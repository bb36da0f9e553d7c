// gains: per-node connection weight to every partition, for refinement.
//
// Replaces src/repro/kernels/gains/kernel.py::gains_pallas (the
// pl.pallas_call at :55), which its ops.py::conn_weights feeds from a
// densified [N, H] incidence tile and a dense f32 transpose of pins > 0.
// This kernel computes that ops-level function:
//
//   conn[n, k] = sum_{j < min(deg n, h)} w(e_j) * [pins[e_j, k] > 0]
//   e_j = node_edges[node_off[n] + j],   f32 [ncap, kcap]
//
// over the node rows [row0, row0 + nrows) (all of them on one device, a
// contiguous stripe a shard on a mesh), written as [nrows, kcap] rows.
//
// For a live edge, pins[e, k] > 0 exactly when some pin p of e has
// parts[p] == k (0 <= k < kcap), which is how pins_count builds the row from
// the same edge CSR. So the kernel walks the edge's pins instead of reading
// its kcap-wide pins row, which for a 17-pin edge holds at most 17 nonzeros
// out of 1024.
//
// What bounds it: bytes, and now mostly the output. At level 0 of the main
// path (ncap 131072, ecap 122880, kcap 1024, 2.09M incidences) it reads the
// node CSR, the edge CSR, parts and edge_w (about 19 MB) and writes conn
// (537 MB): about 0.17 ms at 3.35 TB/s. Reading a pins row for every
// incidence instead would move about 8.6 GB.
//
// Design: one warp per node, eight nodes per block. The warp keeps the
// node's conn row (kcap f32) and marks, one bit per partition, in shared
// memory, and walks the node's incidences in j order with a __syncwarp
// between two incidences. For incidence j its lanes read the pins of e_j
// from the edge CSR and each pin's part; a lane adds w(e_j) to conn[k] only
// if its shared-memory atomicOr finds k's mark bit clear, so each k gets
// one add per incidence and the adds of one k come in j order: the same
// float sum, bit for bit, as the segment path (refine.conn_segments) and
// the plain versions. The marks are two bit rows used in turn, the other
// one cleared while this one is in use. Bits rather than an int32 mark per
// partition keep a warp's shared memory near kcap words, which lets twice
// as many warps share an SM: the warps wait on the walk's dependent loads
// and atomics, so more of them is what made the kernel faster; loading
// further ahead in one warp did not. Loads run one incidence ahead (the
// next incidence's parts, the one after's pins). An edge with more than
// `wide` pins takes its pins row instead and adds w(e_j) where
// pins[e_j, k] > 0; both branches give the same bits. Last, the row goes
// out with 16-byte stores. When the row and marks do not fit in shared
// memory, the warp sums straight into its output row and every edge takes
// the pins-row branch (each lane owns the same k at every j).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxWarps = 8;                  // nodes per block
constexpr size_t kSmemLimit = 227 * 1024;     // dynamic shared memory a block

// 32-bit words of one bit row of marks, rounded up to even so that each
// warp's slice (the row and two bit rows) keeps 16-byte alignment
__host__ __device__ inline int mark_words(int kcap) {
  return ((kcap + 31) / 32 + 1) & ~1;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    gains_kernel(const int* __restrict__ node_off,
                 const int* __restrict__ node_edges,
                 const int* __restrict__ edge_off,
                 const int* __restrict__ edge_pins,
                 const int* __restrict__ parts,
                 const float* __restrict__ edge_w,
                 const int* __restrict__ pins, float* __restrict__ conn,
                 int ncap, int ecap, int kcap, int h, int wide,
                 int row0, int nrows, bool smem_rows) {
  extern __shared__ int smem[];  // per warp: [kcap] f32 row, 2 bit rows
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= nrows) return;  // the whole warp leaves together
  const int n = row0 + r;
  float* out = conn + static_cast<int64_t>(r) * kcap;
  const int nw = mark_words(kcap);
  int* slice = smem + warp * (kcap + 2 * nw);
  float* row = smem_rows ? reinterpret_cast<float*>(slice) : out;
  unsigned* marks = reinterpret_cast<unsigned*>(slice + kcap);
  for (int k = lane; k < kcap; k += 32) row[k] = 0.0f;
  if (smem_rows)
    for (int i = lane; i < 2 * nw; i += 32) marks[i] = 0u;
  __syncwarp();

  // nodes past the live count have deg 0 by the padding convention
  const int lo = node_off[n];
  const int deg = min(node_off[n + 1] - lo, h);
  for (int j0 = 0; j0 < deg; j0 += 32) {
    const int cnt = min(32, deg - j0);
    // lane i holds incidence j0 + i: its edge, weight, pin slice
    int e_l = 0, elo_l = 0, card_l = 0;
    float w_l = 0.0f;
    if (lane < cnt) {
      e_l = min(max(node_edges[lo + j0 + lane], 0), ecap - 1);
      w_l = edge_w[e_l];
      elo_l = edge_off[e_l];
      card_l = edge_off[e_l + 1] - elo_l;
    }
    // this lane's first pin of incidence jj, or -1 (warp-uniform call)
    auto first_pin = [&](int jj) {
      const int elo = __shfl_sync(0xffffffffu, elo_l, jj);
      const int card = __shfl_sync(0xffffffffu, card_l, jj);
      return card <= wide && lane < card
                 ? min(max(edge_pins[elo + lane], 0), ncap - 1) : -1;
    };
    int pin_b = first_pin(0);
    int part_a = -1;
    for (int j = -1; j < cnt; ++j) {
      // incidence j + 1's parts and incidence j + 2's pins go out now
      const int part_b = pin_b >= 0 ? parts[pin_b] : -1;
      pin_b = j + 2 < cnt ? first_pin(j + 2) : -1;
      if (j >= 0) {
        const int e = __shfl_sync(0xffffffffu, e_l, j);
        const float w = __shfl_sync(0xffffffffu, w_l, j);
        const int elo = __shfl_sync(0xffffffffu, elo_l, j);
        const int card = __shfl_sync(0xffffffffu, card_l, j);
        unsigned* mark = marks + (j & 1) * nw;
        unsigned* next = marks + ((j + 1) & 1) * nw;
        if (smem_rows)  // the other bit row, clear for incidence j + 1
          for (int i = lane; i < nw; i += 32) next[i] = 0u;
        if (card > wide) {
          const int* prow = pins + static_cast<int64_t>(e) * kcap;
          for (int k = lane; k < kcap; k += 32)
            if (prow[k] > 0) row[k] += w;
        } else {
          int p = part_a;
          for (int s = lane; s < card; s += 32) {
            if (s != lane)
              p = parts[min(max(edge_pins[elo + s], 0), ncap - 1)];
            if (p < 0 || p >= kcap) continue;
            const unsigned bit = 1u << (p & 31);
            if (!(atomicOr(&mark[p >> 5], bit) & bit)) row[p] += w;
          }
        }
        __syncwarp();
      }
      part_a = part_b;
    }
  }

  if (smem_rows) {
    if ((kcap & 3) == 0) {
      const float4* src = reinterpret_cast<const float4*>(row);
      float4* dst = reinterpret_cast<float4*>(out);
      for (int i = lane; i < kcap / 4; i += 32) dst[i] = src[i];
    } else {
      for (int k = lane; k < kcap; k += 32) out[k] = row[k];
    }
  }
}

}  // namespace

// wide: edges with more pins take the pins-row branch (the wrapper's
// ops.wide_bound; the plain version uses the same threshold). conn holds
// the rows [row0, row0 + nrows).
extern "C" int gains_launch(const void* node_off, const void* node_edges,
                            const void* edge_off, const void* edge_pins,
                            const void* parts, const void* edge_w,
                            const void* pins, void* conn, int ncap, int ecap,
                            int kcap, int h, int wide, int row0, int nrows,
                            void* stream) {
  if (nrows <= 0 || kcap <= 0) return static_cast<int>(cudaSuccess);
  if (row0 < 0 || row0 + nrows > ncap)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t per_warp =
      (static_cast<size_t>(kcap) + 2 * mark_words(kcap)) * sizeof(int);
  const bool smem_rows = per_warp <= kSmemLimit;
  const int warps = smem_rows ? static_cast<int>(std::min<size_t>(
                                    kMaxWarps, kSmemLimit / per_warp))
                              : kMaxWarps;
  const size_t smem = smem_rows ? warps * per_warp : 0;
  cudaError_t err = cudaFuncSetAttribute(
      gains_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (nrows + warps - 1) / warps;
  gains_kernel<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(node_off), static_cast<const int*>(node_edges),
      static_cast<const int*>(edge_off), static_cast<const int*>(edge_pins),
      static_cast<const int*>(parts), static_cast<const float*>(edge_w),
      static_cast<const int*>(pins), static_cast<float*>(conn), ncap, ecap,
      kcap, h, smem_rows ? wide : -1, row0, nrows, smem_rows);
  return static_cast<int>(cudaGetLastError());
}
