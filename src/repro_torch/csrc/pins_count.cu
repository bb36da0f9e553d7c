// pins_count: per-edge partition pin counts for refinement.
//
// Replaces src/repro/kernels/pins_count/kernel.py::pins_count_pallas (the
// pl.pallas_call at :55), which its ops.py::pins_matrix_kernel feeds from a
// densified [E, dbar] tile. This kernel computes that ops-level function,
// not the Pallas blocking:
//
//   pins[e, k]    = #{pins v of edge e : parts[v] == k}          k < kcap
//   pins_in[e, k] = #{dst pins v of edge e : parts[v] == k}
//
// for the edge rows [row0, row0 + nrows) (all of them on one device, a
// contiguous stripe a shard on a mesh), written as contiguous int32
// [nrows, kcap] rows; the caller uses the free
// [kcap, ecap] transpose view, and the gains kernel reads the rows.
//
// What bounds it: bytes. At the main-path shapes (ecap 122880, kcap 512 to
// 1024, 2.09M pins) the two outputs are 2 * ecap * kcap * 4 B = 0.5 to
// 1.0 GB, against about 10 MB of CSR input and 2.09M increments, so the
// output write is the floor (about 0.15 to 0.3 ms at 3.35 TB/s).
//
// Design: one block per edge reads the edge's CSR pins directly (no
// [E, dbar] densify). The edge's 2 * kcap counters live in shared memory
// while they fit in 48 KB; the block counts with shared-memory integer
// atomics (exact, order-free) and then writes both rows with coalesced
// stores, so each output byte is written once. Past 48 KB the block zeroes
// its output rows and counts with integer atomics in global memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kSmemLimit = 48 * 1024;

__global__ void pins_count_kernel(const int* __restrict__ edge_off,
                                  const int* __restrict__ edge_pins,
                                  const int* __restrict__ edge_nsrc,
                                  const int* __restrict__ parts,
                                  int* __restrict__ pins,
                                  int* __restrict__ pins_in,
                                  int ncap, int kcap, int row0,
                                  bool smem_counters) {
  extern __shared__ int counters[];  // [2 * kcap] when smem_counters
  const int e = row0 + blockIdx.x;
  int* row = pins + static_cast<int64_t>(blockIdx.x) * kcap;
  int* row_in = pins_in + static_cast<int64_t>(blockIdx.x) * kcap;
  int* c = smem_counters ? counters : row;
  int* c_in = smem_counters ? counters + kcap : row_in;
  for (int k = threadIdx.x; k < kcap; k += blockDim.x) {
    c[k] = 0;
    c_in[k] = 0;
  }
  __syncthreads();
  // edges past the live count have lo == hi by the padding convention
  const int lo = edge_off[e];
  const int hi = edge_off[e + 1];
  const int dst0 = lo + edge_nsrc[e];
  for (int s = lo + threadIdx.x; s < hi; s += blockDim.x) {
    const int pin = min(max(edge_pins[s], 0), ncap - 1);
    const int p = parts[pin];
    if (p >= 0 && p < kcap) {
      atomicAdd(&c[p], 1);
      if (s >= dst0) atomicAdd(&c_in[p], 1);
    }
  }
  if (smem_counters) {
    __syncthreads();
    for (int k = threadIdx.x; k < kcap; k += blockDim.x) {
      row[k] = c[k];
      row_in[k] = c_in[k];
    }
  }
}

}  // namespace

extern "C" int pins_count_launch(const void* edge_off, const void* edge_pins,
                                 const void* edge_nsrc, const void* parts,
                                 void* pins, void* pins_in, int ecap, int ncap,
                                 int kcap, int row0, int nrows, void* stream) {
  if (nrows <= 0 || kcap <= 0) return static_cast<int>(cudaSuccess);
  if (row0 < 0 || row0 + nrows > ecap)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(kcap) * sizeof(int);
  const bool use_smem = smem <= kSmemLimit;
  pins_count_kernel<<<nrows, kThreads, use_smem ? smem : 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(edge_off), static_cast<const int*>(edge_pins),
      static_cast<const int*>(edge_nsrc), static_cast<const int*>(parts),
      static_cast<int*>(pins), static_cast<int*>(pins_in), ncap, kcap, row0,
      use_smem);
  return static_cast<int>(cudaGetLastError());
}
