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
// reading the node incidence CSR and the int32 pins rows [ecap, kcap]
// written by pins_count directly, so the f32 transpose disappears.
//
// What bounds it: bytes. At the main-path shapes (ncap 131072, kcap 512 to
// 1024, 2.09M incidences) the function must read the pins matrix once
// (0.25 to 0.5 GB) and write conn once (0.27 to 0.54 GB); the compare-adds
// number 2.09M * kcap, about 2G, far below the f32 rate. The kernel
// re-reads a pins row for every incidence of it (about 17 times at level
// 0), which the 50 MB L2 only partly absorbs: that gather is where a later
// version gains.
//
// Design: one block per (node, 256-wide slice of partitions); each thread
// owns one partition k and keeps its sum in a register. The block stages
// the node's (edge, weight) list in shared memory in chunks and walks it
// in j order, adding w(e_j) where pins[e_j, k] > 0: the float sum runs in
// the same fixed order as the reference's segment sum, with no atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;

__global__ void gains_kernel(const int* __restrict__ node_off,
                             const int* __restrict__ node_edges,
                             const float* __restrict__ edge_w,
                             const int* __restrict__ pins,
                             float* __restrict__ conn, int ecap, int kcap,
                             int h) {
  __shared__ int s_e[kChunk];
  __shared__ float s_w[kChunk];
  const int n = blockIdx.x;
  const int k = blockIdx.y * blockDim.x + threadIdx.x;
  // nodes past the live count have deg 0 by the padding convention
  const int lo = node_off[n];
  const int deg = min(node_off[n + 1] - lo, h);
  float acc = 0.0f;
  for (int j0 = 0; j0 < deg; j0 += kChunk) {
    const int cnt = min(kChunk, deg - j0);
    __syncthreads();
    if (threadIdx.x < cnt) {
      const int e = min(max(node_edges[lo + j0 + threadIdx.x], 0), ecap - 1);
      s_e[threadIdx.x] = e;
      s_w[threadIdx.x] = edge_w[e];
    }
    __syncthreads();
    if (k < kcap) {
      for (int j = 0; j < cnt; ++j) {
        if (pins[static_cast<int64_t>(s_e[j]) * kcap + k] > 0) acc += s_w[j];
      }
    }
  }
  if (k < kcap) conn[static_cast<int64_t>(n) * kcap + k] = acc;
}

}  // namespace

extern "C" int gains_launch(const void* node_off, const void* node_edges,
                            const void* edge_w, const void* pins, void* conn,
                            int ncap, int ecap, int kcap, int h, void* stream) {
  if (ncap <= 0 || kcap <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(ncap, (kcap + kThreads - 1) / kThreads);
  gains_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(node_off), static_cast<const int*>(node_edges),
      static_cast<const float*>(edge_w), static_cast<const int*>(pins),
      static_cast<float*>(conn), ecap, kcap, h);
  return static_cast<int>(cudaGetLastError());
}
