// pair_scores: the coarsening's neighbour histogram and inbound
// intersection, the paper's hottest kernel.
//
// Replaces src/repro/kernels/pair_scores/kernel.py::pair_scores_pallas (the
// pl.pallas_call at :64), fed by ops.py::score_slots_kernel with dense
// per-node tiles. This kernel computes the same tile function:
//
//   eta[t, u]   = sum_l w[t, l] * [m[t, l] == nbr[t, u]]     f32
//   inter[t, u] = sum_l d[t, l] * [m[t, l] == nbr[t, u]]     int32, exact
//
// nbr [rows, U] holds row t's unique neighbour ids ascending (pad -1),
// m/w/d [rows, L] its traversal in (node, lane) order (m pad -2); ucnt and
// lcnt give each row's live U and L counts.
//
// What bounds it: bytes. At the main-path shapes (rows 131072, U = L = 640)
// the function reads at most four [rows, 640] int32/f32 tiles and writes
// two, about 2 GB (0.6 ms at 3.35 TB/s); the live entries, which are all
// it has to read, are a fraction of that. The equality compares number
// sum_t ucnt[t] * lcnt[t], about 10^10 at level 0, which at the card's
// int32 rate costs less than the bytes.
//
// Design: one block per (row, 256-wide slice of neighbour slots); each
// thread owns one slot id in a register. The block stages the row's
// traversal (m, w, d) in shared memory in chunks and every thread scans it
// in l order, adding w into eta and d into inter where m equals its id: a
// fixed summation order (the reference's segment-sum order), no atomics.
// Blocks stop at the row's live counts, so padded slots, padded traversal
// entries and rows past the live nodes cost one store of zeros.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;

__global__ void pair_scores_kernel(const int* __restrict__ nbr,
                                   const int* __restrict__ trav_m,
                                   const float* __restrict__ trav_w,
                                   const int* __restrict__ trav_d,
                                   const int* __restrict__ ucnt,
                                   const int* __restrict__ lcnt,
                                   float* __restrict__ eta,
                                   int* __restrict__ inter, int u_dim,
                                   int l_dim) {
  __shared__ int s_m[kChunk];
  __shared__ float s_w[kChunk];
  __shared__ int s_d[kChunk];
  const int r = blockIdx.x;
  const int u = blockIdx.y * blockDim.x + threadIdx.x;
  const int64_t row_u = static_cast<int64_t>(r) * u_dim;
  const int64_t row_l = static_cast<int64_t>(r) * l_dim;
  const int un = min(ucnt[r], u_dim);
  const int ln = min(lcnt[r], l_dim);
  float acc = 0.0f;
  int hits = 0;
  if (static_cast<int>(blockIdx.y) * static_cast<int>(blockDim.x) < un) {
    const int id = u < un ? nbr[row_u + u] : -1;
    for (int l0 = 0; l0 < ln; l0 += kChunk) {
      const int cnt = min(kChunk, ln - l0);
      __syncthreads();
      for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
        s_m[i] = trav_m[row_l + l0 + i];
        s_w[i] = trav_w[row_l + l0 + i];
        s_d[i] = trav_d[row_l + l0 + i];
      }
      __syncthreads();
      if (u < un) {
        for (int i = 0; i < cnt; ++i) {
          if (s_m[i] == id) {
            acc += s_w[i];
            hits += s_d[i];
          }
        }
      }
    }
  }
  if (u < u_dim) {
    eta[row_u + u] = acc;
    inter[row_u + u] = hits;
  }
}

}  // namespace

extern "C" int pair_scores_launch(const void* nbr, const void* trav_m,
                                  const void* trav_w, const void* trav_d,
                                  const void* ucnt, const void* lcnt,
                                  void* eta, void* inter, int rows, int u_dim,
                                  int l_dim, void* stream) {
  if (rows <= 0 || u_dim <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(rows, (u_dim + kThreads - 1) / kThreads);
  pair_scores_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nbr), static_cast<const int*>(trav_m),
      static_cast<const float*>(trav_w), static_cast<const int*>(trav_d),
      static_cast<const int*>(ucnt), static_cast<const int*>(lcnt),
      static_cast<float*>(eta), static_cast<int*>(inter), u_dim, l_dim);
  return static_cast<int>(cudaGetLastError());
}
