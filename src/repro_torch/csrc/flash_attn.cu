// flash_attn: online-softmax attention for the LM prefill, GQA, causal or
// not, f32 or bf16 inputs with f32 accumulation.
//
// Replaces src/repro/kernels/flash_attn/kernel.py::flash_attention_pallas
// (the pl.pallas_call at :75) behind its ops.py::flash_attention_gqa. This
// kernel computes that ops-level function on the [B, S, H, Dh] layout:
//
//   o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / g]) v[b, j, h / g]
//   g = H / KV,   j <= i when causal
//
// with the TPU kernel's arithmetic: f32 scores, masked scores at -1e30, the
// running max / denominator / accumulator update of kernel.py:48-56, and
// o = acc / max(l, 1e-30) cast to q's type. Query head h reads KV head
// h / g in place (no repeat, no transpose copies).
//
// What bounds it: operations. At the serving path's prefill (S 2048, H 12,
// KV 2, Dh 128, causal) the two products need 2 * S^2 * Dh * H = 12.9
// GFLOP against 29 MB of q/k/v/o; this first version runs them as f32 FMAs
// out of shared memory (no tensor cores, so f32 results stay within the
// reference's tolerance). wgmma and TMA are for a later version.
//
// Design: one block of 256 threads per (b * h, 64-query tile). The block
// stages its Q tile once and loops over 64-key tiles, staging K and V in
// shared memory (f32, rows padded to kill bank conflicts). Thread (ty, tx)
// owns query rows 4ty..4ty+3: it computes the scores of those rows against
// keys tx + 16j (j < 4), and the output columns tx * Dh/16 onwards. The 16
// threads of one row group form half a warp, so row maxima and sums reduce
// with shuffles and the probabilities pass to the PV product through
// shared memory behind a __syncwarp. Running max, denominator and
// accumulator stay in registers. Tiles wholly above the causal diagonal
// are skipped (on the TPU they add exactly 0 with correction 1); partial
// tiles (S not a multiple of 64) are masked, so any prompt length works.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column threads
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // q tile, k tile (rows padded by 1), v tile, probabilities (padded)
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int S,
                      int H, int KV, int causal, float scale) {
  constexpr int QS = D + 1;
  constexpr int KS = D + 1;
  constexpr int PS = kBK + 1;
  constexpr int DPT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [kBQ][QS]
  float* ks = qs + kBQ * QS;    // [kBK][KS]
  float* vs = ks + kBK * KS;    // [kBK][D]
  float* ps = vs + kBK * D;     // [kBQ][PS]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int64_t q_step = static_cast<int64_t>(H) * D;   // one position
  const int64_t kv_step = static_cast<int64_t>(KV) * D;
  const T* qb = q + static_cast<int64_t>(b) * S * q_step + h * D;
  const T* kb = k + static_cast<int64_t>(b) * S * kv_step + kvh * D;
  const T* vb = v + static_cast<int64_t>(b) * S * kv_step + kvh * D;
  T* ob = o + static_cast<int64_t>(b) * S * q_step + h * D;

  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    qs[r * QS + d] = s < S ? to_f32(qb[s * q_step + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.0f;
  }

  int n_kt = (S + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every thread is done with the previous K/V tile
    for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D, s = k0 + r;
      const bool in = s < S;
      ks[r * KS + d] = in ? to_f32(kb[s * kv_step + d]) : 0.0f;
      vs[r * D + d] = in ? to_f32(vb[s * kv_step + d]) : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * ty + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + 4 * ty + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        float s = sc[i][j] * scale;
        if (c >= S || (causal && c > r)) s = kNeg;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[(4 * ty + i) * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // the row group's probabilities are in shared memory

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * PS + c];
#pragma unroll
      for (int e = 0; e < DPT; ++e) vv[e] = vs[c * D + tx * DPT + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + 4 * ty + i;
    if (s >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      store(&ob[s * q_step + tx * DPT + e], acc[i][e] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_attn_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int KV, int D, int causal, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, KV, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype 0: float32, 1: bfloat16. q/o [B, S, H, D], k/v [B, S, KV, D], all
// contiguous; H a multiple of KV.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, int B, int S, int H, int KV, int D,
                                 int causal, float scale, int dtype,
                                 void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, B, S, H, KV, D, causal, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, S, H, KV, D, causal, scale,
                                   st);
  return static_cast<int>(cudaErrorInvalidValue);
}
