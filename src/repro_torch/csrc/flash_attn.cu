// flash_attn: online-softmax attention for the LM prefill, GQA, causal or
// not, f32 or bf16 inputs with f32 accumulation.
//
// Replaces src/repro/kernels/flash_attn/kernel.py::flash_attention_pallas
// (the pl.pallas_call at :75) behind its ops.py::flash_attention_gqa. This
// kernel computes that ops-level function on the [B, S, H, Dh] layout:
//
//   o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / g]) v[b, j, h / g]
//   g = H / KV,   j <= q_offset + i when causal
//
// q/o hold Sq positions and k/v Sk. Query row i sits at position
// q_offset + i of the causal mask, as in the JAX layers.flash_attention's
// q_offset: a rank of sequence-parallel prefill passes its own block of
// query rows and every key, and the tiles past its last row's position
// are never loaded.
//
// with the TPU kernel's arithmetic: f32 scores, masked scores at -1e30, the
// running max / correction / denominator update of kernel.py:50-58, and
// o = acc / max(l, 1e-30) cast to q's type. Query head h reads KV head
// h / g in place (no repeat, no transpose copies).
//
// What bounds it: operations. At the serving path's prefill (S 2048, H 12,
// KV 2, Dh 128, causal) the two products need 2 * S^2 * Dh * H = 12.9
// GFLOP over the causal triangle against 29 MB of q/k/v/o. Both products
// run on the tensor cores (mma.sync m16n8k8, TF32 in, f32 accumulate) with
// the 3xTF32 split: each f32 operand x is split into big = tf32(x) and
// small = tf32(x - big), rounded to nearest with ties away as
// cvt.rna.tf32.f32 does (here by adding half an ulp to the bits and
// clearing the 13 low ones: two integer operations), and a product is
// small*big + big*small + big*big. That keeps the f32 tolerance (2e-5
// at the serving shapes, where one TF32 product is off by about 1.5e-3)
// for three tensor-core products: 3 x 12.9 GFLOP, 0.078 ms at the TF32
// rate. bf16 values are exact in TF32, so bf16 inputs skip the small parts
// of q, k and v: one product for QK^T and two for PV, whose P is f32.
// With p_bf16 (the JAX attn_p_bf16 flag, bf16 inputs only) each tile's P
// is rounded to bf16, to nearest even as astype does, before the PV
// product, which then takes one product; the denominator l sums the
// unrounded f32 P.
//
// Design: one block of 4 warps per (b * h, 64 query rows), each warp 16
// rows; heavy causal tiles are launched first. The block stages its Q tile
// once and loops over 32-key tiles of K and V, double-buffered with
// cp.async (16-byte copies, rows past Sq or Sk zero-filled) so the next
// tile loads while this one multiplies. Shared memory holds f32 tiles
// only; rows are padded (Q and K by 4 words, V by 8) so the fragment loads
// hit 32 distinct banks. Fragments are split in registers as they are
// loaded. A warp's score tile [16 x 32] comes out in the accumulator
// layout (rows g and g + 8, keys 2t and 2t + 1 of each 8-key slice), where
// quad shuffles take the row maxima and sums; the probabilities reach the
// A layout of the PV product (keys t and t + 4) through eight shuffles a
// slice. Tiles wholly above a warp's rows' positions are skipped (on the
// TPU they add exactly 0 with correction 1); partial tiles are masked, so
// any prompt length works. bf16 inputs are converted to f32 as they are
// staged, with plain loads. ptxas -v (sm_90a): 167 registers a thread at
// Dh 128 in f32, 168 in bf16, no spills; 100 KB of shared memory a block,
// two blocks an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kBK = 32;           // keys per tile
constexpr int kThreads = 32 * kWarps;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// shared memory: Q [kBQ][QS], two K buffers [kBK][KS], two V [kBK][VS]
template <int D>
struct Smem {
  static constexpr int QS = D + 4;
  static constexpr int KS = D + 4;
  static constexpr int VS = D + 8;
  static constexpr int K_OFF = kBQ * QS;
  static constexpr int V_OFF = K_OFF + 2 * kBK * KS;
  static constexpr size_t kBytes = sizeof(float) * (V_OFF + 2 * kBK * VS);
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// x to TF32, round to nearest with ties away (cvt.rna.tf32.f32 on finite x)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// d += a * b on one m16n8k8 tile
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// rows [row0, row0 + kRows) of a source with `step` elements a position
// into dst (row stride ST floats); rows at or past S become zeros
template <int D, int ST, int kRows>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int64_t step, int row0, int S) {
  constexpr int C = D / 4;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < kRows * C; i += kThreads) {
    const int r = i / C, c = i - r * C, s = row0 + r;
    const bool in = s < S;
    cp_async16(dst + r * ST + 4 * c, src + (in ? s : 0) * step + 4 * c, in);
  }
}
template <int D, int ST, int kRows>
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src,
                                      int64_t step, int row0, int S) {
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D, s = row0 + r;
    dst[r * ST + d] = s < S ? __bfloat162float(src[s * step + d]) : 0.0f;
  }
}

// x rounded to bf16 (nearest even), as TF32 bits: exact in TF32
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __float_as_uint(__bfloat162float(__float2bfloat16_rn(x)));
}

template <typename T, int D, bool PB>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int Sq,
                      int Sk, int H, int KV, int causal, int q_off,
                      float scale) {
  using L = Smem<D>;
  // bf16 values are exact in TF32: their small parts are 0
  constexpr bool kSmall = std::is_same<T, float>::value;
  static_assert(!(PB && kSmall), "p_bf16 takes bf16 inputs");
  constexpr int NT = kBK / 8;  // 8-key slices of a tile
  constexpr int DT = D / 8;    // 8-wide slices of the head dimension
  extern __shared__ float smem[];
  float* qs = smem;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t q_step = static_cast<int64_t>(H) * D;  // one position
  const int64_t kv_step = static_cast<int64_t>(KV) * D;
  const T* qb = q + static_cast<int64_t>(b) * Sq * q_step + h * D;
  const T* kb = k + static_cast<int64_t>(b) * Sk * kv_step + kvh * D;
  const T* vb = v + static_cast<int64_t>(b) * Sk * kv_step + kvh * D;
  T* ob = o + static_cast<int64_t>(b) * Sq * q_step + h * D;

  // a causal block reads the key tiles up to its last row's position
  int n_kt = (Sk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q_off + q0 + kBQ - 1) / kBK + 1);
  stage<D, L::QS, kBQ>(qs, qb, q_step, q0, Sq);
  stage<D, L::KS, kBK>(smem + L::K_OFF, kb, kv_step, 0, Sk);
  stage<D, L::VS, kBK>(smem + L::V_OFF, vb, kv_step, 0, Sk);
  cp_async_commit();

  const int r_lo = q0 + 16 * warp + g;  // this thread's rows: r_lo, r_lo + 8
  const float* qw = qs + 16 * warp * L::QS;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
  float acc[DT][4] = {};
  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) {
      stage<D, L::KS, kBK>(smem + L::K_OFF + (buf ^ 1) * kBK * L::KS, kb,
                           kv_step, (kt + 1) * kBK, Sk);
      stage<D, L::VS, kBK>(smem + L::V_OFF + (buf ^ 1) * kBK * L::VS, vb,
                           kv_step, (kt + 1) * kBK, Sk);
    }
    cp_async_commit();
    cp_async_wait_one();  // every group but the newest: tile kt is in
    __syncthreads();
    const int k0 = kt * kBK;
    if (!causal || k0 <= q_off + q0 + 16 * warp + 15) {
      const float* ks = smem + L::K_OFF + buf * kBK * L::KS;
      const float* vs = smem + L::V_OFF + buf * kBK * L::VS;

      // S = Q K^T, [16 x kBK] a warp
      float sc[NT][4] = {};
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) {
        const float* qa = qw + kk * 8 + t;
        uint32_t ab[4], as[4];
        split(qa[g * L::QS], ab[0], as[0]);
        split(qa[(g + 8) * L::QS], ab[1], as[1]);
        split(qa[g * L::QS + 4], ab[2], as[2]);
        split(qa[(g + 8) * L::QS + 4], ab[3], as[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* kp = ks + (nt * 8 + g) * L::KS + kk * 8 + t;
          uint32_t bb0, bs0, bb1, bs1;
          split(kp[0], bb0, bs0);
          split(kp[4], bb1, bs1);
          if (kSmall) {
            mma(sc[nt], as, bb0, bb1);
            mma(sc[nt], ab, bs0, bs1);
          }
          mma(sc[nt], ab, bb0, bb1);
        }
      }

      // scale, mask, online softmax; rows r_lo (c 0, 1) and r_lo + 8 (c 2, 3)
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = r_lo + 8 * (c >> 1);
          const int col = k0 + nt * 8 + 2 * t + (c & 1);
          float s = sc[nt][c] * scale;
          if (col >= Sk || (causal && col > q_off + row)) s = kNeg;
          sc[nt][c] = s;
          mx[c >> 1] = fmaxf(mx[c >> 1], s);
        }
      }
      float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = expf(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = expf(sc[nt][c] - m[c >> 1]);
          sc[nt][c] = p;
          sum[c >> 1] += p;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(kFull, sum[i], 1);
        sum[i] += __shfl_xor_sync(kFull, sum[i], 2);
        l[i] = l[i] * corr[i] + sum[i];
      }
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[dt][c] *= corr[c >> 1];
      }

      // O += P V: P's A fragment (rows g, g + 8; keys t, t + 4 of a slice)
      // comes from the lanes holding keys 2t', 2t' + 1 with t' = t / 2 and
      // t' = 2 + t / 2
      const int src0 = (lane & ~3) | (t >> 1);
      const int src1 = src0 + 2;
      const bool odd = t & 1;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        const float x0 = __shfl_sync(kFull, sc[kk][0], src0);
        const float x1 = __shfl_sync(kFull, sc[kk][1], src0);
        const float y0 = __shfl_sync(kFull, sc[kk][2], src0);
        const float y1 = __shfl_sync(kFull, sc[kk][3], src0);
        const float z0 = __shfl_sync(kFull, sc[kk][0], src1);
        const float z1 = __shfl_sync(kFull, sc[kk][1], src1);
        const float w0 = __shfl_sync(kFull, sc[kk][2], src1);
        const float w1 = __shfl_sync(kFull, sc[kk][3], src1);
        const float pf[4] = {odd ? x1 : x0, odd ? y1 : y0, odd ? z1 : z0,
                             odd ? w1 : w0};
        uint32_t pb[4], ps[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (PB) {
            pb[i] = bf16_bits(pf[i]);
          } else {
            split(pf[i], pb[i], ps[i]);
          }
        }
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          const float* vp = vs + (kk * 8 + t) * L::VS + dt * 8 + g;
          uint32_t bb0, bs0, bb1, bs1;
          split(vp[0], bb0, bs0);
          split(vp[4 * L::VS], bb1, bs1);
          if (kSmall) mma(acc[dt], pb, bs0, bs1);
          if constexpr (!PB) mma(acc[dt], ps, bb0, bb1);
          mma(acc[dt], pb, bb0, bb1);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before its refill
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = ob + row * q_step + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      store(orow + dt * 8, acc[dt][2 * i] / den);
      store(orow + dt * 8 + 1, acc[dt][2 * i + 1] / den);
    }
  }
}

template <typename T, int D, bool PB>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int causal, int q_off, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = Smem<D>::kBytes;
  auto kern = flash_attn_kernel<T, D, PB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, causal,
      q_off, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PB>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Sk, int H, int KV, int D, int causal, int q_off,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16, PB>(q, k, v, o, B, Sq, Sk, H, KV, causal, q_off,
                               scale, stream);
    case 32:
      return launch<T, 32, PB>(q, k, v, o, B, Sq, Sk, H, KV, causal, q_off,
                               scale, stream);
    case 64:
      return launch<T, 64, PB>(q, k, v, o, B, Sq, Sk, H, KV, causal, q_off,
                               scale, stream);
    case 128:
      return launch<T, 128, PB>(q, k, v, o, B, Sq, Sk, H, KV, causal, q_off,
                                scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype 0: float32, 1: bfloat16. q/o [B, Sq, H, D], k/v [B, Sk, KV, D], all
// contiguous and 16-byte aligned; H a multiple of KV; query row i at
// position q_off + i of the causal mask; p_bf16 (bf16 only) rounds P to
// bf16 before the PV product.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, int B, int Sq, int Sk, int H,
                                 int KV, int D, int causal, int q_off,
                                 int p_bf16, float scale, int dtype,
                                 void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || Sk <= 0 || q_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !p_bf16)
    return launch_d<float, false>(q, k, v, o, B, Sq, Sk, H, KV, D, causal,
                                  q_off, scale, st);
  if (dtype == 1 && !p_bf16)
    return launch_d<__nv_bfloat16, false>(q, k, v, o, B, Sq, Sk, H, KV, D,
                                          causal, q_off, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16, true>(q, k, v, o, B, Sq, Sk, H, KV, D,
                                         causal, q_off, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
