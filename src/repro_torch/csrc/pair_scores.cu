// pair_scores: the coarsening's neighbour histogram and inbound
// intersection, the paper's hottest kernel, in slot space.
//
// Replaces src/repro/kernels/pair_scores/kernel.py::pair_scores_pallas (the
// pl.pallas_call at :64) and the dense tiles its wrapper
// ops.py::score_slots_kernel builds around it. This kernel computes that
// wrapper's slot-space function, with no pair sort and no tiles:
//
//   eta[s]   = sum_{lanes (e, i, j) of node n with pins_e[j] == ids[s]} w(e)/|e|
//   inter[s] = the number of those lanes with i, j >= nsrc(e)     (exact)
//
// for every slot s of node n's neighbourhood [nbr_off[n], nbr_off[n+1]),
// and 0 at every slot from nbr_off[ncap] (the live entry count) to nbcap.
//
// What bounds it: bytes. At level 0 of the main path (ncap 131072, 2.09M
// pins, nbcap 33.4M, about 15.7M live slots) it reads the node and edge CSRs,
// edge_nsrc/edge_w and the live neighbour ids once (about 85 MB) and writes
// eta/inter over nbcap (267 MB): about 0.10 ms at 3.35 TB/s. Its work is one
// binary search in shared memory per pair lane (33.4M lanes, about 8 steps
// each), integer operations that cost less than the bytes.
//
// Order. The segment path (core/coarsen.py::score_slots) adds each slot's
// lanes in lane order, which build_pairs lays out by (e, i, j): for one node,
// edges ascending, then the node's positions i in the edge, then the other
// positions j. A node's incidence lists its inbound edges first and its
// outbound edges after, each run ascending, so walking it as listed would
// add out of order. The warp merges the two runs into ascending e (32 at a
// time, each element ranked by a binary search in the other run's window)
// and visits an edge found in both runs once: an input edge may hold one
// node as a source and as a destination. On that visit it takes every
// position i with pins[i] == n, in order. wn = w(e)/|e| is one IEEE f32
// division (__fdiv_rn; the build has no --use_fast_math), as torch divides in
// build_pairs. So eta has the segment path's bits and inter is exact.
//
// Design: one warp per node, eight nodes a block. The warp stages the node's
// slot ids in shared memory beside an f32 eta bin and an int32 inter bin per
// slot, both zeroed. It loads the first pins of eight visits at once, then
// appends each visit's lanes in (e, i, j) order to a 64-entry ring in shared
// memory (m with dst in its top bit, wn) and takes them 32 at a time: each
// lane binary-searches its m among the staged ids, lanes that hit one slot
// are grouped with __match_any_sync, and the group's lowest lane adds the
// members' wn in ascending lane order, read from the ring, and their dst
// count; a __syncwarp separates the steps. No float atomics. The bins go
// out to the node's slot range with coalesced stores. A node with more slots
// than the bins a warp holds (bins, set by the wrapper from the level's
// largest neighbourhood) takes them in batches and re-walks its lanes once
// per batch; a lane whose m lies outside the batch's ids finds no slot and
// skips. The whole grid zeroes the slots past the last node's range.
//
// The walk waits on dependent loads and shared-memory searches, so warps in
// flight are what make it fast: registers are capped for six blocks (48
// warps) an SM, which the bins of a level-0 node (at most 167 slots) leave
// room for in shared memory.
//
// Registers and spills (ptxas, as chip_smoke.py [1] reports them): 40
// registers, 88 bytes of spill stores, under the six-block cap.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kWarps = 8;                   // nodes per block
constexpr int kMinBlocks = 6;               // blocks an SM: <= 40 registers
constexpr int kRing = 64;                   // queued lanes a warp holds
constexpr int kMerge = 3 * 32;              // two run windows + merged run
constexpr int kStage = 8;                   // visits whose pins load at once
constexpr size_t kSmemLimit = 227 * 1024;   // dynamic shared memory a block
constexpr unsigned kFull = 0xffffffffu;

// 32-bit words of shared memory a warp uses with `bins` bins: ids, eta and
// inter bins, the ring's m (dst in bit 31) and wn, the merge windows, staged
// pins
__host__ __device__ inline int warp_words(int bins) {
  return 3 * bins + 2 * kRing + kMerge + kStage * 32;
}

// first index in a[0, n) whose value is >= x (> x when `upper`)
__device__ __forceinline__ int search(const int* a, int n, int x,
                                      bool upper) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x || (upper && a[mid] == x)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    pair_scores_kernel(const int* __restrict__ node_off,
                       const int* __restrict__ node_edges,
                       const int* __restrict__ node_nin,
                       const int* __restrict__ edge_off,
                       const int* __restrict__ edge_pins,
                       const int* __restrict__ edge_nsrc,
                       const float* __restrict__ edge_w,
                       const int* __restrict__ nbr_off,
                       const int* __restrict__ nbr_ids,
                       float* __restrict__ eta, int* __restrict__ inter,
                       int ncap, int ecap, int nbcap, int bins, int row0,
                       int nrows, bool tail) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;  // lanes before this one

  // the outputs hold the slots from the stripe's first, `base`
  const int base = nbr_off[row0];
  eta -= base;
  inter -= base;
  // slots past the last node's range hold no entry: 0, as score_slots
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = nbr_off[ncap] +
                   static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       tail && s < nbcap; s += stride) {
    eta[s] = 0.0f;
    inter[s] = 0;
  }

  const int r = blockIdx.x * kWarps + warp;
  if (r >= nrows) return;  // the whole warp leaves together
  const int n = row0 + r;
  int* ids = smem + warp * warp_words(bins);
  float* bin_eta = reinterpret_cast<float*>(ids + bins);
  int* bin_inter = ids + 2 * bins;
  unsigned* ring_md = reinterpret_cast<unsigned*>(ids + 3 * bins);
  float* ring_w = reinterpret_cast<float*>(ids + 3 * bins + kRing);
  int* win_a = ids + 3 * bins + 2 * kRing;
  int* win_b = win_a + 32;
  int* merged = win_b + 32;
  int* staged = merged + 32;  // [kStage][32] first pins of the next visits

  const int lo = nbr_off[n];
  const int ucnt = nbr_off[n + 1] - lo;
  const int p0 = node_off[n];
  const int deg = node_off[n + 1] - p0;  // 0 for nodes past the live count
  const int na = min(max(node_nin[n], 0), deg);  // the inbound run
  const int nb = deg - na;                       // the outbound run

  for (int b0 = 0; b0 < ucnt; b0 += bins) {
    const int cnt = min(bins, ucnt - b0);
    for (int k = lane; k < cnt; k += 32) {
      ids[k] = nbr_ids[lo + b0 + k];
      bin_eta[k] = 0.0f;
      bin_inter[k] = 0;
    }
    __syncwarp();
    int head = 0, queued = 0;  // the ring's first entry and its length

    // one step: the ring's first `take` lanes into the bins, in lane order
    auto step = [&](int take) {
      int slot = -1;
      bool dst = false;
      if (lane < take) {
        const unsigned md = ring_md[(head + lane) & (kRing - 1)];
        const int m = static_cast<int>(md & 0x7fffffffu);
        dst = md >> 31;
        const int k = search(ids, cnt, m, false);
        if (k < cnt && ids[k] == m) slot = k;
      }
      const unsigned group = __match_any_sync(kFull, slot);
      const unsigned dsts = __ballot_sync(kFull, dst);
      if (slot >= 0 && (group & below) == 0) {
        float acc = bin_eta[slot];
        for (unsigned g = group; g; g &= g - 1)
          acc += ring_w[(head + __ffs(g) - 1) & (kRing - 1)];
        bin_eta[slot] = acc;
        bin_inter[slot] += __popc(group & dsts);
      }
      __syncwarp();
      head = (head + take) & (kRing - 1);
      queued -= take;
    };

    int ia = 0, ib = 0, prev = -1;  // merge positions, last merged edge
    while (ia < na || ib < nb) {
      // the next 32 edges of the merged runs: each element's rank is its
      // index plus the count of the other window's elements before it
      // (inbound first on a tie)
      const int a = ia + lane < na ? node_edges[p0 + ia + lane] : INT_MAX;
      const int b = ib + lane < nb ? node_edges[p0 + na + ib + lane]
                                   : INT_MAX;
      win_a[lane] = a;
      win_b[lane] = b;
      __syncwarp();
      const int ra = lane + search(win_b, 32, a, false);
      const int rb = lane + search(win_a, 32, b, true);
      if (ra < 32) merged[ra] = a;
      if (rb < 32) merged[rb] = b;
      ia += __popc(__ballot_sync(kFull, ra < 32 && a != INT_MAX));
      ib += __popc(__ballot_sync(kFull, rb < 32 && b != INT_MAX));
      __syncwarp();
      const int e_m = merged[lane];
      const int up = __shfl_up_sync(kFull, e_m, 1);
      const unsigned real = __ballot_sync(kFull, e_m != INT_MAX);
      // an edge in both runs comes twice in a row: visit it once
      const unsigned keep =
          __ballot_sync(kFull, e_m != INT_MAX && e_m != (lane ? up : prev));
      prev = __shfl_sync(kFull, e_m, 31 - __clz(real));
      if (keep >> lane & 1u) win_a[__popc(keep & below)] = e_m;
      __syncwarp();
      const int nv = __popc(keep);

      // lane v holds visit v's offset, pin count, nsrc and w(e)/|e|
      int e_off = 0, e_card = 0, e_nsrc = 0;
      float e_wn = 0.0f;
      if (lane < nv) {
        const int e = min(max(win_a[lane], 0), ecap - 1);
        e_off = edge_off[e];
        e_card = edge_off[e + 1] - e_off;
        e_nsrc = edge_nsrc[e];
        e_wn = __fdiv_rn(edge_w[e], __int2float_rn(max(e_card, 1)));
      }
      for (int v0 = 0; v0 < nv; v0 += kStage) {
        // the first 32 pins of kStage visits, their loads in flight together
        int first[kStage];
#pragma unroll
        for (int k = 0; k < kStage; ++k) {
          const int off = __shfl_sync(kFull, e_off, (v0 + k) & 31);
          const int card = __shfl_sync(kFull, e_card, (v0 + k) & 31);
          first[k] = v0 + k < nv && lane < card ? edge_pins[off + lane] : -1;
        }
#pragma unroll
        for (int k = 0; k < kStage; ++k) staged[k * 32 + lane] = first[k];
        __syncwarp();
        for (int v = v0; v < min(v0 + kStage, nv); ++v) {
          const int off = __shfl_sync(kFull, e_off, v);
          const int card = __shfl_sync(kFull, e_card, v);
          const int nsrc = __shfl_sync(kFull, e_nsrc, v);
          const float wn = __shfl_sync(kFull, e_wn, v);
          const int* first_pins = staged + (v - v0) * 32;
          // this lane's pin in chunk c of the edge, or -1
          auto pin_at = [&](int c) {
            return c == 0 ? first_pins[lane]
                          : (c + lane < card ? edge_pins[off + c + lane] : -1);
          };
          for (int ic = 0; ic < card; ic += 32) {
            const int pin_i = pin_at(ic);
            for (unsigned is = __ballot_sync(kFull, pin_i == n); is;
                 is &= is - 1) {
              // row (e, i): lanes j != i, appended in j order
              const int i = ic + __ffs(is) - 1;
              for (int jc = 0; jc < card; jc += 32) {
                const int j = jc + lane;
                const bool live = j < card && j != i;
                const int m = jc == ic ? pin_i : pin_at(jc);
                const unsigned lanes = __ballot_sync(kFull, live);
                if (live) {
                  const int r = (head + queued + __popc(lanes & below)) &
                                (kRing - 1);
                  ring_md[r] = static_cast<unsigned>(m) |
                               (i >= nsrc && j >= nsrc ? 0x80000000u : 0u);
                  ring_w[r] = wn;
                }
                queued += __popc(lanes);
                __syncwarp();
                if (queued >= 32) step(32);
              }
            }
          }
        }
        __syncwarp();  // the staged pins are read before the next stage
      }
    }
    if (queued > 0) step(queued);

    for (int k = lane; k < cnt; k += 32) {
      eta[lo + b0 + k] = bin_eta[k];
      inter[lo + b0 + k] = bin_inter[k];
    }
    __syncwarp();
  }
}

}  // namespace

// bins: the neighbour slots a warp holds at once (the wrapper's
// ops.bin_budget); a node with more takes them in batches. The launch
// covers the node rows [row0, row0 + nrows): eta and inter hold the slots
// from nbr_off[row0] on, and with `tail` also the zeroed slots from
// nbr_off[ncap] to nbcap (the last stripe of a sharded level, or the whole
// level on one device).
extern "C" int pair_scores_launch(const void* node_off, const void* node_edges,
                                  const void* node_nin, const void* edge_off,
                                  const void* edge_pins, const void* edge_nsrc,
                                  const void* edge_w, const void* nbr_off,
                                  const void* nbr_ids, void* eta, void* inter,
                                  int ncap, int ecap, int nbcap, int bins,
                                  int row0, int nrows, int tail,
                                  void* stream) {
  if (ncap <= 0 || ecap <= 0 || nbcap <= 0) return static_cast<int>(cudaSuccess);
  if (row0 < 0 || nrows < 0 || row0 + nrows > ncap)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nrows == 0 && !tail) return static_cast<int>(cudaSuccess);
  const size_t smem =
      static_cast<size_t>(kWarps) * warp_words(bins) * sizeof(int);
  if (bins <= 0 || smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      pair_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = ((nrows > 0 ? nrows : 1) + kWarps - 1) / kWarps;
  pair_scores_kernel<<<grid, kWarps * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(node_off), static_cast<const int*>(node_edges),
      static_cast<const int*>(node_nin), static_cast<const int*>(edge_off),
      static_cast<const int*>(edge_pins), static_cast<const int*>(edge_nsrc),
      static_cast<const float*>(edge_w), static_cast<const int*>(nbr_off),
      static_cast<const int*>(nbr_ids), static_cast<float*>(eta),
      static_cast<int*>(inter), ncap, ecap, nbcap, bins, row0, nrows,
      tail != 0);
  return static_cast<int>(cudaGetLastError());
}
