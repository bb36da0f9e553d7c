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
// [nrows, kcap] rows; the caller uses the free [kcap, ecap] transpose
// view, and the gains kernel reads the rows. Part ids outside [0, kcap)
// drop out; pin ids are clamped to [0, ncap).
//
// What bounds it: bytes, and at small kcap the launch. At kcap 1024 on
// the main-path level (ecap 122880, 2.09M pins) the two outputs are
// 2 * ecap * kcap * 4 B = 1.0 GB against about 10 MB of CSR input, so the
// output write is the floor (0.30 ms at 3.35 TB/s). At kcap 2 the outputs
// are 2 MB and the whole call moves about 12 MB (3.5 us): an edge averages
// 17 pins, so a block per edge would leave 240 of 256 threads idle and
// schedule 122,880 blocks of two barriers each; the time is then the
// blocks', not the bytes', unless a block takes many edges.
//
// Design (tile_plan in kernels/pins_count/ops.py picks the numbers):
// - Edge tiles. A block takes TE consecutive rows, whose pins are one
//   contiguous CSR span. It loads the tile's offsets into shared memory,
//   its 256 threads stride over the span with coalesced loads (balanced by
//   pins, not edges), each pin finds its row by binary search over the
//   offsets and counts with shared-memory integer atomics, exact and free
//   of order. TE is the largest power of two in [1, 128] whose two
//   [TE, kcap] counter blocks fit 16 KB: 128 at kcap 2, 16 at kcap 128,
//   2 at kcap 1024 (the best of TE 1-256 timed at those three).
// - A persistent grid: as many blocks as fit on the SMs at that shared
//   memory, each walking tiles blockIdx.x, + gridDim.x, ... (960 blocks
//   for 960 tiles at kcap 2, 792 for 61,440 tiles at kcap 1024).
// - Bulk asynchronous stores. A tile's rows are one contiguous span in
//   each output; one thread writes it from shared memory with
//   cp.async.bulk (after fence.proxy.async), double-buffered so tile i's
//   stores drain while tile i+1 counts. Each output byte is written once.
//   A ragged last tile, a span that is not a multiple of 16 bytes or a
//   misaligned output takes plain (vectorised where aligned) stores.
// - A dead tile (an empty pin span: rows past the live count) skips the
//   counting and the barriers and bulk-stores zeros from a zeroed region.
// - Above 48 KB the counters take dynamic shared memory up to the card's
//   227 KB (TE 1 holds kcap up to 29,056); past that the rows are zeroed
//   in global memory and counted with global integer atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 4;        // pins a thread loads before counting them
constexpr int kZeroInts = 1024;  // the dead tiles' zero source (4 KB)
constexpr size_t kStaticSmem = 48 * 1024;

struct Args {
  const int* edge_off;
  const int* edge_pins;
  const int* edge_nsrc;
  const int* parts;
  int* pins;
  int* pins_in;
  int ncap, kcap, row0, nrows;
  int te;         // rows a tile (a power of two)
  int stages;     // counter buffers (2: stores overlap the next tile)
  int zero_ints;  // ints of the zero region (0: no dead-tile shortcut)
  bool bulk;      // full tiles leave by cp.async.bulk
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// shared -> global, `bytes` a multiple of 16, both ends 16-byte aligned
__device__ __forceinline__ void bulk_store(int* gmem, const int* smem,
                                           int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(gmem), "r"(smem_u32(smem)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// dst[0, n) = src[0, n) (src null: zeros) by the whole block, 16 bytes a
// store where both ends are aligned
__device__ void plain_store(int* dst, const int* src, int n) {
  int head = 0;
  if (aligned16(dst) && (src == nullptr || aligned16(src))) {
    const int n4 = n >> 2;
    int4* d4 = reinterpret_cast<int4*>(dst);
    const int4* s4 = reinterpret_cast<const int4*>(src);
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      d4[i] = src ? s4[i] : make_int4(0, 0, 0, 0);
    head = n4 << 2;
  }
  for (int i = head + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src ? src[i] : 0;
}

__device__ void zero_smem(int* p, int n) {
  int head = 0;
  if (aligned16(p)) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      reinterpret_cast<int4*>(p)[i] = make_int4(0, 0, 0, 0);
    head = n4 << 2;
  }
  for (int i = head + threadIdx.x; i < n; i += blockDim.x) p[i] = 0;
}

// the row r of [0, rows) whose slots [offs[r], offs[r+1]) hold slot s
__device__ __forceinline__ int find_row(const int* offs, int rows, int s) {
  int lo = 0, hi = rows - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (offs[mid] <= s) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
pins_count_tiles(const Args a) {
  extern __shared__ __align__(16) int smem[];
  const int span = a.te * a.kcap;
  const bool one = a.te == 1;    // a tile's bounds stay in registers
  int* zeros = smem + a.stages * 2 * span;
  int* offs = zeros + a.zero_ints;  // [te + 1] slot offsets
  int* dst0 = offs + a.te + 1;      // [te] each row's first dst slot
  if (a.zero_ints > 0) {
    zero_smem(zeros, a.zero_ints);
    fence_proxy_async();  // the zeros, visible to the bulk copies
    __syncthreads();
  }
  const int ntiles = (a.nrows + a.te - 1) / a.te;
  int live = 0;  // tiles this block counted: picks the counter buffer
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int r0 = t * a.te;
    const int rows = min(a.te, a.nrows - r0);
    const int e0 = a.row0 + r0;
    const int lo = __ldg(a.edge_off + e0);
    const int hi = __ldg(a.edge_off + e0 + rows);
    const int n = rows * a.kcap;
    int* out = a.pins + static_cast<int64_t>(r0) * a.kcap;
    int* out_in = a.pins_in + static_cast<int64_t>(r0) * a.kcap;
    const bool bulk = a.bulk && rows == a.te;
    if (lo == hi && a.zero_ints > 0) {  // dead tile: zeros, no barrier
      if (bulk) {
        if (threadIdx.x == 0) {
          for (int i = 0; i < n; i += a.zero_ints) {
            const int bytes = 4 * min(a.zero_ints, n - i);
            bulk_store(out + i, zeros, bytes);
            bulk_store(out_in + i, zeros, bytes);
          }
          bulk_commit();
        }
      } else {
        plain_store(out, nullptr, n);
        plain_store(out_in, nullptr, n);
      }
      continue;
    }
    int* c = smem + (a.stages == 2 ? (live & 1) : 0) * 2 * span;
    int* c_in = c + span;
    ++live;
    // the buffer's last bulk group (two live tiles back, or one with a
    // single buffer) has finished reading it
    if (threadIdx.x == 0) {
      if (a.stages == 2) bulk_wait_read<1>(); else bulk_wait_read<0>();
    }
    __syncthreads();
    zero_smem(c, 2 * span);
    int my_dst0 = 0;
    if (one) {
      my_dst0 = lo + __ldg(a.edge_nsrc + e0);
    } else {
      for (int i = threadIdx.x; i <= rows; i += blockDim.x) {
        const int o = __ldg(a.edge_off + e0 + i);
        offs[i] = o;
        if (i < rows) dst0[i] = o + __ldg(a.edge_nsrc + e0 + i);
      }
    }
    __syncthreads();
    for (int s0 = lo + threadIdx.x; s0 < hi; s0 += kBatch * blockDim.x) {
      int p[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int s = s0 + u * blockDim.x;
        p[u] = s < hi ? __ldg(a.edge_pins + s) : -1;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int s = s0 + u * blockDim.x;
        p[u] = s < hi ? __ldg(a.parts + min(max(p[u], 0), a.ncap - 1)) : -1;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int s = s0 + u * blockDim.x;
        if (p[u] >= 0 && p[u] < a.kcap) {  // s >= hi gave -1
          const int r = one ? 0 : find_row(offs, rows, s);
          const int k = r * a.kcap + p[u];
          atomicAdd(&c[k], 1);
          if (s >= (one ? my_dst0 : dst0[r])) atomicAdd(&c_in[k], 1);
        }
      }
    }
    if (bulk) fence_proxy_async();  // this thread's counts, to the copies
    __syncthreads();
    if (bulk) {
      if (threadIdx.x == 0) {
        bulk_store(out, c, 4 * n);
        bulk_store(out_in, c_in, 4 * n);
        bulk_commit();
      }
    } else {
      plain_store(out, c, n);
      plain_store(out_in, c_in, n);
    }
  }
  // shared memory stays until the last copies have read it, and the rows
  // are written before the block retires
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// counters too wide for shared memory: each block zeroes its rows in
// global memory and counts there with integer atomics
__global__ void __launch_bounds__(kThreads)
pins_count_global(const Args a) {
  for (int r = blockIdx.x; r < a.nrows; r += gridDim.x) {
    const int e = a.row0 + r;
    int* row = a.pins + static_cast<int64_t>(r) * a.kcap;
    int* row_in = a.pins_in + static_cast<int64_t>(r) * a.kcap;
    plain_store(row, nullptr, a.kcap);
    plain_store(row_in, nullptr, a.kcap);
    __syncthreads();
    const int lo = __ldg(a.edge_off + e);
    const int hi = __ldg(a.edge_off + e + 1);
    const int d0 = lo + __ldg(a.edge_nsrc + e);
    for (int s = lo + threadIdx.x; s < hi; s += blockDim.x) {
      const int pin = min(max(__ldg(a.edge_pins + s), 0), a.ncap - 1);
      const int p = __ldg(a.parts + pin);
      if (p >= 0 && p < a.kcap) {
        atomicAdd(&row[p], 1);
        if (s >= d0) atomicAdd(&row_in[p], 1);
      }
    }
  }
}

}  // namespace

// te, stages and grid come from ops.py::tile_plan; stages 0 takes the
// global-memory path. The shared-memory layout below is the one tile_plan
// sizes: stages x 2 counter blocks [te, kcap], the zero region (two
// stages of full-width spans only), then the offsets unless te is 1.
extern "C" int pins_count_launch(const void* edge_off, const void* edge_pins,
                                 const void* edge_nsrc, const void* parts,
                                 void* pins, void* pins_in, int ecap, int ncap,
                                 int kcap, int row0, int nrows, int te,
                                 int stages, int grid, void* stream) {
  if (nrows <= 0 || kcap <= 0) return static_cast<int>(cudaSuccess);
  if (row0 < 0 || row0 + nrows > ecap || grid <= 0 || te < 1 || te > 256 ||
      (te & (te - 1)) != 0 || stages < 0 || stages > 2 ||
      static_cast<int64_t>(te) * kcap > (1 << 28))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{static_cast<const int*>(edge_off), static_cast<const int*>(edge_pins),
         static_cast<const int*>(edge_nsrc), static_cast<const int*>(parts),
         static_cast<int*>(pins), static_cast<int*>(pins_in), ncap, kcap, row0,
         nrows, te, stages, 0, false};
  if (stages == 0) {
    pins_count_global<<<grid, kThreads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int span = te * kcap;
  a.bulk = span % 4 == 0 && (reinterpret_cast<uintptr_t>(pins) & 15) == 0 &&
           (reinterpret_cast<uintptr_t>(pins_in) & 15) == 0;
  a.zero_ints = a.bulk && stages == 2 ? (span < kZeroInts ? span : kZeroInts)
                                      : 0;
  const size_t smem =
      sizeof(int) * (static_cast<size_t>(stages) * 2 * span + a.zero_ints +
                     (te == 1 ? 0 : 2 * te + 1));
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        pins_count_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pins_count_tiles<<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
