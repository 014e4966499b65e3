// The capability probes: ports of the @probe kernels of
// tools/mosaic_probe.py, which check the Mosaic primitives the fused TPU
// kernels are built on. Each kernel here computes what its TPU probe
// computes, through the Hopper primitive that plays the same role:
//
//   hbm_scratch   (:38)  1-D bulk async copies (cp.async.bulk) completing on
//                        an mbarrier, a bulk store to a device-memory scratch
//                        and back, fence.proxy.async between the proxies;
//                        the rows dealt to 16 CTAs
//   fori_dma      (:65)  a loop of bulk copies through a ring of stage
//                        buffers, one mbarrier a stage re-armed each use
//                        (phase parity)
//   argmax        (:93)  the loads in flight before the first compare, a
//                        32-bit order a value (NaN above +inf, -0 as +0),
//                        one 64-bit key a thread (~index below), a max of
//                        keys by warp shuffles; JAX's `cols` on a NaN row
//   dyn_sublane   (:115) a device-held index read in the kernel while a
//                        bulk copy stages the table beside it, a 128 KB
//                        dynamic shared scratch indexed by it
//   rot           (:139) rotate-half as a lane map of float4 / float2 /
//                        float vectors over a 2-D grid, the sign bit
//                        flipped, no division an element
//   onehot        (:158) one-hot x table as JAX computes it, NaN columns
//                        included: a scan of the whole table for non-
//                        finite entries in blocks of 8 columns, a CTA
//                        each, the chosen entries loaded behind the
//                        scan's first batch
//   dyn_col_dma   (:180) a 2-D TMA tiled load at coordinates computed in the
//                        kernel from a device-held index, a bulk store of
//                        it; the rows dealt to CTAs
//
// The eighth, int8_panel (:208: TMA loads of an int8 panel, int8 -> bf16,
// a bf16 dot into f32), computes kernel A's function (out = x @ w[:, :256],
// bf16 x, int8 w, f32 out), so its wrapper (tools/mosaic_probe.py
// int8_panel) launches kernel A itself (csrc/qmatmul.cu: a TMA ring along
// K, ldmatrix.trans fragments of a 128-byte-swizzled tile, int8 -> bf16 in
// registers, wgmma with A from registers, the K split summed in a
// cluster), with unit column scales; it has no kernel here.
//
// Bound: none of them is a path of the system; each is one block (or a few)
// at fixed small shapes, latency first: launch and dependent copies, not
// bytes. Each was redesigned for this card: copies spread over CTAs, kept
// in flight by a ring, issued before the index they wait on is read, or
// all of a thread's loads issued before its first compare, test or store.
// The geometry macros (SCRATCH_CTAS, FORI_STAGES, ARGMAX_THREADS,
// ROT_ITEMS, ONEHOT_COLS, COL_ROWS) are each the one place that sets its
// number. Every launch function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tensor_map.cuh"

namespace {

// ------------------------------------------------------------ primitives
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of async transfers to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// block until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// global -> shared, `bytes` contiguous (multiple of 16), on the mbarrier
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared -> global, `bytes` contiguous, as one bulk group
__device__ __forceinline__ void bulk_s2g(void* dst, const void* src,
                                         uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
                   "l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk groups have read their sources (shared memory may be
// written again)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// this thread's bulk groups have completed their writes
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's generic-proxy accesses of shared memory are ordered before
// later async-proxy (bulk copy / TMA) accesses
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2-D TMA tile load: box at (c0 innermost, c1) of the tensor map
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// a start index as lax.dynamic_slice takes it: a negative start counts
// from the end, then the start is clamped so that `size` elements fit
__device__ __forceinline__ int dynamic_start(int start, int dim, int size) {
  if (start < 0) start += dim;
  return min(max(start, 0), dim - size);
}

// ------------------------------------------------------- 5: hbm_scratch
// The tile's 64 rows are dealt to kScratchCtas CTAs, a slice of rows each.
// Each CTA runs the whole protocol on its slice, so the slices' copies go
// through as many SMs' copy engines at once: bulk load on an mbarrier
// (phase 0); bulk store to its part of the scratch, its source read
// awaited before the generic clear of the buffer and fence.proxy.async,
// its writes awaited before the reload (phase 1); then 2x with 16-byte
// stores, one float4 a thread. Three dependent round trips through the
// L2 remain: they, not bytes, bound it. 16 CTAs of 4 rows measured ~3%
// faster than 8 of 8 and 32 of 2, 4 of 16 ~12% slower (H100, CUDA-graph
// replay; tools/frame_measure.py probes with -DSCRATCH_CTAS=N).
constexpr int kScratchElems = 64 * 128;
#ifndef SCRATCH_CTAS
#define SCRATCH_CTAS 16
#endif
constexpr int kScratchCtas = SCRATCH_CTAS;               // 4 rows a CTA
static_assert(64 % kScratchCtas == 0, "whole rows a CTA");
constexpr int kScratchSlice = kScratchElems / kScratchCtas;
constexpr uint32_t kScratchSliceBytes = kScratchSlice * sizeof(float);
constexpr int kScratchThreads = kScratchSlice / 4;      // a float4 each

__global__ void __launch_bounds__(kScratchThreads)
hbm_scratch_kernel(const float* __restrict__ x, float* scratch,
                   float* __restrict__ out) {
  __shared__ __align__(128) float4 buf[kScratchThreads];
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * kScratchSlice;
  if (tid == 0) {                       // x's slice -> shared (phase 0)
    mbar_init(&bar, 1);
    mbar_expect_tx(&bar, kScratchSliceBytes);
    bulk_g2s(buf, x + base, kScratchSliceBytes, &bar);
  }
  __syncthreads();
  mbar_wait(&bar, 0);
  if (tid == 0) {                       // -> the slice's part of the scratch
    bulk_s2g(scratch + base, buf, kScratchSliceBytes);
    bulk_wait_read();
  }
  __syncthreads();
  // clear the buffer with generic stores, so that only the reload can
  // refill it; the fence orders them before the async write below
  buf[tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {                       // scratch -> shared (phase 1)
    bulk_wait();
    mbar_expect_tx(&bar, kScratchSliceBytes);
    bulk_g2s(buf, scratch + base, kScratchSliceBytes, &bar);
  }
  mbar_wait(&bar, 1);
  const float4 v = buf[tid];
  reinterpret_cast<float4*>(out + base)[tid] =
      make_float4(2.f * v.x, 2.f * v.y, 2.f * v.z, 2.f * v.w);
}

// ---------------------------------------------------------- 6: fori_dma
// A ring of kForiStages stage buffers, each on its own mbarrier: the
// first min(steps, kForiStages) copies are issued before any sum, and
// stage s = i % kForiStages, once step i has been summed from it, is
// re-armed (phase i / kForiStages + 1, parity) with step i + kForiStages.
// So the copies' latencies overlap instead of adding up; the sum stays in
// the order o = 0; o += w[i]. One CTA, a thread sums one float4. At the
// probe's 4 steps, 4 stages measured ~2% faster than 3 and ~5% than 2
// (H100, CUDA-graph replay; tools/frame_measure.py probes with
// -DFORI_STAGES=N), and the rows dealt to 2 or 8 CTAs, a ring each, no
// faster than one.
constexpr int kSliceElems = 8 * 128;
#ifndef FORI_STAGES
#define FORI_STAGES 4
#endif
constexpr int kForiStages = FORI_STAGES;
constexpr uint32_t kSliceBytes = kSliceElems * sizeof(float);      // 4 KB
constexpr int kForiThreads = kSliceElems / 4;

__global__ void __launch_bounds__(kForiThreads)
fori_dma_kernel(const float* __restrict__ w, float* __restrict__ out,
                int steps) {
  __shared__ __align__(128) float4 buf[kForiStages][kForiThreads];
  __shared__ __align__(8) uint64_t full[kForiStages];
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kForiStages; ++s) mbar_init(&full[s], 1);
    for (int s = 0; s < kForiStages && s < steps; ++s) {
      mbar_expect_tx(&full[s], kSliceBytes);
      bulk_g2s(buf[s], w + (int64_t)s * kSliceElems, kSliceBytes, &full[s]);
    }
  }
  __syncthreads();
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < steps; ++i) {
    const int s = i % kForiStages;
    mbar_wait(&full[s], (i / kForiStages) & 1);
    const float4 v = buf[s][tid];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
    if (i + kForiStages < steps) {      // refill stage s with step i + S
      fence_proxy_async();              // the reads before the async write
      __syncthreads();
      if (tid == 0) {
        mbar_expect_tx(&full[s], kSliceBytes);
        bulk_g2s(buf[s], w + (int64_t)(i + kForiStages) * kSliceElems,
                 kSliceBytes, &full[s]);
      }
    }
  }
  reinterpret_cast<float4*>(out)[tid] = acc;
}

// ------------------------------------------------------------ 7: argmax
// The TPU probe's result: the lowest index among each row's maxima, `cols`
// for a row that holds a NaN (jnp.max carries it and x >= NaN never
// holds), broadcast over `lanes`. A row's result is the largest of one
// 64-bit key a thread, a larger key winning: the high word is the order of
// the thread's largest value mapped to unsigned (order_of: -0 folded into
// +0, which the TPU formula's >= does not tell apart; any NaN above +inf,
// and then kNanMark), the low word ~index of its first occurrence, so
// equal values go to the lower index.
//
// A CTA a row, ARGMAX_THREADS threads (-D, the one place that sets them).
// Each thread issues a batch of loads before its first compare: its share
// of the probe's 2048-column row (kArgVec float4 through the read-only
// path where the row starts 16-byte aligned and cols % 4 == 0, 4 kArgVec
// scalars otherwise), so at the probe's shape one batch covers the row.
// Then, in registers, each value's order (no predicate but the NaN
// select), their max and the first index holding it. The keys reduce by
// xor shuffles in each warp, one shared slot a warp, one __syncthreads,
// and warp 0 reduces the slots by shuffles and writes the row's lanes
// (16-byte stores where lanes % 4 == 0). Bound: one launch, one dependent
// read of the row and the dependent steps of the reduction, not bytes (8
// rows of 8 KiB). At the probe's [8, 2048], 256 threads measured 0.0019-
// 0.0020 ms, 512 and 128 2-4% slower, 64 ~20% and 32 ~2x (one thread's
// 64 values in a chain); a running 64-bit key an element, unrolled for 16
// float4s whatever the work, 0.0026 at 128 threads, and redux.sync in
// place of the shuffles no faster (H100, CUDA-graph replay;
// tools/frame_measure.py probes with -DARGMAX_THREADS=N).
#ifndef ARGMAX_THREADS
#define ARGMAX_THREADS 256
#endif
constexpr int kArgThreads = ARGMAX_THREADS;
constexpr int kArgWarps = kArgThreads / 32;
static_assert(kArgThreads % 32 == 0 && kArgThreads <= 1024 &&
                  (kArgWarps & (kArgWarps - 1)) == 0,
              "a power of two of whole warps");
// a batch: each thread's share of a 2048-column row (the probe's), so
// that no unrolled load or compare is issued without work at that shape
constexpr int kArgVec = 2048 / 4 / kArgThreads > 0 ? 2048 / 4 / kArgThreads
                                                    : 1;
constexpr int kArgScalar = 4 * kArgVec;
constexpr uint32_t kNanMark = 0xffffffffu;

// x's order as a signed int: -|x| for a negative x, |x| otherwise, so -0
// and +0 are both 0; a NaN of either sign above +inf
__device__ __forceinline__ int order_of(float x) {
  const uint32_t b = __float_as_uint(x);
  const int a = static_cast<int>(b & 0x7fffffffu);
  const int m = static_cast<int>(b) >> 31;
  return a > 0x7f800000 ? a : (a ^ m) - m;
}

__device__ __forceinline__ unsigned long long key_max(unsigned long long a,
                                                      unsigned long long b) {
  return a > b ? a : b;
}

// a batch of N values at increasing indices i[e] (ok[e]: in the row):
// their largest order and its first index, folded into (best, at); a tie
// with an earlier batch keeps the earlier, lower index
template <int N>
__device__ __forceinline__ void fold(const float (&v)[N], const int (&i)[N],
                                     const bool (&ok)[N], int& best,
                                     int& at) {
  int ord[N];
  int m = INT_MIN;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    ord[e] = ok[e] ? order_of(v[e]) : INT_MIN;
    m = max(m, ord[e]);
  }
  int first = INT_MAX;
#pragma unroll
  for (int e = 0; e < N; ++e)
    first = min(first, ord[e] == m ? i[e] : INT_MAX);
  if (m > best) {
    best = m;
    at = first;
  }
}

template <bool kVecIn, bool kVecOut>
__global__ void __launch_bounds__(kArgThreads)
argmax_kernel(const float* __restrict__ x, int* __restrict__ out, int cols,
              int lanes) {
  const int tid = threadIdx.x, lane = tid % 32;
  const float* xr = x + static_cast<int64_t>(blockIdx.x) * cols;
  int best = INT_MIN, at = cols;        // below every value's order
  if (kVecIn) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const int n4 = cols / 4;
    for (int c0 = tid; c0 < n4; c0 += kArgVec * kArgThreads) {
      float4 w[kArgVec];
#pragma unroll
      for (int k = 0; k < kArgVec; ++k) {
        const int c = c0 + k * kArgThreads;
        w[k] = c < n4 ? __ldg(x4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float v[4 * kArgVec];
      int i[4 * kArgVec];
      bool ok[4 * kArgVec];
#pragma unroll
      for (int k = 0; k < kArgVec; ++k) {
        const int c = c0 + k * kArgThreads;
        v[4 * k] = w[k].x;
        v[4 * k + 1] = w[k].y;
        v[4 * k + 2] = w[k].z;
        v[4 * k + 3] = w[k].w;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          i[4 * k + e] = 4 * c + e;
          ok[4 * k + e] = c < n4;
        }
      }
      fold(v, i, ok, best, at);
    }
  } else {
    for (int64_t c0 = tid; c0 < cols; c0 += kArgScalar * kArgThreads) {
      float v[kArgScalar];
      int i[kArgScalar];
      bool ok[kArgScalar];
#pragma unroll
      for (int k = 0; k < kArgScalar; ++k) {
        const int64_t c = c0 + k * kArgThreads;
        ok[k] = c < cols;
        i[k] = static_cast<int>(c);
        v[k] = ok[k] ? __ldg(xr + c) : 0.f;
      }
      fold(v, i, ok, best, at);
    }
  }
  const uint32_t hi = best > 0x7f800000
                          ? kNanMark
                          : static_cast<uint32_t>(best) ^ 0x80000000u;
  unsigned long long key = (static_cast<unsigned long long>(hi) << 32) |
                           static_cast<uint32_t>(~at);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    key = key_max(key, __shfl_xor_sync(0xffffffffu, key, off));
  if constexpr (kArgWarps > 1) {
    __shared__ unsigned long long slot[kArgWarps];
    if (lane == 0) slot[tid / 32] = key;
    __syncthreads();
    if (tid >= 32) return;
    key = lane < kArgWarps ? slot[lane] : 0ull;
#pragma unroll
    for (int off = kArgWarps / 2; off > 0; off >>= 1)
      key = key_max(key, __shfl_xor_sync(0xffffffffu, key, off));
    key = __shfl_sync(0xffffffffu, key, 0);
  }
  const int idx = static_cast<uint32_t>(key >> 32) == kNanMark
                      ? cols
                      : static_cast<int>(~static_cast<uint32_t>(key));
  int* orow = out + static_cast<int64_t>(blockIdx.x) * lanes;
  if (kVecOut) {
    const int4 q = make_int4(idx, idx, idx, idx);
    for (int l = lane; l < lanes / 4; l += 32)
      reinterpret_cast<int4*>(orow)[l] = q;
  } else {
    for (int l = lane; l < lanes; l += 32) orow[l] = idx;
  }
}

// ------------------------------------------------------- 8: dyn_sublane
// The TPU probe keeps the table c in VMEM and writes row pos of it into
// row pos of an [8, 32, 128] scratch. Here thread 0 stages the whole 16 KB
// table in shared memory with one bulk copy on an mbarrier at entry, while
// warp 1 reads pos and clamps it, so the row's address no longer waits on
// pos before data moves: one global round trip, not two. The scratch keeps
// the probe's layout and is not cleared (only row p is read back). Warp s
// writes copy s, a float4 a lane; the read-back takes another thread
// mapping (copies and lanes reversed) and stores out as float4.
constexpr int kSubRows = 32, kSubLanes = 128, kSubCopies = 8;
constexpr int kSubRow4 = kSubLanes / 4;                        // float4s a row
constexpr uint32_t kSubTabBytes = kSubRows * kSubLanes * 4;    // 16 KB
constexpr int kSubBufBytes = kSubCopies * kSubTabBytes;        // 128 KB
constexpr int kSubThreads = kSubCopies * 32;                   // a warp a copy
static_assert(kSubThreads == kSubCopies * kSubRow4, "a float4 a thread out");

__global__ void __launch_bounds__(kSubThreads)
dyn_sublane_kernel(const float* __restrict__ c, const int* __restrict__ pos,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  float4* buf = reinterpret_cast<float4*>(dyn_smem);   // [8][32][32] float4
  __shared__ __align__(128) float4 tab[kSubRows * kSubRow4];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int sp;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {                       // the table -> shared, not waiting on pos
    mbar_init(&bar, 1);
    mbar_expect_tx(&bar, kSubTabBytes);
    bulk_g2s(tab, c, kSubTabBytes, &bar);
  } else if (tid == 32) {               // the index, from device memory
    sp = dynamic_start(pos[0], kSubRows, 1);
  }
  __syncthreads();
  const int p = sp;
  mbar_wait(&bar, 0);
  buf[(warp * kSubRows + p) * kSubRow4 + lane] =
      tab[p * kSubRow4 + lane];
  __syncthreads();
  // read back through another thread mapping than the write
  const int j = kSubThreads - 1 - tid;
  const int s = j / kSubRow4, l = j % kSubRow4;
  reinterpret_cast<float4*>(out)[j] =
      buf[(s * kSubRows + p) * kSubRow4 + l];
}

// --------------------------------------------------------------- 9: rot
// out[..., :h] = -x[..., h:], out[..., h:] = x[..., :h] (h = d / 2), as a
// lane map of vectors of V floats: the host picks the widest V of 4, 2, 1
// that divides h and fits both pointers' alignment, so no vector straddles
// the halves. A 2-D grid: x over a row's d / V vectors (blocks of up to
// kRotThreads threads, the rest of the block over rows), y over groups of
// rows; vector j of a row reads vector j + h / V or j - h / V of the same
// row, so an element costs no division or modulo. Each thread handles
// ROT_ITEMS (-D, the one place that sets it) rows of its column: it issues
// their loads (ld.global.nc) before its stores. The negation flips the
// sign bit of every value (-0, +-inf and NaN included), as jnp's -x does
// on the CPU; the compiler's float negation (torch.neg on the card) would
// give the canonical NaN 0x7fffffff for a NaN.
// Bound: one launch and a dependent read, not bytes (64 KiB each way at
// the probe's [8, 16, 128]). There 1 row a thread (32 CTAs) measured
// 0.0015-0.00155 ms, 2 rows ~3% and 4 ~7% slower (H100, CUDA-graph
// replay; tools/frame_measure.py probes with -DROT_ITEMS=N).
#ifndef ROT_ITEMS
#define ROT_ITEMS 1
#endif
constexpr int kRotItems = ROT_ITEMS;
constexpr int kRotThreads = 128;
static_assert(kRotItems >= 1, "rows a thread");

template <int V>
struct RotVec;
template <>
struct RotVec<1> {
  using T = float;
  static __device__ __forceinline__ T flip(T v) {
    return __uint_as_float(__float_as_uint(v) ^ 0x80000000u);
  }
};
template <>
struct RotVec<2> {
  using T = float2;
  static __device__ __forceinline__ T flip(T v) {
    return make_float2(RotVec<1>::flip(v.x), RotVec<1>::flip(v.y));
  }
};
template <>
struct RotVec<4> {
  using T = float4;
  static __device__ __forceinline__ T flip(T v) {
    return make_float4(RotVec<1>::flip(v.x), RotVec<1>::flip(v.y),
                       RotVec<1>::flip(v.z), RotVec<1>::flip(v.w));
  }
};

template <int V>
__global__ void __launch_bounds__(kRotThreads)
rot_kernel(const float* __restrict__ x, float* __restrict__ out,
           int64_t rows, int hv) {
  using T = typename RotVec<V>::T;
  const T* xv = reinterpret_cast<const T*>(x);
  T* ov = reinterpret_cast<T*>(out);
  const int dv = 2 * hv;                                  // vectors a row
  const int j = blockIdx.x * blockDim.x + threadIdx.x;    // this column
  if (j >= dv) return;
  const bool neg = j < hv;
  const int src = neg ? j + hv : j - hv;
  const int64_t group = static_cast<int64_t>(blockDim.y) * kRotItems;
  for (int64_t r0 = blockIdx.y * group + threadIdx.y; r0 < rows;
       r0 += gridDim.y * group) {
    T v[kRotItems];
#pragma unroll
    for (int k = 0; k < kRotItems; ++k) {
      const int64_t r = r0 + static_cast<int64_t>(k) * blockDim.y;
      if (r < rows) v[k] = __ldg(xv + r * dv + src);
    }
#pragma unroll
    for (int k = 0; k < kRotItems; ++k) {
      const int64_t r = r0 + static_cast<int64_t>(k) * blockDim.y;
      if (r < rows) ov[r * dv + j] = neg ? RotVec<V>::flip(v[k]) : v[k];
    }
  }
}

// ------------------------------------------------------------ 10: onehot
// The TPU probe computes jnp.dot(one_hot(codes[:, 0]), tab): a sum over
// every row of the table, in which 0 * inf and 0 * NaN are NaN. With c =
// codes[r, 0], hit = 0 <= c < vocab and n_j the non-finite entries
// (exponent bits all ones) of column j, out[r, j] is NaN where hit and
// tab[c, j] is NaN, else NaN where n_j - (hit && tab[c, j] non-finite) >
// 0, else tab[c, j] where hit, else 0: the same value as JAX's, not its
// NaN payload or the sign of a zero sum.
//
// So the function reads the whole table. The grid is ceil(d / ONEHOT_COLS)
// column blocks, one CTA of kOneWarps warps each. A warp reads 32 / C rows
// of a block of C = ONEHOT_COLS columns at once (C a divisor of 32: C * 4
// bytes of each row, whole 32-byte sectors from C = 8); the warps and lane
// rows of the CTA stride over the vocab, and over the output rows. A
// thread reads the code of its first output row, issues the first batch
// of the table (kOneBatch rows: the whole table at the probe's vocab, at
// most 32 loads), and only then the load of tab[c, j] for its column,
// which waits on the code: no load that can go waits for one that cannot.
// Every address is clamped into the table and each load's validity is a
// mask of its test, so a batch is one straight run of loads. Each
// column's non-finite entries are counted in a register, summed over a
// warp's lane rows by shuffles and over the warps through shared memory;
// a thread then writes its output rows by the rule above. Scalar loads, so
// any contiguous table, aligned or not.
// Bound: one launch, the table's read and the dependent code -> entry
// loads, not bytes (the table, 8 codes and the output: 132 KiB at the
// probe's [8, 128] codes and [256, 128] table, 4.0e-05 ms at 3.35 TB/s).
// There 8 columns (16 CTAs of 512 threads, 8 KiB of the table and 4 loads
// a thread) measured fastest, 0.00202 ms: wider blocks leave fewer CTAs to
// share the scan, and with 8 KiB a CTA nothing is left for a cluster that
// splits the vocab to save that pays for its launch and barriers (H100,
// CUDA-graph replay; tools/frame_measure.py probes with -DONEHOT_COLS=N;
// the variants, cluster splits included, in PERF.md section 6).
#ifndef ONEHOT_COLS
#define ONEHOT_COLS 8
#endif
constexpr int kOneCols = ONEHOT_COLS;
static_assert(kOneCols >= 1 && 32 % kOneCols == 0, "a divisor of 32 lanes");
constexpr int kOneVocab = 256;                     // the probe's table rows
constexpr int kOneWarps = 16;
constexpr int kOneThreads = 32 * kOneWarps;
constexpr int kOneLaneRows = 32 / kOneCols;        // rows of a warp
constexpr int kOneRows = kOneWarps * kOneLaneRows; // rows of a CTA
// a batch: a thread's share of the probe's table, at most 32 loads
constexpr int kOneShare = kOneVocab / kOneRows > 0 ? kOneVocab / kOneRows : 1;
constexpr int kOneBatch = kOneShare < 32 ? kOneShare : 32;

__device__ __forceinline__ bool non_finite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u;
}

// out[r, j] from e = tab[c, j] (0 for a miss) and the column's count n
__device__ __forceinline__ float onehot_value(float e, bool hit, int n) {
  const int others = n - (hit && non_finite(e) ? 1 : 0);
  return isnan(e) ? e : others > 0 ? __int_as_float(0x7fffffff) : e;
}

// tab[r, j], r and j clamped into the table
__device__ __forceinline__ float onehot_load(const float* __restrict__ tab,
                                             int r, int vocab, int j, int d) {
  return __ldg(tab + static_cast<int64_t>(min(r, vocab - 1)) * d +
               min(j, d - 1));
}

__global__ void __launch_bounds__(kOneThreads)
onehot_kernel(const int* __restrict__ codes, const float* __restrict__ tab,
              float* __restrict__ out, int rows, int ld_codes, int vocab,
              int d) {
  __shared__ int slot[kOneWarps * kOneCols];       // the column counts a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = lane % kOneCols, sub = lane / kOneCols;
  const int j = blockIdx.x * kOneCols + col;
  const int first = warp * kOneLaneRows + sub;     // table and output row
  int c = first < rows ? __ldg(codes + static_cast<int64_t>(first) * ld_codes)
                       : -1;
  float v[kOneBatch];
  int r0 = first;
#pragma unroll
  for (int i = 0; i < kOneBatch; ++i)
    v[i] = onehot_load(tab, r0 + i * kOneRows, vocab, j, d);
  bool hit = c >= 0 && c < vocab;
  float e = onehot_load(tab, hit ? c : 0, vocab, j, d);
  int n = 0;
  while (true) {
#pragma unroll
    for (int i = 0; i < kOneBatch; ++i)
      n += r0 + i * kOneRows < vocab && j < d && non_finite(v[i]);
    r0 += kOneBatch * kOneRows;
    if (r0 >= vocab) break;
#pragma unroll
    for (int i = 0; i < kOneBatch; ++i)
      v[i] = onehot_load(tab, r0 + i * kOneRows, vocab, j, d);
  }
#pragma unroll
  for (int off = kOneCols; off < 32; off *= 2)
    n += __shfl_xor_sync(0xffffffffu, n, off);
  if (sub == 0) slot[warp * kOneCols + col] = n;
  __syncthreads();
  if (first >= rows || j >= d) return;
  int tot = 0;
#pragma unroll
  for (int w = 0; w < kOneWarps; ++w) tot += slot[w * kOneCols + col];
  for (int r = first; r < rows; r += kOneRows) {
    if (r != first) {
      c = __ldg(codes + static_cast<int64_t>(r) * ld_codes);
      hit = c >= 0 && c < vocab;
      e = onehot_load(tab, hit ? c : 0, vocab, j, d);
    }
    out[static_cast<int64_t>(r) * d + j] =
        onehot_value(hit ? e : 0.f, hit, tot);
  }
}

// ------------------------------------------------------- 11: dyn_col_dma
// out[rows, width] = w[:, c0:c0 + width], c0 computed in the kernel from a
// device-held q. The rows are dealt to CTAs of one thread, kColRows a CTA,
// and the thread never touches the data: it prefetches the tensor map's
// descriptor (it overlaps the read of q), reads q, loads its slice as one
// 2-D TMA box [kColRows, width] at (c0, r0) onto an mbarrier, then writes
// the slice's valid rows (out's rows r0.. are contiguous) with one bulk
// store from shared memory. TMA fills the box's rows past `rows` with zeros; the
// store leaves them out. Only async-proxy accesses touch the buffer, so no
// proxy fence; the store's source read is awaited before the CTA exits.
// Bound: two dependent round trips (q, then the box) and the store, not
// bytes. COL_ROWS (-D, as SCRATCH_CTAS) sets the rows a CTA: at the
// probe's 128 rows, 32 CTAs of 4 rows, 64 of 2 and 16 of 8 measured
// within ~3% of each other (4 the fastest in two of three runs), 128 of 1
// ~6% slower, 8 of 16 ~10% and 4 of 32 ~27% (H100, CUDA-graph replay;
// tools/frame_measure.py probes with -DCOL_ROWS=N).
#ifndef COL_ROWS
#define COL_ROWS 4
#endif
constexpr int kColRows = COL_ROWS;
constexpr int kColMaxWidth = 256;                // one TMA box's limit
static_assert(kColRows >= 1 && kColRows <= 256, "a TMA box's rows");
static_assert(kColRows * kColMaxWidth * 4 <= 48 * 1024, "static shared");

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

__global__ void __launch_bounds__(1)
dyn_col_dma_kernel(const __grid_constant__ CUtensorMap map,
                   const int* __restrict__ q, float* __restrict__ out,
                   int rows, int cols, int width, int q_mul, int q_add) {
  __shared__ __align__(128) float buf[kColRows * kColMaxWidth];
  __shared__ __align__(8) uint64_t bar;
  prefetch_tensormap(&map);
  mbar_init(&bar, 1);
  const int r0 = blockIdx.x * kColRows;
  const int valid = min(kColRows, rows - r0);
  // column offset from the device-held q
  const int col0 = dynamic_start(q[0] * q_mul + q_add, cols, width);
  const uint32_t row_bytes = static_cast<uint32_t>(width) * 4;
  mbar_expect_tx(&bar, kColRows * row_bytes);      // the whole box, fill too
  tma_load_2d(buf, &map, col0, r0, &bar);
  mbar_wait(&bar, 0);
  bulk_s2g(out + (int64_t)r0 * width, buf, valid * row_bytes);
  bulk_wait_read();
}

// ------------------------------------------------------------ host side
constexpr int kMaxDevices = 64;

// cudaFuncSetAttribute once a device and process, not once a launch (a
// host call of its own); a device past kMaxDevices asks each launch
cudaError_t allow_smem_once(const void* kernel, int bytes,
                            bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace

extern "C" {

// x, scratch, out f32 [64, 128]
int probe_hbm_scratch_launch(const void* x, void* scratch, void* out, int n,
                             void* stream) {
  if (n != kScratchElems) return static_cast<int>(cudaErrorInvalidValue);
  hbm_scratch_kernel<<<kScratchCtas, kScratchThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(scratch),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// w f32 [steps, 8, 128] -> out f32 [8, 128]
int probe_fori_dma_launch(const void* w, void* out, int steps, void* stream) {
  if (steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  fori_dma_kernel<<<1, kForiThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<float*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}

// x f32 [rows, cols] -> out int32 [rows, lanes]; any contiguous x: rows
// that start 16-byte aligned with cols % 4 == 0 take float4 loads, others
// scalar ones
int probe_argmax_launch(const void* x, void* out, int rows, int cols,
                        int lanes, void* stream) {
  if (rows < 1 || cols < 1 || lanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vin = cols % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vout =
      lanes % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  void (*kernel)(const float*, int*, int, int) =
      vin ? (vout ? argmax_kernel<true, true> : argmax_kernel<true, false>)
          : (vout ? argmax_kernel<false, true> : argmax_kernel<false, false>);
  kernel<<<rows, kArgThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int*>(out), cols, lanes);
  return static_cast<int>(cudaGetLastError());
}

// c f32 [32, 128] (16-byte aligned), pos int32 [1] (device) -> out f32
// [8, 128]
int probe_dyn_sublane_launch(const void* c, const void* pos, void* out,
                             void* stream) {
  static bool allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem_once(
      reinterpret_cast<const void*>(&dyn_sublane_kernel), kSubBufBytes,
      allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  dyn_sublane_kernel<<<1, kSubThreads, kSubBufBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(c), static_cast<const int*>(pos),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x, out f32 [n / d, d], d even; vectors of 4, 2 or 1 floats, the widest
// that divides d / 2 and both pointers' alignment
int probe_rot_launch(const void* x, void* out, long long n, int d,
                     void* stream) {
  if (n < 1 || d < 2 || d % 2 || n % d)
    return static_cast<int>(cudaErrorInvalidValue);
  const int h = d / 2;
  const uintptr_t at = reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(out);
  const int vec = h % 4 == 0 && at % 16 == 0 ? 4
                  : h % 2 == 0 && at % 8 == 0 ? 2
                                              : 1;
  const int dv = d / vec;
  const long long rows = n / d;
  const int tx = dv < kRotThreads ? dv : kRotThreads;
  const int ty = kRotThreads / tx;
  const long long group = static_cast<long long>(ty) * kRotItems;
  const long long groups = (rows + group - 1) / group;
  const dim3 grid((dv + tx - 1) / tx,
                  static_cast<unsigned>(groups < 65535 ? groups : 65535));
  const dim3 block(tx, ty);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (vec == 4)
    rot_kernel<4><<<grid, block, 0, s>>>(xf, of, rows, h / 4);
  else if (vec == 2)
    rot_kernel<2><<<grid, block, 0, s>>>(xf, of, rows, h / 2);
  else
    rot_kernel<1><<<grid, block, 0, s>>>(xf, of, rows, h);
  return static_cast<int>(cudaGetLastError());
}

// codes int32 [rows, ld_codes] (column 0 used), tab f32 [vocab, d] ->
// out f32 [rows, d]; any contiguous codes and table (scalar loads).
// ceil(d / kOneCols) CTAs
int probe_onehot_launch(const void* codes, const void* tab, void* out,
                        int rows, int ld_codes, int vocab, int d,
                        void* stream) {
  if (rows < 1 || ld_codes < 1 || vocab < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      static_cast<unsigned>((d + kOneCols - 1LL) / kOneCols);
  onehot_kernel<<<blocks, kOneThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(codes), static_cast<const float*>(tab),
      static_cast<float*>(out), rows, ld_codes, vocab, d);
  return static_cast<int>(cudaGetLastError());
}

// q int32 [1] (device), w f32 [rows, cols] -> out f32 [rows, width] =
// w[:, c0:c0 + width], c0 = clamp(q * q_mul + q_add); rows <= 256, width
// <= 256 (one TMA box's width), 16-byte aligned rows; ceil(rows /
// kColRows) CTAs
int probe_dyn_col_dma_launch(const void* q, const void* w, void* out,
                             int rows, int cols, int width, int q_mul,
                             int q_add, void* stream) {
  if (rows < 1 || rows > 256 || width < 4 || width > kColMaxWidth ||
      width % 4 || cols < width || cols % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  cudaError_t err = make_map(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w, rows,
                             cols, cols * 4LL, kColRows, width);
  if (err != cudaSuccess) return static_cast<int>(err);
  dyn_col_dma_kernel<<<(rows + kColRows - 1) / kColRows, 1, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const int*>(q), static_cast<float*>(out), rows, cols,
      width, q_mul, q_add);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
