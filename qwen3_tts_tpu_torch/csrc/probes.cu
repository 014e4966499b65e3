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
//   argmax        (:93)  per-row (value, index) warp/block reduction
//   dyn_sublane   (:115) a device-held index read in the kernel while a
//                        bulk copy stages the table beside it, a 128 KB
//                        dynamic shared scratch indexed by it
//   rot           (:139) rotate-half as an elementwise lane map
//   onehot        (:158) one-hot x table as a direct, bounds-checked row load
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
// bytes. hbm_scratch, fori_dma, dyn_sublane and dyn_col_dma were
// redesigned for this card (copies spread over CTAs, kept in flight by a
// ring, or issued before the index they wait on is read); argmax, rot and
// onehot keep their first, simple design, not yet made fast. Every launch
// function returns cudaGetLastError().

#include <cuda_runtime.h>
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

constexpr int kThreads = 256;

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
struct Best {
  float v;
  int i;
};

// a wins over b: larger value, or the same value at a lower index
__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__global__ void __launch_bounds__(kThreads)
argmax_kernel(const float* __restrict__ x, int* __restrict__ out, int cols,
              int lanes) {
  __shared__ Best warp_best[kThreads / 32];
  const int row = blockIdx.x, tid = threadIdx.x;
  const float* xr = x + (int64_t)row * cols;
  Best b{__int_as_float(0xff800000), cols};   // -inf
  for (int c = tid; c < cols; c += kThreads) b = better(b, Best{xr[c], c});
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best o{__shfl_down_sync(0xffffffffu, b.v, off),
           __shfl_down_sync(0xffffffffu, b.i, off)};
    b = better(b, o);
  }
  if (tid % 32 == 0) warp_best[tid / 32] = b;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kThreads / 32; ++w) b = better(b, warp_best[w]);
    warp_best[0] = b;
  }
  __syncthreads();
  const int idx = warp_best[0].i;
  for (int l = tid; l < lanes; l += kThreads) out[(int64_t)row * lanes + l] = idx;
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
__global__ void rot_kernel(const float* __restrict__ x, float* __restrict__ out,
                           int64_t n, int d) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int h = d / 2;
  const int l = static_cast<int>(i % d);
  out[i] = l < h ? -x[i + h] : x[i - h];
}

// ------------------------------------------------------------ 10: onehot
__global__ void onehot_kernel(const int* __restrict__ codes,
                              const float* __restrict__ tab,
                              float* __restrict__ out, int ld_codes, int vocab,
                              int d) {
  const int row = blockIdx.x;
  const int code = codes[(int64_t)row * ld_codes];
  // one-hot semantics: a code outside the table matches no row -> zeros
  const bool hit = code >= 0 && code < vocab;
  for (int j = threadIdx.x; j < d; j += blockDim.x)
    out[(int64_t)row * d + j] = hit ? tab[(int64_t)code * d + j] : 0.f;
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

// x f32 [rows, cols] -> out int32 [rows, lanes]
int probe_argmax_launch(const void* x, void* out, int rows, int cols,
                        int lanes, void* stream) {
  if (rows < 1 || cols < 1 || lanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  argmax_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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

// x, out f32 [n / d, d], d even
int probe_rot_launch(const void* x, void* out, long long n, int d,
                     void* stream) {
  if (n < 1 || d < 2 || d % 2 || n % d)
    return static_cast<int>(cudaErrorInvalidValue);
  rot_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, d);
  return static_cast<int>(cudaGetLastError());
}

// codes int32 [rows, ld_codes] (column 0 used), tab f32 [vocab, d] ->
// out f32 [rows, d]
int probe_onehot_launch(const void* codes, const void* tab, void* out,
                        int rows, int ld_codes, int vocab, int d,
                        void* stream) {
  if (rows < 1 || ld_codes < 1 || vocab < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  onehot_kernel<<<rows, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(codes), static_cast<const float*>(tab),
      static_cast<float*>(out), ld_codes, vocab, d);
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
