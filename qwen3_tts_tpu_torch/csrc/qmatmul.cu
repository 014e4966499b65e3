// Kernel A: int8 weight-only matmul for prefill,
//   out[M, N] f32 = f32( bf16(x)[M, K] @ bf16(q)[K, N] ) * scale[N].
//
// Replaces: qwen3_tts_tpu/ops/quant.py::_pallas_qmatmul (kernel
//   _qmatmul_kernel, call :222): every int8 product of the talker prefill
//   and the int8 head, through quant.linear -> quant.qmatmul (the JAX
//   package's shape dispatch: K and N multiples of 128).
//
// Bound: at M = 64 (one 64-token prompt) the weight bytes: a talker layer
//   reads 50.3 MB of int8 weights, 15 us at 3.35 TB/s, for 6.4 GFLOP (6.5
//   us at 989 TFLOP/s). A weight byte feeds 2 M operations, the card's
//   ridge is 295 a byte, so from M ~ 150 rows the tensor cores bound it: at
//   M = 1088 (17 prompts) 1.1e11 operations a layer, 0.111 ms.
//
// Design: out^T = W^T x^T. A 64-row wgmma tile is 64 output columns, and M
//   is wgmma's N: a block takes MT = 16..192 rows of x (ops/quant.py
//   qmatmul_plan picks MT, the column tile BN = 128 or 256, the K split and
//   the ring depth). Warp 8 is the producer: its lane 0 streams the block's
//   K range through a ring of stages in shared memory with TMA
//   (cp.async.bulk.tensor, 128-byte swizzle) on full / empty mbarriers. A
//   stage is one 64-deep K chunk: BN / 128 int8 weight boxes of 64 x 128
//   and x's box of MT x 64 bf16; up to 8 stages, 64-200 KB in flight a
//   block (the ~25 KB a SM that 3.35 TB/s needs at ~1 us of latency, and
//   more). A block takes at least 118 KB, so the grid spreads one block an
//   SM. Warps 0-7 are two consumer warpgroups, each taking 64 columns of
//   every weight box:
//   - a warp loads its 16 columns x 32 K rows with one ldmatrix.x4.trans
//     (the swizzle keeps it free of bank conflicts), which hands a thread
//     K pairs of two neighbouring columns: rows g and g + 8 of its wgmma A
//     fragment are columns 2g and 2g + 1 of the warp's 16;
//   - int8 -> bf16 in registers, exact (|q| <= 127): the byte + 128 into the
//     mantissa of 2^23, one f32 subtraction, the upper half;
//   - wgmma.mma_async m64nMTk16, A from registers, x^T from shared memory
//     (K-major, 128-byte swizzle), f32 accumulate; chunk i + 1's fragments
//     are converted while chunk i's products run;
//   - the wide column tile lets each x byte (read from L2 by every column
//     tile) serve BN weight columns.
//   The epilogue writes the block's f32 tile into its own shared memory (the
//   drained ring). Where the output tiles alone leave SMs idle, the K range
//   is split across the ranks of a thread-block cluster (<= 8): rank r sums
//   slice r of the tile over the ranks, in rank order, through distributed
//   shared memory, so no partial leaves the cluster, no second kernel runs,
//   and the sum does not depend on scheduling. The scale is applied after
//   the f32 sum, and the tile is stored coalesced. Rows past M are zeros
//   from TMA's out-of-bounds fill and are never stored. The weight's tensor
//   map is encoded once per view (qmatmul_map; ops/quant.py caches it),
//   x's at every launch. Each launch is a programmatic dependent launch:
//   its blocks start while the previous kernel ends, fetch the maps and
//   prefetch their first weight boxes into L2, and wait for that kernel
//   (griddepcontrol.wait) before they load x or touch the output.
//
// What holds it back (H100, chip_smoke.py qmatmul_plan_times): a block
//   streams ~17 KB of weights a us with its products,
//   so a product runs at the speed of the SMs it keeps busy, and each
//   launch costs a few us of fill and drain; at M = 1088 the last of ~4.4
//   waves of 132 blocks runs a third full.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "persistent.cuh"   // smem_addr and the mbarriers (and cg, gemv.cuh)
#include "tensor_map.cuh"

namespace {

constexpr int kBK = 64;                  // K rows a stage: x's 128-byte row
constexpr int kBoxN = 128;               // weight columns a box: its row
constexpr int kWBox = kBK * kBoxN;       // bytes of a weight box
constexpr int kConsumerWarps = 8;        // two warpgroups
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr int kPad = 8;                  // f32 pad of a partial-tile row
constexpr int kMaxStages = 8;
constexpr int kMaxRanks = 8;         // a cluster's K ranks
constexpr int kSmemMax = 232448;         // 227 KB a block
constexpr int kSmemMin = 118 * 1024;     // more than half an SM's 228 KB

// a stage: one chunk of 64 K rows, nsub weight boxes of 64 x 128 int8
// and x's box of mt x 64 bf16
__host__ __device__ constexpr int stage_bytes(int mt, int nsub) {
  return nsub * kWBox + mt * kBK * 2;
}
__host__ __device__ constexpr int part_bytes(int mt, int nsub) {
  return mt * (nsub * kBoxN + kPad) * 4;
}
__host__ __device__ constexpr int region_bytes(int mt, int nsub,
                                               int stages) {
  return stages * stage_bytes(mt, nsub) > part_bytes(mt, nsub)
             ? stages * stage_bytes(mt, nsub)
             : part_bytes(mt, nsub);
}
// the ring (the partial tile after it drains), the mbarriers, and room to
// align the ring to the 1024 bytes of the swizzle pattern; at least
// kSmemMin, so that one block runs on an SM and the grid spreads over the
// card (two blocks on one SM share its memory stream)
int smem_bytes(int mt, int nsub, int stages) {
  return max(kSmemMin,
             region_bytes(mt, nsub, stages) + 2 * kMaxStages * 8 + 1024);
}

// one 2-D TMA box global -> shared at (c0 inner, c1 outer), on `bar`
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1,
                                       unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
// a 2-D TMA box into L2 only
__device__ __forceinline__ void tma_prefetch_l2(const CUtensorMap* map, int c0,
                                                int c1) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.2d.L2.global [%0, {%1, %2}];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1)
      : "memory");
}

// wait until the previous kernel in the stream has finished and its writes
// are visible (a no-op without a programmatic dependent launch)
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// four 8x8 b16 matrices, transposed: rows given by lanes 0-7, 8-15, ...
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// the int8 bytes b0..b3 of r -> bf16 pairs (b0, b2) and (b1, b3), exact:
// b + 128 is the mantissa of 2^23 + b + 128, less 2^23 + 128 in f32, and a
// small integer's bf16 is its f32's upper half
__device__ __forceinline__ void i8_to_bf16(uint32_t r, uint32_t& even,
                                           uint32_t& odd) {
  const uint32_t u = r ^ 0x80808080u;
  const float k = 8388736.f;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - k;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - k;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - k;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - k;
  even = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
  odd = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
}

// wgmma's descriptor of a K-major bf16 tile in 128-byte swizzle: rows of
// 128 bytes, 8-row atoms 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator accesses across the async
// products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x MT] += A[64 x 16] (registers, bf16) * B[16 x MT] (shared, desc):
// one specialization per row tile, the accumulator registers written out
#define ACC4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC8(d, i) ACC4(d, i), ACC4(d, i + 4)
#define ACC16(d, i) ACC8(d, i), ACC8(d, i + 8)
#define ACC32(d, i) ACC16(d, i), ACC16(d, i + 16)
#define ACC64(d, i) ACC32(d, i), ACC32(d, i + 32)
#define ACC96(d, i) ACC64(d, i), ACC32(d, i + 64)

template <int MT>
__device__ void wgmma_rs(float (&d)[MT / 2], const uint32_t (&a)[4],
                         uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
    "%0, %1, %2, %3, %4, %5, %6, %7"
    "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
    : ACC8(d, 0)
    : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
    "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
    : ACC16(d, 0)
    : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
    "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
    : ACC32(d, 0)
    : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
    "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
    : ACC64(d, 0)
    : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
    "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
    "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
    "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
    : ACC96(d, 0)
    : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}


// A warp's fragments of one stage: its 16 columns of each weight box, the
// box's 64 K rows as 4 K steps of 16, int8 -> bf16
template <int NSUB>
__device__ __forceinline__ void load_a(uint32_t (&a)[NSUB][4][4],
                                       const uint8_t* st, int lane, int ch) {
#pragma unroll
  for (int j = 0; j < NSUB; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // lane L: row k = 32 h + L of the box; matrices: K steps 2h (rows
      // 0-7, 8-15) and 2h + 1
      const int k = 32 * h + lane;
      uint32_t r[4];
      ldsm_x4_trans(r, st + j * kWBox + k * kBoxN + ((ch ^ (k & 7)) << 4));
      i8_to_bf16(r[0], a[j][2 * h][0], a[j][2 * h][1]);
      i8_to_bf16(r[1], a[j][2 * h][2], a[j][2 * h][3]);
      i8_to_bf16(r[2], a[j][2 * h + 1][0], a[j][2 * h + 1][1]);
      i8_to_bf16(r[3], a[j][2 * h + 1][2], a[j][2 * h + 1][3]);
    }
}

// one stage's products, started and committed: they run on until retired
template <int MT, int NSUB>
__device__ __forceinline__ void mma_stage(float (&acc)[NSUB][MT / 2],
                                          const uint32_t (&a)[NSUB][4][4],
                                          const uint8_t* xtile) {
  const uint64_t desc = sw128_desc(xtile);
#pragma unroll
  for (int j = 0; j < NSUB; ++j) fence_acc(acc[j]);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
      wgmma_rs<MT>(acc[j], a[j][kk], desc + 2 * kk);   // + 32 bytes of K
  wg_commit();
}

// One block: output rows [m0, m0 + MT) x columns [n0, n0 + BN), K chunks
// [kc0, kc0 + chunks) of 64; blockIdx.z is the block's rank in its cluster
// (the K split).
template <int MT, int NSUB>
__global__ void __launch_bounds__(kThreads, 1)
qmatmul_wgmma(const __grid_constant__ CUtensorMap wmap,
              const __grid_constant__ CUtensorMap xmap,
              const float* __restrict__ scale, float* __restrict__ out, int M,
              int N, int chunks, int stages) {
  constexpr int kBN = NSUB * kBoxN;
  constexpr int kStage = stage_bytes(MT, NSUB);
  constexpr int kLd = kBN + kPad;        // floats a partial-tile row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(
      ring + region_bytes(MT, NSUB, stages));
  unsigned long long* empty = full + kMaxStages;
  float* part = reinterpret_cast<float*>(ring);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * MT;
  const int kc0 = blockIdx.z * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init_count(&full[s], 1);
      mbar_init_count(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // the producer: chunk i into stage i % stages once its last use is done
    if (lane == 0) {
      // launched early behind the previous kernel (programmatic dependent
      // launch): fetch the maps and bring the first stages' weights into
      // L2 (coherent with that kernel's writes), then wait for it before
      // loading anything into shared memory
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&xmap))
                   : "memory");
      for (int i = 0; i < stages && i < chunks; ++i)
#pragma unroll
        for (int j = 0; j < NSUB; ++j)
          tma_prefetch_l2(&wmap, n0 + j * kBoxN, (kc0 + i) * kBK);
      grid_dependency_wait();
      for (int i = 0; i < chunks; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
        uint8_t* st = ring + s * kStage;
        const int k = (kc0 + i) * kBK;
        mbar_expect(&full[s], kStage);
#pragma unroll
        for (int j = 0; j < NSUB; ++j)
          tma_2d(st + j * kWBox, &wmap, n0 + j * kBoxN, k, &full[s]);
        tma_2d(st + NSUB * kWBox, &xmap, k, m0, &full[s]);
      }
      // the next kernel may launch (its blocks wait for this grid's end)
      asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    }
    __syncwarp();
  } else {
    // the consumers: warp w of warpgroup wg takes the 16-byte column chunk
    // ch of every weight box; accumulator row 16 w + g (+ 8) is its column
    // 2g (+ 1). Chunk i + 1's fragments are loaded and converted while
    // chunk i's products run.
    const int ch = warp;                 // 4 wg + w
    grid_dependency_wait();              // before scale and out
    float acc[NSUB][MT / 2];
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int i = 0; i < MT / 2; ++i) acc[j][i] = 0.f;
    auto stage = [&](int i) { return ring + (i % stages) * kStage; };
    auto ready = [&](int i) { mbar_wait(&full[i % stages], (i / stages) & 1); };
    auto retire = [&](int i) {           // chunk i's products are done
      wg_wait_all();
#pragma unroll
      for (int j = 0; j < NSUB; ++j) fence_acc(acc[j]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[i % stages]);
    };
    uint32_t a0[NSUB][4][4], a1[NSUB][4][4];
    ready(0);
    load_a<NSUB>(a0, stage(0), lane, ch);
    for (int i = 0; i < chunks; i += 2) {
      mma_stage<MT, NSUB>(acc, a0, stage(i) + NSUB * kWBox);
      if (i + 1 < chunks) {
        ready(i + 1);
        load_a<NSUB>(a1, stage(i + 1), lane, ch);
      }
      retire(i);
      if (i + 1 == chunks) break;
      mma_stage<MT, NSUB>(acc, a1, stage(i + 1) + NSUB * kWBox);
      if (i + 2 < chunks) {
        ready(i + 2);
        load_a<NSUB>(a0, stage(i + 2), lane, ch);
      }
      retire(i + 1);
    }

    // both warpgroups are done with the ring: it becomes the partial tile
    // [MT][kLd] f32
    sync_first(kConsumers);
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int j = 0; j < NSUB; ++j) {
      const int n = j * kBoxN + 16 * ch + 2 * g;
#pragma unroll
      for (int c = 0; c < MT / 8; ++c) {
        const int m = 8 * c + 2 * t;
        *reinterpret_cast<float2*>(&part[m * kLd + n]) =
            make_float2(acc[j][4 * c], acc[j][4 * c + 2]);
        *reinterpret_cast<float2*>(&part[(m + 1) * kLd + n]) =
            make_float2(acc[j][4 * c + 1], acc[j][4 * c + 3]);
      }
    }
  }

  // rank r sums slice r of the tile over the cluster's ranks in rank order,
  // scales it and stores the rows below M
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (warp < kConsumerWarps) {
    const int ranks = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    constexpr int kRow4 = kBN / 4;
    const int per = MT * kRow4 / ranks;
    const int rows = min(MT, M - m0);
    for (int e = rank * per + threadIdx.x; e < (rank + 1) * per;
         e += kConsumers) {
      const int m = e / kRow4, c = (e % kRow4) * 4;
      if (m >= rows) break;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < ranks; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part + m * kLd + c, q));
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      const int n = n0 + c;
      *reinterpret_cast<float4*>(out + (int64_t)(m0 + m) * N + n) =
          make_float4(sum.x * scale[n], sum.y * scale[n + 1],
                      sum.z * scale[n + 2], sum.w * scale[n + 3]);
    }
  }
  cluster.sync();                        // no block leaves while it is read
}

template <int MT, int NSUB>
int launch(const CUtensorMap& wmap, const void* x, const float* scale,
           float* out, int M, int K, int N, int splits, int stages,
           cudaStream_t st) {
  CUtensorMap xmap;
  cudaError_t err = make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K,
                             2LL * K, MT, kBK, CU_TENSOR_MAP_SWIZZLE_128B,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = smem_bytes(MT, NSUB, stages);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  static int allowed = 0;              // the largest smem set for this kernel
  if (smem > allowed) {
    err = cudaFuncSetAttribute(qmatmul_wgmma<MT, NSUB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / (NSUB * kBoxN), (M + MT - 1) / MT, splits);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  // a programmatic dependent launch: the blocks start while the previous
  // kernel finishes and wait for it in the kernel; one rank needs no
  // cluster
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 2 : 1;
  err = cudaLaunchKernelEx(&cfg, qmatmul_wgmma<MT, NSUB>, wmap, xmap, scale,
                           out, M, N, K / kBK / splits, stages);
  return err != cudaSuccess ? static_cast<int>(err)
                            : static_cast<int>(cudaGetLastError());
}

// the row tile as a template argument: the accumulators (NSUB x MT / 2
// f32 a thread) and two stages' fragments fit 168 registers up to 96 + 32
// (128-column tiles to MT = 192, 256-column tiles to MT = 64)
template <int NSUB, typename... Args>
int by_mt(int mt, Args... args) {
  switch (mt) {
    case 16: return launch<16, NSUB>(args...);
    case 32: return launch<32, NSUB>(args...);
    case 64: return launch<64, NSUB>(args...);
  }
  if constexpr (NSUB == 1) {
    if (mt == 128) return launch<128, 1>(args...);
    if (mt == 192) return launch<192, 1>(args...);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// the TMA map of an int8 weight q [K, ldq] (16-byte aligned base, ldq % 16
// == 0), its first N columns (N % 128 == 0), written to `map` (128 bytes,
// host memory)
int qmatmul_map(void* map, const void* q, int K, int N, int ldq) {
  if (K <= 0 || N <= 0 || N % kBoxN || N > ldq || ldq % 16 ||
      reinterpret_cast<uintptr_t>(q) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m;
  const cudaError_t err = make_map(&m, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, K, N,
                                   ldq, kBK, kBoxN, CU_TENSOR_MAP_SWIZZLE_128B,
                                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (err == cudaSuccess) memcpy(map, &m, sizeof(m));
  return static_cast<int>(err);
}

// x bf16 [M, K] contiguous (16-byte aligned); wmap: qmatmul_map's map of q;
// scale f32 [N]; out f32 [M, N]. bn: 128 or 256 columns a block (N % bn ==
// 0), mt: rows a block (16, 32, 64; 128, 192 with bn = 128), splits: the
// cluster's K ranks (1, 2, 4, 8; (K / 64) % splits == 0), stages: the
// ring's depth (2-8 within 227 KB, or 1 where a rank has one chunk: a
// consumer waits for chunk i + 1 before it frees chunk i's stage):
// ops/quant.py qmatmul_plan.
int qmatmul_launch(const void* x, const void* wmap, const void* scale,
                   void* out, int M, int K, int N, int bn, int mt, int splits,
                   int stages, void* stream) {
  if (M <= 0 || K <= 0 || K % kBK || (bn != kBoxN && bn != 2 * kBoxN) ||
      N <= 0 || N % bn || splits < 1 || splits > kMaxRanks ||
      (splits & (splits - 1)) || (K / kBK) % splits || stages < 1 ||
      stages > kMaxStages || (stages < 2 && K / kBK / splits > 1) ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap w;
  memcpy(&w, wmap, sizeof(w));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  return bn == kBoxN ? by_mt<1>(mt, w, x, sc, o, M, K, N, splits, stages, st)
                     : by_mt<2>(mt, w, x, sc, o, M, K, N, splits, stages, st);
}

}  // extern "C"
