// Skinny matmul y[M, N] = x[M, K] @ W[K, N] for decode batches (M <= 32):
// kernel B (W in the model dtype), B8 (int8 W, per-column scale) and B4
// (packed biased int4 W with per-group multipliers m8 and a per-column
// scale), each optionally with the rms norm of x as its prologue.
//
// Replaces: the `stream_matmul` helpers inside the two TPU kernels,
//   qwen3_tts_tpu/ops/fused_talker.py::_kernel_body (stream_matmul) and
//   qwen3_tts_tpu/ops/fused_predictor.py::_kernel_body (stream_matmul):
//   every qkv / wo / gate-up / down / head product of the talker step and
//   the predictor frame, for dense, int8 and int4 weights; B4 computes the
//   int4 panel order of qwen3_tts_tpu/ops/quant.py::panel_matmul4. The
//   norm prologue replaces `rms2` (qwen3_tts_tpu/ops/fused_talker.py:121,
//   qwen3_tts_tpu/ops/fused_predictor.py:130), which the TPU kernels also
//   compute inside the kernel of the product it feeds (ln1 -> qkv, ln2 ->
//   gate/up, the predictor's final norm -> its head slice).
//
// Bound: weight bytes. At M <= 32 each weight element is used M times, far
//   below the ~295 FLOP/byte where Hopper's tensor cores become the limit,
//   so the product costs the time to read the K*N weights from HBM: 2 or 4
//   bytes each for B, 1 for B8, 1/2 (+ 1/128 for m8) for B4. B4's nibble
//   unpacking costs about as many instructions as its bytes take time, so
//   its inner loop is written for few instructions per nibble.
//
// Design (B, B8, B4), one CUDA kernel per product, aimed at M = 1-2:
//   * Tiles. A block (8 warps) owns a 128-column tile of W and one K
//     range: 16 lanes span a row (8 columns, one 16-byte load of bf16, two
//     of f32, one 8-byte load of int8 or of packed int4, a lane), so a warp
//     reads two rows and the block 16 rows a step. x rows (MT = 1, 2, 4 or
//     8 per block by M, at most 4 for B4; grid.y walks row chunks) are
//     staged in shared memory as f32 and broadcast.
//   * Bytes in flight. Each lane keeps two batches of independent loads in
//     flight (a batch of 128 bytes: 8 16-byte loads of bf16, 16 8-byte
//     loads of int8, 4 pairs of f32; of 80 for B4: a packed group's 8
//     8-byte rows and its two m8 rows, which unpack to as many weights as
//     256 bytes of bf16): the next batch loads while the current one is
//     multiplied, and a piece's first batch loads while x is staged. The
//     grid is sized in Python from the SM count and the resident blocks a
//     SM takes (`gemv_blocks_per_sm`).
//   * The K split is a thread block cluster. The `splits` blocks of one
//     column tile (cluster rank = K range) sum their warps in shared memory
//     in warp order, meet at a cluster barrier, and each rank then reduces a
//     slice of the tile: it reads every rank's partials through distributed
//     shared memory in rank order, applies the column scale and the
//     epilogue, and stores. No workspace, no second launch, no atomics:
//     every sum has a fixed order, so results do not depend on scheduling.
//   int8 -> f32 is exact (|q| <= 127), so B8 is B's arithmetic with 1-byte
//   weights.
//
// Design (B4, `gemv4_cluster`), a sibling of B's kernel that shares its
//   tiles, x staging, norm prologue and cluster reduction, but not its
//   inner loop: packed row r holds k = r (low nibble) and k = K/2 + r (high
//   nibble), so a packed group (128 packed rows) covers two whole k-groups,
//   g and ng/2 + g, and m8 multiplies each group's dot after it. A rank
//   takes whole packed groups, so a group is never split across blocks; a
//   lane takes 8 rows of each group (x staged as two halves, the low and
//   the high k's) and forms per group and column
//   (x_g . (nib_u - 8)) * m8[g] over its rows in f32, nib_u the biased
//   nibble in [0, 15]: the same exact products x * nib_u and x * 8 that
//   panel_matmul4's x_g . nib_u - 8 * rowsum(x_g) sums, in another order.
//   The lanes' shares are then summed as B sums its lanes. A nibble becomes
//   a float in two instructions: one LOP3 puts it into the mantissa of a
//   float whose exponent makes the nibble's bits worth 1 (2^(23-s) + nib
//   for the nibble at bit s), one FADD takes 2^(23-s) + 8 off again; both
//   exact. B4's accumulators (three per column and row) are why it stages
//   at most 4 x rows a block. Measured (NVIDIA H100, chip_smoke.py
//   kernel_times): the talker layer's four launches take ~5x its bytes'
//   time, about 3/4 of it each launch's fixed chain (x staging, cluster
//   reduction) and memory latency, 1/4 the nibble unpacking.
//
// Norm prologue (template flag kNorm; the unfused instantiations compile
//   without it): x is the f32 residual [M, K] and ln the norm weight [K] in
//   the model dtype T. Each block starts the weight loads of its first
//   piece, then reduces the sum of squares of its x rows over the whole K
//   (L2-resident: 8 KB a talker row; a fixed order: per thread, warp
//   butterflies, warps in order), and stages f32(T(x * rsqrt(sum / K +
//   eps) * ln)): f32 math, one rounding, the semantics of `rms2` and of the
//   standalone rms_norm kernel. Staging the piece in the same pass over x
//   (one read of the row instead of two) measured slower a frame on the
//   H100: faster for the talker's K = 2048, slower for the predictor's
//   1024, which has five times the launches.
//
// W is row-major [K, ldw] (B4: [K/2, ldw], m8 [K/128, ldm]); `col0` selects
// columns [col0, col0 + N) (the predictor's per-codebook head slice) of W,
// m8 and scale alike, with no copy. x is in the model dtype T (float or
// bf16), f32 with the norm; accumulation is f32.
//
// Epilogues: 0 store T, 1 store f32, 2 store f32 rounded through T
// (logits), 3 add into an f32 residual buffer.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

// ops/gemv.py TILE_N, MAX_SPLITS, GROUP4
constexpr int kBThreads = 256;           // 8 warps
constexpr int kBWarps = kBThreads / 32;
constexpr int kVec = 8;                  // output columns per lane
constexpr int kLanesN = 16;              // lanes across one weight row
constexpr int kBTileN = kLanesN * kVec;  // 128 columns per block
constexpr int kRowGroups = kBThreads / kLanesN;   // 16 rows a step
constexpr int kXStage = 4096;            // x values staged per piece
constexpr int kMaxSplits = 8;            // portable cluster size
constexpr int kFlightBytes = 128;        // loads in flight per lane
constexpr int kMaxMT = 8;                // max x rows per block
constexpr int kMaxMT4 = 4;               // max x rows per B4 block
constexpr int kGroup4 = 128;             // int4 k-group (quant.GROUP4)
constexpr int kRows4 = kGroup4 / kRowGroups;      // a lane's rows a group

// x's element type: the model dtype, or the f32 residual with the norm
template <typename T, bool kNorm>
using XT = typename std::conditional<kNorm, float, T>::type;

// One lane's 8 weights as raw bytes: loaded first, converted later, so
// that all of a lane's loads are in flight before its first FMA.
template <typename W> struct Raw;
template <> struct Raw<float> { float4 a, b; };
template <> struct Raw<__nv_bfloat16> { uint4 a; };
template <> struct Raw<int8_t> { uint2 a; };

__device__ __forceinline__ Raw<float> ld_raw(const float* p) {
  return {__ldg(reinterpret_cast<const float4*>(p)),
          __ldg(reinterpret_cast<const float4*>(p + 4))};
}
__device__ __forceinline__ Raw<__nv_bfloat16> ld_raw(const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const uint4*>(p))};
}
__device__ __forceinline__ Raw<int8_t> ld_raw(const int8_t* p) {
  return {__ldg(reinterpret_cast<const uint2*>(p))};
}

__device__ __forceinline__ void cvt8(const Raw<float>& r, float* w) {
  w[0] = r.a.x; w[1] = r.a.y; w[2] = r.a.z; w[3] = r.a.w;
  w[4] = r.b.x; w[5] = r.b.y; w[6] = r.b.z; w[7] = r.b.w;
}
__device__ __forceinline__ void cvt8(const Raw<__nv_bfloat16>& r, float* w) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void cvt8(const Raw<int8_t>& r, float* w) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&r.a);
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = static_cast<float>(b[i]);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_t(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_t(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float round_t(float v, float*) { return v; }
__device__ __forceinline__ float round_t(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// rows r0, r0 + 16, ... (kU of them) of a lane's 8 columns, those < pn
template <typename W, int kU>
__device__ __forceinline__ void load_rows(Raw<W>* raw, const W* w, int ldw,
                                          int r0, int pn) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int r = r0 + u * kRowGroups;
    if (r < pn) raw[u] = ld_raw(w + (int64_t)r * ldw);
  }
}

// The norm prologue's reduction: rinv[m] = rsqrt(mean(x[m0 + m]^2) + eps)
// for the block's x rows, over the whole K, in a fixed order. `scratch`
// holds kBWarps * kMT floats; rinv is read after the caller's barrier.
template <int kMT>
__device__ __forceinline__ void row_rms(const float* __restrict__ x, int K,
                                        int m0, int mt, float eps,
                                        float* scratch, float* rinv) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float s[kMT];
#pragma unroll
  for (int m = 0; m < kMT; ++m) s[m] = 0.f;
#pragma unroll 4
  for (int k = threadIdx.x; k < K; k += kBThreads) {
#pragma unroll
    for (int m = 0; m < kMT; ++m)
      if (m < mt) {
        const float v = x[(int64_t)(m0 + m) * K + k];
        s[m] = fmaf(v, v, s[m]);
      }
  }
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      s[m] += __shfl_xor_sync(0xffffffffu, s[m], o);
    if (lane == 0) scratch[warp * kMT + m] = s[m];
  }
  __syncthreads();
  if (threadIdx.x < kMT) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kBWarps; ++q) t += scratch[q * kMT + threadIdx.x];
    rinv[threadIdx.x] = rsqrtf(t / static_cast<float>(K) + eps);
  }
}

// One staged x value: x[(m0 + m) * K + k] in f32, or its normed value
// rounded once through T.
template <typename T, bool kNorm>
__device__ __forceinline__ float x_value(const XT<T, kNorm>* __restrict__ x,
                                         const T* __restrict__ ln,
                                         const float* rinv, int K, int m0,
                                         int m, int k) {
  const float v = to_f32(x[(int64_t)(m0 + m) * K + k]);
  if constexpr (kNorm)
    return round_t(v * rinv[m] * to_f32(ln[k]), (T*)nullptr);
  else
    return v;
}

// The tile's reduction and store, shared by B and B4. acc: a lane's sums
// over its rows for its 8 columns c..c+7 of the tile. The two row groups of
// a warp hold the same columns: add them, then the warps in warp order;
// then the K ranges of the tile: every rank's partials, in rank order,
// through distributed shared memory; rank r finishes slice r of the tile.
// The column scale and the residual of the thread's first element (its only
// one at M <= 2) are fetched before the cluster barrier. `smem` holds
// kBWarps * kMT * kBTileN floats, `part` kMT * kBTileN.
template <typename T, int kMT>
__device__ __forceinline__ void cluster_store(
    float (&acc)[kMT][kVec], float* smem, float* part,
    const float* __restrict__ scale, void* __restrict__ out, int N,
    int col0, int epi, int tile, int m0, int mt) {
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = (threadIdx.x % kLanesN) * kVec;
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
  __syncthreads();                        // smem: x pieces -> partials
  if (lane < kLanesN) {
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        smem[(warp * kMT + m) * kBTileN + c + j] = acc[m][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kMT * kBTileN; i += kBThreads) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kBWarps; ++q) s += smem[q * kMT * kBTileN + i];
    part[i] = s;
  }

  const int total = mt * kBTileN;
  const int per = (total + splits - 1) / splits;
  const int i0 = rank * per + threadIdx.x;
  const int i1 = min(total, (rank + 1) * per);
  float sc0 = 1.f, res0 = 0.f;
  if (i0 < i1) {
    const int n = tile * kBTileN + i0 % kBTileN;
    if (n < N) {
      if (scale != nullptr) sc0 = scale[col0 + n];
      if (epi == 3)
        res0 = reinterpret_cast<const float*>(
            out)[(int64_t)(m0 + i0 / kBTileN) * N + n];
    }
  }
  cluster.sync();
  for (int i = i0; i < i1; i += kBThreads) {
    const int m = i / kBTileN, n = tile * kBTileN + i % kBTileN;
    if (n >= N) continue;
    // all ranks' partials in flight at once, then summed in rank order
    float v[kMaxSplits];
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      v[q] = q < splits ? cluster.map_shared_rank(part, q)[i] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < splits) s += v[q];
    const bool first = i == i0;
    if (scale != nullptr) s *= first ? sc0 : scale[col0 + n];
    const int64_t o = (int64_t)(m0 + m) * N + n;
    float* outf = reinterpret_cast<float*>(out);
    switch (epi) {
      case 0: store_t(reinterpret_cast<T*>(out) + o, s); break;
      case 1: outf[o] = s; break;
      case 2: outf[o] = round_t(s, (T*)nullptr); break;
      default: outf[o] = (first ? res0 : outf[o]) + s; break;
    }
  }
  cluster.sync();                 // no block leaves while its part is read
}

// B / B8: y[m0 + m, n] for one 128-column tile and row chunk, the K split
// over the cluster (module comment). scale == nullptr for dense weights.
template <typename T, typename W, int kMT, bool kNorm>
__global__ void __launch_bounds__(kBThreads)
gemv_cluster(const XT<T, kNorm>* __restrict__ x, const W* __restrict__ w,
             const float* __restrict__ scale, const T* __restrict__ ln,
             float eps, void* __restrict__ out, int M, int K, int N, int ldw,
             int col0, int epi) {
  constexpr int kU = kFlightBytes / (kVec * sizeof(W));   // rows per lane
  constexpr int kPiece = kXStage / kMT;                    // x rows a piece
  constexpr int kRed = kBWarps * kMT * kBTileN;
  // x pieces during the loop, then the warps' partials
  __shared__ float smem[kRed > kXStage ? kRed : kXStage];
  __shared__ float part[kMT * kBTileN];                    // the block's sum
  __shared__ float rinv[kMT];                              // norm prologue

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / splits;
  const int m0 = blockIdx.y * kMT;
  const int mt = min(kMT, M - m0);
  const int rows = (K + splits - 1) / splits;
  const int kb = min(K, rank * rows);
  const int ke = min(K, kb + rows);
  const int rg = threadIdx.x / kLanesN;             // row group, 0..15
  const int c = (threadIdx.x % kLanesN) * kVec;     // column in the tile
  const int col = tile * kBTileN + c;               // within [0, N)
  const W* wp = w + col0 + col;

  float acc[kMT][kVec];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[m][j] = 0.f;

  for (int p0 = kb; p0 < ke; p0 += kPiece) {
    const int pn = min(kPiece, ke - p0);
    const W* wpiece = wp + (int64_t)p0 * ldw;
    // the piece's first rows are in flight while x is staged (and, first,
    // while the norm's sums of squares are reduced)
    Raw<W> cur[kU];
    if (col < N) load_rows<W, kU>(cur, wpiece, ldw, rg, pn);
    if constexpr (kNorm)
      if (p0 == kb) row_rms<kMT>(x, K, m0, mt, eps, part, rinv);
    __syncthreads();                      // the last piece's reads are done
    for (int i = threadIdx.x; i < kMT * pn; i += kBThreads) {
      const int m = i / pn, k = i % pn;
      smem[m * kPiece + k] =
          m < mt ? x_value<T, kNorm>(x, ln, rinv, K, m0, m, p0 + k) : 0.f;
    }
    __syncthreads();
    if (col < N) {
      // two batches of rows in flight: the next one loads while this one
      // is multiplied
      for (int r0 = rg; r0 < pn; r0 += kRowGroups * kU) {
        Raw<W> nxt[kU];
        load_rows<W, kU>(nxt, wpiece, ldw, r0 + kRowGroups * kU, pn);
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int r = r0 + u * kRowGroups;
          if (r < pn) {
            float wv[kVec];
            cvt8(cur[u], wv);
#pragma unroll
            for (int m = 0; m < kMT; ++m) {
              const float xv = smem[m * kPiece + r];
#pragma unroll
              for (int j = 0; j < kVec; ++j)
                acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) cur[u] = nxt[u];
      }
    }
  }
  cluster_store<T, kMT>(acc, smem, part, scale, out, N, col0, epi, tile, m0,
                        mt);
}

// B4's batch: a lane's 8 rows of one packed group (8 bytes each: 8
// columns, two nibbles a column) and the group's two m8 rows (low and high
// k-group) for its 8 columns.
struct Group4 {
  uint2 q[kRows4];
  uint2 mlo, mhi;
};

__device__ __forceinline__ void load_group(Group4& g, const uint8_t* wp,
                                           const int8_t* mp, int ldw,
                                           int ldm, int r0, int grp,
                                           int ng2) {
#pragma unroll
  for (int u = 0; u < kRows4; ++u)
    g.q[u] = __ldg(reinterpret_cast<const uint2*>(
        wp + (int64_t)(r0 + u * kRowGroups) * ldw));
  g.mlo = __ldg(reinterpret_cast<const uint2*>(mp + (int64_t)grp * ldm));
  g.mhi = __ldg(
      reinterpret_cast<const uint2*>(mp + (int64_t)(ng2 + grp) * ldm));
}

// the nibble at bit s (0, 4, 8 or 12) of v, less the storage bias 8, as a
// float in [-8, 7], exact: the nibble's bits OR a float 2^(23 - s)
// (exponent 150 - s, zero mantissa), whose mantissa LSB is worth 2^-s,
// minus 2^(23 - s) + 8
template <int kS>
__device__ __forceinline__ float nib(uint32_t v) {
  constexpr uint32_t kMagic = static_cast<uint32_t>(150 - kS) << 23;
  constexpr float kBase = static_cast<float>((1u << (23 - kS)) + 8u);
  return __uint_as_float((v & (0xFu << kS)) | kMagic) - kBase;
}

// a 32-bit word of 4 packed bytes (4 columns): low and high nibbles
__device__ __forceinline__ void unpack4(uint32_t v, float* lo, float* hi) {
  const uint32_t u = v >> 16;
  lo[0] = nib<0>(v); hi[0] = nib<4>(v);
  lo[1] = nib<8>(v); hi[1] = nib<12>(v);
  lo[2] = nib<0>(u); hi[2] = nib<4>(u);
  lo[3] = nib<8>(u); hi[3] = nib<12>(u);
}

__device__ __forceinline__ void m8_cvt(uint2 v, float* m) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int j = 0; j < kVec; ++j) m[j] = static_cast<float>(b[j]);
}

// One packed group of a lane into acc: its rows r0, r0 + 16, ... of the
// group (x's low half at xs[2m][r], high half at xs[2m + 1][r], rows kPiece
// apart), per column (x . (nib_u - 8)) * m8 for the low and the high
// k-group, in f32.
template <int kMT, int kPiece>
__device__ __forceinline__ void group_dot(const Group4& g, const float* xs,
                                          int r0, float (&acc)[kMT][kVec]) {
  float dlo[kMT][kVec], dhi[kMT][kVec];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < kVec; ++j) dlo[m][j] = dhi[m][j] = 0.f;
#pragma unroll
  for (int u = 0; u < kRows4; ++u) {
    const int r = r0 + u * kRowGroups;
    float lo[kVec], hi[kVec];
    unpack4(g.q[u].x, lo, hi);
    unpack4(g.q[u].y, lo + 4, hi + 4);
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      const float xl = xs[(2 * m) * kPiece + r];
      const float xh = xs[(2 * m + 1) * kPiece + r];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        dlo[m][j] = fmaf(xl, lo[j], dlo[m][j]);
        dhi[m][j] = fmaf(xh, hi[j], dhi[m][j]);
      }
    }
  }
  // the group's m8 after its dot, in f32
  float mlo[kVec], mhi[kVec];
  m8_cvt(g.mlo, mlo);
  m8_cvt(g.mhi, mhi);
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      acc[m][j] = fmaf(dlo[m][j], mlo[j], acc[m][j]);
      acc[m][j] = fmaf(dhi[m][j], mhi[j], acc[m][j]);
    }
}

// B4: as B, over packed groups (module comment). While a lane multiplies
// one group, the next one loads (more groups in flight measured no faster).
template <typename T, int kMT, bool kNorm>
__global__ void __launch_bounds__(kBThreads)
gemv4_cluster(const XT<T, kNorm>* __restrict__ x,
              const uint8_t* __restrict__ w, const int8_t* __restrict__ m8,
              const float* __restrict__ scale, const T* __restrict__ ln,
              float eps, void* __restrict__ out, int M, int K, int N,
              int ldw, int ldm, int col0, int epi) {
  constexpr int kPiece = kXStage / (2 * kMT);   // packed rows a piece
  static_assert(kPiece % kGroup4 == 0, "a piece holds whole groups");
  constexpr int kRed = kBWarps * kMT * kBTileN;
  __shared__ float smem[kRed > kXStage ? kRed : kXStage];
  __shared__ float part[kMT * kBTileN];
  __shared__ float rinv[kMT];

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / splits;
  const int m0 = blockIdx.y * kMT;
  const int mt = min(kMT, M - m0);
  const int half = K / 2;
  const int ng2 = half / kGroup4;                   // packed groups
  const int per = (ng2 + splits - 1) / splits;      // whole groups a rank
  const int kb = min(ng2, rank * per) * kGroup4;    // packed rows
  const int ke = min(ng2 * kGroup4, kb + per * kGroup4);
  const int rg = threadIdx.x / kLanesN;
  const int c = (threadIdx.x % kLanesN) * kVec;
  const int col = tile * kBTileN + c;
  const uint8_t* wp = w + col0 + col;
  const int8_t* mp = m8 + col0 + col;

  float acc[kMT][kVec];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[m][j] = 0.f;

  for (int p0 = kb; p0 < ke; p0 += kPiece) {
    const int pn = min(kPiece, ke - p0);
    // the piece's first group is in flight while x is staged
    Group4 cur;
    if (col < N)
      load_group(cur, wp, mp, ldw, ldm, p0 + rg, p0 / kGroup4, ng2);
    if constexpr (kNorm)
      if (p0 == kb) row_rms<kMT>(x, K, m0, mt, eps, part, rinv);
    __syncthreads();
    // x of the piece's low k's [p0, p0 + pn) and high k's half + [p0, ..)
    for (int i = threadIdx.x; i < kMT * 2 * pn; i += kBThreads) {
      const int m = i / (2 * pn), rem = i % (2 * pn);
      const int h = rem / pn, r = rem % pn;
      smem[(2 * m + h) * kPiece + r] =
          m < mt ? x_value<T, kNorm>(x, ln, rinv, K, m0, m,
                                     h * half + p0 + r)
                 : 0.f;
    }
    __syncthreads();
    if (col < N) {
      for (int g0 = 0; g0 < pn; g0 += kGroup4) {
        Group4 nxt;
        if (g0 + kGroup4 < pn)
          load_group(nxt, wp, mp, ldw, ldm, p0 + g0 + kGroup4 + rg,
                     (p0 + g0) / kGroup4 + 1, ng2);
        group_dot<kMT, kPiece>(cur, smem, g0 + rg, acc);
        cur = nxt;
      }
    }
  }
  cluster_store<T, kMT>(acc, smem, part, scale, out, N, col0, epi, tile, m0,
                        mt);
}

// x rows per block: the smallest of 1, 2, 4, 8 (B4: 1, 2, 4) that covers M,
// so a batch of one does no work for absent rows (ops/gemv.py row_tile)
template <int kMax, typename F>
int by_rows(int M, F&& f) {
  if (M == 1) return f(std::integral_constant<int, 1>{});
  if (M == 2) return f(std::integral_constant<int, 2>{});
  if constexpr (kMax == 4) {
    return f(std::integral_constant<int, 4>{});
  } else {
    if (M <= 4) return f(std::integral_constant<int, 4>{});
    return f(std::integral_constant<int, kMax>{});
  }
}

// grid (column tiles * splits, x row chunks); one split needs no cluster,
// and a cluster launch costs 0.3-0.9 us more on the H100 (chip_smoke.py
// split_times)
template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, int mt, int M, int N, int splits,
                   cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + kBTileN - 1) / kBTileN) * splits,
                     (M + mt - 1) / mt, 1);
  cfg.blockDim = dim3(kBThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const int err = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

template <typename T, typename W, bool kNorm>
int launch(const void* x, const void* w, const float* scale, const void* ln,
           float eps, void* out, int M, int K, int N, int ldw, int col0,
           int splits, int epi, cudaStream_t st) {
  return by_rows<kMaxMT>(M, [&](auto mt) {
    return launch_cluster(
        gemv_cluster<T, W, decltype(mt)::value, kNorm>, mt, M, N, splits, st,
        static_cast<const XT<T, kNorm>*>(x), static_cast<const W*>(w), scale,
        static_cast<const T*>(ln), eps, out, M, K, N, ldw, col0, epi);
  });
}

template <typename T, bool kNorm>
int launch4(const void* x, const void* w, const void* m8, const float* scale,
            const void* ln, float eps, void* out, int M, int K, int N,
            int ldw, int ldm, int col0, int splits, int epi,
            cudaStream_t st) {
  return by_rows<kMaxMT4>(M, [&](auto mt) {
    return launch_cluster(
        gemv4_cluster<T, decltype(mt)::value, kNorm>, mt, M, N, splits, st,
        static_cast<const XT<T, kNorm>*>(x), static_cast<const uint8_t*>(w),
        static_cast<const int8_t*>(m8), scale, static_cast<const T*>(ln),
        eps, out, M, K, N, ldw, ldm, col0, epi);
  });
}

template <typename Kernel>
int occupancy(Kernel kernel) {
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kBThreads, 0);
  return e != cudaSuccess ? -static_cast<int>(e) : n;
}

// resident blocks per SM of one weight kind's kernel at M
template <typename T, bool kNorm>
int blocks_per_sm(int wkind, int M) {
  if (wkind == 2)
    return by_rows<kMaxMT4>(M, [](auto mt) {
      return occupancy(gemv4_cluster<T, decltype(mt)::value, kNorm>);
    });
  if (wkind == 1)
    return by_rows<kMaxMT>(M, [](auto mt) {
      return occupancy(gemv_cluster<T, int8_t, decltype(mt)::value, kNorm>);
    });
  return by_rows<kMaxMT>(M, [](auto mt) {
    return occupancy(gemv_cluster<T, T, decltype(mt)::value, kNorm>);
  });
}

bool bad_shape(int M, int K, int splits) {
  return splits <= 0 || splits > kMaxSplits || M <= 0 || M > 32 || K <= 0;
}

}  // namespace

extern "C" {

// dtype (the model dtype T): 0 float32, 1 bfloat16. ln: the norm weight
// [K] in T, or null for no norm prologue; with it x is the f32 residual,
// without it x is in T. splits: the K split, the cluster size,
// 1..kMaxSplits (ops/gemv.py gemv_splits, gemv4_splits).

// B: W in T.
int gemv_launch(const void* x, const void* w, const void* ln, void* out,
                int M, int K, int N, int ldw, int col0, int splits,
                int dtype, int epi, float eps, void* stream) {
  if (bad_shape(M, K, splits)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (dtype == 0)
    return ln ? launch<float, float, true>(x, w, nullptr, ln, eps, out, M, K,
                                           N, ldw, col0, splits, epi, st)
              : launch<float, float, false>(x, w, nullptr, ln, eps, out, M,
                                            K, N, ldw, col0, splits, epi, st);
  return ln ? launch<BF, BF, true>(x, w, nullptr, ln, eps, out, M, K, N, ldw,
                                   col0, splits, epi, st)
            : launch<BF, BF, false>(x, w, nullptr, ln, eps, out, M, K, N,
                                    ldw, col0, splits, epi, st);
}

// B8: int8 q [K, ldw], f32 scale [ldw].
int gemv_int8_launch(const void* x, const void* q, const void* scale,
                     const void* ln, void* out, int M, int K, int N, int ldw,
                     int col0, int splits, int dtype, int epi, float eps,
                     void* stream) {
  if (bad_shape(M, K, splits)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  using BF = __nv_bfloat16;
  if (dtype == 0)
    return ln ? launch<float, int8_t, true>(x, q, sc, ln, eps, out, M, K, N,
                                            ldw, col0, splits, epi, st)
              : launch<float, int8_t, false>(x, q, sc, ln, eps, out, M, K, N,
                                             ldw, col0, splits, epi, st);
  return ln ? launch<BF, int8_t, true>(x, q, sc, ln, eps, out, M, K, N, ldw,
                                       col0, splits, epi, st)
            : launch<BF, int8_t, false>(x, q, sc, ln, eps, out, M, K, N, ldw,
                                        col0, splits, epi, st);
}

// B4: packed q4 [K/2, ldw], m8 [K/128, ldm], f32 scale [ldw]; K a multiple
// of 256, splits at most K / 256 (whole packed groups a rank).
int gemv_int4_launch(const void* x, const void* q4, const void* m8,
                     const void* scale, const void* ln, void* out, int M,
                     int K, int N, int ldw, int ldm, int col0, int splits,
                     int dtype, int epi, float eps, void* stream) {
  if (bad_shape(M, K, splits) || K % (2 * kGroup4) ||
      splits > K / (2 * kGroup4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  using BF = __nv_bfloat16;
  if (dtype == 0)
    return ln ? launch4<float, true>(x, q4, m8, sc, ln, eps, out, M, K, N,
                                     ldw, ldm, col0, splits, epi, st)
              : launch4<float, false>(x, q4, m8, sc, ln, eps, out, M, K, N,
                                      ldw, ldm, col0, splits, epi, st);
  return ln ? launch4<BF, true>(x, q4, m8, sc, ln, eps, out, M, K, N, ldw,
                                ldm, col0, splits, epi, st)
            : launch4<BF, false>(x, q4, m8, sc, ln, eps, out, M, K, N, ldw,
                                 ldm, col0, splits, epi, st);
}

// Resident blocks per SM of the kernel for (dtype, weight kind: 0 dense,
// 1 int8, 2 int4, M, norm prologue), for the grid plan; a negative
// cudaError_t on failure.
int gemv_blocks_per_sm(int dtype, int wkind, int M, int norm) {
  if (dtype == 0)
    return norm ? blocks_per_sm<float, true>(wkind, M)
                : blocks_per_sm<float, false>(wkind, M);
  return norm ? blocks_per_sm<__nv_bfloat16, true>(wkind, M)
              : blocks_per_sm<__nv_bfloat16, false>(wkind, M);
}

}  // extern "C"
