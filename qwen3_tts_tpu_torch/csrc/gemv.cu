// Skinny matmul y[M, N] = x[M, K] @ W[K, N] for decode batches (M <= 32):
// kernel B (W in the model dtype), B8 (int8 W, per-column scale) and B4
// (packed biased int4 W with per-group multipliers m8 and a per-column
// scale).
//
// Replaces: the `stream_matmul` helpers inside the two TPU kernels,
//   qwen3_tts_tpu/ops/fused_talker.py::_kernel_body (stream_matmul) and
//   qwen3_tts_tpu/ops/fused_predictor.py::_kernel_body (stream_matmul):
//   every qkv / wo / gate-up / down / head product of the talker step and
//   the predictor frame, for dense, int8 and int4 weights; B4 computes the
//   int4 panel order of qwen3_tts_tpu/ops/quant.py::panel_matmul4.
//
// Bound: weight bytes. At M <= 32 each weight element is used M times, far
//   below the ~295 FLOP/byte where Hopper's tensor cores become the limit,
//   so the product costs the time to read the K*N weights from HBM: 2 or 4
//   bytes each for B, 1 for B8, 1/2 (+ 1/128 for m8) for B4.
//
// Design (B, B8), one CUDA kernel per product, aimed at M = 1-2:
//   * Tiles. A block (8 warps) owns a 128-column tile of W and one K
//     range: 16 lanes span a row (8 columns, one 16-byte load of bf16, two
//     of f32, one 8-byte load of int8, a lane), so a warp reads two rows and
//     the block 16 rows a step. x rows (MT = 1, 2, 4 or 8 per block by M;
//     grid.y walks row chunks) are staged in shared memory as f32, in
//     pieces of 4096 / MT rows, and broadcast.
//   * Bytes in flight. Each lane keeps two batches of 128 bytes of
//     independent loads in flight (a batch: 8 16-byte loads of bf16, 16
//     8-byte loads of int8, 4 pairs of f32): the next batch loads while the
//     current one is multiplied, and a piece's first batch loads while x is
//     staged. The grid is sized in Python from the SM count and the
//     resident blocks a SM takes (`gemv_blocks_per_sm`), with at least 32 KB
//     of weights per block.
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
// Design (B4): packed row r holds k = r (low nibble) and k = K/2 + r (high
//   nibble), so a block's chunk of one packed group (128 packed rows) covers
//   two whole k-groups, g and ng/2 + g. A chunk never splits a group (the
//   group's m8 is applied after its dot, as panel_matmul4 does); the
//   parallelism comes from narrower column tiles (4 columns a thread, 4-byte
//   loads, 128 columns a block). Per group and column the block forms
//   (x_g . nib_u  -  8 * rowsum(x_g)) * m8[g] in f32, nib_u the biased
//   nibble in [0, 15]: the storage bias folds out through the rowsum. B4
//   keeps two launches: its partials go to an f32 workspace [K/256, M, N]
//   and `gemv_epilogue` sums them in group order, then scale and epilogue.
//
// W is row-major [K, ldw] (B4: [K/2, ldw], m8 [K/128, ldm]); `col0` selects
// columns [col0, col0 + N) (the predictor's per-codebook head slice) of W,
// m8 and scale alike, with no copy. x is in the model dtype T (float or
// bf16); accumulation is f32.
//
// Epilogues: 0 store T, 1 store f32, 2 store f32 rounded through T
// (logits), 3 add into an f32 residual buffer.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// B and B8 (ops/gemv.py TILE_N, MAX_SPLITS)
constexpr int kBThreads = 256;           // 8 warps
constexpr int kBWarps = kBThreads / 32;
constexpr int kVec = 8;                  // output columns per lane
constexpr int kLanesN = 16;              // lanes across one weight row
constexpr int kBTileN = kLanesN * kVec;  // 128 columns per block
constexpr int kRowGroups = kBThreads / kLanesN;   // 16 rows a step
constexpr int kXStage = 4096;            // x values staged per piece
constexpr int kMaxSplits = 8;            // portable cluster size
constexpr int kFlightBytes = 128;        // loads in flight per lane
// B4
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxMT = 8;                // max x rows per block
constexpr int kGroup4 = 128;             // int4 k-group (quant.GROUP4)
constexpr int kCols4 = 4;                // B4 output columns per thread
constexpr int kTileN4 = 32 * kCols4;     // 128 columns per B4 block

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

// B / B8: y[m0 + m, n] for one 128-column tile and row chunk, the K split
// over the cluster (module comment). scale == nullptr for dense weights.
template <typename T, typename W, int kMT>
__global__ void __launch_bounds__(kBThreads)
gemv_cluster(const T* __restrict__ x, const W* __restrict__ w,
             const float* __restrict__ scale, void* __restrict__ out, int M,
             int K, int N, int ldw, int col0, int epi) {
  constexpr int kU = kFlightBytes / (kVec * sizeof(W));   // rows per lane
  constexpr int kPiece = kXStage / kMT;                    // x rows a piece
  constexpr int kRed = kBWarps * kMT * kBTileN;
  // x pieces during the loop, then the warps' partials
  __shared__ float smem[kRed > kXStage ? kRed : kXStage];
  __shared__ float part[kMT * kBTileN];                    // the block's sum

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / splits;
  const int m0 = blockIdx.y * kMT;
  const int mt = min(kMT, M - m0);
  const int rows = (K + splits - 1) / splits;
  const int kb = min(K, rank * rows);
  const int ke = min(K, kb + rows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
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
    // the piece's first rows are in flight while x is staged
    Raw<W> cur[kU];
    if (col < N) load_rows<W, kU>(cur, wpiece, ldw, rg, pn);
    __syncthreads();                      // the last piece's reads are done
    for (int i = threadIdx.x; i < kMT * pn; i += kBThreads) {
      const int m = i / pn, k = i % pn;
      smem[m * kPiece + k] =
          m < mt ? to_f32(x[(int64_t)(m0 + m) * K + p0 + k]) : 0.f;
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

  // the two row groups of a warp hold the same columns: add them, then the
  // warps in warp order
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

  // the K ranges of the tile: every rank's partials, in rank order, through
  // distributed shared memory; rank r finishes slice r of the tile. The
  // column scale and the residual of the thread's first element (its only
  // one at M <= 2) are fetched before the cluster barrier.
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

// B4's partial sums over one packed group: block (column tile, packed
// group c, row chunk). Writes part[c, m, n] = sum over the two k-groups
// c (low nibbles) and ng/2 + c (high nibbles) of
// (x_g . nib_u_g - 8 * rowsum(x_g)) * m8[g, n].
template <typename T, int kMT>
__global__ void __launch_bounds__(kThreads)
gemv4_partial(const T* __restrict__ x, const uint8_t* __restrict__ w,
              const int8_t* __restrict__ m8, float* __restrict__ part, int M,
              int K, int N, int ldw, int ldm, int col0) {
  __shared__ float xs[2][kMT][kGroup4];
  __shared__ float xsum[2][kMT];
  __shared__ float red[2][kWarps][kMT][kTileN4];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.y;                  // packed group
  const int half = K / 2;
  const int ng2 = half / kGroup4;
  const int r0 = c * kGroup4;                // first packed row
  const int m0 = blockIdx.z * kMT;
  const int mt = min(kMT, M - m0);
  const int col = blockIdx.x * kTileN4 + lane * kCols4;   // within [0, N)

  // x of the two k-groups: k = r0 + i (low) and k = half + r0 + i (high)
  for (int i = threadIdx.x; i < 2 * kMT * kGroup4; i += kThreads) {
    int h = i / (kMT * kGroup4), rem = i % (kMT * kGroup4);
    int m = rem / kGroup4, k = rem % kGroup4;
    xs[h][m][k] = m < mt
        ? to_f32(x[(int64_t)(m0 + m) * K + h * half + r0 + k]) : 0.f;
  }
  __syncthreads();
  // row sums of x over each group, one warp per (half, row), in f32
  for (int j = warp; j < 2 * kMT; j += kWarps) {
    int h = j / kMT, m = j % kMT;
    float s = 0.f;
    for (int k = lane; k < kGroup4; k += 32) s += xs[h][m][k];
#pragma unroll
    for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) xsum[h][m] = s;
  }

  float lo_acc[kMT][kCols4], hi_acc[kMT][kCols4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < kCols4; ++j) lo_acc[m][j] = hi_acc[m][j] = 0.f;

  if (col < N) {
    const uint8_t* wp = w + (int64_t)r0 * ldw + col0 + col;
#pragma unroll 4
    for (int k = warp; k < kGroup4; k += kWarps) {
      uint32_t raw = *reinterpret_cast<const uint32_t*>(wp + (int64_t)k * ldw);
      float lo[kCols4], hi[kCols4];
#pragma unroll
      for (int j = 0; j < kCols4; ++j) {
        uint32_t b = (raw >> (8 * j)) & 0xFFu;
        lo[j] = static_cast<float>(b & 0xFu);
        hi[j] = static_cast<float>(b >> 4);
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        float xl = xs[0][m][k], xh = xs[1][m][k];
#pragma unroll
        for (int j = 0; j < kCols4; ++j) {
          lo_acc[m][j] = fmaf(xl, lo[j], lo_acc[m][j]);
          hi_acc[m][j] = fmaf(xh, hi[j], hi_acc[m][j]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < kCols4; ++j) {
      red[0][warp][m][lane * kCols4 + j] = lo_acc[m][j];
      red[1][warp][m][lane * kCols4 + j] = hi_acc[m][j];
    }
  __syncthreads();

  // per (row, column): the two groups' dots summed over warps in a fixed
  // order, the bias folded out, m8 applied in f32
  for (int i = threadIdx.x; i < mt * kTileN4; i += kThreads) {
    int m = i / kTileN4, cc = i % kTileN4;
    int n = blockIdx.x * kTileN4 + cc;
    if (n >= N) continue;
    float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      s_lo += red[0][q][m][cc];
      s_hi += red[1][q][m][cc];
    }
    float m_lo = static_cast<float>(m8[(int64_t)c * ldm + col0 + n]);
    float m_hi = static_cast<float>(m8[(int64_t)(ng2 + c) * ldm + col0 + n]);
    float y = (s_lo - 8.f * xsum[0][m]) * m_lo;
    y += (s_hi - 8.f * xsum[1][m]) * m_hi;
    part[((int64_t)c * M + m0 + m) * N + n] = y;
  }
}

// B4's second launch: sum the packed groups' partials in group order, times
// the column scale, then the epilogue.
template <typename T>
__global__ void gemv_epilogue(const float* __restrict__ part,
                              const float* __restrict__ scale, void* out,
                              int M, int N, int col0, int k_chunks, int epi) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  float s = 0.f;
  for (int c = 0; c < k_chunks; ++c) s += part[(int64_t)c * M * N + i];
  if (scale != nullptr) s *= scale[col0 + i % N];
  switch (epi) {
    case 0: store_t(reinterpret_cast<T*>(out) + i, s); break;
    case 1: reinterpret_cast<float*>(out)[i] = s; break;
    case 2: reinterpret_cast<float*>(out)[i] = round_t(s, (T*)nullptr); break;
    default: reinterpret_cast<float*>(out)[i] += s; break;
  }
}

template <typename T, typename W, int kMT>
int launch_cluster(const void* x, const void* w, const float* scale,
                   void* out, int M, int K, int N, int ldw, int col0,
                   int splits, int epi, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + kBTileN - 1) / kBTileN) * splits,
                     (M + kMT - 1) / kMT, 1);
  cfg.blockDim = dim3(kBThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  // one split needs no cluster; a cluster launch costs 0.3-0.9 us more on
  // the H100 (chip_smoke.py split_times)
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, gemv_cluster<T, W, kMT>, static_cast<const T*>(x),
      static_cast<const W*>(w), scale, out, M, K, N, ldw, col0, epi));
}

// rows per block: the smallest of 1, 2, 4, 8 that covers M (up to 8), so a
// batch of one does no work for absent rows (ops/gemv.py gemv_splits)
template <typename T, typename W>
int launch(const void* x, const void* w, const float* scale, void* out,
           int M, int K, int N, int ldw, int col0, int splits, int epi,
           cudaStream_t st) {
  int err;
  if (M == 1)
    err = launch_cluster<T, W, 1>(x, w, scale, out, M, K, N, ldw, col0,
                                  splits, epi, st);
  else if (M == 2)
    err = launch_cluster<T, W, 2>(x, w, scale, out, M, K, N, ldw, col0,
                                  splits, epi, st);
  else if (M <= 4)
    err = launch_cluster<T, W, 4>(x, w, scale, out, M, K, N, ldw, col0,
                                  splits, epi, st);
  else
    err = launch_cluster<T, W, kMaxMT>(x, w, scale, out, M, K, N, ldw, col0,
                                       splits, epi, st);
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

template <typename T, typename W>
int blocks_per_sm(int M) {
  int n = 0;
  cudaError_t e;
  if (M == 1)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, gemv_cluster<T, W, 1>, kBThreads, 0);
  else if (M == 2)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, gemv_cluster<T, W, 2>, kBThreads, 0);
  else if (M <= 4)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, gemv_cluster<T, W, 4>, kBThreads, 0);
  else
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, gemv_cluster<T, W, kMaxMT>, kBThreads, 0);
  return e != cudaSuccess ? -static_cast<int>(e) : n;
}

template <typename T>
void launch_epilogue(const void* part, const float* scale, void* out, int M,
                     int N, int col0, int k_chunks, int epi,
                     cudaStream_t st) {
  int total = M * N;
  gemv_epilogue<T><<<(total + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), scale, out, M, N, col0, k_chunks, epi);
}

template <typename T, int kMT>
void launch4_partial(const void* x, const void* w, const void* m8, void* part,
                     int M, int K, int N, int ldw, int ldm, int col0,
                     cudaStream_t st) {
  dim3 grid((N + kTileN4 - 1) / kTileN4, K / (2 * kGroup4),
            (M + kMT - 1) / kMT);
  gemv4_partial<T, kMT><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(w),
      static_cast<const int8_t*>(m8), static_cast<float*>(part), M, K, N,
      ldw, ldm, col0);
}

// B4: x in T, packed int4 W, m8, scale
template <typename T>
int launch4(const void* x, const void* w, const void* m8, const float* scale,
            void* out, void* part, int M, int K, int N, int ldw, int ldm,
            int col0, int epi, cudaStream_t st) {
  if (M == 1)
    launch4_partial<T, 1>(x, w, m8, part, M, K, N, ldw, ldm, col0, st);
  else if (M == 2)
    launch4_partial<T, 2>(x, w, m8, part, M, K, N, ldw, ldm, col0, st);
  else if (M <= 4)
    launch4_partial<T, 4>(x, w, m8, part, M, K, N, ldw, ldm, col0, st);
  else
    launch4_partial<T, kMaxMT>(x, w, m8, part, M, K, N, ldw, ldm, col0, st);
  launch_epilogue<T>(part, scale, out, M, N, col0, K / (2 * kGroup4), epi,
                     st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B. dtype: 0 float32, 1 bfloat16 (x and W). splits: the K split, the
// cluster size, 1..kMaxSplits (ops/gemv.py gemv_splits).
int gemv_launch(const void* x, const void* w, void* out, int M, int K, int N,
                int ldw, int col0, int splits, int dtype, int epi,
                void* stream) {
  if (splits <= 0 || splits > kMaxSplits || M <= 0 || M > 32 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(x, w, nullptr, out, M, K, N, ldw, col0,
                                splits, epi, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, w, nullptr, out, M, K, N,
                                              ldw, col0, splits, epi, st);
}

// B8: int8 q [K, ldw], f32 scale [ldw]; dtype of x as for B.
int gemv_int8_launch(const void* x, const void* q, const void* scale,
                     void* out, int M, int K, int N, int ldw, int col0,
                     int splits, int dtype, int epi, void* stream) {
  if (splits <= 0 || splits > kMaxSplits || M <= 0 || M > 32 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0)
    return launch<float, int8_t>(x, q, sc, out, M, K, N, ldw, col0, splits,
                                 epi, st);
  return launch<__nv_bfloat16, int8_t>(x, q, sc, out, M, K, N, ldw, col0,
                                       splits, epi, st);
}

// Resident blocks per SM of the B / B8 kernel for (dtype, int8 weights, M),
// for the grid plan; a negative cudaError_t on failure.
int gemv_blocks_per_sm(int dtype, int int8_w, int M) {
  if (dtype == 0)
    return int8_w ? blocks_per_sm<float, int8_t>(M)
                  : blocks_per_sm<float, float>(M);
  return int8_w ? blocks_per_sm<__nv_bfloat16, int8_t>(M)
                : blocks_per_sm<__nv_bfloat16, __nv_bfloat16>(M);
}

// B4: packed q4 [K/2, ldw], m8 [K/128, ldm], f32 scale [ldw]; K a multiple
// of 256. part: f32 [K/256, M, N].
int gemv_int4_launch(const void* x, const void* q4, const void* m8,
                     const void* scale, void* out, void* part, int M, int K,
                     int N, int ldw, int ldm, int col0, int dtype, int epi,
                     void* stream) {
  if (M <= 0 || M > 32 || K <= 0 || K % (2 * kGroup4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0)
    return launch4<float>(x, q4, m8, sc, out, part, M, K, N, ldw, ldm, col0,
                          epi, st);
  return launch4<__nv_bfloat16>(x, q4, m8, sc, out, part, M, K, N, ldw, ldm,
                                col0, epi, st);
}

}  // extern "C"
