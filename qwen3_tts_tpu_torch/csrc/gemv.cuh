// Device code of the skinny matmul kernels B, B8 and B4, shared by their
// translation units (gemv.cu: B and the C entry points' common parts,
// gemv_int8.cu: B8, gemv_int4.cu: B4), which nvcc compiles in parallel.
// The design, the bound and what each piece replaces are described at the
// top of gemv.cu.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

// The qk epilogue's arguments (ops/gemv.py _QkArgs, field for field): the
// per-head norm weights [hd] and the outputs q [M, nq, hd], k, v [M, nk,
// hd] in the model dtype T; cos / sin [M, hd] f32; the KV store's slot
// views of an f32 cache (kc[b * kc_sb + h * kc_sh + d], null for none).
struct QkArgs {
  const void* q_norm;
  const void* k_norm;
  const float* cos;
  const float* sin;
  void* q;
  void* k;
  void* v;
  float* kc;
  float* vc;
  long long kc_sb, kc_sh, vc_sb, vc_sh;
  int nq, nk, hd;
  float eps;
};

// Occupancy of B8's and B4's kernels (defined in their translation units,
// read by gemv_blocks_per_sm in gemv.cu).
int gemv_int8_blocks_per_sm(int dtype, int M, int pro);
int gemv_int4_blocks_per_sm(int dtype, int M, int pro);

namespace {

// ops/gemv.py TILE_N, MAX_SPLITS, GROUP4, PRO_*, EPI_*
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
constexpr int kMaxHd = 128;              // the qk epilogue's widest head
constexpr int kProNone = 0, kProNorm = 1, kProSilu = 2;   // prologues
constexpr int kEpiAdd = 3, kEpiQk = 4;

// x's element type: the model dtype, or f32 with a prologue (the residual
// for the norm, the gate/up product for silu)
template <typename T, int kPro>
using XT = typename std::conditional<kPro == kProNone, T, float>::type;

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

// One staged x value at row m0 + m, column k < K, in f32: x itself; its
// normed value rounded once through T (norm); or silu(g) * u rounded once
// through T from the gate/up row [g | u] of width 2K (silu).
template <typename T, int kPro>
__device__ __forceinline__ float x_value(const XT<T, kPro>* __restrict__ x,
                                         const T* __restrict__ ln,
                                         const float* rinv, int K, int m0,
                                         int m, int k) {
  if constexpr (kPro == kProSilu) {
    const float* row = x + (int64_t)(m0 + m) * 2 * K;
    const float g = row[k];
    return round_t(g / (1.f + expf(-g)) * row[K + k], (T*)nullptr);
  } else {
    const float v = to_f32(x[(int64_t)(m0 + m) * K + k]);
    if constexpr (kPro == kProNorm)
      return round_t(v * rinv[m] * to_f32(ln[k]), (T*)nullptr);
    else
      return v;
  }
}

// The tile's value at index i (row i / kBTileN) of the cluster's K split:
// every rank's partials, all in flight at once, summed in rank order.
__device__ __forceinline__ float rank_sum(cg::cluster_group& cluster,
                                          float* part, int splits, int i) {
  float v[kMaxSplits];
#pragma unroll
  for (int q = 0; q < kMaxSplits; ++q)
    v[q] = q < splits ? cluster.map_shared_rank(part, q)[i] : 0.f;
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxSplits; ++q)
    if (q < splits) s += v[q];
  return s;
}

// The qk epilogue: the tile's 128 / hd whole heads of each row, a warp per
// (row, head), the (row, head) units split over the ranks in equal whole
// numbers, so a head's sum of squares is one warp's shuffle reduction. Per
// head: s = the product's f32 value (times the column scale) rounded once
// to T, as epilogue 0 stores it. q and k heads: n = T(s * rsqrt(mean(s^2)
// + eps) * w_norm), then rotate-half RoPE T(n * T(cos) + rot(n) * T(sin))
// in f32 with one rounding (ops/elementwise.py qk_norm_rope_plain); v
// heads: s. Stores q, k, v in T and, given a KV store, f32(k) and f32(v)
// into the cache's slot views. `scratch` holds kBWarps * kMaxHd floats (a
// warp's normed head, read back at the rotation's partner e ^ hd/2).
template <typename T, int kMT>
__device__ __forceinline__ void qk_finish(float* part, float* scratch,
                                          const float* __restrict__ scale,
                                          int col0, int tile, int m0, int mt,
                                          const QkArgs& qk) {
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hd = qk.hd, half = hd / 2;
  const int hpt = kBTileN / hd;                       // whole heads a tile
  const int units = mt * hpt;
  const int per = (units + splits - 1) / splits;
  const int u1 = min(units, (rank + 1) * per);
  float* xs = scratch + warp * kMaxHd;
  for (int u = rank * per + warp; u < u1; u += kBWarps) {
    const int m = u / hpt, c0 = (u % hpt) * hd;     // row, head's column
    const int h = tile * hpt + u % hpt;             // head of the qkv row
    if (h >= qk.nq + 2 * qk.nk) continue;           // past the last head
    const int b = m0 + m;
    float v[kMaxHd / 32];
    float ss = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxHd / 32; ++t) {
      const int e = lane + 32 * t;
      v[t] = 0.f;
      if (e < hd) {
        float s = rank_sum(cluster, part, splits, m * kBTileN + c0 + e);
        if (scale != nullptr) s *= scale[col0 + tile * kBTileN + c0 + e];
        v[t] = round_t(s, (T*)nullptr);
        ss = fmaf(v[t], v[t], ss);
      }
    }
    if (h < qk.nq + qk.nk) {                        // q or k: norm, RoPE
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float r = rsqrtf(ss / static_cast<float>(hd) + qk.eps);
      const T* w = static_cast<const T*>(h < qk.nq ? qk.q_norm : qk.k_norm);
#pragma unroll
      for (int t = 0; t < kMaxHd / 32; ++t) {
        const int e = lane + 32 * t;
        if (e < hd) {
          v[t] = round_t(v[t] * r * to_f32(w[e]), (T*)nullptr);
          xs[e] = v[t];
        }
      }
      __syncwarp();
#pragma unroll
      for (int t = 0; t < kMaxHd / 32; ++t) {
        const int e = lane + 32 * t;
        if (e < hd) {
          const float p = xs[e ^ half];
          const float rot = e < half ? -p : p;
          const float c = round_t(qk.cos[(int64_t)b * hd + e], (T*)nullptr);
          const float sn = round_t(qk.sin[(int64_t)b * hd + e], (T*)nullptr);
          v[t] = round_t(__fadd_rn(__fmul_rn(v[t], c), __fmul_rn(rot, sn)),
                         (T*)nullptr);
        }
      }
      __syncwarp();                   // xs is rewritten by the next unit
    }
    T* dst;
    float* cache = nullptr;
    if (h < qk.nq) {
      dst = static_cast<T*>(qk.q) + ((int64_t)b * qk.nq + h) * hd;
    } else if (h < qk.nq + qk.nk) {
      const int j = h - qk.nq;
      dst = static_cast<T*>(qk.k) + ((int64_t)b * qk.nk + j) * hd;
      if (qk.kc != nullptr) cache = qk.kc + b * qk.kc_sb + j * qk.kc_sh;
    } else {
      const int j = h - qk.nq - qk.nk;
      dst = static_cast<T*>(qk.v) + ((int64_t)b * qk.nk + j) * hd;
      if (qk.vc != nullptr) cache = qk.vc + b * qk.vc_sb + j * qk.vc_sh;
    }
#pragma unroll
    for (int t = 0; t < kMaxHd / 32; ++t) {
      const int e = lane + 32 * t;
      if (e < hd) {
        store_t(dst + e, v[t]);
        if (cache != nullptr) cache[e] = v[t];    // already rounded to T
      }
    }
  }
}

// The tile's reduction and store, shared by B and B4. acc: a lane's sums
// over its rows for its 8 columns c..c+7 of the tile. The two row groups of
// a warp hold the same columns: add them, then the warps in warp order;
// then the K ranges of the tile: every rank's partials, in rank order,
// through distributed shared memory; rank r finishes slice r of the tile
// (the qk epilogue: whole heads, `qk_finish`). The column scale and the
// residual of the thread's first element (its only one at M <= 2) are
// fetched before the cluster barrier. `smem` holds kBWarps * kMT * kBTileN
// floats, `part` kMT * kBTileN. Only the norm's instantiations (kQk)
// compile the qk epilogue: it always follows the ln1 prologue.
template <typename T, int kMT, bool kQk>
__device__ __forceinline__ void cluster_store(
    float (&acc)[kMT][kVec], float* smem, float* part,
    const float* __restrict__ scale, void* __restrict__ out, int N,
    int col0, int epi, int tile, int m0, int mt, const QkArgs& qk) {
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

  if constexpr (kQk) {
    if (epi == kEpiQk) {
      cluster.sync();             // every part is summed; smem is free
      qk_finish<T, kMT>(part, smem, scale, col0, tile, m0, mt, qk);
      cluster.sync();             // no block leaves while its part is read
      return;
    }
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
      if (epi == kEpiAdd)
        res0 = reinterpret_cast<const float*>(
            out)[(int64_t)(m0 + i0 / kBTileN) * N + n];
    }
  }
  cluster.sync();
  for (int i = i0; i < i1; i += kBThreads) {
    const int m = i / kBTileN, n = tile * kBTileN + i % kBTileN;
    if (n >= N) continue;
    float s = rank_sum(cluster, part, splits, i);
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
// over the cluster (gemv.cu). scale == nullptr for dense weights.
template <typename T, typename W, int kMT, int kPro>
__global__ void __launch_bounds__(kBThreads)
gemv_cluster(const XT<T, kPro>* __restrict__ x, const W* __restrict__ w,
             const float* __restrict__ scale, const T* __restrict__ ln,
             float eps, void* __restrict__ out, int M, int K, int N, int ldw,
             int col0, int epi, QkArgs qk) {
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
    if constexpr (kPro == kProNorm)
      if (p0 == kb) row_rms<kMT>(x, K, m0, mt, eps, part, rinv);
    __syncthreads();                      // the last piece's reads are done
    for (int i = threadIdx.x; i < kMT * pn; i += kBThreads) {
      const int m = i / pn, k = i % pn;
      smem[m * kPiece + k] =
          m < mt ? x_value<T, kPro>(x, ln, rinv, K, m0, m, p0 + k) : 0.f;
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
  cluster_store<T, kMT, kPro == kProNorm>(acc, smem, part, scale, out, N,
                                          col0, epi, tile, m0, mt, qk);
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

// B4: as B, over packed groups (gemv.cu). While a lane multiplies one
// group, the next one loads (more groups in flight measured no faster).
template <typename T, int kMT, int kPro>
__global__ void __launch_bounds__(kBThreads)
gemv4_cluster(const XT<T, kPro>* __restrict__ x,
              const uint8_t* __restrict__ w, const int8_t* __restrict__ m8,
              const float* __restrict__ scale, const T* __restrict__ ln,
              float eps, void* __restrict__ out, int M, int K, int N,
              int ldw, int ldm, int col0, int epi, QkArgs qk) {
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
    if constexpr (kPro == kProNorm)
      if (p0 == kb) row_rms<kMT>(x, K, m0, mt, eps, part, rinv);
    __syncthreads();
    // x of the piece's low k's [p0, p0 + pn) and high k's half + [p0, ..),
    // each through the prologue
    for (int i = threadIdx.x; i < kMT * 2 * pn; i += kBThreads) {
      const int m = i / (2 * pn), rem = i % (2 * pn);
      const int h = rem / pn, r = rem % pn;
      smem[(2 * m + h) * kPiece + r] =
          m < mt ? x_value<T, kPro>(x, ln, rinv, K, m0, m,
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
  cluster_store<T, kMT, kPro == kProNorm>(acc, smem, part, scale, out, N,
                                          col0, epi, tile, m0, mt, qk);
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

// the prologue code as a template argument
template <typename F>
int by_pro(int pro, F&& f) {
  if (pro == kProNorm) return f(std::integral_constant<int, kProNorm>{});
  if (pro == kProSilu) return f(std::integral_constant<int, kProSilu>{});
  return f(std::integral_constant<int, kProNone>{});
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

template <typename Kernel>
int occupancy(Kernel kernel) {
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kBThreads, 0);
  return e != cudaSuccess ? -static_cast<int>(e) : n;
}

// A launch's arguments that the kernels do not take (ops/gemv.py refuses
// them first): M, K, the split, the prologue and its norm weight, the
// epilogue; the qk epilogue only after the norm prologue, over the whole
// qkv width (nq + 2 nk) * hd from column 0, with hd a power of two in
// [2, 128] (a 128-column tile holds whole heads).
bool bad_args(int M, int K, int N, int col0, int splits, int pro,
              const void* ln, int epi, const QkArgs* qk) {
  if (splits <= 0 || splits > kMaxSplits || M <= 0 || M > 32 || K <= 0 ||
      pro < kProNone || pro > kProSilu || (pro == kProNorm) != (ln != nullptr)
      || epi < 0 || epi > kEpiQk)
    return true;
  if (epi != kEpiQk) return false;
  if (pro != kProNorm || qk == nullptr || col0 != 0) return true;
  const int hd = qk->hd;
  return hd < 2 || hd > kMaxHd || (hd & (hd - 1)) || qk->nq <= 0 ||
         qk->nk <= 0 || N != (qk->nq + 2 * qk->nk) * hd ||
         qk->q == nullptr || qk->k == nullptr || qk->v == nullptr ||
         qk->q_norm == nullptr || qk->k_norm == nullptr ||
         qk->cos == nullptr || qk->sin == nullptr ||
         (qk->kc == nullptr) != (qk->vc == nullptr);
}

QkArgs qk_or_none(const void* qk) {
  return qk != nullptr ? *static_cast<const QkArgs*>(qk) : QkArgs{};
}

}  // namespace
