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
// Design (B, B8): every weight byte is read once per row chunk, neighbouring
//   threads on neighbouring addresses (16-byte loads for bf16 / f32, 8-byte
//   loads of int8). Each thread owns 8 output columns; a warp covers 256
//   contiguous columns of one weight row. A block (4 warps) covers a
//   256-column tile and a K chunk; its warps take interleaved rows of the
//   chunk and are summed in shared memory in a fixed order. The grid's K
//   split gives enough blocks to keep 132 SMs streaming; partial sums go to
//   an f32 workspace [k_chunks, M, N] and a second small kernel adds them in
//   chunk order, multiplies by the column scale (B8, B4) and applies the
//   epilogue, so results do not depend on scheduling. x rows (MT = 1, 2, 4
//   or 8 per block by M; grid.z walks row chunks) are staged in shared
//   memory as f32 and broadcast to all lanes. int8 -> f32 is exact
//   (|q| <= 127), so B8 is B's arithmetic with 1-byte weights.
//
// Design (B4): packed row r holds k = r (low nibble) and k = K/2 + r (high
//   nibble), so a block's chunk of one packed group (128 packed rows) covers
//   two whole k-groups, g and ng/2 + g. A chunk never splits a group (the
//   group's m8 is applied after its dot, as panel_matmul4 does); the
//   parallelism comes from narrower column tiles (4 columns a thread, 4-byte
//   loads, 128 columns a block). Per group and column the block forms
//   (x_g . nib_u  -  8 * rowsum(x_g)) * m8[g] in f32, nib_u the biased
//   nibble in [0, 15]: the storage bias folds out through the rowsum.
//
// W is row-major [K, ldw] (B4: [K/2, ldw], m8 [K/128, ldm]); `col0` selects
// columns [col0, col0 + N) (the predictor's per-codebook head slice) of W,
// m8 and scale alike, with no copy. x is in the model dtype T (float or
// bf16); accumulation is f32.
//
// Epilogues: 0 store T, 1 store f32, 2 store f32 rounded through T
// (logits), 3 add into an f32 residual buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 8;                 // output columns per thread
constexpr int kTileN = 32 * kCols;       // 256 columns per block
constexpr int kMaxChunk = 256;           // max K rows per block
constexpr int kMaxMT = 8;                // max x rows per block
constexpr int kGroup4 = 128;             // int4 k-group (quant.GROUP4)
constexpr int kCols4 = 4;                // B4 output columns per thread
constexpr int kTileN4 = 32 * kCols4;     // 128 columns per B4 block

__device__ __forceinline__ void load8(const float* p, float* w) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* w) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* w) {
  int2 raw = *reinterpret_cast<const int2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
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

template <typename T, typename W, int kMT>
__global__ void __launch_bounds__(kThreads)
gemv_partial(const T* __restrict__ x, const W* __restrict__ w,
             float* __restrict__ part, int M, int K, int N, int ldw,
             int col0, int chunk) {
  __shared__ float xs[kMT][kMaxChunk];
  __shared__ float red[kWarps][kMT][kTileN];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.y * chunk;
  const int kn = min(chunk, K - k0);
  const int m0 = blockIdx.z * kMT;
  const int mt = min(kMT, M - m0);
  const int col = blockIdx.x * kTileN + lane * kCols;   // within [0, N)

  for (int i = threadIdx.x; i < kMT * kn; i += kThreads) {
    int m = i / kn, k = i % kn;
    xs[m][k] = m < mt ? to_f32(x[(int64_t)(m0 + m) * K + k0 + k]) : 0.f;
  }
  __syncthreads();

  float acc[kMT][kCols];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;

  if (col < N) {
    const W* wp = w + (int64_t)k0 * ldw + col0 + col;
#pragma unroll 4
    for (int k = warp; k < kn; k += kWarps) {
      float wv[kCols];
      load8(wp + (int64_t)k * ldw, wv);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        float xv = xs[m][k];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) red[warp][m][lane * kCols + j] = acc[m][j];
  __syncthreads();

  // fixed-order sum over the block's warps, one output element per thread
  for (int i = threadIdx.x; i < mt * kTileN; i += kThreads) {
    int m = i / kTileN, c = i % kTileN;
    int n = blockIdx.x * kTileN + c;
    if (n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) s += red[q][m][c];
    part[((int64_t)blockIdx.y * M + m0 + m) * N + n] = s;
  }
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

// Sum the K chunks' partials in chunk order, times the column scale
// (scale == nullptr for dense weights), then the epilogue.
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
void launch_partial(const void* x, const void* w, void* part, int M, int K,
                    int N, int ldw, int col0, int chunk, int k_chunks,
                    cudaStream_t st) {
  dim3 grid((N + kTileN - 1) / kTileN, k_chunks, (M + kMT - 1) / kMT);
  gemv_partial<T, W, kMT><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<float*>(part), M, K, N, ldw, col0, chunk);
}

template <typename T>
void launch_epilogue(const void* part, const float* scale, void* out, int M,
                     int N, int col0, int k_chunks, int epi,
                     cudaStream_t st) {
  int total = M * N;
  gemv_epilogue<T><<<(total + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), scale, out, M, N, col0, k_chunks, epi);
}

// B and B8: x in T, W in T or int8
template <typename T, typename W>
int launch(const void* x, const void* w, const float* scale, void* out,
           void* part, int M, int K, int N, int ldw, int col0, int chunk,
           int epi, cudaStream_t st) {
  int k_chunks = (K + chunk - 1) / chunk;
  // rows per block: the smallest of 1, 2, 4, 8 that covers M (up to 8),
  // so a batch of one does no work for absent rows
  if (M == 1)
    launch_partial<T, W, 1>(x, w, part, M, K, N, ldw, col0, chunk, k_chunks,
                            st);
  else if (M == 2)
    launch_partial<T, W, 2>(x, w, part, M, K, N, ldw, col0, chunk, k_chunks,
                            st);
  else if (M <= 4)
    launch_partial<T, W, 4>(x, w, part, M, K, N, ldw, col0, chunk, k_chunks,
                            st);
  else
    launch_partial<T, W, kMaxMT>(x, w, part, M, K, N, ldw, col0, chunk,
                                 k_chunks, st);
  launch_epilogue<T>(part, scale, out, M, N, col0, k_chunks, epi, st);
  return static_cast<int>(cudaGetLastError());
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

// B. dtype: 0 float32, 1 bfloat16 (x and W). part: f32 [ceil(K/chunk), M,
// N]. chunk: K rows per block, at most kMaxChunk (ops/gemv.py MAX_CHUNK).
int gemv_launch(const void* x, const void* w, void* out, void* part, int M,
                int K, int N, int ldw, int col0, int chunk, int dtype,
                int epi, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || M <= 0 || M > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(x, w, nullptr, out, part, M, K, N, ldw, col0,
                                chunk, epi, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, w, nullptr, out, part, M, K,
                                              N, ldw, col0, chunk, epi, st);
}

// B8: int8 q [K, ldw], f32 scale [ldw]; dtype of x as for B.
int gemv_int8_launch(const void* x, const void* q, const void* scale,
                     void* out, void* part, int M, int K, int N, int ldw,
                     int col0, int chunk, int dtype, int epi, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || M <= 0 || M > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0)
    return launch<float, int8_t>(x, q, sc, out, part, M, K, N, ldw, col0,
                                 chunk, epi, st);
  return launch<__nv_bfloat16, int8_t>(x, q, sc, out, part, M, K, N, ldw,
                                       col0, chunk, epi, st);
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
