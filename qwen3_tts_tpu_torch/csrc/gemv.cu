// Skinny matmul y[M, N] = x[M, K] @ W[K, N] for decode batches (M <= 32).
//
// Replaces: the `stream_matmul` helpers inside the two TPU kernels,
//   qwen3_tts_tpu/ops/fused_talker.py::_kernel_body (stream_matmul) and
//   qwen3_tts_tpu/ops/fused_predictor.py::_kernel_body (stream_matmul):
//   every qkv / wo / gate-up / down / head product of the talker step and
//   the predictor frame.
//
// Bound: weight bytes. At M <= 32 each weight element is used M times, far
//   below the ~295 FLOP/byte where Hopper's tensor cores become the limit,
//   so the product costs the time to read K*N weight values from HBM.
//
// Design: every weight byte is read once per row chunk, with 16-byte loads
//   that neighbouring threads issue on neighbouring addresses. Each thread
//   owns 8 output columns; a warp covers 256 contiguous columns of one
//   weight row. A block (4 warps) covers a 256-column tile and a K chunk;
//   its warps take interleaved rows of the chunk and are summed in shared
//   memory in a fixed order. The grid's K split gives enough blocks to keep
//   132 SMs streaming; partial sums go to an f32 workspace
//   [k_chunks, M, N] and a second small kernel adds them in chunk order and
//   applies the epilogue, so results do not depend on scheduling. x rows
//   (MT = 1, 2, 4 or 8 per block by M; grid.z walks row chunks) are staged in
//   shared memory as f32 and broadcast to all lanes.
//
// W is row-major [K, ldw]; `col0` selects columns [col0, col0 + N) (the
// predictor's per-codebook head slice) with no copy. x and W share the
// model dtype T (float or bf16); accumulation is f32.
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

template <typename T, int kMT>
__global__ void __launch_bounds__(kThreads)
gemv_partial(const T* __restrict__ x, const T* __restrict__ w,
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
    const T* wp = w + (int64_t)k0 * ldw + col0 + col;
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

template <typename T>
__global__ void gemv_epilogue(const float* __restrict__ part, void* out,
                              int M, int N, int k_chunks, int epi) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  float s = 0.f;
  for (int c = 0; c < k_chunks; ++c) s += part[(int64_t)c * M * N + i];
  switch (epi) {
    case 0: store_t(reinterpret_cast<T*>(out) + i, s); break;
    case 1: reinterpret_cast<float*>(out)[i] = s; break;
    case 2: reinterpret_cast<float*>(out)[i] = round_t(s, (T*)nullptr); break;
    default: reinterpret_cast<float*>(out)[i] += s; break;
  }
}

template <typename T, int kMT>
void launch_partial(const void* x, const void* w, void* part, int M, int K,
                    int N, int ldw, int col0, int chunk, int k_chunks,
                    cudaStream_t st) {
  dim3 grid((N + kTileN - 1) / kTileN, k_chunks, (M + kMT - 1) / kMT);
  gemv_partial<T, kMT><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<float*>(part), M, K, N, ldw, col0, chunk);
}

template <typename T>
int launch(const void* x, const void* w, void* out, void* part, int M, int K,
           int N, int ldw, int col0, int chunk, int epi, cudaStream_t st) {
  int k_chunks = (K + chunk - 1) / chunk;
  // rows per block: the smallest of 1, 2, 4, 8 that covers M (up to 8),
  // so a batch of one does no work for absent rows
  if (M == 1)
    launch_partial<T, 1>(x, w, part, M, K, N, ldw, col0, chunk, k_chunks, st);
  else if (M == 2)
    launch_partial<T, 2>(x, w, part, M, K, N, ldw, col0, chunk, k_chunks, st);
  else if (M <= 4)
    launch_partial<T, 4>(x, w, part, M, K, N, ldw, col0, chunk, k_chunks, st);
  else
    launch_partial<T, kMaxMT>(x, w, part, M, K, N, ldw, col0, chunk, k_chunks,
                              st);
  int total = M * N;
  gemv_epilogue<T><<<(total + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), out, M, N, k_chunks, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (x and W). part: f32 [ceil(K/chunk), M, N].
// chunk: K rows per block, at most kMaxChunk (ops/gemv.py MAX_CHUNK).
int gemv_launch(const void* x, const void* w, void* out, void* part, int M,
                int K, int N, int ldw, int col0, int chunk, int dtype,
                int epi, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || M <= 0 || M > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, out, part, M, K, N, ldw, col0, chunk, epi, st);
  return launch<__nv_bfloat16>(x, w, out, part, M, K, N, ldw, col0, chunk,
                               epi, st);
}

}  // extern "C"
