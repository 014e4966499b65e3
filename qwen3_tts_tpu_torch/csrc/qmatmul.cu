// Kernel A: int8 weight-only matmul for prefill,
//   out[M, N] f32 = f32( bf16(x)[M, K] @ bf16(q)[K, N] ) * scale[N].
//
// Replaces: qwen3_tts_tpu/ops/quant.py::_pallas_qmatmul (kernel
//   _qmatmul_kernel): every int8 product of the talker prefill and the int8
//   head, through quant.linear -> quant.qmatmul (the JAX package's shape
//   dispatch: K and N multiples of 128).
//
// Bound: at M <= 64 (a short prompt at B=1) the weight bytes, K*N int8 read
//   once; above a few hundred rows the FLOPs (2*M*K*N). The TPU kernel pads
//   M to 16 and holds x whole in VMEM; here M is masked per tile and any M
//   works.
//
// Design: 64x64 output tiles, 4 warps, each warp a 64x16 slab computed with
//   mma.sync m16n8k16 (bf16 in, f32 accumulate) on Hopper's tensor cores.
//   Per 64-deep K step a block stages the x tile (bf16, 16-byte loads) and
//   the int8 weight tile in shared memory; the int8 values are converted to
//   bf16 (exact: |q| <= 127) in registers on the way, stored k-pair-major
//   so each B fragment register is one 32-bit shared load. The next K
//   step's global loads are issued into registers before the current step's
//   MMAs (one-deep software pipeline). Rows past M are zero in shared
//   memory and never stored. Where the output tiles alone are fewer than
//   two waves on 132 SMs, grid.z splits K into `splits` whole-tile ranges;
//   their f32 partials [splits, M, N] are summed in split order by a second
//   kernel, so the result does not depend on scheduling. The scale is
//   applied in the epilogue, after the f32 sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 64;
constexpr int kThreads = 128;               // 4 warps, one 64x16 slab each
constexpr int kPad = 8;                     // bf16 pad per shared row
constexpr int kLd = kBK + kPad;             // shared row stride (bf16)

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(int8_t lo, int8_t hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(static_cast<float>(lo),
                                           static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&p);
}

__global__ void __launch_bounds__(kThreads)
qmatmul_tile(const __nv_bfloat16* __restrict__ x,
             const int8_t* __restrict__ q, const float* __restrict__ scale,
             float* __restrict__ out, float* __restrict__ part, int M, int K,
             int N, int ldq, int splits) {
  // xs[m][k]: x tile, k contiguous; ws[n][k]: weight tile transposed, so
  // the (k, k+1) pair of one column is one 32-bit word
  __shared__ __align__(16) __nv_bfloat16 xs[kBM][kLd];
  __shared__ __align__(16) __nv_bfloat16 ws[kBN][kLd];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;       // mma fragment coordinates
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int k_tiles = K / kBK / splits;
  const int kt0 = blockIdx.z * k_tiles;

  // global -> register staging: x 4 x 16 B a thread (64 rows x 8 chunks),
  // q 2 x 16 B a thread (rows k and k+1 of a 16-column group)
  uint4 xr[4];
  uint4 wr[2];
  const int wpair = tid / 4, wcg = tid % 4;
  auto load = [&](int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int idx = tid + i * kThreads;
      int row = idx / 8, c8 = idx % 8;
      xr[i] = m0 + row < M
          ? *reinterpret_cast<const uint4*>(
                x + (int64_t)(m0 + row) * K + k0 + c8 * 8)
          : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wr[i] = *reinterpret_cast<const uint4*>(
          q + (int64_t)(k0 + 2 * wpair + i) * ldq + n0 + wcg * 16);
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int idx = tid + i * kThreads;
      int row = idx / 8, c8 = idx % 8;
      *reinterpret_cast<uint4*>(&xs[row][c8 * 8]) = xr[i];
    }
    const int8_t* k_lo = reinterpret_cast<const int8_t*>(&wr[0]);
    const int8_t* k_hi = reinterpret_cast<const int8_t*>(&wr[1]);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(&ws[wcg * 16 + j][2 * wpair]) =
          pack_bf16(k_lo[j], k_hi[j]);
  };

  float acc[4][2][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  load(kt0);
  for (int kt = kt0; kt < kt0 + k_tiles; ++kt) {
    __syncthreads();                // the previous step's MMAs are done
    store();
    __syncthreads();
    if (kt + 1 < kt0 + k_tiles) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4], b[2][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        int r = mi * 16 + g;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + 2 * t]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + 2 * t]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + 2 * t + 8]);
        a[mi][3] =
            *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        int n = warp * 16 + ni * 8 + g;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(&ws[n][kk + 2 * t]);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(&ws[n][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
  }

  // accumulator (mi, ni, r): row mi*16 + g (+8 for r >= 2), column
  // ni*8 + 2t + (r & 1) of the warp's slab
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int row = m0 + mi * 16 + g + (r >= 2 ? 8 : 0);
        int col = n0 + warp * 16 + ni * 8 + 2 * t + (r & 1);
        if (row >= M) continue;
        if (splits == 1)
          out[(int64_t)row * N + col] = acc[mi][ni][r] * scale[col];
        else
          part[((int64_t)blockIdx.z * M + row) * N + col] = acc[mi][ni][r];
      }
}

// out = (sum of the K splits' partials, in split order) * scale
__global__ void qmatmul_reduce(const float* __restrict__ part,
                               const float* __restrict__ scale,
                               float* __restrict__ out, int M, int N,
                               int splits) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t total = (int64_t)M * N;
  if (i >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * total + i];
  out[i] = s * scale[i % N];
}

}  // namespace

extern "C" {

// x bf16 [M, K] contiguous; q int8 [K, ldq] (16-byte aligned rows); scale
// f32 [N]; out f32 [M, N]; part f32 [splits, M, N] when splits > 1.
// K % 64 == 0 with (K / 64) % splits == 0, N % 64 == 0.
int qmatmul_launch(const void* x, const void* q, const void* scale, void* out,
                   void* part, int M, int K, int N, int ldq, int splits,
                   void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % kBK || N % kBN || ldq % 16 ||
      splits < 1 || (K / kBK) % splits)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(N / kBN, (M + kBM - 1) / kBM, splits);
  qmatmul_tile<<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(out),
      static_cast<float*>(part), M, K, N, ldq, splits);
  if (splits > 1) {
    int64_t total = (int64_t)M * N;
    qmatmul_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(part), static_cast<const float*>(scale),
        static_cast<float*>(out), M, N, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
