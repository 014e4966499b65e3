// Skinny matmul y[M, N] = x[M, K] @ W[K, N] for decode batches (M <= 32):
// kernel B (W in the model dtype), B8 (int8 W, per-column scale) and B4
// (packed biased int4 W with per-group multipliers m8 and a per-column
// scale), each optionally with a prologue on x (the rms norm, or silu*up)
// and, after the norm, the qk epilogue (QK-norm, RoPE, the q/k/v split and
// the predictor's KV store). This file holds B and the entry points' shared
// part; B8 is gemv_int8.cu, B4 gemv_int4.cu, the device code gemv.cuh (one
// nvcc each, in parallel: kernels/build.py).
//
// Replaces: the `stream_matmul` helpers inside the two TPU kernels,
//   qwen3_tts_tpu/ops/fused_talker.py::_kernel_body (stream_matmul) and
//   qwen3_tts_tpu/ops/fused_predictor.py::_kernel_body (stream_matmul):
//   every qkv / wo / gate-up / down / head product of the talker step and
//   the predictor frame, for dense, int8 and int4 weights; B4 computes the
//   int4 panel order of qwen3_tts_tpu/ops/quant.py::panel_matmul4. As
//   inside the TPU kernels, the elementwise work around a product runs in
//   the product's own launch:
//   * the norm prologue replaces `rms2` (qwen3_tts_tpu/ops/fused_talker.py
//     :121, qwen3_tts_tpu/ops/fused_predictor.py:130): ln1 -> qkv, ln2 ->
//     gate/up, the predictor's final norm -> its head slice;
//   * the qk epilogue of the qkv product replaces `rms3` + `rope`
//     (qwen3_tts_tpu/ops/fused_talker.py:126-134, 348-351;
//     qwen3_tts_tpu/ops/fused_predictor.py:137-151, 353-354) and the
//     predictor's store of k / v at slot `pos` of its frame cache (the
//     `kbuf` / `vbuf` store and `kv_write_dma`,
//     qwen3_tts_tpu/ops/fused_predictor.py:299-307, 359-379);
//   * the silu prologue of the down product replaces the SwiGLU
//     (qwen3_tts_tpu/ops/fused_talker.py:373-375,
//     qwen3_tts_tpu/ops/fused_predictor.py:409-413);
//   * the argmax epilogue of the predictor's head slice replaces
//     `argmax_row` and the ptab row gather
//     (qwen3_tts_tpu/ops/fused_predictor.py:465-469, 533-555): design in
//     gemv.cuh.
//
// Bound: weight bytes. At M <= 32 each weight element is used M times, far
//   below the ~295 FLOP/byte where Hopper's tensor cores become the limit,
//   so the product costs the time to read the K*N weights from HBM: 2 or 4
//   bytes each for B, 1 for B8, 1/2 (+ 1/128 for m8) for B4. B4's nibble
//   unpacking costs about as many instructions as its bytes take time, so
//   its inner loop is written for few instructions per nibble. The
//   prologues and the qk epilogue add no weight bytes: x's row (8-24 KB,
//   L2-resident) and a head's values, which each launch already holds.
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
//     (The argmax epilogue alone keeps a workspace of keys and tickets and
//     joins keys by atomicMax, which is order-free: gemv.cuh.)
//   int8 -> f32 is exact (|q| <= 127), so B8 is B's arithmetic with 1-byte
//   weights.
//
// Design (B4, `gemv4_cluster`), a sibling of B's kernel that shares its
//   tiles, x staging, prologues, epilogues and cluster reduction, but not its
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
// Prologues (template code kPro; each instantiation compiles only its own):
//   * norm: x is the f32 residual [M, K] and ln the norm weight [K] in the
//     model dtype T. Each block starts the weight loads of its first piece,
//     then reduces the sum of squares of its x rows over the whole K
//     (L2-resident: 8 KB a talker row; a fixed order: per thread, warp
//     butterflies, warps in order), and stages f32(T(x * rsqrt(sum / K +
//     eps) * ln)): f32 math, one rounding, the semantics of `rms2` and of
//     the standalone rms_norm kernel. Staging the piece in the same pass
//     over x (one read of the row instead of two) measured slower a frame
//     on the H100: faster for the talker's K = 2048, slower for the
//     predictor's 1024, which has five times the launches.
//   * silu: x is the gate/up product's f32 output [M, 2K] (g | u), and each
//     block stages, for its own K range only, f32(T(g / (1 + exp(-g)) * u))
//     (expf, IEEE division; one rounding, as silu_mul_plain). B4 stages its
//     low and high k's through it alike.
//
// The qk epilogue (code 4, runtime; compiled into the norm instantiations
//   only, as the qkv product always has ln1 as its prologue): the
//   cluster's finish is split over the ranks in whole (row, head) units, a
//   warp per unit (`qk_finish` in gemv.cuh), so a head's mean square is one
//   warp's shuffle reduction; at M = 1 and hd = 128 a tile is one head and
//   one rank finishes it, reading the 8 ranks' partials through
//   distributed shared memory as every finish does. Per head it rounds the
//   product to T, then for q and k heads applies the per-head rms norm
//   (rounded to T) and rotate-half RoPE with cos / sin rounded to T (f32
//   math, one rounding); v heads pass unchanged. q, k and v go to their own
//   [M, heads, hd] buffers in T (the fused qkv row is never stored) and,
//   with a KV store, k and v also as f32 into slot p of the predictor's
//   frame cache, through its strided [M, nk, hd] view. The store lands
//   before the pass's attention, which reads slots [valid_from, p) only and
//   takes the current token from k_new / v_new, so no launch of the pass
//   reads slot p. The talker's cache write stays after the step.
//
// W is row-major [K, ldw] (B4: [K/2, ldw], m8 [K/128, ldm]); `col0` selects
// columns [col0, col0 + N) (the predictor's per-codebook head slice) of W,
// m8 and scale alike, with no copy. x is in the model dtype T (float or
// bf16), f32 with a prologue; accumulation is f32.
//
// Epilogues: 0 store T, 1 store f32, 2 store f32 rounded through T
// (logits), 3 add into an f32 residual buffer, 4 qk (above), 5 argmax
// (epilogue 2's logits, the greedy code and the next pass's ptab row;
// after the norm prologue only, as the qk epilogue).

#include "gemv.cuh"

namespace {

template <typename T, typename W, int kPro, bool kAm>
int launch(const void* x, const void* w, const float* scale, const void* ln,
           float eps, void* out, int M, int K, int N, int ldw, int col0,
           int splits, int epi, const QkArgs& qk, const ArgmaxArgs& am,
           cudaStream_t st) {
  return by_rows<kMaxMT>(M, [&](auto mt) {
    return launch_cluster(
        gemv_cluster<T, W, decltype(mt)::value, kPro, kAm>, mt, M, N, splits,
        st,
        static_cast<const XT<T, kPro>*>(x), static_cast<const W*>(w), scale,
        static_cast<const T*>(ln), eps, out, M, K, N, ldw, col0, epi, qk,
        am);
  });
}

template <typename T>
int blocks_per_sm(int M, int pro) {
  return by_pro(pro, [&](auto p) {
    return by_rows<kMaxMT>(M, [](auto mt) {
      return occupancy(
          gemv_cluster<T, T, decltype(mt)::value, decltype(p)::value>);
    });
  });
}

}  // namespace

extern "C" {

// dtype (the model dtype T): 0 float32, 1 bfloat16. pro: 0 none (x in T),
// 1 the rms norm (x the f32 residual, ln the norm weight [K] in T), 2 silu
// (x the f32 gate/up [M, 2K]); ln null unless pro is 1. epi: 0-5; qk: a
// QkArgs for epi 4, else null; am: an ArgmaxArgs for epi 5, else null.
// splits: the K split, the cluster size, 1..kMaxSplits (ops/gemv.py
// gemv_splits, gemv4_splits).

// B: W in T.
int gemv_launch(const void* x, const void* w, const void* ln, void* out,
                int M, int K, int N, int ldw, int col0, int splits,
                int dtype, int epi, float eps, int pro, const void* qk,
                const void* am, void* stream) {
  if (bad_args(M, K, N, col0, splits, pro, ln, epi,
               static_cast<const QkArgs*>(qk),
               static_cast<const ArgmaxArgs*>(am)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const QkArgs q = qk_or_none(qk);
  const ArgmaxArgs a = am_or_none(am);
  return by_pro(pro, [&](auto p) {
    constexpr int kP = decltype(p)::value;
    return by_am<kP>(epi, [&](auto am_on) {
      constexpr bool kA = decltype(am_on)::value;
      if (dtype == 0)
        return launch<float, float, kP, kA>(x, w, nullptr, ln, eps, out, M,
                                            K, N, ldw, col0, splits, epi, q,
                                            a, st);
      using BF = __nv_bfloat16;
      return launch<BF, BF, kP, kA>(x, w, nullptr, ln, eps, out, M, K, N,
                                    ldw, col0, splits, epi, q, a, st);
    });
  });
}

// Resident blocks per SM of the kernel for (dtype, weight kind: 0 dense,
// 1 int8, 2 int4, M, prologue code), for the grid plan; a negative
// cudaError_t on failure.
int gemv_blocks_per_sm(int dtype, int wkind, int M, int pro) {
  if (pro < kProNone || pro > kProSilu)
    return -static_cast<int>(cudaErrorInvalidValue);
  if (wkind == 1) return gemv_int8_blocks_per_sm(dtype, M, pro);
  if (wkind == 2) return gemv_int4_blocks_per_sm(dtype, M, pro);
  return dtype == 0 ? blocks_per_sm<float>(M, pro)
                    : blocks_per_sm<__nv_bfloat16>(M, pro);
}

}  // extern "C"
