// Single-token GQA decode attention over a stacked, pre-update KV cache.
//
// Replaces: qwen3_tts_tpu/ops/flash_decode.py::decode_attention_stacked
//   (Pallas kernel `_kernel`), and the attention inside
//   qwen3_tts_tpu/ops/fused_talker.py::_kernel_body and
//   qwen3_tts_tpu/ops/fused_predictor.py::_kernel_body.
//
// Computes, for batch row b and q head r of kv head h (r in the group of
// g = nq / nk heads):
//   out[b, r] = softmax_j(q . k_j / sqrt(hd)) v_j over the cache slots
//               valid_from[b] <= j < kv_len[b] of layer `layer`, PLUS the
//               current token's own k_new/v_new, folded in last.
// The cache is read before this step's write (the caller writes k_new/v_new
// into the cache afterwards), so the current token never comes from it.
//
// Bound: cache bytes. Each (b, h) reads kv_len * hd keys and values once;
//   the arithmetic per byte is a few FLOPs. At decode batch sizes there are
//   only B * nk (b, h) pairs (8 on the talker at B = 1), far fewer than the
//   132 SMs, so one block per pair would leave the card idle.
//
// Design (split-K "flash decoding"): the cache prefix is split into
//   `n_splits` ranges of whole tiles, one block per (b, h, range), so the
//   grid fills the card. A block walks its range in shared-memory tiles of
//   kTile slots (converted to f32 on load) and keeps an f32 online softmax:
//   warp r scores slot `lane` of the tile for q row r (rows of the group
//   ride along, so each tile is read once for all of them), takes the
//   tile's max and sum with warp shuffles, and every thread accumulates one
//   head dimension of p @ V. Masking is explicit: a masked slot contributes
//   p = 0 even in a fully masked tile, so kv_len = 0 works; tiles before
//   valid_from are skipped. Each block writes (m, l, acc) of its range to an
//   f32 workspace; a second kernel merges the ranges in order, then folds in
//   the current token and divides by max(l, 1e-30). The cache may be bf16 or
//   f32 and q / k_new / v_new bf16 or f32, at any T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // cache slots per tile: one per lane
constexpr int kMaxHd = kThreads;     // one head dimension per thread
constexpr int kMaxG = kWarps;        // one warp per q row of the group
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// q rows of group (b, h), scaled by 1 / sqrt(hd) as the reference does
template <typename TQ>
__device__ __forceinline__ void load_q(float (*qs)[kMaxHd], const TQ* q,
                                       int64_t q_off, int g, int hd) {
  const float sqrt_hd = sqrtf(static_cast<float>(hd));
  for (int i = threadIdx.x; i < g * hd; i += kThreads)
    qs[i / hd][i % hd] = to_f32(q[q_off + i]) / sqrt_hd;
}

template <typename TQ, typename TC>
__global__ void __launch_bounds__(kThreads)
attention_split(const TQ* __restrict__ q,        // [B, nq, hd]
                const TC* __restrict__ kc,       // [L, B, nk, T, hd]
                const TC* __restrict__ vc,
                const int* __restrict__ kv_len,      // [B]
                const int* __restrict__ valid_from,  // [B]
                float* __restrict__ part,  // [B*nk, n_splits, g, hd + 2]
                int layer, int B, int nq, int nk, int T, int hd,
                int tiles_per_split) {
  __shared__ float ks[kTile][kMaxHd + 1];   // +1: conflict-free row reads
  __shared__ float vs[kTile][kMaxHd];
  __shared__ float qs[kMaxG][kMaxHd];
  __shared__ float ps[kMaxG][kTile];
  __shared__ float alpha_s[kMaxG];

  const int bh = blockIdx.x, split = blockIdx.y, n_splits = gridDim.y;
  const int b = bh / nk, h = bh % nk;
  const int g = nq / nk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  load_q(qs, q, ((int64_t)b * nq + (int64_t)h * g) * hd, g, hd);
  const int len = kv_len[b];
  const int vfrom = valid_from[b];
  const int64_t c_off = (((int64_t)layer * B + b) * nk + h) * T * hd;
  const int t_lo = max(split * tiles_per_split * kTile,
                       (vfrom / kTile) * kTile);
  const int t_hi = min((split + 1) * tiles_per_split * kTile, min(len, T));

  float m = kNeg, l = 0.f;       // warp `warp`'s q row; lane-uniform
  float acc[kMaxG];
#pragma unroll
  for (int r = 0; r < kMaxG; ++r) acc[r] = 0.f;
  __syncthreads();

  for (int t0 = t_lo; t0 < t_hi; t0 += kTile) {
    for (int i = tid; i < kTile * hd; i += kThreads) {
      const int t = i / hd, d = i % hd;
      const bool in = t0 + t < T;
      const int64_t at = c_off + (int64_t)(t0 + t) * hd + d;
      ks[t][d] = in ? to_f32(kc[at]) : 0.f;
      vs[t][d] = in ? to_f32(vc[at]) : 0.f;
    }
    __syncthreads();

    if (warp < g) {
      const int pos = t0 + lane;
      const bool ok = pos < t_hi && pos >= vfrom;   // t_hi <= min(len, T)
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += qs[warp][d] * ks[lane][d];
      s = ok ? s : kNeg;
      const float m_new = fmaxf(m, warp_max(s));
      const float alpha = expf(m - m_new);
      const float p = ok ? expf(s - m_new) : 0.f;
      l = l * alpha + warp_sum(p);
      m = m_new;
      ps[warp][lane] = p;
      if (lane == 0) alpha_s[warp] = alpha;
    }
    __syncthreads();

    if (tid < hd) {
#pragma unroll
      for (int r = 0; r < kMaxG; ++r) {
        if (r < g) {
          float pv = 0.f;
#pragma unroll 8
          for (int t = 0; t < kTile; ++t) pv += ps[r][t] * vs[t][tid];
          acc[r] = acc[r] * alpha_s[r] + pv;
        }
      }
    }
    __syncthreads();
  }

  const int stride = hd + 2;
  float* base = part + ((int64_t)bh * n_splits + split) * g * stride;
  if (warp < g && lane == 0) {
    base[warp * stride + hd] = m;
    base[warp * stride + hd + 1] = l;
  }
  if (tid < hd) {
#pragma unroll
    for (int r = 0; r < kMaxG; ++r)
      if (r < g) base[r * stride + tid] = acc[r];
  }
}

template <typename TQ>
__global__ void __launch_bounds__(kThreads)
attention_merge(const TQ* __restrict__ q, const TQ* __restrict__ k_new,
                const TQ* __restrict__ v_new,
                const float* __restrict__ part, TQ* __restrict__ out,
                int nq, int nk, int hd, int n_splits) {
  __shared__ float qs[kMaxG][kMaxHd];
  __shared__ float s_new[kMaxG];

  const int bh = blockIdx.x;
  const int b = bh / nk, h = bh % nk;
  const int g = nq / nk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t q_off = ((int64_t)b * nq + (int64_t)h * g) * hd;
  const int64_t n_off = ((int64_t)b * nk + h) * hd;
  load_q(qs, q, q_off, g, hd);
  __syncthreads();
  if (warp < g) {
    float s = 0.f;
    for (int d = lane; d < hd; d += 32)
      s += qs[warp][d] * to_f32(k_new[n_off + d]);
    s = warp_sum(s);
    if (lane == 0) s_new[warp] = s;
  }
  __syncthreads();
  if (tid >= hd) return;

  const int stride = hd + 2;
  const float* base = part + (int64_t)bh * n_splits * g * stride;
  const float vn = to_f32(v_new[n_off + tid]);
  for (int r = 0; r < g; ++r) {
    float m = kNeg, l = 0.f, acc = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) {       // ranges in order
      const float* pr = base + ((int64_t)sp * g + r) * stride;
      const float ms = pr[hd], ls = pr[hd + 1];
      const float m_new = fmaxf(m, ms);
      const float a = expf(m - m_new), c = expf(ms - m_new);
      l = l * a + ls * c;
      acc = acc * a + pr[tid] * c;
      m = m_new;
    }
    // the current token, always valid (causal self-attention), last
    const float m_fin = fmaxf(m, s_new[r]);
    const float a = expf(m - m_fin);
    const float p_new = expf(s_new[r] - m_fin);
    const float l_fin = fmaxf(l * a + p_new, 1e-30f);
    store(&out[q_off + (int64_t)r * hd + tid], (acc * a + p_new * vn) / l_fin);
  }
}

template <typename TQ, typename TC>
int launch(const void* q, const void* kc, const void* vc, const void* kn,
           const void* vn, const void* kv_len, const void* vfrom, void* out,
           void* part, int layer, int B, int nq, int nk, int T, int hd,
           int n_splits, int tiles_per_split, cudaStream_t st) {
  attention_split<TQ, TC><<<dim3(B * nk, n_splits), kThreads, 0, st>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(kc),
      static_cast<const TC*>(vc), static_cast<const int*>(kv_len),
      static_cast<const int*>(vfrom), static_cast<float*>(part), layer, B,
      nq, nk, T, hd, tiles_per_split);
  attention_merge<TQ><<<B * nk, kThreads, 0, st>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(kn),
      static_cast<const TQ*>(vn), static_cast<const float*>(part),
      static_cast<TQ*>(out), nq, nk, hd, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q_dtype / c_dtype: 0 float32, 1 bfloat16. part: f32 workspace of
// B * nk * n_splits * (nq / nk) * (hd + 2) values. The splits must cover
// the cache: n_splits * tiles_per_split * 32 >= T.
int decode_attention_launch(const void* q, const void* kc, const void* vc,
                            const void* k_new, const void* v_new,
                            const void* kv_len, const void* valid_from,
                            void* out, void* part, int layer, int B, int nq,
                            int nk, int T, int hd, int n_splits,
                            int tiles_per_split, int q_dtype, int c_dtype,
                            void* stream) {
  if (hd > kMaxHd || nk <= 0 || nq % nk != 0 || nq / nk > kMaxG ||
      n_splits <= 0 || tiles_per_split <= 0 ||
      (int64_t)n_splits * tiles_per_split * kTile < T)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && c_dtype == 0)
    return launch<float, float>(q, kc, vc, k_new, v_new, kv_len, valid_from,
                                out, part, layer, B, nq, nk, T, hd, n_splits,
                                tiles_per_split, st);
  if (q_dtype == 0)
    return launch<float, __nv_bfloat16>(q, kc, vc, k_new, v_new, kv_len,
                                        valid_from, out, part, layer, B, nq,
                                        nk, T, hd, n_splits, tiles_per_split,
                                        st);
  if (c_dtype == 0)
    return launch<__nv_bfloat16, float>(q, kc, vc, k_new, v_new, kv_len,
                                        valid_from, out, part, layer, B, nq,
                                        nk, T, hd, n_splits, tiles_per_split,
                                        st);
  return launch<__nv_bfloat16, __nv_bfloat16>(
      q, kc, vc, k_new, v_new, kv_len, valid_from, out, part, layer, B, nq,
      nk, T, hd, n_splits, tiles_per_split, st);
}

}  // extern "C"
