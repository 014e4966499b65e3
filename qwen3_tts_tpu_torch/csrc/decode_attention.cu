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
// Bound: at the main path's shapes, latency. Each (b, h) reads its live
//   slots' keys and values once (the talker: ~100 slots x 128 dims x 2
//   bytes x 2 per kv head, ~0.4 MB a layer-step in all, ~0.12 us at HBM
//   rate; the predictor: <= 15 slots), well below the cost of one launch,
//   and only B * nk (b, h) pairs exist (8 at B = 1).
//
// Design, one CUDA kernel per call:
//   * A cluster per (b, h) of `n_splits` blocks (ops/flash_decode.py
//     attention_splits: from B, nk and the cache capacity, never from the
//     data, so the launch needs no host sync and is CUDA-graph-safe). Each
//     block reads kv_len[b] and valid_from[b] itself and takes an even share
//     of the LIVE range [valid_from, min(kv_len, T)): a 4096-slot cache
//     costs what a 256-slot window costs, and no block walks empty slots.
//   * In a block, a group of hd / 8 lanes scores one key: each lane holds 8
//     head dimensions of every q row of the group (g <= 4) in registers,
//     reads 8 dims of the key and of the value with 16-byte loads (two for
//     f32), converts in registers, and the group sums its lanes' dots with
//     shuffles; every q row is scored from one read of each key. Groups
//     take slots round robin, 4 slots a lane in flight, each with its own
//     online softmax (m, l, acc) in f32.
//   * The block merges its groups in shared memory; then, after a cluster
//     barrier, rank r merges a slice of (q row, dim) over the cluster's
//     blocks through distributed shared memory, folds in the current token
//     last and divides by max(l, 1e-30). Each merge takes two passes: the
//     states' max m*, then sum_i l_i exp(m_i - m*) (and acc alike) in group
//     or rank order, so the exponentials do not wait on each other. Empty
//     ranges carry m = -1e30, l = 0, acc = 0, so kv_len = 0 and a fully
//     masked prefix give the current token's value. Every sum has a fixed
//     order: results do not depend on scheduling.
// q / k_new / v_new bf16 or f32 and the cache bf16 or f32, in any mix; hd a
// power of two from 8 to 128, g <= 4.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;              // head dims per lane
constexpr int kMaxHd = 128;
constexpr int kMaxG = 4;
constexpr int kMaxSplits = 8;        // portable cluster size
constexpr int kAhead = 4;            // slots per group in flight
// groups of a block: 1024 / hd; their (acc, m, l) per q row: at most
// (1024 / hd) * kMaxG * (hd + 2) floats, largest at hd = 8
constexpr int kGroupFloats = (kThreads * kVec / 8) * kMaxG * (8 + 2);
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 8 consecutive values as raw bytes (loaded ahead, converted later)
template <typename T> struct Raw;
template <> struct Raw<float> { float4 a, b; };
template <> struct Raw<__nv_bfloat16> { uint4 a; };

__device__ __forceinline__ Raw<float> ld_raw(const float* p) {
  return {__ldg(reinterpret_cast<const float4*>(p)),
          __ldg(reinterpret_cast<const float4*>(p + 4))};
}
__device__ __forceinline__ Raw<__nv_bfloat16> ld_raw(const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const uint4*>(p))};
}
__device__ __forceinline__ void cvt8(const Raw<float>& r, float* f) {
  f[0] = r.a.x; f[1] = r.a.y; f[2] = r.a.z; f[3] = r.a.w;
  f[4] = r.b.x; f[5] = r.b.y; f[6] = r.b.z; f[7] = r.b.w;
}
__device__ __forceinline__ void cvt8(const Raw<__nv_bfloat16>& r, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}


template <typename TQ, typename TC>
__global__ void __launch_bounds__(kThreads)
attention_cluster(const TQ* __restrict__ q,        // [B, nq, hd]
                  const TC* __restrict__ kc,       // [L, B, nk, T, hd]
                  const TC* __restrict__ vc,
                  const TQ* __restrict__ k_new,    // [B, nk, hd]
                  const TQ* __restrict__ v_new,
                  const int* __restrict__ kv_len,      // [B]
                  const int* __restrict__ valid_from,  // [B]
                  TQ* __restrict__ out,            // [B, nq, hd]
                  int layer, int B, int nq, int nk, int T, int hd) {
  __shared__ float grp[kGroupFloats];         // [group][row][hd + 2]
  __shared__ float blk[kMaxG * (kMaxHd + 2)];  // [row][hd + 2]: acc, m, l
  __shared__ float s_new[kMaxG];

  cg::cluster_group cluster = cg::this_cluster();
  const int n_splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / n_splits;
  const int b = bh / nk, h = bh % nk;
  // the row's live range first: the K / V loads wait on it
  const int len = min(kv_len[b], T);
  const int lo = max(valid_from[b], 0);
  const int g = nq / nk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lk = hd / kVec;                   // lanes per key, 1..16
  const int n_groups = kThreads / lk;
  const int group = tid / lk, sub = tid % lk;
  // the group's lanes, for its shuffles (groups run apart)
  const unsigned gmask = (lk == 32 ? 0xffffffffu : ((1u << lk) - 1u))
                         << ((lane / lk) * lk);
  const int stride = hd + 2;
  const int64_t q_off = ((int64_t)b * nq + (int64_t)h * g) * hd;
  const int64_t n_off = ((int64_t)b * nk + h) * hd;

  // q is scaled by 1 / sqrt(hd) before its dots, as the reference scales it
  const float sqrt_hd = sqrtf(static_cast<float>(hd));
  // the current token's score per q row, for the final merge
  if (warp < g) {
    float s = 0.f;
#pragma unroll 4
    for (int d = lane; d < hd; d += 32)
      s += to_f32(q[q_off + (int64_t)warp * hd + d]) / sqrt_hd *
           to_f32(k_new[n_off + d]);
    s = warp_sum(s);
    if (lane == 0) s_new[warp] = s;
  }

  // this lane's 8 dims of every q row
  float qv[kMaxG][kVec];
#pragma unroll
  for (int r = 0; r < kMaxG; ++r) {
    if (r < g) {
      float f[kVec];
      const TQ* p = q + q_off + (int64_t)r * hd + sub * kVec;
#pragma unroll
      for (int j = 0; j < kVec; ++j) f[j] = to_f32(p[j]) / sqrt_hd;
#pragma unroll
      for (int j = 0; j < kVec; ++j) qv[r][j] = f[j];
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) qv[r][j] = 0.f;
    }
  }

  // this block's share of the live range
  const int live = max(len - lo, 0);
  const int per = (live + n_splits - 1) / n_splits;
  const int s0 = lo + rank * per;
  const int s1 = min(s0 + per, len);

  float m[kMaxG], l[kMaxG], acc[kMaxG][kVec];
#pragma unroll
  for (int r = 0; r < kMaxG; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[r][j] = 0.f;
  }

  const int64_t c_off =
      (((int64_t)layer * B + b) * nk + h) * T * hd + sub * kVec;
  for (int j0 = s0 + group; j0 < s1; j0 += n_groups * kAhead) {
    Raw<TC> kr[kAhead], vr[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int j = j0 + u * n_groups;
      if (j < s1) {
        kr[u] = ld_raw(kc + c_off + (int64_t)j * hd);
        vr[u] = ld_raw(vc + c_off + (int64_t)j * hd);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (j0 + u * n_groups < s1) {          // uniform over the group
        float kf[kVec], vf[kVec];
        cvt8(kr[u], kf);
        cvt8(vr[u], vf);
#pragma unroll
        for (int r = 0; r < kMaxG; ++r) {
          if (r < g) {
            float s = 0.f;
#pragma unroll
            for (int d = 0; d < kVec; ++d) s = fmaf(qv[r][d], kf[d], s);
            for (int o = lk / 2; o > 0; o >>= 1)
              s += __shfl_xor_sync(gmask, s, o);
            const float mn = fmaxf(m[r], s);
            const float a = expf(m[r] - mn), p = expf(s - mn);
            l[r] = l[r] * a + p;
#pragma unroll
            for (int d = 0; d < kVec; ++d)
              acc[r][d] = fmaf(p, vf[d], acc[r][d] * a);
            m[r] = mn;
          }
        }
      }
    }
  }

  // the block's groups, merged in group order
#pragma unroll
  for (int r = 0; r < kMaxG; ++r) {
    if (r < g) {
      float* gp = grp + (group * g + r) * stride;
#pragma unroll
      for (int d = 0; d < kVec; ++d) gp[sub * kVec + d] = acc[r][d];
      if (sub == 0) {
        gp[hd] = m[r];
        gp[hd + 1] = l[r];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < g * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    // two passes: the groups' max, then their (l, acc) rescaled to it and
    // summed in group order (the rescalings do not wait on each other)
    float mm = kNeg;
    for (int q2 = 0; q2 < n_groups; ++q2)
      mm = fmaxf(mm, grp[(q2 * g + r) * stride + hd]);
    float ll = 0.f, aa = 0.f;
    for (int q2 = 0; q2 < n_groups; ++q2) {
      const float* gp = grp + (q2 * g + r) * stride;
      const float c = expf(gp[hd] - mm);
      ll = fmaf(gp[hd + 1], c, ll);
      aa = fmaf(gp[d], c, aa);
    }
    blk[r * stride + d] = aa;
    if (d == 0) {
      blk[r * stride + hd] = mm;
      blk[r * stride + hd + 1] = ll;
    }
  }

  // the cluster's blocks in rank order, then the current token, last
  cluster.sync();
  const int total = g * hd;
  const int share = (total + n_splits - 1) / n_splits;
  const int i1 = min(total, (rank + 1) * share);
  for (int i = rank * share + tid; i < i1; i += kThreads) {
    const int r = i / hd, d = i % hd;
    // all ranks' (m, l, acc) in flight at once, then merged in rank order
    float ms[kMaxSplits], ls[kMaxSplits], as[kMaxSplits];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      if (sp < n_splits) {
        const float* bp = cluster.map_shared_rank(blk, sp) + r * stride;
        ms[sp] = bp[hd];
        ls[sp] = bp[hd + 1];
        as[sp] = bp[d];
      }
    }
    float mm = kNeg, ll = 0.f, aa = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < n_splits) mm = fmaxf(mm, ms[sp]);
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      if (sp < n_splits) {
        const float c = expf(ms[sp] - mm);
        ll = fmaf(ls[sp], c, ll);
        aa = fmaf(as[sp], c, aa);
      }
    }
    const float m_fin = fmaxf(mm, s_new[r]);
    const float a = expf(mm - m_fin);
    const float p_new = expf(s_new[r] - m_fin);
    const float l_fin = fmaxf(ll * a + p_new, 1e-30f);
    store(&out[q_off + (int64_t)r * hd + d],
          (aa * a + p_new * to_f32(v_new[n_off + d])) / l_fin);
  }
  cluster.sync();                 // no block leaves while its blk is read
}

template <typename TQ, typename TC>
int launch(const void* q, const void* kc, const void* vc, const void* kn,
           const void* vn, const void* kv_len, const void* vfrom, void* out,
           int layer, int B, int nq, int nk, int T, int hd, int n_splits,
           cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * nk * n_splits, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  // one split needs no cluster (a block is its own cluster of one); a
  // cluster launch costs 0.3-0.9 us more on the H100 (chip_smoke.py
  // split_times)
  cfg.numAttrs = n_splits > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, attention_cluster<TQ, TC>, static_cast<const TQ*>(q),
      static_cast<const TC*>(kc), static_cast<const TC*>(vc),
      static_cast<const TQ*>(kn), static_cast<const TQ*>(vn),
      static_cast<const int*>(kv_len), static_cast<const int*>(vfrom),
      static_cast<TQ*>(out), layer, B, nq, nk, T, hd);
  return e != cudaSuccess ? static_cast<int>(e)
                          : static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q_dtype / c_dtype: 0 float32, 1 bfloat16. n_splits: blocks per (b, h),
// the cluster size, 1..kMaxSplits. hd a power of two in [8, 128].
int decode_attention_launch(const void* q, const void* kc, const void* vc,
                            const void* k_new, const void* v_new,
                            const void* kv_len, const void* valid_from,
                            void* out, int layer, int B, int nq, int nk,
                            int T, int hd, int n_splits, int q_dtype,
                            int c_dtype, void* stream) {
  if (hd < kVec || hd > kMaxHd || (hd & (hd - 1)) != 0 || nk <= 0 ||
      nq % nk != 0 || nq / nk > kMaxG || n_splits <= 0 ||
      n_splits > kMaxSplits || B <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && c_dtype == 0)
    return launch<float, float>(q, kc, vc, k_new, v_new, kv_len, valid_from,
                                out, layer, B, nq, nk, T, hd, n_splits, st);
  if (q_dtype == 0)
    return launch<float, __nv_bfloat16>(q, kc, vc, k_new, v_new, kv_len,
                                        valid_from, out, layer, B, nq, nk, T,
                                        hd, n_splits, st);
  if (c_dtype == 0)
    return launch<__nv_bfloat16, float>(q, kc, vc, k_new, v_new, kv_len,
                                        valid_from, out, layer, B, nq, nk, T,
                                        hd, n_splits, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(
      q, kc, vc, k_new, v_new, kv_len, valid_from, out, layer, B, nq, nk, T,
      hd, n_splits, st);
}

}  // extern "C"
