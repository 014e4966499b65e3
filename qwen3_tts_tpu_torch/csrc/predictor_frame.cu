// The predictor's whole frame as one persistent CUDA kernel: 16 passes of
// the layer stack (the 2 prefill tokens, then 14 greedy codebook steps),
// the 15 head slices, their argmax and the ptab gather, in ONE cooperative
// launch a frame.
//
// Replaces: qwen3_tts_tpu/ops/fused_predictor.py::frame_codes_fused (the
//   Pallas kernel `_kernel_body`, one pallas_call a frame), which the port
//   had carried as a chain of ~670 launches a frame driven from Python
//   (ops/chain.py layer_pass: five launches a layer pass, a head slice and
//   an argmax_gather a codebook). It computes what the chain computes
//   (ops/fused_predictor.py frame_codes_fused_plain), at the same rounding
//   points: the f32 residual; each rms norm rounded once to the model dtype
//   T; the product in f32 (times the int8 column scale); QK-norm and
//   rotate-half RoPE on the T-rounded q / k heads (rounded once each, cos /
//   sin rounded to T); the frame-local f32 KV cache, slot p stored before
//   the pass's attention reads [0, p); silu(g) * u in f32, rounded once;
//   logits in f32 rounded through T; argmax with the lowest index on ties
//   (NaN above every number, as torch.argmax); the next pass's input row
//   ptab[q][sel(code)], sel clamping negative codes to 0 and sending codes
//   past the real rows to the bias row (qwen3_tts_tpu/ops/
//   fused_predictor.py:651-659).
//
// Bound: weight bytes. A pass reads the 8 layers' weights once (27.3 MB in
//   bf16 at the full predictor width), a head slice 4.2 MB: 3.55 GB a frame
//   dense bf16, 1.06 ms at 3.35 TB/s; half of it int8. At B <= 16 each
//   weight element is used B times, far below the tensor cores' balance
//   point. What the chain paid on top was a fixed cost per launch (host
//   launch, x staging, cluster reductions), ~670 times a frame.
//
// Design, simple first:
//   * One cooperative launch (cudaLaunchKernelEx with the cooperative
//     attribute): grid = SMs x resident blocks per SM at the kernel's
//     shared memory, so every block is resident at once. Dependent stages
//     meet at a grid barrier on a self-resetting generation counter
//     (arrivals reset by the last block, which then bumps the generation
//     with release semantics; waiters spin on an acquire load). It needs no
//     memset per launch, so the kernel replays in a CUDA graph. A wait
//     longer than kSpinLimitNs traps (an error, never a hang).
//   * Stages of a layer pass (each a grid barrier apart):
//       1. qkv: every block computes the ln1 norm of the whole residual
//          itself, its 8-column units of the qkv product over the whole K,
//          f32 out to scratch. Layer 0 of a pass reads its input row from
//          the source (h1024 at pass 0, else the ptab row of the last code)
//          and each block writes its share of the residual from it;
//       2. per (row, kv head): the k / v / q heads rounded to T, QK-norm and
//          RoPE, k and v stored at slot p of the frame cache, then
//          attention over slots [0, p) and the current token;
//       3. wo, added into the residual;
//       4. gate / up with the ln2 norm, f32 out;
//       5. down with silu(g) * u as its prologue, added into the residual.
//     After a pass p >= 1, the head stage: the final norm, the product over
//     slice p - 1, each block's logits reduced to a per-row (max, index)
//     partial. After the barrier every block reduces the partials (the
//     order does not matter: the comparison is a total order), block 0
//     writes codes[:, p], and each block gathers the ptab row itself in
//     the next pass's layer 0.
//   * Work plan: a stage's N columns are 8-column units, dealt over the
//     blocks in contiguous ranges [blk * U / nb, (blk + 1) * U / nb) (the
//     same formula as ops/fused_predictor.py split_units). Each output
//     column is computed by one block over the whole K in a fixed order:
//     no K split, no atomics, so repeats are bit-identical.
//   * The weights do not depend on the activations. They are read from a
//     packed copy (ops/fused_predictor.py pack_units: each 8-column unit's
//     rows contiguous), so a block's slice of a stage is one contiguous
//     range, which one thread copies into shared memory with a TMA bulk
//     copy completing on an mbarrier. A stage starts the copy of the NEXT
//     weight stage's slice into the other buffer as soon as its own inputs
//     are in flight, so the activations' loads do not queue behind the
//     weights (issued two stages ahead at the end of a stage, the frame
//     measured ~0.5 ms slower on the H100): HBM reads run under the rest
//     of the stage and the barrier waits. A
//     slice larger than a buffer stages its first rows; the rest are read
//     from global memory in the product's loop (f32 weights at full width
//     only).
//   * x rows (MT = 1, 2 or 4 a chunk; B > 4 loops over chunks) are staged
//     in shared memory in T after their prologue (every product's input is
//     a T-rounded value, so this is exact); a thread loads all its inputs
//     of a row at once (one round trip; the norm's sum of squares from the
//     same registers). The 256 threads of a block split K over a batch of
//     units (32 sums: 4 units at MT = 1), whose sums reduce through one
//     warp reduce-scatter (31 shuffles) and the warps in order.
//   * A trace, as talker_step.cu's (compiled in only with -DKERNEL_TRACE,
//     on when args.trace is set): block 0's thread 0 writes %globaltimer
//     at each grid barrier's arrival and release and sums the time to its
//     products' inputs and their rest, its norm loads and reductions, and
//     its waits for a stage's copies (tools/frame_measure.py trace).
// Scope: T = float or bf16; each of the five weights dense in T or int8
//   with an f32 per-column scale (mixed kinds too); 1 <= B <= 16; hd a
//   power of two in [8, 128]; nq / nk <= 4; H <= 2048; H, F, nq * hd, CV
//   multiples of 8. int4 weights and B > 16 keep the chain (ops/fused_predictor.py
//   frame_route).

#include "persistent.cuh"

namespace {

constexpr int kFThreads = 256;
constexpr int kFWarps = kFThreads / 32;
constexpr int kUnit = 8;              // columns of a unit (one 8-wide vector)
constexpr int kFMaxB = 16;
constexpr int kCodes = 16;            // protocol.NUM_CODEBOOKS
constexpr int kFMaxG = 4;             // q heads per kv head
constexpr int kFMaxHd = 128;
constexpr int kXPer = 8;              // norm inputs a thread holds: H <= 2048
constexpr int kYPer = 12;             // wo / down inputs a thread loads at once
enum { kQkv = 0, kWo = 1, kGu = 2, kDown = 3, kHead = 4 };
// trace words (tools/frame_measure.py trace): barrier i at 2 i, 2 i + 1;
// block 0's products kTrProd + 4 mat + 1..3 (to its inputs, the rest,
// calls), its norm inputs kTrNorm + 0..3 (loads, row reduction, -, calls;
// + 4 scratch), its waits for a stage's copies kTrWait + 0..1, the start
constexpr int kTrProd = 1900, kTrNorm = 1960, kTrWait = 1980, kTrT0 = 1999;

// ops/fused_predictor.py _FrameArgs, field for field.
struct FrameArgs {
  const void* w[5];       // qkv, wo, gu, down [L, K, N]; head [H, 16 * CV]
  const float* sc[5];     // int8 column scales [L, N] / [16 * CV]; null dense
  const void* ln1;        // [L, H] T
  const void* ln2;        // [L, H] T
  const void* q_norm;     // [L, hd] T
  const void* k_norm;     // [L, hd] T
  const void* final_norm; // [H] T
  const void* ptab;       // [16, R, H] T
  const float* h1024;     // [B, H]
  const int* code0;       // [B]
  int* codes;             // [B, 16] out
  float* xres;            // [B, H] the residual
  float* qkv;             // [B, (nq + 2 nk) hd]
  float* att;             // [B, nq hd] (T-rounded values)
  float* gu;              // [B, 2F]
  float* kc;              // [L, B, nk, 16, hd] the frame cache
  float* vc;
  const float* cos;       // [16, hd]
  const float* sin;
  float* part_v;          // [nb, B] the head's per-block partials
  int* part_i;
  unsigned* bar;          // [2 kGen]: arrivals at 0, generation at kGen
  int B, H, L, nq, nk, hd, F, CV, R, rows0;
  int buf;                // bytes of each weight buffer
  float eps;
  unsigned long long* trace;  // null, or block 0's timeline (kTr*)
};

// ---------------------------------------------------------------- argmax
// The argmax order: NaN above every number (the first NaN wins, as
// torch.argmax), then the larger value, then the lower index. A strict
// total order, so any reduction tree gives the same winner.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool n = isnan(v), bn = isnan(bv);
  if (n != bn) return n;
  if (!n && v != bv) return v > bv;
  return i < bi;
}

// ---------------------------------------------------------------- stages
// A weight stage in the packed layout (ops/fused_predictor.py pack_units:
// [units][K][8], unit u's rows contiguous): its rows K, columns N, the
// element offset of its first unit (the layer's, or the head slice's) and
// of its first column scale.
struct StageDims {
  int K, N;
  long long off, soff;
};

__device__ __forceinline__ StageDims dims(const FrameArgs& a, int mat,
                                          int layer, int slice) {
  const int nqkv = (a.nq + 2 * a.nk) * a.hd;
  StageDims d;
  switch (mat) {
    case kQkv: d.K = a.H; d.N = nqkv; break;
    case kWo: d.K = a.nq * a.hd; d.N = a.H; break;
    case kGu: d.K = a.H; d.N = 2 * a.F; break;
    case kDown: d.K = a.F; d.N = a.H; break;
    default: d.K = a.H; d.N = a.CV; break;
  }
  if (mat == kHead) {
    d.soff = static_cast<long long>(slice) * a.CV;
    d.off = d.soff * a.H;
  } else {
    d.soff = static_cast<long long>(layer) * d.N;
    d.off = d.soff * d.K;
  }
  return d;
}

// Weight stage s of the frame (the order the kernel runs them): pass 0 has
// 4 L stages (qkv, wo, gu, down a layer), every later pass 4 L + 1 (its
// head slice last).
__device__ __forceinline__ void stage_of(int s, int L, int& mat, int& layer,
                                         int& slice) {
  int r = s, p = 0;
  if (s >= 4 * L) {
    const int t = s - 4 * L;
    p = 1 + t / (4 * L + 1);
    r = t % (4 * L + 1);
  }
  if (r == 4 * L) {
    mat = kHead; layer = 0; slice = p - 1;
  } else {
    mat = r % 4; layer = r / 4; slice = 0;
  }
}

__device__ __forceinline__ int unit_lo(int units, int blk, int nb) {
  return static_cast<int>(static_cast<long long>(blk) * units / nb);
}

// rows of each unit of the block's slice that fit a buffer (the rest are
// read from global memory), even so that every copy is whole 16 bytes
__device__ __forceinline__ int staged_rows(int K, int nu, int vb, int buf) {
  return nu > 0 ? min(K, buf / (nu * vb)) & ~1 : 0;
}

// Thread 0 starts the bulk copies of weight stage s's block slice into
// `buf` ([unit][row][8], the first kpre rows of each unit: one copy of
// the whole slice, contiguous in the packed layout, or one a unit when
// only the first rows fit) and arms the buffer's barrier
// with their bytes (none past the last stage: the phase completes at
// once). The caller has synchronised the block since the buffer's last
// reads.
template <typename T>
__device__ void issue(const FrameArgs& a, int s, int n_stages,
                      unsigned char* buf, unsigned long long* bar) {
  if (threadIdx.x != 0) return;
  int nu = 0, kpre = 0, vb = 0, u0 = 0, mat = 0;
  StageDims d{};
  if (s < n_stages) {
    int layer, slice;
    stage_of(s, a.L, mat, layer, slice);
    d = dims(a, mat, layer, slice);
    const int U = d.N / kUnit;
    u0 = unit_lo(U, blockIdx.x, gridDim.x);
    nu = unit_lo(U, blockIdx.x + 1, gridDim.x) - u0;
    vb = kUnit * (a.sc[mat] != nullptr ? 1 : static_cast<int>(sizeof(T)));
    kpre = staged_rows(d.K, nu, vb, a.buf);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect(bar, static_cast<unsigned>(nu * kpre * vb));
  const char* g = static_cast<const char*>(a.w[mat]) +
                  (d.off + static_cast<long long>(u0) * d.K * kUnit) *
                      (vb / kUnit);
  if (kpre == d.K && nu > 0)          // the whole slice: one range
    bulk_copy(buf, g, static_cast<unsigned>(nu * kpre * vb), bar);
  else
    for (int u = 0; u < nu && kpre > 0; ++u)
      bulk_copy(buf + static_cast<long long>(u) * kpre * vb,
                g + static_cast<long long>(u) * d.K * vb,
                static_cast<unsigned>(kpre * vb), bar);
}

// Shared memory of a block: two weight buffers, then the fixed part
// (ops/fused_predictor.py frame_smem_fixed computes the same size).
template <typename T, int kMT>
struct Smem {
  unsigned char* buf[2];
  unsigned long long* bar;   // [2] the buffers' mbarriers
  T* xs;          // [kMT][Kmax] staged x rows
  float* red;     // [kFWarps][32] the warps' unit sums / row sums
  float* outv;    // [32] a batch's sums
  float* rinv;    // [kFMaxB]
  float* bestv;   // [kFMaxB] the block's argmax
  int* besti;     // [kFMaxB]
  int* code;      // [kFMaxB] the codes of the pass's input rows
  float* hb;      // [2 + kFMaxG][hd] k, v, q heads of stage 2
  float* sc;      // [kCodes] attention scores
};

__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }

__host__ __device__ inline int kmax_of(int H, int nq, int hd, int F) {
  const int a = H > nq * hd ? H : nq * hd;
  return a > F ? a : F;
}

__host__ __device__ inline int fixed_smem(int mt, int kmax, int hd,
                                          int tsize) {
  return 16 + align16(mt * kmax * tsize) +
         (kFWarps * 32 + 32 + 4 * kFMaxB + (2 + kFMaxG) * hd +
          kCodes) * 4;
}

template <typename T, int kMT>
__device__ Smem<T, kMT> carve(unsigned char* base, const FrameArgs& a) {
  Smem<T, kMT> s;
  s.buf[0] = base;
  s.buf[1] = base + a.buf;
  unsigned char* p = base + 2 * a.buf;
  s.bar = reinterpret_cast<unsigned long long*>(p);
  p += 16;
  s.xs = reinterpret_cast<T*>(p);
  p += align16(kMT * kmax_of(a.H, a.nq, a.hd, a.F) * sizeof(T));
  s.red = reinterpret_cast<float*>(p);
  s.outv = s.red + kFWarps * 32;
  s.rinv = s.outv + 32;
  s.bestv = s.rinv + kFMaxB;
  s.besti = reinterpret_cast<int*>(s.bestv + kFMaxB);
  s.code = s.besti + kFMaxB;
  s.hb = reinterpret_cast<float*>(s.code + kFMaxB);
  s.sc = s.hb + (2 + kFMaxG) * a.hd;
  return s;
}

// Units a batch: kUB units of kMT rows of 8 columns are 32 sums, one a lane
// after the warp's reduce-scatter.
template <int kMT>
struct UnitsABatch {
  static constexpr int value = 32 / (kMT * kVec);
};

// The sums of a batch of nub <= kUB units for the staged rows: threads
// over k (each unit's smem rows first, then its rows past the buffer from
// global memory), then the warp's 32 sums reduced and scattered at once (at
// each butterfly step a lane keeps one half of its values and adds its
// partner's copy of that half: 31 shuffles, lane l ends with sum l), then
// the warps in order, into sm.outv[(ub * kMT + m) * 8 + j]. Ends
// synchronised.
template <typename T, typename W, int kMT>
__device__ void batch_sums(const Smem<T, kMT>& sm, const W* wsm,
                           const W* wg, int K, int kpre, int nub) {
  constexpr int kUB = UnitsABatch<kMT>::value;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) v[i] = 0.f;
  for (int k = threadIdx.x; k < K; k += kFThreads) {
    float xv[kMT];
#pragma unroll
    for (int m = 0; m < kMT; ++m) xv[m] = to_f32(sm.xs[m * K + k]);
#pragma unroll
    for (int ub = 0; ub < kUB; ++ub)
      if (ub < nub) {
        const Raw<W> r =
            k < kpre ? ld_sm(wsm + (static_cast<long long>(ub) * kpre + k) *
                                       kUnit)
                     : ld_raw(wg + (static_cast<long long>(ub) * K + k) *
                                       kUnit);
        float wv[kVec];
        cvt8(r, wv);
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            float& acc = v[(ub * kMT + m) * kVec + j];
            acc = fmaf(xv[m], wv[j], acc);
          }
      }
  }
#pragma unroll
  for (int o = 16, n = 32; o > 0; o /= 2) {
    const bool up = (lane & o) != 0;
    n /= 2;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < n) {
        const float send = up ? v[i] : v[i + n];
        const float keep = up ? v[i + n] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
  }
  sm.red[warp * 32 + lane] = v[0];
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kFWarps; ++w) t += sm.red[w * 32 + threadIdx.x];
    sm.outv[threadIdx.x] = t;
  }
  __syncthreads();
}

// The stage's input value of row b, column k, before its rounding to T:
// the residual (or the pass's source row) normed, the attention output, or
// silu(g) * u of the gate / up product.
template <typename T>
struct Src {
  const float* h1024;      // pass 0's source rows, else null
  const T* prow[kFMaxB];   // ptab rows of the pass's codes (layer 0, p >= 1)
  bool source;             // layer 0: read the source, not the residual
};

template <typename T>
__device__ __forceinline__ float resid(const FrameArgs& a, const Src<T>& src,
                                       int b, int k) {
  if (!src.source) return a.xres[b * a.H + k];
  if (src.h1024 != nullptr)
    return round_t(src.h1024[b * a.H + k], (T*)nullptr);
  return to_f32(src.prow[b][k]);
}

// The norm stages' inputs of a chunk of mt rows into xs: every thread
// loads its columns k = t + 256 q of the rows (the residual, or the
// pass's source) and of the norm weight at once, into registers (one
// round trip; H <= 256 kXPer), sums the squares in order, the rows' sums
// reduce through the warp's butterfly and the warps in order, and each
// value is normed and rounded once: T(x * rsqrt(mean(x^2) + eps) * w).
template <typename T, int kMT, typename Hook>
__device__ void stage_norm(const FrameArgs& a, const Smem<T, kMT>& sm,
                           const Src<T>& src, const T* ln, int c0, int mt,
                           Hook&& loaded) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool tr = trace_thread(a.trace);
  if (tr) a.trace[kTrNorm + 4] = global_ns();
  const int K = a.H;
  float xr[kMT][kXPer], lw[kXPer];
#pragma unroll
  for (int q = 0; q < kXPer; ++q) {
    const int k = threadIdx.x + q * kFThreads;
    lw[q] = k < K ? to_f32(ln[k]) : 0.f;
#pragma unroll
    for (int m = 0; m < kMT; ++m)
      xr[m][q] = m < mt && k < K ? resid<T>(a, src, c0 + m, k) : 0.f;
  }
  loaded();
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    float ss = 0.f;
#pragma unroll
    for (int q = 0; q < kXPer; ++q) ss = fmaf(xr[m][q], xr[m][q], ss);
#pragma unroll
    for (int o = 16; o > 0; o /= 2) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) sm.red[warp * 32 + m] = ss;
  }
  const unsigned long long tn0 = tr ? global_ns() : 0;
  __syncthreads();
  if (threadIdx.x < mt) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kFWarps; ++w) t += sm.red[w * 32 + threadIdx.x];
    sm.rinv[threadIdx.x] = rsqrtf(t / static_cast<float>(K) + a.eps);
  }
  __syncthreads();
  if (tr) {
    a.trace[kTrNorm] += tn0 - a.trace[kTrNorm + 4];
    a.trace[kTrNorm + 1] += global_ns() - tn0;
    a.trace[kTrNorm + 3] += 1;
  }
#pragma unroll
  for (int q = 0; q < kXPer; ++q) {
    const int k = threadIdx.x + q * kFThreads;
    if (k < K)
#pragma unroll
      for (int m = 0; m < kMT; ++m)
        store_x(sm.xs + m * K + k,
                m < mt ? round_t(xr[m][q] * sm.rinv[m] * lw[q], (T*)nullptr)
                       : 0.f);
  }
}

// wo's and down's inputs of a chunk into xs: the attention output, or
// silu(g) * u of the gate / up product rounded once; a thread loads kYPer
// columns' inputs of a row at once (one round trip for K <= 256 kYPer).
template <typename T, int kMT, typename Hook>
__device__ void stage_plain(const FrameArgs& a, const Smem<T, kMT>& sm,
                            bool down, int K, int c0, int mt,
                            Hook&& loaded) {
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    const int b = c0 + m;
    for (int k0 = threadIdx.x; k0 < K; k0 += kYPer * kFThreads) {
      float x0[kYPer], x1[kYPer];
#pragma unroll
      for (int q = 0; q < kYPer; ++q) {
        const int k = k0 + q * kFThreads;
        x0[q] = x1[q] = 0.f;
        if (m < mt && k < K) {
          if (down) {
            const float* row = a.gu + static_cast<long long>(b) * 2 * K;
            x0[q] = row[k];
            x1[q] = row[K + k];
          } else {
            x0[q] = a.att[b * K + k];
          }
        }
      }
      if (m == 0 && k0 == static_cast<int>(threadIdx.x)) loaded();
#pragma unroll
      for (int q = 0; q < kYPer; ++q) {
        const int k = k0 + q * kFThreads;
        if (k < K)
          store_x(sm.xs + m * K + k,
                  m >= mt ? 0.f
                  : down  ? round_t(x0[q] / (1.f + expf(-x0[q])) * x1[q],
                                    (T*)nullptr)
                          : x0[q]);
      }
    }
  }
}

// A product stage of the block: the units [u0, u0 + nu) of weight stage
// (mat, layer, slice), its slice staged in `buf` (kpre rows a unit), and
// the stage's epilogue.
template <typename T, int kMT, typename W, typename Hook>
__device__ void product(const FrameArgs& a, const Smem<T, kMT>& sm,
                        const Src<T>& src, int mat, int layer, int slice,
                        const unsigned char* buf, Hook&& after_inputs) {
  const StageDims d = dims(a, mat, layer, slice);
  const int U = d.N / kUnit;
  const int u0 = unit_lo(U, blockIdx.x, gridDim.x);
  const int nu = unit_lo(U, blockIdx.x + 1, gridDim.x) - u0;
  const int kpre = staged_rows(d.K, nu, kUnit * sizeof(W), a.buf);
  const bool norm = mat == kQkv || mat == kGu || mat == kHead;
  const T* ln = static_cast<const T*>(
      mat == kQkv ? a.ln1 : mat == kGu ? a.ln2 : a.final_norm);
  if (mat != kHead) ln += static_cast<long long>(layer) * a.H;
  // scales: [L, N] a layer, [16 * CV] for the head (its slice's offset)
  const float* scale = a.sc[mat] == nullptr ? nullptr : a.sc[mat] + d.soff;
  const W* wbase = static_cast<const W*>(a.w[mat]) + d.off;
  const int B = a.B, K = d.K;
  constexpr int kUB = UnitsABatch<kMT>::value;
  const bool tr = trace_thread(a.trace);
  const unsigned long long tp0 = tr ? global_ns() : 0;
  unsigned long long tp1 = tp0;

  if (mat == kHead && threadIdx.x < B) {
    sm.bestv[threadIdx.x] = -INFINITY;
    sm.besti[threadIdx.x] = 0x7fffffff;
  }
  __syncthreads();
  if (nu == 0) after_inputs();
  if (nu > 0) {
    for (int c0 = 0; c0 < B; c0 += kMT) {
      const int mt = min(kMT, B - c0);
      // the next stage's copies start once this chunk's inputs are on
      // their way, so these loads do not queue behind them
      auto loaded = [&] {
        if (c0 == 0) after_inputs();
      };
      if (norm)
        stage_norm<T, kMT>(a, sm, src, ln, c0, mt, loaded);
      else
        stage_plain<T, kMT>(a, sm, mat == kDown, K, c0, mt, loaded);
      __syncthreads();
      if (tr && c0 == 0) tp1 = global_ns();
      // wo / down add into the residual: the first batch's old values
      // load before its sums (the later batches' in their epilogue)
      float res0 = 0.f;
      {
        const int i = threadIdx.x;
        const int ub = i / (kMT * kVec), m = i / kVec % kMT;
        if ((mat == kWo || mat == kDown) && i < 32 && ub < min(kUB, nu) &&
            m < mt)
          res0 = a.xres[(c0 + m) * a.H + (u0 + ub) * kUnit + i % kVec];
      }
      for (int ul = 0; ul < nu; ul += kUB) {
        const int nub = min(kUB, nu - ul);
        batch_sums<T, W, kMT>(
            sm, reinterpret_cast<const W*>(buf) +
                    static_cast<long long>(ul) * kpre * kUnit,
            wbase + static_cast<long long>(u0 + ul) * K * kUnit, K, kpre,
            nub);
        const int i = threadIdx.x;
        const int ub = i / (kMT * kVec), m = i / kVec % kMT;
        if (i < 32 && ub < nub && m < mt) {
          const int n = (u0 + ul + ub) * kUnit + i % kVec;
          const int b = c0 + m;
          float s = sm.outv[i];
          if (scale != nullptr) s *= scale[n];
          switch (mat) {
            case kQkv: a.qkv[static_cast<long long>(b) * d.N + n] = s; break;
            case kGu: a.gu[static_cast<long long>(b) * d.N + n] = s; break;
            case kHead: sm.outv[i] = round_t(s, (T*)nullptr); break;
            default:                                        // wo, down
              a.xres[b * a.H + n] =
                  (ul == 0 ? res0 : a.xres[b * a.H + n]) + s;
          }
        }
        if (mat == kHead) {
          __syncthreads();
          if (threadIdx.x < mt) {        // the row's logits in column order
            const int r = threadIdx.x, b = c0 + r;
            float bv = sm.bestv[b];
            int bi = sm.besti[b];
            for (int u = 0; u < nub; ++u)
              for (int j = 0; j < kVec; ++j) {
                const float lv = sm.outv[(u * kMT + r) * kVec + j];
                const int col = (u0 + ul + u) * kUnit + j;
                if (better(lv, col, bv, bi)) { bv = lv; bi = col; }
              }
            sm.bestv[b] = bv;
            sm.besti[b] = bi;
          }
        }
        __syncthreads();                 // red / outv are reused
      }
    }
  }
  if (tr) {
    a.trace[kTrProd + mat * 4 + 1] += tp1 - tp0;
    a.trace[kTrProd + mat * 4 + 2] += global_ns() - tp1;
    a.trace[kTrProd + mat * 4 + 3] += 1;
  }
  if (mat == kHead && threadIdx.x < B) {
    a.part_v[blockIdx.x * B + threadIdx.x] = sm.bestv[threadIdx.x];
    a.part_i[blockIdx.x * B + threadIdx.x] = sm.besti[threadIdx.x];
  }
}

// Stage 2 of layer l in pass p, for the block's (row, kv head) units: a
// warp per head vector (k, v, then the group's q heads) rounds it to T,
// QK-norms and RoPEs q and k (one rounding each, ops/gemv.cuh qk_finish's
// arithmetic), stores k and v at slot p of the frame cache; then per q
// head the scores over slots [0, p) and the current token (a warp per
// slot), the softmax in f32 and the weighted sum of the values, rounded to
// T into the attention output.
template <typename T, int kMT>
__device__ void attention(const FrameArgs& a, const Smem<T, kMT>& sm, int p,
                          int l) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hd = a.hd, half = hd / 2, g = a.nq / a.nk;
  const int nqkv = (a.nq + 2 * a.nk) * hd;
  const int U = a.B * a.nk;
  const int u1 = unit_lo(U, blockIdx.x + 1, gridDim.x);
  const float rs = sqrtf(static_cast<float>(hd));
  constexpr int kR = kFMaxHd / 32;             // a lane's head dims
  constexpr int kSlots = kCodes / kFWarps;      // a warp's cached slots
  for (int u = unit_lo(U, blockIdx.x, gridDim.x); u < u1; ++u) {
    const int b = u / a.nk, j = u % a.nk;
    const long long slot0 =
        ((static_cast<long long>(l) * a.B + b) * a.nk + j) * kCodes * hd;
    // every load that does not depend on this stage's results, in flight
    // together: the cached keys of the warp's slots, the cached values of
    // the thread's dim e, the head vectors with their norm weight and cos /
    // sin
    float kr[kSlots][kR];
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int t = warp + kFWarps * i, e = lane + 32 * r;
        kr[i][r] = t < p && e < hd ? a.kc[slot0 + t * hd + e] : 0.f;
      }
    float vt[kCodes];
#pragma unroll
    for (int t = 0; t < kCodes; ++t)
      vt[t] = t < p && threadIdx.x < hd
                  ? a.vc[slot0 + t * hd + threadIdx.x] : 0.f;
    if (warp < 2 + g) {
      const int h = warp == 0 ? a.nq + j
                    : warp == 1 ? a.nq + a.nk + j
                                : j * g + warp - 2;
      const T* wn = static_cast<const T*>(warp == 0 ? a.k_norm : a.q_norm)
                    + static_cast<long long>(l) * hd;
      float* hv = sm.hb + warp * hd;
      float v[kR], w[kR], c[kR], sn[kR];
      float ss = 0.f;
#pragma unroll
      for (int t = 0; t < kR; ++t) {
        const int e = lane + 32 * t;
        v[t] = w[t] = c[t] = sn[t] = 0.f;
        if (e < hd) {
          v[t] = round_t(a.qkv[static_cast<long long>(b) * nqkv + h * hd + e],
                         (T*)nullptr);
          w[t] = to_f32(wn[e]);
          c[t] = round_t(a.cos[p * hd + e], (T*)nullptr);
          sn[t] = round_t(a.sin[p * hd + e], (T*)nullptr);
          ss = fmaf(v[t], v[t], ss);
        }
      }
      if (warp != 1) {                       // q or k: norm, RoPE
#pragma unroll
        for (int o = 16; o > 0; o /= 2)
          ss += __shfl_xor_sync(0xffffffffu, ss, o);
        const float r = rsqrtf(ss / static_cast<float>(hd) + a.eps);
#pragma unroll
        for (int t = 0; t < kR; ++t) {
          const int e = lane + 32 * t;
          if (e < hd) {
            v[t] = round_t(v[t] * r * w[t], (T*)nullptr);
            hv[e] = v[t];
          }
        }
        __syncwarp();
#pragma unroll
        for (int t = 0; t < kR; ++t) {
          const int e = lane + 32 * t;
          if (e < hd) {
            const float pr = hv[e ^ half];
            const float rot = e < half ? -pr : pr;
            v[t] = round_t(__fadd_rn(__fmul_rn(v[t], c[t]),
                                     __fmul_rn(rot, sn[t])),
                           (T*)nullptr);
          }
        }
        __syncwarp();
      }
      float* cache = warp == 0 ? a.kc : warp == 1 ? a.vc : nullptr;
#pragma unroll
      for (int t = 0; t < kR; ++t) {
        const int e = lane + 32 * t;
        if (e < hd) {
          hv[e] = v[t];
          if (cache != nullptr) cache[slot0 + p * hd + e] = v[t];
        }
      }
    }
    __syncthreads();
    for (int i = 0; i < g; ++i) {
      const float* qv = sm.hb + (2 + i) * hd;
      // scores: slot t of the cache from the warp's registers, slot p (the
      // current token) from the k head in shared memory
#pragma unroll
      for (int n = 0; n < kSlots + 1; ++n) {
        const int t = n < kSlots ? warp + kFWarps * n : p;
        if (n < kSlots ? t < p : warp == 0) {
          float sc = 0.f;
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const int e = lane + 32 * r;
            if (e < hd)
              sc = fmaf(__fdiv_rn(qv[e], rs),
                        n < kSlots ? kr[n < kSlots ? n : 0][r] : sm.hb[e],
                        sc);
          }
#pragma unroll
          for (int o = 16; o > 0; o /= 2)
            sc += __shfl_xor_sync(0xffffffffu, sc, o);
          if (lane == 0) sm.sc[t] = sc;
        }
      }
      __syncthreads();
      if (threadIdx.x < hd) {
        const int e = threadIdx.x;
        float mx = sm.sc[0];
        for (int t = 1; t <= p; ++t) mx = fmaxf(mx, sm.sc[t]);
        float lsum = 0.f, acc = 0.f;
#pragma unroll
        for (int t = 0; t < kCodes; ++t)
          if (t < p) {
            const float ew = expf(sm.sc[t] - mx);
            lsum += ew;
            acc = fmaf(ew, vt[t], acc);
          }
        const float ew = expf(sm.sc[p] - mx);
        lsum += ew;
        acc = fmaf(ew, sm.hb[hd + e], acc);
        a.att[static_cast<long long>(b) * a.nq * hd + (j * g + i) * hd + e] =
            round_t(acc / fmaxf(lsum, 1e-30f), (T*)nullptr);
      }
      __syncthreads();
    }
  }
}

// codes of head slice q - 1 from the blocks' partials, a warp per row, into
// sm.code; block 0 stores codes[:, q].
template <typename T, int kMT>
__device__ void reduce_codes(const FrameArgs& a, const Smem<T, kMT>& sm,
                             int q) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int b = warp; b < a.B; b += kFWarps) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int i = lane; i < static_cast<int>(gridDim.x); i += 32) {
      const float v = a.part_v[i * a.B + b];
      const int k = a.part_i[i * a.B + b];
      if (better(v, k, bv, bi)) { bv = v; bi = k; }
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) {
      const float v = __shfl_xor_sync(0xffffffffu, bv, o);
      const int k = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(v, k, bv, bi)) { bv = v; bi = k; }
    }
    if (lane == 0) {
      sm.code[b] = bi;
      if (blockIdx.x == 0) a.codes[b * kCodes + q] = bi;
    }
  }
}

template <typename T, int kMT, typename Hook>
__device__ void product_any(const FrameArgs& a, const Smem<T, kMT>& sm,
                            const Src<T>& src, int mat, int layer, int slice,
                            const unsigned char* buf, Hook&& after_inputs) {
  if (a.sc[mat] != nullptr)
    product<T, kMT, int8_t>(a, sm, src, mat, layer, slice, buf,
                            after_inputs);
  else
    product<T, kMT, T>(a, sm, src, mat, layer, slice, buf, after_inputs);
}

template <typename T, int kMT>
__global__ void __launch_bounds__(kFThreads, 1)
predictor_frame(FrameArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T, kMT> sm = carve<T, kMT>(smem_raw, a);
  const int L = a.L, B = a.B;
  const int n_stages = 4 * L + (kCodes - 1) * (4 * L + 1);
  const bool tr = trace_thread(a.trace);
  if (tr) a.trace[kTrT0] = global_ns();
  unsigned long long* btr = kTrace && blockIdx.x == 0 ? a.trace : nullptr;
  int s = 0, ti = 0;
  auto barrier = [&] { grid_barrier_first(a.bar, kFThreads, btr, ti); };
  if (threadIdx.x == 0) {
    mbar_init(sm.bar);
    mbar_init(sm.bar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  issue<T>(a, 0, n_stages, sm.buf[0], sm.bar);
  if (blockIdx.x == 0 && threadIdx.x < B)
    a.codes[threadIdx.x * kCodes] = a.code0[threadIdx.x];

  // weight stage s: wait for its copies (buffer s & 1, its (s / 2)-th
  // use), load its inputs, start the copies of stage s + 1 into the other
  // buffer (free since the last barrier), run the products, meet the grid
  auto weight_stage = [&](const Src<T>& src, int mat, int layer,
                          int slice) {
    const unsigned long long tw0 = tr ? global_ns() : 0;
    mbar_wait(sm.bar + (s & 1), (s >> 1) & 1);
    if (tr) {
      a.trace[kTrWait] += global_ns() - tw0;
      a.trace[kTrWait + 1] += 1;
    }
    product_any<T, kMT>(a, sm, src, mat, layer, slice, sm.buf[s & 1], [&] {
      issue<T>(a, s + 1, n_stages, sm.buf[(s + 1) & 1],
               sm.bar + ((s + 1) & 1));
    });
    ++s;
    barrier();
  };

  for (int p = 0; p < kCodes; ++p) {
    // the pass's source rows: h1024 at pass 0, else ptab[p - 1][sel(code)]
    Src<T> src{};
    src.source = true;
    if (p == 0) {
      src.h1024 = a.h1024;
    } else {
      if (p == 1) {
        if (threadIdx.x < B) sm.code[threadIdx.x] = a.code0[threadIdx.x];
      } else {
        reduce_codes<T, kMT>(a, sm, p - 1);
      }
      __syncthreads();
      for (int b = 0; b < B; ++b) {
        const int c = max(sm.code[b], 0);
        const int row = c < a.rows0 ? c : a.R - 1;
        src.prow[b] = static_cast<const T*>(a.ptab) +
                      (static_cast<long long>(p - 1) * a.R + row) * a.H;
      }
    }
    // this block's share of the residual, from the source
    {
      const int k0 = unit_lo(a.H, blockIdx.x, gridDim.x);
      const int k1 = unit_lo(a.H, blockIdx.x + 1, gridDim.x);
      const int n = k1 - k0;
      for (int i = threadIdx.x; i < B * n; i += kFThreads) {
        const int b = i / n, k = k0 + i % n;
        a.xres[b * a.H + k] = resid<T>(a, src, b, k);
      }
    }
    const Src<T> res{};
    for (int l = 0; l < L; ++l) {
      weight_stage(l == 0 ? src : res, kQkv, l, 0);
      attention<T, kMT>(a, sm, p, l);
      barrier();
      weight_stage(res, kWo, l, 0);
      weight_stage(res, kGu, l, 0);
      weight_stage(res, kDown, l, 0);
    }
    if (p >= 1) weight_stage(res, kHead, 0, p - 1);
  }
  if (blockIdx.x == 0) reduce_codes<T, kMT>(a, sm, kCodes - 1);
}

template <typename T>
using FrameKernel = void (*)(FrameArgs);

template <typename T>
FrameKernel<T> frame_kernel(int mt) {
  if (mt == 1) return predictor_frame<T, 1>;
  if (mt == 2) return predictor_frame<T, 2>;
  return predictor_frame<T, 4>;
}

template <typename F>
int with_kernel(int dtype, int mt, F&& f) {
  if (dtype == 0) return f(frame_kernel<float>(mt), 4);
  return f(frame_kernel<__nv_bfloat16>(mt), 2);
}

bool bad_frame(const FrameArgs& a, int mt) {
  const bool pow2 = a.hd >= 8 && a.hd <= kFMaxHd && !(a.hd & (a.hd - 1));
  return a.B < 1 || a.B > kFMaxB || (mt != 1 && mt != 2 && mt != 4) ||
         a.L < 1 || !pow2 || a.nk < 1 || a.nq % a.nk ||
         a.nq / a.nk > kFMaxG || a.H % kUnit || a.F % kUnit ||
         a.H > kXPer * kFThreads ||
         a.CV % kUnit || a.buf < 0 || a.buf % 16 || a.R < 1 ||
         a.rows0 < 0 || a.rows0 > a.R;
}

}  // namespace

extern "C" {

// out[0] = resident blocks per SM of the kernel (dtype: 0 float32, 1
// bfloat16; mt: x rows a chunk, 1, 2 or 4) at `smem` bytes of dynamic
// shared memory, out[1] the device's opt-in shared memory per block, out[2]
// its SM count; returns a cudaError_t.
int predictor_frame_query(int dtype, int mt, int smem, int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[2], cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > out[1] || (mt != 1 && mt != 2 && mt != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_kernel(dtype, mt, [&](auto kernel, int) {
    cudaError_t r = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (r == cudaSuccess)
      r = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel,
                                                        kFThreads, smem);
    return static_cast<int>(r);
  });
}

// One frame: `args` a FrameArgs (ops/fused_predictor.py _FrameArgs), nb
// blocks (SMs x resident blocks), smem = the fixed part + 2 * args.buf.
int predictor_frame_launch(const void* args, int dtype, int mt, int nb,
                           int smem, void* stream) {
  if (args == nullptr || (dtype != 0 && dtype != 1) || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const FrameArgs a = *static_cast<const FrameArgs*>(args);
  if (bad_frame(a, mt) ||
      smem != fixed_smem(mt, kmax_of(a.H, a.nq, a.hd, a.F), a.hd,
                         dtype == 0 ? 4 : 2) + 2 * a.buf)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_kernel(dtype, mt, [&](auto kernel, int) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nb, 1, 1);
    cfg.blockDim = dim3(kFThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, a);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  });
}

}  // extern "C"
