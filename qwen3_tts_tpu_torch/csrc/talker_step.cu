// The talker's whole decode step as one persistent CUDA kernel: 28 layers
// of qkv / attention / wo / gate-up / down, then the final norm and the
// head, in ONE cooperative launch a step.
//
// Replaces: qwen3_tts_tpu/ops/fused_talker.py::talker_step_fused (the
//   Pallas kernel `_kernel_body`, one pallas_call a step), which the port
//   had carried as a chain of ~142 launches a step driven from Python
//   (ops/chain.py layer_pass: five launches a layer; the Triton rms_norm
//   and the head's gemv; two indexed cache copies). It computes what the
//   chain computes (ops/fused_talker.py talker_step_fused_plain), at the
//   same rounding points: the f32 residual; ln1 / ln2 / the final norm
//   rounded once to the model dtype T; products in f32 (times the int8 /
//   int4 column scale); the qkv row rounded to T, QK-norm and rotate-half
//   M-RoPE (cos / sin rounded to T), one rounding each; attention over the
//   pre-update cache [valid_from, kv_len) with the current token folded in
//   last, rounded to T; silu(g) * u in f32, rounded once; the final norm's
//   output is the step's hidden; logits f32 rounded through T.
//
// Bound: weight bytes. A step reads the 28 layers' weights and the head
//   once: 2.83 GB dense bf16 at the full talker width, 0.845 ms at 3.35
//   TB/s (int8 about half, int4 about a quarter); the live cache slots add
//   ~0.1 MB a layer per row. At B <= 16 each weight element is used B
//   times, far below the tensor cores' balance point. What the chain paid
//   on top was a fixed cost per launch, ~142 times a step.
//
// Design (the machinery of predictor_frame.cu, csrc/persistent.cuh):
//   * One cooperative launch, one block per SM. A block is 8 consumer
//     warps and one producer warp. Dependent stages meet at a grid barrier
//     of the consumer threads (named barrier 1, then the counting grid
//     barrier of persistent.cuh); the producer never waits for one.
//   * Stages of a layer, each a grid barrier apart: qkv (ln1 as its norm
//     prologue, f32 out); attention; wo (added into the residual); gate /
//     up (ln2; its packed columns interleave each 4 gate features with
//     their 4 up features, so each unit's epilogue writes silu(g) * u);
//     down (added into the residual). After the last layer: the head
//     with the final norm as its prologue; the normed rows are the step's
//     hidden.
//   * Work plan: a product's N columns are 8-column units dealt over the
//     blocks in contiguous ranges [blk * U / nb, (blk + 1) * U / nb)
//     (ops/fused_talker.py split_units). Each output column is computed by
//     one block over the whole K in a fixed order: no K split, no atomics
//     on data, repeats are bit-identical.
//   * The weight ring. The weights are read from a packed copy (each
//     8-column unit's rows contiguous, ops/fused_predictor.py pack_units),
//     so a block's units of a stage are contiguous. A block takes its units
//     in batches (4 units at one x row, 2 at two, 1 at four or more: 32 or
//     64 sums a thread) and each batch's rows in chunks of at most `chunk`
//     bytes. The producer's one thread walks the same sequence, stage after
//     stage and layer after layer, copying chunk after chunk with TMA bulk
//     copies into a ring of `nbuf` shared-memory buffers, each completing
//     on its "full" mbarrier. It waits only for a free buffer: the consumer
//     warps release a buffer on its "empty" mbarrier once they have read
//     it. So the weight stream runs ahead under the attention stage, the
//     barriers and the prologues, as deep as the ring.
//   * x rows: a row pass stages up to kMT rows (1, 2, 4 or 8 in bf16, at
//     most 4 in f32: B > kMT takes ceil(B / kMT) passes over the stage, its
//     weights streamed once a pass) in shared memory in T after their
//     prologue; a thread holds kMT * 8 sums for each unit of a batch,
//     reduced through one warp reduce-scatter per 32 sums and the warps in
//     order.
//   * Split attention. Units (row b, kv head j, split s), s < S, are dealt
//     over the blocks; S comes from B, nk, the grid and the cache capacity
//     only (ops/fused_talker.py step_splits), never from kv_len. A unit
//     rounds its k, v and q heads, QK-norms and RoPEs them, takes split s
//     of the row's live range [valid_from, min(kv_len, T)), and writes its
//     online-softmax state (m, l, acc) to scratch. The unit then counts
//     itself on its (b, j) counter (an acquire-release add); the last of
//     the S units merges the states in split order (two passes: the max,
//     then the rescaled sums), folds the current token in last, writes the
//     T-rounded output and resets the counter (with one split, the unit
//     finishes from its warps' states directly). Every unit of (b, j) has
//     read that cache slice by then and no later stage of the step reads
//     it, so the same unit stores the current k and v at the row's slot:
//     the pre-update contract of qwen3_tts_tpu/ops/fused_talker.py:575-596
//     holds, and the step needs no copy of its own. Which block merges
//     depends on timing; what it computes does not.
//   * positions, slot, kv_len and valid_from are device int32 [B]; the grid
//     and the plan depend on shapes only, so the launch replays in a CUDA
//     graph. The split counters reset themselves; the grid barrier's
//     count only grows, and each launch starts from where it stands.
//   * A trace, compiled in only with -DKERNEL_TRACE (persistent.cuh
//     kTrace) and on when args.trace is set: block 0's consumer thread 0
//     writes %globaltimer at each grid barrier's arrival and release and
//     sums its waits for full buffers; the producer sums its waits for
//     free ones (tools/frame_measure.py talker).
// Scope: T = float or bf16; each of the five weights dense in T or int8
//   with an f32 column scale (mixed too), or all five int4 (packed biased
//   nibbles, an int8 multiplier per 128-row group and column, an f32
//   column scale; the products are exact in f32, summed in another order
//   than ops/quant.py panel_matmul4_plain); 1 <= B <= 16; hd a power of two
//   in [8, 128]; nq / nk <= 4; H <= 2048; H, F, nq * hd, V multiples of 8.

#include "persistent.cuh"

namespace {

constexpr int kSThreads = 256;           // consumer threads
constexpr int kSWarps = kSThreads / 32;
constexpr int kSBlock = kSThreads + 32;  // + the producer warp
constexpr int kSUnit = 8;                // columns of a unit
constexpr int kSMaxB = 16;
constexpr int kSMaxMT = 8;
constexpr int kSMaxG = 4;
constexpr int kSMaxHd = 128;
constexpr int kSXPer = 8;                // norm inputs a thread holds
constexpr int kSMaxRing = 8;
constexpr int kSMaxSplits = 16;
constexpr int kSAhead = 8;               // cache slots a warp loads at once
constexpr float kSNeg = -1e30f;
enum { kSQkv = 0, kSWo = 1, kSGu = 2, kSDown = 3, kSHead = 4 };
enum { kDense = 0, kInt8 = 1, kInt4 = 2 };
// trace words (tools/frame_measure.py): barrier i at 2 i, 2 i + 1
constexpr int kTrT0 = 500, kTrEnd = 501, kTrWait = 502, kTrPWait = 504;
// the attention unit 0's phases (the last layer's): kTrAttn + 0..5; block
// 0's product stages of the last layer, kTrProd + 8 mat + 0..4: start,
// inputs staged, first chunk in, last chunk read, end
constexpr int kTrAttn = 510, kTrProd = 520;

// ops/fused_talker.py _StepArgs, field for field.
struct StepArgs {
  const void* w[5];       // packed values [L, N / 8, Kp, 8] (head: no L)
  const int8_t* m8[5];    // int4: multipliers [L, K / 128, N]; else null
  const float* sc[5];     // column scales [L, N] / [N]; null dense
  const void* ln1;        // [L, H] T
  const void* ln2;
  const void* q_norm;     // [L, hd] T
  const void* k_norm;
  const void* final_norm; // [H] T
  const void* x;          // [B, H] T, the step's input
  const float* cos;       // [B, hd]
  const float* sin;
  const int* slot;        // [B] the cache write slot
  const int* kv_len;      // [B]
  const int* valid_from;  // [B]
  void* kc;               // [L, B, nk, Tc, hd] T, updated at the slot
  void* vc;
  void* hidden;           // [B, H] T out
  float* logits;          // [B, V] out
  float* xres;            // [B, H] the residual
  float* qkv;             // [B, (nq + 2 nk) hd]
  float* att;             // [B, nq hd] (T-rounded values)
  float* act;             // [B, F] silu(g) * u (T-rounded values)
  float* part;            // [B nk S][g (hd + 2)] split states
  unsigned* cnt;          // [B nk] split counters
  unsigned long long* bar;  // the grid barrier's arrival count
  unsigned long long* trace;
  int kind[5];            // kDense, kInt8, kInt4
  int B, H, L, nq, nk, hd, F, V, Tc, S;
  int chunk;              // bytes of a ring buffer
  int nbuf;               // ring buffers
  float eps;
};

__host__ __device__ inline int s_align16(int n) { return (n + 15) & ~15; }

__host__ __device__ inline int s_kmax(int H, int nq, int hd, int F) {
  const int a = H > nq * hd ? H : nq * hd;
  return a > F ? a : F;
}

// sums a thread holds for a batch of units: 32, or 64 at 8 rows
__host__ __device__ constexpr int s_acc(int mt) {
  return mt * kSUnit > 32 ? mt * kSUnit : 32;
}

// Bytes of a block's shared memory besides the ring (ops/fused_talker.py
// step_smem_fixed): the ring's barriers, the staged x rows, the sums'
// scratch, the attention unit's head vectors and per-warp states.
__host__ __device__ inline int s_fixed(int mt, int kmax, int hd, int tsize) {
  return 2 * kSMaxRing * 8 + s_align16(mt * kmax * tsize) +
         4 * (2 * kSWarps * 32 + 64 + kSMaxMT + (2 + kSMaxG) * hd +
              kSWarps * kSMaxG * (hd + 2) + kSMaxG + 4);
}

template <typename T, int kMT>
struct SSmem {
  unsigned char* ring;          // [nbuf][chunk]
  unsigned long long* full;     // [kSMaxRing]
  unsigned long long* empty;    // [kSMaxRing]
  T* xs;                        // [kMT][Kmax]
  float* red;                   // [2][kSWarps][32]
  float* outv;                  // [64]
  float* rinv;                  // [kSMaxMT]
  float* hb;                    // [2 + kSMaxG][hd]: k, v, q heads
  float* wst;                   // [kSWarps][kSMaxG][hd + 2]
  float* snew;                  // [kSMaxG]
  int* flag;                    // [4]
};

template <typename T, int kMT>
__device__ SSmem<T, kMT> s_carve(unsigned char* base, const StepArgs& a) {
  SSmem<T, kMT> s;
  s.ring = base;
  unsigned char* p = base + a.nbuf * a.chunk;
  s.full = reinterpret_cast<unsigned long long*>(p);
  s.empty = s.full + kSMaxRing;
  p += 2 * kSMaxRing * 8;
  s.xs = reinterpret_cast<T*>(p);
  p += s_align16(kMT * s_kmax(a.H, a.nq, a.hd, a.F) * sizeof(T));
  s.red = reinterpret_cast<float*>(p);
  s.outv = s.red + 2 * kSWarps * 32;
  s.rinv = s.outv + 64;
  s.hb = s.rinv + kSMaxMT;
  s.wst = s.hb + (2 + kSMaxG) * a.hd;
  s.snew = s.wst + kSWarps * kSMaxG * (a.hd + 2);
  s.flag = reinterpret_cast<int*>(s.snew + kSMaxG);
  return s;
}

__device__ __forceinline__ void csync() { sync_first(kSThreads); }

// 4 consecutive values of a cache row as f32, one vector load
__device__ __forceinline__ void ld4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// ---------------------------------------------------------------- stages
// A weight stage: x width K, packed weight rows Kp (K / 2 for int4), N
// columns, bytes of a unit row (8 columns), the element offsets of its
// layer in the packed values, the scales and the int4 multipliers.
struct SGeom {
  int mat, layer, kind, K, Kp, N, wb, u0, nu;
  long long off, soff, moff;
};

// Weight stage s of the step: 4 a layer (qkv, wo, gate/up, down), then the
// head at s = 4 L.
template <typename T>
__device__ __forceinline__ SGeom s_geom(const StepArgs& a, int s) {
  SGeom d;
  d.mat = s == 4 * a.L ? kSHead : s % 4;
  d.layer = s == 4 * a.L ? 0 : s / 4;
  d.kind = a.kind[d.mat];
  switch (d.mat) {
    case kSQkv: d.K = a.H; d.N = (a.nq + 2 * a.nk) * a.hd; break;
    case kSWo: d.K = a.nq * a.hd; d.N = a.H; break;
    case kSGu: d.K = a.H; d.N = 2 * a.F; break;
    case kSDown: d.K = a.F; d.N = a.H; break;
    default: d.K = a.H; d.N = a.V; break;
  }
  d.Kp = d.kind == kInt4 ? d.K / 2 : d.K;
  d.wb = kSUnit * (d.kind == kDense ? static_cast<int>(sizeof(T)) : 1);
  d.soff = static_cast<long long>(d.layer) * d.N;
  d.off = d.soff * d.Kp;
  d.moff = d.soff * (d.K / kGroup4);
  const int U = d.N / kSUnit;
  d.u0 = static_cast<int>(static_cast<long long>(blockIdx.x) * U / gridDim.x);
  d.nu = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * U /
                          gridDim.x) - d.u0;
  return d;
}

// rows of a chunk of a batch of nub units: as many as `chunk` bytes hold,
// even (whole 16-byte copies), at most Kp
__device__ __forceinline__ int s_chunk_rows(int chunk, int nub, int wb,
                                            int Kp) {
  return min(Kp, (chunk / (nub * wb)) & ~1);
}

__host__ __device__ constexpr int s_units_a_batch(int mt) {
  return s_acc(mt) / (mt * kSUnit);
}

__host__ __device__ inline int s_row_passes(int B, int mt) {
  return (B + mt - 1) / mt;
}

// The chunks of the step in the order the consumers read them: stage after
// stage (4 a layer, then the head), each row pass, each batch of units,
// each batch's rows in chunks (stages where the block has no units have
// none).
template <typename T, int kMT>
struct ChunkWalk {
  static constexpr int kUB = s_units_a_batch(kMT);
  const StepArgs* a;
  SGeom d;
  const char* g;
  int s, rc, ul, r0, passes;
  bool done;

  __device__ void start(const StepArgs& args) {
    a = &args;
    passes = s_row_passes(a->B, kMT);
    s = -1;
    next_stage();
  }
  __device__ void next_stage() {
    rc = ul = r0 = 0;
    do {
      if (++s > 4 * a->L) {
        done = true;
        return;
      }
      d = s_geom<T>(*a, s);
    } while (d.nu == 0);
    g = static_cast<const char*>(a->w[d.mat]) + d.off * (d.wb / kSUnit);
    done = false;
  }
  __device__ int nub() const { return min(kUB, d.nu - ul); }
  __device__ int rows() const {
    return s_chunk_rows(a->chunk, nub(), d.wb, d.Kp);
  }
  // bytes of each unit's copy of the chunk, and unit i's source
  __device__ unsigned bytes() const {
    return static_cast<unsigned>(min(rows(), d.Kp - r0) * d.wb);
  }
  __device__ const char* src(int i) const {
    return g + (static_cast<long long>(d.u0 + ul + i) * d.Kp + r0) * d.wb;
  }
  __device__ void advance() {
    r0 += rows();
    if (r0 < d.Kp) return;
    r0 = 0;
    ul += kUB;
    if (ul < d.nu) return;
    ul = 0;
    if (++rc < passes) return;
    next_stage();
  }
};

// The producer (lane 0 of the block's last warp): every chunk of the step
// in the consumers' order, each into ring buffer ci % nbuf once the
// consumers have released its last use.
template <typename T, int kMT>
__device__ void produce(const StepArgs& a, const SSmem<T, kMT>& sm) {
  const bool tr = kTrace && a.trace != nullptr && blockIdx.x == 0;
  unsigned long long waited = 0;
  ChunkWalk<T, kMT> cw;
  cw.start(a);
  int ci = 0;
  for (; !cw.done; cw.advance(), ++ci) {
    const int b = ci % a.nbuf;
    if (ci >= a.nbuf) {
      const unsigned long long t0 = tr ? global_ns() : 0;
      mbar_wait(sm.empty + b, ((ci / a.nbuf) - 1) & 1);
      if (tr) waited += global_ns() - t0;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const unsigned bytes = cw.bytes();
    const int nub = cw.nub();
    mbar_expect(sm.full + b, bytes * nub);
    unsigned char* dst = sm.ring + static_cast<long long>(b) * a.chunk;
    for (int i = 0; i < nub; ++i)
      bulk_copy(dst + static_cast<long long>(i) * bytes, cw.src(i), bytes,
                sm.full + b);
  }
  if (tr) {
    a.trace[kTrPWait] += waited;
    a.trace[kTrPWait + 1] += ci;
  }
}

// ---------------------------------------------------------------- prologues
// The norm stages' inputs of row pass rc into xs (predictor_frame.cu's
// stage_norm, for up to 8 rows): every thread loads its columns k = t +
// 256 q of the rows (the residual, or the step's input at layer 0) and of
// the norm weight at once, sums the squares in order, the rows' sums
// reduce through the warp's butterfly and the warps in order, and each
// value is normed and rounded once: T(x * rsqrt(mean(x^2) + eps) * w).
template <typename T, int kMT>
__device__ void s_norm(const StepArgs& a, const SSmem<T, kMT>& sm,
                       const T* ln, bool source, int c0, int mt) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int K = a.H;
  const T* x = static_cast<const T*>(a.x);
  float xr[kMT][kSXPer], lw[kSXPer];
#pragma unroll
  for (int q = 0; q < kSXPer; ++q) {
    const int k = threadIdx.x + q * kSThreads;
    lw[q] = k < K ? to_f32(ln[k]) : 0.f;
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      const int b = c0 + m;
      xr[m][q] = m < mt && k < K
                     ? (source ? to_f32(x[b * K + k]) : a.xres[b * K + k])
                     : 0.f;
    }
  }
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    float ss = 0.f;
#pragma unroll
    for (int q = 0; q < kSXPer; ++q) ss = fmaf(xr[m][q], xr[m][q], ss);
#pragma unroll
    for (int o = 16; o > 0; o /= 2) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) sm.red[warp * 32 + m] = ss;
  }
  csync();
  if (threadIdx.x < mt) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kSWarps; ++w) t += sm.red[w * 32 + threadIdx.x];
    sm.rinv[threadIdx.x] = rsqrtf(t / static_cast<float>(K) + a.eps);
  }
  csync();
#pragma unroll
  for (int q = 0; q < kSXPer; ++q) {
    const int k = threadIdx.x + q * kSThreads;
    if (k < K)
#pragma unroll
      for (int m = 0; m < kMT; ++m)
        store_x(sm.xs + m * K + k,
                m < mt ? round_t(xr[m][q] * sm.rinv[m] * lw[q], (T*)nullptr)
                       : 0.f);
  }
}

// wo's and down's inputs of row pass rc into xs: the attention output, or
// silu(g) * u (both already T-rounded by the stage that made them). A
// thread loads kYP columns of every row at once (one round trip for K <=
// 256 kYP: a product's K at one row), then stores them.
template <typename T, int kMT>
__device__ void s_plain(const SSmem<T, kMT>& sm, const float* src, int K,
                        int c0, int mt) {
  constexpr int kYP = 24 / kMT > 2 ? 24 / kMT : 2;
  for (int k0 = threadIdx.x; k0 < K; k0 += kYP * kSThreads) {
    float v[kMT][kYP];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int q = 0; q < kYP; ++q) {
        const int k = k0 + q * kSThreads;
        v[m][q] = m < mt && k < K
                      ? src[static_cast<long long>(c0 + m) * K + k] : 0.f;
      }
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int q = 0; q < kYP; ++q) {
        const int k = k0 + q * kSThreads;
        if (k < K) store_x(sm.xs + m * K + k, v[m][q]);
      }
  }
}

// 32 sums of a warp reduced and scattered at once (at each butterfly step
// a lane keeps one half of its values and adds its partner's copy of that
// half: 31 shuffles), lane l ending with sum l of v[32 kH .. 32 kH + 31]
template <int kAcc, int kH>
__device__ __forceinline__ float s_scatter(const float (&v)[kAcc], int lane) {
  float w[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) w[i] = v[kH * 32 + i];
#pragma unroll
  for (int o = 16, n = 32; o > 0; o /= 2) {
    const bool up = (lane & o) != 0;
    n /= 2;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < n) {
        const float send = up ? w[i] : w[i + n];
        const float keep = up ? w[i + n] : w[i];
        w[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
  }
  return w[0];
}

// the 8 weights of a unit row in the ring, as f32: dense, int8 (scale in
// the epilogue) or int4 (nibble - 8 times the group's multiplier, exact)
template <typename W>
__device__ __forceinline__ void s_weights(const unsigned char* p, float* wv) {
  cvt8(ld_sm(reinterpret_cast<const W*>(p)), wv);
}

// A product stage of row pass [c0, c0 + mt): the block's units in batches,
// each batch's rows chunk by chunk from the ring (ci counts the chunks as
// the producer does), then the batch's sums reduced over the block and the
// stage's epilogue.
template <typename T, int kMT, int kKind>
__device__ void s_product(const StepArgs& a, const SSmem<T, kMT>& sm,
                          const SGeom& d, int c0, int mt, int& ci,
                          unsigned long long& waited,
                          unsigned long long* ps) {
  using W = typename std::conditional<kKind == kDense, T, int8_t>::type;
  constexpr int kAcc = s_acc(kMT);
  constexpr int kUB = s_units_a_batch(kMT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool tr = trace_thread(a.trace);
  const int K = d.K, Kp = d.Kp;
  const float* scale = a.sc[d.mat] == nullptr ? nullptr : a.sc[d.mat] + d.soff;
  const int8_t* m8 = a.m8[d.mat] == nullptr ? nullptr : a.m8[d.mat] + d.moff;
  const int ng2 = Kp / kGroup4;   // int4: multiplier rows of the low half
  for (int ul = 0; ul < d.nu; ul += kUB) {
    const int nub = min(kUB, d.nu - ul);
    const int R = s_chunk_rows(a.chunk, nub, d.wb, Kp);
    float v[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) v[i] = 0.f;
    for (int r0 = 0; r0 < Kp; r0 += R, ++ci) {
      const int rn = min(R, Kp - r0);
      const int b = ci % a.nbuf;
      const unsigned long long t0 = tr ? global_ns() : 0;
      mbar_wait(sm.full + b, (ci / a.nbuf) & 1);
      if (tr) waited += global_ns() - t0;
      if (ps != nullptr && ul == 0 && r0 == 0) ps[2] = global_ns();
      const unsigned char* buf = sm.ring + static_cast<long long>(b) * a.chunk;
      for (int r = threadIdx.x; r < rn; r += kSThreads) {
        const int k = r0 + r;
        if constexpr (kKind != kInt4) {
          float xv[kMT];
#pragma unroll
          for (int m = 0; m < kMT; ++m) xv[m] = to_f32(sm.xs[m * K + k]);
#pragma unroll
          for (int ub = 0; ub < kUB; ++ub)
            if (ub < nub) {
              float wv[kSUnit];
              s_weights<W>(buf + (static_cast<long long>(ub) * rn + r) * d.wb,
                           wv);
#pragma unroll
              for (int m = 0; m < kMT; ++m)
#pragma unroll
                for (int j = 0; j < kSUnit; ++j) {
                  float& acc = v[(ub * kMT + m) * kSUnit + j];
                  acc = fmaf(xv[m], wv[j], acc);
                }
            }
        } else {
          float xl[kMT], xh[kMT];
#pragma unroll
          for (int m = 0; m < kMT; ++m) {
            xl[m] = to_f32(sm.xs[m * K + k]);
            xh[m] = to_f32(sm.xs[m * K + Kp + k]);
          }
          const int grp = k / kGroup4;
#pragma unroll
          for (int ub = 0; ub < kUB; ++ub)
            if (ub < nub) {
              const int col = (d.u0 + ul + ub) * kSUnit;
              const uint2 q = *reinterpret_cast<const uint2*>(
                  buf + (static_cast<long long>(ub) * rn + r) * kSUnit);
              const uint2 ml = __ldg(reinterpret_cast<const uint2*>(
                  m8 + static_cast<long long>(grp) * d.N + col));
              const uint2 mh = __ldg(reinterpret_cast<const uint2*>(
                  m8 + static_cast<long long>(ng2 + grp) * d.N + col));
              float lo[kSUnit], hi[kSUnit], fl[kSUnit], fh[kSUnit];
              unpack4(q.x, lo, hi);
              unpack4(q.y, lo + 4, hi + 4);
              m8_cvt(ml, fl);
              m8_cvt(mh, fh);
#pragma unroll
              for (int j = 0; j < kSUnit; ++j) {
                const float wl = lo[j] * fl[j], wh = hi[j] * fh[j];
#pragma unroll
                for (int m = 0; m < kMT; ++m) {
                  float& acc = v[(ub * kMT + m) * kSUnit + j];
                  acc = fmaf(xl[m], wl, acc);
                  acc = fmaf(xh[m], wh, acc);
                }
              }
            }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty + b);    // the buffer is free
    }
    if (ps != nullptr) ps[3] = global_ns();
    sm.red[warp * 32 + lane] = s_scatter<kAcc, 0>(v, lane);
    if constexpr (kAcc == 64)
      sm.red[(kSWarps + warp) * 32 + lane] = s_scatter<kAcc, 1>(v, lane);
    csync();
    if (threadIdx.x < kAcc) {
      const int h = threadIdx.x / 32, l = threadIdx.x % 32;
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kSWarps; ++w) t += sm.red[(h * kSWarps + w) * 32 + l];
      sm.outv[threadIdx.x] = t;
    }
    csync();
    const int i = threadIdx.x;
    const int ub = i / (kMT * kSUnit), m = i / kSUnit % kMT;
    const int j = i % kSUnit;
    if (i < kAcc && ub < nub && m < mt) {
      const int n = (d.u0 + ul + ub) * kSUnit + j;
      const long long bn = static_cast<long long>(c0 + m) * d.N + n;
      float s = sm.outv[i];
      if (scale != nullptr) s *= scale[n];
      switch (d.mat) {
        case kSQkv: a.qkv[bn] = s; break;
        case kSGu:
          // the unit's columns are g of features 4 u' .. 4 u' + 3, then
          // u of the same features (ops/fused_talker.py interleave_gu):
          // silu(g) * u in f32, rounded once
          if (j < 4) {
            float up = sm.outv[i + 4];
            if (scale != nullptr) up *= scale[n + 4];
            a.act[static_cast<long long>(c0 + m) * a.F +
                  (d.u0 + ul + ub) * 4 + j] =
                round_t(s / (1.f + expf(-s)) * up, (T*)nullptr);
          }
          break;
        case kSHead: a.logits[bn] = round_t(s, (T*)nullptr); break;
        default: a.xres[bn] = a.xres[bn] + s;              // wo, down
      }
    }
  }
}

// A weight stage: per row pass, the prologue into xs (the head's also
// gives the step's hidden: each block stores its share of the columns),
// then the product of the weight's kind.
template <typename T, int kMT>
__device__ void s_stage(const StepArgs& a, const SSmem<T, kMT>& sm, int s,
                        int& ci, unsigned long long& waited) {
  const SGeom d = s_geom<T>(a, s);
  const int passes = s_row_passes(a.B, kMT);
  const T* ln = static_cast<const T*>(
      d.mat == kSQkv ? a.ln1 : d.mat == kSGu ? a.ln2 : a.final_norm);
  if (d.mat != kSHead) ln += static_cast<long long>(d.layer) * a.H;
  unsigned long long* ps =
      trace_thread(a.trace) && (d.layer == a.L - 1 || d.mat == kSHead)
          ? a.trace + kTrProd + 8 * d.mat : nullptr;
  if (ps != nullptr) ps[0] = global_ns();
  for (int rc = 0; rc < passes; ++rc) {
    const int c0 = rc * kMT, mt = min(kMT, a.B - c0);
    if (d.nu == 0 && d.mat != kSHead) continue;
    if (d.mat == kSQkv || d.mat == kSGu || d.mat == kSHead)
      s_norm<T, kMT>(a, sm, ln, d.mat == kSQkv && d.layer == 0, c0, mt);
    else
      s_plain<T, kMT>(sm, d.mat == kSDown ? a.act : a.att, d.K, c0, mt);
    csync();
    if (ps != nullptr) ps[1] = global_ns();
    if (d.mat == kSHead) {
      const int k0 = static_cast<int>(
          static_cast<long long>(blockIdx.x) * a.H / gridDim.x);
      const int k1 = static_cast<int>(
          static_cast<long long>(blockIdx.x + 1) * a.H / gridDim.x);
      T* hid = static_cast<T*>(a.hidden);
      for (int i = threadIdx.x; i < mt * (k1 - k0); i += kSThreads) {
        const int m = i / (k1 - k0), k = k0 + i % (k1 - k0);
        hid[static_cast<long long>(c0 + m) * a.H + k] = sm.xs[m * a.H + k];
      }
    }
    switch (d.kind) {
      case kInt8:
        s_product<T, kMT, kInt8>(a, sm, d, c0, mt, ci, waited, ps);
        break;
      case kInt4:
        s_product<T, kMT, kInt4>(a, sm, d, c0, mt, ci, waited, ps);
        break;
      default:
        s_product<T, kMT, kDense>(a, sm, d, c0, mt, ci, waited, ps);
    }
  }
  if (ps != nullptr) ps[4] = global_ns();
}

// A merged state (m, l, acc) with the current token (score sn, value vn)
// folded in last, divided by max(l, 1e-30), rounded to T.
template <typename T>
__device__ __forceinline__ float s_fold(float mm, float ll, float aa,
                                        float sn, float vn, T*) {
  const float mf = fmaxf(mm, sn);
  const float cf = expf(mm - mf), pn = expf(sn - mf);
  const float lf = fmaxf(ll * cf + pn, 1e-30f);
  return round_t((aa * cf + pn * vn) / lf, (T*)nullptr);
}

// The attention stage of layer l, for the block's (row, kv head, split)
// units. Per unit: a warp per head vector (k, v, then the group's q heads)
// rounds it to T, QK-norms and RoPEs q and k (gemv.cuh qk_finish's
// arithmetic); the current token's score per q head; then the warps take
// the split's slots round robin, kSAhead at once, each with its own online
// softmax in f32 (a lane holds hd / 32 contiguous dims); the warps' states
// merge in warp order into the unit's state in scratch. The last unit of
// (b, j) to count itself merges the S states and stores k and v at the
// row's slot.
template <typename T, int kMT>
__device__ void s_attention(const StepArgs& a, const SSmem<T, kMT>& sm,
                            int l) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hd = a.hd, half = hd / 2, g = a.nq / a.nk, S = a.S;
  const int nqkv = (a.nq + 2 * a.nk) * hd;
  const int U = a.B * a.nk * S;
  const int st = hd + 2;                       // a state: acc[hd], m, l
  const float rs = sqrtf(static_cast<float>(hd));
  constexpr int kR = kSMaxHd / 32;
  const int dpl = hd >= 32 ? hd / 32 : 1;      // a lane's contiguous dims
  T* kc = static_cast<T*>(a.kc);
  T* vc = static_cast<T*>(a.vc);
  const int u1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * U /
                                  gridDim.x);
  for (int u = static_cast<int>(static_cast<long long>(blockIdx.x) * U /
                                gridDim.x);
       u < u1; ++u) {
    const int bj = u / S, sp = u % S;
    const int b = bj / a.nk, j = bj % a.nk;
    const long long base =
        ((static_cast<long long>(l) * a.B + b) * a.nk + j) * a.Tc * hd;
    const bool ts = kTrace && a.trace != nullptr && u == 0 && threadIdx.x == 0;
    if (ts) a.trace[kTrAttn] = global_ns();
    // this unit's share of the row's live range, and the warp's first
    // slots' keys and values in flight under the head vectors' work
    const int lo = max(a.valid_from[b], 0);
    const int hi = min(a.kv_len[b], a.Tc);
    const int live = max(hi - lo, 0);
    const int per = (live + S - 1) / S;
    const int s0 = lo + sp * per, s1 = min(s0 + per, hi);
    float kr[kSAhead][kR], vr[kSAhead][kR];
    auto load = [&](int t0) {
#pragma unroll
      for (int q = 0; q < kSAhead; ++q) {
        const int t = t0 + q * kSWarps;
        const long long row = base + static_cast<long long>(t) * hd;
        if (dpl == kR) {                      // hd 128: one vector a lane
          if (t < s1) {
            ld4(kc + row + lane * kR, kr[q]);
            ld4(vc + row + lane * kR, vr[q]);
          } else {
#pragma unroll
            for (int r = 0; r < kR; ++r) kr[q][r] = vr[q][r] = 0.f;
          }
        } else {
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const int e = lane * dpl + r;
            const bool ok = t < s1 && r < dpl && e < hd;
            kr[q][r] = ok ? to_f32(kc[row + e]) : 0.f;
            vr[q][r] = ok ? to_f32(vc[row + e]) : 0.f;
          }
        }
      }
    };
    const int h = warp == 0 ? a.nq + j : warp == 1 ? a.nq + a.nk + j
                                                   : j * g + warp - 2;
    const T* wn = static_cast<const T*>(warp == 0 ? a.k_norm : a.q_norm) +
                  static_cast<long long>(l) * hd;
    float* hv = sm.hb + warp * hd;
    float v[kR], w[kR], c[kR], sn[kR];
    float ss = 0.f;
#pragma unroll
    for (int t = 0; t < kR; ++t) {
      const int e = lane + 32 * t;
      v[t] = w[t] = c[t] = sn[t] = 0.f;
      if (warp < 2 + g && e < hd) {
        v[t] = round_t(a.qkv[static_cast<long long>(b) * nqkv + h * hd + e],
                       (T*)nullptr);
        w[t] = to_f32(wn[e]);
        c[t] = round_t(a.cos[b * hd + e], (T*)nullptr);
        sn[t] = round_t(a.sin[b * hd + e], (T*)nullptr);
        ss = fmaf(v[t], v[t], ss);
      }
    }
    if (s0 + warp < s1) load(s0 + warp);
    if (warp < 2 + g) {
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
#pragma unroll
      for (int t = 0; t < kR; ++t) {
        const int e = lane + 32 * t;
        if (e < hd) hv[e] = v[t];
      }
    }
    csync();
    if (warp < g) {                          // the current token's scores
      float s = 0.f;
      for (int e = lane; e < hd; e += 32)
        s = fmaf(__fdiv_rn(sm.hb[(2 + warp) * hd + e], rs), sm.hb[e], s);
#pragma unroll
      for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) sm.snew[warp] = s;
    }
    if (ts) a.trace[kTrAttn + 1] = global_ns();
    float qs[kSMaxG][kR], m[kSMaxG], ls[kSMaxG], acc[kSMaxG][kR];
#pragma unroll
    for (int i = 0; i < kSMaxG; ++i) {
      m[i] = kSNeg;
      ls[i] = 0.f;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int e = lane * dpl + r;
        acc[i][r] = 0.f;
        qs[i][r] = i < g && r < dpl && e < hd
                       ? __fdiv_rn(sm.hb[(2 + i) * hd + e], rs) : 0.f;
      }
    }
    for (int t0 = s0 + warp; t0 < s1; t0 += kSWarps * kSAhead) {
      if (t0 != s0 + warp) load(t0);
#pragma unroll
      for (int q = 0; q < kSAhead; ++q) {
        if (t0 + q * kSWarps >= s1) break;     // uniform over the warp
#pragma unroll
        for (int i = 0; i < kSMaxG; ++i) {
          if (i >= g) break;
          float sc = 0.f;
#pragma unroll
          for (int r = 0; r < kR; ++r) sc = fmaf(qs[i][r], kr[q][r], sc);
#pragma unroll
          for (int o = 16; o > 0; o /= 2)
            sc += __shfl_xor_sync(0xffffffffu, sc, o);
          const float mn = fmaxf(m[i], sc);
          const float cf = expf(m[i] - mn), p = expf(sc - mn);
          ls[i] = ls[i] * cf + p;
#pragma unroll
          for (int r = 0; r < kR; ++r)
            acc[i][r] = fmaf(p, vr[q][r], acc[i][r] * cf);
          m[i] = mn;
        }
      }
    }
    // the warps' states, merged in warp order into the unit's state
#pragma unroll
    for (int i = 0; i < kSMaxG; ++i) {
      if (i >= g) break;
      float* wp = sm.wst + (warp * kSMaxG + i) * st;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int e = lane * dpl + r;
        if (r < dpl && e < hd) wp[e] = acc[i][r];
      }
      if (lane == 0) {
        wp[hd] = m[i];
        wp[hd + 1] = ls[i];
      }
    }
    csync();
    if (ts) a.trace[kTrAttn + 2] = global_ns();
    // the unit's state: its warps' states in warp order (two passes: the
    // max, then the rescaled sums); with one split, the row's result
    float* part = a.part + static_cast<long long>(bj * S + sp) * g * st;
    float* att = a.att + static_cast<long long>(b) * a.nq * hd + j * g * hd;
    for (int idx = threadIdx.x; idx < g * hd; idx += kSThreads) {
      const int i = idx / hd, e = idx % hd;
      float mm = kSNeg;
      for (int w = 0; w < kSWarps; ++w)
        mm = fmaxf(mm, sm.wst[(w * kSMaxG + i) * st + hd]);
      float ll = 0.f, aa = 0.f;
      for (int w = 0; w < kSWarps; ++w) {
        const float* wp = sm.wst + (w * kSMaxG + i) * st;
        const float cf = expf(wp[hd] - mm);
        ll = fmaf(wp[hd + 1], cf, ll);
        aa = fmaf(wp[e], cf, aa);
      }
      if (S == 1) {
        att[idx] = s_fold(mm, ll, aa, sm.snew[i], sm.hb[hd + e], (T*)nullptr);
      } else {
        part[i * st + e] = aa;
        if (e == 0) {
          part[i * st + hd] = mm;
          part[i * st + hd + 1] = ll;
        }
      }
    }
    csync();
    if (ts) a.trace[kTrAttn + 3] = global_ns();
    if (S > 1 && threadIdx.x == 0) {
      const bool last = atom_add_acq_rel(a.cnt + bj) == static_cast<unsigned>(
                                                             S - 1);
      if (last) st_relaxed(a.cnt + bj, 0u);
      sm.flag[0] = last;
    }
    csync();
    if (ts) a.trace[kTrAttn + 4] = global_ns();
    if (S == 1 || sm.flag[0]) {
      // the S states in split order, then the current token, last: all
      // S states of a (q head, dim) in flight at once
      const float* p0 = a.part + static_cast<long long>(bj * S) * g * st;
      for (int idx = threadIdx.x; S > 1 && idx < g * hd;
           idx += kSThreads) {
        const int i = idx / hd, e = idx % hd;
        float ms[kSMaxSplits], lv[kSMaxSplits], av[kSMaxSplits];
#pragma unroll
        for (int q = 0; q < kSMaxSplits; ++q) {
          const float* pp = p0 + (q * g + i) * st;
          ms[q] = q < S ? __ldcg(pp + hd) : kSNeg;
          lv[q] = q < S ? __ldcg(pp + hd + 1) : 0.f;
          av[q] = q < S ? __ldcg(pp + e) : 0.f;
        }
        float mm = kSNeg;
#pragma unroll
        for (int q = 0; q < kSMaxSplits; ++q)
          if (q < S) mm = fmaxf(mm, ms[q]);
        float ll = 0.f, aa = 0.f;
#pragma unroll
        for (int q = 0; q < kSMaxSplits; ++q)
          if (q < S) {
            const float cf = expf(ms[q] - mm);
            ll = fmaf(lv[q], cf, ll);
            aa = fmaf(av[q], cf, aa);
          }
        att[idx] = s_fold(mm, ll, aa, sm.snew[i], sm.hb[hd + e], (T*)nullptr);
      }
      // every unit of (b, j) has read the slice: the current k, v at the
      // row's slot
      const int slot = a.slot[b];
      if (slot >= 0 && slot < a.Tc)
        for (int e = threadIdx.x; e < hd; e += kSThreads) {
          store_t(kc + base + static_cast<long long>(slot) * hd + e, sm.hb[e]);
          store_t(vc + base + static_cast<long long>(slot) * hd + e,
                  sm.hb[hd + e]);
        }
    }
    csync();                                 // hb, wst, flag are reused
    if (ts) a.trace[kTrAttn + 5] = global_ns();
  }
}

template <typename T, int kMT>
__global__ void __launch_bounds__(kSBlock, 1) talker_step(StepArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const SSmem<T, kMT> sm = s_carve<T, kMT>(smem_raw, a);
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.nbuf; ++i) {
      mbar_init(sm.full + i);
      mbar_init_count(sm.empty + i, kSWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kSThreads) {            // the producer warp
    if (threadIdx.x == kSThreads) produce<T, kMT>(a, sm);
    return;
  }
  const bool tr = trace_thread(a.trace);
  if (tr) a.trace[kTrT0] = global_ns();
  {                                          // the residual, from x
    const int k0 = static_cast<int>(
        static_cast<long long>(blockIdx.x) * a.H / gridDim.x);
    const int n = static_cast<int>(
        static_cast<long long>(blockIdx.x + 1) * a.H / gridDim.x) - k0;
    const T* x = static_cast<const T*>(a.x);
    for (int i = threadIdx.x; i < a.B * n; i += kSThreads) {
      const int b = i / n, k = k0 + i % n;
      a.xres[b * a.H + k] = to_f32(x[b * a.H + k]);
    }
  }
  int ci = 0, ti = 0;
  unsigned long long waited = 0;
  unsigned long long* btr = kTrace && blockIdx.x == 0 ? a.trace : nullptr;
  unsigned long long next = threadIdx.x == 0 ? grid_count_base(a.bar) : 0;
  auto barrier = [&] {
    grid_barrier_first(a.bar, next, kSThreads, btr, ti);
  };
  for (int l = 0; l < a.L; ++l) {
    s_stage<T, kMT>(a, sm, 4 * l + kSQkv, ci, waited);
    barrier();
    s_attention<T, kMT>(a, sm, l);
    barrier();
    s_stage<T, kMT>(a, sm, 4 * l + kSWo, ci, waited);
    barrier();
    s_stage<T, kMT>(a, sm, 4 * l + kSGu, ci, waited);
    barrier();
    s_stage<T, kMT>(a, sm, 4 * l + kSDown, ci, waited);
    barrier();
  }
  s_stage<T, kMT>(a, sm, 4 * a.L, ci, waited);
  if (tr) {
    a.trace[kTrEnd] = global_ns();
    a.trace[kTrWait] += waited;
    a.trace[kTrWait + 1] += ci;
  }
}

using StepKernel = void (*)(StepArgs);

template <typename T>
StepKernel step_kernel(int mt) {
  if (mt == 1) return talker_step<T, 1>;
  if (mt == 2) return talker_step<T, 2>;
  if constexpr (sizeof(T) > 2) {
    return talker_step<T, 4>;    // f32: at most 4 rows a pass (step_rows)
  } else {
    if (mt == 4) return talker_step<T, 4>;
    return talker_step<T, 8>;
  }
}

StepKernel step_kernel_of(int dtype, int mt) {
  return dtype == 0 ? step_kernel<float>(mt)
                    : step_kernel<__nv_bfloat16>(mt);
}

// x rows a pass (ops/fused_talker.py row_pass): 1, 2, 4, else 8 in bf16
// and 4 in f32, so the staged rows take at most 16 bytes a K element
int step_rows(int B, int tsize) {
  const int mt = B == 1 ? 1 : B == 2 ? 2 : B <= 4 ? 4 : 8;
  return mt * tsize > 16 ? 16 / tsize : mt;
}

bool bad_step(const StepArgs& a, int mt, int tsize) {
  const bool pow2 = a.hd >= 8 && a.hd <= kSMaxHd && !(a.hd & (a.hd - 1));
  int n4 = 0;
  for (int i = 0; i < 5; ++i) {
    if (a.kind[i] < kDense || a.kind[i] > kInt4 ||
        (a.kind[i] != kDense) != (a.sc[i] != nullptr) ||
        (a.kind[i] == kInt4) != (a.m8[i] != nullptr) || a.w[i] == nullptr)
      return true;
    n4 += a.kind[i] == kInt4;
  }
  const int g2 = 2 * kGroup4;
  if (n4 != 0 && (n4 != 5 || a.H % g2 || a.F % g2 || (a.nq * a.hd) % g2))
    return true;
  return a.B < 1 || a.B > kSMaxB || mt != step_rows(a.B, tsize) || a.L < 1 ||
         !pow2 || a.nk < 1 || a.nq % a.nk || a.nq / a.nk > kSMaxG ||
         a.H % kSUnit || a.F % kSUnit || a.V % kSUnit ||
         a.H > kSXPer * kSThreads || a.Tc < 1 || a.S < 1 ||
         a.S > kSMaxSplits || a.chunk < 1024 || a.chunk % 16 ||
         a.nbuf < 2 || a.nbuf > kSMaxRing;
}

}  // namespace

extern "C" {

// out[0] = resident blocks per SM of the kernel (dtype: 0 float32, 1
// bfloat16; mt: x rows a pass, 1, 2, 4 or, in bf16, 8) at `smem` bytes of
// dynamic shared memory, out[1] the device's opt-in shared memory per
// block, out[2] its SM count; returns a cudaError_t.
int talker_step_query(int dtype, int mt, int smem, int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[2], cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > out[1] || (mt != 1 && mt != 2 && mt != 4 && mt != 8) ||
      mt * (dtype == 0 ? 4 : 2) > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const StepKernel kernel = step_kernel_of(dtype, mt);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, kSBlock,
                                                      smem);
  return static_cast<int>(e);
}

// One step: `args` a StepArgs (ops/fused_talker.py _StepArgs), nb blocks
// (SMs x resident blocks), smem = the fixed part + nbuf * chunk.
int talker_step_launch(const void* args, int dtype, int mt, int nb, int smem,
                       void* stream) {
  if (args == nullptr || (dtype != 0 && dtype != 1) || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const StepArgs a = *static_cast<const StepArgs*>(args);
  const int tsize = dtype == 0 ? 4 : 2;
  if (bad_step(a, mt, tsize) ||
      smem != s_fixed(mt, s_kmax(a.H, a.nq, a.hd, a.F), a.hd, tsize) +
                  a.nbuf * a.chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const StepKernel kernel = step_kernel_of(dtype, mt);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb, 1, 1);
  cfg.blockDim = dim3(kSBlock, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"
