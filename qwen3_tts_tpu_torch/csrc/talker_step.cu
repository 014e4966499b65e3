// The talker's whole decode step as one persistent CUDA kernel: 28 layers
// of qkv with attention / wo / gate-up / down, then the final norm and the
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
//   ~0.1 MB a layer per row. At B <= 32 each weight element is used B
//   times, far below the tensor cores' balance point. What a step pays on
//   top is latency: 112 dependent stages, each a grid barrier, its first
//   activation loads and its epilogue, and attention, which reads no
//   weights (PERF.md, the step kernel's trace).
//
// Design (the machinery of predictor_frame.cu, csrc/persistent.cuh):
//   * One cooperative launch, one block per SM: 8 consumer warps and one
//     producer warp. Dependent stages meet at a grid barrier of the
//     consumer threads (named barrier 1, then the counting grid barrier of
//     persistent.cuh); the producer never waits for one.
//   * Four grid barriers a layer (step_barriers: 4 L, 112 at 28 layers;
//     the kernel traps if it meets another count):
//       1. qkv, ln1 its norm prologue, f32 out, THEN attention in the same
//          stage. The qkv columns are grouped by kv head (ops/fused_talker.py
//          group_qkv: head j's g q heads, its k, its v, contiguous), so each
//          block's qkv units touch one or two heads. Once its qkv sums are
//          stored a block counts its units of each head on that head's
//          arrival counter (a release add). The attention units (kv head j,
//          row b, split s), j-major, are dealt over the blocks in the same
//          order, so head j's units land on about the blocks that computed
//          head j's columns; a unit waits on head j's counter alone
//          (acquire), never on the whole grid. The cache slots it reads
//          do not depend on the step: the producer brings them into the L2
//          when it starts the layer's qkv weights, and the unit loads its
//          first ones before the wait;
//       2. wo, added into the residual;
//       3. gate / up, ln2 its prologue (its packed columns interleave each 4
//          gate features with their 4 up features, so a unit's epilogue
//          writes silu(g) * u);
//       4. down, added into the residual.
//     After the last layer: the head, the final norm its prologue; the
//     normed rows are the step's hidden. The head counters count (L)
//     layers' units; block 0 zeroes them after the last barrier, when no
//     block waits on them, so each launch starts from zero.
//   * Split attention. A unit QK-norms and RoPEs the g q heads it scores
//     with (each split its own copy: a unit that publishes them for the
//     others would put one more dependent round trip between qkv and the
//     slots), takes split s of the row's live range [valid_from, min(kv_len,
//     T)) (S from B, nk, the grid and the cache capacity only,
//     ops/fused_talker.py step_splits, never from kv_len) over its warps,
//     and writes its online-softmax state (m, l, acc) to scratch. It counts
//     itself on its (b, j) counter (an acquire-release add); the last of
//     the S units (or the only one) finishes k once a (row, kv head): k and
//     v, T-rounded, went to shared memory at the unit's start, and its warp
//     g QK-norms and RoPEs k; the group's current-token scores follow, the
//     S states
//     merge in split order (the max, then the rescaled sums), the current
//     token folds in last, the T-rounded output goes to the att scratch,
//     and k and v go to the row's slot: every unit of (b, j) has read the
//     slice by then and no later stage reads it (the pre-update contract of
//     qwen3_tts_tpu/ops/fused_talker.py:575-596). The counter resets itself.
//     Which block merges depends on timing; what it computes does not.
//   * One loop over the step's stages calls one stage function, so the
//     stage code is emitted once (predictor_frame.cu's fix of instruction
//     cache misses at every stage).
//   * Work plan: a product's N columns are 8-column units dealt over the
//     blocks in contiguous ranges [blk * U / nb, (blk + 1) * U / nb)
//     (ops/fused_predictor.py split_units). Each output column is computed by
//     one block over the whole K in a fixed order: no K split, no atomics
//     on data, repeats and graph replays are bit-identical.
//   * The weight ring: kSRing buffers of kSChunk bytes, constants shared
//     with the host (ops/fused_talker.py RING, CHUNK); its shared memory
//     comes out of the L1 that caches the spills, so it is no deeper than
//     it measured to pay (PERF.md). The weights are read from a packed copy
//     (each 8-column unit's rows contiguous, ops/fused_predictor.py
//     pack_units), so a block's units of a stage are contiguous. A block
//     takes its units in batches (4 units at one x row, 2 at two, 1 at four
//     or more: 32 or 64 sums a thread) and each batch's rows in chunks of
//     at most kSChunk bytes. The producer's one thread walks the same
//     sequence, stage after stage and layer after layer, copying chunk
//     after chunk with TMA bulk copies, each buffer completing on its
//     "full" mbarrier, under an L2 evict-first policy (the weights are read
//     once a step; the small tensors every stage reads stay); it waits only
//     for a free buffer, which the consumer warps release on its "empty"
//     mbarrier. So the weight stream runs ahead under attention, the
//     barriers and the prologues, as deep as the ring. A consumer thread
//     loads its row of every unit of the batch before any arithmetic, with
//     no branch on the batch's size (a branch per unit had serialised the
//     loads); int8 bytes become floats by i8_cvt. Each stage brings the
//     next stage's norm weight into the L2, and qkv its attention's norm
//     weights and cos / sin.
//   * int4: the kernel's copy pairs adjacent rows in a byte (ops/
//     fused_talker.py pair_int4: row 2r low nibble, 2r + 1 high) and keeps
//     each unit's multipliers [K / 128, 8] in its own rows; the producer
//     copies a chunk's multipliers with its rows (whole pairs of groups)
//     into the buffer's last 64th, so they come from shared memory. A warp
//     takes a group of a chunk (64 packed rows), a lane two of its packed
//     rows; the lane's dot of the group with the biased nibbles less 8 (exact
//     in f32, gemv.cuh unpack4) is multiplied by the group's multiplier once,
//     in f32, as B4 does.
//   * x rows: a row pass stages up to kMT rows (1, 2, 4 or 8 in bf16, at
//     most 4 in f32 or with int4 weights: B > kMT takes ceil(B / kMT)
//     passes over the stage, its weights streamed once a pass) in shared
//     memory in T after their prologue; a thread holds kMT * 8 sums for each
//     unit of a batch, reduced through one warp reduce-scatter per 32 sums
//     and the warps in order.
//   * positions, slot, kv_len and valid_from are device int32 [B]; the grid
//     and the plan depend on shapes only, so the launch replays in a CUDA
//     graph; the counters leave each launch at the state it found them.
//   * A trace, compiled in only with -DKERNEL_TRACE (persistent.cuh kTrace)
//     and on when args.trace is set: every block's consumer thread 0 writes
//     %globaltimer at each grid barrier's arrival and release and sums, per
//     stage kind, the time to its first activation data and its products'
//     phases, attention's phases (the head wait, the q heads, the slots
//     and warp states, the state and count, the merge) and its waits for
//     full buffers; the producer sums its waits for free ones
//     (tools/frame_measure.py talker). args.mode, read in those builds
//     only, cuts the products out (kNoWork: no copies, no sums).
// Scope: T = float or bf16; each of the five weights dense in T or int8
//   with an f32 column scale (mixed too), or all five int4 (biased nibbles,
//   an int8 multiplier per 128-row group and column, an f32 column scale:
//   per group (x . (nib - 8)) * m8 in f32, the order of ops/quant.py
//   panel_matmul4_plain up to the order of the sums); 1 <= B <= 32 (the
//   TPU kernel's `batch <= 32`; the fixed shared part depends on the row
//   pass, not on B, and the attention units, their counters and states are
//   in the workspace, sized B nk S); hd a
//   power of two in [8, 128]; nq / nk <= 4; H <= 2048; H, F, nq * hd, V
//   multiples of 8.

#include "persistent.cuh"

namespace {

constexpr int kSThreads = 256;           // consumer threads
constexpr int kSWarps = kSThreads / 32;
constexpr int kSBlock = kSThreads + 32;  // + the producer warp
constexpr int kSUnit = 8;                // columns of a unit
constexpr int kSMaxB = 32;             // the TPU kernel's batch cap
constexpr int kSMaxMT = 8;
constexpr int kSMaxMT4 = 4;              // x rows a pass with int4 weights
constexpr int kSMaxG = 4;
constexpr int kSMaxHd = 128;
constexpr int kSXPer = 8;                // norm inputs a thread holds
constexpr int kSMaxSplits = 16;
constexpr int kSAhead = 8;               // cache slots a warp loads at once
constexpr int kSPreSlots = 256;          // a unit's slots the producer
                                         // brings into the L2 ahead
constexpr float kSNeg = -1e30f;
// The weight ring (ops/fused_talker.py RING, CHUNK). -DSTEP_RING /
// -DSTEP_CHUNK build a variant for tools/frame_measure.py ring.
#ifndef STEP_RING
#define STEP_RING 4
#endif
#ifndef STEP_CHUNK
#define STEP_CHUNK 16384
#endif
constexpr int kSRing = STEP_RING;
constexpr int kSChunk = STEP_CHUNK;
// a buffer: kSChunk bytes of values, then int4's multipliers (8 bytes a
// group of 64 packed rows and unit: a 64th of the values' bytes)
constexpr int kSBuf = kSChunk + kSChunk / 64;
static_assert(kSRing >= 2 && kSChunk >= 8192 && kSChunk % 1024 == 0,
              "the ring: two buffers, whole int4 groups of 4 units a chunk");
enum { kSQkv = 0, kSWo = 1, kSGu = 2, kSDown = 3, kSHead = 4 };
enum { kDense = 0, kInt8 = 1, kInt4 = 2 };
// args.mode bits (-DKERNEL_TRACE builds only)
enum { kNoWork = 1 };
// trace words (tools/frame_measure.py talker), a block's kTrStride words
// from blk * kTrStride: barrier i's arrival and release at 2 i, 2 i + 1 (i
// < kTrBars); the start, the end, the barriers counted; per stage kind
// (qkv, wo, gu, down, head) the time from its start to its first
// activation data and the calls (kTrFirst + 2 mat + 0..1); the consumers'
// waits for full buffers (time, chunks); the producer's for free ones
// (time, chunks); attention's phases summed over the block's units (the
// head wait, the q heads, the slots and warp states, the state and count,
// the merge) and the units (kTrAttn + 0..5); per stage kind the products
// from their start to the first chunk in, to the last chunk read, to the
// epilogue's end, and the calls (kTrProd + 4 mat + 0..3). The consumers sum
// in shared memory (kTrSums words from kTrFirst) and add the sums into the
// trace at the end.
constexpr int kTrStride = 1024, kTrBars = 448;
constexpr int kTrT0 = 900, kTrEnd = 901, kTrNBar = 902, kTrFirst = 904,
              kTrCWait = 914, kTrPWait = 916, kTrAttn = 918, kTrProd = 924;
constexpr int kTrSums = 40;

// grid barriers a step: 4 a layer (ops/fused_talker.py step_barriers)
__host__ __device__ constexpr int step_barriers(int L) { return 4 * L; }

// ops/fused_talker.py _StepArgs, field for field.
struct StepArgs {
  const void* w[5];       // packed values [L, N / 8, Kp, 8] (head: no L)
  const int8_t* m8[5];    // int4: multipliers [L, N / 8, K / 128, 8]; else null
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
  float* qkv;             // [B, nk (g + 2) hd], grouped by kv head
  float* att;             // [B, nq hd] (T-rounded values)
  float* act;             // [B, F] silu(g) * u (T-rounded values)
  float* part;            // [B nk S][g (hd + 2)] split states
  unsigned* cnt;          // [B nk] split counters
  unsigned* hcnt;         // [nk] head arrival counters
  unsigned long long* bar;  // the grid barrier's arrival count
  unsigned long long* trace;  // null, or nb x kTrStride words
  int kind[5];            // kDense, kInt8, kInt4
  int B, H, L, nq, nk, hd, F, V, Tc, S;
  int mode;               // kNoWork (trace builds only)
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

__host__ __device__ constexpr int s_units_a_batch(int mt) {
  return s_acc(mt) / (mt * kSUnit);
}

// Bytes of a block's shared memory besides the ring (ops/fused_talker.py
// step_smem_fixed): the ring's barriers, the trace's sums, the staged x
// rows, the sums' scratch, the attention unit's head vectors and per-warp
// states.
// the ring's bytes (ops/fused_talker.py ring_bytes)
__host__ __device__ constexpr int s_ring_bytes() { return kSRing * kSBuf; }

__host__ __device__ inline int s_fixed(int mt, int kmax, int hd, int tsize) {
  return 2 * kSRing * 8 + kTrSums * 8 + s_align16(mt * kmax * tsize) +
         4 * (2 * kSWarps * 32 + 64 + kSMaxMT + (5 + kSMaxG) * hd +
              kSWarps * kSMaxG * (hd + 2) + kSMaxG + 4);
}

// rows of a chunk of a batch of nub units (ops/fused_talker.py chunk_rows):
// as many as kSChunk bytes hold, even (whole 16-byte copies); with int4
// whole pairs of groups (128 packed rows: the group's multipliers are 16
// bytes a unit); at most Kp
__host__ __device__ inline int s_chunk_rows(int nub, int wb, int Kp, bool i4) {
  const int r = (kSChunk / (nub * wb)) & (i4 ? ~127 : ~1);
  return r < Kp ? r : Kp;
}

template <typename T, int kMT>
struct SSmem {
  unsigned char* ring;          // [kSRing][kSBuf]
  unsigned long long* full;     // [kSRing]
  unsigned long long* empty;    // [kSRing]
  unsigned long long* tsum;     // [kTrSums] the trace's sums
  T* xs;                        // [kMT][Kmax]
  float* red;                   // [2][kSWarps][32]
  float* outv;                  // [64]
  float* rinv;                  // [kSMaxMT]
  float* hb;                    // [5 + kSMaxG][hd]: q heads, k, v, k's
                                // norm weight, cos, sin
  float* wst;                   // [kSWarps][kSMaxG][hd + 2]
  float* snew;                  // [kSMaxG]
  int* flag;                    // [4]
};

template <typename T, int kMT>
__device__ SSmem<T, kMT> s_carve(unsigned char* base, const StepArgs& a) {
  SSmem<T, kMT> s;
  s.ring = base;
  unsigned char* p = base + s_ring_bytes();
  s.full = reinterpret_cast<unsigned long long*>(p);
  s.empty = s.full + kSRing;
  p += 2 * kSRing * 8;
  s.tsum = reinterpret_cast<unsigned long long*>(p);
  p += kTrSums * 8;
  s.xs = reinterpret_cast<T*>(p);
  p += s_align16(kMT * s_kmax(a.H, a.nq, a.hd, a.F) * sizeof(T));
  s.red = reinterpret_cast<float*>(p);
  s.outv = s.red + 2 * kSWarps * 32;
  s.rinv = s.outv + 64;
  s.hb = s.rinv + kSMaxMT;
  s.wst = s.hb + (5 + kSMaxG) * a.hd;
  s.snew = s.wst + kSWarps * kSMaxG * (a.hd + 2);
  s.flag = reinterpret_cast<int*>(s.snew + kSMaxG);
  return s;
}

__device__ __forceinline__ void csync() { sync_first(kSThreads); }

__device__ __forceinline__ bool no_work(const StepArgs& a) {
  return kTrace && (a.mode & kNoWork) != 0;
}

// this block's trace words, or null
__device__ __forceinline__ unsigned long long* block_trace(const StepArgs& a) {
  return kTrace && a.trace != nullptr
             ? a.trace + static_cast<long long>(blockIdx.x) * kTrStride
             : nullptr;
}

// thread 0's trace sum of word w (kTrFirst <= w < kTrFirst + kTrSums)
template <typename T, int kMT>
__device__ __forceinline__ void tsum_add(const SSmem<T, kMT>& sm, int w,
                                         unsigned long long v) {
  sm.tsum[w - kTrFirst] += v;
}

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

// 8 int8 weights as f32, exact, at the full rate of the integer and float
// pipes (cvt8's conversions run at a quarter of it): each byte, its sign
// bit flipped (b + 128 in [0, 255]), becomes the low mantissa byte of
// 2^23, then 2^23 + 128 comes off
__device__ __forceinline__ void i8_cvt(uint2 q, float* w) {
  const unsigned lo = q.x ^ 0x80808080u, hi = q.y ^ 0x80808080u;
  constexpr float kBias = 8388736.f;         // 2^23 + 128
  w[0] = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7540)) - kBias;
  w[1] = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7541)) - kBias;
  w[2] = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7542)) - kBias;
  w[3] = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7543)) - kBias;
  w[4] = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7540)) - kBias;
  w[5] = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7541)) - kBias;
  w[6] = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7542)) - kBias;
  w[7] = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7543)) - kBias;
}

// the first unit of `units` dealt over nb blocks that block blk owns
__device__ __forceinline__ int unit_lo(int units, int blk) {
  return static_cast<int>(static_cast<long long>(blk) * units / gridDim.x);
}

// ---------------------------------------------------------------- stages
// A weight stage: x width K, packed weight rows Kp (K / 2 for int4), N
// columns, bytes of a unit row (8 columns), the element offsets of its
// layer in the packed values, the scales and the int4 multipliers, the
// block's units [u0, u0 + nu).
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
  d.u0 = unit_lo(U, blockIdx.x);
  d.nu = unit_lo(U, blockIdx.x + 1) - d.u0;
  return d;
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
  __device__ bool i4() const { return d.kind == kInt4; }
  __device__ int nub() const { return min(kUB, d.nu - ul); }
  __device__ int rows() const {
    return s_chunk_rows(nub(), d.wb, d.Kp, i4());
  }
  // the chunk's rows, and unit i's sources: values, int4 multipliers
  __device__ int rn() const { return min(rows(), d.Kp - r0); }
  __device__ const char* src(int i) const {
    return g + (static_cast<long long>(d.u0 + ul + i) * d.Kp + r0) * d.wb;
  }
  __device__ const int8_t* msrc(int i) const {
    return a->m8[d.mat] + d.moff +
           (static_cast<long long>(d.u0 + ul + i) * (d.K / kGroup4) +
            r0 / kG4Rows) * kSUnit;
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

// The block's attention units' cache slices of layer l (each unit's split
// of its row's live range, at most kSPreSlots slots of k and of v) into
// the L2, issued by the producer as it starts layer l's qkv weights, some
// us before the units read them (a slice from the device memory took ~3
// us a unit under the weight stream; PERF.md, the step kernel's trace).
template <typename T>
__device__ void prefetch_slices(const StepArgs& a, int l) {
  const int S = a.S, B = a.B, hd = a.hd;
  const int U = a.nk * B * S;
  const int u1 = unit_lo(U, blockIdx.x + 1);
  for (int u = unit_lo(U, blockIdx.x); u < u1; ++u) {
    const int j = u / (B * S), b = u / S % B, sp = u % S;
    // read-only inputs through the non-coherent cache: after the first
    // layer these hit in it, so the producer does not stall a layer
    const int lo = max(__ldg(a.valid_from + b), 0);
    const int hi = min(__ldg(a.kv_len + b), a.Tc);
    const int per = (max(hi - lo, 0) + S - 1) / S;
    const int s0 = lo + sp * per;
    const int s1 = min(min(s0 + per, hi), s0 + kSPreSlots);
    if (s1 <= s0) continue;
    const long long off =
        ((((static_cast<long long>(l) * B + b) * a.nk + j) * a.Tc) + s0) * hd;
    const unsigned bytes = static_cast<unsigned>((s1 - s0) * hd * sizeof(T));
    bulk_prefetch_l2(static_cast<const T*>(a.kc) + off, bytes);
    bulk_prefetch_l2(static_cast<const T*>(a.vc) + off, bytes);
  }
}

// The producer (lane 0 of the block's last warp): every chunk of the step
// in the consumers' order, each into ring buffer ci % kSRing once the
// consumers have released its last use: unit i's rows at i rn wb, int4's
// multipliers at kSChunk + i rn / 8. The copies evict first from the L2
// (the weights are read once a step). At a layer's first qkv chunk it
// brings the block's attention slices of the cache into the L2.
template <typename T, int kMT>
__device__ void produce(const StepArgs& a, const SSmem<T, kMT>& sm) {
  if (no_work(a)) return;
  unsigned long long* tb = block_trace(a);
  unsigned long long waited = 0;
  ChunkWalk<T, kMT> cw;
  cw.start(a);
  const unsigned long long policy = evict_first_policy();
  int ci = 0, stage = -1;
  for (; !cw.done; cw.advance(), ++ci) {
    const int b = ci % kSRing;
    if (cw.s != stage) {                     // a stage's first chunk
      stage = cw.s;
      if (cw.d.mat == kSQkv) prefetch_slices<T>(a, cw.d.layer);
    }
    if (ci >= kSRing) {
      const unsigned long long t0 = tb != nullptr ? global_ns() : 0;
      mbar_wait(sm.empty + b, ((ci / kSRing) - 1) & 1);
      if (tb != nullptr) waited += global_ns() - t0;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const int rn = cw.rn(), nub = cw.nub();
    const bool i4 = cw.i4();
    const unsigned vb = static_cast<unsigned>(rn * cw.d.wb);
    const unsigned mb = i4 ? static_cast<unsigned>(rn / 8) : 0u;
    mbar_expect(sm.full + b, (vb + mb) * nub);
    unsigned char* dst = sm.ring + static_cast<long long>(b) * kSBuf;
    for (int i = 0; i < nub; ++i) {
      bulk_copy_hint(dst + i * vb, cw.src(i), vb, sm.full + b, policy);
      if (i4)
        bulk_copy_hint(dst + kSChunk + i * mb, cw.msrc(i), mb, sm.full + b,
                       policy);
    }
  }
  if (tb != nullptr) {
    tb[kTrPWait] += waited;
    tb[kTrPWait + 1] += ci;
  }
}

// ---------------------------------------------------------------- prologues
// The norm stages' inputs of row pass rc into xs (predictor_frame.cu's
// stage_norm, for up to 8 rows): every thread loads its columns k = t +
// 256 q of the rows (the residual, or the step's input at layer 0) and of
// the norm weight at once, sums the squares in order, the rows' sums
// reduce through the warp's butterfly and the warps in order, and each
// value is normed and rounded once: T(x * rsqrt(mean(x^2) + eps) * w).
// `first`: thread 0's stamp once its loads are in.
template <typename T, int kMT, typename Mark>
__device__ void s_norm(const StepArgs& a, const SSmem<T, kMT>& sm,
                       const T* ln, bool source, int c0, int mt,
                       Mark&& first) {
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
    if (m == 0) first();
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
template <typename T, int kMT, typename Mark>
__device__ void s_plain(const SSmem<T, kMT>& sm, const float* src, int K,
                        int c0, int mt, Mark&& first) {
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
    if (k0 == static_cast<int>(threadIdx.x)) first();
  }
}

// 32 sums of a warp reduced and scattered at once (at each butterfly step
// a lane keeps one half of its values and adds its partner's copy of that
// half: 31 shuffles), lane l ending with sum l of v[32 kH .. 32 kH + 31]
template <int kAcc, int kH>
__device__ __forceinline__ float s_scatter(float (&v)[kAcc], int lane) {
  float* w = v + kH * 32;          // in place: the sums are spent after
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

// A product stage of row pass [c0, c0 + mt): the block's units in batches,
// each batch's rows chunk by chunk from the ring (ci counts the chunks as
// the producer does), then the batch's sums reduced over the block and the
// stage's epilogue. Dense and int8: a thread a row of the chunk (int8's
// bytes converted by i8_cvt, its column scale in the epilogue). int4: a
// warp a group of the chunk, a lane two of its packed rows (four weight
// rows); the lane's dot with the nibbles less 8, then times the group's
// multiplier, once.
template <typename T, int kMT, int kKind>
__device__ void s_product(const StepArgs& a, const SSmem<T, kMT>& sm,
                          const SGeom& d, int c0, int mt, int& ci,
                          unsigned long long* tb) {
  using W = typename std::conditional<kKind == kDense, T, int8_t>::type;
  constexpr int kAcc = s_acc(kMT);
  constexpr int kUB = s_units_a_batch(kMT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool tr = tb != nullptr && threadIdx.x == 0;
  const bool work = !no_work(a);
  const int K = d.K, Kp = d.Kp;
  const float* scale = a.sc[d.mat] == nullptr ? nullptr : a.sc[d.mat] + d.soff;
  unsigned long long waited = 0, tp1 = 0, tp2 = 0;
  const unsigned long long tp0 = tr ? global_ns() : 0;
  int chunks = 0;
  for (int ul = 0; ul < d.nu; ul += kUB) {
    const int nub = min(kUB, d.nu - ul);
    const int R = s_chunk_rows(nub, d.wb, Kp, kKind == kInt4);
    float v[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) v[i] = 0.f;
    for (int r0 = 0; work && r0 < Kp; r0 += R, ++ci) {
      const int rn = min(R, Kp - r0);
      const int ustride = rn * d.wb;       // a unit's rows in the buffer
      const int b = ci % kSRing;
      const unsigned long long t0 = tr ? global_ns() : 0;
      mbar_wait(sm.full + b, (ci / kSRing) & 1);
      if (tr) {
        const unsigned long long t1 = global_ns();
        waited += t1 - t0;
        if (chunks++ == 0) tp1 = t1;
      }
      const unsigned char* buf = sm.ring + static_cast<long long>(b) * kSBuf;
      if constexpr (kKind != kInt4) {
        for (int r = threadIdx.x; r < rn; r += kSThreads) {
          const int k = r0 + r;
          // every unit's row loaded before any arithmetic, without
          // branches: past nub the last unit again (its sums unused)
          Raw<W> raw[kUB];
#pragma unroll
          for (int ub = 0; ub < kUB; ++ub)
            raw[ub] = ld_sm(reinterpret_cast<const W*>(
                buf + min(ub, nub - 1) * ustride + r * d.wb));
          float xv[kMT];
#pragma unroll
          for (int m = 0; m < kMT; ++m) xv[m] = to_f32(sm.xs[m * K + k]);
#pragma unroll
          for (int ub = 0; ub < kUB; ++ub) {
            float wv[kSUnit];
            if constexpr (kKind == kInt8)
              i8_cvt(raw[ub].a, wv);
            else
              cvt8(raw[ub], wv);
#pragma unroll
            for (int m = 0; m < kMT; ++m)
#pragma unroll
              for (int j = 0; j < kSUnit; ++j) {
                float& acc = v[(ub * kMT + m) * kSUnit + j];
                acc = fmaf(xv[m], wv[j], acc);
              }
          }
        }
      } else if constexpr (kMT <= kSMaxMT4) {
        int4_chunk<T, kMT, kUB, kAcc, kSWarps>(buf, buf + kSChunk, rn, nub,
                                               sm.xs, K, r0, v);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty + b);    // the buffer is free
    }
    if (tr) tp2 = global_ns();
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
  if (tr) {
    tsum_add(sm, kTrCWait, waited);
    tsum_add(sm, kTrCWait + 1, chunks);
    const int w = kTrProd + 4 * d.mat;
    tsum_add(sm, w, (chunks > 0 ? tp1 : tp2) - tp0);
    tsum_add(sm, w + 1, tp2 - tp0);
    tsum_add(sm, w + 2, global_ns() - tp0);
    tsum_add(sm, w + 3, 1);
  }
}

// ---------------------------------------------------------------- attention
// One head vector of a warp (lane holds dims e = lane + 32 r, already
// T-rounded): QK-norm and rotate-half RoPE, one rounding each (gemv.cuh
// qk_finish's arithmetic); the partner dims e ^ hd / 2 through hv.
template <typename T>
__device__ __forceinline__ void s_norm_rope(float (&v)[kSMaxHd / 32],
                                            const float (&w)[kSMaxHd / 32],
                                            const float (&c)[kSMaxHd / 32],
                                            const float (&sn)[kSMaxHd / 32],
                                            float* hv, int hd, float eps) {
  constexpr int kR = kSMaxHd / 32;
  const int lane = threadIdx.x % 32, half = hd / 2;
  float ss = 0.f;
#pragma unroll
  for (int r = 0; r < kR; ++r) ss = fmaf(v[r], v[r], ss);
#pragma unroll
  for (int o = 16; o > 0; o /= 2) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float rr = rsqrtf(ss / static_cast<float>(hd) + eps);
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int e = lane + 32 * r;
    if (e < hd) {
      v[r] = round_t(v[r] * rr * w[r], (T*)nullptr);
      hv[e] = v[r];
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int e = lane + 32 * r;
    if (e < hd) {
      const float pr = hv[e ^ half];
      const float rot = e < half ? -pr : pr;
      v[r] = round_t(__fadd_rn(__fmul_rn(v[r], c[r]), __fmul_rn(rot, sn[r])),
                     (T*)nullptr);
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int e = lane + 32 * r;
    if (e < hd) hv[e] = v[r];
  }
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

// qkv units of kv head group j a layer: (g + 2) hd / 8
__device__ __forceinline__ int group_units(const StepArgs& a) {
  return (a.nq / a.nk + 2) * a.hd / kSUnit;
}

// The block's qkv units of layer l are stored: count them on each group's
// arrival counter (a release add; after the caller's block sync).
__device__ __forceinline__ void s_arrive(const StepArgs& a, const SGeom& d) {
  if (threadIdx.x != 0 || d.nu == 0) return;
  const int ug = group_units(a);
  for (int j = d.u0 / ug; j * ug < d.u0 + d.nu; ++j) {
    const int lo = max(d.u0, j * ug), hi = min(d.u0 + d.nu, (j + 1) * ug);
    red_release_add(a.hcnt + j, static_cast<unsigned>(hi - lo));
  }
}

// Attention of layer l for the block's units (kv head j, row b, split s),
// j-major. Per unit: the warps' first cache slots in flight; the wait for
// head j's qkv columns (layer l's count on its counter); a warp per q head
// of the group rounds it to T, QK-norms and RoPEs it, warps g and g + 1
// load k and v raw (finished by the merging unit only); the warps take the
// split's slots round robin, kSAhead at once, each with its own online
// softmax in f32 (a lane holds hd / 32 contiguous dims); the warps' states
// merge in warp order into the unit's state. With S > 1 the state goes to
// scratch and the unit counts itself; the last unit of (b, j), or the only
// one, finishes k and v, the current token's scores, merges, folds in the
// current token and stores k and v at the row's slot.
template <typename T, int kMT>
__device__ void s_attention(const StepArgs& a, const SSmem<T, kMT>& sm,
                            int l, unsigned long long* tb) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hd = a.hd, g = a.nq / a.nk, S = a.S, B = a.B;
  const int gw = (g + 2) * hd;                 // a group's qkv columns
  const int U = a.nk * B * S;
  const int st = hd + 2;                       // a state: acc[hd], m, l
  const float rs = sqrtf(static_cast<float>(hd));
  constexpr int kR = kSMaxHd / 32;
  const int dpl = hd >= 32 ? hd / 32 : 1;      // a lane's contiguous dims
  const bool tr = tb != nullptr && threadIdx.x == 0;
  const unsigned want = static_cast<unsigned>(group_units(a) * (l + 1));
  T* kc = static_cast<T*>(a.kc);
  T* vc = static_cast<T*>(a.vc);
  int ready = -1;                              // the group waited for
  const int u1 = unit_lo(U, blockIdx.x + 1);
  for (int u = unit_lo(U, blockIdx.x); u < u1; ++u) {
    const int j = u / (B * S), b = u / S % B, sp = u % S;
    const int bj = b * a.nk + j;
    const long long base =
        ((static_cast<long long>(l) * B + b) * a.nk + j) * a.Tc * hd;
    unsigned long long tp = tr ? global_ns() : 0;
    auto phase = [&](int w) {                // the trace's phase w ends
      if (tr) {
        const unsigned long long now = global_ns();
        tsum_add(sm, kTrAttn + w, now - tp);
        tp = now;
      }
    };
    // this unit's share of the row's live range, and the warp's first
    // slots' keys and values in flight under the wait and the head vectors
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
    if (s0 + warp < s1) load(s0 + warp);
    if (j != ready) {                          // head j's qkv columns
      if (threadIdx.x == 0) {
        if (ld_acquire32(a.hcnt + j) < want) {
          const unsigned long long w0 = global_ns();
          unsigned spins = 0;
          while (ld_acquire32(a.hcnt + j) < want)
            if ((++spins & 1023u) == 0 && global_ns() - w0 > kSpinLimitNs)
              __trap();
        }
      }
      csync();
      ready = j;
    }
    phase(0);
    // warp i < g: q head i of the group, QK-normed and RoPEd; warps g and
    // g + 1 put k and v (T-rounded) and k's norm weight, cos and sin in
    // hb for the merge
    {
      const float* row =
          a.qkv + static_cast<long long>(b) * a.nk * gw + j * gw;
      const T* wn = static_cast<const T*>(warp == g ? a.k_norm : a.q_norm) +
                    static_cast<long long>(l) * hd;
      float hv[kR], w[kR], c[kR], sn[kR];
#pragma unroll
      for (int t = 0; t < kR; ++t) {
        const int e = lane + 32 * t;
        const bool ok = warp < g + 2 && e < hd;
        hv[t] = ok ? round_t(row[warp * hd + e], (T*)nullptr) : 0.f;
        w[t] = ok && warp <= g ? to_f32(wn[e]) : 0.f;
        c[t] = ok && warp <= g ? round_t(a.cos[b * hd + e], (T*)nullptr)
                               : 0.f;
        sn[t] = ok && warp <= g ? round_t(a.sin[b * hd + e], (T*)nullptr)
                                : 0.f;
      }
      if (warp < g) {
        s_norm_rope<T>(hv, w, c, sn, sm.hb + warp * hd, hd, a.eps);
      } else if (warp < g + 2) {
#pragma unroll
        for (int t = 0; t < kR; ++t) {
          const int e = lane + 32 * t;
          if (e < hd) {
            sm.hb[warp * hd + e] = hv[t];
            if (warp == g) {
              sm.hb[(g + 2) * hd + e] = w[t];
              sm.hb[(g + 3) * hd + e] = c[t];
              sm.hb[(g + 4) * hd + e] = sn[t];
            }
          }
        }
      }
    }
    csync();
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
                       ? __fdiv_rn(sm.hb[i * hd + e], rs) : 0.f;
      }
    }
    phase(1);
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
    // the warps' states, for the merge in warp order
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
    phase(2);
    float* att = a.att + static_cast<long long>(b) * a.nq * hd + j * g * hd;
    bool merge = true;
    if (S > 1) {
      // the unit's state: its warps' states in warp order (the max, then
      // the rescaled sums), then the count
      float* part = a.part + static_cast<long long>(bj * S + sp) * g * st;
      for (int idx = threadIdx.x; idx < g * hd; idx += kSThreads) {
        const int i = idx / hd, e = idx % hd;
        float mm = kSNeg;
        for (int w2 = 0; w2 < kSWarps; ++w2)
          mm = fmaxf(mm, sm.wst[(w2 * kSMaxG + i) * st + hd]);
        float ll = 0.f, aa = 0.f;
        for (int w2 = 0; w2 < kSWarps; ++w2) {
          const float* wp = sm.wst + (w2 * kSMaxG + i) * st;
          const float cf = expf(wp[hd] - mm);
          ll = fmaf(wp[hd + 1], cf, ll);
          aa = fmaf(wp[e], cf, aa);
        }
        part[i * st + e] = aa;
        if (e == 0) {
          part[i * st + hd] = mm;
          part[i * st + hd + 1] = ll;
        }
      }
      csync();
      if (threadIdx.x == 0) {
        const bool last = atom_add_acq_rel(a.cnt + bj) ==
                          static_cast<unsigned>(S - 1);
        if (last) st_relaxed(a.cnt + bj, 0u);
        sm.flag[0] = last;
      }
      csync();
      merge = sm.flag[0] != 0;
    }
    phase(3);
    if (merge) {
      // k, once a (row, kv head): QK-normed and RoPEd in place (v is
      // final as loaded)
      if (warp == g) {
        float hv[kR], w[kR], c[kR], sn[kR];
#pragma unroll
        for (int t = 0; t < kR; ++t) {
          const int e = lane + 32 * t;
          const bool ok = e < hd;
          hv[t] = ok ? sm.hb[g * hd + e] : 0.f;
          w[t] = ok ? sm.hb[(g + 2) * hd + e] : 0.f;
          c[t] = ok ? sm.hb[(g + 3) * hd + e] : 0.f;
          sn[t] = ok ? sm.hb[(g + 4) * hd + e] : 0.f;
        }
        __syncwarp();
        s_norm_rope<T>(hv, w, c, sn, sm.hb + g * hd, hd, a.eps);
      }
      csync();
      if (warp < g) {                          // the current token's scores
        float s = 0.f;
        for (int e = lane; e < hd; e += 32)
          s = fmaf(__fdiv_rn(sm.hb[warp * hd + e], rs), sm.hb[g * hd + e], s);
#pragma unroll
        for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) sm.snew[warp] = s;
      }
      csync();
      // the states in order (the warps' with one split, else the S
      // splits' from scratch, all of a (q head, dim) in flight at once),
      // then the current token, last
      const float* p0 = a.part + static_cast<long long>(bj * S) * g * st;
      for (int idx = threadIdx.x; idx < g * hd; idx += kSThreads) {
        const int i = idx / hd, e = idx % hd;
        float mm = kSNeg, ll = 0.f, aa = 0.f;
        if (S == 1) {
          for (int w2 = 0; w2 < kSWarps; ++w2)
            mm = fmaxf(mm, sm.wst[(w2 * kSMaxG + i) * st + hd]);
          for (int w2 = 0; w2 < kSWarps; ++w2) {
            const float* wp = sm.wst + (w2 * kSMaxG + i) * st;
            const float cf = expf(wp[hd] - mm);
            ll = fmaf(wp[hd + 1], cf, ll);
            aa = fmaf(wp[e], cf, aa);
          }
        } else {
          float ms[kSMaxSplits], lv[kSMaxSplits], av[kSMaxSplits];
#pragma unroll
          for (int q = 0; q < kSMaxSplits; ++q) {
            const float* pp = p0 + (q * g + i) * st;
            ms[q] = q < S ? __ldcg(pp + hd) : kSNeg;
            lv[q] = q < S ? __ldcg(pp + hd + 1) : 0.f;
            av[q] = q < S ? __ldcg(pp + e) : 0.f;
          }
#pragma unroll
          for (int q = 0; q < kSMaxSplits; ++q)
            if (q < S) mm = fmaxf(mm, ms[q]);
#pragma unroll
          for (int q = 0; q < kSMaxSplits; ++q)
            if (q < S) {
              const float cf = expf(ms[q] - mm);
              ll = fmaf(lv[q], cf, ll);
              aa = fmaf(av[q], cf, aa);
            }
        }
        att[idx] = s_fold(mm, ll, aa, sm.snew[i], sm.hb[(g + 1) * hd + e],
                          (T*)nullptr);
      }
      // every unit of (b, j) has read the slice: the current k, v at the
      // row's slot
      const int slot = a.slot[b];
      if (slot >= 0 && slot < a.Tc)
        for (int e = threadIdx.x; e < hd; e += kSThreads) {
          store_t(kc + base + static_cast<long long>(slot) * hd + e,
                  sm.hb[g * hd + e]);
          store_t(vc + base + static_cast<long long>(slot) * hd + e,
                  sm.hb[(g + 1) * hd + e]);
        }
    }
    csync();                                 // hb, wst, flag are reused
    phase(4);
    if (tr) tsum_add(sm, kTrAttn + 5, 1);
  }
}

// Lines of n bytes from p into the L2 ahead of their first loads: thread
// t0 + i brings line i
__device__ __forceinline__ void prefetch_lines(const void* p, int n, int t0) {
  const int i = static_cast<int>(threadIdx.x) - t0;
  if (i >= 0 && i * 128 < n)
    prefetch_l2(static_cast<const char*>(p) + i * 128);
}

// At the start of stage s: the next stage's norm weight (ln1, ln2 or the
// final norm) and, with qkv, this layer's q / k norm weights and the rows'
// cos / sin, which its attention reads.
template <typename T>
__device__ __forceinline__ void s_prefetch(const StepArgs& a, int s,
                                           const SGeom& d) {
  const int nb = a.H * static_cast<int>(sizeof(T));
  const int m = s + 1 == 4 * a.L ? kSHead : (s + 1) % 4;
  const T* next = m == kSQkv ? static_cast<const T*>(a.ln1) + (s + 1) / 4 * a.H
                  : m == kSGu ? static_cast<const T*>(a.ln2) + (s + 1) / 4 * a.H
                  : m == kSHead ? static_cast<const T*>(a.final_norm)
                                : nullptr;
  if (s < 4 * a.L && next != nullptr) prefetch_lines(next, nb, 0);
  if (d.mat == kSQkv) {
    const int hb = a.hd * static_cast<int>(sizeof(T));
    const long long lo = static_cast<long long>(d.layer) * a.hd;
    prefetch_lines(static_cast<const T*>(a.q_norm) + lo, hb, 128);
    prefetch_lines(static_cast<const T*>(a.k_norm) + lo, hb, 160);
    prefetch_lines(a.cos, a.B * a.hd * 4, 192);
    prefetch_lines(a.sin, a.B * a.hd * 4, 224);
  }
}

// A stage of the step: per row pass, the prologue into xs (the head's also
// gives the step's hidden: each block stores its share of the columns),
// then the product of the weight's kind; after qkv's last row pass, the
// block's arrivals on the head counters and its attention units.
template <typename T, int kMT>
__device__ void s_stage(const StepArgs& a, const SSmem<T, kMT>& sm, int s,
                        int& ci, unsigned long long* tb) {
  const SGeom d = s_geom<T>(a, s);
  const bool tr = tb != nullptr && threadIdx.x == 0;
  const unsigned long long t0 = tr ? global_ns() : 0;
  s_prefetch<T>(a, s, d);
  const T* ln = static_cast<const T*>(
      d.mat == kSQkv ? a.ln1 : d.mat == kSGu ? a.ln2 : a.final_norm);
  if (d.mat != kSHead) ln += static_cast<long long>(d.layer) * a.H;
  for (int c0 = 0; c0 < a.B && (d.nu > 0 || d.mat == kSHead); c0 += kMT) {
    const int mt = min(kMT, a.B - c0);
    auto first = [&] {
      if (tr && c0 == 0) {
        tsum_add(sm, kTrFirst + 2 * d.mat, global_ns() - t0);
        tsum_add(sm, kTrFirst + 2 * d.mat + 1, 1);
      }
    };
    if (d.mat == kSQkv || d.mat == kSGu || d.mat == kSHead)
      s_norm<T, kMT>(a, sm, ln, d.mat == kSQkv && d.layer == 0, c0, mt,
                     first);
    else
      s_plain<T, kMT>(sm, d.mat == kSDown ? a.act : a.att, d.K, c0, mt, first);
    csync();
    if (d.mat == kSHead) {
      const int k0 = unit_lo(a.H, blockIdx.x);
      const int k1 = unit_lo(a.H, blockIdx.x + 1);
      T* hid = static_cast<T*>(a.hidden);
      for (int i = threadIdx.x; i < mt * (k1 - k0); i += kSThreads) {
        const int m = i / (k1 - k0), k = k0 + i % (k1 - k0);
        hid[static_cast<long long>(c0 + m) * a.H + k] = sm.xs[m * a.H + k];
      }
    }
    switch (d.kind) {
      case kInt8:
        s_product<T, kMT, kInt8>(a, sm, d, c0, mt, ci, tb);
        break;
      case kInt4:
        s_product<T, kMT, kInt4>(a, sm, d, c0, mt, ci, tb);
        break;
      default:
        s_product<T, kMT, kDense>(a, sm, d, c0, mt, ci, tb);
    }
  }
  if (d.mat == kSQkv) {
    csync();              // the block's qkv stores, then its arrivals
    s_arrive(a, d);
    s_attention<T, kMT>(a, sm, d.layer, tb);
  }
}

template <typename T, int kMT>
__global__ void __launch_bounds__(kSBlock, 1) talker_step(StepArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const SSmem<T, kMT> sm = s_carve<T, kMT>(smem_raw, a);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kSRing; ++i) {
      mbar_init(sm.full + i);
      mbar_init_count(sm.empty + i, kSWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; kTrace && i < kTrSums; ++i) sm.tsum[i] = 0;
  }
  __syncthreads();
  if (threadIdx.x >= kSThreads) {            // the producer warp
    if (threadIdx.x == kSThreads) produce<T, kMT>(a, sm);
    return;
  }
  unsigned long long* tb = block_trace(a);
  if (tb != nullptr && threadIdx.x == 0) tb[kTrT0] = global_ns();
  {                                          // the residual, from x
    const int k0 = unit_lo(a.H, blockIdx.x);
    const int n = unit_lo(a.H, blockIdx.x + 1) - k0;
    const T* x = static_cast<const T*>(a.x);
    for (int i = threadIdx.x; i < a.B * n; i += kSThreads) {
      const int b = i / n, k = k0 + i % n;
      a.xres[b * a.H + k] = to_f32(x[b * a.H + k]);
    }
  }
  int ci = 0, ti = 0;
  unsigned long long next = threadIdx.x == 0 ? grid_count_base(a.bar) : 0;
  // one loop over the step's stages, so that the stage code is compiled
  // once; a grid barrier after each but the head
  const int n = 4 * a.L + 1;
#pragma unroll 1
  for (int s = 0; s < n; ++s) {
    s_stage<T, kMT>(a, sm, s, ci, tb);
    if (s + 1 < n)
      grid_barrier_first(a.bar, next, kSThreads, ti < kTrBars ? tb : nullptr,
                         ti);
  }
  if (ti != step_barriers(a.L)) __trap();    // the host counts the same
  // past the last barrier no block waits on a head counter: ready for the
  // next launch
  if (blockIdx.x == 0 && threadIdx.x < a.nk)
    st_relaxed(a.hcnt + threadIdx.x, 0u);
  if (tb != nullptr && threadIdx.x == 0) {
    tb[kTrEnd] = global_ns();
    tb[kTrNBar] = ti;
    for (int i = 0; i < kTrSums; ++i)      // the producer adds its own
      if (kTrFirst + i != kTrPWait && kTrFirst + i != kTrPWait + 1)
        tb[kTrFirst + i] += sm.tsum[i];
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
// and 4 in f32, so the staged rows take at most 16 bytes a K element; at
// most 4 with int4 weights
int step_rows(int B, int tsize, bool i4) {
  int mt = B == 1 ? 1 : B == 2 ? 2 : B <= 4 ? 4 : 8;
  if (mt * tsize > 16) mt = 16 / tsize;
  return i4 && mt > kSMaxMT4 ? kSMaxMT4 : mt;
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
  return a.B < 1 || a.B > kSMaxB || mt != step_rows(a.B, tsize, n4 != 0) ||
         a.L < 1 || 4 * a.L > kTrBars || !pow2 || a.nk < 1 || a.nq % a.nk ||
         a.nq / a.nk > kSMaxG || a.H % kSUnit || a.F % kSUnit ||
         a.V % kSUnit || a.H > kSXPer * kSThreads || a.Tc < 1 || a.S < 1 ||
         a.S > kSMaxSplits || a.hcnt == nullptr || a.cnt == nullptr;
}

}  // namespace

extern "C" {

// out[0] = resident blocks per SM of the kernel (dtype: 0 float32, 1
// bfloat16; mt: x rows a pass, 1, 2, 4 or, in bf16, 8) at `smem` bytes of
// dynamic shared memory, out[1] the device's opt-in shared memory per
// block, out[2] its SM count, out[3] and out[4] the ring's buffers and
// bytes a buffer as compiled; returns a cudaError_t.
int talker_step_query(int dtype, int mt, int smem, int* out) {
  int dev = 0;
  out[3] = kSRing;
  out[4] = kSChunk;
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
// (SMs x resident blocks), smem = the fixed part + the ring's bytes.
int talker_step_launch(const void* args, int dtype, int mt, int nb, int smem,
                       void* stream) {
  if (args == nullptr || (dtype != 0 && dtype != 1) || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const StepArgs a = *static_cast<const StepArgs*>(args);
  const int tsize = dtype == 0 ? 4 : 2;
  if (bad_step(a, mt, tsize) ||
      smem != s_fixed(mt, s_kmax(a.H, a.nq, a.hd, a.F), a.hd, tsize) +
                  s_ring_bytes())
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
