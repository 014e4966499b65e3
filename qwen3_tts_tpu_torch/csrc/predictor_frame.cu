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
//   dense bf16, 1.06 ms at 3.35 TB/s; half of it int8, about a quarter
//   int4 (its multipliers a 64th more). At B <= 16 each
//   weight element is used B times, far below the tensor cores' balance
//   point. What a frame pays on top is latency: 527 dependent stages, each
//   a grid barrier, its first activation loads and its epilogue (measured
//   on the H100: ~9 us a stage against ~2 us of its bytes; PERF.md).
//
// Design:
//   * One cooperative launch, one block per SM: 8 consumer warps and one
//     producer warp. Dependent stages meet at a grid barrier of the
//     consumer threads (named barrier 1, then a counting barrier: every
//     block adds one to a 64-bit arrival count that never resets, with
//     release semantics and no returned value, and spins with acquire loads
//     until the count reaches its next multiple of the grid; the base is
//     read at the start, when the first barrier cannot have completed).
//     It needs no memset per launch, so the kernel replays in a CUDA graph.
//     A wait longer than kSpinLimitNs traps (an error, never a hang).
//   * Four grid barriers a layer pass:
//       1. qkv, the ln1 norm its prologue, f32 out to scratch. Layer 0 of
//          a pass reads its input row from the source (h1024 at pass 0,
//          else the ptab row of the last code) and each block writes its
//          share of the residual from it;
//       2. wo, with attention as its prologue: every block that holds wo
//          columns computes the attention output of every (row, kv head)
//          it needs itself, a warp a unit (the k / v / q heads rounded to
//          T, QK-norm and RoPE, slots [0, p) of the frame cache and the
//          current token), straight into its staged x rows (at B = 1 each
//          of 128 blocks reads the same 8 KB x p of cache); the block that
//          owns wo unit (b nk + j) mod (H / 8) stores k and v at slot p.
//          Added into the residual;
//       3. gate / up with the ln2 norm, f32 out;
//       4. down with silu(g) * u as its prologue, added into the residual.
//     After a pass p >= 1, the head stage: the final norm, the product over
//     slice p - 1, each block's logits reduced to a per-row (max, index)
//     partial. After the barrier every block reduces the partials (the
//     order does not matter: the comparison is a total order), block 0
//     writes codes[:, p], and each block gathers the ptab row itself in
//     the next pass's layer 0. 64 L + 15 barriers a frame (527 at L = 8).
//   * Work plan: a stage's N columns are 8-column units, dealt over the
//     blocks in contiguous ranges [blk * U / nb, (blk + 1) * U / nb) (the
//     same formula as ops/fused_predictor.py split_units). Each output
//     column is computed by one block over the whole K in a fixed order:
//     no K split, no atomics on data, so repeats are bit-identical.
//   * The weight ring. The weights do not depend on the activations. They
//     are read from a packed copy (ops/fused_predictor.py pack_units: each
//     8-column unit's rows contiguous). A block takes its units of a stage
//     in batches (4 units at one x row, 2 at two, 1 at four or eight) and
//     each batch's rows in chunks of at most `chunk` bytes. The producer's
//     one thread walks the frame's whole chunk sequence (16 passes x L
//     layers x qkv, wo, gate/up, down, and each head slice after its pass)
//     copying chunk after chunk with TMA bulk copies into a ring of kFRing
//     buffers, each completing on its "full" mbarrier; it waits only for a
//     free buffer, which the consumer warps release on its "empty"
//     mbarrier once they have read it. It never waits at a grid barrier,
//     so the weight stream runs on through barriers and prologues as deep
//     as the ring: 6 buffers of 16 KiB, the largest stage share of a block
//     at full width (gate/up, dense bf16 at one x row). A deeper ring ran
//     slower: the shared memory it takes comes out of the SM's L1, which
//     caches the spills below (on the H100, dense B = 1: 13 buffers 4.84
//     ms a frame, 6 buffers 4.57; PERF.md).
//   * One loop over the frame's stages calls one stage function, so its
//     code is emitted once: with a call site per stage kind the kernel was
//     19k instructions, which thrashed the instruction caches at every
//     stage (on the H100 each stage's first loads took ~1 us longer). A
//     producer warp beside 8 consumer warps caps a thread at 168 registers
//     (three warps share an SM sub-partition's register file): attention
//     loads its cached keys and values in two rounds, and ~360 bytes a
//     thread spill to local memory.
//   * int4, the step kernel's machinery (talker_step.cu): the kernel's copy
//     pairs adjacent rows in a byte (ops/fused_predictor.py pair_int4: row
//     2r low nibble, 2r + 1 high) and keeps each unit's multipliers [K /
//     128, 8] in its own rows; the producer copies a chunk's multipliers
//     with its rows (whole pairs of groups) into the buffer's last 64th,
//     which int4 adds to each ring buffer. A warp takes a group of a chunk
//     (64 packed rows), a lane two of its packed rows; the lane's dot of
//     the group with the biased nibbles less 8 (exact in f32, gemv.cuh
//     unpack4) is multiplied by the group's multiplier once, in f32, and
//     the column scale comes in the epilogue. All five weights int4 or none
//     (the TPU kernel gates on wqkv alone; quantize_decoder_params makes
//     all five): the host routes a mix to the chain, the kernel refuses it.
//   * x rows: a row pass stages up to kMT rows (1, 2, 4, or 8 in bf16 and
//     4 in f32; at most 4 with int4 weights, kFMaxMT4, whose group sums a
//     lane holds beside the stage's; B > kMT takes ceil(B / kMT) passes
//     over a stage, its weights streamed once a pass) in shared memory in T
//     after their prologue (every product's input is a T-rounded value, so
//     this is exact); a thread holds kMT * 8 sums for each unit of a batch
//     (32 or 64), reduced through one warp reduce-scatter per 32 sums and
//     the warps in order.
//   * A trace, compiled in only with -DKERNEL_TRACE (persistent.cuh
//     kTrace) and on when args.trace is set: every block's consumer thread
//     0 writes %globaltimer at each grid barrier's arrival and release,
//     sums the time from a stage's start to its first activation data, its
//     products and its waits for full ring buffers; the producer sums its
//     waits for free ones (tools/frame_measure.py trace). args.mode, read
//     in those builds only, cuts the products out (kNoWork: no copies, no
//     sums; what is left is barriers, prologues and epilogues).
// Scope: T = float or bf16; each of the five weights dense in T or int8
//   with an f32 per-column scale (mixed kinds too), or all five int4
//   (biased nibbles, an int8 multiplier per 128-row group and column, an
//   f32 column scale: per group (x . (nib - 8)) * m8 in f32, then the
//   column scale, the order of ops/quant.py panel_matmul4_plain up to the
//   order of the sums; H, F and nq * hd multiples of 256); 1 <= B <= 16
//   (the TPU kernel's `max_b`); hd a power of two in [8, 128]; nq / nk <=
//   4; H <= 2048; H, F, nq * hd, CV multiples of 8.

#include "persistent.cuh"

namespace {

constexpr int kFThreads = 256;           // consumer threads
constexpr int kFWarps = kFThreads / 32;
constexpr int kFBlock = kFThreads + 32;  // + the producer warp
constexpr int kUnit = 8;                 // columns of a unit
constexpr int kFMaxB = 16;
constexpr int kFMaxMT = 8;
constexpr int kFMaxMT4 = 4;              // x rows a pass with int4 weights
constexpr int kCodes = 16;               // protocol.NUM_CODEBOOKS
constexpr int kFMaxG = 4;                // q heads per kv head
constexpr int kFMaxHd = 128;
constexpr int kXPer = 8;                 // norm inputs a thread holds
constexpr int kFRing = 6;                // ring buffers
enum { kQkv = 0, kWo = 1, kGu = 2, kDown = 3, kHead = 4 };
enum { kDense = 0, kInt8 = 1, kInt4 = 2 };
// args.mode bits (-DKERNEL_TRACE builds only)
enum { kNoWork = 1 };
// trace words (tools/frame_measure.py trace), a block's kTrStride words
// from blk * kTrStride: barrier i's arrival and release at 2 i, 2 i + 1 (i
// < kTrBars); the start, the end, the barriers counted; per stage kind
// (qkv, wo, gu, down, head) the time from the stage's start to its first
// activation data and the calls (kTrFirst + 2 mat + 0..1); the consumers'
// waits for full buffers (time, chunks); the producer's for free ones
// (time, chunks); the wo stage's attention prologue (time, calls); per
// stage kind the products from their start to the first chunk in, to the
// last chunk read, to the epilogue's end, and the calls (kTrProd + 4 mat +
// 0..3). The consumers sum in shared memory (kTrSums words from
// kTrFirst) and add the sums into the trace at the end.
constexpr int kTrStride = 2048, kTrBars = 960;
constexpr int kTrT0 = 1920, kTrEnd = 1921, kTrNBar = 1922, kTrFirst = 1924,
              kTrCWait = 1934, kTrPWait = 1936, kTrAttn = 1938,
              kTrProd = 1940;
constexpr int kTrSums = 40;

// grid barriers a frame: 4 a layer pass, one after each head slice
// (ops/fused_predictor.py frame_barriers)
__host__ __device__ constexpr int frame_barriers(int L) {
  return kCodes * 4 * L + kCodes - 1;
}

// ops/fused_predictor.py _FrameArgs, field for field.
struct FrameArgs {
  const void* w[5];       // packed [L, N / 8, Kp, 8] (head [16 CV / 8, Kp, 8])
  const int8_t* m8[5];    // int4: multipliers [L, N / 8, K / 128, 8]; else null
  const float* sc[5];     // column scales [L, N] / [16 * CV]; null dense
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
  float* gu;              // [B, 2F]
  float* kc;              // [L, B, nk, 16, hd] the frame cache
  float* vc;
  const float* cos;       // [16, hd]
  const float* sin;
  float* part_v;          // [nb, B] the head's per-block partials
  int* part_i;
  unsigned long long* bar;  // the grid barrier's arrival count
  int kind[5];            // kDense, kInt8, kInt4
  int B, H, L, nq, nk, hd, F, CV, R, rows0;
  int chunk;              // bytes of a ring buffer
  int mode;               // kNoWork (trace builds only)
  float eps;
  unsigned long long* trace;  // null, or nb x kTrStride words
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

// ---------------------------------------------------------------- geometry
// (32-bit: blk * units and (x + 1) * nb stay far below 2^32)
__device__ __forceinline__ int unit_lo(int units, int blk, int nb) {
  return static_cast<int>(static_cast<unsigned>(blk * units) /
                          static_cast<unsigned>(nb));
}

// the block that owns unit x of U dealt over nb blocks
__device__ __forceinline__ int unit_owner(int x, int U, int nb) {
  return static_cast<int>(static_cast<unsigned>((x + 1) * nb - 1) /
                          static_cast<unsigned>(U));
}

// A weight stage in the packed layout: its x width K, packed rows Kp (K /
// 2 for int4), columns N, the bytes of a unit row (8 columns), the element
// offsets of its layer (or head slice) in the values, the scales and the
// int4 multipliers, the block's units [u0, u0 + nu).
struct FGeom {
  int mat, layer, slice, kind, K, Kp, N, wb, u0, nu;
  long long off, soff, moff;
};

template <typename T>
__device__ __forceinline__ FGeom geom(const FrameArgs& a, int mat, int layer,
                                      int slice) {
  FGeom d;
  d.mat = mat;
  d.layer = layer;
  d.slice = slice;
  switch (mat) {
    case kQkv: d.K = a.H; d.N = (a.nq + 2 * a.nk) * a.hd; break;
    case kWo: d.K = a.nq * a.hd; d.N = a.H; break;
    case kGu: d.K = a.H; d.N = 2 * a.F; break;
    case kDown: d.K = a.F; d.N = a.H; break;
    default: d.K = a.H; d.N = a.CV; break;
  }
  d.kind = a.kind[mat];
  d.Kp = d.kind == kInt4 ? d.K / 2 : d.K;
  d.wb = kUnit * (d.kind == kDense ? static_cast<int>(sizeof(T)) : 1);
  d.soff = static_cast<long long>(mat == kHead ? slice : layer) * d.N;
  d.off = d.soff * d.Kp;
  d.moff = d.soff * (d.K / kGroup4);
  const int U = d.N / kUnit;
  d.u0 = unit_lo(U, blockIdx.x, gridDim.x);
  d.nu = unit_lo(U, blockIdx.x + 1, gridDim.x) - d.u0;
  return d;
}

// Weight stage s of the frame (the order the kernel runs them): pass 0 has
// 4 L stages (qkv, wo, gu, down a layer), every later pass 4 L + 1 (its
// head slice last).
__device__ __forceinline__ void stage_of(int s, int L, int& mat, int& layer,
                                         int& slice, int& p) {
  int r = s;
  p = 0;
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

// sums a thread holds for a batch of units: 32, or 64 at 8 rows
__host__ __device__ constexpr int f_acc(int mt) {
  return mt * kUnit > 32 ? mt * kUnit : 32;
}
__host__ __device__ constexpr int f_units_a_batch(int mt) {
  return f_acc(mt) / (mt * kUnit);
}

// rows of a chunk of a batch of nub units: as many as `chunk` bytes hold,
// even (whole 16-byte copies); with int4 whole pairs of groups (128 packed
// rows: the group's multipliers are 16 bytes a unit); at most Kp
// (ops/fused_predictor.py chunk_rows)
__device__ __forceinline__ int f_chunk_rows(int chunk, int nub, int wb,
                                            int Kp, bool i4) {
  return min(Kp, (chunk / (nub * wb)) & (i4 ? ~127 : ~1));
}

// bytes of a ring buffer: `chunk` bytes of values, then with int4 weights
// the chunk's multipliers (8 bytes a group of 64 packed rows and unit: a
// 64th of the values' bytes; ops/fused_predictor.py ring_bytes)
__host__ __device__ inline int f_buf(const FrameArgs& a) {
  return a.chunk + (a.kind[0] == kInt4 ? a.chunk / 64 : 0);
}

// ---------------------------------------------------------------- smem
__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }

__host__ __device__ inline int kmax_of(int H, int nq, int hd, int F) {
  const int a = H > nq * hd ? H : nq * hd;
  return a > F ? a : F;
}

// Bytes of a block's shared memory besides the ring (ops/fused_predictor.py
// frame_smem_fixed): the ring's mbarriers, the staged x rows, the sums'
// scratch, the head's argmax and codes, the warps' head vectors.
__host__ __device__ inline int fixed_smem(int mt, int kmax, int hd,
                                          int tsize) {
  return 2 * kFRing * 8 + kTrSums * 8 + align16(mt * kmax * tsize) +
         4 * (2 * kFWarps * 32 + 64 + kFMaxMT + 3 * kFMaxB + kFWarps * hd +
              kFWarps * kFMaxG * (kCodes + 1));
}

template <typename T, int kMT>
struct Smem {
  unsigned char* ring;          // [kFRing][f_buf]
  unsigned long long* full;     // [kFRing]
  unsigned long long* empty;    // [kFRing]
  unsigned long long* tsum;     // [kTrSums] the trace's sums
  T* xs;          // [kMT][Kmax] staged x rows
  float* red;     // [2][kFWarps][32] the warps' unit sums / row sums
  float* outv;    // [64] a batch's sums
  float* rinv;    // [kFMaxMT]
  float* bestv;   // [kFMaxB] the block's argmax
  int* besti;     // [kFMaxB]
  int* code;      // [kFMaxB] the codes of the pass's input rows
  float* hv;      // [kFWarps][hd] a warp's head vector (RoPE's partner)
  float* sc;      // [kFWarps][kFMaxG][kCodes + 1] a warp's attention
                  // scores (the current token's last)
};

template <typename T, int kMT>
__device__ Smem<T, kMT> carve(unsigned char* base, const FrameArgs& a) {
  Smem<T, kMT> s;
  s.ring = base;
  unsigned char* p = base + kFRing * f_buf(a);
  s.full = reinterpret_cast<unsigned long long*>(p);
  s.empty = s.full + kFRing;
  p += 2 * kFRing * 8;
  s.tsum = reinterpret_cast<unsigned long long*>(p);
  p += kTrSums * 8;
  s.xs = reinterpret_cast<T*>(p);
  p += align16(kMT * kmax_of(a.H, a.nq, a.hd, a.F) * sizeof(T));
  s.red = reinterpret_cast<float*>(p);
  s.outv = s.red + 2 * kFWarps * 32;
  s.rinv = s.outv + 64;
  s.bestv = s.rinv + kFMaxMT;
  s.besti = reinterpret_cast<int*>(s.bestv + kFMaxB);
  s.code = s.besti + kFMaxB;
  s.hv = reinterpret_cast<float*>(s.code + kFMaxB);
  s.sc = s.hv + kFWarps * a.hd;
  return s;
}

__device__ __forceinline__ void csync() { sync_first(kFThreads); }

// thread 0's trace sum of word w (kTrFirst <= w < kTrFirst + kTrSums)
template <typename T, int kMT>
__device__ __forceinline__ void tsum_add(const Smem<T, kMT>& sm, int w,
                                         unsigned long long v) {
  sm.tsum[w - kTrFirst] += v;
}

__device__ __forceinline__ bool no_work(const FrameArgs& a) {
  return kTrace && (a.mode & kNoWork) != 0;
}

// this block's trace words, or null
__device__ __forceinline__ unsigned long long* block_trace(
    const FrameArgs& a) {
  return kTrace && a.trace != nullptr
             ? a.trace + static_cast<long long>(blockIdx.x) * kTrStride
             : nullptr;
}

// ---------------------------------------------------------------- ring
// The chunks of the frame in the order the consumers read them: stage
// after stage (stage_of), each row pass, each batch of units, each batch's
// rows in chunks (stages where the block has no units have none).
template <typename T, int kMT>
struct FrameWalk {
  static constexpr int kUB = f_units_a_batch(kMT);
  const FrameArgs* a;
  FGeom d;
  const char* g;
  int s, n_stages, rc, ul, r0, passes;
  bool done;

  __device__ void start(const FrameArgs& args) {
    a = &args;
    passes = (a->B + kMT - 1) / kMT;
    n_stages = 4 * a->L + (kCodes - 1) * (4 * a->L + 1);
    s = -1;
    next_stage();
  }
  __device__ void next_stage() {
    rc = ul = r0 = 0;
    do {
      if (++s >= n_stages) {
        done = true;
        return;
      }
      int mat, layer, slice, p;
      stage_of(s, a->L, mat, layer, slice, p);
      d = geom<T>(*a, mat, layer, slice);
    } while (d.nu == 0);
    g = static_cast<const char*>(a->w[d.mat]) + d.off * (d.wb / kUnit);
    done = false;
  }
  __device__ bool i4() const { return d.kind == kInt4; }
  __device__ int nub() const { return min(kUB, d.nu - ul); }
  __device__ int rows() const {
    return f_chunk_rows(a->chunk, nub(), d.wb, d.Kp, i4());
  }
  // the chunk's rows, and unit i's sources: values, int4 multipliers
  __device__ int rn() const { return min(rows(), d.Kp - r0); }
  __device__ const char* src(int i) const {
    return g + (static_cast<long long>(d.u0 + ul + i) * d.Kp + r0) * d.wb;
  }
  __device__ const int8_t* msrc(int i) const {
    return a->m8[d.mat] + d.moff +
           (static_cast<long long>(d.u0 + ul + i) * (d.K / kGroup4) +
            r0 / kG4Rows) * kUnit;
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

// The producer (lane 0 of the block's last warp): every chunk of the frame
// in the consumers' order, each into ring buffer ci % kFRing once the
// consumers have released its last use: unit i's rows at i rn wb, int4's
// multipliers at chunk + i rn / 8.
template <typename T, int kMT>
__device__ void produce(const FrameArgs& a, const Smem<T, kMT>& sm) {
  if (no_work(a)) return;
  unsigned long long* tb = block_trace(a);
  unsigned long long waited = 0;
  FrameWalk<T, kMT> fw;
  fw.start(a);
  int ci = 0;
  for (; !fw.done; fw.advance(), ++ci) {
    const int b = ci % kFRing;
    if (ci >= kFRing) {
      const unsigned long long t0 = tb != nullptr ? global_ns() : 0;
      mbar_wait(sm.empty + b, ((ci / kFRing) - 1) & 1);
      if (tb != nullptr) waited += global_ns() - t0;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const int rn = fw.rn(), nub = fw.nub();
    const bool i4 = fw.i4();
    const unsigned vb = static_cast<unsigned>(rn * fw.d.wb);
    const unsigned mb = i4 ? static_cast<unsigned>(rn / 8) : 0u;
    mbar_expect(sm.full + b, (vb + mb) * nub);
    unsigned char* dst = sm.ring + static_cast<long long>(b) * f_buf(a);
    for (int i = 0; i < nub; ++i) {
      bulk_copy(dst + static_cast<long long>(i) * vb, fw.src(i), vb,
                sm.full + b);
      if (i4)
        bulk_copy(dst + a.chunk + i * mb, fw.msrc(i), mb, sm.full + b);
    }
  }
  if (tb != nullptr) {
    tb[kTrPWait] += waited;
    tb[kTrPWait + 1] += ci;
  }
}

// ---------------------------------------------------------------- barrier
// The consumers' grid barrier (persistent.cuh grid_barrier_first on the
// counting barrier), stamped into the block's trace up to kTrBars.
struct Barrier {
  unsigned long long next;   // thread 0: the count this barrier waits for
  int ti;

  __device__ void start(const FrameArgs& a) {
    ti = 0;
    next = threadIdx.x == 0 ? grid_count_base(a.bar) : 0;
  }
  __device__ void sync(const FrameArgs& a, unsigned long long* tb) {
    grid_barrier_first(a.bar, next, kFThreads, ti < kTrBars ? tb : nullptr,
                       ti);
  }
};

// ---------------------------------------------------------------- prologues
// The stage's input value of row b, column k, before its rounding to T:
// the residual, or at layer 0 the pass's source row (h1024 at pass 0, else
// the ptab row of slice p - 1 that the row's code selects).
template <typename T>
struct Src {
  const int* code;         // the pass's codes (shared memory), null at pass 0
  int q;                   // the ptab slice, p - 1
  bool source;             // layer 0: read the source, not the residual
};

template <typename T>
__device__ __forceinline__ float resid(const FrameArgs& a, const Src<T>& src,
                                       int b, int k) {
  if (!src.source) return a.xres[b * a.H + k];
  if (src.code == nullptr) return round_t(a.h1024[b * a.H + k], (T*)nullptr);
  const int c = max(src.code[b], 0);
  const int row = c < a.rows0 ? c : a.R - 1;
  return to_f32(static_cast<const T*>(
      a.ptab)[(static_cast<long long>(src.q) * a.R + row) * a.H + k]);
}

// The norm stages' inputs of rows [c0, c0 + mt) into xs: every thread
// loads its columns k = t + 256 q of the rows (the residual, or the pass's
// source) and of the norm weight at once, into registers (one round trip;
// H <= 256 kXPer), sums the squares in order, the rows' sums reduce
// through the warp's butterfly and the warps in order, and each value is
// normed and rounded once: T(x * rsqrt(mean(x^2) + eps) * w). `first`:
// thread 0's stamp once its loads are in.
template <typename T, int kMT, typename Mark>
__device__ void stage_norm(const FrameArgs& a, const Smem<T, kMT>& sm,
                           const Src<T>& src, const T* ln, int c0, int mt,
                           Mark&& first) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
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
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    float ss = 0.f;
#pragma unroll
    for (int q = 0; q < kXPer; ++q) ss = fmaf(xr[m][q], xr[m][q], ss);
    if (m == 0) first();
#pragma unroll
    for (int o = 16; o > 0; o /= 2) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) sm.red[warp * 32 + m] = ss;
  }
  csync();
  if (threadIdx.x < mt) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kFWarps; ++w) t += sm.red[w * 32 + threadIdx.x];
    sm.rinv[threadIdx.x] = rsqrtf(t / static_cast<float>(K) + a.eps);
  }
  csync();
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

// down's inputs of rows [c0, c0 + mt) into xs: silu(g) * u of the gate /
// up product, in f32, rounded once. A thread loads kYP columns of every
// row at once (one round trip for F <= 256 kYP at one row).
template <typename T, int kMT, typename Mark>
__device__ void stage_silu(const FrameArgs& a, const Smem<T, kMT>& sm,
                           int c0, int mt, Mark&& first) {
  constexpr int kYP = 12 / kMT > 2 ? 12 / kMT : 2;
  const int K = a.F;
  for (int k0 = threadIdx.x; k0 < K; k0 += kYP * kFThreads) {
    float g[kMT][kYP], u[kMT][kYP];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int q = 0; q < kYP; ++q) {
        const int k = k0 + q * kFThreads;
        const float* row = a.gu + static_cast<long long>(c0 + m) * 2 * K;
        const bool ok = m < mt && k < K;
        g[m][q] = ok ? row[k] : 0.f;
        u[m][q] = ok ? row[K + k] : 0.f;
      }
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int q = 0; q < kYP; ++q) {
        const int k = k0 + q * kFThreads;
        if (k < K)
          store_x(sm.xs + m * K + k,
                  m < mt ? round_t(g[m][q] / (1.f + expf(-g[m][q])) * u[m][q],
                                   (T*)nullptr)
                         : 0.f);
      }
    if (k0 == static_cast<int>(threadIdx.x)) first();
  }
}

// One head vector of a warp (lane holds dims e = lane + 32 r): QK-norm and
// rotate-half RoPE, one rounding each (ops/gemv.cuh qk_finish's
// arithmetic); the partner dims e ^ hd / 2 through the warp's hv.
template <typename T>
__device__ __forceinline__ void qk_norm_rope(float (&v)[kFMaxHd / 32],
                                             const float (&w)[kFMaxHd / 32],
                                             const float (&c)[kFMaxHd / 32],
                                             const float (&sn)[kFMaxHd / 32],
                                             float* hv, int hd, float eps) {
  constexpr int kR = kFMaxHd / 32;
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
}

// 16 sums of a warp's lanes (one per cache slot) reduced and scattered at
// once: at each butterfly step over lane bits 4..1 a lane keeps one half of
// its values and adds its partner's copy of that half (15 shuffles), then
// the last step over bit 0; lane l ends with the sum of slot l / 2
__device__ __forceinline__ float scatter16(float (&w)[kCodes], int lane) {
#pragma unroll
  for (int o = 16, n = kCodes; o > 1; o /= 2) {
    const bool up = (lane & o) != 0;
    n /= 2;
#pragma unroll
    for (int i = 0; i < kCodes / 2; ++i)
      if (i < n) {
        const float send = up ? w[i] : w[i + n];
        const float keep = up ? w[i + n] : w[i];
        w[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
  }
  return w[0] + __shfl_xor_sync(0xffffffffu, w[0], 1);
}

// wo's inputs of rows [c0, c0 + mt) into xs: the attention of layer l in
// pass p, a warp a (row, kv head) unit, in two rounds of loads (the cached
// keys of slots [0, p) with the head vectors, then the cached values: with
// a producer warp beside 8 consumer warps a thread has 168 registers).
// The unit's k, v and q heads rounded to T,
// k and q QK-normed and RoPEd; the block that owns wo unit (b nk + j) mod
// (H / 8) stores k and v at slot p; per q head the scores over slots
// [0, p) and the current token, the softmax in f32 and the weighted sum of
// the values (the current token last), rounded to T into xs.
template <typename T, int kMT, typename Mark>
__device__ void stage_attention(const FrameArgs& a, const Smem<T, kMT>& sm,
                                int p, int l, int c0, int mt, Mark&& first) {
  constexpr int kR = kFMaxHd / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hd = a.hd, nk = a.nk, g = a.nq / a.nk;
  const int nqkv = (a.nq + 2 * nk) * hd, K = a.nq * hd, Uwo = a.H / kUnit;
  const float rs = sqrtf(static_cast<float>(hd));
  float* hv = sm.hv + warp * hd;
  float* scw = sm.sc + warp * kFMaxG * (kCodes + 1);
  const T* kw = static_cast<const T*>(a.k_norm) + l * hd;
  const T* qw = static_cast<const T*>(a.q_norm) + l * hd;
  for (int u = warp; u < mt * nk; u += kFWarps) {
    const int m = u / nk, j = u % nk, b = c0 + m;
    const long long slot0 =
        ((static_cast<long long>(l) * a.B + b) * nk + j) * kCodes * hd;
    const float* row = a.qkv + static_cast<long long>(b) * nqkv;
    // the first round of loads, in flight at once: the cached keys of
    // slots [0, p) (a lane's 4 dims of each), the head vectors, the norm
    // weights and cos / sin; the cached values come after the scores (the
    // two would not fit in registers together)
    float kc[kCodes][kR];
#pragma unroll
    for (int t = 0; t < kCodes; ++t)
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int e = lane + 32 * r;
        kc[t][r] = t < p && e < hd ? a.kc[slot0 + t * hd + e] : 0.f;
      }
    float kv[kR], vv[kR], kwr[kR], qwr[kR], c[kR], sn[kR], qv[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int e = lane + 32 * r;
      const bool ok = e < hd;
      kv[r] = ok ? round_t(row[(a.nq + j) * hd + e], (T*)nullptr) : 0.f;
      vv[r] = ok ? round_t(row[(a.nq + nk + j) * hd + e], (T*)nullptr) : 0.f;
      qv[r] = ok ? round_t(row[j * g * hd + e], (T*)nullptr) : 0.f;
      kwr[r] = ok ? to_f32(kw[e]) : 0.f;
      qwr[r] = ok ? to_f32(qw[e]) : 0.f;
      c[r] = ok ? round_t(a.cos[p * hd + e], (T*)nullptr) : 0.f;
      sn[r] = ok ? round_t(a.sin[p * hd + e], (T*)nullptr) : 0.f;
    }
    if (u == warp) first();
    qk_norm_rope<T>(kv, kwr, c, sn, hv, hd, a.eps);
    if (unit_owner((b * nk + j) % Uwo, Uwo, gridDim.x) ==
        static_cast<int>(blockIdx.x))
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int e = lane + 32 * r;
        if (e < hd) {
          a.kc[slot0 + p * hd + e] = kv[r];
          a.vc[slot0 + p * hd + e] = vv[r];
        }
      }
    // per q head (the group's others loaded in their turn; the loops over
    // q heads are not unrolled, so that their code is emitted once) the
    // scores: each lane's dims in order, then the warp's reduce-scatter
    // (lane l ends with slot l / 2) into the warp's scw, the current
    // token's by the butterfly into scw's slot kCodes
#pragma unroll 1
    for (int i = 0; i < g; ++i) {
      if (i > 0)
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int e = lane + 32 * r;
          qv[r] = e < hd ? round_t(row[(j * g + i) * hd + e], (T*)nullptr)
                         : 0.f;
        }
      qk_norm_rope<T>(qv, qwr, c, sn, hv, hd, a.eps);
      float q[kR], w[kCodes];
#pragma unroll
      for (int r = 0; r < kR; ++r) q[r] = __fdiv_rn(qv[r], rs);
#pragma unroll
      for (int t = 0; t < kCodes; ++t) {
        w[t] = 0.f;
#pragma unroll
        for (int r = 0; r < kR; ++r) w[t] = fmaf(q[r], kc[t][r], w[t]);
      }
      float* sc = scw + i * (kCodes + 1);
      const float st = scatter16(w, lane);
      if ((lane & 1) == 0 && lane / 2 < p) sc[lane / 2] = st;
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kR; ++r) s = fmaf(q[r], kv[r], s);
#pragma unroll
      for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) sc[kCodes] = s;
    }
    __syncwarp();
    // the second round: the cached values; per q head the softmax in f32
    // and the weighted sum (the current token last), rounded to T into xs
    float vc[kCodes][kR];
#pragma unroll
    for (int t = 0; t < kCodes; ++t)
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int e = lane + 32 * r;
        vc[t][r] = t < p && e < hd ? a.vc[slot0 + t * hd + e] : 0.f;
      }
#pragma unroll 1
    for (int i = 0; i < g; ++i) {
      const float* sc = scw + i * (kCodes + 1);
      const float scur = sc[kCodes];
      float mx = p > 0 ? sc[0] : scur;
      for (int t = 1; t < p; ++t) mx = fmaxf(mx, sc[t]);
      if (p > 0) mx = fmaxf(mx, scur);
      float lsum = 0.f, acc[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[r] = 0.f;
#pragma unroll
      for (int t = 0; t < kCodes; ++t)
        if (t < p) {
          const float ew = expf(sc[t] - mx);
          lsum += ew;
#pragma unroll
          for (int r = 0; r < kR; ++r) acc[r] = fmaf(ew, vc[t][r], acc[r]);
        }
      const float ew = expf(scur - mx);
      lsum += ew;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int e = lane + 32 * r;
        if (e < hd)
          store_x(sm.xs + m * K + (j * g + i) * hd + e,
                  round_t(fmaf(ew, vv[r], acc[r]) / fmaxf(lsum, 1e-30f),
                          (T*)nullptr));
      }
    }
    __syncwarp();                  // scw and hv are the next unit's
  }
}

// ---------------------------------------------------------------- products
// 32 sums of a warp reduced and scattered at once (at each butterfly step
// a lane keeps one half of its values and adds its partner's copy of that
// half: 31 shuffles), lane l ending with sum l of v[32 kH .. 32 kH + 31]
template <int kAcc, int kH>
__device__ __forceinline__ float f_scatter(float (&v)[kAcc], int lane) {
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

// A product of rows [c0, c0 + mt): the block's units in batches, each
// batch's rows chunk by chunk from the ring (ci counts the chunks as the
// producer does), then the batch's sums reduced over the block and the
// stage's epilogue: qkv / gate-up f32 out, wo / down added into the
// residual, the head's logits rounded through T into the rows' argmax.
// Dense and int8: a thread a row of the chunk (int8's column scale in the
// epilogue). int4 (kMT <= kFMaxMT4): a warp a group of the chunk, a lane
// two of its packed rows (four weight rows); the lane's dot with the
// nibbles less 8, then times the group's multiplier, once; the column
// scale in the epilogue.
template <typename T, int kMT, int kKind>
__device__ void product(const FrameArgs& a, const Smem<T, kMT>& sm,
                        const FGeom& d, int c0, int mt, int& ci,
                        unsigned long long* tb) {
  using W = typename std::conditional<kKind == kDense, T, int8_t>::type;
  constexpr int kAcc = f_acc(kMT);
  constexpr int kUB = f_units_a_batch(kMT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool tr = tb != nullptr && threadIdx.x == 0;
  const bool work = !no_work(a);
  const int K = d.K, Kp = d.Kp;
  const int bufb = f_buf(a);
  const float* scale = a.sc[d.mat] == nullptr ? nullptr : a.sc[d.mat] + d.soff;
  unsigned long long waited = 0, tp1 = 0, tp2 = 0;
  const unsigned long long tp0 = tr ? global_ns() : 0;
  int chunks = 0;
  for (int ul = 0; ul < d.nu; ul += kUB) {
    const int nub = min(kUB, d.nu - ul);
    const int R = f_chunk_rows(a.chunk, nub, d.wb, Kp, kKind == kInt4);
    float v[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) v[i] = 0.f;
    for (int r0 = 0; work && r0 < Kp; r0 += R, ++ci) {
      const int rn = min(R, Kp - r0);
      const int b = ci % kFRing;
      const unsigned long long t0 = tr ? global_ns() : 0;
      mbar_wait(sm.full + b, (ci / kFRing) & 1);
      if (tr) {
        const unsigned long long t1 = global_ns();
        waited += t1 - t0;
        if (chunks++ == 0) tp1 = t1;
      }
      const unsigned char* buf = sm.ring + static_cast<long long>(b) * bufb;
      if constexpr (kKind != kInt4) {
        for (int r = threadIdx.x; r < rn; r += kFThreads) {
          const int k = r0 + r;
          float xv[kMT];
#pragma unroll
          for (int m = 0; m < kMT; ++m) xv[m] = to_f32(sm.xs[m * K + k]);
#pragma unroll
          for (int ub = 0; ub < kUB; ++ub)
            if (ub < nub) {
              float wv[kUnit];
              cvt8(ld_sm(reinterpret_cast<const W*>(
                       buf + (static_cast<long long>(ub) * rn + r) * d.wb)),
                   wv);
#pragma unroll
              for (int m = 0; m < kMT; ++m)
#pragma unroll
                for (int j = 0; j < kUnit; ++j) {
                  float& acc = v[(ub * kMT + m) * kUnit + j];
                  acc = fmaf(xv[m], wv[j], acc);
                }
            }
        }
      } else if constexpr (kMT <= kFMaxMT4) {
        int4_chunk<T, kMT, kUB, kAcc, kFWarps>(buf, buf + a.chunk, rn, nub,
                                               sm.xs, K, r0, v);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty + b);    // the buffer is free
    }
    if (tr) tp2 = global_ns();
    sm.red[warp * 32 + lane] = f_scatter<kAcc, 0>(v, lane);
    if constexpr (kAcc == 64)
      sm.red[(kFWarps + warp) * 32 + lane] = f_scatter<kAcc, 1>(v, lane);
    csync();
    if (threadIdx.x < kAcc) {
      const int h = threadIdx.x / 32, l = threadIdx.x % 32;
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kFWarps; ++w) t += sm.red[(h * kFWarps + w) * 32 + l];
      sm.outv[threadIdx.x] = t;
    }
    csync();
    const int i = threadIdx.x;
    const int ub = i / (kMT * kUnit), m = i / kUnit % kMT;
    if (i < kAcc && ub < nub && m < mt) {
      const int n = (d.u0 + ul + ub) * kUnit + i % kUnit;
      const int b = c0 + m;
      float s = sm.outv[i];
      if (scale != nullptr) s *= scale[n];
      switch (d.mat) {
        case kQkv: a.qkv[static_cast<long long>(b) * d.N + n] = s; break;
        case kGu: a.gu[static_cast<long long>(b) * d.N + n] = s; break;
        case kHead: sm.outv[i] = round_t(s, (T*)nullptr); break;
        default: a.xres[b * a.H + n] += s;               // wo, down
      }
    }
    if (d.mat == kHead) {
      csync();
      if (threadIdx.x < mt) {            // the row's logits in column order
        const int r = threadIdx.x, b = c0 + r;
        float bv = sm.bestv[b];
        int bi = sm.besti[b];
        for (int u = 0; u < nub; ++u)
          for (int j = 0; j < kUnit; ++j) {
            const float lv = sm.outv[(u * kMT + r) * kUnit + j];
            const int col = (d.u0 + ul + u) * kUnit + j;
            if (better(lv, col, bv, bi)) { bv = lv; bi = col; }
          }
        sm.bestv[b] = bv;
        sm.besti[b] = bi;
      }
    }
    csync();                             // red / outv are reused
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

// A weight stage: per row pass, the prologue into xs (the norm, the
// attention, or silu(g) * u), then the product of the weight's kind; the
// head writes the block's argmax partials (every block, units or none).
template <typename T, int kMT>
__device__ void stage(const FrameArgs& a, const Smem<T, kMT>& sm,
                      const Src<T>& src, int mat, int layer, int slice, int p,
                      int& ci, unsigned long long* tb) {
  const FGeom d = geom<T>(a, mat, layer, slice);
  const bool tr = tb != nullptr && threadIdx.x == 0;
  const unsigned long long t0 = tr ? global_ns() : 0;
  auto first = [&] {
    if (tr) {
      tsum_add(sm, kTrFirst + 2 * mat, global_ns() - t0);
      tsum_add(sm, kTrFirst + 2 * mat + 1, 1);
    }
  };
  if (mat == kHead && threadIdx.x < a.B) {
    sm.bestv[threadIdx.x] = -INFINITY;
    sm.besti[threadIdx.x] = 0x7fffffff;
  }
  const T* ln = static_cast<const T*>(
      mat == kQkv ? a.ln1 : mat == kGu ? a.ln2 : a.final_norm);
  if (mat != kHead) ln += static_cast<long long>(layer) * a.H;
  for (int c0 = 0; c0 < a.B && d.nu > 0; c0 += kMT) {
    const int mt = min(kMT, a.B - c0);
    auto once = [&] {
      if (c0 == 0) first();
    };
    if (mat == kWo) {
      const unsigned long long ta = tr ? global_ns() : 0;
      stage_attention<T, kMT>(a, sm, p, layer, c0, mt, once);
      if (tr) {
        tsum_add(sm, kTrAttn, global_ns() - ta);
        tsum_add(sm, kTrAttn + 1, 1);
      }
    } else if (mat == kDown) {
      stage_silu<T, kMT>(a, sm, c0, mt, once);
    } else {
      stage_norm<T, kMT>(a, sm, src, ln, c0, mt, once);
    }
    csync();
    if (d.kind == kInt8) {
      product<T, kMT, kInt8>(a, sm, d, c0, mt, ci, tb);
    } else if (d.kind == kDense) {
      product<T, kMT, kDense>(a, sm, d, c0, mt, ci, tb);
    } else if constexpr (kMT <= kFMaxMT4) {      // int4: at most 4 rows
      product<T, kMT, kInt4>(a, sm, d, c0, mt, ci, tb);
    }
  }
  if (mat == kHead) {
    csync();
    if (threadIdx.x < a.B) {
      a.part_v[blockIdx.x * a.B + threadIdx.x] = sm.bestv[threadIdx.x];
      a.part_i[blockIdx.x * a.B + threadIdx.x] = sm.besti[threadIdx.x];
    }
  }
}

template <typename T, int kMT>
__global__ void __launch_bounds__(kFBlock, 1) predictor_frame(FrameArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem<T, kMT> sm = carve<T, kMT>(smem_raw, a);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kFRing; ++i) {
      mbar_init(sm.full + i);
      mbar_init_count(sm.empty + i, kFWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; kTrace && i < kTrSums; ++i) sm.tsum[i] = 0;
  }
  __syncthreads();
  if (threadIdx.x >= kFThreads) {            // the producer warp
    if (threadIdx.x == kFThreads) produce<T, kMT>(a, sm);
    return;
  }
  const int L = a.L, B = a.B;
  unsigned long long* tb = block_trace(a);
  if (tb != nullptr && threadIdx.x == 0) tb[kTrT0] = global_ns();
  Barrier bar;
  bar.start(a);
  int ci = 0;
  if (blockIdx.x == 0 && threadIdx.x < B)
    a.codes[threadIdx.x * kCodes] = a.code0[threadIdx.x];

  // one loop over the frame's stages, so that the stage code is compiled
  // once (the kernel's code stays small enough for the instruction caches)
  const int n_stages = 4 * L + (kCodes - 1) * (4 * L + 1);
#pragma unroll 1
  for (int s = 0; s < n_stages; ++s) {
    int mat, layer, slice, p;
    stage_of(s, L, mat, layer, slice, p);
    const bool first = mat == kQkv && layer == 0;
    // the pass's source rows: h1024 at pass 0, else ptab[p - 1][sel(code)]
    const Src<T> src{p == 0 ? nullptr : sm.code, p - 1, first};
    if (first) {
      if (p == 1) {
        if (threadIdx.x < B) sm.code[threadIdx.x] = a.code0[threadIdx.x];
      } else if (p > 1) {
        reduce_codes<T, kMT>(a, sm, p - 1);
      }
      csync();
      // this block's share of the residual, from the source
      const int k0 = unit_lo(a.H, blockIdx.x, gridDim.x);
      const int n = unit_lo(a.H, blockIdx.x + 1, gridDim.x) - k0;
      for (int i = threadIdx.x; i < B * n; i += kFThreads) {
        const int b = i / n, k = k0 + i % n;
        a.xres[b * a.H + k] = resid<T>(a, src, b, k);
      }
    }
    stage<T, kMT>(a, sm, src, mat, layer, slice, p, ci, tb);
    bar.sync(a, tb);
  }
  if (blockIdx.x == 0) reduce_codes<T, kMT>(a, sm, kCodes - 1);
  if (bar.ti != frame_barriers(L)) __trap();   // the host counts the same
  if (tb != nullptr && threadIdx.x == 0) {
    tb[kTrEnd] = global_ns();
    tb[kTrNBar] = bar.ti;
    for (int i = 0; i < kTrSums; ++i)      // the producer adds its own
      if (kTrFirst + i != kTrPWait && kTrFirst + i != kTrPWait + 1)
        tb[kTrFirst + i] += sm.tsum[i];
  }
}

using FrameKernel = void (*)(FrameArgs);

template <typename T>
FrameKernel frame_kernel(int mt) {
  if (mt == 1) return predictor_frame<T, 1>;
  if (mt == 2) return predictor_frame<T, 2>;
  if constexpr (sizeof(T) > 2) {
    return predictor_frame<T, 4>;    // f32: at most 4 rows a pass
  } else {
    if (mt == 4) return predictor_frame<T, 4>;
    return predictor_frame<T, 8>;
  }
}

FrameKernel frame_kernel_of(int dtype, int mt) {
  return dtype == 0 ? frame_kernel<float>(mt)
                    : frame_kernel<__nv_bfloat16>(mt);
}

// x rows a pass (ops/fused_predictor.py row_pass): 1, 2, 4, else 8 in bf16
// and 4 in f32, so the staged rows take at most 16 bytes a K element; at
// most 4 with int4 weights
int frame_rows(int B, int tsize, bool i4) {
  int mt = B == 1 ? 1 : B == 2 ? 2 : B <= 4 ? 4 : 8;
  if (mt * tsize > 16) mt = 16 / tsize;
  return i4 && mt > kFMaxMT4 ? kFMaxMT4 : mt;
}

bool bad_frame(const FrameArgs& a, int mt, int tsize) {
  const bool pow2 = a.hd >= 8 && a.hd <= kFMaxHd && !(a.hd & (a.hd - 1));
  int n4 = 0;
  for (int i = 0; i < 5; ++i) {
    if (a.kind[i] < kDense || a.kind[i] > kInt4 ||
        (a.kind[i] != kDense) != (a.sc[i] != nullptr) ||
        (a.kind[i] == kInt4) != (a.m8[i] != nullptr) || a.w[i] == nullptr)
      return true;
    n4 += a.kind[i] == kInt4;
  }
  // int4: all five or none, whole pairs of groups in every K, a chunk of
  // whole multiplier copies holding two groups of a batch
  const int g2 = 2 * kGroup4;
  if (n4 != 0 && (n4 != 5 || a.H % g2 || a.F % g2 || (a.nq * a.hd) % g2 ||
                  a.chunk % 1024 || a.chunk < 4096))
    return true;
  return a.B < 1 || a.B > kFMaxB || mt != frame_rows(a.B, tsize, n4 != 0) ||
         a.L < 1 || !pow2 || a.nk < 1 || a.nq % a.nk ||
         a.nq / a.nk > kFMaxG || a.H % kUnit || a.F % kUnit ||
         a.H > kXPer * kFThreads || a.CV % kUnit || a.R < 1 ||
         a.rows0 < 0 || a.rows0 > a.R || a.chunk < 1024 || a.chunk % 16;
}

}  // namespace

extern "C" {

// out[0] = resident blocks per SM of the kernel (dtype: 0 float32, 1
// bfloat16; mt: x rows a pass, 1, 2, 4 or, in bf16, 8) at `smem` bytes of
// dynamic shared memory, out[1] the device's opt-in shared memory per
// block, out[2] its SM count; returns a cudaError_t.
int predictor_frame_query(int dtype, int mt, int smem, int* out) {
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
  const FrameKernel kernel = frame_kernel_of(dtype, mt);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, kFBlock,
                                                      smem);
  return static_cast<int>(e);
}

// One frame: `args` a FrameArgs (ops/fused_predictor.py _FrameArgs), nb
// blocks (SMs x resident blocks), smem = the fixed part + kFRing buffers
// (chunk bytes, and a 64th of that for int4's multipliers).
int predictor_frame_launch(const void* args, int dtype, int mt, int nb,
                           int smem, void* stream) {
  if (args == nullptr || (dtype != 0 && dtype != 1) || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const FrameArgs a = *static_cast<const FrameArgs*>(args);
  const int tsize = dtype == 0 ? 4 : 2;
  if (bad_frame(a, mt, tsize) ||
      smem != fixed_smem(mt, kmax_of(a.H, a.nq, a.hd, a.F), a.hd, tsize) +
                  kFRing * f_buf(a))
    return static_cast<int>(cudaErrorInvalidValue);
  const FrameKernel kernel = frame_kernel_of(dtype, mt);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb, 1, 1);
  cfg.blockDim = dim3(kFBlock, 1, 1);
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
