// Device helpers shared by the persistent kernels (predictor_frame.cu,
// talker_step.cu): mbarriers and TMA bulk copies, the atomics of the
// talker's split and head counters, the counting grid barrier, the 8-wide
// shared-memory weight loads and the int4 product of a ring chunk.

#pragma once

#include "gemv.cuh"

namespace {

constexpr unsigned long long kSpinLimitNs = 5000000000ull;   // 5 s

// ---------------------------------------------------------------- memory
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}
// arrive on the buffer's barrier, expecting `bytes` from the bulk copies
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try(unsigned long long* bar,
                                         unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ unsigned long long global_ns();
// wait for the buffer's copies; a wait longer than kSpinLimitNs traps
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  if (mbar_try(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try(bar, parity))
    if (global_ns() - t0 > kSpinLimitNs) __trap();
}
// one TMA bulk copy global -> shared, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// an L2 policy that evicts first what it covers (the talker's weight
// stream, read once a step, so that it does not evict the small tensors
// every stage reads)
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
// bulk_copy under an L2 cache policy
__device__ __forceinline__ void bulk_copy_hint(void* dst, const void* src,
                                               unsigned bytes,
                                               unsigned long long* bar,
                                               unsigned long long policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}
// bring `bytes` (a multiple of 16) at src into the L2, no completion
__device__ __forceinline__ void bulk_prefetch_l2(const void* src,
                                                 unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src),
               "r"(bytes)
               : "memory");
}
// bring a line into the L2 ahead of its use, kept there longer
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2::evict_last [%0];\n" ::"l"(p));
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p) {
  unsigned v;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned ld_acquire32(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
// a release add that returns nothing (the talker's head arrival counters)
__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The counting grid barrier: cnt is a 64-bit arrival count that only grows
// (by the grid size at every barrier; it never wraps in practice). A
// block's thread 0 adds its arrival with a release reduction, which
// returns nothing (the arrivals pipeline at the L2 and no block has to be
// the last one), and spins with acquire loads until the count reaches
// `next`, the barrier's multiple of the grid size. A block synchronisation
// before and after carries the block's writes into the release and the
// acquire to the block's reads (the pattern of CUTLASS's generic barrier).
// Data written in the kernel is read with plain loads after it, never
// through the non-coherent path (__ldg). grid_count_base gives the first
// `next` of a launch: read before the block's first arrival, the count
// lies in [C0, C0 + nb) with C0 the multiple of nb that the last launch
// left (the first barrier cannot complete without this block), so a
// count word serves launches of one grid size only (the workspaces that
// hold it are kept per grid). Why a count and not an arrive-and-reset
// barrier (an acquire-release add, the last arriver resetting the count
// and publishing a generation): from the last arrival to the first
// release it took 0.62-1.11 us against 1.01-2.02 on an H100 80GB HBM3 at
// 700 W (PERF.md).
__device__ __forceinline__ unsigned long long grid_count_base(
    const unsigned long long* cnt) {
  const unsigned long long v = ld_acquire64(cnt);
  return v - v % gridDim.x + gridDim.x;
}
__device__ __forceinline__ void grid_count_wait(unsigned long long* cnt,
                                                unsigned long long& next) {
  asm volatile("red.release.gpu.global.add.u64 [%0], 1;\n" ::"l"(cnt)
               : "memory");
  if (ld_acquire64(cnt) < next) {
    const unsigned long long t0 = global_ns();
    unsigned spins = 0;
    while (ld_acquire64(cnt) < next) {
      if ((++spins & 1023u) == 0 && global_ns() - t0 > kSpinLimitNs)
        __trap();                   // blocks not co-resident: fail, not hang
    }
  }
  next += gridDim.x;
}

// named barrier 1 over the first n threads of the block (a multiple of 32):
// the block's other warps (a producer) run on
__device__ __forceinline__ void sync_first(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// The traces of tools/frame_measure.py (block 0's stamps, args.trace) are
// compiled in only with -DKERNEL_TRACE (kernels/build.py trace_build): a
// kernel's trace code tests kTrace first, so the library the port runs
// carries none of it.
#ifdef KERNEL_TRACE
constexpr bool kTrace = true;
#else
constexpr bool kTrace = false;
#endif

// the thread that writes a traced launch's stamps: block 0's thread 0
__device__ __forceinline__ bool trace_thread(const void* trace) {
  return kTrace && trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
}

// the grid barrier of the blocks' first n threads (all of a block without
// a producer warp) on the count `cnt`, `next` thread 0's (grid_count_base
// at the launch's start); ti counts the barriers. `tr`: null, or the
// block's trace, where its thread 0 stamps the block's arrival at tr[2 ti]
// and its release at tr[2 ti + 1] (tools/frame_measure.py)
__device__ __forceinline__ void grid_barrier_first(unsigned long long* cnt,
                                                   unsigned long long& next,
                                                   int n,
                                                   unsigned long long* tr,
                                                   int& ti) {
  sync_first(n);
  if (threadIdx.x == 0) {
    if (kTrace && tr != nullptr) tr[2 * ti] = global_ns();
    grid_count_wait(cnt, next);
    if (kTrace && tr != nullptr) tr[2 * ti + 1] = global_ns();
  }
  ++ti;
  sync_first(n);
}

// 8 weights of one unit row from shared memory
__device__ __forceinline__ Raw<float> ld_sm(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return {q[0], q[1]};
}
__device__ __forceinline__ Raw<__nv_bfloat16> ld_sm(const __nv_bfloat16* p) {
  return {*reinterpret_cast<const uint4*>(p)};
}
__device__ __forceinline__ Raw<int8_t> ld_sm(const int8_t* p) {
  return {*reinterpret_cast<const uint2*>(p)};
}

// x values k and k + 1 of a staged row (k even), one load: the two weight
// rows of an int4 packed row
__device__ __forceinline__ float2 x_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 x_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

constexpr int kG4Rows = kGroup4 / 2;     // packed int4 rows of a group

// The int4 product of one ring chunk (talker_step.cu, predictor_frame.cu),
// the weights' rows paired in a byte (ops/fused_predictor.py pair_int4: row
// 2r low nibble, 2r + 1 high): a warp takes the chunk's groups of 64 packed
// rows in turn (kWarps warps), a lane two of a group's packed rows (weight
// rows k .. k + 3, x from the staged rows xs); the lane's dot with the
// biased nibbles less 8 (exact in f32, gemv.cuh unpack4), then times the
// group's multiplier once, in f32, into the unit sums v[(ub kMT + m) 8 + j].
// Unit ub's packed rows at vals + ub rn 8, its multipliers at mul + ub rn /
// 8; loads first, without branches: past nub the last unit again (its sums
// are never stored).
template <typename T, int kMT, int kUB, int kAcc, int kWarps>
__device__ __forceinline__ void int4_chunk(const unsigned char* vals,
                                           const unsigned char* mul, int rn,
                                           int nub, const T* xs, int K,
                                           int r0, float (&v)[kAcc]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ustride = rn * kVec;
  const int ng = rn / kG4Rows;
  for (int gi = warp; gi < ng; gi += kWarps) {
    float dd[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) dd[i] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pr = gi * kG4Rows + h * 32 + lane;
      const int k = 2 * (r0 + pr);              // weight rows k, k + 1
      uint2 q[kUB];
#pragma unroll
      for (int ub = 0; ub < kUB; ++ub)
        q[ub] = *reinterpret_cast<const uint2*>(
            vals + min(ub, nub - 1) * ustride + pr * kVec);
      float2 xv[kMT];
#pragma unroll
      for (int m = 0; m < kMT; ++m) xv[m] = x_pair(xs + m * K + k);
#pragma unroll
      for (int ub = 0; ub < kUB; ++ub) {
        float lo[kVec], hi[kVec];
        unpack4(q[ub].x, lo, hi);
        unpack4(q[ub].y, lo + 4, hi + 4);
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            float& acc = dd[(ub * kMT + m) * kVec + j];
            acc = fmaf(xv[m].x, lo[j], acc);
            acc = fmaf(xv[m].y, hi[j], acc);
          }
      }
    }
#pragma unroll
    for (int ub = 0; ub < kUB; ++ub) {
      float mf[kVec];
      m8_cvt(*reinterpret_cast<const uint2*>(
                 mul + min(ub, nub - 1) * (rn / 8) + gi * kVec),
             mf);
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const int i = (ub * kMT + m) * kVec + j;
          v[i] = fmaf(dd[i], mf[j], v[i]);
        }
    }
  }
}

__device__ __forceinline__ void store_x(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_x(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);      // v is already T-rounded: exact
}

// an mbarrier expecting `count` arrivals a phase (the weight ring's
// "empty" barriers: one arrival per consumer warp)
__device__ __forceinline__ void mbar_init_count(unsigned long long* bar,
                                                unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// one arrival on an mbarrier, no transaction bytes
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

}  // namespace
