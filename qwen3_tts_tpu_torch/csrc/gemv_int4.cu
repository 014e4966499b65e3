// Kernel B4: gemv over packed biased int4 weights in the panel order of
// quant.panel_matmul4, with B's prologues and epilogues (design: gemv.cu;
// device code: gemv.cuh).

#include "gemv.cuh"

namespace {

template <typename T, int kPro, bool kAm>
int launch4(const void* x, const void* w, const void* m8, const float* scale,
            const void* ln, float eps, void* out, int M, int K, int N,
            int ldw, int ldm, int col0, int splits, int epi,
            const QkArgs& qk, const ArgmaxArgs& am, cudaStream_t st) {
  return by_rows<kMaxMT4>(M, [&](auto mt) {
    return launch_cluster(
        gemv4_cluster<T, decltype(mt)::value, kPro, kAm>, mt, M, N, splits,
        st,
        static_cast<const XT<T, kPro>*>(x), static_cast<const uint8_t*>(w),
        static_cast<const int8_t*>(m8), scale, static_cast<const T*>(ln),
        eps, out, M, K, N, ldw, ldm, col0, epi, qk, am);
  });
}

template <typename T>
int blocks_per_sm4(int M, int pro) {
  return by_pro(pro, [&](auto p) {
    return by_rows<kMaxMT4>(M, [](auto mt) {
      return occupancy(
          gemv4_cluster<T, decltype(mt)::value, decltype(p)::value>);
    });
  });
}

}  // namespace

int gemv_int4_blocks_per_sm(int dtype, int M, int pro) {
  return dtype == 0 ? blocks_per_sm4<float>(M, pro)
                    : blocks_per_sm4<__nv_bfloat16>(M, pro);
}

extern "C" {

// B4: packed q4 [K/2, ldw], m8 [K/128, ldm], f32 scale [ldw]; K a multiple
// of 256, splits at most K / 256 (whole packed groups a rank); the other
// arguments as gemv_launch's.
int gemv_int4_launch(const void* x, const void* q4, const void* m8,
                     const void* scale, const void* ln, void* out, int M,
                     int K, int N, int ldw, int ldm, int col0, int splits,
                     int dtype, int epi, float eps, int pro, const void* qk,
                     const void* am, void* stream) {
  if (bad_args(M, K, N, col0, splits, pro, ln, epi,
               static_cast<const QkArgs*>(qk),
               static_cast<const ArgmaxArgs*>(am)) ||
      K % (2 * kGroup4) || splits > K / (2 * kGroup4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const QkArgs a = qk_or_none(qk);
  const ArgmaxArgs g = am_or_none(am);
  return by_pro(pro, [&](auto p) {
    constexpr int kP = decltype(p)::value;
    return by_am<kP>(epi, [&](auto am_on) {
      constexpr bool kA = decltype(am_on)::value;
      if (dtype == 0)
        return launch4<float, kP, kA>(x, q4, m8, sc, ln, eps, out, M, K, N,
                                      ldw, ldm, col0, splits, epi, a, g, st);
      return launch4<__nv_bfloat16, kP, kA>(x, q4, m8, sc, ln, eps, out, M, K,
                                            N, ldw, ldm, col0, splits, epi, a,
                                            g, st);
    });
  });
}

}  // extern "C"
