// Kernel B8: gemv B over int8 weights with a per-column f32 scale, with
// B's prologues and epilogues (design: gemv.cu; device code: gemv.cuh).

#include "gemv.cuh"

namespace {

template <typename T, int kPro, bool kAm>
int launch8(const void* x, const void* q, const float* scale, const void* ln,
            float eps, void* out, int M, int K, int N, int ldw, int col0,
            int splits, int epi, const QkArgs& qk, const ArgmaxArgs& am,
            cudaStream_t st) {
  return by_rows<kMaxMT>(M, [&](auto mt) {
    return launch_cluster(
        gemv_cluster<T, int8_t, decltype(mt)::value, kPro, kAm>, mt, M, N,
        splits, st, static_cast<const XT<T, kPro>*>(x), static_cast<const int8_t*>(q),
        scale, static_cast<const T*>(ln), eps, out, M, K, N, ldw, col0, epi,
        qk, am);
  });
}

template <typename T>
int blocks_per_sm8(int M, int pro) {
  return by_pro(pro, [&](auto p) {
    return by_rows<kMaxMT>(M, [](auto mt) {
      return occupancy(
          gemv_cluster<T, int8_t, decltype(mt)::value, decltype(p)::value>);
    });
  });
}

}  // namespace

int gemv_int8_blocks_per_sm(int dtype, int M, int pro) {
  return dtype == 0 ? blocks_per_sm8<float>(M, pro)
                    : blocks_per_sm8<__nv_bfloat16>(M, pro);
}

extern "C" {

// B8: int8 q [K, ldw], f32 scale [ldw]; the other arguments as gemv_launch's.
int gemv_int8_launch(const void* x, const void* q, const void* scale,
                     const void* ln, void* out, int M, int K, int N, int ldw,
                     int col0, int splits, int dtype, int epi, float eps,
                     int pro, const void* qk, const void* am,
                     void* stream) {
  if (bad_args(M, K, N, col0, splits, pro, ln, epi,
               static_cast<const QkArgs*>(qk),
               static_cast<const ArgmaxArgs*>(am)))
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
        return launch8<float, kP, kA>(x, q, sc, ln, eps, out, M, K, N, ldw,
                                      col0, splits, epi, a, g, st);
      return launch8<__nv_bfloat16, kP, kA>(x, q, sc, ln, eps, out, M, K, N,
                                            ldw, col0, splits, epi, a, g,
                                            st);
    });
  });
}

}  // extern "C"
