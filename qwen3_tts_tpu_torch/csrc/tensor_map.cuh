// Host side of TMA tiled copies, shared by probes.cu and qmatmul.cu:
// cuTensorMapEncodeTiled looked up at run time (cudaGetDriverEntryPoint),
// so the library links without -lcuda, and a 2-D row-major map.

#pragma once

#include <cuda.h>           // CUtensorMap and its enums only; no -lcuda
#include <cuda_runtime.h>

namespace {

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a row-major [rows, cols] tensor with rows `row_bytes` apart, read in
// (box_rows x box_cols) boxes; out-of-range elements read as zero
cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType type,
                     const void* base, int rows, int cols, long long row_bytes,
                     int box_rows, int box_cols,
                     CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE,
                     CUtensorMapL2promotion promo =
                         CU_TENSOR_MAP_L2_PROMOTION_NONE) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  cuuint32_t estr[2] = {1, 1};
  CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box,
                  estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, promo,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
