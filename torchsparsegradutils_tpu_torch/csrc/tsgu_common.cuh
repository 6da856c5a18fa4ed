// Shared helpers of the hand-written kernels: the accumulation type of
// each storage type, and the loads, stores and fused multiply-adds in it.
//
// float and __nv_bfloat16 accumulate in float, double in double.  Every
// multiply-add is an explicit fused one (__fmaf_rn / __fma_rn): exact
// IEEE FMA on the CUDA cores, never a tensor-core TF32 product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tsgu {

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float load_acc(const float* p) { return *p; }
__device__ __forceinline__ float load_acc(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ double load_acc(const double* p) { return *p; }

__device__ __forceinline__ void store_acc(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_acc(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_acc(double* p, double v) { *p = v; }

__device__ __forceinline__ float fma_acc(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_acc(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// Largest diagonal count of a DIA plan (kernels/dia.py MAX_DIAGS).
constexpr int MAX_DIAGS = 256;

}  // namespace tsgu
