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
#include <string.h>

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

// Four consecutive storage elements as one load or store: 16 bytes of
// float, 8 of bfloat16, two 16-byte halves of double.  The caller
// guarantees the alignment (chunk kernels: p % 4 == 0 and 16-byte base
// pointers, so every row start qualifies).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a, b;
  memcpy(&a, &q.x, 4);
  memcpy(&b, &q.y, 4);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  v[0] = fa.x; v[1] = fa.y; v[2] = fb.x; v[3] = fb.y;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      double (&v)[4]) {
  float f[4];
  load4(p, f);
  v[0] = f[0]; v[1] = f[1]; v[2] = f[2]; v[3] = f[3];
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  memcpy(&q.x, &a, 4);
  memcpy(&q.y, &b, 4);
  *reinterpret_cast<uint2*>(p) = q;
}
__device__ __forceinline__ void store4(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// Columns of a dense row that one warp covers at a time: 32 lanes x 4.
constexpr int TILE = 128;

// A lane's four columns of the tile that starts at column t0 of a row of
// p: with VEC the consecutive t0 + 4 lane + i (one vector access; needs
// p % 4 == 0), else the strided t0 + lane + 32 i.  Columns at or past p
// read as 0 and are not written.
template <bool VEC, typename T, typename A>
__device__ __forceinline__ void load_tile(const T* row, int64_t t0, int lane,
                                          int64_t p, A (&v)[4]) {
  if (VEC) {
    const int64_t j = t0 + 4 * lane;
    if (j < p) {
      load4(row + j, v);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = A(0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t j = t0 + lane + 32 * i;
      v[i] = j < p ? load_acc(row + j) : A(0);
    }
  }
}

template <bool VEC, typename T, typename A>
__device__ __forceinline__ void store_tile(T* row, int64_t t0, int lane,
                                           int64_t p, const A (&v)[4]) {
  if (VEC) {
    const int64_t j = t0 + 4 * lane;
    if (j < p) store4(row + j, v);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t j = t0 + lane + 32 * i;
      if (j < p) store_acc(row + j, v[i]);
    }
  }
}

// Sum over the 32 lanes of a warp; every lane gets the total.  The
// butterfly order is fixed, so the result is the same on every run.
template <typename A>
__device__ __forceinline__ A warp_sum(A s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Whether the vector path may take rows of p elements at these bases.
__host__ __forceinline__ bool vec_ok(int64_t p, const void* a,
                                     const void* b) {
  return p % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

}  // namespace tsgu
