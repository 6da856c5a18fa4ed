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

// A product rounded to nearest on its own: the compiler does not contract
// it with a later add into an FMA.
__device__ __forceinline__ float mul_acc(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_acc(double a, double b) {
  return __dmul_rn(a, b);
}

// Largest diagonal count of a DIA plan (kernels/dia.py MAX_DIAGS).
constexpr int MAX_DIAGS = 256;

// Four consecutive storage elements as one load or store: 16 bytes of
// float, 8 of bfloat16, two 16-byte halves of double.  The caller
// guarantees the alignment.
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

// Sum over the 32 lanes of a warp; every lane gets the total.  The
// butterfly order is fixed, so the result is the same on every run.
template <typename A>
__device__ __forceinline__ A warp_sum(A s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// What resident_blocks keeps of one kernel, per device: the shared memory
// it was opted in to, and the blocks that fit an SM at the last size
// asked.  Each kernel instantiation holds its own (a static of its launch
// function, zero at start).
struct Fit {
  int64_t opted[64], smem[64];
  int fit[64], sms[64];
};

// The blocks of NT threads with SMEM bytes of dynamic shared memory that
// fit the card at once, in *blocks.  Above 48 KB a kernel must opt in,
// once per device.  Returns a CUDA error code, 0 on success.
template <typename Kernel>
int resident_blocks(Kernel kernel, Fit& f, int NT, int64_t smem,
                    int64_t* blocks) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && f.opted[dev] < smem) {
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
    if (rc != cudaSuccess) return (int)rc;
    f.opted[dev] = smem;
  }
  if (f.smem[dev] != smem || f.fit[dev] == 0) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f.fit[dev], kernel,
                                                       NT, (size_t)smem);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&f.sms[dev],
                                  cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return (int)rc;
    if (f.fit[dev] == 0) return (int)cudaErrorInvalidConfiguration;
    f.smem[dev] = smem;
  }
  *blocks = (int64_t)f.fit[dev] * f.sms[dev];
  return 0;
}

}  // namespace tsgu
