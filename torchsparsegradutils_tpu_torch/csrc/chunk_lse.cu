// Row logsumexp of a row-sorted pattern, read as CSR, and its backward:
//   out[r] = log(sum over e in [indptr[r], indptr[r + 1]) of exp(v[e])
//                + (width - count_r) * exp(0) if include_zeros)      (K10)
//   d[e]   = exp(v[e] - out[r]) * g[r], 0 where out[r] is not finite or
//            v[e] = -inf                                              (K11)
//
// Replace the JAX package's _lse_partials and _lse_bwd_pass (pallas_call
// at torchsparsegradutils_tpu/kernels/chunk_lse.py:70 and :142).  The
// TPU kernels cut the entry stream into chunks, emit online (max, sum
// exp) partials per chunk-local row through one-hot (W, C) tiles and
// combine them with a segment max and sum (_lse_combine), because a TPU
// cannot scatter.  Here one warp owns one row: its lanes stride the
// row's entries keeping an online pair (m, s = sum exp(v - m)), the
// pairs merge by a fixed butterfly of shuffles, and lane 0 applies
// _lse_combine's rules (include_zeros mass, +inf passes, an empty or
// all -inf row gives -inf, or log(width - count) with include_zeros)
// and writes out[r].  No partials, no combine pass, no atomics: the
// result is the same on every run.
//
// Degree skew is why this route exists (the ELL grid refuses a pattern
// whose longest row exceeds 8x the mean), so one warp must not walk a
// long row alone: a row of more than HEAVY entries is taken by the whole
// block of 8 warps after the light rows, the warps' pairs merged through
// shared memory.  A 100,000-entry row then costs about 400 steps a
// thread instead of 3,125.
//
// Shapes: indptr (n + 1,) int64, vals (nnz,) of T, out and g (n,) and
// the sums in float (T = float or bfloat16) or double (T = double);
// d (nnz,) of T.
//
// What bounds them on an H100: bytes.  At the skewed cfd2 shape (n =
// 123,440, nnz = 3.09M, f32) K10 reads 12.35 MB of values and 0.99 MB of
// row pointers and writes 0.49 MB, 4.1 us at 3.35 TB/s; K11 moves
// 26.7 MB, 8.0 us; one exp per entry is far below the card's rate.
#include "tsgu_common.cuh"

#include <math.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int64_t HEAVY = 1024;  // longer rows take the whole block

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }
__device__ __forceinline__ bool fin(float x) { return fabsf(x) < INFINITY; }
__device__ __forceinline__ bool fin(double x) { return fabs(x) < INFINITY; }

// Add one value to the online pair (m, s).  -inf adds nothing; a +inf
// makes m = +inf, which decides the result whatever s becomes.
template <typename A>
__device__ __forceinline__ void push(A& m, A& s, A v) {
  if (v > m) {
    s = s * ex(m - v) + A(1);
    m = v;
  } else if (v != A(-INFINITY)) {
    s += ex(v - m);
  }
}

// Merge (m2, s2) into (m, s).  Symmetric in its two pairs, so both
// lanes of a butterfly step hold the same bits afterwards.
template <typename A>
__device__ __forceinline__ void merge(A& m, A& s, A m2, A s2) {
  const A mm = m > m2 ? m : m2;
  s = mm == A(-INFINITY) ? A(0) : s * ex(m - mm) + s2 * ex(m2 - mm);
  m = mm;
}

template <typename A>
__device__ __forceinline__ void warp_merge(A& m, A& s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const A m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const A s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
  }
}

// The row's result from its pair: _lse_combine's rules.
template <typename A>
__device__ __forceinline__ A finish(A m, A s, int64_t count, int64_t width,
                                    bool include_zeros) {
  if (m == A(INFINITY)) return A(INFINITY);
  A shift = fin(m) ? m : A(0);
  A S = m == A(-INFINITY) ? A(0) : s;
  const A z = A(width - count);
  if (include_zeros && z > A(0)) {
    const A mz = shift > A(0) ? shift : A(0);
    S = S * ex(shift - mz) + z * ex(-mz);
    shift = mz;
  }
  return S == A(0) ? A(-INFINITY) : shift + lg(S);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lse_rows_kernel(const int64_t* __restrict__ indptr, const T* __restrict__ v,
                typename tsgu::Acc<T>::type* __restrict__ out, int64_t n,
                int64_t width, bool include_zeros) {
  using A = typename tsgu::Acc<T>::type;
  __shared__ A sm[WARPS], ss[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * WARPS;
  const int64_t r = base + warp;
  if (r < n) {
    const int64_t beg = indptr[r], end = indptr[r + 1];
    if (end - beg <= HEAVY) {
      A m = A(-INFINITY), s = A(0);
      for (int64_t e = beg + lane; e < end; e += 32) {
        push(m, s, tsgu::load_acc(v + e));
      }
      warp_merge(m, s);
      if (lane == 0) out[r] = finish(m, s, end - beg, width, include_zeros);
    }
  }
  // the block's heavy rows, one after another, by all its threads (the
  // test below reads the same pointers in every thread: no divergence
  // around the barriers)
  for (int w = 0; w < WARPS && base + w < n; ++w) {
    const int64_t beg = indptr[base + w], end = indptr[base + w + 1];
    if (end - beg <= HEAVY) continue;
    A m = A(-INFINITY), s = A(0);
    for (int64_t e = beg + threadIdx.x; e < end; e += THREADS) {
      push(m, s, tsgu::load_acc(v + e));
    }
    warp_merge(m, s);
    if (lane == 0) {
      sm[warp] = m;
      ss[warp] = s;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 1; k < WARPS; ++k) merge(m, s, sm[k], ss[k]);
      out[base + w] = finish(m, s, end - beg, width, include_zeros);
    }
    __syncthreads();
  }
}

template <typename T, typename A>
__device__ __forceinline__ void bwd_entry(const T* v, T* d, int64_t e, A o,
                                          A g, bool ok) {
  const A x = tsgu::load_acc(v + e);
  tsgu::store_acc(d + e, ok && x != A(-INFINITY) ? ex(x - o) * g : A(0));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lse_rows_bwd_kernel(const int64_t* __restrict__ indptr,
                    const T* __restrict__ v,
                    const typename tsgu::Acc<T>::type* __restrict__ out,
                    const typename tsgu::Acc<T>::type* __restrict__ g,
                    T* __restrict__ d, int64_t n) {
  using A = typename tsgu::Acc<T>::type;
  const int lane = threadIdx.x & 31;
  const int64_t base = (int64_t)blockIdx.x * WARPS;
  const int64_t r = base + (threadIdx.x >> 5);
  if (r < n) {
    const int64_t beg = indptr[r], end = indptr[r + 1];
    if (end - beg <= HEAVY) {
      const A o = out[r], gr = g[r];
      const bool ok = fin(o);
      for (int64_t e = beg + lane; e < end; e += 32) {
        bwd_entry(v, d, e, o, gr, ok);
      }
    }
  }
  for (int w = 0; w < WARPS && base + w < n; ++w) {
    const int64_t beg = indptr[base + w], end = indptr[base + w + 1];
    if (end - beg <= HEAVY) continue;
    const A o = out[base + w], gr = g[base + w];
    const bool ok = fin(o);
    for (int64_t e = beg + threadIdx.x; e < end; e += THREADS) {
      bwd_entry(v, d, e, o, gr, ok);
    }
  }
}

inline unsigned blocks(int64_t n) {
  return (unsigned)((n + WARPS - 1) / WARPS);
}

template <typename T>
int launch_fwd(const void* indptr, const void* v, void* out, int64_t n,
               int64_t width, int64_t include_zeros, void* stream) {
  using A = typename tsgu::Acc<T>::type;
  lse_rows_kernel<T><<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)indptr, (const T*)v, (A*)out, n, width,
      include_zeros != 0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* indptr, const void* v, const void* out,
               const void* g, void* d, int64_t n, void* stream) {
  using A = typename tsgu::Acc<T>::type;
  lse_rows_bwd_kernel<T><<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)indptr, (const T*)v, (const A*)out, (const A*)g,
      (T*)d, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tsgu_lse_rows_f32(const void* indptr, const void* v, void* out,
                      int64_t n, int64_t width, int64_t include_zeros,
                      void* stream) {
  return launch_fwd<float>(indptr, v, out, n, width, include_zeros, stream);
}

int tsgu_lse_rows_bf16(const void* indptr, const void* v, void* out,
                       int64_t n, int64_t width, int64_t include_zeros,
                       void* stream) {
  return launch_fwd<__nv_bfloat16>(indptr, v, out, n, width, include_zeros,
                                   stream);
}

int tsgu_lse_rows_f64(const void* indptr, const void* v, void* out,
                      int64_t n, int64_t width, int64_t include_zeros,
                      void* stream) {
  return launch_fwd<double>(indptr, v, out, n, width, include_zeros, stream);
}

int tsgu_lse_rows_bwd_f32(const void* indptr, const void* v, const void* out,
                          const void* g, void* d, int64_t n, void* stream) {
  return launch_bwd<float>(indptr, v, out, g, d, n, stream);
}

int tsgu_lse_rows_bwd_bf16(const void* indptr, const void* v,
                           const void* out, const void* g, void* d,
                           int64_t n, void* stream) {
  return launch_bwd<__nv_bfloat16>(indptr, v, out, g, d, n, stream);
}

int tsgu_lse_rows_bwd_f64(const void* indptr, const void* v, const void* out,
                          const void* g, void* d, int64_t n, void* stream) {
  return launch_bwd<double>(indptr, v, out, g, d, n, stream);
}

}  // extern "C"
