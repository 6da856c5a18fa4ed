// Chunk-engine SpMV over a row-sorted pattern (p = 1):
//   y[r] = sum over e in [indptr[r], indptr[r + 1]) of vals[e] * x[cols[e]].
//
// Replaces the JAX package's chunk_spmv (pallas_call at
// torchsparsegradutils_tpu/kernels/chunk_spmm.py:296), the matvec of
// p = 1 sparse_mm, of its transpose (over the transpose plan) and of the
// Krylov solvers.  chunk_spmm.cu at p = 1 would run one column per warp
// and idle 31 of its 32 lanes, so the matvec is a kernel of its own, as
// on the TPU: one warp per row with the lanes across the row's entries
// (lane l takes entries beg + l, beg + l + 32, ...), then a fixed
// butterfly of shuffles.  No atomics: the result is the same on every
// run; an empty row writes 0.
//
// Shapes: indptr (n + 1,) int64, cols (nnz,) int64, vals (nnz,), x (m,),
// y (n,); contiguous.
//
// What bounds it on an H100: bytes.  The least traffic at the uniform
// random cfd2 shape (n = m = 123,440, nnz = 3.09M, f32) is vals 12.4 MB +
// cols 24.7 MB + indptr 1 MB + x 0.5 MB + y 0.5 MB, about 11 us at
// 3.35 TB/s; 2 nnz FLOP is nothing.  x fits in L2, so its random reads
// are L2 hits; vals and cols stream coalesced.  Rows of the random
// pattern hold 25 entries on average, so a warp's lanes are 78 % busy.
#include "tsgu_common.cuh"

namespace {

constexpr int WARPS = 8;  // rows per block

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
chunk_spmv_kernel(const int64_t* __restrict__ indptr,
                  const int64_t* __restrict__ cols,
                  const T* __restrict__ vals, const T* __restrict__ x,
                  T* __restrict__ y, int64_t n) {
  using A = typename tsgu::Acc<T>::type;
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n) return;  // the whole warp leaves together
  const int64_t end = indptr[r + 1];
  A s = A(0);
  for (int64_t e = indptr[r] + lane; e < end; e += 32) {
    s = tsgu::fma_acc(tsgu::load_acc(vals + e), tsgu::load_acc(x + cols[e]),
                      s);
  }
  s = tsgu::warp_sum(s);
  if (lane == 0) tsgu::store_acc(y + r, s);
}

template <typename T>
int launch(const void* indptr, const void* cols, const void* vals,
           const void* x, void* y, int64_t n, void* stream) {
  const unsigned blocks = (unsigned)((n + WARPS - 1) / WARPS);
  chunk_spmv_kernel<T><<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int64_t*)indptr, (const int64_t*)cols, (const T*)vals,
      (const T*)x, (T*)y, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tsgu_chunk_spmv_f32(const void* indptr, const void* cols,
                        const void* vals, const void* x, void* y, int64_t n,
                        void* stream) {
  return launch<float>(indptr, cols, vals, x, y, n, stream);
}

int tsgu_chunk_spmv_bf16(const void* indptr, const void* cols,
                         const void* vals, const void* x, void* y, int64_t n,
                         void* stream) {
  return launch<__nv_bfloat16>(indptr, cols, vals, x, y, n, stream);
}

int tsgu_chunk_spmv_f64(const void* indptr, const void* cols,
                        const void* vals, const void* x, void* y, int64_t n,
                        void* stream) {
  return launch<double>(indptr, cols, vals, x, y, n, stream);
}

}  // extern "C"
