// Chunk-engine SDDMM at a row-sorted pattern, in the entries' own order:
//   out[e] = dot(X[r, :], Y[cols[e], :]) for e in [indptr[r], indptr[r + 1]).
//
// Replaces the JAX package's chunk_sddmm (pallas_call at
// torchsparsegradutils_tpu/kernels/chunk_spmm.py:349).  The TPU kernel
// expands each chunk's X rows with a one-hot MXU product over a window
// of W rows; here one warp owns one row r, so X[r] is read once and kept
// in registers (the first 128 columns; wider rows loop over further
// tiles, re-read from L1).  It is gradA of a general SpMM and the forward
// of a general sddmm.
//
// Shapes: indptr (n + 1,) int64, cols (nnz,) int64, X (n, p), Y (m, p),
// out (nnz,); row-major and contiguous.  For p <= NARROW_P the lanes run
// across the row's entries instead, each lane a whole dot, so a narrow
// (p = 1) gradA does not idle 31 lanes.
//
// What bounds it on an H100: bytes.  The least traffic at the uniform
// random cfd2 shape (n = m = 123,440, nnz = 3.09M, p = 128, f32) is X and
// Y 63.2 MB each + cols 24.7 MB + indptr 1 MB + out 12.4 MB, about 49 us
// at 3.35 TB/s, against 2 nnz p = 0.79 GFLOP, 12 us at 67 TFLOP/s.  As in
// chunk_spmm.cu the Y rows come in random order from a Y larger than L2,
// one random row read per entry.  Design: a warp reads a whole Y row tile
// per entry, UNROLL entries' rows in flight, and a fixed butterfly of
// shuffles sums each dot; lane (e mod 32) writes out[e].  No atomics: the
// result is the same on every run.
#include "tsgu_common.cuh"

namespace {

constexpr int WARPS = 8;     // rows per block
constexpr int UNROLL = 4;    // entries whose Y rows are loaded together
constexpr int NARROW_P = 8;  // at or below: lanes across entries

template <typename T, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
chunk_sddmm_kernel(const int64_t* __restrict__ indptr,
                   const int64_t* __restrict__ cols,
                   const T* __restrict__ X, const T* __restrict__ Y,
                   T* __restrict__ out, int64_t n, int64_t p) {
  using A = typename tsgu::Acc<T>::type;
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n) return;  // the whole warp leaves together
  const int64_t beg = indptr[r], end = indptr[r + 1];
  if (beg == end) return;
  const T* x = X + r * p;

  if (p <= NARROW_P) {
    A xr[NARROW_P];
#pragma unroll
    for (int j = 0; j < NARROW_P; ++j) {
      xr[j] = j < p ? tsgu::load_acc(x + j) : A(0);
    }
    for (int64_t e = beg + lane; e < end; e += 32) {
      const T* y = Y + cols[e] * p;
      A s = A(0);
#pragma unroll
      for (int j = 0; j < NARROW_P; ++j) {
        if (j < p) s = tsgu::fma_acc(xr[j], tsgu::load_acc(y + j), s);
      }
      tsgu::store_acc(out + e, s);
    }
    return;
  }

  A xt[4];
  tsgu::load_tile<VEC>(x, 0, lane, p, xt);
  for (int64_t e0 = beg; e0 < end; e0 += UNROLL) {
    A s[UNROLL];
    A y[UNROLL][4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      s[u] = A(0);
      if (e0 + u < end) {
        tsgu::load_tile<VEC>(Y + cols[e0 + u] * p, 0, lane, p, y[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (e0 + u < end) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[u] = tsgu::fma_acc(xt[i], y[u][i], s[u]);
        }
      }
    }
    for (int64_t t0 = tsgu::TILE; t0 < p; t0 += tsgu::TILE) {
      A xx[4];
      tsgu::load_tile<VEC>(x, t0, lane, p, xx);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (e0 + u < end) {
          tsgu::load_tile<VEC>(Y + cols[e0 + u] * p, t0, lane, p, y[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (e0 + u < end) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[u] = tsgu::fma_acc(xx[i], y[u][i], s[u]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const A total = tsgu::warp_sum(s[u]);
      const int64_t e = e0 + u;
      if (e < end && lane == (int)(e & 31)) tsgu::store_acc(out + e, total);
    }
  }
}

template <typename T>
int launch(const void* indptr, const void* cols, const void* X,
           const void* Y, void* out, int64_t n, int64_t p, void* stream) {
  const unsigned blocks = (unsigned)((n + WARPS - 1) / WARPS);
  void (*kernel)(const int64_t*, const int64_t*, const T*, const T*, T*,
                 int64_t, int64_t) =
      tsgu::vec_ok(p, X, Y) ? &chunk_sddmm_kernel<T, true>
                            : &chunk_sddmm_kernel<T, false>;
  kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int64_t*)indptr, (const int64_t*)cols, (const T*)X,
      (const T*)Y, (T*)out, n, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tsgu_chunk_sddmm_f32(const void* indptr, const void* cols, const void* X,
                         const void* Y, void* out, int64_t n, int64_t p,
                         void* stream) {
  return launch<float>(indptr, cols, X, Y, out, n, p, stream);
}

int tsgu_chunk_sddmm_bf16(const void* indptr, const void* cols,
                          const void* X, const void* Y, void* out, int64_t n,
                          int64_t p, void* stream) {
  return launch<__nv_bfloat16>(indptr, cols, X, Y, out, n, p, stream);
}

int tsgu_chunk_sddmm_f64(const void* indptr, const void* cols, const void* X,
                         const void* Y, void* out, int64_t n, int64_t p,
                         void* stream) {
  return launch<double>(indptr, cols, X, Y, out, n, p, stream);
}

}  // extern "C"
