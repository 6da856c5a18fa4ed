// Fused backward of a chunk-engine SpMM out = A @ B, given G = dL/dout:
//   pass 1 (K12a), over the row plan, for e in [indptr[r], indptr[r + 1]):
//     dd[e]   = dot(G[r, :], B[cols[e], :])          (gradA)
//     V[e, :] = vals[e] * G[r, :]                    (in V's dtype)
//   pass 2 (K12b), over the transpose plan (entries sorted by column):
//     dB[c, :] = sum over d in [indptr_t[c], indptr_t[c + 1]) of
//                V[perm[d], :]                        (gradB = A^T G)
//
// Replaces the JAX package's chunk_spmm_bwd_fused (pallas_calls at
// torchsparsegradutils_tpu/kernels/chunk_spmm.py:429 and :462).  The TPU
// passes expand each chunk's G rows with a one-hot MXU product and
// reduce pass 2's chunks with a segment sum.  Here, as in chunk_sddmm.cu
// and chunk_spmm.cu, one warp owns one row: pass 1 keeps G[r]'s tile in
// registers, reads a B row tile per entry (UNROLL entries in flight),
// sums each dot by a fixed butterfly and writes the entry's V row tile
// beside it; p <= NARROW_P runs the lanes across entries instead.  Pass
// 1 walks its 128-column tiles inside the warp, as chunk_sddmm.cu does,
// because each dd[e] sums over all p columns (tiles over gridDim.y would
// need atomics or a second pass).  Pass 2 is chunk_spmm.cu with unit
// weights and a row gather of V through perm, 128-column tiles over
// gridDim.y.  No atomics: both passes give the same bits on every run,
// and dd equals chunk_sddmm.cu's.
//
// Types: T for vals, B, G, dd and dB (float, bfloat16 or double; sums in
// float for float and bfloat16, double for double); VT for V, T itself
// or bfloat16 (grad_precision="fast").
//
// What bounds it on an H100: bytes, and more of them than the split
// backward moves.  At the uniform random cfd2 shape (nnz = 3.09M, p =
// 128, f32) pass 1 must write V, nnz x p x 4 = 1,581 MB, beside G and B
// (63.2 MB each), vals, cols and dd: 1.76 GB, 0.52 ms at 3.35 TB/s; pass
// 2 reads V back (1,581 MB) with perm and writes dB (63.2 MB): 0.50 ms.
// The pair's bound, about 1.0 ms, is above the split backward's measured
// time; the fused path is kept for parity, not speed, and is not the
// default.
#include "tsgu_common.cuh"

namespace {

constexpr int WARPS = 8;     // rows (columns in pass 2) per block
constexpr int UNROLL = 4;    // entries whose rows are loaded together
constexpr int NARROW_P = 8;  // at or below: pass 1 lanes across entries

template <typename T, typename VT, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
bwd_rows_kernel(const int64_t* __restrict__ indptr,
                const int64_t* __restrict__ cols, const T* __restrict__ vals,
                const T* __restrict__ B, const T* __restrict__ G,
                T* __restrict__ dd, VT* __restrict__ V, int64_t n,
                int64_t p) {
  using A = typename tsgu::Acc<T>::type;
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n) return;  // the whole warp leaves together
  const int64_t beg = indptr[r], end = indptr[r + 1];
  if (beg == end) return;
  const T* g = G + r * p;

  if (p <= NARROW_P) {
    A gr[NARROW_P];
#pragma unroll
    for (int j = 0; j < NARROW_P; ++j) {
      gr[j] = j < p ? tsgu::load_acc(g + j) : A(0);
    }
    for (int64_t e = beg + lane; e < end; e += 32) {
      const T* b = B + cols[e] * p;
      const A v = tsgu::load_acc(vals + e);
      A s = A(0);
#pragma unroll
      for (int j = 0; j < NARROW_P; ++j) {
        if (j < p) {
          s = tsgu::fma_acc(gr[j], tsgu::load_acc(b + j), s);
          tsgu::store_acc(V + e * p + j, v * gr[j]);
        }
      }
      tsgu::store_acc(dd + e, s);
    }
    return;
  }

  for (int64_t e0 = beg; e0 < end; e0 += UNROLL) {
    A s[UNROLL], v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      s[u] = A(0);
      v[u] = e0 + u < end ? tsgu::load_acc(vals + e0 + u) : A(0);
    }
    for (int64_t t0 = 0; t0 < p; t0 += tsgu::TILE) {
      A gt[4], b[UNROLL][4];
      tsgu::load_tile<VEC>(g, t0, lane, p, gt);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (e0 + u < end) {
          tsgu::load_tile<VEC>(B + cols[e0 + u] * p, t0, lane, p, b[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (e0 + u < end) {
          A w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[u] = tsgu::fma_acc(gt[i], b[u][i], s[u]);
            w[i] = v[u] * gt[i];
          }
          tsgu::store_tile<VEC>(V + (e0 + u) * p, t0, lane, p, w);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const A total = tsgu::warp_sum(s[u]);
      const int64_t e = e0 + u;
      if (e < end && lane == (int)(e & 31)) tsgu::store_acc(dd + e, total);
    }
  }
}

template <typename T, typename VT, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
bwd_cols_kernel(const int64_t* __restrict__ indptr,
                const int64_t* __restrict__ perm, const VT* __restrict__ V,
                T* __restrict__ out, int64_t m, int64_t p) {
  using A = typename tsgu::Acc<T>::type;
  const int lane = threadIdx.x & 31;
  const int64_t c = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= m) return;
  const int64_t t0 = (int64_t)blockIdx.y * tsgu::TILE;
  const int64_t beg = indptr[c], end = indptr[c + 1];
  A acc[4] = {A(0), A(0), A(0), A(0)};
  for (int64_t d0 = beg; d0 < end; d0 += UNROLL) {
    A x[UNROLL][4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (d0 + u < end) {
        tsgu::load_tile<VEC>(V + perm[d0 + u] * p, t0, lane, p, x[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (d0 + u < end) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += x[u][i];
      }
    }
  }
  tsgu::store_tile<VEC>(out + c * p, t0, lane, p, acc);
}

template <typename T, typename VT>
int launch_rows(const void* indptr, const void* cols, const void* vals,
                const void* B, const void* G, void* dd, void* V, int64_t n,
                int64_t p, void* stream) {
  const unsigned blocks = (unsigned)((n + WARPS - 1) / WARPS);
  void (*kernel)(const int64_t*, const int64_t*, const T*, const T*,
                 const T*, T*, VT*, int64_t, int64_t) =
      tsgu::vec_ok(p, B, G) && tsgu::vec_ok(p, V, V)
          ? &bwd_rows_kernel<T, VT, true>
          : &bwd_rows_kernel<T, VT, false>;
  kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int64_t*)indptr, (const int64_t*)cols, (const T*)vals,
      (const T*)B, (const T*)G, (T*)dd, (VT*)V, n, p);
  return (int)cudaGetLastError();
}

template <typename T, typename VT>
int launch_cols(const void* indptr, const void* perm, const void* V,
                void* out, int64_t m, int64_t p, void* stream) {
  const dim3 blocks((unsigned)((m + WARPS - 1) / WARPS),
                    (unsigned)((p + tsgu::TILE - 1) / tsgu::TILE));
  void (*kernel)(const int64_t*, const int64_t*, const VT*, T*, int64_t,
                 int64_t) = tsgu::vec_ok(p, V, out)
                                ? &bwd_cols_kernel<T, VT, true>
                                : &bwd_cols_kernel<T, VT, false>;
  kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int64_t*)indptr, (const int64_t*)perm, (const VT*)V, (T*)out,
      m, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Entries tsgu_chunk_bwd_rows_<T>_<VT> and tsgu_chunk_bwd_cols_<T>_<VT>.
#define TSGU_FUSED_ENTRIES(SFX, T, VT)                                      \
  int tsgu_chunk_bwd_rows_##SFX(const void* indptr, const void* cols,      \
                                const void* vals, const void* B,           \
                                const void* G, void* dd, void* V,          \
                                int64_t n, int64_t p, void* stream) {      \
    return launch_rows<T, VT>(indptr, cols, vals, B, G, dd, V, n, p,       \
                              stream);                                     \
  }                                                                        \
  int tsgu_chunk_bwd_cols_##SFX(const void* indptr, const void* perm,      \
                                const void* V, void* out, int64_t m,       \
                                int64_t p, void* stream) {                 \
    return launch_cols<T, VT>(indptr, perm, V, out, m, p, stream);         \
  }

extern "C" {
TSGU_FUSED_ENTRIES(f32_f32, float, float)
TSGU_FUSED_ENTRIES(f32_bf16, float, __nv_bfloat16)
TSGU_FUSED_ENTRIES(bf16_bf16, __nv_bfloat16, __nv_bfloat16)
TSGU_FUSED_ENTRIES(f64_f64, double, double)
TSGU_FUSED_ENTRIES(f64_bf16, double, __nv_bfloat16)
}  // extern "C"
