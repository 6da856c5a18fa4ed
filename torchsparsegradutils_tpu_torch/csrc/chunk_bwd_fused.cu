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
// and chunk_spmm.cu, one warp owns one row.  Pass 1 takes chunk_sddmm.cu's
// lanes and column slabs (chunk_lanes.cuh: G lanes an entry, 32 / G
// entries a round, U rounds in flight, the slab and lg picked on the host
// by kernels/chunk_spmm.py, sddmm_passes), but walks a round's slabs
// inside the warp, in one launch, since it also writes each entry's V
// row: slab by slab, the G lanes of an entry write their columns of V
// and sum the slab's share of dd[e] (lane_dot, group_sums), and the
// shares are added in registers in slab order, slab 0 first.  chunk_sddmm.cu adds the same
// shares, computed the same way, in the same order across its passes, so
// dd is bitwise chunk_sddmm.cu's.  p <= NARROW_P runs the lanes across
// entries instead, each lane a whole dot, as chunk_sddmm.cu does.  Pass 2
// is a one-warp-a-column SpMM loop with unit weights, gathering V rows
// through perm, 128-column tiles over gridDim.y.  No atomics: both passes
// give the same bits on every run.
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
#include "chunk_lanes.cuh"

namespace {

using tsgu::FULL;
using tsgu::Piece;

constexpr int WARPS = 8;     // rows (columns in pass 2) per block
constexpr int U = 4;         // pass 1: rounds of B loads in flight a lane
constexpr int UNROLL = 4;    // pass 2: entries whose rows load together
constexpr int NARROW_P = 8;  // at or below: pass 1 lanes across entries

// W values in the accumulation type stored as W elements of VT (rounded
// as tsgu::store_acc rounds), in one streaming store where they fill 4,
// 8 or 16 bytes.
template <typename VT, typename A, int W>
__device__ __forceinline__ void store_v(VT* p, const A (&v)[W]) {
  VT t[W];
#pragma unroll
  for (int w = 0; w < W; ++w) tsgu::store_acc(&t[w], v[w]);
  constexpr int bytes = W * (int)sizeof(VT);
  if constexpr (bytes == 16) {
    uint4 q;
    memcpy(&q, t, 16);
    __stcs(reinterpret_cast<uint4*>(p), q);
  } else if constexpr (bytes == 8) {
    uint2 q;
    memcpy(&q, t, 8);
    __stcs(reinterpret_cast<uint2*>(p), q);
  } else if constexpr (bytes == 4) {
    unsigned q;
    memcpy(&q, t, 4);
    __stcs(reinterpret_cast<unsigned*>(p), q);
  } else {
    p[0] = t[0];
  }
}

template <typename T, typename VT, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
bwd_rows_kernel(const int64_t* __restrict__ indptr,
                const int64_t* __restrict__ cols, const T* __restrict__ vals,
                const T* __restrict__ B, const T* __restrict__ G,
                T* __restrict__ dd, VT* __restrict__ V, int64_t n,
                int64_t p, int lg) {
  using A = typename tsgu::Acc<T>::type;
  using P = Piece<T, VEC>;
  constexpr int W = P::W;
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n) return;  // the whole warp leaves together
  // lanes 0 and 1 load the row's bounds
  long long ip = 0;
  if (lane <= 1) ip = indptr[r + lane];
  const int64_t beg = __shfl_sync(FULL, ip, 0);
  const int64_t end = __shfl_sync(FULL, ip, 1);
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

  // chunk_sddmm.cu's lanes and slabs, the slabs walked inside the warp
  const int E = 32 >> lg;
  const int grp = lane >> lg;
  const int64_t slabs = (p + ((int64_t)W << lg) - 1) / ((int64_t)W << lg);
  for (int64_t base = beg; base < end; base += 32) {
    const int cnt = end - base < 32 ? (int)(end - base) : 32;
    long long c_cur = 0;
    A v_cur = A(0);
    if (lane < cnt) {
      c_cur = __ldcs(reinterpret_cast<const long long*>(cols) + base + lane);
      const T t = __ldcs(vals + base + lane);
      v_cur = tsgu::load_acc(&t);
    }
    A mine = A(0);
    for (int k = 0; k < cnt; k += U * E) {
      long long c[U];
      A v[U], acc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int slot = k + u * E + grp;
        acc[u] = A(0);
        c[u] = __shfl_sync(FULL, c_cur, slot & 31);
        v[u] = __shfl_sync(FULL, v_cur, slot & 31);
      }
      for (int64_t s = 0; s < slabs; ++s) {
        const int64_t col = tsgu::slab_col<T, VEC>(s, lg, lane);
        const bool live = col < p;
        A gs[W];
        P::unpack(live ? P::load(g + col) : P::zero(), gs);
        typename P::Raw raw[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          raw[u] = P::zero();
          if (k + u * E + grp < cnt && live) {
            raw[u] = P::load(B + c[u] * p + col);
          }
        }
        A d[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          d[u] = tsgu::lane_dot<T, VEC>(gs, raw[u]);
          const int64_t e = base + k + u * E + grp;
          if (k + u * E + grp < cnt && live) {
            A w[W];
#pragma unroll
            for (int i = 0; i < W; ++i) w[i] = v[u] * gs[i];
            store_v(V + e * p + col, w);
          }
        }
        // slab s's shares of dd, added in chunk_sddmm.cu's order
        tsgu::group_sums<U>(d, lg, lane);
#pragma unroll
        for (int i = 0; i < U; ++i) acc[i] = s == 0 ? d[i] : acc[i] + d[i];
      }
      tsgu::sums_to_slot_lanes<U>(acc, k, lg, lane, mine);
    }
    if (lane < cnt) tsgu::store_acc(dd + base + lane, mine);
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

template <typename T, typename VT, bool VEC>
int launch_rows(const void* indptr, const void* cols, const void* vals,
                const void* B, const void* G, void* dd, void* V, int64_t n,
                int64_t p, int64_t lg, void* stream) {
  const unsigned blocks = (unsigned)((n + WARPS - 1) / WARPS);
  bwd_rows_kernel<T, VT, VEC><<<blocks, WARPS * 32, 0,
                                (cudaStream_t)stream>>>(
      (const int64_t*)indptr, (const int64_t*)cols, (const T*)vals,
      (const T*)B, (const T*)G, (T*)dd, (VT*)V, n, p, (int)lg);
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

// Entries tsgu_chunk_bwd_rows_<T>_<VT>_<vec|scalar>(indptr, cols, vals,
// B, G, dd, V, n, p, lg, stream), with chunk_sddmm.cu's path and lg
// (kernels/chunk_spmm.py, sddmm_passes), and
// tsgu_chunk_bwd_cols_<T>_<VT>(indptr, perm, V, out, m, p, stream).
#define TSGU_ROWS_ENTRY(SFX, T, VT, VEC)                                    \
  int tsgu_chunk_bwd_rows_##SFX(const void* indptr, const void* cols,      \
                                const void* vals, const void* B,           \
                                const void* G, void* dd, void* V,          \
                                int64_t n, int64_t p, int64_t lg,          \
                                void* stream) {                            \
    return launch_rows<T, VT, VEC>(indptr, cols, vals, B, G, dd, V, n, p,  \
                                   lg, stream);                            \
  }
#define TSGU_FUSED_ENTRIES(SFX, T, VT)                                      \
  TSGU_ROWS_ENTRY(SFX##_vec, T, VT, true)                                  \
  TSGU_ROWS_ENTRY(SFX##_scalar, T, VT, false)                              \
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
