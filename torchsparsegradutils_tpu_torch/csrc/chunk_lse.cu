// Row logsumexp of a row-sorted pattern, read as CSR, and its backward:
//   out[r] = log(sum over e in [indptr[r], indptr[r + 1]) of exp(v[e])
//                + (width - count_r) * exp(0) if include_zeros)      (K10)
//   d[e]   = exp(v[e] - out[r]) * g[r], 0 where out[r] is not finite or
//            v[e] = -inf                                              (K11)
//
// Replace the JAX package's _lse_partials and _lse_bwd_pass (pallas_call
// at torchsparsegradutils_tpu/kernels/chunk_lse.py:70 and :142).  The
// TPU kernels cut the entry stream into fixed chunks, emit online (max,
// sum exp) partials per chunk-local row and combine them with a segment
// max and sum (_lse_combine), because a TPU cannot scatter.  Here the
// work is cut by entries too, but into packs of whole rows, so each row
// is finished where it is read: no partials, no combine pass, no
// atomics, and the same bits on every run.
//
// The host plans the packs (kernels/row_packs.py:pack_table), cached
// with the pattern: consecutive rows holding at most PACK entries and
// PACK / 2 rows, or one row of more than LONG_ROW (256) entries alone.
// The table holds each pack's first row, first entry and lane group
// (log2 G, from the pack's mean row length), and a last line (n, nnz,
// 0).  The pack loop, its merges and the table's reader are
// row_packs.cuh's, which the chunk SpMV (chunk_spmv.cu) shares.  One
// block takes one pack:
//
//   * a pack of several rows is staged in shared memory in one burst:
//     its values, its slice of indptr (as offsets in the pack) and, for
//     K11, out and g of its rows, every thread's loads issued before any
//     is used.  Lane groups of G threads then take one row each from
//     shared memory; a row longer than 8 G is taken by a whole warp
//     after the groups are done.  K10 reads a row twice from shared
//     memory (its max, then its sum of exp(v - max), each merged by a
//     butterfly of log2 G shuffles in a fixed order) and writes the
//     pack's results coalesced; K11 rewrites the staged values in place
//     and writes them back coalesced.
//   * a pack of one row is walked by the whole block, PACK entries at
//     a time held in registers (one burst a chunk): K10 folds each
//     chunk's max and sum into the row's (max, sum) through a reduction
//     over the block in warp order; K11 writes each chunk straight back.
//
// The two-pass form costs one exp an entry and none in the merges (the
// online (max, sum) pair costs two a merge step) and rounds like the
// plain version, which takes the max first.  finish() applies
// _lse_combine's rules: include_zeros mass, +inf passes, an empty or all
// -inf row gives -inf (or log(width - count) with include_zeros).
//
// Shapes: indptr (n + 1,) int64, vals (nnz,) of T, packs (npacks + 1, 3)
// int64, out and g (n,) and the sums in float (T = float or bfloat16) or
// double (T = double); d (nnz,) of T.  The pack size is PACK = 2048
// entries (kernels/row_packs.py:PACK_ENTRIES), at most 37 KB of dynamic
// shared memory a block (K11 in double), under the 48 KB that needs no
// opt-in.
//
// What bounds them on an H100: bytes.  At the skewed cfd2 shape (n =
// 123,440, nnz = 3.09M, f32) K10 reads 12.35 MB of values and 0.99 MB of
// row pointers and writes 0.49 MB, 4.1 us at 3.35 TB/s; K11 moves
// 26.7 MB, 8.0 us; one exp an entry is far below the card's rate.  What
// the packs do about it: a block has a whole pack's loads in flight at
// once (8 KB of values in f32), where one warp a row had a burst of at
// most a light row's 13 loads.
#include "row_packs.cuh"

#include <math.h>

namespace {

using namespace tsgu::packs;

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }
__device__ __forceinline__ bool fin(float x) { return fabsf(x) < INFINITY; }
__device__ __forceinline__ bool fin(double x) { return fabs(x) < INFINITY; }

// The row's result from its max m and s = sum of exp(v - m) over its
// entries: _lse_combine's rules.
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

// A row's LSE by G lanes from the staged values sv[b, e).
template <typename A>
__device__ __forceinline__ A row_lse(const A* sv, int b, int e, int li,
                                     int G, unsigned mask, int64_t width,
                                     bool include_zeros) {
  A m = A(-INFINITY);
  for (int j = b + li; j < e; j += G) m = mx(m, sv[j]);
  m = group_max(m, G, mask);
  A s = A(0);
  if (fin(m)) {  // the same in every lane of the group
    for (int j = b + li; j < e; j += G) s += ex(sv[j] - m);
    s = group_sum(s, G, mask);
  }
  return finish(m, s, (int64_t)(e - b), width, include_zeros);
}

// d for the staged values sv[b, e) of a row, in place, by G lanes.
template <typename A>
__device__ __forceinline__ void row_bwd(A* sv, int b, int e, int li, int G,
                                        A o, A g) {
  const bool ok = fin(o);
  for (int j = b + li; j < e; j += G) {
    const A x = sv[j];
    sv[j] = ok && x != A(-INFINITY) ? ex(x - o) * g : A(0);
  }
}

// Load the pack's values, its indptr slice and (with N_ROW_ARRAYS = 2)
// two per-row arrays into shared memory: every load first, then every
// store.
template <int N_ROW_ARRAYS, typename T, typename A>
__device__ __forceinline__ void stage_pack(
    const Pack& pk, const int64_t* __restrict__ indptr,
    const T* __restrict__ v, const A* __restrict__ ra,
    const A* __restrict__ rb, A* sv, int* sp, A* sa, A* sb) {
  constexpr int UV = PACK / THREADS;
  constexpr int UR = N_ROW_ARRAYS ? PACK_ROWS / THREADS : 1;
  const int ne = (int)(pk.e1 - pk.e0), nr = (int)(pk.r1 - pk.r0);
  const int t = threadIdx.x;
  A xv[UV], xa[UR], xb[UR];
  int64_t xp[UP];
#pragma unroll
  for (int u = 0; u < UV; ++u) {
    const int j = u * THREADS + t;
    if (j < ne) xv[u] = tsgu::load_acc(v + pk.e0 + j);
  }
  load_ptrs(pk, indptr, xp);
  if (N_ROW_ARRAYS) {
#pragma unroll
    for (int u = 0; u < UR; ++u) {
      if (u * THREADS + t < nr) {
        xa[u] = ra[pk.r0 + u * THREADS + t];
        xb[u] = rb[pk.r0 + u * THREADS + t];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < UV; ++u) {
    if (u * THREADS + t < ne) sv[u * THREADS + t] = xv[u];
  }
  store_ptrs(pk, xp, sp);
  if (N_ROW_ARRAYS) {
#pragma unroll
    for (int u = 0; u < UR; ++u) {
      if (u * THREADS + t < nr) {
        sa[u * THREADS + t] = xa[u];
        sb[u * THREADS + t] = xb[u];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lse_rows_kernel(const int64_t* __restrict__ indptr, const T* __restrict__ v,
                const int64_t* __restrict__ packs,
                typename tsgu::Acc<T>::type* __restrict__ out, int64_t width,
                bool include_zeros) {
  using A = typename tsgu::Acc<T>::type;
  constexpr int UV = PACK / THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ A red[WARPS];
  A* sv = reinterpret_cast<A*>(smem);
  A* res = sv + PACK;
  int* sp = reinterpret_cast<int*>(res + PACK_ROWS);
  const Pack pk = load_pack(packs, blockIdx.x);
  const int t = threadIdx.x;
  if (pk.r1 - pk.r0 == 1) {
    // one row, PACK entries at a time in registers, by the whole block
    A M = A(-INFINITY), S = A(0);
    for (int64_t c0 = pk.e0; c0 < pk.e1; c0 += PACK) {
      const int64_t cn = pk.e1 - c0;
      A x[UV];
      A cm = A(-INFINITY);
#pragma unroll
      for (int u = 0; u < UV; ++u) {
        x[u] = u * THREADS + t < cn ? tsgu::load_acc(v + c0 + u * THREADS + t)
                                    : A(-INFINITY);
      }
#pragma unroll
      for (int u = 0; u < UV; ++u) cm = mx(cm, x[u]);
      cm = block_fold<true>(cm, red);
      if (cm == A(INFINITY)) {
        M = cm;
        break;
      }
      if (cm > M) {
        S = S * ex(M - cm);
        M = cm;
      }
      if (M != A(-INFINITY)) {
        A ps = A(0);
#pragma unroll
        for (int u = 0; u < UV; ++u) ps += ex(x[u] - M);
        S += block_fold<false>(ps, red);
      }
    }
    if (t == 0) out[pk.r0] = finish(M, S, pk.e1 - pk.e0, width, include_zeros);
    return;
  }
  check_pack(pk);
  const int nr = (int)(pk.r1 - pk.r0);
  stage_pack<0>(pk, indptr, v, (const A*)nullptr, (const A*)nullptr, sv,
                    sp, (A*)nullptr, (A*)nullptr);
  __syncthreads();
  walk_rows(sp, nr, pk.lg,
            [&](int i, int b, int e, int li, int G, unsigned mask) {
              const A r = row_lse(sv, b, e, li, G, mask, width, include_zeros);
              if (li == 0) res[i] = r;
            });
  __syncthreads();
  for (int i = t; i < nr; i += THREADS) out[pk.r0 + i] = res[i];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lse_rows_bwd_kernel(const int64_t* __restrict__ indptr,
                    const T* __restrict__ v,
                    const int64_t* __restrict__ packs,
                    const typename tsgu::Acc<T>::type* __restrict__ out,
                    const typename tsgu::Acc<T>::type* __restrict__ g,
                    T* __restrict__ d) {
  using A = typename tsgu::Acc<T>::type;
  constexpr int UV = PACK / THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  A* sv = reinterpret_cast<A*>(smem);
  A* so = sv + PACK;
  A* sg = so + PACK_ROWS;
  int* sp = reinterpret_cast<int*>(sg + PACK_ROWS);
  const Pack pk = load_pack(packs, blockIdx.x);
  const int t = threadIdx.x;
  if (pk.r1 - pk.r0 == 1) {
    // one row, PACK entries at a time, by the whole block
    const A o = out[pk.r0], gr = g[pk.r0];
    const bool ok = fin(o);
    for (int64_t c0 = pk.e0; c0 < pk.e1; c0 += PACK) {
      const int64_t cn = pk.e1 - c0;
      A x[UV];
#pragma unroll
      for (int u = 0; u < UV; ++u) {
        const int j = u * THREADS + t;
        if (j < cn) x[u] = tsgu::load_acc(v + c0 + j);
      }
#pragma unroll
      for (int u = 0; u < UV; ++u) {
        if (u * THREADS + t < cn) {
          tsgu::store_acc(d + c0 + u * THREADS + t,
                          ok && x[u] != A(-INFINITY) ? ex(x[u] - o) * gr
                                                     : A(0));
        }
      }
    }
    return;
  }
  check_pack(pk);
  const int ne = (int)(pk.e1 - pk.e0), nr = (int)(pk.r1 - pk.r0);
  stage_pack<2>(pk, indptr, v, out, g, sv, sp, so, sg);
  __syncthreads();
  walk_rows(sp, nr, pk.lg,
            [&](int i, int b, int e, int li, int G, unsigned) {
              row_bwd(sv, b, e, li, G, so[i], sg[i]);
            });
  __syncthreads();
#pragma unroll
  for (int u = 0; u < UV; ++u) {
    if (u * THREADS + t < ne) {
      tsgu::store_acc(d + pk.e0 + u * THREADS + t, sv[u * THREADS + t]);
    }
  }
}

template <typename T>
int launch_fwd(const void* indptr, const void* v, const void* packs,
               void* out, int64_t npacks, int64_t width,
               int64_t include_zeros, void* stream) {
  using A = typename tsgu::Acc<T>::type;
  if (npacks <= 0) return (int)cudaSuccess;
  const size_t smem = (PACK + PACK_ROWS) * sizeof(A) +
                      (PACK_ROWS + 1) * sizeof(int);
  lse_rows_kernel<T><<<(unsigned)npacks, THREADS, smem,
                       (cudaStream_t)stream>>>(
      (const int64_t*)indptr, (const T*)v, (const int64_t*)packs, (A*)out,
      width, include_zeros != 0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* indptr, const void* v, const void* packs,
               const void* out, const void* g, void* d, int64_t npacks,
               void* stream) {
  using A = typename tsgu::Acc<T>::type;
  if (npacks <= 0) return (int)cudaSuccess;
  const size_t smem = 2 * PACK * sizeof(A) + (PACK_ROWS + 1) * sizeof(int);
  lse_rows_bwd_kernel<T>
      <<<(unsigned)npacks, THREADS, smem, (cudaStream_t)stream>>>(
          (const int64_t*)indptr, (const T*)v, (const int64_t*)packs,
          (const A*)out, (const A*)g, (T*)d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tsgu_lse_rows_f32(const void* indptr, const void* v, const void* packs,
                      void* out, int64_t npacks, int64_t width,
                      int64_t include_zeros, void* stream) {
  return launch_fwd<float>(indptr, v, packs, out, npacks, width,
                           include_zeros, stream);
}

int tsgu_lse_rows_bf16(const void* indptr, const void* v, const void* packs,
                       void* out, int64_t npacks, int64_t width,
                       int64_t include_zeros, void* stream) {
  return launch_fwd<__nv_bfloat16>(indptr, v, packs, out, npacks, width,
                                   include_zeros, stream);
}

int tsgu_lse_rows_f64(const void* indptr, const void* v, const void* packs,
                      void* out, int64_t npacks, int64_t width,
                      int64_t include_zeros, void* stream) {
  return launch_fwd<double>(indptr, v, packs, out, npacks, width,
                            include_zeros, stream);
}

int tsgu_lse_rows_bwd_f32(const void* indptr, const void* v,
                          const void* packs, const void* out, const void* g,
                          void* d, int64_t npacks, void* stream) {
  return launch_bwd<float>(indptr, v, packs, out, g, d, npacks, stream);
}

int tsgu_lse_rows_bwd_bf16(const void* indptr, const void* v,
                           const void* packs, const void* out, const void* g,
                           void* d, int64_t npacks, void* stream) {
  return launch_bwd<__nv_bfloat16>(indptr, v, packs, out, g, d, npacks,
                                   stream);
}

int tsgu_lse_rows_bwd_f64(const void* indptr, const void* v,
                          const void* packs, const void* out, const void* g,
                          void* d, int64_t npacks, void* stream) {
  return launch_bwd<double>(indptr, v, packs, out, g, d, npacks, stream);
}

}  // extern "C"
