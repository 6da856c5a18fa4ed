// Fused backward of a chunk-engine SpMM out = A @ B, given G = dL/dout,
// in one pass over the transpose plan (A's entries sorted by column):
// for each column c and each position d in [indptr_t[c], indptr_t[c + 1]),
// with r = cols_t[d] the entry's row,
//   dd_t[d]  = dot(G[r, :], B[c, :])                     (gradA)
//   dB[c, :] = sum over d of round(vals_t[d] * G[r, :])   (gradB = A^T G)
// where round is the identity, or a rounding of each product to RT =
// bfloat16 (grad_precision="fast", and always for bfloat16 T).  vals_t
// and dd_t are in the transpose plan's order: the wrapper
// (kernels/chunk_spmm.py, chunk_bwd_cols) gathers the values into it and
// dd back into A's order with K3 (gather.cu).
//
// Replaces both passes of the JAX package's chunk_spmm_bwd_fused
// (pallas_calls at torchsparsegradutils_tpu/kernels/chunk_spmm.py:429,
// K12a, and :462, K12b).  The TPU writes V[e] = vals[e] * G[row_e], one
// (nnz, p) row per entry, in RT, then sums V's rows in column order in a
// second pass, since there it gathers rows and not scalars.  Here the
// rows of G are gathered in column order directly: each gathered row
// serves both gradients, dotted with B[c] for dd and scaled into dB[c]'s
// sum.  V is never written, so the scratch stays O(nnz), and the products
// are rounded as V's stores rounded them.
//
// Shapes: indptr_t (m + 1,), cols_t (nnz,) int64; vals_t (nnz,); B (m,
// p); G (n, p); dd_t (nnz,) in the accumulation type; dB (m, p);
// row-major and contiguous.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W): the least
// traffic at the uniform random cfd2 shape (n = m = 123,440, nnz = 3.09M,
// p = 128, f32) is G, B and dB once (63.2 MB each), vals and dd (12.4 MB
// each), cols_t and perm (24.7 MB each) and indptr_t: 265 MB, 79 us at
// 3.35 TB/s.  But each entry gathers its G row, 3.09M x 512 B = 1.58 GB
// in random order from L2, as K7 (chunk_sddmm.cu) gathers B's rows in
// 0.253 ms and K6 (chunk_spmm.cu) G's rows for A^T G in 0.222.  This
// kernel takes 0.406-0.412 ms there, the wrapper's two K3 gathers 0.029
// each (scripts/fused_bwd_probe.py): latency-bound, not by the gather's
// bytes.  With the dB sums taken out it still takes 0.396 (and 0.380
// with G's read rows folded into 15.8 MB of L2), so the walk of dd, K7's
// loop, runs 1.5x K7's time here; the sums of dB cost almost nothing
// beside it.  The TPU-shaped pair wrote and read back V as well, 1,581
// MB each way at that shape, and took 1.55 ms.
//
// Design:
// * One warp a column of one column slab, K7's lanes (chunk_lanes.cuh):
//   2^lg lanes an entry, each with 16 bytes (VEC) or one element of the
//   slab, the warp's E = 32 >> lg lane groups on consecutive entries of
//   the column, U rounds of loads in flight.  lg and the slab are K7's
//   for (X, Y) = (G, B) (kernels/chunk_spmm.py, sddmm_passes, from the
//   row plan's n and nnz), and each slab's share of an entry's dot is
//   summed as K7 sums it (the lane's W products by FMA, G's first, then
//   group_sums over the entry's lanes) and added to the shares of the
//   slabs before it, slab 0 first.  So dd is bitwise K7's, although this
//   walk meets the entries in another order: an entry's sum depends only
//   on its own lanes, not on its slot.
// * Persistent and slab-major: the blocks that fit the card at once, warp
//   w of nw taking columns w, w + nw, ... of slab 0, then of slab 1, so
//   that the gathered share of G (31.6 MB a slab at cfd2) mostly stays in
//   L2, and each entry's running dd in dd_t is read back by the lane that
//   wrote it.  One launch a call, at any p.  A block a column group with
//   all slabs of a column in turn took 0.461 ms, a launch a slab as K7's
//   passes 0.468.
// * B[c]'s slab and dB[c]'s sums live in registers, W values each.  Each
//   lane group sums its own entries' products in order; at the end of
//   the column the groups' sums are added by a fixed xor butterfly and
//   group 0 writes the slab of the row.
// * __launch_bounds__ asks for BLOCKS = 4 blocks an SM (64 registers):
//   the compiler's own choice took 60 registers and 0.517 ms, 3 and 5
//   blocks 0.44-0.45, 2 or 8 rounds in flight 0.47-0.48.
// * Indices and values read coalesced in column order: lane j loads
//   cols_t and vals_t of entry base + j of the column's next 32, and the
//   groups take row and value by shuffle (so G has fewer than 2^31 rows;
//   the wrapper checks).  Gathering the values through perm and
//   scattering dd through it inside the walk cost more than the two K3
//   passes around it.
// * For p <= NARROW_P the lanes run across the column's entries instead,
//   each lane a whole dot and its own dB sums, added over the warp at the
//   end, as K7's narrow path does.
// * Products are rounded to nearest (__fmul_rn / __dmul_rn), so the
//   compiler cannot contract them into the sums: round(v * g) is what V
//   held.  No atomics: two launches give the same bits.
// * Load: a column is one warp's, however long, and a warp's columns are
//   fixed: a hub column of k entries holds its warp for about k / (U E)
//   rounds of gathers a slab.
//
// Types: T for vals_t, B, G and dB (float, bfloat16 or double; sums in
// float for float and bfloat16, double for double); RT, the products'
// rounding, T itself or bfloat16.
#include "chunk_lanes.cuh"

namespace {

using tsgu::FULL;
using tsgu::Piece;

constexpr int WARPS = 8;     // warps a block
constexpr int BLOCKS = 4;    // blocks an SM (__launch_bounds__)
constexpr int U = 4;         // rounds of G loads in flight a lane
constexpr int NARROW_P = 8;  // at or below: lanes across entries

// v * g rounded to RT and back, as V's stores rounded it.
template <typename RT, typename A>
__device__ __forceinline__ A product(A v, A g) {
  const A x = tsgu::mul_acc(v, g);
  if constexpr (std::is_same<RT, A>::value) {
    return x;
  } else {
    RT t;
    tsgu::store_acc(&t, x);
    return (A)tsgu::load_acc(&t);
  }
}

// Column c, p <= NARROW_P: lane j takes entries j, j + 32, ... of the
// column, a whole dot each, and sums its own products; the warp adds the
// lanes' sums at the end.
template <typename T, typename RT>
__device__ __forceinline__ void narrow_column(
    const int64_t* __restrict__ indptr_t, const int64_t* __restrict__ cols_t,
    const T* __restrict__ vals_t, const T* __restrict__ B,
    const T* __restrict__ G, typename tsgu::Acc<T>::type* __restrict__ dd_t,
    T* __restrict__ dB, int64_t c, int64_t p, int lane) {
  using A = typename tsgu::Acc<T>::type;
  long long ip = 0;
  if (lane <= 1) ip = indptr_t[c + lane];
  const int64_t beg = __shfl_sync(FULL, ip, 0);
  const int64_t end = __shfl_sync(FULL, ip, 1);
  A bc[NARROW_P], acc[NARROW_P];
#pragma unroll
  for (int j = 0; j < NARROW_P; ++j) {
    bc[j] = j < p ? tsgu::load_acc(B + c * p + j) : A(0);
    acc[j] = A(0);
  }
  for (int64_t d = beg + lane; d < end; d += 32) {
    const T* g = G + cols_t[d] * p;
    const A v = tsgu::load_acc(vals_t + d);
    A s = A(0);
#pragma unroll
    for (int j = 0; j < NARROW_P; ++j) {
      if (j < p) {
        const A gj = tsgu::load_acc(g + j);
        s = tsgu::fma_acc(gj, bc[j], s);  // K7's narrow dot, G first
        acc[j] += product<RT>(v, gj);
      }
    }
    dd_t[d] = s;
  }
#pragma unroll
  for (int j = 0; j < NARROW_P; ++j) {
    if (j < p) {
      const A t = tsgu::warp_sum(acc[j]);
      if (lane == j) tsgu::store_acc(dB + c * p + j, t);
    }
  }
}

// Slab s of column c: K7's lanes (2^lg an entry, E = 32 >> lg entries a
// round, U rounds in flight).  Adds the slab's share of each entry's dot
// to dd_t (slab 0 writes it) and writes the slab of dB's row c.
template <typename T, typename RT, bool VEC>
__device__ __forceinline__ void slab_column(
    const int64_t* __restrict__ indptr_t, const int64_t* __restrict__ cols_t,
    const T* __restrict__ vals_t, const T* __restrict__ B,
    const T* __restrict__ G, typename tsgu::Acc<T>::type* __restrict__ dd_t,
    T* __restrict__ dB, int64_t c, int64_t s, int64_t p, int lg, int lane) {
  using A = typename tsgu::Acc<T>::type;
  using P = Piece<T, VEC>;
  constexpr int W = P::W;
  long long ip = 0;
  if (lane <= 1) ip = indptr_t[c + lane];
  const int64_t beg = __shfl_sync(FULL, ip, 0);
  const int64_t end = __shfl_sync(FULL, ip, 1);
  const int E = 32 >> lg;
  const int grp = lane >> lg;
  const int64_t col = tsgu::slab_col<T, VEC>(s, lg, lane);
  const bool live = col < p;  // lanes past p load nothing and add 0
  A bs[W], acc[W];
  P::unpack(live ? P::load(B + c * p + col) : P::zero(), bs);
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = A(0);
  const T* gcol = G + col;
  for (int64_t base = beg; base < end; base += 32) {
    const int cnt = end - base < 32 ? (int)(end - base) : 32;
    int r_cur = 0;  // n < 2^31: the wrapper checks
    A v_cur = A(0), before = A(0);  // before: slabs 0..s-1's sum
    if (lane < cnt) {
      r_cur = (int)__ldcs(reinterpret_cast<const long long*>(cols_t) +
                          base + lane);
      v_cur = tsgu::load_acc(vals_t + base + lane);
      if (s > 0) before = dd_t[base + lane];
    }
    A share = A(0);
    for (int k = 0; k < cnt; k += U * E) {
      typename P::Raw raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int slot = k + u * E + grp;
        const int r = __shfl_sync(FULL, r_cur, slot & 31);
        raw[u] = P::zero();
        if (slot < cnt && live) raw[u] = P::load(gcol + (int64_t)r * p);
      }
      A dsum[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int slot = k + u * E + grp;
        const A v = __shfl_sync(FULL, v_cur, slot & 31);
        A g[W];
        P::unpack(raw[u], g);
        dsum[u] = A(0);  // K7's lane_dot, G's values first
#pragma unroll
        for (int w = 0; w < W; ++w) {
          dsum[u] = tsgu::fma_acc(g[w], bs[w], dsum[u]);
        }
        if (slot < cnt) {
#pragma unroll
          for (int w = 0; w < W; ++w) acc[w] += product<RT>(v, g[w]);
        }
      }
      tsgu::group_sums<U>(dsum, lg, lane);
      tsgu::sums_to_slot_lanes<U>(dsum, k, lg, lane, share);
    }
    // slab s's share, added in K7's order
    if (lane < cnt) dd_t[base + lane] = s > 0 ? before + share : share;
  }
  // the lane groups' sums of each column, in a fixed order
#pragma unroll
  for (int w = 0; w < W; ++w) {
    for (int o = 1 << lg; o < 32; o <<= 1) {
      acc[w] += __shfl_xor_sync(FULL, acc[w], o);
    }
  }
  if (grp == 0 && live) P::store(dB + c * p + col, acc);
}

// Persistent: warp w of nw takes columns w, w + nw, ..., one slab at a
// time, slab 0 first.
template <typename T, typename RT, bool VEC>
__global__ void __launch_bounds__(WARPS * 32, BLOCKS)
bwd_cols_kernel(const int64_t* __restrict__ indptr_t,
                const int64_t* __restrict__ cols_t,
                const T* __restrict__ vals_t, const T* __restrict__ B,
                const T* __restrict__ G,
                typename tsgu::Acc<T>::type* __restrict__ dd_t,
                T* __restrict__ dB, int64_t m, int64_t p, int lg) {
  const int lane = threadIdx.x & 31;
  const int64_t w0 = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int64_t nw = (int64_t)gridDim.x * WARPS;
  if (p <= NARROW_P) {
    for (int64_t c = w0; c < m; c += nw) {
      narrow_column<T, RT>(indptr_t, cols_t, vals_t, B, G, dd_t, dB, c, p,
                           lane);
    }
    return;
  }
  const int64_t width = (int64_t)Piece<T, VEC>::W << lg;
  const int64_t slabs = (p + width - 1) / width;
  for (int64_t s = 0; s < slabs; ++s) {
    for (int64_t c = w0; c < m; c += nw) {
      slab_column<T, RT, VEC>(indptr_t, cols_t, vals_t, B, G, dd_t, dB, c,
                              s, p, lg, lane);
    }
  }
}

template <typename T, typename RT, bool VEC>
int launch(const void* indptr_t, const void* cols_t, const void* vals_t,
           const void* B, const void* G, void* dd_t, void* dB, int64_t m,
           int64_t p, int64_t lg, void* stream) {
  static tsgu::Fit cache;
  auto kernel = bwd_cols_kernel<T, RT, VEC>;
  int64_t fit = 0;
  const int rc = tsgu::resident_blocks(kernel, cache, WARPS * 32, 0, &fit);
  if (rc != 0) return rc;
  const int64_t need = (m + WARPS - 1) / WARPS;
  kernel<<<(unsigned)(need < fit ? need : fit), WARPS * 32, 0,
           (cudaStream_t)stream>>>(
      (const int64_t*)indptr_t, (const int64_t*)cols_t, (const T*)vals_t,
      (const T*)B, (const T*)G, (typename tsgu::Acc<T>::type*)dd_t, (T*)dB,
      m, p, (int)lg);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries tsgu_chunk_bwd_cols_<T>_<RT>_<vec|scalar>(indptr_t, cols_t,
// vals_t, B, G, dd_t, dB, m, p, lg, stream), with K7's path and lg for
// (X, Y) = (G, B) (kernels/chunk_spmm.py, sddmm_passes); dd_t in the
// accumulation type.
#define TSGU_BWD_ENTRY(SFX, T, RT, VEC)                                     \
  int tsgu_chunk_bwd_cols_##SFX(const void* indptr_t, const void* cols_t,  \
                                const void* vals_t, const void* B,         \
                                const void* G, void* dd_t, void* dB,       \
                                int64_t m, int64_t p, int64_t lg,          \
                                void* stream) {                            \
    return launch<T, RT, VEC>(indptr_t, cols_t, vals_t, B, G, dd_t, dB, m, \
                              p, lg, stream);                              \
  }
#define TSGU_BWD_ENTRIES(SFX, T, RT)                                        \
  TSGU_BWD_ENTRY(SFX##_vec, T, RT, true)                                   \
  TSGU_BWD_ENTRY(SFX##_scalar, T, RT, false)

extern "C" {
TSGU_BWD_ENTRIES(f32_f32, float, float)
TSGU_BWD_ENTRIES(f32_bf16, float, __nv_bfloat16)
TSGU_BWD_ENTRIES(bf16_bf16, __nv_bfloat16, __nv_bfloat16)
TSGU_BWD_ENTRIES(f64_f64, double, double)
TSGU_BWD_ENTRIES(f64_bf16, double, __nv_bfloat16)
}  // extern "C"
