// The row-pack loop of the kernels that finish whole CSR rows in one
// block: the chunk LSE kernels K10 and K11 (chunk_lse.cu) and the chunk
// SpMV K8 (chunk_spmv.cu).
//
// The host plans the packs (kernels/row_packs.py:pack_table), cached
// with the pattern: consecutive rows holding at most T entries and T / 2
// rows, or one row of more than LONG_ROW (256) entries alone; T is PACK
// for K10 and K11 and chunk_spmv.cu's SPMV_PACK for K8.
// The table, (npacks + 1, 3) int64, holds each pack's first row, first
// entry and lane group (log2 G, from the pack's mean row length), and a
// last line (n, nnz, 0).  One block of THREADS threads takes one pack:
// a pack of several rows is staged in shared memory in one burst and
// walked by lane groups (walk_rows); a pack of one row is walked by the
// whole block and folded over the block in warp order (block_fold).
// Every merge runs in a fixed order, so the results are the same bits
// on every run.
#pragma once

#include "tsgu_common.cuh"

namespace tsgu {
namespace packs {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;
// Entries and rows a pack of several rows may hold (the host's plan,
// kernels/row_packs.py:PACK_ENTRIES), for K10 and K11; K8 plans its
// packs at a size of its own, the P of the helpers below.
constexpr int PACK = 2048;
constexpr int PACK_ROWS = PACK / 2;
// A thread's loads of the indptr slice (P / 2 + 1 values) of a pack of
// at most P entries.
__host__ __device__ constexpr int ptr_loads(int P) {
  return (P / 2 + THREADS) / THREADS;
}
constexpr int UP = ptr_loads(PACK);

template <typename A>
__device__ __forceinline__ A mx(A a, A b) { return b > a ? b : a; }

// Max and sum over the G lanes of a group (mask: the group's lanes); a
// fixed butterfly, so every lane of the group gets the same bits.
template <typename A>
__device__ __forceinline__ A group_max(A x, int G, unsigned mask) {
  for (int o = G >> 1; o > 0; o >>= 1) x = mx(x, __shfl_xor_sync(mask, x, o));
  return x;
}

template <typename A>
__device__ __forceinline__ A group_sum(A x, int G, unsigned mask) {
  for (int o = G >> 1; o > 0; o >>= 1) x += __shfl_xor_sync(mask, x, o);
  return x;
}

// Max or sum over the block, in warp order; every thread gets the same
// bits.  Called by all threads of the block.
template <bool MAX, typename A>
__device__ __forceinline__ A block_fold(A x, A* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = MAX ? group_max(x, 32, FULL) : group_sum(x, 32, FULL);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  A r = red[0];
#pragma unroll
  for (int k = 1; k < WARPS; ++k) r = MAX ? mx(r, red[k]) : r + red[k];
  __syncthreads();
  return r;
}

// The pack loop over the staged rows of a pack (row i spans [sp[i],
// sp[i + 1])).  First every lane group of G = 2^lg threads takes rows
// gi, gi + THREADS / G, ... of at most 8 G entries (every row where
// G = 32); then every warp takes, one after another, the longer rows of
// its 32-row chunks with all 32 lanes.  Calls fn(i, b, e, lane in the
// group, G, the group's lane mask).
template <typename I, typename F>
__device__ __forceinline__ void walk_rows(const I* sp, int nr, int lg,
                                          F fn) {
  const int G = 1 << lg, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int li = threadIdx.x & (G - 1), long_row = 8 * G;
  const unsigned mask =
      G == 32 ? FULL : ((1u << G) - 1u) << (lane & ~(G - 1));
  for (int i = threadIdx.x >> lg; i < nr; i += THREADS >> lg) {
    const int b = sp[i], e = sp[i + 1];
    if (G == 32 || e - b <= long_row) fn(i, b, e, li, G, mask);
  }
  if (G == 32) return;
  for (int c = warp * 32; c < nr; c += THREADS) {
    const int i = c + lane;
    unsigned todo = __ballot_sync(
        FULL, i < nr && sp[i + 1] - sp[i] > long_row);
    while (todo) {
      const int k = c + __ffs(todo) - 1;
      todo &= todo - 1;
      fn(k, sp[k], sp[k + 1], lane, 32, FULL);
    }
  }
}

struct Pack {
  int64_t r0, e0, r1, e1;
  int lg;
};

// Pack k of the table.
__device__ __forceinline__ Pack load_pack(const int64_t* packs, int64_t k) {
  const int64_t* p = packs + 3 * k;
  return {p[0], p[1], p[3], p[4], (int)p[2]};
}

// A pack of several rows must fit the staging of P entries and P / 2
// rows: the host plans it so.
template <int P = PACK>
__device__ __forceinline__ void check_pack(const Pack& pk) {
  if (pk.e1 - pk.e0 > P || pk.r1 - pk.r0 > P / 2) __trap();
}

// The pack's indptr slice: load_ptrs issues this thread's loads,
// store_ptrs writes them to sp as offsets in the pack (int, or a
// narrower type where P fits it).  Split, so that a kernel issues all of
// a burst's loads before any store.
template <int P = PACK>
__device__ __forceinline__ void load_ptrs(const Pack& pk,
                                          const int64_t* __restrict__ indptr,
                                          int64_t (&xp)[ptr_loads(P)]) {
  const int nr = (int)(pk.r1 - pk.r0), t = threadIdx.x;
#pragma unroll
  for (int u = 0; u < ptr_loads(P); ++u) {
    if (u * THREADS + t <= nr) xp[u] = indptr[pk.r0 + u * THREADS + t];
  }
}

template <int P = PACK, typename I>
__device__ __forceinline__ void store_ptrs(const Pack& pk,
                                           const int64_t (&xp)[ptr_loads(P)],
                                           I* sp) {
  const int nr = (int)(pk.r1 - pk.r0), t = threadIdx.x;
#pragma unroll
  for (int u = 0; u < ptr_loads(P); ++u) {
    if (u * THREADS + t <= nr) sp[u * THREADS + t] = (I)(xp[u] - pk.e0);
  }
}

}  // namespace packs
}  // namespace tsgu
