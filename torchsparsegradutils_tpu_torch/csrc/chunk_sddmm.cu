// Chunk-engine SDDMM at a row-sorted pattern, in the entries' own order:
//   out[e] = dot(X[r, :], Y[cols[e], :]) for e in [indptr[r], indptr[r + 1]).
//
// Replaces the JAX package's chunk_sddmm (pallas_call at
// torchsparsegradutils_tpu/kernels/chunk_spmm.py:349).  The TPU kernel
// expands each chunk's X rows with a one-hot MXU product over a window
// of W rows and sums over its column blocks j in grid order.  Here one
// warp owns one row r of one column slab, as in chunk_spmm.cu.  It is
// gradA of a general SpMM and the forward of a general sddmm.
//
// Shapes: indptr (n + 1,) int64, cols (nnz,) int64, X (n, p), Y (m, p),
// out (nnz,); row-major and contiguous.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W): moving the
// gathered Y rows from L2 into the SMs, as for chunk_spmm.cu.  Each entry
// needs its Y row's p values, in random order, so at the uniform random
// cfd2 shape (n = m = 123,440, nnz = 3.09M, p = 128, f32) a call moves
// 3.09M x 512 B = 1.58 GB of Y rows, from a Y of 63.2 MB that the 50 MB
// L2 does not hold.  (The least traffic, X and Y once, cols, indptr and
// out, is 164 MB: 49 us at 3.35 TB/s.)  The one-warp-a-row kernel this
// replaces read a whole Y row per entry, four entries in flight a warp,
// all 32 lanes loading the same cols[e], and summed every dot with a
// 32-lane butterfly: 0.382 ms there, 0.271 with Y's read rows folded
// into 15.8 MB (so 0.11 ms of HBM misses), and 0.26 at p = 16 and 32,
// where most lanes idled.  This one takes 0.245-0.252 ms, about 6.3 TB/s
// of rows, and 0.228-0.233 with Y folded into L2 (chip_smoke.py,
// k7_times): what is left is the L2's rate for scattered lines and the
// SM's work beside it.  The loop takes 44 registers for float, so an SM
// runs 40 warps; in trial builds, launch bounds that forced 32 or 40
// registers spilled and ran slower, and neither blocks of 2 or 4 warps
// nor 2 or 8 rounds in flight ran faster.
//
// Design:
// * Column slabs, one launch (pass) each, in stream order.  Pass s reads
//   slab s of Y's columns for every row (the slab's share of Y, two
//   128-byte lines of a row: 31.6 MB of a cfd2 Y, mostly stays in L2)
//   and adds its share of each dot to the sum of passes 0..s-1: pass 0
//   writes part[e], pass s > 0 reads part[e] and writes part[e] + share,
//   and the last pass writes out[e].  So the shares are added in a fixed
//   order, slab 0 first, and no pass races another.  part is out itself
//   for float and double; bfloat16 sums in a float buffer.  Each pass
//   after the first reads and writes 4 (8 for double) bytes an entry
//   more: 24.7 MB a pass at cfd2.  The host picks the slab
//   (kernels/chunk_spmm.py, sddmm_passes: chunk_spmm.cu's choice); rows
//   of fewer than 8 entries on average take four-line slabs, one pass at
//   p = 128 f32.
// * Entries shared across lanes (chunk_lanes.cuh): G lanes an entry, each
//   with 16 bytes (VEC) or one element of the slab, so the warp's 32 / G
//   lane groups take consecutive entries of the row, U rounds of loads in
//   flight.  Each entry's share is summed over its G lanes only, and the
//   U rounds' shares together by a transposed butterfly (group_sums: 5
//   shuffles for 4 rounds at G = 16, where a butterfly a round takes 16);
//   then each share goes to the lane of its slot, so part and out are
//   read and written 32 consecutive entries at once.
// * Indices loaded once, coalesced, with streaming hints: lane j loads
//   cols[base + j] of the row's next 32 entries, and the groups take
//   theirs by a 32-bit shuffle (so Y has fewer than 2^31 rows; the
//   wrapper checks).  X's slab of row r is read once per pass, also
//   streaming, and kept in registers.
// * For p <= NARROW_P one pass runs the lanes across the row's entries
//   instead, each lane a whole dot, so a narrow (p = 1) gradA does not
//   idle 31 lanes.
// * VEC (16-byte accesses) needs p a multiple of 16 bytes' elements and
//   16-byte aligned X and Y; otherwise the scalar path takes one element
//   a lane.
// No atomics: the result is the same on every run, and the fused
// backward's gradA (chunk_bwd_fused.cu) gives the same bits.
#include "chunk_lanes.cuh"

namespace {

using tsgu::FULL;
using tsgu::Piece;

constexpr int WARPS = 8;     // rows per block
constexpr int U = 4;         // rounds of Y loads in flight a lane
constexpr int NARROW_P = 8;  // at or below: lanes across entries

template <typename T, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
chunk_sddmm_kernel(const int64_t* __restrict__ indptr,
                   const int64_t* __restrict__ cols,
                   const T* __restrict__ X, const T* __restrict__ Y,
                   typename tsgu::Acc<T>::type* part, T* out, int64_t n,
                   int64_t p, int lg, int64_t s, int64_t slabs) {
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
  const T* x = X + r * p;

  if (p <= NARROW_P) {
    A xr[NARROW_P];
#pragma unroll
    for (int j = 0; j < NARROW_P; ++j) {
      xr[j] = j < p ? tsgu::load_acc(x + j) : A(0);
    }
    for (int64_t e = beg + lane; e < end; e += 32) {
      const T* y = Y + cols[e] * p;
      A d = A(0);
#pragma unroll
      for (int j = 0; j < NARROW_P; ++j) {
        if (j < p) d = tsgu::fma_acc(xr[j], tsgu::load_acc(y + j), d);
      }
      tsgu::store_acc(out + e, d);
    }
    return;
  }

  const int E = 32 >> lg;  // entries a round: one per lane group
  const int grp = lane >> lg;
  const int64_t col = tsgu::slab_col<T, VEC>(s, lg, lane);
  const bool live = col < p;  // lanes past p load nothing and add 0
  A xs[W];
  P::unpack(live ? P::load_cs(x + col) : P::zero(), xs);
  const T* ycol = Y + col;
  for (int64_t base = beg; base < end; base += 32) {
    const int cnt = end - base < 32 ? (int)(end - base) : 32;
    int c_cur = 0;    // m < 2^31: the wrapper checks
    A before = A(0);  // the sum of passes 0..s-1 for slot lane
    if (lane < cnt) {
      c_cur = (int)__ldcs(reinterpret_cast<const long long*>(cols) + base +
                          lane);
      if (s > 0) before = part[base + lane];
    }
    A mine = A(0);
    for (int k = 0; k < cnt; k += U * E) {
      typename P::Raw raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int slot = k + u * E + grp;
        const int c = __shfl_sync(FULL, c_cur, slot & 31);
        raw[u] = P::zero();
        if (slot < cnt && live) raw[u] = P::load(ycol + (int64_t)c * p);
      }
      A res[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        res[u] = tsgu::lane_dot<T, VEC>(xs, raw[u]);
      }
      tsgu::group_sums<U>(res, lg, lane);
      tsgu::sums_to_slot_lanes<U>(res, k, lg, lane, mine);
    }
    if (lane < cnt) {
      const A sum = s > 0 ? before + mine : mine;
      if (s + 1 == slabs) {
        tsgu::store_acc(out + base + lane, sum);
      } else {
        part[base + lane] = sum;
      }
    }
  }
}

// Pass s of slabs over rows in blocks of WARPS.
template <typename T, bool VEC>
int launch(const void* indptr, const void* cols, const void* X,
           const void* Y, void* part, void* out, int64_t n, int64_t p,
           int64_t lg, int64_t s, int64_t slabs, void* stream) {
  const unsigned blocks = (unsigned)((n + WARPS - 1) / WARPS);
  chunk_sddmm_kernel<T, VEC><<<blocks, WARPS * 32, 0,
                               (cudaStream_t)stream>>>(
      (const int64_t*)indptr, (const int64_t*)cols, (const T*)X,
      (const T*)Y, (typename tsgu::Acc<T>::type*)part, (T*)out, n, p,
      (int)lg, s, slabs);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries tsgu_chunk_sddmm_<dtype>_<vec|scalar>(indptr, cols, X, Y,
// part, out, n, p, lg, s, slabs, stream): pass s of slabs (lg is log2 of
// the lanes an entry; kernels/chunk_spmm.py, sddmm_passes), launched for
// s = 0, 1, ..., slabs - 1 in stream order.
#define TSGU_CHUNK_SDDMM_ENTRY(NAME, T, VEC)                                \
  int tsgu_chunk_sddmm_##NAME(const void* indptr, const void* cols,         \
                              const void* X, const void* Y, void* part,     \
                              void* out, int64_t n, int64_t p, int64_t lg,  \
                              int64_t s, int64_t slabs, void* stream) {     \
    return launch<T, VEC>(indptr, cols, X, Y, part, out, n, p, lg, s,       \
                          slabs, stream);                                   \
  }

extern "C" {
TSGU_CHUNK_SDDMM_ENTRY(f32_vec, float, true)
TSGU_CHUNK_SDDMM_ENTRY(f32_scalar, float, false)
TSGU_CHUNK_SDDMM_ENTRY(bf16_vec, __nv_bfloat16, true)
TSGU_CHUNK_SDDMM_ENTRY(bf16_scalar, __nv_bfloat16, false)
TSGU_CHUNK_SDDMM_ENTRY(f64_vec, double, true)
TSGU_CHUNK_SDDMM_ENTRY(f64_scalar, double, false)
}  // extern "C"
