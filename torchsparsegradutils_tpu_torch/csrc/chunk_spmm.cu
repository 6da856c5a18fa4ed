// Chunk-engine SpMM over a row-sorted pattern:
//   out[r, :] = sum over e in [indptr[r], indptr[r + 1]) of
//               vals[e] * B[cols[e], :].
//
// Replaces the JAX package's chunk_spmm (pallas_call at
// torchsparsegradutils_tpu/kernels/chunk_spmm.py:248).  The TPU kernel
// cuts the entry stream into chunks of C entries, reduces each chunk's
// rows with a one-hot matrix on the MXU and combines the chunk partials
// with a segment sum, because a TPU cannot scatter.  Here the pattern is
// read as CSR: one warp owns one output row of one column slab, walks its
// entries and writes the row's slab once.  So there are no atomics and no
// partial buffer, the result is the same on every run, an empty row
// writes 0 and a row of any length (a dense row) just loops.  Over the
// transpose plan (entries sorted by column) the same kernel computes
// A^T G.
//
// Shapes: indptr (n + 1,) int64, cols (nnz,) int64, vals (nnz,), B (m, p),
// out (n, p); row-major and contiguous.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W): moving the
// gathered B rows from L2 into the SMs.  Each entry needs its B row's p
// values, in random order, so at the uniform random cfd2 shape (n = m =
// 123,440, nnz = 3.09M, p = 128, f32) a launch moves 3.09M x 512 B = 1.58
// GB of B rows, from a B of 63.2 MB that the 50 MB L2 does not hold.
// (The least traffic, each B row once, is 164 MB: 49 us at 3.35 TB/s.)
// The one-warp-a-row kernel this replaces took 0.330 ms there: 0.12 ms of
// it HBM misses (0.209 ms with B's read rows folded into 15.8 MB), the
// rest four entries in flight a warp, all 32 lanes loading the same
// cols[e] (0.155 ms at p = 16 and at p = 32, where most lanes idle).
// This one takes 0.223-0.229 ms, about 7 TB/s of rows, and 0.197-0.213
// ms with B's read rows folded into L2: what is left is the L2's rate
// for scattered lines.
//
// Design:
// * Column slabs, slab-major.  blockIdx.y is the slab, so blocks run one
//   slab of B's columns at a time, rows fastest, and the slab's share of
//   B (two 128-byte lines of a row: 31.6 MB of a cfd2 B) mostly stays in
//   L2 while it is read.  The indices are read again for each slab, with
//   streaming loads that L2 evicts first.  The host picks the slab
//   (kernels/chunk_spmm.py, spmm_lanes): G lanes an entry, each with 16
//   bytes (VEC) or one element.  chip_smoke.py times slabs of one, two
//   and four lines at p = 128 (k6_times, slab_probe): two lines win on
//   the random pattern, where four passes re-read the indices too often
//   and one pass misses L2.  Rows of fewer than 8 entries on average take
//   four-line slabs: a pass costs each row a chain of dependent loads,
//   and on the hybrid residual's rows (3.8 entries) one pass wins.
// * Entries shared across lanes.  The 32 / G lane groups of a warp take
//   consecutive entries of the row, U rounds of loads in flight; each
//   group keeps its own sums, and the groups are combined once per output
//   row by a fixed xor butterfly, so every run gives the same bits.  At p
//   below a slab, G shrinks and the lanes spread over more entries (p =
//   16 f32: 4 lanes an entry, 8 entries a round) instead of idling.
// * Indices loaded once, coalesced: lane j loads cols and vals of entry
//   base + j of the row's next 32, and the groups take theirs by shuffle.
// * Occupancy over depth: the loop fits 32 registers for f32, so an SM
//   runs 64 warps; a deeper pipeline (more rounds, or the next row's
//   indices loaded ahead) took registers and ran slower.
// * VEC (16-byte accesses) needs p a multiple of 16 bytes' elements and
//   16-byte aligned B and out; otherwise the scalar path takes one
//   element a lane.
//
// K13 (tsgu_chunk_spmm_slab_*) replaces the chunk SpMM that each device
// runs on its own row slab under shard_map (pallas_call at
// torchsparsegradutils_tpu/parallel/chunk_sharded.py:146): the rows
// [row0, row0 + rps) of the same product, into a (rps, p) slab whose rows
// at or past n are 0.  It reads the global indptr, cols and vals in
// place: the rows are sorted, so a slab's entries are contiguous, and the
// TPU path's per-shard value relayout (take(data_ext, entry_sel)) and its
// segment_sum combine have no counterpart.  Its own symbol keeps it apart
// from K6 in a profile; the row loop is the one K6 runs, so its rows are
// bitwise K6's.
#include "chunk_lanes.cuh"

namespace {

using tsgu::FULL;
using tsgu::Piece;

constexpr int WARPS = 8;  // warps (output rows of a slab) a block
constexpr int U = 4;      // rounds of B loads in flight a lane

// Cols and vals of entries [base, min(base + 32, end)) of a row, lane j
// holding entry base + j (0 past the end): one coalesced load each, read
// with streaming hints so that L2 keeps B's slab rather than the indices.
template <typename T>
__device__ __forceinline__ void load_batch(
    const int64_t* __restrict__ cols, const T* __restrict__ vals,
    int64_t base, int64_t end, int lane, long long& c,
    typename tsgu::Acc<T>::type& v) {
  using A = typename tsgu::Acc<T>::type;
  c = 0;
  v = A(0);
  if (base + lane < end) {
    c = __ldcs(reinterpret_cast<const long long*>(cols) + base + lane);
    const T t = __ldcs(vals + base + lane);
    v = tsgu::load_acc(&t);
  }
}

// The loop K6 and K13 share: the lane's W columns (from col; live false
// past p, where the lane loads and stores nothing) of row r's slab of the
// product, written to dst (the output row).  Rows at or past n are empty
// and write 0.  The warp's 32 / G lane groups (G = 2^lg lanes an entry)
// take the row's entries g, g + E, g + 2E, ... (E = 32 / G) in order, U
// rounds of loads in flight; the groups are combined by a fixed xor
// butterfly and group 0 stores, so a row's bits depend on its entries
// alone.  Every lane of the warp runs it together (it shuffles).
template <typename T, bool VEC>
__device__ __forceinline__ void row_slab(
    const int64_t* __restrict__ indptr, const int64_t* __restrict__ cols,
    const T* __restrict__ vals, const T* __restrict__ B, T* __restrict__ dst,
    int64_t r, int64_t n, int64_t p, int64_t col, bool live, int lg,
    int lane) {
  using A = typename tsgu::Acc<T>::type;
  using P = Piece<T, VEC>;
  constexpr int W = P::W;
  const int E = 32 >> lg;       // entries a round: one per lane group
  const int grp = lane >> lg;
  const T* bcol = B + col;
  // lanes 0 and 1 load the row's bounds (past n: indptr[n], so empty)
  long long ip = 0;
  if (lane <= 1) ip = indptr[r + lane < n ? r + lane : n];
  const int64_t beg = __shfl_sync(FULL, ip, 0);
  const int64_t end = __shfl_sync(FULL, ip, 1);
  long long c_cur;
  A v_cur;
  load_batch<T>(cols, vals, beg, end, lane, c_cur, v_cur);
  A acc[W];
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = A(0);
  for (int64_t base = beg; base < end; base += 32) {
    if (base != beg) {
      load_batch<T>(cols, vals, base, end, lane, c_cur, v_cur);
    }
    const int cnt = end - base < 32 ? (int)(end - base) : 32;
    for (int k = 0; k < cnt; k += U * E) {
      typename P::Raw raw[U];
      A v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int slot = k + u * E + grp;
        const long long c = __shfl_sync(FULL, c_cur, slot & 31);
        v[u] = __shfl_sync(FULL, v_cur, slot & 31);
        raw[u] = P::zero();
        if (slot < cnt && live) raw[u] = P::load(bcol + c * p);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k + u * E + grp < cnt) {
          A b[W];
          P::unpack(raw[u], b);
#pragma unroll
          for (int w = 0; w < W; ++w) {
            acc[w] = tsgu::fma_acc(v[u], b[w], acc[w]);
          }
        }
      }
    }
  }
  for (int o = 1 << lg; o < 32; o <<= 1) {
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] += __shfl_xor_sync(FULL, acc[w], o);
  }
  if (grp == 0 && live) P::store(dst + col, acc);
}

// One warp a row of one slab.  The kernel is bound by the B rows in
// flight, so occupancy is what counts: this loop takes 32 registers for
// f32 (no launch bound forces it; a bound that did made other shapes of
// the loop spill), so 64 warps, the most an SM takes, run at once.
template <typename T, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
chunk_spmm_kernel(const int64_t* __restrict__ indptr,
                  const int64_t* __restrict__ cols,
                  const T* __restrict__ vals, const T* __restrict__ B,
                  T* __restrict__ out, int64_t n, int64_t p, int lg) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n) return;  // the whole warp leaves together
  const int64_t col = tsgu::slab_col<T, VEC>(blockIdx.y, lg, lane);
  row_slab<T, VEC>(indptr, cols, vals, B, out + r * p, r, n, p, col,
                   col < p, lg, lane);
}

// K13: the rows [row0, row0 + rps) of the same product, written to a
// (rps, p) slab; slab rows at or past n (the last shard's padding) are 0.
template <typename T, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
chunk_spmm_slab_kernel(const int64_t* __restrict__ indptr,
                       const int64_t* __restrict__ cols,
                       const T* __restrict__ vals, const T* __restrict__ B,
                       T* __restrict__ out, int64_t n, int64_t row0,
                       int64_t rps, int64_t p, int lg) {
  const int lane = threadIdx.x & 31;
  const int64_t l = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (l >= rps) return;
  const int64_t col = tsgu::slab_col<T, VEC>(blockIdx.y, lg, lane);
  row_slab<T, VEC>(indptr, cols, vals, B, out + l * p, row0 + l, n, p, col,
                   col < p, lg, lane);
}

// Blocks of WARPS rows by slabs of 2^lg lanes of W columns each; the host
// checks that the slab count fits grid y.
template <typename T, bool VEC>
dim3 blocks(int64_t rows, int64_t p, int lg) {
  const int64_t slab = ((int64_t)1 << lg) * Piece<T, VEC>::W;
  return dim3((unsigned)((rows + WARPS - 1) / WARPS),
              (unsigned)((p + slab - 1) / slab));
}

template <typename T, bool VEC>
int launch(const void* indptr, const void* cols, const void* vals,
           const void* B, void* out, int64_t n, int64_t p, int64_t lg,
           void* stream) {
  chunk_spmm_kernel<T, VEC><<<blocks<T, VEC>(n, p, (int)lg), WARPS * 32, 0,
                              (cudaStream_t)stream>>>(
      (const int64_t*)indptr, (const int64_t*)cols, (const T*)vals,
      (const T*)B, (T*)out, n, p, (int)lg);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch_slab(const void* indptr, const void* cols, const void* vals,
                const void* B, void* out, int64_t n, int64_t row0,
                int64_t rps, int64_t p, int64_t lg, void* stream) {
  chunk_spmm_slab_kernel<T, VEC><<<blocks<T, VEC>(rps, p, (int)lg),
                                   WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int64_t*)indptr, (const int64_t*)cols, (const T*)vals,
      (const T*)B, (T*)out, n, row0, rps, p, (int)lg);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries tsgu_chunk_spmm_<dtype>_<vec|scalar>(indptr, cols, vals, B,
// out, n, p, lg, stream) and tsgu_chunk_spmm_slab_<dtype>_<vec|scalar>(
// indptr, cols, vals, B, out, n, row0, rps, p, lg, stream): lg is log2 of
// the lanes an entry (kernels/chunk_spmm.py, spmm_lanes).
#define TSGU_CHUNK_SPMM_ENTRIES(NAME, T, VEC)                                \
  int tsgu_chunk_spmm_##NAME(const void* indptr, const void* cols,           \
                             const void* vals, const void* B, void* out,     \
                             int64_t n, int64_t p, int64_t lg,               \
                             void* stream) {                                 \
    return launch<T, VEC>(indptr, cols, vals, B, out, n, p, lg, stream);     \
  }                                                                          \
  int tsgu_chunk_spmm_slab_##NAME(const void* indptr, const void* cols,      \
                                  const void* vals, const void* B,           \
                                  void* out, int64_t n, int64_t row0,        \
                                  int64_t rps, int64_t p, int64_t lg,        \
                                  void* stream) {                            \
    return launch_slab<T, VEC>(indptr, cols, vals, B, out, n, row0, rps, p,  \
                               lg, stream);                                  \
  }

extern "C" {
TSGU_CHUNK_SPMM_ENTRIES(f32_vec, float, true)
TSGU_CHUNK_SPMM_ENTRIES(f32_scalar, float, false)
TSGU_CHUNK_SPMM_ENTRIES(bf16_vec, __nv_bfloat16, true)
TSGU_CHUNK_SPMM_ENTRIES(bf16_scalar, __nv_bfloat16, false)
TSGU_CHUNK_SPMM_ENTRIES(f64_vec, double, true)
TSGU_CHUNK_SPMM_ENTRIES(f64_scalar, double, false)
}  // extern "C"
