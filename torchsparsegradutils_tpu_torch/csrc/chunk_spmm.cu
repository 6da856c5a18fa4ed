// Chunk-engine SpMM over a row-sorted pattern:
//   out[r, :] = sum over e in [indptr[r], indptr[r + 1]) of
//               vals[e] * B[cols[e], :].
//
// Replaces the JAX package's chunk_spmm (pallas_call at
// torchsparsegradutils_tpu/kernels/chunk_spmm.py:248).  The TPU kernel
// cuts the entry stream into chunks of C entries, reduces each chunk's
// rows with a one-hot matrix on the MXU and combines the chunk partials
// with a segment sum, because a TPU cannot scatter.  Here the pattern is
// read as CSR: one warp owns one output row, walks its entries in order
// and writes the row once.  So there are no atomics and no partial
// buffer, the result is the same on every run, an empty row writes 0 and
// a row of any length (a dense row) just loops.  Over the transpose plan
// (entries sorted by column) the same kernel computes A^T G.
//
// Shapes: indptr (n + 1,) int64, cols (nnz,) int64, vals (nnz,), B (m, p),
// out (n, p); row-major and contiguous.  blockIdx.y picks a tile of 128
// columns (tsgu::TILE), so p may reach 128 x 65,535.  The vector path
// (four consecutive columns per lane) runs when p % 4 == 0 and B and out
// are 16-byte aligned; the scalar path strides the lanes by 32 otherwise.
//
// What bounds it on an H100: bytes.  The least traffic at the uniform
// random cfd2 shape (n = m = 123,440, nnz = 3.09M, p = 128, f32) is vals
// 12.4 MB + cols 24.7 MB + B 63.2 MB + out 63.2 MB, about 49 us at
// 3.35 TB/s, against 2 nnz p = 0.79 GFLOP, 12 us at 67 TFLOP/s.  But the
// B rows arrive in random order and B is larger than the 50 MB L2, so
// each entry costs one random 512-byte row read.  Design: a warp reads a
// whole B row tile per entry (full 128-byte lines), and keeps UNROLL
// entries' rows in flight at once to hide the latency of those reads.
//
// K13 (tsgu_chunk_spmm_slab_*) replaces the chunk SpMM that each device
// runs on its own row slab under shard_map (pallas_call at
// torchsparsegradutils_tpu/parallel/chunk_sharded.py:146): the rows
// [row0, row0 + rps) of the same product, into a (rps, p) slab whose rows
// at or past n are 0.  It reads the global indptr, cols and vals in
// place: the rows are sorted, so a slab's entries are contiguous, and the
// TPU path's per-shard value relayout (take(data_ext, entry_sel)) and its
// segment_sum combine have no counterpart.  Its own symbol keeps it apart
// from K6 in a profile; the row loop is the one K6 runs.
#include "tsgu_common.cuh"

namespace {

constexpr int WARPS = 8;   // output rows per block
constexpr int UNROLL = 4;  // entries whose B rows are loaded together

// Accumulates entries [beg, end) of one row into the lane's four columns
// of the tile that starts at t0: the loop K6 and K13 share.
template <typename T, bool VEC>
__device__ __forceinline__ void row_sum(
    const int64_t* __restrict__ cols, const T* __restrict__ vals,
    const T* __restrict__ B, int64_t beg, int64_t end, int64_t t0, int lane,
    int64_t p, typename tsgu::Acc<T>::type (&acc)[4]) {
  using A = typename tsgu::Acc<T>::type;
  for (int64_t e0 = beg; e0 < end; e0 += UNROLL) {
    A v[UNROLL];
    A b[UNROLL][4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (e0 + u < end) {
        v[u] = tsgu::load_acc(vals + e0 + u);
        tsgu::load_tile<VEC>(B + cols[e0 + u] * p, t0, lane, p, b[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (e0 + u < end) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i] = tsgu::fma_acc(v[u], b[u][i], acc[i]);
        }
      }
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
chunk_spmm_kernel(const int64_t* __restrict__ indptr,
                  const int64_t* __restrict__ cols,
                  const T* __restrict__ vals, const T* __restrict__ B,
                  T* __restrict__ out, int64_t n, int64_t p) {
  using A = typename tsgu::Acc<T>::type;
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n) return;  // the whole warp leaves together
  const int64_t t0 = (int64_t)blockIdx.y * tsgu::TILE;
  A acc[4] = {A(0), A(0), A(0), A(0)};
  row_sum<T, VEC>(cols, vals, B, indptr[r], indptr[r + 1], t0, lane, p, acc);
  tsgu::store_tile<VEC>(out + r * p, t0, lane, p, acc);
}

// K13: the rows [row0, row0 + rps) of the same product, written to a
// (rps, p) slab; slab rows at or past n (the last shard's padding) are 0.
template <typename T, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
chunk_spmm_slab_kernel(const int64_t* __restrict__ indptr,
                       const int64_t* __restrict__ cols,
                       const T* __restrict__ vals, const T* __restrict__ B,
                       T* __restrict__ out, int64_t n, int64_t row0,
                       int64_t rps, int64_t p) {
  using A = typename tsgu::Acc<T>::type;
  const int lane = threadIdx.x & 31;
  const int64_t l = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (l >= rps) return;
  const int64_t r = row0 + l;
  const int64_t t0 = (int64_t)blockIdx.y * tsgu::TILE;
  A acc[4] = {A(0), A(0), A(0), A(0)};
  if (r < n) {
    row_sum<T, VEC>(cols, vals, B, indptr[r], indptr[r + 1], t0, lane, p,
                    acc);
  }
  tsgu::store_tile<VEC>(out + l * p, t0, lane, p, acc);
}

template <typename T>
int launch(const void* indptr, const void* cols, const void* vals,
           const void* B, void* out, int64_t n, int64_t p, void* stream) {
  const dim3 blocks((unsigned)((n + WARPS - 1) / WARPS),
                    (unsigned)((p + tsgu::TILE - 1) / tsgu::TILE));
  void (*kernel)(const int64_t*, const int64_t*, const T*, const T*, T*,
                 int64_t, int64_t) =
      tsgu::vec_ok(p, B, out) ? &chunk_spmm_kernel<T, true>
                              : &chunk_spmm_kernel<T, false>;
  kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int64_t*)indptr, (const int64_t*)cols, (const T*)vals,
      (const T*)B, (T*)out, n, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_slab(const void* indptr, const void* cols, const void* vals,
                const void* B, void* out, int64_t n, int64_t row0,
                int64_t rps, int64_t p, void* stream) {
  const dim3 blocks((unsigned)((rps + WARPS - 1) / WARPS),
                    (unsigned)((p + tsgu::TILE - 1) / tsgu::TILE));
  void (*kernel)(const int64_t*, const int64_t*, const T*, const T*, T*,
                 int64_t, int64_t, int64_t, int64_t) =
      tsgu::vec_ok(p, B, out) ? &chunk_spmm_slab_kernel<T, true>
                              : &chunk_spmm_slab_kernel<T, false>;
  kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int64_t*)indptr, (const int64_t*)cols, (const T*)vals,
      (const T*)B, (T*)out, n, row0, rps, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tsgu_chunk_spmm_f32(const void* indptr, const void* cols,
                        const void* vals, const void* B, void* out,
                        int64_t n, int64_t p, void* stream) {
  return launch<float>(indptr, cols, vals, B, out, n, p, stream);
}

int tsgu_chunk_spmm_bf16(const void* indptr, const void* cols,
                         const void* vals, const void* B, void* out,
                         int64_t n, int64_t p, void* stream) {
  return launch<__nv_bfloat16>(indptr, cols, vals, B, out, n, p, stream);
}

int tsgu_chunk_spmm_f64(const void* indptr, const void* cols,
                        const void* vals, const void* B, void* out,
                        int64_t n, int64_t p, void* stream) {
  return launch<double>(indptr, cols, vals, B, out, n, p, stream);
}

int tsgu_chunk_spmm_slab_f32(const void* indptr, const void* cols,
    const void* vals, const void* B, void* out, int64_t n, int64_t row0,
    int64_t rps, int64_t p, void* stream) {
  return launch_slab<float>(indptr, cols, vals, B, out, n, row0, rps, p,
      stream);
}

int tsgu_chunk_spmm_slab_bf16(const void* indptr, const void* cols,
    const void* vals, const void* B, void* out, int64_t n, int64_t row0,
    int64_t rps, int64_t p, void* stream) {
  return launch_slab<__nv_bfloat16>(indptr, cols, vals, B, out, n, row0,
      rps, p, stream);
}

int tsgu_chunk_spmm_slab_f64(const void* indptr, const void* cols,
    const void* vals, const void* B, void* out, int64_t n, int64_t row0,
    int64_t rps, int64_t p, void* stream) {
  return launch_slab<double>(indptr, cols, vals, B, out, n, row0, rps, p,
      stream);
}

}  // extern "C"
