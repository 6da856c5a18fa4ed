// DIA SpMM: out[r, :] = sum_k grid[r, k] * B[r + off_k, :].
//
// Replaces two TPU kernels of the JAX package, which compute this same
// map: dia_mxu.spmm_core_mxu (pallas_call at
// torchsparsegradutils_tpu/kernels/dia_mxu.py:838) and
// dia._spmm_core_pallas (kernels/dia.py:477).  The same kernel computes
// A^T G: the caller passes the negated offsets and the column-shifted
// grid (kernels/dia.py, DiaGeometry.shift).
//
// Shapes: grid (n, K), B (m, p), offsets (K,) int64 sorted, out (n, p),
// all row-major and contiguous.  Rows with r + off_k outside [0, m) are
// holes: they add nothing, and B is never read there.
//
// What bounds it on an H100: bytes.  The least traffic is grid + B + out
// (139 MB in f32 at the cfd2 shape n = m = 123,440, K = 25, p = 128,
// about 41 us at 3.35 TB/s) against 2 * nnz * p = 0.78 GFLOP, 12 us at
// the 67 TFLOP/s f32 FMA rate.  Design: threads run along p, so a warp
// reads 32 consecutive elements of a B row (one 128-byte line in f32);
// each thread keeps ROWS_PER_THREAD rows of the output in registers and
// walks the K diagonals.  The B rows a block touches span
// off_max - off_min rows (about 5,000 at cfd2, 2.5 MB), which L2 keeps,
// so B comes from device memory about once and its K-fold re-reads are
// served by L2 and L1.  A first, simple kernel: no shared-memory halo
// and no vector loads yet.
#include "tsgu_common.cuh"

namespace {

constexpr int COLS = 32;            // threadIdx.x: columns of B / out
constexpr int ROW_THREADS = 8;      // threadIdx.y
constexpr int ROWS_PER_THREAD = 4;  // output rows kept in registers
constexpr int ROWS = ROW_THREADS * ROWS_PER_THREAD;

template <typename T>
__global__ void __launch_bounds__(COLS * ROW_THREADS)
dia_spmm_kernel(const T* __restrict__ grid, const T* __restrict__ B,
                const int64_t* __restrict__ offsets, T* __restrict__ out,
                int64_t n, int64_t m, int K, int64_t p) {
  using A = typename tsgu::Acc<T>::type;
  __shared__ int64_t s_off[tsgu::MAX_DIAGS];
  const int tid = threadIdx.y * COLS + threadIdx.x;
  for (int k = tid; k < K; k += COLS * ROW_THREADS) s_off[k] = offsets[k];
  __syncthreads();

  const int64_t j = (int64_t)blockIdx.y * COLS + threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * ROWS + threadIdx.y;
  if (j >= p) return;
  A acc[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i] = A(0);

  for (int k = 0; k < K; ++k) {
    const int64_t off = s_off[k];
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) {
      const int64_t r = r0 + i * ROW_THREADS;
      const int64_t c = r + off;
      if (r < n && c >= 0 && c < m) {
        acc[i] = tsgu::fma_acc(tsgu::load_acc(grid + r * K + k),
                               tsgu::load_acc(B + c * p + j), acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int64_t r = r0 + i * ROW_THREADS;
    if (r < n) tsgu::store_acc(out + r * p + j, acc[i]);
  }
}

template <typename T>
int launch(const void* grid, const void* B, const void* offsets, void* out,
           int64_t n, int64_t m, int64_t K, int64_t p, void* stream) {
  const dim3 block(COLS, ROW_THREADS);
  const dim3 blocks((unsigned)((n + ROWS - 1) / ROWS),
                    (unsigned)((p + COLS - 1) / COLS));
  dia_spmm_kernel<T><<<blocks, block, 0, (cudaStream_t)stream>>>(
      (const T*)grid, (const T*)B, (const int64_t*)offsets, (T*)out, n, m,
      (int)K, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tsgu_dia_spmm_f32(const void* grid, const void* B, const void* offsets,
                      void* out, int64_t n, int64_t m, int64_t K, int64_t p,
                      void* stream) {
  return launch<float>(grid, B, offsets, out, n, m, K, p, stream);
}

int tsgu_dia_spmm_bf16(const void* grid, const void* B, const void* offsets,
                       void* out, int64_t n, int64_t m, int64_t K, int64_t p,
                       void* stream) {
  return launch<__nv_bfloat16>(grid, B, offsets, out, n, m, K, p, stream);
}

int tsgu_dia_spmm_f64(const void* grid, const void* B, const void* offsets,
                      void* out, int64_t n, int64_t m, int64_t K, int64_t p,
                      void* stream) {
  return launch<double>(grid, B, offsets, out, n, m, K, p, stream);
}

}  // extern "C"
