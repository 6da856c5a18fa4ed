// DIA SDDMM: out[r, k] = dot(X[r, :], Y[r + off_k, :]), 0 where
// r + off_k lies outside [0, m).
//
// Replaces two TPU kernels of the JAX package, which compute this same
// map: dia_mxu.sddmm_core_mxu (pallas_call at
// torchsparsegradutils_tpu/kernels/dia_mxu.py:974) and
// dia._dia_sddmm_pallas (kernels/dia.py:538).  It is gradA of the DIA
// SpMM on the (n, K) value grid, and the forward of a DIA sddmm.
//
// Shapes: X (n, p), Y (m, p), offsets (K,) int64 sorted, out (n, K), all
// row-major and contiguous.
//
// What bounds it on an H100: bytes.  The least traffic is X + Y + out
// (139 MB in f32 at the cfd2 shape n = m = 123,440, K = 25, p = 128,
// about 41 us at 3.35 TB/s) against 2 * nnz * p = 0.78 GFLOP, 12 us at
// the 67 TFLOP/s f32 FMA rate.  Design: one warp per output row.  The
// lanes stride along p, so each dot reads whole 128-byte lines of X and
// Y, and a butterfly of shuffles sums the 32 partial dots in the
// accumulation type.  X[r, :] is re-read K times from L1; the Y rows a
// block touches span off_max - off_min rows, which L2 keeps.  A first,
// simple kernel: no shared-memory staging yet.
#include "tsgu_common.cuh"

namespace {

constexpr int WARPS = 8;  // rows per block

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
dia_sddmm_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                 const int64_t* __restrict__ offsets, T* __restrict__ out,
                 int64_t n, int64_t m, int K, int64_t p) {
  using A = typename tsgu::Acc<T>::type;
  __shared__ int64_t s_off[tsgu::MAX_DIAGS];
  for (int k = threadIdx.x; k < K; k += blockDim.x) s_off[k] = offsets[k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n) return;  // the whole warp leaves together
  const T* x = X + r * p;
  for (int k = 0; k < K; ++k) {
    const int64_t c = r + s_off[k];
    A s = A(0);
    if (c >= 0 && c < m) {  // the same for every lane of the warp
      const T* y = Y + c * p;
      for (int64_t j = lane; j < p; j += 32) {
        s = tsgu::fma_acc(tsgu::load_acc(x + j), tsgu::load_acc(y + j), s);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == (k & 31)) tsgu::store_acc(out + r * K + k, s);
  }
}

template <typename T>
int launch(const void* X, const void* Y, const void* offsets, void* out,
           int64_t n, int64_t m, int64_t K, int64_t p, void* stream) {
  const unsigned blocks = (unsigned)((n + WARPS - 1) / WARPS);
  dia_sddmm_kernel<T><<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const T*)X, (const T*)Y, (const int64_t*)offsets, (T*)out, n, m,
      (int)K, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tsgu_dia_sddmm_f32(const void* X, const void* Y, const void* offsets,
                       void* out, int64_t n, int64_t m, int64_t K, int64_t p,
                       void* stream) {
  return launch<float>(X, Y, offsets, out, n, m, K, p, stream);
}

int tsgu_dia_sddmm_bf16(const void* X, const void* Y, const void* offsets,
                        void* out, int64_t n, int64_t m, int64_t K,
                        int64_t p, void* stream) {
  return launch<__nv_bfloat16>(X, Y, offsets, out, n, m, K, p, stream);
}

int tsgu_dia_sddmm_f64(const void* X, const void* Y, const void* offsets,
                       void* out, int64_t n, int64_t m, int64_t K, int64_t p,
                       void* stream) {
  return launch<double>(X, Y, offsets, out, n, m, K, p, stream);
}

}  // extern "C"
