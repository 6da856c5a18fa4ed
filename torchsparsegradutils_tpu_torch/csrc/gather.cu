// Value-grid gather: dst[d] = map[d] >= 0 ? src[map[d]] : 0.
//
// Replaces the JAX package's window-gather relayout kernel,
// window_gather._window_gather_impl (pallas_call at
// torchsparsegradutils_tpu/kernels/window_gather.py:402).  It moves a
// DIA matrix's values between CSR order (nnz,) and the (n, K) diagonal
// grid in both directions, and compacts and expands the hybrid residual.
// The TPU kernel's z8 / drift / BigShift window plans exist because a
// TPU cannot gather scalars at speed; an H100 can, so the map is read as
// it is.
//
// Values are copied as raw 2-, 4- or 8-byte words, so bfloat16 moves
// exactly, with no widening.  The map is int64: n * K passes 2^31 on
// large plans.  An index outside [0, src_size) reads as a hole.
//
// What bounds it on an H100: bytes: the map (8 bytes a slot) + src +
// dst, about 49 MB for the f32 cfd2 grid fill (n * K = 3.09M slots from
// 3.06M values), or 15 us at 3.35 TB/s; it does no arithmetic.  Design:
// a grid-stride loop, one slot per thread per step, so map and dst
// stream coalesced; the src reads of a monotone map walk forward through
// memory.
#include "tsgu_common.cuh"

namespace {

template <typename W>
__global__ void gather_kernel(const W* __restrict__ src,
                              const int64_t* __restrict__ map,
                              W* __restrict__ dst, int64_t src_size,
                              int64_t dst_size) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t d = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       d < dst_size; d += stride) {
    const int64_t s = map[d];
    dst[d] = (s >= 0 && s < src_size) ? src[s] : W(0);
  }
}

template <typename W>
int launch(const void* src, const void* map, void* dst, int64_t src_size,
           int64_t dst_size, void* stream) {
  constexpr int THREADS = 256;
  int64_t blocks = (dst_size + THREADS - 1) / THREADS;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  gather_kernel<W><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const W*)src, (const int64_t*)map, (W*)dst, src_size, dst_size);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tsgu_gather_f32(const void* src, const void* map, void* dst,
                    int64_t src_size, int64_t dst_size, void* stream) {
  return launch<uint32_t>(src, map, dst, src_size, dst_size, stream);
}

int tsgu_gather_bf16(const void* src, const void* map, void* dst,
                     int64_t src_size, int64_t dst_size, void* stream) {
  return launch<uint16_t>(src, map, dst, src_size, dst_size, stream);
}

int tsgu_gather_f64(const void* src, const void* map, void* dst,
                    int64_t src_size, int64_t dst_size, void* stream) {
  return launch<uint64_t>(src, map, dst, src_size, dst_size, stream);
}

}  // extern "C"
