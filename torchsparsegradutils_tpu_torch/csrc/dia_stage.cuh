// Staging of DIA offset windows in shared memory, shared by the DIA SpMM
// (dia_spmm.cu) and the DIA SDDMM (dia_sddmm.cu).
//
// Both kernels read the same window plan (kernels/dia.py, window_plan):
// W rows of (k_first, count, off_lo, off_hi), W + 1 run starts, and NR
// runs of consecutive offsets as (k - k_first, off_k - off_lo, length),
// window by window.  A block holds the plan in shared memory as int, each
// window's off_hi turned into its span off_hi - off_lo, and copies rows of
// a dense operand into shared memory with cp.async: VW consecutive
// elements a copy, zero-filled where the row lies outside the operand
// (source size 0, the source clamped to the base).  Blocks are persistent:
// a kernel asks resident_blocks (tsgu_common.cuh) how many fit the card
// at once.
#pragma once

#include "tsgu_common.cuh"

namespace tsgu {

// Stages of the copy pipeline: the next job loads while this one
// computes.  A third stage cost more in blocks per SM than it hid (K1).
constexpr int STAGES = 2;

__host__ __device__ inline int64_t round16(int64_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Bytes of the window plan in shared memory.
__host__ __device__ inline int64_t plan_bytes(int64_t W, int64_t NR) {
  return round16((5 * W + 1 + 3 * NR) * (int64_t)sizeof(int));
}

// Copy the plan into shared memory: s_win[4 w ..] = (k_first, count,
// off_lo, span), then the W + 1 run starts, then the runs.  The caller
// synchronises before reading it.
__device__ __forceinline__ void load_plan(const int64_t* __restrict__ wplan,
                                          int W, int NR, int* s_win,
                                          int tid, int nt) {
  for (int i = tid; i < 5 * W + 1 + 3 * NR; i += nt) {
    const int64_t v = wplan[i];
    s_win[i] = i < 4 * W && i % 4 == 3 ? (int)(v - wplan[i - 1]) : (int)v;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous copy of BYTES (4, 8 or 16) from global to shared memory;
// zero-filled when !ok (the source must still be a valid address).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage VW consecutive elements (0 when !ok).  One bfloat16 is below
// cp.async's 4-byte minimum: it is copied by a plain load and store.
template <typename T, int VW>
__device__ __forceinline__ void stage(T* dst, const T* src, bool ok) {
  constexpr int BYTES = VW * (int)sizeof(T);
  if constexpr (BYTES == 2) {
    *reinterpret_cast<unsigned short*>(dst) =
        ok ? *reinterpret_cast<const unsigned short*>(src) : 0;
  } else if constexpr (BYTES == 32) {
    cp_async<16>(dst, src, ok);
    cp_async<16>(reinterpret_cast<char*>(dst) + 16,
                 reinterpret_cast<const char*>(src) + 16, ok);
  } else {
    cp_async<BYTES>(dst, src, ok);
  }
}

// VW staged elements in the accumulation type (VW = 4 needs them aligned
// to four elements).
template <int VW, typename T, typename A>
__device__ __forceinline__ void load_vec(const T* p, A (&v)[VW]) {
  if constexpr (VW == 4) {
    load4(p, v);
  } else {
    v[0] = load_acc(p);
  }
}

}  // namespace tsgu
