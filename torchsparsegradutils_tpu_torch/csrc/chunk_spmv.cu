// Chunk-engine SpMV over a row-sorted pattern (p = 1):
//   y[r] = sum over e in [indptr[r], indptr[r + 1]) of vals[e] * x[cols[e]].
//
// Replaces the JAX package's chunk_spmv (pallas_call at
// torchsparsegradutils_tpu/kernels/chunk_spmm.py:296), the matvec of
// p = 1 sparse_mm, of its transpose (over the transpose plan) and of the
// Krylov solvers.  chunk_spmm.cu at p = 1 would run one column per warp
// and idle 31 of its 32 lanes, so the matvec is a kernel of its own, as
// on the TPU.
//
// It walks row packs, the chunk LSE kernels' plan (row_packs.cuh; the
// table from kernels/row_packs.py:pack_table, cached with the plan) cut
// at SPMV_PACK entries, one block a pack: the CSR-Stream / CSR-Vector
// split of CSR-Adaptive SpMV.
//
//   * a pack of several rows (at most SPMV_PACK entries and SPMV_PACK / 2
//     rows) is staged in one burst: every thread loads its cols and vals
//     of the pack (coalesced) and its share of the indptr slice, all
//     loads issued before any use, then gathers x[cols[e]] and writes the
//     products vals[e] * x[cols[e]], each rounded once to the
//     accumulation type, to shared memory.  Lane groups of G =
//     2^table[:, 2] threads then sum one row each from shared memory (a
//     warp a row longer than 8 G), merged by a fixed butterfly, and the
//     group's first lane writes the row's y.
//   * a pack of one row (a row of more than 256 entries, or a row that
//     ends the plan before a longer one) is walked by the whole block,
//     SPMV_PACK entries at a time in registers, each thread keeping its
//     own fused multiply-add sum, then folded over the block in warp
//     order.
//
// No atomics: the sums run in a fixed order, so every run gives the same
// bits; an empty row writes 0.  The pack path rounds each product before
// adding it, as the plain version (a product, then index_add) does.
//
// Shapes: indptr (n + 1,) int64, cols (nnz,) int64, vals (nnz,) of T,
// x (m,) and y (n,) of T, packs (npacks + 1, 3) int64; the sums in float
// (T = float or bfloat16) or double (T = double).
//
// What bounds it on an H100: the gather of x.  The least traffic at the
// uniform random cfd2 shape (n = m = 123,440, nnz = 3.09M, f32) is vals
// 12.4 MB + cols 24.7 MB + indptr 1 MB + x 0.5 MB + y 0.5 MB, about
// 11.7 us at 3.35 TB/s; 2 nnz FLOP is nothing.  But its 3.09M reads of x
// land on random 32-byte sectors: x (0.5 MB) stays in L2, and only the
// share of it that the SM's L1 holds is read there.  So the kernel keeps
// its shared memory small (a pack of 512 entries: 3 KB in f32) and sets
// the carve-out to what its resident blocks need (the row offsets of a
// pack in 16 bits, so that eight blocks fit the 32 KB setting), which
// leaves the rest of each SM's 256 KB to the L1; a larger pack (2,048,
// the LSE kernels' size) left less L1 and read slower on the card, for
// all its longer bursts (PERF.md, section 6, K8).
#include "row_packs.cuh"

namespace {

using namespace tsgu::packs;

// Entries and rows a pack of several rows may hold: the host plans K8's
// packs at this size (kernels/chunk_spmm.py:SPMV_PACK).
constexpr int SPMV_PACK = 512;
constexpr int UV = SPMV_PACK / THREADS;   // a thread's entries of a burst
constexpr int UPV = ptr_loads(SPMV_PACK);
static_assert(SPMV_PACK <= 65535, "row offsets in a pack are 16-bit");

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
chunk_spmv_kernel(const int64_t* __restrict__ indptr,
                  const int64_t* __restrict__ cols,
                  const T* __restrict__ vals, const T* __restrict__ x,
                  const int64_t* __restrict__ packs, T* __restrict__ y) {
  using A = typename tsgu::Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ A red[WARPS];
  A* sv = reinterpret_cast<A*>(smem);
  uint16_t* sp = reinterpret_cast<uint16_t*>(sv + SPMV_PACK);
  const Pack pk = load_pack(packs, blockIdx.x);
  const int t = threadIdx.x;
  int64_t c[UV];
  A v[UV], xv[UV];
  if (pk.r1 - pk.r0 == 1) {
    // one row, SPMV_PACK entries at a time in registers, by the block
    A s = A(0);
    for (int64_t c0 = pk.e0; c0 < pk.e1; c0 += SPMV_PACK) {
      const int64_t cn = pk.e1 - c0;
#pragma unroll
      for (int u = 0; u < UV; ++u) {
        const int j = u * THREADS + t;
        if (j < cn) {
          c[u] = cols[c0 + j];
          v[u] = tsgu::load_acc(vals + c0 + j);
        }
      }
#pragma unroll
      for (int u = 0; u < UV; ++u) {
        if (u * THREADS + t < cn) xv[u] = tsgu::load_acc(x + c[u]);
      }
#pragma unroll
      for (int u = 0; u < UV; ++u) {
        if (u * THREADS + t < cn) s = tsgu::fma_acc(v[u], xv[u], s);
      }
    }
    s = block_fold<false>(s, red);
    if (t == 0) tsgu::store_acc(y + pk.r0, s);
    return;
  }
  check_pack<SPMV_PACK>(pk);
  const int ne = (int)(pk.e1 - pk.e0), nr = (int)(pk.r1 - pk.r0);
  int64_t xp[UPV];
#pragma unroll
  for (int u = 0; u < UV; ++u) {
    const int j = u * THREADS + t;
    if (j < ne) {
      c[u] = cols[pk.e0 + j];
      v[u] = tsgu::load_acc(vals + pk.e0 + j);
    }
  }
  load_ptrs<SPMV_PACK>(pk, indptr, xp);
#pragma unroll
  for (int u = 0; u < UV; ++u) {
    if (u * THREADS + t < ne) xv[u] = tsgu::load_acc(x + c[u]);
  }
#pragma unroll
  for (int u = 0; u < UV; ++u) {
    if (u * THREADS + t < ne) sv[u * THREADS + t] = mul(v[u], xv[u]);
  }
  store_ptrs<SPMV_PACK>(pk, xp, sp);
  __syncthreads();
  walk_rows(sp, nr, pk.lg,
            [&](int i, int b, int e, int li, int G, unsigned mask) {
              A s = A(0);
              for (int j = b + li; j < e; j += G) s += sv[j];
              s = group_sum(s, G, mask);
              if (li == 0) tsgu::store_acc(y + pk.r0 + i, s);
            });
}

template <typename T>
int launch(const void* indptr, const void* cols, const void* vals,
           const void* x, const void* packs, void* y, int64_t npacks,
           void* stream) {
  using A = typename tsgu::Acc<T>::type;
  if (npacks <= 0) return (int)cudaSuccess;
  const size_t smem = SPMV_PACK * sizeof(A) +
                      (SPMV_PACK / 2 + 1) * sizeof(uint16_t);
  // The shared memory carve-out: what the resident blocks need (their
  // dynamic and static shared memory and the 1 KB the system keeps for
  // each), of the 228 KB an SM can give; set once a dtype.
  static bool carved = false;
  if (!carved) {
    int per_sm = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chunk_spmv_kernel<T>, THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    const size_t need = per_sm * (smem + WARPS * sizeof(A) + 1024);
    e = cudaFuncSetAttribute(chunk_spmv_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)((need * 100 + 233471) / 233472));
    if (e != cudaSuccess) return (int)e;
    carved = true;
  }
  chunk_spmv_kernel<T><<<(unsigned)npacks, THREADS, smem,
                         (cudaStream_t)stream>>>(
      (const int64_t*)indptr, (const int64_t*)cols, (const T*)vals,
      (const T*)x, (const int64_t*)packs, (T*)y);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tsgu_chunk_spmv_f32(const void* indptr, const void* cols,
                        const void* vals, const void* x, const void* packs,
                        void* y, int64_t npacks, void* stream) {
  return launch<float>(indptr, cols, vals, x, packs, y, npacks, stream);
}

int tsgu_chunk_spmv_bf16(const void* indptr, const void* cols,
                         const void* vals, const void* x, const void* packs,
                         void* y, int64_t npacks, void* stream) {
  return launch<__nv_bfloat16>(indptr, cols, vals, x, packs, y, npacks,
                               stream);
}

int tsgu_chunk_spmv_f64(const void* indptr, const void* cols,
                        const void* vals, const void* x, const void* packs,
                        void* y, int64_t npacks, void* stream) {
  return launch<double>(indptr, cols, vals, x, packs, y, npacks, stream);
}

}  // extern "C"
