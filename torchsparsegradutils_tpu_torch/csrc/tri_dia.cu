// Banded lower-triangular solve from the DIA value grid:
//
//   x[r, :] = (B[r, :] - sum_{k: d_k > 0} grid[r, k] * x[r - d_k, :])
//             / grid[r, k0],          d_k = -off_k,
//
// k0 the column of offset 0.  Columns with off_k > 0 are ignored (dense
// triangular-solve semantics); with unit the diagonal is 1 and column k0
// is not read.  Sums run in float for float and bfloat16, in double for
// double.
//
// Replaces the TPU kernel of the JAX package that computes this solve:
// dia_tri.tri_dia_core (pallas_call at
// torchsparsegradutils_tpu/kernels/dia_tri.py:150), with its block
// inverses (_build_diag_inv, :50).  Upper-triangular and transposed
// solves reach this lower core through flips and the DIA grid shift
// (ops/triangular_solve.py, _tri_dia_forward).
//
// Shapes: grid (n, K), B (n, p), out (n, p), row-major and contiguous;
// meta (2 nk,) int64: the grid columns of the nk strictly-lower offsets,
// offsets ascending (d descending), then their d.  dinv (nblk, NB, DS)
// holds the inverse of each NB-row block's lower triangle, zero above
// the diagonal, in rows of stride DS; xw (n, p) the solved rows in the
// sum type: out itself for float and double, a scratch array for
// bfloat16.
//
// What bounds it on an H100: neither bytes nor operations but the
// dependency chain.  At the cfd2 shape (n = 123,440, 13 lower offsets,
// span 2,500, p = 128, f32) the least traffic is grid + B + x, about
// 133 MB or 40 us at 3.35 TB/s, and the FMAs take about 6 us; but offset
// -1 makes every row wait for the one before.  A walk of one row a step
// is n steps whatever p is (5.1 ms in the kernel this one replaced).
// Design: the block inverses cut the chain to n / NB block steps,
// x_b = Dinv_b (B_b - off-block terms).  tri_dia_inv_kernel builds every
// Dinv_b at once (one CTA a block, one thread a column of the inverse,
// forward substitution down the block, the block's grid values staged
// first): a chain of NB rows, all blocks in parallel.  tri_dia_kernel
// walks the blocks in order, one CTA per tile of TP right-hand-side
// columns, and keeps each step short.  A term of row i of block b at
// distance d is
//   in-block if d <= i: it is inside Dinv_b;
//   late     if i < d <= i + NB: its source lies in block b - 1;
//   early    if d > i + NB: its source lies before block b - 1.
// Three roles share the step, each through shared memory only:
//   - the copy warp keeps Dinv two blocks ahead and the grid rows three
//     blocks ahead in shared memory, one bulk copy (the Tensor Memory
//     Accelerator) a buffer, and waits on their mbarriers;
//   - the producer warps, one thread an element, form block b + 1's
//     right-hand side: B (loaded a block ahead into a register) less the
//     early terms, whose sources they read from a ring in shared memory
//     that holds the last span / NB + 2 blocks of solved rows;
//   - the consumer warps subtract block b's late terms (sources in the
//     ring), then compute x_b = Dinv_b rhs: G lanes a pair of rows (i,
//     NB - 1 - i), each lane its strided columns, fully unrolled with no
//     predicate (Dinv is 0 above its diagonal), the 2 TP sums split among
//     the lanes by a fixed butterfly; x_b goes to the ring, xw and out.
// Where that ring and the grid rows do not fit the card's shared memory
// (float64 with wide bands, or many offsets), launch() takes the kernel's
// other instantiation: the early terms read xw, the grid values the grid,
// and the ring keeps the two blocks the late terms read.  A step is two
// barriers and these chains; the walk is instruction- and latency-bound at
// about 1,900 steps, far above the bytes bound.  No atomics and no tensor
// cores: every run gives the same bits.
#include "dia_stage.cuh"

namespace {

constexpr int NB = 64;         // rows of a block
constexpr int TP = 2;          // right-hand-side columns per CTA
constexpr int NC = 128;        // consumer threads: late terms, product
// lanes that sum a pair of rows
constexpr int G = NC / (NB / 2) < 8 ? NC / (NB / 2) : 8;
constexpr int NP = NB * TP;    // producer threads: one element each
constexpr int THREADS = NC + NP + 32;   // and a warp that copies ahead
constexpr int U = 6;           // early terms of a row held in registers
constexpr int L = 6;           // late terms of a row held in registers
constexpr int PF = 4;          // blocks between B's L2 prefetch and its load
constexpr int NDINV = 3;       // Dinv buffers: in use, landed, landing
constexpr int NGRID = 4;       // grid-row buffers: consumers', producers',
                               // landed, landing
constexpr int DS = NB + G;     // Dinv's row stride: the G lanes of the
                               // 32 / G row pairs of a warp hit distinct banks
constexpr int V = 2 * TP;      // sums of a row pair
constexpr int PER = V > G ? V / G : 1;   // sums a lane holds after the split
constexpr int REP = G > V ? G / V : 1;   // lanes holding the same sums
static_assert(NB * TP <= NC && NP % 32 == 0, "one element a thread");
static_assert(NB / 2 * G <= NC && (NB / 2) % (32 / G) == 0,
              "one row pair a lane group, whole warps");

// Bytes of the walk's dynamic shared memory: the Dinv buffers, two
// right-hand-side buffers, a ring of nr blocks' solved rows and, with
// stage, the grid-row buffers (each NB x K of the storage type).
template <typename T>
int64_t walk_smem(int64_t nr, bool stage, int64_t K) {
  using A = typename tsgu::Acc<T>::type;
  return (int64_t)sizeof(A) * (NDINV * NB * DS + 2 * NB * TP + nr * NB * TP) +
         (stage ? (int64_t)sizeof(T) * NGRID * NB * K : 0);
}

// A bulk copy (the Tensor Memory Accelerator) of `bytes` (a multiple of
// 16, both addresses 16-byte aligned) from global to shared memory, whose
// completion the mbarrier `bar` counts; and the mbarrier operations.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
      tsgu::smem_addr(bar)));
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          tsgu::smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(tsgu::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(tsgu::smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT_%=:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}" ::"r"(tsgu::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Barriers of the whole CTA (id 0) and of the consumer warps (id 1); the
// "memory" clobber keeps shared-memory accesses on their side.
__device__ __forceinline__ void sync_all() {
  asm volatile("bar.sync 0;" ::: "memory");
}
__device__ __forceinline__ void sync_consumers() {
  asm volatile("bar.sync 1, %0;" ::"n"(NC) : "memory");
}

// The lane's TP consecutive elements of a row aligned to TP elements, in
// one vector load.
template <typename A>
__device__ __forceinline__ void load_row(const A* p, A (&r)[TP]) {
  struct alignas(sizeof(A) * TP) Row { A v[TP]; };
  const Row q = *reinterpret_cast<const Row*>(p);
#pragma unroll
  for (int c = 0; c < TP; ++c) r[c] = q.v[c];
}

// Sum v over the G lanes of a group, leaving each lane a share: at each
// offset o = G/2 .. 1 a lane keeps the half of its sums its bit o selects
// and adds the partner's; once one sum is left the rest is a butterfly.
// Returns the index in v of the lane's first sum (it holds PER).
template <typename A>
__device__ __forceinline__ int split_sums(A (&v)[V], int lane) {
  int idx = 0;
#pragma unroll
  for (int r = 0; (G >> (r + 1)) > 0; ++r) {
    const int o = G >> (r + 1);
    const int m = (V >> r) > 0 ? V >> r : 1;
    if (m > 1) {
      const int h = m / 2;
      const bool hi = lane & o;
#pragma unroll
      for (int k = 0; k < h; ++k) {
        const A send = hi ? v[k] : v[k + h];
        const A keep = hi ? v[k + h] : v[k];
        v[k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
      if (hi) idx += h;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
  return idx;
}

template <typename T, bool STAGE>
__global__ void __launch_bounds__(THREADS, 1)
tri_dia_kernel(const T* __restrict__ grid, const T* __restrict__ B,
               const typename tsgu::Acc<T>::type* __restrict__ dinv,
               const int64_t* __restrict__ meta,
               typename tsgu::Acc<T>::type* xw, T* out, int64_t n, int K,
               int64_t p, int nk, int nr) {
  using A = typename tsgu::Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  A* sdinv = reinterpret_cast<A*>(smem);       // NDINV x NB x DS
  A* srhs = sdinv + NDINV * NB * DS;           // 2 x NB x TP
  A* xring = srhs + 2 * NB * TP;               // nr x NB x TP
  T* sgrid = reinterpret_cast<T*>(xring + nr * NB * TP);   // NGRID x NB x K
  __shared__ int s_k[tsgu::MAX_DIAGS];
  __shared__ int s_d[tsgu::MAX_DIAGS];
  __shared__ __align__(8) uint64_t s_bar[NDINV + NGRID];
  uint64_t* dbar = s_bar;                      // Dinv buffer s landed
  uint64_t* gbar = s_bar + NDINV;              // grid-row buffer s landed
  const int tid = threadIdx.x;
  for (int j = tid; j < nk; j += THREADS) {
    s_k[j] = (int)meta[j];
    s_d[j] = (int)meta[nk + j];
  }
  if (tid < NDINV + NGRID) bar_init(s_bar + tid);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();
  const int64_t c0 = (int64_t)blockIdx.x * TP;
  const int nblk = (int)((n + NB - 1) / NB);
  // meta entries 0 .. above(t) - 1 have d > t (d descends)
  auto above = [&](int t) {
    int m = 0;
    while (m < nk && s_d[m] > t) ++m;
    return m;
  };
  // block bb's grid rows: its buffer, or the grid itself
  auto grows = [&](int bb) -> const T* {
    if constexpr (STAGE) return sgrid + (bb % NGRID) * NB * K;
    return grid + (int64_t)bb * NB * K;
  };

  if (tid < NC) {
    // consumers: thread tid takes the late terms (meta entries lo .. lo +
    // nlt - 1, i < d <= i + NB: sources in the block before, in the ring)
    // of element (li, lc) of each block; lane group tid / G the row pair
    // (i0, i1) = (q, NB - 1 - q) of the product
    const int li = tid / TP, lc = tid % TP;
    const bool lact = tid < NB * TP;
    const int lo = lact ? above(li + NB) : 0;
    const int nlt = lact ? above(li) - lo : 0;
    int lgo[L], lro[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int j = k < nlt ? lo + k : 0;
      lgo[k] = li * K + s_k[j];
      lro[k] = (li - s_d[j] + NB) * TP + lc;
    }
    const int q = tid / G, lane = tid % G;
    const int i0 = q, i1 = NB - 1 - q;
    // the sums this lane keeps after split_sums, and where they go
    int orow[PER], oxs[PER];
    int64_t ooff[PER];
    bool ocol[PER];
    {
      A probe[V];
#pragma unroll
      for (int k = 0; k < V; ++k) probe[k] = A(0);
      const int idx = split_sums(probe, lane);
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int k = idx + m, c = k % TP;
        orow[m] = k < TP ? i0 : i1;
        oxs[m] = orow[m] * TP + c;
        ooff[m] = (int64_t)orow[m] * p + c0 + c;
        ocol[m] = lane % REP == 0 && c0 + c < p;
      }
    }
    sync_all();                                // the prologue's staging
    int slot = 0, rs = 0, prev = nr - 1;       // Dinv, ring slots of b, b-1
    for (int b = 0; b < nblk; ++b) {
      const int64_t base = (int64_t)b * NB;
      A* rhs = srhs + (b & 1) * NB * TP;
      // (rows past n keep the 0 the producers gave them)
      if (b > 0 && nlt > 0 && base + li < n) {
        const T* g = grows(b);
        const A* xp = xring + prev * NB * TP;
        A s = rhs[tid];
#pragma unroll
        for (int k = 0; k < L; ++k) {
          if (k < nlt) s = tsgu::fma_acc(-tsgu::load_acc(g + lgo[k]),
                                         xp[lro[k]], s);
        }
        for (int j = lo + L; j < lo + nlt; ++j) {   // rows with more
          s = tsgu::fma_acc(-tsgu::load_acc(g + li * K + s_k[j]),
                            xp[(li - s_d[j] + NB) * TP + lc], s);
        }
        rhs[tid] = s;
      }
      sync_consumers();
      // x_b = Dinv_b rhs, lane j of the group taking columns j, j + G,
      // ...: Dinv is 0 above its diagonal, so row i1 runs over every
      // column and row i0 (< NB / 2) over the first half, with no
      // predicate (whole warps: q < NB / 2)
      if (q < NB / 2) {
      const A* D = sdinv + slot * NB * DS + lane;
      const A* d1p = D + i1 * DS;
      const A* d0p = D + i0 * DS;
      const A* rp = rhs + lane * TP;
      A v[V];
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = A(0);
#pragma unroll
      for (int k = 0; k < NB / G; ++k) {
        A rr[TP];
        load_row(rp + k * G * TP, rr);
        const A d1 = d1p[k * G];
#pragma unroll
        for (int c = 0; c < TP; ++c) v[TP + c] = tsgu::fma_acc(d1, rr[c],
                                                               v[TP + c]);
        if (k < NB / 2 / G) {
          const A d0 = d0p[k * G];
#pragma unroll
          for (int c = 0; c < TP; ++c) v[c] = tsgu::fma_acc(d0, rr[c], v[c]);
        }
      }
      split_sums(v, lane);
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        if (lane % REP == 0) xring[rs * NB * TP + oxs[m]] = v[m];
        if (ocol[m] && base + orow[m] < n) {
          const int64_t off = base * p + ooff[m];
          xw[off] = v[m];
          if (out != nullptr) tsgu::store_acc(out + off, v[m]);
        }
      }
      }
      sync_all();
      slot = slot == NDINV - 1 ? 0 : slot + 1;
      prev = rs;
      rs = rs == nr - 1 ? 0 : rs + 1;
    }
  } else if (tid >= NC + NP) {
    // the copy warp: its lane 0 copies Dinv_bb (rows of stride DS, as the
    // inverse build writes them) and block bb's grid rows into their
    // buffers, one bulk copy each (the grid rows' last bytes short of 16
    // by plain stores), two and three blocks ahead
    const bool lead = tid == NC + NP;
    auto copy = [&](int bd, int bg) {
      if (!lead) return;
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      if (bd >= 0 && bd < nblk) {
        bulk_copy(sdinv + (bd % NDINV) * NB * DS,
                  dinv + (int64_t)bd * NB * DS, NB * DS * (int)sizeof(A),
                  dbar + bd % NDINV);
      }
      if (STAGE && bg < nblk) {
        const int64_t base = (int64_t)bg * NB;
        const int elems = (int)((n - base < NB ? n - base : NB) * K);
        const int bulk = elems * (int)sizeof(T) / 16 * 16;
        T* dst = sgrid + (bg % NGRID) * NB * K;
        const T* src = grid + base * K;
        if (bulk > 0) bulk_copy(dst, src, bulk, gbar + bg % NGRID);
        else asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                 tsgu::smem_addr(gbar + bg % NGRID)) : "memory");
        for (int k = bulk / (int)sizeof(T); k < elems; ++k) dst[k] = src[k];
      }
    };
    auto wait = [&](int bd, int bg) {
      if (!lead) return;
      if (bd >= 0 && bd < nblk) bar_wait(dbar + bd % NDINV, (bd / NDINV) & 1);
      if (STAGE && bg < nblk) bar_wait(gbar + bg % NGRID, (bg / NGRID) & 1);
    };
    // Dinv NDINV - 1 blocks ahead, grid rows NGRID - 1
    for (int k = 0; k < NGRID - 1; ++k) copy(k < NDINV - 1 ? k : -1, k);
    wait(0, 0);
    wait(-1, 1);
    sync_all();
    for (int b = 0; b < nblk; ++b) {
      copy(b + NDINV - 1, b + NGRID - 1);
      wait(b + 1, b + 2);                      // for step b + 1
      sync_all();
    }
  } else {
    // producers: thread e takes element (i, c) of each block's right-hand
    // side, B (loaded a block ahead) less the early terms (meta entries 0
    // .. ne - 1, d > i + NB: sources before the block before, in the ring
    // or, without STAGE, in xw)
    const int e = tid - NC;
    const bool act = e < NB * TP;
    const int i = e / TP, c = e % TP;
    const int64_t col = c0 + c;
    const int ne = act ? above(i + NB) : 0;
    // term u of block bb: its source is row xro[u] of block bb + delta,
    // ring slot xs[u] (advanced a block at a time), from block eb[u] on
    int ed[U], ego[U], xro[U], xs[U], eb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = u < ne ? u : 0;
      const int d = s_d[j];
      const int delta = -((d - i + NB - 1) / NB);
      ed[u] = d;
      ego[u] = i * K + s_k[j];
      xro[u] = (i - d - delta * NB) * TP + c;
      xs[u] = ((delta % nr) + nr) % nr;
      eb[u] = u < ne ? -delta : nblk;
    }
    A bv = A(0);
    auto load_b = [&](int bb) {
      const int64_t r = (int64_t)bb * NB + i;
      bv = act && col < p && bb < nblk && r < n
               ? tsgu::load_acc(B + r * p + col)
               : A(0);
    };
    // block bb's right-hand side; 0 for rows past n, which the product
    // multiplies by Dinv's zeros
    auto finish = [&](int bb) {
      const T* g = grows(bb);
      const int64_t r = (int64_t)bb * NB + i;
      A s = bv;
      if (act && bb < nblk && r < n) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (bb >= eb[u]) {                   // u < ne, source past row 0
            const A x = STAGE ? xring[xs[u] * NB * TP + xro[u]]
                              : xw[(r - ed[u]) * p + col];
            s = tsgu::fma_acc(-tsgu::load_acc(g + ego[u]), x, s);
          }
        }
        for (int j = U; j < ne; ++j) {         // rows with more
          const int64_t src = r - s_d[j];
          if (src >= 0) {
            const A x = STAGE ? xring[(int)((src / NB) % nr) * NB * TP +
                                      (int)(src % NB) * TP + c]
                              : xw[src * p + col];
            s = tsgu::fma_acc(-tsgu::load_acc(g + i * K + s_k[j]), x, s);
          }
        }
      }
      if (act && bb < nblk) srhs[(bb & 1) * NB * TP + e] = s;
#pragma unroll
      for (int u = 0; u < U; ++u) xs[u] = xs[u] == nr - 1 ? 0 : xs[u] + 1;
    };
    // block bb's B rows into L2
    auto prefetch = [&](int bb) {
      const int64_t r = (int64_t)bb * NB + e;
      if (e < NB && bb < nblk && r < n) {
        asm volatile("prefetch.global.L2 [%0];" ::"l"(B + r * p + c0));
      }
    };
    for (int k = 1; k <= PF; ++k) prefetch(k);
    load_b(0);
    finish(0);                                 // no early term in block 0
    load_b(1);
    sync_all();
    for (int b = 0; b < nblk; ++b) {
      finish(b + 1);
      load_b(b + 2);
      prefetch(b + 2 + PF);
      sync_all();
    }
  }
}

// Dinv_b for every row block b: one CTA a block, thread c the column c of
// the inverse, by forward substitution down the block (rows above c are
// 0).  The block holds the offsets with 0 < d < NB (meta entries ni ..
// nk - 1) and the diagonal (1 with unit, and for the padded rows past n);
// its rows go out at a stride of DS, as the walk copies them.
template <typename T>
__global__ void __launch_bounds__(NB)
tri_dia_inv_kernel(const T* __restrict__ grid,
                   const int64_t* __restrict__ meta,
                   typename tsgu::Acc<T>::type* dinv, int64_t n, int K,
                   int nk, int ni, int k0, int unit) {
  using A = typename tsgu::Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nin = nk - ni;
  A* X = reinterpret_cast<A*>(smem);           // NB x (NB + 1)
  A* gin = X + NB * (NB + 1);                  // the block's grid values
  A* invd = gin + NB * nin;                    // 1 / diagonal
  __shared__ int s_k[tsgu::MAX_DIAGS];
  __shared__ int s_d[tsgu::MAX_DIAGS];
  const int c = threadIdx.x;
  for (int j = c; j < nin; j += NB) {
    s_k[j] = (int)meta[ni + j];
    s_d[j] = (int)meta[nk + ni + j];
  }
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * NB;
  // stage the block's grid values first, so the chain reads shared memory
  for (int it = c; it < NB * nin; it += NB) {
    const int i = it / nin, j = it % nin;
    const int64_t r = base + i;
    gin[it] = r < n && s_d[j] <= i ? tsgu::load_acc(grid + r * K + s_k[j])
                                   : A(0);
  }
  {
    const int64_t r = base + c;
    invd[c] = r < n && !unit
                  ? A(1) / (k0 >= 0 ? tsgu::load_acc(grid + r * K + k0) : A(0))
                  : A(1);
  }
  __syncthreads();
  A* dst = dinv + (int64_t)blockIdx.x * NB * DS;
  for (int i = 0; i < NB; ++i) {
    A s = i == c ? A(1) : A(0);
    for (int j = 0; j < nin; ++j) {
      const int d = s_d[j];
      if (d <= i) {
        s = tsgu::fma_acc(-gin[i * nin + j], X[(i - d) * (NB + 1) + c], s);
      }
    }
    const A x = i < c ? A(0) : s * invd[i];
    X[i * (NB + 1) + c] = x;
    dst[i * DS + c] = x;
  }
}

// Dynamic shared memory above 48 KB needs the kernel's consent.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int64_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, bool STAGE>
int launch_walk(const T* grid, const T* B, const void* dinv,
                const void* meta, void* xw, void* out, int64_t n, int64_t K,
                int64_t p, int64_t nk, int64_t nr, void* stream) {
  using A = typename tsgu::Acc<T>::type;
  const int64_t smem = walk_smem<T>(nr, STAGE, K);
  cudaError_t rc = allow_smem(tri_dia_kernel<T, STAGE>, smem);
  if (rc != cudaSuccess) return (int)rc;
  const unsigned blocks = (unsigned)((p + TP - 1) / TP);
  // xw == out: float and double write the solved rows once, in place
  T* o = (out == xw) ? nullptr : (T*)out;
  tri_dia_kernel<T, STAGE><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      grid, B, (const A*)dinv, (const int64_t*)meta, (A*)xw, o, n, (int)K, p,
      (int)nk, (int)nr);
  return (int)cudaGetLastError();
}

// The walk's plan: a ring of the band's last ceil(span / NB) + 2 blocks of
// solved rows and the grid rows staged, where both fit the shared memory a
// CTA of this card may take beside the kernel's static tables; else a
// ring of the two blocks the late terms read, and xw and the grid read in
// device memory.
template <typename T>
int launch(const void* grid, const void* B, const void* dinv,
           const void* meta, void* xw, void* out, int64_t n, int64_t K,
           int64_t p, int64_t nk, int64_t span, void* stream) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc == cudaSuccess)
    rc = cudaFuncGetAttributes(&attr, tri_dia_kernel<T, true>);
  if (rc != cudaSuccess) return (int)rc;
  const T* g = (const T*)grid;
  const T* b = (const T*)B;
  const int64_t full = (span + NB - 1) / NB + 2;
  if (walk_smem<T>(full, true, K) + (int64_t)attr.sharedSizeBytes <= optin)
    return launch_walk<T, true>(g, b, dinv, meta, xw, out, n, K, p, nk, full,
                                stream);
  return launch_walk<T, false>(g, b, dinv, meta, xw, out, n, K, p, nk, 2,
                               stream);
}

template <typename T>
int launch_inv(const void* grid, const void* meta, void* dinv, int64_t n,
               int64_t K, int64_t nk, int64_t ni, int64_t k0, int64_t unit,
               void* stream) {
  using A = typename tsgu::Acc<T>::type;
  const int64_t smem = sizeof(A) * NB * (NB + 1 + nk - ni + 1);
  cudaError_t rc = allow_smem(tri_dia_inv_kernel<T>, smem);
  if (rc != cudaSuccess) return (int)rc;
  const unsigned blocks = (unsigned)((n + NB - 1) / NB);
  tri_dia_inv_kernel<T><<<blocks, NB, smem, (cudaStream_t)stream>>>(
      (const T*)grid, (const int64_t*)meta, (A*)dinv, n, (int)K, (int)nk,
      (int)ni, (int)k0, (int)unit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define TSGU_TRI_DIA_ENTRY(SUFFIX, T)                                        \
  int tsgu_tri_dia_##SUFFIX(const void* grid, const void* B,                \
                            const void* dinv, const void* meta, void* xw,   \
                            void* out, int64_t n, int64_t K, int64_t p,     \
                            int64_t nk, int64_t span, void* stream) {       \
    return launch<T>(grid, B, dinv, meta, xw, out, n, K, p, nk, span,       \
                     stream);                                               \
  }                                                                         \
  int tsgu_tri_dia_inv_##SUFFIX(const void* grid, const void* meta,         \
                                void* dinv, int64_t n, int64_t K,           \
                                int64_t nk, int64_t ni, int64_t k0,         \
                                int64_t unit, void* stream) {               \
    return launch_inv<T>(grid, meta, dinv, n, K, nk, ni, k0, unit, stream); \
  }

TSGU_TRI_DIA_ENTRY(f32, float)
TSGU_TRI_DIA_ENTRY(bf16, __nv_bfloat16)
TSGU_TRI_DIA_ENTRY(f64, double)

}  // extern "C"
