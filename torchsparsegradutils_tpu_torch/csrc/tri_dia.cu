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
// torchsparsegradutils_tpu/kernels/dia_tri.py:150).  Upper-triangular and
// transposed solves reach this lower core through flips and the DIA grid
// shift (ops/triangular_solve.py, _tri_dia_forward).
//
// Shapes: grid (n, K), B (n, p), out (n, p), row-major and contiguous;
// meta (2 nk,) int64: the grid columns of the nk strictly-lower offsets,
// offsets ascending (d descending), then their d.  Entries nf .. nf+nr-1
// are the near ones beyond the register window (WIN < d < nb); k0 and
// kw[d - 1] (d = 1 .. WIN) are the grid columns of offsets 0 and -d, or
// -1; rows below nlate of a block have terms whose source lies in the
// block before.  xw (n, p) holds the solved
// rows in the sum type: out itself for float and double, a scratch array
// for bfloat16.
//
// What bounds it on an H100: neither bytes nor operations but the
// dependency chain.  At the cfd2 shape (n = 123,440, 13 lower offsets,
// span 2,500, p = 128, f32) the least traffic is grid + B + x, about
// 133 MB or 40 us at 3.35 TB/s, and the FMAs take about 6 us; but offset
// -1 makes every row wait for the one before, so each column is a chain of
// n dependent steps whatever p is.  Design: one CTA per tile of TP
// right-hand-side columns walks the row blocks of nb rows in order.  A
// term of row i (in-block) at distance d is
//   early  if d > i + nb: its source lies before the previous block;
//   late   if i < d <= i + nb (d >= 2): its source lies in the previous
//          block;
//   serial if d <= i, or d <= WIN: its source lies in this block (or in
//          the register window of the last WIN solved rows).
// While one warp walks block b serially, the other warps stage block b+1
// into the second of two buffers: its right-hand side less its early
// terms, read back from xw in device memory (L2: a rolling window of up
// to 8,192 rows x the tile does not fit in shared memory), which this CTA
// wrote before the last barrier; its near grid values, window values and
// 1 / diagonal.  After the barrier all threads write block b out and add
// block b+1's late terms from block b's rows in shared memory.  The
// serial walk, one thread a column, keeps the last WIN solved rows in
// registers: row i + 1's terms with d >= 2 are summed while row i is
// solved, so one FMA (the d = 1 term) and one multiply separate a row
// from the next, and the terms with d > WIN come from shared memory
// stored at least WIN rows earlier.  It is compiled for the exact count
// of those (up to NNM, else a generic loop), with no predicate past the
// block's first rows.  An earlier version that looped over predicated
// slots for every near term, with no staging ahead and no register
// window, took 15 ms at the cfd2 shape (chip_smoke.py's kernels line).
// No atomics: every run gives the same bits.
#include "tsgu_common.cuh"

namespace {

constexpr int TP = 4;          // right-hand-side columns per CTA
constexpr int THREADS = 512;
constexpr int NNM = 8;         // unrolled walk: near offsets beyond WIN
constexpr int WIN = 3;         // solved rows kept in registers

// Layout of a staging buffer of nb rows: acc (nb x TP), invd, the window
// values gw[d - 1] (d = 1 .. WIN), then gn (nb x nr).
template <typename A>
struct Stage {
  A* acc;
  A* invd;
  A* gw[WIN];
  A* gn;
  __device__ Stage(A* buf, int nb) {
    acc = buf;
    invd = buf + nb * TP;
#pragma unroll
    for (int w = 0; w < WIN; ++w) gw[w] = invd + (w + 1) * nb;
    gn = invd + (WIN + 1) * nb;
  }
};

// s less the NR near terms of row i (block-local; sources i - d in this
// block), in list order; PRED: skip the terms with d > i (late ones).
template <int NR, bool PRED, typename A>
__device__ __forceinline__ A near_sum(A s, const A* g, const A* xcol,
                                      const int (&dn)[NNM], int i) {
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    if (!PRED || dn[j] <= i) {
      s = tsgu::fma_acc(-g[i * NR + j], xcol[(i - dn[j]) * TP], s);
    }
  }
  return s;
}

// Rows [i0, i1) of one column.  x1, x2, x3 hold the last three solved
// rows; pr is row i's sum less every term but d = 1, formed while row
// i - 1 was solved.  Row i + 1's operands are read even for i + 1 = i1,
// with no branch, so that the loop body is one basic block the compiler
// can schedule: that row lies inside the shared allocation (the next
// array, buffer or xs) and its sum is never used.
template <int NR, bool PRED, typename A>
__device__ __forceinline__ void serial_rows(const Stage<A>& st, int tid,
                                            A* xcol, const int (&dn)[NNM],
                                            int i0, int i1, A& x1, A& x2,
                                            A& x3) {
  if (i0 >= i1) return;
  const A* acc = st.acc + tid;
  A pr = near_sum<NR, PRED>(acc[i0 * TP], st.gn, xcol, dn, i0);
  pr = tsgu::fma_acc(-st.gw[2][i0], x3, pr);
  pr = tsgu::fma_acc(-st.gw[1][i0], x2, pr);
  A g1n = st.gw[0][i0], invn = st.invd[i0];   // row i's, loaded a row ahead
  for (int i = i0; i < i1; ++i) {
    const A g1 = g1n;
    const A inv = invn;
    g1n = st.gw[0][i + 1];
    invn = st.invd[i + 1];
    A pn = near_sum<NR, PRED>(acc[(i + 1) * TP], st.gn, xcol, dn, i + 1);
    pn = tsgu::fma_acc(-st.gw[2][i + 1], x2, pn);
    pn = tsgu::fma_acc(-st.gw[1][i + 1], x1, pn);
    const A x = tsgu::fma_acc(-g1, x1, pr) * inv;
    xcol[i * TP] = x;
    x3 = x2;
    x2 = x1;
    x1 = x;
    pr = pn;
  }
}

template <int NR, typename A>
__device__ __forceinline__ void walk(const Stage<A>& st, int tid, A* xcol,
                                     const int (&dn)[NNM], int rows, A& x1,
                                     A& x2, A& x3) {
  // rows below the largest d have late terms, already in acc
  const int dmax = NR > 0 ? (dn[0] < rows ? dn[0] : rows) : 0;
  serial_rows<NR, true>(st, tid, xcol, dn, 0, dmax, x1, x2, x3);
  serial_rows<NR, false>(st, tid, xcol, dn, dmax, rows, x1, x2, x3);
}

template <typename T, bool FAST>
__global__ void __launch_bounds__(THREADS, 1)
tri_dia_kernel(const T* __restrict__ grid, const T* __restrict__ B,
               const int64_t* __restrict__ meta,
               typename tsgu::Acc<T>::type* xw, T* out, int64_t n, int K,
               int64_t p, int nk, int nf, int nr, int k0, int k1, int k2,
               int k3, int unit, int nb, int nlate) {
  using A = typename tsgu::Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  // two staging buffers, then the solved rows xs (nb x TP)
  const int stride = nb * (TP + WIN + 1 + nr);
  A* buf0 = reinterpret_cast<A*>(smem);
  A* xs = buf0 + 2 * stride;
  __shared__ int s_k[tsgu::MAX_DIAGS];
  __shared__ int s_d[tsgu::MAX_DIAGS];
  const int kw[WIN] = {k1, k2, k3};

  const int tid = threadIdx.x;
  for (int j = tid; j < nk; j += THREADS) {
    s_k[j] = (int)meta[j];
    s_d[j] = (int)meta[nk + j];
  }
  __syncthreads();
  int dn[NNM];
#pragma unroll
  for (int j = 0; j < NNM; ++j) dn[j] = j < nr ? s_d[nf + j] : 0;

  const int64_t c0 = (int64_t)blockIdx.x * TP;
  const int64_t nblk = (n + nb - 1) / nb;

  // block bb into buffer buf, by threads t0, t0 + step, ...: B less the
  // early terms, the near and window grid values, 1 / diagonal
  auto stage = [&](int64_t bb, A* buf, int t0, int step) {
    const int64_t base = bb * nb;
    const int rows = n - base < nb ? (int)(n - base) : nb;
    const Stage<A> st(buf, nb);
    for (int it = t0; it < rows * TP; it += step) {
      const int i = it / TP;
      const int64_t col = c0 + it % TP;
      A s = A(0);
      if (col < p) {
        const int64_t r = base + i;
        s = tsgu::load_acc(B + r * p + col);
        for (int j = 0; j < nk; ++j) {
          const int d = s_d[j];
          if (d > i + nb && r - d >= 0) {
            s = tsgu::fma_acc(-tsgu::load_acc(grid + r * K + s_k[j]),
                              xw[(r - d) * p + col], s);
          }
        }
      }
      st.acc[it] = s;
    }
    for (int it = t0; it < rows * nr; it += step) {
      const int i = it / nr;
      st.gn[it] = tsgu::load_acc(grid + (base + i) * K + s_k[nf + it % nr]);
    }
    for (int i = t0; i < rows; i += step) {
      const int64_t r = base + i;
      const T* row = grid + r * K;
      st.invd[i] = unit ? A(1)
                        : A(1) / (k0 >= 0 ? tsgu::load_acc(row + k0) : A(0));
#pragma unroll
      for (int w = 0; w < WIN; ++w) {
        st.gw[w][i] = kw[w] >= 0 && r > w ? tsgu::load_acc(row + kw[w])
                                           : A(0);
      }
    }
  };

  stage(0, buf0, tid, THREADS);
  __syncthreads();
  A x1 = A(0), x2 = A(0), x3 = A(0);  // the serial threads' last rows
  for (int64_t b = 0; b < nblk; ++b) {
    const int64_t base = b * nb;
    const int rows = n - base < nb ? (int)(n - base) : nb;
    A* cur = buf0 + (b & 1) * stride;
    A* nxt = buf0 + ((b + 1) & 1) * stride;

    if (tid < 32) {
      // the serial walk over block b, one thread a column
      if (tid < TP && c0 + tid < p) {
        const Stage<A> st(cur, nb);
        A* xcol = xs + tid;
        if constexpr (FAST) {
          switch (nr) {
            case 0: walk<0>(st, tid, xcol, dn, rows, x1, x2, x3); break;
            case 1: walk<1>(st, tid, xcol, dn, rows, x1, x2, x3); break;
            case 2: walk<2>(st, tid, xcol, dn, rows, x1, x2, x3); break;
            case 3: walk<3>(st, tid, xcol, dn, rows, x1, x2, x3); break;
            case 4: walk<4>(st, tid, xcol, dn, rows, x1, x2, x3); break;
            case 5: walk<5>(st, tid, xcol, dn, rows, x1, x2, x3); break;
            case 6: walk<6>(st, tid, xcol, dn, rows, x1, x2, x3); break;
            case 7: walk<7>(st, tid, xcol, dn, rows, x1, x2, x3); break;
            default: walk<8>(st, tid, xcol, dn, rows, x1, x2, x3);
          }
        } else {
          for (int i = 0; i < rows; ++i) {
            A s = st.acc[i * TP + tid];
            for (int j = 0; j < nr; ++j) {
              const int d = s_d[nf + j];
              if (d <= i) {
                s = tsgu::fma_acc(-st.gn[i * nr + j], xcol[(i - d) * TP], s);
              }
            }
            s = tsgu::fma_acc(-st.gw[2][i], x3, s);
            s = tsgu::fma_acc(-st.gw[1][i], x2, s);
            s = tsgu::fma_acc(-st.gw[0][i], x1, s);
            x3 = x2;
            x2 = x1;
            x1 = s * st.invd[i];
            xcol[i * TP] = x1;
          }
        }
      }
    } else if (b + 1 < nblk) {
      stage(b + 1, nxt, tid - 32, THREADS - 32);
    }
    __syncthreads();

    // block b out; block b + 1's late terms from block b's rows
    for (int it = tid; it < rows * TP; it += THREADS) {
      const int64_t col = c0 + it % TP;
      if (col < p) {
        const int64_t off = (base + it / TP) * p + col;
        const A v = xs[it];
        xw[off] = v;
        if (out != nullptr) tsgu::store_acc(out + off, v);
      }
    }
    if (b + 1 < nblk) {
      const int64_t nbase = base + nb;
      const int nrows = n - nbase < nb ? (int)(n - nbase) : nb;
      const int lr = nlate < nrows ? nlate : nrows;
      const Stage<A> st(nxt, nb);
      for (int it = tid; it < lr * TP; it += THREADS) {
        const int i = it / TP, c = it % TP;
        if (c0 + c >= p) continue;
        A s = st.acc[it];
        for (int j = 0; j < nk; ++j) {
          const int d = s_d[j];
          if (d > WIN && d > i && d <= i + nb) {
            const A g = j >= nf && j < nf + nr
                            ? st.gn[i * nr + j - nf]
                            : tsgu::load_acc(grid + (nbase + i) * K + s_k[j]);
            s = tsgu::fma_acc(-g, xs[(nb + i - d) * TP + c], s);
          }
        }
        st.acc[it] = s;
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* grid, const void* B, const void* meta, void* xw,
           void* out, int64_t n, int64_t K, int64_t p, int64_t nk,
           int64_t nf, int64_t nr, int64_t k0, int64_t k1, int64_t k2,
           int64_t k3, int64_t unit, int64_t nb, int64_t nlate,
           void* stream) {
  using A = typename tsgu::Acc<T>::type;
  const size_t smem =
      sizeof(A) * (size_t)nb * (2 * (TP + WIN + 1 + (size_t)nr) + TP);
  const unsigned blocks = (unsigned)((p + TP - 1) / TP);
  // xw == out: float and double write the solved rows once, in place
  T* o = (out == xw) ? nullptr : (T*)out;
  if (nr <= NNM) {
    tri_dia_kernel<T, true><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)grid, (const T*)B, (const int64_t*)meta, (A*)xw, o, n,
        (int)K, p, (int)nk, (int)nf, (int)nr, (int)k0, (int)k1, (int)k2,
        (int)k3, (int)unit, (int)nb, (int)nlate);
  } else {
    tri_dia_kernel<T, false><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)grid, (const T*)B, (const int64_t*)meta, (A*)xw, o, n,
        (int)K, p, (int)nk, (int)nf, (int)nr, (int)k0, (int)k1, (int)k2,
        (int)k3, (int)unit, (int)nb, (int)nlate);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define TSGU_TRI_DIA_ENTRY(NAME, T)                                          \
  int NAME(const void* grid, const void* B, const void* meta, void* xw,     \
           void* out, int64_t n, int64_t K, int64_t p, int64_t nk,          \
           int64_t nf, int64_t nr, int64_t k0, int64_t k1, int64_t k2,      \
           int64_t k3, int64_t unit, int64_t nb, int64_t nlate,             \
           void* stream) {                                                  \
    return launch<T>(grid, B, meta, xw, out, n, K, p, nk, nf, nr, k0, k1,   \
                     k2, k3, unit, nb, nlate, stream);                      \
  }

TSGU_TRI_DIA_ENTRY(tsgu_tri_dia_f32, float)
TSGU_TRI_DIA_ENTRY(tsgu_tri_dia_bf16, __nv_bfloat16)
TSGU_TRI_DIA_ENTRY(tsgu_tri_dia_f64, double)

}  // extern "C"
