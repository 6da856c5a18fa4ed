// DIA SDDMM: out[r, k] = dot(X[r, :], Y[r + off_k, :]), 0 where
// r + off_k lies outside [0, m).
//
// Replaces two TPU kernels of the JAX package, which compute this same
// map: dia_mxu.sddmm_core_mxu (pallas_call at
// torchsparsegradutils_tpu/kernels/dia_mxu.py:974) and
// dia._dia_sddmm_pallas (kernels/dia.py:538).  It is gradA of the DIA
// SpMM on the (n, K) value grid, and the forward of a DIA sddmm.
//
// Shapes: X (n, p), Y (m, p), out (n, K), all row-major and contiguous;
// the sorted offsets reach the kernel through the window plan.
//
// What bounds it on an H100: bytes.  The least traffic is X + Y + out
// (139 MB in f32 at the cfd2 shape n = m = 123,440, K = 25, p = 128,
// 41 us at 3.35 TB/s) against 2 * nnz * p = 0.79 GFLOP, 12 us at the
// 67 TFLOP/s f32 FMA rate.  The first version of this kernel, one warp
// per output row, read Y[r + off_k] from global memory for every (r, k)
// (K times Y, 1.58 GB through L1/L2) and summed each (r, k) over the warp
// with a butterfly of shuffles per 32 columns: 0.35 ms, and 0.25 ms at
// p = 16, 2 and 1 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py --k2).
//
// What bounds this design: the copies into shared memory.  At p = 128 a
// launch stages 338 MB of Y and 190 MB of X from L2 (3.8 times the bound's
// bytes), about 3.4 TB/s at its 0.156 ms of device time, the rate at
// which the DIA SpMM stages the same windows; trial builds without the
// products, or without the copies, each took most of that time.  At
// p = 16, 2 and 1 (0.033, 0.025 and 0.025 ms; bounds 0.008, 0.004 and
// 0.004) the output, 12.3 MB stored a few elements a row at a time, is
// most of the bytes; what holds the kernel there is not measured.
//
// Design: the offset windows of the DIA SpMM (dia_stage.cuh), turned
// round.  A block owns R output rows at a time and walks its jobs
// (tile, window, column slab of PT columns), slabs innermost.  Each job
// stages Y rows [r0 + off_lo, r0 + R + off_hi) and X rows [r0, r0 + R) of
// the slab by cp.async, two stages deep; rows outside [0, m), past n and
// columns past p are zero-filled, and a window wholly outside stages
// nothing and stores zeros.  At the cfd2 stencil with R = 128 that is 3
// windows and 684 staged Y rows (and 3 x 128 X rows) a tile, against
// 25 x 128 rows read from L2 one by one before.
//
// The reduction runs over p.  The host cuts each window's runs of
// consecutive offsets into segments of at most LT offsets (window_plan),
// and caps a window at NT / RG segments (window_table), so one pass over
// a window's items (row group of RT rows, segment) fits the block.  Each
// item takes CL consecutive threads (CL the largest power of two that
// fits NT and the slab's NV column vectors), lane l summing column
// vectors l, l + CL, ... of every slab.  A thread holds RT x LT partial
// dots in registers: per column vector it reads RT X rows and the
// RT + LT - 1 Y rows that RT rows x LT consecutive offsets touch.  After
// the window's last slab the CL lanes combine their partials once per
// output by a butterfly of shuffles (fixed order: every lane gets the
// same bits), and the lanes share the stores.  One thread writes each
// output element, with no atomics, so a result repeats bitwise.
// X is staged again for each window: holding a tile's X for all p
// (64 KB at p = 128) beside two stages of Y would leave one block per SM.
// bfloat16 stages bfloat16 and accumulates in float; float64 takes half
// the tile's columns.  Vector configurations (VW = 4) need p % 4 == 0 and
// X and Y aligned to four elements; the wrapper takes a scalar
// configuration otherwise, and narrow slabs with more rows at small p.
#include "dia_stage.cuh"

namespace {

using tsgu::plan_bytes;
using tsgu::round16;
using tsgu::STAGES;

constexpr int NT = 256;  // threads per block

// A tile of R = RG * RT rows and PT = NV * VW columns, staged with a row
// stride of S elements (one vector of padding, which spreads the rows of
// a column over the banks).  The Y window holds LT - 1 spare rows: a
// segment shorter than LT reads past the window's end, into products
// that are never stored.
template <typename T, int VW, int PT, int RG, int RT, int LT>
struct Tile {
  static constexpr int R = RG * RT, NV = PT / VW;
  static constexpr int S = PT == 1 ? 1 : PT + VW;
  __host__ __device__ static int64_t y_bytes(int64_t span) {
    return round16((R + span + LT - 1) * S * (int64_t)sizeof(T));
  }
  __host__ __device__ static int64_t x_bytes() {
    return round16((int64_t)R * S * sizeof(T));
  }
};

// wplan (int64, from kernels/dia.py window_plan with runs cut at LT): W
// rows of (k_first, count, off_lo, off_hi), W + 1 run starts, and NR runs
// as (k - k_first, off_k - off_lo, length), window by window; at most
// NT / RG runs a window.  span_max sizes the stages.
template <typename T, int VW, int PT, int RG, int RT, int LT>
__global__ void __launch_bounds__(NT)
dia_sddmm_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                 const int64_t* __restrict__ wplan, T* __restrict__ out,
                 int64_t n, int64_t m, int K, int64_t p, int W, int NR,
                 int span_max) {
  using A = typename tsgu::Acc<T>::type;
  using Tl = Tile<T, VW, PT, RG, RT, LT>;
  constexpr int R = Tl::R, NV = Tl::NV, S = Tl::S, YR = RT + LT - 1;
  constexpr int RSTEP = NT / NV;              // rows a staging pass covers
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  // the plan as int: s_win[4 w ..] = (k_first, count, off_lo, span),
  // s_first[w] the first run of window w, s_run[3 r ..] run r
  int* const s_win = reinterpret_cast<int*>(smem);
  int* const s_first = s_win + 4 * W;
  int* const s_run = s_first + W + 1;
  tsgu::load_plan(wplan, W, NR, s_win, tid, NT);
  const int y_elems = (int)(Tl::y_bytes(span_max) / sizeof(T));
  const int stage_elems = y_elems + (int)(Tl::x_bytes() / sizeof(T));
  T* const stages = reinterpret_cast<T*>(smem + plan_bytes(W, NR));
  // one slab also at p = 0, whose jobs store zeros
  const int slabs = p > PT ? (int)((p + PT - 1) / PT) : 1;
  const int per_tile = W * slabs;
  const int tiles = (int)((n + R - 1) / R);
  const int jobs = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x * per_tile;
  __syncthreads();                                    // the plan

  struct Job {
    int64_t r0;
    int w, s;
  };
  auto job = [&](int j) {
    const int q = j / per_tile, e = j - q * per_tile, w = e / slabs;
    return Job{(int64_t)((int)blockIdx.x + q * (int)gridDim.x) * R, w,
               e - w * slabs};
  };
  // whether window w has a Y row in [0, m) for rows from r0 (else its
  // outputs are 0)
  auto live = [&](int64_t r0, int w) {
    const int64_t b0 = r0 + s_win[4 * w + 2];
    return b0 < m && b0 + R + s_win[4 * w + 3] > 0;
  };

  // stage job j (an empty group past the last job)
  auto prefetch = [&](int j) {
    const Job jb = job(j);
    if (j < jobs && live(jb.r0, jb.w)) {
      T* Ys = stages + (j % STAGES) * stage_elems;
      T* Xs = Ys + y_elems;
      const int* wn = s_win + 4 * jb.w;
      const int rows = R + wn[3];
      const int64_t b0 = jb.r0 + wn[2];
      // each thread copies column vector c of rows r1, r1 + RSTEP, ...
      const int c = tid % NV, r1 = tid / NV;
      const int64_t gc = (int64_t)jb.s * PT + (int64_t)c * VW;
      const int y_lo = b0 < 0 ? (int)-b0 : 0;
      const int y_hi = gc < p ? (int)(m - b0 < rows ? m - b0 : rows) : 0;
      const T* src = Y + (b0 + r1) * p + gc;
      T* dst = Ys + r1 * S + c * VW;
      for (int row = r1; row < rows; row += RSTEP) {
        const bool ok = row >= y_lo && row < y_hi;
        tsgu::stage<T, VW>(dst, ok ? src : Y, ok);
        src += (int64_t)RSTEP * p;
        dst += RSTEP * S;
      }
      const int x_hi = gc < p ? (int)(n - jb.r0 < R ? n - jb.r0 : R) : 0;
      src = X + (jb.r0 + r1) * p + gc;
      dst = Xs + r1 * S + c * VW;
      for (int row = r1; row < R; row += RSTEP) {
        const bool ok = row < x_hi;
        tsgu::stage<T, VW>(dst, ok ? src : X, ok);
        src += (int64_t)RSTEP * p;
        dst += RSTEP * S;
      }
    }
    tsgu::cp_async_commit();
  };

  A acc[RT][LT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int t = 0; t < LT; ++t) acc[i][t] = A(0);

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) prefetch(j);
  for (int j = 0; j < jobs; ++j) {
    tsgu::cp_async_wait<STAGES - 2>();                // job j is in
    // every thread is past job j - 1: its stage takes job j + STAGES - 1
    __syncthreads();
    prefetch(j + STAGES - 1);
    const Job jb = job(j);
    // this window's items: (row group, run), CL lanes each
    const int first = s_first[jb.w], runs = s_first[jb.w + 1] - first;
    const int items = RG * runs;
    int cl = 1;
    while (cl < NV && 2 * cl * items <= NT) cl *= 2;
    const int item = tid / cl, lane = tid & (cl - 1);
    const bool mine = item < items;
    const int rg = mine ? item / runs : 0;
    const int* rn = s_run + 3 * (first + (mine ? item - rg * runs : 0));
    if (mine && live(jb.r0, jb.w)) {
      const T* Ys = stages + (j % STAGES) * stage_elems;
      const T* xp = Ys + y_elems + rg * RT * S + lane * VW;
      const T* yp = Ys + (rg * RT + rn[1]) * S + lane * VW;
      for (int v = lane; v < NV; v += cl) {
        A x[RT][VW], y[YR][VW];
#pragma unroll
        for (int i = 0; i < RT; ++i) tsgu::load_vec<VW>(xp + i * S, x[i]);
#pragma unroll
        for (int i = 0; i < YR; ++i) tsgu::load_vec<VW>(yp + i * S, y[i]);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int t = 0; t < LT; ++t)
#pragma unroll
            for (int e = 0; e < VW; ++e)
              acc[i][t] = tsgu::fma_acc(x[i][e], y[i + t][e], acc[i][t]);
        xp += cl * VW;
        yp += cl * VW;
      }
    }
    if (jb.s == slabs - 1) {                  // the window is done
      // every thread of the block takes part: cl is the block's
      for (int o = cl >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int t = 0; t < LT; ++t)
            acc[i][t] += __shfl_xor_sync(0xffffffffu, acc[i][t], o);
      if (mine) {
        T* o0 = out + (jb.r0 + rg * RT) * K + s_win[4 * jb.w] + rn[0];
        const int L = rn[2];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int t = 0; t < LT; ++t)
            if (t < L && ((i * LT + t) & (cl - 1)) == lane &&
                jb.r0 + rg * RT + i < n)
              tsgu::store_acc(o0 + (int64_t)i * K + t, acc[i][t]);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int t = 0; t < LT; ++t) acc[i][t] = A(0);
    }
  }
}

template <typename T, int VW, int PT, int RG, int RT, int LT>
int launch(const void* X, const void* Y, const void* wplan, void* out,
           int64_t n, int64_t m, int64_t K, int64_t p, int64_t W, int64_t NR,
           int64_t span_max, void* stream) {
  using Tl = Tile<T, VW, PT, RG, RT, LT>;
  const int64_t smem = plan_bytes(W, NR) +
                       STAGES * (Tl::y_bytes(span_max) + Tl::x_bytes());
  int64_t fit = 0;
  static tsgu::Fit cache;
  auto kernel = dia_sddmm_kernel<T, VW, PT, RG, RT, LT>;
  const int rc = tsgu::resident_blocks(kernel, cache, NT, smem, &fit);
  if (rc != 0) return rc;
  // jobs are counted in int inside the kernel
  const int64_t tiles = (n + Tl::R - 1) / Tl::R;
  const int64_t slabs = p > PT ? (p + PT - 1) / PT : 1;
  if (tiles * W * slabs > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int64_t blocks = tiles < fit ? tiles : fit;
  kernel<<<(unsigned)blocks, NT, (size_t)smem, (cudaStream_t)stream>>>(
      (const T*)X, (const T*)Y, (const int64_t*)wplan, (T*)out, n, m, (int)K,
      p, (int)W, (int)NR, (int)span_max);
  return (int)cudaGetLastError();
}

}  // namespace

// One C entry per storage type and tile configuration; kernels/dia.py
// (SDDMM_TILES) holds the same (VW, PT, RG, RT, LT) and picks one.
#define TSGU_DIA_SDDMM(SUF, T, CFG, VW, PT, RG, RT, LT)                      \
  extern "C" int tsgu_dia_sddmm_##SUF##_##CFG(                               \
      const void* X, const void* Y, const void* wplan, void* out, int64_t n, \
      int64_t m, int64_t K, int64_t p, int64_t W, int64_t NR,                \
      int64_t span_max, void* stream) {                                      \
    return launch<T, VW, PT, RG, RT, LT>(X, Y, wplan, out, n, m, K, p, W,   \
                                         NR, span_max, stream);              \
  }

// v32: vectors of 4, 32 columns, 128 rows (float, bfloat16 at p >= 32)
TSGU_DIA_SDDMM(f32, float, v32, 4, 32, 32, 4, 4)
TSGU_DIA_SDDMM(bf16, __nv_bfloat16, v32, 4, 32, 32, 4, 4)
// v16: vectors of 4, 16 columns, 128 rows (float64; 4 <= p < 32)
TSGU_DIA_SDDMM(f32, float, v16, 4, 16, 32, 4, 4)
TSGU_DIA_SDDMM(bf16, __nv_bfloat16, v16, 4, 16, 32, 4, 4)
TSGU_DIA_SDDMM(f64, double, v16, 4, 16, 32, 4, 4)
// s32, s4, s1: scalar columns (p % 4 != 0 or X or Y unaligned), 32
// columns over 128 rows, and 4 and 1 over 256
TSGU_DIA_SDDMM(f32, float, s32, 1, 32, 32, 4, 4)
TSGU_DIA_SDDMM(bf16, __nv_bfloat16, s32, 1, 32, 32, 4, 4)
TSGU_DIA_SDDMM(f64, double, s32, 1, 32, 32, 4, 4)
TSGU_DIA_SDDMM(f32, float, s4, 1, 4, 64, 4, 4)
TSGU_DIA_SDDMM(bf16, __nv_bfloat16, s4, 1, 4, 64, 4, 4)
TSGU_DIA_SDDMM(f64, double, s4, 1, 4, 64, 4, 4)
TSGU_DIA_SDDMM(f32, float, s1, 1, 1, 64, 4, 4)
TSGU_DIA_SDDMM(bf16, __nv_bfloat16, s1, 1, 1, 64, 4, 4)
TSGU_DIA_SDDMM(f64, double, s1, 1, 1, 64, 4, 4)
