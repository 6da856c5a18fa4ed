// DIA SpMM: out[r, :] = sum_k grid[r, k] * B[r + off_k, :].
//
// Replaces two TPU kernels of the JAX package, which compute this same
// map: dia_mxu.spmm_core_mxu (pallas_call at
// torchsparsegradutils_tpu/kernels/dia_mxu.py:838) and
// dia._spmm_core_pallas (kernels/dia.py:477).  The same kernel computes
// A^T G: the caller passes the negated offsets, the column-shifted grid
// (kernels/dia.py, DiaGeometry.shift) and the transpose's window plan.
//
// Shapes: grid (n, K), B (m, p), out (n, p), all row-major and
// contiguous; the sorted offsets reach the kernel through the window
// plan.  Rows with r + off_k outside [0, m) are holes: they add nothing
// (B is staged as 0 there).
//
// What bounds it on an H100: bytes.  The least traffic is grid + B + out
// (139 MB in f32 at the cfd2 shape n = m = 123,440, K = 25, p = 128,
// 41 us at 3.35 TB/s) against 2 * nnz * p = 0.79 GFLOP, 12 us at the
// 67 TFLOP/s f32 FMA rate.  Reading B[r + off_k] from global memory for
// every (r, k), as the first version of this kernel did, moves K times B
// (1.58 GB) through L1/L2 and runs at the cache and issue rate.
//
// Design: offset windows staged in shared memory.  The host groups the
// sorted offsets into windows (kernels/dia.py, window_table): an offset
// joins the current window while its gap to the previous one is below the
// tile's row count R and the window's span stays within a cap that fits
// shared memory.  A block owns R output rows x PT columns at a time.  For
// each window (k_first, count, off_lo, off_hi) it stages B rows
// [r0 + off_lo, r0 + R + off_hi) of its columns, and the grid columns
// [k_first, k_first + count) of its rows (transposed), with cp.async;
// rows outside [0, m) and grid rows past n are zero-filled (source size
// 0, source clamped to the base).  Two stages: the next window loads
// while this one computes.  At the cfd2 stencil with R = 128 that is 3
// windows and 684 staged B rows a tile, against the 25 * 128 rows read
// before: the L2-to-shared traffic (about 340 MB a launch) and the
// output's stores now bound the kernel.
//
// Each thread keeps RT consecutive output rows x VW columns in registers.
// Inside a run of consecutive offsets (the host lists each window's runs)
// it slides its B rows through a ring of RT + 1 registers: RT + L shared
// loads for the RT * L row products of a run of L offsets, each step's
// loads issued ahead of the previous step's products.  Sums run in
// ascending k; one thread writes each output element, with no atomics,
// so a result repeats bitwise.  bfloat16 stages bfloat16 and accumulates
// in float; float64 takes half the tile's columns.  Vector configurations
// (VW = 4) need p % 4 == 0 and B aligned to four elements; the wrapper
// takes a scalar configuration otherwise, and narrow tiles with more rows
// at small p.
#include "dia_stage.cuh"

namespace {

using tsgu::plan_bytes;
using tsgu::round16;
using tsgu::STAGES;

// Bytes of one stage's B window and grid columns (one grid row more than
// a window holds: a run's last step reads the next row ahead and discards
// it).
template <typename T>
__host__ __device__ inline int64_t b_bytes(int R, int PT, int64_t span) {
  return round16((R + span) * PT * (int64_t)sizeof(T));
}
template <typename T>
__host__ __device__ inline int64_t g_bytes(int R, int64_t count) {
  return round16((count + 1) * (R + 4) * (int64_t)sizeof(T));
}

// The grid values of a thread's RT rows at one offset (stored
// transposed: consecutive rows are consecutive elements).
template <int RT, typename T, typename A>
__device__ __forceinline__ void load_g(const T* p, A (&g)[RT]) {
  if constexpr (RT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < RT; i += 4) {
      A q[4];
      tsgu::load4(p + i, q);
#pragma unroll
      for (int j = 0; j < 4; ++j) g[i + j] = q[j];
    }
  } else {
#pragma unroll
    for (int i = 0; i < RT; ++i) g[i] = tsgu::load_acc(p + i);
  }
}

// A tile: R = RG * RT rows x PT = LANES * VW columns for a block of
// NT = LANES * RG threads; thread (lane, rg) owns rows rg * RT .. + RT - 1
// of the tile and columns lane * VW .. + VW - 1.  Blocks are persistent:
// block b takes tiles b, b + gridDim.x, ..., and one pipeline of STAGES
// stages runs over its (tile, window) jobs, so the next tile's first window
// loads while this tile's last one computes.  Tiles are numbered with the
// column tiles of one row tile consecutive, which then share its grid rows
// in L2.
//
// wplan (int64, from kernels/dia.py window_plan): W rows of (k_first,
// count, off_lo, off_hi), W + 1 run starts, and NR runs of consecutive
// offsets as (k - k_first, off_k - off_lo, length), window by window.
// span_max and count_max size the stages.
template <typename T, int VW, int LANES, int RG, int RT>
__global__ void __launch_bounds__(LANES * RG)
dia_spmm_kernel(const T* __restrict__ grid, const T* __restrict__ B,
                const int64_t* __restrict__ wplan, T* __restrict__ out,
                int64_t n, int64_t m, int K, int64_t p, int W, int NR,
                int span_max, int count_max) {
  using A = typename tsgu::Acc<T>::type;
  constexpr int NT = LANES * RG, R = RG * RT, PT = LANES * VW, RP = R + 4;
  constexpr int RS = RT + 1;                          // the ring's slots
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  // the plan as int: s_win[4 w ..] = (k_first, count, off_lo, span),
  // s_first[w] the first run of window w, s_run[3 r ..] run r
  int* const s_win = reinterpret_cast<int*>(smem);
  int* const s_first = s_win + 4 * W;
  int* const s_run = s_first + W + 1;
  tsgu::load_plan(wplan, W, NR, s_win, tid, NT);
  const int b_elems = (int)(b_bytes<T>(R, PT, span_max) / sizeof(T));
  const int stage_elems = b_elems + (int)(g_bytes<T>(R, count_max) /
                                          sizeof(T));
  T* const stages = reinterpret_cast<T*>(smem + plan_bytes(W, NR));
  const int col_tiles = (int)((p + PT - 1) / PT);
  const int tiles = (int)((n + R - 1) / R) * col_tiles;
  // this block's jobs: WJ per tile (one that only stores zeros if W = 0)
  const int WJ = W > 0 ? W : 1;
  const int jobs = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x * WJ;
  __syncthreads();                                    // the plan

  struct Job {
    int64_t r0, c0;
    int w;
  };
  auto job = [&](int j) {
    const int q = j / WJ, t = (int)blockIdx.x + q * (int)gridDim.x;
    const int rt = t / col_tiles;
    return Job{(int64_t)rt * R, (int64_t)(t - rt * col_tiles) * PT,
               j - q * WJ};
  };
  // whether window w stages anything for rows from r0: some B row of it
  // lies in [0, m) (else it adds nothing)
  auto live = [&](int64_t r0, int w) {
    if (w >= W) return false;
    const int64_t b0 = r0 + s_win[4 * w + 2];
    return b0 < m && b0 + R + s_win[4 * w + 3] > 0;
  };

  // stage job j (an empty group past the last job)
  auto prefetch = [&](int j) {
    const Job jb = job(j);
    if (j < jobs && live(jb.r0, jb.w)) {
      T* Bs = stages + (j % STAGES) * stage_elems;
      T* Gs = Bs + b_elems;
      const int* wn = s_win + 4 * jb.w;
      const int kf = wn[0], cnt = wn[1], rows = R + wn[3];
      const int64_t b0 = jb.r0 + wn[2];
      // each thread copies one column vector c of rows rg0, rg0 + RG, ...
      // of the window; rows outside [0, m) and columns past p are zeros
      const int c = tid % LANES, rg0 = tid / LANES;
      const int64_t gc = jb.c0 + (int64_t)c * VW;
      const int row_lo = b0 < 0 ? (int)-b0 : 0;
      const int row_hi = gc < p ? (int)(m - b0 < rows ? m - b0 : rows) : 0;
      const T* src = B + (b0 + rg0) * p + gc;
      T* dst = Bs + rg0 * PT + c * VW;
      for (int row = rg0; row < rows; row += RG) {
        const bool ok = row >= row_lo && row < row_hi;
        tsgu::stage<T, VW>(dst, ok ? src : B, ok);
        src += (int64_t)RG * p;
        dst += RG * PT;
      }
      // grid rows in memory order (row = e / cnt, by a float reciprocal:
      // exact, since e / cnt is 0.5 / cnt off any integer)
      const float inv = 1.0f / (float)cnt;
      const T* g0 = grid + jb.r0 * K + kf;
      const int g_rows = n - jb.r0 < R ? (int)(n - jb.r0) : R;
      for (int e = tid; e < cnt * R; e += NT) {
        const int row = (int)(((float)e + 0.5f) * inv), kk = e - row * cnt;
        const bool ok = row < g_rows;
        tsgu::stage<T, 1>(Gs + kk * RP + row, ok ? g0 + row * K + kk : grid,
                          ok);
      }
    }
    tsgu::cp_async_commit();
  };

  A acc[RT][VW];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int v = 0; v < VW; ++v) acc[i][v] = A(0);

  const int lane = tid % LANES, rg = tid / LANES;
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) prefetch(j);
  for (int j = 0; j < jobs; ++j) {
    tsgu::cp_async_wait<STAGES - 2>();                // job j is in
    // every thread is past job j - 1: its stage takes job j + STAGES - 1
    __syncthreads();
    prefetch(j + STAGES - 1);
    const Job jb = job(j);
    if (live(jb.r0, jb.w)) {
      const T* Bs = stages + (j % STAGES) * stage_elems;
      const T* Gs = Bs + b_elems;
      for (int r = s_first[jb.w]; r < s_first[jb.w + 1]; ++r) {
        const int* rn = s_run + 3 * r;
        const int L = rn[2];
        const T* bp = Bs + (rg * RT + rn[1]) * PT + lane * VW;
        const T* gp = Gs + rn[0] * RP + rg * RT;
        // a ring of RS = RT + 1 B rows: at step t, row i reads slot
        // (t + i) % RS, and row t + RT (step t + 1's newest) loads into
        // the slot that row t - 1 left, with step t + 1's grid values,
        // before step t's products
        A bv[RS][VW], g[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          tsgu::load_vec<VW>(bp + i * PT, bv[i]);
        load_g<RT>(gp, g);
        for (int t0 = 0; t0 < L; t0 += RS) {
#pragma unroll
          for (int u = 0; u < RS; ++u) {
            if (t0 + u < L) {
              A gn[RT];
              tsgu::load_vec<VW>(bp + (t0 + u + RT) * PT,
                                 bv[(u + RT) % RS]);
              load_g<RT>(gp + (t0 + u + 1) * RP, gn);
#pragma unroll
              for (int i = 0; i < RT; ++i)
#pragma unroll
                for (int v = 0; v < VW; ++v)
                  acc[i][v] = tsgu::fma_acc(g[i], bv[(u + i) % RS][v],
                                            acc[i][v]);
#pragma unroll
              for (int i = 0; i < RT; ++i) g[i] = gn[i];
            }
          }
        }
      }
    }
    if (jb.w == WJ - 1) {                             // the tile is done
      const int64_t c = jb.c0 + lane * VW;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int64_t r = jb.r0 + rg * RT + i;
        if (r < n && c < p) {
          if constexpr (VW == 4) {
            tsgu::store4(out + r * p + c, acc[i]);
          } else {
            tsgu::store_acc(out + r * p + c, acc[i][0]);
          }
        }
#pragma unroll
        for (int v = 0; v < VW; ++v) acc[i][v] = A(0);
      }
    }
  }
}

template <typename T, int VW, int LANES, int RG, int RT>
int launch(const void* grid, const void* B, const void* wplan, void* out,
           int64_t n, int64_t m, int64_t K, int64_t p, int64_t W, int64_t NR,
           int64_t span_max, int64_t count_max, void* stream) {
  constexpr int NT = LANES * RG, R = RG * RT, PT = LANES * VW;
  const int64_t smem = plan_bytes(W, NR) +
                       STAGES * (b_bytes<T>(R, PT, span_max) +
                                 g_bytes<T>(R, count_max));
  int64_t fit = 0;
  static tsgu::Fit cache;
  auto kernel = dia_spmm_kernel<T, VW, LANES, RG, RT>;
  const int rc = tsgu::resident_blocks(kernel, cache, NT, smem, &fit);
  if (rc != 0) return rc;
  // tiles are counted in int inside the kernel
  const int64_t tiles = (n + R - 1) / R * ((p + PT - 1) / PT);
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int64_t blocks = tiles < fit ? tiles : fit;
  kernel<<<(unsigned)blocks, NT, (size_t)smem, (cudaStream_t)stream>>>(
      (const T*)grid, (const T*)B, (const int64_t*)wplan, (T*)out, n, m,
      (int)K, p, (int)W, (int)NR, (int)span_max, (int)count_max);
  return (int)cudaGetLastError();
}

}  // namespace

// One C entry per storage type and tile configuration; kernels/dia.py
// (SPMM_TILES) holds the same (VW, LANES, RG, RT) and picks one.
#define TSGU_DIA_SPMM(SUF, T, CFG, VW, LANES, RG, RT)                        \
  extern "C" int tsgu_dia_spmm_##SUF##_##CFG(                                \
      const void* grid, const void* B, const void* wplan, void* out,         \
      int64_t n, int64_t m, int64_t K, int64_t p, int64_t W, int64_t NR,     \
      int64_t span_max, int64_t count_max, void* stream) {                   \
    return launch<T, VW, LANES, RG, RT>(grid, B, wplan, out, n, m, K, p,     \
                                        W, NR, span_max, count_max, stream); \
  }

// v32: vectors of 4, 32 columns, 128 rows (float, bfloat16 at p >= 32)
TSGU_DIA_SPMM(f32, float, v32, 4, 8, 16, 8)
TSGU_DIA_SPMM(bf16, __nv_bfloat16, v32, 4, 8, 16, 8)
// v16: vectors of 4, 16 columns, 256 rows (float64; narrow p)
TSGU_DIA_SPMM(f32, float, v16, 4, 4, 32, 8)
TSGU_DIA_SPMM(bf16, __nv_bfloat16, v16, 4, 4, 32, 8)
TSGU_DIA_SPMM(f64, double, v16, 4, 4, 32, 8)
// s32, s4, s1: scalar columns (p % 4 != 0 or B unaligned), 32, 4 and 1
// columns over 64, 128 and 256 rows
TSGU_DIA_SPMM(f32, float, s32, 1, 32, 8, 8)
TSGU_DIA_SPMM(bf16, __nv_bfloat16, s32, 1, 32, 8, 8)
TSGU_DIA_SPMM(f64, double, s32, 1, 32, 8, 8)
TSGU_DIA_SPMM(f32, float, s4, 1, 4, 32, 4)
TSGU_DIA_SPMM(bf16, __nv_bfloat16, s4, 1, 4, 32, 4)
TSGU_DIA_SPMM(f64, double, s4, 1, 4, 32, 4)
TSGU_DIA_SPMM(f32, float, s1, 1, 1, 256, 1)
TSGU_DIA_SPMM(bf16, __nv_bfloat16, s1, 1, 1, 256, 1)
TSGU_DIA_SPMM(f64, double, s1, 1, 1, 256, 1)
