// Lane layout of the chunk kernels that gather rows of a dense operand
// one column slab at a time: the SpMM K6 and K13 (chunk_spmm.cu), the
// SDDMM K7 (chunk_sddmm.cu) and the fused backward K12
// (chunk_bwd_fused.cu, over the transpose plan's columns).
//
// A warp works on one row of the pattern and one slab of the gathered
// operand's columns.  G = 2^lg lanes share an entry, each holding W
// consecutive columns of its row (a Piece: 16 bytes with VEC, else one
// element), so a slab is G W columns and the warp's E = 32 / G lane
// groups take E entries a round.  The host picks lg
// (kernels/chunk_spmm.py, spmm_lanes and sddmm_passes).
#pragma once

#include <type_traits>

#include "tsgu_common.cuh"

namespace tsgu {

constexpr unsigned FULL = 0xffffffffu;

// What one lane reads of a row per entry: 16 bytes (VEC) or one element
// (scalar), and the accumulation type's W values it holds.
template <typename T, bool VEC> struct Piece {
  using A = typename Acc<T>::type;
  static constexpr int W = 1;
  using Raw = T;
  __device__ static Raw zero() { return Raw(); }
  __device__ static Raw load(const T* p) { return __ldg(p); }
  // streaming: read once, evicted from L2 first
  __device__ static Raw load_cs(const T* p) { return __ldcs(p); }
  __device__ static void unpack(Raw q, A (&v)[W]) { v[0] = load_acc(&q); }
  __device__ static void store(T* p, const A (&v)[W]) {
    store_acc(p, v[0]);
  }
};

template <typename T> struct Piece<T, true> {
  using A = typename Acc<T>::type;
  static constexpr int W = 16 / (int)sizeof(T);
  using Raw = uint4;
  __device__ static Raw zero() { return make_uint4(0, 0, 0, 0); }
  __device__ static Raw load(const T* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static Raw load_cs(const T* p) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void unpack(Raw q, A (&v)[W]) {
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same<T, double>::value) {
      v[0] = __hiloint2double((int)w[1], (int)w[0]);
      v[1] = __hiloint2double((int)w[3], (int)w[2]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        __nv_bfloat162 h;
        memcpy(&h, &w[i], 4);
        const float2 f = __bfloat1622float2(h);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    }
  }
  __device__ static void store(T* p, const A (&v)[W]) {
    uint4 q;
    if constexpr (std::is_same<T, float>::value) {
      q = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                     __float_as_uint(v[2]), __float_as_uint(v[3]));
    } else if constexpr (std::is_same<T, double>::value) {
      q = make_uint4((unsigned)__double2loint(v[0]),
                     (unsigned)__double2hiint(v[0]),
                     (unsigned)__double2loint(v[1]),
                     (unsigned)__double2hiint(v[1]));
    } else {
      unsigned w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i],
                                                       v[2 * i + 1]);
        memcpy(&w[i], &h, 4);
      }
      q = make_uint4(w[0], w[1], w[2], w[3]);
    }
    __stcs(reinterpret_cast<uint4*>(p), q);
  }
};

// The lane's first column in slab s: 2^lg lanes of W columns a slab.
template <typename T, bool VEC>
__device__ __forceinline__ int64_t slab_col(int64_t s, int lg, int lane) {
  return ((s << lg) + (lane & ((1 << lg) - 1))) * Piece<T, VEC>::W;
}

// log2 of a power of two.
__host__ __device__ constexpr int log2_of(int u) {
  return u <= 1 ? 0 : 1 + log2_of(u / 2);
}

// The lane's share of one entry's dot over one slab, from its W values
// of the row operand (x) and the Piece it loaded of the gathered row
// (raw, zero where the lane holds no column): the W products summed by
// FMA in column order from 0.
template <typename T, bool VEC>
__device__ __forceinline__ typename Acc<T>::type lane_dot(
    const typename Acc<T>::type (&x)[Piece<T, VEC>::W],
    typename Piece<T, VEC>::Raw raw) {
  using A = typename Acc<T>::type;
  constexpr int W = Piece<T, VEC>::W;
  A y[W];
  Piece<T, VEC>::unpack(raw, y);
  A s = A(0);
#pragma unroll
  for (int w = 0; w < W; ++w) s = fma_acc(x[w], y[w], s);
  return s;
}

// Sums each of the lane's U values (one a round) over the G = 2^lg lanes
// of its group, by a transposed butterfly: at each of the first h =
// min(log2 U, lg) steps (o = G / 2, G / 4, ...) a lane keeps half of its
// values, the upper half where lane & o, and adds its partner's copy of
// them; the steps left (o down to 1) add the one value left.  Each step
// is fixed, so every lane that holds a sum holds the same bits.  After
// it the lane holds U >> h sums, v[i] that of round b (U >> h) + i, b the
// lane's bits lg - h .. lg - 1.  It takes U - (U >> h) + lg - h
// shuffles, not U lg.  An entry's sum depends only on its own lanes'
// values and lg, not on its slot or round.  K7 and K12 both sum each
// slab's share of an SDDMM entry with lane_dot's arithmetic and this, and
// add the shares in slab order, slab 0 first, which is why their gradA
// are bitwise equal, though K12 meets the entries in column order.  Every
// lane of the warp calls it together.
template <int U, typename A>
__device__ __forceinline__ void group_sums(A (&v)[U], int lg, int lane) {
  constexpr int LU = log2_of(U);
#pragma unroll
  for (int j = 0; j < LU; ++j) {
    if (j < lg) {
      const int o = 1 << (lg - 1 - j);
      const bool up = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < (U >> (j + 1)); ++i) {
        const A send = up ? v[i] : v[i + (U >> (j + 1))];
        const A keep = up ? v[i + (U >> (j + 1))] : v[i];
        v[i] = keep + __shfl_xor_sync(FULL, send, o);
      }
    }
  }
  for (int o = (1 << lg) >> (LU + 1); o > 0; o >>= 1) {
    v[0] += __shfl_xor_sync(FULL, v[0], o);
  }
}

// After group_sums of U rounds at slot k (round u's lane group g summing
// slot k + u E + g, E = 32 >> lg), hands each sum to the lane of its
// slot: lane L in [k, k + U E) sets mine to slot L's sum, other lanes
// keep theirs.  Only moves values, U >> h shuffles, so that a warp stores
// 32 consecutive entries at once.
template <int U, typename A>
__device__ __forceinline__ void sums_to_slot_lanes(const A (&v)[U], int k,
                                                   int lg, int lane,
                                                   A& mine) {
  constexpr int LU = log2_of(U);
  const int h = lg < LU ? lg : LU;
  const int rel = lane - k;
  const int u = rel >> (5 - lg);            // the slot's round
  const int b = (u >> (LU - h)) & ((1 << h) - 1);
  const int src = ((rel & ((32 >> lg) - 1)) << lg) | (b << (lg - h));
  const bool here = rel >= 0 && u < U;
#pragma unroll
  for (int i = 0; i < U; ++i) {
    if (i < (U >> h)) {
      const A t = __shfl_sync(FULL, v[i], src);
      if (here && (u & ((U >> h) - 1)) == i) mine = t;
    }
  }
}

}  // namespace tsgu
