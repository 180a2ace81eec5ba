// Row-major grid geometry shared by the stencil (K1) and multigrid (K2, K3)
// kernels: up to four axes, per-axis stencil half-width k and a periodic
// flag.  Axis 0 is the outermost (largest pitch), as in the JAX package's
// StencilForm (nutils_tpu/ops/stencil.py).  Grid indices are 32-bit (the
// wrappers refuse grids of 2^31 points or more); per-axis loops run over
// the fixed MAXD so that coordinate arrays stay in registers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ntt {

constexpr int MAXD = 4;
constexpr int BLOCK = 256;

struct Grid {
  int ndim;
  int W;  // window slots, prod(2 k_a + 1)
  int n;  // points, prod(shape)
  int shape[MAXD];
  int pitch[MAXD];
  int ks[MAXD];
  int per[MAXD];
};

inline Grid make_grid(int ndim, const int64_t* shape, const int* ks, const int* per) {
  Grid g;
  g.ndim = ndim;
  int64_t n = 1;
  g.W = 1;
  for (int a = MAXD - 1; a >= 0; --a) {
    bool on = a < ndim;
    g.shape[a] = on ? (int)shape[a] : 1;
    g.pitch[a] = (int)n;
    n *= g.shape[a];
    g.ks[a] = on && ks ? ks[a] : 0;
    g.per[a] = on && per ? per[a] : 0;
    g.W *= 2 * g.ks[a] + 1;
  }
  g.n = (int)n;
  return g;
}

// The CG loop's active flag (null: the caller is not a predicated loop).
__device__ __forceinline__ bool stopped(const int* active) { return active && *active == 0; }

inline unsigned int nblocks(int n) { return (unsigned int)((n + BLOCK - 1) / BLOCK); }

__device__ __forceinline__ void coords_of(const Grid& g, int i, int (&c)[MAXD]) {
#pragma unroll
  for (int a = 0; a < MAXD; ++a) {
    c[a] = i / g.pitch[a];
    i -= c[a] * g.pitch[a];
  }
}

// a * b + c rounded once, written out so that the compiler contracts no
// sum differently in one kernel than in another (K2's single and fused
// sweeps must give the same bits)
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// (A x)[i] = sum_s w[s, i] * x[i + a_s], slots in row-major window order
// (last axis fastest), zero outside non-periodic axes, wrapped on periodic
// ones.  Accumulates in slot order from zero, one fma a slot, as the plain
// version does (its products and sums rounded apart).
template <typename T>
__device__ __forceinline__ T stencil_row(const Grid& g, const T* __restrict__ w,
                                         const T* __restrict__ x, int i) {
  int c[MAXD];
  coords_of(g, i, c);
  int digit[MAXD] = {0, 0, 0, 0};
  T acc = T(0);
  for (int s = 0; s < g.W; ++s) {
    int j = 0;
    bool inside = true;
#pragma unroll
    for (int a = 0; a < MAXD; ++a) {
      int q = c[a] + digit[a] - g.ks[a];
      if (q < 0 || q >= g.shape[a]) {
        if (g.per[a])
          q += q < 0 ? g.shape[a] : -g.shape[a];
        else
          inside = false;
      }
      j += q * g.pitch[a];
    }
    if (inside) acc = fma_rn(w[(int64_t)s * g.n + i], x[j], acc);
    bool carry = true;  // next slot: mixed-radix increment, last axis fastest
#pragma unroll
    for (int a = MAXD - 1; a >= 0; --a) {
      if (carry) {
        if (digit[a] < 2 * g.ks[a]) {
          ++digit[a];
          carry = false;
        } else {
          digit[a] = 0;
        }
      }
    }
  }
  return acc;
}

// ------------------------------------------------------------ row tiles
//
// K1's tiled form and K2's component form take grids (n0, n1, V): axes 0
// and 1 of half-width 1, periodic or not, beside a trailing axis of V = 1-3
// components that is not periodic (C = 3 slots along it, 27 in all), or a
// 2-D grid (V = 1, C = 1: 9 slots).  A block owns a tile of T0 x T1 points
// with all V values of each, and stages an array of the grid on the tile
// grown by a halo of H points on axes 0 and 1 only: the component axis has
// no points outside, since a component's neighbours lie at its own point.
// Staged values are row-major (l0, l1, c), so that a staged row is one
// contiguous run of (T1 + 2 H) V values, on the grid as in shared memory,
// and neighbouring threads take neighbouring values: a warp's loads are
// coalesced runs of 32 values.

constexpr int TILE_THREADS = 256;

// the grid as rows of points of V values
struct Rows {
  int n0, n1;      // points along axes 0 and 1
  int per0, per1;  // periodic flags of axes 0 and 1
  int npts;        // values, n0 n1 V
};

template <typename T_, int V_, int C_, int T0_, int T1_, int H_>
struct RowTile {
  using T = T_;
  static constexpr int V = V_, C = C_, T0 = T0_, T1 = T1_, H = H_;
  static constexpr int W = 9 * C;                            // slots
  static constexpr int R0 = T0 + 2 * H, R1 = T1 + 2 * H;     // staged points along axes 0 and 1
  static constexpr int RS = R0 * R1 * V;                     // staged values
};

// a grid index along an axis of n points from the offset q, wrapped where
// the axis is periodic; -1 off a non-periodic axis
__device__ __forceinline__ int axis_index(int q, int n, int per) {
  if (q >= 0 && q < n) return q;
  if (!per) return -1;
  q %= n;
  return q < 0 ? q + n : q;
}

// the grid index of the staged value (l0, l1, c) of the tile at (o0, o1);
// -1 off a non-periodic axis
template <class G>
__device__ __forceinline__ int row_global(const Rows& g, int o0, int o1, int l0, int l1, int c) {
  const int q0 = axis_index(o0 + l0 - G::H, g.n0, g.per0), q1 = axis_index(o1 + l1 - G::H, g.n1, g.per1);
  return q0 < 0 || q1 < 0 ? -1 : (q0 * g.n1 + q1) * G::V + c;
}

// f(l0, l1, c, i) over the tile grown by h <= H: staged coordinates and the
// value's index i into the staged arrays, thread p on the p-th value in
// row-major order; unrolled, so that the loads of a thread's values are
// issued together
template <class G, int h, typename F>
__device__ __forceinline__ void for_rows(F f) {
  constexpr int EQ = (G::T1 + 2 * h) * G::V, N = (G::T0 + 2 * h) * EQ;
#pragma unroll
  for (int k = 0; k < (N + TILE_THREADS - 1) / TILE_THREADS; ++k) {
    const int p = threadIdx.x + k * TILE_THREADS;
    if (p < N) {
      const int m0 = p / EQ, q = p - m0 * EQ, l0 = m0 + G::H - h;
      f(l0, q / G::V + G::H - h, q % G::V, (l0 * G::R1 + G::H - h) * G::V + q);
    }
  }
}

// (A x) at the staged value i, component c, from the staged x, each slot's
// weight wt(s): the slots in stencil_row's order (d2 fastest), one fma
// each.  A neighbour off the grid, staged as 0 or off the component axis,
// adds w * 0 (+-0) to a sum that starts at +0 and so is never -0 (a sum is
// -0 only where both terms are): the bits of stencil_row, which skips it.
template <class G, typename Wt>
__device__ __forceinline__ typename G::T row_sum(Wt wt, const typename G::T* xs, int i, int c) {
  using T = typename G::T;
  T acc = T(0);
#pragma unroll
  for (int s = 0; s < G::W; ++s) {
    const int d0 = s / (3 * G::C) - 1, d1 = s / G::C % 3 - 1, d2 = s % G::C - G::C / 2;
    const bool off = (d2 < 0 && c == 0) || (d2 > 0 && c == G::V - 1);
    acc = fma_rn(wt(s), off ? T(0) : xs[i + (d0 * G::R1 + d1) * G::V + d2], acc);
  }
  return acc;
}

}  // namespace ntt
