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

}  // namespace ntt
