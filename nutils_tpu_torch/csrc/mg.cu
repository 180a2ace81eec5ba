// K2 (weighted-Jacobi sweeps and residual) and K3 (full-weighting
// restriction and linear prolongation) of the multigrid V-cycle.
//
// Replace the device work of nutils_tpu/ops/mg.py _vcycle_fn (a stencil
// matvec followed by elementwise updates), _restrict_1d and _interleave_1d
// (strided slices applied axis by axis).
//
// Bound: device memory, as the stencil matvec.  K2 fuses the matvec with
// the update, so a sweep reads w, x, r and dinv once and writes one value a
// dof instead of materialising A x; its first sweep (x = 0) reads no
// stencil at all.  K3 applies the tensor-product transfer of all coarsened
// axes in one pass instead of one pass per axis.  Inside the CG loop's chunk graphs each kernel reads the loop's
// active flag first and does nothing once the loop has stopped (null:
// always runs), so an iteration after the loop's exit costs empty launches,
// not a V-cycle.
//
// K2 comes in a single sweep and three fused forms, chosen by shape on
// the host (ops/mg.py fused_form).  The single sweep (jacobi_kernel) takes
// any grid of up to four axes and any half-width through the generic
// stencil_row (the degree-2 levels' k = 2).  The fused sweeps take the
// V-cycle's smoothing of a level in two launches instead of 2 nu:
// jacobi_pre is mode 0, nu - 1 mode-1 sweeps and the mode-2 residual,
// jacobi_post nu mode-1 sweeps, for grids of half-width 1 with every slot
// unrolled and no division per point:
// - the 2-D form (jacobi_fused_kernel, D = 2): the slice's and the Laplace
//   example's levels;
// - the component form (jacobi_rows_kernel, below): grids (n0, n1, V) of
//   V = 1-3 components, the last axis not periodic, the finite-strain
//   levels (721, 721, 2) down to (91, 91, 2);
// - the 3-D box (jacobi_fused_kernel, D = 3): every other 3-D grid.
// In the 2-D and box forms a block owns a tile of outputs (2-D 16 x 32 in
// float32 and 8 x 32 in float64, 3-D 4 x 4 x 32) and stages r, dinv and x
// on the tile grown by a halo of nu
// points in shared memory (periodic axes wrap, points off a non-periodic
// axis hold 0); each sweep runs on a halo one point smaller, so the halo
// points are recomputed, not exchanged between blocks.  The weights are
// not staged: each sweep reads a point's slots from device memory where it
// needs them, L1 and L2 serving the repeats (the tile's interior in the
// next sweep, the halos of neighbouring tiles), so that a 2-D block takes
// 14-16 KB of shared memory and eight fit a multiprocessor: the resident
// blocks, not the staging, hide the loads.  A launch thus reads
// w, r, dinv (and x) from device memory about once, and writes its outputs
// once: (W + 4) values a dof, against (W + 4) + (W + 3) + 3 for the single
// sweeps of jacobi_pre at nu = 2.  The grids' rows (1025, 2049 points) are
// not multiples of 16 bytes, so the loads are coalesced 4- or 8-byte ones,
// not tensor maps.
// Every form computes a point with the same jacobi_point and sums its slots
// in the same order with explicit fmas, so a fused launch gives the same
// bits as the single sweeps it replaces.
#include "grid.cuh"

namespace ntt {

// One point of a sweep, given ax = (A x)[i]:
// mode 0: omega dinv r            (first sweep from x = 0; x, ax unused)
// mode 1: x + omega dinv (r - ax)
// mode 2: r - ax                  (residual for restriction; dinv unused)
template <typename T>
__device__ __forceinline__ T jacobi_point(int mode, T omega, T dinv, T r, T x, T ax) {
  if (mode == 0) return omega * dinv * r;
  T res = r - ax;
  return mode == 2 ? res : fma_rn(omega * dinv, res, x);
}

template <typename T>
__global__ void jacobi_kernel(Grid g, const T* __restrict__ w, const T* __restrict__ dinv,
                              const T* __restrict__ r, const T* __restrict__ x,
                              T* __restrict__ out, T omega, int mode, const int* active) {
  if (stopped(active)) return;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.n) return;
  if (mode == 0) {
    out[i] = jacobi_point(0, omega, dinv[i], r[i], T(0), T(0));
    return;
  }
  out[i] = jacobi_point(mode, omega, mode == 2 ? T(0) : dinv[i], r[i], mode == 2 ? T(0) : x[i],
                        stencil_row(g, w, x, i));
}

// ------------------------------------------------------------ fused sweeps

constexpr int FTHREADS = 256;

// a block's tile of outputs, axes outermost first (a 2-D grid is the one
// plane of a 3-D grid whose outer axis has one point), and the slots.  A
// 2-D tile has 64 bytes of rows a column (16 in float32, 8 in float64): a
// larger tile recomputes less halo, a smaller one leaves more of the
// multiprocessor's memory to L1, which serves the weights' repeats.
template <typename T, int D>
struct FTile;
template <typename T>
struct FTile<T, 2> {
  static constexpr int T0 = 1, T1 = 64 / (int)sizeof(T), T2 = 32, W = 9;
};
template <typename T>
struct FTile<T, 3> {
  static constexpr int T0 = 4, T1 = 4, T2 = 32, W = 27;
};

// the grid as three axes: sizes, periodic flags, tiles along each
struct Box {
  int n[3];
  int per[3];
  int tiles[3];
  int npts;
};

// extents of the staged arrays: the tile grown by NU on every grid axis
template <typename T, int D, int NU>
struct Region {
  using Tile = FTile<T, D>;
  static constexpr int H0 = D == 3 ? NU : 0;
  static constexpr int R0 = Tile::T0 + 2 * H0, R1 = Tile::T1 + 2 * NU, R2 = Tile::T2 + 2 * NU;
  static constexpr int RS = R0 * R1 * R2;
  static constexpr size_t bytes = 4 * RS * sizeof(T) + RS * sizeof(int);
};

// index into the grid of the staged point (l0, l1, l2) of the tile at o,
// wrapped on periodic axes; -1 off a non-periodic axis
template <int D, int NU>
__device__ __forceinline__ int global_of(const Box& b, const int (&o)[3], int l0, int l1, int l2) {
  const int q[3] = {o[0] + l0 - (D == 3 ? NU : 0), o[1] + l1 - NU, o[2] + l2 - NU};
  int g = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    int qa = q[a];
    if (qa < 0 || qa >= b.n[a]) {
      if (!b.per[a]) return -1;
      qa %= b.n[a];
      if (qa < 0) qa += b.n[a];
    }
    g = g * b.n[a] + qa;
  }
  return g;
}

// f(l0, l1, l2, i) over the tile grown by h, in staged coordinates and
// their index i into the staged arrays; unrolled, so that the loads of a
// thread's points are issued together
template <typename T, int D, int NU, int h, typename F>
__device__ __forceinline__ void for_region(F f) {
  using G = Region<T, D, NU>;
  constexpr int h0 = D == 3 ? h : 0;
  constexpr int E0 = G::Tile::T0 + 2 * h0, E1 = G::Tile::T1 + 2 * h, E2 = G::Tile::T2 + 2 * h;
#pragma unroll
  for (int k = 0; k < (E0 * E1 * E2 + FTHREADS - 1) / FTHREADS; ++k) {
    const int p = threadIdx.x + k * FTHREADS;
    if (p < E0 * E1 * E2) {
      const int m0 = p / (E1 * E2), rem = p - m0 * (E1 * E2), m1 = rem / E2, m2 = rem - m1 * E2;
      const int l0 = m0 + G::H0 - h0, l1 = m1 + NU - h, l2 = m2 + NU - h;
      f(l0, l1, l2, (l0 * G::R1 + l1) * G::R2 + l2);
    }
  }
}

// (A x) at staged point i (grid index g >= 0) from the staged x: the slots
// in stencil_row's order, one fma each, the weights read from device memory
template <typename T, int D, int NU>
__device__ __forceinline__ T stencil_sum(const Box& b, const T* __restrict__ w, const T* xs, int g, int i) {
  using G = Region<T, D, NU>;
  T acc = T(0);
#pragma unroll
  for (int s = 0; s < FTile<T, D>::W; ++s) {
    const int d0 = D == 3 ? s / 9 - 1 : 0, d1 = s / 3 % 3 - 1, d2 = s % 3 - 1;
    acc = fma_rn(__ldg(w + (int64_t)s * b.npts + g), xs[i + (d0 * G::R1 + d1) * G::R2 + d2], acc);
  }
  return acc;
}

// mode-1 sweeps over the tile grown by h, h - 1, ..., last, from src into
// dst and back (0 off the grid); returns the buffer holding the last
template <typename T, int D, int NU, int h, int last>
__device__ __forceinline__ T* sweeps(const Box& b, const T* __restrict__ w, const int* sg, const T* sr, const T* sd,
                                     T* src, T* dst, T omega) {
  if constexpr (h < last) {
    return src;
  } else {
    for_region<T, D, NU, h>([&](int, int, int, int i) {
      const int g = sg[i];
      dst[i] = g < 0 ? T(0) : jacobi_point(1, omega, sd[i], sr[i], src[i], stencil_sum<T, D, NU>(b, w, src, g, i));
    });
    __syncthreads();
    return sweeps<T, D, NU, h - 1, last>(b, w, sg, sr, sd, dst, src, omega);
  }
}

// PRE: xout = x after mode 0 and NU - 1 mode-1 sweeps, res = r - A xout.
// Post (not PRE): xout = NU mode-1 sweeps from xin.  res or xin unused.
template <typename T, int D, int NU, bool PRE>
__global__ void __launch_bounds__(FTHREADS)
    jacobi_fused_kernel(Box b, const T* __restrict__ w, const T* __restrict__ dinv, const T* __restrict__ r,
                        const T* __restrict__ xin, T* __restrict__ xout, T* __restrict__ res, T omega,
                        const int* active) {
  if (stopped(active)) return;
  using G = Region<T, D, NU>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xa = (T*)smem_raw;
  T* xb = xa + G::RS;
  T* sr = xb + G::RS;
  T* sd = sr + G::RS;
  int* sg = (int*)(sd + G::RS);
  int t = blockIdx.x, o[3];
  o[2] = t % b.tiles[2] * G::Tile::T2;
  t /= b.tiles[2];
  o[1] = t % b.tiles[1] * G::Tile::T1;
  o[0] = t / b.tiles[1] * G::Tile::T0;
  // stage r, dinv and x (PRE: x0 = omega dinv r) over the halo NU; Post
  // reads r and dinv over the halo NU - 1 only
  for_region<T, D, NU, NU>([&](int l0, int l1, int l2, int i) {
    const int g = global_of<D, NU>(b, o, l0, l1, l2);
    sg[i] = g;
    if (PRE) {
      const T rv = g >= 0 ? r[g] : T(0), dv = g >= 0 ? dinv[g] : T(0);
      sr[i] = rv;
      sd[i] = dv;
      xa[i] = g >= 0 ? jacobi_point(0, omega, dv, rv, T(0), T(0)) : T(0);
    } else {
      xa[i] = g >= 0 ? xin[g] : T(0);
      const bool in1 = l1 > 0 && l1 < G::R1 - 1 && l2 > 0 && l2 < G::R2 - 1 &&
                       (D == 2 || (l0 > 0 && l0 < G::R0 - 1));
      if (in1 && g >= 0) {
        sr[i] = r[g];
        sd[i] = dinv[g];
      }
    }
  });
  __syncthreads();
  const T* xs = sweeps<T, D, NU, NU - 1, 1>(b, w, sg, sr, sd, xa, xb, omega);
  // the tile itself: the residual (PRE) or the last sweep (Post), written
  // where the tile lies on the grid
  for_region<T, D, NU, 0>([&](int l0, int l1, int l2, int i) {
    if (o[0] + l0 - G::H0 >= b.n[0] || o[1] + l1 - NU >= b.n[1] || o[2] + l2 - NU >= b.n[2]) return;
    const int g = sg[i];
    const T ax = stencil_sum<T, D, NU>(b, w, xs, g, i);
    if (PRE) {
      res[g] = jacobi_point(2, omega, T(0), sr[i], T(0), ax);
      xout[g] = xs[i];
    } else {
      xout[g] = jacobi_point(1, omega, sd[i], sr[i], xs[i], ax);
    }
  });
}

template <typename T, int D, int NU, bool PRE>
int launch_fused(Box b, const void* w, const void* dinv, const void* r, const void* xin, void* xout, void* res,
                 double omega, const int* active, cudaStream_t s) {
  using Tile = FTile<T, D>;
  b.tiles[0] = (b.n[0] + Tile::T0 - 1) / Tile::T0;
  b.tiles[1] = (b.n[1] + Tile::T1 - 1) / Tile::T1;
  b.tiles[2] = (b.n[2] + Tile::T2 - 1) / Tile::T2;
  const size_t bytes = Region<T, D, NU>::bytes;
  auto kernel = jacobi_fused_kernel<T, D, NU, PRE>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned int tiles = (unsigned int)b.tiles[0] * b.tiles[1] * b.tiles[2];
  kernel<<<tiles, FTHREADS, bytes, s>>>(b, (const T*)w, (const T*)dinv, (const T*)r, (const T*)xin, (T*)xout,
                                        (T*)res, (T)omega, active);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool PRE>
int fused_nu(int nu, const Box& b, const void* w, const void* dinv, const void* r, const void* xin, void* xout,
             void* res, double omega, const int* active, cudaStream_t s) {
  switch (nu) {
    case 1: return launch_fused<T, D, 1, PRE>(b, w, dinv, r, xin, xout, res, omega, active, s);
    case 2: return launch_fused<T, D, 2, PRE>(b, w, dinv, r, xin, xout, res, omega, active, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool PRE>
int fused(int ndim, int nu, const Box& b, const void* w, const void* dinv, const void* r, const void* xin,
          void* xout, void* res, double omega, const int* active, cudaStream_t s) {
  if (ndim == 2) return fused_nu<T, 2, PRE>(nu, b, w, dinv, r, xin, xout, res, omega, active, s);
  return fused_nu<T, 3, PRE>(nu, b, w, dinv, r, xin, xout, res, omega, active, s);
}

// ------------------------------------------------------------ component form
//
// K2's fused sweeps on a grid (n0, n1, V) of half-width 1 whose last axis
// holds V = 1-3 components and is not periodic: a vector field's levels,
// the finite-strain hierarchy's (721, 721, 2) down to (91, 91, 2).  The box
// form above tiles the component axis as a spatial one: 30 of its tile's 32
// columns lie off a 2-point axis, and a block stages 2,304 points (83 KB in
// float64) for 32 outputs.  Here a block of a 2-D launch grid owns a tile
// of T0 x 16 points over axes 0 and 1 (T0 = 16 in float32, 8 in float64)
// with all V values of each (grid.cuh's row tiles), and stages r, dinv and
// x on the tile grown by nu points on those axes alone: in float64 at
// nu = 2 and V = 2, 12 x 20 x 2 values, 17 KB, for 256 outputs.  The
// sweeps run as the box form's do (the halo recomputed, each sweep one
// point smaller), each value's slots in stencil_row's order, so the bits
// are the single sweeps'.
// The weights are 27 of the 31 values a point moves, and at nu = 2 a launch
// applies A to its tile twice (the inner sweep over the tile grown by 1,
// then the residual or the last sweep over the tile).  So a thread loads
// the weights of its own values of the tile into registers first, before
// the block stages its arrays, and keeps them for both passes: device
// memory gives each weight once, and its loads overlap the staging.  Only
// the inner sweep's ring (points of the neighbouring tiles), swept first,
// reads weights again, mostly from L2.  (Reading a value's weights from
// device memory in each pass instead, the second read left to L2 as the
// 2-D form does, on 8 x 32 tiles, took 0.20 ms a launch at (721, 721, 2)
// on the H100 against this form's 0.14, PERF.md.)

// f(c, i) over the ring of the tile grown by 1: rows H - 1 and H + T0
// whole, then the points H - 1 and H + T1 of the tile's rows
template <class G, typename F>
__device__ __forceinline__ void for_ring(F f) {
  constexpr int EQ = (G::T1 + 2) * G::V, N = 2 * EQ + 2 * G::T0 * G::V;
#pragma unroll
  for (int k = 0; k < (N + TILE_THREADS - 1) / TILE_THREADS; ++k) {
    const int p = threadIdx.x + k * TILE_THREADS;
    if (p < N) {
      int l0, l1, c;
      if (p < 2 * EQ) {
        const int q = p < EQ ? p : p - EQ;
        l0 = p < EQ ? G::H - 1 : G::H + G::T0;
        l1 = q / G::V + G::H - 1;
        c = q % G::V;
      } else {
        const int e = p - 2 * EQ;
        l0 = G::H + e / (2 * G::V);
        l1 = e % (2 * G::V) < G::V ? G::H - 1 : G::H + G::T1;
        c = e % G::V;
      }
      f(c, (l0 * G::R1 + l1) * G::V + c);
    }
  }
}

// PRE: xout = x after mode 0 and H - 1 mode-1 sweeps, res = r - A xout.
// Post (not PRE): xout = H mode-1 sweeps from xin.  H (= nu) is 1 or 2.
template <class G, bool PRE>
__global__ void __launch_bounds__(TILE_THREADS)
    jacobi_rows_kernel(Rows b, const typename G::T* __restrict__ w, const typename G::T* __restrict__ dinv,
                       const typename G::T* __restrict__ r, const typename G::T* __restrict__ xin,
                       typename G::T* __restrict__ xout, typename G::T* __restrict__ res, typename G::T omega,
                       const int* active) {
  using T = typename G::T;
  constexpr int NU = G::H, TQ = G::T1 * G::V, NI = G::T0 * TQ, P = (NI + TILE_THREADS - 1) / TILE_THREADS;
  static_assert(NU == 1 || NU == 2, "one or two sweeps a launch");
  if (stopped(active)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // sd before xa: row_sum's select may read the value before xa
  T* sr = (T*)smem_raw;
  T* sd = sr + G::RS;
  T* xa = sd + G::RS;
  T* xb = xa + G::RS;
  int* sg = (int*)(xb + G::RS);
  const int o0 = blockIdx.y * G::T0, o1 = blockIdx.x * G::T1;
  const int64_t npts = b.npts;
  // f(k, l0, l1, c, i) over the thread's values of the tile, k-th at p =
  // threadIdx.x + k TILE_THREADS (the order of for_rows<G, 0>)
  auto for_own = [&](auto f) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int p = threadIdx.x + k * TILE_THREADS;
      if (p < NI) {
        const int m0 = p / TQ, q = p - m0 * TQ;
        f(k, G::H + m0, G::H + q / G::V, q % G::V, ((G::H + m0) * G::R1 + G::H) * G::V + q);
      }
    }
  };
  // the weights of the thread's own values, loaded first
  T wr[P][G::W];
  for_own([&](int k, int l0, int l1, int c, int) {
    const int g = row_global<G>(b, o0, o1, l0, l1, c);
#pragma unroll
    for (int s = 0; s < G::W; ++s) wr[k][s] = g >= 0 ? __ldg(w + s * npts + g) : T(0);
  });
  // stage r, dinv and x (PRE: x0 = omega dinv r) over the halo NU; Post
  // reads r and dinv over the halo NU - 1 only
  for_rows<G, NU>([&](int l0, int l1, int c, int i) {
    const int g = row_global<G>(b, o0, o1, l0, l1, c);
    sg[i] = g;
    if (PRE) {
      const T rv = g >= 0 ? r[g] : T(0), dv = g >= 0 ? dinv[g] : T(0);
      sr[i] = rv;
      sd[i] = dv;
      xa[i] = g >= 0 ? jacobi_point(0, omega, dv, rv, T(0), T(0)) : T(0);
    } else {
      xa[i] = g >= 0 ? xin[g] : T(0);
      if (g >= 0 && l0 > 0 && l0 < G::R0 - 1 && l1 > 0 && l1 < G::R1 - 1) {
        sr[i] = r[g];
        sd[i] = dinv[g];
      }
    }
  });
  __syncthreads();
  if constexpr (NU == 2) {
    // the inner sweep over the tile grown by 1: the ring, then the tile
    auto sweep = [&](int c, int i, auto wt) {
      const int g = sg[i];
      xb[i] = g < 0 ? T(0) : jacobi_point(1, omega, sd[i], sr[i], xa[i], row_sum<G>(wt, xa, i, c));
    };
    for_ring<G>([&](int c, int i) {
      const int64_t g = sg[i];
      sweep(c, i, [&](int s) { return __ldg(w + s * npts + g); });
    });
    for_own([&](int k, int, int, int c, int i) { sweep(c, i, [&](int s) { return wr[k][s]; }); });
    __syncthreads();
  }
  // the tile itself: the residual (PRE) or the last sweep (Post), written
  // where the tile lies on the grid
  const T* xs = NU == 2 ? xb : xa;
  for_own([&](int k, int l0, int l1, int c, int i) {
    if (o0 + l0 - G::H >= b.n0 || o1 + l1 - G::H >= b.n1) return;
    const int g = sg[i];
    const T ax = row_sum<G>([&](int s) { return wr[k][s]; }, xs, i, c);
    if (PRE) {
      res[g] = jacobi_point(2, omega, T(0), sr[i], T(0), ax);
      xout[g] = xs[i];
    } else {
      xout[g] = jacobi_point(1, omega, sd[i], sr[i], xs[i], ax);
    }
  });
}

template <typename T, int V, int NU, bool PRE>
int launch_rows(const Rows& b, const void* w, const void* dinv, const void* r, const void* xin, void* xout, void* res,
                double omega, const int* active, cudaStream_t s) {
  using G = RowTile<T, V, 3, 64 / (int)sizeof(T), 16, NU>;
  constexpr size_t bytes = 4 * G::RS * sizeof(T) + G::RS * sizeof(int);
  auto kernel = jacobi_rows_kernel<G, PRE>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((b.n1 + G::T1 - 1) / G::T1, (b.n0 + G::T0 - 1) / G::T0);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<grid, TILE_THREADS, bytes, s>>>(b, (const T*)w, (const T*)dinv, (const T*)r, (const T*)xin, (T*)xout,
                                           (T*)res, (T)omega, active);
  return (int)cudaGetLastError();
}

template <typename T, bool PRE>
int rows(int V, int nu, const Rows& b, const void* w, const void* dinv, const void* r, const void* xin, void* xout,
         void* res, double omega, const int* active, cudaStream_t s) {
  switch (V * 2 + nu) {
    case 3: return launch_rows<T, 1, 1, PRE>(b, w, dinv, r, xin, xout, res, omega, active, s);
    case 4: return launch_rows<T, 1, 2, PRE>(b, w, dinv, r, xin, xout, res, omega, active, s);
    case 5: return launch_rows<T, 2, 1, PRE>(b, w, dinv, r, xin, xout, res, omega, active, s);
    case 6: return launch_rows<T, 2, 2, PRE>(b, w, dinv, r, xin, xout, res, omega, active, s);
    case 7: return launch_rows<T, 3, 1, PRE>(b, w, dinv, r, xin, xout, res, omega, active, s);
    case 8: return launch_rows<T, 3, 2, PRE>(b, w, dinv, r, xin, xout, res, omega, active, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------ transfers
//
// K3 comes in two forms too.  The generic one (restrict_kernel,
// prolong_add_kernel) takes any pattern of coarsened axes on grids of up to
// four axes, one thread per output point.  The tiled one (restrict_tile,
// prolong_add_tile) takes the transfers every path runs: axes 0 and 1
// coarsened (n = 2 nc - 1), and a trailing axis of V = 1, 2 or 3
// components kept (V = 1: a 2-D grid); the host picks it by shape alone
// (ops/mg.py transfer_form).  The generic kernels spend four integer
// divisions a point on its coordinates and loop over the combinations of
// offsets at run time, and the prolongation's warps diverge (an even fine
// point reads one coarse value, an odd/odd one four), so at 5-19 MB a call
// instructions, not DRAM, set their pace.  The tiled kernels launch on a
// 2-D grid of blocks with the offsets unrolled and no division by a
// run-time value:
// - restrict_tile: a block owns TY x TX coarse points (x V) and stages the
//   fine tile with its one-point halo, 2 TY + 1 rows of (2 TX + 1) V
//   values, in shared memory with coalesced loads, so DRAM reads each fine
//   value about once; each thread then computes TY / 8 rows of its V
//   outputs from shared memory.  Points off the grid are staged as -0,
//   which leaves any sum unchanged (x + -0 = x, also for x = +-0), so the
//   sums skip them as the generic kernel does.
// - prolong_add_tile: one thread per coarse value (a coarse point's
//   component) adds into its 2 x 2 fine points (fewer on the last row and
//   column); neighbouring threads share their coarse reads through L1, no
//   warp diverges but at the grid's last row and column, and a warp writes
//   two fine rows of 64 contiguous values.
// The tiled kernels sum a point's terms in the generic kernel's order,
// from zero, with its weights (1, 1/2, 1/4: each product exact), each term
// one fma written out (the contraction nvcc makes of the generic kernel's
// acc += wt * f): restrict with the offset of axis 0 fastest, then axis 1;
// prolong-add the low, then the high neighbour of axis 0, then of axis 1,
// then x[i] + acc.  The two forms give the same bits.

// rc[j] = sum over coarsened axes of f[2 j + a] weighted (1/2, 1, 1/2) for
// a = (-1, 0, 1), zero outside the fine grid (P^T of linear interpolation).
template <typename T>
__global__ void restrict_kernel(Grid fine, Grid coarse, const T* __restrict__ f,
                                T* __restrict__ rc, const int* active) {
  if (stopped(active)) return;
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= coarse.n) return;
  int c[MAXD];
  coords_of(coarse, j, c);
  int ncombo = 1;
#pragma unroll
  for (int a = 0; a < MAXD; ++a)
    if (fine.shape[a] != coarse.shape[a]) ncombo *= 3;
  T acc = T(0);
  for (int t = 0; t < ncombo; ++t) {
    int rem = t;
    int i = 0;
    T wt = T(1);
    bool inside = true;
#pragma unroll
    for (int a = 0; a < MAXD; ++a) {
      int q = c[a];
      if (fine.shape[a] != coarse.shape[a]) {
        int off = rem % 3 - 1;
        rem /= 3;
        q = 2 * c[a] + off;
        if (off) wt *= T(0.5);
        if (q < 0 || q >= fine.shape[a]) inside = false;
      }
      i += q * fine.pitch[a];
    }
    if (inside) acc += wt * f[i];
  }
  rc[j] = acc;
}

// x[i] += (P xc)[i]: linear interpolation on the coarsened axes (even fine
// index: the coarse value; odd: the mean of its two coarse neighbours).
template <typename T>
__global__ void prolong_add_kernel(Grid fine, Grid coarse, T* __restrict__ x,
                                   const T* __restrict__ xc, const int* active) {
  if (stopped(active)) return;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= fine.n) return;
  int c[MAXD];
  coords_of(fine, i, c);
  int ncombo = 1;
#pragma unroll
  for (int a = 0; a < MAXD; ++a)
    if (fine.shape[a] != coarse.shape[a] && (c[a] & 1)) ncombo *= 2;
  T acc = T(0);
  for (int t = 0; t < ncombo; ++t) {
    int rem = t;
    int j = 0;
    T wt = T(1);
    bool inside = true;
#pragma unroll
    for (int a = 0; a < MAXD; ++a) {
      int q = c[a];
      if (fine.shape[a] != coarse.shape[a]) {
        if (c[a] & 1) {
          q = (c[a] - 1) / 2 + (rem & 1);
          rem >>= 1;
          wt *= T(0.5);
        } else {
          q = c[a] / 2;
        }
        if (q >= coarse.shape[a]) inside = false;
      }
      j += q * coarse.pitch[a];
    }
    if (inside) acc += wt * xc[j];
  }
  x[i] += acc;
}

// the tiled form: coarse points a tile along axis 1 (a warp's), threads
// along axis 0 in a block, coarse rows a restrict tile (16 in float32, 8 in
// float64: 33 or 17 staged fine rows, at most 26.5 KB at V = 3)
constexpr int TX = 32;
constexpr int TROWS = 8;
template <typename T>
struct RTile {
  static constexpr int TY = 64 / (int)sizeof(T);
};

// the weight of offset o (0, 1, 2 for -1, 0, +1) on one axis
template <typename T>
__device__ __forceinline__ constexpr T wt1(int o) {
  return o == 1 ? T(1) : T(0.5);
}

// rc = full weighting of f over axes 0 and 1: f is (n0, n1, V), rc (c0, c1, V)
template <typename T, int V>
__global__ void __launch_bounds__(TX * TROWS)
    restrict_tile(int n0, int n1, int c0, int c1, const T* __restrict__ f, T* __restrict__ rc, const int* active) {
  if (stopped(active)) return;
  constexpr int TY = RTile<T>::TY, SR = 2 * TY + 1, SC = (2 * TX + 1) * V, TV = TX * V;
  __shared__ T s[SR * SC];
  const int j0 = blockIdx.y * TY, j1 = blockIdx.x * TX;
  const int f0 = 2 * j0 - 1, e0 = (2 * j1 - 1) * V, rowlen = n1 * V;
  const int tid = threadIdx.y * TX + threadIdx.x;
  // the fine tile and its halo, each staged row one contiguous run of
  // (2 TX + 1) V values on the grid
  for (int p = tid; p < SR * SC; p += TX * TROWS) {
    const int fr = f0 + p / SC, e = e0 + p % SC;
    s[p] = fr >= 0 && fr < n0 && e >= 0 && e < rowlen ? f[fr * rowlen + e] : T(-0.0);
  }
  __syncthreads();
  // outputs: TY rows of TX V values, neighbouring threads on neighbouring
  // values (q = V x + v for the coarse point j1 + x, component v)
  const int nq = min(TV, (c1 - j1) * V);
  for (int p = tid; p < TY * TV; p += TX * TROWS) {
    const int ly = p / TV, q = p % TV;
    if (j0 + ly >= c0 || q >= nq) continue;
    const int v = q % V, base = 2 * (q - v) + v;  // staged value of the fine point 2 x - 1, component v
    T acc = T(0);
#pragma unroll
    for (int o1 = 0; o1 < 3; ++o1)
#pragma unroll
      for (int o0 = 0; o0 < 3; ++o0)
        acc = fma_rn(wt1<T>(o0) * wt1<T>(o1), s[(2 * ly + o0) * SC + base + o1 * V], acc);
    rc[(j0 + ly) * c1 * V + j1 * V + q] = acc;
  }
}

// x += P xc over axes 0 and 1: x is (n0, n1, V), xc (c0, c1, V); one thread
// per coarse value (q = V j1 + v: coarse point (j0, j1), component v)
template <typename T, int V>
__global__ void __launch_bounds__(TX * TROWS)
    prolong_add_tile(int n0, int n1, int c0, int c1, T* __restrict__ x, const T* __restrict__ xc,
                     const int* active) {
  if (stopped(active)) return;
  const int j0 = blockIdx.y * TROWS + threadIdx.y, q = blockIdx.x * TX + threadIdx.x;
  if (j0 >= c0 || q >= c1 * V) return;
  const int v = q % V, j1 = q / V;
  const bool odd0 = 2 * j0 + 1 < n0, odd1 = 2 * j1 + 1 < n1;  // the fine point after it on each axis
  const T* c = xc + j0 * c1 * V + q;
  T* out = x + 2 * j0 * n1 * V + 2 * (q - v) + v;  // the fine point (2 j0, 2 j1), component v
  const int crow = c1 * V, frow = n1 * V;
  const T a00 = c[0], a01 = odd1 ? c[V] : T(0), a10 = odd0 ? c[crow] : T(0), a11 = odd0 && odd1 ? c[crow + V] : T(0);
  out[0] = out[0] + fma_rn(T(1), a00, T(0));
  if (odd1) out[V] = out[V] + fma_rn(T(0.5), a01, fma_rn(T(0.5), a00, T(0)));
  if (odd0) out[frow] = out[frow] + fma_rn(T(0.5), a10, fma_rn(T(0.5), a00, T(0)));
  if (odd0 && odd1)
    out[frow + V] = out[frow + V] +
                    fma_rn(T(0.25), a11, fma_rn(T(0.25), a01, fma_rn(T(0.25), a10, fma_rn(T(0.25), a00, T(0)))));
}

template <typename T, int V>
int launch_tile(bool restrict_, int n0, int n1, const void* in, void* out, const int* active, cudaStream_t s) {
  const int c0 = (n0 + 1) / 2, c1 = (n1 + 1) / 2;
  const dim3 threads(TX, TROWS);
  if (restrict_) {
    const dim3 grid((c1 + TX - 1) / TX, (c0 + RTile<T>::TY - 1) / RTile<T>::TY);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    restrict_tile<T, V><<<grid, threads, 0, s>>>(n0, n1, c0, c1, (const T*)in, (T*)out, active);
  } else {
    const dim3 grid((c1 * V + TX - 1) / TX, (c0 + TROWS - 1) / TROWS);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    prolong_add_tile<T, V><<<grid, threads, 0, s>>>(n0, n1, c0, c1, (T*)out, (const T*)in, active);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int tile(bool restrict_, int V, int n0, int n1, const void* in, void* out, const int* active, cudaStream_t s) {
  switch (V) {
    case 1: return launch_tile<T, 1>(restrict_, n0, n1, in, out, active, s);
    case 2: return launch_tile<T, 2>(restrict_, n0, n1, in, out, active, s);
    case 3: return launch_tile<T, 3>(restrict_, n0, n1, in, out, active, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace ntt

extern "C" {

int ntt_jacobi(int dtype, const void* w, const void* dinv, const void* r, const void* x, void* out,
               const int* active, double omega, int mode, int ndim, const int64_t* shape, const int* ks,
               const int* per, void* stream) {
  ntt::Grid g = ntt::make_grid(ndim, shape, ks, per);
  if (g.n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    ntt::jacobi_kernel<float><<<ntt::nblocks(g.n), ntt::BLOCK, 0, s>>>(
        g, (const float*)w, (const float*)dinv, (const float*)r, (const float*)x, (float*)out,
        (float)omega, mode, active);
  else
    ntt::jacobi_kernel<double><<<ntt::nblocks(g.n), ntt::BLOCK, 0, s>>>(
        g, (const double*)w, (const double*)dinv, (const double*)r, (const double*)x,
        (double*)out, omega, mode, active);
  return (int)cudaGetLastError();
}

// The fused sweeps of a level: pre (mode 0, nu - 1 sweeps, the residual
// into res) or post (nu sweeps from xin), on a grid of half-width 1 on
// every axis, nu 1 or 2, in the form `form` (else cudaErrorInvalidValue):
// 0 the 2-D form (ndim 2) or the 3-D box (ndim 3); 1 the component form
// (ndim 3, a last axis of 1-3 components, not periodic).
int ntt_jacobi_fused(int dtype, const void* w, const void* dinv, const void* r, const void* xin, void* xout,
                     void* res, const int* active, double omega, int nu, int pre, int form, int ndim,
                     const int64_t* shape, const int* ks, const int* per, void* stream) {
  if (ndim < 2 || ndim > 3 || nu < 1 || nu > 2 || form < 0 || form > 1) return (int)cudaErrorInvalidValue;
  for (int a = 0; a < ndim; ++a)
    if (ks[a] != 1) return (int)cudaErrorInvalidValue;
  if (form) {
    if (ndim != 3 || shape[2] < 1 || shape[2] > 3 || per[2]) return (int)cudaErrorInvalidValue;
    ntt::Rows b;
    b.n0 = (int)shape[0];
    b.n1 = (int)shape[1];
    b.per0 = per[0];
    b.per1 = per[1];
    b.npts = b.n0 * b.n1 * (int)shape[2];
    if (b.npts == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const int V = (int)shape[2];
    if (dtype == 0)
      return pre ? ntt::rows<float, true>(V, nu, b, w, dinv, r, xin, xout, res, omega, active, s)
                 : ntt::rows<float, false>(V, nu, b, w, dinv, r, xin, xout, res, omega, active, s);
    return pre ? ntt::rows<double, true>(V, nu, b, w, dinv, r, xin, xout, res, omega, active, s)
               : ntt::rows<double, false>(V, nu, b, w, dinv, r, xin, xout, res, omega, active, s);
  }
  ntt::Box b;
  b.npts = 1;
  for (int a = 0; a < 3; ++a) {
    const int src = a - (3 - ndim);  // a 2-D grid is axes 1 and 2
    b.n[a] = src >= 0 ? (int)shape[src] : 1;
    b.per[a] = src >= 0 ? per[src] : 0;
    b.npts *= b.n[a];
  }
  if (b.npts == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return pre ? ntt::fused<float, true>(ndim, nu, b, w, dinv, r, xin, xout, res, omega, active, s)
               : ntt::fused<float, false>(ndim, nu, b, w, dinv, r, xin, xout, res, omega, active, s);
  return pre ? ntt::fused<double, true>(ndim, nu, b, w, dinv, r, xin, xout, res, omega, active, s)
             : ntt::fused<double, false>(ndim, nu, b, w, dinv, r, xin, xout, res, omega, active, s);
}

int ntt_restrict(int dtype, const void* f, void* rc, const int* active, int ndim, const int64_t* fshape,
                 const int64_t* cshape, void* stream) {
  ntt::Grid fine = ntt::make_grid(ndim, fshape, nullptr, nullptr);
  ntt::Grid coarse = ntt::make_grid(ndim, cshape, nullptr, nullptr);
  if (coarse.n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    ntt::restrict_kernel<float><<<ntt::nblocks(coarse.n), ntt::BLOCK, 0, s>>>(
        fine, coarse, (const float*)f, (float*)rc, active);
  else
    ntt::restrict_kernel<double><<<ntt::nblocks(coarse.n), ntt::BLOCK, 0, s>>>(
        fine, coarse, (const double*)f, (double*)rc, active);
  return (int)cudaGetLastError();
}

int ntt_prolong_add(int dtype, void* x, const void* xc, const int* active, int ndim, const int64_t* fshape,
                    const int64_t* cshape, void* stream) {
  ntt::Grid fine = ntt::make_grid(ndim, fshape, nullptr, nullptr);
  ntt::Grid coarse = ntt::make_grid(ndim, cshape, nullptr, nullptr);
  if (fine.n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    ntt::prolong_add_kernel<float><<<ntt::nblocks(fine.n), ntt::BLOCK, 0, s>>>(
        fine, coarse, (float*)x, (const float*)xc, active);
  else
    ntt::prolong_add_kernel<double><<<ntt::nblocks(fine.n), ntt::BLOCK, 0, s>>>(
        fine, coarse, (double*)x, (const double*)xc, active);
  return (int)cudaGetLastError();
}

// K3's tiled form (the generic kernels' bits): restrict (f fine, out
// coarse) or prolong-add (f coarse, out the fine x, added to in place)
// between a fine grid (n0, n1, V) and the coarse (c0, c1, V), c = (n + 1) /
// 2 on axes 0 and 1, V 1-3 (else cudaErrorInvalidValue).
int ntt_transfer_tile(int dtype, const void* f, void* out, const int* active, int restrict_, int n0, int n1, int V,
                      void* stream) {
  if (n0 < 1 || n1 < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return ntt::tile<float>(restrict_, V, n0, n1, f, out, active, s);
  return ntt::tile<double>(restrict_, V, n0, n1, f, out, active, s);
}

}  // extern "C"
