// K1: grid-stencil matvec y = A x.
//
// Replaces the device work of nutils_tpu/ops/stencil.py _matvec_fn (the
// function that the deleted Pallas stencil kernel computed): y[i] =
// sum_s w[s, i] x[i + a_s] on a row-major grid of up to four axes, per-axis
// half-width k <= 3, zero or periodic boundary per axis.
//
// Bound: device memory.  Each output dof reads its W weights, one x value
// and writes one y: (W + 2) values a dof, about 46 MB per float32 matvec
// at 1025^2 dofs and W = 9.  w is slot-major [W, *shape], so for each slot
// neighbouring threads read neighbouring addresses, and every byte of w is
// read once.  Inside the CG loop's chunk graphs a launch reads the loop's
// active flag first and does nothing once the loop has stopped (null:
// always runs).
//
// K1 comes in two forms, chosen by shape on the host
// (ops/stencil.py matvec_form); both give the same bits.
// - The tiled form (stencil_tile_kernel) takes the grids of half-width 1
//   that the paths' operators have: 2-D grids (9 slots: the slice's
//   1025^2, the Laplace example's 2049^2) and grids (n0, n1, V) of V = 1-3
//   components beside axes 0 and 1 (27 slots: the finite-strain levels,
//   (721, 721, 2) down to (91, 91, 2)).  A block of a 2-D launch grid owns a
//   tile of 16 x 32 points in float32, 8 x 32 in float64, stages x on it
//   with a one-point halo in shared memory (grid.cuh's row tiles: the
//   staging K2's component form shares) and computes its outputs with every
//   slot unrolled and no division by a run-time value.
// - The generic form (stencil_matvec_kernel) takes every other grid (the
//   degree-2 levels' k = 2, the elasticity squares' ks (2, 2, 1), 4-D): one
//   thread a dof over the flat grid, four integer divisions for its
//   coordinates and the slots walked by a mixed-radix counter
//   (grid.cuh stencil_row), x's neighbours left to the caches.
// Both sum a dof's slots in slot order from zero, one fma a slot; the tiled
// form adds w * 0 where stencil_row skips a neighbour off the grid, which
// leaves the bits unchanged (grid.cuh row_sum).
#include "grid.cuh"

namespace ntt {

template <typename T>
__global__ void stencil_matvec_kernel(Grid g, const T* __restrict__ w, const T* __restrict__ x,
                                      T* __restrict__ y, const int* active) {
  if (stopped(active)) return;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.n) return;
  y[i] = stencil_row(g, w, x, i);
}

// the tiled form: a T0 x T1 tile's outputs from x staged with a halo of 1
template <class G>
__global__ void __launch_bounds__(TILE_THREADS)
    stencil_tile_kernel(Rows b, const typename G::T* __restrict__ w, const typename G::T* __restrict__ x,
                        typename G::T* __restrict__ y, const int* active) {
  using T = typename G::T;
  if (stopped(active)) return;
  // one value of guard before the staged x: row_sum's select may read
  // xs[-1] for a first component whose left neighbour is off the grid
  __shared__ T xs_[G::RS + 1];
  T* xs = xs_ + 1;
  const int o0 = blockIdx.y * G::T0, o1 = blockIdx.x * G::T1;
  for_rows<G, 1>([&](int l0, int l1, int c, int i) {
    const int g = row_global<G>(b, o0, o1, l0, l1, c);
    xs[i] = g >= 0 ? x[g] : T(0);
  });
  __syncthreads();
  for_rows<G, 0>([&](int l0, int l1, int c, int i) {
    const int q0 = o0 + l0 - G::H, q1 = o1 + l1 - G::H;
    if (q0 >= b.n0 || q1 >= b.n1) return;
    const int g = (q0 * b.n1 + q1) * G::V + c;
    y[g] = row_sum<G>([&](int s) { return __ldg(w + (int64_t)s * b.npts + g); }, xs, i, c);
  });
}

template <typename T, int V, int C>
int launch_stencil_tile(const Rows& b, const void* w, const void* x, void* y, const int* active, cudaStream_t s) {
  using G = RowTile<T, V, C, 64 / (int)sizeof(T), 32, 1>;
  const dim3 grid((b.n1 + G::T1 - 1) / G::T1, (b.n0 + G::T0 - 1) / G::T0);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  stencil_tile_kernel<G><<<grid, TILE_THREADS, 0, s>>>(b, (const T*)w, (const T*)x, (T*)y, active);
  return (int)cudaGetLastError();
}

template <typename T>
int stencil_tile(int V, int C, const Rows& b, const void* w, const void* x, void* y, const int* active, cudaStream_t s) {
  if (C == 1) return launch_stencil_tile<T, 1, 1>(b, w, x, y, active, s);
  switch (V) {
    case 1: return launch_stencil_tile<T, 1, 3>(b, w, x, y, active, s);
    case 2: return launch_stencil_tile<T, 2, 3>(b, w, x, y, active, s);
    case 3: return launch_stencil_tile<T, 3, 3>(b, w, x, y, active, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace ntt

extern "C" {

const char* ntt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// dtype: 0 float32, 1 float64; active: the CG loop's flag, or null.
// Returns cudaGetLastError() after the launch.
int ntt_stencil_matvec(int dtype, const void* w, const void* x, void* y, const int* active, int ndim,
                       const int64_t* shape, const int* ks, const int* per, void* stream) {
  ntt::Grid g = ntt::make_grid(ndim, shape, ks, per);
  if (g.n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    ntt::stencil_matvec_kernel<float><<<ntt::nblocks(g.n), ntt::BLOCK, 0, s>>>(
        g, (const float*)w, (const float*)x, (float*)y, active);
  else
    ntt::stencil_matvec_kernel<double><<<ntt::nblocks(g.n), ntt::BLOCK, 0, s>>>(
        g, (const double*)w, (const double*)x, (double*)y, active);
  return (int)cudaGetLastError();
}

// K1's tiled form: a 2-D grid of half-width 1, or a grid (n0, n1, V) of
// half-width 1 with V 1-3 and its last axis not periodic (else
// cudaErrorInvalidValue); the grid described as for ntt_stencil_matvec.
int ntt_stencil_tile(int dtype, const void* w, const void* x, void* y, const int* active, int ndim,
                     const int64_t* shape, const int* ks, const int* per, void* stream) {
  if (ndim < 2 || ndim > 3 || (ndim == 3 && (shape[2] < 1 || shape[2] > 3 || per[2])))
    return (int)cudaErrorInvalidValue;
  for (int a = 0; a < ndim; ++a)
    if (ks[a] != 1) return (int)cudaErrorInvalidValue;
  ntt::Rows b;
  b.n0 = (int)shape[0];
  b.n1 = (int)shape[1];
  b.per0 = per[0];
  b.per1 = per[1];
  const int V = ndim == 3 ? (int)shape[2] : 1;
  b.npts = b.n0 * b.n1 * V;
  if (b.npts == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return ntt::stencil_tile<float>(V, ndim == 3 ? 3 : 1, b, w, x, y, active, s);
  return ntt::stencil_tile<double>(V, ndim == 3 ? 3 : 1, b, w, x, y, active, s);
}

}  // extern "C"
