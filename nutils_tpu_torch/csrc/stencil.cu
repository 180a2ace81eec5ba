// K1: grid-stencil matvec y = A x.
//
// Replaces the device work of nutils_tpu/ops/stencil.py _matvec_fn (the
// function that the deleted Pallas stencil kernel computed): y[i] =
// sum_s w[s, i] x[i + a_s] on a row-major grid of up to four axes, per-axis
// half-width k <= 3, zero or periodic boundary per axis.
//
// Bound: device memory.  Each output dof reads its W weights, one x value
// (its neighbours are mostly L2 hits) and writes one y: (W + 2) values a
// dof, about 46 MB per float32 matvec at 1025^2 dofs and W = 9.  Design:
// one thread per output dof over the flat grid; w is slot-major
// [W, *shape], so for each slot neighbouring threads read neighbouring
// addresses, and every byte of w is read once.  Inside the CG loop's
// chunk graphs it reads the loop's active flag first and does nothing once
// the loop has stopped (null: always runs).
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

}  // extern "C"
