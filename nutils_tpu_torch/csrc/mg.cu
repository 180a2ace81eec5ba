// K2 (weighted-Jacobi sweep and residual) and K3 (full-weighting
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
// axes in one pass, one thread per output point, instead of one pass per
// axis.  Inside the CG loop's chunk graphs each kernel reads the loop's
// active flag first and does nothing once the loop has stopped (null:
// always runs), so an iteration after the loop's exit costs empty launches,
// not a V-cycle.
#include "grid.cuh"

namespace ntt {

// mode 0: out = omega dinv r            (first sweep from x = 0)
// mode 1: out = x + omega dinv (r - A x)
// mode 2: out = r - A x                  (residual for restriction)
template <typename T>
__global__ void jacobi_kernel(Grid g, const T* __restrict__ w, const T* __restrict__ dinv,
                              const T* __restrict__ r, const T* __restrict__ x,
                              T* __restrict__ out, T omega, int mode, const int* active) {
  if (stopped(active)) return;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.n) return;
  if (mode == 0) {
    out[i] = omega * dinv[i] * r[i];
    return;
  }
  T res = r[i] - stencil_row(g, w, x, i);
  out[i] = mode == 2 ? res : x[i] + omega * dinv[i] * res;
}

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

}  // extern "C"
