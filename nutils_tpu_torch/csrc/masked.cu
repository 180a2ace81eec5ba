// K14: the two passes of the masked operator m * A(m * x) + (1 - m) * x,
// float32 or float64, m the free-dof mask (1 free, 0 fixed) stored in the
// operand's dtype:
//   mask_pre:  xm = m * x;
//   mask_post: y = m * yi + (1 - m) * x, yi = A xm (may be y itself).
//
// Replaces the 'masked' operator kind of nutils_tpu/ops/sparse.py
// _make_matvec (the masked-solve constraint handling that keeps the
// operator's form), around whichever matvec (K1, K5, K9) the operator has.
// Each value is rounded as the expression's plain version rounds it (the
// products by 0 and 1 are exact, so any order gives the same value).
//
// Bound: device memory.  mask_pre reads m and x and writes xm (3 values an
// entry), mask_post reads m, yi and x and writes y (4 values): 25.0 MB and
// 33.3 MB in float64 at n = 1,039,682.  Design: one thread per entry,
// neighbouring threads on neighbouring addresses.  Inside the CG loop's
// chunk graphs both read the loop's active flag first and do nothing once
// the loop has stopped (null: always run).
#include <cuda_runtime.h>
#include <stdint.h>

namespace ntt_mask {

constexpr int THREADS = 256;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
__global__ void mask_pre(const T* __restrict__ m, const T* __restrict__ x, T* __restrict__ xm, int n,
                         const int* active) {
  if (active && *active == 0) return;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n) xm[i] = mul_rn(m[i], x[i]);
}

// yi and y may be one buffer: each thread reads its entry before writing it
template <typename T>
__global__ void mask_post(const T* __restrict__ m, const T* yi, const T* __restrict__ x, T* y, int n,
                          const int* active) {
  if (active && *active == 0) return;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const T mi = m[i];
  y[i] = add_rn(mul_rn(mi, yi[i]), mul_rn(sub_rn(T(1), mi), x[i]));
}

inline unsigned int blocks(int n) { return (unsigned int)((n + THREADS - 1) / THREADS); }

}  // namespace ntt_mask

extern "C" {

// dtype: 0 float32, 1 float64; active: the CG loop's flag, or null.
// Returns cudaGetLastError().
int ntt_mask_pre(int dtype, const void* m, const void* x, void* xm, const int* active, int n, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    ntt_mask::mask_pre<float><<<ntt_mask::blocks(n), ntt_mask::THREADS, 0, s>>>(
        (const float*)m, (const float*)x, (float*)xm, n, active);
  else
    ntt_mask::mask_pre<double><<<ntt_mask::blocks(n), ntt_mask::THREADS, 0, s>>>(
        (const double*)m, (const double*)x, (double*)xm, n, active);
  return (int)cudaGetLastError();
}

int ntt_mask_post(int dtype, const void* m, const void* yi, const void* x, void* y, const int* active, int n,
                  void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    ntt_mask::mask_post<float><<<ntt_mask::blocks(n), ntt_mask::THREADS, 0, s>>>(
        (const float*)m, (const float*)yi, (const float*)x, (float*)y, n, active);
  else
    ntt_mask::mask_post<double><<<ntt_mask::blocks(n), ntt_mask::THREADS, 0, s>>>(
        (const double*)m, (const double*)yi, (const double*)x, (double*)y, n, active);
  return (int)cudaGetLastError();
}

}  // extern "C"
