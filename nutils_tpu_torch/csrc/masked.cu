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
// 33.3 MB in float64 at n = 1,039,682, 12.5 and 16.6 MB in float32, all of
// which a CUDA graph's replays find in the 50 MB L2.  Design: each thread
// moves 16 bytes of each operand at a time (float4, double2), PER such
// vectors (1: kernel_plan_sweep.py rebuilds this source with 2 and 4 and
// times each at n = 1,039,682), loaded before any is stored; the grid
// covers the vector body once.  The host splits [0, n) into a
// scalar head (up to the first 16-byte boundary), the vector body and a
// scalar tail (ops/sparse.py mask_plan); where the operands' addresses
// differ modulo 16 bytes the whole range is the head.  The head and tail
// run in the same launch, one entry a thread.  Inside the CG loop's chunk
// graphs both passes read the loop's active flag once a thread and do
// nothing once the loop has stopped (null: always run).
#include <cuda_runtime.h>
#include <stdint.h>

namespace ntt_mask {

constexpr int THREADS = 256;
constexpr int PER = 1;  // vectors a thread (ops/sparse.py mask_plan's grid gives each thread one)

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
__device__ __forceinline__ T pre(T m, T x) {
  return mul_rn(m, x);
}
template <typename T>
__device__ __forceinline__ T post(T m, T y, T x) {
  return add_rn(mul_rn(m, y), mul_rn(sub_rn(T(1), m), x));
}
__device__ __forceinline__ float4 pre(float4 m, float4 x) {
  return make_float4(pre(m.x, x.x), pre(m.y, x.y), pre(m.z, x.z), pre(m.w, x.w));
}
__device__ __forceinline__ double2 pre(double2 m, double2 x) { return make_double2(pre(m.x, x.x), pre(m.y, x.y)); }
__device__ __forceinline__ float4 post(float4 m, float4 y, float4 x) {
  return make_float4(post(m.x, y.x, x.x), post(m.y, y.y, x.y), post(m.z, y.z, x.z), post(m.w, y.w, x.w));
}
__device__ __forceinline__ double2 post(double2 m, double2 y, double2 x) {
  return make_double2(post(m.x, y.x, x.x), post(m.y, y.y, x.y));
}

// the scalar entries: s < head at s, the tail after the body
__device__ __forceinline__ int scalar_index(int s, int head, int body) { return s < head ? s : s + body; }

template <typename T, typename V>
__global__ void __launch_bounds__(THREADS)
    mask_pre(const T* __restrict__ m, const T* __restrict__ x, T* __restrict__ xm, int head, int nvec, int n,
             const int* active) {
  if (active && *active == 0) return;
  constexpr int W = (int)(sizeof(V) / sizeof(T));  // values a vector
  const V* mv = reinterpret_cast<const V*>(m + head);
  const V* xv = reinterpret_cast<const V*>(x + head);
  V* ov = reinterpret_cast<V*>(xm + head);
  for (int base = blockIdx.x * THREADS * PER + threadIdx.x; base < nvec; base += gridDim.x * THREADS * PER) {
    V a[PER], b[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u)
      if (base + u * THREADS < nvec) a[u] = mv[base + u * THREADS], b[u] = xv[base + u * THREADS];
#pragma unroll
    for (int u = 0; u < PER; ++u)
      if (base + u * THREADS < nvec) ov[base + u * THREADS] = pre(a[u], b[u]);
  }
  const int body = nvec * W, nscalar = n - body;
  for (int s = blockIdx.x * THREADS + threadIdx.x; s < nscalar; s += gridDim.x * THREADS) {
    const int i = scalar_index(s, head, body);
    xm[i] = pre(m[i], x[i]);
  }
}

// yi and y may be one buffer: each thread reads its entries before writing
// them
template <typename T, typename V>
__global__ void __launch_bounds__(THREADS)
    mask_post(const T* __restrict__ m, const T* yi, const T* __restrict__ x, T* y, int head, int nvec, int n,
              const int* active) {
  if (active && *active == 0) return;
  constexpr int W = (int)(sizeof(V) / sizeof(T));  // values a vector
  const V* mv = reinterpret_cast<const V*>(m + head);
  const V* yv = reinterpret_cast<const V*>(yi + head);
  const V* xv = reinterpret_cast<const V*>(x + head);
  V* ov = reinterpret_cast<V*>(y + head);
  for (int base = blockIdx.x * THREADS * PER + threadIdx.x; base < nvec; base += gridDim.x * THREADS * PER) {
    V a[PER], b[PER], c[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u)
      if (base + u * THREADS < nvec)
        a[u] = mv[base + u * THREADS], b[u] = yv[base + u * THREADS], c[u] = xv[base + u * THREADS];
#pragma unroll
    for (int u = 0; u < PER; ++u)
      if (base + u * THREADS < nvec) ov[base + u * THREADS] = post(a[u], b[u], c[u]);
  }
  const int body = nvec * W, nscalar = n - body;
  for (int s = blockIdx.x * THREADS + threadIdx.x; s < nscalar; s += gridDim.x * THREADS) {
    const int i = scalar_index(s, head, body);
    y[i] = post(m[i], yi[i], x[i]);
  }
}

}  // namespace ntt_mask

extern "C" {

// dtype: 0 float32, 1 float64; head, nvec, grid: the split and grid of
// ops/sparse.py mask_plan (the body's pointers on 16 bytes); active: the
// CG loop's flag, or null.  Returns cudaGetLastError().
int ntt_mask_pre(int dtype, const void* m, const void* x, void* xm, const int* active, int n, int head, int nvec,
                 int grid, void* stream) {
  using namespace ntt_mask;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    mask_pre<float, float4><<<grid, THREADS, 0, s>>>((const float*)m, (const float*)x, (float*)xm, head, nvec, n,
                                                     active);
  else
    mask_pre<double, double2><<<grid, THREADS, 0, s>>>((const double*)m, (const double*)x, (double*)xm, head, nvec,
                                                       n, active);
  return (int)cudaGetLastError();
}

int ntt_mask_post(int dtype, const void* m, const void* yi, const void* x, void* y, const int* active, int n,
                  int head, int nvec, int grid, void* stream) {
  using namespace ntt_mask;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    mask_post<float, float4><<<grid, THREADS, 0, s>>>((const float*)m, (const float*)yi, (const float*)x, (float*)y,
                                                      head, nvec, n, active);
  else
    mask_post<double, double2><<<grid, THREADS, 0, s>>>((const double*)m, (const double*)yi, (const double*)x,
                                                        (double*)y, head, nvec, n, active);
  return (int)cudaGetLastError();
}

}  // extern "C"
