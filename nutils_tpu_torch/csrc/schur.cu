// K7: Schur-aware inverse diagonal of a CSR operator whose values live in a
// weight buffer (block-grid or stencil form): a_k = w[csr_map[k]]; or, with
// no map (a null csr_map), of a CSR operator whose values are w itself:
// a_k = w[k].
//
// Replaces nutils_tpu/ops/sparse.py _schur_diag_kernel (reached through
// schur_diag_inverse_device and System.fused_step_op).  Per row i:
//
//   d_i      = a_ii,  rn2_i = sum_k a_ik^2
//   strong_i = |d_i| > weak_rel * sqrt(rn2_i),  dsafe_i = strong_i ? |d_i| : 1
//   schur_i  = sum_k a_ik^2 / dsafe_{col k}
//   minv_i   = strong_i ? 1 / d_i : (schur_i > 0 ? 1 / schur_i : 1)
//
// Bound: device memory.  Two passes over the nonzeros, each reading a slot's
// csr_map entry (mapped form), its value and its column index, plus one
// pass over the rows.  Design: one
// warp per row, lanes striding the row's slots, a fixed-order shuffle
// reduction (the result does not depend on scheduling).  Pass 2 needs the
// dsafe of every column, so it is a second launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace ntt_schur {

constexpr int WARPS = 8;  // warps (rows) per block

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, bool MAPPED>
__device__ __forceinline__ T value(const T* __restrict__ w, const int* __restrict__ cmap, int k) {
  if constexpr (MAPPED) return w[cmap[k]];
  return w[k];
}

template <typename T, bool MAPPED>
__global__ void schur_pass1(const T* __restrict__ w, const int* __restrict__ cmap, const int* __restrict__ indices,
                            const int* __restrict__ indptr, int n, T weak_rel, T* __restrict__ d,
                            T* __restrict__ dsafe, unsigned char* __restrict__ strong) {
  int row = blockIdx.x * WARPS + threadIdx.x / 32;
  int lane = threadIdx.x % 32;
  if (row >= n) return;
  T dsum = T(0), sq = T(0);
  for (int k = indptr[row] + lane; k < indptr[row + 1]; k += 32) {
    T a = value<T, MAPPED>(w, cmap, k);
    if (indices[k] == row) dsum += a;
    sq += a * a;
  }
  dsum = warp_sum(dsum);
  sq = warp_sum(sq);
  if (lane == 0) {
    bool st = fabs(dsum) > weak_rel * sqrt(sq);
    d[row] = dsum;
    dsafe[row] = st ? fabs(dsum) : T(1);
    strong[row] = st;
  }
}

template <typename T, bool MAPPED>
__global__ void schur_pass2(const T* __restrict__ w, const int* __restrict__ cmap, const int* __restrict__ indices,
                            const int* __restrict__ indptr, int n, const T* __restrict__ d,
                            const T* __restrict__ dsafe, const unsigned char* __restrict__ strong,
                            T* __restrict__ minv) {
  int row = blockIdx.x * WARPS + threadIdx.x / 32;
  int lane = threadIdx.x % 32;
  if (row >= n) return;
  T schur = T(0);
  for (int k = indptr[row] + lane; k < indptr[row + 1]; k += 32) {
    T a = value<T, MAPPED>(w, cmap, k);
    schur += a * a / dsafe[indices[k]];
  }
  schur = warp_sum(schur);
  if (lane == 0) minv[row] = strong[row] ? T(1) / d[row] : (schur > T(0) ? T(1) / schur : T(1));
}

template <typename T, bool MAPPED>
int launch(const void* w, const void* cmap, const void* indices, const void* indptr, int n, double weak_rel,
           void* d, void* dsafe, void* strong, void* minv, cudaStream_t s) {
  unsigned int grid = (unsigned int)((n + WARPS - 1) / WARPS);
  schur_pass1<T, MAPPED><<<grid, WARPS * 32, 0, s>>>((const T*)w, (const int*)cmap, (const int*)indices,
                                             (const int*)indptr, n, (T)weak_rel, (T*)d, (T*)dsafe,
                                             (unsigned char*)strong);
  int err = (int)cudaGetLastError();
  if (err) return err;
  schur_pass2<T, MAPPED><<<grid, WARPS * 32, 0, s>>>((const T*)w, (const int*)cmap, (const int*)indices,
                                             (const int*)indptr, n, (const T*)d, (const T*)dsafe,
                                             (const unsigned char*)strong, (T*)minv);
  return (int)cudaGetLastError();
}

}  // namespace ntt_schur

extern "C" {

// dtype: 0 float32, 1 float64.  cmap null: the values are w itself.  d,
// dsafe (dtype) and strong (bytes) are scratch of n entries; minv is the
// output.  Returns cudaGetLastError().
int ntt_schur_diag(int dtype, const void* w, const void* cmap, const void* indices, const void* indptr, void* d,
                   void* dsafe, void* strong, void* minv, int n, double weak_rel, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (cmap == nullptr) {
    if (dtype == 0)
      return ntt_schur::launch<float, false>(w, cmap, indices, indptr, n, weak_rel, d, dsafe, strong, minv, s);
    return ntt_schur::launch<double, false>(w, cmap, indices, indptr, n, weak_rel, d, dsafe, strong, minv, s);
  }
  if (dtype == 0)
    return ntt_schur::launch<float, true>(w, cmap, indices, indptr, n, weak_rel, d, dsafe, strong, minv, s);
  return ntt_schur::launch<double, true>(w, cmap, indices, indptr, n, weak_rel, d, dsafe, strong, minv, s);
}

}  // extern "C"
