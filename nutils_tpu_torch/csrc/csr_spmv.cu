// K9: y = A x for a CSR matrix (data, indices, indptr), float32 or float64.
//
// Replaces nutils_tpu/ops/sparse.py _make_matvec for the unstructured
// operator kinds ('csr', 'ell', 'bell': one function in three TPU layouts;
// the port keeps the CSR operand itself).  Float64 is the refinement's
// widened operator.
//
// Bound: device memory.  Each nonzero's value and column are read once
// (8 B in float32), plus the row pointers, x and y; the gathers x[col] hit
// L2 for the banded finite-element patterns.  Design: a group of LANES
// consecutive lanes per row, striding the row so that neighbouring lanes
// read neighbouring values and columns, then a fixed-order butterfly
// shuffle inside the group: the result does not depend on scheduling.
// LANES is 4: on the Taylor-Hood triangle operator (~30 nonzeros a row, at
// most 59) a lane carries about eight products and a warp covers 8 rows; 4
// ran fastest of 4, 8, 16 and 32 on an H100 (csr_lanes_sweep.py rebuilds
// this file with each).
#include <cuda_runtime.h>
#include <stdint.h>

namespace ntt_spmv {

constexpr int THREADS = 256;
constexpr int LANES = 4;

template <typename T>
__global__ void spmv(const T* __restrict__ data, const int* __restrict__ indices, const int* __restrict__ indptr,
                     const T* __restrict__ x, T* __restrict__ y, int n) {
  long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  int row = (int)(tid / LANES);
  int lane = threadIdx.x % LANES;
  T acc = T(0);
  if (row < n) {
    int end = indptr[row + 1];
    for (int k = indptr[row] + lane; k < end; k += LANES) acc += data[k] * __ldg(x + indices[k]);
  }
  // every lane of the warp takes part in the shuffles (rows past n hold 0)
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o, LANES);
  if (lane == 0 && row < n) y[row] = acc;
}

template <typename T>
int launch(const void* data, const void* indices, const void* indptr, const void* x, void* y, int n,
           cudaStream_t s) {
  long long threads = (long long)n * LANES;
  unsigned int grid = (unsigned int)((threads + THREADS - 1) / THREADS);
  spmv<T><<<grid, THREADS, 0, s>>>((const T*)data, (const int*)indices, (const int*)indptr, (const T*)x, (T*)y, n);
  return (int)cudaGetLastError();
}

}  // namespace ntt_spmv

extern "C" {

// dtype: 0 float32, 1 float64.  Returns cudaGetLastError().
int ntt_csr_spmv(int dtype, const void* data, const void* indices, const void* indptr, const void* x, void* y, int n,
                 void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return ntt_spmv::launch<float>(data, indices, indptr, x, y, n, s);
  return ntt_spmv::launch<double>(data, indices, indptr, x, y, n, s);
}

}  // extern "C"
