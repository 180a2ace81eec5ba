// K8: CSR value scatter, data[s] = sum of values[j] over the entries j whose
// CSR slot is s, float32 or float64.
//
// Replaces nutils_tpu/matrix.py SparsePattern.scatter (an XLA scatter-add,
// jnp.zeros(nnz).at[slot].add(values)), reached from solver._jacobian_trace
// when the jacobian has neither stencil nor block-grid form.
//
// The host sorts the entries by slot once per pattern (order) and keeps the
// segment pointer of each slot (segptr, nnz + 1): one thread per slot sums
// its entries in that fixed order, with no float atomics, so assembly is
// bitwise reproducible (and bitwise equal to a sequential index_add_).
//
// Bound: device memory.  Each entry's value and order index are read once,
// the segment pointers once and the output written once; the value reads
// follow the entry order of the slot and are gathers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace ntt_scatter {

constexpr int THREADS = 256;

template <typename T>
__global__ void scatter(const T* __restrict__ values, const int* __restrict__ order, const int* __restrict__ segptr,
                        T* __restrict__ data, int nnz) {
  int s = blockIdx.x * THREADS + threadIdx.x;
  if (s >= nnz) return;
  T acc = T(0);
  int end = segptr[s + 1];
  for (int j = segptr[s]; j < end; ++j) acc += values[order[j]];
  data[s] = acc;
}

}  // namespace ntt_scatter

extern "C" {

// dtype: 0 float32, 1 float64.  Returns cudaGetLastError().
int ntt_csr_scatter(int dtype, const void* values, const void* order, const void* segptr, void* data, int nnz,
                    void* stream) {
  if (nnz == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned int grid = (unsigned int)((nnz + ntt_scatter::THREADS - 1) / ntt_scatter::THREADS);
  if (dtype == 0)
    ntt_scatter::scatter<float><<<grid, ntt_scatter::THREADS, 0, s>>>(
        (const float*)values, (const int*)order, (const int*)segptr, (float*)data, nnz);
  else
    ntt_scatter::scatter<double><<<grid, ntt_scatter::THREADS, 0, s>>>(
        (const double*)values, (const int*)order, (const int*)segptr, (double*)data, nnz);
  return (int)cudaGetLastError();
}

}  // extern "C"
