// K13: block-Jacobi apply z = M r, M the inverted diagonal blocks
// minv[nb, bs, bs] of a matrix (bs from 1 to 8), float32 or float64.
//
// Replaces nutils_tpu/ops/sparse.py _apply_block (an einsum 'bij,bj->bi'
// over r padded to nb * bs), which every Krylov loop of the JAX package
// runs under precon='block': z[i] = sum_j minv[i / bs, i % bs, j] *
// r[(i / bs) * bs + j], over the j with (i / bs) * bs + j < n.  The padding
// of the last block is the identity's, so the terms past n are zero and
// are skipped: nothing reads past r[n - 1].
//
// Bound: device memory.  Each row reads its bs values of minv and writes
// one z; r is read once from DRAM (the bs rows of a block read the same bs
// values, from L1 or L2): (bs + 2) values a row, 33.3 MB per float64 apply
// at n = 1,039,682 and bs = 2.  Design: one thread per row; row i's values
// of minv are the bs values from minv + i * bs, so a warp reads 32 * bs
// contiguous values for any bs.  The sum runs in the order of j as fused
// multiply-adds, started from the first product.  bs = 1, 2, 4 and 8 are
// instances of a template with the loop unrolled; 3, 5, 6 and 7 run one
// loop over the block size.  Inside the CG loop's chunk graphs it reads the
// loop's active flag first and does nothing once the loop has stopped
// (null: always runs).
#include <cuda_runtime.h>
#include <stdint.h>

namespace ntt_block {

constexpr int THREADS = 256;

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// BS > 0: that block size, unrolled; BS == 0: the block size bs at run time
template <typename T, int BS>
__global__ void block_apply(const T* __restrict__ minv, const T* __restrict__ r, T* __restrict__ z, int n, int bs,
                            const int* active) {
  if (active && *active == 0) return;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int b = BS > 0 ? BS : bs;
  const int lo = (i / b) * b;
  const int m = min(b, n - lo);  // the block's rows below n
  const T* row = minv + (int64_t)i * b;
  T acc = mul_rn(row[0], __ldg(r + lo));
  if constexpr (BS > 0) {
#pragma unroll
    for (int j = 1; j < BS; ++j)
      if (j < m) acc = fma_rn(row[j], __ldg(r + lo + j), acc);
  } else {
    for (int j = 1; j < m; ++j) acc = fma_rn(row[j], __ldg(r + lo + j), acc);
  }
  z[i] = acc;
}

template <typename T>
int launch(const void* minv, const void* r, void* z, const int* active, int n, int bs, cudaStream_t s) {
  const unsigned int grid = (unsigned int)((n + THREADS - 1) / THREADS);
  const T* m = (const T*)minv;
  const T* x = (const T*)r;
  T* y = (T*)z;
  switch (bs) {
    case 1: block_apply<T, 1><<<grid, THREADS, 0, s>>>(m, x, y, n, bs, active); break;
    case 2: block_apply<T, 2><<<grid, THREADS, 0, s>>>(m, x, y, n, bs, active); break;
    case 4: block_apply<T, 4><<<grid, THREADS, 0, s>>>(m, x, y, n, bs, active); break;
    case 8: block_apply<T, 8><<<grid, THREADS, 0, s>>>(m, x, y, n, bs, active); break;
    default: block_apply<T, 0><<<grid, THREADS, 0, s>>>(m, x, y, n, bs, active); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace ntt_block

extern "C" {

// dtype: 0 float32, 1 float64; minv [ceil(n / bs), bs, bs] (or more
// blocks), bs 1..8; active: the CG loop's flag, or null.  Returns
// cudaGetLastError().
int ntt_block_apply(int dtype, const void* minv, const void* r, void* z, const int* active, int n, int bs,
                    void* stream) {
  if (n == 0) return 0;
  if (bs < 1 || bs > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return ntt_block::launch<float>(minv, r, z, active, n, bs, s);
  return ntt_block::launch<double>(minv, r, z, active, n, bs, s);
}

}  // extern "C"
