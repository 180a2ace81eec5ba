// K9: y = A x for a CSR matrix (data, indices, indptr), float32 or float64.
//
// Replaces nutils_tpu/ops/sparse.py _make_matvec for the unstructured
// operator kinds ('csr', 'ell', 'bell': one function in three TPU layouts;
// the port keeps the CSR operand itself).  Float64 is the refinement's
// widened operator.
//
// Bound: device memory.  Each nonzero's value and column are read once
// (8 B in float32, 12 B in float64), plus the row pointers, x and y; x
// (3.9 MB in float32 at the triangle step) stays in L2, so its gathers
// cost L2 bandwidth, not device memory.  Design: CSR-stream (Greathouse and
// Daga, SC 2014) rather than merge-path (Merrill and Garland, SC 2016): the
// finite-element rows are short and even (about 30 nonzeros, at most 59),
// so cutting the nonzeros into equal blocks at row boundaries balances the
// work as well as a merge-path split would, and a block never shares a row
// with another, so no carry-out between blocks is needed.  A plan made
// once per operand (ops/sparse.py csr_plan, a list of row starts) cuts the
// rows into blocks of at most `cap` nonzeros; a row of more than cap / 2
// is a block of its own (a "long" one where it holds more than cap).  A block reads its span [indptr[r0], indptr[r1]) of
// data and indices with 16-byte loads by neighbouring threads (the values
// before the first and after the last 4-value boundary are read one at a
// time: row starts are arbitrary, only the arrays' bases are aligned),
// marked as streams (evict first) so that L1 and L2 keep x for the
// gathers, and writes the products into shared memory.  LANES lanes then
// sum each row, strided, in a fixed order, and a butterfly shuffle adds
// the lanes; a long row is summed by the whole block, strided, then by
// warps and across warps in a fixed order.  The sums do not depend on
// scheduling, so repeated calls give the same bits.  The first rows'
// bounds are read before the span, so that their latency hides behind
// it.  Inside the CG loop's chunk graphs the kernel reads the loop's
// active flag first and does nothing once the loop has stopped (null:
// always runs).  csr_lanes_sweep.py rebuilds this file at other LANES and
// times plans at other caps (cap 1,024, 2 lanes: shared memory leaves L1
// room for x in float64).
#include <cuda_runtime.h>
#include <stdint.h>

namespace ntt_spmv {

constexpr int THREADS = 256;
constexpr int LANES = 2;
constexpr int VEC = 4;  // values a 16-byte load of indices brings

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// data[e .. e + 3] with 16-byte loads (e a multiple of 4, base aligned)
__device__ __forceinline__ void load4(const float* p, float (&v)[VEC]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[VEC]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p)), b = __ldcs(reinterpret_cast<const double2*>(p + 2));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    spmv(const T* __restrict__ data, const int* __restrict__ indices, const int* __restrict__ indptr,
         const int* __restrict__ starts, const T* __restrict__ x, T* __restrict__ y, int cap, int vec_ok,
         const int* active) {
  if (active && *active == 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* prod = reinterpret_cast<T*>(smem_raw);
  __shared__ T warp_sums[THREADS / 32];
  const int r0 = starts[blockIdx.x], r1 = starts[blockIdx.x + 1];
  const int k0 = indptr[r0], k1 = indptr[r1];
  if (k1 - k0 > cap) {
    // one long row (the plan gives it a block of its own)
    T acc = T(0);
    for (int k = k0 + threadIdx.x; k < k1; k += THREADS) acc += mul_rn(data[k], __ldg(x + indices[k]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      T sum = T(0);
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) sum += warp_sums[w];
      y[r0] = sum;
    }
    return;
  }
  // this thread's first row's bounds, read now so that their latency hides
  // behind the span's loads
  const int lane = threadIdx.x % LANES;
  int rs = 0, re = 0;
  if (r0 + (int)threadIdx.x / LANES < r1) {
    rs = indptr[r0 + threadIdx.x / LANES];
    re = indptr[r0 + threadIdx.x / LANES + 1];
  }
  // the span's products into shared memory: the 4-aligned interior with
  // 16-byte loads, VEC values a thread a step; the head and the tail (up to
  // VEC - 1 values each) one value a thread
  if (vec_ok) {
    const int ka = min((k0 + VEC - 1) & ~(VEC - 1), k1), kb = max(k1 & ~(VEC - 1), ka);
#pragma unroll 2
    for (int e = ka + VEC * threadIdx.x; e < kb; e += VEC * THREADS) {
      const int4 c = __ldcs(reinterpret_cast<const int4*>(indices + e));
      T v[VEC];
      load4(data + e, v);
      const T x0 = __ldg(x + c.x), x1 = __ldg(x + c.y), x2 = __ldg(x + c.z), x3 = __ldg(x + c.w);
      T* out = prod + (e - k0);
      out[0] = mul_rn(v[0], x0);
      out[1] = mul_rn(v[1], x1);
      out[2] = mul_rn(v[2], x2);
      out[3] = mul_rn(v[3], x3);
    }
    const int k = threadIdx.x < VEC - 1 ? k0 + threadIdx.x : kb + threadIdx.x - (VEC - 1);
    if (threadIdx.x < 2 * (VEC - 1) && k < (threadIdx.x < VEC - 1 ? ka : k1))
      prod[k - k0] = mul_rn(data[k], __ldg(x + indices[k]));
  } else {
    for (int k = k0 + threadIdx.x; k < k1; k += THREADS) prod[k - k0] = mul_rn(data[k], __ldg(x + indices[k]));
  }
  __syncthreads();
  // each row's products: LANES lanes, strided, then the butterfly (every
  // lane of the warp takes part; rows past r1 hold 0)
  for (int base = r0; base < r1; base += THREADS / LANES) {
    const int row = base + threadIdx.x / LANES;
    if (base != r0 && row < r1) {
      rs = indptr[row];
      re = indptr[row + 1];
    }
    T acc = T(0);
    if (row < r1)
      for (int k = rs - k0 + lane; k < re - k0; k += LANES) acc += prod[k];
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o, LANES);
    if (lane == 0 && row < r1) y[row] = acc;
  }
}

template <typename T>
int launch(const void* data, const void* indices, const void* indptr, const void* starts, const void* x, void* y,
           const int* active, int nblocks, int cap, cudaStream_t s) {
  const int vec_ok = (uintptr_t)data % 16 == 0 && (uintptr_t)indices % 16 == 0;
  const size_t bytes = (size_t)cap * sizeof(T);
  if (bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
  spmv<T><<<(unsigned int)nblocks, THREADS, bytes, s>>>((const T*)data, (const int*)indices, (const int*)indptr,
                                                        (const int*)starts, (const T*)x, (T*)y, cap, vec_ok, active);
  return (int)cudaGetLastError();
}

}  // namespace ntt_spmv

extern "C" {

// dtype: 0 float32, 1 float64; starts: the plan's nblocks + 1 row starts,
// each block at most cap nonzeros unless it is one row; active: the CG
// loop's flag, or null.  Returns cudaGetLastError().
int ntt_csr_spmv(int dtype, const void* data, const void* indices, const void* indptr, const void* starts,
                 const void* x, void* y, const int* active, int nblocks, int cap, void* stream) {
  if (nblocks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return ntt_spmv::launch<float>(data, indices, indptr, starts, x, y, active, nblocks, cap, s);
  return ntt_spmv::launch<double>(data, indices, indptr, starts, x, y, active, nblocks, cap, s);
}

}  // extern "C"
