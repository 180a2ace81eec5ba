// K15: the value of a functional from its integrand at the points, float32
// or float64, in a fixed order of sums.
//
//   elem_value      partials[b] = sum of f over the elements [b span, (b + 1) span)
//   elem_value_sum  out[0] = v_0 + v_1 + ..., v_s the sum of segment s of the
//                   partials
//
// Replaces the outer sum of nutils_tpu/solver.py System._value_trace
// (solver.py:985, the compiled functional, whose integral XLA reduces) and of
// the want_val branch of _scan_assemble (:1488-1489, :1551-1552), that is
// the value assembly that Minimize reads on every line-search trial.  f is
// the integrand [E, P] with the quadrature weights and jacobians folded in
// (ops/assembly.py), flat here; an additive term's value is its sum, and
// the functional's value is the sum of its terms' values in their order.
//
// Order of sums.  A block of elem_value owns span elements (span P values,
// span a power of two): its thread t sums the values t, t + T, t + 2T, ...
// of the span (rounds of T, a value past the span or past n adding 0), and
// the T lanes then add pairwise in shared memory, lane t + h into lane t for
// h = T/2, ..., 1.  elem_value_sum reduces each segment of partials the same
// way in one block and adds the segments' values in order in thread 0.  The
// plain version (ops/assembly.py elem_value_plain, elem_value_sum_plain)
// takes the same sums, so the two agree bit for bit; a block's partial
// depends on its span's values only, so an element chunk whose size is a
// multiple of the span, written into its rows of one partials buffer, gives
// the same partials as the whole batch.  No atomics: repeated calls give
// the same bits.
//
// Bound: device memory.  elem_value reads each value once and does one add
// a value (at the finite-strain path's 518,400 elements of 4 points in
// float64, 16.6 MB: 0.005 ms at 3.35 TB/s); elem_value_sum reads one value a
// block.  Design: a simple one-pass kernel, coalesced scalar loads (thread t
// of a round reads value t), T = 256, 1,024 values a block where P divides
// it; 2,025 blocks on that path.
#include <cuda_runtime.h>

namespace ntt_value {

constexpr int THREADS = 256;

// The lanes of the block add pairwise; the sum is left in s[0].
template <typename T>
__device__ __forceinline__ void tree(T* s) {
#pragma unroll
  for (int h = THREADS / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (threadIdx.x < h) s[threadIdx.x] += s[threadIdx.x + h];
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS) elem_value(const T* __restrict__ f, T* __restrict__ partials, long long n,
                                                      int span, int rounds) {
  __shared__ T s[THREADS];
  const long long base = (long long)blockIdx.x * span;
  T acc = T(0);
  for (int r = 0; r < rounds; ++r) {
    const int i = r * THREADS + threadIdx.x;
    const long long j = base + i;
    acc += (i < span && j < n) ? f[j] : T(0);
  }
  s[threadIdx.x] = acc;
  tree(s);
  if (threadIdx.x == 0) partials[blockIdx.x] = s[0];
}

template <typename T>
__global__ void __launch_bounds__(THREADS) elem_value_sum(const T* __restrict__ partials,
                                                          const long long* __restrict__ off, T* __restrict__ out,
                                                          int nseg) {
  __shared__ T s[THREADS];
  T total = T(0);
  for (int k = 0; k < nseg; ++k) {
    const long long lo = off[k], len = off[k + 1] - lo;
    const long long rounds = (len + THREADS - 1) / THREADS;
    T acc = T(0);
    for (long long r = 0; r < rounds; ++r) {
      const long long i = r * THREADS + threadIdx.x;
      acc += i < len ? partials[lo + i] : T(0);
    }
    __syncthreads();  // the previous segment's s[0] has been read
    s[threadIdx.x] = acc;
    tree(s);
    if (threadIdx.x == 0) total = k == 0 ? s[0] : total + s[0];
  }
  if (threadIdx.x == 0) out[0] = total;
}

}  // namespace ntt_value

extern "C" {

// dtype: 0 float32, 1 float64.  n values of f; span values a block (the
// last block ragged); rounds = ceil(span / 256).  Writes ceil(n / span)
// partials.  Returns cudaGetLastError().
int ntt_elem_value(int dtype, const void* f, void* partials, long long n, int span, int rounds, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long blocks = (n + span - 1) / span;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidConfiguration;
  if (dtype == 0)
    ntt_value::elem_value<float><<<(unsigned int)blocks, ntt_value::THREADS, 0, s>>>(
        (const float*)f, (float*)partials, n, span, rounds);
  else
    ntt_value::elem_value<double><<<(unsigned int)blocks, ntt_value::THREADS, 0, s>>>(
        (const double*)f, (double*)partials, n, span, rounds);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 float64.  offsets: the nseg + 1 bounds of the
// segments in partials, int64 on the device.  Writes out[0].  Returns
// cudaGetLastError().
int ntt_elem_value_sum(int dtype, const void* partials, const void* offsets, void* out, int nseg, void* stream) {
  if (nseg < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* off = (const long long*)offsets;
  if (dtype == 0)
    ntt_value::elem_value_sum<float><<<1, ntt_value::THREADS, 0, s>>>((const float*)partials, off, (float*)out, nseg);
  else
    ntt_value::elem_value_sum<double><<<1, ntt_value::THREADS, 0, s>>>((const double*)partials, off, (double*)out,
                                                                       nseg);
  return (int)cudaGetLastError();
}

}  // extern "C"
