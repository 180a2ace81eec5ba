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
// h = T/2, ..., 1.  The segment sum (segment_sum) reduces each segment of
// partials the same way in one block and adds the segments' values in order
// in thread 0.  The plain version (ops/assembly.py elem_value_plain,
// elem_value_sum_plain) takes the same sums, so the two agree bit for bit; a
// block's partial depends on its span's values only, so an element chunk
// whose size is a multiple of the span, written into its rows of one
// partials buffer, gives the same partials as the whole batch.  Repeated
// calls give the same bits.
//
// The fold.  A value's last elem_value launch (a part's, or its last
// chunk's) also finishes the value: each block writes its partials and
// draws a ticket from an int32 counter (a release atomic); the block that
// draws the last ticket runs segment_sum over every part's partials
// (earlier launches' by stream order, this launch's by the release and an
// acquire fence) into out[0] and sets the counter back to 0, so that the
// next launch, or a CUDA graph's replay, starts from 0 (the ticket of K6
// and K10, csrc/krylov.cuh).  A last part with no values launches one
// block that writes no partial and finishes.  A block sums SPANS = 2 spans:
// 1,013 blocks on the finite-strain path, one wave, half the tickets; one
// span a block and four measured slower (kernel_plan_sweep.py --k12).  On
// the card the fold's device time is level with the two launches it
// replaced in one CUDA graph (each block waits for its ticket's round trip,
// as long as a kernel boundary); it saves the second launch's host call.
// elem_value_sum, the same segment_sum as a launch of one block, stays for
// the tests and the card's checks; no path launches it.
//
// Bound: device memory.  elem_value reads each value once and does one add
// a value (at the finite-strain path's 518,400 elements of 4 points in
// float64, 16.6 MB: 0.005 ms at 3.35 TB/s); the segment sum reads one value
// a block, its time the latency of one block's pass, which the fold hides in
// the launch that wrote them.  Design: a simple one-pass kernel, coalesced
// scalar loads (thread t of a round reads value t), T = 256, 1,024 values a
// block where P divides it; 2,025 blocks on that path.
#include <cuda_runtime.h>

namespace ntt_value {

constexpr int THREADS = 256;
constexpr int U = 8;      // segment_sum's rounds of loads in flight
constexpr int SPANS = 2;  // elem_value's spans (partials) a block

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

// The segments [off[k], off[k + 1]) of partials, each reduced over the
// lanes in the fixed order, their values added in order; valid in thread 0.
// s: the block's THREADS values of shared memory.
template <typename T>
__device__ __forceinline__ T segment_sum(const T* partials, const long long* __restrict__ off, int nseg, T* s) {
  T total = T(0);
  for (int k = 0; k < nseg; ++k) {
    const long long lo = off[k], len = off[k + 1] - lo;
    const long long rounds = (len + THREADS - 1) / THREADS;
    T acc = T(0);
    // U rounds' loads in flight at once, their adds in round order (a value
    // past len adding 0)
    for (long long r0 = 0; r0 < rounds; r0 += U) {
      T v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long i = (r0 + u) * THREADS + threadIdx.x;
        v[u] = r0 + u < rounds && i < len ? __ldcg(partials + lo + i) : T(0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r0 + u < rounds) acc += v[u];
    }
    __syncthreads();  // the previous segment's s[0] has been read
    s[threadIdx.x] = acc;
    tree(s);
    if (threadIdx.x == 0) total = k == 0 ? s[0] : total + s[0];
  }
  return total;
}

// Thread 0 of a block that has written its partials draws a ticket (a
// release atomic): true in the launch's last block, to which every block's
// partials are then visible (an acquire fence), which sets the counter
// back to 0.
__device__ __forceinline__ bool last_ticket(int* ticket) {
  unsigned old;
  asm volatile("atom.add.release.gpu.u32 %0, [%1], 1;" : "=r"(old) : "l"(ticket) : "memory");
  if (old != gridDim.x - 1) return false;
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
  *ticket = 0;
  return true;
}

// A block sums SPANS spans, its partials b = SPANS blockIdx.x + k, each as
// above (their loads interleaved).  Where ticket is not null, the launch's
// last block to draw a ticket sums the value's partials `all` in the
// segments off into out[0] and resets the ticket.
template <typename T>
__global__ void __launch_bounds__(THREADS) elem_value(const T* __restrict__ f, T* partials, long long n, int span,
                                                      int rounds, const T* all, const long long* __restrict__ off,
                                                      T* __restrict__ out, int nseg, int* ticket) {
  __shared__ T s[THREADS];
  __shared__ bool last;
  const long long b0 = (long long)blockIdx.x * SPANS;
  T acc[SPANS];
#pragma unroll
  for (int k = 0; k < SPANS; ++k) acc[k] = T(0);
#pragma unroll 4
  for (int r = 0; r < rounds; ++r) {
    const int i = r * THREADS + threadIdx.x;
#pragma unroll
    for (int k = 0; k < SPANS; ++k) {
      const long long j = (b0 + k) * span + i;
      acc[k] += (i < span && j < n) ? f[j] : T(0);
    }
  }
#pragma unroll
  for (int k = 0; k < SPANS; ++k) {
    if ((b0 + k) * span >= n) break;  // uniform over the block
    s[threadIdx.x] = acc[k];
    tree(s);
    if (threadIdx.x == 0) partials[b0 + k] = s[0];
  }
  if (ticket == nullptr) return;
  if (threadIdx.x == 0) last = last_ticket(ticket);
  __syncthreads();
  if (!last) return;
  const T total = segment_sum(all, off, nseg, s);
  if (threadIdx.x == 0) out[0] = total;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) elem_value_sum(const T* __restrict__ partials,
                                                          const long long* __restrict__ off, T* __restrict__ out,
                                                          int nseg) {
  __shared__ T s[THREADS];
  const T total = segment_sum(partials, off, nseg, s);
  if (threadIdx.x == 0) out[0] = total;
}

}  // namespace ntt_value

extern "C" {

// dtype: 0 float32, 1 float64.  n values of f; span values a block (the
// last block ragged); rounds = ceil(span / 256).  Writes ceil(n / span)
// partials.  ticket: null, or the value's last launch (at least one block,
// n = 0 too): an int32 counter at 0, and the last block writes out[0], the
// sum of all (the value's partials, this launch's the last) in the nseg
// segments of offsets (int64 on the device).  Returns cudaGetLastError().
int ntt_elem_value(int dtype, const void* f, void* partials, long long n, int span, int rounds, const void* all,
                   const void* offsets, void* out, int nseg, void* ticket, void* stream) {
  if (ticket == nullptr && n == 0) return 0;
  if (ticket != nullptr && nseg < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long per = (long long)span * ntt_value::SPANS;
  long long blocks = (n + per - 1) / per;
  if (blocks < 1) blocks = 1;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidConfiguration;
  const long long* off = (const long long*)offsets;
  int* t = (int*)ticket;
  if (dtype == 0)
    ntt_value::elem_value<float><<<(unsigned int)blocks, ntt_value::THREADS, 0, s>>>(
        (const float*)f, (float*)partials, n, span, rounds, (const float*)all, off, (float*)out, nseg, t);
  else
    ntt_value::elem_value<double><<<(unsigned int)blocks, ntt_value::THREADS, 0, s>>>(
        (const double*)f, (double*)partials, n, span, rounds, (const double*)all, off, (double*)out, nseg, t);
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
