// K4: the vector work of the preconditioned CG loop, and the loop's
// decisions, on a small state buffer in device memory.
//
// Replaces the device work of nutils_tpu/ops/sparse.py _cg_driver's body
// (sparse.py:330-364) apart from the matvec and the preconditioner, and the
// tests of its lax.while_loop, so that the host reads the state once a
// chunk of iterations instead of once an iteration:
//
//   ntt_cg_dot   st[slot] = a . b (rz = r . z, pAp = p . Ap, rr = r . r)
//   ntt_cg_step  alpha = rz / pAp; x += alpha p; r -= alpha Ap; rr = |r|^2;
//                rz_old = rz; then the convergence claim, the refresh
//                schedule and the iteration cap, which clear the state's
//                active flag and record why
//   ntt_cg_xpby  beta = rz / rz_old (0 after a claimed refresh);
//                p = z + beta p
//
// The state (float64 slots, int32 slots of the same buffer; ops/cg.py holds
// the same layout): atol, rz, pAp, rr, rz_old and rr0 as float64 (all but
// atol hold working-dtype values, widened exactly), the iteration count k,
// maxiter, the active flag, the reason it fell and the grid ticket as
// int32, then one partial sum per block.  An iteration's dot of r . z
// writes the new rz over the old, which the step has saved, so xpby writes
// no state and needs no ticket.  Every entry returns at once when the flag
// is clear, so iterations enqueued after the loop's exit change nothing.
//
// Bound: device memory (8-24 bytes of traffic per element in float32 and
// no more than 3 operations).  Design: a grid of a few blocks an SM
// (ops/cg.BLOCKS_PER_SM, at most as many as fit) walks the vectors with
// 128-bit loads (float4 or double2, with a scalar tail) in grid-stride
// order, the same grid for every launch; the first loads are issued
// before the flag's test, so their latencies overlap.  Reductions are one
// launch: each block writes its fixed-order partial sum, and the last block
// to take a ticket (after __threadfence) sums the partials in block order,
// so the result is deterministic for a given grid, and takes the loop's
// decisions in float64, as the host loop does.  Sums accumulate in float64
// and are rounded to the working dtype once.  The scalars stay in the
// state, so no host read and no extra launch divides them.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ntt_cg {

constexpr int THREADS = 256;
// float64 slots
constexpr int ATOL = 0, RZ = 1, PAP = 2, RR = 3, RZOLD = 4, RR0 = 5, PARTS = 16;
// int32 slots
constexpr int K = 12, MAXITER = 13, ACTIVE = 14, REASON = 15, TICKET = 16;
// why the active flag fell
constexpr int RUNNING = 0, CLAIMED = 1, SCHEDULED = 2, CAPPED = 3, START = 4;
constexpr int REFRESH_EVERY = 64;

// The type the sums accumulate in: float64 for float32 vectors.  It costs
// nothing on a memory-bound kernel, a sum of a million terms is then
// exact to about one float32 rounding, and the recursive residual drifts
// less from the true one, so fewer convergence claims are refuted and the
// float32 inner solves take fewer iterations (PERF.md).
template <typename T>
struct Accum {
  using type = T;
};

template <>
struct Accum<float> {
  using type = double;
};

template <typename T, int W>
struct alignas(sizeof(T) * W) Lanes {
  T v[W];
};

template <typename T, int W>
__device__ __forceinline__ Lanes<T, W> load(const T* p, int i) {
  return reinterpret_cast<const Lanes<T, W>*>(p)[i];
}

template <typename T, int W>
__device__ __forceinline__ void store(T* p, int i, const Lanes<T, W>& v) {
  reinterpret_cast<Lanes<T, W>*>(p)[i] = v;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block in a fixed order; the result is valid in thread 0.
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T warps[THREADS / 32];
  __syncthreads();  // an earlier call's readers are done with warps[]
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = v;
  __syncthreads();
  v = threadIdx.x < THREADS / 32 ? warps[threadIdx.x] : T(0);
  if (threadIdx.x < 32) v = warp_sum(v);
  return v;
}

// Thread 0 publishes the block's partial sum, then takes a ticket; true in
// every thread of the last block to finish, which then sees every partial.
// Every block has read the state before it takes its ticket, so the last
// block may write it.
__device__ __forceinline__ bool last_block(double* st, double partial) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    st[PARTS + blockIdx.x] = partial;
    __threadfence();
    unsigned* ticket = reinterpret_cast<unsigned*>(st) + TICKET;
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  return last;
}

// The partial sums in block order (fixed per grid); valid in thread 0.
template <typename A>
__device__ __forceinline__ A sum_partials(const double* st) {
  A acc = A(0);
#pragma unroll 4
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS) acc += (A)__ldcg(st + PARTS + b);
  return block_sum(acc);
}

// The host loop's sqrt(max(v, 0.0)): a NaN stays a NaN.
__device__ __forceinline__ double norm_of(double v) { return sqrt(v < 0.0 ? 0.0 : v); }

template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
    dot_kernel(const T* __restrict__ a, const T* __restrict__ b, int n, double* st, int slot, int start) {
  int* sti = reinterpret_cast<int*>(st);
  const int active = sti[ACTIVE];
  const int nv = n / W, stride = gridDim.x * THREADS, g = blockIdx.x * THREADS + threadIdx.x;
  int i = g;
  Lanes<T, W> va, vb;
  if (i < nv) {
    va = load<T, W>(a, i);
    vb = load<T, W>(b, i);
  }
  if (!active) return;
  using A = typename Accum<T>::type;
  A acc = A(0);
  while (i < nv) {
#pragma unroll
    for (int j = 0; j < W; ++j) acc += (A)va.v[j] * (A)vb.v[j];
    i += stride;
    if (i < nv) {
      va = load<T, W>(a, i);
      vb = load<T, W>(b, i);
    }
  }
  if (g < n - nv * W) acc += (A)a[nv * W + g] * (A)b[nv * W + g];
  A part = block_sum(acc);
  if (!last_block(st, (double)part)) return;
  const T total = (T)sum_partials<A>(st);
  if (threadIdx.x == 0) {
    st[slot] = (double)total;
    // the loop's entry test: rnorm > atol and k < maxiter
    if (start && !(norm_of((double)total) > st[ATOL] && sti[K] < sti[MAXITER])) {
      sti[ACTIVE] = 0;
      sti[REASON] = START;
    }
    sti[TICKET] = 0;
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
    step_kernel(T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p, const T* __restrict__ ap, int n,
                double* st) {
  int* sti = reinterpret_cast<int*>(st);
  const int active = sti[ACTIVE];
  const T alpha = (T)st[RZ] / (T)st[PAP];
  const int nv = n / W, stride = gridDim.x * THREADS, g = blockIdx.x * THREADS + threadIdx.x;
  int i = g;
  Lanes<T, W> vx, vr, vp, va;
  if (i < nv) {
    vx = load<T, W>(x, i);
    vr = load<T, W>(r, i);
    vp = load<T, W>(p, i);
    va = load<T, W>(ap, i);
  }
  if (!active) return;
  using A = typename Accum<T>::type;
  A acc = A(0);
  while (i < nv) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      vx.v[j] += alpha * vp.v[j];
      vr.v[j] -= alpha * va.v[j];
      acc += (A)vr.v[j] * (A)vr.v[j];
    }
    store<T, W>(x, i, vx);
    store<T, W>(r, i, vr);
    i += stride;
    if (i < nv) {
      vx = load<T, W>(x, i);
      vr = load<T, W>(r, i);
      vp = load<T, W>(p, i);
      va = load<T, W>(ap, i);
    }
  }
  if (g < n - nv * W) {
    const int e = nv * W + g;
    x[e] += alpha * p[e];
    const T re = r[e] - alpha * ap[e];
    r[e] = re;
    acc += (A)re * (A)re;
  }
  A part = block_sum(acc);
  if (!last_block(st, (double)part)) return;
  const T rr = (T)sum_partials<A>(st);
  if (threadIdx.x == 0) {
    st[RR] = (double)rr;
    st[RZOLD] = st[RZ];
    // refresh the true residual on a 64-iteration schedule and whenever the
    // recursion claims convergence; stop at the iteration cap
    const bool claimed = norm_of((double)rr) <= st[ATOL];
    const int k = sti[K] + 1;
    const bool need = claimed || k % REFRESH_EVERY == 0;
    const bool stop = need || k >= sti[MAXITER];
    sti[K] = k;
    sti[REASON] = !stop ? RUNNING : claimed ? CLAIMED : need ? SCHEDULED : CAPPED;
    if (stop) sti[ACTIVE] = 0;
    sti[TICKET] = 0;
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(THREADS) xpby_kernel(T* __restrict__ p, const T* __restrict__ z, int n, double* st) {
  int* sti = reinterpret_cast<int*>(st);
  const int active = sti[ACTIVE];
  // a claimed-but-refuted convergence restarts the direction
  const T beta = sti[REASON] == CLAIMED ? T(0) : (T)st[RZ] / (T)st[RZOLD];
  const int nv = n / W, stride = gridDim.x * THREADS, g = blockIdx.x * THREADS + threadIdx.x;
  int i = g;
  Lanes<T, W> vp, vz;
  if (i < nv) {
    vp = load<T, W>(p, i);
    vz = load<T, W>(z, i);
  }
  if (!active) return;
  while (i < nv) {
#pragma unroll
    for (int j = 0; j < W; ++j) vp.v[j] = vz.v[j] + beta * vp.v[j];
    store<T, W>(p, i, vp);
    i += stride;
    if (i < nv) {
      vp = load<T, W>(p, i);
      vz = load<T, W>(z, i);
    }
  }
  if (g < n - nv * W) p[nv * W + g] = z[nv * W + g] + beta * p[nv * W + g];
}

inline bool aligned(const void* a, const void* b = nullptr, const void* c = nullptr, const void* d = nullptr) {
  return ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d) % 16 == 0;
}

template <typename T>
int dot(const void* a, const void* b, void* st, int n, int grid, int slot, int start, cudaStream_t s) {
  if (aligned(a, b))
    dot_kernel<T, 16 / sizeof(T)><<<grid, THREADS, 0, s>>>((const T*)a, (const T*)b, n, (double*)st, slot, start);
  else
    dot_kernel<T, 1><<<grid, THREADS, 0, s>>>((const T*)a, (const T*)b, n, (double*)st, slot, start);
  return (int)cudaGetLastError();
}

template <typename T>
int step(void* x, void* r, const void* p, const void* ap, void* st, int n, int grid, cudaStream_t s) {
  if (aligned(x, r, p, ap))
    step_kernel<T, 16 / sizeof(T)><<<grid, THREADS, 0, s>>>((T*)x, (T*)r, (const T*)p, (const T*)ap, n,
                                                             (double*)st);
  else
    step_kernel<T, 1><<<grid, THREADS, 0, s>>>((T*)x, (T*)r, (const T*)p, (const T*)ap, n, (double*)st);
  return (int)cudaGetLastError();
}

template <typename T>
int xpby(void* p, const void* z, void* st, int n, int grid, cudaStream_t s) {
  if (aligned(p, z))
    xpby_kernel<T, 16 / sizeof(T)><<<grid, THREADS, 0, s>>>((T*)p, (const T*)z, n, (double*)st);
  else
    xpby_kernel<T, 1><<<grid, THREADS, 0, s>>>((T*)p, (const T*)z, n, (double*)st);
  return (int)cudaGetLastError();
}

template <typename T>
int blocks_per_sm() {
  const void* kernels[] = {(const void*)dot_kernel<T, 16 / sizeof(T)>, (const void*)dot_kernel<T, 1>,
                           (const void*)step_kernel<T, 16 / sizeof(T)>, (const void*)step_kernel<T, 1>,
                           (const void*)xpby_kernel<T, 16 / sizeof(T)>, (const void*)xpby_kernel<T, 1>};
  int least = 1 << 30;
  for (const void* f : kernels) {
    int b = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, f, THREADS, 0) != cudaSuccess) return -1;
    least = b < least ? b : least;
  }
  return least;
}

}  // namespace ntt_cg

extern "C" {

// The grid of every K4 launch on the current device: the SM count times
// ``per_sm`` blocks, or as many of the least occupant kernel as fit on one
// SM if fewer, so that a solve's state holds one partial sum per block.
// Negative on a CUDA error.
int ntt_cg_grid(int per_sm) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  int f32 = ntt_cg::blocks_per_sm<float>(), f64 = ntt_cg::blocks_per_sm<double>();
  if (f32 <= 0 || f64 <= 0) return -1;
  int fit = f32 < f64 ? f32 : f64;
  return sms * (per_sm < fit ? per_sm : fit);
}

// dtype: 0 float32, 1 float64.  Each returns cudaGetLastError() after its
// launch.
int ntt_cg_dot(int dtype, const void* a, const void* b, void* st, int n, int grid, int slot, int start,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? ntt_cg::dot<float>(a, b, st, n, grid, slot, start, s)
                    : ntt_cg::dot<double>(a, b, st, n, grid, slot, start, s);
}

int ntt_cg_step(int dtype, void* x, void* r, const void* p, const void* ap, void* st, int n, int grid,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? ntt_cg::step<float>(x, r, p, ap, st, n, grid, s)
                    : ntt_cg::step<double>(x, r, p, ap, st, n, grid, s);
}

int ntt_cg_xpby(int dtype, void* p, const void* z, void* st, int n, int grid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? ntt_cg::xpby<float>(p, z, st, n, grid, s) : ntt_cg::xpby<double>(p, z, st, n, grid, s);
}

}  // extern "C"
