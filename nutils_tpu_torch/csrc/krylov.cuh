// Pieces shared by K6 (gmres.cu) and K10 (bicgstab.cu): the tiling of a
// vector over the grid, 16-byte loads, fixed-order block sums, the ticket
// that finds a launch's last block, and the working dtype's arithmetic with
// one rounding per operation.
//
// Tiling: a block owns a tile of THREADS * VPT * W consecutive elements
// (W = 16 / sizeof(T) values a 16-byte chunk; ROW_TILE for the row
// kernels); thread t holds its chunks c = 0 .. VPT-1 at elements tile0 +
// (c * THREADS + t) * W, so a warp's loads of one chunk are 512 contiguous
// bytes.  The grid is the vector's
// tile count, the same for every launch over vectors of one length, so a
// state sized for it holds one partial sum per block.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ntt_krylov {

constexpr int THREADS = 256;
constexpr int VPT = 4;

// The working dtype's arithmetic, one rounding per operation (no fused
// multiply-add), as numpy's scalars of that dtype compute; and the loops'
// eps, finfo(dtype).tiny * 16.
template <typename T>
struct Num;

template <>
struct Num<float> {
  static constexpr int W = 4;
  __device__ static float eps() { return 16.0f * FLT_MIN; }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
  __device__ static float sqrt(float a) { return __fsqrt_rn(a); }
  __device__ static float abs(float a) { return fabsf(a); }
};

template <>
struct Num<double> {
  static constexpr int W = 2;
  __device__ static double eps() { return 16.0 * DBL_MIN; }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
  __device__ static double sqrt(double a) { return __dsqrt_rn(a); }
  __device__ static double abs(double a) { return fabs(a); }
};

template <typename T>
struct alignas(16) Chunk {
  T v[Num<T>::W];
};

template <typename T>
__host__ __device__ constexpr long tile_elems() {
  return (long)THREADS * VPT * Num<T>::W;
}

template <typename T>
inline int tiles(int n) {
  return (int)((n + tile_elems<T>() - 1) / tile_elems<T>());
}

// The element where thread threadIdx.x's chunk c of this block's tile of
// NV chunks a thread starts.
template <typename T, int NV = VPT>
__device__ __forceinline__ long chunk_start(int c) {
  return (long)blockIdx.x * THREADS * NV * Num<T>::W + (long)(c * THREADS + threadIdx.x) * Num<T>::W;
}

// The kernels that loop over the rows of a basis (K6's projection, update
// and combination) take a tile of ROW_TILE elements, Rows<T>::VPT chunks a
// thread, so that a block's registers leave room for many blocks an SM.
constexpr int ROW_TILE = 1024;

template <typename T>
struct Rows {
  static constexpr int VPT = ROW_TILE / (THREADS * Num<T>::W);
};

inline int row_tiles(int n) { return (n + ROW_TILE - 1) / ROW_TILE; }

// The W values of p from element e (zeros past n); one 16-byte load where
// the operands are aligned (AL) and the chunk lies inside.
template <typename T, bool AL>
__device__ __forceinline__ void load(const T* p, long e, long n, T (&v)[Num<T>::W]) {
  constexpr int W = Num<T>::W;
  if (AL && e + W <= n) {
    const Chunk<T> q = *reinterpret_cast<const Chunk<T>*>(p + e);
#pragma unroll
    for (int k = 0; k < W; ++k) v[k] = q.v[k];
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) v[k] = e + k < n ? p[e + k] : T(0);
  }
}

template <typename T, bool AL>
__device__ __forceinline__ void store(T* p, long e, long n, const T (&v)[Num<T>::W]) {
  constexpr int W = Num<T>::W;
  if (AL && e + W <= n) {
    Chunk<T> q;
#pragma unroll
    for (int k = 0; k < W; ++k) q.v[k] = v[k];
    *reinterpret_cast<Chunk<T>*>(p + e) = q;
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (e + k < n) p[e + k] = v[k];
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warps[THREADS / 32];
  __syncthreads();  // an earlier call's readers are done with warps[]
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = v;
  __syncthreads();
  v = threadIdx.x < THREADS / 32 ? warps[threadIdx.x] : 0.0;
  if (threadIdx.x < 32) v = warp_sum(v);
  return v;
}

// After thread 0 has written the block's partial sums: true in every thread
// of the last of ``expected`` blocks to take a ticket, which then sees every
// partial.  Every block has read the state before it takes its ticket, so
// the last block may write it (and resets the ticket).
__device__ __forceinline__ bool last_block(int* ticket, unsigned expected) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(reinterpret_cast<unsigned*>(ticket), 1u) == expected - 1;
  }
  __syncthreads();
  return last;
}

// ``count`` partial sums from p in block order (fixed for a grid); valid in
// thread 0.
__device__ __forceinline__ double sum_partials(const double* p, int count) {
  double acc = 0.0;
  for (int b = threadIdx.x; b < count; b += THREADS) acc += __ldcg(p + b);
  return block_sum(acc);
}

inline bool aligned16(const void* a, const void* b = nullptr, const void* c = nullptr, const void* d = nullptr,
                      const void* e = nullptr, const void* f = nullptr, const void* g = nullptr) {
  return ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d | (uintptr_t)e | (uintptr_t)f | (uintptr_t)g) %
             16 ==
         0;
}

}  // namespace ntt_krylov
