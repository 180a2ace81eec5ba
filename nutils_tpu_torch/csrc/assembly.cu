// K11 and K12: the element contractions of the factored assembly, float32 or
// float64.
//
//   K11  V[e, i, j] = sum_q sum_a sum_b Bt[e, q, a, i] K[e, q, a, b] Bs[e, q, b, j]
//   K12  r[e, i]    = sum_q sum_a Bt[e, q, a, i] g[e, q, a]
//
// Replace the element-block contraction of nutils_tpu/solver.py
// System._jacobian_trace (the jvp of the localized gradient over the unit
// seeds, summed over the points, which XLA fuses) and of _residual_trace.
// Bt and Bs are the feature operators of the test and trial dofs (a field's
// value and gradient at each point as a linear map of the element's dofs), g
// and K the gradient and Hessian of the integrand in those features.  Every
// operand comes with its own strides in elements; an element stride of 0 is
// an operator that every element shares.
//
// Bound: on the Navier-Stokes step the operations (Q (A B J + A I J) products
// an element, ~15 GFLOP) and the bytes (K read, V written, ~0.55 GB) are
// both a fraction of a millisecond.  K11 is written for correctness first:
// a thread block takes a group of consecutive elements at a time (as many as
// keep its threads busy, 1 for the velocity block), stages their K (and Bt
// and Bs, unless shared, which a block stages once) in shared memory, forms
// T = K Bs there, and each thread then sums its (i, j) outputs over (q, a)
// in a fixed order, so the results are bitwise reproducible and no atomics
// are used.  K12 takes one thread an output, reading Bt and g from device
// memory (neighbouring threads read neighbouring i), or, where every element
// shares Bt, one thread an element with Bt in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace ntt_asm {

constexpr int THREADS = 256;

struct Str {
  long long e, q, a, l;
};

// G: groups of more than one element (without, the group index of every
// entry is 0 and the kernel skips the divisions that find it)
template <typename T, bool G>
__global__ void __launch_bounds__(THREADS)
    elem_matrix(const T* __restrict__ Bt, const T* __restrict__ K, const T* __restrict__ Bs, T* __restrict__ out,
                int E, int Q, int A, int B, int I, int J, int epb, Str st, Str sk, Str ss) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nBt = Q * A * I, nBs = Q * B * J, nK = Q * A * B, nT = Q * A * J, nO = I * J, QA = Q * A;
  // per element of a group unless shared by every element (stride 0)
  const int mBt = st.e ? epb : 1, mBs = ss.e ? epb : 1;
  T* sBt = reinterpret_cast<T*>(smem_raw);
  T* sBs = sBt + mBt * nBt;
  T* sK = sBs + mBs * nBs;
  T* sT = sK + epb * nK;
  const long long groups = (E + epb - 1) / epb;
  bool staged = false;
  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long e0 = grp * epb;
    const int ne = (int)(E - e0 < epb ? E - e0 : epb);
    if (!staged || st.e != 0)
      for (int t = threadIdx.x; t < (st.e ? ne : 1) * nBt; t += THREADS) {
        int k = G ? t / nBt : 0, r = G ? t % nBt : t, i = r % I;
        r /= I;
        sBt[t] = Bt[(e0 + k) * st.e + (r / A) * st.q + (r % A) * st.a + i * st.l];
      }
    if (!staged || ss.e != 0)
      for (int t = threadIdx.x; t < (ss.e ? ne : 1) * nBs; t += THREADS) {
        int k = G ? t / nBs : 0, r = G ? t % nBs : t, j = r % J;
        r /= J;
        sBs[t] = Bs[(e0 + k) * ss.e + (r / B) * ss.q + (r % B) * ss.a + j * ss.l];
      }
    staged = true;
    for (int t = threadIdx.x; t < ne * nK; t += THREADS) {
      int k = G ? t / nK : 0, r = G ? t % nK : t, b = r % B;
      r /= B;
      sK[t] = K[(e0 + k) * sk.e + (r / A) * sk.q + (r % A) * sk.a + b * sk.l];
    }
    __syncthreads();
    // T[q, a, j] = sum_b K[q, a, b] Bs[q, b, j], each element of the group
    for (int t = threadIdx.x; t < ne * nT; t += THREADS) {
      int k = G ? t / nT : 0, rem = G ? t % nT : t, j = rem % J, r = rem / J;
      const T* kk = sK + k * nK + r * B;
      const T* bs = sBs + (ss.e ? k * nBs : 0) + (r / A) * B * J + j;
      T acc = T(0);
      for (int b = 0; b < B; ++b) acc += kk[b] * bs[b * J];
      sT[t] = acc;
    }
    __syncthreads();
    // V[i, j] = sum_(q, a) Bt[q, a, i] T[q, a, j]
    for (int t = threadIdx.x; t < ne * nO; t += THREADS) {
      int k = G ? t / nO : 0, rem = G ? t % nO : t, j = rem % J, i = rem / J;
      const T* bt = sBt + (st.e ? k * nBt : 0) + i;
      const T* tt = sT + k * nT + j;
      T acc = T(0);
      for (int r = 0; r < QA; ++r) acc += bt[r * I] * tt[r * J];
      out[e0 * nO + t] = acc;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    elem_vector(const T* __restrict__ Bt, const T* __restrict__ g, T* __restrict__ out, int E, int Q, int A, int I,
                Str st, Str sg) {
  long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= (long long)E * I) return;
  long long e = t / I;
  int i = (int)(t % I);
  const T* bt = Bt + e * st.e + i * st.l;
  const T* ge = g + e * sg.e;
  T acc = T(0);
  for (int q = 0; q < Q; ++q)
    for (int a = 0; a < A; ++a) acc += bt[q * st.q + a * st.a] * ge[q * sg.q + a * sg.a];
  out[t] = acc;
}

// K12 where every element shares Bt: Bt staged in shared memory, one thread
// an element, its I <= MAXI outputs in registers, each summed over (q, a) in
// the order above (so both variants give the same bits), g read once
constexpr int MAXI = 32;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    elem_vector_shared(const T* __restrict__ Bt, const T* __restrict__ g, T* __restrict__ out, int E, int Q, int A,
                       int I, Str st, Str sg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sBt = reinterpret_cast<T*>(smem_raw);
  for (int t = threadIdx.x; t < Q * A * I; t += THREADS) {
    int i = t % I, r = t / I;
    sBt[t] = Bt[(r / A) * st.q + (r % A) * st.a + i * st.l];
  }
  __syncthreads();
  long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= E) return;
  const T* ge = g + e * sg.e;
  T acc[MAXI];
#pragma unroll
  for (int i = 0; i < MAXI; ++i) acc[i] = T(0);
  for (int q = 0; q < Q; ++q)
    for (int a = 0; a < A; ++a) {
      const T gv = ge[q * sg.q + a * sg.a];
      const T* b = sBt + (q * A + a) * I;
#pragma unroll
      for (int i = 0; i < MAXI; ++i)
        if (i < I) acc[i] += b[i] * gv;
    }
#pragma unroll
  for (int i = 0; i < MAXI; ++i)
    if (i < I) out[e * I + i] = acc[i];
}

template <typename T>
int launch_matrix(const void* Bt, const void* K, const void* Bs, void* out, int E, int Q, int A, int B, int I,
                  int J, const int64_t* s, cudaStream_t stream) {
  Str st{s[0], s[1], s[2], s[3]}, sk{s[4], s[5], s[6], s[7]}, ss{s[8], s[9], s[10], s[11]};
  // a group of elements a block, enough that small blocks keep the threads
  // busy, as long as the group's slices fit in shared memory
  int epb = 2 * THREADS / (I * J);
  epb = epb < 1 ? 1 : epb > 32 ? 32 : epb;
  auto smem = [&](int n) {
    return (size_t)((st.e ? n : 1) * Q * A * I + (ss.e ? n : 1) * Q * B * J + n * (Q * A * B + Q * A * J)) *
           sizeof(T);
  };
  while (epb > 1 && smem(epb) > 96 * 1024) --epb;
  size_t bytes = smem(epb);
  auto kernel = epb > 1 ? elem_matrix<T, true> : elem_matrix<T, false>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  long long groups = ((long long)E + epb - 1) / epb;
  // operators that every element shares are staged once a block: give each
  // block many groups
  long long cap = (st.e == 0 && ss.e == 0) ? 1056 : 2147483647LL;
  unsigned int grid = (unsigned int)(groups < cap ? groups : cap);
  kernel<<<grid, THREADS, bytes, stream>>>((const T*)Bt, (const T*)K, (const T*)Bs, (T*)out, E, Q, A, B, I, J, epb,
                                           st, sk, ss);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vector(const void* Bt, const void* g, void* out, int E, int Q, int A, int I, const int64_t* s,
                  cudaStream_t stream) {
  Str st{s[0], s[1], s[2], s[3]}, sg{s[4], s[5], s[6], 0};
  size_t bytes = (size_t)Q * A * I * sizeof(T);
  if (st.e == 0 && I <= MAXI && bytes <= 48 * 1024) {
    unsigned int grid = (unsigned int)(((long long)E + THREADS - 1) / THREADS);
    elem_vector_shared<T><<<grid, THREADS, bytes, stream>>>((const T*)Bt, (const T*)g, (T*)out, E, Q, A, I, st, sg);
  } else {
    unsigned int grid = (unsigned int)(((long long)E * I + THREADS - 1) / THREADS);
    elem_vector<T><<<grid, THREADS, 0, stream>>>((const T*)Bt, (const T*)g, (T*)out, E, Q, A, I, st, sg);
  }
  return (int)cudaGetLastError();
}

}  // namespace ntt_asm

extern "C" {

// dtype: 0 float32, 1 float64.  strides: Bt (e, q, a, i), K (e, q, a, b),
// Bs (e, q, b, j), in elements.  Returns cudaGetLastError().
int ntt_elem_matrix(int dtype, const void* Bt, const void* K, const void* Bs, void* out, int E, int Q, int A, int B,
                    int I, int J, const int64_t* strides, void* stream) {
  if (E == 0 || I == 0 || J == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? ntt_asm::launch_matrix<float>(Bt, K, Bs, out, E, Q, A, B, I, J, strides, s)
                    : ntt_asm::launch_matrix<double>(Bt, K, Bs, out, E, Q, A, B, I, J, strides, s);
}

// dtype: 0 float32, 1 float64.  strides: Bt (e, q, a, i), g (e, q, a), in
// elements.  Returns cudaGetLastError().
int ntt_elem_vector(int dtype, const void* Bt, const void* g, void* out, int E, int Q, int A, int I,
                    const int64_t* strides, void* stream) {
  if (E == 0 || I == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? ntt_asm::launch_vector<float>(Bt, g, out, E, Q, A, I, strides, s)
                    : ntt_asm::launch_vector<double>(Bt, g, out, E, Q, A, I, strides, s);
}

}  // extern "C"
