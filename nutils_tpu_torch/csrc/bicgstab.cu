// K10: right-preconditioned BiCGStab on a state buffer in device memory:
// the vector work, the scalars and every test of the loop.
//
// Replaces nutils_tpu/ops/sparse.py _bicgstab_driver (sparse.py:531), a
// device program of one lax.while_loop, apart from the three matvecs and
// the two preconditioner applies of an iteration, so that the host reads the
// state once a chunk of iterations instead of once an iteration:
//
//   ntt_bicg_dots     st[slot_b] = a . b and, where c is given, st[slot_c] =
//                     a . c (rhat . v; t . t with t . s); ``start``: |b|^2,
//                     rho, |b| as rnorm and lastres, and the entry test
//   ntt_bicg_s        alpha = rho / rv (rv = 1 where |rv| <= eps);
//                     s = r - alpha v
//   ntt_bicg_xr       omega = ts / tt (tt = 1 where tt <= eps);
//                     x += alpha phat + omega shat; r = s - omega t with
//                     r . r and rhat . r; then the claim (sqrt(rr) <= atol)
//                     and the refresh flag (every 64 iterations, or on a
//                     claim), which predicates the refresh's matvec
//   ntt_bicg_refresh  where the refresh flag is set: r = b - A x (A x from
//                     that matvec) with r . r and rhat . r; then the loop's
//                     decisions: the stall (> 0.99 lastres at a refresh),
//                     the breakdown (|rhat . r| <= eps, |omega| <= eps or a
//                     claim), beta, the next rho, k + 1 and the exit test
//                     (rnorm > atol, k < maxiter, stall < 4)
//   ntt_bicg_p        p = r + beta (p - omega v), or on a breakdown p = r
//                     and rhat = r (a restart from the true residual)
//
// The state (ops/bicgstab.py holds the same layout): float64 slots atol,
// rho, rv, alpha, tt, ts, omega, rr, rhor, beta, lastres and rnorm
// (working-dtype values, widened exactly); int32 slots k, maxiter, the
// active and refresh flags, stall, claimed, breakdown, the grid ticket and
// the counts of refreshes, refuted claims and breakdowns; then two partial
// sums per tile.  Every entry returns
// at once while the active flag is clear, so a CUDA graph may hold
// iterations past the exit.  The decisions run in the working dtype with
// one rounding per operation (Num<T>), as the host loop's numpy scalars.
//
// Bound: device memory (2-8 vectors move a launch, a few operations an
// element).  Design: a block owns a tile of the vectors (krylov.cuh), 16
// bytes a load, the first loads issued before the flag's test so the two
// latencies overlap; each reduction is one launch whose last block, found
// by ticket, sums the partials in a fixed order in float64, so the
// iteration counts repeat from run to run.
#include "krylov.cuh"

namespace ntt_bicg {

using namespace ntt_krylov;

// float64 slots
constexpr int ATOL = 0, RHO = 1, RV = 2, ALPHA = 3, TT = 4, TS = 5, OMEGA = 6, RR = 7, RHOR = 8, BETA = 9,
              LASTRES = 10, RNORM = 11, HEAD = 20;
// int32 slots
constexpr int K = 24, MAXITER = 25, ACTIVE = 26, NEED = 27, STALL = 28, CLAIMED = 29, BREAKDOWN = 30, TICKET = 31,
              REFRESHES = 32, REFUTED = 33, BREAKDOWNS = 34;
constexpr int REFRESH_EVERY = 64;

template <typename T>
__device__ __forceinline__ T guard(T v, bool ok) {
  return ok ? v : T(1);
}

template <typename T, bool AL>
__global__ void __launch_bounds__(THREADS) dots_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                                       const T* __restrict__ c, int n, double* st, int slot_b,
                                                       int slot_c, int start) {
  int* sti = reinterpret_cast<int*>(st);
  constexpr int W = Num<T>::W;
  const int active = sti[ACTIVE];
  T va[VPT][W], vb[VPT][W], vc[VPT][W];
#pragma unroll
  for (int q = 0; q < VPT; ++q) {
    load<T, AL>(a, chunk_start<T>(q), n, va[q]);
    load<T, AL>(b, chunk_start<T>(q), n, vb[q]);
    if (c) load<T, AL>(c, chunk_start<T>(q), n, vc[q]);
  }
  if (!active) return;
  double ab = 0.0, ac = 0.0;
#pragma unroll
  for (int q = 0; q < VPT; ++q)
#pragma unroll
    for (int k = 0; k < W; ++k) {
      ab += (double)va[q][k] * (double)vb[q][k];
      if (c) ac += (double)va[q][k] * (double)vc[q][k];
    }
  ab = block_sum(ab);
  if (c) ac = block_sum(ac);
  if (threadIdx.x == 0) {
    st[HEAD + blockIdx.x] = ab;
    st[HEAD + gridDim.x + blockIdx.x] = ac;
  }
  if (!last_block(sti + TICKET, gridDim.x)) return;
  ab = sum_partials(st + HEAD, gridDim.x);
  if (c) ac = sum_partials(st + HEAD + gridDim.x, gridDim.x);
  if (threadIdx.x == 0) {
    const T tab = (T)ab;
    st[slot_b] = (double)tab;
    if (c) st[slot_c] = (double)(T)ac;
    if (start) {
      // rho = |b|^2; the loop's entry test on |b|
      const T rnorm = Num<T>::sqrt(tab);
      st[RHO] = (double)tab;
      st[RNORM] = (double)rnorm;
      st[LASTRES] = (double)rnorm;
      if (!(rnorm > (T)st[ATOL] && sti[K] < sti[MAXITER])) sti[ACTIVE] = 0;
    }
    sti[TICKET] = 0;
  }
}

template <typename T, bool AL>
__global__ void __launch_bounds__(THREADS)
    s_kernel(const T* __restrict__ r, const T* __restrict__ v, T* __restrict__ s, int n, double* st) {
  int* sti = reinterpret_cast<int*>(st);
  constexpr int W = Num<T>::W;
  const int active = sti[ACTIVE];
  const T rv = (T)st[RV], rho = (T)st[RHO];
  T vr[VPT][W], vv[VPT][W];
#pragma unroll
  for (int q = 0; q < VPT; ++q) {
    load<T, AL>(r, chunk_start<T>(q), n, vr[q]);
    load<T, AL>(v, chunk_start<T>(q), n, vv[q]);
  }
  if (!active) return;
  const T alpha = Num<T>::div(rho, guard(rv, Num<T>::abs(rv) > Num<T>::eps()));
#pragma unroll
  for (int q = 0; q < VPT; ++q) {
#pragma unroll
    for (int k = 0; k < W; ++k) vr[q][k] -= alpha * vv[q][k];
    store<T, AL>(s, chunk_start<T>(q), n, vr[q]);
  }
  // no block of this launch reads alpha's slot
  if (blockIdx.x == 0 && threadIdx.x == 0) st[ALPHA] = (double)alpha;
}

template <typename T, bool AL>
__global__ void __launch_bounds__(THREADS)
    xr_kernel(T* __restrict__ x, T* __restrict__ r, const T* __restrict__ phat, const T* __restrict__ shat,
              const T* __restrict__ s, const T* __restrict__ t, const T* __restrict__ rhat, int n, double* st) {
  int* sti = reinterpret_cast<int*>(st);
  constexpr int W = Num<T>::W;
  const int active = sti[ACTIVE];
  const T tt = (T)st[TT], ts = (T)st[TS], alpha = (T)st[ALPHA];
  double rr = 0.0, rhor = 0.0;
  T omega = T(0);
#pragma unroll
  for (int q = 0; q < VPT; ++q) {
    const long e = chunk_start<T>(q);
    T vx[W], vp[W], vs[W], vh[W], vt[W], vr[W];
    load<T, AL>(s, e, n, vs);
    load<T, AL>(t, e, n, vt);
    load<T, AL>(rhat, e, n, vr);
    load<T, AL>(x, e, n, vx);
    load<T, AL>(phat, e, n, vp);
    load<T, AL>(shat, e, n, vh);
    if (q == 0) {
      if (!active) return;
      omega = Num<T>::div(ts, guard(tt, tt > Num<T>::eps()));
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
      vx[k] = vx[k] + alpha * vp[k] + omega * vh[k];
      vs[k] = vs[k] - omega * vt[k];
      rr += (double)vs[k] * (double)vs[k];
      rhor += (double)vr[k] * (double)vs[k];
    }
    store<T, AL>(x, e, n, vx);
    store<T, AL>(r, e, n, vs);
  }
  rr = block_sum(rr);
  rhor = block_sum(rhor);
  if (threadIdx.x == 0) {
    st[HEAD + blockIdx.x] = rr;
    st[HEAD + gridDim.x + blockIdx.x] = rhor;
  }
  if (!last_block(sti + TICKET, gridDim.x)) return;
  rr = sum_partials(st + HEAD, gridDim.x);
  rhor = sum_partials(st + HEAD + gridDim.x, gridDim.x);
  if (threadIdx.x == 0) {
    const T trr = (T)rr;
    st[RR] = (double)trr;
    st[RHOR] = (double)(T)rhor;
    st[OMEGA] = (double)omega;
    // refresh the true residual on a 64-iteration schedule and whenever
    // the recursion claims convergence
    const bool claimed = Num<T>::sqrt(trr) <= (T)st[ATOL];
    sti[CLAIMED] = claimed;
    sti[NEED] = claimed || (sti[K] + 1) % REFRESH_EVERY == 0;
    sti[TICKET] = 0;
  }
}

// The loop's decisions after the refresh (ops/bicgstab.py decide_plain).
template <typename T>
__device__ void decide(double* st, int* sti, bool need) {
  using N = Num<T>;
  const T eps = N::eps();
  const T rr = (T)st[RR];
  const T rnorm = N::sqrt(rr);
  if (need) {
    // stagnating refreshes end the loop
    sti[STALL] = rnorm > N::mul(T(0.99), (T)st[LASTRES]) ? sti[STALL] + 1 : 0;
    st[LASTRES] = (double)rnorm;
  }
  const T rhor = (T)st[RHOR], omega = (T)st[OMEGA], rho = (T)st[RHO], alpha = (T)st[ALPHA];
  // rho/omega breakdown or refuted convergence: restart the recurrence
  // from the true residual
  const bool breakdown = N::abs(rhor) <= eps || N::abs(omega) <= eps || sti[CLAIMED];
  const T beta = N::mul(N::div(rhor, guard(rho, N::abs(rho) > eps)), N::div(alpha, guard(omega, N::abs(omega) > eps)));
  st[BETA] = (double)beta;
  st[RHO] = (double)(breakdown ? rr : rhor);
  st[RNORM] = (double)rnorm;
  sti[BREAKDOWN] = breakdown;
  sti[BREAKDOWNS] += breakdown;
  sti[REFUTED] += sti[CLAIMED] && !(rnorm <= (T)st[ATOL]);
  sti[NEED] = 0;
  const int k = sti[K] + 1;
  sti[K] = k;
  if (!(rnorm > (T)st[ATOL] && k < sti[MAXITER] && sti[STALL] < 4)) sti[ACTIVE] = 0;
}

template <typename T, bool AL>
__global__ void __launch_bounds__(THREADS) refresh_kernel(const T* __restrict__ b, const T* __restrict__ y,
                                                          T* __restrict__ r, const T* __restrict__ rhat, int n,
                                                          double* st) {
  int* sti = reinterpret_cast<int*>(st);
  constexpr int W = Num<T>::W;
  if (!sti[ACTIVE]) return;
  if (!sti[NEED]) {
    // no refresh: the decisions alone; the other blocks have nothing to do
    if (blockIdx.x == 0 && threadIdx.x == 0) decide<T>(st, sti, false);
    return;
  }
  double rr = 0.0, rhor = 0.0;
#pragma unroll
  for (int q = 0; q < VPT; ++q) {
    const long e = chunk_start<T>(q);
    T vb[W], vy[W], vh[W];
    load<T, AL>(b, e, n, vb);
    load<T, AL>(y, e, n, vy);
    load<T, AL>(rhat, e, n, vh);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      vb[k] -= vy[k];
      rr += (double)vb[k] * (double)vb[k];
      rhor += (double)vh[k] * (double)vb[k];
    }
    store<T, AL>(r, e, n, vb);
  }
  rr = block_sum(rr);
  rhor = block_sum(rhor);
  if (threadIdx.x == 0) {
    st[HEAD + blockIdx.x] = rr;
    st[HEAD + gridDim.x + blockIdx.x] = rhor;
  }
  if (!last_block(sti + TICKET, gridDim.x)) return;
  rr = sum_partials(st + HEAD, gridDim.x);
  rhor = sum_partials(st + HEAD + gridDim.x, gridDim.x);
  if (threadIdx.x == 0) {
    st[RR] = (double)(T)rr;
    st[RHOR] = (double)(T)rhor;
    sti[REFRESHES] += 1;
    decide<T>(st, sti, true);
    sti[TICKET] = 0;
  }
}

template <typename T, bool AL>
__global__ void __launch_bounds__(THREADS)
    p_kernel(T* __restrict__ p, const T* __restrict__ r, const T* __restrict__ v, T* __restrict__ rhat, int n,
             const double* st) {
  const int* sti = reinterpret_cast<const int*>(st);
  constexpr int W = Num<T>::W;
  const int active = sti[ACTIVE];
  const bool breakdown = sti[BREAKDOWN];
  const T beta = (T)st[BETA], omega = (T)st[OMEGA];
  T vr[VPT][W];
#pragma unroll
  for (int q = 0; q < VPT; ++q) load<T, AL>(r, chunk_start<T>(q), n, vr[q]);
  if (!active) return;
#pragma unroll
  for (int q = 0; q < VPT; ++q) {
    const long e = chunk_start<T>(q);
    if (breakdown) {
      store<T, AL>(p, e, n, vr[q]);
      store<T, AL>(rhat, e, n, vr[q]);
    } else {
      T vp[W], vv[W];
      load<T, AL>(p, e, n, vp);
      load<T, AL>(v, e, n, vv);
#pragma unroll
      for (int k = 0; k < W; ++k) vp[k] = vr[q][k] + beta * (vp[k] - omega * vv[k]);
      store<T, AL>(p, e, n, vp);
    }
  }
}

template <typename T>
int dots(const void* a, const void* b, const void* c, void* st, int n, int slot_b, int slot_c, int start,
         cudaStream_t s) {
  if (aligned16(a, b, c))
    dots_kernel<T, true><<<tiles<T>(n), THREADS, 0, s>>>((const T*)a, (const T*)b, (const T*)c, n, (double*)st,
                                                         slot_b, slot_c, start);
  else
    dots_kernel<T, false><<<tiles<T>(n), THREADS, 0, s>>>((const T*)a, (const T*)b, (const T*)c, n, (double*)st,
                                                          slot_b, slot_c, start);
  return (int)cudaGetLastError();
}

template <typename T>
int s_update(const void* r, const void* v, void* s_, void* st, int n, cudaStream_t s) {
  if (aligned16(r, v, s_))
    s_kernel<T, true><<<tiles<T>(n), THREADS, 0, s>>>((const T*)r, (const T*)v, (T*)s_, n, (double*)st);
  else
    s_kernel<T, false><<<tiles<T>(n), THREADS, 0, s>>>((const T*)r, (const T*)v, (T*)s_, n, (double*)st);
  return (int)cudaGetLastError();
}

template <typename T>
int xr(void* x, void* r, const void* phat, const void* shat, const void* s_, const void* t, const void* rhat, void* st,
       int n, cudaStream_t s) {
  if (aligned16(x, r, phat, shat, s_, t, rhat))
    xr_kernel<T, true><<<tiles<T>(n), THREADS, 0, s>>>((T*)x, (T*)r, (const T*)phat, (const T*)shat, (const T*)s_,
                                                       (const T*)t, (const T*)rhat, n, (double*)st);
  else
    xr_kernel<T, false><<<tiles<T>(n), THREADS, 0, s>>>((T*)x, (T*)r, (const T*)phat, (const T*)shat, (const T*)s_,
                                                        (const T*)t, (const T*)rhat, n, (double*)st);
  return (int)cudaGetLastError();
}

template <typename T>
int refresh(const void* b, const void* y, void* r, const void* rhat, void* st, int n, cudaStream_t s) {
  if (aligned16(b, y, r, rhat))
    refresh_kernel<T, true><<<tiles<T>(n), THREADS, 0, s>>>((const T*)b, (const T*)y, (T*)r, (const T*)rhat, n,
                                                            (double*)st);
  else
    refresh_kernel<T, false><<<tiles<T>(n), THREADS, 0, s>>>((const T*)b, (const T*)y, (T*)r, (const T*)rhat, n,
                                                             (double*)st);
  return (int)cudaGetLastError();
}

template <typename T>
int p_update(void* p, const void* r, const void* v, void* rhat, const void* st, int n, cudaStream_t s) {
  if (aligned16(p, r, v, rhat))
    p_kernel<T, true><<<tiles<T>(n), THREADS, 0, s>>>((T*)p, (const T*)r, (const T*)v, (T*)rhat, n,
                                                      (const double*)st);
  else
    p_kernel<T, false><<<tiles<T>(n), THREADS, 0, s>>>((T*)p, (const T*)r, (const T*)v, (T*)rhat, n,
                                                       (const double*)st);
  return (int)cudaGetLastError();
}

}  // namespace ntt_bicg

extern "C" {

// dtype: 0 float32, 1 float64; st the state for (n, dtype).  Each returns
// cudaGetLastError() after its launch.
int ntt_bicg_dots(int dtype, const void* a, const void* b, const void* c, void* st, int n, int slot_b, int slot_c,
                  int start, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? ntt_bicg::dots<float>(a, b, c, st, n, slot_b, slot_c, start, s)
                    : ntt_bicg::dots<double>(a, b, c, st, n, slot_b, slot_c, start, s);
}

int ntt_bicg_s(int dtype, const void* r, const void* v, void* s_, void* st, int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? ntt_bicg::s_update<float>(r, v, s_, st, n, s) : ntt_bicg::s_update<double>(r, v, s_, st, n, s);
}

int ntt_bicg_xr(int dtype, void* x, void* r, const void* phat, const void* shat, const void* s_, const void* t,
                const void* rhat, void* st, int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? ntt_bicg::xr<float>(x, r, phat, shat, s_, t, rhat, st, n, s)
                    : ntt_bicg::xr<double>(x, r, phat, shat, s_, t, rhat, st, n, s);
}

int ntt_bicg_refresh(int dtype, const void* b, const void* y, void* r, const void* rhat, void* st, int n,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? ntt_bicg::refresh<float>(b, y, r, rhat, st, n, s)
                    : ntt_bicg::refresh<double>(b, y, r, rhat, st, n, s);
}

int ntt_bicg_p(int dtype, void* p, const void* r, const void* v, void* rhat, const void* st, int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? ntt_bicg::p_update<float>(p, r, v, rhat, st, n, s)
                    : ntt_bicg::p_update<double>(p, r, v, rhat, st, n, s);
}

}  // extern "C"
