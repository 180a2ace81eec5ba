// K6: restarted GMRES(m) with CGS2 on a state buffer in device memory: the
// Arnoldi vector work, the Givens rotations, the triangular solve and the
// loop's exit tests.
//
// Replaces nutils_tpu/ops/sparse.py _gmres_driver (sparse.py:408), a device
// program of nested lax.while_loops, apart from the matvec and the
// preconditioner, so that the host reads the state once a chunk of Arnoldi
// steps and once a restart cycle instead of once a step:
//
//   ntt_gmres_project   h = V[:j+1] . w into h1 (first CGS2 pass) or h2
//   ntt_gmres_update    w = src - h . V[:j+1]; on the second pass also |w|^2,
//                       and its last block finishes the step: hn = |w|, the
//                       earlier rotations on h = h1 + h2, the new rotation,
//                       R's column j, g, res = |g[j+1]|, j + 1, and the inner
//                       test (j < m and res > inner_tol)
//   ntt_gmres_normalize V[j] = w / max(hn, eps), or 0 where hn <= eps, into
//                       the basis and into a fixed buffer vcur (the next
//                       step's matvec reads vcur: a pointer captured in a
//                       CUDA graph cannot follow j); ``first``: V[0] = z /
//                       max(beta, eps)
//   ntt_gmres_start     beta = |z|, rn = |r|, inner_tol = 0.25 atol
//                       max(beta, eps) / max(rn, eps), g[0] = beta, j = 0 and
//                       the inner flag (a cycle's start)
//   ntt_gmres_residual  r = b - y (r = b where y is null) and |r|; then the
//                       stall test (|r| > 0.999 resnorm), it += j and the
//                       outer test (resnorm > atol, it < maxiter, stall < 5);
//                       ``first``: the loop's entry test alone
//   ntt_gmres_solve_combine  R[:j,:j] y = g[:j] by back-substitution in one
//                       warp (columns j-1 down to 0, staged in shared
//                       memory PANEL columns at a time by the block), then
//                       x += y . V[:j]
//
// The state (ops/gmres.py holds the same layout): float64 slots atol, beta,
// rn, inner_tol, res, resnorm, hn and the last sums of squares ww (|w|^2 or
// |z|^2) and rr (|r|^2) (working-dtype values, widened exactly); int32 slots j, it, stall, the inner and the outer (active)
// flags, the grid ticket, maxiter and the cycle count; then h1 and h2
// (m + 1 each), g (m + 1), cs, sn and y (m each), R (m x m, row-major) and
// the projection's tickets, one a group of ROWS rows, and the partial
// sums, m + 1 per row tile.  The Arnoldi entries run while the
// inner flag is set, the cycle's entries while the outer one is, so a CUDA
// graph may hold steps past the inner loop's exit and a cycle end past the
// outer loop's.  The scalar work runs in the working dtype with one rounding
// per operation (Num<T>), in the host loop's order.
//
// Bound: device memory.  A step reads V[:j+1] four times (the two passes of
// the projection and of the update), w or its source and writes w, V[j+1]
// and vcur: 16 (j + 1) n bytes in float32 and more.  Design: a block owns a
// tile of the vectors (krylov.cuh); the projection holds its tile of w in
// registers and loops over its group of ROWS rows of V (a second grid axis;
// groups above j return at once), RB rows' loads in flight together, each
// row's sum reduced within each warp (no block barrier until the group is
// done), writing one partial sum per row; the last block of a row group
// sums the group's partials; the update
// and the combination accumulate c . V over the rows in registers, RB rows
// at a time, and write their vector once.  Every entry issues its first
// loads before it reads its flag, so the two latencies overlap.
// The row kernels take tiles of ROW_TILE elements (krylov.cuh), so that a
// block holds little in registers and many blocks fill an SM.  Each
// reduction is one launch: the last block to take a ticket (in the
// projection, the last of each row group) sums the partials in a fixed
// order, accumulating in float64, so every sum, and the iteration counts,
// repeat from run to run.
#include "krylov.cuh"

namespace ntt_gmres {

using namespace ntt_krylov;

constexpr int ROWS = 32;  // rows of V a projection block takes
constexpr int RB = 4;     // rows of V whose loads a thread has in flight together
constexpr int PANEL = 8;  // columns of R the back-substitution stages at a time
constexpr int MAX_RESTART = 512;
// float64 slots
constexpr int ATOL = 0, BETA = 1, RN = 2, INNER_TOL = 3, RES = 4, RESNORM = 5, HN = 6, WW = 7, RR = 8, HEAD = 24;
// int32 slots
constexpr int J = 32, IT = 33, STALL = 34, INNER = 35, ACTIVE = 36, TICKET = 37, MAXITER = 38, CYCLES = 39;

struct Layout {
  long h1, h2, g, cs, sn, y, R, tickets, parts;
  __host__ __device__ explicit Layout(int m) {
    h1 = HEAD;
    h2 = h1 + m + 1;
    g = h2 + m + 1;
    cs = g + m + 1;
    sn = cs + m;
    y = sn + m;
    R = y + m;
    tickets = R + (long)m * m;  // the projection's, one a row group (int32 view)
    parts = tickets + (m + ROWS) / ROWS;
  }
};

template <typename T, bool AL>
__global__ void __launch_bounds__(THREADS)
    project_kernel(const T* __restrict__ V, long ld, const T* __restrict__ w, int n, double* st, int m, int second) {
  int* sti = reinterpret_cast<int*>(st);
  constexpr int W = Num<T>::W, NV = Rows<T>::VPT;
  const int inner = sti[INNER], j = sti[J];
  T wv[NV][W];
#pragma unroll
  for (int c = 0; c < NV; ++c) load<T, AL>(w, chunk_start<T, NV>(c), n, wv[c]);
  const int r0 = blockIdx.y * ROWS;
  if (!inner || r0 > j) return;
  const Layout L(m);
  const int ntiles = gridDim.x;
  const int r1 = min(j, r0 + ROWS - 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // each warp's sum of each row, in smem; the block's only barrier is
  // after the last row, so warps run free of each other until then
  __shared__ double warps[ROWS][THREADS / 32];
  // RB rows at a time: their loads in flight together
  for (int i = r0; i <= r1; i += RB) {
    T v[RB][NV][W];
#pragma unroll
    for (int q = 0; q < RB; ++q)
      if (i + q <= r1)
#pragma unroll
        for (int c = 0; c < NV; ++c) load<T, AL>(V + (long)(i + q) * ld, chunk_start<T, NV>(c), n, v[q][c]);
    double acc[RB];
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      acc[q] = 0.0;
      if (i + q <= r1)
#pragma unroll
        for (int c = 0; c < NV; ++c)
#pragma unroll
          for (int k = 0; k < W; ++k) acc[q] += (double)v[q][c][k] * (double)wv[c][k];
    }
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const double sum = warp_sum(acc[q]);
      if (lane == 0 && i + q <= r1) warps[i + q - r0][warp] = sum;
    }
  }
  __syncthreads();
  if (threadIdx.x <= r1 - r0) {
    double part = 0.0;
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k) part += warps[threadIdx.x][k];
    st[L.parts + (long)(r0 + threadIdx.x) * ntiles + blockIdx.x] = part;
    __threadfence();  // last_block fences thread 0's writes alone
  }
  // the last block of this row group sums its rows' partials: warp k the
  // rows r0 + k + 8 q, their loads in flight together, each in a fixed order
  int* ticket = sti + 2 * L.tickets + blockIdx.y;
  if (!last_block(ticket, ntiles)) return;
  double* h = st + (second ? L.h2 : L.h1);
  constexpr int WARPS = THREADS / 32, PER = ROWS / WARPS;
  const int row0 = r0 + warp;
  double acc[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) acc[q] = 0.0;
#pragma unroll 4
  for (int b = lane; b < ntiles; b += 32)
#pragma unroll
    for (int q = 0; q < PER; ++q)
      if (row0 + q * WARPS <= r1) acc[q] += __ldcg(st + L.parts + (long)(row0 + q * WARPS) * ntiles + b);
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const double sum = warp_sum(acc[q]);
    if (lane == 0 && row0 + q * WARPS <= r1) h[row0 + q * WARPS] = (double)(T)sum;
  }
  if (threadIdx.x == 0) *ticket = 0;
}

// acc += sum over rows i0 <= i < i1 of c[i] V[i] for a thread's chunks, the
// rows in increasing order (one fused multiply-add a row and value); RB rows'
// loads in flight together.
template <typename T, bool AL>
__device__ __forceinline__ void accumulate_rows(const T* V, long ld, const T* c, int i0, int i1, int n,
                                                T (&acc)[Rows<T>::VPT][Num<T>::W]) {
  constexpr int W = Num<T>::W, NV = Rows<T>::VPT;
  int i = i0;
  for (; i + RB <= i1; i += RB) {
    T v[RB][NV][W];
#pragma unroll
    for (int q = 0; q < RB; ++q)
#pragma unroll
      for (int k = 0; k < NV; ++k) load<T, AL>(V + (long)(i + q) * ld, chunk_start<T, NV>(k), n, v[q][k]);
#pragma unroll
    for (int q = 0; q < RB; ++q)
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int e = 0; e < W; ++e) acc[k][e] = fma(c[i + q], v[q][k][e], acc[k][e]);
  }
  for (; i < i1; ++i) {
    T v[NV][W];
#pragma unroll
    for (int k = 0; k < NV; ++k) load<T, AL>(V + (long)i * ld, chunk_start<T, NV>(k), n, v[k]);
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int e = 0; e < W; ++e) acc[k][e] = fma(c[i], v[k][e], acc[k][e]);
  }
}

// The step's scalar work in the last block of the second update: the host
// loop's rotations in the working dtype (ops/gmres.py step_scalars).
template <typename T>
__device__ void finish_step(double* st, int* sti, const Layout& L, int j, int m, double ww) {
  using N = Num<T>;
  __shared__ T hs[MAX_RESTART + 1], cs[MAX_RESTART], sn[MAX_RESTART];
  for (int i = threadIdx.x; i <= j; i += THREADS) hs[i] = N::add((T)st[L.h1 + i], (T)st[L.h2 + i]);
  for (int i = threadIdx.x; i < j; i += THREADS) {
    cs[i] = (T)st[L.cs + i];
    sn[i] = (T)st[L.sn + i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const T eps = N::eps();
    const T hn = N::sqrt((T)ww);
    // the earlier rotations; ``carry`` is h[i] as rotated so far
    T carry = hs[0];
    for (int i = 0; i < j; ++i) {
      const T c = cs[i], s = sn[i], next = hs[i + 1];
      hs[i] = N::add(N::mul(c, carry), N::mul(s, next));
      carry = N::add(N::mul(-s, carry), N::mul(c, next));
    }
    // the new rotation annihilating h[j+1] = hn
    const T denom = N::sqrt(N::add(N::mul(carry, carry), N::mul(hn, hn)));
    const T safe = eps > denom ? eps : denom;
    const T c = N::div(carry, safe), s = N::div(hn, safe);
    hs[j] = denom;
    st[L.cs + j] = (double)c;
    st[L.sn + j] = (double)s;
    const T gj = (T)st[L.g + j];
    const T gn = N::mul(-s, gj);
    st[L.g + j + 1] = (double)gn;
    st[L.g + j] = (double)N::mul(c, gj);
    const T res = N::abs(gn);
    st[RES] = (double)res;
    st[HN] = (double)hn;
    sti[J] = j + 1;
    if (!(j + 1 < m && res > (T)st[INNER_TOL])) sti[INNER] = 0;
    sti[TICKET] = 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i <= j; i += THREADS) st[L.R + (long)i * m + j] = (double)hs[i];
}

template <typename T, bool AL>
__global__ void __launch_bounds__(THREADS)
    update_kernel(const T* __restrict__ V, long ld, const T* src, T* w, int n, double* st, int m, int second) {
  int* sti = reinterpret_cast<int*>(st);
  constexpr int W = Num<T>::W, NV = Rows<T>::VPT;
  const int inner = sti[INNER], j = sti[J];
  T s[NV][W];
#pragma unroll
  for (int c = 0; c < NV; ++c) load<T, AL>(src, chunk_start<T, NV>(c), n, s[c]);
  if (!inner) return;
  const Layout L(m);
  __shared__ T hs[MAX_RESTART + 1];
  const double* h = st + (second ? L.h2 : L.h1);
  for (int i = threadIdx.x; i <= j; i += THREADS) hs[i] = (T)h[i];
  __syncthreads();
  T acc[NV][W];
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int k = 0; k < W; ++k) acc[c][k] = T(0);
  // h . V[:j+1], formed first and then subtracted, as the host loop does
  accumulate_rows<T, AL>(V, ld, hs, 0, j + 1, n, acc);
  double ww = 0.0;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      s[c][k] -= acc[c][k];
      ww += (double)s[c][k] * (double)s[c][k];
    }
    store<T, AL>(w, chunk_start<T, NV>(c), n, s[c]);
  }
  if (!second) return;
  const double part = block_sum(ww);
  if (threadIdx.x == 0) st[L.parts + blockIdx.x] = part;
  if (!last_block(sti + TICKET, gridDim.x)) return;
  ww = sum_partials(st + L.parts, gridDim.x);
  if (threadIdx.x == 0) st[WW] = (double)(T)ww;
  finish_step<T>(st, sti, L, j, m, (double)(T)ww);
}

template <typename T, bool AL>
__global__ void __launch_bounds__(THREADS) normalize_kernel(const T* __restrict__ w, T* __restrict__ V, long ld,
                                                            T* __restrict__ vcur, int n, const double* st, int first) {
  const int* sti = reinterpret_cast<const int*>(st);
  constexpr int W = Num<T>::W;
  const long e = ((long)blockIdx.x * THREADS + threadIdx.x) * W;
  // the state's slots and w read together, so their latencies overlap
  const int inner = sti[INNER], j = first ? 0 : sti[J];
  const T hn = (T)st[first ? BETA : HN];
  T v[W];
  load<T, AL>(w, e, n, v);
  if (!inner) return;
  const T eps = Num<T>::eps();
  const T d = eps > hn ? eps : hn;
  const bool zero = !first && !(hn > eps);
#pragma unroll
  for (int k = 0; k < W; ++k) v[k] = zero ? T(0) : Num<T>::div(v[k], d);
  store<T, AL>(V + (long)j * ld, e, n, v);
  store<T, AL>(vcur, e, n, v);
}

template <typename T, bool AL>
__global__ void __launch_bounds__(THREADS)
    start_kernel(const T* __restrict__ z, const T* __restrict__ r, int n, double* st, int m) {
  int* sti = reinterpret_cast<int*>(st);
  constexpr int W = Num<T>::W;
  const int active = sti[ACTIVE];
  T a[VPT][W], b[VPT][W];
#pragma unroll
  for (int c = 0; c < VPT; ++c) {
    load<T, AL>(z, chunk_start<T>(c), n, a[c]);
    load<T, AL>(r, chunk_start<T>(c), n, b[c]);
  }
  if (!active) return;
  const Layout L(m);
  double zz = 0.0, rr = 0.0;
#pragma unroll
  for (int c = 0; c < VPT; ++c)
#pragma unroll
    for (int k = 0; k < W; ++k) {
      zz += (double)a[c][k] * (double)a[c][k];
      rr += (double)b[c][k] * (double)b[c][k];
    }
  zz = block_sum(zz);
  rr = block_sum(rr);
  if (threadIdx.x == 0) {
    st[L.parts + blockIdx.x] = zz;
    st[L.parts + gridDim.x + blockIdx.x] = rr;
  }
  if (!last_block(sti + TICKET, gridDim.x)) return;
  zz = sum_partials(st + L.parts, gridDim.x);
  rr = sum_partials(st + L.parts + gridDim.x, gridDim.x);
  if (threadIdx.x == 0) {
    using N = Num<T>;
    const T eps = N::eps();
    st[WW] = (double)(T)zz;
    st[RR] = (double)(T)rr;
    const T beta = N::sqrt((T)zz), rn = N::sqrt((T)rr);
    const T beta_safe = eps > beta ? eps : beta, rn_safe = eps > rn ? eps : rn;
    // the true-residual tolerance in the preconditioned scale
    const T inner_tol = N::div(N::mul(N::mul(T(0.25), (T)st[ATOL]), beta_safe), rn_safe);
    st[BETA] = (double)beta;
    st[RN] = (double)rn;
    st[INNER_TOL] = (double)inner_tol;
    st[RES] = (double)beta;
    st[L.g] = (double)beta;
    sti[J] = 0;
    sti[INNER] = 0 < m && beta > inner_tol;
    sti[TICKET] = 0;
  }
}

template <typename T, bool AL>
__global__ void __launch_bounds__(THREADS)
    residual_kernel(const T* __restrict__ b, const T* __restrict__ y, T* __restrict__ r, int n, double* st, int m,
                    int first) {
  int* sti = reinterpret_cast<int*>(st);
  constexpr int W = Num<T>::W;
  const int active = sti[ACTIVE];
  T a[VPT][W], q[VPT][W];
#pragma unroll
  for (int c = 0; c < VPT; ++c) {
    load<T, AL>(b, chunk_start<T>(c), n, a[c]);
    if (y) load<T, AL>(y, chunk_start<T>(c), n, q[c]);
  }
  if (!active) return;
  double rr = 0.0;
#pragma unroll
  for (int c = 0; c < VPT; ++c) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (y) a[c][k] -= q[c][k];
      rr += (double)a[c][k] * (double)a[c][k];
    }
    store<T, AL>(r, chunk_start<T>(c), n, a[c]);
  }
  const Layout L(m);
  rr = block_sum(rr);
  if (threadIdx.x == 0) st[L.parts + blockIdx.x] = rr;
  if (!last_block(sti + TICKET, gridDim.x)) return;
  rr = sum_partials(st + L.parts, gridDim.x);
  if (threadIdx.x == 0) {
    using N = Num<T>;
    st[RR] = (double)(T)rr;
    const T resnorm = N::sqrt((T)rr);
    if (!first) {
      // restart cycles that stop reducing the true residual: stalled
      sti[STALL] = resnorm > N::mul(T(0.999), (T)st[RESNORM]) ? sti[STALL] + 1 : 0;
      sti[IT] += sti[J];
      sti[CYCLES] += 1;
    }
    st[RESNORM] = (double)resnorm;
    if (!(resnorm > (T)st[ATOL] && sti[IT] < sti[MAXITER] && sti[STALL] < 5)) {
      sti[ACTIVE] = 0;
      sti[INNER] = 0;
    }
    sti[TICKET] = 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) solve_kernel(double* st, int m) {
  const int* sti = reinterpret_cast<const int*>(st);
  if (!sti[ACTIVE]) return;
  const int j = sti[J];
  using N = Num<T>;
  const Layout L(m);
  __shared__ T s[MAX_RESTART];
  __shared__ T panel[PANEL][MAX_RESTART];
  for (int i = threadIdx.x; i < j; i += THREADS) s[i] = (T)st[L.g + i];
  // columns j-1 down to 0: y[k] = s[k] / R[k][k], then s[:k] -= R[:k, k]
  // y[k]; the block stages PANEL columns of R at a time, one warp solves
  for (int k1 = j - 1; k1 >= 0; k1 -= PANEL) {
    const int k0 = max(0, k1 - PANEL + 1), cols = k1 - k0 + 1;
    __syncthreads();
    for (int e = threadIdx.x; e < (k1 + 1) * cols; e += THREADS) {
      const int i = e / cols, c = e - i * cols;
      panel[c][i] = (T)st[L.R + (long)i * m + k0 + c];
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      for (int k = k1; k >= k0; --k) {
        const T* col = panel[k - k0];
        const T yk = N::div(s[k], col[k]);
        for (int i = lane; i < k; i += 32) s[i] = N::sub(s[i], N::mul(col[i], yk));
        if (lane == 0) st[L.y + k] = (double)yk;
        __syncwarp();
      }
    }
  }
}

template <typename T, bool AL>
__global__ void __launch_bounds__(THREADS)
    combine_kernel(const T* __restrict__ V, long ld, T* __restrict__ x, int n, const double* st, int m) {
  const int* sti = reinterpret_cast<const int*>(st);
  constexpr int W = Num<T>::W, NV = Rows<T>::VPT;
  const int active = sti[ACTIVE], j = sti[J];
  T a[NV][W];
#pragma unroll
  for (int c = 0; c < NV; ++c) load<T, AL>(x, chunk_start<T, NV>(c), n, a[c]);
  if (!active || !j) return;
  const Layout L(m);
  __shared__ T ys[MAX_RESTART];
  for (int i = threadIdx.x; i < j; i += THREADS) ys[i] = (T)st[L.y + i];
  __syncthreads();
  T acc[NV][W];
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int k = 0; k < W; ++k) acc[c][k] = T(0);
  accumulate_rows<T, AL>(V, ld, ys, 0, j, n, acc);
#pragma unroll
  for (int c = 0; c < NV; ++c) {
#pragma unroll
    for (int k = 0; k < W; ++k) a[c][k] += acc[c][k];
    store<T, AL>(x, chunk_start<T, NV>(c), n, a[c]);
  }
}

template <typename T>
bool basis_aligned(const void* V, long long ld) {
  return aligned16(V) && (ld * (long long)sizeof(T)) % 16 == 0;
}

template <typename T>
int project(const void* V, const void* w, void* st, long long ld, int n, int m, int second, cudaStream_t s) {
  const dim3 grid(row_tiles(n), (m + ROWS) / ROWS);
  if (basis_aligned<T>(V, ld) && aligned16(w))
    project_kernel<T, true><<<grid, THREADS, 0, s>>>((const T*)V, ld, (const T*)w, n, (double*)st, m, second);
  else
    project_kernel<T, false><<<grid, THREADS, 0, s>>>((const T*)V, ld, (const T*)w, n, (double*)st, m, second);
  return (int)cudaGetLastError();
}

template <typename T>
int update(const void* V, const void* src, void* w, void* st, long long ld, int n, int m, int second,
           cudaStream_t s) {
  if (basis_aligned<T>(V, ld) && aligned16(src, w))
    update_kernel<T, true><<<row_tiles(n), THREADS, 0, s>>>((const T*)V, ld, (const T*)src, (T*)w, n, (double*)st, m,
                                                          second);
  else
    update_kernel<T, false><<<row_tiles(n), THREADS, 0, s>>>((const T*)V, ld, (const T*)src, (T*)w, n, (double*)st, m,
                                                           second);
  return (int)cudaGetLastError();
}

template <typename T>
int normalize(const void* w, void* V, void* vcur, const void* st, long long ld, int n, int first, cudaStream_t s) {
  const long per = (long)THREADS * Num<T>::W;
  const int grid = (int)((n + per - 1) / per);
  if (basis_aligned<T>(V, ld) && aligned16(w, vcur))
    normalize_kernel<T, true><<<grid, THREADS, 0, s>>>((const T*)w, (T*)V, ld, (T*)vcur, n, (const double*)st, first);
  else
    normalize_kernel<T, false><<<grid, THREADS, 0, s>>>((const T*)w, (T*)V, ld, (T*)vcur, n, (const double*)st,
                                                        first);
  return (int)cudaGetLastError();
}

template <typename T>
int start(const void* z, const void* r, void* st, int n, int m, cudaStream_t s) {
  if (aligned16(z, r))
    start_kernel<T, true><<<tiles<T>(n), THREADS, 0, s>>>((const T*)z, (const T*)r, n, (double*)st, m);
  else
    start_kernel<T, false><<<tiles<T>(n), THREADS, 0, s>>>((const T*)z, (const T*)r, n, (double*)st, m);
  return (int)cudaGetLastError();
}

template <typename T>
int residual(const void* b, const void* y, void* r, void* st, int n, int m, int first, cudaStream_t s) {
  if (aligned16(b, y, r))
    residual_kernel<T, true><<<tiles<T>(n), THREADS, 0, s>>>((const T*)b, (const T*)y, (T*)r, n, (double*)st, m,
                                                             first);
  else
    residual_kernel<T, false><<<tiles<T>(n), THREADS, 0, s>>>((const T*)b, (const T*)y, (T*)r, n, (double*)st, m,
                                                              first);
  return (int)cudaGetLastError();
}

template <typename T>
int solve_combine(const void* V, void* x, void* st, long long ld, int n, int m, cudaStream_t s) {
  solve_kernel<T><<<1, THREADS, 0, s>>>((double*)st, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (basis_aligned<T>(V, ld) && aligned16(x))
    combine_kernel<T, true><<<row_tiles(n), THREADS, 0, s>>>((const T*)V, ld, (T*)x, n, (const double*)st, m);
  else
    combine_kernel<T, false><<<row_tiles(n), THREADS, 0, s>>>((const T*)V, ld, (T*)x, n, (const double*)st, m);
  return (int)cudaGetLastError();
}

}  // namespace ntt_gmres

extern "C" {

// dtype: 0 float32, 1 float64; V is the basis [m + 1, ld] (row stride ld
// elements, n of them used); st the state for (n, m, dtype).  Each returns
// cudaGetLastError() after its launches.
int ntt_gmres_project(int dtype, const void* V, const void* w, void* st, long long ld, int n, int m, int second,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? ntt_gmres::project<float>(V, w, st, ld, n, m, second, s)
                    : ntt_gmres::project<double>(V, w, st, ld, n, m, second, s);
}

int ntt_gmres_update(int dtype, const void* V, const void* src, void* w, void* st, long long ld, int n, int m,
                     int second, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? ntt_gmres::update<float>(V, src, w, st, ld, n, m, second, s)
                    : ntt_gmres::update<double>(V, src, w, st, ld, n, m, second, s);
}

int ntt_gmres_normalize(int dtype, const void* w, void* V, void* vcur, const void* st, long long ld, int n, int first,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? ntt_gmres::normalize<float>(w, V, vcur, st, ld, n, first, s)
                    : ntt_gmres::normalize<double>(w, V, vcur, st, ld, n, first, s);
}

int ntt_gmres_start(int dtype, const void* z, const void* r, void* st, int n, int m, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? ntt_gmres::start<float>(z, r, st, n, m, s) : ntt_gmres::start<double>(z, r, st, n, m, s);
}

int ntt_gmres_residual(int dtype, const void* b, const void* y, void* r, void* st, int n, int m, int first,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? ntt_gmres::residual<float>(b, y, r, st, n, m, first, s)
                    : ntt_gmres::residual<double>(b, y, r, st, n, m, first, s);
}

int ntt_gmres_solve_combine(int dtype, const void* V, void* x, void* st, long long ld, int n, int m, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? ntt_gmres::solve_combine<float>(V, x, st, ld, n, m, s)
                    : ntt_gmres::solve_combine<double>(V, x, st, ld, n, m, s);
}

}  // extern "C"
