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
// Bound.  K11 reads each distinct operand once and writes V: on the
// Navier-Stokes velocity block (E 108,900, Q 16, A = B 6, I = J 18, one
// operator for test and trial) 1,145 MB, 0.342 ms at 3.35 TB/s, against
// 9.0 GFLOP of fused multiply-adds, 0.135 ms at 67 TFLOP/s: bytes bound
// every block of the ported paths, though the velocity block only by 2.5x,
// so its shared-memory traffic has to stay well below one load a multiply-
// add.
//
// Design of K11 (the plan is chosen on the host by a pure function,
// ops/assembly.py matrix_plan, and passed in as an array of integers):
// - A persistent block walks over groups of G consecutive elements, as
//   many as fit in its share of shared memory (two blocks a
//   multiprocessor).  Their K, Bt and Bs arrive by cp.async in a ring of
//   S = 2 shared-memory stages, so the next group's copies are in flight
//   while the current one computes.  Each operand is copied along its
//   smallest stride: the plan orders its dims by source stride and merges
//   what is contiguous in both source and destination; K, a permuted view
//   of the Hessian [S, E, Q, A_total], is read as one run of (element, q,
//   a) for each b-plane and staged as [b][q][a] an element, so that a run
//   stays a run.  A copy is 16 bytes (cp.async.cg) where the innermost run
//   is contiguous and aligned on both sides, else one value (cp.async.ca);
//   its indices advance by carries and its addresses by precomputed
//   increments, without a division or a multiply for each entry.
// - An operator that every element shares (stride 0) is staged once a
//   block; where Bt and Bs are one tensor (same pointer, shape and
//   strides) it is staged once and read as both.
// - T = K Bs for each (element, q) and then V = Bt^T T for each element
//   are small products computed in registers: a thread owns a tile of up
//   to 4 x 4 outputs and the operands feeding them, so a value loaded from
//   shared memory feeds up to 4 multiply-adds.  T goes to shared memory, V
//   to a shared-memory tile that the block writes out contiguously.
// - Regime "element_lanes" (fewer than 32 tiles an element and 32 elements
//   a group or more: Laplace, the example, NS qp, the triangles' vp, qu,
//   qp): the element is the fastest index of a task, so a warp's lanes
//   take 32 elements; each element's slices lie at odd strides in shared
//   memory (no bank conflicts), or at odd multiples of 16 bytes where that
//   lets an operand of each element go by 16-byte copies.  Regime
//   "tile_lanes" (NS vu, vp, qu, the triangles' vu, elasticity): a warp's
//   lanes take one element's tiles, its elements' slices on 16 bytes and
//   32 / (elements a warp) banks apart.
// - Every output is summed in one fixed order: T[q, a, j] over b ascending
//   from 0, then V[i, j] over r = (q, a) ascending from 0, each step one
//   fused multiply-add (fmaf / fma).  An element's outputs depend on its own
//   operands alone, never on its group, chunk or plan, so two launches, two
//   plans, and a chunked and an unchunked assembly give the same bits.  No
//   tensor cores.
//
// K12 (redesigned from one thread an output reading device memory): the
// same machinery as K11 with g in the place of T.  Bound: bytes.  On the
// Navier-Stokes velocity residual (E 108,900, Q 16, A 6, I 18, float32, Bt
// per element) it reads Bt once (753 MB) and g once (42 MB): 0.240 ms at
// 3.35 TB/s against 0.006 ms of multiply-adds.  Design (the plan is
// ops/assembly.py vector_plan, an array of integers as K11's):
// - Persistent blocks walk over groups of G consecutive elements.  Each
//   group's g, and its Bt where Bt is per element, arrive by cp.async in a
//   ring of two stages (stage_copy, with K11's copies: 16 bytes where the
//   innermost run is contiguous and aligned, else one value), so the next
//   group's copies are in flight while the current one computes; a Bt that
//   every element shares is staged once a block.  One block a
//   multiprocessor where Bt is per element, two where it is shared, at
//   least 256 threads (more threads issue the copies), about four groups a
//   multiprocessor or more.  A TMA bulk copy was not tried: only the
//   per-element Bt is a contiguous slab, and it already goes by 16-byte
//   copies.
// - A thread owns a register tile of up to 4 outputs r[k, i..i+3] of one
//   element, or, where every element shares Bt, of 4 elements (a broadcast
//   value of Bt then feeds 4 fused multiply-adds: with one element a tile
//   the shared-memory loads, not the copies, held the triangle step and
//   elasticity).  Regime "element_lanes" (fewer than 32 tiles an element
//   and a group of 32 elements or more: every path but the Navier-Stokes
//   velocity residual): a warp's lanes take 32 elements, whose slices lie
//   at odd strides in shared memory, or at odd multiples of 16 bytes where
//   an operand goes by 16-byte copies and is read 16 bytes a lane (Bt's
//   rows of outputs, g's runs of r = (q, a)); "tile_lanes": a warp's lanes
//   take an element's tiles.  The group's G x I outputs go through shared
//   memory and out contiguously.
// - Each output is one chain of fused multiply-adds over r = (q, a)
//   ascending from 0, starting from 0: the order of the kernel it replaced,
//   whose acc += b * g nvcc contracted to the same fused multiply-adds, so
//   the outputs keep that kernel's bits (the sha1 of every path's residual
//   in chip_smoke.py --only kernels turns against it).
// On an NVIDIA H100 80GB HBM3 at 700 W it runs at 80-85% of its bound
// where Bt is per element, 63% on elasticity; the pressure residuals and
// the triangles' velocity one read a slice of 1 or 6 of 14 features a
// point of g, whose copies alone take most of their time
// (kernel_plan_sweep.py --k12, probe k12_copies_only).
// The generic kernel (elem_vector, one thread an output, the same order and
// bits) stays for operands whose one element does not fit in shared memory
// in two stages (vector_plan's regime "generic": Q * A * I above about
// 14,000 values in float64), which no path of the port has
// (chip_smoke.py asserts it).
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <utility>
#include <vector>

namespace ntt_asm {

constexpr int THREADS = 256;

struct Str {
  long long e, q, a, l;
};

// ------------------------------------------------------------------ K11

constexpr int MAX_THREADS = 512;

// one operand's copy of a group into shared memory: up to 4 dims, outermost
// first, each with its extent, source and destination stride (in values; the
// innermost counted in copies of `vec` values); `kd` names the element dim
// (its extent clipped to the group's elements), -1 for a shared operator;
// `se` is the source's element stride
struct Copy {
  long long s[4];
  long long se;
  int n[4], d[4];
  int kd, vec;
};

// the plan (ops/assembly.py matrix_plan, packed in the order of PLAN_FIELDS)
struct Plan {
  int G, NT, S, kfast;
  int ti, tj, ta, tjt;       // tiles of V (ti x tj) and of T (ta x tjt)
  int nBt, nBs, nK, nT, nV;  // an element's stride in each region (values)
  int oBt, oBs, oK;          // offsets in a stage, or in the shared region
  int oStage, stage, oT, oV; // the ring's offset and a stage's size; T and V
  int shBt, shBs;            // staged once a block (a shared operator)
  Copy cBt, cBs, cK;         // cBs.n[0] == 0 where Bs is Bt
};

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issue one operand's copies for a group of `ne` elements (src at its first
// element): thread t takes the flat indices t, t + NT, ..., split into its 4
// dims once; each step adds NT's own digits, carrying, and moves the source
// and destination by precomputed increments (no division, no multiply).
template <typename T>
__device__ __forceinline__ void stage_copy(T* dst, const T* src, const Copy& c, int ne, int NT) {
  int n0 = c.n[0], n1 = c.n[1], n2 = c.n[2], n3 = c.n[3];
  if (c.kd == 0) n0 = ne;
  else if (c.kd == 1) n1 = ne;
  else if (c.kd == 2) n2 = ne;
  else if (c.kd == 3) n3 = ne;
  const int total = n0 * n1 * n2 * n3;
  if ((int)threadIdx.x >= total) return;
  int r = threadIdx.x;
  int i3 = r % n3;
  r /= n3;
  int i2 = r % n2;
  r /= n2;
  int i1 = r % n1, i0 = r / n1;
  r = NT;
  const int s3 = r % n3;
  r /= n3;
  const int s2 = r % n2;
  r /= n2;
  const int s1 = r % n1, s0 = r / n1;
  const T* g = src + i0 * c.s[0] + i1 * c.s[1] + i2 * c.s[2] + i3 * c.s[3];
  T* sm = dst + i0 * c.d[0] + i1 * c.d[1] + i2 * c.d[2] + i3 * c.d[3];
  // a step, and the corrections of a carry out of dims 3, 2 and 1
  const long long step = s0 * c.s[0] + s1 * c.s[1] + s2 * c.s[2] + s3 * c.s[3];
  const long long w3 = c.s[2] - n3 * c.s[3], w2 = c.s[1] - n2 * c.s[2], w1 = c.s[0] - n1 * c.s[1];
  const int dstep = s0 * c.d[0] + s1 * c.d[1] + s2 * c.d[2] + s3 * c.d[3];
  const int v3 = c.d[2] - n3 * c.d[3], v2 = c.d[1] - n2 * c.d[2], v1 = c.d[0] - n1 * c.d[1];
  const int bytes = c.vec * (int)sizeof(T);
  for (int idx = threadIdx.x; idx < total; idx += NT) {
    cp_async(sm, g, bytes);
    g += step;
    sm += dstep;
    i3 += s3;
    if (i3 >= n3) i3 -= n3, ++i2, g += w3, sm += v3;
    i2 += s2;
    if (i2 >= n2) i2 -= n2, ++i1, g += w2, sm += v2;
    i1 += s1;
    if (i1 >= n1) i1 -= n1, g += w1, sm += v1;
  }
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return fma(a, b, c); }

// four consecutive values from shared memory on 16 bytes, by 16-byte loads
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 a = reinterpret_cast<const double2*>(p)[0], b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

// C[m, n] = sum_p X[p ldx + m] Y[p ldy + n] for the tile m0 <= m < m0 + TM,
// n0 <= n < n0 + TN (written where inside M x N), p ascending from 0, each
// step one fused multiply-add from 0.  A tile that runs past M or N reads
// the values after its row (the next row, or the next region of shared
// memory: never past its end) into outputs it does not write.  VX, VY: a
// row of 4 is read by 16-byte loads (its start on 16 bytes).
template <typename T, int TM, int TN, bool VX, bool VY>
__device__ __forceinline__ void tile_product(const T* __restrict__ X, int ldx, const T* __restrict__ Y, int ldy,
                                             int P, int m0, int n0, int M, int N, T* __restrict__ C, int ldc) {
  T acc[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc[a][b] = T(0);
  const T* xp = X + m0;
  const T* yp = Y + n0;
#pragma unroll 4
  for (int p = 0; p < P; ++p, xp += ldx, yp += ldy) {
    T x[TM], y[TN];
    if constexpr (VX) {
      load4(xp, x);
    } else {
#pragma unroll
      for (int a = 0; a < TM; ++a) x[a] = xp[a];
    }
    if constexpr (VY) {
      load4(yp, y);
    } else {
#pragma unroll
      for (int b = 0; b < TN; ++b) y[b] = yp[b];
    }
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b) acc[a][b] = fma_rn(x[a], y[b], acc[a][b]);
  }
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b)
      if (m0 + a < M && n0 + b < N) C[(m0 + a) * ldc + n0 + b] = acc[a][b];
}

// tile_product with 16-byte loads of the rows of 4 that allow them (vx, vy:
// uniform over the block)
template <typename T, int TM, int TN>
__device__ __forceinline__ void tile(bool vx, bool vy, const T* X, int ldx, const T* Y, int ldy, int P, int m0,
                                     int n0, int M, int N, T* C, int ldc) {
  if constexpr (TM == 4 && TN == 4) {
    if (vx && vy) return tile_product<T, 4, 4, true, true>(X, ldx, Y, ldy, P, m0, n0, M, N, C, ldc);
    if (vy) return tile_product<T, 4, 4, false, true>(X, ldx, Y, ldy, P, m0, n0, M, N, C, ldc);
    if (vx) return tile_product<T, 4, 4, true, false>(X, ldx, Y, ldy, P, m0, n0, M, N, C, ldc);
  } else if constexpr (TM == 4) {
    if (vx) return tile_product<T, 4, TN, true, false>(X, ldx, Y, ldy, P, m0, n0, M, N, C, ldc);
  } else if constexpr (TN == 4) {
    if (vy) return tile_product<T, TM, 4, false, true>(X, ldx, Y, ldy, P, m0, n0, M, N, C, ldc);
  }
  tile_product<T, TM, TN, false, false>(X, ldx, Y, ldy, P, m0, n0, M, N, C, ldc);
}

// values of T in 16 bytes: a row of 4 starting at a multiple of it (in a
// region on 16 bytes) is on 16 bytes
template <typename T>
constexpr int W16 = 16 / (int)sizeof(T);

// T[k, q, a, j] = sum_b K[k, q, a, b] Bs[k, q, b, j] for the group's ne
// elements (K staged as [k][b][q][a]); task (k, q, a-tile, j-tile), k
// fastest where kfast
template <typename T, int TM, int TN>
__device__ void phase_T(const Plan& p, const T* sK, const T* sBs, T* sT, int ne, int Q, int A, int B, int J) {
  const int mt = (A + TM - 1) / TM, nt = (J + TN - 1) / TN, per = Q * mt * nt;
  const int bstride = p.shBs ? 0 : p.nBs;
  const bool vx = A % W16<T> == 0 && p.nK % W16<T> == 0, vy = J % W16<T> == 0 && bstride % W16<T> == 0;
  for (int t = threadIdx.x; t < p.G * per; t += p.NT) {
    int k, rest;
    if (p.kfast) {
      k = t % p.G;
      rest = t / p.G;
    } else {
      k = t / per;
      rest = t % per;
    }
    if (k >= ne) continue;
    const int jt = rest % nt;
    rest /= nt;
    const int at = rest % mt, q = rest / mt;
    tile<T, TM, TN>(vx, vy, sK + k * p.nK + q * A, Q * A, sBs + k * bstride + q * B * J, J, B, at * TM, jt * TN, A,
                    J, sT + k * p.nT + q * A * J, J);
  }
}

// V[k, i, j] = sum_(q, a) Bt[k, q, a, i] T[k, q, a, j]; task (k, i-tile,
// j-tile), k fastest where kfast
template <typename T, int TM, int TN>
__device__ void phase_V(const Plan& p, const T* sBt, const T* sT, T* sV, int ne, int QA, int I, int J) {
  const int mt = (I + TM - 1) / TM, nt = (J + TN - 1) / TN, per = mt * nt;
  const int tstride = p.shBt ? 0 : p.nBt;
  const bool vx = I % W16<T> == 0 && tstride % W16<T> == 0, vy = J % W16<T> == 0 && p.nT % W16<T> == 0;
  for (int t = threadIdx.x; t < p.G * per; t += p.NT) {
    int k, rest;
    if (p.kfast) {
      k = t % p.G;
      rest = t / p.G;
    } else {
      k = t / per;
      rest = t % per;
    }
    if (k >= ne) continue;
    const int jt = rest % nt, it = rest / nt;
    tile<T, TM, TN>(vx, vy, sBt + k * tstride, I, sT + k * p.nT, J, QA, it * TM, jt * TN, I, J, sV + k * p.nV, J);
  }
}

// The group's ne rows of n values (staged at element stride ns) are
// contiguous in out: neighbouring threads write neighbouring values.
template <typename T>
__device__ __forceinline__ void write_rows(T* __restrict__ og, const T* sv, int ns, int n, int ne, int NT) {
  int k = threadIdx.x / n, x = threadIdx.x % n;
  const int dk = NT / n, dx = NT % n;
  for (int f = threadIdx.x; f < ne * n; f += NT) {
    og[f] = sv[k * ns + x];
    x += dx;
    const int carry = x >= n;
    x -= carry ? n : 0;
    k += dk + carry;
  }
}

#define NTT_TILES(X) \
  X(1, 1) X(1, 2) X(1, 3) X(1, 4) X(2, 1) X(2, 2) X(2, 3) X(2, 4) X(3, 1) X(3, 2) X(3, 3) X(3, 4) X(4, 1) X(4, 2) X(4, 3) X(4, 4)

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    elem_matrix(const T* __restrict__ Bt, const T* __restrict__ K, const T* __restrict__ Bs, T* __restrict__ out,
                int E, int Q, int A, int B, int I, int J, const __grid_constant__ Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const long long groups = ((long long)E + p.G - 1) / p.G;
  const int IJ = I * J;
  auto issue = [&](long long grp, int slot) {
    const long long e0 = grp * p.G;
    const int ne = (int)(E - e0 < p.G ? E - e0 : p.G);
    T* st = sm + p.oStage + slot * p.stage;
    if (!p.shBt) stage_copy(st + p.oBt, Bt + e0 * p.cBt.se, p.cBt, ne, p.NT);
    if (!p.shBs) stage_copy(st + p.oBs, Bs + e0 * p.cBs.se, p.cBs, ne, p.NT);
    stage_copy(st + p.oK, K + e0 * p.cK.se, p.cK, ne, p.NT);
  };
  // operators that every element shares go with the first group's copies
  if (p.shBt) stage_copy(sm + p.oBt, Bt, p.cBt, 1, p.NT);
  if (p.shBs) stage_copy(sm + p.oBs, Bs, p.cBs, 1, p.NT);
  for (int s = 0; s < p.S - 1; ++s) {
    const long long grp = blockIdx.x + (long long)s * gridDim.x;
    if (grp < groups) issue(grp, s);
    cp_commit();
  }
  for (long long it = 0;; ++it) {
    const long long grp = blockIdx.x + it * gridDim.x;
    if (grp >= groups) break;
    const long long nxt = grp + (long long)(p.S - 1) * gridDim.x;
    if (nxt < groups) issue(nxt, (int)((it + p.S - 1) % p.S));
    cp_commit();
    cp_wait(p.S - 1);  // this group's copies have landed (this thread's) ...
    __syncthreads();   // ... and every thread's
    const long long e0 = grp * p.G;
    const int ne = (int)(E - e0 < p.G ? E - e0 : p.G);
    const T* st = sm + p.oStage + (int)(it % p.S) * p.stage;
    const T* sBt = p.shBt ? sm + p.oBt : st + p.oBt;
    const T* sBs = p.shBs ? sm + p.oBs : st + p.oBs;
    T* sT = sm + p.oT;
    T* sV = sm + p.oV;
    switch (p.ta * 8 + p.tjt) {
#define NTT_CASE(a, b)                                       \
  case a * 8 + b:                                            \
    phase_T<T, a, b>(p, st + p.oK, sBs, sT, ne, Q, A, B, J); \
    break;
      NTT_TILES(NTT_CASE)
#undef NTT_CASE
    }
    __syncthreads();
    switch (p.ti * 8 + p.tj) {
#define NTT_CASE(a, b)                                 \
  case a * 8 + b:                                      \
    phase_V<T, a, b>(p, sBt, sT, sV, ne, Q * A, I, J); \
    break;
      NTT_TILES(NTT_CASE)
#undef NTT_CASE
    }
    __syncthreads();
    write_rows(out + e0 * IJ, sV, p.nV, IJ, ne, p.NT);
  }
}

#undef NTT_TILES

// ------------------------------------------------------------------ K12

// the plan (ops/assembly.py vector_plan, packed in the order of VECTOR_FIELDS)
struct VPlan {
  int G, NT, S, kfast, ti, te;
  int nBt, ng, nr;            // an element's stride in each region (values)
  int oBt, og, oStage, stage; // offsets in a stage (or the shared region); the ring
  int oR, shBt;               // the outputs' region; Bt staged once a block
  Copy cBt, cg;
};

// W16<T> consecutive values from shared memory on 16 bytes, by one 16-byte
// load
__device__ __forceinline__ void load16(const float* p, float* v) { load4(p, v); }
__device__ __forceinline__ void load16(const double* p, double* v) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  v[0] = a.x, v[1] = a.y;
}

// acc[e][a] (+)= sum_r X[r ldx + a] y_e[r] over TE elements' columns y_e =
// Y + e ys, r ascending from 0, each step one fused multiply-add; VX: a row
// of 4 read by 16-byte loads; VR: each y_e read W16 values of r at a time
// (its start on 16 bytes, P a multiple of W16)
template <typename T, int TM, int TE, bool VX, bool VR>
__device__ __forceinline__ void columns(const T* __restrict__ X, int ldx, const T* __restrict__ Y, int ys, int P,
                                        T (&acc)[TE][TM]) {
  constexpr int W = VR ? W16<T> : 1;
#pragma unroll 2
  for (int r0 = 0; r0 < P; r0 += W, X += W * ldx) {
    T y[TE][W];
#pragma unroll
    for (int e = 0; e < TE; ++e) {
      if constexpr (VR)
        load16(Y + e * ys + r0, y[e]);
      else
        y[e][0] = Y[e * ys + r0];
    }
#pragma unroll
    for (int u = 0; u < W; ++u) {
      T x[TM];
      if constexpr (VX) {
        load4(X + u * ldx, x);
      } else {
#pragma unroll
        for (int a = 0; a < TM; ++a) x[a] = X[u * ldx + a];
      }
#pragma unroll
      for (int e = 0; e < TE; ++e)
#pragma unroll
        for (int a = 0; a < TM; ++a) acc[e][a] = fma_rn(x[a], y[e][u], acc[e][a]);
    }
  }
}

// A register tile of TM outputs r[k, m0 ..] of TE elements k = kb, kb +
// gs, ...: each one chain of fused multiply-adds over (q, a) ascending
// from 0.  A tile that runs past I reads the values after its row (inside
// shared memory) into outputs it does not write.
template <typename T, int TM, int TE>
__device__ __forceinline__ void vector_tile(bool vx, bool vr, const T* X, int I, const T* Y, int ys, int QA, int m0,
                                            int kb, int gs, int ne, T* sR, int nr) {
  T acc[TE][TM];
#pragma unroll
  for (int e = 0; e < TE; ++e)
#pragma unroll
    for (int a = 0; a < TM; ++a) acc[e][a] = T(0);
  if constexpr (TM == 4) {
    if (vx && vr)
      columns<T, TM, TE, true, true>(X + m0, I, Y, ys, QA, acc);
    else if (vx)
      columns<T, TM, TE, true, false>(X + m0, I, Y, ys, QA, acc);
    else if (vr)
      columns<T, TM, TE, false, true>(X + m0, I, Y, ys, QA, acc);
    else
      columns<T, TM, TE, false, false>(X + m0, I, Y, ys, QA, acc);
  } else {
    if (vr)
      columns<T, TM, TE, false, true>(X + m0, I, Y, ys, QA, acc);
    else
      columns<T, TM, TE, false, false>(X + m0, I, Y, ys, QA, acc);
  }
#pragma unroll
  for (int e = 0; e < TE; ++e)
#pragma unroll
    for (int a = 0; a < TM; ++a)
      if (kb + e * gs < ne && m0 + a < I) sR[(kb + e * gs) * nr + m0 + a] = acc[e][a];
}

// r[k, i] = sum_(q, a) Bt[k, q, a, i] g[k, q, a] for the group's ne
// elements; task (kb, i-tile), kb fastest where kfast, its register tile
// the elements kb, kb + G / TE, ... (TE > 1 where every element shares Bt,
// in element lanes: a value of Bt, one address for the whole warp, feeds TE
// fused multiply-adds, and the lanes read neighbouring elements' g)
template <typename T, int TM, int TE>
__device__ void phase_r(const VPlan& p, const T* sBt, const T* sg, T* sR, int ne, int QA, int I) {
  const int mt = (I + TM - 1) / TM, GB = p.G / TE;
  const int bstride = p.shBt ? 0 : p.nBt;
  const bool vx = I % W16<T> == 0 && bstride % W16<T> == 0;
  const bool vr = QA % W16<T> == 0 && p.ng % W16<T> == 0;
  for (int t = threadIdx.x; t < GB * mt; t += p.NT) {
    int kb, it;
    if (p.kfast) {
      kb = t % GB;
      it = t / GB;
    } else {
      kb = t / mt;
      it = t % mt;
    }
    if (kb >= ne) continue;
    vector_tile<T, TM, TE>(vx, vr, sBt + kb * bstride, I, sg + kb * p.ng, GB * p.ng, QA, it * TM, kb, GB, ne, sR,
                           p.nr);
  }
}

template <typename T, int TM>
__device__ __forceinline__ void phase_vector(const VPlan& p, const T* sBt, const T* sg, T* sR, int ne, int QA, int I) {
  if (p.te == 4)
    phase_r<T, TM, 4>(p, sBt, sg, sR, ne, QA, I);
  else
    phase_r<T, TM, 1>(p, sBt, sg, sR, ne, QA, I);
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    elem_vector_staged(const T* __restrict__ Bt, const T* __restrict__ g, T* __restrict__ out, int E, int Q, int A,
                       int I, const __grid_constant__ VPlan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const long long groups = ((long long)E + p.G - 1) / p.G;
  auto issue = [&](long long grp, int slot) {
    const long long e0 = grp * p.G;
    const int ne = (int)(E - e0 < p.G ? E - e0 : p.G);
    T* st = sm + p.oStage + slot * p.stage;
    if (!p.shBt) stage_copy(st + p.oBt, Bt + e0 * p.cBt.se, p.cBt, ne, p.NT);
    stage_copy(st + p.og, g + e0 * p.cg.se, p.cg, ne, p.NT);
  };
  // an operator that every element shares goes with the first group's copies
  if (p.shBt) stage_copy(sm + p.oBt, Bt, p.cBt, 1, p.NT);
  for (int s = 0; s < p.S - 1; ++s) {
    const long long grp = blockIdx.x + (long long)s * gridDim.x;
    if (grp < groups) issue(grp, s);
    cp_commit();
  }
  for (long long it = 0;; ++it) {
    const long long grp = blockIdx.x + it * gridDim.x;
    if (grp >= groups) break;
    const long long nxt = grp + (long long)(p.S - 1) * gridDim.x;
    if (nxt < groups) issue(nxt, (int)((it + p.S - 1) % p.S));
    cp_commit();
    cp_wait(p.S - 1);  // this group's copies have landed (this thread's) ...
    __syncthreads();   // ... and every thread's
    const long long e0 = grp * p.G;
    const int ne = (int)(E - e0 < p.G ? E - e0 : p.G);
    const T* st = sm + p.oStage + (int)(it % p.S) * p.stage;
    const T* sBt = p.shBt ? sm + p.oBt : st + p.oBt;
    T* sR = sm + p.oR;
    switch (p.ti) {
      case 1: phase_vector<T, 1>(p, sBt, st + p.og, sR, ne, Q * A, I); break;
      case 2: phase_vector<T, 2>(p, sBt, st + p.og, sR, ne, Q * A, I); break;
      case 3: phase_vector<T, 3>(p, sBt, st + p.og, sR, ne, Q * A, I); break;
      default: phase_vector<T, 4>(p, sBt, st + p.og, sR, ne, Q * A, I); break;
    }
    __syncthreads();
    write_rows(out + e0 * I, sR, p.nr, I, ne, p.NT);
  }
}

// K12's generic kernel, for operands that vector_plan refuses: one thread an
// output, reading Bt and g from device memory, the same chain of fused
// multiply-adds
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
    for (int a = 0; a < A; ++a) acc = fma_rn(bt[q * st.q + a * st.a], ge[q * sg.q + a * sg.a], acc);
  out[t] = acc;
}

// The blocks of `kernel` resident at once on the current device for a
// launch of `threads` and `bytes` of shared memory, queried once for each
// (kernel, device, threads, bytes) and then kept; the kernel may take the
// device's whole opt-in shared memory, set once a kernel and device.
inline int resident_blocks(const void* kernel, int threads, size_t bytes, long long* resident) {
  struct Seen {
    const void* kernel;
    int dev, threads;
    size_t bytes;
    long long resident;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  static std::vector<std::pair<const void*, int>> opted;  // (kernel, device) whose limit is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mu);
  for (const Seen& s : seen)
    if (s.kernel == kernel && s.dev == dev && s.threads == threads && s.bytes == bytes)
      return *resident = s.resident, 0;
  int sms = 0, optin = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  bool set = false;
  for (const auto& o : opted) set = set || (o.first == kernel && o.second == dev);
  if (err == cudaSuccess && !set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess) opted.emplace_back(kernel, dev);
  }
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  seen.push_back({kernel, dev, threads, bytes, (long long)per_sm * sms});
  *resident = seen.back().resident;
  return 0;
}

template <typename T>
int launch_matrix(const void* Bt, const void* K, const void* Bs, void* out, int E, int Q, int A, int B, int I,
                  int J, const int64_t* v, cudaStream_t stream) {
  Plan p;
  int at = 0;
  auto next = [&]() { return (int)v[at++]; };
  p.G = next(), p.NT = next(), p.S = next(), p.kfast = next();
  p.ti = next(), p.tj = next(), p.ta = next(), p.tjt = next();
  p.nBt = next(), p.nBs = next(), p.nK = next(), p.nT = next(), p.nV = next();
  p.oBt = next(), p.oBs = next(), p.oK = next(), p.oStage = next(), p.stage = next(), p.oT = next(), p.oV = next();
  p.shBt = next(), p.shBs = next();
  const size_t bytes = (size_t)v[at++];
  Copy* copies[3] = {&p.cBt, &p.cBs, &p.cK};
  for (Copy* c : copies) {
    for (int d = 0; d < 4; ++d) c->s[d] = v[at++];
    c->se = v[at++];
    for (int d = 0; d < 4; ++d) c->n[d] = next();
    for (int d = 0; d < 4; ++d) c->d[d] = next();
    c->kd = next(), c->vec = next();
  }
  // persistent blocks: as many as are resident at once, at most a group each
  long long resident = 0;
  const int err = resident_blocks((const void*)elem_matrix<T>, p.NT, bytes, &resident);
  if (err != cudaSuccess) return err;
  const long long groups = ((long long)E + p.G - 1) / p.G;
  const unsigned int grid = (unsigned int)(groups < resident ? groups : resident);
  elem_matrix<T><<<grid, p.NT, bytes, stream>>>((const T*)Bt, (const T*)K, (const T*)Bs, (T*)out, E, Q, A, B, I, J, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vector(const void* Bt, const void* g, void* out, int E, int Q, int A, int I, const int64_t* s,
                  const int64_t* v, cudaStream_t stream) {
  if (v == nullptr) {
    const Str st{s[0], s[1], s[2], s[3]}, sg{s[4], s[5], s[6], 0};
    const unsigned int grid = (unsigned int)(((long long)E * I + THREADS - 1) / THREADS);
    elem_vector<T><<<grid, THREADS, 0, stream>>>((const T*)Bt, (const T*)g, (T*)out, E, Q, A, I, st, sg);
    return (int)cudaGetLastError();
  }
  VPlan p;
  int at = 0;
  auto next = [&]() { return (int)v[at++]; };
  p.G = next(), p.NT = next(), p.S = next(), p.kfast = next(), p.ti = next(), p.te = next();
  p.nBt = next(), p.ng = next(), p.nr = next();
  p.oBt = next(), p.og = next(), p.oStage = next(), p.stage = next(), p.oR = next(), p.shBt = next();
  const size_t bytes = (size_t)v[at++];
  Copy* copies[2] = {&p.cBt, &p.cg};
  for (Copy* c : copies) {
    for (int d = 0; d < 4; ++d) c->s[d] = v[at++];
    c->se = v[at++];
    for (int d = 0; d < 4; ++d) c->n[d] = next();
    for (int d = 0; d < 4; ++d) c->d[d] = next();
    c->kd = next(), c->vec = next();
  }
  long long resident = 0;
  const int err = resident_blocks((const void*)elem_vector_staged<T>, p.NT, bytes, &resident);
  if (err != cudaSuccess) return err;
  const long long groups = ((long long)E + p.G - 1) / p.G;
  const unsigned int grid = (unsigned int)(groups < resident ? groups : resident);
  elem_vector_staged<T><<<grid, p.NT, bytes, stream>>>((const T*)Bt, (const T*)g, (T*)out, E, Q, A, I, p);
  return (int)cudaGetLastError();
}

}  // namespace ntt_asm

extern "C" {

// dtype: 0 float32, 1 float64.  plan: ops/assembly.py matrix_plan, packed
// (PLAN_FIELDS, then the copies of Bt, Bs and K).  Returns
// cudaGetLastError().
int ntt_elem_matrix(int dtype, const void* Bt, const void* K, const void* Bs, void* out, int E, int Q, int A, int B,
                    int I, int J, const int64_t* plan, void* stream) {
  if (E == 0 || I == 0 || J == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? ntt_asm::launch_matrix<float>(Bt, K, Bs, out, E, Q, A, B, I, J, plan, s)
                    : ntt_asm::launch_matrix<double>(Bt, K, Bs, out, E, Q, A, B, I, J, plan, s);
}

// dtype: 0 float32, 1 float64.  strides: Bt (e, q, a, i), g (e, q, a), in
// elements (read by the generic kernel).  plan: ops/assembly.py
// vector_plan, packed (VECTOR_FIELDS, then the copies of Bt and g), or null
// for the generic kernel.  Returns cudaGetLastError().
int ntt_elem_vector(int dtype, const void* Bt, const void* g, void* out, int E, int Q, int A, int I,
                    const int64_t* strides, const int64_t* plan, void* stream) {
  if (E == 0 || I == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? ntt_asm::launch_vector<float>(Bt, g, out, E, Q, A, I, strides, plan, s)
                    : ntt_asm::launch_vector<double>(Bt, g, out, E, Q, A, I, strides, plan, s);
}

}  // extern "C"
