// K7: Schur-aware inverse diagonal of a CSR operator whose values live in a
// weight buffer (block-grid or stencil form): a_k = w[csr_map[k]]; or, with
// no map (a null csr_map), of a CSR operator whose values are w itself:
// a_k = w[k].
//
// Replaces nutils_tpu/ops/sparse.py _schur_diag_kernel (reached through
// schur_diag_inverse_device and System.fused_step_op).  Per row i:
//
//   d_i      = a_ii,  rn2_i = sum_k a_ik^2
//   strong_i = |d_i| > weak_rel * sqrt(rn2_i),  dsafe_i = strong_i ? |d_i| : 1
//   schur_i  = sum_k a_ik^2 / dsafe_{col k}
//   minv_i   = strong_i ? 1 / d_i : (schur_i > 0 ? 1 / schur_i : 1)
//
// Bound: device memory.  Pass 2 needs the dsafe of every column, so the
// nonzeros are read twice, in two launches: pass 1 reads each slot's map
// entry, value and column and writes d, dsafe and strong (and, in the
// mapped form, the slot's value in CSR order into a scratch of nnz
// values); pass 2 reads each value (the scratch, or w itself) and column,
// gathers dsafe of the column (3.9 MB in float32 at the NS step, kept in
// L2) and writes minv: about 24 B a nonzero through the map in float32
// and 16 B without one, against the 12 B and 8 B of one read of each input.
// Design: K9's row blocks (ops/sparse.py csr_plan, the plan kept on the
// operand's row pointers): a block takes consecutive rows of at most `cap`
// nonzeros and stages its span in shared memory, the interior with 16-byte
// loads by neighbouring threads, the head and tail (up to 3 values each)
// one at a time.  In the mapped form the whole block gathers its span's
// values through the map together, so consecutive rows share the sectors
// of each slot plane in L1, and gathers each value once: pass 2 reads the
// scratch instead of the map.  Pass 2 stages each slot's a^2 / dsafe.
// Each row's sums then keep the bits of the one-warp-a-row kernel this
// replaces: there, lane l summed slots start + l, start + l + 32, ... in
// order from zero (dsum += a on the diagonal, sq = fma(a, a, sq);
// schur += a^2 / dsafe) and a __shfl_xor butterfly added the 32 lane
// sums, which leaves in lane 0 (and, addition being commutative, in every
// lane) the pairwise tree of lanes (l, l + 16), then (l, l + 8), ..., (0, 1).
// Here a group of LANES threads takes a row (lane_tree): thread j of the
// group computes the lane sums j, j + LANES, ... from shared memory, adds
// the tree's levels whose pairs it holds itself (16, 8, ..., LANES apart),
// and the group's shuffles add the rest (LANES / 2, ..., 1): the same
// operations in the same order, at a fraction of the warp's instructions
// (two butterflies of five shuffles and adds, a loop a warp wide over some
// 30-40 slots) and with a block's rows summed at once rather than a few
// rows a warp in turn.  One thread a row (the whole tree in registers)
// measured slower than one warp a row: a block's rows then sit in one
// warp.  The passes' registers are capped so that eight blocks (2,048
// threads) fit a multiprocessor: the more blocks in flight, the more of
// the dependent loads (plan, row pointers, map, value) overlap.  A row of
// more than cap nonzeros (a block of its own) is staged by the whole block
// cap values at a time (cap a multiple of 32, so each lane keeps its
// sequence) and summed by warp 0 with the butterfly itself.
#include <cuda_runtime.h>
#include <stdint.h>

namespace ntt_schur {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 8;  // blocks a multiprocessor (its 2,048 threads): registers capped to fit
// threads a row (a power of two up to 32): 4 in float32, 8 in float64,
// where 4 spill under the register cap (measured at the NS and triangle
// steps' operators; 32 is the butterfly of one warp a row)
template <typename T>
struct Lanes {
  static constexpr int value = sizeof(T) == 4 ? 4 : 8;
};
constexpr int VEC = 4;  // values a 16-byte load of an int32 table brings

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void load4(const int* p, int (&v)[VEC]) {
  const int4 q = __ldcs(reinterpret_cast<const int4*>(p));
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const float* p, float (&v)[VEC]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[VEC]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p)), b = __ldcs(reinterpret_cast<const double2*>(p + 2));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[VEC]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store4(double* p, const double (&v)[VEC]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  __stcs(reinterpret_cast<double2*>(p + 2), make_double2(v[2], v[3]));
}

// f4(e) for e = ka, ka + 4, ... over the 4-aligned interior [ka, kb) of
// [k0, k1), f1(k) for the head [k0, ka) and the tail [kb, k1); neighbouring
// threads take neighbouring groups.  Without 16-byte alignment (vec_ok 0)
// every k is f1's.
template <typename F4, typename F1>
__device__ __forceinline__ void for_span(int k0, int k1, int vec_ok, F4 f4, F1 f1) {
  if (!vec_ok) {
    for (int k = k0 + threadIdx.x; k < k1; k += THREADS) f1(k);
    return;
  }
  const int ka = min((k0 + VEC - 1) & ~(VEC - 1), k1), kb = max(k1 & ~(VEC - 1), ka);
#pragma unroll 2
  for (int e = ka + VEC * threadIdx.x; e < kb; e += VEC * THREADS) f4(e);
  const int k = threadIdx.x < VEC - 1 ? k0 + threadIdx.x : kb + threadIdx.x - (VEC - 1);
  if (threadIdx.x < 2 * (VEC - 1) && k < (threadIdx.x < VEC - 1 ? ka : k1)) f1(k);
}

// pass 1 on the span [k0, k1): stage values into sv and columns into sc
// (slot k at k - base); mapped, also write the values into vals
template <typename T, bool MAPPED>
__device__ __forceinline__ void stage1(const T* __restrict__ w, const int* __restrict__ cmap,
                                       const int* __restrict__ indices, T* __restrict__ vals, int base, int k0, int k1,
                                       int vec_ok, T* sv, int* sc) {
  for_span(
      k0, k1, vec_ok,
      [&](int e) {
        int c[VEC];
        T a[VEC];
        load4(indices + e, c);
        if constexpr (MAPPED) {
          int m[VEC];
          load4(cmap + e, m);
#pragma unroll
          for (int i = 0; i < VEC; ++i) a[i] = __ldg(w + m[i]);
          store4(vals + e, a);
        } else {
          load4(w + e, a);
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          sv[e - base + i] = a[i];
          sc[e - base + i] = c[i];
        }
      },
      [&](int k) {
        T a;
        if constexpr (MAPPED) {
          a = __ldg(w + cmap[k]);
          vals[k] = a;
        } else {
          a = w[k];
        }
        sv[k - base] = a;
        sc[k - base] = indices[k];
      });
}

// one lane's part of pass 1's sums of row `row` over its staged slots
// [ks, ke) (slot k at k - base): lane l takes ks + l, ks + l + 32, ...
template <typename T>
__device__ __forceinline__ void sums1(const T* sv, const int* sc, int base, int ks, int ke, int row, int lane,
                                      T& dsum, T& sq) {
  for (int k = ks + lane; k < ke; k += 32) {
    const T a = sv[k - base];
    if (sc[k - base] == row) dsum += a;
    sq = fma_rn(a, a, sq);
  }
}

// what the butterfly (warp_sum) of the 32 lane sums leaves in lane 0, for
// NS sums at once, computed by a group of LANES threads (this one its
// j-th): lane(l, acc) adds lane l's terms to acc[0 .. NS) from zero; the
// lanes are then added in pairs (l, l + 16), (l, l + 8), ..., (0, 1).
// Every thread of the warp calls it (the shuffles take the whole warp);
// the group's thread 0 gets the sums.
template <typename T, int NS, typename F>
__device__ __forceinline__ void lane_tree(int j, F lane, T (&out)[NS]) {
  constexpr int LANES = Lanes<T>::value;
  constexpr int M = 32 / LANES;  // lane sums a thread: j + LANES m
  T p[M][NS];
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int s = 0; s < NS; ++s) p[m][s] = T(0);
    lane(j + LANES * m, p[m]);
  }
#pragma unroll
  for (int o = 16; o >= LANES; o >>= 1)
#pragma unroll
    for (int m = 0; m < o / LANES; ++m)
#pragma unroll
      for (int s = 0; s < NS; ++s) p[m][s] = p[m][s] + p[m + o / LANES][s];
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
#pragma unroll
    for (int s = 0; s < NS; ++s) p[0][s] += __shfl_xor_sync(0xffffffffu, p[0][s], o);
#pragma unroll
  for (int s = 0; s < NS; ++s) out[s] = p[0][s];
}

template <typename T>
__device__ __forceinline__ void finish1(int row, T dsum, T sq, T weak_rel, T* __restrict__ d, T* __restrict__ dsafe,
                                        unsigned char* __restrict__ strong) {
  bool st = fabs(dsum) > weak_rel * sqrt(sq);
  d[row] = dsum;
  dsafe[row] = st ? fabs(dsum) : T(1);
  strong[row] = st;
}

template <typename T, bool MAPPED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    schur_pass1(const T* __restrict__ w, const int* __restrict__ cmap, const int* __restrict__ indices,
                const int* __restrict__ indptr, const int* __restrict__ starts, int cap, int vec_ok, T weak_rel,
                T* __restrict__ d, T* __restrict__ dsafe, unsigned char* __restrict__ strong, T* __restrict__ vals) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sv = reinterpret_cast<T*>(smem_raw);
  int* sc = reinterpret_cast<int*>(sv + cap);
  const int r0 = starts[blockIdx.x], r1 = starts[blockIdx.x + 1];
  const int k0 = indptr[r0], k1 = indptr[r1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (k1 - k0 > cap) {
    // one long row: cap slots at a time, summed by warp 0
    T dsum = T(0), sq = T(0);
    for (int base = k0; base < k1; base += cap) {
      const int end = min(base + cap, k1);
      stage1<T, MAPPED>(w, cmap, indices, vals, base, base, end, vec_ok, sv, sc);
      __syncthreads();
      if (warp == 0) sums1(sv, sc, base, base, end, r0, lane, dsum, sq);
      __syncthreads();
    }
    if (warp == 0) {
      dsum = warp_sum(dsum);
      sq = warp_sum(sq);
      if (lane == 0) finish1(r0, dsum, sq, weak_rel, d, dsafe, strong);
    }
    return;
  }
  stage1<T, MAPPED>(w, cmap, indices, vals, k0, k0, k1, vec_ok, sv, sc);
  __syncthreads();
  constexpr int LANES = Lanes<T>::value;
  for (int base = r0; base < r1; base += THREADS / LANES) {
    const int row = base + threadIdx.x / LANES;
    const int ks = row < r1 ? indptr[row] - k0 : 0, ke = row < r1 ? indptr[row + 1] - k0 : 0;
    T sums[2];  // dsum, sq
    lane_tree<T, 2>(
        threadIdx.x % LANES,
        [&](int l, T(&acc)[2]) {
          for (int k = ks + l; k < ke; k += 32) {
            const T a = sv[k];
            if (sc[k] == row) acc[0] += a;
            acc[1] = fma_rn(a, a, acc[1]);
          }
        },
        sums);
    if (row < r1 && threadIdx.x % LANES == 0) finish1(row, sums[0], sums[1], weak_rel, d, dsafe, strong);
  }
}

// pass 2 on the span [k0, k1): stage a^2 / dsafe[col] into sq (slot k at
// k - base)
template <typename T>
__device__ __forceinline__ void stage2(const T* __restrict__ vals, const int* __restrict__ indices,
                                       const T* __restrict__ dsafe, int base, int k0, int k1, int vec_ok, T* sq) {
  for_span(
      k0, k1, vec_ok,
      [&](int e) {
        int c[VEC];
        T a[VEC];
        load4(indices + e, c);
        load4(vals + e, a);
#pragma unroll
        for (int i = 0; i < VEC; ++i) sq[e - base + i] = a[i] * a[i] / __ldg(dsafe + c[i]);
      },
      [&](int k) {
        const T a = vals[k];
        sq[k - base] = a * a / __ldg(dsafe + indices[k]);
      });
}

template <typename T>
__device__ __forceinline__ void finish2(int row, T schur, const T* __restrict__ d,
                                        const unsigned char* __restrict__ strong, T* __restrict__ minv) {
  minv[row] = strong[row] ? T(1) / d[row] : (schur > T(0) ? T(1) / schur : T(1));
}

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    schur_pass2(const T* __restrict__ vals, const int* __restrict__ indices, const int* __restrict__ indptr,
                const int* __restrict__ starts, int cap, int vec_ok, const T* __restrict__ d,
                const T* __restrict__ dsafe, const unsigned char* __restrict__ strong, T* __restrict__ minv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  const int r0 = starts[blockIdx.x], r1 = starts[blockIdx.x + 1];
  const int k0 = indptr[r0], k1 = indptr[r1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (k1 - k0 > cap) {
    T schur = T(0);
    for (int base = k0; base < k1; base += cap) {
      const int end = min(base + cap, k1);
      stage2(vals, indices, dsafe, base, base, end, vec_ok, sq);
      __syncthreads();
      if (warp == 0)
        for (int k = base + lane; k < end; k += 32) schur += sq[k - base];
      __syncthreads();
    }
    if (warp == 0) {
      schur = warp_sum(schur);
      if (lane == 0) finish2(r0, schur, d, strong, minv);
    }
    return;
  }
  stage2(vals, indices, dsafe, k0, k0, k1, vec_ok, sq);
  __syncthreads();
  constexpr int LANES = Lanes<T>::value;
  for (int base = r0; base < r1; base += THREADS / LANES) {
    const int row = base + threadIdx.x / LANES;
    const int ks = row < r1 ? indptr[row] - k0 : 0, ke = row < r1 ? indptr[row + 1] - k0 : 0;
    T schur[1];
    lane_tree<T, 1>(
        threadIdx.x % LANES,
        [&](int l, T(&acc)[1]) {
          for (int k = ks + l; k < ke; k += 32) acc[0] += sq[k];
        },
        schur);
    if (row < r1 && threadIdx.x % LANES == 0) finish2(row, schur[0], d, strong, minv);
  }
}

inline bool aligned(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

template <typename T, bool MAPPED>
int launch(const void* w, const void* cmap, const void* indices, const void* indptr, const void* starts,
           int nblocks, int cap, double weak_rel, void* d, void* dsafe, void* strong, void* minv, void* vals,
           cudaStream_t s) {
  if (cap % 32 || cap % VEC || (size_t)cap * (sizeof(T) + sizeof(int)) > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int vec_ok = aligned(indices) && aligned(MAPPED ? cmap : w) && (!MAPPED || aligned(vals));
  schur_pass1<T, MAPPED><<<(unsigned int)nblocks, THREADS, (size_t)cap * (sizeof(T) + sizeof(int)), s>>>(
      (const T*)w, (const int*)cmap, (const int*)indices, (const int*)indptr, (const int*)starts, cap, vec_ok,
      (T)weak_rel, (T*)d, (T*)dsafe, (unsigned char*)strong, (T*)vals);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const T* values = MAPPED ? (const T*)vals : (const T*)w;
  schur_pass2<T><<<(unsigned int)nblocks, THREADS, (size_t)cap * sizeof(T), s>>>(
      values, (const int*)indices, (const int*)indptr, (const int*)starts, cap, vec_ok && aligned(values),
      (const T*)d, (const T*)dsafe, (const unsigned char*)strong, (T*)minv);
  return (int)cudaGetLastError();
}

}  // namespace ntt_schur

extern "C" {

// dtype: 0 float32, 1 float64.  cmap null: the values are w itself.  starts:
// K9's plan, nblocks + 1 row starts, each block at most cap nonzeros unless
// it is one row.  d, dsafe (dtype) and strong (bytes) are scratch of n
// entries, vals (dtype) of nnz entries where cmap is not null (else null);
// minv is the output.  Returns cudaGetLastError().
int ntt_schur_diag(int dtype, const void* w, const void* cmap, const void* indices, const void* indptr,
                   const void* starts, void* d, void* dsafe, void* strong, void* minv, void* vals, int nblocks,
                   int cap, double weak_rel, void* stream) {
  if (nblocks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (cmap == nullptr) {
    if (dtype == 0)
      return ntt_schur::launch<float, false>(w, cmap, indices, indptr, starts, nblocks, cap, weak_rel, d, dsafe,
                                             strong, minv, vals, s);
    return ntt_schur::launch<double, false>(w, cmap, indices, indptr, starts, nblocks, cap, weak_rel, d, dsafe,
                                            strong, minv, vals, s);
  }
  if (vals == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return ntt_schur::launch<float, true>(w, cmap, indices, indptr, starts, nblocks, cap, weak_rel, d, dsafe, strong,
                                          minv, vals, s);
  return ntt_schur::launch<double, true>(w, cmap, indices, indptr, starts, nblocks, cap, weak_rel, d, dsafe, strong,
                                         minv, vals, s);
}

}  // extern "C"
