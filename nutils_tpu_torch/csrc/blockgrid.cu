// K5: block-grid matvec y = A x for multi-field structured operators, on
// the compact operand of the operator's nonzeros.
//
// Replaces the device work of nutils_tpu/ops/blockgrid.py _matvec_fn.  The
// dof vector is split into fields (velocity, pressure, ...), each on its own
// row-major grid; every (row field i, column field j) block is a phased
// stencil: a row with grid coordinate r splits per axis into a phase
// phi = r % qr and a within-phase coordinate m = r / qr, and
//
//   y_i[r] += sum_s w_{b,phi}[s, m] * x_j[qc * m + a_s]
//
// with a_s running row-major over the block's shift window, zero outside a
// non-periodic column grid and wrapped on a periodic one.
//
// Bound: device memory.  The function needs the operator's values (39.8 M
// nonzeros on the 983,403-dof Taylor-Hood step, 159 MB in float32), one
// read of x and one write of y.  The window of a block is the union of its
// rows' stencils: a P2 edge or centre row has entries in fewer slots than a
// vertex row, so the weight buffer holds 87.7 M slots for 39.8 M values.
//
// Design: the host groups the rows of every field into classes
// (ops/blockgrid.py compact_plan): rows with entries in the same slots of
// every block, and the same column arithmetic.  The compact operand holds
// only those entries, class by class and slot-major within a class, so a
// warp's value loads for one slot are 128 contiguous bytes in float32 and
// each value is read once (streamed past L2 with __ldcs, which leaves L2 to
// x).  A thread block takes up to 256 rows of one class: its slot deltas,
// block records and segment sizes sit in shared memory, and every thread
// runs the same loops, with no field lookup and no window digits.  A row's
// column for slot s is base(m) + delta_s, base(m) = sum_ax qc m pitch_ax
// computed once per block; a class whose window wraps a periodic axis
// takes the checked path, per axis.  Each block's sum runs over its live
// slots in increasing order from zero and is added to the row's total in
// block order, as in the weight-buffer form; the slots it skips hold exact
// zeros there, and fma(0, x, acc) == acc, so the sums are the same.  y is
// written once per row, with no atomics.
//
// Tables (int32, built once per pattern by compact_plan):
//   block record (22): row offset, column offset, gr[4], gc[4], qr[4], qc[4],
//     wrap[4]   (axes padded to 4 with extent 1)
//   class record (8): first row, rows, first value, first segment, segments,
//     checked, first thread block, unused
//   segment record (3): block, first slot, slots
//   slot (2): column delta, per-axis shifts as four signed bytes
//   rows: every row once, class by class; tiles: the class of each thread block
#include <cuda_runtime.h>
#include <stdint.h>

namespace ntt_bg {

constexpr int MAXD = 4;
constexpr int ROWS = 256;
constexpr int MAX_SEGMENTS = 8;
constexpr int MAX_SLOTS = 1024;
constexpr int BCOLS = 22;
constexpr int CCOLS = 8;
constexpr int SCOLS = 3;

enum { B_ROFF = 0, B_COFF = 1, B_GR = 2, B_GC = 6, B_QR = 10, B_QC = 14, B_WRAP = 18 };
enum { C_ROW0 = 0, C_NROWS = 1, C_VBASE = 2, C_SEG0 = 3, C_NSEG = 4, C_CHECKED = 5, C_TILE0 = 6 };

template <typename T>
__global__ void __launch_bounds__(ROWS)
    blockgrid_matvec_kernel(const T* __restrict__ v, const T* __restrict__ x, T* __restrict__ y,
                            const int* __restrict__ rows, const int* __restrict__ ctab,
                            const int* __restrict__ stab, const int2* __restrict__ slots,
                            const int* __restrict__ btab, const int* __restrict__ tiles,
                            const int* __restrict__ active) {
  // the loop's flag, read with the class's tables and tested after them, so
  // the two latencies overlap
  const int live = active ? *active : 1;
  __shared__ int s_delta[MAX_SLOTS];
  __shared__ int s_shift[MAX_SLOTS];
  __shared__ int s_blk[MAX_SEGMENTS][BCOLS];
  __shared__ int s_first[MAX_SEGMENTS];
  __shared__ int s_count[MAX_SEGMENTS];
  const int c = tiles[blockIdx.x];
  const int* C = ctab + c * CCOLS;
  const int nrows = C[C_NROWS];
  const int nseg = C[C_NSEG];
  const int* Sg = stab + C[C_SEG0] * SCOLS;
  const bool checked = C[C_CHECKED] != 0;
  // the class's tables into shared memory; its segments' slots are
  // contiguous in the slot table
  const int first = nseg ? Sg[1] : 0;
  const int nslots = nseg ? Sg[(nseg - 1) * SCOLS + 1] + Sg[(nseg - 1) * SCOLS + 2] - first : 0;
  for (int k = threadIdx.x; k < nslots; k += ROWS) {
    const int2 sl = slots[first + k];
    s_delta[k] = sl.x;
    s_shift[k] = sl.y;
  }
  for (int k = threadIdx.x; k < nseg * BCOLS; k += ROWS) {
    const int s = k / BCOLS;
    s_blk[s][k - s * BCOLS] = btab[Sg[s * SCOLS] * BCOLS + k - s * BCOLS];
  }
  if (threadIdx.x < nseg) {
    s_first[threadIdx.x] = Sg[threadIdx.x * SCOLS + 1] - first;
    s_count[threadIdx.x] = Sg[threadIdx.x * SCOLS + 2];
  }
  __syncthreads();
  const int i = (blockIdx.x - C[C_TILE0]) * ROWS + threadIdx.x;
  if (!live || i >= nrows) return;
  const int g = rows[C[C_ROW0] + i];
  const T* vp = v + C[C_VBASE] + i;
  T total = T(0);
  for (int s = 0; s < nseg; ++s) {
    const int* B = s_blk[s];
    // within-phase coordinate m on the (rank-aligned) row grid, and the
    // column grid's pitches, last axis fastest
    int m[MAXD], pitch[MAXD];
    int lr = g - B[B_ROFF];
    int p = 1;
#pragma unroll
    for (int a = MAXD - 1; a >= 0; --a) {
      const int gr = B[B_GR + a];
      const int r = lr % gr;
      lr /= gr;
      m[a] = r / B[B_QR + a];
      pitch[a] = p;
      p *= B[B_GC + a];
    }
    const T* xb = x + B[B_COFF];
    const int k0 = s_first[s];
    const int k1 = k0 + s_count[s];
    T acc = T(0);
    if (!checked) {
      int base = 0;
#pragma unroll
      for (int a = 0; a < MAXD; ++a) base += B[B_QC + a] * m[a] * pitch[a];
#pragma unroll 4
      for (int k = k0; k < k1; ++k)
        acc = fma(__ldcs(vp + (int64_t)k * nrows), __ldg(xb + base + s_delta[k]), acc);
    } else {
      for (int k = k0; k < k1; ++k) {
        const int packed = s_shift[k];
        int col = 0;
        bool inside = true;
#pragma unroll
        for (int a = 0; a < MAXD; ++a) {
          const int gc = B[B_GC + a];
          int cc = B[B_QC + a] * m[a] + (int)(signed char)(packed >> (8 * a));
          if (cc < 0 || cc >= gc) {
            if (B[B_WRAP + a])
              cc = ((cc % gc) + gc) % gc;
            else
              inside = false;
          }
          col += cc * pitch[a];
        }
        if (inside) acc = fma(__ldcs(vp + (int64_t)k * nrows), __ldg(xb + col), acc);
      }
    }
    total += acc;
  }
  y[g] = total;
}

}  // namespace ntt_bg

extern "C" {

// dtype: 0 float32, 1 float64; active: a Krylov loop's flag (null: not a
// predicated loop), y is left unwritten while it is 0.  Returns
// cudaGetLastError() after the launch.
int ntt_blockgrid_matvec(int dtype, const void* v, const void* x, void* y, const void* rows, const void* ctab,
                         const void* stab, const void* slots, const void* btab, const void* tiles, const int* active,
                         int ntiles, void* stream) {
  if (ntiles == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    ntt_bg::blockgrid_matvec_kernel<float><<<ntiles, ntt_bg::ROWS, 0, s>>>(
        (const float*)v, (const float*)x, (float*)y, (const int*)rows, (const int*)ctab, (const int*)stab,
        (const int2*)slots, (const int*)btab, (const int*)tiles, active);
  else
    ntt_bg::blockgrid_matvec_kernel<double><<<ntiles, ntt_bg::ROWS, 0, s>>>(
        (const double*)v, (const double*)x, (double*)y, (const int*)rows, (const int*)ctab, (const int*)stab,
        (const int2*)slots, (const int*)btab, (const int*)tiles, active);
  return (int)cudaGetLastError();
}

}  // extern "C"
