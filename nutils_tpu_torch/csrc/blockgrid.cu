// K5: block-grid matvec y = A x for multi-field structured operators.
//
// Replaces the device work of nutils_tpu/ops/blockgrid.py _matvec_fn.  The
// dof vector is split into fields (velocity, pressure, ...), each on its own
// row-major grid; every (row field i, column field j) block is a phased
// stencil: a row with grid coordinate r splits per axis into a phase
// phi = r % qr and a within-phase coordinate m = r / qr, and
//
//   y_i[r] += sum_s w_{b,phi}[s, m] * x_j[qc * m + a_s]
//
// with a_s running row-major over the window amin .. amin + awid - 1, zero
// outside a non-periodic column grid and wrapped on a periodic one.
//
// Bound: device memory.  The function needs the operator's values (39.8 M
// nonzeros on the 983,403-dof Taylor-Hood step, 159 MB in float32), one
// read of x (neighbours are L2 hits) and one write of y.  This kernel reads
// every slot of the weight buffer (87.7 M, 351 MB), the structurally empty
// ones too: the P2 window of an edge or centre node is narrower than the
// block's, but a slot is skipped only where it falls off the grid.
//
// Design: one thread per output dof; the thread finds its field, and for
// each block of that row field its phase and m, then loops over the
// block's S slots.  The weights
// of a (block, phase) pair are slot-major [S, *pshape], so for each slot
// neighbouring threads of one phase read neighbouring addresses.  Each
// block's sum starts from zero and is added to the row's total in block
// order, as the plain version does; y is written once, with no phase
// interleave copies, no per-field concatenation and no atomics.
//
// Tables (int32, built once per operator by ops/blockgrid.py tables()):
//   block record (36): row field, row offset, column offset, rank,
//     gr[4], gc[4], qr[4], qc[4], amin[4], awid[4], wrap[4], S,
//     first phase, phase count, unused   (axes padded to 4 with extent 1)
//   phase record (6): weight offset, pshape[4], npix
#include <cuda_runtime.h>
#include <stdint.h>

namespace ntt_bg {

constexpr int MAXD = 4;
constexpr int BLOCK = 256;
constexpr int BCOLS = 36;
constexpr int PCOLS = 6;

enum {
  B_FIELD = 0, B_ROFF = 1, B_COFF = 2, B_RANK = 3, B_GR = 4, B_GC = 8, B_QR = 12, B_QC = 16,
  B_AMIN = 20, B_AWID = 24, B_WRAP = 28, B_S = 32, B_PH0 = 33, B_NPH = 34
};

template <typename T>
__global__ void blockgrid_matvec_kernel(const T* __restrict__ w, const T* __restrict__ x, T* __restrict__ y,
                                        const int* __restrict__ brec, const int* __restrict__ prec,
                                        const int* __restrict__ offs, int nblocks, int nfields, int n) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  int field = 0;
  while (field + 1 < nfields && g >= offs[field + 1]) ++field;
  T total = T(0);
  for (int b = 0; b < nblocks; ++b) {
    const int* B = brec + b * BCOLS;
    if (B[B_FIELD] != field) continue;
    int lr = g - B[B_ROFF];
    // row coordinate r on the (rank-aligned) row grid, last axis fastest
    int r[MAXD], m[MAXD], ph = 0;
#pragma unroll
    for (int a = MAXD - 1; a >= 0; --a) {
      int gr = B[B_GR + a];
      r[a] = lr % gr;
      lr /= gr;
    }
#pragma unroll
    for (int a = 0; a < MAXD; ++a) {
      int q = B[B_QR + a];
      m[a] = r[a] / q;
      ph = ph * q + (r[a] - m[a] * q);
    }
    const int* P = prec + (B[B_PH0] + ph) * PCOLS;
    int lin = 0;
#pragma unroll
    for (int a = 0; a < MAXD; ++a) lin = lin * P[1 + a] + m[a];
    const int npix = P[5];
    const T* wb = w + P[0] + lin;
    const T* xb = x + B[B_COFF];
    // column pitches
    int pitch[MAXD];
    int p = 1;
#pragma unroll
    for (int a = MAXD - 1; a >= 0; --a) {
      pitch[a] = p;
      p *= B[B_GC + a];
    }
    int digit[MAXD] = {0, 0, 0, 0};
    const int S = B[B_S];
    T acc = T(0);
    for (int s = 0; s < S; ++s) {
      int col = 0;
      bool inside = true;
#pragma unroll
      for (int a = 0; a < MAXD; ++a) {
        int gc = B[B_GC + a];
        int c = B[B_QC + a] * m[a] + B[B_AMIN + a] + digit[a];
        if (c < 0 || c >= gc) {
          if (B[B_WRAP + a])
            c = ((c % gc) + gc) % gc;
          else
            inside = false;
        }
        col += c * pitch[a];
      }
      if (inside) acc += wb[(int64_t)s * npix] * xb[col];
      bool carry = true;  // next slot: mixed-radix increment, last axis fastest
#pragma unroll
      for (int a = MAXD - 1; a >= 0; --a) {
        if (carry) {
          if (digit[a] + 1 < B[B_AWID + a]) {
            ++digit[a];
            carry = false;
          } else {
            digit[a] = 0;
          }
        }
      }
    }
    total += acc;
  }
  y[g] = total;
}

}  // namespace ntt_bg

extern "C" {

// dtype: 0 float32, 1 float64.  Returns cudaGetLastError() after the launch.
int ntt_blockgrid_matvec(int dtype, const void* w, const void* x, void* y, const void* brec, const void* prec,
                         const void* offs, int nblocks, int nfields, int n, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned int grid = (unsigned int)((n + ntt_bg::BLOCK - 1) / ntt_bg::BLOCK);
  if (dtype == 0)
    ntt_bg::blockgrid_matvec_kernel<float><<<grid, ntt_bg::BLOCK, 0, s>>>(
        (const float*)w, (const float*)x, (float*)y, (const int*)brec, (const int*)prec, (const int*)offs,
        nblocks, nfields, n);
  else
    ntt_bg::blockgrid_matvec_kernel<double><<<grid, ntt_bg::BLOCK, 0, s>>>(
        (const double*)w, (const double*)x, (double*)y, (const int*)brec, (const int*)prec, (const int*)offs,
        nblocks, nfields, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
