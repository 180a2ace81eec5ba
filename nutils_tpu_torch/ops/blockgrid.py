'''Block-grid operator form: mixed-field structured systems as a grid of
inter-grid stencils.

A multi-field structured system (Taylor-Hood Navier-Stokes: degree-2
velocity on a (2n+1)^2 x 2 grid, degree-1 pressure on (n+1)^2) is not one
stencil, but each (row field, column field) block is: with per-axis pitch
ratio qr:qc every nonzero decomposes as

    col_ax = qc * (row_ax // qr) + a_ax,   |a_ax| bounded,

a PHASED rectangular stencil.  Rows split into qr phases per axis
(row_ax = qr * m + phi), and within a phase

    y[m] += sum_s  w_s[m] * x[qc * m + a_s]

with zero padding or periodic wrap per axis.  Detection (:func:`detect`),
value refill (:func:`refill`) and the weight shapes (:func:`_w_shapes`) are
host work copied from ``nutils_tpu.ops.blockgrid`` with one difference: the
JAX package permutes each block's grid axes so that the largest extents are
minor (a workaround for the TPU's (8, 128) tiling).  The port keeps every
block's axes in their natural order, so the velocity weights are
``[S, 661, 661, 2]`` with the component axis minor.

The matvec is kernel K5 (``csrc/blockgrid.cu``, :func:`blockgrid_matvec`);
:func:`matvec_plain` is its plain torch version (the literal port of
``_matvec_fn`` with strided slices and phase interleaving), taken for
tensors on the CPU.

Operands: the weights of all (block, phase) pairs live in ONE flat buffer
``w``; ``woff[k]`` is where the k-th (block, phase) array ``[S, *pshape]``
starts (enumeration order of ``meta``).  The solver aligns each offset to
the array's own grid size; any offsets that keep the arrays apart work.
'''

import functools
import itertools

import numpy
import torch

from .. import _kernels

_RATIOS = ((1, 1), (2, 1), (1, 2), (3, 1), (1, 3), (3, 2), (2, 3), (4, 1), (1, 4), (4, 3), (3, 4))


class BlockGridForm:
    '''Static meta + per-(block, phase) weight arrays + value-refill plan.'''

    __slots__ = ('meta', 'ws', 'fill')

    def __init__(self, meta, ws, fill):
        self.meta = meta    # hashable: (offsets, fieldshapes, blocks)
        self.ws = ws        # list of [S, *pshape] arrays (enumeration order)
        self.fill = fill    # (sizes, windex, wpos): ws[i].flat refill plan


def _align(gr, gc):
    '''Pad the lower-rank grid shape with 1s (left or right) to the common
    rank; returns candidate (gr, gc) pairs to try, in order.'''
    dr, dc = len(gr), len(gc)
    if dr == dc:
        return [(gr, gc)]
    pad = (1,) * abs(dr - dc)
    if dr < dc:
        return [(pad + gr, gc), (gr + pad, gc)]
    return [(gr, pad + gc), (gr, gc + pad)]


def _axis_shift(r_ax, c_ax, qr, qc, dimc, max_shift):
    '''Per-axis shifts a = c - qc*(r//qr), retried with periodic wrap (the
    column grid is read modulo its size) when the plain form exceeds the
    window; returns (a, wrap) or None.'''
    a = c_ax - qc * (r_ax // qr)
    if len(a) and int(numpy.abs(a).max(initial=0)) > max_shift:
        if dimc > 2 * max_shift + 3:
            aw = (a + dimc // 2) % dimc - dimc // 2
            if int(numpy.abs(aw).max(initial=0)) <= max_shift:
                return aw, True
        return None
    return a, False


def _axis_ratio(r_ax, c_ax, dimc, max_shift):
    '''Pick the (qr, qc) pitch ratio for one axis by minimizing the observed
    shift window; returns (qr, qc, a, amin, amax, wrap) or None.'''
    best = None
    for qr, qc in _RATIOS:
        hit = _axis_shift(r_ax, c_ax, qr, qc, dimc, max_shift)
        if hit is None:
            continue
        a, wrap = hit
        amin, amax = int(a.min(initial=0)), int(a.max(initial=0))
        width = amax - amin
        if best is None or (wrap, qr * qc, width) < (best[5], best[0] * best[1], best[4] - best[3]):
            best = (qr, qc, a, amin, amax, wrap)
    return best


def _phase_index(ph, qr):
    '''Phase multi-index (row-major over qr) of phase number ``ph``.'''
    phi = []
    for q in reversed(qr):
        phi.append(ph % q)
        ph //= q
    return tuple(phi[::-1])


def detect(data, indices, indptr, offsets, grids=None, max_shift=4, max_phase_terms=128):
    '''Detect the block-grid form of an n x n CSR matrix whose dof vector is
    partitioned at ``offsets`` (field boundaries); returns a BlockGridForm
    or None.  ``grids`` optionally carries per-field (shape, periodic)
    layout hints registered by the solver (exact, alias-free); fields
    without a hint infer their grid from the diagonal block.  Each block
    of ``meta`` is ``(i, j, gr, gc, qr, qc, amin, awid, wrap, phmeta)`` with
    its grid axes in natural order.  O(nnz) vectorized host work.'''
    data = numpy.asarray(data)
    indices = numpy.asarray(indices).astype(numpy.int64)
    indptr = numpy.asarray(indptr)
    offsets = tuple(int(o) for o in offsets)
    n = len(indptr) - 1
    F = len(offsets) - 1
    if F < 2 or offsets[0] != 0 or offsets[-1] != n:
        return None
    counts = numpy.diff(indptr)
    rows = numpy.repeat(numpy.arange(n), counts)

    # field grids: solver hints, else inferred from the diagonal blocks
    import scipy.sparse
    from . import stencil as _stencil
    A = scipy.sparse.csr_matrix((data, indices, indptr), shape=(n, n))
    fieldshapes = []
    for i in range(F):
        hint = grids[i] if grids is not None and i < len(grids) else None
        if hint is not None:
            fieldshapes.append(tuple(int(s) for s in hint[0]))
            continue
        lo, hi = offsets[i], offsets[i + 1]
        Ab = A[lo:hi, lo:hi].tocsr()
        form = _stencil.from_csr(Ab.data, Ab.indices, Ab.indptr, hi - lo) if Ab.nnz else None
        if form is None:
            return None
        fieldshapes.append(form.shape)

    rfield = numpy.searchsorted(offsets, rows, side='right') - 1
    cfield = numpy.searchsorted(offsets, indices, side='right') - 1

    blocks = []
    ws = []
    sizes, windex, wpos = [], numpy.zeros(len(data), dtype=numpy.int64), numpy.zeros(len(data), dtype=numpy.int64)
    for i in range(F):
        for j in range(F):
            sel = numpy.nonzero((rfield == i) & (cfield == j))[0]
            if not len(sel):
                continue
            r = rows[sel] - offsets[i]
            c = indices[sel] - offsets[j]
            # ratio selection on a sample, exact verification on all entries
            step = max(1, len(sel) // 16384)
            hit = None
            for gr, gc in _align(fieldshapes[i], fieldshapes[j]):
                pr = [int(numpy.prod(gr[ax + 1:])) for ax in range(len(gr))]
                pc = [int(numpy.prod(gc[ax + 1:])) for ax in range(len(gc))]
                per_axis = [_axis_ratio((r[::step] // p1) % s1, (c[::step] // p2) % s2, s2, max_shift)
                            for p1, s1, p2, s2 in zip(pr, gr, pc, gc)]
                if all(p is not None for p in per_axis):
                    hit = (gr, gc, pr, pc, per_axis)
                    break
            if hit is None:
                return None
            gr, gc, pr, pc, per_axis = hit
            d = len(gr)
            qr = tuple(p[0] for p in per_axis)
            qc = tuple(p[1] for p in per_axis)
            # full exact pass with the sampled choice
            rc = [(r // p) % s for p, s in zip(pr, gr)]
            cc = [(c // p) % s for p, s in zip(pc, gc)]
            per_axis = []
            for ax in range(d):
                hit_ax = _axis_shift(rc[ax], cc[ax], qr[ax], qc[ax], gc[ax], max_shift)
                if hit_ax is None:
                    return None
                a, wrap_ax = hit_ax
                per_axis.append((qr[ax], qc[ax], a, int(a.min(initial=0)),
                                 int(a.max(initial=0)), wrap_ax))
            amin = tuple(p[3] for p in per_axis)
            awid = tuple(p[4] - p[3] + 1 for p in per_axis)
            wrap = tuple(p[5] for p in per_axis)
            # phase id (row-major over qr) and within-phase slot (row-major
            # over the shift window)
            phase = numpy.zeros(len(sel), dtype=numpy.int64)
            slot = numpy.zeros(len(sel), dtype=numpy.int64)
            for ax in range(d):
                phase = phase * qr[ax] + rc[ax] % qr[ax]
                slot = slot * awid[ax] + (per_axis[ax][2] - amin[ax])
            nphase = int(numpy.prod(qr))
            pshapes = []
            for ph in range(nphase):
                phi = _phase_index(ph, qr)
                pshapes.append(tuple(-(-(gr[ax] - phi[ax]) // qr[ax]) for ax in range(d)))
            # within-phase grid coordinate (m) of each entry
            m_per_ax = [rc[ax] // qr[ax] for ax in range(d)]
            phshape_arr = numpy.array(pshapes)  # [nphase, d]
            mloc = numpy.zeros(len(sel), dtype=numpy.int64)
            for ax in range(d):
                mloc = mloc * phshape_arr[phase, ax] + m_per_ax[ax]
            S = int(numpy.prod(awid))
            if S > max_phase_terms:
                return None
            phmeta = []
            for ph in range(nphase):
                psel = phase == ph
                npix = int(numpy.prod(pshapes[ph]))
                w = numpy.zeros(S * npix, dtype=data.dtype)
                lin = slot[psel] * npix + mloc[psel]
                w[lin] = data[sel[psel]]
                wi = len(ws)
                ws.append(w.reshape((S,) + pshapes[ph]))
                sizes.append(S * npix)
                windex[sel[psel]] = wi
                wpos[sel[psel]] = lin
                phmeta.append((_phase_index(ph, qr), pshapes[ph]))
            blocks.append((i, j, tuple(gr), tuple(gc), qr, qc, amin, awid, wrap, tuple(phmeta)))
    meta = (offsets, tuple(fieldshapes), tuple(blocks))
    return BlockGridForm(meta, ws, (tuple(sizes), windex, wpos))


def refill(form_or_fill, data, meta=None):
    '''Rebuild the weight arrays from fresh CSR values (constant pattern).'''
    if isinstance(form_or_fill, BlockGridForm):
        sizes, windex, wpos = form_or_fill.fill
        meta = form_or_fill.meta
    else:
        sizes, windex, wpos = form_or_fill
    data = numpy.asarray(data)
    flat = [numpy.zeros(s, dtype=data.dtype) for s in sizes]
    order = numpy.argsort(windex, kind='stable')
    wi_sorted = windex[order]
    bounds = numpy.searchsorted(wi_sorted, numpy.arange(len(sizes) + 1))
    for wi in range(len(sizes)):
        sl = order[bounds[wi]:bounds[wi + 1]]
        flat[wi][wpos[sl]] = data[sl]
    shapes = _w_shapes(meta)
    return [f.reshape(s) for f, s in zip(flat, shapes)]


def _w_shapes(meta):
    '''[S, *pshape] of every (block, phase) weight array, in enumeration
    order.'''
    shapes = []
    for _i, _j, _gr, _gc, _qr, _qc, _amin, awid, _wrap, phmeta in meta[2]:
        S = int(numpy.prod(awid))
        for _phi, pshape in phmeta:
            shapes.append((S,) + tuple(pshape))
    return shapes


def weight_views(w, meta, woff):
    '''The (block, phase) weight arrays as views of the flat buffer ``w``.'''
    return [w[o:o + int(numpy.prod(shp))].reshape(shp) for o, shp in zip(woff, _w_shapes(meta))]


# ------------------------------------------------------------ plain version

def _interleave(parts, gr, qr):
    '''Merge per-phase outputs [pshape...] (row-major over the phases) back
    onto the full row grid, axis by axis, last axis first.'''
    d = len(gr)
    for ax in reversed(range(d)):
        q = qr[ax]
        if q == 1:
            continue
        merged = []
        for base in range(0, len(parts), q):
            grp = parts[base:base + q]
            m = max(p.shape[ax] for p in grp)
            padded = []
            for p in grp:
                pad = [0, 0] * p.ndim
                pad[2 * (p.ndim - 1 - ax) + 1] = m - p.shape[ax]
                padded.append(torch.nn.functional.pad(p, pad))
            st = torch.stack(padded, dim=ax + 1)
            shp = list(padded[0].shape)
            shp[ax] = m * q
            merged.append(st.reshape(shp).narrow(ax, 0, gr[ax]))
        parts = merged
    assert len(parts) == 1
    return parts[0]


def matvec_plain(w, x, meta, woff):
    '''Plain torch block-grid matvec y = A x for flat ``x`` and the flat
    weight buffer ``w`` (the literal port of
    ``nutils_tpu.ops.blockgrid._matvec_fn`` in natural axis order: pad or
    wrap each column field, accumulate the strided slices of every phase in
    slot order, interleave the phases, sum the blocks per row field).'''
    offsets, fieldshapes, blocks = meta
    F = len(fieldshapes)
    ws = weight_views(w, meta, woff)
    xs = [x[offsets[j]:offsets[j + 1]] for j in range(F)]
    ys = [torch.zeros(offsets[i + 1] - offsets[i], dtype=x.dtype, device=x.device) for i in range(F)]
    wi = 0
    for i, j, gr, gc, qr, qc, amin, awid, wrap, phmeta in blocks:
        d = len(gr)
        xg = xs[j].reshape(gc)
        shifts = list(itertools.product(*[range(a0, a0 + wd) for a0, wd in zip(amin, awid)]))
        padlo = [max(0, -amin[ax]) for ax in range(d)]
        pmax = [max(pm[1][ax] for pm in phmeta) for ax in range(d)]
        padhi = [max(0, qc[ax] * (pmax[ax] - 1) + amin[ax] + awid[ax] - 1 - (gc[ax] - 1))
                 for ax in range(d)]
        xp = xg
        for ax in range(d):  # periodic axes pad with wrapped copies
            if wrap[ax] and (padlo[ax] or padhi[ax]):
                xp = torch.cat([xp.narrow(ax, gc[ax] - padlo[ax], padlo[ax]), xp,
                                xp.narrow(ax, 0, padhi[ax])], dim=ax)
        zpad = []
        for ax in reversed(range(d)):
            zpad += [0, 0] if wrap[ax] else [padlo[ax], padhi[ax]]
        if any(zpad):
            xp = torch.nn.functional.pad(xp, zpad)
        parts = []
        for _phi, pshape in phmeta:
            wb = ws[wi]
            wi += 1
            acc = torch.zeros(pshape, dtype=x.dtype, device=x.device)
            for s, sh in enumerate(shifts):
                sl = tuple(slice(padlo[ax] + sh[ax], padlo[ax] + sh[ax] + qc[ax] * (pshape[ax] - 1) + 1, qc[ax])
                           for ax in range(d))
                acc = acc + wb[s] * xp[sl]
            parts.append(acc)
        ys[i] = ys[i] + _interleave(parts, gr, qr).reshape(-1)
    return torch.cat(ys)


# ------------------------------------------------------------ kernel K5

_BLOCK_COLS = 36   # int32 fields of one block record (csrc/blockgrid.cu)
_PHASE_COLS = 6    # woff, pshape[4], npix


def tables(meta, woff):
    '''The int32 block and phase tables of ``meta`` as numpy arrays (the
    layout ``csrc/blockgrid.cu`` reads): one record per block (row field,
    row and column offsets, rank, gr, gc, qr, qc, amin, awid, wrap, S, first
    phase, phase count, one unused; axes padded to four with extent 1) and
    one per
    (block, phase) (weight offset, phase shape, phase size).'''
    offsets, _fieldshapes, blocks = meta
    brec = numpy.zeros((len(blocks), _BLOCK_COLS), dtype=numpy.int32)
    prec = numpy.zeros((len(woff), _PHASE_COLS), dtype=numpy.int32)
    k = 0
    for b, (i, j, gr, gc, qr, qc, amin, awid, wrap, phmeta) in enumerate(blocks):
        d = len(gr)
        if d > 4:
            raise ValueError(f'block grid rank {d} is above 4')

        def pad4(v, fill):
            return list(v) + [fill] * (4 - d)
        brec[b] = [i, offsets[i], offsets[j], d, *pad4(gr, 1), *pad4(gc, 1), *pad4(qr, 1), *pad4(qc, 1),
                   *pad4(amin, 0), *pad4(awid, 1), *pad4([int(bool(v)) for v in wrap], 0),
                   int(numpy.prod(awid)), k, len(phmeta), 0]
        for _phi, pshape in phmeta:
            prec[k] = [woff[k], *pad4(pshape, 1), int(numpy.prod(pshape))]
            k += 1
    return brec, prec


@functools.lru_cache(maxsize=16)
def _device_tables(meta, woff, device):
    '''The tables of :func:`tables` and the field offsets on ``device``,
    uploaded once per operator layout and reused by every matvec.'''
    brec, prec = tables(meta, woff)
    offs = numpy.asarray(meta[0], dtype=numpy.int32)
    return tuple(torch.as_tensor(a, device=device) for a in (brec, prec, offs))


def blockgrid_matvec(w, x, meta, woff):
    '''y = A x for the block-grid operator with flat weights ``w`` and flat
    ``x`` (kernel K5, ``csrc/blockgrid.cu``), replacing the device work of
    ``nutils_tpu.ops.blockgrid._matvec_fn``.  It is memory-bound: one
    thread per output dof reads its S slot-major weights of each block in
    its row field (neighbouring threads, neighbouring addresses) while L2
    serves the reads of ``x``; ``y`` is written once, with no interleave
    copies.  It reads every in-grid slot, structurally empty ones too, so
    its traffic is the weight buffer's, not the operator's nonzeros.
    Tensors on the CPU take
    :func:`matvec_plain`; a CUDA tensor launches the kernel or raises.'''
    if x.device.type == 'cpu':
        return matvec_plain(w, x, meta, woff)
    n = int(meta[0][-1])
    total = int(w.shape[0])
    _kernels.check_operands('blockgrid_matvec', x, (n,), x.dtype, w=(w, (total,)))
    if total >= 2**31 or n >= 2**31:
        raise ValueError('blockgrid_matvec: 2^31 weights or dofs or more; the kernel indexes in 32 bits')
    shapes = _w_shapes(meta)
    if len(woff) != len(shapes) or any(o < 0 or o + int(numpy.prod(s)) > total for o, s in zip(woff, shapes)):
        raise ValueError('blockgrid_matvec: weight offsets do not fit the weight buffer')
    brec, prec, offs = _device_tables(meta, tuple(woff), x.device)
    y = torch.empty_like(x)
    _kernels.call('ntt_blockgrid_matvec', x, [w, x, y, brec, prec, offs],
                  scalars=(brec.shape[0], offs.shape[0] - 1, n))
    blockgrid_matvec.launches += 1
    return y


blockgrid_matvec.launches = 0
