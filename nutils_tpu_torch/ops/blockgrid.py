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

Operands: the weights of all (block, phase) pairs live in ONE flat buffer
``w``; ``woff[k]`` is where the k-th (block, phase) array ``[S, *pshape]``
starts (enumeration order of ``meta``).  The solver aligns each offset to
the array's own grid size; any offsets that keep the arrays apart work.
A block's window is the union of its rows' stencils, so ``w`` also holds
slots that no row uses (on the Taylor-Hood step 87.7 M slots for 39.8 M
nonzeros).

The matvec is kernel K5 (``csrc/blockgrid.cu``, :func:`blockgrid_matvec`)
on a compact operand that holds only the pattern's entries, laid out by a
host plan of the pattern (:func:`compact_plan`) and gathered from ``w`` by
:func:`pack`.  :func:`compact_matvec_plain` is the kernel's plain torch
version on that operand; :func:`matvec_plain`, the literal port of
``_matvec_fn`` (strided slices and phase interleaving) on ``w``, is what
the wrapper takes for tensors on the CPU.
'''

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

# table layouts shared with csrc/blockgrid.cu
MAXD = 4             # grid rank; lower ranks are padded with extent-1 axes
ROWS_PER_CTA = 256   # rows of one class that a thread block takes
MAX_SEGMENTS = 8     # blocks of one row field (one per column field)
MAX_SLOTS = 1024     # window slots of one class over all its blocks
MAX_CLASSES = 128    # slot sets of one (block, phase) before it falls back to its whole window
_BCOLS = 22          # block: row offset, column offset, gr[4], gc[4], qr[4], qc[4], wrap[4]
_CCOLS = 8           # class: first row, rows, first value, first segment, segments, checked, first tile, unused
_SCOLS = 3           # segment: block, first slot, slots


def _pad4(v, fill):
    return [int(a) for a in v] + [fill] * (MAXD - len(v))


def _pitches(shape):
    return [int(numpy.prod(shape[ax + 1:], dtype=numpy.int64)) for ax in range(len(shape))]


def _coords(lr, gr, qr):
    '''Per-axis coordinates r on the row grid ``gr`` (last axis fastest) of
    the local rows ``lr`` (numpy or torch integers), and their
    within-phase coordinates m = r // qr.'''
    r = [None] * len(gr)
    for ax in reversed(range(len(gr))):
        r[ax] = lr % gr[ax]
        lr = lr // gr[ax]
    return r, [ra // q for ra, q in zip(r, qr)]


def _block_table(meta):
    '''int32 [blocks, 22]: each block's row and column field offsets, row
    grid, column grid, pitch ratios qr and qc and wrap flags, axes padded to
    four with extent 1 (the block records ``csrc/blockgrid.cu`` reads).'''
    offsets, _fieldshapes, blocks = meta
    btab = numpy.zeros((len(blocks), _BCOLS), dtype=numpy.int32)
    for b, (i, j, gr, gc, qr, qc, _amin, _awid, wrap, _phmeta) in enumerate(blocks):
        if len(gr) > MAXD:
            raise ValueError(f'block grid rank {len(gr)} is above {MAXD}')
        btab[b] = [offsets[i], offsets[j], *_pad4(gr, 1), *_pad4(gc, 1), *_pad4(qr, 1), *_pad4(qc, 1),
                   *_pad4([bool(v) for v in wrap], 0)]
    return btab


class CompactPlan:
    '''K5's plan of one block-grid pattern: the rows grouped into classes,
    and the layout of the compact operand that the kernel reads.

    A class holds rows of one field that have a pattern entry in the same
    window slots of every block (one segment per block, its live slots in
    increasing order) and whose columns follow the same arithmetic: either
    ``base(m) + delta_s`` for every slot, or, where the window wraps a
    periodic axis, per axis (``checked``).  The compact operand holds the
    values class by class, slot-major within a class, so neighbouring rows
    of a class sit at neighbouring addresses; ``index`` says where each
    value sits in the flat weight buffer ``w``.  The plan depends on the
    pattern only: an entry that is zero in some Newton step keeps its place.

    A (block, phase) whose rows form more than ``MAX_CLASSES`` slot sets
    gives each of its rows the block's whole window instead (checked, the
    slots off a non-periodic grid skipped): listed in ``fallback``, and the
    compact operand then holds more values than the pattern.

    Tables (int32): ``rows`` (every row once, class by class), ``ctab``
    (class records), ``stab`` (segment records), ``slots`` (per live slot
    its column delta and its per-axis shifts as four signed bytes),
    ``btab`` (block records), ``tiles`` (the class of each thread
    block) and ``index`` (the gather of :func:`pack`).'''

    def __init__(self, meta, woff, total, index, rows, ctab, stab, slots, fallback):
        self.meta = meta
        self.woff = tuple(int(o) for o in woff)
        self.n = int(meta[0][-1])
        self.total = int(total)
        self.nv = len(index)
        self.index = index
        self.rows = rows
        self.ctab = ctab
        self.stab = stab
        self.slots = slots
        self.btab = _block_table(meta)
        self.tiles = numpy.repeat(numpy.arange(len(ctab), dtype=numpy.int32),
                                  -(-ctab[:, 1] // ROWS_PER_CTA)).astype(numpy.int32)
        self.fallback = tuple(fallback)
        self._dev = {}

    def classes_per_block(self):
        '''The number of classes with a segment on each block.'''
        return numpy.bincount(self.stab[:, 0], minlength=len(self.btab)).tolist()

    def tables(self, device):
        '''The plan's int32 tables on ``device``, uploaded once.'''
        key = str(device)
        if key not in self._dev:
            self._dev[key] = {name: torch.as_tensor(getattr(self, name), device=device)
                              for name in ('index', 'rows', 'ctab', 'stab', 'slots', 'btab', 'tiles')}
        return self._dev[key]


def compact_plan(meta, woff, csr_map, indptr, indices):
    '''The :class:`CompactPlan` of the block-grid layout (meta, woff) of a
    CSR pattern (indptr, indices) whose value k sits at ``w[csr_map[k]]``.
    Host work, O(nnz) and once per pattern; it reads no values.'''
    offsets, _fieldshapes, blocks = meta
    n, nb = int(offsets[-1]), len(blocks)
    shapes = _w_shapes(meta)
    woff = numpy.asarray(woff, dtype=numpy.int64)
    npix = numpy.array([int(numpy.prod(s[1:])) for s in shapes], dtype=numpy.int64)
    total = int(max((o + s[0] * p for o, s, p in zip(woff, shapes, npix)), default=0))
    csr_map = numpy.asarray(csr_map, dtype=numpy.int64)
    if max(total, len(csr_map), n) >= 2**31:
        raise ValueError('blockgrid: 2^31 weights, values or dofs or more; K5 indexes in 32 bits')
    nph = [len(blk[9]) for blk in blocks]
    k0 = numpy.concatenate([[0], numpy.cumsum(nph)[:-1]]).astype(numpy.int64)
    smax = max(int(numpy.prod(blk[7])) for blk in blocks)
    if smax > 128:
        raise ValueError(f'blockgrid: a window of {smax} slots; the plan keeps at most 128')

    # per block: each row's phase, place in its phase array and column base
    # (column offset included); each slot's shifts and column delta
    lo, hi, phase, mloc, base = [], [], [], [], []
    shifts = numpy.zeros((nb, smax, MAXD), dtype=numpy.int64)
    delta = numpy.zeros((nb, smax), dtype=numpy.int64)
    for b, (i, j, gr, gc, qr, qc, amin, awid, _wrap, phmeta) in enumerate(blocks):
        lo.append(offsets[i])
        hi.append(offsets[i + 1])
        r, m = _coords(numpy.arange(hi[b] - lo[b], dtype=numpy.int32), gr, qr)
        pc = _pitches(gc)
        psh = numpy.array([p[1] for p in phmeta], dtype=numpy.int32)
        ph = numpy.zeros(hi[b] - lo[b], dtype=numpy.int32)
        for ax in range(len(gr)):
            ph = ph * qr[ax] + r[ax] % qr[ax]
        ml = numpy.zeros_like(ph)
        for ax in range(len(gr)):
            ml = ml * psh[ph, ax] + m[ax]
        phase.append(ph)
        mloc.append(ml)
        base.append(offsets[j] + sum(numpy.int64(qc[ax] * pc[ax]) * m[ax] for ax in range(len(gr))))
        a = numpy.array(list(itertools.product(*[range(a0, a0 + wd) for a0, wd in zip(amin, awid)])),
                        dtype=numpy.int64).reshape(-1, len(gr))
        shifts[b, :len(a), :len(gr)] = a
        delta[b, :len(a)] = a @ numpy.array(pc, dtype=numpy.int64)

    # each entry's row, block and slot, in (row, block) order (a CSR
    # pattern's columns are sorted, and each block's columns are one field)
    rows = numpy.repeat(numpy.arange(n, dtype=numpy.int32), numpy.diff(numpy.asarray(indptr, dtype=numpy.int64)))
    k = numpy.searchsorted(woff, csr_map, side='right') - 1
    slot = (csr_map - woff[k]).astype(numpy.int32) // npix[k].astype(numpy.int32)
    blk = numpy.repeat(numpy.arange(nb, dtype=numpy.int8), nph)[k]
    del k
    cols = numpy.asarray(indices)
    group = rows.astype(numpy.int64) * nb + blk
    if not (group[1:] >= group[:-1]).all():
        order = numpy.argsort(group, kind='stable')
        rows, slot, blk, cols, group = rows[order], slot[order], blk[order], cols[order], group[order]
    # rows whose window wraps a periodic axis: an entry's column is not
    # base + delta (off a wrapped block it always is, as detect verified)
    checked = numpy.zeros(n, dtype=bool)
    for b, blk_meta in enumerate(blocks):
        if any(blk_meta[8]):
            sel = numpy.flatnonzero(blk == b)
            r = rows[sel]
            checked[r[base[b][r - lo[b]] + delta[b, slot[sel]] != cols[sel]]] = True
    # each (row, block)'s set of live slots as a 128-bit mask (two words),
    # OR-reduced over the (row, block)'s run of entries
    mask = numpy.zeros((n * nb, 2), dtype=numpy.uint64)
    if len(group):
        starts = numpy.flatnonzero(numpy.concatenate([[True], group[1:] != group[:-1]]))
        bit = numpy.left_shift(numpy.uint64(1), (slot & 63).astype(numpy.uint64))
        high = slot >= 64
        for wd, take in enumerate((~high, high)):
            mask[group[starts], wd] = numpy.bitwise_or.reduceat(numpy.where(take, bit, numpy.uint64(0)), starts)
    mask = mask.reshape(n, nb, 2)
    del rows, slot, blk, cols, group

    def set_ids(b):
        '''Dense ids of the slot sets of block b's rows.'''
        words = mask[lo[b]:hi[b], b]
        ids = numpy.unique(words[:, 0], return_inverse=True)[1].reshape(-1)
        if words[:, 1].any():
            hid = numpy.unique(words[:, 1], return_inverse=True)[1].reshape(-1)
            ids = numpy.unique(hid * (int(ids.max(initial=0)) + 1) + ids, return_inverse=True)[1].reshape(-1)
        return ids

    sids = [set_ids(b) for b in range(nb)]
    fallback = []
    for b, blk_meta in enumerate(blocks):
        S = int(numpy.prod(blk_meta[7]))
        nsid = int(sids[b].max(initial=0)) + 1
        pairs = numpy.unique(phase[b].astype(numpy.int64) * nsid + sids[b])
        counts = numpy.bincount(pairs // nsid, minlength=len(blk_meta[9]))
        for p in numpy.flatnonzero(counts > MAX_CLASSES):
            sel = lo[b] + numpy.flatnonzero(phase[b] == p)
            mask[sel, b] = [(1 << min(S, 64)) - 1, (1 << max(0, S - 64)) - 1]
            checked[sel] = True
            fallback.append((b, int(p)))
            sids[b] = set_ids(b)

    # classes: rows alike in field, every block's slot set and checked
    key = numpy.searchsorted(numpy.asarray(offsets), numpy.arange(n), side='right') - 1
    span = len(offsets)
    for b, sid in enumerate(sids):
        nsid = int(sid.max(initial=0)) + 1
        if span * nsid >= 2**62:
            key = numpy.unique(key, return_inverse=True)[1].reshape(-1)
            span = int(key.max(initial=0)) + 1
        full = numpy.zeros(n, dtype=numpy.int64)
        full[lo[b]:hi[b]] = sid
        key = key * nsid + full
        span *= nsid
    cls = numpy.unique(key * 2 + checked, return_inverse=True)[1].reshape(-1)
    order = numpy.argsort(cls, kind='stable').astype(numpy.int32)
    nrows = numpy.bincount(cls)
    row0 = numpy.concatenate([[0], numpy.cumsum(nrows)[:-1]])
    ctab = numpy.zeros((len(nrows), _CCOLS), dtype=numpy.int64)
    stab, slots, index_parts = [], [], []
    nv = 0
    for c, (r0, R) in enumerate(zip(row0, nrows)):
        crows = order[r0:r0 + R]
        rep = int(crows[0])
        ctab[c, :6] = [r0, R, nv, len(stab), 0, checked[rep]]
        kk = 0
        for b, blk_meta in enumerate(blocks):
            if not lo[b] <= rep < hi[b]:
                continue
            live = numpy.array([s for s in range(int(numpy.prod(blk_meta[7])))
                                if int(mask[rep, b, s >> 6]) >> (s & 63) & 1], dtype=numpy.int64)
            if not len(live):
                continue
            lr = crows - lo[b]
            kb = k0[b] + phase[b][lr]
            index_parts.append((woff[kb][None] + live[:, None] * npix[kb][None] + mloc[b][lr][None]).ravel())
            packed = sum((shifts[b, live, ax] & 0xff) << (8 * ax) for ax in range(MAXD))
            stab.append((b, len(slots), len(live)))
            slots.extend(zip(delta[b, live].tolist(), packed.astype(numpy.int32).tolist()))
            kk += len(live)
        ctab[c, 4] = len(stab) - ctab[c, 3]
        if ctab[c, 4] > MAX_SEGMENTS or kk > MAX_SLOTS:
            raise ValueError(f'blockgrid: a class of {ctab[c, 4]} blocks and {kk} slots; K5 takes at most '
                             f'{MAX_SEGMENTS} and {MAX_SLOTS}')
        nv += kk * R
    ctab[:, 6] = numpy.concatenate([[0], numpy.cumsum(-(-nrows // ROWS_PER_CTA))[:-1]])
    index = numpy.concatenate(index_parts) if index_parts else numpy.zeros(0, dtype=numpy.int64)
    if nv >= 2**31:
        raise ValueError('blockgrid: 2^31 compact values or more; K5 indexes in 32 bits')
    assert len(index) == nv and (fallback or nv == len(csr_map)), 'the classes do not rebuild the pattern'
    return CompactPlan(meta, woff, total, index.astype(numpy.int32), order, ctab.astype(numpy.int32),
                       numpy.array(stab, dtype=numpy.int32).reshape(-1, _SCOLS),
                       numpy.array(slots, dtype=numpy.int64).astype(numpy.int32).reshape(-1, 2), fallback)


def pack(w, plan):
    '''The compact operand of the flat weight buffer ``w``: one gather
    through the plan's int32 index table.'''
    return w.index_select(0, plan.tables(w.device)['index'])


def unpack(v, plan):
    '''The flat weight buffer of the compact operand ``v``, zero outside
    the pattern.'''
    index = plan.tables(v.device)['index'].long()
    return torch.zeros(plan.total, dtype=v.dtype, device=v.device).index_put_((index,), v)


def class_columns(plan, c, tables):
    '''(rows, columns [slots, rows], in-grid mask [slots, rows], slots per
    segment) of class ``c``, computed as the kernel computes them: base(m)
    plus each slot's delta, or per axis with wrap on a checked class.'''
    row0, nrows, _vbase, seg0, nseg, checked = (int(v) for v in plan.ctab[c, :6])
    rows = tables['rows'][row0:row0 + nrows].long()
    cols, inside, counts = [], [], []
    for b, first, K in plan.stab[seg0:seg0 + nseg].tolist():
        roff, coff = (int(v) for v in plan.btab[b, :2])
        gr, gc, qr, qc, wrap = (plan.btab[b, 2 + 4 * q:6 + 4 * q].tolist() for q in range(5))
        _r, m = _coords(rows - roff, gr, qr)
        pc = _pitches(gc)
        sl = tables['slots'][first:first + K].long()
        if not checked:
            base = sum(qc[ax] * pc[ax] * m[ax] for ax in range(MAXD))
            col = coff + base[None, :] + sl[:, :1]
            ins = torch.ones_like(col, dtype=torch.bool)
        else:
            col, ins = coff, torch.ones((K, nrows), dtype=torch.bool, device=rows.device)
            for ax in range(MAXD):
                a = (sl[:, 1] >> (8 * ax)) & 0xff
                cc = qc[ax] * m[ax][None, :] + (a - 256 * (a >= 128))[:, None]
                if wrap[ax]:
                    cc = cc % gc[ax]
                else:
                    ins = ins & (cc >= 0) & (cc < gc[ax])
                    cc = cc.clamp(0, gc[ax] - 1)
                col = col + cc * pc[ax]
        cols.append(col)
        inside.append(ins)
        counts.append(K)
    if not counts:
        empty = torch.zeros((0, nrows), dtype=torch.int64, device=rows.device)
        return rows, empty, empty.bool(), counts
    return rows, torch.cat(cols), torch.cat(inside), counts


def compact_matvec_plain(v, x, plan):
    '''Plain torch version of :func:`blockgrid_matvec` on the compact
    operand ``v``: per class, the gathers of ``x`` at the kernel's columns
    times the class's values, summed per block in slot order, the blocks
    added in order, each row written once.'''
    tables = plan.tables(x.device)
    y = torch.empty_like(x)
    zero = x.new_zeros(())
    for c in range(len(plan.ctab)):
        rows, cols, inside, counts = class_columns(plan, c, tables)
        vbase, nrows = int(plan.ctab[c, 2]), int(plan.ctab[c, 1])
        prod = v[vbase:vbase + cols.shape[0] * nrows].view(-1, nrows) * torch.where(inside, x[cols], zero)
        total = torch.zeros(nrows, dtype=x.dtype, device=x.device)
        kk = 0
        for K in counts:
            total = total + prod[kk:kk + K].sum(0)
            kk += K
        y.index_copy_(0, rows, total)
    return y


def blockgrid_matvec(v, x, plan, active=None):
    '''y = A x for the block-grid operator whose compact operand is ``v``
    (:func:`pack` of its weights) and flat ``x``: kernel K5
    (``csrc/blockgrid.cu``), replacing the device work of
    ``nutils_tpu.ops.blockgrid._matvec_fn``.  It reads each of the
    operator's values once, the row list once, ``x`` through L2 and writes
    ``y`` once, with no atomics.  ``active`` (int32, a Krylov loop's flag)
    makes the kernel do nothing while it is 0; ``y`` is then left
    unwritten.  Tensors on the CPU take :func:`matvec_plain`, the literal
    port, on the weights that ``v`` unpacks to; a CUDA tensor launches the
    kernel or raises.'''
    if x.device.type == 'cpu':
        return matvec_plain(unpack(v, plan), x, plan.meta, plan.woff)
    _kernels.check_operands('blockgrid_matvec', x, (plan.n,), x.dtype, v=(v, (plan.nv,)))
    _kernels.check_flag('blockgrid_matvec', active, x)
    t = plan.tables(x.device)
    y = torch.empty_like(x)
    _kernels.call('ntt_blockgrid_matvec', x, [v, x, y, t['rows'], t['ctab'], t['stab'], t['slots'], t['btab'],
                                              t['tiles'], active], scalars=(len(plan.tiles),))
    blockgrid_matvec.launches += 1
    return y


_kernels.counted(blockgrid_matvec)
