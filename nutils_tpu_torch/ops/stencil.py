'''Stencil (DIA-on-a-grid) operator form: detection from CSR (host, copied
from ``nutils_tpu.ops.stencil``) and the grid-stencil matvec.

On structured grids the assembled FEM operator couples each dof only with a
prod_i (2k_i+1) window of grid neighbors, so the CSR matrix is losslessly a
stencil:

    y[i1..id] = sum_{|a_i| <= k_i} w[a, i1..id] * x[i1 + a_1, ..., id + a_d]

with zero padding or periodic wrap per axis.  The matvec is the device
kernel K1 (``csrc/stencil.cu``, :func:`stencil_matvec`); :func:`matvec_plain`
is its plain torch version (the literal port of ``_matvec_fn``), taken for
tensors on the CPU.  :func:`from_csr` (grid inference) and
:func:`from_csr_grid` (a known grid, used by the multigrid set-up) are
pattern-verified host work: every nonzero must decompose into in-window
per-axis shifts; an unstructured pattern gives None.
'''

import itertools

import numpy
import torch

from .. import _kernels


class StencilForm:
    '''w [prod(2k_i+1), *shape] stencil weights plus grid metadata.

    ``shape``/``ks`` are outermost-axis-first (row-major flat index =
    coords . pitches with the largest pitch first); slot s of the leading w
    axis is the row-major index of the window offset (a_1 + k_1, ...,
    a_d + k_d) over window dims (2k_i + 1).'''

    __slots__ = ('w', 'ks', 'shape', 'slot', 'rows', 'periodic')

    def __init__(self, w, ks, shape, slot=None, rows=None, periodic=None):
        self.w = w
        self.ks = tuple(int(k) for k in ks)
        self.shape = tuple(int(s) for s in shape)
        self.slot = slot    # per-CSR-entry window slot (value refill plan)
        self.rows = rows    # per-CSR-entry row index
        self.periodic = tuple(bool(p) for p in periodic) if periodic is not None \
            else (False,) * len(self.shape)


def _decompose(d, pitches, dims, rows, max_k=None):
    '''Exactly decompose column offsets d (int64) over the mixed-radix grid
    given by descending ``pitches`` and ``dims``: both the row and the
    column are valid grid indices, so the per-axis window shift is simply
    the difference of their grid coordinates — no rounding, no ambiguity
    (round-division picks the wrong representative when windows alias, e.g.
    interleaved component axes).  When ``max_k`` is given, axes whose plain
    shifts exceed it are retried with periodic wrap canonicalization
    (shift modulo the axis size, centered) — exact either way, since the
    matvec wrap-pads flagged axes.  Returns (ok, A, periodic).'''
    r = rows.astype(numpy.int64)
    c = r + d.astype(numpy.int64)
    A = []
    periodic = []
    for p, dim in zip(pitches, dims):
        a = (c // p) % dim - (r // p) % dim
        wrap = False
        if max_k is not None and len(a) and int(numpy.abs(a).max(initial=0)) > max_k \
                and dim > 2 * max_k + 1:
            aw = (a + dim // 2) % dim - dim // 2
            if int(numpy.abs(aw).max(initial=0)) <= max_k:
                a = aw
                wrap = True
        A.append(a)
        periodic.append(wrap)
    return numpy.ones(len(d), dtype=bool), A, periodic


def _pitch_dims(pitches_desc, n):
    '''Grid dims (outermost first) for descending pitches; None when the
    pitch tower is not a divisor chain of n.'''
    dims = []
    prev = n
    for p in pitches_desc:
        if prev % p:
            return None
        dims.append(prev // p)
        prev = p
    if prev != 1:
        # innermost pitch > 1: dofs within a pitch-1 residue never couple;
        # expose them as an extra innermost axis with zero window
        dims.append(prev)
        return dims, list(pitches_desc) + [1]
    return dims, list(pitches_desc)


def from_csr(data, indices, indptr, n, max_k=3, max_dim=4, sample=8192):
    '''Detect a d-dimensional grid-stencil layout of an n x n CSR matrix;
    returns a StencilForm or None.  O(nnz) vectorized host work; pitch
    candidates are pre-screened on the (small) set of unique offsets and a
    row sample so unstructured matrices reject cheaply.'''
    data = numpy.asarray(data)
    indices = numpy.asarray(indices)
    if n == 0 or len(data) == 0:
        return None
    counts = numpy.diff(indptr)
    rows = numpy.repeat(numpy.arange(n), counts)
    d = indices.astype(numpy.int64) - rows
    offs = numpy.unique(numpy.abs(d))
    offs = offs[offs > 0]
    if len(offs) == 0:
        return None  # pure diagonal: Jacobi handles it better than a stencil
    step = max(1, len(d) // sample)
    d_s, rows_s = d[::step], rows[::step]

    def covered(o, pitches_desc):
        rem = int(o)
        for p in pitches_desc:
            a = (rem + (p >> 1)) // p
            if abs(a) > max_k:
                return False
            rem -= a * p
        return rem == 0

    wrap_k = [None]  # pass 1: plain deltas only; pass 2 allows periodic wrap

    def verify(pitches_desc):
        pd = _pitch_dims(pitches_desc, n)
        if pd is None:
            return None
        dims, pitches = pd
        if len(dims) > max_dim:
            return None
        _ok, A_s, _per = _decompose(d_s, pitches, dims, rows_s, wrap_k[0])
        if max((int(numpy.abs(a).max(initial=0)) for a in A_s), default=0) > max_k:
            return None
        _ok, A, periodic = _decompose(d, pitches, dims, rows, wrap_k[0])
        ks = [int(numpy.abs(a).max(initial=0)) for a in A]
        if max(ks, default=0) > max_k:
            return None
        if int(numpy.prod([2 * k + 1 for k in ks])) > (2 * max_k + 1) ** 3:
            return None  # window too large to slice-enumerate profitably
        return dims, pitches, ks, A, periodic

    budget = [96]  # total candidate verifications across the whole search
    hits = []      # all verified towers; the best by quality() wins

    def quality(dims_, ks_, per_):
        ncoarsen = sum(1 for s, p in zip(dims_, per_) if s >= 5 and s % 2 == 1 and not p)
        W_ = int(numpy.prod([2 * k + 1 for k in ks_]))
        return (ncoarsen, -W_)

    def search(pitches_desc):
        # smallest positive offset not representable with current pitches
        # (round-division screen; the exact verify is the arbiter, so try it
        # on the current tower first whenever the screen is in doubt)
        unc = [o for o in offs if not covered(o, pitches_desc)]
        if not unc or pitches_desc:
            if budget[0] <= 0:
                return
            budget[0] -= 1
            res = verify(pitches_desc)
            if res is not None:
                hits.append(res)
            if not unc:
                return
        if len(pitches_desc) + 1 > max_dim or len(hits) >= 6:
            return
        o = int(unc[0])
        span = max_k * sum(pitches_desc) if pitches_desc else 0
        # a new outermost pitch p satisfies o = a*p + c for some covered
        # combination c (|c| <= span) and a in [1, max_k]; overlapping
        # windows are legal (the decomposition is exact coordinate deltas),
        # so the only structural requirements are monotone growth and the
        # divisor-chain check inside verify
        prev = pitches_desc[0] if pitches_desc else 0
        cands, seen = [], set()
        for a in range(1, max_k + 1):            # likely candidates first:
            for ac in range(span + 1):           # a=1 and small |c| (higher
                for c in (ac, -ac) if ac else (0,):  # a aliases the grid)
                    if (o - c) % a == 0:
                        p = (o - c) // a
                        # every pitch divides the next and the outermost
                        # divides n, so any viable pitch divides n and is a
                        # multiple of the previous one
                        if p > prev and n % p == 0 and (prev == 0 or p % prev == 0) \
                                and p not in seen:
                            seen.add(p)
                            cands.append(p)
        for p in cands:
            if budget[0] <= 0 or len(hits) >= 6:
                return
            search([p] + pitches_desc)

    # prefer non-wrapped factorizations: a periodic reading can rescue an
    # aliased tower, so wrap is only allowed once the plain pass fails;
    # among verified towers the best hierarchy (most coarsenable axes, then
    # smallest window) wins — aliased factorizations are exact but bloat
    # the window and defeat multigrid
    search([])
    if not hits:
        wrap_k[0] = max_k
        budget[0] = 96
        search([])
    if not hits:
        return None
    dims, pitches, ks, A, periodic = max(hits, key=lambda h: quality(h[0], h[2], h[4]))

    # axis-refinement pass: a flat factorization can merge a short inner
    # axis (vector components) into a spatial one — exact for the matvec,
    # but the merged even axis blocks multigrid coarsening.  Split even
    # axes into (odd, short) pairs when the finer tower also verifies AND
    # actually improves the hierarchy (more coarsenable axes, or the same
    # with a smaller window).
    changed = True
    while changed:
        changed = False
        for ax in range(len(dims)):
            if dims[ax] % 2 == 0:
                for s in (2, 3, 4):
                    if dims[ax] % s == 0 and (dims[ax] // s) % 2 == 1 and dims[ax] // s > 1:
                        rdims = dims[:ax] + [dims[ax] // s, s] + dims[ax + 1:]
                        rpitches = [int(numpy.prod(rdims[i + 1:])) for i in range(len(rdims))]
                        res = verify(rpitches) if len(rdims) <= max_dim else None
                        if res is not None and quality(res[0], res[2], res[4]) \
                                > quality(dims, ks, periodic):
                            dims, pitches, ks, A, periodic = res
                            changed = True
                            break
                if changed:
                    break
    windows = [2 * k + 1 for k in ks]
    W = int(numpy.prod(windows))
    slot = numpy.zeros(len(d), dtype=numpy.int64)
    for a, k, wdim in zip(A, ks, windows):
        slot = slot * wdim + (a + k)
    w = numpy.zeros((W, n), dtype=data.dtype)
    w[slot, rows] = data
    return StencilForm(w.reshape([W] + dims), tuple(ks), tuple(dims), slot, rows,
                       tuple(periodic))


def refill(ks, shape, slot, rows, data):
    '''Rebuild the stencil weight array from fresh CSR values using a cached
    (slot, rows) plan — the per-Newton-step path when the sparsity pattern is
    constant and only values change (no re-detection).'''
    data = numpy.asarray(data)
    n = int(numpy.prod(shape))
    W = int(numpy.prod([2 * k + 1 for k in ks]))
    w = numpy.zeros((W, n), dtype=data.dtype)
    w[slot, rows] = data
    return w.reshape([W] + list(shape))


def from_csr_grid(data, indices, indptr, shape, max_k=3):
    '''Stencil form of a CSR matrix over a KNOWN grid ``shape`` (outermost
    first); returns StencilForm or None when some nonzero leaves the window
    or the grid.  Used by the multigrid setup, where the coarse grids are
    known geometrically and re-inference could pick an aliased
    factorization.'''
    data = numpy.asarray(data)
    indices = numpy.asarray(indices)
    shape = [int(s) for s in shape]
    n = int(numpy.prod(shape))
    if n != len(indptr) - 1 or len(data) == 0:
        return None
    counts = numpy.diff(indptr)
    rows = numpy.repeat(numpy.arange(n), counts)
    d = indices.astype(numpy.int64) - rows
    pitches = [int(numpy.prod(shape[i + 1:])) for i in range(len(shape))]
    _ok, A, periodic = _decompose(d, pitches, shape, rows, max_k)
    ks = [int(numpy.abs(a).max(initial=0)) for a in A]
    if max(ks, default=0) > max_k:
        return None
    windows = [2 * k + 1 for k in ks]
    W = int(numpy.prod(windows))
    slot = numpy.zeros(len(d), dtype=numpy.int64)
    for a, k, wdim in zip(A, ks, windows):
        slot = slot * wdim + (a + k)
    w = numpy.zeros((W, n), dtype=data.dtype)
    w[slot, rows] = data
    return StencilForm(w.reshape([W] + shape), tuple(ks), tuple(shape), slot, rows,
                       tuple(periodic))


def matvec_plain(w, x, ks, shape, periodic=None):
    '''Plain torch stencil matvec: w [W, *shape], x [*shape] -> [*shape]
    (the literal port of ``nutils_tpu.ops.stencil._matvec_fn``: wrap-pad the
    periodic axes, zero-pad the others, accumulate the W shifted slices in
    slot order).'''
    windows = [2 * k + 1 for k in ks]
    periodic = periodic or (False,) * len(ks)
    xp = x
    for ax, (k, per) in enumerate(zip(ks, periodic)):
        if k and per:
            # wrap-pad: periodic couplings read across the seam
            n = shape[ax]
            xp = torch.cat([xp.narrow(ax, n - k, k), xp, xp.narrow(ax, 0, k)], dim=ax)
    zpad = []
    for k, per in reversed(list(zip(ks, periodic))):
        zpad += [0, 0] if per else [k, k]
    if any(zpad):
        xp = torch.nn.functional.pad(xp, zpad)
    acc = torch.zeros_like(x)
    for s, shifts in enumerate(itertools.product(*[range(m) for m in windows])):
        sl = tuple(slice(o, o + n) for o, n in zip(shifts, shape))
        acc = acc + w[s] * xp[sl]
    return acc


# K1's tiled form and K2's component form (``csrc/grid.cuh``'s row tiles):
# the components a trailing axis may hold, the fewest rows of points a tile
# has (float64's), and the rows of tiles a launch's grid may hold
TILE_COMPONENTS = 3
TILE_ROWS = 8
MAX_GRID_Y = 65535


def matvec_form(ks, shape, periodic):
    '''The form of K1 for a grid (a pure function of it): ``'tile'`` for
    half-width 1 on a 2-D grid, or on a grid (n0, n1, V) whose last axis
    holds at most :data:`TILE_COMPONENTS` components and is not periodic
    (a vector field's), within the launch grid's rows; ``'generic'`` for
    every other grid (wider stencils, 1-D, 4-D, more components, a periodic
    last axis).'''
    ks, shape = tuple(int(k) for k in ks), tuple(int(s) for s in shape)
    periodic = tuple(bool(p) for p in periodic)
    rows = len(ks) == 2 or len(ks) == 3 and 1 <= shape[2] <= TILE_COMPONENTS and not periodic[2]
    fits = -(-shape[0] // TILE_ROWS) <= MAX_GRID_Y
    return 'tile' if rows and all(k == 1 for k in ks) and fits else 'generic'


def stencil_matvec(w, x, ks, shape, periodic=None, active=None):
    '''y = A x for the grid stencil ``w`` [W, *shape] and ``x`` [*shape].

    Kernel K1 (``csrc/stencil.cu``), replacing the device work of
    ``nutils_tpu.ops.stencil._matvec_fn`` (the function the deleted Pallas
    stencil kernel computed), in its form for the grid
    (:func:`matvec_form`: tiled, x staged with its halo in shared memory,
    or generic, one thread a dof), both with the same bits.  It is
    memory-bound: (W + 2) values move per dof, the W slot-major weights
    read coalesced.  ``active`` (int32, the CG loop's flag, ``ops/cg.py``)
    makes the kernel do nothing while it is 0; ``y`` is then left
    unwritten.  Tensors on the CPU take :func:`matvec_plain`; a CUDA tensor
    launches the kernel or raises.  ``stencil_matvec.forms`` counts the
    launches by form.'''
    ks = tuple(int(k) for k in ks)
    shape = tuple(int(s) for s in shape)
    periodic = tuple(bool(p) for p in (periodic or (False,) * len(ks)))
    if x.device.type == 'cpu':
        return matvec_plain(w, x, ks, shape, periodic)
    W = int(numpy.prod([2 * k + 1 for k in ks]))
    _kernels.check_operands('stencil_matvec', x, shape, x.dtype, w=(w, (W,) + shape))
    _kernels.check_flag('stencil_matvec', active, x)
    y = torch.empty_like(x)
    form = matvec_form(ks, shape, periodic)
    _kernels.launch('ntt_stencil_tile' if form == 'tile' else 'ntt_stencil_matvec', x, [w, x, y, active], shape,
                    ks=ks, periodic=periodic)
    _kernels.count(stencil_matvec, form)
    return y


_kernels.counted(stencil_matvec, forms=('tile', 'generic'))


def matvec(form, w_dev, x):
    '''y = A x for x of shape [prod(shape)] (flat) or [*shape]; same shape
    out.'''
    flat = x.ndim == 1
    xg = x.reshape(form.shape) if flat else x
    y = stencil_matvec(w_dev, xg, form.ks, form.shape, form.periodic)
    return y.reshape(-1) if flat else y


def matvec_numpy(w, x, ks, shape, periodic=None):
    '''Host (numpy, any dtype) counterpart of :func:`_matvec_fn`: exact
    float64 stencil matvec for the iterative-refinement residual, so the
    refinement loop never needs the CSR materialization of the operator
    (matrix._device_krylov).  ``w`` [W, *shape], ``x`` [*shape] or flat.'''
    w = numpy.asarray(w)
    windows_total = int(numpy.prod([2 * k + 1 for k in ks]))
    w = w.reshape((windows_total,) + tuple(shape))
    x = numpy.asarray(x)
    flat = x.ndim == 1
    xg = x.reshape(shape) if flat else x
    periodic = periodic or (False,) * len(ks)
    windows = [2 * k + 1 for k in ks]
    xp = xg
    for ax, (k, per) in enumerate(zip(ks, periodic)):
        if k and per:
            sl = [slice(None)] * xp.ndim
            sl[ax] = slice(xp.shape[ax] - k, xp.shape[ax])
            front = xp[tuple(sl)]
            sl[ax] = slice(0, k)
            back = xp[tuple(sl)]
            xp = numpy.concatenate([front, xp, back], axis=ax)
    zpad = [(0, 0) if per else (k, k) for k, per in zip(ks, periodic)]
    if any(p != (0, 0) for p in zpad):
        xp = numpy.pad(xp, zpad)
    acc = numpy.zeros(shape, dtype=numpy.result_type(w.dtype, x.dtype))
    for s, shifts in enumerate(itertools.product(*[range(m) for m in windows])):
        sl = tuple(slice(o, o + n) for o, n in zip(shifts, shape))
        acc += w[s] * xp[sl]
    return acc.reshape(-1) if flat else acc
