'''Solver layer: System assembly of residuals and jacobians by localized AD.

The ``System`` of ``nutils_tpu.solver`` on torch (reference:
solver.py:189 ``System``).  Host planning is copied: every appearance of a
trial/test argument in a lowered integral is a localized gather that
becomes a Leaf (``_localize``); the jacobian layout (``_jac_layout``) and
the stencil-form plan (``_plan_stencil_jacobian``, ``_plan_value_table``,
``_grid_plan``) are the JAX package's, so the value order and slot order
match it exactly.  The traces are torch:

* the residual of each test localization is ``torch.func.grad`` of the
  scalar functional with respect to the leaf;
* jacobian blocks are ``torch.func.jvp`` of that gradient with respect to
  each trial leaf, pushed through ``torch.func.vmap`` over the unit seeds of
  the local dofs, giving exact per-element dense blocks
  (``torch.func.linearize`` traces with ``make_fx``, which refuses the
  nested forward-mode jvps of the coordinate ``Grad`` nodes);
* values land in the flat stencil or block-grid weight buffer ``w`` through
  strided slice adds into a zeroed buffer, in place, after the transforms
  have produced them (``_apply_value_plan``).

Multi-field structured systems (Taylor-Hood velocity and pressure) assemble
into block-grid weights (``_plan_blockgrid_jacobian``, ``ops/blockgrid.py``),
in the natural axis order of each block: the JAX package's axis
permutation for the TPU's tiling is not ported.  A jacobian with neither
form (an unstructured mesh) assembles into CSR values on the device through
the pattern's value scatter (kernel K8, ``SparsePattern.scatter``).
``fused_step_op`` is the assemble + Schur diagonal + refined GMRES step of
block-grid systems as a plain composition.  A batch of more than
``config.assembly_chunk`` elements is assembled a chunk of elements at a time
(``System._chunk_plan``).  The functional's value (``assemble_value``) is
its integrand at the points summed by kernel K15.  ``System.solve`` (with
:class:`Direct`, :class:`Newton`, :class:`ReuseNewton`,
:class:`LinesearchNewton` under :class:`NormBased` or
:class:`MedianBased`, and :class:`Minimize`) and
``System.solve_constraints`` are the reference's, as are ``System.step``
(time stepping with timestep-halving retry), :class:`Arnoldi`,
:class:`Pseudotime` and the legacy functions (``solve_linear``, ``newton``,
``minimize``, ``pseudotime``, ``thetamethod``, ``impliciteuler``,
``cranknicolson``, ``optimize``).  Every step of a time loop passes its
history, time and timestep as arguments of the assembly, so one System's
layout, plans and feature operators serve the whole run.
'''

import contextlib
import copy
import functools
import hashlib
import math
import pickle

import numpy
import torch

from . import evaluable as ev
from . import cache, function, matrix
from .ops import assembly
from .utils import _log as log
from .utils import config


class SolverError(Exception):
    pass


# ------------------------------------------------------------ line search

class NormBased:
    '''Line-search strategy minimizing a cubic model of the squared residual
    norm (reference: ``nutils_tpu/solver.py:45``).

    Given the residual and directional derivative at relaxation 0 and at the
    candidate point, fit |res(x + r dx)|^2 ~ A + B r + C r^2 + D r^3 and pick
    the relaxation scale at which the model is minimal.  Returns ``(scale,
    accept)``: the multiplicative update for the relaxation value, and
    whether the candidate point is acceptable.'''

    def __init__(self, minscale=.01, acceptscale=2/3., maxscale=2.):
        assert 0 < minscale < acceptscale < 1 < maxscale
        self.minscale = minscale
        self.acceptscale = acceptscale
        self.maxscale = maxscale

    def __call__(self, res0, dres0, res1, dres1):
        if not numpy.isfinite(res1).all():
            return self.minscale, False
        # squared-norm samples and slopes at r=0 and r=1
        p0 = float(res0 @ res0)
        q0 = 2 * float(res0 @ dres0)
        p1 = float(res1 @ res1)
        q1 = 2 * float(res1 @ dres1)
        if q0 >= 0:
            raise SolverError('search vector does not reduce the residual')
        # cubic fit P(r) = p0 + q0 r + c r^2 + d r^3 through both samples
        c = math.fsum([-3 * p0, 3 * p1, -2 * q0, -q1])
        d = math.fsum([2 * p0, -2 * p1, q0, q1])
        # stationary points of P solve q0 + 2 c r + 3 d r^2 = 0; the
        # numerically stable (Citardauq) root, since q0 < 0
        disc = c**2 - 3 * q0 * d
        scale = -q0 / (c + math.sqrt(disc)) if disc > 0 and (c > 0 or d > 0) else math.inf
        if scale >= 1 and p1 > p0:
            return self.minscale, False
        return min(max(scale, self.minscale), self.maxscale), scale >= self.acceptscale and p1 < p0


class MedianBased:
    '''Line-search strategy placing the chosen quantile of per-entry optimal
    relaxations beyond the current one (reference:
    ``nutils_tpu/solver.py:87``).  Invariant to per-equation scaling of the
    residual, unlike :class:`NormBased`.'''

    def __init__(self, minscale=.01, acceptscale=2/3., maxscale=2., quantile=.5):
        assert 0 < minscale < acceptscale < 1 < maxscale
        assert 0 < quantile < 1
        self.minscale = minscale
        self.acceptscale = acceptscale
        self.maxscale = maxscale
        self.quantile = quantile

    def __call__(self, res0, dres0, res1, dres1):
        if not numpy.isfinite(res1).all():
            return self.minscale, False
        # per-entry cubic models of the squared residual components
        dp = res1**2 - res0**2
        q0 = 2 * res0 * dres0
        q1 = 2 * res1 * dres1
        decreasing = q0 <= 0  # entries whose model decreases at r=0
        n = round(len(res0) * self.quantile) - int((~decreasing).sum())
        if n < 0:
            raise SolverError(f'search vector fails to reduce more than the {self.quantile}-quantile of the residual')
        c = 3 * dp - 2 * q0 - q1
        d = -2 * dp + q0 + q1
        disc = c**2 - 3 * q0 * d
        ok = decreasing & (disc > 0)
        numer = -q0[ok]
        denom = c[ok] + numpy.sqrt(disc[ok])
        pos = denom > 0
        if n < int(pos.sum()):
            scales = numpy.sort(numer[pos] / denom[pos])
            scale = float(scales[n])
        else:
            scale = numpy.inf
        return min(max(scale, self.minscale), self.maxscale), scale >= self.acceptscale


# ------------------------------------------------------------ localization

def _pack_complex(v):
    '''Pack a complex ndarray into the real backing layout (..., 2); NaN in
    the real part (free-dof marker) propagates to the imag part.'''
    v = numpy.asarray(v)
    if v.dtype.kind == 'c':
        im = numpy.where(numpy.isnan(v.real), numpy.nan, v.imag)
        return numpy.stack([v.real, im], axis=-1)
    return v


def _grid_plan(idx, N):
    '''Detect the structured-grid affine layout of a constant index table:

        idx[e, t...] == base[t] + sum_ax coord_ax(e) * stride_ax

    with the element index e unraveled row-major over an element grid of any
    rank — the shape of every dof table a structured (tensor-product) basis
    produces, in 1-D through 3-D (and beyond).  Returns
    (eshape, strides, bases [T]) or None; ``strides`` are outermost-first
    and form a divisor chain, so gathers and scatter-adds become static
    unit-stride slices of a nested grid view instead of element-granular
    gathers and scatters.  The match is
    verified exactly over the whole table, so the fast paths can never
    change results.'''
    idx = numpy.asarray(idx)
    if idx.ndim < 2 or idx.shape[0] < 4:
        return None
    E = idx.shape[0]
    flatT = idx.reshape(E, -1)
    col = flatT[:, 0].astype(numpy.int64)
    dims, strides = [], []   # innermost-first factorization of the e axis
    seg = col
    while len(seg) > 1:
        d0 = numpy.diff(seg)
        s = int(d0[0])
        if s < 1:
            return None
        jumps = numpy.nonzero(d0 != s)[0]
        n0 = int(jumps[0] + 1) if len(jumps) else len(seg)
        if len(seg) % n0:
            return None
        dims.append(n0)
        strides.append(s)
        seg = seg[::n0]
    if not dims:
        return None
    eshape = tuple(reversed(dims))
    strides_o = tuple(reversed(strides))
    for a, b in zip(strides_o[:-1], strides_o[1:]):
        if a % b:
            return None  # no nested unit-stride view exists
    e = numpy.arange(E)
    coords = numpy.stack(numpy.unravel_index(e, eshape), axis=1)
    grid = coords @ numpy.array(strides_o, dtype=numpy.int64)
    if not numpy.array_equal(flatT, flatT[:1] + (grid - grid[0])[:, None]):
        return None
    bases = (flatT[0] - grid[0]).astype(numpy.int64)
    if len(bases) and bases.min() < 0:
        return None
    for b in bases:  # slices must not wrap within the nested view
        cs = _view_coords(int(b), strides_o)
        for i in range(1, len(eshape)):
            if cs[i] + eshape[i] > strides_o[i - 1] // strides_o[i]:
                return None
    return eshape, strides_o, bases


def _view_coords(b, strides_o):
    '''Mixed-radix coordinates of flat offset b in the nested view: one
    coordinate per element axis plus the innermost residual.'''
    cs = []
    rem = b
    for s in strides_o:
        cs.append(rem // s)
        rem -= cs[-1] * s
    cs.append(rem)
    return cs


def _grid_view(flat, plan):
    '''Padded nested-grid view of the flat dof vector plus its slice
    geometry: (view, vshape, pad).  Without padding the view shares
    storage with ``flat``.'''
    eshape, strides, bases = plan
    s0 = strides[0]
    top = max((int(b) // s0 for b in bases), default=0) + eshape[0]
    m0 = max(top, -(-flat.shape[0] // s0))
    pad = m0 * s0 - flat.shape[0]
    v = torch.nn.functional.pad(flat, (0, pad)) if pad else flat
    vshape = (m0,) + tuple(strides[i - 1] // strides[i] for i in range(1, len(strides))) \
        + (strides[-1],)
    return v.reshape(vshape), vshape, pad


def _slices(plan, b):
    eshape, strides, _bases = plan
    cs = _view_coords(int(b), strides)
    return tuple(slice(cs[i], cs[i] + eshape[i]) for i in range(len(eshape))) \
        + (slice(cs[-1], cs[-1] + 1),)


def _slice_gather(flat, plan, trailing_shape):
    '''[N] -> [E, *trailing] through static unit-stride slices of the padded
    nested grid view (the slice-form counterpart of flat[idx]).'''
    eshape, strides, bases = plan
    view, _vshape, _pad = _grid_view(flat, plan)
    E = int(numpy.prod(eshape))
    parts = [view[_slices(plan, b)].reshape(-1) for b in bases]
    out = torch.stack(parts, dim=-1) if len(parts) > 1 else parts[0][:, None]
    return out.reshape((E,) + tuple(trailing_shape))


def _slice_scatter_add(r, plan, v):
    '''r[idx] += v in place via static unit-stride slice adds; v [E,
    *trailing] (C-order trailing matching the plan's bases).'''
    eshape, strides, bases = plan
    view, _vshape, pad = _grid_view(r, plan)
    vf = v.reshape(v.shape[0], -1)
    for t, b in enumerate(bases):
        view[_slices(plan, b)] += vf[:, t].reshape(tuple(eshape) + (1,))
    if pad:  # the view is a padded copy: write the valid part back
        r.copy_(view.reshape(-1)[:r.shape[0]])
    return r


def _grouped_plan(ts, gk, total):
    '''Per-column-group affine plans (phased buffers with different row
    pitches have a per-column-constant group key), or None.'''
    if gk is None or not len(ts) or not (gk == gk[:1]).all():
        return None
    groups = {}
    for j in range(gk.shape[1]):
        groups.setdefault(int(gk[0, j]), []).append(j)
    if len(groups) == 1:
        return None  # single group == the whole table, already tried
    out = []
    for wi, cols in sorted(groups.items()):
        p = _grid_plan(ts[:, cols], total)
        if p is None:
            return None
        out.append((numpy.asarray(cols), p))
    return out


def _grid_row_candidates(tseg):
    '''Candidate element-grid row lengths: jump spacings of sampled target
    columns (the mode of the distances between stride breaks), plus the
    exact whole-table period when one exists.'''
    E, C = tseg.shape
    cands = []
    for j in range(0, C, max(1, C // 8)):
        col = tseg[:, j]
        d = numpy.diff(col)
        if not len(d):
            continue
        vals, counts = numpy.unique(d, return_counts=True)
        s = vals[numpy.argmax(counts)]
        jumps = numpy.nonzero(d != s)[0]
        if not len(jumps):
            continue
        spacing = numpy.diff(jumps)
        p = int(numpy.bincount(spacing).argmax()) if len(spacing) else int(jumps[0]) + 1
        if 2 <= p < E and E % p == 0 and p not in cands:
            cands.append(p)
    for p in range(2, E // 2 + 1):
        if E % p:
            continue
        d = tseg[p:] - tseg[:-p]
        if (d == d[:1]).all():
            if p not in cands:
                cands.append(p)
            break
    return cands


def _plan_value_table(tseg, groupkey, total, depth=2):
    '''Accumulation plan for a constant target table [E, C] into a flat
    buffer of size ``total``: ('slice', plan) when the whole table is
    grid-affine, ('grouped', [(cols, plan), ...]) when targets split into
    per-column affine groups, ('banded', (ny, nx, inner?, bands)) when the
    element grid splits into bands that plan recursively — outer bands for
    boundary-row anomalies (e.g. masked-basis fallback dofs on edge
    elements), inner per-column-of-the-grid bands for periodic seams (the
    seam pattern repeats every grid row) — or ('scatter', flat) as the
    element-granular fallback.  Bands are reached by pure reshapes/slices
    of the value tensor; a small scatter remainder (<=1/4 of the entries)
    is tolerated inside a banding.'''
    E, C = tseg.shape
    if E >= 4:
        plan = _grid_plan(tseg, total)
        if plan is not None:
            return 'slice', plan
    g = _grouped_plan(tseg, groupkey, total)
    if g is not None:
        return 'grouped', g
    if depth > 0 and E >= 8:
        for nx in _grid_row_candidates(tseg):
            ny = E // nx
            if ny < 2:
                continue
            t3 = tseg.reshape(ny, nx, C)
            g3 = None if groupkey is None else groupkey.reshape(ny, nx, C)

            def subplan(ts, gk):
                sp = _plan_value_table(ts, gk, total, depth - 1)
                return sp, (ts.size if sp[0] == 'scatter' else 0)

            # outer bands: runs of grid rows with identical intra-row shape
            sigs = [(t3[r] - t3[r, :1, :1]).tobytes() for r in range(ny)]
            runs = []
            lo = 0
            for r in range(1, ny + 1):
                if r == ny or sigs[r] != sigs[lo]:
                    runs.append((lo, r))
                    lo = r
            if 1 < len(runs) <= 12:
                bands, scat = [], 0
                for rlo, rhi in runs:
                    sp, s = subplan(t3[rlo:rhi].reshape(-1, C),
                                    None if g3 is None else g3[rlo:rhi].reshape(-1, C))
                    bands.append((rlo, rhi, sp))
                    scat += s
                if scat * 4 <= tseg.size:
                    return 'banded', (ny, nx, False, bands)
            elif len(runs) == 1:
                # all grid rows alike (periodic seams): per-inner-index bands,
                # greedily merged
                bands, scat = [], 0
                lo = 0
                while lo < nx:
                    hi = lo + 1
                    best, s = subplan(t3[:, lo:hi].reshape(-1, C),
                                      None if g3 is None else g3[:, lo:hi].reshape(-1, C))
                    while hi < nx and best[0] != 'scatter':
                        cand, cs = subplan(t3[:, lo:hi + 1].reshape(-1, C),
                                           None if g3 is None else g3[:, lo:hi + 1].reshape(-1, C))
                        if cand[0] == 'scatter':
                            break
                        best, s = cand, cs
                        hi += 1
                    bands.append((lo, hi, best))
                    scat += s
                    lo = hi
                if scat * 4 <= tseg.size and len(bands) <= 16:
                    return 'banded', (ny, nx, True, bands)
    return 'scatter', _RowSums(tseg)


class _RowSums:
    '''Accumulation of values into constant targets of a flat buffer,
    ``w[targets] += values``, in the same order on every run.  On a card the
    values are summed per distinct target by the value scatter K8 (the
    targets sorted once, stably, with a segment pointer per distinct
    target: a fixed order) and each sum is added to its target once, so no
    two additions race; float atomics (``index_add_`` over the raw targets)
    add in an order that changes from run to run.  A buffer on the CPU takes
    ``index_add_``, which adds in entry order there.'''

    def __init__(self, targets):
        self.targets = numpy.ascontiguousarray(targets).reshape(-1)
        self._tables = {}

    def _device_tables(self, device):
        '''(distinct targets, order, segment pointers, segment of each
        entry) on ``device``: int32 order and pointers for K8 on a card,
        int64 segment ids for its plain version on the CPU.'''
        key = str(device)
        if key not in self._tables:
            order = numpy.argsort(self.targets, kind='stable')
            ts = self.targets[order]
            new = numpy.ones(len(ts), dtype=bool)
            numpy.not_equal(ts[1:], ts[:-1], out=new[1:])
            segptr = numpy.append(numpy.flatnonzero(new), len(ts))
            if device.type == 'cpu':
                seg = numpy.empty(len(ts), dtype=numpy.int64)
                seg[order] = numpy.cumsum(new) - 1
                tabs = (None, torch.as_tensor(segptr), torch.as_tensor(seg))
            else:
                if len(ts) >= 2**31:
                    raise ValueError('the value scatter indexes entries in 32 bits: 2^31 entries or more')
                tabs = tuple(torch.as_tensor(a.astype(numpy.int32), device=device) for a in (order, segptr)) \
                    + (None,)
            self._tables[key] = (torch.as_tensor(ts[new], dtype=torch.int64, device=device),) + tabs
        return self._tables[key]

    def add_into(self, w, values):
        '''``w[targets] += values`` in place (``values`` flat, in target
        order).'''
        if w.device.type == 'cpu':
            return w.index_add_(0, torch.as_tensor(self.targets, dtype=torch.int64), values)
        return self.add_sorted(w, values)

    def add_sorted(self, w, values):
        '''The sorted segment sums added into ``w``: K8 on a card, its
        plain version on the CPU.'''
        from .ops.sparse import csr_scatter
        utargets, order, segptr, seg = self._device_tables(w.device)
        return w.index_add_(0, utargets, csr_scatter(values, order, segptr, seg))


def _apply_value_plan(w, skind, payload, V):
    '''Apply a _plan_value_table plan: accumulate the value table V
    (leading element axis) into the flat buffer w, in place.'''
    Vf = V.reshape(V.shape[0], -1)
    if skind == 'slice':
        return _slice_scatter_add(w, payload, Vf)
    if skind == 'grouped':
        for cols, p in payload:
            _slice_scatter_add(w, p, Vf[:, torch.as_tensor(cols, device=Vf.device)])
        return w
    if skind == 'banded':
        ny, nx, inner, bands = payload
        V3 = Vf.reshape(ny, nx, -1)
        for lo, hi, sp in bands:
            sub = V3[:, lo:hi] if inner else V3[lo:hi]
            _apply_value_plan(w, sp[0], sp[1], sub.reshape(-1, V3.shape[2]))
        return w
    return payload.add_into(w, Vf.reshape(-1))


class _LazyPattern:
    '''Deferred CSR pattern: holds the raw per-segment COO index streams and
    builds the deduplicated :class:`matrix.SparsePattern` (a ~10M-entry sort
    at ~1M dofs) only when some consumer actually touches a CSR attribute.
    The stencil-form device path (assembly through slice adds, MG-CG on the
    weight grid) never does — CSR becomes an export format, not the
    operator.'''

    def __init__(self, rows_list, cols_list, shape):
        self.shape = tuple(shape)
        self._rows_list = rows_list
        self._cols_list = cols_list
        self._pat = None

    def get(self):
        if self._pat is None:
            rows = numpy.concatenate([r.ravel() for r in self._rows_list]) \
                if self._rows_list else numpy.zeros(0, dtype=numpy.int64)
            cols = numpy.concatenate([c.ravel() for c in self._cols_list]) \
                if self._cols_list else numpy.zeros(0, dtype=numpy.int64)
            self._pat = matrix.SparsePattern(rows, cols, self.shape)
            self._rows_list = self._cols_list = None
        return self._pat

    def __getattr__(self, name):
        if name.startswith('_'):
            raise AttributeError(name)
        return getattr(self.get(), name)


class _Loc:
    '''One localized appearance of an argument in an expression.

    ``leaf`` replaces the gather node; ``argidx`` is a numpy int array
    (broadcastable to leaf.shape) holding the flat argument index of each leaf
    entry; ``seed_axes`` are the leaf axes that enumerate distinct argument
    entries per element (axes > 0 where argidx varies).  ``dense`` marks a
    non-localized (whole-argument) appearance with no element axis.
    '''

    def __init__(self, name, argshape, leaf, argidx, dense=False):
        self.name = name
        self.argshape = argshape
        self.leaf = leaf
        self.argidx = argidx
        self.dense = dense
        if dense:
            self.seed_axes = tuple(range(argidx.ndim))
        else:
            self.seed_axes = tuple(ax for ax in range(1, argidx.ndim) if argidx.shape[ax] > 1)
        self.nseeds = int(numpy.prod([leaf.shape[ax] for ax in self.seed_axes], dtype=numpy.int64)) if self.seed_axes else 1

    def leaf_value(self, args):
        flat = args[self.name].reshape(-1)
        plan = getattr(self, '_gplan', '?')
        if plan == '?':
            N = int(numpy.prod(self.argshape, dtype=numpy.int64))
            plan = self._gplan = None if self.dense else _grid_plan(self.argidx, N)
        if plan is not None:
            out = _slice_gather(flat, plan, self.argidx.shape[1:])
            return out.expand(self.leaf.shape)
        idx = getattr(self, '_idx', None)
        if idx is None or idx.device != flat.device:
            # torch indexing takes int64; the host table stays as planned
            idx = self._idx = torch.as_tensor(self.argidx, dtype=torch.int64, device=flat.device)
        return flat[idx].expand(self.leaf.shape)

    def seeds(self, shape=None):
        '''[S, *shape] tangent basis: identity over the seed axes,
        broadcast over element/point axes; ``shape`` is the leaf's (an
        element chunk's has fewer elements).'''
        S = self.nseeds
        shape = tuple(self.leaf.shape if shape is None else shape)
        eshape = [S] + [shape[ax] if ax in self.seed_axes else 1 for ax in range(len(shape))]
        eye = torch.eye(S, dtype=config.torch_dtype(float), device=config.torch_device()).reshape(eshape)
        return eye.expand((S,) + shape)

    def cols(self):
        '''[E, S] (or [1, S] for dense) flat argument index per (element, seed).'''
        sq = self.argidx
        assert all(sq.shape[ax] == 1 for ax in range(sq.ndim) if ax not in self.seed_axes and (self.dense or ax != 0))
        if self.dense:
            return sq.reshape(1, -1)
        keep = [sq.shape[0]] + [sq.shape[ax] for ax in self.seed_axes]
        sq = sq.reshape(keep)
        return sq.reshape(sq.shape[0], -1)


_loc_counter = [0]


def _arg_indices(node, names):
    '''Resolve a node that is a (possibly nested) constant gather of a
    broadcast argument: returns (Argument, flat-index array broadcastable to
    node.shape), or None.  Handles GatherAlong chains (tensor-product bases
    contracted per factor) by composing the index tables host-side.'''
    if isinstance(node, ev.GatherAlong):
        if node.dofs.arguments or node.dofs.leafdeps:
            return None
        inner = _arg_indices(node.func, names)
        if inner is None:
            return None
        arg, idx = inner
        dofs_np = _eval_const(node.dofs).astype(numpy.int64)
        # compose: out[..., l, ...] = idx[..., dofs[..., l, ...], ...]
        # (take_along_axis broadcasts unit axes, keeping memory small)
        return arg, numpy.take_along_axis(idx, dofs_np, node.axis)
    core = _argcore(node)
    if core is None:
        return None
    arg, axmap, table = core
    if arg.name not in names:
        return None
    arg_axes = {core_ax: leaf_ax for leaf_ax, core_ax in enumerate(axmap) if core_ax is not None}
    strides = numpy.cumprod([1] + list(arg.shape[::-1][:-1]))[::-1].astype(numpy.int64)
    shape0 = [1] * len(node.shape)
    ax0 = arg_axes.get(0)
    assert ax0 is not None, 'argument axis lost in broadcast'
    base = (table if table is not None else numpy.arange(arg.shape[0])).astype(numpy.int64) * strides[0]
    shape0[ax0] = len(base)
    idx = base.reshape(shape0)
    for core_ax in range(1, len(arg.shape)):
        leaf_ax = arg_axes.get(core_ax)
        assert leaf_ax is not None, 'argument axis lost in broadcast'
        n = arg.shape[core_ax]
        shape = [1] * len(node.shape)
        shape[leaf_ax] = n
        idx = idx + numpy.arange(n, dtype=numpy.int64).reshape(shape) * strides[core_ax]
    return arg, idx


def _seed_from(orig, name, direction):
    '''Route ``direction`` (an evaluable of the argument's shape) through the
    same index-structural gather chain as the original argument appearance
    ``orig``.  Elementwise factors of the direction are split first so that a
    plain-argument factor stays localizable (gather(a*b) = gather(a)*gather(b)
    holds because the chain is a pure index selection).'''
    if isinstance(direction, ev.Multiply):
        a, b = direction.children
        return ev.multiply(_seed_from(orig, name, a), _seed_from(orig, name, b))
    argnodes = ev.find(orig, lambda n: isinstance(n, ev.Argument) and n.name == name)
    assert len(argnodes) == 1, 'gather chain must contain the argument exactly once'
    return ev.replace(orig, {argnodes[0]: direction})


def _split_const_gathers(e, names):
    '''Rewrite gather(arg_expr * const, dofs) -> gather(arg_expr) *
    gather(const): masked trial/test arguments (e.g. the reference's
    ``dtest * dfluid`` restriction, examples/turek.py:261,327) keep the
    constant mask outside the gather so the argument gather itself stays
    localizable per element batch.'''
    while True:
        repl = {}
        for node in ev.find(e, lambda n: isinstance(n, ev.GatherAlong)):
            chain = []
            core = node.func
            while isinstance(core, ev.InsertAxis):
                chain.append((core.axis, core.length))
                core = core.func
            if not isinstance(core, ev.Multiply):
                continue
            a, b = core.children
            for witharg, constpart in ((a, b), (b, a)):
                if any(arg.name in names for arg in witharg.arguments) \
                        and not constpart.arguments and not constpart.leafdeps:
                    def rebuild(x):
                        for ax, ln in reversed(chain):
                            x = ev.insertaxis(x, ax, ln)
                        return ev.GatherAlong(x, node.dofs, node.axis)
                    repl[node] = ev.multiply(rebuild(witharg), rebuild(constpart))
                    break
        if not repl:
            return e
        e = ev.replace(e, repl)


def _localize(expr, names):
    '''Replace localized gathers (and remaining direct appearances) of the
    named arguments by Leafs.  ArgGrad nodes over the named arguments
    (function.linearize directions) are expanded into LeafGrads whose seeds
    ride the same gather tables, so directional derivatives stay
    element-batched.  Returns (new_expr, {name: [_Loc]}).'''
    expr = _split_const_gathers(expr, names)
    locs = {name: [] for name in names}
    leafinfo = {}  # leaf key -> (argument name, original gather node or None)

    def collect_and_replace(e):
        candidates = []
        for node in ev.find(e, lambda n: isinstance(n, ev.GatherAlong)):
            res = _arg_indices(node, names)
            if res is not None:
                candidates.append((node, res))
        # keep outermost candidates only (nested gathers are consumed by their parent)
        nodes = [n for n, _ in candidates]
        repl = {}
        for node, (arg, idx) in candidates:
            inner_of_other = any(other is not node and node in set(ev.find(other, lambda n: n is node))
                                 for other in nodes)
            if inner_of_other:
                continue
            _loc_counter[0] += 1
            leaf = ev.Leaf(('loc', _loc_counter[0]), node.shape, float)
            repl[node] = leaf
            locs[arg.name].append(_Loc(arg.name, arg.shape, leaf, idx))
            leafinfo[leaf.key] = (arg.name, node)
        return ev.replace(e, repl) if repl else e

    new_expr = collect_and_replace(expr)

    for _ in range(4):  # nested linearizations expand one level per round
        ags = ev.find(new_expr, lambda n: isinstance(n, ev.ArgGrad) and n.name in names)
        if not ags:
            break
        repl = {}
        for ag in ags:
            func = ag.func
            # dense (unlocalized) appearances of the differentiated argument:
            # localize here so the directional derivative flows through a leaf
            for argnode in [a for a in func.arguments if a.name == ag.name]:
                _loc_counter[0] += 1
                leaf = ev.Leaf(('loc', _loc_counter[0]), argnode.shape, float)
                func = ev.replace(func, {argnode: leaf})
                idx = numpy.arange(int(numpy.prod(argnode.shape, dtype=numpy.int64)), dtype=numpy.int64).reshape(argnode.shape)
                locs[ag.name].append(_Loc(ag.name, argnode.shape, leaf, idx, dense=True))
                leafinfo[leaf.key] = (ag.name, None)
            out = None
            for leaf in sorted(func.leafdeps, key=lambda l: l.key):
                info = leafinfo.get(leaf.key)
                if info is None or info[0] != ag.name:
                    continue
                orig = info[1]
                seed = ag.direction if orig is None else _seed_from(orig, ag.name, ag.direction)
                term = ev.LeafGrad(func, leaf.key, seed)
                out = term if out is None else ev.add(out, term)
            if out is None:  # argument absent from func: derivative is zero
                out = ev.Zeros(ag.shape, float)
            repl[ag] = out
        new_expr = ev.replace(new_expr, repl)
        new_expr = _split_const_gathers(new_expr, names)
        new_expr = collect_and_replace(new_expr)  # localize the seed gathers

    for name in names:  # remaining direct (dense) appearances
        for argnode in [a for a in new_expr.arguments if a.name == name]:
            _loc_counter[0] += 1
            leaf = ev.Leaf(('loc', _loc_counter[0]), argnode.shape, float)
            new_expr = ev.replace(new_expr, {argnode: leaf})
            idx = numpy.arange(int(numpy.prod(argnode.shape, dtype=numpy.int64)), dtype=numpy.int64).reshape(argnode.shape)
            locs[name].append(_Loc(name, argnode.shape, leaf, idx, dense=True))

    return new_expr, locs


def _argcore(node):
    '''If node is a pure broadcast (InsertAxis/Transpose) of an Argument — or
    of a constant re-indexing Take of one (block/vectorized bases) — return
    (argument, axismap node_axis -> arg_axis or None, index_table or None).'''
    factors = ev._decompose_product(node)
    if len(factors) != 1:
        return None
    core = factors[0].core
    if isinstance(core, ev.Argument):
        return core, factors[0].axismap, None
    if isinstance(core, ev.Take) and core.axis == 0 and isinstance(core.children[0], ev.Argument) \
            and isinstance(core.children[1], ev.Constant) and core.children[1].ndim == 1:
        return core.children[0], factors[0].axismap, core.children[1].value
    return None


def _eval_const(node):
    if isinstance(node, ev.Constant):
        return node.value
    assert not node.arguments and not node.leafdeps, 'dof table is not constant'
    return ev.eval_once(node, on_host=True)


def _additive_terms(expr):
    if isinstance(expr, ev.Add):
        return _additive_terms(expr.children[0]) + _additive_terms(expr.children[1])
    if isinstance(expr, ev.Multiply):
        # distribute constant scalar factors (e.g. a global tolerance scaling)
        # over sums so per-term sparsity analysis sees the individual integrals
        a, b = expr.children
        for x, y in ((a, b), (b, a)):
            if isinstance(x, ev.Add) and not y.arguments and not y.leafdeps:
                return [t for u in _additive_terms(x) for t in _additive_terms(ev.multiply(u, y))]
    return [expr]


def _scalarize(res_array, testname):
    '''Contract a residual vector with a synthetic test argument *inside* each
    integral: sum_t integral(R_t) . v becomes sum_t integral(R_t . v), keeping
    every term's test/trial gathers on the same element batch so that
    localization-based jacobian assembly stays per-element.'''
    from .sample import _Integral
    v = function.Argument(testname, res_array.shape)

    def walk(arr, sign):
        if isinstance(arr, function._Add):
            return walk(arr.operands[0], sign) + walk(arr.operands[1], sign)
        if isinstance(arr, function._Neg):
            return walk(arr.operands[0], -sign)
        return [(arr, sign)]

    out = None
    for term, sign in walk(res_array, 1):
        if isinstance(term, function._Derivative) and term.func.shape == ():
            # residual built as energy.derivative(trial): contracting with the
            # synthetic test v gives exactly the directional derivative
            # (linearize) of the energy toward v, which the localized-AD
            # machinery assembles sparsely — no dense ndofs x ndofs jacobian
            # intermediate ever exists (reference: function.py:2021 derivative
            # feeding solver.System, solver.py:238)
            e = function._Linearized(term.func, term.name, v, term.argshape)
        elif isinstance(term, _Integral) and term.integrand.ndim == res_array.ndim:
            inner = function.sum_(function.multiply(term.integrand, v), tuple(range(res_array.ndim)))
            e = term.sample.integral(inner)
        else:
            e = function.sum_(function.multiply(term, v), tuple(range(res_array.ndim)))
        if sign < 0:
            e = function.negative(e)
        out = e if out is None else function.add(out, e)
    return out if out is not None else function.asarray(0.0)


def _chunk_rewriter(E, ce, tables):
    '''``node -> node`` on element chunks of ``ce`` of the ``E`` elements
    (reference: ``nutils_tpu/solver.py:718`` ``_chunk_rewrite``): a leaf
    batched over the E elements becomes the leaf of the same key with ``ce``
    rows, a broadcast of length E one of length ce.  A constant of E rows
    (the JAX package binds such tables as leaves from 1,024 rows up; below,
    its rewrite fails and its plan turns chunking off) becomes a new leaf
    too, its value added to ``tables``.  Memoized across calls.'''
    memo = {}

    def rec(node):
        hit = memo.get(node)
        if hit is not None:
            return hit
        if isinstance(node, ev.Leaf):
            out = ev.Leaf(node.key, (ce,) + node.shape[1:], node.dtype, node.value) if node.shape[:1] == (E,) \
                else node
        elif isinstance(node, ev.Constant) and node.shape[:1] == (E,):
            key = ('chunk-table', len(tables))
            tables[key] = node
            out = ev.Leaf(key, (ce,) + node.shape[1:], node.dtype, node.value)
        elif not node.children:
            out = node
        else:
            newc = tuple(rec(c) for c in node.children)
            if isinstance(node, ev.InsertAxis) and node.length == E:
                out = ev.insertaxis(newc[0], node.axis, ce)
            elif all(a is b for a, b in zip(newc, node.children)):
                out = node
            else:
                out = ev._rebuild(node, newc)
        memo[node] = out
        return out
    return rec


def _device_tables(nodes, cache):
    '''The values of the leaves or constants ``nodes`` (a dict by key) that
    have one, as tensors on the configured device: made once per (device,
    floatx) and kept in ``cache``.'''
    key = (str(config.torch_device()), config.float_dtype())
    cached = cache.get('tables')
    if cached is None or cached[0] != key:
        dev = config.torch_device()
        tabs = {}
        for lkey, node in nodes.items():
            if node.value is not None:
                v = node.value
                if isinstance(v, numpy.ndarray):
                    v = torch.as_tensor(numpy.array(v, dtype=ev._concrete_dtype(node.dtype), order='C'), device=dev)
                tabs[lkey] = v
        cached = cache['tables'] = (key, tabs)
    return cached[1]


def _chunk_leaves(leaves, keys, rows):
    '''``leaves`` on the element chunk ``rows``: those of ``keys`` (batched
    over the elements) sliced.'''
    return {key: v[rows] if key in keys else v for key, v in leaves.items()}


# the generic route's seeds a vmapped pass (System._block_values)
GENERIC_SEED_CHUNK = 64


def _leaf_grad(comp, key, args, leaves):
    '''The gradient of the scalar ``comp`` in leaf ``key`` at ``leaves``.'''
    return torch.func.grad(lambda x: comp.trace(args, {**leaves, key: x}))(leaves[key])


class _Chunk:
    '''One additive contribution to a residual block: its functional
    ``comp`` (the terms its test leaf appears in, compiled from ``expr``,
    their indices ``terms``; its values are the gradient in the test leaf,
    :func:`_leaf_grad`),
    constant broadcastable flat row indices, the trial localizations the
    values can depend on, its test leaf's key, and its point-level form (a
    _FactoredForm) where its assembly takes the factored route.'''

    def __init__(self, rows, leafdeps, shape, key, expr, comp):
        self.rows = rows
        self.leafdeps = leafdeps
        self.shape = shape
        self.key = key
        self.expr = expr
        self.comp = comp
        self.factored = None
        self.terms = ()  # the indices of its additive terms in the System's functional


class _FactoredForm:
    '''The functional of one or more chunks in its point-level features.

    The functional ``expr`` reaches each of its localized dof leaves (the
    tests' and the trials') only through features ``z``
    (``evaluable.feature_cut``: the field's value and gradient at the
    points, ``[E, Q, A]``), affine in the dofs, and is a sum over the points
    of terms that each see one point.  So the gradient in a test's dofs and
    the jacobian block of a (test, trial) pair are

        r = Bt . g_t,    V = Bt . K_ts . Bs    (summed over points and features)

    with ``B = dz/dc`` the feature operators (jvp of the features over the
    leaf's unit seeds; constant in the dofs, kept on the device while they
    depend on no argument), ``g = dF/dz`` and ``K = d2F/dz dz_s`` from one
    ``vmap(jvp(grad))`` of the functional with the features bound as leaves,
    over the trial features' few unit seeds, for every chunk of the
    functional at once.  The contractions are kernels K11 and K12
    (``ops/assembly.py``).  The values equal the generic route's
    ``vmap(jvp(grad))`` over the dofs with the point axes summed; affine
    features keep an energy form's Hessian whole.'''

    def __init__(self, expr, tests, trials, cuts, npt, operators):
        self.npt = npt
        self.operators = operators  # shared by the System's forms
        # the trials' features first: they are the Hessian's seeds
        self.locs = {loc.leaf.key: loc for loc in (*trials, *tests)}
        self.cuts = cuts
        feats = ev.feature_leaves([n for key in self.locs for n in cuts[key]])
        rest = ev.replace(expr, feats)
        # what does not change from call to call is evaluated once a device
        self.fixed = ev.feature_leaves(ev.fixed_parts(rest))
        self._rest = ev.replace(rest, self.fixed)
        self.rest = ev.compile(self._rest)
        self.comp = {key: ev.compile(list(cut)) for key, cut in cuts.items()}
        self.layout = {}
        self._fixed = None
        self._chunks = None
        self._base, self._rw = self, None  # a chunked form's unchunked one and its rewriter
        self._lifted = None  # (the rest's point integrand or None,), made at first use
        self._vcomp = None
        off = 0
        for key in self.locs:
            entries = [(feats[n], n.shape, int(numpy.prod(n.shape[npt:], dtype=numpy.int64))) for n in cuts[key]]
            width = sum(a for _f, _s, a in entries)
            self.layout[key] = (slice(off, off + width), entries)
            off += width
        self.nseeds = sum(self.layout[loc.leaf.key][0].stop - self.layout[loc.leaf.key][0].start for loc in trials)
        self.cacheable = {key: not any(n.arguments for n in cut) for key, cut in cuts.items()}

    def chunked(self, rw, E, ce, keys):
        '''This form on element chunks of ``ce`` of the ``E`` elements
        (``rw``, a :func:`_chunk_rewriter`; ``keys``, the leaves batched over
        the E elements): its features, call-invariant parts and rest
        rewritten to a chunk's shapes.  Its operators are the whole batch's,
        made a chunk at a time (:meth:`operator` slices them).'''
        form = copy.copy(self)
        form._chunks, form._fixed = (E, ce, keys), None
        form._rw, form._vcomp = rw, None
        form.comp = {key: ev.compile([rw(n) for n in cut]) for key, cut in self.cuts.items()}
        form.fixed = {rw(n): rw(leaf) for n, leaf in self.fixed.items()}
        form.rest = ev.compile(rw(self._rest))
        form.layout = {key: (sl, [(rw(leaf), rw(leaf).shape, a) for leaf, _shape, a in entries])
                       for key, (sl, entries) in self.layout.items()}
        return form

    def features(self, key, args, leaves, x):
        '''The features of leaf ``key`` bound to ``x``: ``[E, P, A]`` (P
        the points of an element).'''
        vals = self.comp[key].trace(args, {**leaves, key: x})
        return torch.cat([v.reshape(v.shape[0], -1, a) for v, (_f, _s, a) in zip(vals, self.layout[key][1])], dim=-1)

    def operator(self, key, args, leaves, rows=None):
        '''``B = dz/dc`` of leaf ``key``: ``[E or 1, P, A, S]``, extent 1
        where every element has the same operator; of the elements ``rows``
        (a slice) only, where given.  Made for the whole batch, from the
        whole batch's ``leaves``; kept while it depends on no argument, once
        for all equal operators (a test and a trial of one basis).'''
        B = self._operator(key, args, leaves)
        return B if rows is None or B.shape[0] == 1 else B[rows]

    def _operator(self, key, args, leaves):
        tag = (str(config.torch_device()), config.float_dtype())
        hit = self.operators.get((key, self.cuts[key]))
        if hit is not None and hit[0] == tag:
            return hit[1]
        loc = self.locs[key]

        def jvps(lv):
            x0 = lv[key].contiguous()
            B = torch.func.vmap(lambda seed: torch.func.jvp(lambda x: self.features(key, args, lv, x), (x0,),
                                                            (seed.contiguous(),))[1])(loc.seeds(x0.shape))
            return B.permute(1, 2, 3, 0)
        if self._chunks is None:
            B = jvps(leaves).contiguous()
        else:  # a chunk at a time into the whole batch's operator
            E, ce, keys = self._chunks
            B = None
            for lo in range(0, E, ce):
                Bc = jvps(_chunk_leaves(leaves, keys, slice(lo, lo + ce)))
                if B is None:
                    B = Bc.new_empty((E,) + Bc.shape[1:])
                B[lo:lo + ce] = Bc
                del Bc
        if B.shape[0] > 1 and torch.equal(B, B[:1].expand_as(B)):
            B = B[:1].clone()
        if self.cacheable[key]:
            B = next((other for t, other in self.operators.values()
                      if t == tag and other.shape == B.shape and torch.equal(other, B)), B)
            self.operators[key, self.cuts[key]] = tag, B
        return B

    def point_terms(self, args, leaves, hessian=True, rows=None):
        '''(g ``[E, P, A]``, K ``[S, E, P, A]`` or None): the functional's
        gradient in all its features at the arguments, and its jvp over the
        S unit seeds of the trial features.  ``rows`` names the element
        chunk that ``leaves`` hold (a slice, on a :meth:`chunked` form; None
        for the whole batch): the call-invariant parts are kept for each.'''
        fixed = self._fixed_values(args, leaves, rows)
        z0 = torch.cat([self.features(key, args, leaves, leaves[key]) for key in self.locs], dim=-1)

        def functional(z):
            lv = {**leaves, **fixed}
            for sl, entries in self.layout.values():
                off = sl.start
                for leaf, shape, a in entries:
                    lv[leaf.key] = z[..., off:off + a].reshape(shape)
                    off += a
            return self.rest.trace(args, lv)
        grad = torch.func.grad(functional)
        if not hessian:
            return grad(z0), None
        n, S = z0.shape[-1], self.nseeds
        seeds = torch.eye(n, dtype=z0.dtype, device=z0.device)[:S].reshape((S,) + (1,) * (z0.ndim - 1) + (n,))
        g, K = torch.func.vmap(lambda seed: torch.func.jvp(grad, (z0,), (seed.expand(z0.shape).contiguous(),)))(seeds)
        return g[0], K

    def _fixed_values(self, args, leaves, rows=None):
        '''The call-invariant parts' values {leaf key: tensor} on the
        element chunk ``rows`` whose leaves ``leaves`` holds (None: the
        whole batch), kept for each.'''
        tag = (str(config.torch_device()), config.float_dtype())
        if self._fixed is None or self._fixed[0] != tag:
            self._fixed = tag, {}
        start = None if rows is None else rows.start
        fixed = self._fixed[1].get(start)
        if fixed is None:
            vals = ev.compile(list(self.fixed)).trace(args, leaves)
            fixed = self._fixed[1][start] = {leaf.key: v for leaf, v in zip(self.fixed.values(), vals)}
        return fixed

    def _value_comp(self):
        '''The rest's point integrand (:func:`evaluable.point_integrand`
        over the features), compiled on this form's shapes (a chunk's on a
        :meth:`chunked` form), or None where the rest has none.'''
        base = self._base
        if base._lifted is None:
            feats = [leaf for _sl, entries in base.layout.values() for leaf, _shape, _a in entries]
            base._lifted = (ev.point_integrand(base._rest, feats, base.npt),)
        if self._vcomp is None and base._lifted[0] is not None:
            self._vcomp = ev.compile(base._lifted[0] if self._rw is None else self._rw(base._lifted[0]))
        return self._vcomp

    def integrand(self, args, leaves, rows=None):
        '''The functional at its points, ``[E, P]`` (the elements of
        ``leaves``, the chunk ``rows`` where given, as :meth:`point_terms`),
        the weights and jacobians folded in: its value is their sum (kernel
        K15).  The rest's features bound as :meth:`point_terms` binds them,
        without the rest's outer sum.  None where it has no point integrand.'''
        comp = self._value_comp()
        if comp is None:
            return None
        lv = {**leaves, **self._fixed_values(args, leaves, rows)}
        for key in self.locs:
            vals = self.comp[key].trace(args, leaves)
            for (leaf, shape, _a), v in zip(self.layout[key][1], vals):
                lv[leaf.key] = v.reshape(shape)
        f = comp.trace(args, lv)
        return f.reshape(f.shape[0], -1)

    def residual(self, test, g, args, leaves, rows=None, out=None):
        '''The values ``[E, L_t]`` of test leaf ``test`` (kernel K12),
        of the elements ``rows`` where given (``g`` is theirs, ``leaves``
        the whole batch's), written into ``out`` where given.'''
        return assembly.elem_vector(self.operator(test, args, leaves, rows), g[..., self.layout[test][0]], out=out)

    def block(self, test, trial, K, args, leaves, rows=None, out=None):
        '''The element blocks ``[E, L_t, S]`` of test leaf ``test`` and
        trial leaf ``trial`` (kernel K11), of the elements ``rows`` where
        given, written into ``out`` where given.'''
        Kts = K[self.layout[trial][0]][..., self.layout[test][0]].permute(1, 2, 3, 0)
        return assembly.elem_matrix(self.operator(test, args, leaves, rows), Kts,
                                    self.operator(trial, args, leaves, rows), out=out)


def _factor_form(expr, tests, trials, lockeys, operators):
    '''The _FactoredForm of test localizations ``tests`` with trial
    localizations ``trials`` in their functional ``expr``, or None where it
    has no point-level factoring (``evaluable.feature_cut``; ``operators``
    is the System's cache of feature operators); every localization must be
    element-batched with its seed axes last, on the same element and point
    axes, and each feature must depend on its own leaf alone among the
    localized ones (``lockeys``).'''
    npt = tests[0].leaf.ndim - len(tests[0].seed_axes)
    locs = {loc.leaf.key: loc for loc in (*tests, *trials)}
    for loc in locs.values():
        if loc.dense or loc.seed_axes != tuple(range(npt, loc.leaf.ndim)) \
                or loc.argidx.shape[0] != loc.leaf.shape[0] or loc.leaf.shape[:npt] != tests[0].leaf.shape[:npt]:
            return None
    cuts = {}
    for key, loc in locs.items():
        cut = ev.feature_cut(expr, loc.leaf, npt)
        if cut is None or any({l.key for l in n.leafdeps} & lockeys != {key} for n in cut):
            return None
        cuts[key] = cut
    feats = ev.feature_leaves([n for cut in cuts.values() for n in cut])
    rest = ev.replace(expr, feats)
    if any(loc.leaf in rest.leafdeps for loc in locs.values()) or not ev.separable(rest, list(feats.values()), npt):
        return None
    return _FactoredForm(expr, tests, trials, cuts, npt, operators)


class System:
    '''A linear or nonlinear system of equations (reference: solver.py:189).

    Built from a scalar functional (energy minimization; the test space is
    the trial space) or a residual with explicit trial/test argument names:

    The port carries assembly (``assemble_jacobian_residual`` and friends)
    in stencil, block-grid and CSR form, the value (``assemble_value``),
    ``solve`` with :class:`Direct`, the Newton family, :class:`Minimize`,
    :class:`Arnoldi` and :class:`Pseudotime`, ``step`` and
    ``solve_constraints``.
    '''

    def __init__(self, residual, /, trial, test=None):
        self.trials = tuple(trial.split(',') if isinstance(trial, str) else trial)

        # a complex residual R is equivalent to the real functional Re(R):
        # stationarity in the packed (re, im) test dofs is exactly R == 0
        # componentwise (reference: complex dtype support, examples/coil.py);
        # complex trial arguments are backed by real (..., 2) arrays
        if isinstance(residual, (tuple, list)):
            residual = [function.asarray(r).real if function.iscomplex(function.asarray(r)) else r for r in residual]
        else:
            res_a = function.asarray(residual)
            if function.iscomplex(res_a):
                residual = res_a.real

        # a sum of function.linearize terms over one functional is the energy
        # formulation in disguise: unwrap so assembly uses localized AD
        if test is None and not isinstance(residual, (tuple, list)):
            lin = function._unwrap_linearized(residual, self.trials)
            if lin is not None:
                residual = lin

        if isinstance(residual, (tuple, list)):
            if test is not None:
                raise ValueError('test arguments are not allowed with residual vectors')
            res_arrays = [function.asarray(r) for r in residual]
            assert len(res_arrays) == len(self.trials), 'one residual vector per trial argument'
            self.is_symmetric = False
            tests = tuple(f'__test_{i}__' for i in range(len(res_arrays)))
            value = None
            for r, tname in zip(res_arrays, tests):
                term = _scalarize(r, tname)
                value = term if value is None else function.add(value, term)
            self._synthetic_tests = tests
            linear_degree = 1
        else:
            value = function.asarray(residual)
            if value.ndim != 0:
                raise ValueError('System requires a scalar functional')
            tests = self.trials if test is None else tuple(test.split(',') if isinstance(test, str) else test)
            self.is_symmetric = tests == self.trials
            self._synthetic_tests = ()
            # a true energy (no explicit tests) is linear when quadratic in the
            # trials; with explicit test functions the functional already
            # carries the test factor, so the residual is linear iff the
            # functional is linear in the trials
            linear_degree = 2 if test is None else 1

        argspecs = dict(value.arguments)
        self.argshapes = {n: spec[0] for n, spec in argspecs.items()}
        self.argdtypes = {n: spec[1] for n, spec in argspecs.items()}
        for t in self.trials:
            assert t in self.argshapes, f'trial argument {t!r} does not appear in the residual'
        for t in tests:
            assert t in self.argshapes, f'test argument {t!r} does not appear in the residual'
        self.tests = tests
        self.trial_shapes = tuple(self.argshapes[t] for t in self.trials)
        self.test_shapes = tuple(self.argshapes[t] for t in tests)
        trial_sizes = [int(numpy.prod(s, dtype=numpy.int64)) for s in self.trial_shapes]
        test_sizes = [int(numpy.prod(s, dtype=numpy.int64)) for s in self.test_shapes]
        toffs = numpy.cumsum([0] + trial_sizes)
        roffs = numpy.cumsum([0] + test_sizes)
        self._trial_slices = [slice(int(a), int(b)) for a, b in zip(toffs[:-1], toffs[1:])]
        self._test_slices = [slice(int(a), int(b)) for a, b in zip(roffs[:-1], roffs[1:])]
        self._ntrial = int(toffs[-1])
        self._ntest = int(roffs[-1])
        assert self._ntrial == self._ntest, 'jacobian must be square'

        # ---- localize and build chunks
        E_ir = ev.astype(value.lower(function.EMPTY_LOWER_ARGS), float)
        deg = ev.poly_degree(E_ir, frozenset(self.trials))
        self.is_linear = deg <= linear_degree
        resargs = {a.name for a in E_ir.arguments} - set(self._synthetic_tests)
        self.is_constant_matrix = self.is_linear and resargs <= set(self.trials) | set(tests)
        self.arguments = frozenset(resargs)

        names = frozenset(tests) | frozenset(self.trials)
        E_loc, locs = _localize(E_ir, names)
        E_loc = ev._promote_big_constants([E_loc])[0]
        self._expr = E_loc
        self._comp = ev.compile(E_loc)
        self._locs = locs
        self._trial_locs = {u: locs[u] for u in self.trials}

        terms = _additive_terms(E_loc)
        lockeys = {loc.leaf.key for ll in locs.values() for loc in ll}
        term_lockeys = [frozenset(l.key for l in t.leafdeps if l.key in lockeys) for t in terms]

        self._blocks = []
        trial_locs = {l.leaf.key: l for u in self.trials for l in self._trial_locs[u]}
        made = []  # (test, chunk index, chunk, its functional, test loc)
        for ti, t in enumerate(tests):
            chunks = []
            for loc in locs[t]:
                # trial leaves that share an additive term with this test leaf
                deps = frozenset().union(*(tk for tk in term_lockeys if loc.leaf.key in tk)) if term_lockeys else frozenset()
                trial_keys = deps & set(trial_locs)

                # evaluate only the terms this test localization appears in:
                # the gradient is identical (other terms are constant in the
                # leaf) and the evaluated graph is much smaller
                dep = [i for i, tk in enumerate(term_lockeys) if loc.leaf.key in tk]
                expr_dep = terms[dep[0]] if dep else E_loc
                for i in dep[1:]:
                    expr_dep = ev.add(expr_dep, terms[i])
                made.append((t, len(chunks), _Chunk(loc.argidx, trial_keys, loc.leaf.shape, loc.leaf.key, expr_dep,
                                                    ev.compile(expr_dep)), expr_dep, loc))
                made[-1][2].terms = tuple(dep) if dep else tuple(range(len(terms)))
                chunks.append(made[-1][2])
            self._blocks.append(chunks)

        # each chunk's assembly route, chosen from its form: 'factored' where
        # its functional has point-level features (one _FactoredForm for all
        # the chunks of one functional), else 'generic'
        self._assembly_routes = {}
        self._operators = {}
        groups = {}
        for item in made:
            groups.setdefault(item[3], []).append(item)
        for expr, items in groups.items():
            keys = sorted(frozenset().union(*(item[2].leafdeps for item in items)))
            form = _factor_form(expr, [item[4] for item in items], [trial_locs[k] for k in keys], lockeys,
                                self._operators)
            for item in items:
                item[2].factored = form
        for t, ci, c, _expr, loc in made:
            self._assembly_routes[t, ci] = 'generic' if c.factored is None else 'factored'
            if c.factored is None:
                log.info(f'assembly of test {t!r} chunk {ci}: generic route (vmap(jvp) over {loc.nseeds} dof '
                         'seeds); its form has no point-level features')

        self._cache = {}
        # the trials' registered dof layouts, read now: a later field of the
        # same name and size replaces the registration
        self._fields = self._field_partition()

    # -------------------------------------------------------- helpers

    def _bound_leaves(self, args, overrides, tables):
        leaves = dict(tables)
        for ll in self._locs.values():
            for loc in ll:
                key = loc.leaf.key
                v = overrides.get(key)
                leaves[key] = v if v is not None else loc.leaf_value(args)
        return leaves

    def _tables(self):
        '''Default bindings (sample coordinate / promoted constant tables) of
        the compiled functional as tensors on the configured device, made
        once per (device, floatx) and reused.'''
        return _device_tables(self._comp.leafnodes, self._cache)

    def _device_args(self, clean):
        '''Cleaned numpy arguments -> float tensors on the configured device.'''
        dev = config.torch_device()
        fdt = config.float_dtype()
        return {name: torch.as_tensor(numpy.asarray(v, dtype=fdt), device=dev) for name, v in clean.items()}

    def _clean(self, arguments):
        out = {}
        for name, shape in self.argshapes.items():
            v = arguments.get(name)
            if v is None and (name in self._synthetic_tests or name in self.tests):
                # test-function values never influence the residual/jacobian
                # (the residual IS the derivative with respect to them)
                out[name] = numpy.ones(shape)
            else:
                assert v is not None, f'missing argument {name!r}'
                out[name] = numpy.asarray(_pack_complex(v), dtype=float)
        # pass through any extra arguments the expressions may close over
        for name, v in arguments.items():
            if name not in out and not isinstance(v, str):
                out[name] = numpy.asarray(v, dtype=float)
        return out

    @contextlib.contextmanager
    def _generic_route(self):
        '''While open, every assembly chunk takes the generic ``vmap(jvp)``
        route over its dof seeds (the reference of the factored route);
        the chunks' forms and ``_assembly_routes`` are restored on exit.'''
        saved = [(c, c.factored) for chunks in self._blocks for c in chunks], self._assembly_routes
        try:
            for c, _form in saved[0]:
                c.factored = None
            self._assembly_routes = dict.fromkeys(saved[1], 'generic')
            yield self
        finally:
            for c, form in saved[0]:
                c.factored = form
            self._assembly_routes = saved[1]

    # -------------------------------------------------------- traces

    def _form(self, c, rows):
        '''Factored chunk ``c``'s form, on the element chunks of the chunk
        plan where ``rows`` is given.'''
        return c.factored if rows is None else self._chunk_plan()['forms'][id(c.factored)]

    def _point_terms(self, c, args, leaves, terms, rows=None, hessian=True):
        '''(g, K) of factored chunk ``c``'s form on the element chunk
        ``rows`` whose leaves ``leaves`` holds (_FactoredForm.point_terms),
        kept in ``terms`` for the rest of that chunk's assembly.'''
        hit = terms.get(id(c.factored))
        if hit is None or hessian and hit[1] is None:
            hit = terms[id(c.factored)] = self._form(c, rows).point_terms(args, leaves, hessian, rows)
        return hit

    def _block_values(self, mi, args, leaves, lv, terms, rows=None, out=None):
        '''The values of jacobian entry ``mi`` of ``_jac_layout``: a
        ``[E, L_t, S]`` table (the point axes summed), of the elements
        ``rows`` where given.  ``leaves`` binds the whole batch, ``lv`` the
        chunk's; ``out`` (the chunk's rows of the batch's value buffer, flat
        per element) receives them.'''
        bi, ci, u, li, reduce_axes, _size = self._jac_layout[0][mi]
        c = self._blocks[bi][ci]
        loc = self._trial_locs[u][li]
        if c.factored is not None:
            _g, K = self._point_terms(c, args, lv, terms, rows)
            return self._form(c, rows).block(c.key, loc.leaf.key, K, args, leaves, rows,
                                             None if out is None else out.view(out.shape[0], -1, loc.nseeds))
        x0 = lv[loc.leaf.key].contiguous()
        comp = c.comp if rows is None else self._chunk_plan()['comps'][c.key]

        def tangent(seed):
            return torch.func.jvp(lambda x: _leaf_grad(comp, c.key, args, {**lv, loc.leaf.key: x}), (x0,),
                                  (seed.contiguous(),))[1]
        # the seed tangents in vmapped passes of GENERIC_SEED_CHUNK seeds:
        # the primal (and the grad pass) does not depend on the batched
        # seed, so it is evaluated once a pass, unbatched; every
        # intermediate of a pass carries the pass's seeds, so a form whose
        # trial has all its dofs on every element (coil's, on a tensor
        # product with a revolution space) keeps its peak bounded
        seeds = loc.seeds(x0.shape)
        parts = []
        for a in range(0, max(seeds.shape[0], 1), GENERIC_SEED_CHUNK):
            V = torch.movedim(torch.func.vmap(tangent)(seeds[a:a + GENERIC_SEED_CHUNK]), 0, -1)   # [*cshape, s]
            parts.append(V.sum(dim=reduce_axes) if reduce_axes else V)
        V = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        return V if out is None else out.copy_(V.reshape(out.shape))

    def _row_plan(self, c, n):
        '''(axes the chunk's values are summed over, value plan) of the
        rows of residual chunk ``c`` in its block of ``n`` rows, planned at
        first use: the axes the row table broadcasts along are summed, then
        the structured slice-scatter layout (whole-affine, phase-grouped,
        or seam-banded for periodic meshes) is planned; rows with no slice
        plan take the sorted segment sums (deterministic on a card).'''
        plan = getattr(c, '_row_plan', None)
        if plan is None:
            rows_np = numpy.asarray(c.rows)
            bcast = tuple(ax for ax in range(len(c.shape)) if rows_np.shape[ax] == 1 and c.shape[ax] > 1)
            sq = rows_np
            for ax in reversed(bcast):
                sq = numpy.squeeze(sq, ax)
            vplan = _plan_value_table(sq.reshape(sq.shape[0], -1), None, n) \
                if sq.ndim >= 2 and sq.shape[0] > 1 else None
            plan = c._row_plan = (bcast, vplan or ('scatter', _RowSums(sq)))
        return plan

    def _residual_values(self, bi, ci, args, leaves, lv, terms, rows=None, out=None):
        '''The values of residual chunk ``ci`` of test ``bi`` (the axes its
        row table broadcasts along summed), as :meth:`_block_values`.'''
        c = self._blocks[bi][ci]
        bcast, _vplan = self._row_plan(c, self._test_slices[bi].stop - self._test_slices[bi].start)
        if c.factored is not None:
            g, _K = self._point_terms(c, args, lv, terms, rows, hessian=False)
            return self._form(c, rows).residual(c.key, g, args, leaves, rows, out)
        v = _leaf_grad(c.comp if rows is None else self._chunk_plan()['comps'][c.key], c.key, args, lv)
        v = v.sum(dim=bcast) if bcast else v
        return v if out is None else out.copy_(v.reshape(out.shape))

    @functools.cached_property
    def _jac_layout(self):
        '''(chunk_meta, SparsePattern): one meta entry per (chunk, trial loc)
        pair, aligned with the value order of _jacobian_trace.'''
        chunk_meta = []
        rows_all = []
        cols_all = []
        segs2d = []
        for bi, chunks in enumerate(self._blocks):
            row_off = self._test_slices[bi].start
            for ci, c in enumerate(chunks):
                for u in self.trials:
                    col_off = self._trial_slices[self.trials.index(u)].start
                    for li, loc in enumerate(self._trial_locs[u]):
                        if loc.leaf.key not in c.leafdeps:
                            continue
                        S = loc.nseeds
                        vshape = c.shape + (S,)
                        rows_b = c.rows.reshape(c.rows.shape + (1,))
                        cols_es = loc.cols()  # [E, S] or [1, S]
                        if loc.dense or cols_es.shape[0] == 1:
                            cols_b = cols_es.reshape((1,) * len(c.shape) + (S,))
                        else:
                            assert len(c.shape) and c.shape[0] == cols_es.shape[0], (
                                f'row chunk and trial localization live on different element batches: '
                                f'chunk shape {c.shape} (block {bi}, chunk {ci}) vs cols {cols_es.shape} '
                                f'for trial {u!r} loc {li}')
                            cols_b = cols_es.reshape((cols_es.shape[0],) + (1,) * (len(c.shape) - 1) + (S,))
                        reduce_axes = tuple(ax for ax in range(len(vshape))
                                            if rows_b.shape[ax] == 1 and cols_b.shape[ax] == 1 and vshape[ax] > 1)
                        sel = tuple(0 if ax in reduce_axes else slice(None) for ax in range(len(vshape)))
                        rows_k = numpy.broadcast_to(rows_b, vshape)[sel].astype(numpy.int32) + numpy.int32(row_off)
                        cols_k = numpy.broadcast_to(cols_b, vshape)[sel].astype(numpy.int32) + numpy.int32(col_off)
                        rows_all.append(rows_k.ravel())
                        cols_all.append(cols_k.ravel())
                        segs2d.append((rows_k.reshape(rows_k.shape[0], -1),
                                       cols_k.reshape(cols_k.shape[0], -1)))
                        chunk_meta.append((bi, ci, u, li, reduce_axes, rows_k.size))
        pattern = _LazyPattern(rows_all, cols_all, (self._ntest, self._ntrial))
        jplan = self._plan_stencil_jacobian(segs2d, pattern)
        if jplan is None:
            jplan = self._plan_blockgrid_jacobian(segs2d, pattern)
        return chunk_meta, pattern, jplan

    def _plan_stencil_jacobian(self, segs2d, pattern):
        '''Try to assemble the jacobian directly in stencil form
        w[(2k+1)^2, nyd, nxd]: every (row, col) entry must decompose as
        col - row = a*nxd + b with |a|,|b| <= k and no grid-row wrap, and the
        dof pitch nxd must be consistent across all (chunk, loc) segments.
        Segments whose target tables are grid-affine scatter through static
        slices (solver._slice_scatter_add); the few that are not (boundary
        batches etc.) keep an element-granular add into the same w buffer.
        No CSR value scatter runs during assembly.'''
        n = self._ntest
        if n != self._ntrial or not segs2d:
            return None
        # dof grid: the registered layout of the single trial field (exact,
        # any rank, periodic-aware); fall back to 2-D pitch inference from
        # the grid-affine volume-batch row tables for unregistered fields
        grid = per = None
        if len(self.trials) == 1:
            hint = function.field_grid(self.trials[0], n)
            if hint is not None:
                grid, per = hint
        if grid is None:
            nxd = None
            for rowsT, colsT in segs2d:
                rp = _grid_plan(rowsT, n)
                if rp is not None and len(rp[0]) == 2 and rp[0][0] > 1:
                    (ny_e, nx_e), (pitch, sx), _bases = rp
                    if pitch % sx == 0:
                        cand = pitch // sx
                        if nxd is None:
                            nxd = cand
                        elif nxd != cand:
                            return None
            if nxd is None or n % nxd:
                return None
            grid, per = (n // nxd, nxd), (False, False)
        grid = tuple(int(g) for g in grid)
        if int(numpy.prod(grid)) != n:
            return None
        d = len(grid)
        pitches = [int(numpy.prod(grid[ax + 1:])) for ax in range(d)]

        def shifts_of(rowsT, colsT):
            '''Per-axis window shifts (periodic axes wrap) or None.  Index
            arithmetic runs in int32 (dof counts < 2^31): numpy's int64
            floor-division is scalar (~130x slower than the vectorized int32
            path) and dominated System planning at ~1M dofs.'''
            rowsT = rowsT.astype(numpy.int32, copy=False)
            colsT = colsT.astype(numpy.int32, copy=False)
            A = []
            for ax in range(d):
                rc = (rowsT // pitches[ax]) % grid[ax]
                cc = (colsT // pitches[ax]) % grid[ax]
                a = cc - rc
                if numpy.abs(a).max(initial=0) > 3:
                    if per[ax] and grid[ax] > 9:
                        a = (a + grid[ax] // 2) % grid[ax] - grid[ax] // 2
                        if numpy.abs(a).max(initial=0) > 3:
                            return None
                    else:
                        return None
                A.append(a)
            return A

        deltas = []
        for rowsT, colsT in segs2d:
            A = shifts_of(rowsT, colsT)
            if A is None:
                return None
            deltas.append(A)
        ks = [max(int(numpy.abs(A[ax]).max(initial=0)) for A in deltas)
              for ax in range(d)]
        windows = [2 * k + 1 for k in ks]
        W = int(numpy.prod(windows))
        segs = []
        for (rowsT, colsT), A in zip(segs2d, deltas):
            widx = numpy.zeros(rowsT.shape, dtype=numpy.int64)
            for a, k, wdim in zip(A, ks, windows):
                widx = widx * wdim + (a + k)
            tgt = widx * n + rowsT
            segs.append(_plan_value_table(tgt, widx, W * n))
        # CSR materialization map: slot l holds w[widx_l * n + row_l].
        # Deferred: every pattern entry comes from a seg that passed
        # shifts_of, so the pattern-level decomposition cannot fail; building
        # it eagerly would force the CSR pattern (a ~10M-entry sort) that the
        # stencil-form device path otherwise never needs.
        _cm = []  # memo: resolved once, shared by every Newton-step matrix

        def csr_map():
            if not _cm:
                A = shifts_of(numpy.asarray(pattern.urows), numpy.asarray(pattern.indices))
                assert A is not None, 'stencil decomposition failed on the deduplicated pattern'
                widx = numpy.zeros(len(pattern.indices), dtype=numpy.int64)
                for a, k, wdim in zip(A, ks, windows):
                    widx = widx * wdim + (a + k)
                _cm.append(widx * n + pattern.urows)
            return _cm[0]
        return dict(form='stencil', ks=tuple(ks), grid=grid, total=W * n, segs=segs,
                    csr_map=csr_map, periodic=tuple(bool(p) for p in per))

    def _field_partition(self):
        '''(offsets, grids): the dof vector partitioned into registered
        field parts — one per trial for plain fields, several for composite
        (vectorized) fields; fields without a registered layout contribute a
        single part with grid None.'''
        offsets = [0]
        grids = []
        for t, sl in zip(self.trials, self._trial_slices):
            size = sl.stop - sl.start
            parts = function.field_parts(t, size)
            if parts is None:
                offsets.append(offsets[-1] + size)
                grids.append(None)
            else:
                for psize, grid, per in parts:
                    offsets.append(offsets[-1] + psize)
                    grids.append((grid, per))
        return tuple(offsets), tuple(grids)

    def _plan_blockgrid_jacobian(self, segs2d, pattern):
        '''Assemble the jacobian of a multi-field structured system directly
        in block-grid form (ops/blockgrid.py): values land in the
        concatenated per-(block, phase) weight buffers through static slice
        adds, and the device Krylov operand comes out of assembly with zero
        copies.  Host planning copied from the JAX package, in the natural
        axis order of each block.'''
        from .ops import blockgrid as bg
        if self._ntest != self._ntrial or not segs2d:
            return None
        offsets, grids = self._fields
        if len(grids) < 2 or any(g is None for g in grids):
            return None
        form = bg.detect(numpy.ones(pattern.nnz), pattern.indices, pattern.indptr,
                         offsets, grids=grids)
        if form is None:
            return None
        sizes, windex, wpos = form.fill
        # buffer offsets aligned to each buffer's own grid size, so the
        # mixed-radix slice layouts of the nested views start at a grid-row
        # boundary (a mid-row base defeats the no-wrap check of _grid_plan)
        shapes = bg._w_shapes(form.meta)
        woff = numpy.zeros(len(sizes) + 1, dtype=numpy.int64)
        for i, (sz, shp) in enumerate(zip(sizes, shapes)):
            npix = int(numpy.prod(shp[1:]))
            woff[i] = -(-woff[i] // npix) * npix if npix else woff[i]
            woff[i + 1] = woff[i] + sz
        tgt_slot = woff[windex] + wpos          # per CSR slot
        tgt_entry = tgt_slot[pattern.slot]      # per original assembly entry
        wind_entry = windex[pattern.slot]
        total = int(woff[-1])
        segs = []
        pos = 0
        for rowsT, _colsT in segs2d:
            m = rowsT.size
            tseg = tgt_entry[pos:pos + m].reshape(rowsT.shape[0], -1)
            wseg = wind_entry[pos:pos + m].reshape(rowsT.shape[0], -1)
            pos += m
            segs.append(_plan_value_table(tseg, wseg, total))
        assert pos == len(tgt_entry)
        return dict(form='blockgrid', meta=form.meta, sizes=tuple(int(sz) for sz in sizes),
                    woff=tuple(int(o) for o in woff[:-1]), total=total, segs=segs,
                    csr_map=tgt_slot, field_offsets=tuple(offsets),
                    field_grids=tuple(grids))

    def _chunk_plan(self):
        '''The element chunks of the assembly (reference:
        ``nutils_tpu/solver.py:1337`` ``_build_scan_plan``), or None where
        every element batch has at most ``config.assembly_chunk`` elements.

        The largest batch, of E elements, is cut into chunks of ``ce``
        elements, ``ce`` the largest divisor of E not above the setting (a
        divisor that makes more than eight times the fewest chunks raises);
        every leaf batched over those E elements (tables and localized dof
        leaves) is sliced per chunk.  ``jac`` and ``res`` map the jacobian
        entries and residual chunks whose test localization lies on that
        batch to their values per element: these are assembled a chunk at a
        time into one value buffer each, the rest once, whole.  Planned
        once for each value of the setting and each choice of routes.'''
        key = int(config.assembly_chunk.value), tuple(c.factored is None for cs in self._blocks for c in cs)
        cached = self._cache.get('chunkplan')
        if cached is None or cached[0] != key:
            self._cache.pop('chunkplan', None)
            cached = self._cache['chunkplan'] = key, self._build_chunk_plan(key[0])
        return cached[1]

    def _build_chunk_plan(self, chunk):
        leaf_nodes = ev.find(self._expr, lambda n: isinstance(n, ev.Leaf))
        sizes = [n.shape[0] for n in leaf_nodes if n.value is not None and len(n.shape)]
        if chunk <= 0 or not sizes or max(sizes) <= chunk:
            return None
        E = max(sizes)
        ce = next(d for d in range(chunk, 0, -1) if E % d == 0)
        if E // ce > 8 * -(-E // chunk):
            # the chunks run one after another from the host: a divisor far
            # below the setting (E prime, or twice a prime) would make E // ce
            # rounds of point terms and launches
            raise ValueError(f'chunked assembly: {E} elements have no divisor near assembly_chunk = {chunk} '
                             f'(the largest, {ce}, makes {E // ce} chunks); set config.assembly_chunk to a '
                             f'divisor of {E}, or to {E} to assemble in one piece')
        lockeys = {loc.leaf.key for ll in self._locs.values() for loc in ll}
        keys = set()
        for n in leaf_nodes:
            if len(n.shape) and n.shape[0] == E:
                if n.value is None and n.key not in lockeys:
                    raise ValueError(f'unrecognized element-batched leaf {n.key!r}')
                keys.add(n.key)

        def batched(c, summed):
            '''Values per element of chunk ``c`` (its axes ``summed``
            summed), or None off the chunked batch.'''
            if c.key not in keys:
                return None
            if 0 in summed or numpy.asarray(c.rows).shape[0] != E:
                raise ValueError(f'chunked assembly: the values of localization {c.key!r} are not element-major')
            return int(numpy.prod([n for ax, n in enumerate(c.shape) if ax and ax not in summed], dtype=numpy.int64))
        jac = {}
        for mi, (bi, ci, u, li, reduce_axes, _size) in enumerate(self._jac_layout[0]):
            per = batched(self._blocks[bi][ci], reduce_axes)
            if per is not None:
                jac[mi] = per * self._trial_locs[u][li].nseeds
        res = {}
        for bi, chunks in enumerate(self._blocks):
            n = self._test_slices[bi].stop - self._test_slices[bi].start
            for ci, c in enumerate(chunks):
                per = batched(c, self._row_plan(c, n)[0])
                if per is not None:
                    res[bi, ci] = per
        if not jac and not res:
            return None
        # the chunks' functionals, rewritten to a chunk's shapes
        consts = {}
        rw = _chunk_rewriter(E, ce, consts)
        keys = set(keys)  # and the constants' tables that rw finds
        forms, comps = {}, {}
        for c in {self._blocks[m[0]][m[1]] for m in (self._jac_layout[0][mi] for mi in jac)} \
                | {self._blocks[bi][ci] for bi, ci in res}:
            if c.factored is not None:
                if id(c.factored) not in forms:
                    forms[id(c.factored)] = c.factored.chunked(rw, E, ce, keys)
            else:
                comps[c.key] = ev.compile(rw(c.expr))
        keys |= set(consts)
        return dict(E=E, ce=ce, nc=E // ce, keys=keys, jac=jac, res=res, forms=forms, comps=comps, consts=consts)

    def _assemble(self, args, tables, want_jac=True, want_res=True):
        '''(jacobian, residual), each None where not wanted: the jacobian's
        values in its stencil, block-grid or CSR form, the residual as one
        vector.

        Without element chunks every entry is assembled from the whole
        batch.  With them (:meth:`_chunk_plan`), the entries of the chunked
        batch are assembled one chunk at a time, each into its rows of the
        entry's one value buffer (the factored route's contractions write
        there in place), so that only one chunk's point-level tensors are
        live at a time; the value plans then apply once to the whole
        buffers, in the same order of sums as without chunks.'''
        plan = self._chunk_plan()
        if plan is not None and plan['consts']:
            tables = {**tables, **_device_tables(plan['consts'], plan)}
        leaves = self._bound_leaves(args, {}, tables)
        jentries = range(len(self._jac_layout[0])) if want_jac else ()
        rentries = [(bi, ci) for bi, chunks in enumerate(self._blocks) for ci in range(len(chunks))] \
            if want_res else ()
        jvals, rvals = {}, {}
        if plan is not None:
            E, ce = plan['E'], plan['ce']
            fdt, dev = config.torch_dtype(float), config.torch_device()
            jbig = {mi: torch.empty((E, plan['jac'][mi]), dtype=fdt, device=dev)
                    for mi in jentries if mi in plan['jac']}
            rbig = {k: torch.empty((E, plan['res'][k]), dtype=fdt, device=dev) for k in rentries if k in plan['res']}
            for lo in range(0, E, ce):
                rows = slice(lo, lo + ce)
                lv = _chunk_leaves(leaves, plan['keys'], rows)
                terms = {}  # the chunk's point terms, once for both
                for mi, buf in jbig.items():
                    self._block_values(mi, args, leaves, lv, terms, rows, out=buf[rows])
                for (bi, ci), buf in rbig.items():
                    self._residual_values(bi, ci, args, leaves, lv, terms, rows, out=buf[rows])
                del lv, terms
            jvals.update(jbig)
            rvals.update(rbig)
        terms = {}  # the factored chunks' point terms, once for both
        for mi in jentries:
            if mi not in jvals:
                jvals[mi] = self._block_values(mi, args, leaves, leaves, terms)
        for bi, ci in rentries:
            if (bi, ci) not in rvals:
                rvals[bi, ci] = self._residual_values(bi, ci, args, leaves, leaves, terms)
        del terms
        jac = res = None
        if want_jac:
            _chunk_meta, pattern, jplan = self._jac_layout
            vals = [jvals[mi] for mi in jentries]
            if jplan is None:
                # CSR form: the entries in pattern order, summed into their
                # CSR slots (kernel K8)
                jac = pattern.scatter(torch.cat([V.reshape(-1) for V in vals]) if len(vals) > 1
                                      else vals[0].reshape(-1))
            else:
                # direct stencil- or block-grid-form assembly: values land
                # in the flat weight buffer through static slice adds
                # (grid-affine segments) or small constant-table adds, into a
                # zeroed buffer after the transforms
                jac = torch.zeros(jplan['total'], dtype=config.torch_dtype(float), device=config.torch_device())
                for (skind, payload), V in zip(jplan['segs'], vals):
                    _apply_value_plan(jac, skind, payload, V)
        if want_res:
            parts = []
            for bi, (chunks, sl) in enumerate(zip(self._blocks, self._test_slices)):
                r = torch.zeros(sl.stop - sl.start, dtype=config.torch_dtype(float), device=config.torch_device())
                for ci, c in enumerate(chunks):
                    _bcast, vplan = self._row_plan(c, sl.stop - sl.start)
                    _apply_value_plan(r, vplan[0], vplan[1], rvals[bi, ci])
                parts.append(r)
            res = torch.cat(parts) if len(parts) > 1 else parts[0]
        return jac, res

    def _value_parts(self):
        '''The parts of the functional's value, in the order of its
        additive terms (:func:`_additive_terms`): ``('form', form)`` for the
        terms of a factored form that has a point integrand
        (:meth:`_FactoredForm.integrand`), where no earlier part took one
        of them; ``('term', comp, lead)`` for each other term, ``comp`` its
        point integrand over its localized dof leaves compiled (of shape
        ``lead``), or the term itself (``lead`` None).  Planned once for
        each choice of routes.'''
        key = tuple(c.factored is None for cs in self._blocks for c in cs)
        cached = self._cache.get('valueparts')
        if cached is not None and cached[0] == key:
            return cached[1]
        terms = _additive_terms(self._expr)
        locs = {loc.leaf.key: loc for ll in self._locs.values() for loc in ll}
        owner = [None] * len(terms)
        for c in (c for cs in self._blocks for c in cs):
            form = c.factored
            if form is not None and all(owner[i] is None for i in c.terms) and form._value_comp() is not None:
                for i in c.terms:
                    owner[i] = form
        parts, seen = [], set()
        for i, term in enumerate(terms):
            if owner[i] is not None:
                if id(owner[i]) not in seen:
                    seen.add(id(owner[i]))
                    parts.append(('form', owner[i]))
                continue
            srcs = [leaf for leaf in term.leafdeps if leaf.key in locs and not locs[leaf.key].dense]
            npts = {leaf.ndim - len(locs[leaf.key].seed_axes) for leaf in srcs}
            lifted = ev.point_integrand(term, srcs, npts.pop(), allow_grad=True) if len(npts) == 1 else None
            parts.append(('term', ev.compile(term), None) if lifted is None
                         else ('term', ev.compile(lifted), lifted.shape))
        self._cache['valueparts'] = key, parts
        return parts

    def _value_sizes(self, parts, plan):
        '''The partials of each value part (:meth:`_value_parts`) and the
        launches of K15 that write them, from the parts' static shapes.'''
        sizes, launches = [], 0
        for part in parts:
            if part[0] == 'term':
                lead = part[2]
                sizes.append(1 if lead is None else assembly.value_blocks(int(lead[0]), int(numpy.prod(lead[1:]))))
                launches += 1
                continue
            lead = part[1]._base._lifted[0].shape
            P = int(numpy.prod(lead[1:]))
            if plan is not None and id(part[1]) in plan['forms']:
                sizes.append(plan['nc'] * assembly.value_blocks(plan['ce'], P))
                launches += plan['nc']
            else:
                sizes.append(assembly.value_blocks(int(lead[0]), P))
                launches += 1
        return sizes, launches

    def _assemble_value(self, args, tables):
        '''The functional's value, a ``[1]`` tensor: each part's integrand
        at the points summed to block partials by kernel K15, written into
        the part's segment of one buffer, the last launch summing the
        segments (each in a fixed order, the parts' values added in order:
        ``elem_value(finish=)``).  A factored form on the element chunks of
        :meth:`_chunk_plan` is evaluated a chunk at a time, each chunk's
        partials written into its rows of the form's segment: where the
        chunk size is a multiple of K15's span, the same bits as one piece.
        A term with no point integrand adds its value as one partial; terms
        off the factored route are evaluated in one piece.'''
        plan = self._chunk_plan()
        if plan is not None and plan['consts']:
            tables = {**tables, **_device_tables(plan['consts'], plan)}
        leaves = self._bound_leaves(args, {}, tables)
        parts = self._value_parts()
        if not parts:
            return torch.zeros(1, dtype=config.torch_dtype(float), device=config.torch_device())
        sizes, nlaunch = self._value_sizes(parts, plan)
        offsets = numpy.cumsum([0] + sizes).tolist()

        def pieces():
            '''(its first partial, its integrand [E, P], its part's end) of
            each launch, in order.'''
            for k, part in enumerate(parts):
                if part[0] == 'term':
                    _kind, comp, lead = part
                    f = comp.trace(args, leaves)
                    shape = (1, 1) if lead is None else (int(lead[0]), int(numpy.prod(lead[1:])))
                    yield offsets[k], f.reshape(shape), offsets[k + 1]
                elif plan is None or id(part[1]) not in plan['forms']:
                    yield offsets[k], part[1].integrand(args, leaves), offsets[k + 1]
                else:
                    form, nbc = plan['forms'][id(part[1])], sizes[k] // plan['nc']
                    for c, lo in enumerate(range(0, plan['E'], plan['ce'])):
                        rows = slice(lo, lo + plan['ce'])
                        f = form.integrand(args, _chunk_leaves(leaves, plan['keys'], rows), rows)
                        yield offsets[k] + c * nbc, f, offsets[k] + (c + 1) * nbc
                        del f
        partials = total = None
        for i, (lo, f, hi) in enumerate(pieces()):
            if partials is None:
                partials, total = f.new_empty(offsets[-1]), f.new_empty(1)
            if lo + assembly.value_blocks(*f.shape) != hi:
                raise AssertionError(f'value assembly: an integrand {tuple(f.shape)} does not fill its partials '
                                     f'[{lo}, {hi})')
            assembly.elem_value(f, out=partials[lo:hi], finish=(partials, offsets, total) if i == nlaunch - 1 else None)
            del f
        return total

    # -------------------------------------------------------- public assembly

    def _compiled(self, which):
        '''Assembly function ``clean numpy arguments -> tensors`` for
        ``which`` in residual/jacobian/jacres, and ``value`` (a ``[1]``
        tensor; no compilation: the name follows the JAX package).'''
        fn = self._cache.get(which)
        if fn is None:
            if which == 'value':
                def fn(clean):
                    return self._assemble_value(self._device_args(clean), self._tables())
            else:
                want = {'residual': (False, True), 'jacobian': (True, False), 'jacres': (True, True)}[which]

                def fn(clean):
                    jac, res = self._assemble(self._device_args(clean), self._tables(), *want)
                    return res if jac is None else jac if res is None else (jac, res)
            self._cache[which] = fn
        return fn

    def _wrap_matrix(self, pattern, jplan, data):
        if jplan is None:
            m = matrix.Matrix.from_pattern(pattern.get(), data)
            # the field partition: multi-field systems may have a block-grid
            # operator, and single-field ones skip grid inference
            # (matrix._device_op, _fieldsplit)
            offsets, grids = self._fields
            m._field_grids = tuple(grids)
            if len(grids) > 1:
                m._field_offsets = tuple(offsets)
            return m
        if jplan['form'] == 'stencil':
            return matrix._StencilMatrix(pattern, data, jplan['ks'], jplan['grid'],
                                         jplan['csr_map'], jplan.get('periodic'))
        m = matrix._BlockGridMatrix(pattern, data, jplan['meta'], jplan['sizes'],
                                    jplan['csr_map'], jplan['woff'])
        m._field_offsets = jplan['field_offsets']
        m._field_grids = jplan['field_grids']
        return m

    def fused_step_op(self, *, solver='gmres', rtol=1e-3, restart=100, maxiter=None, maxrounds=30):
        '''Newton sub-step for unconstrained block-grid systems as one
        call ``clean_args -> (dx, resnorm, iters)``: jacobian + residual
        assembly, the device Schur-aware diagonal (kernel K7) and the
        mixed-precision refined Krylov solve, with no host round trip of the
        operator.  ``dx`` is a float64 device tensor; ``resnorm`` is the
        device-computed float64 true residual, target ``rtol * |res|``.  The
        contract of the JAX package's one-program ``fused_step_op``, as a
        plain composition (a CUDA graph of it is later work).'''
        from .ops.blockgrid import pack
        from .ops.sparse import refined_solve_device, schur_diag_inverse_device
        fn = self._compiled('jacres')
        _chunk_meta, pattern, jplan = self._jac_layout
        if jplan is None or jplan['form'] != 'blockgrid':
            raise NotImplementedError('fused_step_op requires the blockgrid jacobian form')
        n = int(pattern.shape[0])
        cap = int(maxiter or max(1024, int(16 * numpy.sqrt(n))))
        # the pattern's K5 plan and tables, shared with the split path
        plan = matrix.blockgrid_plan(pattern, jplan['meta'], jplan['woff'], jplan['csr_map'])
        mv_kind = ('blockgrid', plan)

        def step(clean):
            w, res = fn(clean)
            tabs = matrix.device_csr_tables(pattern, jplan['csr_map'], w.device)
            minv = schur_diag_inverse_device(w, *tabs, n)
            v = pack(w, plan)
            b64 = res.to(torch.float64)
            target = rtol * float(torch.linalg.norm(b64))
            x, rn, it, _rounds = refined_solve_device(solver, mv_kind, (v,), b64, target=target, maxiter=cap,
                                                      restart=restart, minv=minv, precon='diag',
                                                      op64=(v.to(torch.float64),), maxrounds=maxrounds)
            return x, rn, it
        return step

    @log.withcontext
    def assemble_residual(self, arguments, x=None):
        arguments, free = self.construct(arguments, x, return_free=True)
        r = matrix._host(self._compiled('residual')(self._clean(arguments)))
        return r[free]

    @log.withcontext
    def assemble_jacobian(self, arguments, x=None):
        arguments, free = self.construct(arguments, x, return_free=True)
        jac = self._jac_matrix(self._clean(arguments))
        return jac.submatrix(free, free)

    def _jac_matrix(self, clean):
        if self.is_constant_matrix and 'jacmat' in self._cache:
            return self._cache['jacmat']
        _, pattern, jplan = self._jac_layout
        jac = self._wrap_matrix(pattern, jplan, self._compiled('jacobian')(clean))
        if self.is_constant_matrix:
            self._cache['jacmat'] = jac
        return jac

    def assemble(self, arguments, x=None):
        '''(jacobian, residual, value), the value None for an unsymmetric
        system (reference: ``nutils_tpu/solver.py:1890``).'''
        jac, res = self.assemble_jacobian_residual(arguments, x)
        val = self.assemble_value(arguments, x) if self.is_symmetric else None
        return jac, res, val

    @log.withcontext
    def assemble_value(self, arguments, x=None):
        '''The functional's value, a float (reference:
        ``nutils_tpu/solver.py:1896``): its integrand at the points summed on
        the device by kernel K15 (:meth:`_assemble_value`), read once.'''
        if not self.is_symmetric:
            raise SolverError('value is not defined for unsymmetric systems')
        arguments = self.construct(arguments, x)
        return float(self._compiled('value')(self._clean(arguments)))

    @log.withcontext
    def assemble_jacobian_residual(self, arguments, x=None):
        arguments, free = self.construct(arguments, x, return_free=True)
        clean = self._clean(arguments)
        if self.is_constant_matrix and 'jacmat' in self._cache:
            jac = self._cache['jacmat']
            r = matrix._host(self._compiled('residual')(clean))
        else:
            data, r = self._compiled('jacres')(clean)
            _, pattern, jplan = self._jac_layout
            jac = self._wrap_matrix(pattern, jplan, data)
            r = matrix._host(r)
            if self.is_constant_matrix:
                self._cache['jacmat'] = jac
        return jac.submatrix(free, free), r[free]

    # -------------------------------------------------------- dof packing

    def construct(self, arguments, x=None, return_free=False):
        v = numpy.concatenate([numpy.asarray(arguments[t], dtype=float).ravel() for t in self.trials])
        free = numpy.isnan(v)
        if x is None:
            assert not free.any(), 'unresolved free dofs'
            free = numpy.ones_like(free)
        else:
            v = v.copy()
            v[free] = x
            arguments = dict(arguments) | {
                t: v[sl].reshape(shape) for t, shape, sl in zip(self.trials, self.trial_shapes, self._trial_slices)}
        return (arguments, free) if return_free else arguments

    def deconstruct(self, arguments, constrain):
        '''Split the trial arguments into NaN-marked templates and the
        vector of free dofs (reference: ``nutils_tpu/solver.py:1904``).'''
        arguments = dict(arguments)
        xparts = []
        for t, shape in zip(self.trials, self.trial_shapes):
            a = arguments.get(t)
            c = constrain.get(t)
            if a is not None:
                a = _pack_complex(a)
            if c is not None and numpy.asarray(c).dtype.kind == 'c':
                c = _pack_complex(c)
            if a is None:
                if c is None:
                    a = numpy.full(shape, numpy.nan)
                elif numpy.asarray(c).dtype == bool:
                    a = numpy.full(shape, numpy.nan)
                    a[numpy.asarray(c)] = 0.
                else:
                    a = numpy.asarray(c, dtype=float)
                x = numpy.zeros(int(numpy.isnan(a).sum()))
            else:
                a = numpy.asarray(a, dtype=float)
                if c is None:
                    x = a.ravel().copy()
                    a = numpy.full(shape, numpy.nan)
                elif numpy.asarray(c).dtype == bool:
                    c = numpy.asarray(c)
                    x = a[~c]
                    a = a.copy()
                    a[~c] = numpy.nan
                else:
                    c = numpy.asarray(c, dtype=float)
                    x = a[numpy.isnan(c)]
                    a = c
                assert numpy.isfinite(x).all(), 'non-finite initial guess'
            arguments[t] = a
            xparts.append(numpy.asarray(x, dtype=float).ravel())
        return arguments, numpy.concatenate(xparts) if xparts else numpy.zeros(0)

    def _user_args(self, arguments):
        '''Unpack complex trial arguments from the real backing layout.'''
        out = dict(arguments)
        for t in self.trials:
            if self.argdtypes.get(t) is complex and t in out:
                a = numpy.asarray(out[t])
                if a.dtype.kind != 'c':
                    out[t] = a[..., 0] + 1j * a[..., 1]
        return out

    # -------------------------------------------------------- solving

    @log.withcontext
    def solve(self, *, arguments=None, constrain=None, tol=0., miniter=0, maxiter=None, method=None):
        '''Solve the system for its trial arguments (reference:
        ``nutils_tpu/solver.py:1970``): :class:`Direct` for a linear system
        and :class:`Newton` otherwise, unless ``method`` is given.  Where
        :mod:`cache` is enabled the result is memoized on disk, keyed by a
        process-stable digest of the localized expression and the call's
        data (reference: ``@cache.function`` on ``System.solve``).'''
        arguments = dict(arguments or {})
        constrain = dict(constrain or {})
        if method is None:
            method = (Direct if self.is_linear else Newton)()
        cachekey = None
        if cache._cachedir[0] is not None:
            try:
                payload = pickle.dumps((sorted(arguments.items()), sorted(constrain.items()),
                                        tol, miniter, maxiter, str(method)), protocol=4)
            except (pickle.PicklingError, TypeError, AttributeError):
                payload = None
            if payload is not None:
                cachekey = 'solve-' + hashlib.sha1(
                    (ev.stable_digest(self._expr) + hashlib.sha1(payload).hexdigest()).encode()).hexdigest()
                hit = cache.load(cachekey)
                if hit is not None:
                    log.info(f'cache hit: solve for {",".join(self.trials)}')
                    return hit
        out = self._solve_impl(arguments=arguments, constrain=constrain, tol=tol, miniter=miniter,
                               maxiter=maxiter, method=method)
        if cachekey is not None:
            cache.store(cachekey, out)
        return out

    def _solve_impl(self, *, arguments, constrain, tol, miniter, maxiter, method):
        log.info(f'{"optimizing" if self.is_symmetric else "solving"} for {",".join(self.trials)} using {method}')
        m = method(self, arguments=arguments, constrain=constrain)
        if isinstance(m, tuple):
            arguments, resnorm = m
            log.info(f'residual norm: {resnorm:.1e}')
            if not numpy.isfinite(resnorm):
                raise SolverError('residual is not finite')
            if resnorm > tol > 0:
                raise SolverError(f'failed to reach tolerance {tol:.0e} (residual {resnorm:.1e})')
            return self._user_args(arguments)
        if tol <= 0:
            raise ValueError('nonlinear solve requires a positive tolerance')
        arguments, resnorm = next(m)
        log.info(f'iter 0: residual norm {resnorm:.1e}')
        if not numpy.isfinite(resnorm):
            raise SolverError('residual is not finite')
        iiter = 0
        while iiter < miniter or resnorm > tol:
            if maxiter is not None and iiter >= maxiter:
                raise SolverError(f'failed to converge in {maxiter} iterations')
            iiter += 1
            arguments, resnorm = next(m)
            log.info(f'iter {iiter}: residual norm {resnorm:.1e}')
            if not numpy.isfinite(resnorm):
                raise SolverError('residual diverged')
        return self._user_args(arguments)

    def step(self, *, arguments, suffix, timearg=None, timesteparg=None, timestep=None, maxretry=2, **solveargs):
        '''Advance one time step with timestep-halving retry (reference:
        ``nutils_tpu/solver.py:2032``).  The history (``<trial><suffix>``,
        ``<timearg><suffix>``), the time and the timestep are arguments of
        the assembly, passed anew at every step: nothing of them is kept in
        the System, whose layout, plans and operators serve every step.'''
        arguments = dict(arguments)
        for t in self.trials:
            if t in arguments:
                arguments[t + suffix] = arguments[t]
        if timearg or timesteparg:
            if timestep is None:
                raise ValueError('timearg/timesteparg require timestep')
            if timesteparg:
                arguments[timesteparg] = timestep
            if timearg:
                tval = arguments.get(timearg, 0.)
                arguments[timearg + suffix] = tval
                arguments[timearg] = tval + timestep
        try:
            return self.solve(arguments=arguments, **solveargs)
        except (SolverError, matrix.MatrixError) as e:
            if (timearg not in self.arguments and timesteparg not in self.arguments) or maxretry <= 0:
                raise
            log.error(f'error: {e}; retrying with timestep {timestep/2}')
            half = dict(solveargs, timestep=timestep / 2, timearg=timearg, timesteparg=timesteparg,
                        suffix=suffix, maxretry=maxretry - 1)
            halfway = self.step(arguments=arguments, **half)
            return self.step(arguments=halfway, **half)

    @log.withcontext
    def solve_constraints(self, *, droptol, arguments=None, constrain=None, linargs=None):
        '''Solve a possibly singular linear system, returning NaN for the
        dofs that do not take part (reference: ``nutils_tpu/solver.py:2060``).'''
        arguments = dict(arguments or {})
        constrain = dict(constrain or {})
        if not self.is_linear:
            raise SolverError('system is not linear')
        arguments, x = self.deconstruct(arguments, constrain)
        jac, res = self.assemble_jacobian_residual(arguments, x)
        data, colidx, _ = jac.export('csr')
        mycons = numpy.ones(res.shape, dtype=bool)
        mycons[colidx[numpy.abs(data) > droptol]] = False
        dx = -jac.solve(res, constrain=mycons, symmetric=self.is_symmetric, **(linargs or {}))
        log.info(f'constrained {int(mycons.sum())} of {len(mycons)} dofs; residual norm '
                 f'{numpy.linalg.norm((jac @ dx + res)[~mycons]):.1e}')
        x = x + dx
        x[mycons] = numpy.nan
        arguments = self._user_args(self.construct(arguments, x))
        return dict(constrain) | {t: arguments[t] for t in self.trials}


# ------------------------------------------------------------ methods

class Direct:
    '''One linear solve (reference: ``nutils_tpu/solver.py:2083``).'''

    def __init__(self, **linargs):
        self.linargs = linargs

    def __str__(self):
        return 'direct'

    def __call__(self, system, *, arguments, constrain):
        if not system.is_linear:
            raise SolverError('problem is not linear')
        arguments, x = system.deconstruct(arguments, constrain)
        jac, res = system.assemble_jacobian_residual(arguments, x)
        dx = jac.solve(res, symmetric=system.is_symmetric, **self.linargs)
        x = x - dx
        return system.construct(arguments, x), float(numpy.linalg.norm(res - jac @ dx))


class Newton:
    '''Newton's method (reference: ``nutils_tpu/solver.py:2101``): a
    generator of (arguments, residual norm), one jacobian solve a step.

    Unless the caller pins ``rtol``, the inner tolerance is Eisenstat-
    Walker's: ``eta_k = 0.9 (|r_k| / |r_(k-1)|)^2``, clamped to [1e-10,
    1e-3], so the early steps keep the lenient 1e-3 and the last update near
    quadratic convergence is solved tightly.'''

    def __init__(self, **linargs):
        self.linargs = dict(linargs)
        self._adaptive = 'rtol' not in self.linargs
        self.linargs.setdefault('rtol', 1e-3)

    def __str__(self):
        return 'newton'

    def __call__(self, system, *, arguments, constrain):
        arguments, x = system.deconstruct(arguments, constrain)
        prev = None
        while True:
            jac, res = system.assemble_jacobian_residual(arguments, x)
            resnorm = float(numpy.linalg.norm(res))
            yield system.construct(arguments, x), resnorm
            linargs = dict(self.linargs)
            if self._adaptive and prev:
                eta = 0.9 * (resnorm / prev) ** 2
                linargs['rtol'] = float(min(1e-3, max(eta, 1e-10)))
            prev = resnorm
            dx = jac.solve_leniently(res, symmetric=system.is_symmetric, **linargs)
            x = x - dx


class ReuseNewton:
    '''Newton reusing the previous jacobian for as long as the residual
    norm keeps shrinking by the ``require`` factor (reference:
    ``nutils_tpu/solver.py:2134``).'''

    def __init__(self, require=.5, **linargs):
        self.require = require
        self.linargs = dict(linargs)
        self.linargs.setdefault('rtol', 1e-3)

    def __str__(self):
        return 'reuse-newton'

    def __call__(self, system, *, arguments, constrain):
        arguments, x = system.deconstruct(arguments, constrain)
        res = system.assemble_residual(arguments, x)
        resnorm = float(numpy.linalg.norm(res))
        yield system.construct(arguments, x), resnorm
        fresh = True
        jac = None
        while True:
            if fresh:
                log.info('updating jacobian matrix')
                jac = system.assemble_jacobian(arguments, x)
            newx = x - jac.solve_leniently(res, symmetric=system.is_symmetric, **self.linargs)
            newres = system.assemble_residual(arguments, newx)
            newresnorm = float(numpy.linalg.norm(newres))
            if fresh or newresnorm < self.require * resnorm:
                x, res, resnorm = newx, newres, newresnorm
                yield system.construct(arguments, x), resnorm
                fresh = False
            else:
                fresh = True


class LinesearchNewton:
    '''Newton with strategy-driven relaxation (reference:
    ``nutils_tpu/solver.py:2168``).

    Iterates ``x <- x - relax J(x)^-1 r(x)``; the relaxation value starts at
    ``relax0`` and is updated by ``strategy`` (default :class:`NormBased`)
    from the residuals and directional derivatives before and after each
    trial step.  Raises SolverError when relaxation falls below
    ``failrelax``.'''

    def __init__(self, strategy=None, failrelax=1e-6, relax0=1., **linargs):
        self.strategy = strategy if strategy is not None else NormBased()
        assert callable(self.strategy)
        self.failrelax = failrelax
        self.relax0 = relax0
        self.linargs = dict(linargs)
        self.linargs.setdefault('rtol', 1e-3)

    def __str__(self):
        return 'linesearch-newton'

    def __call__(self, system, *, arguments, constrain):
        arguments, x = system.deconstruct(arguments, constrain)
        jac, res = system.assemble_jacobian_residual(arguments, x)
        relax = self.relax0
        while True:
            yield system.construct(arguments, x), float(numpy.linalg.norm(res))
            dx = -jac.solve_leniently(res, symmetric=system.is_symmetric, **self.linargs)
            res0 = res
            jac0dx = jac @ dx  # equals -res0 up to the linear solver's tolerance
            while True:
                newx = x + dx * relax
                jac, res = system.assemble_jacobian_residual(arguments, newx)
                scale, accept = self.strategy(res0, jac0dx * relax, res, (jac @ dx) * relax)
                if accept:
                    log.debug(f'update accepted at relaxation {relax:.5f}')
                    relax = min(relax * scale, 1.)
                    break
                assert scale < 1
                relax *= scale
                if relax <= self.failrelax:
                    raise SolverError('stuck in local minimum')
            x = newx


class Minimize:
    '''Energy minimization for symmetric systems (reference:
    ``nutils_tpu/solver.py:2211``).

    Starting from the Newton update, the two leading Ritz values of the
    jacobian on span{dx, res} define an approximate steepest-descent curve
    x(r) = x_newton - V exp(-r L); the relaxation exponent ramps up while the
    energy decreases along the curve and down otherwise.  Every trial point
    assembles the jacobian, the residual and the value (kernel K15).'''

    def __init__(self, rampup=.5, rampdown=-1., failrelax=-10., **linargs):
        self.rampup = rampup
        self.rampdown = rampdown
        self.failrelax = failrelax
        self.linargs = dict(linargs)
        self.linargs.setdefault('rtol', 1e-3)

    def __str__(self):
        return 'minimize'

    def __call__(self, system, *, arguments, constrain):
        if not system.is_symmetric:
            raise SolverError('minimize requires a symmetric system')
        arguments, x = system.deconstruct(arguments, constrain)
        jac, res = system.assemble_jacobian_residual(arguments, x)
        val = system.assemble_value(arguments, x)
        relax = 0.
        while True:
            yield system.construct(arguments, x), float(numpy.linalg.norm(res))
            dx = -jac.solve_leniently(res, symmetric=True, **self.linargs)
            x = x + dx  # vanilla Newton baseline
            # two-dimensional Lanczos on span{dx, jac dx}: the Ritz pair gives
            # the local spectrum that shapes the descent curve
            dxnorm = numpy.linalg.norm(dx)
            if dxnorm == 0:
                jac, res = system.assemble_jacobian_residual(arguments, x)
                val = system.assemble_value(arguments, x)
                continue
            k0 = dx / dxnorm
            k1 = -res / dxnorm  # = jac @ k0 up to the solver's tolerance
            a = float(k1 @ k0)
            k1 = k1 - k0 * a
            c = float(numpy.linalg.norm(k1))
            if c == 0:
                jac, res = system.assemble_jacobian_residual(arguments, x)
                val = system.assemble_value(arguments, x)
                continue
            k1 = k1 / c
            b = float(k1 @ (jac @ k1))
            D = numpy.hypot(b - a, 2 * c)
            L = numpy.array([a + b - D, a + b + D]) / 2  # Ritz values
            v0, v1 = res + dx * L[:, numpy.newaxis]
            V = numpy.stack([v1, -v0], axis=1) / D  # satisfies V @ L = -res, V.sum(1) = dx
            log.debug('spectrum: {:.1e}..{:.1e} ({}definite)'.format(
                L[0], L[1], 'positive ' if L[0] > 0 else 'negative ' if L[-1] < 0 else 'in'))
            val0 = val
            while True:  # line search along the descent curve
                r = numpy.exp(relax) / D
                eL = numpy.exp(-r * L)
                newx = x - V @ eL
                jac, res = system.assemble_jacobian_residual(arguments, newx)
                val = system.assemble_value(arguments, newx)
                slope = float(res @ (V @ (eL * L)))
                log.debug(f'energy {val - val0:+.2e} / e{relax:+.1f} and {"in" if slope > 0 else "de"}creasing')
                # epsilon slack keeps the acceptance test meaningful once the
                # energy decrement falls below float64 resolution near
                # convergence
                tiny = 1e-14 * (1 + abs(val0))
                if numpy.isfinite(val) and numpy.isfinite(res).all() and val <= val0 + tiny and slope <= tiny:
                    relax += self.rampup
                    break
                relax += self.rampdown
                if relax <= self.failrelax:
                    raise SolverError('stuck in local minimum')
            x = newx


class Arnoldi:
    '''Linear solve with subspace recycling across parameter changes
    (reference: ``nutils_tpu/solver.py:2286``).

    First use is a solve of the jacobian.  On reuse with a changed matrix
    A(y), the cached matrix P acts as a preconditioner: the solution is
    projected on the growing subspace [P b, P (A P) b, ...], each P solve
    direct on the host, until tolerance or ``maxiter``, after which the new
    matrix is solved and cached.'''

    def __init__(self, maxiter=2, **linargs):
        self.maxiter = maxiter
        self.linargs = linargs
        self._cached = None

    def __str__(self):
        return 'arnoldi'

    def __call__(self, system, *, arguments, constrain):
        if not system.is_linear:
            raise SolverError('problem is not linear')
        arguments, x = system.deconstruct(arguments, constrain)
        jac, res = system.assemble_jacobian_residual(arguments, x)
        yield system.construct(arguments, x), float(numpy.linalg.norm(res))

        approx = self._cached
        if approx is not None and approx.shape == jac.shape:
            dx_space = numpy.empty((self.maxiter, len(res)))
            dres_space = numpy.empty((self.maxiter, len(res)))
            for i in range(self.maxiter):
                try:
                    dx_space[i] = approx.solve(res, solver='direct', symmetric=system.is_symmetric, **self.linargs)
                    dres_space[i] = jac @ dx_space[i]
                    w, res2, *_ = numpy.linalg.lstsq(dres_space[:i + 1].T, res, rcond=None)
                    resnorm = float(numpy.sqrt(res2[0])) if len(res2) else float(
                        numpy.linalg.norm(res - w @ dres_space[:i + 1]))
                except Exception as e:
                    log.warning(f'subspace solve failed: {e}')
                    break
                x = x - w @ dx_space[:i + 1]
                yield system.construct(arguments, x), resnorm
                res = res - w @ dres_space[:i + 1]

        log.info('updating cached jacobian')
        self._cached = jac
        dx = jac.solve(res, symmetric=system.is_symmetric, **self.linargs)
        x = x - dx
        yield system.construct(arguments, x), float(numpy.linalg.norm(res - jac @ dx))


class Pseudotime:
    '''Inertia-assisted Newton: solves ``(J(x) + dJ/dt) dx = r(x)`` with the
    timestep growing as the residual shrinks (reference:
    ``nutils_tpu/solver.py:2335``).

    ``inertia`` is given in the same form as the system residual: a scalar
    functional carrying the system's test arguments, or a list of residual
    vectors (entries may be None) aligned with the trial arguments.  The
    sum ``jac + djac / timestep`` is the matrix algebra's, on the host.'''

    def __init__(self, inertia, timestep, **linargs):
        self.inertia = inertia
        self.timestep = timestep
        self.linargs = dict(linargs)
        self.linargs.setdefault('rtol', 1e-3)

    def __str__(self):
        return 'pseudotime'

    def _inertia_jacobian(self, system, arguments, free):
        '''Assemble the inertia jacobian over the full trial space, embedding
        sub-blocks for trials the inertia does not reference.'''
        import scipy.sparse
        inertia = self.inertia
        if isinstance(inertia, (tuple, list)) and system._synthetic_tests:
            pairs = [(i, f) for i, f in enumerate(inertia) if f is not None]
            isys = System([f for _, f in pairs], trial=[system.trials[i] for i, _ in pairs])
            rowmap = [i for i, _ in pairs]
        else:
            if isinstance(inertia, (tuple, list)):
                val = None
                for f in inertia:
                    if f is not None:
                        val = f if val is None else function.add(val, f)
                inertia = val
            present = set(function.arguments_for(inertia))
            idx = [i for i, (t, s) in enumerate(zip(system.trials, system.tests)) if t in present and s in present]
            isys = System(inertia, trial=[system.trials[i] for i in idx], test=[system.tests[i] for i in idx])
            rowmap = idx
        full = system.construct(arguments, numpy.zeros(int(free.sum())))
        sub = isys._jac_matrix(isys._clean({k: v for k, v in full.items() if k in isys.arguments})) \
            if set(isys.arguments) <= set(full) else isys.assemble_jacobian(full)
        m = sub._scipy().tocoo()
        # embed at the full system's (row, col) offsets
        roff = numpy.array([system._test_slices[i].start for i in rowmap])
        coff = numpy.array([system._trial_slices[i].start for i in rowmap])
        rstart = numpy.cumsum([0] + [int(numpy.prod(isys.test_shapes[j], dtype=numpy.int64)) for j in range(len(rowmap))])
        cstart = numpy.cumsum([0] + [int(numpy.prod(isys.trial_shapes[j], dtype=numpy.int64)) for j in range(len(rowmap))])
        rows = m.row.copy()
        cols = m.col.copy()
        for j in range(len(rowmap)):
            rsel = (m.row >= rstart[j]) & (m.row < rstart[j + 1])
            rows[rsel] += roff[j] - rstart[j]
            csel = (m.col >= cstart[j]) & (m.col < cstart[j + 1])
            cols[csel] += coff[j] - cstart[j]
        n = system._ntrial
        emb = scipy.sparse.coo_matrix((m.data, (rows, cols)), shape=(n, n)).tocsr()
        emb = matrix.Matrix(emb.indptr, emb.indices, emb.data, emb.shape)
        return emb.submatrix(free, free)

    def __call__(self, system, *, arguments, constrain):
        arguments, x = system.deconstruct(arguments, constrain)
        _, free = system.construct(arguments, x, return_free=True)
        djac = self._inertia_jacobian(system, arguments, free)
        resnorm0 = None
        while True:
            jac, res = system.assemble_jacobian_residual(arguments, x)
            resnorm = float(numpy.linalg.norm(res))
            yield system.construct(arguments, x), resnorm
            if resnorm0 is None:
                resnorm0 = resnorm
            timestep = self.timestep * (resnorm0 / resnorm)
            log.debug(f'timestep: {timestep:.0e}')
            x = x - (jac + djac * (1. / timestep)).solve_leniently(res, **self.linargs)


# ------------------------------------------------------------ legacy wrappers

def _split_trial_test(target):
    '''Split 'u:v,p:q' / ['u:v'] / 'u,p' targets into (trial, test)
    (reference: ``nutils_tpu/solver.py:2411``).'''
    if isinstance(target, str):
        target = target.rstrip(',')
        target = target.split(',') if target else []
    if not target:
        raise ValueError('no targets specified')
    parts = [item.split(':') if isinstance(item, str) else list(item) for item in target]
    n = len(parts[0])
    if not all(len(p) == n for p in parts):
        raise ValueError('inconsistent targets')
    if n == 1:
        return [p[0] for p in parts], None
    if n == 2:
        return [p[0] for p in parts], [p[1] for p in parts]
    raise ValueError('invalid targets')


def _is_single(target):
    return isinstance(target, str) and ',' not in target


def _as_cons(target, constrain):
    if constrain is None:
        return {}
    if isinstance(constrain, dict):
        return constrain
    name = target.split(':')[0] if isinstance(target, str) else target
    return {name: constrain}


def _make_system(target, residual):
    trial, test = _split_trial_test(target)
    if test is not None:
        if isinstance(residual, (tuple, list)):
            # list of scalar functionals sharing the test arguments: sum them
            val = None
            for r in residual:
                if r is not None:
                    val = r if val is None else function.add(val, r)
            residual = val
        return System(residual, trial=trial, test=test)
    if not isinstance(residual, (tuple, list)):
        residual = [residual]
    return System(list(residual), trial=trial)


def _strip_lin(kwargs):
    '''Extract 'lin'-prefixed keyword arguments (reference:
    ``nutils_tpu/solver.py:2459``).'''
    lin = {key[3:]: kwargs.pop(key) for key in list(kwargs) if key.startswith('lin')}
    if kwargs:
        raise TypeError('unexpected keyword arguments: {}'.format(', '.join(kwargs)))
    return lin


class _with_solve:
    '''Iterator over (arguments, resnorm) pairs with a ``.solve`` method
    (reference: ``nutils_tpu/solver.py:2467``).'''

    def __init__(self, system, method, arguments, constrain, item=None):
        self.system = system
        self.method = method
        self.arguments = arguments
        self.constrain = constrain
        self.item = item

    def __getitem__(self, item):
        assert self.item is None
        return _with_solve(self.system, self.method, self.arguments, self.constrain, item)

    def __iter__(self):
        class _info:
            def __init__(self, resnorm):
                self.resnorm = resnorm
        for arguments, resnorm in self.method(self.system, arguments=self.arguments, constrain=self.constrain):
            yield (arguments if self.item is None else arguments[self.item]), _info(resnorm)

    def solve(self, tol, maxiter=float('inf'), miniter=0):
        lhs, info = self.solve_withinfo(tol, maxiter=maxiter, miniter=miniter)
        return lhs

    def solve_withinfo(self, tol, maxiter=float('inf'), miniter=0):
        if miniter > maxiter:
            raise ValueError('miniter cannot exceed maxiter')
        it = enumerate(iter(self))
        iiter, (lhs, info) = next(it)
        while info.resnorm > tol or iiter < miniter:
            if iiter >= maxiter:
                raise SolverError(f'failed to reach target tolerance in {maxiter} iterations')
            iiter, (lhs, info) = next(it)
        log.info(f'converged in {iiter} iterations to residual {info.resnorm:.1e}')
        info.niter = iiter
        return lhs, info


def solve_linear(target, residual, *, constrain=None, arguments=None, **kwargs):
    '''Legacy functional API (reference: ``nutils_tpu/solver.py:2507``).'''
    if _is_single(target):
        name = target.split(':')[0]
        sys_ = _make_system(target, residual)
        return sys_.solve(constrain=_as_cons(target, constrain), arguments=arguments or {}, method=Direct(**_strip_lin(kwargs)))[name]
    sys_ = _make_system(target, residual)
    return sys_.solve(constrain=constrain or {}, arguments=arguments or {}, method=Direct(**_strip_lin(kwargs)))


def newton(target, residual, *, relax0=1., constrain=None, linesearch='normbased', failrelax=1e-6, arguments=None, **kwargs):
    '''Iteratively solve a nonlinear problem by Newton descent; returns an
    iterator with a ``.solve(tol)`` method (reference:
    ``nutils_tpu/solver.py:2517``).'''
    if linesearch == 'normbased':
        linesearch = NormBased()
    linargs = _strip_lin(kwargs)
    system = _make_system(target, residual)
    method = Newton(**linargs) if not linesearch \
        else LinesearchNewton(strategy=linesearch, relax0=relax0, failrelax=failrelax, **linargs)
    ws = _with_solve(system, method, arguments or {}, _as_cons(target, constrain))
    return ws[target] if _is_single(target) and ':' not in target else ws


def minimize(target, energy, *, constrain=None, rampup=.5, rampdown=-1., failrelax=-10., arguments=None, **kwargs):
    '''Iteratively minimize a scalar functional; returns an iterator with a
    ``.solve(tol)`` method (reference: ``nutils_tpu/solver.py:2530``).'''
    trial, test = _split_trial_test(target)
    assert test is None, 'minimize does not accept test targets'
    system = System(energy, trial=trial)
    method = Minimize(rampup=rampup, rampdown=rampdown, failrelax=failrelax, **_strip_lin(kwargs))
    ws = _with_solve(system, method, arguments or {}, _as_cons(target, constrain))
    return ws[target] if _is_single(target) else ws


def pseudotime(target, residual, inertia, timestep, *, constrain=None, arguments=None, **kwargs):
    '''Iteratively solve a nonlinear problem by pseudo-time stepping; returns
    an iterator with a ``.solve(tol)`` method (reference:
    ``nutils_tpu/solver.py:2541``).'''
    system = _make_system(target, residual)
    method = Pseudotime(inertia=inertia, timestep=timestep, **_strip_lin(kwargs))
    ws = _with_solve(system, method, arguments or {}, _as_cons(target, constrain))
    return ws[target] if _is_single(target) and ':' not in target else ws


def thetamethod(target, residual, inertia, timestep, theta, *, constrain=None, newtontol=1e-10,
                arguments=None, newtonargs=None, timetarget='_thetamethod_time', time0=0., historysuffix='0'):
    '''Time stepping by the theta method: theta=1 implicit Euler, theta=.5
    Crank-Nicolson (reference: ``nutils_tpu/solver.py:2550``).  Yields the
    argument dict per timestep, starting with the initial condition.  One
    System serves every step: the history and the time are arguments of
    its assembly (:meth:`System.step`).'''
    trial, test = _split_trial_test(target)
    residuals = list(residual) if isinstance(residual, (tuple, list)) else [residual]
    inertias = list(inertia) if isinstance(inertia, (tuple, list)) else [inertia]
    assert len(residuals) == len(inertias), 'one inertia term per residual'

    argspecs = function.arguments_for(*[f for f in residuals + inertias if f is not None])
    targ = function.Argument(timetarget, ())
    subs0 = {t: function.Argument(t + historysuffix, argspecs[t].shape, argspecs[t].dtype) for t in trial if t in argspecs}
    subs0[timetarget] = function.Argument(timetarget + historysuffix, ())
    dt = function.subtract(targ, subs0[timetarget])

    combined = []
    for res, inert in zip(residuals, inertias):
        term = function.add(function.multiply(function.asarray(theta), res),
                            function.multiply(function.asarray(1. - theta), function.replace_arguments(res, subs0)))
        if inert is not None:
            term = function.add(term, function.divide(
                function.subtract(inert, function.replace_arguments(inert, subs0)), dt))
        combined.append(term)

    if test is not None:
        value = None
        for term in combined:
            value = term if value is None else function.add(value, term)
        system = System(value, trial=trial, test=test)
    else:
        system = System(combined, trial=trial)

    arguments = dict(arguments or {})
    arguments.setdefault(timetarget, time0)
    newtonargs = dict(newtonargs or {})
    linesearch = newtonargs.pop('linesearch', NormBased())
    method = None if system.is_linear else Newton() if linesearch is None \
        else LinesearchNewton(strategy=linesearch, **newtonargs)
    constrain = _as_cons(target, constrain)
    single = _is_single(target)
    name = target.split(':')[0] if isinstance(target, str) else None

    def steps(arguments):
        while True:
            yield arguments[name] if single else arguments
            arguments = system.step(arguments=arguments, timestep=timestep, timearg=timetarget,
                                    suffix=historysuffix, constrain=constrain, tol=newtontol, method=method)
    return steps(arguments)


impliciteuler = functools.partial(thetamethod, theta=1.)
cranknicolson = functools.partial(thetamethod, theta=.5)


def optimize(target, functional, *, tol=0., droptol=None, constrain=None, arguments=None,
             relax0=1., linesearch='normbased', failrelax=1e-6, **kwargs):
    '''Find the minimizer of a functional (reference:
    ``nutils_tpu/solver.py:2605``).'''
    single = _is_single(target)
    trial, test = _split_trial_test(target)
    constrain = _as_cons(target, constrain)
    arguments = arguments or {}
    present = set(function.arguments_for(functional))
    missing = [t for t in trial if t not in present]
    if missing:
        if not droptol:
            raise ValueError(f'target {", ".join(missing)} does not occur in the functional; consider setting droptol>0')
        keep = [i for i, t in enumerate(trial) if t not in missing]
        trial = [trial[i] for i in keep]
        if test is not None:
            test = [test[i] for i in keep]
        if not trial:
            return {}
    linargs = _strip_lin(kwargs)
    sys_ = System(functional, trial=trial, test=test)
    if droptol is not None:
        cons = sys_.solve_constraints(droptol=droptol, arguments=arguments, constrain=constrain, linargs=linargs or None)
        return cons[target] if single else cons
    if linesearch == 'normbased':
        linesearch = NormBased()
    method = Direct(**linargs) if sys_.is_linear \
        else Newton(**linargs) if linesearch is None \
        else LinesearchNewton(strategy=linesearch, relax0=relax0, failrelax=failrelax, **linargs)
    out = sys_.solve(constrain=constrain, arguments=arguments, tol=tol, method=method)
    return out[target] if single else out
