'''Carry-over of ``nutils_tpu`` state into the port.

For a finite element system the "weights" are the argument dof vectors and
the assembled operator.  These helpers take them as numpy arrays (as
``numpy.asarray`` of the JAX package's arrays gives them) and build the
port's tensors and objects, so that the solve can be run on an operator
that ``nutils_tpu`` assembled, independently of the port's assembly.
'''

import numpy
import torch

from . import matrix
from .ops import blockgrid as _bg
from .ops import mg as _mg
from .utils import config


def _device(device):
    return config.torch_device() if device is None else torch.device(device)


def arguments_from_numpy(args, device=None, dtype=None):
    '''``{'u': ndarray}`` -> ``{'u': tensor}`` of ``dtype`` (default
    config.floatx) on ``device`` (default config.device).'''
    tdt = config.torch_dtype(float if dtype is None else numpy.dtype(dtype))
    dev = _device(device)
    return {name: torch.as_tensor(numpy.asarray(v), device=dev).to(tdt) for name, v in args.items()}


class _Shape:
    '''Pattern stand-in for a stencil matrix that has no CSR pattern: only
    the shape is known until the CSR face is asked for.'''

    def __init__(self, n):
        self.shape = (n, n)


def stencil_matrix_from_numpy(w, ks, grid, periodic, shape=None, device=None):
    '''A ``nutils_tpu`` ``_StencilMatrix``'s weights (``numpy.asarray(jac._w)``,
    flat or [W, *grid]) and stencil metadata -> the port's ``_StencilMatrix``
    on ``device``.  Its CSR face (``data``/``indices``/``indptr``, which the
    multigrid set-up reads) holds every in-grid window slot of every row.'''
    ks = tuple(int(k) for k in ks)
    grid = tuple(int(g) for g in grid)
    n = int(numpy.prod(grid))
    W = int(numpy.prod([2 * k + 1 for k in ks]))
    w = numpy.array(numpy.asarray(w).reshape(W * n))
    if shape is not None and tuple(shape) != (n, n):
        raise ValueError(f'shape {tuple(shape)} does not match the grid {grid}')
    wt = torch.as_tensor(w, device=_device(device))
    m = matrix._StencilMatrix(_Shape(n), wt, ks, grid, None, periodic)
    csr = _csr_of_stencil(w.reshape((W,) + grid), ks, grid, periodic)
    m.indptr, m.indices, m.data = csr
    return m


def _csr_of_stencil(w, ks, grid, periodic):
    '''CSR arrays (indptr, indices, data) of the stencil operator: one entry
    per (row, in-grid window slot), nonzero or not, columns sorted.'''
    import scipy.sparse
    n = int(numpy.prod(grid))
    periodic = tuple(bool(p) for p in (periodic or (False,) * len(grid)))
    coords = numpy.indices(grid).reshape(len(grid), n)
    windows = [2 * k + 1 for k in ks]
    rows, cols, vals = [], [], []
    for s, digits in enumerate(numpy.ndindex(*windows)):
        col = numpy.zeros(n, dtype=numpy.int64)
        ok = numpy.ones(n, dtype=bool)
        for ax, (dg, k, g, per) in enumerate(zip(digits, ks, grid, periodic)):
            q = coords[ax] + dg - k
            if per:
                q = q % g
            else:
                ok &= (q >= 0) & (q < g)
            col = col * g + numpy.clip(q, 0, g - 1)
        vals.append(w[s].reshape(-1)[ok])
        rows.append(numpy.nonzero(ok)[0])
        cols.append(col[ok])
    A = scipy.sparse.csr_matrix((numpy.concatenate(vals), (numpy.concatenate(rows), numpy.concatenate(cols))),
                                shape=(n, n))
    A.sort_indices()
    return A.indptr, A.indices, A.data


class _CSRPattern:
    '''Pattern of a carried CSR operator: shape, indptr and indices.'''

    def __init__(self, indptr, indices, n):
        self.shape = (n, n)
        self.indptr = numpy.asarray(indptr)
        self.indices = numpy.asarray(indices)


def csr_matrix_from_numpy(data, indices, indptr, shape, device=None, dtype=None):
    '''A ``nutils_tpu`` CSR jacobian (``numpy.asarray(jac.data)``,
    ``jac.indices``, ``jac.indptr``, ``jac.shape``) -> the port's ``Matrix``
    with its values on ``device`` in ``dtype`` (default: the values' dtype).
    Its device operator is routed as for an assembled CSR jacobian.'''
    data = numpy.array(data, dtype=dtype)
    return matrix.Matrix(indptr, indices, torch.as_tensor(data, device=_device(device)), shape)


def blockgrid_matrix_from_numpy(data, indices, indptr, field_offsets, field_grids, device=None, dtype=None):
    '''A ``nutils_tpu`` block-grid jacobian's CSR values and pattern
    (``numpy.asarray(jac.data)``, ``jac.indices``, ``jac.indptr``,
    ``jac._field_offsets``, ``jac._field_grids``) -> the port's
    ``_BlockGridMatrix`` on ``device``, with weights of ``dtype`` (default:
    the values' dtype).  The weights come from the port's own ``detect`` and
    ``refill``: the JAX package's raw weight buffers are in another (axis-
    permuted) layout, so only CSR values are carried.'''
    data = numpy.asarray(data)
    if dtype is not None:
        data = data.astype(dtype)
    indptr = numpy.asarray(indptr)
    n = len(indptr) - 1
    form = _bg.detect(data, indices, indptr, field_offsets, grids=field_grids)
    if form is None:
        raise ValueError('the operator has no block-grid form')
    sizes = form.fill[0]
    woff = numpy.concatenate([[0], numpy.cumsum(sizes)[:-1]]).astype(numpy.int64)
    w = numpy.concatenate([a.ravel() for a in _bg.refill(form, data)])
    csr_map = woff[form.fill[1]] + form.fill[2]
    m = matrix._BlockGridMatrix(_CSRPattern(indptr, indices, n), torch.as_tensor(w, device=_device(device)),
                                form.meta, sizes, csr_map, woff)
    m._field_offsets = tuple(int(o) for o in field_offsets)
    m._field_grids = tuple(field_grids)
    return m


def mgdata_from_numpy(ws, dinvs, coarse_inv, levels, device=None):
    '''A ``nutils_tpu`` ``ops.mg.MGData`` (its arrays as numpy) -> the port's
    ``MGData`` with tensors on ``device``.'''
    dev = _device(device)

    def put(a):
        return torch.as_tensor(numpy.array(a, order='C'), device=dev)
    levels = tuple((tuple(int(k) for k in ks), tuple(int(s) for s in shape), tuple(bool(p) for p in per))
                   for ks, shape, per in levels)
    return _mg.MGData(tuple(put(w) for w in ws), tuple(put(d) for d in dinvs), put(coarse_inv), levels)

