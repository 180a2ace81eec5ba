'''Mesh generators (reference: mesh.py:34 rectilinear, :686 unitsquare):
the structured ones of ``nutils_tpu.mesh`` and its triangle and mixed unit
squares.'''

import numpy

from . import function, topology
from .utils import numeric


class _RectilinearGeom(function.Array):
    '''Piecewise-linear map from root coordinates to vertex positions:
    x_i = v_i[e_i] + (root_i - e_i) * (v_i[e_i+1] - v_i[e_i]), with constant
    per-element tables (differentiable in the root coordinates).'''

    def __init__(self, space, verts, shape, topo=None):
        self.space = space
        self.verts = [numpy.asarray(v, dtype=float) for v in verts]
        self.grid_shape = tuple(shape)
        self._topo = topo
        super().__init__((len(verts),), float, frozenset({space}), {})

    def _base_cells(self, chart):
        '''Base-grid cell multi-index [E, d] of the chart's elements (charts
        of the base topology only; refined and located charts are ROADMAP
        A6).'''
        if self._topo is None or chart.origin_topo is self._topo or chart.origin_topo is None:
            return numpy.stack(numpy.unravel_index(chart.index, self.grid_shape), axis=1)
        raise NotImplementedError('rectilinear geometry on a foreign chart (ROADMAP A6)')

    def lower(self, args):
        from . import evaluable as ev
        chart = args.chart(self.space)
        multi = self._base_cells(chart)  # [E, d]
        c0 = numpy.empty(multi.shape, dtype=float)
        c1 = numpy.empty(multi.shape, dtype=float)
        for i, v in enumerate(self.verts):
            dv = numpy.diff(v)
            c1[:, i] = dv[multi[:, i]]
            c0[:, i] = v[multi[:, i]] - multi[:, i] * dv[multi[:, i]]
        E, P = args.points_shape
        c0x = ev.insertaxis(ev.constant(c0), 1, P)
        c1x = ev.insertaxis(ev.constant(c1), 1, P)
        return ev.add(c0x, ev.multiply(c1x, chart.X))


def rectilinear(richshape, periodic=(), space='X', bnames=None):
    '''Structured mesh: integer axis sizes or explicit vertex positions
    (reference: mesh.py:34).'''
    verts = [numpy.arange(v + 1, dtype=float) if numeric.isint(v) else numpy.asarray(v, dtype=float) for v in richshape]
    shape = [len(v) - 1 for v in verts]
    topo = topology.StructuredTopology(space, shape, periodic, bnames=bnames)
    if all(numeric.isint(v) for v in richshape):
        geom = function._RootCoords(space, len(shape))
    else:
        geom = _RectilinearGeom(space, verts, shape, topo)
    return topo, geom


def line(nodes, periodic=False, space='X', bnames=None):
    '''1-D mesh with scalar geometry (reference: mesh.py:66).'''
    topo, geom = rectilinear([nodes], periodic=(0,) if periodic else (), space=space,
                             bnames=None if bnames is None else [bnames])
    return topo, geom[0]


def unitsquare(nelems, etype='square'):
    '''Unit square [0,1]^2 as structured squares, unstructured triangles, or a
    mixed triangle/square mesh (reference: mesh.py:686; the triangle/mixed
    vertex and element numbering is the JAX package's, so dof orderings and
    sparsity patterns match).  The multipatch variant needs multipatch
    topologies (ROADMAP A6).'''
    from . import element
    from .unstructured import UnstructuredTopology

    if etype in ('square', 'rectilinear'):
        topo, geom = rectilinear([nelems, nelems])
        return topo, geom / nelems
    if etype == 'multipatch':
        raise NotImplementedError('unitsquare etype \'multipatch\' is not ported yet (ROADMAP A6)')
    if etype not in ('triangle', 'mixed'):
        raise ValueError(f'invalid element type {etype!r}')

    n = nelems
    # vertex grid: id = i*(n+1)+j at coordinates (i, j); each cell (i, j),
    # row-major, split into two sorted-vertex triangles with a
    # parity-dependent diagonal
    i, j = numpy.divmod(numpy.arange(n * n), n)
    v00 = i * (n + 1) + j
    v01, v10 = v00 + 1, v00 + (n + 1)
    v11 = v10 + 1
    even = (i % 2 == j % 2)[:, None]
    first = numpy.where(even, numpy.stack([v00, v01, v10], 1), numpy.stack([v00, v01, v11], 1))
    second = numpy.where(even, numpy.stack([v01, v10, v11], 1), numpy.stack([v00, v10, v11], 1))
    elem_verts = numpy.stack([first, second], axis=1).reshape(2 * n * n, 3)
    tri = element.simplex(2)
    refs = [tri] * len(elem_verts)

    if etype == 'mixed':
        square = element.hypercube(2)
        elem_verts = list(elem_verts)
        isquares = [i * n + j for i in range(n) for j in range(n) if i % 2 == j % 3]
        for cell in sorted(isquares, reverse=True):
            merged = numpy.unique(numpy.concatenate([elem_verts[2 * cell], elem_verts[2 * cell + 1]]))
            refs[2 * cell:2 * cell + 2] = [square]
            elem_verts[2 * cell:2 * cell + 2] = [merged]

    v = numpy.arange(n + 1, dtype=float)
    coords = numeric.meshgrid(v, v).reshape(2, -1).T
    topo = UnstructuredTopology('X', refs, elem_verts, (n + 1) ** 2)
    basis = topo.basis('std', degree=1)
    if etype == 'mixed':
        # coords permuted to the basis's merged dof numbering (first
        # appearance order of vertices over elements; reference: mesh.py:748)
        order = numpy.argsort(numpy.unique(numpy.concatenate(elem_verts), return_index=True)[1])
        coords = coords[order]
    geom = function.matmul(basis, function.asarray(coords))

    # named boundary groups from boundary-edge centroids
    btopo = topo.boundary
    bsmp = btopo.sample('_centroid', None)
    x, y = numpy.asarray(bsmp.eval(geom)).T
    perm = _sample_elem_perm(bsmp, btopo)
    masks = {'left': x < .1, 'right': x > n - .1, 'bottom': y < .1, 'top': y > n - .1}
    groups = {}
    for name, m in masks.items():
        medges = numpy.zeros(len(btopo), dtype=bool)
        medges[perm] = m
        groups[name] = btopo[medges]
    topo = topo.withboundary(**groups)
    return topo, geom / n


def _sample_elem_perm(smp, topo):
    '''Map sample row order to topology element order (chained samples order
    elements bucket-by-bucket).'''
    from .sample import ChainedSample
    if not isinstance(smp, ChainedSample):
        return numpy.arange(len(topo))
    buckets = {}
    for k, (ielem, iedge) in enumerate(topo._edges):
        ref = topo.parent._refs[ielem]
        key = (type(ref).__name__, type(ref.edges[iedge][3]).__name__)
        buckets.setdefault(key, []).append(k)
    return numpy.asarray([k for rows in buckets.values() for k in rows])
