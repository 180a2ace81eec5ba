'''Topologies: element sets with bases, boundaries and sampling.

The structured part of ``nutils_tpu.topology`` (copied): a topology produces
batched sample *tables* (root coordinates, parent indices, affine maps,
normals) host-side, in numpy.  Unstructured topologies are in
``unstructured.py``; hierarchical, trimmed and tensor-product topologies are
not ported yet (ROADMAP A6).
'''

import functools

import numpy

from . import element, function, sample as _sample
from .utils import _log as log


class Topology:

    def __init__(self, space, ndims):
        self.space = space
        self.ndims = ndims

    def __len__(self):
        raise NotImplementedError

    # ---------------------------------------------------------- sampling

    def sample(self, ischeme, degree=None):
        raise NotImplementedError

    def integral(self, func, *, degree=None):
        return self.sample('gauss', degree).integral(func)

    def integrate(self, funcs, *, degree=None, arguments=None, **kw):
        return self.sample('gauss', degree).integrate(funcs, arguments, **kw)

    # ---------------------------------------------------------- fields

    def basis(self, btype='std', degree=1, **kwargs):
        method = getattr(self, 'basis_' + btype.replace('-', '_'), None)
        if method is None:
            raise ValueError(f'unknown basis type {btype!r} for {type(self).__name__}')
        return method(degree, **kwargs)

    def field(self, name, *, btype='std', degree=1, shape=(), dtype=float, **kwargs):
        # function.field records the structured dof-grid layout of the basis
        # for the solver/matrix stencil and block-grid device operators
        basis = self.basis(btype, degree, **kwargs)
        return function.field(name, basis, shape=shape, dtype=dtype)

    @property
    def boundary(self):
        raise NotImplementedError

    def withboundary(self, **bgroups):
        '''Attach named boundary groups; string values refer to existing
        groups (reference: topology.py:734).'''
        resolved = {}
        for name, val in bgroups.items():
            if isinstance(val, str):
                val = self.boundary[val]
            resolved[name] = val
        return _WithGroupsTopology(self, resolved)

    # ------------------------------------------------------ subsets, refinement

    def subset(self, selection, newboundary=None, strict=False):
        raise NotImplementedError('hierarchical subsets are not ported yet (ROADMAP A6)')

    def refined_by(self, refine):
        raise NotImplementedError('hierarchical refinement is not ported yet (ROADMAP A6)')

    def trim(self, levelset, maxrefine, ndivisions=8, name='trimmed', *, arguments=None):
        raise NotImplementedError('trimming is not ported yet (ROADMAP A6)')

    @property
    def interfaces(self):
        raise NotImplementedError

    def __getitem__(self, item):
        raise KeyError(item)

    def __mul__(self, other):
        raise NotImplementedError('tensor-product topologies are not ported yet (ROADMAP A6)')


class StructuredTopology(Topology):
    '''Tensor grid of hypercube elements, C-order numbering (first axis
    slowest), root coordinates = element multi-index + local coordinate
    (reference: topology.py:1982 with transformseq.StructuredTransforms).'''

    def __init__(self, space, shape, periodic=(), root_h=1.0, origin=None, bnames=None):
        super().__init__(space, len(shape))
        self.shape = tuple(int(n) for n in shape)
        self.periodic = tuple(periodic)
        self.root_h = float(root_h)  # element size in root coordinates: the
        # root chart is stable under refinement so coarse bases and geometries
        # evaluate on refined samples (the analogue of the reference's shared
        # transform-chain roots, transformseq.py:526)
        self.origin = tuple(int(o) for o in origin) if origin is not None else (0,) * self.ndims
        # per-axis (lo, hi) boundary names (reference: mesh.line bnames)
        self.bnames = tuple(tuple(b) for b in bnames) if bnames is not None else None
        self.ref = element.hypercube(self.ndims)

    def __len__(self):
        return int(numpy.prod(self.shape, dtype=numpy.int64))

    def __repr__(self):
        return f'StructuredTopology({"x".join(map(str, self.shape))})'

    @functools.cached_property
    def _origins(self):
        '''Root-coordinate origin of each element, [nelems, ndims].'''
        grids = numpy.meshgrid(*[o + numpy.arange(n) for o, n in zip(self.origin, self.shape)], indexing='ij')
        return numpy.stack([g.ravel() for g in grids], axis=1).astype(float) * self.root_h

    def sample(self, ischeme, degree=None):
        E = len(self)
        d = self.ndims
        tri_local = hull_local = None
        if ischeme == 'gauss':
            assert degree is not None
            pts, wts = self.ref.gauss(degree)
        elif ischeme == 'bezier':
            pts, tri_local, hull_local = self.ref.bezier(degree)
            wts = None
        elif ischeme == 'uniform':
            n = degree or 1
            x1 = (numpy.arange(n) + 0.5) / n
            grids = numpy.meshgrid(*[x1] * d, indexing='ij')
            pts = numpy.stack([g.ravel() for g in grids], axis=1)
            wts = numpy.full(len(pts), 1.0 / len(pts))
        elif ischeme in ('vertex', '_centroid'):
            pts = self.ref.vertices if ischeme == 'vertex' else numpy.full((1, d), 0.5)
            wts = None
        else:
            raise ValueError(f'unknown sample scheme {ischeme!r}')
        P = len(pts)
        h = self.root_h
        coords = self._origins[:, None, :] + pts[None, :, :] * h
        weights = None if wts is None else numpy.broadcast_to(wts, (E, P)).copy()
        p_linear = numpy.broadcast_to(numpy.eye(d) / h, (E, d, d))
        p_offset = -self._origins / h
        tangents = numpy.broadcast_to(numpy.eye(d) * h, (E, d, d))
        return _sample.Sample(self.space, coords, weights, numpy.arange(E), p_linear, p_offset,
                              tangents, None, tri_local, hull_local, origin_topo=self)

    # ---------------------------------------------------------- boundaries

    _BNAMES = ('left', 'right'), ('bottom', 'top'), ('front', 'back')

    @functools.cached_property
    def boundary(self):
        sides = {}
        for idim in range(self.ndims):
            if idim in self.periodic:
                continue
            lo, hi = self.bnames[idim] if self.bnames is not None else self._BNAMES[idim]
            sides[lo] = _StructuredBoundary(self, idim, 0)
            sides[hi] = _StructuredBoundary(self, idim, 1)
        return UnionTopology(self.space, self.ndims - 1, sides)

    @property
    def interfaces(self):
        raise NotImplementedError('structured interfaces are not ported yet (ROADMAP A6)')

    # ---------------------------------------------------------- bases

    def _spline_tables(self, degree, continuity=-1, periodic=None, knotvalues=None, knotmultiplicities=None):
        from .ops import spline
        if isinstance(degree, int):
            degree = [degree] * self.ndims
        if periodic is None:
            periodic = self.periodic
        if knotvalues is None or numpy.isscalar(knotvalues[0]):
            knotvalues = [knotvalues] * self.ndims
        if knotmultiplicities is None or numpy.isscalar(knotmultiplicities[0]):
            knotmultiplicities = [knotmultiplicities] * self.ndims
        if not numpy.iterable(continuity):
            continuity = [continuity] * self.ndims
        offsets, coeffs, ndofs = [], [], []
        for i in range(self.ndims):
            o, c, n = spline.splinebasis_1d(self.shape[i], degree[i], periodic=i in periodic,
                                            knotvalues=knotvalues[i], knotmultiplicities=knotmultiplicities[i],
                                            continuity=continuity[i])
            offsets.append(o)
            coeffs.append(c)
            ndofs.append(n)
        return offsets, coeffs, ndofs

    def basis_spline(self, degree, removedofs=None, **kwargs):
        offsets, coeffs, ndofs = self._spline_tables(degree, **kwargs)
        basis = function.StructuredBasis(self.space, offsets, coeffs, ndofs, self.shape,
                                         topo=self, root_h=self.root_h)
        if removedofs is None or not any(removedofs):
            return basis
        if isinstance(removedofs[0], int):
            removedofs = [removedofs] * self.ndims
        mask = numpy.ones((), dtype=bool)
        for idofs, nd in zip(removedofs, ndofs):
            mask = mask[..., None].repeat(nd, axis=-1)
            if idofs:
                mask[..., [d % nd for d in idofs]] = False
        mb = function.MaskedBasis(basis, mask.ravel())
        # removing whole dof planes keeps a tensor-product numbering: the
        # kept dofs renumber row-major over the per-dim kept counts, so the
        # masked basis still carries an exact grid layout — unless a
        # periodic axis loses planes (renumbering shifts its wrap offsets)
        if not any(idofs and i in self.periodic for i, idofs in enumerate(removedofs)):
            mb._ndofs_per_dim = [nd - len({d % nd for d in idofs}) if idofs else nd
                                 for idofs, nd in zip(removedofs, ndofs)]
            mb._topo = self
        return mb

    def basis_std(self, degree, **kwargs):
        return self.basis_spline(degree, continuity=0, **kwargs)

    basis_bernstein = basis_std  # C0 splines are per-element Bernstein polys

    @property
    def refined(self):
        return StructuredTopology(self.space, tuple(2 * n for n in self.shape), self.periodic,
                                  root_h=self.root_h / 2, origin=tuple(2 * o for o in self.origin),
                                  bnames=self.bnames)

    def __getitem__(self, item):
        '''Contiguous sub-grid by per-axis slices, e.g. topo[:-1, :-1]
        (reference: topology.py:1982 StructuredTopology.__getitem__).  The
        sub-grid shares the parent's root chart so parent bases and geometry
        evaluate on its samples; slicing drops periodicity.'''
        if isinstance(item, str):
            raise KeyError(item)
        if not isinstance(item, tuple):
            item = (item,)
        item = item + (slice(None),) * (self.ndims - len(item))
        assert len(item) == self.ndims, 'too many indices'
        origin = []
        shape = []
        for sl, o, n in zip(item, self.origin, self.shape):
            assert isinstance(sl, slice) and sl.step in (None, 1), 'only contiguous slices are supported'
            start, stop, _ = sl.indices(n)
            assert stop > start, 'empty slice'
            origin.append(o + start)
            shape.append(stop - start)
        if tuple(shape) == self.shape:
            return self
        return StructuredTopology(self.space, shape, (), root_h=self.root_h, origin=origin, bnames=self.bnames)

    def refine(self, n):
        topo = self
        for _ in range(n):
            topo = topo.refined
        return topo

class _StructuredBoundary(Topology):
    '''One side of a structured topology: (ndims-1)-dim elements embedded in
    their parents via constant affine edge maps.  Supports slicing to a
    contiguous subset of side elements (reference: boundary getitem via
    DimAxis.getitem, transformseq.py:484).'''

    def __init__(self, parent, idim, side, subset=None):
        super().__init__(parent.space, parent.ndims - 1)
        self.parent = parent
        self.idim = idim
        self.side = side  # 0 = low, 1 = high
        self.subset = subset  # optional element index array into the full side
        self.ref = element.hypercube(self.ndims)

    def __len__(self):
        n = int(numpy.prod([n for i, n in enumerate(self.parent.shape) if i != self.idim], dtype=numpy.int64))
        return n if self.subset is None else len(self.subset)

    def __getitem__(self, item):
        nfull = int(numpy.prod([n for i, n in enumerate(self.parent.shape) if i != self.idim], dtype=numpy.int64))
        base = numpy.arange(nfull) if self.subset is None else self.subset
        if isinstance(item, slice):
            return _StructuredBoundary(self.parent, self.idim, self.side, base[item])
        if isinstance(item, (list, numpy.ndarray)):
            return _StructuredBoundary(self.parent, self.idim, self.side, base[numpy.asarray(item)])
        raise KeyError(item)

    @functools.cached_property
    def _tables(self):
        '''(parent_index [E], edge_linear [d, d-1], edge_offset_local [d], normal [d])'''
        p = self.parent
        d = p.ndims
        other = [i for i in range(d) if i != self.idim]
        grids = numpy.meshgrid(*[numpy.arange(p.shape[i]) for i in other], indexing='ij')
        nfull = int(numpy.prod([p.shape[i] for i in other], dtype=numpy.int64))
        multi = numpy.zeros((nfull, d), dtype=int)
        for k, i in enumerate(other):
            multi[:, i] = grids[k].ravel()
        multi[:, self.idim] = 0 if self.side == 0 else p.shape[self.idim] - 1
        parent_index = numpy.ravel_multi_index(multi.T, p.shape)
        lin = numpy.zeros((d, d - 1))
        for k, i in enumerate(other):
            lin[i, k] = 1.0
        off = numpy.zeros(d)
        off[self.idim] = float(self.side)
        nrm = numpy.zeros(d)
        nrm[self.idim] = -1.0 if self.side == 0 else 1.0
        return parent_index, lin, off, nrm

    def sample(self, ischeme, degree=None):
        E = len(self)
        d = self.parent.ndims
        parent_index, lin, off, nrm = self._tables
        if self.subset is not None:
            parent_index = parent_index[self.subset]
        tri_local = hull_local = None
        if ischeme == 'gauss':
            assert degree is not None
            pts, wts = self.ref.gauss(degree)
        elif ischeme == 'bezier':
            pts, tri_local, hull_local = self.ref.bezier(degree)
            wts = None
        elif ischeme == '_centroid':
            pts = numpy.full((1, self.ndims), 0.5)
            wts = None
        elif ischeme == 'uniform':
            pts, wts = self.ref.uniform(degree or 1)
        else:
            raise ValueError(f'unknown sample scheme {ischeme!r}')
        P = len(pts)
        h = self.parent.root_h
        # parent-local coordinates of the edge points
        xi_local = pts @ lin.T + off  # [P, d]
        origins = self.parent._origins[parent_index]  # [E, d]
        coords = origins[:, None, :] + xi_local[None, :, :] * h
        weights = None if wts is None else numpy.broadcast_to(wts, (E, P)).copy()
        p_linear = numpy.broadcast_to(numpy.eye(d) / h, (E, d, d))
        p_offset = -origins / h
        tangents = numpy.broadcast_to(lin * h, (E, d, d - 1))
        normal_root = numpy.broadcast_to(nrm, (E, d))
        return _sample.Sample(self.space, coords, weights, parent_index, p_linear, p_offset,
                              tangents, normal_root, tri_local, hull_local,
                              part_ids=numpy.zeros(E, dtype=int), part_topos=[self],
                              origin_topo=self.parent)

    def basis(self, btype='std', degree=1, **kwargs):
        return self.parent.basis(btype, degree, **kwargs)


class _WithGroupsTopology(Topology):
    '''Topology wrapper with user-defined named boundary groups
    (reference: topology.py:734 withboundary).'''

    def __init__(self, parent, bgroups):
        super().__init__(parent.space, parent.ndims)
        self.parent = parent
        self._bgroups = bgroups

    def __getitem__(self, item):
        return self.parent[item]

    def __len__(self):
        return len(self.parent)

    def __getattr__(self, name):
        return getattr(self.parent, name)

    @property
    def interfaces(self):
        return self.parent.interfaces

    @property
    def refined(self):
        return self.parent.refined

    def sample(self, ischeme, degree=None):
        return self.parent.sample(ischeme, degree)

    def basis(self, btype='std', degree=1, **kwargs):
        return self.parent.basis(btype, degree, **kwargs)

    @functools.cached_property
    def boundary(self):
        '''The full boundary (each face once); named groups resolve through
        aliases so whole-boundary integrals do not double count faces that
        also appear in a group (reference: boundary groups are subsets of the
        boundary, topology.py:734).'''
        pbnd = self.parent.boundary
        parts = dict(getattr(pbnd, 'parts', {}))
        if parts:
            return UnionTopology(self.space, self.ndims - 1, parts, aliases=self._bgroups)
        if hasattr(pbnd, '_edges'):
            # unstructured parent: named groups are edge subsets of the full
            # boundary; an unnamed remainder keeps whole-boundary integrals
            # and constraints on every exterior edge
            named = set()
            for g in self._bgroups.values():
                named.update(getattr(g, '_edges', ()))
            rest = [e for e in pbnd._edges if e not in named]
            parts = dict(self._bgroups)
            if rest:
                parts['_unnamed'] = type(pbnd)(pbnd.parent, rest)
            return UnionTopology(self.space, self.ndims - 1, parts)
        return UnionTopology(self.space, self.ndims - 1, self._bgroups)


class UnionTopology(Topology):
    '''Disjoint union of same-dimensional topologies with named groups
    (structured boundaries, withboundary groups).'''

    def __init__(self, space, ndims, parts, aliases=None):
        super().__init__(space, ndims)
        self.parts = dict(parts)
        self.aliases = dict(aliases or {})  # named views, not part of the union

    def _lookup(self, name):
        if name in self.aliases:
            return self.aliases[name]
        return self.parts[name]

    def __len__(self):
        return sum(len(p) for p in self.parts.values())

    def __getitem__(self, item):
        if isinstance(item, str):
            if ',' in item:
                return UnionTopology(self.space, self.ndims, {k: self._lookup(k) for k in item.split(',')})
            return self._lookup(item)
        raise KeyError(item)

    def sample(self, ischeme, degree=None):
        flat = []
        for p in self.parts.values():
            s = p.sample(ischeme, degree)
            flat.extend(s.samples if isinstance(s, _sample.ChainedSample) else [s])
        groups = {}
        for s in flat:
            groups.setdefault((s.batch_key, s.npoints_per_elem, s.ndims), []).append(s)
        merged = [_sample.Sample.concatenate(g) if len(g) > 1 else g[0] for g in groups.values()]
        if len(merged) == 1:
            return merged[0]
        return _sample.ChainedSample(merged)

    def basis(self, btype='std', degree=1, **kwargs):
        parts = list(self.parts.values())
        return parts[0].basis(btype, degree, **kwargs)
