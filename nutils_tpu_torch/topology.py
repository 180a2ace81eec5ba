'''Topologies: element sets with bases, boundaries and sampling.

A copy of ``nutils_tpu.topology``: a topology produces batched sample
*tables* (root coordinates, parent indices, affine maps, normals) host-side,
in numpy.  Unstructured topologies are in ``unstructured.py`` (with the
Newton point location the others share), trimmed ones in ``trim.py``,
hierarchical ones in ``hierarchical.py`` and multipatch ones in
``multipatch.py``.

>>> import numpy
>>> from nutils_tpu_torch import mesh, function
>>> topo, geom = mesh.rectilinear([2, 2])
>>> len(topo)
4
>>> float(topo.integrate(function.J(geom), degree=1))
4.0±1e-12
>>> basis = topo.basis('spline', degree=2)
>>> basis.ndofs
16
>>> float(topo.boundary.integrate(function.J(geom), degree=1))
8.0±1e-12
>>> len(topo.refined)
16
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

    def integrate_elementwise(self, func, *, degree, arguments=None, asfunction=False):
        '''Element-wise integrals as a [nelems, ...] array (reference:
        topology.py:406).'''
        smp = self.sample('gauss', degree)
        parts = smp.samples if isinstance(smp, _sample.ChainedSample) else [smp]
        vals = function.eval([_sample._ElemIntegral(function.asarray(func), s) for s in parts],
                             arguments or {})
        out = numpy.concatenate([numpy.asarray(v) for v in vals])
        if asfunction:
            # piecewise-constant function carrying each element's integral
            # (reference: topology.py:420 asfunction branch): the degree-0
            # discontinuous basis is the element indicator set
            b = self.basis('discont', degree=0)
            v = function.asarray(out)
            for n in out.shape[1:]:
                b = function.insertaxis(b, b.ndim, n)
            return function.sum_(function.multiply(b, v), 0)
        return out

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

    def project(self, fun, onto, geometry, *, degree=None, droptol=1e-12, ptype='lsqr',
                exact_boundaries=False, constrain=None, verify=None, arguments=None, **kwargs):
        '''Projection of ``fun`` onto a basis; returns the dof vector with
        NaN at dofs without support (reference: topology.py:448).

        ``ptype='lsqr'`` solves the L2-projection normal equations;
        ``'convolute'`` divides the convolution of ``fun`` against the basis
        by the basis volumes (diagonal approximation, no solve);
        ``'nodal'`` divides point sums over the ``bezier 2`` vertex sample
        (exact for nodal bases; uses unit point weights where the reference
        weights per element volume, identical except on mixed-type meshes).
        '''
        from .solver import System
        fun = function.asarray(fun)
        onto = function.asarray(onto)
        ndofs = int(onto.shape[0])
        cons = numpy.full(ndofs, numpy.nan) if constrain is None \
            else numpy.array(numpy.asarray(constrain, dtype=float), copy=True)
        if exact_boundaries:
            bc = self.boundary.project(fun, onto, geometry, degree=degree, droptol=droptol,
                                       ptype=ptype, arguments=arguments)
            free = numpy.isnan(cons)
            cons[free] = numpy.asarray(bc)[free]
        J = function.J(geometry)
        vector = onto.ndim == 2

        if ptype == 'lsqr':
            assert degree is not None, 'please specify an integration degree for lsqr-projection'
            u = function.dotarg('__project__', onto)
            err2 = ((u - fun) ** 2).sum(-1) if vector else (u - fun) ** 2
            sqr = self.integral(err2 * J, degree=degree)
            out = System(sqr, trial='__project__').solve_constraints(
                droptol=droptol, arguments=arguments or {},
                constrain={'__project__': cons} if not numpy.isnan(cons).all() else None)
            result = numpy.asarray(out['__project__'])
        elif ptype == 'convolute':
            assert degree is not None, 'please specify an integration degree for convolute-projection'
            if vector:
                ufun = (onto * fun).sum(-1)
                afun = function.sqrt((onto ** 2).sum(-1))
            else:
                ufun = onto * fun
                afun = onto
            smp = self.sample('gauss', degree)
            u, scale = (numpy.asarray(a) for a in
                        smp.integrate([ufun * J, afun * J], arguments or {}))
            result = cons.copy()
            N = numpy.isnan(result) & (numpy.abs(scale) > droptol)
            result[N] = u[N] / scale[N]
        elif ptype == 'nodal':
            bezier = self.sample('bezier', 2)
            if vector:
                wfun, ffun = (onto ** 2).sum(-1), (onto * fun).sum(-1)
            else:
                wfun, ffun = onto, onto * fun
            Wp, Fp = (numpy.asarray(a) for a in bezier.eval([wfun, ffun], arguments or {}))
            W, F = Wp.sum(0), Fp.sum(0)
            result = cons.copy()
            N = numpy.isnan(result) & (numpy.abs(W) > droptol)
            result[N] = F[N] / W[N]
        else:
            raise ValueError(f'invalid projection type {ptype!r}')

        numcons = int((~numpy.isnan(result)).sum())
        if verify is not None:
            assert numcons == verify, \
                f'number of constraints does not meet expectation: {numcons} != {verify}'
        return result

    @property
    def boundary(self):
        raise NotImplementedError

    # ------------------------------------------------------ subsets, refinement

    def select(self, indicator, ischeme='bezier2', *, arguments=None, **kwargs):
        '''Selection of the elements on which ``indicator`` is positive at any
        point of the sample (reference: topology.py:765).'''
        import re
        m = re.fullmatch(r'([a-zA-Z_]+?)(\d*)', ischeme)
        scheme, sdeg = m.group(1), m.group(2)
        degree = int(sdeg) if sdeg else None
        smp = self.sample(scheme, degree)
        vals = numpy.asarray(smp.eval(function.asarray(indicator), arguments or {}))
        mask = numpy.zeros(len(self), dtype=bool)
        parts = smp.samples if isinstance(smp, _sample.ChainedSample) else [smp]
        pos = 0
        for s in parts:
            v = vals[pos:pos + s.npoints].reshape(s.nelems, s.npoints_per_elem)
            mask[s.index[(v > 0).any(axis=1)]] = True
            pos += s.npoints
        return self._subset_view(self, numpy.nonzero(mask)[0])

    def indicator(self, subtopo):
        '''Function that is 1 on the given subtopology (a name resolving via
        ``__getitem__`` or a whole-element subset view of this topology) and
        0 elsewhere (reference: topology.py:760).'''
        parts = [self[n] for n in subtopo.split(',')] if isinstance(subtopo, str) else [subtopo]
        plain = self
        while isinstance(plain, _WithGroupsTopology):
            plain = plain.parent
        mask = numpy.zeros(len(self))
        for p in parts:
            sub = p._whole_subset()
            if sub is None or (sub[0] is not self and sub[0] is not plain):
                raise NotImplementedError('indicator requires whole-element subset groups of this topology')
            mask[sub[1]] = 1.0
        b = self.basis('discont', degree=0)
        return function.sum_(function.multiply(b, function.asarray(mask)), 0)

    def subset(self, selection, newboundary=None, strict=False):
        '''Whole-element subset topology; newly exposed inter-element edges
        form the boundary group ``newboundary`` (reference: topology.py:720;
        the whole-element case of SubsetTopology, topology.py:2615).'''
        from .hierarchical import HierarchicalTopology
        if isinstance(selection, _Selection):
            ielems = selection.ielems
        elif isinstance(selection, Topology):
            sub = selection._whole_subset()
            plain = self
            while isinstance(plain, _WithGroupsTopology):
                plain = plain.parent
            if sub is None or (sub[0] is not self and sub[0] is not plain):
                raise ValueError('subset selection topology is not a subset view of this topology')
            ielems = sub[1]
        else:
            ielems = numpy.asarray(selection, dtype=int)
        return HierarchicalTopology(self, [ielems], newboundary=newboundary)

    def refined_by(self, refine):
        '''Hierarchical topology with the given elements replaced by their
        children (reference: topology.py:531).'''
        from .hierarchical import HierarchicalTopology
        return HierarchicalTopology(self, [numpy.arange(len(self))]).refined_by(refine)

    def trim(self, levelset, maxrefine, ndivisions=8, name='trimmed', *, arguments=None):
        '''Trim along a levelset, keeping the positive side (reference:
        topology.py:1603).'''
        from . import trim as _trim
        return _trim.trim(self, levelset, maxrefine, ndivisions, name, arguments=arguments)

    def withboundary(self, **bgroups):
        '''Attach named boundary groups; string values refer to existing
        groups (reference: topology.py:734).'''
        resolved = {}
        for name, val in bgroups.items():
            if isinstance(val, str):
                val = self.boundary[val]
            resolved[name] = val
        return _WithGroupsTopology(self, resolved)

    def withsubdomain(self, **vgroups):
        '''Attach named volume groups, accessible via ``topo[name]``
        (reference: topology.py:731 withsubdomain).'''
        out = _WithGroupsTopology(self, {})
        out._vgroups = dict(vgroups)
        return out

    @property
    def interfaces(self):
        raise NotImplementedError

    def __getitem__(self, item):
        raise KeyError(item)

    def __mul__(self, other):
        '''Tensor product over disjoint spaces (reference: topology.py:1239
        _Mul): samples, bases and boundaries tensorize.'''
        return _MulTopology(self, other)

    # ------------------------------------------------------------ set algebra
    # (reference: topology.py:1498-1538 __or__/__and__/__sub__; the whole-
    # element cases operate on recorded (base, element-indices) subset views,
    # the trim case re-trims the complement levelset)

    def _whole_subset(self):
        '''``(base, ielems)`` when this topology is a whole-element subset
        view of a parent (single-level hierarchical subset or unstructured
        subset view), else None.'''
        from .hierarchical import HierarchicalTopology
        from .unstructured import UnstructuredSubsetTopology
        if isinstance(self, HierarchicalTopology) and self.nlevels == 1:
            return self.basetopo, self._ipl[0]
        if isinstance(self, UnstructuredSubsetTopology):
            return self.parent, self._ielems
        return None

    @staticmethod
    def _subset_view(base, ielems):
        ielems = numpy.unique(numpy.asarray(ielems, dtype=int))
        if len(ielems) == len(base):
            return base
        take = getattr(base, 'take', None)
        return take(ielems) if take is not None else base.subset(ielems)

    def __or__(self, other):
        if not isinstance(other, Topology) or other.space != self.space or other.ndims != self.ndims:
            return NotImplemented
        if not len(other):
            return self
        if not len(self):
            return other
        a = self._whole_subset()
        b = other._whole_subset()
        if a is not None and b is not None and a[0] is b[0]:
            return self._subset_view(a[0], numpy.union1d(a[1], b[1]))
        if b is not None and b[0] is self:
            return self
        if a is not None and a[0] is other:
            return other
        return UnionTopology(self.space, self.ndims, {'_0': self, '_1': other})

    __ror__ = __or__

    def __add__(self, other):
        return self.__or__(other)

    def __and__(self, other):
        if not isinstance(other, Topology) or other.space != self.space or other.ndims != self.ndims:
            return NotImplemented
        a = self._whole_subset()
        b = other._whole_subset()
        if a is not None and b is not None and a[0] is b[0]:
            return self._subset_view(a[0], numpy.intersect1d(a[1], b[1]))
        if b is not None and b[0] is self:
            return other
        if a is not None and a[0] is other:
            return self
        return NotImplemented

    __rand__ = __and__

    def __sub__(self, other):
        '''Complement of ``other`` within ``self``: the negative side of a
        trim (re-trimmed along the negated levelset at the same refinement
        depth, so measures partition exactly), or the complementary element
        set of a whole-element subset view.'''
        from .trim import TrimmedTopology
        if not isinstance(other, Topology) or other.space != self.space or other.ndims != self.ndims:
            return NotImplemented
        if isinstance(other, TrimmedTopology):
            plain = self
            while isinstance(plain, _WithGroupsTopology):
                plain = plain.parent
            if other.plain is plain:
                specs = other._trim_specs
                combined = specs[0][0]
                merged = dict(specs[0][3])
                for ls, _mr, _nm, ar in specs[1:]:
                    combined = function.min_(combined, ls)
                    merged.update(ar)  # cross-spec conflicts were rejected at trim time
                return self.trim(-combined, maxrefine=max(s[1] for s in specs),
                                 name=specs[-1][2], arguments=merged)
        b = other._whole_subset()
        if b is not None:
            base, ielems = b
            if base is self:
                return self._subset_view(self, numpy.setdiff1d(numpy.arange(len(self)), ielems))
            a = self._whole_subset()
            if a is not None and a[0] is base:
                return self._subset_view(base, numpy.setdiff1d(a[1], ielems))
        return NotImplemented


class _Selection:
    '''Result of Topology.select: the element indices to keep.'''

    def __init__(self, topo, ielems):
        self.topo = topo
        self.ielems = numpy.asarray(ielems, dtype=int)

    def __len__(self):
        return len(self.ielems)


class _MulTopology(Topology):
    '''Tensor product of two topologies with disjoint spaces.'''

    def __init__(self, topo1, topo2):
        assert topo1.space != topo2.space, 'tensor product requires disjoint spaces'
        super().__init__(topo1.space, topo1.ndims + topo2.ndims)
        self.topo1 = topo1
        self.topo2 = topo2

    def __len__(self):
        return len(self.topo1) * len(self.topo2)

    def sample(self, ischeme, degree=None):
        return self.topo1.sample(ischeme, degree) * self.topo2.sample(ischeme, degree)

    def _split_kwargs(self, kwargs):
        kw1, kw2 = {}, {}
        n1 = self.topo1.ndims
        for attr in ('degree', 'continuity'):
            val = kwargs.pop(attr, None)
            if val is None:
                continue
            if isinstance(val, int):
                kw1[attr] = kw2[attr] = val
            else:
                kw1[attr] = tuple(val[:n1])
                kw2[attr] = tuple(val[n1:])
        val = kwargs.pop('periodic', None)
        if val is not None:
            kw1['periodic'] = tuple(p for p in val if p < n1)
            kw2['periodic'] = tuple(p - n1 for p in val if p >= n1)
        for attr in ('knotvalues', 'knotmultiplicities', 'removedofs'):
            val = kwargs.pop(attr, None)
            if val is None:
                continue
            kw1[attr] = tuple(val[:n1])
            kw2[attr] = tuple(val[n1:])
        kw1.update(kwargs)
        kw2.update(kwargs)
        return kw1, kw2

    def bases(self, btype='std', **kwargs):
        kw1, kw2 = self._split_kwargs(dict(kwargs))
        return [self.topo1.basis(btype, **kw1), self.topo2.basis(btype, **kw2)]

    def basis(self, btype='std', degree=1, **kwargs):
        raise NotImplementedError('use field() or bases() on tensor-product topologies')

    def field(self, name, *, btype='std', shape=(), dtype=float, **kwargs):
        return function.field(name, *self.bases(btype, **kwargs), shape=shape, dtype=dtype)

    @functools.cached_property
    def boundary(self):
        parts = {}

        def addpart(key, topo):
            while key in parts:
                key += "'"
            parts[key] = topo

        for topo, make in ((self.topo1, lambda p: _MulTopology(p, self.topo2)),
                           (self.topo2, lambda p: _MulTopology(self.topo1, p))):
            try:
                items = list(topo.boundary.parts.items())
            except (NotImplementedError, AttributeError):
                items = [(f'__{topo.space}__', topo.boundary)]
            except KeyError:
                items = []
            for k, p in items:
                addpart(k, make(p))
        return _MulBoundary(self.space, self.ndims - 1, parts)


class _MulBoundary(Topology):
    '''Boundary of a tensor-product topology: a union of lower-dimensional
    products whose samples generally have different point structures, hence
    always chained.'''

    def __init__(self, space, ndims, parts):
        super().__init__(space, ndims)
        self.parts = dict(parts)

    def __len__(self):
        return sum(len(p) for p in self.parts.values())

    def __getitem__(self, item):
        if isinstance(item, str):
            if ',' in item:
                return _MulBoundary(self.space, self.ndims, {k: self.parts[k] for k in item.split(',')})
            return self.parts[item]
        raise KeyError(item)

    def sample(self, ischeme, degree=None):
        flat = []
        for p in self.parts.values():
            s = p.sample(ischeme, degree)
            flat.extend(s.samples if isinstance(s, _sample.ChainedSample) else [s])
        if len(flat) == 1:
            return flat[0]
        return _sample.ChainedSample(flat)


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
        return _StructuredInterfaces(self)

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

    def basis_lagrange(self, degree):
        '''Nodal (equispaced) Lagrange basis: the C0 dof layout of basis_std
        with interpolatory per-element polynomials (reference:
        topology.py:1801 basis_lagrange).'''
        from .ops import spline
        if not numpy.iterable(degree):
            degree = [degree] * self.ndims
        offsets, coeffs, ndofs = [], [], []
        for i in range(self.ndims):
            o, _c, n = spline.splinebasis_1d(self.shape[i], degree[i],
                                             periodic=i in self.periodic, continuity=0)
            c1 = element.lagrange_coeffs(element.LineReference(), degree[i])
            offsets.append(o)
            coeffs.append(numpy.broadcast_to(c1, (self.shape[i],) + c1.shape).copy())
            ndofs.append(n)
        return function.StructuredBasis(self.space, offsets, coeffs, ndofs, self.shape,
                                        topo=self, root_h=self.root_h)

    def basis_discont(self, degree):
        from .ops import spline
        # fully discontinuous: per-element Bernstein-like (power) basis from
        # a single-element clamped spline, numbered per element
        o1, c1, n1 = spline.splinebasis_1d(1, degree)
        E = len(self)
        L = (degree + 1) ** self.ndims
        # per-element tensor coefficients
        mi = numpy.zeros((1, self.ndims), dtype=int)
        from .ops.spline import tensor_tables
        _, coeffs1 = tensor_tables([o1] * self.ndims, [c1] * self.ndims, [n1] * self.ndims, mi)
        coeffs = numpy.broadcast_to(coeffs1[0], (E,) + coeffs1.shape[1:]).copy()
        dofs = numpy.arange(E * L).reshape(E, L)
        return function.PlainBasis(self.space, dofs, coeffs, E * L)

    def basis_legendre(self, degree):
        '''Modal (shifted) Legendre basis, fully discontinuous
        (reference: topology.py:2365 via function.LegendreBasis).'''
        p = degree
        coeffs1 = numpy.zeros((p + 1, p + 1))
        coeffs1[0, 0] = 1.0
        if p >= 1:
            coeffs1[1, :2] = [-1.0, 2.0]
        for k in range(1, p):
            # (k+1) P~_{k+1}(t) = (2k+1)(2t-1) P~_k(t) - k P~_{k-1}(t)
            shifted = numpy.zeros(p + 1)
            shifted[1:] += 2 * coeffs1[k, :-1]
            shifted -= coeffs1[k]
            coeffs1[k + 1] = ((2 * k + 1) * shifted - k * coeffs1[k - 1]) / (k + 1)
        E = len(self)
        if self.ndims == 1:
            coeffs = numpy.broadcast_to(coeffs1, (E, p + 1, p + 1)).copy()
            L = p + 1
        else:
            raise NotImplementedError('legendre basis is 1-D only (as in the reference)')
        dofs = numpy.arange(E * L).reshape(E, L)
        return function.PlainBasis(self.space, dofs, coeffs, E * L)

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

    # ---------------------------------------------------------- point location

    def locate(self, geom, coords, *, tol=None, eps=0, arguments=None, maxiter=None, maxdist=None, skip_missing=False, weights=None):
        '''Sample at the elements/local coordinates containing the given
        physical points (reference: topology.py:777; the affine fast path of
        topology.py:2406 ``StructuredTopology._locate``).

        The geometry is probed on a uniform sample to detect an affine map
        root->physical; curved geometries fall back to per-point Newton
        iteration on the affine initial guess.
        '''
        coords = numpy.asarray(coords, dtype=float)
        if coords.ndim == 1:
            coords = coords[:, None]
        xi = self._locate_rootcoords(geom, coords, tol=tol, eps=eps, arguments=arguments,
                                     maxiter=maxiter, skip_missing=skip_missing,
                                     maxdist=maxdist)
        valid = ~numpy.isnan(xi[:, 0])
        xi = xi[valid]
        if weights is not None:
            weights = numpy.asarray(weights)[valid]
        return self._point_sample(xi, weights)

    def _locate_rootcoords(self, geom, coords, *, tol=None, eps=0, arguments=None,
                           maxiter=None, skip_missing=False, maxdist=None):
        '''Element-unit root coordinates xi [N, d] of the physical points
        ``coords`` (NaN rows mark unlocated points under ``skip_missing``);
        shared by the structured and hierarchical ``locate``.'''
        d = self.ndims
        assert coords.shape[1] == d
        geom = function.asarray(geom)
        if geom.ndim == 0:  # scalar geometry: promote to a 1-vector
            geom = function.stack([geom], axis=0)
        # probe for affinity: geom ~ geom0 + scale * root
        probe = self.sample('uniform', 2)
        gvals = numpy.asarray(probe.eval(geom, arguments or {})).reshape(len(self), 2 ** d, d)
        roots = probe.coords  # [E, P, d]
        # least-squares affine fit per probe batch
        A = numpy.concatenate([roots.reshape(-1, d), numpy.ones((roots.size // d, 1))], axis=1)
        sol, res_, rank_, sv_ = numpy.linalg.lstsq(A, gvals.reshape(-1, d), rcond=None)
        lin = sol[:d]       # [d, d]: geom = root @ lin + off
        off = sol[d]
        fit_err = numpy.abs(A @ sol - gvals.reshape(-1, d)).max()
        if tol is None:
            tol = 1e-12
        xi = (coords - off) @ numpy.linalg.inv(lin) / self.root_h  # element units
        bad = numpy.zeros(len(coords), dtype=bool)
        if fit_err > max(tol, 1e-10):
            # curved geometry: per-point Newton on the affine initial guess,
            # re-evaluating geometry and root-gradient at the moving points
            # (reference: topology.py:777 generic _locate)
            xi = numpy.clip(xi, 0, numpy.array(self.shape, dtype=float))
            rootgrad = function.grad(geom, function._RootCoords(self.space, d))
            converged = False
            for _ in range(maxiter or 30):
                smp = self._point_sample(xi)
                vals, grads = smp.eval([geom, rootgrad], arguments or {})
                r = coords - numpy.asarray(vals)
                if numpy.abs(r).max() < max(tol, 1e-12):
                    converged = True
                    break
                delta = numpy.linalg.solve(numpy.asarray(grads), r[..., None])[..., 0]
                xi = xi + delta / self.root_h
                xi = numpy.clip(xi, -2 * eps - 1e-9, numpy.array(self.shape, dtype=float) + 2 * eps + 1e-9)
            resid = numpy.abs(r).max(axis=1)
            if not skip_missing and not converged:
                raise ValueError(f'failed to locate points (max residual {resid.max():.1e})')
            if skip_missing:
                bad |= resid >= (maxdist if maxdist is not None else max(tol, 1e-9) * 1e3)
        inside = (xi > -eps - 1e-10).all(1) & (xi < numpy.array(self.shape) + eps + 1e-10).all(1)
        if not (inside | bad).all():
            if not skip_missing:
                raise ValueError(f'failed to locate {int((~inside).sum())}/{len(coords)} points')
        bad |= ~inside
        xi = xi.copy()
        xi[bad] = numpy.nan
        return xi

    def _point_sample(self, xi, weights=None):
        '''One-point-per-row sample at element-unit root coordinates [N, d].'''
        d = self.ndims
        h = self.root_h
        ielem = numpy.minimum(numpy.maximum(numpy.floor(xi).astype(int), 0), numpy.array(self.shape) - 1)
        ielems = numpy.ravel_multi_index(ielem.T, self.shape)
        E = len(xi)
        origins = self._origins[ielems]
        sample_coords = xi[:, None, :] * h  # [E, 1, d] root coords
        p_linear = numpy.broadcast_to(numpy.eye(d) / h, (E, d, d))
        # located points are interior volume points: full-dimension tangents so
        # jacobians/normals of functions of this space stay well defined (the
        # reference's located samples integrate with user weights, topology.py:777)
        tangents = numpy.broadcast_to(numpy.eye(d) * h, (E, d, d))
        return _sample.Sample(self.space, sample_coords,
                              None if weights is None else numpy.asarray(weights)[:, None],
                              ielems, p_linear, -origins / h, tangents,
                              origin_topo=self)


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
        self._vgroups = {}

    def __getitem__(self, item):
        if isinstance(item, str) and item in self._vgroups:
            return self._vgroups[item]
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
        try:
            parts = dict(self.parent.boundary.parts)
        except (NotImplementedError, AttributeError):
            parts = {}
        if parts:
            return UnionTopology(self.space, self.ndims - 1, parts, aliases=self._bgroups)
        pbnd = getattr(self.parent, 'boundary', None)
        if pbnd is not None and hasattr(pbnd, '_edges'):
            # unstructured parent: named groups are edge subsets of the full
            # boundary; keep any unnamed remainder so whole-boundary integrals
            # and constraints still cover every exterior edge (reference:
            # groups are views, the boundary itself stays complete,
            # topology.py:734)
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

    def indicator(self, names):
        '''Function that is 1 on the named part(s), 0 elsewhere
        (reference: topology.py:760).'''
        targets = [self.parts[n] for n in names.split(',')]
        return function._Indicator(targets)


class _StructuredInterfaces(Topology):
    '''Interior inter-element faces of a structured topology with two-sided
    lowering: each face carries the parent maps of both neighboring elements
    (reference: topology.py:1740 interfaces with opposite transform chains);
    ``function.opposite``/jump/mean switch to the second side.  The interface
    normal points from the first (lower-index) into the second side.'''

    def __init__(self, parent):
        super().__init__(parent.space, parent.ndims - 1)
        self.parent = parent
        self.ref = element.hypercube(self.ndims)

    @functools.cached_property
    def _face_tables(self):
        '''Per dim: (left_parents [F], right_parents [F], lin [d,d-1], nrm [d]).'''
        p = self.parent
        d = p.ndims
        out = []
        for idim in range(d):
            n = p.shape[idim]
            other = [i for i in range(d) if i != idim]
            grids = numpy.meshgrid(*[numpy.arange(p.shape[i]) for i in other], indexing='ij')
            cross = numpy.stack([g.ravel() for g in grids], axis=1) if other else numpy.zeros((1, 0), dtype=int)
            nint = n if idim in p.periodic else n - 1
            ks = numpy.arange(nint)
            left = numpy.zeros((nint, len(cross), d), dtype=int)
            right = numpy.zeros((nint, len(cross), d), dtype=int)
            for c, i in enumerate(other):
                left[:, :, i] = cross[None, :, c]
                right[:, :, i] = cross[None, :, c]
            left[:, :, idim] = ks[:, None]
            right[:, :, idim] = (ks[:, None] + 1) % n
            lp = numpy.ravel_multi_index(left.reshape(-1, d).T, p.shape)
            rp = numpy.ravel_multi_index(right.reshape(-1, d).T, p.shape)
            lin = numpy.zeros((d, d - 1))
            for c, i in enumerate(other):
                lin[i, c] = 1.0
            nrm = numpy.zeros(d)
            nrm[idim] = 1.0
            out.append((lp, rp, lin, nrm, idim))
        return out

    def __len__(self):
        return sum(len(lp) for lp, *_ in self._face_tables)

    def sample(self, ischeme, degree=None):
        p = self.parent
        d = p.ndims
        if ischeme == 'gauss':
            assert degree is not None
            pts, wts = self.ref.gauss(degree)
        elif ischeme == 'bezier':
            pts, _tri, _hull = self.ref.bezier(degree)
            wts = None
        elif ischeme == 'uniform':
            pts, wts = self.ref.uniform(degree or 1)
        else:
            raise ValueError(f'unknown interface scheme {ischeme!r}')
        P = len(pts)
        sides = [[], []]
        for lp, rp, lin, nrm, idim in self._face_tables:
            E = len(lp)
            h = p.root_h
            for side, (parents, level) in enumerate(((lp, 1.0), (rp, 0.0))):
                xi_local = pts @ lin.T  # [P, d]
                xi_local = xi_local + level * numpy.eye(d)[idim]
                origins = p._origins[parents]
                coords = origins[:, None, :] + xi_local[None, :, :] * h
                sides[side].append(dict(
                    coords=coords,
                    weights=None if wts is None else numpy.broadcast_to(wts, (E, P)).copy(),
                    index=parents,
                    p_linear=numpy.broadcast_to(numpy.eye(d) / h, (E, d, d)),
                    p_offset=-origins / h,
                    tangents=numpy.broadcast_to(lin * h, (E, d, d - 1)),
                    normal_root=numpy.broadcast_to(nrm if side == 0 else -nrm, (E, d)),
                ))

        def build(parts, opposite):
            return _sample.Sample(
                p.space,
                numpy.concatenate([q['coords'] for q in parts]),
                None if wts is None else numpy.concatenate([q['weights'] for q in parts]),
                numpy.concatenate([q['index'] for q in parts]),
                numpy.concatenate([q['p_linear'] for q in parts]),
                numpy.concatenate([q['p_offset'] for q in parts]),
                numpy.concatenate([q['tangents'] for q in parts]),
                numpy.concatenate([q['normal_root'] for q in parts]),
                None, None, opposite, origin_topo=p)
        oppo = build(sides[1], None)
        return build(sides[0], oppo)
