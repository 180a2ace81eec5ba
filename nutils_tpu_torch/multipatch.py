'''Multipatch topologies: structured patches glued along matching faces.

A copy of ``nutils_tpu.multipatch``, the counterpart of the reference's
MultipatchTopology (reference:
topology.py:3078, mesh.py:96): each patch is a structured grid; the glue is
pure dof bookkeeping — per-patch spline dof grids are merged across shared
faces by vertex-key matching (util.merge_index_map semantics) — and samples
are per-patch table batches with globally offset element indices, so every
basis lowers through the standard per-element-table path.

>>> import numpy
>>> from nutils_tpu_torch import mesh, function
>>> topo, geom = mesh.multipatch(
...     patches=[[0, 1, 3, 4], [1, 2, 4, 5]],  # two unit squares side by side
...     patchverts=[[0, 0], [1, 0], [2, 0], [0, 1], [1, 1], [2, 1]], nelems=2)
>>> len(topo)
8
>>> float(topo.integrate(function.J(geom), degree=1))
2.0±1e-12
>>> topo.basis('spline', degree=1, patchcontinuous=True).ndofs  # glued seam
15
'''

import functools
import itertools

import numpy

from . import element, function, sample as _sample
from .topology import Topology, UnionTopology, StructuredTopology, _StructuredBoundary
from .unstructured import merge_index_map


def _offset_sample(s, offset, origin):
    '''Reindex a single-space sample into the global multipatch numbering.'''
    sp = s.specs[0]
    return _sample.Sample(sp.space, sp.coords, s.weights, sp.index + offset,
                          sp.p_linear, sp.p_offset, sp.tangents, sp.normal_root,
                          s.tri_local, s.hull_local,
                          opposite=None if s.opposite is None else _offset_sample(s.opposite, offset, origin),
                          batch_key=s.batch_key, origin_topo=origin)


class MultipatchTopology(Topology):

    def __init__(self, space, patches, patchverts, shapes):
        '''patches: [npatches, 2]*ndims int array of patch-vertex labels;
        shapes: per-patch element counts per dimension.'''
        patches = numpy.asarray(patches)
        ndims = patches.ndim - 1
        super().__init__(space, ndims)
        self.patches = patches
        self.shapes = [tuple(s) for s in shapes]
        self.topos = [StructuredTopology(space, s) for s in self.shapes]
        self.offsets = numpy.cumsum([0] + [len(t) for t in self.topos])
        # classify faces: shared between two patches or boundary
        sides = {}
        for ipatch, verts in enumerate(self.patches):
            for idim, iside, idx in self._iter_boundaries():
                bverts = verts[idx]
                sides.setdefault(frozenset(bverts.flat), []).append((bverts, ipatch, idim, iside))
        self._boundaries = []   # (ipatch, idim, iside)
        self._interfaces = []   # [(ipatch, idim, iside), ...] groups
        for patchdata in sides.values():
            if len(patchdata) == 1:
                _bv, ipatch, idim, iside = patchdata[0]
                self._boundaries.append((ipatch, idim, iside))
            else:
                bverts0 = patchdata[0][0]
                if not all((bv == bverts0).all() for bv, *_rest in patchdata[1:]):
                    raise NotImplementedError('patch interfaces must have the same order of axes and orientation')
                self._interfaces.append([(ip, idim, iside) for _bv, ip, idim, iside in patchdata])

    def _iter_boundaries(self):
        return ((idim, iside, (slice(None),) * idim + (iside,))
                for idim in range(self.ndims) for iside in (-1, 0))

    def __len__(self):
        return int(self.offsets[-1])

    def __repr__(self):
        return f'MultipatchTopology({len(self.topos)} patches)'

    def __getitem__(self, item):
        if isinstance(item, str) and item.startswith('patch'):
            return _PatchView(self, int(item[5:]))
        raise KeyError(item)

    # ------------------------------------------------------------ sampling

    def sample(self, ischeme, degree=None):
        parts = [_offset_sample(t.sample(ischeme, degree), off, self)
                 for t, off in zip(self.topos, self.offsets)]
        merged = _sample.Sample.concatenate(parts) if len(parts) > 1 else parts[0]
        return merged

    # ------------------------------------------------------------ boundary

    @functools.cached_property
    def boundary(self):
        parts = {}
        for ipatch, idim, iside in self._boundaries:
            bname = StructuredTopology._BNAMES[idim][1 if iside == -1 else 0]
            parts[f'patch{ipatch}-{bname}'] = _PatchBoundary(self, ipatch, idim, iside)
        return UnionTopology(self.space, self.ndims - 1, parts)

    @functools.cached_property
    def interfaces(self):
        '''All interior faces: per-patch structured interfaces plus the
        glued inter-patch faces, the latter also available as the named group
        ``interfaces['interpatch']`` (reference: topology.py:3098
        MultipatchTopology.interfaces).'''
        parts = {}
        for ipatch, topo in enumerate(self.topos):
            if any(n > 1 for n in topo.shape):
                parts[f'patch{ipatch}'] = _PatchInterfaces(self, ipatch)
        groups = [g for g in self._interfaces]
        if groups:
            parts['interpatch'] = UnionTopology(self.space, self.ndims - 1, {
                f'group{i}': _InterpatchInterface(self, g) for i, g in enumerate(groups)
            }) if len(groups) > 1 else _InterpatchInterface(self, groups[0])
        return UnionTopology(self.space, self.ndims - 1, parts)

    # ------------------------------------------------------------ locate

    def _elem_patch(self, ielems):
        '''Global element ids -> (patch ids, local element ids).'''
        ielems = numpy.asarray(ielems, dtype=int)
        p = numpy.searchsorted(self.offsets, ielems, side='right') - 1
        return p, ielems - self.offsets[p]

    def _patch_rows(self, ielems):
        '''Per-patch row groups (in patch order) of the given global ids.'''
        patch, _ = self._elem_patch(ielems)
        return [(p, numpy.nonzero(patch == p)[0]) for p in numpy.unique(patch)]

    def _point_sample(self, ielems, xi, weights=None):
        '''Sample of one point per row at element-local coordinates xi [N, d]
        of global elements ielems [N].'''
        ielems = numpy.asarray(ielems, dtype=int)
        xi = numpy.asarray(xi, dtype=float)
        patch, local = self._elem_patch(ielems)
        samples = []
        row_order = []
        for p, rows in self._patch_rows(ielems):
            topo = self.topos[p]
            multi = numpy.stack(numpy.unravel_index(local[rows], topo.shape), axis=1)
            s = topo._point_sample(multi + xi[rows],
                                   None if weights is None else numpy.asarray(weights)[rows])
            samples.append(_offset_sample(s, self.offsets[p], self))
            row_order.append(rows)
        if len(samples) == 1:
            return samples[0]
        # chained parts are patch-grouped; restore input row order for eval
        order = numpy.concatenate(row_order)   # parent row k holds input row order[k]
        perm = numpy.empty_like(order)
        perm[order] = numpy.arange(len(order))  # perm[i] = parent row of input row i
        return _sample.ReorderedSample(_sample.ChainedSample(samples), perm)

    def locate(self, geom, coords, *, tol=None, eps=0, arguments=None, maxiter=None,
               maxdist=None, skip_missing=False, weights=None):
        '''Newton point location over all patches (reference: topology.py:777
        generic Topology._locate; patches are curved so the structured affine
        fast path does not apply).'''
        from .unstructured import newton_locate
        return newton_locate(self, geom, coords, tol=tol, eps=eps, arguments=arguments,
                             maxiter=maxiter, maxdist=maxdist, skip_missing=skip_missing,
                             weights=weights)

    # newton_locate hooks: iteration coordinates are local coordinates of the
    # candidate element, but excursions across element borders stay valid
    # anywhere inside the candidate's patch (the geometry is patchwise smooth)

    def _locate_start(self, cand):
        return numpy.full((len(cand), self.ndims), 0.5)

    def _locate_eval(self, cand, xi, evaluate):
        # a ReorderedSample: already input-row order
        vals, grads = evaluate(self._point_sample(cand, xi))
        patch, _ = self._elem_patch(cand)
        h = numpy.array([self.topos[p].root_h for p in patch])
        return vals, grads * h[:, None, None]

    def _locate_clip(self, cand, xi):
        patch, local = self._elem_patch(cand)
        out = xi.copy()
        for p, rows in self._patch_rows(cand):
            shape = numpy.array(self.topos[p].shape, dtype=float)
            multi = numpy.stack(numpy.unravel_index(local[rows], self.topos[p].shape), axis=1)
            out[rows] = numpy.clip(multi + xi[rows], 0.0, shape) - multi
        return out

    def _locate_accept(self, cand, xi, eps):
        patch, local = self._elem_patch(cand)
        ok = numpy.zeros(len(cand), dtype=bool)
        elems = numpy.array(cand)
        xi_local = numpy.array(xi)
        for p, rows in self._patch_rows(cand):
            topo = self.topos[p]
            shape = numpy.array(topo.shape)
            multi = numpy.stack(numpy.unravel_index(local[rows], topo.shape), axis=1)
            grid = multi + xi[rows]
            inside = ((grid > -eps - 1e-10) & (grid < shape + eps + 1e-10)).all(axis=1)
            cell = numpy.minimum(numpy.maximum(numpy.floor(grid).astype(int), 0), shape - 1)
            elems[rows] = self.offsets[p] + numpy.ravel_multi_index(cell.T, topo.shape)
            xi_local[rows] = grid - cell
            ok[rows] = inside
        return ok, elems, xi_local

    # ------------------------------------------------------------ bases

    def _patch_knot_lookup(self, table, verts, idim):
        '''Resolve a per-edge {vertexpair: value} dict for a patch dimension.'''
        if table is None or not isinstance(table, dict):
            return table
        left = tuple(0 if j == idim else slice(None) for j in range(self.ndims))
        right = tuple(1 if j == idim else slice(None) for j in range(self.ndims))
        vals = set()
        for edge in zip(numpy.ravel(verts[left]), numpy.ravel(verts[right])):
            if edge in table:
                vals.add(tuple(table[edge]))
            elif edge[::-1] in table:
                v = table[edge[::-1]]
                vals.add(tuple(v[::-1]) if v is not None else None)
            else:
                vals.add(None if table.get(None) is None else tuple(table[None]))
        assert len(vals) == 1, f'ambiguous knot data for patch dimension {idim}'
        v = vals.pop()
        return None if v is None else list(v)

    def basis_spline(self, degree, patchcontinuous=True, knotvalues=None, knotmultiplicities=None, *, continuity=-1):
        '''Per-patch spline basis, optionally C0-merged at patch interfaces
        (reference: topology.py:3122 basis_spline).'''
        from .ops.spline import tensor_tables
        alldofs = []
        allcoeffs = []
        dofcount = 0
        commonboundarydofs = {}
        for ipatch, (topo, verts) in enumerate(zip(self.topos, self.patches)):
            kv = [self._patch_knot_lookup(knotvalues, verts, idim) for idim in range(self.ndims)]
            km = [self._patch_knot_lookup(knotmultiplicities, verts, idim) for idim in range(self.ndims)]
            offsets, coeffs1, ndofs = topo._spline_tables(degree, continuity=continuity,
                                                          knotvalues=kv, knotmultiplicities=km)
            multi = numpy.stack(numpy.unravel_index(numpy.arange(len(topo)), topo.shape), axis=1)
            pdofs, pcoeffs = tensor_tables(offsets, coeffs1, ndofs, multi)
            alldofs.append(pdofs + dofcount)
            allcoeffs.append(pcoeffs)
            if patchcontinuous:
                dofs = dofcount + numpy.arange(numpy.prod(ndofs), dtype=int).reshape(ndofs)
                for idim, iside, idx in self._iter_boundaries():
                    commonboundarydofs.setdefault(tuple(verts[idx].flat), []).append(dofs[idx].ravel())
            dofcount += int(numpy.prod(ndofs))
        dofs = numpy.concatenate(alldofs)
        coeffs = numpy.concatenate(allcoeffs)
        if patchcontinuous:
            pairs = itertools.chain(*(zip(*d) for d in commonboundarydofs.values() if len(d) > 1))
            renumber, dofcount = merge_index_map(dofcount, pairs)
            dofs = renumber[dofs]
        basis = function.PlainBasis(self.space, dofs, coeffs, dofcount)
        basis._origin = self
        return basis

    def basis_discont(self, degree):
        '''Fully discontinuous per-element basis: the generic structured
        construction applies verbatim since samples carry patch-offset global
        element indices (reference: topology.py:1801 basis via _tensorial).'''
        from .topology import StructuredTopology
        return StructuredTopology.basis_discont(self, degree)

    def basis_std(self, degree, patchcontinuous=True):
        return self.basis_spline(degree, patchcontinuous, continuity=0)

    def basis_patch(self, degree=None):
        '''Patchwise-constant basis (reference: topology.py:3224 basis_patch).'''
        E = len(self)
        d = self.ndims
        dofs = numpy.concatenate([numpy.full(len(t), i) for i, t in enumerate(self.topos)])[:, None]
        coeffs = numpy.zeros((E, 1) + (1,) * d)
        coeffs[:] = 1.0
        basis = function.PlainBasis(self.space, dofs, coeffs, len(self.topos))
        basis._origin = self
        return basis


class _PatchBoundary(Topology):
    '''One outer face of one patch, with global element indices.'''

    def __init__(self, mp, ipatch, idim, iside):
        super().__init__(mp.space, mp.ndims - 1)
        self.mp = mp
        self.ipatch = ipatch
        self.idim = idim
        self.side = 1 if iside == -1 else 0
        self._inner = _StructuredBoundary(mp.topos[ipatch], idim, self.side)

    def __len__(self):
        return len(self._inner)

    def __getitem__(self, item):
        out = _PatchBoundary(self.mp, self.ipatch, self.idim, -1 if self.side else 0)
        out._inner = self._inner[item]
        return out

    def sample(self, ischeme, degree=None):
        return _offset_sample(self._inner.sample(ischeme, degree),
                              self.mp.offsets[self.ipatch], self.mp)

    def basis(self, btype='std', degree=1, **kwargs):
        return self.mp.basis(btype, degree, **kwargs)


class _PatchView(Topology):
    '''One patch of a multipatch topology, with global element indices.'''

    def __init__(self, mp, ipatch):
        super().__init__(mp.space, mp.ndims)
        self.mp = mp
        self.ipatch = ipatch

    def __len__(self):
        return len(self.mp.topos[self.ipatch])

    def sample(self, ischeme, degree=None):
        return _offset_sample(self.mp.topos[self.ipatch].sample(ischeme, degree),
                              self.mp.offsets[self.ipatch], self.mp)

    @property
    def boundary(self):
        parts = {}
        for idim in range(self.ndims):
            for iside in (-1, 0):
                bname = StructuredTopology._BNAMES[idim][1 if iside == -1 else 0]
                parts[bname] = _PatchBoundary(self.mp, self.ipatch, idim, iside)
        return UnionTopology(self.space, self.ndims - 1, parts)

    def basis(self, btype='std', degree=1, **kwargs):
        return self.mp.basis(btype, degree, **kwargs)


def multipatch(patches, nelems, patchverts=None, space='X'):
    '''Multipatch rectilinear mesh generator (reference: mesh.py:96): build a
    MultipatchTopology from patch-vertex labels and a per-edge or global
    element count, with a patchwise multilinear geometry.'''
    patches = numpy.array(patches)
    assert patches.dtype.kind == 'i'
    if patches.ndim == 2:
        ndims = 0
        while 2 ** ndims < patches.shape[1]:
            ndims += 1
        assert 2 ** ndims == patches.shape[1], 'hyperrectangular patches only'
        patches = patches.reshape((patches.shape[0],) + (2,) * ndims)
    ndims = patches.ndim - 1

    if isinstance(nelems, int):
        nelems = {None: nelems}
    else:
        nelems = {(k if k is None else frozenset(k)): v for k, v in nelems.items()}

    shapes = []
    coords = []
    for i, patch in enumerate(patches):
        shape = []
        for dim in range(ndims):
            counts = set()
            sides = [(0, 1)] * ndims
            sides[dim] = (slice(None),)
            for side in itertools.product(*sides):
                key = frozenset(patch[side])
                counts.add(nelems.get(key, nelems[None]))
            assert len(counts) == 1, f'ambiguous element count for patch {i} dimension {dim}'
            shape.append(counts.pop())
        shapes.append(shape)
        # patchwise multilinear geometry control values at the element grid
        grids = numpy.meshgrid(*[numpy.linspace(0, 1, n + 1) for n in shape], indexing='ij')
        pc = numpy.stack([g.ravel() for g in grids], axis=0)  # [ndims, nverts]
        if patchverts is not None:
            pv = numpy.asarray(patchverts, dtype=float)
            acc = 0
            for j, corner in zip(patch.flat, itertools.product(*[[0, 1]] * ndims)):
                w = numpy.ones(pc.shape[1])
                for c, s in zip(pc, corner):
                    w = w * (c if s else 1 - c)
                acc = acc + pv[j][:, None] * w
            pc = acc
        coords.append(pc)

    topo = MultipatchTopology(space, patches, patchverts, shapes)
    funcsp = topo.basis_spline(degree=1, patchcontinuous=False)
    geom = funcsp @ numpy.concatenate(coords, axis=1).T
    return topo, geom


class _PatchInterfaces(Topology):
    '''Interior (intra-patch) interfaces of one patch, globally indexed.'''

    def __init__(self, mp, ipatch):
        super().__init__(mp.space, mp.ndims - 1)
        from .topology import _StructuredInterfaces
        self.mp = mp
        self.ipatch = ipatch
        self._inner = _StructuredInterfaces(mp.topos[ipatch])

    def __len__(self):
        return len(self._inner)

    def sample(self, ischeme, degree=None):
        return _offset_sample(self._inner.sample(ischeme, degree),
                              self.mp.offsets[self.ipatch], self.mp)

    def basis(self, btype='std', degree=1, **kwargs):
        return self.mp.basis(btype, degree, **kwargs)


class _InterpatchInterface(Topology):
    '''Faces glued between two patches, with two-sided samples: the main side
    is the first patch in the group (normal outward from it), the opposite
    sample evaluates on the second patch (reference: topology.py:3098
    MultipatchTopology.interfaces 'interpatch' group).  Point pairing relies
    on the construction-time assertion that glued faces share vertex order
    and orientation, so both patches' structured boundary samples enumerate
    the same physical points in the same order.'''

    def __init__(self, mp, group):
        super().__init__(mp.space, mp.ndims - 1)
        self.mp = mp
        assert len(group) >= 2
        self.group = list(group)

    def __len__(self):
        ip, idim, iside = self.group[0]
        return len(_PatchBoundary(self.mp, ip, idim, iside))

    def sample(self, ischeme, degree=None):
        sides = [_PatchBoundary(self.mp, ip, idim, iside).sample(ischeme, degree)
                 for ip, idim, iside in self.group[:2]]
        main, opp = sides
        assert main.nelems == opp.nelems and main.npoints_per_elem == opp.npoints_per_elem, \
            'glued patch faces must have matching element counts'
        sp = main.specs[0]
        osp = opp.specs[0]
        opp2 = _sample.Sample(osp.space, osp.coords, None, osp.index, osp.p_linear,
                              osp.p_offset, osp.tangents, osp.normal_root,
                              batch_key=opp.batch_key, origin_topo=self.mp)
        return _sample.Sample(sp.space, sp.coords, main.weights, sp.index, sp.p_linear,
                              sp.p_offset, sp.tangents, sp.normal_root,
                              main.tri_local, main.hull_local, opposite=opp2,
                              part_ids=numpy.zeros(main.nelems, dtype=int), part_topos=[self],
                              batch_key=main.batch_key, origin_topo=self.mp)

    def basis(self, btype='std', degree=1, **kwargs):
        return self.mp.basis(btype, degree, **kwargs)
