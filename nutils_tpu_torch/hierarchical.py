'''Hierarchically refined topologies and (truncated) hierarchical bases.

A copy of ``nutils_tpu.hierarchical``, the counterpart of the reference's
SubsetTopology/HierarchicalTopology
(reference: topology.py:2615,2785): a refinement *family* tracks uniformly
refined levels of a base topology with pure index arithmetic (parent maps,
child affine maps, frame affine maps) instead of transform chains; a
hierarchical topology is a per-level set of active element indices, its
samples are level-major concatenations of per-level table batches carrying a
*lineage* (family, level, element) so any basis of the family resolves
elements by an ancestor walk, and the h-/th- bases are built host-side into
ragged per-element polynomial tables (reference: topology.py:2927
_tensorial_bases) evaluated as one batched monomial contraction.

>>> import numpy
>>> from nutils_tpu_torch import mesh, function
>>> topo, geom = mesh.rectilinear([2, 2])
>>> ref = topo.refined_by([0])   # replace element 0 by its four children
>>> len(ref)
7
>>> float(ref.integrate(function.J(geom), degree=1))  # volume is preserved
4.0±1e-12
>>> basis = ref.basis('th-std', degree=1)  # truncated hierarchical basis
>>> smp = ref.sample('gauss', 2)
>>> vals = numpy.asarray(smp.eval(function.sum_(basis, 0), {}))
>>> bool(abs(vals - 1).max() < 1e-12)     # THB is a partition of unity
True
>>> len(ref.interfaces)   # 4 fine-fine + 4 fine-coarse + 2 coarse-coarse
10
'''

import functools
import itertools

import numpy

from . import element, function, sample as _sample
from .topology import Topology, UnionTopology, StructuredTopology, _WithGroupsTopology
from .unstructured import UnstructuredTopology, UnstructuredBoundary
from .utils import _log as log


def _plain(topo):
    while isinstance(topo, _WithGroupsTopology):
        topo = topo.parent
    return topo


def family_of(topo):
    plain = _plain(topo)
    hier = getattr(plain, '_hier', None)
    if hier is not None:
        return hier[0]
    return _Family(plain)


class _Family:
    '''Uniform refinement levels of a base topology, linked by index maps.

    The *frame* is the coordinate system shared by all levels of a family: the
    root coordinates for structured topologies (stable under refinement), the
    base element's local coordinates for unstructured ones.  Per level the
    family provides the affine maps frame -> element-local (``to_local``) and
    element-local -> frame (``frame_affine``), the parent/child index maps,
    and the child affine maps in the parent's local frame (the analogue of
    the reference's transform-chain tails, transform.py:309).
    '''

    def __init__(self, base):
        assert isinstance(base, (StructuredTopology, UnstructuredTopology)), type(base)
        self.base = base
        self.structured = isinstance(base, StructuredTopology)
        self.ndims = base.ndims
        self.levels = [base]
        base._hier = (self, 0)
        if not self.structured:
            d = base.ndims
            E = len(base)
            self._parents = [None]
            self._slots = [None]
            self._frame_lin = [numpy.broadcast_to(numpy.eye(d), (E, d, d)).copy()]
            self._frame_off = [numpy.zeros((E, d))]
            self._local_cache = {}

    def level_of(self, topo):
        for l, lev in enumerate(self.levels):
            if lev is topo:
                return l
        return None

    def ensure(self, nlevels):
        while len(self.levels) < nlevels:
            self._add_level()

    # ------------------------------------------------------------ growth

    def _add_level(self):
        l = len(self.levels)
        if self.structured:
            base = self.base
            topo = StructuredTopology(base.space, tuple(n << l for n in base.shape),
                                      base.periodic, root_h=base.root_h / 2 ** l)
            topo._hier = (self, l)
            self.levels.append(topo)
            return
        prev = self.levels[-1]
        d = self.ndims
        refs, elem_verts, parents, slots = [], [], [], []
        flin, foff = [], []
        vmap = {}

        def vid(key):
            if key not in vmap:
                vmap[key] = len(vmap)
            return vmap[key]

        for ielem, (ref, verts) in enumerate(zip(prev._refs, prev._elem_verts)):
            ch = element.children(ref)
            vkeys = element.child_vert_keys(ref)
            for slot, ((clin, coff), keys) in enumerate(zip(ch, vkeys)):
                gkeys = []
                for k in keys:
                    if k[0] == 'v':
                        gkeys.append(('v', int(verts[k[1]])))
                    elif k[0] == 'e':
                        a, b = int(verts[k[1]]), int(verts[k[2]])
                        gkeys.append(('e', min(a, b), max(a, b)))
                    else:
                        gkeys.append(('c', ielem))
                refs.append(ref)
                elem_verts.append(numpy.array([vid(k) for k in gkeys]))
                parents.append(ielem)
                slots.append(slot)
                flin.append(self._frame_lin[-1][ielem] @ clin)
                foff.append(self._frame_lin[-1][ielem] @ coff + self._frame_off[-1][ielem])
        topo = UnstructuredTopology(prev.space, refs, elem_verts, len(vmap))
        topo._hier = (self, l)
        self.levels.append(topo)
        self._parents.append(numpy.asarray(parents))
        self._slots.append(numpy.asarray(slots))
        self._frame_lin.append(numpy.asarray(flin))
        self._frame_off.append(numpy.asarray(foff))

    # ------------------------------------------------------------ index maps

    def nelems(self, l):
        self.ensure(l + 1)
        return len(self.levels[l])

    def shape(self, l):
        return tuple(n << l for n in self.base.shape)

    def nchildren(self, l, elems):
        if self.structured:
            return numpy.full(len(elems), 2 ** self.ndims, dtype=int)
        self.ensure(l + 1)
        return numpy.asarray([len(element.children(self.levels[l]._refs[e])) for e in elems])

    def parent_of(self, l, elems):
        '''Level l element ids -> level l-1 parent ids.'''
        elems = numpy.asarray(elems, dtype=int)
        assert l >= 1
        if self.structured:
            multi = numpy.stack(numpy.unravel_index(elems, self.shape(l)), axis=1)
            return numpy.ravel_multi_index((multi // 2).T, self.shape(l - 1))
        self.ensure(l + 1)
        return self._parents[l][elems]

    def children_of(self, l, elems):
        '''All level l+1 children of the given level l elements, sorted.'''
        elems = numpy.asarray(elems, dtype=int)
        self.ensure(l + 2)
        if self.structured:
            multi = numpy.stack(numpy.unravel_index(elems, self.shape(l)), axis=1)  # [E,d]
            offs = numpy.array(list(itertools.product([0, 1], repeat=self.ndims)))  # [C,d]
            cm = multi[:, None, :] * 2 + offs[None, :, :]
            out = numpy.ravel_multi_index(cm.reshape(-1, self.ndims).T, self.shape(l + 1))
        else:
            par = self._parents[l + 1]
            out = numpy.nonzero(numpy.isin(par, elems))[0]
        return numpy.unique(out)

    def base_ancestor(self, l, elems):
        elems = numpy.asarray(elems, dtype=int)
        if self.structured:
            multi = numpy.stack(numpy.unravel_index(elems, self.shape(l)), axis=1)
            return numpy.ravel_multi_index((multi >> l).T, self.base.shape)
        for lev in range(l, 0, -1):
            elems = self._parents[lev][elems]
        return elems

    def ancestors_at(self, levels, elems, L):
        '''Per-row ancestors of (levels[i], elems[i]) at fixed level L.'''
        levels = numpy.broadcast_to(numpy.asarray(levels, dtype=int), numpy.shape(elems))
        elems = numpy.asarray(elems, dtype=int).copy()
        for lev in range(int(levels.max()), L, -1):
            rows = levels >= lev
            if rows.any():
                elems[rows] = self.parent_of(lev, elems[rows])
        assert (levels >= L).all(), 'sample is coarser than the requested basis level'
        return elems

    # ------------------------------------------------------------ affine maps

    def _level_to_local(self, l, elems):
        elems = numpy.asarray(elems, dtype=int)
        d = self.ndims
        if self.structured:
            h = self.base.root_h / 2 ** l
            multi = numpy.stack(numpy.unravel_index(elems, self.shape(l)), axis=1)
            lin = numpy.broadcast_to(numpy.eye(d) / h, (len(elems), d, d))
            return lin, -multi.astype(float)
        self.ensure(l + 1)
        lin = numpy.linalg.inv(self._frame_lin[l][elems])
        off = -numpy.einsum('eij,ej->ei', lin, self._frame_off[l][elems])
        return lin, off

    def to_local(self, levels, elems):
        '''Affine maps frame coordinates -> element-local coordinates,
        [E, d, d] and [E, d]; levels may be scalar or per-row.'''
        levels = numpy.broadcast_to(numpy.asarray(levels, dtype=int), numpy.shape(elems))
        d = self.ndims
        lin = numpy.empty((len(elems), d, d))
        off = numpy.empty((len(elems), d))
        for lev in numpy.unique(levels):
            rows = levels == lev
            lin[rows], off[rows] = self._level_to_local(int(lev), numpy.asarray(elems)[rows])
        return lin, off

    def _level_frame(self, l, elems):
        elems = numpy.asarray(elems, dtype=int)
        d = self.ndims
        if self.structured:
            h = self.base.root_h / 2 ** l
            multi = numpy.stack(numpy.unravel_index(elems, self.shape(l)), axis=1)
            lin = numpy.broadcast_to(numpy.eye(d) * h, (len(elems), d, d))
            return lin, multi * h
        self.ensure(l + 1)
        return self._frame_lin[l][elems], self._frame_off[l][elems]

    def frame_affine(self, levels, elems):
        '''Affine maps element-local -> frame coordinates.'''
        levels = numpy.broadcast_to(numpy.asarray(levels, dtype=int), numpy.shape(elems))
        d = self.ndims
        lin = numpy.empty((len(elems), d, d))
        off = numpy.empty((len(elems), d))
        for lev in numpy.unique(levels):
            rows = levels == lev
            lin[rows], off[rows] = self._level_frame(int(lev), numpy.asarray(elems)[rows])
        return lin, off

    def child_affine(self, l, elems):
        '''Per-element affine map child-local -> parent-local for level l
        elements (l >= 1): the transform-chain tails of the reference.'''
        elems = numpy.asarray(elems, dtype=int)
        d = self.ndims
        if self.structured:
            multi = numpy.stack(numpy.unravel_index(elems, self.shape(l)), axis=1)
            lin = numpy.broadcast_to(numpy.eye(d) * 0.5, (len(elems), d, d))
            return lin, (multi % 2) * 0.5
        self.ensure(l + 1)
        lin = numpy.empty((len(elems), d, d))
        off = numpy.empty((len(elems), d))
        for i, e in enumerate(elems):
            ref = self.levels[l]._refs[e]
            clin, coff = element.children(ref)[self._slots[l][e]]
            lin[i], off[i] = clin, coff
        return lin, off

    def ref_of(self, l, e):
        if self.structured:
            return self.levels[l].ref
        self.ensure(l + 1)
        return self.levels[l]._refs[e]


class _ElemRef:
    '''Handle to a set of elements of a hierarchical topology (the analogue
    of indexing reference ``topo.transforms``, transformseq.py).'''

    def __init__(self, topo, indices):
        self.topo = topo
        self.indices = numpy.asarray(indices, dtype=int)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, item):
        return _ElemRef(self.topo, self.indices[item])


class HierarchicalTopology(Topology):
    '''Per-level active element sets over a refinement family (reference:
    topology.py:2785 HierarchicalTopology; a single-level instance plays the
    role of the reference's whole-element SubsetTopology, topology.py:2615).
    '''

    def __init__(self, basetopo, indices_per_level, newboundary=None):
        if isinstance(basetopo, HierarchicalTopology):
            basetopo = basetopo.basetopo
        self.basetopo = basetopo
        self.family = family_of(basetopo)
        self.newboundary = newboundary
        ipl = [numpy.unique(numpy.asarray(i, dtype=int)) for i in indices_per_level]
        while len(ipl) > 1 and not len(ipl[-1]):
            ipl.pop()
        self._ipl = ipl
        self.family.ensure(len(ipl))
        super().__init__(self.family.base.space, self.family.base.ndims)
        self._offsets = numpy.cumsum([0] + [len(i) for i in ipl])
        self._base_kept = numpy.unique(numpy.concatenate(
            [self.family.base_ancestor(l, idx) for l, idx in enumerate(ipl) if len(idx)]
            or [numpy.empty(0, dtype=int)]))  # empty subsets (e.g. disjoint intersections) are valid

    def __len__(self):
        return int(self._offsets[-1])

    def __repr__(self):
        return f'HierarchicalTopology({"+".join(str(len(i)) for i in self._ipl)})'

    @property
    def nlevels(self):
        return len(self._ipl)

    # ------------------------------------------------------------ indexing

    @property
    def transforms(self):
        return _ElemRef(self, numpy.arange(len(self)))

    def _row_level_elem(self, rows):
        '''Hierarchical element index -> (level, full-level element id).'''
        rows = numpy.asarray(rows, dtype=int)
        levels = numpy.searchsorted(self._offsets, rows, side='right') - 1
        elems = numpy.empty_like(rows)
        for l in numpy.unique(levels):
            sel = levels == l
            elems[sel] = self._ipl[l][rows[sel] - self._offsets[l]]
        return levels, elems

    def _hier_index(self, levels, elems, strict=True):
        '''Map (level, full-level element) rows to the hierarchical index of
        the *active* element containing them (ancestor walk; the analogue of
        the reference's transforms.index_with_tail, transformseq.py:15).
        Non-strict mode marks unresolvable rows (no active ancestor-or-self,
        e.g. the region is refined deeper) with -1 instead of raising.'''
        levels = numpy.broadcast_to(numpy.asarray(levels, dtype=int), numpy.shape(elems)).copy()
        elems = numpy.asarray(elems, dtype=int).copy()
        out = numpy.full(len(elems), -1, dtype=int)
        todo = numpy.ones(len(elems), dtype=bool)
        while todo.any():
            for l in numpy.unique(levels[todo]):
                sel = todo & (levels == l)
                if l < len(self._ipl) and len(self._ipl[l]):
                    pos = numpy.searchsorted(self._ipl[l], elems[sel])
                    pos = numpy.minimum(pos, len(self._ipl[l]) - 1)
                    found = self._ipl[l][pos] == elems[sel]
                    rows = numpy.nonzero(sel)[0][found]
                    out[rows] = self._offsets[l] + pos[found]
                    todo[rows] = False
            if not todo.any():
                break
            if (levels[todo] <= 0).any():
                if not strict:
                    todo &= levels > 0  # unresolvable: stay -1
                    if not todo.any():
                        break
                else:
                    raise ValueError('element is not part of this hierarchical topology')
            for l in numpy.unique(levels[todo]):
                sel = todo & (levels == l)
                elems[sel] = self.family.parent_of(int(l), elems[sel])
            levels[todo] -= 1
        return out

    # ------------------------------------------------------------ sampling

    def sample(self, ischeme, degree=None):
        parts = []
        for l, idx in enumerate(self._ipl):
            if len(idx):
                parts.extend(self._level_sample(l, idx, ischeme, degree))
        groups = {}
        for s in parts:
            groups.setdefault((s.batch_key, s.npoints_per_elem, s.ndims), []).append(s)
        merged = [_sample.Sample.concatenate(g) if len(g) > 1 else g[0] for g in groups.values()]
        if len(merged) == 1:
            return merged[0]
        return _sample.ChainedSample(merged)

    def _level_sample(self, l, idx, ischeme, degree):
        fam = self.family
        d = self.ndims
        out = []
        if fam.structured:
            buckets = [(fam.levels[l].ref, idx)]
        else:
            buckets = [(ref, ids[numpy.isin(ids, idx)]) for ref, ids in fam.levels[l]._buckets]
        for ref, sel in buckets:
            if not len(sel):
                continue
            tri_local = hull_local = None
            if ischeme == 'gauss':
                pts, wts = ref.gauss(degree)
            elif ischeme == 'bezier':
                pts, tri_local, hull_local = ref.bezier(degree)
                wts = None
            elif ischeme in ('vertex', '_centroid'):
                pts = ref.vertices if ischeme == 'vertex' else ref.vertices.mean(0, keepdims=True)
                wts = None
            elif ischeme == 'uniform':
                pts, wts = ref.uniform(degree or 1)
            else:
                raise ValueError(f'unknown sample scheme {ischeme!r}')
            E, P = len(sel), len(pts)
            flin, foff = fam._level_frame(l, sel)
            coords = numpy.einsum('eij,pj->epi', flin, pts) + foff[:, None, :]
            p_lin, p_off = fam._level_to_local(l, sel)
            weights = None if wts is None else numpy.broadcast_to(wts, (E, P)).copy()
            out.append(_sample.Sample(
                self.space, coords, weights, sel, p_lin, p_off, flin,
                None, tri_local, hull_local,
                part_ids=numpy.zeros(E, dtype=int), part_topos=[self],
                batch_key=type(ref).__name__, origin_topo=fam.levels[l],
                lineage=(fam, numpy.full(E, l), sel)))
        return out

    # ------------------------------------------------------------ refinement

    @property
    def refined(self):
        fam = self.family
        new = [numpy.empty(0, dtype=int)]
        for l, idx in enumerate(self._ipl):
            new.append(fam.children_of(l, idx) if len(idx) else numpy.empty(0, dtype=int))
        return HierarchicalTopology(self.basetopo, new, self.newboundary)

    def subset(self, selection, newboundary=None, strict=False):
        '''Subset of the ACTIVE (hierarchical-row) elements: rows map back to
        their (level, element) pairs, yielding a hierarchical topology over
        the same family (the base implementation would misread row indices
        as level-0 element ids).'''
        from . import topology as _topology
        if isinstance(selection, _topology._Selection):
            rows = selection.ielems
        elif isinstance(selection, _topology.Topology):
            t = getattr(selection, 'transforms', None)
            if isinstance(t, _ElemRef) and t.topo is self:
                rows = t.indices
            else:
                raise ValueError('subset selection topology is not a subset view of this topology')
        else:
            rows = numpy.asarray(selection, dtype=int)
        levels, elems = self._row_level_elem(numpy.unique(rows))
        ipl = [elems[levels == l] for l in range(self.nlevels)]
        return HierarchicalTopology(self.basetopo, ipl,
                                    newboundary=newboundary if newboundary is not None else self.newboundary)

    def refined_by(self, refine):
        from . import topology as _topology
        if isinstance(refine, _topology.Topology):
            # a subtopology selects its elements (reference: topology.py:531
            # refined_by accepting a Topology)
            t = getattr(refine, 'transforms', None)
            def _strip(t):
                while isinstance(t, _topology._WithGroupsTopology):
                    t = t.parent
                return t
            if isinstance(t, _ElemRef):
                refine = t
            elif _strip(refine) is _strip(self.basetopo) or refine is self:
                # whole-topology selection (e.g. select() matched every
                # element and returned the base itself): refine everything
                refine = _ElemRef(self, numpy.arange(len(self)))
            else:
                sub = refine._whole_subset()
                if sub is None or _strip(sub[0]) is not _strip(self.basetopo):
                    raise ValueError('refine topology is not a subset view of this topology')
                refine = _ElemRef(HierarchicalTopology(self.basetopo, [numpy.arange(len(sub[0]))]), sub[1])
        if isinstance(refine, _ElemRef):
            levels, elems = refine.topo._row_level_elem(refine.indices)
            rows = self._hier_index(levels, elems)
        else:
            rows = numpy.asarray(list(refine), dtype=int)
        rows = numpy.unique(rows)
        levels, elems = self._row_level_elem(rows)
        new = [idx.copy() for idx in self._ipl] + [numpy.empty(0, dtype=int)]
        for l in numpy.unique(levels):
            sel = elems[levels == l]
            new[l] = numpy.setdiff1d(new[l], sel)
            new[l + 1] = numpy.union1d(new[l + 1], self.family.children_of(int(l), sel))
        return HierarchicalTopology(self.basetopo, new, self.newboundary)

    # ------------------------------------------------------------ boundary

    def _kept_level(self, l):
        '''All level-l descendants of the kept base elements.'''
        fam = self.family
        all_l = numpy.arange(fam.nelems(l))
        return all_l[numpy.isin(fam.base_ancestor(l, all_l), self._base_kept)]

    @functools.cached_property
    def _base_group_lookup(self):
        '''(base ielem, iedge) -> boundary group name, for unstructured
        bases wrapped by withboundary.'''
        lookup = {}
        topo = self.basetopo
        if isinstance(topo, _WithGroupsTopology):
            for name, part in topo._bgroups.items():
                if isinstance(part, UnstructuredBoundary):
                    for ie, ik in part._edges:
                        lookup[ie, ik] = name
        return lookup

    @functools.cached_property
    def boundary(self):
        fam = self.family
        named = {}  # name -> list of (level, elem, edge)
        if fam.structured:
            periodic = fam.base.periodic
            # ref edge index by (idim, side)
            edgeidx = {}
            for k, (_l, _o, nrm, _r) in enumerate(fam.levels[0].ref.edges):
                idim = int(numpy.argmax(numpy.abs(nrm)))
                edgeidx[idim, int(nrm[idim] > 0)] = k
            kept0 = numpy.zeros(len(fam.base), dtype=bool)
            kept0[self._base_kept] = True
            for l, idx in enumerate(self._ipl):
                if not len(idx):
                    continue
                shape_l = fam.shape(l)
                multi = numpy.stack(numpy.unravel_index(idx, shape_l), axis=1)
                for idim in range(self.ndims):
                    for side in (0, 1):
                        nb = multi.copy()
                        nb[:, idim] += 1 if side else -1
                        if idim in periodic:
                            nb[:, idim] %= shape_l[idim]
                            outer = numpy.zeros(len(idx), dtype=bool)
                        else:
                            outer = (nb[:, idim] < 0) | (nb[:, idim] >= shape_l[idim])
                        inner = ~outer
                        dropped = numpy.zeros(len(idx), dtype=bool)
                        if inner.any():
                            banc = numpy.ravel_multi_index((nb[inner] >> l).T, fam.base.shape)
                            dropped[inner] = ~kept0[banc]
                        k = edgeidx[idim, side]
                        if outer.any():
                            name = StructuredTopology._BNAMES[idim][side]
                            named.setdefault(name, []).extend((l, e, k) for e in idx[outer])
                        if dropped.any():
                            name = self.newboundary or '_trimmed'
                            named.setdefault(name, []).extend((l, e, k) for e in idx[dropped])
        else:
            kept0 = numpy.zeros(len(fam.base), dtype=bool)
            kept0[self._base_kept] = True
            lookup = self._base_group_lookup
            for l, idx in enumerate(self._ipl):
                if not len(idx):
                    continue
                conn = fam.levels[l].connectivity
                for e in idx:
                    for k, nb in enumerate(conn[e]):
                        if nb == -1:
                            # outer: resolve the base edge for its group name
                            le, lk = int(e), int(k)
                            for lev in range(l, 0, -1):
                                slot = fam._slots[lev][le]
                                ref = fam.levels[lev]._refs[le]
                                pk = element.child_edge_map(ref)[slot][lk]
                                assert pk != -1, 'outer edge does not lie on a parent edge'
                                le = fam._parents[lev][le]
                                lk = pk
                            name = lookup.get((le, lk), '_boundary')
                            named.setdefault(name, []).append((l, int(e), int(k)))
                        elif not kept0[fam.base_ancestor(l, numpy.array([nb]))[0]]:
                            name = self.newboundary or '_trimmed'
                            named.setdefault(name, []).append((l, int(e), int(k)))
        parts = {name: _HierBoundaryPart(self, items) for name, items in named.items()}
        return UnionTopology(self.space, self.ndims - 1, parts)

    # ------------------------------------------------------------ interfaces

    @functools.cached_property
    def interfaces(self):
        '''Interior faces between active elements, including cross-level
        facets (a fine element's full face against a coarser neighbor) with
        two-sided lowering (reference: HierarchicalTopology boundary/
        interfaces via topology.py:2785-2925).'''
        return _HierInterfaces(self)

    # ------------------------------------------------------------ bases

    def basis(self, btype='std', degree=1, **kwargs):
        if btype.startswith('h-'):
            return self._hbasis(btype[2:], degree, truncated=False, kwargs=kwargs)
        if btype.startswith('th-'):
            return self._hbasis(btype[3:], degree, truncated=True, kwargs=kwargs)
        if btype == 'discont':
            # per-element blocks need no inter-level gluing (reference:
            # topology.py:365 generic dispatch handles hierarchical discont)
            return self.basis_discont(degree)
        if self.nlevels == 1:
            parent = _plain(self.basetopo).basis(btype, degree, **kwargs)
            if len(self._ipl[0]) == len(self.family.base):
                return parent
            # whole-element subset: the parent basis restricted to the dofs
            # supported on the kept elements (reference: SubsetTopology.basis
            # returning a PrunedBasis, topology.py:2615/function.py:3103)
            return function.PrunedBasis(parent, self._ipl[0])
        raise ValueError(f'basis type {btype!r} requires an h- or th- prefix on hierarchical topologies')

    def _level_basis(self, inner, degree, kwargs, l):
        topo = self.family.levels[l]
        if self.family.structured:
            return topo.basis(inner, degree, **kwargs)
        if l == 0:
            return topo.basis(inner, degree, **kwargs)
        if inner != 'std':
            raise ValueError(f'basis type {inner!r} is not supported on refined unstructured levels')
        return topo.basis_bernstein(degree)

    def _hbasis(self, inner, degree, truncated, kwargs, truncation_tolerance=1e-15):
        '''Construct the (truncated) hierarchical basis (reference:
        topology.py:2927 _tensorial_bases): per level, a dof is *active* when
        it touches an active element and its support (restricted to the kept
        subset) consists of elements that are active or refined further;
        per hierarchical element the active functions of all coarser levels
        are collected with coefficients pushed through the child maps.'''
        fam = self.family
        L = self.nlevels
        bases = [self._level_basis(inner, degree, kwargs, l) for l in range(L)]

        def elem_tables(basis, ielem):
            if isinstance(basis, function.PlainBasis) and basis._ragged:
                return basis._dofs[ielem], basis._elemcoeffs[ielem]
            dd, cc = basis.get_tables(numpy.asarray([ielem]))
            return dd[0], cc[0]

        def dofs_union(basis, elems):
            if not len(elems):
                return numpy.empty(0, dtype=int)
            if isinstance(basis, function.PlainBasis) and basis._ragged:
                return numpy.unique(numpy.concatenate([basis._dofs[i] for i in elems]))
            dd, _cc = basis.get_tables(numpy.asarray(elems))
            return numpy.unique(dd)

        # relevant element sets per level: active or ancestor of finer active
        ielems = [None] * L
        cur = numpy.empty(0, dtype=int)
        for l in reversed(range(L)):
            ielems[l] = numpy.union1d(self._ipl[l], cur)
            if l:
                cur = numpy.unique(fam.parent_of(l, ielems[l])) if len(ielems[l]) else cur
        active, passive = [], []
        for l in range(L):
            bad = numpy.setdiff1d(self._kept_level(l), ielems[l], assume_unique=True)
            dofs_bad = dofs_union(bases[l], bad)
            touch = dofs_union(bases[l], self._ipl[l])
            active.append(numpy.setdiff1d(touch, dofs_bad))
            passive.append(numpy.intersect1d(dofs_union(bases[l], ielems[l]), dofs_bad))
        offsets = numpy.cumsum([0] + [len(a) for a in active])
        ndofs = int(offsets[-1])

        hdofs, hcoeffs = [], []
        pinv_cache = {}
        for l in range(L):
            for e in self._ipl[l]:
                # ancestor chain a[0..l] and child-affine tails
                ancs = [int(e)]
                for lev in range(l, 0, -1):
                    ancs.insert(0, int(fam.parent_of(lev, numpy.array([ancs[0]]))[0]))
                tails = [tuple(map(numpy.squeeze, fam.child_affine(h + 1, numpy.array([ancs[h + 1]]))))
                         for h in range(l)]
                trans_dofs, trans_coeffs = [], []
                if not truncated:
                    for h in range(l + 1):
                        mydofs, mypoly = elem_tables(bases[h], ancs[h])
                        pos = numpy.searchsorted(active[h], mydofs)
                        pos = numpy.minimum(pos, max(len(active[h]) - 1, 0))
                        sel = len(active[h]) > 0 and active[h][pos] == mydofs
                        if numpy.any(sel):
                            trans_dofs.append(offsets[h] + pos[sel])
                            trans_coeffs.append(mypoly[sel])
                        if h < l:
                            lin, off = tails[h]
                            trans_coeffs = [element.compose_affine_poly(c, lin.reshape(self.ndims, self.ndims), off.reshape(self.ndims))
                                            for c in trans_coeffs]
                else:
                    project = None
                    truncpoly = None
                    pmask = None
                    for h in range(l, -1, -1):
                        mydofs, mypoly = elem_tables(bases[h], ancs[h])
                        if h == l:
                            truncpoly = mypoly
                        else:
                            lin, off = tails[h]
                            T = element.compose_affine_poly(mypoly, lin.reshape(self.ndims, self.ndims), off.reshape(self.ndims))
                            Kf = int(numpy.prod(T.shape[1:]))
                            truncpoly = (T.reshape(len(T), Kf)
                                         @ project[:, pmask]
                                         @ truncpoly[pmask].reshape(-1, Kf)).reshape(T.shape)
                        pos = numpy.searchsorted(active[h], mydofs)
                        pos = numpy.minimum(pos, max(len(active[h]) - 1, 0))
                        sel = (len(active[h]) > 0) & (active[h][pos] == mydofs) if len(active[h]) else numpy.zeros(len(mydofs), bool)
                        nz = numpy.abs(truncpoly.reshape(len(truncpoly), -1)).max(1) > truncation_tolerance
                        sel = sel & nz
                        if numpy.any(sel):
                            trans_dofs.append(offsets[h] + pos[sel])
                            trans_coeffs.append(truncpoly[sel])
                        pmask = numpy.isin(mydofs, passive[h])
                        if not pmask.any():
                            break
                        key = id(bases[h]), int(ancs[h])
                        if key not in pinv_cache:
                            P = mypoly.reshape(len(mypoly), -1)
                            pinv_cache[key] = numpy.linalg.pinv(P)
                        project = pinv_cache[key]
                hdofs.append(numpy.concatenate(trans_dofs))
                hcoeffs.append(numpy.concatenate(trans_coeffs, axis=0))
        basis = HierarchicalBasis(self, hdofs, hcoeffs, ndofs)
        return basis

    def basis_discont(self, degree):
        '''Fully discontinuous per-active-element basis (reference:
        topology.py:365 basis dispatch + function.py:2916 DiscontBasis):
        every (level, element) leaf carries its own (degree+1)^d block of
        dofs, numbered consecutively in hierarchical row order.'''
        levels, elems = self._row_level_elem(numpy.arange(len(self)))
        fam = self.family
        dofs, coeffs = [], []
        start = 0
        if fam.structured:
            from .ops.spline import splinebasis_1d, tensor_tables
            o1, c1, n1 = splinebasis_1d(1, degree)
            mi = numpy.zeros((1, self.ndims), dtype=int)
            _, coeffs1 = tensor_tables([o1] * self.ndims, [c1] * self.ndims,
                                       [n1] * self.ndims, mi)
            cell = coeffs1[0]
            L = cell.shape[0]
            for _row in range(len(self)):
                dofs.append(numpy.arange(start, start + L))
                coeffs.append(cell)
                start += L
        else:
            for l, e in zip(levels, elems):
                ref = fam.ref_of(int(l), int(e))
                cell = element.bernstein_coeffs(ref, degree)
                L = cell.shape[0]
                dofs.append(numpy.arange(start, start + L))
                coeffs.append(cell)
                start += L
        return HierarchicalBasis(self, dofs, coeffs, start)

    # ------------------------------------------------------------ locate

    def locate(self, geom, coords, *, tol=None, eps=0, arguments=None, maxiter=None,
               maxdist=None, skip_missing=False, weights=None):
        '''Sample at the active (level, element) cells containing the given
        physical points (reference: topology.py:777 ``Topology.locate``,
        which resolves hierarchical membership through
        ``transforms.index_with_tail``).

        Root coordinates are recovered once through the base structured
        topology's affine-probe/Newton machinery; hierarchical membership is
        then pure integer arithmetic — at level l the candidate cell is
        floor(xi * 2^l), active iff it belongs to this topology's per-level
        index set (the active cells partition the domain, so exactly one
        level matches per point).'''
        fam = self.family
        base = fam.base
        coords = numpy.asarray(coords, dtype=float)
        if coords.ndim == 1:
            coords = coords[:, None]
        npts = len(coords)
        out_level = numpy.full(npts, -1, dtype=int)
        out_elem = numpy.zeros(npts, dtype=int)
        out_local = numpy.zeros((npts, self.ndims))
        if not fam.structured:
            # unstructured parents: locate in the base mesh (Newton over
            # candidate elements), then walk the refinement tree — at each
            # level test the point's frame coordinates against the children's
            # local frames until an active (level, element) cell is reached
            # (the role of the reference's chain->(element, tail) lookup,
            # transformseq.py:15 index_with_tail)
            from .unstructured import newton_locate
            felem, fxi = newton_locate(base, geom, coords, tol=tol, eps=eps,
                                       arguments=arguments, maxiter=maxiter,
                                       maxdist=maxdist, skip_missing=skip_missing,
                                       _raw=True)
            active_sets = [set(map(int, numpy.asarray(idx))) for idx in self._ipl]
            nlev = len(self._ipl)
            for i in range(npts):
                e = int(felem[i])
                if e < 0:
                    continue
                frame = fxi[i]
                loc = frame  # level-0 local == frame coordinates
                for l in range(nlev):
                    if l < len(active_sets) and e in active_sets[l]:
                        out_level[i] = l
                        out_elem[i] = e
                        out_local[i] = loc
                        break
                    if l + 1 >= nlev:
                        break
                    ch = fam.children_of(l, [e])
                    lin, off = fam.to_local(numpy.full(len(ch), l + 1), ch)
                    locs = lin @ frame + off
                    pick = -1
                    for slack in (eps + 1e-12, 1e-9, 1e-6, 1e-3):
                        for ci, c in enumerate(ch):
                            if element.inside(fam.ref_of(l + 1, int(c)), locs[ci], slack):
                                pick = ci
                                break
                        if pick >= 0:
                            break
                    if pick < 0:
                        break
                    e = int(ch[pick])
                    loc = locs[pick]
            found = out_level >= 0
            if not found.all() and not skip_missing:
                raise ValueError(f'failed to locate {int((~found).sum())}/{npts} points')
            return self._locate_build_samples(out_level, out_elem, out_local, weights, base)
        xi = base._locate_rootcoords(geom, coords, tol=tol, eps=eps, arguments=arguments,
                                     maxiter=maxiter, skip_missing=skip_missing,
                                     maxdist=maxdist)
        valid = ~numpy.isnan(xi[:, 0])
        for l, idx in enumerate(self._ipl):
            if not len(idx):
                continue
            shape_l = numpy.array(fam.shape(l))
            xl = xi * (1 << l)
            em = numpy.minimum(numpy.maximum(
                numpy.floor(numpy.where(numpy.isnan(xl), 0.0, xl)).astype(int), 0), shape_l - 1)
            flat = numpy.ravel_multi_index(tuple(em.T), tuple(shape_l))
            hit = numpy.isin(flat, idx) & valid & (out_level == -1)
            out_level[hit] = l
            out_elem[hit] = flat[hit]
            out_local[hit] = xl[hit] - em[hit]
        found = out_level >= 0
        if not found.all() and not skip_missing:
            raise ValueError(f'failed to locate {int((~found).sum())}/{npts} points')
        return self._locate_build_samples(out_level, out_elem, out_local, weights, base)

    def _locate_build_samples(self, out_level, out_elem, out_local, weights, base):
        '''Per-level point samples from located (level, element, local) rows,
        reordered back to the input point order.'''
        fam = self.family
        found = out_level >= 0
        samples, row_order = [], []
        for l in sorted(set(out_level[found])):
            rows = numpy.nonzero(out_level == l)[0]
            sel = out_elem[rows]
            flin, foff = fam._level_frame(l, sel)
            local = out_local[rows]
            coords_s = (numpy.einsum('eij,ej->ei', flin, local) + foff)[:, None, :]
            p_lin, p_off = fam._level_to_local(l, sel)
            w = None if weights is None else numpy.asarray(weights)[rows][:, None]
            ref = fam.levels[l].ref if fam.structured else fam.ref_of(int(l), int(sel[0]))
            samples.append(_sample.Sample(
                self.space, coords_s, w, sel, p_lin, p_off, flin,
                None, None, None,
                part_ids=numpy.zeros(len(rows), dtype=int), part_topos=[self],
                batch_key=type(ref).__name__, origin_topo=fam.levels[l],
                lineage=(fam, numpy.full(len(rows), l), sel)))
            row_order.append(rows)
        if not samples:
            return base._point_sample(numpy.zeros((0, self.ndims)), None)
        if len(samples) == 1:
            return samples[0]
        order = numpy.concatenate(row_order)   # parent row k holds input row order[k]
        perm = numpy.empty_like(order)
        perm[order] = numpy.arange(len(order))  # perm[i] = parent row of input row i
        return _sample.ReorderedSample(_sample.ChainedSample(samples), perm)


class _HierBoundaryPart(Topology):
    '''A named group of boundary edges of a hierarchical topology, stored as
    (level, element, edge) triples across levels.'''

    def __init__(self, hier, items):
        super().__init__(hier.space, hier.ndims - 1)
        self.hier = hier
        self.items = list(items)

    def __len__(self):
        return len(self.items)

    def sample(self, ischeme, degree=None):
        fam = self.hier.family
        d = self.hier.ndims
        buckets = {}
        for (l, e, k) in self.items:
            ref = fam.ref_of(l, e)
            eref = ref.edges[k][3]
            buckets.setdefault(type(eref).__name__, []).append((l, e, k, ref, eref))
        samples = []
        for key, items in buckets.items():
            eref = items[0][4]
            tri_local = hull_local = None
            if ischeme == 'gauss':
                pts, wts = eref.gauss(degree)
            elif ischeme == 'bezier':
                pts, tri_local, hull_local = eref.bezier(degree)
                wts = None
            elif ischeme == '_centroid':
                pts = eref.vertices.mean(0, keepdims=True)
                wts = None
            else:
                raise ValueError(f'unknown sample scheme {ischeme!r}')
            E, P = len(items), len(pts)
            levels = numpy.asarray([it[0] for it in items])
            elems = numpy.asarray([it[1] for it in items])
            flin, foff = fam.frame_affine(levels, elems)
            coords = numpy.empty((E, P, d))
            tangents = numpy.empty((E, d, d - 1))
            normals = numpy.empty((E, d))
            for i, (l, e, k, ref, _er) in enumerate(items):
                elin, eoff, nrm, _ = ref.edges[k]
                coords[i] = (pts @ elin.T + eoff) @ flin[i].T + foff[i]
                tangents[i] = flin[i] @ elin
                nf = numpy.linalg.inv(flin[i]).T @ nrm
                normals[i] = nf / numpy.linalg.norm(nf)
            p_lin, p_off = fam.to_local(levels, elems)
            weights = None if wts is None else numpy.broadcast_to(wts, (E, P)).copy()
            samples.append(_sample.Sample(
                self.space, coords, weights, elems, p_lin, p_off, tangents,
                normals, tri_local, hull_local,
                part_ids=numpy.zeros(E, dtype=int), part_topos=[self],
                batch_key=('hier-edge', key), origin_topo=None,
                lineage=(fam, levels, elems)))
        if len(samples) == 1:
            return samples[0]
        return _sample.ChainedSample(samples)

    def basis(self, btype='std', degree=1, **kwargs):
        return self.hier.basis(btype, degree, **kwargs)


class _HierInterfaces(Topology):
    '''Interior faces between the active elements of a hierarchical topology.

    Every facet is emitted exactly once, as a full face of the FINER element
    of the pair (same-level pairs on the positive side only); the first side
    of the two-sided sample is that emitting element, the normal points from
    the first into the second side, and both sides lower through lineage
    charts so any basis of the refinement family evaluates two-sidedly
    (reference: topology.py:1740 interfaces + HierarchicalTopology edge
    gluing, topology.py:2785).'''

    def __init__(self, hier):
        super().__init__(hier.space, hier.ndims - 1)
        self.hier = hier
        fam = hier.family
        if not fam.structured:
            raise NotImplementedError('interfaces of hierarchical refinements of '
                                      'unstructured topologies')
        levels, els = hier._row_level_elem(numpy.arange(len(hier)))
        base = fam.base
        ref = fam.levels[0].ref
        edgeidx = {}
        for k, (_l, _o, nrm, _r) in enumerate(ref.edges):
            idim = int(numpy.argmax(numpy.abs(nrm)))
            edgeidx[idim, int(nrm[idim] > 0)] = k
        items = []  # (level, elem, face k, nb level, nb elem)
        for row in range(len(hier)):
            l, e = int(levels[row]), int(els[row])
            shape = fam.shape(l)
            multi = numpy.array(numpy.unravel_index(e, shape))
            for idim in range(hier.ndims):
                for side in (0, 1):
                    nb = multi.copy()
                    nb[idim] += 1 if side else -1
                    if idim in base.periodic:
                        nb[idim] %= shape[idim]
                    elif nb[idim] < 0 or nb[idim] >= shape[idim]:
                        continue
                    nbe = int(numpy.ravel_multi_index(nb, shape))
                    nrow = int(hier._hier_index([l], [nbe], strict=False)[0])
                    if nrow < 0:
                        continue  # neighbor refined deeper: the finer side emits
                    nl, ne = hier._row_level_elem([nrow])
                    nl, ne = int(nl[0]), int(ne[0])
                    if nl == l and side == 0:
                        continue  # same level: emitted by the positive side
                    items.append((l, e, edgeidx[idim, side], nl, ne))
        self.items = items
        self.ref = ref

    def __len__(self):
        return len(self.items)

    def sample(self, ischeme, degree=None):
        hier = self.hier
        fam = hier.family
        d = hier.ndims
        eref = self.ref.edges[0][3]
        tri_local = hull_local = None
        if ischeme == 'gauss':
            pts, wts = eref.gauss(degree)
        elif ischeme == 'bezier':
            pts, tri_local, hull_local = eref.bezier(degree)
            wts = None
        elif ischeme == 'uniform':
            pts, wts = eref.uniform(degree or 1)
        elif ischeme == '_centroid':
            pts = eref.vertices.mean(0, keepdims=True)
            wts = None
        else:
            raise ValueError(f'unknown interface scheme {ischeme!r}')
        E, P = len(self.items), len(pts)
        levels = numpy.asarray([it[0] for it in self.items])
        elems = numpy.asarray([it[1] for it in self.items])
        nlevels = numpy.asarray([it[3] for it in self.items])
        nelems = numpy.asarray([it[4] for it in self.items])
        flin, foff = fam.frame_affine(levels, elems)
        coords = numpy.empty((E, P, d))
        tangents = numpy.empty((E, d, d - 1))
        normals = numpy.empty((E, d))
        for i, (l, e, k, _nl, _ne) in enumerate(self.items):
            elin, eoffs, nrm, _ = self.ref.edges[k]
            coords[i] = (pts @ elin.T + eoffs) @ flin[i].T + foff[i]
            tangents[i] = flin[i] @ elin
            nf = numpy.linalg.inv(flin[i]).T @ nrm
            normals[i] = nf / numpy.linalg.norm(nf)
        weights = None if wts is None else numpy.broadcast_to(wts, (E, P)).copy()
        p_lin0, p_off0 = fam.to_local(levels, elems)
        p_lin1, p_off1 = fam.to_local(nlevels, nelems)
        oppo = _sample.Sample(
            self.space, coords, None if weights is None else weights.copy(),
            nelems, p_lin1, p_off1, tangents, -normals, tri_local, hull_local,
            part_ids=numpy.zeros(E, dtype=int), part_topos=[self],
            batch_key=('hier-iface',), origin_topo=None,
            lineage=(fam, nlevels, nelems))
        return _sample.Sample(
            self.space, coords, weights, elems, p_lin0, p_off0, tangents,
            normals, tri_local, hull_local, opposite=oppo,
            part_ids=numpy.zeros(E, dtype=int), part_topos=[self],
            batch_key=('hier-iface',), origin_topo=None,
            lineage=(fam, levels, elems))

    def basis(self, btype='std', degree=1, **kwargs):
        return self.hier.basis(btype, degree, **kwargs)


class HierarchicalBasis(function.Basis):
    '''Basis from ragged per-hierarchical-element polynomial tables; lowers on
    any sample of the refinement family through the chart lineage.'''

    def __init__(self, topo, dofs, coeffs, ndofs):
        self.topo = topo
        self._dofs = [numpy.asarray(d, dtype=int) for d in dofs]
        self._elemcoeffs = [numpy.asarray(c, dtype=float) for c in coeffs]
        super().__init__(ndofs, len(dofs), topo.space)

    def get_tables(self, elem_indices):
        elem_indices = numpy.asarray(elem_indices, dtype=int)
        Lmax = max((len(self._dofs[i]) for i in elem_indices), default=1)
        Kshape = self._elemcoeffs[elem_indices[0]].shape[1:] if len(elem_indices) else ()
        dofs = numpy.zeros((len(elem_indices), Lmax), dtype=int)
        coeffs = numpy.zeros((len(elem_indices), Lmax) + Kshape)
        for i, e in enumerate(elem_indices):
            n = len(self._dofs[e])
            dofs[i, :n] = self._dofs[e]
            coeffs[i, :n] = self._elemcoeffs[e]
        return dofs, coeffs

    @functools.cached_property
    def _support(self):
        sup = [[] for _ in range(self.ndofs)]
        for ielem in range(self.nelems):
            for dd in numpy.unique(self._dofs[ielem]):
                sup[dd].append(ielem)
        return [numpy.asarray(s, dtype=int) for s in sup]

    def _resolve_chart(self, chart, E, P):
        '''Resolve any sample of the refinement family to hierarchical rows
        plus the active element's local coordinates — shared by the direct
        ``lower`` and by wrapper bases (Pruned/Masked) that delegate here.'''
        fam = self.topo.family
        lg = chart.lineage
        if lg is None:
            hier = getattr(chart.origin_topo, '_hier', None)
            assert hier is not None and hier[0] is fam, \
                'hierarchical basis evaluated on a sample outside its refinement family'
            lg = (fam, numpy.full(E, hier[1]), chart.index)
        assert lg[0] is fam, 'sample belongs to a different refinement family'
        rows = self.topo._hier_index(lg[1], lg[2])
        act_l, act_e = self.topo._row_level_elem(rows)
        lin, off = fam.to_local(act_l, act_e)
        xi = function._affine_of_X(chart.X, lin, off, E, P)
        return rows, xi

    def lower(self, args):
        chart = args.chart(self.space)
        E, P = args.points_shape
        rows, xi = self._resolve_chart(chart, E, P)
        dofs, coeffs = self.get_tables(rows)
        return function._lower_poly_tables(dofs, coeffs, xi, P, self.ndofs)
