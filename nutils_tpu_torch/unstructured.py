'''Unstructured topologies: simplex and mixed-element meshes.

The part of ``nutils_tpu.unstructured`` that the triangle slice reaches
(reference: topology.py:2437,2422 SimplexTopology/ConnectedTopology):
per-element vertex tables plus edge-matching connectivity, elements grouped
into uniform *buckets* by reference type so every bucket lowers to statically
shaped batched arrays, and samples over mixed meshes as chains of per-bucket
samples.  The dof numbering is the JAX package's, dof for dof; the edge
matching and the C0 dof merge are vectorised (numpy sorts and a connected-
components pass) where the JAX package loops over elements in Python.

>>> import numpy
>>> from nutils_tpu_torch import mesh, function
>>> topo, geom = mesh.unitsquare(2, 'triangle')
>>> len(topo)
8
>>> topo.basis('std', degree=1).ndofs
9
'''

import functools
import time

import numpy
import torch

from . import element, evaluable, function, sample as _sample
from .topology import Topology


def merge_index_map(nin, merge_sets):
    '''Index merge with minimal representatives, condensed by first
    appearance (reference semantics: _util.py:759 merge_index_map): indices
    joined by a merge set, directly or through others, map to one number,
    and the numbers count up in the order of each group's smallest index.
    ``merge_sets`` is an [m, k] integer array (one set a row) or any
    iterable of sets of any size.  Returns (index map, number of groups).'''
    import scipy.sparse
    import scipy.sparse.csgraph
    if isinstance(merge_sets, numpy.ndarray) and merge_sets.ndim == 2:
        k = merge_sets.shape[1]
        heads = numpy.repeat(merge_sets[:, 0], max(k - 1, 0))
        tails = merge_sets[:, 1:].ravel()
    else:
        # every set joins its first member to each of the others
        heads, tails = [], []
        for merge_set in merge_sets:
            merge_set = list(merge_set)
            heads.extend(merge_set[:1] * (len(merge_set) - 1))
            tails.extend(merge_set[1:])
        heads = numpy.asarray(heads, dtype=numpy.int64)
        tails = numpy.asarray(tails, dtype=numpy.int64)
    graph = scipy.sparse.coo_matrix((numpy.ones(len(heads), dtype=numpy.int8), (heads, tails)), shape=(nin, nin))
    ngroups, labels = scipy.sparse.csgraph.connected_components(graph, directed=False)
    # each group's representative is its smallest index; numbering by first
    # appearance is numbering by that index
    first = numpy.full(ngroups, nin, dtype=numpy.int64)
    numpy.minimum.at(first, labels, numpy.arange(nin))
    rank = numpy.empty(ngroups, dtype=int)
    rank[numpy.argsort(first)] = numpy.arange(ngroups)
    return rank[labels], int(ngroups)


def _nearest_elements(cent, coords, ncand):
    '''[npts, ncand] element ids of the ``ncand`` centroids nearest to each
    point, nearest first: each point's row of squared distances argsorted,
    the JAX package's order with its ties, built for 2^22 (points x
    elements) at a time (32 MiB of float64).'''
    nelems, npts = len(cent), len(coords)
    order = numpy.empty((npts, ncand), dtype=int)
    step = max(1, (1 << 22) // max(nelems, 1))
    for a in range(0, npts, step):
        d2 = ((cent[None, :, :] - coords[a:a + step, None, :]) ** 2).sum(-1)
        order[a:a + step] = numpy.argsort(d2, axis=1)[:, :ncand]
    return order


def _chart_samples(smp):
    '''The plain Samples under a (reordered, chained) sample, in order.'''
    if isinstance(smp, _sample.ReorderedSample):
        return _chart_samples(smp.parent)
    if isinstance(smp, _sample.ChainedSample):
        return [s for part in smp.samples for s in _chart_samples(part)]
    return [smp]


def _chart_key(smp):
    '''Everything of a one-point-per-row Sample that its lowering bakes
    in: every table but the points' coordinates.'''
    return tuple((spec.space, spec.coords.shape, spec.index.tobytes(),
                  numpy.ascontiguousarray(spec.p_linear).tobytes(),
                  numpy.ascontiguousarray(spec.p_offset).tobytes(),
                  numpy.ascontiguousarray(spec.tangents).tobytes()) for spec in smp.specs)


class _PointEval:
    '''``geom`` and its root gradient at the points of one-point-per-row
    samples (a Sample, or a reordered chain of them), as numpy ([N, D],
    [N, D, d]).  Each Sample of the chain is lowered on its own and its
    graph kept while the next samples' part differs from it only in its
    points' coordinates (the Newton iterations of a candidate rank, where
    none of the part's points changes element), which then bind as leaves;
    a graph in which the lowering folded the coordinates into a constant
    serves only the coordinates it was lowered at.  The root gradient
    takes reverse-mode autograd (``evaluable.reverse_grads``).'''

    def __init__(self, geom, rootgrad, arguments, d):
        self.funcs = [geom, rootgrad]
        self.arguments = function._clean_args(arguments or {})
        self.d = d
        self.lowered = 0
        self._parts = {}

    def _part(self, i, smp):
        key = _chart_key(smp)
        coords = [spec.coords for spec in smp.specs]
        hit = self._parts.get(i)
        if hit is None or hit[0] != key or hit[3] is not None and not all(map(numpy.array_equal, hit[3], coords)):
            exprs = [function.asarray(smp.bind(f)).lower(function.EMPTY_LOWER_ARGS) for f in self.funcs]
            comp = evaluable.Compiled(exprs)
            leafkeys = [('X', smp._token, spec.space) for spec in smp.specs]
            folded = not all(k in comp.leafnodes for k in leafkeys)
            hit = self._parts[i] = key, comp, leafkeys, coords if folded else None
            self.lowered += 1
        _key, comp, leafkeys, _folded = hit
        leaves = {k: c for k, c in zip(leafkeys, coords) if k in comp.leafnodes}
        with evaluable.reverse_grads():
            vals, grads = (v.detach() for v in comp.trace_flat(self.arguments, leaves))
        n = vals.shape[0]
        return vals.reshape(n, -1), grads.reshape(n, -1, self.d)

    def __call__(self, smp):
        # the parts' values stay on the device until one read of them all
        parts = [self._part(i, s) for i, s in enumerate(_chart_samples(smp))]
        vals = torch.cat([v for v, _g in parts]).cpu().numpy()
        grads = torch.cat([g for _v, g in parts]).cpu().numpy()
        if isinstance(smp, _sample.ReorderedSample):
            vals, grads = vals[smp.perm], grads[smp.perm]
        return vals, grads


def newton_locate(topo, geom, coords, *, tol=None, eps=0, arguments=None, maxiter=None,
                  maxdist=None, skip_missing=False, weights=None, _raw=False, _stats=None):
    '''Generic physical-point location: per-point Newton iteration over
    candidate elements sorted by centroid distance (reference:
    topology.py:777-897 ``Topology.locate``/``_locate``).  The topology
    provides four hooks — ``_locate_start`` (initial iteration coordinates
    per candidate element), ``_locate_eval`` (geometry value + gradient with
    respect to the iteration coordinates, through the given evaluator),
    ``_locate_clip`` (trust region) and ``_locate_accept`` (containment
    test, mapping iteration coordinates to the containing element + local
    coordinates) — plus ``_point_sample`` to build the final sample.
    ``_stats``, a dict, receives the candidate ranks tried, the Newton
    iterations, the lowerings, the points found and the seconds the
    candidates' argsort took.'''
    coords = numpy.asarray(coords, dtype=float)
    if coords.ndim == 1:
        coords = coords[:, None]
    d = topo.ndims
    geom = function.asarray(geom)
    if geom.ndim == 0:
        geom = function.stack([geom], axis=0)
    assert coords.shape[1] == geom.shape[0]
    tol = tol or 1e-12
    arguments = arguments or {}
    npts = len(coords)
    # element centroids in physical space
    csmp = topo.sample('_centroid')
    parts = csmp.samples if isinstance(csmp, _sample.ChainedSample) else [csmp]
    cent = numpy.empty((len(topo), geom.shape[0]))
    for s in parts:
        cent[s.index] = numpy.asarray(s.eval(geom, arguments)).reshape(s.nelems, -1)
    ncand = min(len(topo), 32)
    t0 = time.perf_counter()
    order = _nearest_elements(cent, coords, ncand)
    t_candidates = time.perf_counter() - t0
    rootgrad = function.grad(geom, function._RootCoords(topo.space, d))
    evaluate = _PointEval(geom, rootgrad, arguments, d)
    found_elem = numpy.full(npts, -1, dtype=int)
    found_xi = numpy.zeros((npts, d))
    active = numpy.arange(npts)
    ranks = iterations = 0
    for rank in range(ncand):
        if not len(active):
            break
        ranks += 1
        cand = order[active, rank]
        xi = topo._locate_start(cand)
        for it in range(maxiter or 30):
            vals, grads = topo._locate_eval(cand, xi, evaluate)
            iterations += 1
            r = coords[active] - vals
            resid = numpy.abs(r).max(axis=1)
            if (resid < max(tol, 1e-12)).all():
                break
            if grads.shape[1] == grads.shape[2]:
                try:
                    delta = numpy.linalg.solve(grads, r[..., None])[..., 0]
                except numpy.linalg.LinAlgError:
                    delta = numpy.stack([numpy.linalg.lstsq(g, rr, rcond=None)[0]
                                         for g, rr in zip(grads, r)])
            else:
                delta = numpy.stack([numpy.linalg.lstsq(g, rr, rcond=None)[0]
                                     for g, rr in zip(grads, r)])
            xi = topo._locate_clip(cand, xi + delta)
        inside_ok, elems, xi_local = topo._locate_accept(cand, xi, eps)
        ok = inside_ok & (resid < max(tol, 1e-12))
        hit = active[ok]
        found_elem[hit] = elems[ok]
        found_xi[hit] = xi_local[ok]
        active = active[~ok]
    if _stats is not None:
        _stats.update(ranks=ranks, iterations=iterations, lowered=evaluate.lowered,
                      found=int((found_elem >= 0).sum()), t_candidates=t_candidates)
    if len(active) and not skip_missing:
        raise ValueError(f'failed to locate {len(active)}/{npts} points')
    if _raw:
        # (element id or -1, element-local coordinates) per input point —
        # the hook the hierarchical walk-down builds on
        return found_elem, found_xi
    sel = found_elem >= 0
    return topo._point_sample(found_elem[sel], found_xi[sel],
                              None if weights is None else numpy.asarray(weights)[sel])


def _frame_arrays(topo, ids, coords, tangents, normal_root=None):
    '''Transform element-local sample arrays into refinement-family *frame*
    arrays when ``topo`` is a refined member of a family (the analogue of the
    reference's transform-chain composition through child transforms,
    transformseq.py:708 DerivedTransforms): returns (coords [E,P,d],
    p_linear, p_offset, tangents, normal_root, lineage).  For base topologies
    the chart is the element itself and the maps are trivial.'''
    E = len(ids)
    d = coords.shape[-1]
    hier = getattr(topo, '_hier', None)
    if hier is None or hier[1] == 0:
        return (coords, numpy.broadcast_to(numpy.eye(d), (E, d, d)), numpy.zeros((E, d)),
                tangents, normal_root,
                None if hier is None else (hier[0], numpy.zeros(E, dtype=int), numpy.asarray(ids)))
    fam, l = hier
    ids = numpy.asarray(ids)
    flin, foff = fam._level_frame(l, ids)
    coords = numpy.einsum('eij,epj->epi', flin, coords) + foff[:, None, :]
    plin, poff = fam._level_to_local(l, ids)
    tangents = numpy.einsum('eij,ejk->eik', flin, numpy.broadcast_to(tangents, (E, d, tangents.shape[-1])))
    if normal_root is not None:
        normal_root = numpy.linalg.solve(
            flin.transpose(0, 2, 1), numpy.broadcast_to(normal_root, (E, d))[..., None])[..., 0]
    return coords, plin, poff, tangents, normal_root, (fam, numpy.full(E, l, dtype=int), ids)


class UnstructuredTopology(Topology):
    '''Mesh of elements given by (reference, vertex ids) per element.

    Parameters
    ----------
    space : str
    refs : list of Reference, one per element (shared types define buckets)
    elem_verts : vertex ids per element (sorted rows): a list of int arrays,
        or one [nelems, nverts] array when every element has as many vertices
    nverts : total number of vertices
    '''

    def __init__(self, space, refs, elem_verts, nverts):
        ndims = refs[0].ndims
        assert all(r.ndims == ndims for r in refs)
        super().__init__(space, ndims)
        self._refs = list(refs)
        if isinstance(elem_verts, numpy.ndarray) and elem_verts.ndim == 2:
            self._elem_verts = elem_verts
        else:
            self._elem_verts = [numpy.asarray(v) for v in elem_verts]
        self.nverts = int(nverts)
        # bucket elements by reference type
        buckets = {}
        for ielem, ref in enumerate(self._refs):
            buckets.setdefault(type(ref).__name__, (ref, []))[1].append(ielem)
        self._buckets = [(ref, numpy.asarray(ids)) for ref, ids in buckets.values()]

    def __len__(self):
        return len(self._refs)

    def _verts_of(self, ids):
        '''[len(ids), nv] vertex table of elements of one reference type.'''
        if isinstance(self._elem_verts, numpy.ndarray):
            return self._elem_verts[ids]
        return numpy.stack([self._elem_verts[i] for i in ids]).reshape(len(ids), -1)

    # ------------------------------------------------------------ sampling

    def sample(self, ischeme, degree=None):
        return self._sample_elements(self._buckets, ischeme, degree, self)

    def _sample_elements(self, buckets, ischeme, degree, origin):
        '''Sample the given (ref, global element ids) buckets; ``origin`` is
        the topology recorded in part_topos.'''
        samples = []
        for ref, ids in buckets:
            tri_local = hull_local = None
            if ischeme == 'gauss':
                pts, wts = ref.gauss(degree)
            elif ischeme == 'bezier':
                pts, tri_local, hull_local = ref.bezier(degree)
                wts = None
            elif ischeme == '_centroid':
                pts = ref.vertices.mean(0, keepdims=True)
                wts = None
            elif ischeme == 'vertex':
                pts = ref.vertices
                wts = None
            elif ischeme == 'uniform':
                pts, wts = ref.uniform(degree or 1)
            else:
                raise ValueError(f'unknown sample scheme {ischeme!r}')
            E, P, d = len(ids), len(pts), self.ndims
            coords = numpy.broadcast_to(pts, (E, P, d)).copy()
            weights = None if wts is None else numpy.broadcast_to(wts, (E, P)).copy()
            tangents = numpy.broadcast_to(numpy.eye(d), (E, d, d))
            coords, p_linear, p_offset, tangents, _, lineage = _frame_arrays(self, ids, coords, tangents)
            samples.append(_sample.Sample(self.space, coords, weights, ids, p_linear, p_offset,
                                          tangents, None, tri_local, hull_local,
                                          part_ids=numpy.zeros(E, dtype=int), part_topos=[origin],
                                          batch_key=type(ref).__name__, origin_topo=self,
                                          lineage=lineage))
        if len(samples) == 1:
            return samples[0]
        return _sample.ChainedSample(samples)

    # ------------------------------------------------------------ structure

    @functools.cached_property
    def _edge_matching(self):
        '''(neighbour [nelems, max edges] with -1 on boundary edges and
        padding, boundary (ielem, iedge) pairs, interior (ielem, iedge,
        jelem, jedge) rows): edges matched by their sorted vertex ids, the
        first occurrence (element-major, edge-minor) owning the pair, as the
        JAX package's dictionary walk does.'''
        nedges = numpy.array([len(ref.edge_vertex_ids) for ref in self._refs])
        first_pos = numpy.concatenate([[0], numpy.cumsum(nedges)])
        width = max(len(ev) for ref, _ids in self._buckets for ev in ref.edge_vertex_ids)
        pos, keys = [], []
        for ref, ids in self._buckets:
            V = self._verts_of(ids)
            for iedge, ev in enumerate(ref.edge_vertex_ids):
                k = numpy.full((len(ids), width), -1, dtype=numpy.int64)
                k[:, :len(ev)] = numpy.sort(V[:, list(ev)], axis=1)
                keys.append(k)
                pos.append(first_pos[ids] + iedge)
        pos = numpy.concatenate(pos)
        keys = numpy.concatenate(keys)
        order = numpy.lexsort((pos,) + tuple(keys[:, c] for c in reversed(range(width))))
        pos, keys = pos[order], keys[order]
        same = numpy.ones(len(pos), dtype=bool)
        same[0] = False
        same[1:] = (keys[1:] == keys[:-1]).all(axis=1)
        if len(pos) > 2 and (same[1:] & same[:-1]).any():
            raise NotImplementedError('an edge shared by more than two elements (non-manifold mesh)')
        second = numpy.flatnonzero(same)
        first = second - 1
        lone = numpy.ones(len(pos), dtype=bool)
        lone[first] = lone[second] = False
        elem_of = numpy.repeat(numpy.arange(len(self)), nedges)
        edge_of = numpy.arange(len(elem_of)) - first_pos[elem_of]
        neighbour = numpy.full((len(self), int(nedges.max(initial=0))), -1, dtype=int)
        pa, pb = pos[first], pos[second]
        neighbour[elem_of[pa], edge_of[pa]] = elem_of[pb]
        neighbour[elem_of[pb], edge_of[pb]] = elem_of[pa]
        bpos = numpy.sort(pos[lone])
        boundary = list(zip(elem_of[bpos].tolist(), edge_of[bpos].tolist()))
        iorder = numpy.argsort(pa)
        pa, pb = pa[iorder], pb[iorder]
        interior = numpy.stack([elem_of[pa], edge_of[pa], elem_of[pb], edge_of[pb]], axis=1)
        return neighbour, boundary, interior

    @functools.cached_property
    def connectivity(self):
        '''Per-element neighbor list aligned with the reference-type edge
        numbering; -1 marks boundary edges (reference: topology.py:2479).'''
        neighbour = self._edge_matching[0]
        return [neighbour[ielem, :len(ref.edge_vertex_ids)] for ielem, ref in enumerate(self._refs)]

    @property
    def _boundary_edges(self):
        return self._edge_matching[1]

    @functools.cached_property
    def boundary(self):
        return UnstructuredBoundary(self, self._boundary_edges)

    @functools.cached_property
    def interfaces(self):
        '''Interior inter-element faces with two-sided samples
        (reference: topology.py:2422 ConnectedTopology.interfaces).'''
        return UnstructuredInterfaces(self, [tuple(map(int, row)) for row in self._edge_matching[2]])

    @property
    def refined(self):
        '''Uniformly refined topology (reference: topology.py:2749
        RefinedTopology; for simplex meshes topology.py:2437).  The result is
        a full UnstructuredTopology over subdivided elements, linked to this
        one through the refinement family so functions (geometry, bases)
        defined here evaluate on the refined samples via the chart lineage.'''
        from .hierarchical import family_of
        fam = family_of(self)
        l = getattr(self, '_hier')[1]
        fam.ensure(l + 2)
        return fam.levels[l + 1]

    def take(self, ielems):
        '''Subset view over a selection of elements.  Samples carry the
        parent's element numbering so any basis or geometry defined on the
        full topology evaluates on the subset's samples; the boundary includes
        the interface edges exposed by the selection (the analogue of the
        reference's whole-element SubsetTopology, topology.py:2615).'''
        return UnstructuredSubsetTopology(self, ielems)

    def withgroups(self, vgroups=None, bgroups=None, pgroups=None):
        '''Attach named element/boundary/point groups: ``topo[name]`` gives
        the subset topology of an element group, ``topo.boundary[name]`` a
        boundary group, and ``topo.points[name]`` a 0-d point-group topology
        (reference: topology.py:731-760 with* and gmsh's pgroups).'''
        out = self
        if vgroups:
            resolved = {name: self.take(ielems) if not isinstance(ielems, Topology) else ielems
                        for name, ielems in vgroups.items()}
            out = out.withsubdomain(**resolved)
        if bgroups:
            out = out.withboundary(**bgroups)
        if pgroups:
            object.__setattr__(out, 'points', dict(pgroups))
        return out

    def point_topology(self, vertex_id):
        '''0-d topology of a single mesh vertex (reference: gmsh physical
        points, accessible as topo.points[name], mesh.py:300 pgroups).'''
        return _VertexTopology(self, int(vertex_id))

    # ------------------------------------------------------------ locate

    def _point_sample(self, ielems, xi, weights=None):
        '''Sample of one point per row at local coordinates xi [N, d] of
        elements ielems [N], in input row order (mixed reference types are
        fine: every chart array is per-row, and the ragged per-element basis
        tables do not require type grouping for single-point rows).'''
        ielems = numpy.asarray(ielems, dtype=int)
        xi = numpy.asarray(xi, dtype=float)
        N, d = xi.shape
        coords = xi[:, None, :]
        tangents = numpy.broadcast_to(numpy.eye(d), (N, d, d))
        coords, p_linear, p_offset, tangents, _, lineage = _frame_arrays(self, ielems, coords, tangents)
        return _sample.Sample(
            self.space, coords,
            None if weights is None else numpy.asarray(weights)[:, None],
            ielems, p_linear, p_offset, tangents, None, None, None,
            part_ids=numpy.zeros(N, dtype=int), part_topos=[self],
            batch_key=('point', self.space), origin_topo=self, lineage=lineage)

    def locate(self, geom, coords, *, tol=None, eps=0, arguments=None, maxiter=None,
               maxdist=None, skip_missing=False, weights=None):
        '''Sample at the elements/local coordinates containing the given
        physical points, by per-point Newton iteration over candidate
        elements sorted by centroid distance (reference: topology.py:777-897
        ``Topology.locate``/``_locate``).'''
        return newton_locate(self, geom, coords, tol=tol, eps=eps, arguments=arguments,
                             maxiter=maxiter, maxdist=maxdist, skip_missing=skip_missing,
                             weights=weights)

    # newton_locate hooks: iteration coordinates are element-local coordinates
    # of the candidate element

    def _elem_kinds(self, ielems):
        '''[(reference, rows)] of the given elements, one per reference type.'''
        kind = numpy.empty(len(self), dtype=int)
        for k, (_ref, ids) in enumerate(self._buckets):
            kind[ids] = k
        kinds = kind[numpy.asarray(ielems, dtype=int)]
        return [(self._buckets[k][0], numpy.flatnonzero(kinds == k)) for k in numpy.unique(kinds)]

    def _locate_start(self, cand):
        out = numpy.empty((len(cand), self.ndims))
        for ref, rows in self._elem_kinds(cand):
            out[rows] = ref.vertices.mean(0)
        return out

    def _locate_eval(self, cand, xi, evaluate):
        vals, grads = evaluate(self._point_sample(cand, xi))
        hier = getattr(self, '_hier', None)
        if hier is not None and hier[1] > 0:
            # root gradients are frame gradients: chain through the frame map
            flin, _ = hier[0]._level_frame(hier[1], cand)
            grads = numpy.einsum('egj,eji->egi', grads, flin)
        return vals, grads

    def _locate_clip(self, cand, xi):
        return numpy.clip(xi, -1.0, 2.0)

    def _locate_accept(self, cand, xi, eps):
        ok = numpy.zeros(len(cand), dtype=bool)
        for ref, rows in self._elem_kinds(cand):
            ok[rows] = element.inside(ref, xi[rows], eps + 1e-10)
        return ok, cand, xi

    def _point_rows(self, ielems):
        rows_by_type = {}
        for row, ie in enumerate(ielems):
            rows_by_type.setdefault(type(self._refs[ie]).__name__, []).append(row)
        return list(rows_by_type.values())

    # ------------------------------------------------------------ bases

    def _plain_basis(self, dofs, coeffs_of, degree, ndofs):
        '''PlainBasis over per-element dof tables: one [nelems, L] table and
        the reference's coefficient table broadcast over the elements where
        every element has one reference type, else ragged per-element lists
        (``dofs`` is then the flat table of concatenated element dofs).'''
        if len(self._buckets) == 1:
            ref = self._buckets[0][0]
            table = coeffs_of(ref, degree)
            coeffs = numpy.broadcast_to(table, (len(self),) + table.shape)
            basis = function.PlainBasis(self.space, numpy.asarray(dofs).reshape(len(self), -1), coeffs, ndofs)
        else:
            coeffs = [coeffs_of(ref, degree) for ref in self._refs]
            offsets = numpy.cumsum([0] + [len(c) for c in coeffs])
            dofs = numpy.asarray(dofs).ravel()
            basis = function.PlainBasis(self.space, [dofs[a:b] for a, b in zip(offsets[:-1], offsets[1:])],
                                        coeffs, ndofs, ragged=True)
        basis._origin = self
        return basis

    def basis_std(self, degree):
        if degree == 1 and all(isinstance(r, (element.LineReference, element.TriangleReference, element.TetReference))
                               for r in self._refs):
            # pure simplex: vertex dofs directly (reference: topology.py:2495)
            verts = self._elem_verts if isinstance(self._elem_verts, numpy.ndarray) \
                else numpy.concatenate(self._elem_verts)
            return self._plain_basis(verts, element.bernstein_coeffs, 1, self.nverts)
        return self.basis_bernstein(degree)

    def basis_bernstein(self, degree):
        '''C0 Bernstein basis: per-element dofs merged across shared edges
        (reference: topology.py:1777 _basis_c0_structured).'''
        return self._basis_c0(degree, element.bernstein_coeffs)

    def basis_lagrange(self, degree):
        '''C0 nodal Lagrange basis on the equispaced lattice (reference:
        topology.py:1801 basis_lagrange): same dof enumeration and edge merge
        as Bernstein, interpolatory coefficients.'''
        return self._basis_c0(degree, element.lagrange_coeffs)

    def _basis_c0(self, degree, coeffs_of):
        counts = numpy.array([len(coeffs_of(ref, degree)) for ref in self._refs])
        offsets = numpy.concatenate([[0], numpy.cumsum(counts)])
        # every interior edge merges its dofs on the lower element with those
        # on the higher one, in each side's canonical edge order
        _neighbour, _boundary, interior = self._edge_matching
        types = {type(ref): k for k, (ref, _ids) in enumerate(self._buckets)}
        tabs = [numpy.array([element.edge_dofs(ref, degree, e) for e in range(len(ref.edge_vertex_ids))])
                for ref, _ids in self._buckets]
        if len({t.shape[1] for t in tabs}) != 1:
            raise NotImplementedError('edges with different dof counts on either side')
        tab = numpy.zeros((len(tabs), max(len(t) for t in tabs), tabs[0].shape[1]), dtype=int)
        for k, t in enumerate(tabs):
            tab[k, :len(t)] = t
        kind = numpy.array([types[type(ref)] for ref in self._refs])
        ie, iedge, je, jedge = interior.T
        di = offsets[ie, None] + tab[kind[ie], iedge]
        dj = offsets[je, None] + tab[kind[je], jedge]
        dofmap, ndofs = merge_index_map(int(offsets[-1]), numpy.stack([di.ravel(), dj.ravel()], axis=1))
        return self._plain_basis(dofmap, coeffs_of, degree, ndofs)

    def basis_discont(self, degree):
        coeffs = [element.bernstein_coeffs(ref, degree) for ref in self._refs]
        counts = [len(c) for c in coeffs]
        offsets = numpy.cumsum([0] + counts)
        dofs = [numpy.arange(offsets[i], offsets[i + 1]) for i in range(len(self._refs))]
        basis = function.PlainBasis(self.space, dofs, coeffs, int(offsets[-1]), ragged=True)
        basis._origin = self
        return basis

    def basis_bubble(self, degree=1):
        '''Linear simplex basis enriched with interior bubbles
        (reference: topology.py:2502 basis_bubble).'''
        assert degree == 1, 'bubble basis is linear-plus-bubble by definition'
        assert all(isinstance(r, element.TriangleReference) for r in self._refs), 'bubble basis: 2-D simplex only'
        d = self.ndims
        K = d + 2
        lin_p = numpy.zeros((3, K, K))
        lin_p[:, :2, :2] = element.bernstein_coeffs(self._refs[0], 1)  # [3, 2, 2]
        bubble = numpy.zeros((K, K))
        # lam0*lam1*lam2 = (1-x-y) x y = xy - x^2 y - x y^2
        bubble[1, 1] += 1.0
        bubble[2, 1] -= 1.0
        bubble[1, 2] -= 1.0
        table = numpy.concatenate([lin_p - bubble[None] / (d + 1), bubble[None]], axis=0)
        verts = self._verts_of(numpy.arange(len(self)))
        dofs = numpy.concatenate([verts, self.nverts + numpy.arange(len(self))[:, None]], axis=1)
        basis = function.PlainBasis(self.space, dofs, numpy.broadcast_to(table, (len(self),) + table.shape),
                                    self.nverts + len(self))
        basis._origin = self
        return basis


class UnstructuredBoundary(Topology):
    '''Boundary edges of an unstructured topology, bucketed by edge type.'''

    def __init__(self, parent, edges, subset=None):
        super().__init__(parent.space, parent.ndims - 1)
        self.parent = parent
        self._edges = list(edges)  # [(ielem, iedge)]
        if subset is not None:
            self._edges = [self._edges[i] for i in subset]

    def __len__(self):
        return len(self._edges)

    def __getitem__(self, item):
        if isinstance(item, numpy.ndarray) and item.dtype == bool:
            return UnstructuredBoundary(self.parent, self._edges, numpy.nonzero(item)[0])
        if isinstance(item, (slice, list, numpy.ndarray)):
            idx = numpy.arange(len(self._edges))[item]
            return UnstructuredBoundary(self.parent, self._edges, idx)
        raise KeyError(item)

    def sample(self, ischeme, degree=None):
        # bucket boundary edges by (parent ref type, edge ref type)
        buckets = {}
        for ielem, iedge in self._edges:
            ref = self.parent._refs[ielem]
            key = (type(ref).__name__, type(ref.edges[iedge][3]).__name__)
            buckets.setdefault(key, []).append((ielem, iedge))
        samples = []
        for key, items in buckets.items():
            pref = self.parent._refs[items[0][0]]
            eref = pref.edges[items[0][1]][3]
            tri_local = hull_local = None
            if ischeme == 'gauss':
                pts, wts = eref.gauss(degree)
            elif ischeme == 'bezier':
                pts, tri_local, hull_local = eref.bezier(degree)
                wts = None
            elif ischeme == '_centroid':
                pts = eref.vertices.mean(0, keepdims=True)
                wts = None
            elif ischeme == 'uniform':
                pts, wts = eref.uniform(degree or 1)
            else:
                raise ValueError(f'unknown sample scheme {ischeme!r}')
            E, P = len(items), len(pts)
            d = self.parent.ndims
            coords = numpy.empty((E, P, d))
            tangents = numpy.empty((E, d, d - 1))
            normals = numpy.empty((E, d))
            index = numpy.empty(E, dtype=int)
            for k, (ielem, iedge) in enumerate(items):
                lin, off, nrm, _ = self.parent._refs[ielem].edges[iedge]
                coords[k] = pts @ lin.T + off
                tangents[k] = lin
                normals[k] = nrm
                index[k] = ielem
            coords, p_linear, p_offset, tangents, normals, lineage = \
                _frame_arrays(self.parent, index, coords, tangents, normals)
            samples.append(_sample.Sample(self.parent.space, coords,
                                          None if wts is None else numpy.broadcast_to(wts, (E, P)).copy(),
                                          index, p_linear, p_offset, tangents, normals, tri_local, hull_local,
                                          part_ids=numpy.zeros(E, dtype=int), part_topos=[self],
                                          batch_key=key, origin_topo=self.parent, lineage=lineage))
        if len(samples) == 1:
            return samples[0]
        return _sample.ChainedSample(samples)

    def basis(self, btype='std', degree=1, **kwargs):
        return self.parent.basis(btype, degree, **kwargs)


class UnstructuredSubsetTopology(Topology):
    '''Whole-element subset view of an :class:`UnstructuredTopology`.

    Samples keep the parent's element numbering, so bases and geometries of
    the parent evaluate directly on subset samples; the subset's boundary is
    recomputed by edge matching *within the selection* and therefore includes
    interface edges against the rest of the mesh (the reference's
    SubsetTopology boundary semantics, topology.py:2615,2665).
    '''

    def __init__(self, parent, ielems):
        if isinstance(parent, UnstructuredSubsetTopology):
            ielems = parent._ielems[numpy.asarray(ielems, dtype=int)]
            parent = parent.parent
        super().__init__(parent.space, parent.ndims)
        self.parent = parent
        self._ielems = numpy.unique(numpy.asarray(ielems, dtype=int))

    def __len__(self):
        return len(self._ielems)

    @functools.cached_property
    def _buckets(self):
        buckets = {}
        for gi in self._ielems:
            ref = self.parent._refs[gi]
            buckets.setdefault(type(ref).__name__, (ref, []))[1].append(int(gi))
        return [(ref, numpy.asarray(ids)) for ref, ids in buckets.values()]

    def sample(self, ischeme, degree=None):
        return self.parent._sample_elements(self._buckets, ischeme, degree, self)

    def basis(self, btype='std', degree=1, **kwargs):
        '''Parent basis restricted to the dofs supported on this subset
        (reference: the PrunedBasis a subset topology's basis() returns,
        topology.py:2615 via function.py:3103).'''
        parent_basis = self.parent.basis(btype, degree, **kwargs)
        pruned = function.PrunedBasis(parent_basis, self._ielems)
        pruned._origin = parent_basis._origin
        return pruned

    def take(self, ielems):
        return UnstructuredSubsetTopology(self, ielems)

    @functools.cached_property
    def boundary(self):
        edge_owner = {}
        for gi in self._ielems:
            ref = self.parent._refs[gi]
            verts = self.parent._elem_verts[gi]
            for iedge, ev_ in enumerate(ref.edge_vertex_ids):
                key = tuple(sorted(verts[list(ev_)].tolist()))
                if key in edge_owner:
                    edge_owner.pop(key)
                else:
                    edge_owner[key] = (int(gi), iedge)
        return UnstructuredBoundary(self.parent, sorted(edge_owner.values()))


class UnstructuredInterfaces(Topology):
    '''Interior inter-element faces of an unstructured topology with
    two-sided samples: each face evaluates functions on its owning element,
    and carries an ``opposite`` sample bound to the neighbor so
    ``function.opposite``/jump/mean switch sides (reference: topology.py:2422
    ConnectedTopology.interfaces with opposite transform chains).

    Point pairing across sides goes through vertex interpolation weights
    (element.corner_weights): a quadrature point on the shared face is
    expressed in the weights of the face's corner vertices, and each side
    rebuilds its element-local coordinates from its own local positions of
    the *same global vertices* — exact for affine/multilinear face
    correspondences, which is the conforming-mesh case.  The interface normal
    points out of the first (owning) side.'''

    def __init__(self, parent, pairs):
        super().__init__(parent.space, parent.ndims - 1)
        self.parent = parent
        self._pairs = list(pairs)  # [(ielem, iedge, jelem, jedge)]

    def __len__(self):
        return len(self._pairs)

    def sample(self, ischeme, degree=None):
        par = self.parent
        d = par.ndims
        buckets = {}
        for pair in self._pairs:
            ref = par._refs[pair[0]]
            eref = ref.edges[pair[1]][3]
            key = (type(par._refs[pair[0]]).__name__, type(par._refs[pair[2]]).__name__,
                   type(eref).__name__)
            buckets.setdefault(key, (eref, []))[1].append(pair)
        samples = []
        for key, (eref, items) in buckets.items():
            tri_local = hull_local = None
            if ischeme == 'gauss':
                assert degree is not None
                pts, wts = eref.gauss(degree)
            elif ischeme == 'bezier':
                pts, tri_local, hull_local = eref.bezier(degree)
                wts = None
            elif ischeme == '_centroid':
                pts = eref.vertices.mean(0, keepdims=True)
                wts = None
            elif ischeme == 'uniform':
                pts, wts = eref.uniform(degree or 1)
            else:
                raise ValueError(f'unknown interface scheme {ischeme!r}')
            P = len(pts)
            W = element.corner_weights(eref, pts)                 # [P, nv]
            center = eref.vertices.mean(0)
            dt = eref.ndims
            # affine tangent weights: centered differences at the face center
            Wt = numpy.stack([
                element.corner_weights(eref, (center + 0.5 * numpy.eye(dt)[t])[None])[0]
                - element.corner_weights(eref, (center - 0.5 * numpy.eye(dt)[t])[None])[0]
                for t in range(dt)])                              # [dt, nv]
            E = len(items)
            sides = []
            for side in range(2):
                coords = numpy.empty((E, P, d))
                tangents = numpy.empty((E, d, dt))
                normals = numpy.empty((E, d))
                index = numpy.empty(E, dtype=int)
                sides.append(dict(coords=coords, tangents=tangents, normals=normals, index=index))
            for k, (ielem, iedge, jelem, jedge) in enumerate(items):
                refi, refj = par._refs[ielem], par._refs[jelem]
                evi = list(refi.edge_vertex_ids[iedge])
                evj = list(refj.edge_vertex_ids[jedge])
                gv_i = par._elem_verts[ielem][evi]
                gv_j = par._elem_verts[jelem][evj]
                # position of each side-i corner among side-j's corners
                posmap = [int(numpy.nonzero(gv_j == g)[0][0]) for g in gv_i]
                pos_i = refi.vertices[evi]                        # [nv, d]
                pos_j = refj.vertices[[evj[m] for m in posmap]]   # [nv, d]
                for side, (elem, pos, edge) in enumerate((
                        (ielem, pos_i, refi.edges[iedge]),
                        (jelem, pos_j, refj.edges[jedge]))):
                    sides[side]['coords'][k] = W @ pos
                    sides[side]['tangents'][k] = (Wt @ pos).T
                    sides[side]['normals'][k] = edge[2]
                    sides[side]['index'][k] = elem
            built = []
            for side in (1, 0):
                q = sides[side]
                coords, p_linear, p_offset, tangents, normals, lineage = \
                    _frame_arrays(par, q['index'], q['coords'], q['tangents'], q['normals'])
                built.append(_sample.Sample(
                    par.space, coords,
                    None if (wts is None or side == 1) else numpy.broadcast_to(wts, (E, P)).copy(),
                    q['index'], p_linear, p_offset, tangents, normals, tri_local, hull_local,
                    opposite=built[0] if side == 0 else None,
                    part_ids=numpy.zeros(E, dtype=int), part_topos=[self],
                    batch_key=('iface',) + key, origin_topo=par, lineage=lineage))
            samples.append(built[1])
        if len(samples) == 1:
            return samples[0]
        return _sample.ChainedSample(samples)

    def basis(self, btype='std', degree=1, **kwargs):
        return self.parent.basis(btype, degree, **kwargs)


class _VertexTopology(Topology):
    '''0-d topology of one mesh vertex (reference: gmsh physical points
    exposed as topo.points[name], mesh.py:300).  Sampling yields a single
    point with unit weight in an element containing the vertex; tangents span
    the full parent dimension so functions of the parent space (including
    jacobians of volume geometries) evaluate cleanly.'''

    def __init__(self, parent, vertex_id):
        super().__init__(parent.space, 0)
        self.parent = parent
        self.vertex_id = int(vertex_id)
        for ielem, verts in enumerate(parent._elem_verts):
            hit = numpy.nonzero(numpy.asarray(verts) == self.vertex_id)[0]
            if len(hit):
                self._ielem = ielem
                self._local = parent._refs[ielem].vertices[int(hit[0])]
                break
        else:
            raise ValueError(f'vertex {vertex_id} not referenced by any element')

    def __len__(self):
        return 1

    def sample(self, ischeme, degree=None):
        d = self.parent.ndims
        coords = numpy.asarray(self._local, dtype=float).reshape(1, 1, d)
        weights = numpy.ones((1, 1))
        p_linear = numpy.eye(d)[None]
        p_offset = numpy.zeros((1, d))
        tangents = numpy.eye(d)[None]
        return _sample.Sample(self.space, coords, weights, numpy.array([self._ielem]),
                              p_linear, p_offset, tangents, origin_topo=self.parent,
                              part_ids=numpy.zeros(1, dtype=int), part_topos=[self],
                              batch_key=('vertex', type(self.parent._refs[self._ielem]).__name__))
