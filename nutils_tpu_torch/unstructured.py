'''Unstructured topologies: simplex and mixed-element meshes.

The part of ``nutils_tpu.unstructured`` that the triangle slice reaches
(reference: topology.py:2437,2422 SimplexTopology/ConnectedTopology):
per-element vertex tables plus edge-matching connectivity, elements grouped
into uniform *buckets* by reference type so every bucket lowers to statically
shaped batched arrays, and samples over mixed meshes as chains of per-bucket
samples.  The dof numbering is the JAX package's, dof for dof; the edge
matching and the C0 dof merge are vectorised (numpy sorts and a connected-
components pass) where the JAX package loops over elements in Python.

Point location, refinement, interfaces, element subsets and the bubble basis
are ROADMAP A6.

>>> import numpy
>>> from nutils_tpu_torch import mesh, function
>>> topo, geom = mesh.unitsquare(2, 'triangle')
>>> len(topo)
8
>>> topo.basis('std', degree=1).ndofs
9
'''

import functools

import numpy

from . import element, function, sample as _sample
from .topology import Topology


def merge_index_map(nin, pairs):
    '''Index merge with minimal representatives, condensed by first
    appearance (reference semantics: _util.py:759 merge_index_map): indices
    joined by the [m, 2] array of ``pairs``, directly or through others, map
    to one number, and the numbers count up in the order of each group's
    smallest index.  Returns (index map, number of groups).'''
    import scipy.sparse
    import scipy.sparse.csgraph
    graph = scipy.sparse.coo_matrix((numpy.ones(len(pairs), dtype=numpy.int8), (pairs[:, 0], pairs[:, 1])),
                                    shape=(nin, nin))
    ngroups, labels = scipy.sparse.csgraph.connected_components(graph, directed=False)
    # each group's representative is its smallest index; numbering by first
    # appearance is numbering by that index
    first = numpy.full(ngroups, nin, dtype=numpy.int64)
    numpy.minimum.at(first, labels, numpy.arange(nin))
    rank = numpy.empty(ngroups, dtype=int)
    rank[numpy.argsort(first)] = numpy.arange(ngroups)
    return rank[labels], int(ngroups)


def _frame_arrays(topo, ids, coords, tangents, normal_root=None):
    '''Element-local sample arrays as chart arrays: (coords [E,P,d],
    p_linear, p_offset, tangents, normal_root, lineage).  The port has base
    topologies only, whose chart is the element itself (refinement families
    are ROADMAP A6).'''
    E = len(ids)
    d = coords.shape[-1]
    return coords, numpy.broadcast_to(numpy.eye(d), (E, d, d)), numpy.zeros((E, d)), tangents, normal_root, None


def _not_ported(what):
    return NotImplementedError(f'{what} of unstructured topologies is not ported yet (ROADMAP A6)')


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

    @property
    def interfaces(self):
        raise _not_ported('interfaces')

    @property
    def refined(self):
        raise _not_ported('refinement')

    def locate(self, geom, coords, **kwargs):
        raise _not_ported('point location')

    def take(self, ielems):
        raise _not_ported('element subsets')

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

    def basis_bubble(self, degree=1):
        raise _not_ported('the bubble basis')


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
