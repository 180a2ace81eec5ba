'''Reference elements: quadrature dispatch and bezier (visualization) points.

The counterpart of the reference's element/points layer (copied from
``nutils_tpu.element``)
(reference: element.py, points.py): reference elements produce *tables* —
quadrature coordinates/weights, uniform bezier grids with local
triangulations, edge affine maps with outward normals — that the topology
layer assembles into batched sample arrays.  No per-element objects exist at
evaluation time.

>>> import numpy
>>> from nutils_tpu_torch import element
>>> quad = element.hypercube(2)
>>> pts, wts = quad.gauss(3)
>>> float(wts.sum())
1.0±1e-14
>>> len(quad.edges)   # four edges, each an affine map + outward normal
4
>>> tri = element.simplex(2)
>>> float(tri.gauss(1)[1].sum())   # reference triangle area
0.5±1e-14
'''

import functools

import numpy

from .ops import quadrature


class Reference:

    ndims = None

    def gauss(self, degree):
        raise NotImplementedError

    def bezier(self, n):
        '''Uniform sample grid: (coords [P, d], tri [nt, d+1], hull [nh, d]).'''
        raise NotImplementedError

    def uniform(self, n):
        '''Cell-midpoint sample: (coords [P, d], weights [P]) with the weights
        summing to the reference volume (reference: element.py:495,516 uniform
        ischeme, points.py:134 CoordsUniformPoints).'''
        raise NotImplementedError(f'uniform scheme not available on {self!r}')

    @property
    def edges(self):
        '''List of (linear [d, d-1], offset [d], normal [d], edge_reference).'''
        raise NotImplementedError

    @property
    def nverts(self):
        return len(self.vertices)

    def __repr__(self):
        return type(self).__name__


class PointReference(Reference):

    ndims = 0
    vertices = numpy.zeros((1, 0))
    volume = 1.0

    def gauss(self, degree):
        return numpy.zeros((1, 0)), numpy.ones(1)

    def bezier(self, n):
        return numpy.zeros((1, 0)), numpy.zeros((1, 1), dtype=int), numpy.zeros((0, 0), dtype=int)

    def uniform(self, n):
        return numpy.zeros((1, 0)), numpy.ones(1)


class LineReference(Reference):

    ndims = 1
    vertices = numpy.array([[0.0], [1.0]])
    volume = 1.0
    # edge i is the facet opposite vertex i (reference: element.py:413
    # SimplexReference.edge_vertices): edge 0 at x=1, edge 1 at x=0
    edge_vertex_ids = ((1,), (0,))

    def gauss(self, degree):
        return quadrature.line(degree)

    def uniform(self, n):
        return (numpy.arange(n)[:, None] + 0.5) / n, numpy.full(n, 1.0 / n)

    def bezier(self, n):
        coords = numpy.linspace(0, 1, n)[:, None]
        tri = numpy.stack([numpy.arange(n - 1), numpy.arange(1, n)], axis=1)
        hull = numpy.array([[0], [n - 1]])
        return coords, tri, hull

    @property
    def edges(self):
        e = numpy.zeros((1, 0))
        return [
            (e.copy(), numpy.array([1.0]), numpy.array([1.0]), PointReference()),
            (e.copy(), numpy.array([0.0]), numpy.array([-1.0]), PointReference()),
        ]


class QuadReference(Reference):
    '''Unit square [0,1]^2 (tensor product of lines).'''

    ndims = 2
    vertices = numpy.array([[0, 0], [0, 1], [1, 0], [1, 1]], dtype=float)
    volume = 1.0

    def gauss(self, degree):
        return quadrature.tensor(degree, 2)

    def uniform(self, n):
        x = (numpy.arange(n) + 0.5) / n
        pts = numpy.stack(numpy.meshgrid(x, x, indexing='ij'), axis=-1).reshape(-1, 2)
        return pts, numpy.full(len(pts), 1.0 / len(pts))

    def bezier(self, n):
        x = numpy.linspace(0, 1, n)
        coords = numpy.stack(numpy.meshgrid(x, x, indexing='ij'), axis=-1).reshape(-1, 2)  # C-order: i0 slow
        tris = []
        for i in range(n - 1):
            for j in range(n - 1):
                v00 = i * n + j
                v01 = i * n + j + 1
                v10 = (i + 1) * n + j
                v11 = (i + 1) * n + j + 1
                tris.append([v00, v01, v10])
                tris.append([v11, v10, v01])
        hull = []
        for k in range(n - 1):
            hull.append([k, k + 1])                          # j edge at i=0
            hull.append([(n - 1) * n + k, (n - 1) * n + k + 1])  # i=n-1
            hull.append([k * n, (k + 1) * n])                # j=0
            hull.append([k * n + n - 1, (k + 1) * n + n - 1])  # j=n-1
        return coords, numpy.asarray(tris), numpy.asarray(hull)

    # tensor edge order (reference: element.py:739 TensorReference): ref1's
    # edges first; line edge 0 is the high side.  Edges: x0=1, x0=0, x1=1, x1=0.
    # Vertex numbering is C-order over (x0, x1): v = 2*i0 + i1.
    edge_vertex_ids = ((2, 3), (0, 1), (1, 3), (0, 2))

    @property
    def edges(self):
        line = LineReference()
        c0 = numpy.array([[0.0], [1.0]])  # edge coord maps to dim 1
        c1 = numpy.array([[1.0], [0.0]])  # edge coord maps to dim 0
        return [
            (c0, numpy.array([1.0, 0.0]), numpy.array([1.0, 0.0]), line),
            (c0, numpy.array([0.0, 0.0]), numpy.array([-1.0, 0.0]), line),
            (c1, numpy.array([0.0, 1.0]), numpy.array([0.0, 1.0]), line),
            (c1, numpy.array([0.0, 0.0]), numpy.array([0.0, -1.0]), line),
        ]


class HexReference(Reference):

    ndims = 3
    volume = 1.0
    vertices = numpy.stack(numpy.meshgrid(*[[0.0, 1.0]] * 3, indexing='ij'), axis=-1).reshape(-1, 3)
    # faces in the order of the ``edges`` property (idim-major, low side
    # first); vertex v = 4*i0 + 2*i1 + i2, face corners listed in the quad
    # edge-reference's vertex order (see edge_vertex_ids invariant on Tet)
    edge_vertex_ids = ((0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 4, 5), (2, 3, 6, 7), (0, 2, 4, 6), (1, 3, 5, 7))

    def gauss(self, degree):
        return quadrature.tensor(degree, 3)

    def uniform(self, n):
        x = (numpy.arange(n) + 0.5) / n
        pts = numpy.stack(numpy.meshgrid(x, x, x, indexing='ij'), axis=-1).reshape(-1, 3)
        return pts, numpy.full(len(pts), 1.0 / len(pts))

    def bezier(self, n):
        x = numpy.linspace(0, 1, n)
        coords = numpy.stack(numpy.meshgrid(x, x, x, indexing='ij'), axis=-1).reshape(-1, 3)

        def vid(i, j, k):
            return (i * n + j) * n + k
        tets = []
        for i in range(n - 1):
            for j in range(n - 1):
                for k in range(n - 1):
                    # split each cell into 6 tets (Kuhn triangulation)
                    v = [vid(i + a, j + b, k + c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]
                    for perm in ((0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7), (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7)):
                        tets.append([v[p] for p in perm])
        hull = []
        for a in range(n - 1):
            for b in range(n - 1):
                for fixed, side in ((0, 0), (0, n - 1), (1, 0), (1, n - 1), (2, 0), (2, n - 1)):
                    if fixed == 0:
                        q = [vid(side, a, b), vid(side, a + 1, b), vid(side, a, b + 1), vid(side, a + 1, b + 1)]
                    elif fixed == 1:
                        q = [vid(a, side, b), vid(a + 1, side, b), vid(a, side, b + 1), vid(a + 1, side, b + 1)]
                    else:
                        q = [vid(a, b, side), vid(a + 1, b, side), vid(a, b + 1, side), vid(a + 1, b + 1, side)]
                    hull.append([q[0], q[1], q[3]])
                    hull.append([q[0], q[3], q[2]])
        return coords, numpy.asarray(tets), numpy.asarray(hull)

    @property
    def edges(self):
        quad = QuadReference()
        out = []
        for idim in range(3):
            other = [d for d in range(3) if d != idim]
            lin = numpy.zeros((3, 2))
            lin[other[0], 0] = 1.0
            lin[other[1], 1] = 1.0
            for side in (0.0, 1.0):
                off = numpy.zeros(3)
                off[idim] = side
                nrm = numpy.zeros(3)
                nrm[idim] = -1.0 if side == 0.0 else 1.0
                out.append((lin.copy(), off, nrm, quad))
        return out


class TriangleReference(Reference):
    '''Unit triangle {x, y >= 0, x + y <= 1}.'''

    ndims = 2
    vertices = numpy.array([[0, 0], [1, 0], [0, 1]], dtype=float)
    volume = 0.5

    def gauss(self, degree):
        return quadrature.triangle(degree)

    def uniform(self, n):
        # lattice of cell points at (i + 1/3)/n, points beyond the diagonal
        # folded back — n^2 points, each the centroid of one subtriangle of
        # the regular n^2 subdivision (reference: element.py:516)
        p = (numpy.arange(n) + 1.0 / 3.0) / n
        pts = numpy.stack(numpy.meshgrid(p, p, indexing='ij'), axis=-1).reshape(-1, 2)
        flip = pts.sum(1) > 1
        pts[flip] = 1 - pts[flip][:, ::-1]
        return pts, numpy.full(len(pts), self.volume / len(pts))

    def bezier(self, n):
        coords = []
        idx = {}
        for i in range(n):
            for j in range(n - i):
                idx[i, j] = len(coords)
                coords.append([i / (n - 1), j / (n - 1)])
        tris = []
        for i in range(n - 1):
            for j in range(n - 1 - i):
                tris.append([idx[i, j], idx[i + 1, j], idx[i, j + 1]])
                if j < n - 2 - i:
                    tris.append([idx[i + 1, j], idx[i + 1, j + 1], idx[i, j + 1]])
        hull = []
        for k in range(n - 1):
            hull.append([idx[k, 0], idx[k + 1, 0]])
            hull.append([idx[0, k], idx[0, k + 1]])
            hull.append([idx[k, n - 1 - k], idx[k + 1, n - 2 - k]])
        return numpy.asarray(coords, dtype=float), numpy.asarray(tris), numpy.asarray(hull)

    # edge i is opposite vertex i: e0 = (v1,v2) hypotenuse, e1 = (v0,v2)
    # left side, e2 = (v0,v1) bottom (reference: element.py:413)
    edge_vertex_ids = ((1, 2), (0, 2), (0, 1))

    @property
    def edges(self):
        line = LineReference()
        s = numpy.sqrt(0.5)
        return [
            (numpy.array([[-1.0], [1.0]]), numpy.array([1.0, 0.0]), numpy.array([s, s]), line),
            (numpy.array([[0.0], [1.0]]), numpy.array([0.0, 0.0]), numpy.array([-1.0, 0.0]), line),
            (numpy.array([[1.0], [0.0]]), numpy.array([0.0, 0.0]), numpy.array([0.0, -1.0]), line),
        ]


class TetReference(Reference):

    ndims = 3
    vertices = numpy.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float)
    volume = 1.0 / 6.0
    # edge_vertex_ids[k][j] is the element vertex sitting at edge-reference
    # vertex j under the k-th edge map (the invariant all references obey;
    # used by unstructured edge matching and interface point pairing)
    edge_vertex_ids = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))

    def gauss(self, degree):
        return quadrature.tetrahedron(degree)

    def bezier(self, n):
        coords = []
        idx = {}
        for i in range(n):
            for j in range(n - i):
                for k in range(n - i - j):
                    idx[i, j, k] = len(coords)
                    coords.append([i / (n - 1), j / (n - 1), k / (n - 1)])
        pts = numpy.asarray(coords, dtype=float)
        if n == 2:
            tets = numpy.asarray([[idx[0, 0, 0], idx[1, 0, 0], idx[0, 1, 0], idx[0, 0, 1]]], dtype=int)
        else:
            # lattice triangulation via Delaunay, degenerate slivers dropped;
            # covers the full reference volume (reference analogue:
            # points.py SimplexBezierPoints.tri)
            from scipy.spatial import Delaunay
            cand = Delaunay(pts).simplices
            vols = numpy.linalg.det(pts[cand[:, 1:]] - pts[cand[:, :1]])
            tets = cand[numpy.abs(vols) > 1e-12 / n**3]
        # hull: each face carries the triangle-lattice triangulation, mapped
        # through the edge transform into the volume lattice
        fpts, ftri, _ = TriangleReference().bezier(n)
        hull = []
        for lin, off, _nrm, _eref in self.edges:
            fc = fpts @ lin.T + off
            fidx = numpy.asarray([idx[tuple(numpy.round(c * (n - 1)).astype(int))] for c in fc])
            hull.extend(fidx[t] for t in ftri)
        return pts, tets, numpy.asarray(hull, dtype=int).reshape(-1, 3)

    @property
    def edges(self):
        tri = TriangleReference()
        s = 1 / numpy.sqrt(3)
        return [
            (numpy.array([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]]), numpy.zeros(3), numpy.array([0.0, 0.0, -1.0]), tri),
            (numpy.array([[1.0, 0.0], [0.0, 0.0], [0.0, 1.0]]), numpy.zeros(3), numpy.array([0.0, -1.0, 0.0]), tri),
            (numpy.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]), numpy.zeros(3), numpy.array([-1.0, 0.0, 0.0]), tri),
            (numpy.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]]), numpy.array([1.0, 0.0, 0.0]), numpy.array([s, s, s]), tri),
        ]


@functools.cache
def hypercube(ndims):
    return [PointReference(), LineReference(), QuadReference(), HexReference()][ndims]


@functools.cache
def simplex(ndims):
    return [PointReference(), LineReference(), TriangleReference(), TetReference()][ndims]


# ------------------------------------------------------------- C0 bases

import itertools as _itertools
import math as _math


def _barycentric_powers(ndims, degree):
    """Local dof enumeration of simplex Bernstein bases: barycentric power
    tuples in the reference's canonical order (reference: element.py:1129
    _integer_barycentric_coordinates)."""
    return tuple((degree - sum(i), *i[::-1])
                 for i in _itertools.product(*[range(degree + 1)] * ndims)
                 if sum(i) <= degree)


def _simplex_bernstein(ndims, degree):
    """[ndofs, (degree+1),..d..] power-basis coefficients of the simplex
    Bernstein polynomials B_p = multinom * lam0^p0 * x1^p1 * ... with
    lam0 = 1 - sum(x)."""
    K = degree + 1
    powers = _barycentric_powers(ndims, degree)
    out = numpy.zeros((len(powers),) + (K,) * ndims)
    for idof, p in enumerate(powers):
        p0, prest = p[0], p[1:]
        scale = _math.factorial(degree)
        for q in p:
            scale //= _math.factorial(q)
        # expand (1 - x1 - ... - xd)^p0 multinomially
        base = numpy.zeros((K,) * ndims)
        for ks in _itertools.product(*[range(p0 + 1)] * ndims):
            if sum(ks) > p0:
                continue
            rem = p0 - sum(ks)
            c = _math.factorial(p0) * (-1) ** sum(ks)
            c //= _math.factorial(rem)
            for k in ks:
                c //= _math.factorial(k)
            base[ks] += c
        term = numpy.zeros((K,) * ndims)
        idx = tuple(prest)
        shifted = numpy.zeros((K,) * ndims)
        sl = tuple(slice(q, None) for q in prest)
        src = tuple(slice(None, K - q) for q in prest)
        shifted[sl] = base[src]
        out[idof] = scale * shifted
    return out


def _simplex_lagrange(ndims, degree):
    """[ndofs, (degree+1),..d..] power-basis coefficients of the simplex
    Lagrange polynomials, nodal at the degree-n barycentric lattice, in the
    same dof enumeration as the Bernstein tables (the node of dof p sits at
    p[1:]/degree in coefficient-axis order), so ``edge_dofs`` and the C0
    merge apply unchanged."""
    from fractions import Fraction
    K = degree + 1
    powers = _barycentric_powers(ndims, degree)
    nodes = [[Fraction(q, max(degree, 1)) for q in p[1:]] for p in powers]
    exps = [ks for ks in _itertools.product(*[range(K)] * ndims) if sum(ks) <= degree]
    n = len(powers)
    # exact rational inverse of the Vandermonde: dyadic coefficients (every
    # lagrange table through degree 4 has power-of-two-times-integer entries)
    # convert to float losslessly, so basis functions vanish EXACTLY at the
    # nodes/faces they should — solve_constraints' droptol and boundary-trace
    # detection depend on exact zeros (a float inv() leaves ~1e-15 residue)
    aug = [[_math.prod(x ** e for x, e in zip(nodes[j], ks)) for ks in exps]
           + [Fraction(int(i == j)) for i in range(n)] for j in range(n)]
    for col in range(n):
        piv = max(range(col, n), key=lambda r: abs(aug[r][col]))
        aug[col], aug[piv] = aug[piv], aug[col]
        inv_p = 1 / aug[col][col]
        aug[col] = [v * inv_p for v in aug[col]]
        for r in range(n):
            if r != col and aug[r][col]:
                f = aug[r][col]
                aug[r] = [a - f * b for a, b in zip(aug[r], aug[col])]
    # inverse rows are by monomial k; lagrange function i's coefficient of
    # monomial k is inv[k][i]
    out = numpy.zeros((n,) + (K,) * ndims)
    for k, ks in enumerate(exps):
        out[(slice(None), *ks)] = [float(aug[k][n + i]) for i in range(n)]
    return out


def lagrange_coeffs(ref, degree):
    """Nodal (equispaced-lattice) Lagrange basis tables, same layout and dof
    order as ``bernstein_coeffs`` (reference: element.py
    get_poly_coeffs('lagrange'), topology.py:1801 basis_lagrange).  The
    table depends on the reference type and degree only: it is computed once
    for each and returned read-only."""
    return _lagrange_table(type(ref), int(degree))


@functools.lru_cache(maxsize=None)
def _lagrange_table(reftype, degree):
    table = _lagrange_of(reftype(), degree)
    table.flags.writeable = False
    return table


def _lagrange_of(ref, degree):
    if isinstance(ref, (LineReference, TriangleReference, TetReference)):
        return _simplex_lagrange(ref.ndims, degree)
    if isinstance(ref, QuadReference):
        c1 = _simplex_lagrange(1, degree)
        K = degree + 1
        return (c1[:, None, :, None] * c1[None, :, None, :]).reshape(K * K, K, K)
    if isinstance(ref, HexReference):
        c1 = _simplex_lagrange(1, degree)
        K = degree + 1
        out = numpy.einsum('ap,bq,cr->abcpqr', c1, c1, c1)
        return out.reshape(K ** 3, K, K, K)
    raise NotImplementedError(type(ref))


def bernstein_coeffs(ref, degree):
    """Per-reference Bernstein basis tables in tensor power layout, local dof
    order matching the reference (simplex: barycentric enumeration; tensor:
    C-order products).  The table depends on the reference type and degree
    only: it is computed once for each and returned read-only."""
    return _bernstein_table(type(ref), int(degree))


@functools.lru_cache(maxsize=None)
def _bernstein_table(reftype, degree):
    table = _bernstein_of(reftype(), degree)
    table.flags.writeable = False
    return table


def _bernstein_of(ref, degree):
    if isinstance(ref, (LineReference, TriangleReference, TetReference)):
        return _simplex_bernstein(ref.ndims, degree)
    if isinstance(ref, QuadReference):
        c1 = _simplex_bernstein(1, degree)  # [d+1, K]
        K = degree + 1
        return (c1[:, None, :, None] * c1[None, :, None, :]).reshape(K * K, K, K)
    if isinstance(ref, HexReference):
        c1 = _simplex_bernstein(1, degree)
        K = degree + 1
        out = numpy.einsum('ap,bq,cr->abcpqr', c1, c1, c1)
        return out.reshape(K ** 3, K, K, K)
    raise NotImplementedError(type(ref))


# ------------------------------------------------------------- refinement

def children(ref):
    """Per-child affine maps (linear [d, d], offset [d]) from child-local to
    parent-local coordinates, following the reference's subdivision
    conventions (reference: transform.py:309 SimplexChild, element.py:719
    TensorReference.child_transforms: line children low/high, hypercube
    children in C-order over axes, simplex children = corners + inverted
    interior cells)."""
    d = ref.ndims
    if isinstance(ref, (LineReference, QuadReference, HexReference)):
        out = []
        for offs in _itertools.product([0.0, 0.5], repeat=d):
            out.append((numpy.eye(d) * 0.5, numpy.array(offs)))
        return out
    if isinstance(ref, TriangleReference):
        I = numpy.eye(2) * 0.5
        return [
            (I.copy(), numpy.array([0.0, 0.0])),
            (I.copy(), numpy.array([0.5, 0.0])),
            (I.copy(), numpy.array([0.0, 0.5])),
            (numpy.array([[-0.5, 0.0], [0.5, 0.5]]), numpy.array([0.5, 0.0])),
        ]
    if isinstance(ref, TetReference):
        I = numpy.eye(3) * 0.5
        out = [(I.copy(), numpy.zeros(3))]
        for i in range(3):
            out.append((I.copy(), I[i].copy()))
        out.append((numpy.array([[-.5, 0, -.5], [.5, .5, 0], [0, 0, .5]]), numpy.array([.5, 0, 0])))
        out.append((numpy.array([[0, -.5, 0], [.5, 0, 0], [0, .5, .5]]), numpy.array([.5, 0, 0])))
        out.append((numpy.array([[.5, 0, 0], [0, -.5, 0], [0, .5, .5]]), numpy.array([0, .5, 0])))
        out.append((numpy.array([[-.5, 0, -.5], [-.5, -.5, 0], [.5, .5, .5]]), numpy.array([.5, .5, 0])))
        return out
    raise NotImplementedError(type(ref))


def child_edge_map(ref):
    """child_edge_map(ref)[ichild][iedge] = parent edge index the child's edge
    lies on, or -1 if interior to the parent (the analogue of the reference's
    Reference.connectivity boundary recovery, element.py:126)."""
    if isinstance(ref, TriangleReference):
        return [[-1, 1, 2], [0, -1, 2], [0, 1, -1], [-1, -1, -1]]
    if isinstance(ref, (LineReference, QuadReference, HexReference)):
        d = ref.ndims
        # map (idim, side) -> parent edge index via edge normals
        byside = {}
        for k, (_lin, _off, nrm, _eref) in enumerate(ref.edges):
            idim = int(numpy.argmax(numpy.abs(nrm)))
            byside[idim, int(nrm[idim] > 0)] = k
        out = []
        for offs in _itertools.product([0, 1], repeat=d):
            row = [-1] * len(ref.edges)
            for k, (_lin, _off, nrm, _eref) in enumerate(ref.edges):
                idim = int(numpy.argmax(numpy.abs(nrm)))
                side = int(nrm[idim] > 0)
                if offs[idim] == side:
                    row[k] = byside[idim, side]
            out.append(row)
        return out
    raise NotImplementedError(type(ref))


def child_vert_keys(ref):
    """Per-child local vertex identities in the parent's terms, for building
    refined unstructured meshes: ('v', i) = parent vertex i, ('e', i, j) =
    midpoint of parent vertices i < j, ('c',) = parent center."""
    if isinstance(ref, TriangleReference):
        v = lambda i: ('v', i)
        e = lambda i, j: ('e', i, j)
        return [
            [v(0), e(0, 1), e(0, 2)],
            [e(0, 1), v(1), e(1, 2)],
            [e(0, 2), e(1, 2), v(2)],
            [e(0, 1), e(0, 2), e(1, 2)],
        ]
    if isinstance(ref, QuadReference):
        # parent vertex id at (a, b) in {0,1}^2 is 2*a + b (C-order)
        def key(x, y):
            fx, fy = x in (0.0, 1.0), y in (0.0, 1.0)
            if fx and fy:
                return ('v', int(2 * x + y))
            if fx:  # vertical edge x fixed
                return ('e', int(2 * x + 0), int(2 * x + 1))
            if fy:
                return ('e', int(0 + y), int(2 + y))
            return ('c',)
        out = []
        for i0, i1 in _itertools.product([0, 1], repeat=2):
            verts = []
            for a, b in ((0, 0), (0, 1), (1, 0), (1, 1)):
                verts.append(key((i0 + a) / 2, (i1 + b) / 2))
            out.append(verts)
        return out
    raise NotImplementedError(type(ref))


# ------------------------------------------------------- polynomial algebra

def _poly_mul(a, b, K):
    """Multiply two tensor power-basis coefficient arrays (shape (Ka,)*d and
    (Kb,)*d), truncating to (K,)*d; truncated coefficients must vanish."""
    d = a.ndim
    out = numpy.zeros((a.shape[0] + b.shape[0] - 1,) * d)
    for ks in _itertools.product(*[range(n) for n in b.shape]):
        c = b[ks]
        if c == 0.0:
            continue
        sl = tuple(slice(k, k + a.shape[0]) for k in ks)
        out[sl] += c * a
    if out.shape[0] > K:
        keep = tuple(slice(None, K) for _ in range(d))
        rest = out.copy()
        rest[keep] = 0.0
        assert numpy.abs(rest).max() < 1e-9, 'affine substitution overflowed the coefficient box'
        out = out[keep]
    elif out.shape[0] < K:
        pad = numpy.zeros((K,) * d)
        pad[tuple(slice(None, out.shape[0]) for _ in range(d))] = out
        out = pad
    return out


_compose_cache = {}


def compose_affine_poly(coeffs, lin, off):
    """Coefficients of p(lin @ y + off) given coefficients of p(x), both in
    tensor power layout [..., K, ..d.., K] (the analogue of the reference's
    transform_poly, transform.py:100)."""
    coeffs = numpy.asarray(coeffs, dtype=float)
    lin = numpy.asarray(lin, dtype=float)
    off = numpy.asarray(off, dtype=float)
    key = (coeffs.tobytes(), coeffs.shape, lin.tobytes(), off.tobytes())
    hit = _compose_cache.get(key)
    if hit is not None:
        return hit
    d = lin.shape[0]
    K = coeffs.shape[-1]
    lead = coeffs.shape[:-d]
    flat = coeffs.reshape((-1,) + (K,) * d)
    # powers[i][m] = (lin[i] . y + off[i])^m as (K,)*d coefficients
    powers = []
    for i in range(d):
        q = numpy.zeros((K,) * d)
        q[(0,) * d] = off[i]
        for j in range(d):
            if lin[i, j] != 0.0:
                q[tuple(1 if jj == j else 0 for jj in range(d))] = lin[i, j]
        pw = [numpy.zeros((K,) * d), q]
        pw[0][(0,) * d] = 1.0
        for m in range(2, K):
            pw.append(_poly_mul(pw[-1], q, K))
        powers.append(pw)
    out = numpy.zeros_like(flat)
    for ks in _itertools.product(*[range(K)] * d):
        col = flat[(slice(None),) + ks]
        if not col.any():
            continue
        term = powers[0][ks[0]]
        for i in range(1, d):
            term = _poly_mul(term, powers[i][ks[i]], K)
        out += col.reshape((-1,) + (1,) * d) * term
    out = out.reshape(lead + (K,) * d)
    if len(_compose_cache) > 4096:
        _compose_cache.clear()
    _compose_cache[key] = out
    return out


def edge_dofs(ref, degree, iedge):
    """Local dofs of ``ref`` lying on edge ``iedge``, in canonical order
    (reference: element.py:463,739 get_edge_dofs)."""
    if isinstance(ref, (LineReference, TriangleReference, TetReference)):
        powers = _barycentric_powers(ref.ndims, degree)
        return numpy.array([i for i, p in enumerate(powers) if p[iedge] == 0], dtype=int)
    if isinstance(ref, QuadReference):
        nd = degree + 1
        if iedge < 2:
            dofs1 = edge_dofs(LineReference(), degree, iedge)
            dofs2 = numpy.arange(nd)
        else:
            dofs1 = numpy.arange(nd)
            dofs2 = edge_dofs(LineReference(), degree, iedge - 2)
        return numpy.array([d1 * nd + d2 for d1 in dofs1 for d2 in dofs2], dtype=int)
    raise NotImplementedError(type(ref))


def corner_weights(ref, pts):
    '''Vertex interpolation weights W [P, nverts] with ``pts == W @
    ref.vertices``: barycentric for simplices, multilinear for hypercubes.
    Exact for points inside the (planar) reference, and equivariant under the
    reference's symmetry group, which makes it the point-matching tool for
    two-sided interface samples (reference analogue: the edge-transform
    orientation bookkeeping of transform.py:265 SimplexEdge/TensorEdge).'''
    pts = numpy.asarray(pts, dtype=float)
    if isinstance(ref, PointReference):
        return numpy.ones((len(pts), 1))
    if isinstance(ref, (LineReference, TriangleReference, TetReference)):
        return numpy.concatenate([1.0 - pts.sum(1, keepdims=True), pts], axis=1)
    if isinstance(ref, (QuadReference, HexReference)):
        d = ref.ndims
        W = numpy.ones((len(pts), 2 ** d))
        for k in range(2 ** d):
            bits = [(k >> (d - 1 - i)) & 1 for i in range(d)]  # vertex bit order: i0 slow
            for i, b in enumerate(bits):
                W[:, k] *= pts[:, i] if b else 1.0 - pts[:, i]
        return W
    raise NotImplementedError(type(ref))


def inside(ref, xi, eps=0.0):
    '''Boolean mask: local coordinates xi [N, d] inside the reference up to
    tolerance eps (reference: element.py:74 Reference.inside).'''
    xi = numpy.asarray(xi, dtype=float)
    if isinstance(ref, (LineReference, TriangleReference, TetReference)):
        return (xi >= -eps).all(axis=-1) & (xi.sum(-1) <= 1.0 + eps)
    if isinstance(ref, (QuadReference, HexReference)):
        return (xi >= -eps).all(axis=-1) & (xi <= 1.0 + eps).all(axis=-1)
    raise NotImplementedError(type(ref))
