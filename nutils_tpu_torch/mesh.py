'''Mesh generators (reference: mesh.py:34 rectilinear, :686 unitsquare):
a copy of ``nutils_tpu.mesh`` with vectorised triangle and mixed unit
squares.'''

import functools

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
        '''Base-grid cell multi-index [E, d] of the chart's elements: element
        indices directly for base-topology charts, ancestor lookup through
        the refinement lineage for refined/hierarchical charts (the analogue
        of the reference's transform-chain head resolution,
        transformseq.py:15 ``index_with_tail``), centroid binning of the
        constant root-coordinate table as a last resort (locate samples).'''
        lineage = getattr(chart, 'lineage', None)
        if self._topo is None or (lineage is None and (chart.origin_topo is self._topo
                                                       or chart.origin_topo is None)):
            return numpy.stack(numpy.unravel_index(chart.index, self.grid_shape), axis=1)
        if lineage is not None and lineage[0].base is self._topo:
            fam, levels, elems = lineage
            levels = numpy.asarray(levels)
            elems = numpy.asarray(elems)
            base = numpy.empty(len(elems), dtype=int)
            for l in numpy.unique(levels):
                m = levels == l
                base[m] = fam.base_ancestor(int(l), elems[m])
            return numpy.stack(numpy.unravel_index(base, self.grid_shape), axis=1)
        cent = numpy.asarray(chart.X.value).mean(axis=1)  # [E, d] root centroids
        return numpy.minimum(numpy.maximum(numpy.floor(cent).astype(int), 0),
                             numpy.array(self.grid_shape) - 1)

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


def newrectilinear(nodes, periodic=(), spaces=None):
    '''Tensor product of one-dimensional rectilinear meshes over distinct
    spaces (reference: mesh.py:78).'''
    if spaces is None:
        spaces = [chr(ord('X') + i) for i in range(len(nodes))]
    topo = geom = None
    for i, (n, space) in enumerate(zip(nodes, spaces)):
        ti, gi = rectilinear([n], periodic=(0,) if i in periodic else (), space=space)
        topo = ti if topo is None else topo * ti
        geom = gi if geom is None else function.concatenate([geom, gi])
    return topo, geom


def unitsquare(nelems, etype='square'):
    '''Unit square [0,1]^2 as structured squares, unstructured triangles, or a
    mixed triangle/square mesh (reference: mesh.py:686; the triangle/mixed
    vertex and element numbering is the JAX package's, so dof orderings and
    sparsity patterns match).'''
    from . import element
    from .unstructured import UnstructuredTopology

    if etype in ('square', 'rectilinear'):
        topo, geom = rectilinear([nelems, nelems])
        return topo, geom / nelems
    if etype == 'multipatch':
        # patch-vertex layout (reference: mesh.py:761):
        # 2─────3
        # │╲   ╱│
        # │ 6─7 │
        # │ 4─5 │
        # │╱   ╲│
        # 0─────1
        from .multipatch import multipatch
        topo, geom = multipatch(
            patches=[[0, 4, 1, 5], [2, 6, 3, 7], [0, 4, 2, 6], [1, 5, 3, 7], [4, 6, 5, 7]],
            patchverts=[[0, 0], [3, 0], [0, 3], [3, 3], [1, 1], [2, 1], [1, 2], [2, 2]],
            nelems=nelems)
        topo = topo.withboundary(
            bottom=topo['patch0'].boundary['bottom'],
            top=topo['patch1'].boundary['bottom'],
            left=topo['patch2'].boundary['bottom'],
            right=topo['patch3'].boundary['bottom'])
        return topo, geom / 3

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


def unitcircle(nelems, variant):
    '''Unit circle centered at the origin (reference: mesh.py:784): either a
    structured square grid smoothly blown up to the circle, or a five-patch
    multipatch mesh.'''
    from . import function as fn
    if variant == 'rectilinear':
        topo, geom = unitsquare(nelems, 'square')
        a0, a1 = (geom - 0.5) * (numpy.pi / 2)
        r2 = numpy.sqrt(2)
        return topo, function.stack([r2 * fn.sin(a0) * fn.cos(a1),
                                     r2 * fn.sin(a1) * fn.cos(a0)])
    if variant == 'multipatch':
        from .solver import System
        topo, geom = unitsquare(nelems, 'multipatch')

        B, T, L, R, C = topo.basis('patch')
        x, y = geom * 2 - 1

        xlin = x / numpy.maximum(abs(y), 1/3)  # -1 / 1
        ylin = y / numpy.maximum(abs(x), 1/3)  # -1 / 1
        xcup = numpy.maximum(1.5 * abs(x) - .5, 0)  # 1 \ 0 / 1
        ycup = numpy.maximum(1.5 * abs(y) - .5, 0)  # 1 \ 0 / 1

        b = numpy.sqrt(1/3)  # scales inner square
        xx = (b + (1-b) * xcup)**2
        yy = (b + (1-b) * ycup)**2

        c = .5 * (numpy.sqrt(2) - 1)  # scales outer radius
        X = (R-L) * (xx + c * xcup**2 * (1 - ylin**2)) + (T+C+B) * xlin * yy
        Y = (T-B) * (yy + c * ycup**2 * (1 - xlin**2)) + (L+C+R) * ylin * xx
        W = 1 + c * (L+R) * xcup**2 * (1 + ylin**2) + c * (T+B) * ycup**2 * (1 + xlin**2)

        # project numerator and denominator onto a quadratic spline basis for
        # efficient evaluation and correct patch-interface gradients
        basis = topo.basis('spline', degree=2)
        cx, cy = cxy = function.field('cxy', basis, shape=(2,))
        cw = function.field('cw', basis)
        sqr = topo.integral((X - cx)**2 + (Y - cy)**2 + (W - cw)**2, degree=4)
        args = System(sqr, trial='cxy,cw').solve()
        return topo, function.replace_arguments(cxy / cw, args)
    raise ValueError(f'unsupported unitcircle variant {variant!r}')


def parsegmsh(text):
    '''Parse Gmsh ``.msh`` data (ASCII, format 2.2 or 4.1) into the keyword
    arguments of :func:`simplex` — no external mesh library required
    (reference: mesh.py:300 parsegmsh, via meshio).  Supports linear lines,
    triangles and tetrahedra with physical groups.'''
    blocks = {}
    cur = None
    for line in text.splitlines():
        s = line.strip()
        if s.startswith('$End'):
            cur = None
        elif s.startswith('$'):
            cur = s[1:]
            blocks[cur] = []
        elif cur is not None:
            blocks[cur].append(s)

    version = float(blocks['MeshFormat'][0].split()[0])
    phys = {}  # (dim, tag) -> name
    if 'PhysicalNames' in blocks:
        for row in blocks['PhysicalNames'][1:]:
            parts = row.split(None, 2)
            phys[int(parts[0]), int(parts[1])] = parts[2].strip().strip('"')

    nodes = {}
    elems = []  # (dim, physname, [node ids, corners first])
    # gmsh element types (dim, nnodes): simplices up to p4 in every dimension;
    # node order is corners first, then per-edge interior nodes, then
    # recursively ordered face nodes, then volume interior nodes (gmsh
    # reference manual node orderings)
    typeinfo = {1: (1, 2), 8: (1, 3), 26: (1, 4), 27: (1, 5),
                2: (2, 3), 9: (2, 6), 21: (2, 10), 23: (2, 15),
                4: (3, 4), 11: (3, 10), 29: (3, 20), 30: (3, 35), 15: (0, 1)}
    if version < 4:
        for row in blocks['Nodes'][1:]:
            parts = row.split()
            nodes[int(parts[0])] = [float(x) for x in parts[1:4]]
        for row in blocks['Elements'][1:]:
            parts = [int(x) for x in row.split()]
            etype, ntags = parts[1], parts[2]
            if etype not in typeinfo:
                raise ValueError(f'unsupported gmsh element type {etype}')
            dim, nn = typeinfo[etype]
            ptag = parts[3] if ntags else 0
            nm = phys.get((dim, ptag))
            elems.append((dim, (nm,) if nm else (), parts[3 + ntags:3 + ntags + nn]))
    else:
        # msh 4.1: entity blocks
        rows = blocks['Nodes']
        nblocks = int(rows[0].split()[0])
        i = 1
        for _ in range(nblocks):
            _edim, _etag, _param, n = (int(x) for x in rows[i].split())
            ids = [int(rows[i + 1 + k]) for k in range(n)]
            for k in range(n):
                nodes[ids[k]] = [float(x) for x in rows[i + 1 + n + k].split()[:3]]
            i += 1 + 2 * n
        # entity -> physical map
        ent_phys = {}
        if 'Entities' in blocks:
            rows_e = blocks['Entities']
            counts = [int(x) for x in rows_e[0].split()]
            i = 1
            for dim, cnt in enumerate(counts):
                for _ in range(cnt):
                    parts = rows_e[i].split()
                    tag = int(parts[0])
                    nbox = 3 if dim == 0 else 6
                    nphys = int(parts[1 + nbox])
                    if nphys:  # an entity may carry several physical groups
                        ent_phys[dim, tag] = [int(p) for p in parts[2 + nbox:2 + nbox + nphys]]
                    i += 1
        rows = blocks['Elements']
        nblocks = int(rows[0].split()[0])
        i = 1
        for _ in range(nblocks):
            edim, etag, etype, n = (int(x) for x in rows[i].split())
            if etype not in typeinfo:
                raise ValueError(f'unsupported gmsh element type {etype}')
            dim, nn = typeinfo[etype]
            names = tuple(nm for p in ent_phys.get((edim, etag), ())
                          if (nm := phys.get((dim, p))) is not None)
            for k in range(n):
                parts = [int(x) for x in rows[i + 1 + k].split()]
                elems.append((dim, names, parts[1:1 + nn]))
            i += 1 + n

    ndims = max(d for d, _n, _v in elems)
    # geometric dimension: keep trailing coordinate columns only where some
    # node actually uses them (manifold meshes: 2-D simplices in 3-D space)
    gdims = ndims
    for g in nodes.values():
        while gdims < 3 and abs(g[gdims]) > 1e-12:
            gdims += 1
    # renumber nodes by first appearance in volume elements, then others
    coords_list = []
    renumber = {}

    def nid(g):
        if g not in renumber:
            renumber[g] = len(renumber)
            coords_list.append(nodes[g][:gdims])
        return renumber[g]

    vol = [(names, [nid(g) for g in verts[:ndims + 1]], verts)
           for d, names, verts in elems if d == ndims]
    simplices = numpy.sort([v for _n, v, _f in vol], axis=1)
    tags = {}
    for ielem, (names, _v, _f) in enumerate(vol):
        for name in names:
            tags.setdefault(name, []).append(ielem)
    bedges = {}  # name -> list of sorted corner-vertex tuples
    for d, names, verts in elems:
        if d == ndims - 1:
            for name in names:
                bedges.setdefault(name, []).append(
                    tuple(sorted(nid(g) for g in verts[:ndims] if g in renumber)))
    ptags = {}  # name -> list of renumbered vertex ids (gmsh physical points)
    for d, names, verts in elems:
        if d == 0 and names and verts[0] in renumber:
            for name in names:
                ptags.setdefault(name, []).append(renumber[verts[0]])
    out = dict(nodes=simplices, coords=numpy.asarray(coords_list),
               tags={k: numpy.asarray(v) for k, v in tags.items()}, btags=bedges,
               ptags=ptags)
    if vol and len(vol[0][2]) > ndims + 1:
        # isoparametric p>=2 geometry: separate numbering over ALL nodes of
        # the volume elements (corners + edge/face nodes), aligned with the
        # UNSORTED element node order so the nodal shape functions match
        nn = len(vol[0][2])
        degree = next(p for p in range(2, 8)
                      if _binom(p + ndims, ndims) == nn)
        ho_renumber = {}
        ho_coords = []

        def hid(g):
            if g not in ho_renumber:
                ho_renumber[g] = len(ho_renumber)
                ho_coords.append(nodes[g][:gdims])
            return ho_renumber[g]

        out['geom_dofs'] = [[hid(g) for g in full] for _n, _v, full in vol]
        out['geom_corners'] = [v for _n, v, _f in vol]  # gmsh corner order
        out['geom_coords'] = numpy.asarray(ho_coords)
        out['geom_degree'] = degree
    return out


def _binom(n, k):
    import math
    return math.comb(n, k)


_GMSH_EDGES = {1: [(0, 1)],
               2: [(0, 1), (1, 2), (2, 0)],
               3: [(0, 1), (1, 2), (0, 2), (0, 3), (2, 3), (1, 3)]}

# tet faces in gmsh closure order with gmsh orientation (gmsh reference
# manual "node ordering"; MTetrahedron faces_tetra): the p>=3 interior face
# nodes recurse on the inset sub-triangle of each face in this corner order
_GMSH_FACES = {3: [(0, 2, 1), (0, 1, 3), (0, 3, 2), (3, 1, 2)]}


@functools.cache
def _gmsh_simplex_nodes(ndims, degree):
    '''Integer barycentric multi-indices [nn, ndims+1] (summing to degree) of
    the gmsh pN simplex nodes in gmsh node order: corners, then the interior
    nodes of each edge walked from its first to its second corner, then face
    nodes ordered by recursing on the inset sub-simplex (gmsh reference
    manual, "node ordering").'''
    def rec(d, deg):
        if deg == 0:
            return [(0,) * (d + 1)]
        eye = numpy.eye(d + 1, dtype=int)
        out = [tuple(deg * eye[i]) for i in range(d + 1)]
        if deg >= 2:
            for a, b in _GMSH_EDGES[d]:
                out.extend(tuple((deg - t) * eye[a] + t * eye[b]) for t in range(1, deg))
        if deg >= 3 and d >= 2:
            if d == 2:
                out.extend(tuple(numpy.asarray(n) + 1) for n in rec(2, deg - 3))
            else:
                assert d == 3
                for face in _GMSH_FACES[3]:
                    for n in rec(2, deg - 3):
                        idx = numpy.zeros(d + 1, dtype=int)
                        for k, c in enumerate(face):
                            idx[c] = n[k] + 1
                        out.append(tuple(idx))
                if deg >= 4:
                    out.extend(tuple(numpy.asarray(n) + 1) for n in rec(3, deg - 4))
        return out
    return numpy.asarray(rec(ndims, degree), dtype=int)


@functools.cache
def _nodal_simplex_coeffs(ndims, degree, perm):
    '''Power-basis coefficients [nn, (degree+1)^ndims box] of the nodal
    (Lagrange) shape functions of the gmsh pN node set, expressed in the
    element frame whose reference vertex j is gmsh corner ``perm[j]``.'''
    lam = _gmsh_simplex_nodes(ndims, degree) / degree  # [nn, d+1] in gmsh corner frame
    pos = lam[:, list(perm)][:, 1:]           # cartesian coords in the element frame
    import itertools
    expos = [e for e in itertools.product(range(degree + 1), repeat=ndims) if sum(e) <= degree]
    V = numpy.array([[numpy.prod(p ** numpy.asarray(e)) for e in expos] for p in pos])
    A = numpy.linalg.inv(V)  # column k = power coeffs of shape fn k
    K = (degree + 1,) * ndims
    coeffs = numpy.zeros((len(pos),) + K)
    for m, e in enumerate(expos):
        coeffs[(slice(None),) + e] = A[m]
    return coeffs


def gmsh(fname, *, space='X'):
    '''Import a Gmsh ``.msh`` file (ASCII v2.2 or v4.1) as an unstructured
    simplex topology with physical boundary/volume groups and a linear
    geometry (reference: mesh.py:461).'''
    from . import element
    from .unstructured import UnstructuredTopology
    if hasattr(fname, 'read'):
        text = fname.read()
        if isinstance(text, bytes):
            text = text.decode()
    else:
        with open(fname) as f:
            text = f.read()
    data = parsegmsh(text)
    simplices = data['nodes']
    coords = data['coords']
    ndims = simplices.shape[1] - 1  # topological dim (< coords.shape[1] for manifolds)
    ref = element.simplex(ndims)
    topo = UnstructuredTopology(space, [ref] * len(simplices), list(simplices), len(coords))
    if 'geom_dofs' in data:
        # isoparametric p>=2 geometry: nodal Lagrange basis over the full
        # (corner + edge/face) node set (reference: mesh.py:540 simplex with
        # higher-order node tables).  The topology's element frame uses the
        # SORTED corner order, so each element's shape functions are built in
        # the corner permutation relating the two orderings.
        coeffs = []
        for sorted_v, gm_c in zip(simplices, data['geom_corners']):
            perm = tuple(gm_c.index(int(vj)) for vj in sorted_v)
            coeffs.append(_nodal_simplex_coeffs(ndims, data['geom_degree'], perm))
        gbasis = function.PlainBasis(space, [numpy.asarray(d) for d in data['geom_dofs']],
                                     coeffs, len(data['geom_coords']), ragged=True)
        gbasis._origin = topo
        geom = function.matmul(gbasis, function.asarray(data['geom_coords']))
    else:
        geom = function.matmul(topo.basis('std', degree=1), function.asarray(coords))
    # resolve named boundary groups by vertex matching
    btopo = topo.boundary
    key2row = {}
    for row, (ielem, iedge) in enumerate(btopo._edges):
        verts = topo._elem_verts[ielem]
        ev = topo._refs[ielem].edge_vertex_ids[iedge]
        key2row[tuple(sorted(int(verts[k]) for k in ev))] = row
    groups = {}
    for name, edges in data['btags'].items():
        rows = [key2row[e] for e in edges if e in key2row]
        if rows:
            groups[name] = btopo[numpy.asarray(rows)]
    vgroups = {name: topo.take(ielems) for name, ielems in data['tags'].items()}
    pgroups = {name: topo.point_topology(ids[0])
               for name, ids in data.get('ptags', {}).items() if len(ids) == 1}
    if groups or vgroups or pgroups:
        topo = topo.withgroups(vgroups=vgroups, bgroups=groups, pgroups=pgroups)
    return topo, geom


def simplex(nodes, cnodes, coords, tags=None, btags=None, ptags=None, *, space='X'):
    '''Simplex topology from raw node tables (reference: mesh.py:540).

    ``nodes`` is the [nelems, ndims+1] connectivity (vertex ids sorted per
    row), ``cnodes`` the [nelems, ncnodes] coordinate-node table in the
    Bernstein barycentric enumeration (``element.bernstein_coeffs`` order;
    the geometry degree is inferred from ncnodes), ``coords`` the
    [ncoords, ndims] coordinate array indexed by ``cnodes``.  ``tags`` maps
    names to element numbers, ``btags`` to [n, 2] (element, edge) pairs,
    ``ptags`` to vertex ids.'''
    from . import element
    from .unstructured import UnstructuredTopology
    nodes = numpy.asarray(nodes, dtype=int)
    cnodes = numpy.asarray(cnodes, dtype=int)
    coords = numpy.asarray(coords, dtype=float)
    nelems, nverts_e = nodes.shape
    ndims = nverts_e - 1
    assert (numpy.diff(nodes, axis=1) > 0).all(), 'nodes must be sorted along axis 1'
    ref = element.simplex(ndims)
    nverts = int(nodes.max()) + 1 if nelems else 0
    topo = UnstructuredTopology(space, [ref] * nelems, list(nodes), nverts)
    degree = 1
    while _binom(degree + ndims, ndims) < cnodes.shape[1]:
        degree += 1
    if _binom(degree + ndims, ndims) != cnodes.shape[1]:
        raise ValueError(f'cnodes width {cnodes.shape[1]} is not a simplex dof count')
    bcoeffs = element.bernstein_coeffs(ref, degree)
    gbasis = function.PlainBasis(space, list(cnodes), [bcoeffs] * nelems, len(coords), ragged=True)
    gbasis._origin = topo
    geom = function.matmul(gbasis, function.asarray(coords))
    vgroups = {name: topo.take(numpy.asarray(ielems, dtype=int))
               for name, ielems in (tags or {}).items()}
    bgroups = {}
    if btags:
        btopo = topo.boundary
        key2row = {tuple(e): row for row, e in enumerate(numpy.asarray(btopo._edges, dtype=int).tolist())}
        for name, edges in btags.items():
            rows = [key2row[tuple(map(int, e))] for e in numpy.asarray(edges, dtype=int)
                    if tuple(map(int, e)) in key2row]
            if rows:
                bgroups[name] = btopo[numpy.asarray(rows)]
    pgroups = {name: topo.point_topology(int(numpy.atleast_1d(ids)[0]))
               for name, ids in (ptags or {}).items() if len(numpy.atleast_1d(ids)) == 1}
    if vgroups or bgroups or pgroups:
        topo = topo.withgroups(vgroups=vgroups, bgroups=bgroups, pgroups=pgroups)
    return topo, geom


def fromfunc(func, nelems, ndims, degree=1, space='X'):
    '''Structured mesh with geometry given by a python function of the
    reference coordinates, L2-projected onto a spline basis (reference:
    mesh.py:674).'''
    if numeric.isint(nelems):
        nelems = [nelems]
    assert len(nelems) == func.__code__.co_argcount
    topo, ref = rectilinear([numpy.linspace(0, 1, n + 1) for n in nelems], space=space)
    basis = topo.basis('spline', degree=degree)
    vals = func(*[ref[i] for i in range(len(nelems))])
    if isinstance(vals, (tuple, list)):
        target = function.stack([function.asarray(v) for v in vals])
    else:
        target = function.asarray(vals)
    assert (target.ndim and target.shape[0] or 1) == ndims
    coeffs = function.field('__fromfunc__', basis, shape=target.shape)
    from .solver import System
    J = function.J(ref)
    diff2 = (coeffs - target) ** 2
    if target.ndim:
        diff2 = function.sum_(diff2, 0)
    sqr = topo.integral(diff2 * J, degree=2 * degree + 2)
    args = System(sqr, trial='__fromfunc__').solve()
    geom = function.replace_arguments(coeffs, args)
    return topo, geom


def multipatch(patches, nelems, patchverts=None, space='X'):
    '''Multipatch topology and geometry from patch vertex tables (reference:
    mesh.py:96 multipatch).'''
    from .multipatch import multipatch as _mp
    return _mp(patches, nelems, patchverts=patchverts, space=space)
