'''Planar graded triangular mesh generation (distmesh-style).

The reference meshes non-trivial 2D geometries by shelling out to the gmsh
binary (reference: mesh.py:461,522-530).  That binary is not a library the
framework can depend on, so this module provides a self-contained generator
for boundary-fitted, graded, multi-region triangulations of planar domains
described by signed-distance functions — the same algorithmic family as
Persson & Strang's *distmesh* (SIAM Review 46(2), 2004): iterate Delaunay
retriangulation of a point set relaxed by edge spring forces, with boundary
points projected onto the zero level set.

Regions are meshed one at a time against a shared discretization of their
interface curves, so multi-region meshes (e.g. the fluid/solid split of the
Turek-Hron FSI benchmark) are conforming by construction.  All computation is
host-side numpy/scipy setup code; the resulting vertex/triangle tables feed
the batched assembly path through :class:`nutils_tpu_torch.unstructured.
UnstructuredTopology`.
'''

import numpy


# ------------------------------------------------------------ signed distances

def drectangle(p, x1, x2, y1, y2):
    '''Signed distance to an axis-aligned rectangle (negative inside).'''
    x, y = p[:, 0], p[:, 1]
    dx = numpy.maximum(x1 - x, x - x2)
    dy = numpy.maximum(y1 - y, y - y2)
    inside = numpy.maximum(dx, dy)
    ox = numpy.maximum(dx, 0)
    oy = numpy.maximum(dy, 0)
    outside = numpy.sqrt(ox**2 + oy**2)
    return numpy.where((dx < 0) & (dy < 0), inside, outside)


def dcircle(p, cx, cy, r):
    '''Signed distance to a disk (negative inside).'''
    return numpy.sqrt((p[:, 0] - cx)**2 + (p[:, 1] - cy)**2) - r


def ddiff(d1, d2):
    '''Set difference of signed distances: inside d1, outside d2.'''
    return numpy.maximum(d1, -d2)


def dunion(d1, d2):
    return numpy.minimum(d1, d2)


def dintersect(d1, d2):
    return numpy.maximum(d1, d2)


# ------------------------------------------------------------ curve sampling

def polyline(points, size, close=False):
    '''Discretize a polyline at local target edge length ``size(x)``.

    Returns the sampled points including both end points (for a closed curve
    the first point is not repeated at the end).'''
    points = numpy.asarray(points, dtype=float)
    if close:
        points = numpy.concatenate([points, points[:1]])
    out = []
    for a, b in zip(points[:-1], points[1:]):
        seg = _segment(a, b, size)
        out.append(seg[:-1])
    out = numpy.concatenate(out)
    if not close:
        out = numpy.concatenate([out, points[-1:]])
    return out


def _segment(a, b, size):
    '''Sample segment [a,b] at local size; includes both endpoints.'''
    L = float(numpy.linalg.norm(b - a))
    # integrate 1/h along the segment to find the point count
    probe = a + numpy.linspace(0, 1, 33)[:, None] * (b - a)
    h = size(probe)
    density = numpy.trapezoid(1 / h, dx=L / 32)
    n = max(1, round(float(density)))
    # place points at equal fractions of the accumulated density
    cum = numpy.concatenate([[0], numpy.cumsum((1 / h[1:] + 1 / h[:-1]) / 2 * (L / 32))])
    targets = numpy.linspace(0, cum[-1], n + 1)
    t = numpy.interp(targets, cum, numpy.linspace(0, 1, 33))
    return a + t[:, None] * (b - a)


def arc(center, radius, a0, a1, size):
    '''Sample a circular arc at local size; includes both endpoints.'''
    cx, cy = center
    # estimate point count from arc length / mean size
    probe_t = numpy.linspace(a0, a1, 65)
    probe = numpy.stack([cx + radius * numpy.cos(probe_t), cy + radius * numpy.sin(probe_t)], axis=1)
    h = size(probe)
    L = abs(a1 - a0) * radius
    density = numpy.trapezoid(1 / h, dx=L / 64)
    n = max(3, round(float(density)))
    cum = numpy.concatenate([[0], numpy.cumsum((1 / h[1:] + 1 / h[:-1]) / 2 * (L / 64))])
    targets = numpy.linspace(0, cum[-1], n + 1)
    t = numpy.interp(targets, cum, probe_t)
    return numpy.stack([cx + radius * numpy.cos(t), cy + radius * numpy.sin(t)], axis=1)


# ------------------------------------------------------------ the generator

def distmesh(fd, size, bbox, fixed, *, maxiter=120, seed=0, dptol=2e-3, geps_rel=1e-3):
    '''Mesh a single region.

    Parameters
    ----------
    fd : callable [N,2] -> [N]
        Signed distance, negative inside the region.
    size : callable [N,2] -> [N]
        Target local edge length.
    bbox : (x1, x2, y1, y2)
        Bounding box for the initial point seeding.
    fixed : [M,2] float
        Points that must appear as mesh vertices verbatim (boundary and
        interface discretizations).  These points never move.

    Returns (points [N,2], triangles [T,3]) with the fixed points first, in
    their given order.
    '''
    import scipy.spatial
    x1, x2, y1, y2 = bbox
    h0 = float(numpy.min(size(numpy.asarray(fixed)))) if len(fixed) else float(numpy.min(size(
        numpy.asarray([[x1, y1], [x2, y2], [(x1 + x2) / 2, (y1 + y2) / 2]]))))
    geps = geps_rel * h0 + 1e-12

    fixed = numpy.asarray(fixed, dtype=float)
    nfix = len(fixed)

    # initial seeding: equilateral-ish lattice, rejection-sampled by 1/size^2
    xs = numpy.arange(x1 + h0 / 2, x2, h0)
    ys = numpy.arange(y1 + h0 / 2, y2, h0 * numpy.sqrt(3) / 2)
    X, Y = numpy.meshgrid(xs, ys, indexing='xy')
    X[1::2] += h0 / 2
    p = numpy.stack([X.ravel(), Y.ravel()], axis=1)
    p = p[fd(p) < -geps]  # keep interior points only
    r0 = 1 / size(p)**2
    rng = numpy.random.RandomState(seed)  # deterministic meshes
    p = p[rng.random_sample(len(p)) < r0 / r0.max()]
    # drop seeds too close to fixed points
    if nfix:
        tree = scipy.spatial.cKDTree(fixed)
        d, _ = tree.query(p)
        p = p[d > 0.7 * size(p)]
    p = numpy.concatenate([fixed, p])

    def triangulate(p):
        tri = scipy.spatial.Delaunay(p).simplices
        cc = p[tri].mean(axis=1)
        return tri[fd(cc) < -geps]

    pold = None
    Fscale = 1.2
    deltat = 0.2
    for _ in range(maxiter):
        if pold is None or numpy.sqrt(((p - pold)**2).sum(1)).max() > 0.1 * h0:
            pold = p.copy()
            t = triangulate(p)
            bars = numpy.unique(numpy.sort(numpy.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]]), axis=1), axis=0)
        barvec = p[bars[:, 0]] - p[bars[:, 1]]
        L = numpy.sqrt((barvec**2).sum(1))
        hbars = size((p[bars[:, 0]] + p[bars[:, 1]]) / 2)
        L0 = hbars * Fscale * numpy.sqrt((L**2).sum() / (hbars**2).sum())
        F = numpy.maximum(L0 - L, 0)
        Fvec = (F / numpy.maximum(L, 1e-12))[:, None] * barvec
        Ftot = numpy.zeros_like(p)
        numpy.add.at(Ftot, bars[:, 0], Fvec)
        numpy.add.at(Ftot, bars[:, 1], -Fvec)
        Ftot[:nfix] = 0
        p = p + deltat * Ftot
        # project escaped points back onto the boundary (numerical gradient)
        d = fd(p)
        ix = d > 0
        if ix.any():
            deps = numpy.sqrt(numpy.finfo(float).eps) * h0
            dgx = (fd(p[ix] + [deps, 0]) - d[ix]) / deps
            dgy = (fd(p[ix] + [0, deps]) - d[ix]) / deps
            norm2 = numpy.maximum(dgx**2 + dgy**2, 1e-12)
            p[ix] -= (d[ix] / norm2)[:, None] * numpy.stack([dgx, dgy], axis=1)
        moved = numpy.sqrt((deltat * Ftot[nfix:][d[nfix:] < -geps]**2).sum(1)) if len(p) > nfix else numpy.zeros(0)
        if len(moved) == 0 or (moved / h0).max() < dptol:
            break
    t = triangulate(p)
    # drop unused points (can happen near tangencies), keep fixed points
    used = numpy.zeros(len(p), dtype=bool)
    used[:nfix] = True
    used[t.ravel()] = True
    renum = numpy.cumsum(used) - 1
    return p[used], renum[t]


def _fix_orientation(points, tri):
    '''Make all triangles counterclockwise.'''
    a, b, c = points[tri[:, 0]], points[tri[:, 1]], points[tri[:, 2]]
    det = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    flip = det < 0
    tri = tri.copy()
    tri[flip] = tri[flip][:, [0, 2, 1]]
    return tri


def merge_regions(regions):
    '''Merge per-region (points, triangles) into one vertex table.

    Vertices are deduplicated by rounded coordinates; since adjoining regions
    are meshed against the *same* interface point sets, the merged mesh is
    conforming.  Returns (points, triangles, region_slices) where
    ``region_slices[i]`` is the triangle index array of region i.'''
    allp = []
    alltri = []
    offsets = []
    n = 0
    for p, t in regions:
        allp.append(p)
        alltri.append(_fix_orientation(p, t) + n)
        offsets.append(len(t))
        n += len(p)
    allp = numpy.concatenate(allp)
    alltri = numpy.concatenate(alltri)
    # dedup by quantized coordinates
    scale = numpy.abs(allp).max() or 1.0
    key = numpy.round(allp / scale * 1e9).astype(numpy.int64)
    _, first, inverse = numpy.unique(key, axis=0, return_index=True, return_inverse=True)
    order = numpy.argsort(first)  # stable: keep first-appearance order
    rank = numpy.empty_like(order)
    rank[order] = numpy.arange(len(order))
    points = allp[first[order]]
    tri = rank[inverse][alltri]
    slices = []
    start = 0
    for cnt in offsets:
        slices.append(numpy.arange(start, start + cnt))
        start += cnt
    return points, tri, slices
