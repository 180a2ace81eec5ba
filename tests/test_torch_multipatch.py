'''Point location, multipatch topologies and the rest of ``mesh`` in the
PyTorch port against the JAX package: the cases of
``tests/test_interfaces_locate.py`` (locate, multipatch, 3-D) and
``tests/test_mesh.py`` (gmsh, ``simplex``) through the port, and the same
constructions through both packages: ``merge_index_map`` on merge sets of
two to five indices, ``unitcircle(4, 'multipatch')`` at the Gauss points,
and ``newton_locate`` on triangles, a multipatch circle and a hierarchical
refinement, with the same candidates' elements and local coordinates to
1e-12.'''

import numpy
import pytest

import _torch_ported_cases as pc
import test_torch_topology_more as more
from nutils_tpu_torch.utils import config

CASES = pc.cases('test_interfaces_locate', exclude=more.INTERFACES) + pc.cases('test_mesh')


@pytest.mark.parametrize('name,fname,kwargs', [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_jax_case_through_the_port(name, fname, kwargs, tmp_path, monkeypatch):
    pc.run(name, fname, kwargs, {'tmp_path': tmp_path, 'monkeypatch': monkeypatch})


@pytest.mark.parametrize('size', [2, 3, 5])
def test_merge_index_map_as_the_jax_package(size):
    from nutils_tpu.unstructured import merge_index_map as merge_jax
    from nutils_tpu_torch.unstructured import merge_index_map
    rng = numpy.random.default_rng(size)
    n = 60
    sets = [tuple(rng.choice(n, size, replace=False).tolist()) for _ in range(12)]
    want = merge_jax(n, iter(sets))
    for given in (iter(sets), numpy.array(sets)):  # a generator of tuples, an [m, k] array
        got = merge_index_map(n, given)
        assert got[1] == want[1] and numpy.array_equal(got[0], want[0])
    mixed = sets[:4] + [s[:2] for s in sets[4:]]  # sets of different sizes in one stream
    got, want = merge_index_map(n, iter(mixed)), merge_jax(n, iter(mixed))
    assert got[1] == want[1] and numpy.array_equal(got[0], want[0])


@pytest.fixture(scope='module')
def circles():
    from nutils_tpu import mesh as mesh_jax
    from nutils_tpu_torch import mesh
    with config.device('cpu'):
        return mesh.unitcircle(4, 'multipatch'), mesh_jax.unitcircle(4, 'multipatch')


def test_unitcircle_multipatch_geometry(circles):
    (tt, gt), (tj, gj) = circles
    assert len(tt) == len(tj) == 5 * 16
    with config.device('cpu'):
        xt = numpy.asarray(tt.sample('gauss', 3).eval(gt))
        area = float(tt.integrate(__import__('nutils_tpu_torch').function.J(gt), degree=4))
    xj = numpy.asarray(tj.sample('gauss', 3).eval(gj))
    assert numpy.allclose(xt, xj, rtol=0, atol=1e-12)
    assert area == pytest.approx(numpy.pi, rel=1e-3)  # a spline fit of the circle


def _locate_both(topo_t, geom_t, topo_j, geom_j, points, **kwargs):
    from nutils_tpu.unstructured import newton_locate as locate_jax
    from nutils_tpu_torch.unstructured import newton_locate
    with config.device('cpu'):
        got = newton_locate(topo_t, geom_t, points, _raw=True, **kwargs)
    want = locate_jax(topo_j, geom_j, points, _raw=True, **kwargs)
    assert numpy.array_equal(got[0], want[0])
    assert numpy.allclose(got[1], want[1], rtol=0, atol=1e-12)
    return got


def test_newton_locate_multipatch(circles):
    (tt, gt), (tj, gj) = circles
    # in the middle patch, near the rim, and beside a patch interface (a
    # point outside the disk would run every candidate rank)
    points = numpy.array([[.5, .5], [.1, .55], [.93, .4], [.5 + .5 / 3 ** .5 * .999, .5]])
    elems, _xi = _locate_both(tt, (gt + 1) / 2, tj, (gj + 1) / 2, points, skip_missing=True, tol=1e-5)
    assert (elems >= 0).all()


def test_cahnhilliard_locate_as_the_jax_package():
    '''examples/cahnhilliard.py's locate on ``test_multipatchcircle``'s
    mesh (3 elements a patch side) through both packages, at a quarter of
    the flux grid's points inside the disk (1/20 apart): the same
    elements, coordinates to 1e-12, the port's sample holding them (the
    reader the card's parity phase uses), and the flux at the located
    points to 1e-10.'''
    import _torch_parity as tp
    from nutils_tpu import SI as SI_jax, function as function_jax
    from nutils_tpu_torch import SI, function
    from nutils_tpu_torch.utils import numeric
    grid = numeric.simplex_grid([1, 1], 1 / 20)
    points = grid[numpy.hypot(*(grid - .5).T) < .45][::4]
    kwargs = dict(maxdist=1 / 3, skip_missing=True, tol=1e-5)
    with config.device('cpu'):
        pt = tp.cahnhilliard('nutils_tpu_torch', locate=False)
    pj = tp.cahnhilliard('nutils_tpu', locate=False)
    elems, _xi = _locate_both(pt['domain'], pt['geom'], pj['domain'], pj['geom'], points, **kwargs)
    assert (elems >= 0).all()
    rng = numpy.random.default_rng(3)
    shape = pt['args']['φ'].shape
    args = dict(φ=rng.normal(0, .5, shape), η=rng.normal(0, 1, shape))
    with config.device('cpu'):
        gt = pt['domain'].locate(pt['geom'], points, **kwargs)
        at, xt = tp.located(gt)
        vt = numpy.asarray(function.eval(gt.bind(pt['ns'].v / SI.Velocity('1m/s')), args))
        assert numpy.allclose(numpy.asarray(gt.eval(pt['geom'])), points, rtol=0, atol=1e-5)
    assert numpy.array_equal(at, elems) and xt.shape == points.shape
    gj = pj['domain'].locate(pj['geom'], points, **kwargs)
    assert tp.rel(vt, numpy.asarray(function_jax.eval(gj.bind(pj['ns'].v / SI_jax.Velocity('1m/s')), args))) <= 1e-10


def test_newton_locate_triangles_and_hierarchical():
    from nutils_tpu import mesh as mesh_jax
    from nutils_tpu_torch import mesh
    points = numpy.random.default_rng(7).uniform(.02, .98, (9, 2))
    with config.device('cpu'):
        tt, gt = mesh.unitsquare(3, 'mixed')
    tj, gj = mesh_jax.unitsquare(3, 'mixed')
    elems, _xi = _locate_both(tt, gt, tj, gj, points, tol=1e-12)
    assert (elems >= 0).all()
    with config.device('cpu'):
        ht = tt.refined_by([0, 4, 5])
        lt = ht.locate(gt, points, tol=1e-12)
        xt, leaves = numpy.asarray(lt.eval(gt)), numpy.asarray(lt.eval(ht.basis('h-std', degree=1)))
    hj = tj.refined_by([0, 4, 5])
    lj = hj.locate(gj, points, tol=1e-12)
    assert numpy.allclose(xt, points, rtol=0, atol=1e-12)
    assert numpy.allclose(leaves, numpy.asarray(lj.eval(hj.basis('h-std', degree=1))), rtol=0, atol=1e-12)


def test_locate_lowers_once_a_rank():
    '''Newton iterations whose points stay in their elements bind new
    coordinates into the graph lowered at the first iteration.'''
    from nutils_tpu_torch import mesh
    from nutils_tpu_torch.unstructured import newton_locate
    stats = {}
    with config.device('cpu'):
        topo, geom = mesh.unitsquare(4, 'triangle')
        curved = geom + .05 * geom[::-1] ** 2
        newton_locate(topo, curved, numpy.array([[.31, .42], [.77, .18]]), tol=1e-12, _stats=stats)
    assert stats['found'] == 2 and stats['ranks'] >= 1
    assert stats['lowered'] < stats['iterations']


def test_locate_relowers_where_the_coordinates_fold():
    '''A part whose lowering folds the points' coordinates into a constant
    (a geometry that does not depend on them) is lowered again for other
    coordinates and reused only at the same ones.'''
    from nutils_tpu_torch import function, mesh, unstructured
    with config.device('cpu'):
        topo, _geom = mesh.unitsquare(2, 'triangle')
        flat = function.asarray(numpy.array([.25, .75]))
        evaluate = unstructured._PointEval(flat, function.grad(flat, function._RootCoords(topo.space, 2)), {}, 2)
        cand = numpy.array([0, 0])
        for xi, lowered in ([[.2, .2], [.3, .1]], 1), ([[.2, .2], [.3, .1]], 1), ([[.1, .1], [.3, .1]], 2):
            vals, grads = evaluate(topo._point_sample(cand, numpy.array(xi)))
            assert evaluate.lowered == lowered
            assert numpy.array_equal(vals, [[.25, .75]] * 2) and not grads.any()


def test_gmsh_simplex_as_the_jax_package():
    import pathlib
    from nutils_tpu import mesh as mesh_jax
    from nutils_tpu_torch import function, mesh
    from nutils_tpu import function as function_jax
    path = sorted((pathlib.Path(__file__).parent / 'test_mesh').glob('*.msh'))[0]
    with config.device('cpu'):
        tt, gt = mesh.gmsh(str(path))
        vt = numpy.asarray(tt.sample('gauss', 2).eval(gt))
        area_t = float(tt.integrate(function.J(gt), degree=2))
    tj, gj = mesh_jax.gmsh(str(path))
    assert len(tt) == len(tj)
    assert numpy.allclose(vt, numpy.asarray(tj.sample('gauss', 2).eval(gj)), rtol=0, atol=1e-14)
    assert area_t == pytest.approx(float(tj.integrate(function_jax.J(gj), degree=2)), rel=1e-13)


@pytest.mark.parametrize('name', ['multipatch', 'cache', 'function'])
def test_new_module_doctests(name):
    import doctest
    import importlib
    from test_docs import FloatNeighborhoodOutputChecker
    mod = importlib.import_module(f'nutils_tpu_torch.{name}')
    runner = doctest.DocTestRunner(checker=FloatNeighborhoodOutputChecker(),
                                   optionflags=doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE)
    tests = [t for t in doctest.DocTestFinder(exclude_empty=True).find(mod, mod.__name__, globs={}) if t.examples]
    with config.device('cpu'):
        failed = sum(runner.run(t).failed for t in tests)
    assert tests and not failed


def test_reverse_grads_are_the_jvp_passes(circles):
    '''The root gradient of the multipatch circle's geometry at points of
    every patch, by forward-mode jvp passes and by reverse-mode autograd
    (``evaluable.reverse_grads``, which point location takes), to
    rounding.'''
    from nutils_tpu_torch import evaluable, function
    (tt, gt), _jax = circles
    grad = function.grad(gt, function._RootCoords(tt.space, 2))
    with config.device('cpu'):
        smp = tt.sample('gauss', 2)
        want = numpy.asarray(smp.eval(grad))
        with evaluable.reverse_grads():
            got = numpy.asarray(smp.eval(grad))
    assert want.shape == got.shape and numpy.allclose(got, want, rtol=1e-13, atol=1e-13)
