'''The Newton family's line searches and Minimize in the PyTorch port
(``ReuseNewton``, ``LinesearchNewton`` under ``NormBased`` and
``MedianBased``, ``Minimize``) against nutils_tpu on the CPU, and
``examples/finitestrain.py``'s own test cases through the port.

Tolerances: the iterates and residual norms of each iteration to 1e-10
relative (both packages solve the small systems directly), the norms with
1e-15 absolute beside it: the residual's entries are sums of element terms
of order one, assembled in another order, so their rounding (up to 1.3e-16
measured) stays as the norm falls; the submatrix
product through the parent's device operator to 1e-12 of the scipy
product (another order of sums); the example's cases to their own
regression data.'''

import importlib
import unittest

import numpy
import pytest
import torch

import _torch_parity as tp
from nutils_tpu_torch import matrix, solver
from nutils_tpu_torch.utils import config

METHODS = {
    'reuse-newton': lambda s: s.ReuseNewton(),
    'linesearch-normbased': lambda s: s.LinesearchNewton(),
    'linesearch-medianbased': lambda s: s.LinesearchNewton(strategy=s.MedianBased()),
    'minimize': lambda s: s.Minimize(),
}


def _nonlinear(pkg):
    '''``tests/test_solver.py``'s nonlinear energy (``_nonlinear_setup``) on
    3 x 3 squares, its first four dofs clamped: (System, constraints).'''
    function, mesh, solver_, _config = tp.modules(pkg)
    topo, geom = mesh.unitsquare(3, 'square')
    u = topo.field('u', btype='std', degree=1)
    J = function.J(geom)
    g = function.grad(u, geom)
    E = topo.integral(((1 + u ** 2) * (g @ g) / 2 + u ** 2 / 2 - u) * J, degree=3)
    cons = {'u': numpy.concatenate([numpy.zeros(4), numpy.full(12, numpy.nan)])}
    return solver_.System(E, trial='u'), cons


@pytest.mark.parametrize('method', METHODS)
def test_iterations_against_nutils_tpu(method):
    solver_jax = tp.modules('nutils_tpu')[2]
    sj, cons = _nonlinear('nutils_tpu')
    with config.device('cpu'):
        st, _cons = _nonlinear('nutils_tpu_torch')
        gj = METHODS[method](solver_jax)(sj, arguments={}, constrain=cons)
        gt = METHODS[method](solver)(st, arguments={}, constrain=cons)
        steps = []
        for _ in range(30):
            (aj, rj), (at, rt) = next(gj), next(gt)
            steps.append((rt, rj, at['u'], aj['u']))
            if rj <= 1e-10:
                break
    r0 = steps[0][1]
    assert r0 > 1e-2 and steps[-1][1] <= 1e-10 and steps[-1][0] <= 1e-10  # both converge, in as many iterations
    for rt, rj, ut, uj in steps:
        assert tp.rel(ut, uj) <= 1e-10
        assert abs(rt - rj) <= 1e-10 * rj + 1e-15


@pytest.mark.parametrize('method', METHODS)
def test_solve_against_nutils_tpu(method):
    # System.solve to 1e-10, the test of tests/test_solver.py
    solver_jax = tp.modules('nutils_tpu')[2]
    sj, cons = _nonlinear('nutils_tpu')
    want = sj.solve(constrain=cons, tol=1e-10, method=METHODS[method](solver_jax))
    with config.device('cpu'):
        st, _cons = _nonlinear('nutils_tpu_torch')
        got = st.solve(constrain=cons, tol=1e-10, method=METHODS[method](solver))
        assert numpy.linalg.norm(st.assemble_residual(got)[4:]) < 1e-10
    assert tp.rel(got['u'], want['u']) <= 1e-10


def test_minimize_needs_a_symmetric_system():
    with config.device('cpu'):
        _domain, _ns, res, _sqr = tp.laplace_example_forms('nutils_tpu_torch', 4)
        system = solver.System(res, trial='u', test='v')
        with pytest.raises(solver.SolverError):
            next(solver.Minimize()(system, arguments={}, constrain={}))


@pytest.mark.parametrize('form', ('stencil', 'blockgrid', 'csr'))
def test_submatrix_product(form):
    # the line searches' jac @ dx: the parent's device operator on the
    # embedded vector, against the scipy submatrix
    rng = numpy.random.default_rng(29)
    with config.device('cpu'):
        jac, _res = tp.spd_jacobian('nutils_tpu_torch', form)
        mask = rng.random(jac.shape[0]) < .8
        sub = jac.submatrix(mask, mask)
        assert isinstance(sub, matrix._SubMatrix) and sub.shape == (mask.sum(),) * 2
        v = rng.standard_normal(int(mask.sum()))
        got = sub @ v
    want = jac._scipy()[mask][:, mask] @ v
    assert tp.rel(got, want) <= 1e-12


def _port_main(nelems=20, etype='square', btype='std', degree=1, poisson=.25, angle=20., restol=1e-10, trim=True):
    '''``examples/finitestrain.py``'s ``main`` through the port (on the
    CPU, without its figures); the port has no trimming yet (ROADMAP A6).'''
    assert not trim
    with config.device('cpu'):
        _cons, u0, u1, _system = tp.finitestrain('nutils_tpu_torch', nelems, etype, btype, degree, poisson, angle,
                                                 restol)
    return u0, u1


@pytest.mark.parametrize('case', ('test_simple', 'test_mixed', 'test_spline'))
def test_example_cases(monkeypatch, case):
    # the example's own test, its main replaced by the port's
    example = importlib.import_module('finitestrain')
    monkeypatch.setattr(example, 'main', _port_main)
    result = unittest.TestResult()
    example.test(case).run(result)
    assert result.testsRun == 1 and not result.skipped
    assert result.wasSuccessful(), result.failures + result.errors


def test_masked_operator_reuse_is_a_fresh_build():
    # a fresh jacobian of the same System under the same mask reuses the
    # masked pattern's plans (Matrix._masked, _device_op, _mg): its device
    # operator, multigrid hierarchy and solve are a fresh build's, bit for bit
    rng = numpy.random.default_rng(41)
    with config.device('cpu'), config.device_solve_min(1):
        _domain, _ns, sqr, _energy, energy1 = tp.finitestrain_forms('nutils_tpu_torch', 32)
        cons = solver.System(sqr, trial='u').solve_constraints(droptol=1e-15)
        system = solver.System(energy1, trial='u')
        arguments, x = system.deconstruct({}, cons)
        # at a displaced state (at zero some couplings vanish, and scipy's
        # product drops them from the masked pattern)
        jac1, res1 = system.assemble_jacobian_residual(arguments, x + 0.01 * rng.standard_normal(x.shape))
        jac1.solve_leniently(res1, symmetric=True, rtol=1e-3)
        x2 = x + 0.01 * rng.standard_normal(x.shape)
        solves = []
        for fresh in (False, True):
            jac, res = system.assemble_jacobian_residual(arguments, x2)
            if fresh:
                del jac._parent._pattern_of()._masked_pattern
            dx = jac.solve_leniently(res, symmetric=True, rtol=1e-3)
            masked = jac._parent._masked_solve_cache[1]
            solves.append((dx, masked, dict(jac._solve_stats)))
        (dx2, m2, stats2), (dx3, m3, stats3) = solves
        assert m2._pattern_src is jac1._parent._masked_solve_cache[1]._pattern_src
        assert m2.indices is m2._pattern_src.indices and m3.indices is not m2.indices  # refilled, built
        assert m3._pattern_src is not m2._pattern_src
        # the hierarchy's prolongations, level plans and Galerkin products'
        # plans (made at the pattern's second meeting), kept with the pattern
        plans = m2._pattern_src._mg_plans
        assert {key[0] for key in plans} == {'P', 'level', 'galerkin'}
        assert all(held[2] is not None for key, held in plans.items() if key[:2] == ('galerkin', 0))
        assert stats2['precon'] == stats3['precon'] == 'mg' and stats2['iters'] == stats3['iters']
        (kind2, op2), (kind3, op3) = m2._device_op(), m3._device_op()
        assert kind2 == kind3 and all(torch.equal(a, b) for a, b in zip(op2, op3))
        g2, g3 = m2._mg(), m3._mg()
        assert g2.levels == g3.levels
        for a, b in ((g2.ws, g3.ws), (g2.dinvs, g3.dinvs), ((g2.coarse_inv,), (g3.coarse_inv,))):
            assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert numpy.array_equal(dx2, dx3)


@pytest.mark.parametrize('grid', [(9, 9), (17, 17, 2), (5, 9, 3), (33,)])
def test_planned_galerkin_is_scipys(grid):
    # the multigrid set-up's Galerkin product P^T A P from a plan of
    # scipy's sums, on a masked operator of a random stencil over a grid
    # (some values zero, of both signs), against scipy's product bit for
    # bit: the same entries, and the entries scipy drops zero; the plan is
    # made at a pattern's second meeting only
    import scipy.sparse
    from nutils_tpu_torch.ops import mg
    rng = numpy.random.default_rng(len(grid) * 100 + grid[0])
    n = int(numpy.prod(grid))
    idx = numpy.arange(n).reshape(grid)
    rows, cols = [], []
    for off in numpy.ndindex(*(3,) * len(grid)):
        sl = tuple(slice(max(0, 1 - o), s - max(0, o - 1)) for o, s in zip(off, grid))
        sh = tuple(slice(max(0, o - 1), s - max(0, 1 - o)) for o, s in zip(off, grid))
        rows.append(idx[sl].ravel())
        cols.append(idx[sh].ravel())
    rows, cols = numpy.concatenate(rows), numpy.concatenate(cols)
    flags = mg._coarsen_flags(grid, (False,) * len(grid), 1)
    P = None
    for size, f in zip(grid, flags):
        P1 = mg._prolong_1d(size) if f else scipy.sparse.eye(size, format='csr')
        P = P1 if P is None else scipy.sparse.kron(P, P1)
    P = P.tocsr()
    A = scipy.sparse.csr_matrix((numpy.ones(len(rows)), (rows, cols)), shape=(n, n))
    A.sum_duplicates()
    A = scipy.sparse.csr_matrix(matrix._masked_csr(A.data, A.indices, A.indptr, rng.random(n) < .8)[::-1],
                                shape=(n, n))
    plans = {}
    for trial in range(3):
        # fresh values on the masked pattern, some of them (explicit) zeros
        A.data = rng.standard_normal(A.nnz)
        A.data[rng.random(A.nnz) < .1] = 0.
        A.data[rng.random(A.nnz) < .05] = -0.
        want = (P.T @ A @ P).tocsr()
        want.sum_duplicates()
        got = mg.galerkin(plans, 0, A, P, 'cpu')
        assert (plans['galerkin', 0, P.shape][2] is None) == (trial == 0)
        assert got.has_sorted_indices and got.toarray().tobytes() == want.toarray().tobytes()
        kept = got.copy()
        kept.eliminate_zeros()
        assert numpy.array_equal(kept.indptr, want.indptr) and numpy.array_equal(kept.indices, want.indices)
        assert kept.data.tobytes() == want.data.tobytes()


@pytest.mark.parametrize('seed', range(4))
def test_masked_csr_is_scipys(seed):
    # Matrix._masked's masked operator, M A M + (I - M), against scipy's
    # products, bit for bit: explicit zeros (of both signs) dropped, a 1 on
    # each fixed row's diagonal
    import scipy.sparse
    rng = numpy.random.default_rng(seed)
    for _ in range(10):
        n = int(rng.integers(1, 80))
        A = scipy.sparse.random(n, n, density=rng.random(), random_state=int(rng.integers(2**31)), format='csr')
        A.data[rng.random(len(A.data)) < .2] = 0.
        A.data[rng.random(len(A.data)) < .1] = -0.
        A.data[rng.random(len(A.data)) < .3] *= -1
        A.sort_indices()
        m = rng.random(n) < rng.random()
        D = scipy.sparse.diags(m.astype(float))
        want = (D @ A @ D + scipy.sparse.diags(1. - m)).tocsr()
        indptr, indices, data = matrix._masked_csr(A.data, A.indices, A.indptr, m)
        assert numpy.array_equal(indptr, want.indptr) and numpy.array_equal(indices, want.indices)
        assert data.tobytes() == want.data.tobytes()


@pytest.mark.parametrize('seed', range(4))
def test_masked_refill_is_a_fresh_build(seed):
    # a masked pattern refilled with the values of another matrix of its
    # source pattern: _masked_csr's bits, or None where the zeros moved
    import scipy.sparse
    rng = numpy.random.default_rng(seed + 10)
    n = int(rng.integers(2, 80))
    A = scipy.sparse.random(n, n, density=rng.random(), random_state=int(rng.integers(2**31)), format='csr')
    A.sort_indices()
    m = rng.random(n) < rng.random()
    indptr, indices, _data = matrix._masked_csr(A.data, A.indices, A.indptr, m)
    held = matrix._MaskedPattern(indptr, indices, A.shape, A.indptr, A.indices, A.data, m)
    for trial in range(4):
        data = rng.standard_normal(A.nnz) * (A.data != 0)
        if trial == 3:  # a zero where a value was, in a free row and column
            free = numpy.flatnonzero(held._keep)
            if len(free):
                data[free[0]] = -0.
        want = matrix._masked_csr(data, A.indices, A.indptr, m)
        got = held.refill(data)
        moved = not (numpy.array_equal(want[0], indptr) and numpy.array_equal(want[1], indices))
        assert (got is None) == moved and moved == (trial == 3 and held._keep.any())
        if got is not None:
            assert got.tobytes() == want[2].tobytes()


def _finite_strain_masked(nelems):
    '''The masked operator of the finite-strain jacobian at the linear
    solution (Minimize's first solve), ``nelems`` squares a side.'''
    _domain, _ns, sqr, energy, energy1 = tp.finitestrain_forms('nutils_tpu_torch', nelems, angle=20.)
    cons = solver.System(sqr, trial='u').solve_constraints(droptol=1e-15)
    args0 = solver.System(energy, trial='u').solve(constrain=cons)
    system = solver.System(energy1, trial='u')
    jac, res = system.assemble_jacobian_residual(*system.deconstruct(args0, cons))
    return jac, res


def test_smoother_damped_where_it_diverges():
    # OMEGA times the largest eigenvalue of D^-1 A: 0.8 x 2.69 on the
    # finite-strain jacobian at 24^2 (and growing under refinement), where
    # weighted Jacobi diverges and MG-CG fails; the estimate lies below the
    # dense eigenvalue and within 10%; the level's rows whose absolute sum
    # exceeds SMOOTHING_BOUND / OMEGA times their diagonal are raised to it
    # (every Gershgorin row sum of OMEGA D^-1 A then at most the bound), the
    # others keep their diagonal, and MG-CG converges in a few iterations
    import scipy.linalg
    from nutils_tpu_torch.ops import mg
    with config.device('cpu'), config.device_solve_min(1):
        jac, res = _finite_strain_masked(24)
        dx = jac.solve(res, symmetric=True, rtol=1e-3, solver='cg')
        stats = jac._solve_stats
        masked = jac._parent._masked_solve_cache[1]
        ks, shape, periodic = masked._mg().levels[0]
        dinv = masked._mg().dinvs[0].reshape(-1).numpy()
        A = masked._scipy()
        d = A.diagonal()
        estimate = mg.smoothing_estimate(masked._device_op()[1][0], torch.as_tensor((1 / d).reshape(shape)), ks,
                                         shape, periodic)
    lam = scipy.linalg.eigvalsh(A.toarray() / numpy.sqrt(numpy.outer(d, d)))[-1]
    assert mg.OMEGA * lam > 2 and .9 * lam <= estimate <= lam
    rows = numpy.asarray(abs(A).sum(axis=1)).ravel()
    raised = mg.OMEGA * rows > mg.SMOOTHING_BOUND * d
    assert raised.any() and (~raised).any()
    assert numpy.array_equal(dinv[~raised], 1 / d[~raised])
    assert (mg.OMEGA * rows * dinv <= mg.SMOOTHING_BOUND * (1 + 1e-15)).all()
    assert stats['precon'] == 'mg' and stats['accepted_on_device'] and stats['iters'] <= 20
    assert numpy.linalg.norm(jac @ dx - res) <= 1e-3 * numpy.linalg.norm(res)


@pytest.mark.parametrize('degree', (1, 2))
def test_smoother_of_a_laplacian_keeps_its_bits(monkeypatch, degree):
    # the Laplace example's hierarchies (constraints and solve): no level's
    # diagonal is raised; at degree 1 every level's Gershgorin bound is at
    # most 2 (2 on the solve's levels, 1.5 on the constraints'), so no
    # power-step estimate runs, at degree 2 the estimates that run lie
    # within the bound
    from nutils_tpu_torch.ops import mg
    made = []
    setup = mg.setup
    monkeypatch.setattr(mg, 'setup', lambda *args, **kwargs: made.append(setup(*args, **kwargs)) or made[-1])
    with config.device('cpu'), config.device_solve_min(1):
        tp.laplace_example('nutils_tpu_torch', 32, degree=degree)
    levels = [level for hierarchy in made for level in hierarchy.smoothing]
    assert levels and not any(raised for _shape, _bound, _lam, raised in levels)
    if degree == 1:
        assert all(lam is None and mg.OMEGA * bound <= mg.SMOOTHING_BOUND for _shape, bound, lam, _raised in levels)
    else:
        estimated = [lam for _shape, _bound, lam, _raised in levels if lam is not None]
        assert estimated and all(mg.OMEGA * lam <= mg.SMOOTHING_BOUND for lam in estimated)


def test_masked_operator_on_the_parents_grid():
    # the constraints' masked operator of a vector field keeps the stencil
    # jacobian's grid (33, 33, 2), which its multigrid hierarchy coarsens;
    # inferred from its pattern alone it took (1089, 2), coarsened along one
    # axis only (solve_constraints at 720^2 then spent minutes inverting the
    # coarsest level)
    with config.device('cpu'), config.device_solve_min(1):
        _domain, _ns, sqr, _energy, _energy1 = tp.finitestrain_forms('nutils_tpu_torch', 32)
        system = solver.System(sqr, trial='u')
        system.solve_constraints(droptol=1e-15)
        jac = system._cache['jacmat']
        masked = jac._masked_solve_cache[1]
        kind = masked._device_op()[0]
        levels = masked._mg().levels
    assert kind[0] == 'stencil' and kind[2] == jac._grid == (33, 33, 2)
    assert [shape for _ks, shape, _per in levels] == [(33, 33, 2), (17, 17, 2)]


def test_best_iterate_of_a_submatrix():
    # a device solve that misses its tolerance on a constrained jacobian:
    # solve_leniently returns the best iterate of the free rows, and the
    # parent's constrained solve raises it with the fixed values in place
    with config.device('cpu'), config.device_solve_min(1):
        jac, res = _finite_strain_masked(8)
        x = jac.solve_leniently(res, symmetric=True, rtol=1e-12, solver='cg', maxiter=1)
        assert x.shape == res.shape and numpy.isfinite(x).all()
        parent, free = jac._parent, jac._mask
        xfix = numpy.where(free, numpy.nan, 0.5)
        with pytest.raises(matrix.ToleranceNotReached) as caught:
            parent.solve(numpy.ones(parent.shape[0]), constrain=xfix, solver='cg', rtol=1e-12, maxiter=1)
    assert caught.value.best.shape == (parent.shape[0],) and (caught.value.best[~free] == .5).all()


def test_smoother_of_a_negative_diagonal():
    # a compressed element of the St. Venant-Kirchhoff energy can leave a
    # diagonal entry below zero (the finite-strain jacobian at 400^2 and
    # 720^2); that level's rows take the l1 bound, every inverse diagonal
    # positive
    from nutils_tpu_torch.ops import mg
    with config.device('cpu'), config.device_solve_min(1):
        jac, _res = _finite_strain_masked(32)
        A = jac._parent._masked(jac._mask)._scipy().tocsr()
        row = int(numpy.flatnonzero(jac._mask)[40])
        slot = A.indptr[row] + int(numpy.flatnonzero(A.indices[A.indptr[row]:A.indptr[row + 1]] == row)[0])
        A.data[slot] = -.05 * A.data[slot]
        bent = matrix.Matrix(A.indptr, A.indices, A.data, A.shape)
        bent._field_grids = ((jac._parent._grid, jac._parent._periodic),)
        dinv = bent._mg().dinvs[0].reshape(-1).numpy()
    rows = numpy.asarray(abs(A).sum(axis=1)).ravel()
    assert (dinv > 0).all() and dinv[row] == 1 / (mg.OMEGA / mg.SMOOTHING_BOUND * rows[row])
