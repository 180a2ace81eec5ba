'''The solve entry points of the PyTorch port (``System.solve`` with
``Direct`` and ``Newton``, ``System.solve_constraints``) against
nutils_tpu: the Laplace example's constraints, solution and L2 error, and
Newton's residual norms on a nonlinear form with constraints.  Tolerances:
1e-12 where a direct solve decides the value; 1e-9 where the solves run on
the device (CG and GMRES to rtol 1e-11, the default of a constrained
solve); Newton's residual norms to 1e-10 relative.'''

import importlib

import numpy
import pytest

import _torch_parity as tp
from nutils_tpu.utils import config as config_jax
from nutils_tpu_torch import solver
from nutils_tpu_torch.utils import config

EXAMPLE_CASES = [('square', 'std', 1), ('mixed', 'std', 2), ('square', 'spline', 2)]


@pytest.mark.parametrize('device_solve_min', ('default', 1))
@pytest.mark.parametrize('etype,btype,degree', EXAMPLE_CASES)
def test_laplace_example(tmp_path, monkeypatch, etype, btype, degree, device_solve_min):
    # the JAX package's example itself (it writes its figure into the
    # working directory) against the port's copy of its body
    monkeypatch.chdir(tmp_path)
    main = importlib.import_module('laplace').main
    smin = config.device_solve_min.value if device_solve_min == 'default' else device_solve_min
    with config_jax.device_solve_min(smin):
        want = main(nelems=4, etype=etype, btype=btype, degree=degree)
    with config.device('cpu'), config.device_solve_min(smin):
        got = tp.laplace_example('nutils_tpu_torch', 4, etype, btype, degree)
    tol = 1e-12 if device_solve_min == 'default' else 1e-9
    (cons, u, err), (cons_want, u_want, err_want) = got, want
    assert numpy.array_equal(numpy.isnan(cons), numpy.isnan(cons_want))
    assert numpy.nanmax(numpy.abs(cons - cons_want)) <= tol * numpy.nanmax(numpy.abs(cons_want))
    assert numpy.abs(u - u_want).max() <= tol * numpy.abs(u_want).max()
    assert abs(err - err_want) <= tol * err_want


def _nonlinear(pkg):
    '''The nonlinear form of tests/test_solver.py (``test_assembly_paths_
    agree``), u = 0 on the left and u = 1 on the right, as (System,
    constraints).'''
    function, mesh, solver_, _config = tp.modules(pkg)
    topo, geom = mesh.rectilinear([numpy.linspace(0, 1, 9)] * 2)
    u = topo.field('u', btype='std', degree=2)
    v = function.replace_arguments(u, 'u:v')
    J = function.J(geom)
    g = function.grad(u, geom)
    gv = function.grad(v, geom)
    res = topo.integral(((gv @ g) + v * u ** 3 - v) * J, degree=4)
    sqr = topo.boundary['left'].integral(u ** 2 * J, degree=4) \
        + topo.boundary['right'].integral((u - 1) ** 2 * J, degree=4)
    cons = solver_.System(sqr, trial='u').solve_constraints(droptol=1e-15)
    return solver_.System(res, trial='u', test='v'), cons


def test_newton_residual_norms():
    sj, cons_j = _nonlinear('nutils_tpu')
    with config.device('cpu'):
        st, cons = _nonlinear('nutils_tpu_torch')
        assert numpy.array_equal(numpy.isnan(cons['u']), numpy.isnan(cons_j['u']))
        norms = []
        newton_j = importlib.import_module('nutils_tpu.solver').Newton()(sj, arguments={}, constrain=cons_j)
        newton_t = solver.Newton()(st, arguments={}, constrain=cons)
        for _ in range(5):
            (_args_j, rj), (_args_t, rt) = next(newton_j), next(newton_t)
            norms.append((rt, rj))
    assert norms[0][1] > 1 and norms[-1][1] < 1e-10 * norms[0][1]  # it converges
    for rt, rj in norms:
        if rj > 1e-8 * norms[0][1]:  # above the rounding floor
            assert abs(rt - rj) <= 1e-10 * rj


def test_solve_newton_and_direct():
    # System.solve picks Newton for the nonlinear form, as the JAX package
    # does (Direct for a linear one: test_laplace_example)
    sj, cons_j = _nonlinear('nutils_tpu')
    want = sj.solve(constrain=cons_j, tol=1e-10)
    with config.device('cpu'):
        st, cons = _nonlinear('nutils_tpu_torch')
        assert not st.is_linear
        got = st.solve(constrain=cons, tol=1e-10)
        with pytest.raises(solver.SolverError):
            st.solve(constrain=cons, tol=1e-10, maxiter=1)
        with pytest.raises(ValueError):
            st.solve(constrain=cons)  # a nonlinear solve needs a tolerance
    assert numpy.abs(got['u'] - want['u']).max() <= 1e-12 * numpy.abs(want['u']).max()


def test_assemble_surface():
    # assemble_residual and assemble_jacobian against the JAX package; the
    # value of this unsymmetric form is undefined in both packages
    rng = numpy.random.default_rng(2)
    sj, _cons = _nonlinear('nutils_tpu')
    args = {'u': rng.standard_normal(sj.trial_shapes[0])}
    with pytest.raises(importlib.import_module('nutils_tpu.solver').SolverError):
        sj.assemble_value(args)
    with config.device('cpu'):
        st, _cons = _nonlinear('nutils_tpu_torch')
        r = st.assemble_residual(args)
        jac = st.assemble_jacobian(args)
        with pytest.raises(solver.SolverError):
            st.assemble_value(args)
        assert st.assemble(args)[2] is None
    assert tp.rel(r, numpy.asarray(sj.assemble_residual(args))) <= 1e-12
    assert tp.rel(jac.export('dense'), sj.assemble_jacobian(args).export('dense')) <= 1e-12


def test_deconstruct():
    # the free-dof vector and NaN templates of every kind of constraint
    rng = numpy.random.default_rng(3)
    sj, _ = _nonlinear('nutils_tpu')
    with config.device('cpu'):
        st, _ = _nonlinear('nutils_tpu_torch')
    n = st.trial_shapes[0][0]
    mask = rng.random(n) < .3
    values = numpy.where(mask, rng.standard_normal(n), numpy.nan)
    u = rng.standard_normal(n)
    for arguments, constrain in (({}, {}), ({}, {'u': mask}), ({}, {'u': values}), ({'u': u}, {}),
                                 ({'u': u}, {'u': mask}), ({'u': u}, {'u': values})):
        (at, xt), (aj, xj) = st.deconstruct(arguments, constrain), sj.deconstruct(arguments, constrain)
        assert numpy.array_equal(xt, xj) and numpy.array_equal(at['u'], aj['u'], equal_nan=True)
