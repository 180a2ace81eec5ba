'''Complex values, ``function.Custom`` and the general eigensolver in the
PyTorch port against the JAX package: the cases of ``tests/test_complex.py``
through the port; the cases of ``tests/test_function_derivative.py``,
``tests/test_derivative_matrix.py`` and ``tests/test_evaluable_nodes.py``
that use ``Custom``, each user function written once a package (in torch
for the port, in ``jax.numpy`` for the JAX package: the port's deliberate
contract) with values and derivatives compared to 1e-12; ``function.eig``;
and coil's complex form on its tensor product with a revolution space, its
assembled values to 1e-12, with the generic route's seed passes chunked or
whole.'''

import numpy
import pytest

import _torch_parity as tp
import _torch_ported_cases as pc
from nutils_tpu_torch.utils import config

CASES = pc.cases('test_complex')


@pytest.mark.parametrize('name,fname,kwargs', [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_jax_case_through_the_port(name, fname, kwargs, tmp_path, monkeypatch):
    pc.run(name, fname, kwargs, {'tmp_path': tmp_path, 'monkeypatch': monkeypatch})


def _customs(pkg):
    '''The ``Custom`` subclasses of the JAX package's tests, written in the
    array library of package ``pkg``.'''
    function = tp.modules(pkg)[0]
    if pkg == 'nutils_tpu':
        import jax.numpy as xp
        logaddexp = xp.logaddexp
        stack, eye, broadcast = xp.stack, xp.eye, xp.broadcast_to
    else:
        import torch as xp
        logaddexp = lambda x, y: torch_logaddexp(x, y)  # noqa: E731
        stack, eye, broadcast = xp.stack, lambda k: xp.eye(k, dtype=xp.float64), xp.broadcast_to

    class Sigmoid(function.Custom):
        @staticmethod
        def evalf(x):
            return 1 / (1 + xp.exp(-x))

    class Doubler(function.Custom):
        @staticmethod
        def evalf(x):
            return 2.0 * x

        @staticmethod
        def partial_derivative(iarg, x):
            # deliberately wrong (3 instead of 2) to prove the override is used
            n, k = x.shape
            return broadcast(3.0 * eye(k), (n, k, k))

    class Squared(function.Custom):
        @staticmethod
        def evalf(x):
            return (x * x).sum(-1)

    class Softplus(function.Custom):
        @staticmethod
        def evalf(x):
            return logaddexp(x, 0.0 * x)

    class SinTimes(function.Custom):
        '''sin(x_0) x_1 with its partials given.'''
        @staticmethod
        def evalf(x):
            return xp.sin(x[:, 0]) * x[:, 1]

        @staticmethod
        def partial_derivative(iarg, x):
            return stack([xp.cos(x[:, 0]) * x[:, 1], xp.sin(x[:, 0])], -1)

    return dict(Sigmoid=Sigmoid, Doubler=Doubler, Squared=Squared, Softplus=Softplus, SinTimes=SinTimes)


def torch_logaddexp(x, y):
    import torch
    return torch.logaddexp(x, y)


def _both(build):
    '''build(pkg, function, mesh, solver, customs) -> list of arrays, for
    each package (the port on the CPU).'''
    out = []
    for pkg in tp.PACKAGES:
        function, mesh, solver, _config = tp.modules(pkg)
        with config.device('cpu'):
            out.append([numpy.asarray(v) for v in build(pkg, function, mesh, solver, _customs(pkg))])
    return out


def _agree(jax_vals, port_vals, tol=1e-12):
    for a, b in zip(jax_vals, port_vals):
        assert a.shape == b.shape
        assert numpy.allclose(b, a, rtol=tol, atol=tol * max(1., numpy.abs(a).max())), abs(a - b).max()


def test_custom_values_and_derivatives():
    x0 = numpy.linspace(-2, 2, 5)

    def build(pkg, function, mesh, solver, c):
        x = function.Argument('x', (5,))
        s = c['Sigmoid'](args=[x], shape=(5,))
        d = c['Doubler'](args=[x], shape=(5,))
        return [s.eval(x=x0), function.derivative(function.sum_(s, 0), 'x').eval(x=x0), d.eval(x=x0),
                function.derivative(function.sum_(d, 0), 'x').eval(x=x0)]
    want, got = _both(build)
    _agree(want, got)
    sig = 1 / (1 + numpy.exp(-x0))
    assert numpy.allclose(got[1], sig * (1 - sig), rtol=1e-10) and numpy.allclose(got[3], 3.)


def test_custom_on_a_topology_and_in_a_functional():
    x0 = .5 * numpy.random.default_rng(3).standard_normal(25)

    def build(pkg, function, mesh, solver, c):
        topo, geom = mesh.unitsquare(4, 'square')
        area = topo.integral(c['Squared'](args=[geom], shape=()) * function.J(geom), degree=3).eval()
        u = topo.field('u', btype='std', degree=1)
        functional = topo.integral(c['Softplus'](args=(u,), shape=u.shape, dtype=float) * function.J(geom), degree=4)
        value, grad = function.eval([functional, function.derivative(functional, 'u')], {'u': x0})
        res = topo.integral((c['Softplus'](args=(u,), shape=(), dtype=float) + u * u) * function.J(geom), degree=4)
        jac, r = solver.System(res, trial='u').assemble_jacobian_residual({'u': x0})
        return [area, value, grad, r, jac.export('dense')]
    want, got = _both(build)
    _agree(want, got)
    assert float(got[0]) == pytest.approx(2 / 3, rel=1e-10)


def test_custom_node_with_partials():
    xv = numpy.random.default_rng(5).random((6, 2))

    def build(pkg, function, mesh, solver, c):
        import importlib
        ev = importlib.import_module(f'{pkg}.evaluable')
        cls = c['SinTimes']
        leaf = ev.Leaf('x', (6, 2))
        node = ev.CustomNode(cls.evalf, (leaf,), (), float, 1, partials=cls.partial_derivative)
        return [ev.Compiled(node).trace({}, {'x': xv}), ev.Compiled(ev.grad(node, leaf)).trace({}, {'x': xv})]
    want, got = _both(build)
    _agree(want, got)
    assert numpy.allclose(got[1], numpy.stack([numpy.cos(xv[:, 0]) * xv[:, 1], numpy.sin(xv[:, 0])], -1))


def test_eig_as_the_jax_package():
    a = numpy.random.default_rng(2).standard_normal((3, 4, 4))

    def build(pkg, function, mesh, solver, c):
        w, v = function.eig(function.asarray(a))
        return function.eval([w, v])
    want, got = _both(build)
    _agree(want, got, 1e-13)
    assert numpy.iscomplexobj(got[0]) and numpy.allclose(a @ got[1], got[1] * got[0][:, None, :])


@pytest.mark.parametrize('freq', [0., 1000.])
def test_coil_form_as_the_jax_package(freq):
    from nutils_tpu_torch import solver as solver_torch
    out = []
    for pkg in tp.PACKAGES:
        with config.device('cpu'):
            system, _ns = tp.coil_forms(pkg, nelems=4, freq=freq)
            arguments, x = system.deconstruct({}, {})
            jac, res = system.assemble_jacobian_residual(arguments, x)
            out.append((jac.export('dense'), numpy.asarray(res)))
    (jj, rj), (jt, rt) = out
    assert jt.shape == jj.shape and numpy.allclose(jt, jj, rtol=0, atol=1e-12 * numpy.abs(jj).max())
    assert numpy.allclose(rt, rj, rtol=0, atol=1e-12 * numpy.abs(rj).max())
    # the generic route's seeds in passes of 7: the same values
    keep = solver_torch.GENERIC_SEED_CHUNK
    solver_torch.GENERIC_SEED_CHUNK = 7
    try:
        with config.device('cpu'):
            system, _ns = tp.coil_forms('nutils_tpu_torch', nelems=4, freq=freq)
            assert set(system._assembly_routes.values()) == {'generic'}
            arguments, x = system.deconstruct({}, {})
            jac, res = system.assemble_jacobian_residual(arguments, x)
    finally:
        solver_torch.GENERIC_SEED_CHUNK = keep
    assert numpy.allclose(jac.export('dense'), jt, rtol=0, atol=1e-14 * numpy.abs(jt).max())
    assert numpy.array_equal(numpy.asarray(res), rt)
