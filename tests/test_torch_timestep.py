'''Time stepping and the rest of the solver surface of the PyTorch port
(``System.step``, ``Arnoldi``, ``Pseudotime``, ``solve_linear``,
``newton``, ``minimize``, ``pseudotime``, ``thetamethod``,
``impliciteuler``, ``cranknicolson``, ``optimize``) against nutils_tpu on
the CPU: the cases of ``tests/test_solver.py`` that use them, and a
Taylor-Hood step with its history and timestep as arguments, Crank-Nicolson
on a heat equation, a timestep that changes between the steps of one
System, a time argument the residual does not read, the layout planned once
over a run of steps and the inertia jacobian's embedding.

Tolerances: 1e-12 relative where direct solves decide the result (every
system here has fewer dofs than ``config.device_solve_min``); the inertia
jacobian's pattern exactly and its values to 1e-13 (the two packages sum
the element terms in other orders); within the port, a reused System and
a fresh one give the same bits.'''

import contextlib
import functools
import inspect

import numpy
import pytest

import _torch_parity as tp
from nutils_tpu_torch import solver
from nutils_tpu_torch.utils import config

TOL = 1e-12


def _on(pkg):
    '''The context a case of package ``pkg`` runs in: the port on the CPU.'''
    return config.device('cpu') if pkg == 'nutils_tpu_torch' else contextlib.nullcontext()


CASES = tp.TIMESTEP_CASES


@pytest.mark.parametrize('case', CASES)
def test_against_nutils_tpu(case):
    want = CASES[case]('nutils_tpu')
    with config.device('cpu'):
        got = CASES[case]('nutils_tpu_torch')
    assert got.keys() == want.keys()
    for key in want:
        g, w = numpy.asarray(got[key]), numpy.asarray(want[key])
        assert g.shape == w.shape and numpy.array_equal(numpy.isnan(g), numpy.isnan(w))
        assert tp.rel(numpy.nan_to_num(g), numpy.nan_to_num(w)) <= TOL, key


@pytest.mark.parametrize('pkg', tp.PACKAGES)
def test_step_timestep_halving_retry(pkg):
    '''``tests/test_solver.py``'s case: the timestep halves on
    SolverError up to ``maxretry`` times and lands at the same final time;
    the same calls in both packages.'''
    with _on(pkg):
        system, args = tp.decay(pkg, read_t=False)
        calls, out = tp.step_with_failures(pkg, system, args, timearg=None, timesteparg='dt')
        # dt 0.1 fails, 0.05 fails, 0.025 succeeds 4x (two halvings: 4 substeps)
        assert calls == [0.1, 0.05, 0.025, 0.025, 0.05, 0.025, 0.025]
        assert 0 < numpy.nanmax(out['u']) < 1.0
        # exhausting maxretry re-raises
        calls, out = tp.step_with_failures(pkg, system, args, maxretry=1, timesteparg='dt')
        assert out is None and calls == [0.1, 0.05]
        # no retry where neither the time nor the timestep is read
        calls, out = tp.step_with_failures(pkg, system, dict(args, dt=0.1), timearg='t')
        assert out is None and calls == [0.1]
    if pkg == 'nutils_tpu_torch':
        want = tp.modules('nutils_tpu')[2].System.step  # the reference's own signature
        assert inspect.signature(tp.modules(pkg)[2].System.step) == inspect.signature(want)


def test_halving_states_agree():
    want = tp.step_with_failures('nutils_tpu', *tp.decay('nutils_tpu', read_t=False), timesteparg='dt')
    with config.device('cpu'):
        got = tp.step_with_failures('nutils_tpu_torch', *tp.decay('nutils_tpu_torch', read_t=False),
                                    timesteparg='dt')
    assert got[0] == want[0] and tp.rel(got[1]['u'], want[1]['u']) <= TOL


def test_set_up_once_over_a_run_of_steps(monkeypatch):
    '''Three steps of the Taylor-Hood System plan its jacobian layout once,
    make its feature operators once and assemble through the one set of
    compiled functions; each step's assembly reads that step's history.'''
    layout = solver.System.__dict__['_jac_layout']
    made = []

    def counting(self):
        made.append(self)
        return layout.func(self)
    prop = functools.cached_property(counting)
    prop.__set_name__(solver.System, '_jac_layout')
    monkeypatch.setattr(solver.System, '_jac_layout', prop)
    with config.device('cpu'):
        system, args = tp.taylor_hood_history('nutils_tpu_torch', 6)
        assert set(system._assembly_routes.values()) == {'factored'}
        states = []
        for _ in range(3):
            args = system.step(timestep=0.01, timearg='t', timesteparg='dt', suffix='0', arguments=args, tol=1e-9)
            states.append(args)
            operators = dict(system._operators)
            if len(states) == 1:
                first = operators, set(system._cache)
        assert made == [system]
        # the operators depend on no argument: kept once, the same tensors
        assert operators.keys() == first[0].keys() and all(operators[k][1] is first[0][k][1] for k in operators)
        assert set(system._cache) == first[1]
    for prev, cur in zip(states, states[1:]):
        assert cur['u0'] is prev['u'] and not numpy.array_equal(cur['u'], prev['u'])


def _inertia_cases(pkg):
    '''``Pseudotime._inertia_jacobian`` through both of its branches: a
    list of inertia vectors (one None) aligned with the trials of a system
    of residual vectors, and a functional that reaches one of the trial
    and test pairs of a two-field system, the second of the two.  Each
    under a constraint of two dofs of ``u``.  [(dense, export('csr'))].'''
    function, mesh, s, _config = tp.modules(pkg)
    topo, geom = mesh.unitsquare(3, 'square')
    J = function.J(geom)
    u = topo.field('u', btype='std', degree=1)
    p = topo.field('p', btype='std', degree=1)
    basis = topo.basis('std', degree=1)
    vectors = s.System([topo.integral(basis * (u - p) * J, degree=2),
                        topo.integral(basis * (p + u * u) * J, degree=2)], trial='u,p')
    v = function.replace_arguments(u, 'u:v')
    q = function.replace_arguments(p, 'p:q')
    weak = s.System(topo.integral((function.grad(v, geom) @ function.grad(u, geom) + q * (p - u)) * J, degree=2),
                    trial='p,u', test='q,v')
    cons = {'u': numpy.where(numpy.arange(16) < 2, 0., numpy.nan)}
    out = []
    for system, inertia in ((vectors, [topo.integral(basis * u * J, degree=2), None]),
                            (weak, topo.integral(u * v * J, degree=2))):
        arguments, x = system.deconstruct({}, cons)
        _, free = system.construct(arguments, x, return_free=True)
        m = s.Pseudotime(inertia, timestep=1.)._inertia_jacobian(system, arguments, free)
        out.append((m.export('dense'), m.export('csr')))
    return out


def test_inertia_jacobian_embedding():
    want = _inertia_cases('nutils_tpu')
    with config.device('cpu'):
        got = _inertia_cases('nutils_tpu_torch')
    for (dg, (data, indices, indptr)), (dw, (wdata, windices, windptr)) in zip(got, want):
        assert dg.shape == dw.shape == (30, 30) and numpy.any(dg)
        assert numpy.array_equal(indptr, windptr) and numpy.array_equal(indices, windices)
        assert numpy.abs(data - wdata).max() <= 1e-13 * numpy.abs(wdata).max()
        assert numpy.abs(dg - dw).max() <= 1e-13 * numpy.abs(dw).max()


NAMES = ('Arnoldi', 'Pseudotime', 'solve_linear', 'newton', 'minimize', 'pseudotime', 'thetamethod',
         'impliciteuler', 'cranknicolson', 'optimize', '_split_trial_test', '_is_single', '_as_cons',
         '_make_system', '_strip_lin', '_with_solve')


@pytest.mark.parametrize('name', NAMES)
def test_signature_is_the_reference(name):
    want = getattr(tp.modules('nutils_tpu')[2], name)
    got = getattr(solver, name)
    if isinstance(want, functools.partial):
        assert isinstance(got, functools.partial) and got.func is solver.thetamethod and got.keywords == want.keywords
        want, got = want.func, got.func
    assert inspect.signature(got) == inspect.signature(want)


def _history_residual(pkg):
    '''The heat residual at 4 squares a side plus the same form in the
    history ``u0``, an argument that is no trial: its gradient stays in the
    factored form's rest.  (System, arguments.)'''
    function = tp.modules(pkg)[0]
    s = tp.modules(pkg)[2]
    _topo, _geom, _u, res, _inertia, u0 = tp.heat(pkg, 4)
    res0 = function.replace_arguments(res, {'u': function.Argument('u0', (25,))})
    system = s.System(function.add(function.multiply(function.asarray(.5), res),
                                   function.multiply(function.asarray(.5), res0)), trial='u', test='v')
    return system, {'u': numpy.zeros(25), 'u0': u0}


def test_argument_field_under_a_gradient():
    '''A field that is an argument but no trial keeps its gradient on the
    factored route: the call-invariant parts under a derivative that
    depends on an argument are not bound as leaves.  At u = 0 the residual
    is the history's part alone.'''
    want, args = _history_residual('nutils_tpu')
    jw, rw = want.assemble_jacobian_residual(args)
    with config.device('cpu'):
        system, _args = _history_residual('nutils_tpu_torch')
        assert set(system._assembly_routes.values()) == {'factored'}
        jf, rf = system.assemble_jacobian_residual(args)
        with system._generic_route():
            jg, rg = system.assemble_jacobian_residual(args)
    assert tp.rel(rf, rg) <= 1e-13 and tp.rel(rf, rw) <= 1e-13 and numpy.linalg.norm(rw) > .5
    assert tp.rel(jf.export('dense'), jw.export('dense')) <= 1e-13
    assert tp.rel(jg.export('dense'), jw.export('dense')) <= 1e-13
