'''Problem builders shared by the tests of the PyTorch port
(tests/test_torch_*.py): the same problem through ``nutils_tpu`` and
``nutils_tpu_torch``.  Holds no tests.'''

import importlib

import numpy

PACKAGES = ('nutils_tpu', 'nutils_tpu_torch')


def modules(pkg):
    '''(function, mesh, solver, config) of package ``pkg``.'''
    return tuple(importlib.import_module(f'{pkg}.{name}')
                 for name in ('function', 'mesh', 'solver', 'utils.config'))


def build_laplace(pkg, nelems, dtype=numpy.float64, reaction=False):
    '''The bench's Laplace slice (``bench.build_laplace``): a reaction-
    diffusion energy on the unit square, degree-1 std basis, gauss degree 2.
    Leaves ``config.floatx`` at ``dtype``.'''
    function, mesh, solver, config = modules(pkg)
    config.floatx.value = dtype
    topo, geom = mesh.unitsquare(nelems, 'square')
    u = topo.field('u', btype='std', degree=1)
    g = function.grad(u, geom)
    J = function.J(geom)
    f = function.sin(geom[0]) * function.cosh(geom[1])
    energy = topo.integral(((g @ g) / 2 + (u * u) / 2 * reaction - f * u) * J, degree=2)
    return solver.System(energy, trial='u')


def build_periodic(pkg, nelems):
    '''The SPD reaction-diffusion system of ``__graft_entry__._build_spd_system``:
    periodic in axis 0, explicit vertex coordinates.'''
    function, mesh, solver, _config = modules(pkg)
    topo, geom = mesh.rectilinear([numpy.linspace(0, 1, nelems + 1)] * 2, periodic=(0,))
    u = topo.field('u', btype='std', degree=1)
    g = function.grad(u, geom)
    J = function.J(geom)
    f = function.sin(geom[0]) * function.cosh(geom[1])
    energy = topo.integral(((g @ g) / 2 + (u * u) / 2 - f * u) * J, degree=2)
    return solver.System(energy, trial='u')


def _taylor_hood_namespace(pkg, topo, geom):
    function = importlib.import_module(f'{pkg}.function')
    Namespace = importlib.import_module(f'{pkg}.expression').Namespace
    ns = Namespace()
    ns.x = geom
    ns.define_for('x', gradient='∇', jacobians=('dV',))
    ns.u = topo.field('u', btype='std', degree=2, shape=[2])
    ns.p = topo.field('p', btype='std', degree=1)
    ns.v = function.replace_arguments(ns.u, 'u:v')
    ns.q = function.replace_arguments(ns.p, 'p:q')
    return ns


def build_ns(pkg, nelems, dtype=numpy.float64, etype='square'):
    """The bench's Navier-Stokes Newton step (``bench.build_ns``): Taylor-Hood
    P2/P1 implicit-Euler step on the unit square of ``etype`` elements,
    convection linearized at a random state.  Returns (system, args); leaves
    ``config.floatx`` at ``dtype``."""
    function, mesh, solver, config = modules(pkg)
    config.floatx.value = dtype
    topo, geom = mesh.unitsquare(nelems, etype)
    ns = _taylor_hood_namespace(pkg, topo, geom)
    ns.δ = function.eye(2)
    ns.u0_i = 'sin(x_0) cos(x_1) δ_i0 - cos(x_0) sin(x_1) δ_i1'  # prior state (divergence-free)
    ns.dt = 0.01
    ns.nu = 0.001
    ns.eps = 0.001  # pressure stabilization: removes the nullspace without BCs
    res = topo.integral(
        '(v_i (u_i - u0_i) / dt + v_i u_j ∇_j(u_i) + nu ∇_j(v_i) ∇_j(u_i)'
        ' - p ∇_i(v_i) + q ∇_i(u_i) + eps p q) dV' @ ns, degree=6)
    system = solver.System(res, trial='u,p', test='v,q')
    rng = numpy.random.default_rng(0)
    args = {t: 0.1 * rng.standard_normal(shape)
            for t, shape in zip(system.trials, system.trial_shapes)}
    return system, args


def build_ns_tri(pkg, nelems, dtype=numpy.float64):
    """``build_ns``'s weak form on ``unitsquare(nelems, 'triangle')``: the
    unstructured triangle slice, whose jacobian has CSR form."""
    return build_ns(pkg, nelems, dtype, etype='triangle')


def build_th_periodic(pkg, nelems):
    """The Taylor-Hood step of ``__graft_entry__._build_th_system``: periodic
    in axis 0, explicit vertex coordinates."""
    function, mesh, solver, _config = modules(pkg)
    topo, geom = mesh.rectilinear([numpy.linspace(0, 1, nelems + 1)] * 2, periodic=(0,))
    ns = _taylor_hood_namespace(pkg, topo, geom)
    ns.δ = function.eye(2)
    ns.π = numpy.pi
    ns.u0_i = 'sin(2 π x_0) cos(π x_1) δ_i0'
    ns.dt = 0.01
    ns.nu = 0.01
    ns.eps = 0.001
    res = topo.integral(
        '(v_i (u_i - u0_i) / dt + v_i u_j ∇_j(u_i) + nu ∇_j(v_i) ∇_j(u_i)'
        ' - p ∇_i(v_i) + q ∇_i(u_i) + eps p q) dV' @ ns, degree=6)
    return solver.System(res, trial='u,p', test='v,q')


def build_stokes(pkg, nelems=12, dtype=numpy.float64, mass=0.01, nu=1.0):
    """The Stokes-class mixed system of ``tests/test_device_op.py``
    (``_taylor_hood_system``): P2 velocity, P1 pressure, a small mass
    regularization; returns its jacobian at zero arguments, assembled with
    ``config.floatx`` at ``dtype``."""
    _function, mesh, solver, config = modules(pkg)
    with config.floatx(dtype):
        topo, geom = mesh.unitsquare(nelems, 'square')
        ns = _taylor_hood_namespace(pkg, topo, geom)
        ns.m = mass
        ns.nu = nu
        ns.eps = 0.001
        res = topo.integral('(m u_i v_i + nu ∇_j(v_i) ∇_j(u_i) - p ∇_i(v_i)'
                            ' + q ∇_i(u_i) + eps p q) dV' @ ns, degree=5)
        system = solver.System(res, trial='u,p', test='v,q')
        args = {t: numpy.zeros(shape) for t, shape in zip(system.trials, system.trial_shapes)}
        jac, _ = system.assemble_jacobian_residual(args)
    return jac


def blockgrid_csr(name):
    """(data, indices, indptr, field offsets, field grids) of a Taylor-Hood
    jacobian that nutils_tpu assembles: ``'stokes8'``, the Stokes system on
    8x8 elements, or ``'th_periodic12'``, the periodic Navier-Stokes step
    on 12x12 (at 8 elements the periodic pressure axis is too short for the
    wrapped block form in both packages)."""
    if name == 'stokes8':
        jac = build_stokes('nutils_tpu', 8)
    else:
        system = build_th_periodic('nutils_tpu', 12)
        rng = numpy.random.default_rng(0)
        args = {t: 0.1 * rng.standard_normal(s) for t, s in zip(system.trials, system.trial_shapes)}
        jac, _res = system.assemble_jacobian_residual(args)
    return (numpy.asarray(jac.data), numpy.asarray(jac.indices), numpy.asarray(jac.indptr),
            tuple(jac._field_offsets), tuple(jac._field_grids))


def rel(a, b):
    '''Normwise relative difference of two arrays.'''
    a = numpy.asarray(a, dtype=numpy.float64)
    b = numpy.asarray(b, dtype=numpy.float64)
    return float(numpy.linalg.norm(a - b) / max(numpy.linalg.norm(b), 1e-300))
