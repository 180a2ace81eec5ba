'''Problem builders shared by the tests of the PyTorch port
(tests/test_torch_*.py): the same problem through ``nutils_tpu`` and
``nutils_tpu_torch``.  Holds no tests.'''

import functools
import importlib

import numpy

PACKAGES = ('nutils_tpu', 'nutils_tpu_torch')


def modules(pkg):
    '''(function, mesh, solver, config) of package ``pkg``.'''
    return tuple(importlib.import_module(f'{pkg}.{name}')
                 for name in ('function', 'mesh', 'solver', 'utils.config'))


def build_laplace(pkg, nelems, dtype=numpy.float64, reaction=False, etype='square', degree=1):
    '''The bench's Laplace slice (``bench.build_laplace``): a reaction-
    diffusion energy on the unit square (of ``etype`` elements), std basis
    of ``degree`` (1), gauss degree 2.  Leaves ``config.floatx`` at
    ``dtype``.'''
    function, mesh, solver, config = modules(pkg)
    config.floatx.value = dtype
    topo, geom = mesh.unitsquare(nelems, etype)
    u = topo.field('u', btype='std', degree=degree)
    g = function.grad(u, geom)
    J = function.J(geom)
    f = function.sin(geom[0]) * function.cosh(geom[1])
    energy = topo.integral(((g @ g) / 2 + (u * u) / 2 * reaction - f * u) * J, degree=2)
    return solver.System(energy, trial='u')


def build_two_field(pkg, nelems):
    '''A symmetric positive definite energy in a P2 vector field ``u`` and
    a P1 scalar field ``p`` on the unit square, coupled weakly: its
    jacobian has block-grid form.'''
    function, mesh, solver, _config = modules(pkg)
    topo, geom = mesh.unitsquare(nelems, 'square')
    ns = _taylor_hood_namespace(pkg, topo, geom)
    energy = topo.integral('(∇_j(u_i) ∇_j(u_i) + u_i u_i + ∇_j(p) ∇_j(p) + p p) / 2 + 0.1 p u_0 dV' @ ns,
                           degree=4)
    return solver.System(energy, trial='u,p')


def laplace_example_forms(pkg, nelems=4, etype='square', btype='std', degree=1):
    '''``examples/laplace.py``'s domain, namespace, weak form ``res`` and
    constraints' functional ``sqr`` through package ``pkg``.'''
    _function, mesh, _solver, _config = modules(pkg)
    Namespace = importlib.import_module(f'{pkg}.expression').Namespace
    domain, geom = mesh.unitsquare(nelems, etype)
    ns = Namespace()
    ns.x = geom
    ns.define_for('x', gradient='∇', normal='n', jacobians=('dV', 'dS'))
    ns.u = domain.field('u', btype=btype, degree=degree)
    ns.v = domain.field('v', btype=btype, degree=degree)
    res = domain.integral('∇_i(v) ∇_i(u) dV' @ ns, degree=degree * 2)
    res -= domain.boundary['right'].integral('v cos(1) cosh(x_1) dS' @ ns, degree=degree * 2)
    sqr = domain.boundary['left'].integral('u^2 dS' @ ns, degree=degree * 2)
    sqr += domain.boundary['top'].integral('(u - cosh(1) sin(x_0))^2 dS' @ ns, degree=degree * 2)
    return domain, ns, res, sqr


def laplace_example(pkg, nelems=4, etype='square', btype='std', degree=1):
    '''``examples/laplace.py``'s ``main`` through package ``pkg``, without
    its figure: (cons, u, L2 error).'''
    solver = modules(pkg)[2]
    domain, ns, res, sqr = laplace_example_forms(pkg, nelems, etype, btype, degree)
    cons = solver.System(sqr, trial='u').solve_constraints(droptol=1e-15)
    args = solver.System(res, trial='u', test='v').solve(constrain=cons)
    err = domain.integral('(u - sin(x_0) cosh(x_1))^2 dV' @ ns, degree=degree * 2).eval(args) ** .5
    return cons['u'], args['u'], err


def elasticity_forms(pkg, nelems=8, etype='square', btype='std', degree=2, poisson=.3):
    '''``examples/elasticity.py``'s domain, namespace and functionals
    through package ``pkg``: the constraints' ``sqr``, the ``energy`` of the
    plate under its load and the traction system's functional.'''
    function, mesh, _solver, _config = modules(pkg)
    Namespace = importlib.import_module(f'{pkg}.expression').Namespace
    domain, geom = mesh.unitsquare(nelems, etype)
    ns = Namespace()
    ns.δ = function.eye(2)
    ns.x = geom
    ns.define_for('x', gradient='∇', normal='n', jacobians=('dV', 'dS'))
    ns.u = domain.field('u', btype=btype, degree=degree, shape=[2])
    ns.X_i = 'x_i + u_i'
    ns.λ = 1
    ns.μ = .5 / poisson - 1
    ns.ε_ij = '.5 (∇_i(u_j) + ∇_j(u_i))'
    ns.σ_ij = 'λ ε_kk δ_ij + 2 μ ε_ij'
    ns.E = 'ε_ij σ_ij'
    ns.q_i = '-δ_i1'
    ns.t = domain.field('t', btype=btype, degree=degree, shape=[2])
    sqr = domain.boundary['top'].integral('u_k u_k dS' @ ns, degree=degree * 2)
    energy = domain.integral('(E - u_i q_i) dV' @ ns, degree=degree * 2)
    traction = energy - domain.boundary['top'].integral('u_i t_i dS' @ ns, degree=degree * 2)
    return domain, ns, sqr, energy, traction


def elasticity(pkg, nelems=8, etype='square', btype='std', degree=2, poisson=.3, **linargs):
    '''``examples/elasticity.py``'s ``main`` through package ``pkg``,
    without its figure, its displacement solve under ``Direct(**linargs)``:
    (cons, u, t, F, the displacement's System), F the total clamping
    force.'''
    solver = modules(pkg)[2]
    domain, ns, sqr, energy, traction = elasticity_forms(pkg, nelems, etype, btype, degree, poisson)
    cons = solver.System(sqr, trial='u').solve_constraints(droptol=1e-15)
    system = solver.System(energy, trial='u')
    args = system.solve(constrain=cons, method=solver.Direct(**linargs))
    args = solver.System(traction, trial='t', test='u').solve(constrain={'t': numpy.isnan(cons['u'])},
                                                               arguments=args)
    F = domain.boundary['top'].integrate('t_i dS' @ ns, degree=degree * 2, arguments=args)
    return cons['u'], args['u'], args['t'], numpy.asarray(F), system


def platewithhole_fcm(pkg, nelems=4, etype='square', btype='std', degree=2, maxrefine=2, radius=.5,
                      traction=.1, poisson=.3, **linargs):
    '''``examples/platewithhole.py``'s finite cell problem (its ``FCM``
    mode and ``main``, without the figure) through package ``pkg``: a dict
    of the trimmed topology, the namespace, the hole's radius error, the
    constraints (``sym``, then ``far`` on top), the elasticity System, the
    solution (``Direct(**linargs)`` where given, else the example's own
    call) and the L2 and H1 errors against the exact solution.'''
    function, mesh, solver, _config = modules(pkg)
    Namespace = importlib.import_module(f'{pkg}.expression').Namespace
    topo0, geom = mesh.unitsquare(nelems, etype)
    topo = topo0.trim(numpy.linalg.norm(geom) - radius, maxrefine=maxrefine, name='hole')
    basis = topo.basis(btype, degree=degree)
    topo = topo.withboundary(sym='left,bottom', far='top,right')
    ns = Namespace()
    ns.δ = function.eye(topo.ndims)
    ns.x = geom
    ns.define_for('x', gradient='∇', normal='n', jacobians=('dV', 'dS'))
    ns.λ = 2 * poisson
    ns.μ = 1 - poisson
    ns.u = function.field('u', basis, shape=[2])
    ns.v = function.field('v', basis, shape=[2])
    ns.ε_ij = '(∇_j(u_i) + ∇_i(u_j)) / 2'
    ns.σ_ij = 'λ ε_kk δ_ij + 2 μ ε_ij'
    ns.r2 = 'x_k x_k'
    ns.R2 = radius**2 / ns.r2
    ns.k = (3 - poisson) / (1 + poisson)
    ns.scale = traction * (1 + poisson) / 2
    ns.uexact_i = 'scale (x_i ((k + 1) (.5 + R2) + (1 - R2) R2 (x_0^2 - 3 x_1^2) / r2) - 2 δ_i1 x_1 (1 + (k - 1 + R2) R2))'
    ns.du_i = 'u_i - uexact_i'
    ns.dr = function.sqrt(ns.r2) - radius
    radiuserr = float(topo.boundary['hole'].integrate('dr^2 dS' @ ns, degree=9)**.5)
    sqr = topo.boundary['sym'].integral('(u_i n_i)^2 dS' @ ns, degree=degree*2)
    cons = solver.System(sqr, trial='u').solve_constraints(droptol=1e-15)
    sqr = topo.boundary['far'].integral('du_k du_k dS' @ ns, degree=20)
    cons = solver.System(sqr, trial='u').solve_constraints(droptol=1e-15, constrain=cons)
    res = topo.integral('∇_j(v_i) σ_ij dV' @ ns, degree=degree*2)
    system = solver.System(res, trial='u', test='v')
    args = system.solve(constrain=cons, **({'method': solver.Direct(**linargs)} if linargs else {}))
    err = numpy.sqrt(topo.integrate(['du_k du_k dV', '∇_j(du_i) ∇_j(du_i) dV'] @ ns, degree=max(degree, 3)*2,
                                    arguments=args))
    return dict(topo=topo, ns=ns, radiuserr=radiuserr, cons=cons['u'], system=system, args=args,
                u=args['u'], err=numpy.asarray(err))


def adaptivity(pkg, etype='square', btype='h-std', degree=2, nrefine=2):
    '''``examples/adaptivity.py``'s ``main`` through package ``pkg``,
    without its figures and log: (the errors of the last level, its
    solution, the last level's System).'''
    function, mesh, solver, _config = modules(pkg)
    Namespace = importlib.import_module(f'{pkg}.expression').Namespace
    domain, geom = mesh.unitsquare(2, etype)
    geom = geom - .5
    x, y = geom
    exact = (x**2 + y**2)**(1/3) * numpy.cos(numpy.arctan2(y+x, y-x) * (2/3))
    domain = domain.subset(domain.select(exact, ischeme='gauss1'), newboundary='corner')
    for irefine in range(nrefine + 1):
        if irefine:
            refdom = domain.refined
            ns.refbasis = refdom.basis(btype=btype, degree=degree)
            res = refdom.integral('∇_k(refbasis_n) ∇_k(u) dV' @ ns, degree=degree*2)
            res -= refdom.boundary.integral('refbasis_n ∇_k(u) n_k dS' @ ns, degree=degree*2)
            indicator = numpy.square(res.eval(args))
            irefelems = ns.refbasis.get_support(indicator > indicator.mean())
            domain = domain.refined_by(refdom.transforms[irefelems])
        ns = Namespace()
        ns.x = geom
        ns.define_for('x', gradient='∇', normal='n', jacobians=('dV', 'dS'))
        ns.u = domain.field('u', btype=btype, degree=degree)
        ns.v = domain.field('v', btype=btype, degree=degree)
        ns.uexact = exact
        ns.du = 'u - uexact'
        sqr = domain.boundary['corner'].integral('u^2 dS' @ ns, degree=degree*2)
        cons = solver.System(sqr, trial='u').solve_constraints(droptol=1e-15)
        sqr = domain.boundary.integral('du^2 dS' @ ns, degree=7)
        cons = solver.System(sqr, trial='u').solve_constraints(droptol=1e-15, constrain=cons)
        res = domain.integral('∇_k(v) ∇_k(u) dV' @ ns, degree=degree*2)
        system = solver.System(res, trial='u', test='v')
        args = system.solve(constrain=cons)
        error = numpy.sqrt(domain.integral(['du^2 dV', '(du^2 + ∇_k(du) ∇_k(du)) dV'] @ ns, degree=7)).eval(args)
    return numpy.asarray(error), args['u'], system


def example_assertions(example, method, testing, **values):
    '''Run the assertions of ``examples/<example>.py``'s test method
    ``method`` (every statement after its first, the call of ``main``) on
    ``values``, the names that call binds, computed elsewhere (without
    the example's figures), with ``testing.TestCase`` of a package.'''
    import ast
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / 'examples' / f'{example}.py'
    tree = ast.parse(path.read_text())
    fn = next(node for cls in tree.body if isinstance(cls, ast.ClassDef)
              for node in cls.body if isinstance(node, ast.FunctionDef) and node.name == method)
    body = ast.Module(body=fn.body[1:], type_ignores=[])

    class Case(testing.TestCase):
        def runTest(self):
            pass
    exec(compile(body, f'{path.name}:{method}', 'exec'), {'self': Case(), 'numpy': numpy, **values})


def finitestrain_forms(pkg, nelems=4, etype='square', btype='std', degree=1, poisson=.25, angle=10.):
    '''``examples/finitestrain.py``'s domain, namespace and functionals
    through package ``pkg``, untrimmed: the constraints' ``sqr``, the
    linear ``energy`` and the finite-strain ``energy1`` (the namespace left
    at the latter's strain).'''
    _function, mesh, _solver, _config = modules(pkg)
    Namespace = importlib.import_module(f'{pkg}.expression').Namespace
    domain, geom = mesh.unitsquare(nelems, etype)
    ns = Namespace()
    ns.X = geom
    ns.define_for('X', gradient='∇', normal='n', jacobians=('dV', 'dS'))
    ns.angle = angle * numpy.pi / 180
    ns.λ = 2 * poisson
    ns.μ = 1 - 2 * poisson
    ns.u = domain.field('u', btype=btype, degree=degree, shape=[2])
    ns.x_i = 'X_i + u_i'
    ns.ε_ij = '.5 (∇_j(u_i) + ∇_i(u_j))'
    ns.energy = '.5 λ ε_ii ε_jj + μ ε_ij ε_ij'
    sqr = domain.boundary['left'].integral('u_k u_k dS' @ ns, degree=degree * 2)
    sqr += domain.boundary['right'].integral('((u_0 - X_1 sin(2 angle) - cos(angle) + 1)^2 + (u_1 - X_1 '
                                             '(cos(2 angle) - 1) + sin(angle))^2) dS' @ ns, degree=degree * 2)
    energy = domain.integral('energy dV' @ ns, degree=degree * 2)
    ns.ε_ij = '.5 (∇_j(u_i) + ∇_i(u_j) + ∇_i(u_k) ∇_j(u_k))'
    ns.energy = 'λ ε_ii ε_jj + 2 μ ε_ij ε_ij'
    energy1 = domain.integral('energy dV' @ ns, degree=degree * 2)
    return domain, ns, sqr, energy, energy1


def finitestrain(pkg, nelems=4, etype='square', btype='std', degree=1, poisson=.25, angle=10., restol=1e-10,
                 **linargs):
    '''``examples/finitestrain.py``'s ``main`` through package ``pkg``,
    untrimmed and without its figures: the linear solve, then the finite-
    strain energy minimized under ``Minimize(**linargs)`` to ``restol``:
    (cons, u0, u1, the finite-strain System).'''
    solver = modules(pkg)[2]
    _domain, _ns, sqr, energy, energy1 = finitestrain_forms(pkg, nelems, etype, btype, degree, poisson, angle)
    cons = solver.System(sqr, trial='u').solve_constraints(droptol=1e-15)
    args0 = solver.System(energy, trial='u').solve(constrain=cons)
    system = solver.System(energy1, trial='u')
    args1 = system.solve(arguments=args0, constrain=cons, method=solver.Minimize(**linargs), tol=restol)
    return cons['u'], args0['u'], args1['u'], system


def spd_jacobian(pkg, form):
    '''The jacobian and residual at zero of a symmetric positive definite
    system whose matrix in the port has the given form: the Laplace slice
    with reaction (``'stencil'``), the weakly coupled two-field energy
    (``'blockgrid'``), the slice's form on P2 triangles (``'csr'``).'''
    if form == 'stencil':
        system = build_laplace(pkg, 8, reaction=True)
    elif form == 'blockgrid':
        system = build_two_field(pkg, 8)
    else:
        system = build_laplace(pkg, 5, reaction=True, etype='triangle', degree=2)
    return system.assemble_jacobian_residual({t: numpy.zeros(s) for t, s in zip(system.trials, system.trial_shapes)})


def build_fem_system(pkg, nelems=8):
    '''The Stokes-like mixed system of ``tests/test_matrix.py``
    (``_fem_system``), with convection: nonsymmetric after
    linearization.'''
    function, mesh, solver, _config = modules(pkg)
    topo, geom = mesh.unitsquare(nelems, 'square')
    u = topo.field('u', btype='std', degree=2, shape=(2,))
    p = topo.field('p', btype='std', degree=1)
    v = topo.field('v', btype='std', degree=2, shape=(2,))
    q = topo.field('q', btype='std', degree=1)
    J = function.J(geom)
    gu = function.grad(u, geom)
    gv = function.grad(v, geom)
    res = topo.integral((function.sum_(gv * gu) + (gu @ u) @ v - function.div(v, geom) * p
                         + q * function.div(u, geom)) * J, degree=4)
    return solver.System(res, trial='u,p', test='v,q')


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


def forget_assembly(system):
    '''Drop what a System of the port keeps from one assembly to the next
    (feature operators, call-invariant parts, the chunk plan), so that the
    next one is a first assembly again.'''
    system._operators.clear()
    for chunks in system._blocks:
        for c in chunks:
            if c.factored is not None:
                c.factored._fixed = None
    system._cache.pop('chunkplan', None)


def csr_of_rows(lens, seed):
    '''A square CSR matrix whose rows have the lengths ``lens``, then rows
    of two nonzeros as far as the longest row needs columns (distinct,
    sorted columns within a row; values from ``seed``): (data, indices,
    indptr) as numpy arrays, int32 tables.'''
    rng = numpy.random.default_rng(seed)
    n = max(len(lens), max(lens) + 1)
    lens = list(lens) + [2] * (n - len(lens))
    indptr = numpy.concatenate([[0], numpy.cumsum(lens)]).astype(numpy.int32)
    indices = numpy.concatenate([numpy.sort(rng.choice(n, k, replace=False)) for k in lens] + [[]])
    return rng.standard_normal(indptr[-1]), indices.astype(numpy.int32), indptr


def rel(a, b):
    '''Normwise relative difference of two arrays.'''
    a = numpy.asarray(a, dtype=numpy.float64)
    b = numpy.asarray(b, dtype=numpy.float64)
    return float(numpy.linalg.norm(a - b) / max(numpy.linalg.norm(b), 1e-300))


# ------------------------------------------------------------ time stepping
# the cases of tests/test_solver.py that step in time or use the legacy
# solver functions, and the port's own: each runs through package ``pkg``
# and returns its results {name: array} (tests/test_torch_timestep.py holds
# them against nutils_tpu, chip_smoke.py's timestep_parity the card against
# the CPU)

def _square(pkg):
    '''``tests/test_solver.py``'s fixture: 3 x 3 squares, a degree-1 field
    ``u`` and its test field ``v``.'''
    function, mesh, _solver, _config = modules(pkg)
    topo, geom = mesh.unitsquare(3, 'square')
    u = topo.field('u', btype='std', degree=1)
    v = topo.field('v', btype='std', degree=1)
    return function, topo, geom, u, v


def _energy(pkg):
    '''``tests/test_solver.py``'s nonlinear energy and its constraints.'''
    function, topo, geom, u, v = _square(pkg)
    g = function.grad(u, geom)
    E = topo.integral(((1 + u ** 2) * (g @ g) / 2 + u ** 2 / 2 - u) * function.J(geom), degree=3)
    cons = {'u': numpy.concatenate([numpy.zeros(4), numpy.full(12, numpy.nan)])}
    return E, cons


def _case_step_theta(pkg):
    function, topo, geom, u, v = _square(pkg)
    s = modules(pkg)[2]
    u0 = function.replace_arguments(u, {'u': function.Argument('u0', (16,))})
    res = topo.integral(((u - u0) / 0.1 + u) * v * function.J(geom), degree=2)
    out = s.System(res, trial='u', test='v').step(arguments={'u': numpy.ones(16)}, suffix='0', tol=1e-10)
    numpy.testing.assert_allclose(out['u'], 1 / 1.1, rtol=1e-10)
    return {'u': out['u']}


def _case_pseudotime(pkg):
    function, topo, geom, u, v = _square(pkg)
    s = modules(pkg)[2]
    E, cons = _energy(pkg)
    system = s.System(function.linearize(E, 'u:v'), trial='u', test='v')
    inertia = topo.integral(u * v * function.J(geom), degree=2)
    out = system.solve(constrain=cons, tol=1e-10, method=s.Pseudotime(inertia=inertia, timestep=.5))
    assert numpy.linalg.norm(system.assemble_residual(out)[4:]) < 1e-10
    return {'u': out['u']}


def _case_arnoldi_reuse(pkg):
    function, topo, geom, u, v = _square(pkg)
    s = modules(pkg)[2]
    k = function.Argument('k', ())
    res = topo.integral(((1 + k) * (function.grad(v, geom) @ function.grad(u, geom)) + u * v - v) * function.J(geom),
                        degree=2)
    system = s.System(res, trial='u', test='v')
    method = s.Arnoldi()
    first = system.solve(arguments={'k': 0.}, tol=1e-10, method=method)
    assert numpy.linalg.norm(system.assemble_residual(first)) < 1e-10
    # a perturbed parameter: the cached jacobian preconditions the subspace
    second = system.solve(arguments={'k': 0.01, 'u': first['u']}, tol=1e-10, method=method)
    assert numpy.linalg.norm(system.assemble_residual(second)) < 1e-10
    return {'first': first['u'], 'second': second['u']}


def _case_newton_wrapper(pkg):
    function, topo, geom, u, v = _square(pkg)
    s = modules(pkg)[2]
    E, cons = _energy(pkg)
    out = s.newton('u:v', function.linearize(E, 'u:v'), constrain=cons['u']).solve(tol=1e-10)
    assert numpy.linalg.norm(s.System(E, trial='u').assemble_residual({'u': out['u']})[4:]) < 1e-10
    return {'u': out['u']}


def _case_minimize_wrapper(pkg):
    s = modules(pkg)[2]
    E, cons = _energy(pkg)
    lhs = s.minimize('u', E, constrain=cons['u']).solve(tol=1e-10)
    assert numpy.linalg.norm(s.System(E, trial='u').assemble_residual({'u': lhs})[4:]) < 1e-10
    return {'u': lhs}


def _case_solve_linear_wrapper(pkg):
    function, topo, geom, u, v = _square(pkg)
    s = modules(pkg)[2]
    res = topo.integral((function.grad(v, geom) @ function.grad(u, geom) + v) * function.J(geom), degree=2)
    cons = numpy.concatenate([numpy.zeros(4), numpy.full(12, numpy.nan)])
    lhs = s.solve_linear('u:v', res, constrain=cons)
    assert numpy.linalg.norm(s.System(res, trial='u', test='v').assemble_residual({'u': lhs})[4:]) < 1e-10
    return {'u': lhs}


def _case_thetamethod(pkg):
    function, topo, geom, u, v = _square(pkg)
    s = modules(pkg)[2]
    res = topo.integral(u * v * function.J(geom), degree=2)
    out = {}
    gen = s.impliciteuler('u:v', res, res, timestep=.1, newtontol=1e-12, arguments={'u': numpy.ones(16)})
    for k in range(3):
        out[f'ie{k}'] = next(gen)
        numpy.testing.assert_allclose(out[f'ie{k}'], 1 / 1.1 ** k, rtol=1e-10)
    gen = s.cranknicolson('u:v', res, res, timestep=.1, newtontol=1e-12, arguments={'u': numpy.ones(16)})
    next(gen)
    out['cn'] = next(gen)
    numpy.testing.assert_allclose(out['cn'], .95 / 1.05, rtol=1e-10)
    return out


def _case_optimize_droptol(pkg):
    function, topo, geom, u, v = _square(pkg)
    s = modules(pkg)[2]
    sqr = topo.boundary['left'].integral(u ** 2 * function.J(geom), degree=2)
    cons = s.optimize('u', sqr, droptol=1e-13)
    assert numpy.isnan(cons).sum() == 12
    numpy.testing.assert_allclose(cons[:4], 0, atol=1e-12)
    return {'cons': cons}


def taylor_hood_history(pkg, nelems=12, dtype=numpy.float64):
    '''``build_ns``'s Navier-Stokes step at ``nelems`` squares a side,
    written as ``examples/cylinderflow.py`` writes its history and
    timestep: ``u0`` and ``dt`` are arguments, the state the same seeded
    one.  (System, arguments.)  Leaves ``config.floatx`` at ``dtype``.'''
    function, mesh, s, config_ = modules(pkg)
    config_.floatx.value = dtype
    topo, geom = mesh.unitsquare(nelems, 'square')
    ns = _taylor_hood_namespace(pkg, topo, geom)
    ns.u0 = function.replace_arguments(ns.u, 'u:u0')
    ns.dt = function.field('dt')
    ns.nu = 0.001
    ns.eps = 0.001
    res = topo.integral('(v_i (u_i - u0_i) / dt + v_i u_j ∇_j(u_i) + nu ∇_j(v_i) ∇_j(u_i)'
                        ' - p ∇_i(v_i) + q ∇_i(u_i) + eps p q) dV' @ ns, degree=6)
    system = s.System(res, trial='u,p', test='v,q')
    rng = numpy.random.default_rng(0)
    args = {t: 0.1 * rng.standard_normal(shape) for t, shape in zip(system.trials, system.trial_shapes)}
    return system, args


def _case_taylor_hood_steps(pkg):
    system, args = taylor_hood_history(pkg)
    out = {}
    for k in range(2):
        prev = args
        args = system.step(timestep=0.01, timearg='t', timesteparg='dt', suffix='0', arguments=args, tol=1e-9)
        # the history is the previous step's state, the very array
        assert args['u0'] is prev['u'] and args['t'] == 0.01 * (k + 1) and args['t0'] == 0.01 * k
        out[f'u{k}'], out[f'p{k}'] = args['u'], args['p']
    return out


def heat(pkg, nelems):
    '''The heat equation on ``nelems`` squares a side, degree 1: the
    residual ``∇v·∇u``, the inertia ``v u`` and the nodal values of the
    Neumann mode cos(πx) cos(πy).'''
    function, mesh, _s, _config = modules(pkg)
    topo, geom = mesh.unitsquare(nelems, 'square')
    u = topo.field('u', btype='std', degree=1)
    v = topo.field('v', btype='std', degree=1)
    J = function.J(geom)
    res = topo.integral((function.grad(v, geom) @ function.grad(u, geom)) * J, degree=2)
    inertia = topo.integral(u * v * J, degree=2)
    c = numpy.cos(numpy.pi * numpy.linspace(0, 1, nelems + 1))
    return topo, geom, u, res, inertia, numpy.outer(c, c).ravel()


def _case_cranknicolson_heat(pkg):
    function, _mesh, s, _config = modules(pkg)
    topo, geom, u, res, inertia, u0 = heat(pkg, 16)
    gen = s.cranknicolson('u:v', res, inertia, timestep=1e-3, newtontol=1e-12, arguments={'u': u0})
    l2 = topo.integral(u ** 2 * function.J(geom), degree=2)
    out, norms = {}, []
    for k in range(4):
        out[f'u{k}'] = next(gen)
        norms.append(float(l2.eval({'u': out[f'u{k}']})) ** .5)
    # each step damps the mode by about the continuous Crank-Nicolson
    # factor, the discrete eigenvalue O(h^2) above 2 pi^2
    lam_dt = 2 * numpy.pi ** 2 * 1e-3
    ratio = numpy.array(norms[1:]) / norms[:-1]
    numpy.testing.assert_allclose(ratio, (1 - lam_dt / 2) / (1 + lam_dt / 2), rtol=1e-3)
    return out


def decay(pkg, read_t=True):
    '''``tests/test_solver.py``'s 1-D diffusion step with the timestep
    ``dt`` an argument, and (``read_t``) a source that reads the time
    ``t``.  (System, arguments.)'''
    function, mesh, s, _config = modules(pkg)
    topo, geom = mesh.rectilinear([4])
    u = topo.field('u', btype='std', degree=1)
    v = function.replace_arguments(u, 'u:v')
    u0 = function.replace_arguments(u, 'u:u0')
    dt = function.Argument('dt', (), float)
    J = function.J(geom)
    f = v * (u - u0) / dt + function.grad(v, geom) @ function.grad(u, geom)
    if read_t:
        f = f - v * function.Argument('t', (), float)
    system = s.System(topo.integral(f * J, degree=2), trial='u', test='v')
    return system, {'u': numpy.sin(numpy.linspace(0, numpy.pi, 5))}


def _case_timestep_change(pkg):
    system, args = decay(pkg)
    step = functools.partial(system.step, suffix='0', timearg='t', timesteparg='dt', tol=1e-12)
    first = step(arguments=args, timestep=0.1)
    second = step(arguments=first, timestep=0.05)
    # a fresh System's step at 0.05 from the same state: no value of the
    # first step (dt 0.1, t 0.1) stays in the reused one
    fresh, _args = decay(pkg)
    again = fresh.step(arguments=first, timestep=0.05, suffix='0', timearg='t', timesteparg='dt', tol=1e-12)
    assert second['dt'] == 0.05 and abs(second['t'] - 0.15) < 1e-15
    if pkg == 'nutils_tpu_torch':
        assert numpy.array_equal(second['u'], again['u'])
    else:
        numpy.testing.assert_allclose(second['u'], again['u'], rtol=1e-14)
    return {'first': first['u'], 'second': second['u']}


def _case_unread_timearg(pkg):
    # cylinderflow passes timearg='t' to a residual that never reads t
    system, args = decay(pkg, read_t=False)
    assert 't' not in system.arguments
    out = system.step(arguments=args, timestep=0.1, timearg='t', timesteparg='dt', suffix='0', tol=1e-12)
    plain = system.step(arguments=dict(args, dt=0.1), suffix='0', tol=1e-12)
    numpy.testing.assert_allclose(out['u'], plain['u'], rtol=1e-14)
    assert out['t'] == 0.1 and out['t0'] == 0.
    return {'u': out['u']}


TIMESTEP_CASES = {name[6:]: fn for name, fn in globals().items() if name.startswith('_case_')}


def step_with_failures(pkg, system, args, maxretry=2, **step):
    '''``System.step`` of ``system`` (package ``pkg``) from ``args`` with
    timestep 0.1 in ``dt`` (``tests/test_solver.py``'s halving case), its
    solves failing above dt 0.026: (the timesteps of the solves, the
    state).'''
    s = modules(pkg)[2]
    calls = []
    solve = s.System.solve

    def failing_solve(self, *, arguments, **kw):
        calls.append(float(arguments['dt']))
        if calls[-1] > 0.026:
            raise s.SolverError('synthetic divergence at large dt')
        return solve(self, arguments=arguments, **kw)
    s.System.solve = failing_solve
    try:
        out = system.step(arguments=args, suffix='0', timestep=0.1, maxretry=maxretry, **step)
    except s.SolverError:
        out = None
    finally:
        s.System.solve = solve
    return calls, out


# the matrix algebra on one operand (tests/test_torch_matrix_algebra.py,
# chip_smoke.py's timestep_parity)
MATRIX_OPS = {
    'add': lambda a: a + a.T,
    'sub': lambda a: a - a * 2.,
    'mul': lambda a: a * 0.3,
    'rmul': lambda a: 0.3 * a,
    'truediv': lambda a: a / 3.,
    'neg': lambda a: -a,
    'transpose': lambda a: a.T,
}


def cahnhilliard(pkg, nelems=3, degree=2, etype='multipatch', circle=True, size='10cm', epsilon='5cm',
                 mobility='1μL*s/kg', stens='50mN/m', wtensn='30mN/m', wtensp='20mN/m', timestep='1h',
                 tol='1nJ/m', seed=0, stable=False, locate=True, gridstep=1/40, clock=None):
    '''``examples/cahnhilliard.py``'s problem as its ``main`` builds it
    (``test_multipatchcircle``'s arguments by default), through package
    ``pkg``, without the figures: a dict of the domain, the namespace, the
    energy and its three parts, the grid of points located for the flux
    plot (``main``'s ``domain.locate`` call on a simplex grid of spacing
    ``gridstep``, ``main``'s 1/40; ``None`` where ``locate`` is false) and
    its flux ``grid_v``, the System, the initial arguments,
    ``step(args, **solveargs)``, one of ``main``'s time steps,
    ``energies(args)``, the three parts in J/m, ``flux(args)``, the flux at
    the located points in m/s, ``mass(args)``, the
    integral of φ over the unit geometry, and ``mass_scale``, the factor
    that turns the sum of the η residual's entries into minus the change
    of that integral.  ``clock(name, fn)``, where given, calls each of the
    mesh, the locate and the System's construction (names ``unitcircle``,
    ``locate``, ``system``).'''
    clock = clock or (lambda _name, fn: fn())
    function, mesh, solver, _config = modules(pkg)
    Namespace = importlib.import_module(f'{pkg}.expression').Namespace
    SI = importlib.import_module(f'{pkg}.SI')
    numeric = importlib.import_module(f'{pkg}.utils.numeric')
    Mobility = SI.Time / SI.Density
    LED = SI.Energy / SI.Length
    size, epsilon, stens = SI.Length(size), SI.Length(epsilon), SI.Tension(stens)
    wtensn, wtensp, timestep = SI.Tension(wtensn), SI.Tension(wtensp), SI.Time(timestep)
    mobility, tol = Mobility(mobility), LED(tol)
    if circle:
        domain, geom = clock('unitcircle', lambda: mesh.unitcircle(nelems, etype))
        geom = (geom + 1) / 2
    else:
        domain, geom = mesh.unitsquare(nelems, etype)
    ns = Namespace()
    ns.x = geom * size
    ns.define_for('x', gradient='∇', normal='n', jacobians=('dV', 'dS'))
    ns.φ = domain.field('φ', btype='std', degree=degree)
    ns.dφ = ns.φ - function.replace_arguments(ns.φ, 'φ:φ0')
    ns.η = domain.field('η', btype='std', degree=degree) * (stens / epsilon)
    ns.dt = function.field('dt') * timestep
    ns.ε = epsilon
    ns.σ = stens
    ns.σmean = (wtensp + wtensn) / 2
    ns.σdiff = (wtensp - wtensn) / 2
    ns.σwall = 'σmean + φ σdiff'
    ns.ψ = '.25 (φ^2 - 1)^2'
    ns.δψ = '.25 dφ^2 (1 - φ^2 + 2 φ dφ / 3 - dφ^2 / 6)' if stable else '0'
    ns.M = mobility
    ns.J_i = '-M ∇_i(η)'
    ns.v_i = 'φ J_i'
    nrg_mix = function.factor(domain.integral('(ψ σ / ε) dV' @ ns, degree=degree*4))
    nrg_iface = function.factor(domain.integral('.5 σ ε ∇_k(φ) ∇_k(φ) dV' @ ns, degree=degree*4))
    nrg_wall = function.factor(domain.boundary.integral('σwall dS' @ ns, degree=degree*2))
    nrg = nrg_mix + nrg_iface + nrg_wall + function.factor(
        domain.integral('(δψ σ / ε - η dφ + .5 dt J_k ∇_k(η)) dV' @ ns, degree=degree*4))
    grid = grid_v = None
    if locate:
        grid = clock('locate', lambda: domain.locate(geom, numeric.simplex_grid([1, 1], gridstep), maxdist=1/nelems,
                                                     skip_missing=True, tol=1e-5))
        grid_v = function.factor(grid.bind(ns.v))
    system = clock('system', lambda: solver.System(nrg / tol, trial='φ,η'))
    numpy.random.seed(seed)
    args = dict(φ=numpy.random.normal(0, .5, function.arguments_for(nrg)['φ'].shape))
    unit = function.J(geom)
    return dict(domain=domain, geom=geom, ns=ns, nrg=nrg, parts=[nrg_mix, nrg_iface, nrg_wall], grid=grid,
                grid_v=grid_v, system=system, args=args,
                step=lambda a, **solveargs: system.step(timestep=1., timesteparg='dt', suffix='0', arguments=a, tol=1,
                                                        maxiter=5, **solveargs),
                energies=lambda a: [float(e / LED('1J/m')) for e in function.eval([nrg_mix, nrg_iface, nrg_wall], a)],
                mass=lambda a: float(domain.integrate(ns.φ * unit, degree=degree * 4, arguments=a)),
                flux=lambda a: numpy.asarray(function.eval(grid_v, a) / SI.Velocity('1m/s')),
                mass_scale=float(tol / (stens / epsilon * size ** 2)))


def located(smp):
    '''(element ids [N], the points' root coordinates [N, d]) of a sample
    of one point a row, as the port's ``locate`` returns it (a Sample, or
    a reordered chain of them), in the located points' order.'''
    unstructured = importlib.import_module('nutils_tpu_torch.unstructured')
    parts = unstructured._chart_samples(smp)
    elems = numpy.concatenate([numpy.asarray(s.index) for s in parts])
    coords = numpy.concatenate([numpy.asarray(s.specs[0].coords)[:, 0] for s in parts])
    perm = getattr(smp, 'perm', None)
    return (elems, coords) if perm is None else (elems[perm], coords[perm])


def coil_forms(pkg, nelems=4, degree=2, freq=0., rwire=.0025, rcoil=.025, nturns=1):
    '''``examples/coil.py``'s first System (the complex magnetic vector
    potential on the tensor product of a trimmed RZ quarter plane and a
    revolution line, ``main`` up to its first solve) through package
    ``pkg``: (the System, its namespace).'''
    import functools as ft
    function, mesh, solver, _config = modules(pkg)
    Namespace = importlib.import_module(f'{pkg}.expression').Namespace
    ns = Namespace()
    ns.j = 1j
    ns.π = numpy.pi
    ns.f = freq
    ns.ω = '2 π f'
    ns.μ0 = '4e-7 π'
    ns.σ = 5.988e7
    ns.rcoil = rcoil
    ns.rwire = rwire
    RZ, ns.rz0 = mesh.rectilinear([numpy.linspace(0, 1, nelems)] * 2, space='RZ')
    REV, ns.θ = mesh.line([-numpy.pi, numpy.pi], bnames=['start', 'end'], space='Θ')
    ns.rz = numpy.arctanh(ns.rz0) * 2 * rcoil
    ns.r, ns.z = ns.rz
    ns.zwires = (numpy.arange(nturns) - (nturns - 1) / 2) * 4 * rwire
    ns.dwires = ns.rwire - numpy.sqrt((ns.r - ns.rcoil)**2 + ft.reduce(numpy.minimum, (ns.z - ns.zwires)**2))
    RZ = RZ.withsubdomain(coil=RZ[:-1, :-1].trim(ns.dwires / ns.rwire, maxrefine=4))
    ns.rot = numpy.stack([function.scatter(function.trignormal(ns.θ), 3, [0, 1]), function.kronecker(1., 0, 3, 2)])
    ns.eθ = numpy.stack(['-sin(θ)', 'cos(θ)', '0'] @ ns)
    ns.x = ns.rz @ ns.rot
    ns.define_for('x', gradient='∇', jacobians=('dV', 'dS'), curl='curl')
    ns.A = RZ.field('A', btype='spline', degree=degree, removedofs=[[0, -1], [-1]], dtype=complex) * ns.eθ
    ns.Atest = function.replace_arguments(ns.A, 'A:Atest')
    ns.E_i = '-j ω A_i'
    ns.Jind_i = 'σ E_i'
    ns.I = 1
    ns.Jext_i = 'eθ_i I / π rwire^2'
    ns.J_i = 'Jext_i + Jind_i'
    res = REV.integral(RZ.integral('-∇_j(Atest_i) ∇_j(A_i) dV' @ ns, degree=2 * degree), degree=0)
    res += REV.integral(RZ['coil'].integral('μ0 Atest_i J_i dV' @ ns, degree=2 * degree), degree=0)
    return solver.System(res, trial='A', test='Atest'), ns
