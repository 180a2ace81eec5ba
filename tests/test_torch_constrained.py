'''Constrained solves of the PyTorch port (``Matrix.solve(constrain=)``,
``submatrix``, ``export``) against nutils_tpu's ``Matrix`` on the same CSR
arrays, on the port's stencil, block-grid and CSR forms.  Tolerances: 1e-12
relative where a direct solve decides the value; 1e-8 where both packages
solve to rtol 1e-10 with a Krylov method (these systems' condition numbers
are below 1e2); prescribed values exactly.'''

import numpy
import pytest
import scipy.sparse

import _torch_parity as tp
from nutils_tpu import matrix as matrix_jax
from nutils_tpu_torch import matrix
from nutils_tpu_torch.utils import config

SOLVERS = ('direct', 'cg', 'gmres', 'bicgstab')


def _assembled(pkg, form):
    '''The jacobian of the form's system at zero (and its residual): the
    port's ``_StencilMatrix``, ``_BlockGridMatrix`` or CSR ``Matrix``.'''
    if form == 'stencil':
        system = tp.build_laplace(pkg, 8, reaction=True)
    elif form == 'blockgrid':
        system = tp.build_two_field(pkg, 12)
    else:
        system = tp.build_laplace(pkg, 5, reaction=True, etype='triangle', degree=2)
    return system.assemble_jacobian_residual({t: numpy.zeros(s) for t, s in zip(system.trials, system.trial_shapes)})


@pytest.fixture(scope='module', params=('stencil', 'blockgrid', 'csr'))
def case(request):
    '''(form, the port's matrix, nutils_tpu's Matrix of its CSR arrays,
    right-hand side, fixed-dof mask, prescribed values).'''
    with config.device('cpu'):
        jac, _res = _assembled('nutils_tpu_torch', request.param)
    kind = {'stencil': matrix._StencilMatrix, 'blockgrid': matrix._BlockGridMatrix, 'csr': matrix.Matrix}
    assert type(jac) is kind[request.param]
    data, indices, indptr = jac.export('csr')
    ref = matrix_jax.Matrix(indptr, indices, data, jac.shape)
    n = jac.shape[0]
    rng = numpy.random.default_rng(1)
    fixed = numpy.zeros(n, dtype=bool)
    fixed[rng.choice(n, n // 5, replace=False)] = True
    return request.param, jac, ref, rng.standard_normal(n), fixed, rng.standard_normal(n)


def _rel(a, b):
    return float(numpy.abs(a - b).max() / numpy.abs(b).max())


@pytest.mark.parametrize('mask', ('bool', 'nan'))
@pytest.mark.parametrize('solver', SOLVERS)
def test_constrained_solve(case, solver, mask):
    form, jac, ref, rhs, fixed, values = case
    cons = fixed if mask == 'bool' else numpy.where(fixed, values, numpy.nan)
    with config.device('cpu'):
        x = jac.solve(rhs, constrain=cons, solver=solver, rtol=1e-10)
    want = ref.solve(rhs, constrain=cons, solver=solver, rtol=1e-10)
    assert numpy.array_equal(x[fixed], numpy.where(fixed, 0. if mask == 'bool' else values, 0.)[fixed])
    assert _rel(x, numpy.asarray(want)) <= (1e-12 if solver == 'direct' else 1e-8)
    if solver != 'direct':
        # the masked operator keeps the matrix's form
        (kind, *_), _op = jac._masked_solve_cache[1]._device_op()
        assert kind == form
        assert jac._solve_stats['op_form'] == form and jac._solve_stats['accepted_on_device']


@pytest.mark.parametrize('solver', SOLVERS)
def test_submatrix_solve_is_the_masked_solve(case, solver):
    _form, jac, _ref, rhs, fixed, _values = case
    free = ~fixed
    with config.device('cpu'):
        sub = jac.submatrix(free, free)
        assert isinstance(sub, matrix._SubMatrix) and sub.shape == (free.sum(),) * 2
        x = sub.solve(rhs[free], solver=solver, rtol=1e-10)
        full = jac.solve(numpy.where(free, rhs, 0.), constrain=fixed, solver=solver, rtol=1e-10)
    assert numpy.array_equal(x, full[free])
    # its CSR face is the parent's rows and columns
    want = jac._scipy()[free][:, free].toarray()
    assert numpy.array_equal(sub.export('dense'), want)


def test_auto_demotion_is_recorded(case):
    # under 'auto' a device GMRES on the masked operator that misses its
    # tolerance (here one below the floating-point floor, in two iterations
    # a round) is demoted to a host direct solve, as in the JAX package,
    # and the solve record says so; a submatrix view's record is its
    # parent's
    _form, jac, ref, rhs, fixed, values = case
    cons = numpy.where(fixed, values, numpy.nan)
    free = ~fixed
    with config.device('cpu'), config.device_solve_min(0):
        x = jac.solve(rhs, constrain=cons, solver='auto', rtol=1e-30, restart=2, maxiter=2)
        stats = jac._solve_stats
        sub = jac.submatrix(free, free)
        sub.solve(rhs[free], solver='auto', rtol=1e-10)
    assert stats['method'] == 'direct' and not stats['accepted_on_device']
    assert stats['fallback_from']['method'] == 'gmres' and not stats['fallback_from']['accepted_on_device']
    assert numpy.array_equal(x[fixed], values[fixed])
    assert _rel(x, numpy.asarray(ref.solve(rhs, constrain=cons, solver='direct'))) <= 1e-12
    assert sub._solve_stats is jac._solve_stats and sub._solve_stats['method'] == 'gmres'


def test_one_masked_operator_per_mask(case):
    _form, jac, _ref, rhs, fixed, _values = case
    with config.device('cpu'):
        jac.solve(rhs, constrain=fixed, solver='gmres', rtol=1e-10)
        key, masked = jac._masked_solve_cache
        op = masked._device_op()
        jac.solve(2 * rhs, constrain=fixed.copy(), solver='bicgstab', rtol=1e-10)
        assert jac._masked_solve_cache[1] is masked and masked._device_op() is op
        other = fixed.copy()
        other[numpy.flatnonzero(~fixed)[0]] = True
        jac.solve(rhs, constrain=other, solver='gmres', rtol=1e-10)
        assert jac._masked_solve_cache[1] is not masked and jac._masked_solve_cache[0] != key


@pytest.mark.parametrize('form', ('stencil', 'blockgrid', 'csr'))
def test_export(form):
    # the port's matrix of the form against the JAX package's assembly of
    # the same system, in all three export forms
    with config.device('cpu'):
        jac, _res = _assembled('nutils_tpu_torch', form)
    ref, _res = _assembled('nutils_tpu', form)
    data, indices, indptr = jac.export('csr')
    rdata, rindices, rindptr = ref.export('csr')
    assert numpy.array_equal(indices, rindices) and numpy.array_equal(indptr, rindptr)
    assert _rel(data, numpy.asarray(rdata)) <= 1e-12
    dense = jac.export('dense')
    assert dense.shape == jac.shape and _rel(dense, ref.export('dense')) <= 1e-12
    cdata, (rows, cols) = jac.export('coo')
    back = scipy.sparse.coo_matrix((cdata, (rows, cols)), shape=jac.shape).toarray()
    assert numpy.array_equal(back, dense)
    with pytest.raises(ValueError):
        jac.export('ell')


def test_gmres_with_constraints():
    # tests/test_matrix.py::test_device_gmres_with_constraints through the
    # port, against the JAX package
    A = scipy.sparse.diags([-1, 2.0, -1], [-1, 0, 1], shape=(250, 250)).tocsr()
    b = numpy.random.RandomState(0).rand(250)
    cons = numpy.full(250, numpy.nan)
    cons[0] = 1.5
    cons[-1] = -0.5
    ref = matrix_jax.Matrix(A.indptr, A.indices, A.data, A.shape)
    with config.device('cpu'):
        M = matrix.Matrix(A.indptr, A.indices, A.data, A.shape)
        x_direct = M.solve(b, constrain=cons, solver='direct')
        x_g = M.solve(b, constrain=cons, solver='gmres', rtol=1e-12)
    assert x_g[0] == 1.5 and x_g[-1] == -0.5
    numpy.testing.assert_allclose(x_g, x_direct, rtol=1e-6)
    assert _rel(x_direct, ref.solve(b, constrain=cons, solver='direct')) <= 1e-12
    assert _rel(x_g, ref.solve(b, constrain=cons, solver='gmres', rtol=1e-12)) <= 1e-9


def test_navier_stokes_subsolve_with_constraints():
    # tests/test_matrix.py::test_navier_stokes_newton_subsolve_on_device
    # through the port (its block-grid jacobian), against the JAX package
    rng = numpy.random.RandomState(7)
    system = tp.build_fem_system('nutils_tpu')
    args = {'u': 0.1 * rng.rand(*system.trial_shapes[0]), 'p': 0.1 * rng.rand(*system.trial_shapes[1])}
    jj, rj = system.assemble_jacobian_residual(args)
    with config.device('cpu'):
        jac, res = tp.build_fem_system('nutils_tpu_torch').assemble_jacobian_residual(args)
        assert isinstance(jac, matrix._BlockGridMatrix)
        cons = numpy.full(jac.shape[0], numpy.nan)
        cons[-1] = 0.0  # pin one pressure dof
        x_direct = jac.solve(res, constrain=cons, solver='direct')
        x_gmres = jac.solve(res, constrain=cons, solver='gmres', rtol=1e-10, restart=200)
    assert numpy.linalg.norm(x_gmres - x_direct) / numpy.linalg.norm(x_direct) < 1e-4
    want = jj.solve(numpy.asarray(rj), constrain=cons, solver='direct')
    assert _rel(x_direct, want) <= 1e-12
    assert _rel(x_gmres, jj.solve(numpy.asarray(rj), constrain=cons, solver='gmres', rtol=1e-10, restart=200)) \
        <= 1e-6
