'''The preconditioner registry (``Matrix.getprecon``, ``_Precon``), block
Jacobi (``ops/precon.py``: the host inverse, kernel K13's plain version)
and the host scipy solvers (``Matrix._solver_scipy``) of the PyTorch port
against nutils_tpu.  Tolerances: the block inverses bit for bit (one LAPACK
inversion a block in both); 1e-8 relative between the packages' Krylov
solves to rtol 1e-10 (these systems' condition numbers are below 1e3);
1e-12 between the packages' scipy solves (the same scipy calls on the same
float64 arrays).'''

import importlib

import numpy
import pytest
import scipy.sparse

import _torch_parity as tp
from nutils_tpu import matrix as matrix_jax
from nutils_tpu.ops import sparse as sparse_jax
from nutils_tpu_torch import matrix
from nutils_tpu_torch.ops import precon
from nutils_tpu_torch.utils import config

PACKAGES = tp.PACKAGES


def _matrix(pkg, A):
    return importlib.import_module(f'{pkg}.matrix').Matrix(A.indptr, A.indices, A.data, A.shape)


def _laplace_csr(pkg, n):
    '''1-D Laplacian (symmetric positive definite), n dofs.'''
    return _matrix(pkg, scipy.sparse.diags([-1, 2.0, -1], [-1, 0, 1], shape=(n, n)).tocsr())


def _rand_rhs(n, seed=0):
    return numpy.random.RandomState(seed).rand(n)


# ------------------------------------------------------------ the registry
# tests/test_matrix.py's registry and cache cases, through both packages

@pytest.mark.parametrize('pkg', PACKAGES)
def test_getprecon_registry(pkg):
    A = _laplace_csr(pkg, 50)
    d = A.getprecon('diag')
    assert d.kind == 'diag'
    numpy.testing.assert_allclose(d.minv, 0.5)
    blk = A.getprecon('block', blocksize=5)
    assert blk.kind == 'block' and blk.minv.shape == (10, 5, 5)
    assert A.getprecon('block').minv.shape == (13, 4, 4)  # blocksize 4 by default
    lu = A.getprecon('splu')
    assert lu.kind == 'host'
    b = _rand_rhs(50)
    numpy.testing.assert_allclose(lu.apply(b), A.solve(b, solver='direct'), rtol=1e-10)
    ilu = A.getprecon('spilu0')
    assert ilu.kind == 'host'


@pytest.mark.parametrize('pkg', PACKAGES)
def test_getprecon_schurdiag_registered(pkg):
    A = _laplace_csr(pkg, 40)
    for name in ('schurdiag', 'schur-diag'):
        obj = A.getprecon(name)
        assert obj.kind == 'diag'
        numpy.testing.assert_allclose(obj.minv, 1.0 / A.diagonal())


@pytest.mark.parametrize('pkg', PACKAGES)
def test_getprecon_cache(pkg):
    A = _laplace_csr(pkg, 20)
    assert A.getprecon('diag') is A.getprecon('diag')
    assert A.getprecon('diag') is not A.getprecon('block', blocksize=2)
    assert A.getprecon('block', blocksize=2) is A.getprecon('block', blocksize=2)


@pytest.mark.parametrize('pkg', PACKAGES)
def test_getprecon_errors(pkg):
    M = _matrix(pkg, scipy.sparse.csr_matrix(numpy.array([[0.0, 1.0], [1.0, 0.0]])))
    errors = importlib.import_module(f'{pkg}.matrix').MatrixError
    with pytest.raises(errors, match='zero entries'):
        M.getprecon('diag')
    with pytest.raises(errors, match='unknown preconditioner'):
        M.getprecon('nonsense')
    R = _matrix(pkg, scipy.sparse.csr_matrix(numpy.ones((2, 3))))
    with pytest.raises(errors, match='square'):
        R.getprecon('diag')


@pytest.mark.parametrize('name', ['diag', 'schurdiag', 'block', 'splu', 'spilu0'])
def test_getprecon_same_handles(name):
    '''The port's handle has the JAX package's kind, minv and host apply.'''
    Aj, At = (_laplace_csr(pkg, 23) for pkg in PACKAGES)
    args = {'blocksize': 3} if name == 'block' else {}
    pj, pt = Aj.getprecon(name, **args), At.getprecon(name, **args)
    assert isinstance(pt, matrix._Precon) and pt.kind == pj.kind
    if pj.minv is not None:
        assert numpy.array_equal(pt.minv, numpy.asarray(pj.minv))
    v = _rand_rhs(23, 4)
    assert numpy.array_equal(pt.apply_host()(v), pj.apply_host()(v))


def test_device_precon_kinds():
    A = _laplace_csr('nutils_tpu_torch', 30)
    kind, minv = A._device_precon('block', {'blocksize': 3})
    assert kind == 'block' and minv is A.getprecon('block', blocksize=3).minv
    assert A._device_precon(A.getprecon('diag'), None)[0] == 'diag'
    with pytest.raises(matrix.MatrixError, match='host preconditioner'):
        A._device_precon('splu', None)
    with pytest.raises(matrix.MatrixError, match='host preconditioner'):
        A._device_precon(A.getprecon('spilu'), None)


# ------------------------------------------------------------ block Jacobi

def _blocky_csr(n, seed, empty=(), singular=(), bs=None):
    '''A random sparse matrix of ``n`` rows with a full diagonal band, the
    rows of ``empty`` without entries, and ``singular`` blocks of ``bs``
    rows made rank one.'''
    rng = numpy.random.default_rng(seed)
    A = scipy.sparse.random(n, n, density=0.2, random_state=seed, format='lil')
    for i in range(n):
        for j in range(max(0, i - 4), min(n, i + 5)):
            A[i, j] = rng.standard_normal() + (6.0 if i == j else 0.0)
    for b in singular:
        lo, hi = b * bs, min(n, (b + 1) * bs)
        v = rng.standard_normal(hi - lo)
        A[lo:hi, lo:hi] = numpy.outer(v, v)
    A = A.tocsr()
    for i in empty:
        A.data[A.indptr[i]:A.indptr[i + 1]] = 0
    A.eliminate_zeros()
    return A


@pytest.mark.parametrize('dtype', [numpy.float64, numpy.float32])
@pytest.mark.parametrize('n,bs', [(40, 1), (40, 2), (41, 2), (39, 3), (40, 4), (43, 4), (37, 5), (45, 5)])
def test_block_jacobi_inverse_is_the_jax_one(n, bs, dtype):
    A = _blocky_csr(n, n * 10 + bs)
    data = A.data.astype(dtype)
    got = precon.block_jacobi_inverse(data, A.indices, A.indptr, n, bs)
    want = sparse_jax.block_jacobi_inverse(data, A.indices, A.indptr, n, bs)
    assert got.dtype == want.dtype and got.shape == (-(-n // bs), bs, bs)
    assert numpy.array_equal(got, want)


@pytest.mark.parametrize('n,bs', [(20, 2), (21, 4), (17, 3)])
def test_block_jacobi_inverse_singular_and_empty_blocks(n, bs):
    '''A block with no entries and a singular block take the diagonal
    fallback (zero diagonals as 1), as in the JAX loop.'''
    nb = -(-n // bs)
    empty = range(bs * (nb // 2), min(n, bs * (nb // 2 + 1)))
    A = _blocky_csr(n, 7, empty=empty, singular=(1,), bs=bs)
    got = precon.block_jacobi_inverse(A.data, A.indices, A.indptr, n, bs)
    want = sparse_jax.block_jacobi_inverse(A.data, A.indices, A.indptr, n, bs)
    assert numpy.array_equal(got, want)
    assert numpy.array_equal(got[nb // 2][:len(empty), :len(empty)], numpy.eye(len(empty)))
    d = A.diagonal()[bs:2 * bs]
    assert numpy.array_equal(numpy.diag(got[1]), 1.0 / d) and not got[1][~numpy.eye(bs, dtype=bool)].any()


@pytest.mark.parametrize('bs', range(1, 9))
@pytest.mark.parametrize('n', [1, 29, 64])
def test_block_apply_plain_is_the_jax_apply(n, bs):
    import jax.numpy as jnp
    import torch
    rng = numpy.random.default_rng(n + bs)
    nb = -(-n // bs)
    minv, r = rng.standard_normal((nb, bs, bs)), rng.standard_normal(n)
    want = numpy.asarray(sparse_jax._apply_block(jnp.asarray(minv), jnp.asarray(r)))
    got = precon.block_apply(torch.as_tensor(minv), torch.as_tensor(r)).numpy()
    assert got.shape == (n,)
    numpy.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13 * numpy.abs(want).max())
    out = torch.zeros(n, dtype=torch.float64)
    assert precon.block_apply(torch.as_tensor(minv), torch.as_tensor(r), out=out) is out


# ------------------------------------------------------------ block-preconditioned device solves

@pytest.fixture(scope='module', params=('stencil', 'blockgrid', 'csr'))
def spd(request):
    '''(form, the port's jacobian, the JAX package's, a right-hand side).'''
    with config.device('cpu'):
        jt, _rt = tp.spd_jacobian('nutils_tpu_torch', request.param)
    jj, _rj = tp.spd_jacobian('nutils_tpu', request.param)
    b = numpy.random.default_rng(3).standard_normal(jt.shape[0])
    return request.param, jt, jj, b


@pytest.mark.parametrize('solver,bs', [('cg', 2), ('gmres', 4), ('bicgstab', 3)])
def test_block_precon_solves(spd, solver, bs):
    form, jt, jj, b = spd
    with config.device('cpu'):
        x = jt.solve(b, solver=solver, rtol=1e-10, precon='block', preconargs={'blocksize': bs})
    stats = jt._solve_stats
    want = jj.solve(b, solver=solver, rtol=1e-10, precon='block', preconargs={'blocksize': bs})
    assert stats['precon'] == 'block' and stats['method'] == solver and stats['accepted_on_device']
    assert stats['op_form'] == form
    assert jj._solve_stats['precon'] == 'block'
    assert tp.rel(x, want) <= 1e-8
    assert tp.rel(jt @ x, b) <= 1e-9


def test_block_precon_handle_feeds_the_device():
    with config.device('cpu'):
        A = _laplace_csr('nutils_tpu_torch', 60)
        b = _rand_rhs(60)
        x = A.solve(b, solver='cg', rtol=1e-12, precon=A.getprecon('block', blocksize=3))
        assert A._solve_stats['precon'] == 'block'
    numpy.testing.assert_allclose(x, A.solve(b, solver='direct'), rtol=1e-9)


# ------------------------------------------------------------ host scipy solvers

@pytest.mark.parametrize('pc', ['diag', 'block', 'splu', 'spilu0'])
@pytest.mark.parametrize('solver', ['scipy:cg', 'bicg', 'cgs', 'lgmres'])
def test_solver_scipy(solver, pc):
    Aj, At = (_laplace_csr(pkg, 120) for pkg in PACKAGES)
    b = _rand_rhs(120)
    At._solve_stats = {'method': 'cg', 'accepted_on_device': True}  # a stale device record
    args = {'preconargs': {'blocksize': 3}} if pc == 'block' else {}
    record = {'method': 'scipy:' + solver.removeprefix('scipy:'), 'accepted_on_device': False}
    try:
        want = Aj.solve(b, solver=solver, rtol=1e-10, precon=pc, **args)
    except matrix_jax.ToleranceNotReached as e:
        # scipy's cg and bicg miss the tolerance under this matrix's
        # ILU(0) in the JAX package: the port misses it too, with the same
        # iterate
        with pytest.raises(matrix.ToleranceNotReached) as got:
            At.solve(b, solver=solver, rtol=1e-10, precon=pc, **args)
        assert At._solve_stats == record and numpy.array_equal(got.value.best, e.best)
        return
    x = At.solve(b, solver=solver, rtol=1e-10, precon=pc, **args)
    assert At._solve_stats == record
    assert tp.rel(x, want) <= 1e-12
    assert tp.rel(At @ x, b) <= 1.01e-10


def test_solver_scipy_bicgstab_host_precon():
    '''bicgstab under a host preconditioner is scipy's, as in the JAX
    package.'''
    Aj, At = (_laplace_csr(pkg, 80) for pkg in PACKAGES)
    b = _rand_rhs(80)
    x = At.solve(b, solver='bicgstab', rtol=1e-10, precon='spilu')
    assert At._solve_stats['method'] == 'scipy:bicgstab'
    assert tp.rel(x, Aj.solve(b, solver='bicgstab', rtol=1e-10, precon='spilu')) <= 1e-12


@pytest.mark.parametrize('pkg', PACKAGES)
def test_solver_scipy_tolerance_not_reached(pkg):
    A = _laplace_csr(pkg, 200)
    errors = importlib.import_module(f'{pkg}.matrix')
    with pytest.raises(errors.ToleranceNotReached):
        A.solve(_rand_rhs(200), solver='scipy:cg', rtol=1e-12, maxiter=3)


@pytest.mark.parametrize('pkg', PACKAGES)
def test_unknown_solver(pkg):
    A = _laplace_csr(pkg, 10)
    with pytest.raises(ValueError, match='unknown solver'):
        A.solve(_rand_rhs(10), solver='nonsense')


def test_unknown_scipy_solver():
    A = _laplace_csr('nutils_tpu_torch', 10)
    with pytest.raises(ValueError, match='unknown solver'):
        A.solve(_rand_rhs(10), solver='scipy:nonsense')

