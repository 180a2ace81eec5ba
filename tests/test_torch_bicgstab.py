'''BiCGStab of the PyTorch port against nutils_tpu.ops.sparse: the driver
(K10's plain versions, K9's plain matvec) on the nonsymmetric systems of
tests/test_matrix.py, on a system whose recurrence breaks down, and the
refined BiCGStab and GMRES solves of the triangle Navier-Stokes step
(``build_ns_tri``, 6 elements a side, float64).  Tolerances: x to 1e-9
relative for the same float64 iteration with sums in another order, dx of
the refined solves to 1e-8; iteration counts equal.'''

import jax.numpy as jnp
import numpy
import pytest
import scipy.sparse
import torch

import _torch_parity as tp
from nutils_tpu import matrix as matrix_jax
from nutils_tpu.ops import sparse as sp_jax
from nutils_tpu_torch import matrix as matrix_torch
from nutils_tpu_torch.ops import sparse as sp_torch
from nutils_tpu_torch.utils import config


def _tridiagonal(n, lower, main, upper):
    return scipy.sparse.diags([numpy.full(n - 1, lower), numpy.full(n, main), numpy.full(n - 1, upper)],
                              [-1, 0, 1]).tocsr()


def _zero_corner(n):
    # the upwind matrix with A[0, 0] = 0: with b = e_0 the first rhat . v is
    # A[0, 0], exactly zero, so alpha takes the guarded denominator
    A = _tridiagonal(n, -1.7, 4.0, -0.3).tolil()
    A[0, 0] = 0
    return A.tocsr()


SYSTEMS = {
    # tests/test_matrix.py test_device_bicgstab_nonsymmetric
    'upwind400': (lambda: _tridiagonal(400, -1.7, 4.0, -0.3), 3),
    # tests/test_matrix.py test_device_bicgstab_with_constraints, without
    # the constraints (the masked operator is ROADMAP A3)
    'tridiag300': (lambda: _tridiagonal(300, -1.2, 3.0, -0.8), 4),
    'zero_corner100': (lambda: _zero_corner(100), None),
}


def _both_ops(A):
    jop = (jnp.asarray(A.data), jnp.asarray(A.indices), jnp.asarray(sp_jax._row_ids(A.indptr)))
    top = (torch.as_tensor(A.data), torch.as_tensor(A.indices.astype(numpy.int32)),
           torch.as_tensor(A.indptr.astype(numpy.int32)))
    return jop, top


@pytest.mark.parametrize('name', list(SYSTEMS))
def test_bicgstab_op_matches_jax(name):
    make, seed = SYSTEMS[name]
    A = make()
    b = numpy.eye(A.shape[0])[0] if seed is None else numpy.random.default_rng(seed).standard_normal(A.shape[0])
    atol = 1e-10 * numpy.linalg.norm(b)
    d = A.diagonal()
    minv = 1 / numpy.where(d != 0, d, 1.0)
    jop, top = _both_ops(A)
    xj, rnj, kj = sp_jax.bicgstab_op(('csr',), jop, jnp.asarray(b), atol=atol, maxiter=1000,
                                     minv=jnp.asarray(minv), precon='diag')
    xt, rnt, kt = sp_torch.bicgstab_op(('csr',), top, torch.as_tensor(b), atol=atol, maxiter=1000,
                                       minv=torch.as_tensor(minv), precon='diag')
    assert kt == int(kj)
    assert tp.rel(xt.numpy(), numpy.asarray(xj)) <= 1e-9
    assert rnt <= atol and float(rnj) <= atol
    assert numpy.linalg.norm(b - A @ xt.numpy()) <= 1e-9 * numpy.linalg.norm(b)


@pytest.mark.parametrize('name', ['upwind400', 'tridiag300'])
def test_matrix_solve_bicgstab(name):
    # Matrix.solve through the refined device solve, as tests/test_matrix.py
    # calls it
    make, seed = SYSTEMS[name]
    A = make()
    b = numpy.random.default_rng(seed).standard_normal(A.shape[0])
    want = matrix_jax.Matrix(A.indptr, A.indices, A.data, A.shape).solve(b, solver='bicgstab', rtol=1e-10)
    with config.device('cpu'):
        m = matrix_torch.Matrix(A.indptr, A.indices, A.data, A.shape)
        got = m.solve(b, solver='bicgstab', rtol=1e-10)
    # a tridiagonal matrix is a 1-D stencil: both packages route it to the
    # stencil operator with the multigrid preconditioner
    assert m._solve_stats['method'] == 'bicgstab' and m._solve_stats['op_form'] == 'stencil'
    assert numpy.linalg.norm(b - A @ got) <= 1e-9 * numpy.linalg.norm(b)
    assert tp.rel(got, want) <= 1e-9


@pytest.fixture(scope='module')
def ns_tri():
    out = {}
    with config.device('cpu'):
        for pkg in tp.PACKAGES:
            system, args = tp.build_ns_tri(pkg, 6, numpy.float64)
            jac, res = system.assemble_jacobian_residual(args)
            out[pkg] = jac, numpy.asarray(res)
    return out


# iterations of each method in both packages at 6x6 (refinement round 1)
ITERS = {'gmres': 22, 'bicgstab': 11}


@pytest.mark.parametrize('method', list(ITERS))
def test_refined_step_solve_matches_jax(ns_tri, method):
    jj, rj = ns_tri['nutils_tpu']
    jt, rt = ns_tri['nutils_tpu_torch']
    dxj = jj.solve_leniently(rj, solver=method, rtol=1e-3)
    with config.device('cpu'):
        dxt = jt.solve_leniently(rt, solver=method, rtol=1e-3)
    sj, st = jj._solve_stats, jt._solve_stats
    for stats in (sj, st):
        assert stats['method'] == method and stats['precon'] == 'diag' and stats['accepted_on_device']
        assert stats['iters'] == ITERS[method] and stats['rounds'] == 1
    assert tp.rel(dxt, dxj) <= 1e-8
    assert numpy.linalg.norm(rt - jt @ dxt) <= 1e-3 * numpy.linalg.norm(rt)


# ------------------------------------------- the chunked driver (plain steps)

def _convection(n, c):
    # a 2-D upwinded convection-diffusion 5-point operator on n x n points
    T = scipy.sparse.diags([numpy.full(n - 1, -1 - c), numpy.full(n, 2.0), numpy.full(n - 1, -1 + c)], [-1, 0, 1])
    I = scipy.sparse.identity(n)
    return (scipy.sparse.kron(I, T) + scipy.sparse.kron(T, I)).tocsr()


CHUNKED = {
    'upwind400': (lambda: _tridiagonal(400, -1.7, 4.0, -0.3), 3),
    'convection900': (lambda: _convection(30, 0.3), 5),
}


def _bicgstab(name, dtype, chunk, rtol, maxiter=2000):
    make, seed = CHUNKED[name]
    A = make()
    b = numpy.random.default_rng(seed).standard_normal(A.shape[0])
    op = (torch.as_tensor(A.data, dtype=dtype), torch.as_tensor(A.indices.astype(numpy.int32)),
          torch.as_tensor(A.indptr.astype(numpy.int32)))
    stats = {}
    x, rn, k = sp_torch.bicgstab_op(('csr',), op, torch.as_tensor(b, dtype=dtype), atol=rtol * numpy.linalg.norm(b),
                                    maxiter=maxiter, minv=torch.as_tensor(1 / A.diagonal(), dtype=dtype),
                                    precon='diag', chunk=chunk, stats=stats)
    return x, rn, k, stats


def _same(a, b):
    (xa, rna, ka, sa), (xb, rnb, kb, sb) = a, b
    assert ka == kb and rna == rnb and torch.equal(xa, xb)
    assert all(sa[key] == sb[key] for key in ('refreshes', 'refuted', 'breakdowns'))


@pytest.mark.parametrize('name', list(CHUNKED))
@pytest.mark.parametrize('chunk', [1, 3, 8])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_chunked_bicgstab_is_the_host_loop(name, dtype, chunk):
    # c iterations between reads, those after the loop's exit doing
    # nothing: bitwise the host loop's (x, rnorm, k); one read a chunk
    rtol = 1e-10 if dtype == torch.float64 else 1e-5
    host = _bicgstab(name, dtype, None, rtol)
    chunked = _bicgstab(name, dtype, chunk, rtol)
    _same(chunked, host)
    assert host[3]['driver'] == 'host' and chunked[3]['driver'] == 'chunked'
    for _x, _rn, k, stats in (host, chunked):
        assert stats['host_reads'] == stats['chunks']
    assert host[3]['chunks'] == host[2] and chunked[3]['chunks'] == -(-host[2] // chunk)


def test_chunked_bicgstab_refreshes_and_refuted_claims():
    # float32 below its attainable residual: the 64-iteration refresh, and
    # claims that the true residual refutes, each a breakdown restart from
    # the true residual, up to the cap
    host = _bicgstab('convection900', torch.float32, None, 1e-9, maxiter=300)
    chunked = _bicgstab('convection900', torch.float32, 8, 1e-9, maxiter=300)
    _same(chunked, host)
    _x, _rn, k, stats = host
    assert k == 300 and stats['refreshes'] >= 300 // 64 + stats['refuted']
    assert stats['refuted'] >= 1 and stats['breakdowns'] >= stats['refuted']


@pytest.mark.parametrize('maxiter', [0, 1, 10, 13])
def test_chunked_bicgstab_maxiter_inside_a_chunk(maxiter):
    host = _bicgstab('convection900', torch.float64, None, 1e-14, maxiter)
    chunked = _bicgstab('convection900', torch.float64, 8, 1e-14, maxiter)
    _same(chunked, host)
    assert host[2] == maxiter


@pytest.mark.parametrize('chunk', [None, 8])
@pytest.mark.parametrize('name', list(SYSTEMS))
def test_chunked_bicgstab_op_matches_jax(name, chunk):
    make, seed = SYSTEMS[name]
    A = make()
    b = numpy.eye(A.shape[0])[0] if seed is None else numpy.random.default_rng(seed).standard_normal(A.shape[0])
    atol = 1e-10 * numpy.linalg.norm(b)
    d = A.diagonal()
    minv = 1 / numpy.where(d != 0, d, 1.0)
    jop, top = _both_ops(A)
    xj, rnj, kj = sp_jax.bicgstab_op(('csr',), jop, jnp.asarray(b), atol=atol, maxiter=1000,
                                     minv=jnp.asarray(minv), precon='diag')
    xt, rnt, kt = sp_torch.bicgstab_op(('csr',), top, torch.as_tensor(b), atol=atol, maxiter=1000,
                                       minv=torch.as_tensor(minv), precon='diag', chunk=chunk)
    assert kt == int(kj)
    assert tp.rel(xt.numpy(), numpy.asarray(xj)) <= 1e-9


@pytest.mark.parametrize('chunk', [None, 8])
def test_chunked_refined_bicgstab(chunk):
    # float32 inner solves in a float64 refinement: the chunked solve is the
    # host loop's bit for bit and the JAX package's to the target; one read
    # a chunk and one a round
    A = _convection(30, 0.3)
    b = numpy.random.default_rng(5).standard_normal(A.shape[0])
    target = 1e-10 * numpy.linalg.norm(b)
    jop, top = _both_ops(A)
    xj, rnj, itj, rj = sp_jax.refined_solve_op('bicgstab', ('csr',), jop, b, target=target, maxiter=1024,
                                               minv=jnp.asarray(1 / A.diagonal()), precon='diag')
    top32 = (top[0].float(),) + top[1:]
    kw = dict(target=target, maxiter=1024, minv=torch.as_tensor(1 / A.diagonal(), dtype=torch.float32),
              precon='diag', op64=top)
    stats = {}
    got = sp_torch.refined_solve_op('bicgstab', ('csr',), top32, b, chunk=chunk, stats=stats, **kw)
    want = sp_torch.refined_solve_op('bicgstab', ('csr',), top32, b, chunk=None, **kw)
    assert got[1:] == want[1:] and numpy.array_equal(got[0], want[0])
    assert got[1] <= target and numpy.linalg.norm(got[0] - numpy.asarray(xj)) <= 1e-8 * numpy.linalg.norm(xj)
    assert stats['host_reads'] == stats['chunks'] + got[3]
