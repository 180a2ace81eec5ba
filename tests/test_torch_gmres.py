'''GMRES of the PyTorch port against nutils_tpu.ops.sparse: ``gmres_op`` and
the refined solve on the block-grid operator that nutils_tpu assembles for
the Navier-Stokes step (carried with nutils_tpu_torch.carry), and
multigrid-preconditioned GMRES on a nonsymmetric stencil.  Tolerances: x to
1e-9 relative (the same float64 iteration, sums in another order);
iterations equal, or one apart where an inner exit test sits at a rounding
tie.'''

import jax.numpy as jnp
import numpy
import pytest
import scipy.sparse
import torch

import _torch_parity as tp
from nutils_tpu import matrix as matrix_jax
from nutils_tpu.ops import sparse as sp_jax
from nutils_tpu_torch import carry
from nutils_tpu_torch.ops import sparse as sp_torch
from nutils_tpu_torch.utils import config


@pytest.fixture(scope='module')
def ns():
    system, args = tp.build_ns('nutils_tpu', 6, numpy.float64)
    jac, res = system.assemble_jacobian_residual(args)
    with config.device('cpu'):
        tjac = carry.blockgrid_matrix_from_numpy(jac.data, jac.indices, jac.indptr, jac._field_offsets,
                                                 jac._field_grids, device='cpu')
    minv = sp_jax.schur_diag_inverse(numpy.asarray(jac.data), jac.indices, jac.indptr, jac.shape[0])
    b = numpy.random.default_rng(0).standard_normal(jac.shape[0])
    return dict(jac=jac, res=numpy.asarray(res), tjac=tjac, minv=minv, b=b)


def test_carried_operator(ns):
    # the carried block-grid operator is the JAX package's CSR operator
    tjac = ns['tjac']
    (kind, _plan), (v,) = tjac._device_op()
    assert kind == 'blockgrid' and v.dtype == torch.float64
    assert numpy.array_equal(tjac.data, numpy.asarray(ns['jac'].data))
    x = numpy.random.default_rng(1).standard_normal(tjac.shape[0])
    y = sp_torch._make_matvec(tjac._device_op()[0])(tjac._device_op()[1], torch.as_tensor(x)).numpy()
    assert tp.rel(y, ns['jac']._scipy() @ x) <= 1e-13


@pytest.mark.parametrize('restart', [100, 15])
def test_gmres_op_matches_jax(ns, restart):
    # restart=15 sits below the iteration count: several true-residual
    # restarts
    b = ns['b']
    atol = 1e-8 * numpy.linalg.norm(b)
    mv_kind, op = ns['jac']._device_op()
    xj, rnj, kj = sp_jax.gmres_op(mv_kind, op, jnp.asarray(b), atol=atol, maxiter=2000, restart=restart,
                                  minv=jnp.asarray(ns['minv']), precon='diag')
    tkind, top = ns['tjac']._device_op()
    xt, rnt, kt = sp_torch.gmres_op(tkind, top, torch.as_tensor(b), atol=atol, maxiter=2000, restart=restart,
                                    minv=torch.as_tensor(ns['minv']), precon='diag')
    assert abs(int(kj) - kt) <= 1
    assert restart == 100 or kt > restart
    assert tp.rel(xt.numpy(), numpy.asarray(xj)) <= 1e-9
    assert rnt <= atol and float(rnj) <= atol


def test_refined_gmres_matches_jax(ns):
    b = ns['res']
    target = 1e-6 * numpy.linalg.norm(b)
    mv_kind, op = ns['jac']._device_op()
    xj, rnj, itj, rj = sp_jax.refined_solve_op('gmres', mv_kind, op, b, target=target, maxiter=1024,
                                               minv=jnp.asarray(ns['minv']), precon='diag')
    tkind, top = ns['tjac']._device_op()
    xt, rnt, itt, rt = sp_torch.refined_solve_op('gmres', tkind, top, b, target=target, maxiter=1024,
                                                 minv=torch.as_tensor(ns['minv']), precon='diag')
    assert rt == rj and abs(itt - itj) <= 1
    assert tp.rel(xt, xj) <= 1e-9
    assert rnt <= target


def test_carried_operator_solves_like_jax(ns):
    # the port's Matrix.solve_leniently on the operator nutils_tpu assembled,
    # its preconditioner the port's device Schur diagonal
    want = ns['jac'].solve_leniently(ns['res'], solver='gmres', rtol=1e-3)
    got = ns['tjac'].solve_leniently(ns['res'], solver='gmres', rtol=1e-3)
    stats = ns['tjac']._solve_stats
    assert {k: stats[k] for k in ('method', 'op_form', 'precon', 'accepted_on_device')} == \
        {'method': 'gmres', 'op_form': 'blockgrid', 'precon': 'diag', 'accepted_on_device': True}
    assert abs(stats['iters'] - ns['jac']._solve_stats['iters']) <= 1
    assert tp.rel(got, want) <= 1e-8


def test_auto_fallback_is_recorded(ns):
    # solver='auto' demotes a device GMRES that misses the tolerance to the
    # host direct solve, as the JAX package does; the solve record says so
    # and keeps the failed device attempt's
    tjac, res = ns['tjac'], ns['res']
    with config.device_solve_min(0):
        x = tjac.solve(res, solver='auto', rtol=1e-12, restart=2, maxiter=2)
    stats = tjac._solve_stats
    assert stats['method'] == 'direct' and not stats['accepted_on_device']
    assert stats['fallback_from']['method'] == 'gmres' and not stats['fallback_from']['accepted_on_device']
    assert numpy.linalg.norm(res - ns['jac']._scipy() @ x) <= 1e-12 * numpy.linalg.norm(res)


def _convection_diffusion(n, seed):
    '''Nonsymmetric 9-point stencil weights [9, n, n]: diffusion plus a
    random-strength upwinded convection.'''
    rng = numpy.random.default_rng(seed)
    w = numpy.zeros((9, n, n))
    w[4] = 8.0 + rng.random((n, n))
    for s in (0, 2, 6, 8):
        w[s] = -1.0
    for s, c in ((1, 1.0), (3, 1.5), (5, 0.5), (7, 1.0)):
        w[s] = -c - 0.5 * rng.random((n, n))
    return w


def test_mg_preconditioned_gmres_nonsymmetric():
    # the V-cycle preconditions GMRES on a nonsymmetric stencil (as
    # tests/test_device_op.py does for nutils_tpu): the driver against JAX's
    # on the same hierarchy, and the port's Matrix.solve routing to it
    n = 33
    w = _convection_diffusion(n, 7)
    indptr, indices, data = carry._csr_of_stencil(w, (1, 1), (n, n), (False, False))
    M = matrix_jax.Matrix(indptr, indices, data, (n * n, n * n))
    mg = M._mg()
    assert mg is not None
    mv_kind, op = M._device_op()
    b = numpy.random.default_rng(8).standard_normal(n * n)
    atol = 1e-10 * numpy.linalg.norm(b)
    xj, _rnj, kj = sp_jax.gmres_op(mv_kind, op, jnp.asarray(b), atol=atol, maxiter=500, restart=100,
                                   minv=(mg.ws, mg.dinvs, mg.coarse_inv), precon=('mg', mg.levels))
    with config.device('cpu'):
        tjac = carry.stencil_matrix_from_numpy(numpy.asarray(op[0]), mv_kind[1], mv_kind[2], mv_kind[3],
                                               device='cpu')
        tmg = carry.mgdata_from_numpy([numpy.asarray(a) for a in mg.ws], [numpy.asarray(a) for a in mg.dinvs],
                                      numpy.asarray(mg.coarse_inv), mg.levels, device='cpu')
        xt, _rnt, kt = sp_torch.gmres_op(mv_kind, tjac._device_op()[1], torch.as_tensor(b), atol=atol,
                                         maxiter=500, restart=100, minv=(tmg.ws, tmg.dinvs, tmg.coarse_inv),
                                         precon=('mg', tmg.levels))
        assert abs(int(kj) - kt) <= 1
        assert tp.rel(xt.numpy(), numpy.asarray(xj)) <= 1e-9
        x = tjac.solve(b, solver='gmres', rtol=1e-10)
    assert tjac._solve_stats['precon'] == 'mg' and tjac._solve_stats['method'] == 'gmres'
    assert numpy.linalg.norm(b - M._scipy() @ x) <= 5e-9 * numpy.linalg.norm(b)


# ------------------------------------------- the chunked driver (plain steps)

def _gmres(ns, dtype, chunk, rtol, restart=100, maxiter=2000, b=None):
    b = ns['b'] if b is None else b
    (kind, _plan), top = ns['tjac']._device_op()
    op = tuple(t.to(dtype) for t in top)
    stats = {}
    x, rn, k = sp_torch.gmres_op(ns['tjac']._device_op()[0], op, torch.as_tensor(b, dtype=dtype),
                                 atol=rtol * numpy.linalg.norm(b), maxiter=maxiter, restart=restart,
                                 minv=torch.as_tensor(ns['minv'], dtype=dtype), precon='diag', chunk=chunk,
                                 stats=stats)
    return x, rn, k, stats


def _same(a, b):
    (xa, rna, ka, _sa), (xb, rnb, kb, _sb) = a, b
    assert ka == kb and rna == rnb and torch.equal(xa, xb)


@pytest.mark.parametrize('restart', [100, 15])
@pytest.mark.parametrize('chunk', [1, 3, 8])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_chunked_gmres_is_the_host_loop(ns, dtype, chunk, restart):
    # c Arnoldi steps between reads, those after the inner loop's stop doing
    # nothing, and a cycle end where it has stopped: bitwise the host loop's
    # (x, resnorm, iterations); one read a chunk and one a cycle end
    rtol = 1e-8 if dtype == torch.float64 else 1e-4
    host = _gmres(ns, dtype, None, rtol, restart)
    chunked = _gmres(ns, dtype, chunk, rtol, restart)
    _same(chunked, host)
    assert host[3]['driver'] == 'host' and chunked[3]['driver'] == 'chunked' and chunked[3]['c'] == chunk
    for _x, _rn, k, stats in (host, chunked):
        assert stats['host_reads'] == stats['chunks'] + stats['cycles']
    # the host loop reads once a step (and once more where a cycle's last
    # step left the inner loop)
    assert host[3]['chunks'] >= host[2] and chunked[3]['chunks'] <= -(-host[2] // chunk) + host[3]['cycles']
    if restart == 15:
        # cycles that end at j = m: several true-residual restarts
        assert host[2] > 2 * restart and host[3]['cycles'] >= 3


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_chunked_gmres_stalls(dtype):
    # GMRES(m) stagnates on the cyclic shift for m < n: no cycle reduces the
    # true residual of b = e_0, and the fifth ends the loop at 5 m steps
    n, m = 50, 10
    A = scipy.sparse.csr_matrix((numpy.ones(n), numpy.roll(numpy.arange(n), 1), numpy.arange(n + 1)), shape=(n, n))
    op = (torch.as_tensor(A.data, dtype=dtype), torch.as_tensor(A.indices.astype(numpy.int32)),
          torch.as_tensor(A.indptr.astype(numpy.int32)))
    b = torch.zeros(n, dtype=dtype)
    b[0] = 1
    out = []
    for chunk in (None, 3):
        stats = {}
        x, rn, k = sp_torch.gmres_op(('csr',), op, b, atol=1e-8, maxiter=1000, restart=m,
                                     minv=torch.ones(n, dtype=dtype), precon='diag', chunk=chunk, stats=stats)
        out.append((x, rn, k, stats))
    _same(*out)
    x, rn, k, stats = out[0]
    assert k == 5 * m and stats['cycles'] == 5 and rn == 1.0 and not x.any()


@pytest.mark.parametrize('maxiter', [0, 1, 20])
def test_chunked_gmres_maxiter_inside_a_chunk(ns, maxiter):
    # the cap is the outer loop's: checked at cycle ends (it += j)
    host = _gmres(ns, torch.float64, None, 1e-14, restart=15, maxiter=maxiter)
    chunked = _gmres(ns, torch.float64, 8, 1e-14, restart=15, maxiter=maxiter)
    _same(chunked, host)
    assert host[2] == -(-maxiter // 15) * 15


@pytest.mark.parametrize('chunk', [None, 8])
def test_chunked_gmres_matches_jax(ns, chunk):
    b = ns['b']
    atol = 1e-8 * numpy.linalg.norm(b)
    mv_kind, op = ns['jac']._device_op()
    xj, rnj, kj = sp_jax.gmres_op(mv_kind, op, jnp.asarray(b), atol=atol, maxiter=2000, restart=15,
                                  minv=jnp.asarray(ns['minv']), precon='diag')
    xt, rnt, kt, _stats = _gmres(ns, torch.float64, chunk, 1e-8, restart=15)
    assert abs(int(kj) - kt) <= 1
    assert tp.rel(xt.numpy(), numpy.asarray(xj)) <= 1e-9


@pytest.mark.parametrize('chunk', [None, 8])
def test_chunked_refined_gmres(ns, chunk):
    # the chunked refined solve is the host loop's bit for bit and the JAX
    # package's to 1e-9; one read a chunk, a cycle end and a round
    b = ns['res']
    target = 1e-6 * numpy.linalg.norm(b)
    mv_kind, op = ns['jac']._device_op()
    xj, rnj, itj, rj = sp_jax.refined_solve_op('gmres', mv_kind, op, b, target=target, maxiter=1024,
                                               minv=jnp.asarray(ns['minv']), precon='diag')
    tkind, top = ns['tjac']._device_op()
    kw = dict(target=target, maxiter=1024, minv=torch.as_tensor(ns['minv']), precon='diag')
    stats = {}
    got = sp_torch.refined_solve_op('gmres', tkind, top, b, chunk=chunk, stats=stats, **kw)
    want = sp_torch.refined_solve_op('gmres', tkind, top, b, chunk=None, **kw)
    assert got[1:] == want[1:] and numpy.array_equal(got[0], want[0])
    assert got[1] <= target and got[3] == rj and abs(got[2] - itj) <= 1 and tp.rel(got[0], xj) <= 1e-9
    assert stats['host_reads'] == stats['chunks'] + stats['cycles'] + got[3]
