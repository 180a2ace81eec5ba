'''``_cg_driver`` and the refined solve of the PyTorch port against nutils_tpu.ops.sparse,
on the operator and multigrid hierarchy that nutils_tpu assembles, brought
over with nutils_tpu_torch.carry.'''

import jax.numpy as jnp
import numpy
import pytest
import torch

import _torch_parity as tp
from nutils_tpu.ops import sparse as sp_jax
from nutils_tpu_torch import carry
from nutils_tpu_torch.ops import sparse as sp_torch
from nutils_tpu_torch.utils import config


@pytest.fixture(scope='module')
def problem():
    system = tp.build_laplace('nutils_tpu', 64, numpy.float64, reaction=True)
    jac, res = system.assemble_jacobian_residual({'u': numpy.zeros(system.trial_shapes[0][0])})
    mg = jac._mg()
    mv_kind, op = jac._device_op()
    w = numpy.asarray(op[0])
    with config.device('cpu'):
        tjac = carry.stencil_matrix_from_numpy(w, jac._ks, jac._grid, jac._periodic, jac.shape, device='cpu')
        tmg = carry.mgdata_from_numpy([numpy.asarray(a) for a in mg.ws], [numpy.asarray(a) for a in mg.dinvs],
                                      numpy.asarray(mg.coarse_inv), mg.levels, device='cpu')
    b = numpy.random.default_rng(0).standard_normal(jac.shape[0])
    return dict(jac=jac, res=res, mg=mg, mv_kind=mv_kind, op=op, w=w, tjac=tjac, tmg=tmg, b=b)


def _minv(p, precon):
    if precon == 'mg':
        return ('mg', p['mg'].levels), (p['mg'].ws, p['mg'].dinvs, p['mg'].coarse_inv), \
            (p['tmg'].ws, p['tmg'].dinvs, p['tmg'].coarse_inv)
    minv = 1.0 / p['jac'].diagonal()
    return 'diag', jnp.asarray(minv), torch.as_tensor(minv)


@pytest.mark.parametrize('precon', ['mg', 'diag'])
def test_cg_driver_matches_jax(problem, precon):
    # x rel 1e-9; iterations equal, or one apart where a refresh test sits
    # at a rounding tie
    p = problem
    kind, mj, mt = _minv(p, precon)
    atol = 1e-9 * numpy.linalg.norm(p['b'])
    xj, rnj, kj = sp_jax.cg_op(p['mv_kind'], p['op'], jnp.asarray(p['b']), atol=atol, maxiter=2000,
                               minv=mj, precon=kind)
    top = p['tjac']._device_op()[1]
    xt, rnt, kt = sp_torch.cg_op(p['mv_kind'], top, torch.as_tensor(p['b']), atol=atol, maxiter=2000,
                                 minv=mt, precon=kind)
    assert abs(int(kj) - kt) <= 1
    assert tp.rel(xt.numpy(), numpy.asarray(xj)) <= 1e-9
    assert rnt <= atol and float(rnj) <= atol


def test_refined_solve_matches_jax(problem):
    p = problem
    kind, mj, mt = _minv(p, 'mg')
    target = 1e-10 * numpy.linalg.norm(p['b'])
    xj, rnj, itj, rj = sp_jax.refined_solve_op('cg', p['mv_kind'], p['op'], p['b'], target=target,
                                               maxiter=1024, minv=mj, precon=kind)
    top = p['tjac']._device_op()[1]
    xt, rnt, itt, rt = sp_torch.refined_solve_op('cg', p['mv_kind'], top, p['b'], target=target,
                                                 maxiter=1024, minv=mt, precon=kind)
    assert rt == rj and abs(itt - itj) <= 1
    assert tp.rel(xt, xj) <= 1e-9
    assert rnt <= target


def test_carried_operator_solves_like_jax(problem):
    # the port's Matrix.solve on the operator nutils_tpu assembled
    p = problem
    want = p['jac'].solve(p['res'], solver='cg', rtol=1e-10)
    with config.device('cpu'):
        tjac = carry.stencil_matrix_from_numpy(p['w'], p['jac']._ks, p['jac']._grid, p['jac']._periodic,
                                               device='cpu')
        got = tjac.solve(p['res'], solver='cg', rtol=1e-10)
    assert tjac._solve_stats['op_form'] == 'stencil' and tjac._solve_stats['precon'] == 'mg'
    assert tp.rel(got, want) <= 1e-8
    args = carry.arguments_from_numpy({'u': got}, device='cpu', dtype=numpy.float32)
    assert args['u'].dtype == torch.float32 and args['u'].shape == got.shape


# ------------------------------------------- the chunked driver (plain steps)

def _operands(p, precon, dtype):
    kind, _mj, mt = _minv(p, precon)
    op = tuple(t.to(dtype) for t in p['tjac']._device_op()[1])
    if precon == 'mg':
        mt = tuple(tuple(t.to(dtype) for t in m) if isinstance(m, tuple) else m.to(dtype) for m in mt)
    else:
        mt = mt.to(dtype)
    return kind, op, mt


def _cg(p, precon, dtype, chunk, rtol, maxiter=2000):
    kind, op, mt = _operands(p, precon, dtype)
    b = torch.as_tensor(p['b'], dtype=dtype)
    stats = {}
    x, rn, k = sp_torch.cg_op(p['mv_kind'], op, b, atol=rtol * numpy.linalg.norm(p['b']), maxiter=maxiter,
                              minv=mt, precon=kind, chunk=chunk, stats=stats)
    return x, rn, k, stats


def _same(a, b):
    (xa, rna, ka, _sa), (xb, rnb, kb, _sb) = a, b
    assert ka == kb and rna == rnb and torch.equal(xa, xb)


@pytest.mark.parametrize('chunk', [1, 3, 8, 64])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('precon', ['mg', 'diag'])
def test_chunked_cg_is_the_host_loop(problem, precon, dtype, chunk):
    # c iterations between reads, the ones after the loop's stop doing
    # nothing: bitwise the host loop's (x, rnorm, k)
    rtol = 1e-9 if dtype == torch.float64 else 1e-5
    host = _cg(problem, precon, dtype, None, rtol)
    chunked = _cg(problem, precon, dtype, chunk, rtol)
    _same(chunked, host)
    assert host[3]['driver'] == 'host' and chunked[3]['driver'] == 'chunked'
    for _x, _rn, k, stats in (host, chunked):
        assert stats['host_reads'] == stats['chunks'] + stats.get('refreshes', 0)
    assert host[3]['chunks'] == host[2] and chunked[3]['chunks'] <= -(-host[2] // chunk) + host[3]['refreshes']


def test_chunked_cg_past_the_scheduled_refresh(problem):
    # diagonal scaling to a tight tolerance runs past iteration 64: the
    # scheduled refresh keeps the direction
    host = _cg(problem, 'diag', torch.float64, None, 1e-11)
    chunked = _cg(problem, 'diag', torch.float64, 5, 1e-11)
    _same(chunked, host)
    assert host[2] > 128 and host[3]['refreshes'] >= host[2] // 64


def test_chunked_cg_refuted_claim_and_stall(problem):
    # float32 below its attainable residual: the recursion claims, the true
    # residual refutes (the direction restarts), and the refreshes stall
    host = _cg(problem, 'mg', torch.float32, None, 1e-9)
    chunked = _cg(problem, 'mg', torch.float32, 8, 1e-9)
    _same(chunked, host)
    x, rn, k, stats = host
    assert stats['refuted'] >= 4 and k < 2000 and rn > 1e-9 * numpy.linalg.norm(problem['b'])


@pytest.mark.parametrize('maxiter', [0, 1, 10, 13])
def test_chunked_cg_maxiter_inside_a_chunk(problem, maxiter):
    host = _cg(problem, 'diag', torch.float64, None, 1e-12, maxiter)
    chunked = _cg(problem, 'diag', torch.float64, 8, 1e-12, maxiter)
    _same(chunked, host)
    assert host[2] == maxiter


@pytest.mark.parametrize('chunk', [None, 8])
@pytest.mark.parametrize('precon', ['mg', 'diag'])
def test_chunked_cg_matches_jax(problem, precon, chunk):
    p = problem
    kind, mj, mt = _minv(p, precon)
    atol = 1e-9 * numpy.linalg.norm(p['b'])
    xj, rnj, kj = sp_jax.cg_op(p['mv_kind'], p['op'], jnp.asarray(p['b']), atol=atol, maxiter=2000,
                               minv=mj, precon=kind)
    top = p['tjac']._device_op()[1]
    xt, rnt, kt = sp_torch.cg_op(p['mv_kind'], top, torch.as_tensor(p['b']), atol=atol, maxiter=2000,
                                 minv=mt, precon=kind, chunk=chunk)
    assert abs(int(kj) - kt) <= 1
    assert tp.rel(xt.numpy(), numpy.asarray(xj)) <= 1e-9


@pytest.mark.parametrize('chunk', [None, 8])
def test_chunked_refined_solve_matches_jax(problem, chunk):
    p = problem
    kind, mj, mt = _minv(p, 'mg')
    target = 1e-10 * numpy.linalg.norm(p['b'])
    xj, rnj, itj, rj = sp_jax.refined_solve_op('cg', p['mv_kind'], p['op'], p['b'], target=target,
                                               maxiter=1024, minv=mj, precon=kind)
    top = tuple(t.float() for t in p['tjac']._device_op()[1])
    mt32 = tuple(tuple(t.float() for t in m) if isinstance(m, tuple) else m.float() for m in mt)
    stats = {}
    xt, rnt, itt, rt = sp_torch.refined_solve_op('cg', p['mv_kind'], top, p['b'], target=target, maxiter=1024,
                                                 minv=mt32, precon=kind, op64=p['tjac']._device_op()[1],
                                                 chunk=chunk, stats=stats)
    xh, rnh, ith, rh = sp_torch.refined_solve_op('cg', p['mv_kind'], top, p['b'], target=target, maxiter=1024,
                                                 minv=mt32, precon=kind, op64=p['tjac']._device_op()[1],
                                                 chunk=None)
    # float32 inner solves: the chunked driver is the host loop bit for bit
    assert (itt, rt, rnt) == (ith, rh, rnh) and numpy.array_equal(xt, xh)
    assert rnt <= target
    assert tp.rel(xt, xj) <= 1e-9
    # one read a chunk, one a refresh and one a round
    assert stats['host_reads'] == stats['chunks'] + stats['refreshes'] + rt
    assert stats['chunks'] == itt if chunk is None else stats['chunks'] < itt
