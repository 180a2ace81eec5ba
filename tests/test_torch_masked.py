'''The device solvers' masked operator (``_isfree=``: ``m A(m x) + (1 - m)
x`` on the device, kernel K14's plain versions on the CPU) of the PyTorch
port against nutils_tpu, on the port's stencil, block-grid and CSR forms,
and against the public constrained solve.  Tolerances: 1e-8 relative where
both solves run to rtol 1e-10 (these systems' condition numbers are below
1e3); the masked matvec to 1e-14 of its largest value (sums in another
order).'''

import numpy
import pytest
import torch

import _torch_parity as tp
from nutils_tpu.ops import sparse as sparse_jax
from nutils_tpu_torch.ops import sparse
from nutils_tpu_torch.utils import config


@pytest.fixture(scope='module', params=('stencil', 'blockgrid', 'csr'))
def case(request):
    '''(form, the port's jacobian, the JAX package's, a right-hand side,
    the free rows).'''
    with config.device('cpu'):
        jt, _rt = tp.spd_jacobian('nutils_tpu_torch', request.param)
    jj, _rj = tp.spd_jacobian('nutils_tpu', request.param)
    n = jt.shape[0]
    rng = numpy.random.default_rng(5)
    isfree = numpy.ones(n, dtype=bool)
    isfree[rng.choice(n, n // 5, replace=False)] = False
    return request.param, jt, jj, rng.standard_normal(n), isfree


@pytest.mark.parametrize('method,precon', [('cg', None), ('gmres', 'block'), ('bicgstab', None)])
def test_masked_solve(case, method, precon):
    form, jt, jj, b, isfree = case
    kw = dict(atol=0., rtol=1e-10, precon=precon, preconargs={'blocksize': 2}, _isfree=isfree)
    with config.device('cpu'):
        x = getattr(jt, f'_solve_{method}')(b, **kw)
    stats = jt._solve_stats
    want = getattr(jj, f'_solve_{method}')(b, **kw)
    assert stats['op_form'] == 'masked' == jj._solve_stats['op_form']
    assert stats['precon'] == (precon or 'diag') and stats['method'] == method and stats['accepted_on_device']
    assert tp.rel(x, want) <= 1e-8
    # the fixed rows are the identity's, the free ones solve A_ff x_f = b_f:
    # the public constrained solve of the free rows' right-hand side
    assert tp.rel(x[~isfree], b[~isfree]) <= 1e-8
    with config.device('cpu'):
        y = jt.solve(numpy.where(isfree, b, 0.), constrain=~isfree, solver=method, rtol=1e-10)
    assert tp.rel(x[isfree], y[isfree]) <= 1e-8


def test_masked_solve_keeps_its_operands(case):
    '''A second masked solve reuses the mask and the preconditioner on the
    device (the CG graphs are keyed on their operands), and an unmasked
    solve afterwards is not masked.'''
    form, jt, _jj, b, isfree = case
    with config.device('cpu'):
        x1 = jt._solve_cg(b, atol=0., rtol=1e-10, _isfree=isfree)
        cached = jt._masked_op_cache[3], jt._device_minv_cache[2]
        x2 = jt._solve_cg(b, atol=0., rtol=1e-10, _isfree=isfree)
        assert jt._masked_op_cache[3] is cached[0] and jt._device_minv_cache[2] is cached[1]
        assert numpy.array_equal(x1, x2)
        jt._solve_cg(b, atol=0., rtol=1e-10)
        assert jt._solve_stats['op_form'] == form


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_masked_matvec_is_the_jax_expression(dtype):
    '''The port's ('masked', ('csr',)) matvec (K14's plain versions around
    K9's) against the JAX package's on the same CSR operand.'''
    import jax.numpy as jnp
    rng = numpy.random.default_rng(9)
    data, indices, indptr = tp.csr_of_rows([3, 0, 5, 1, 7, 2] * 20, 3)
    n = len(indptr) - 1
    m = (rng.random(n) > 0.3).astype(float)
    x = rng.standard_normal(n)
    rows = numpy.repeat(numpy.arange(n), numpy.diff(indptr))
    want = sparse_jax._make_matvec(('masked', ('csr',)))(
        tuple(jnp.asarray(a) for a in (m, data, indices, rows)), jnp.asarray(x))
    op = tuple(torch.as_tensor(a) for a in (m, data)) + tuple(torch.as_tensor(a) for a in (indices, indptr))
    op = tuple(t.to(dtype) if t.is_floating_point() else t for t in op)
    got = sparse._make_matvec(('masked', ('csr',)))(op, torch.as_tensor(x, dtype=dtype))
    want = numpy.asarray(want)
    tol = 1e-14 if dtype == torch.float64 else 1e-6
    assert numpy.abs(got.double().numpy() - want).max() <= tol * numpy.abs(want).max()
    assert numpy.array_equal(got.numpy()[m == 0], x[m == 0].astype(got.numpy().dtype))


def test_mask_passes_write_out():
    m = torch.tensor([1., 0., 1.], dtype=torch.float64)
    x = torch.tensor([2., 3., -4.], dtype=torch.float64)
    y = torch.tensor([5., 6., 7.], dtype=torch.float64)
    xm = torch.empty(3, dtype=torch.float64)
    assert sparse.mask_pre(m, x, out=xm) is xm and xm.tolist() == [2., 0., -4.]
    assert sparse.mask_post(m, y, x, out=y) is y and y.tolist() == [5., 3., 7.]
