'''The CSR-form jacobian of the PyTorch port against nutils_tpu: the
Navier-Stokes Newton step on ``unitsquare(6, 'triangle')`` in float64
(``build_ns_tri``), which has neither stencil nor block-grid form.  The
pattern is identical; CSR values and the residual agree to 1e-12 relative
(the same quadrature, sums in another order); the plain versions of the
value scatter (K8) and the CSR matvec (K9) give the JAX package's results
to 1e-12.'''

import jax.numpy as jnp
import numpy
import pytest
import torch

import _torch_parity as tp
from nutils_tpu.ops import blockgrid as bg_jax
from nutils_tpu.ops import sparse as sp_jax
from nutils_tpu.ops import stencil as st_jax
from nutils_tpu_torch import carry
from nutils_tpu_torch.ops import blockgrid as bg_torch
from nutils_tpu_torch.ops import sparse as sp_torch
from nutils_tpu_torch.ops import stencil as st_torch
from nutils_tpu_torch.utils import config


@pytest.fixture(scope='module')
def assembled():
    '''Per package: (system, args, jacobian, residual).'''
    out = {}
    with config.device('cpu'):
        for pkg in tp.PACKAGES:
            system, args = tp.build_ns_tri(pkg, 6, numpy.float64)
            jac, res = system.assemble_jacobian_residual(args)
            out[pkg] = system, args, jac, numpy.asarray(res)
    return out


def test_pattern_is_identical(assembled):
    sj, _a, jj, _r = assembled['nutils_tpu']
    st, _a, jt, _r = assembled['nutils_tpu_torch']
    # no stencil or block-grid plan in either package
    assert sj._jac_layout[2] is None and st._jac_layout[2] is None
    assert type(jt).__name__ == 'Matrix' and jt.shape == jj.shape == (387, 387)
    assert numpy.array_equal(jt.indptr, jj.indptr) and numpy.array_equal(jt.indices, jj.indices)
    pj, pt = sj._jac_layout[1].get(), st._jac_layout[1].get()
    assert numpy.array_equal(pt.slot, pj.slot)
    assert jt._field_offsets == tuple(jj._field_offsets)


def test_csr_values_and_residual(assembled):
    _s, _a, jj, rj = assembled['nutils_tpu']
    _s, _a, jt, rt = assembled['nutils_tpu_torch']
    # the port's values stay a tensor on its device
    assert isinstance(jt.data, torch.Tensor) and jt.data.dtype == torch.float64
    assert tp.rel(jt.data.numpy(), numpy.asarray(jj.data)) <= 1e-12
    assert tp.rel(rt, rj) <= 1e-12


def test_value_scatter_matches_jax(assembled):
    # K8's plain version through SparsePattern.scatter, on random entry
    # values of the step's own pattern (entries repeat into shared slots)
    pj = assembled['nutils_tpu'][0]._jac_layout[1].get()
    pt = assembled['nutils_tpu_torch'][0]._jac_layout[1].get()
    values = numpy.random.default_rng(0).standard_normal(len(pj.slot))
    want = numpy.asarray(pj.scatter(jnp.asarray(values)))
    got = pt.scatter(torch.as_tensor(values))
    assert got.shape == (pt.nnz,) and tp.rel(got.numpy(), want) <= 1e-12
    # the scatter plan: entries in slot order, one segment per slot
    assert numpy.array_equal(pt.slot[pt._order], numpy.repeat(numpy.arange(pt.nnz), numpy.diff(pt._segptr)))


@pytest.mark.parametrize('jax_kind', [('bell', 32), ('csr',)])
def test_matvec_matches_jax(assembled, jax_kind):
    # K9's plain version on the port's operator, against the JAX package's
    # BELL layout of the same matrix (its route on this pattern) and its CSR
    # segment sum
    _s, _a, jj, _r = assembled['nutils_tpu']
    _s, _a, jt, _r = assembled['nutils_tpu_torch']
    x = numpy.random.default_rng(1).standard_normal(jj.shape[0])
    if jax_kind == ('csr',):
        op = (jnp.asarray(jj.data), jnp.asarray(jj.indices), jnp.asarray(sp_jax._row_ids(jj.indptr)))
    else:
        mv_kind, op = jj._device_op()
        assert mv_kind == jax_kind
    want = numpy.asarray(sp_jax._make_matvec(jax_kind)(op, jnp.asarray(x)))
    mv_kind, top = jt._device_op()
    assert mv_kind == ('csr',)
    got = sp_torch._make_matvec(mv_kind)(top, torch.as_tensor(x)).numpy()
    assert tp.rel(got, want) <= 1e-12
    assert tp.rel(sp_torch.csr_matvec_plain(*top, torch.as_tensor(x)).numpy(), want) <= 1e-12


def test_operator_form_is_bell_in_jax_and_csr_in_the_port(assembled):
    # the JAX package lays the CSR operand out in padded row blocks for the
    # TPU's gathers; the port keeps the CSR operand itself (ROADMAP: BELL and
    # ELL are not ported)
    _s, _a, jj, rj = assembled['nutils_tpu']
    _s, _a, jt, rt = assembled['nutils_tpu_torch']
    jj.solve_leniently(rj, solver='gmres', rtol=1e-3)
    with config.device('cpu'):
        jt.solve_leniently(rt, solver='gmres', rtol=1e-3)
    assert jj._solve_stats['op_form'] == 'bell'
    assert jt._solve_stats['op_form'] == 'csr'
    assert jt._solve_stats['precon'] == jj._solve_stats['precon'] == 'diag'


def test_no_stencil_or_blockgrid_form(assembled):
    # grid inference rejects the triangle pattern in both packages, as a
    # None rather than an error; the block-grid inference infers each
    # field's grid from its diagonal block
    _s, _a, jj, _r = assembled['nutils_tpu']
    data, indices, indptr, n = numpy.asarray(jj.data), jj.indices, jj.indptr, jj.shape[0]
    assert st_jax.from_csr(data, indices, indptr, n) is None
    assert st_torch.from_csr(data, indices, indptr, n) is None
    offsets = tuple(jj._field_offsets)
    assert bg_jax.detect(data, indices, indptr, offsets) is None
    assert bg_torch.detect(data, indices, indptr, offsets) is None
    assert bg_torch.detect(data, indices, indptr, offsets, grids=(None, None)) is None


def test_carried_csr_matrix_solves_like_jax(assembled):
    # carry.csr_matrix_from_numpy: the JAX-assembled operator in the port,
    # solved with the port's refined GMRES
    _s, _a, jj, rj = assembled['nutils_tpu']
    want = jj.solve_leniently(rj, solver='gmres', rtol=1e-3)
    with config.device('cpu'):
        m = carry.csr_matrix_from_numpy(jj.data, jj.indices, jj.indptr, jj.shape, device='cpu')
        m._field_offsets = tuple(jj._field_offsets)
        got = m.solve_leniently(rj, solver='gmres', rtol=1e-3)
    assert m._device_op()[0] == ('csr',) and m._solve_stats['iters'] == jj._solve_stats['iters']
    assert tp.rel(got, want) <= 1e-8


def _kron_laplacian(shape, periodic):
    import scipy.sparse
    rng = numpy.random.default_rng(len(shape))
    A = None
    for n, per in zip(shape, periodic):
        T = scipy.sparse.diags([numpy.full(n - 1, -1.0), numpy.full(n, 2.0), numpy.full(n - 1, -1.0)], [-1, 0, 1],
                               format='lil')
        if per:
            T[0, n - 1] = T[n - 1, 0] = -1.0
        A = T if A is None else scipy.sparse.kron(A, scipy.sparse.identity(n)) + \
            scipy.sparse.kron(scipy.sparse.identity(A.shape[0]), T)
    A = A.tocsr()
    A.data = A.data * (1 + 0.1 * rng.random(A.nnz))  # values off the grid's symmetry
    return A


@pytest.mark.parametrize('shape,periodic', [((7, 9), (False, False)), ((10, 7), (True, False)),
                                            ((5, 7, 9), (False, False, False))])
def test_grid_inference_matches_jax(shape, periodic):
    # from_csr finds the JAX package's grid, window and weights where a
    # pattern has one
    A = _kron_laplacian(shape, periodic)
    a = st_jax.from_csr(A.data, A.indices, A.indptr, A.shape[0])
    b = st_torch.from_csr(A.data, A.indices, A.indptr, A.shape[0])
    assert a is not None and b is not None
    assert (a.ks, a.shape, a.periodic) == (b.ks, b.shape, b.periodic)
    numpy.testing.assert_array_equal(numpy.asarray(a.w), b.w)
    numpy.testing.assert_array_equal(a.slot, b.slot)


def test_blockgrid_inference_without_hints():
    # the structured step's block-grid form found from the CSR matrix alone
    # is the one the registered field grids give
    system, args = tp.build_ns('nutils_tpu', 6, numpy.float64)
    jac, _res = system.assemble_jacobian_residual(args)
    data, offsets = numpy.asarray(jac.data), tuple(jac._field_offsets)
    hinted = bg_torch.detect(data, jac.indices, jac.indptr, offsets, grids=jac._field_grids)
    inferred = bg_torch.detect(data, jac.indices, jac.indptr, offsets)
    assert hinted is not None and inferred is not None
    assert inferred.meta == hinted.meta
    assert all(numpy.array_equal(a, b) for a, b in zip(inferred.fill[1:], hinted.fill[1:]))


def test_a_stale_field_grid_hint_is_dropped():
    # the structured and the triangle step at 6 elements have fields of the
    # same names and sizes; the triangle field replaces the square's grid
    # hint, so the triangle system plans CSR
    with config.device('cpu'):
        tp.build_ns('nutils_tpu_torch', 6, numpy.float64)
        system, _args = tp.build_ns_tri('nutils_tpu_torch', 6, numpy.float64)
    assert len(system._fields[1]) == 2 and all(grid is None for grid in system._fields[1])
    assert system._jac_layout[2] is None
