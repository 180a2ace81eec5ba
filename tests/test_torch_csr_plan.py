'''K9's row-block plan (``ops/sparse.csr_plan``) of the PyTorch port, and the
CSR matvec with its plan on the CPU against ``nutils_tpu.ops.sparse``.  The
kernel that reads the plan is held against its plain version on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).'''

import jax.numpy as jnp
import numpy
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import _torch_parity as tp
from nutils_tpu.ops import sparse as sp_jax
from nutils_tpu_torch.ops import sparse as sp_torch
from nutils_tpu_torch.utils import config


def _check_plan(lens, cap):
    indptr = numpy.concatenate([[0], numpy.cumsum(lens, dtype=numpy.int64)]).astype(numpy.int32)
    starts = sp_torch.csr_plan(torch.as_tensor(indptr), cap)
    assert starts.dtype == torch.int32
    starts = starts.numpy().astype(numpy.int64)
    n = len(lens)
    # every row in exactly one block: strictly increasing starts from 0 to n
    assert starts[0] == 0 and starts[-1] == n and (numpy.diff(starts) > 0).all()
    for r0, r1 in zip(starts[:-1], starts[1:]):
        nnz = indptr[r1] - indptr[r0]
        rows = lens[r0:r1]
        # a row of more than cap // 2 nonzeros is a block of its own; other
        # blocks hold at most cap nonzeros
        if (rows > cap // 2).any():
            assert r1 - r0 == 1
        else:
            assert nnz <= cap
    return starts


@settings(max_examples=200, deadline=None)
@given(lens=st.lists(st.integers(0, 80), max_size=300), cap=st.sampled_from([8, 16, 64, 128]))
def test_plan_covers_every_row_once(lens, cap):
    _check_plan(numpy.asarray(lens, dtype=numpy.int64), cap)


@settings(max_examples=50, deadline=None)
@given(lens=st.lists(st.one_of(st.just(0), st.integers(1, 3), st.integers(60, 400)), min_size=1, max_size=100))
def test_plan_long_and_empty_rows(lens):
    # rows past the budget (cap 64) among empty and one-entry rows
    lens = numpy.asarray(lens, dtype=numpy.int64)
    starts = _check_plan(lens, 64)
    blocks = set(zip(starts[:-1].tolist(), starts[1:].tolist()))
    for r in numpy.flatnonzero(lens > 32):
        assert (r, r + 1) in blocks


def test_plan_of_no_rows():
    assert sp_torch.csr_plan(torch.zeros(1, dtype=torch.int32)).tolist() == [0]


def test_plan_of_the_triangle_operator_is_kept_with_it():
    # the plan is made with the operator (Matrix._device_op) and kept on
    # its row pointers; the triangle step's rows (~15-35 nonzeros) fill the
    # blocks to within the longest row of CSR_CAP
    with config.device('cpu'):
        system, args = tp.build_ns_tri('nutils_tpu_torch', 6, numpy.float64)
        jac, _res = system.assemble_jacobian_residual(args)
        (kind,), (data, indices, indptr) = jac._device_op()
    assert kind == 'csr'
    plan = indptr._k9_plan
    assert plan is sp_torch.csr_plan_of(indptr)
    lens = numpy.diff(indptr.numpy())
    _check_plan(lens, sp_torch.CSR_CAP)
    assert torch.equal(plan, sp_torch.csr_plan(indptr))


def test_matvec_with_its_plan_matches_jax():
    # csr_matvec on the CPU (its plain version), with the operator's plan
    # made, against nutils_tpu.ops.sparse.csr_matvec on the same arrays
    with config.device('cpu'):
        system, args = tp.build_ns_tri('nutils_tpu_torch', 4, numpy.float64)
        jac, _res = system.assemble_jacobian_residual(args)
        _kind, (data, indices, indptr) = jac._device_op()
    x = numpy.random.default_rng(3).standard_normal(jac.shape[0])
    want = numpy.asarray(sp_jax.csr_matvec(jnp.asarray(data.numpy()), jnp.asarray(indices.numpy()),
                                           indptr.numpy(), jnp.asarray(x)))
    got = sp_torch.csr_matvec(data, indices, indptr, torch.as_tensor(x))
    assert hasattr(indptr, '_k9_plan')
    assert tp.rel(got.numpy(), want) <= 1e-12
    out = torch.full_like(got, numpy.nan)
    assert sp_torch.csr_matvec(data, indices, indptr, torch.as_tensor(x), out=out) is out
    assert torch.equal(out, got)
