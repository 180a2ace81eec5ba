'''The compact plan of kernel K5 (``nutils_tpu_torch.ops.blockgrid``) on
Taylor-Hood jacobians that nutils_tpu assembles, and the deterministic row
sums of the residual.  The plan's classes must rebuild the CSR pattern
exactly, and the plain version of K5 on the compact operand must give the
JAX package's ``_matvec_fn`` (the same products in another order: 1e-13 of
the result's scale).'''

import jax.numpy as jnp
import numpy
import pytest
import torch

import _torch_parity as tp
from nutils_tpu.ops import blockgrid as bg_jax
from nutils_tpu_torch import solver
from nutils_tpu_torch.ops import blockgrid as bg
from nutils_tpu_torch.ops import sparse
from nutils_tpu_torch.utils import config


@pytest.fixture(scope='module', params=['stokes8', 'th_periodic12'])
def operator(request):
    '''(data, indices, indptr, field grids, the port's block-grid form,
    its flat weight buffer, csr_map, plan) of a jacobian nutils_tpu
    assembles.'''
    data, indices, indptr, offsets, grids = tp.blockgrid_csr(request.param)
    form = bg.detect(data, indices, indptr, offsets, grids=grids)
    woff = numpy.concatenate([[0], numpy.cumsum(form.fill[0])[:-1]]).astype(numpy.int64)
    w = numpy.concatenate([a.ravel() for a in form.ws])
    csr_map = woff[form.fill[1]] + form.fill[2]
    return data, indices, indptr, grids, form, w, csr_map, bg.compact_plan(form.meta, woff, csr_map, indptr,
                                                                           indices)


def test_plan_rebuilds_the_pattern(operator):
    # every CSR entry appears once in the compact operand, in the row and at
    # the column that the kernel computes for it
    _data, indices, indptr, _grids, _form, _w, csr_map, plan = operator
    entry_of = numpy.full(plan.total, -1)
    entry_of[csr_map] = numpy.arange(len(csr_map))
    tables = plan.tables('cpu')
    entries, rows, cols = [], [], []
    for c in range(len(plan.ctab)):
        crows, ccols, inside, counts = bg.class_columns(plan, c, tables)
        assert bool(inside.all()) and ccols.shape == (sum(counts), len(crows))
        vbase = int(plan.ctab[c, 2])
        entries.append(entry_of[plan.index[vbase:vbase + ccols.numel()]])
        rows.append(numpy.broadcast_to(crows.numpy(), ccols.shape).ravel())
        cols.append(ccols.numpy().ravel())
    entries, rows, cols = (numpy.concatenate(a) for a in (entries, rows, cols))
    assert numpy.array_equal(numpy.sort(entries), numpy.arange(len(indices)))
    csr_rows = numpy.repeat(numpy.arange(len(indptr) - 1), numpy.diff(indptr))
    assert numpy.array_equal(rows, csr_rows[entries])
    assert numpy.array_equal(cols, numpy.asarray(indices)[entries])


def test_compact_values_count_nnz(operator):
    # the operand holds the pattern's entries and nothing else: the
    # velocity rows read ~32 of the 75 window slots on average
    _data, indices, _indptr, _grids, _form, w, _csr_map, plan = operator
    assert plan.nv == len(indices) and not plan.fallback
    assert plan.nv < w.size == plan.total
    assert plan.classes_per_block()[0] <= 2 * 16  # P2 nodes: 16 kinds of rows by position, 2 components


def test_compact_matvec_matches_jax(operator):
    data, indices, indptr, grids, form, w, _csr_map, plan = operator
    x = numpy.random.default_rng(1).standard_normal(plan.n)
    fj = bg_jax.detect(data, indices, indptr, form.meta[0], grids=grids)
    want_jax = numpy.asarray(bg_jax.matvec(fj, [jnp.asarray(a) for a in fj.ws], jnp.asarray(x)))
    wt, xt = torch.as_tensor(w), torch.as_tensor(x)
    got = bg.compact_matvec_plain(bg.pack(wt, plan), xt, plan).numpy()
    assert tp.rel(got, want_jax) <= 1e-13
    assert tp.rel(got, bg.matvec_plain(wt, xt, plan.meta, plan.woff).numpy()) <= 1e-13
    # on the CPU the wrapper unpacks the operand and runs the literal port
    assert torch.equal(bg.unpack(bg.pack(wt, plan), plan), wt)


def test_fallback_to_the_whole_window(operator, monkeypatch):
    # a (block, phase) with more slot sets than the kernel's tables take
    # gives its rows the whole window, checked: more values, the same product
    _data, indices, indptr, _grids, form, w, csr_map, full = operator
    monkeypatch.setattr(bg, 'MAX_CLASSES', 1)
    plan = bg.compact_plan(form.meta, full.woff, csr_map, indptr, indices)
    assert plan.fallback and plan.nv > len(indices) and plan.ctab[:, 5].all()
    x = torch.as_tensor(numpy.random.default_rng(2).standard_normal(plan.n))
    wt = torch.as_tensor(w)
    v = bg.pack(wt, plan)
    want = bg.matvec_plain(wt, x, plan.meta, plan.woff)
    assert tp.rel(bg.compact_matvec_plain(v, x, plan).numpy(), want.numpy()) <= 1e-13
    assert torch.equal(bg.blockgrid_matvec(v, x, plan), want)


def test_float64_operator_holds_no_weight_buffer():
    # the refinement's float64 operator widens the compact operand (nnz
    # values), not the flat weight buffer
    with config.device('cpu'):
        jac = tp.build_stokes('nutils_tpu_torch', 8, numpy.float32)
        (kind, plan), (v,) = jac._device_op()
        op64 = sparse.widen((v,))
        nnz = len(jac.indices)
        assert kind == 'blockgrid' and v.dtype == torch.float32 and op64[0].dtype == torch.float64
        assert v.numel() == op64[0].numel() == nnz < jac._weights().numel()
        b = numpy.random.default_rng(0).standard_normal(jac.shape[0])
        jac.solve(b, solver='gmres', rtol=1e-4)
        assert all(t.numel() == nnz for t in jac._op64_cache)


def test_residual_segment_sums_match_index_add(monkeypatch):
    # the triangle step's residual rows with no slice plan: the sorted
    # segment sums (K8's plain version here) give index_add_'s result
    with config.device('cpu'):
        system, args = tp.build_ns_tri('nutils_tpu_torch', 6, numpy.float64)
        fn = system._compiled('residual')
        clean = system._clean(args)
        want = fn(clean)
        calls = []

        def add_sorted(self, w, values):
            calls.append(values.shape[0])
            return solver._RowSums.add_sorted(self, w, values)
        monkeypatch.setattr(solver._RowSums, 'add_into', add_sorted)
        got = fn(clean)
    assert calls and sparse.csr_scatter.launches == 0
    assert float((got - want).abs().max()) <= 1e-14 * float(want.abs().max())


def test_row_sums_are_index_add():
    # into a zeroed buffer the segment sums are index_add_'s, bitwise
    rng = numpy.random.default_rng(3)
    targets = rng.integers(0, 50, (40, 7))
    sums = solver._RowSums(targets)
    values = torch.as_tensor(rng.standard_normal(targets.size))
    want = torch.zeros(50, dtype=torch.float64).index_add_(0, torch.as_tensor(targets.ravel()), values)
    assert torch.equal(sums.add_sorted(torch.zeros(50, dtype=torch.float64), values), want)
    assert torch.equal(sums.add_into(torch.zeros(50, dtype=torch.float64), values), want)
