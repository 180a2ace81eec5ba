'''Block-grid detection, refill and matvec of the PyTorch port against
nutils_tpu.ops.blockgrid and scipy, on the CSR of Taylor-Hood jacobians that
nutils_tpu assembles.  The JAX package permutes each block's grid axes (a
TPU tiling workaround the port leaves out); the comparison undoes it.'''

import jax.numpy as jnp
import numpy
import pytest
import torch

import _torch_parity as tp
from nutils_tpu.ops import blockgrid as bg_jax
from nutils_tpu_torch.ops import blockgrid as bg_torch


@pytest.fixture(scope='module', params=['stokes8', 'th_periodic12'])
def csr(request):
    '''(data, indices, indptr, field offsets, field grids) of a jacobian
    nutils_tpu assembles (``_torch_parity.blockgrid_csr``).'''
    return tp.blockgrid_csr(request.param)


def _natural(block):
    '''A JAX block with its axis permutation undone; phases keyed by their
    multi-index.'''
    i, j, gr, gc, qr, qc, amin, awid, wrap, phmeta, perm = block

    def un(t):
        out = [None] * len(perm)
        for k, ax in enumerate(perm):
            out[ax] = t[k]
        return tuple(out)
    return (i, j, un(gr), un(gc), un(qr), un(qc), un(amin), un(awid), un(wrap)), \
        {un(phi): un(pshape) for phi, pshape in phmeta}


def _flat(form):
    '''The form's weight arrays in one flat buffer, packed back to back.'''
    woff = tuple(int(o) for o in numpy.concatenate([[0], numpy.cumsum(form.fill[0])[:-1]]))
    return numpy.concatenate([w.ravel() for w in form.ws]), woff


def test_detect_matches_jax(csr):
    data, indices, indptr, offsets, grids = csr
    fj = bg_jax.detect(data, indices, indptr, offsets, grids=grids)
    ft = bg_torch.detect(data, indices, indptr, offsets, grids=grids)
    assert fj is not None and ft is not None
    assert ft.meta[0] == fj.meta[0] and ft.meta[1] == fj.meta[1]
    assert len(ft.meta[2]) == len(fj.meta[2]) == 4
    for bt, bj in zip(ft.meta[2], fj.meta[2]):
        head, phases = _natural(bj)
        assert bt[:9] == head  # fields, grids, ratios (qr, qc), windows, wrap flags
        assert dict(bt[9]) == phases
    kinds = {(b[0], b[1]): (b[4], b[5]) for b in ft.meta[2]}
    assert kinds[(0, 1)] != kinds[(0, 0)]  # u-p coupling is a 2:1 phased stencil
    # the velocity weights keep the component axis minor: [S, 2n+1, 2n+1, 2]
    assert ft.ws[0].shape[1:] == grids[0][0] and ft.ws[0].shape[-1] == 2


def test_refill_round_trip(csr):
    data, indices, indptr, offsets, grids = csr
    form = bg_torch.detect(data, indices, indptr, offsets, grids=grids)
    for a, b in zip(form.ws, bg_torch.refill(form, data)):
        assert numpy.array_equal(a, b)
    # every CSR value sits at its fill position, and nothing else is set
    w, woff = _flat(form)
    sizes, windex, wpos = form.fill
    csr_map = numpy.asarray(woff)[windex] + wpos
    assert numpy.array_equal(w[csr_map], data)
    assert len(numpy.unique(csr_map)) == len(data)
    assert numpy.count_nonzero(w) == numpy.count_nonzero(data)


def test_matvec_matches_jax_and_scipy(csr):
    # the same products in another order: 1e-13 of the result's scale
    import scipy.sparse
    data, indices, indptr, offsets, grids = csr
    n = len(indptr) - 1
    x = numpy.random.default_rng(1).standard_normal(n)
    fj = bg_jax.detect(data, indices, indptr, offsets, grids=grids)
    ft = bg_torch.detect(data, indices, indptr, offsets, grids=grids)
    w, woff = _flat(ft)
    plan = bg_torch.compact_plan(ft.meta, woff, numpy.asarray(woff)[ft.fill[1]] + ft.fill[2], indptr, indices)
    got = bg_torch.blockgrid_matvec(bg_torch.pack(torch.as_tensor(w), plan), torch.as_tensor(x), plan).numpy()
    want_jax = numpy.asarray(bg_jax.matvec(fj, [jnp.asarray(a) for a in fj.ws], jnp.asarray(x)))
    want = scipy.sparse.csr_matrix((data, indices, indptr), shape=(n, n)) @ x
    assert tp.rel(got, want) <= 1e-13
    assert tp.rel(got, want_jax) <= 1e-13
    assert bg_torch.blockgrid_matvec.launches == 0  # CPU tensors take the plain version


def test_kernel_tables(csr):
    # the int32 tables K5 reads: one record per block, one per class, one
    # per (class, block) segment, one per live slot, every row once
    data, indices, indptr, offsets, grids = csr
    form = bg_torch.detect(data, indices, indptr, offsets, grids=grids)
    _w, woff = _flat(form)
    plan = bg_torch.compact_plan(form.meta, woff, numpy.asarray(woff)[form.fill[1]] + form.fill[2], indptr,
                                 indices)
    n = len(indptr) - 1
    for t in (plan.btab, plan.ctab, plan.stab, plan.slots, plan.rows, plan.tiles, plan.index):
        assert t.dtype == numpy.int32
    assert plan.btab.shape == (4, 22)
    assert [tuple(r) for r in plan.btab[:, :2]] == [(offsets[b[0]], offsets[b[1]]) for b in form.meta[2]]
    assert sorted(plan.rows) == list(range(n))
    assert plan.ctab[:, 1].sum() == n and list(plan.ctab[:, 0]) == list(numpy.cumsum(plan.ctab[:, 1]) - plan.ctab[:, 1])
    assert plan.stab[:, 2].sum() == len(plan.slots) and plan.stab[:, 2].min() >= 1
    assert plan.stab.shape[0] == plan.ctab[:, 4].sum() and max(plan.ctab[:, 4]) <= 2
    assert list(numpy.bincount(plan.tiles)) == list(-(-plan.ctab[:, 1] // bg_torch.ROWS_PER_CTA))
