'''The Schur-aware inverse diagonal of the PyTorch port (the plain version
of kernel K7) against nutils_tpu.ops.sparse.schur_diag_inverse_device and the
host schur_diag_inverse, on the Navier-Stokes step's jacobian gathered from
the block-grid weights through csr_map; and the port's default device
preconditioner.'''

import jax.numpy as jnp
import numpy
import pytest
import torch

import _torch_parity as tp
from nutils_tpu.ops import sparse as sp_jax
from nutils_tpu_torch.ops import sparse as sp_torch
from nutils_tpu_torch.utils import config


@pytest.fixture(scope='module')
def ns():
    with config.device('cpu'):
        system, args = tp.build_ns('nutils_tpu_torch', 8, numpy.float64)
        jac, _res = system.assemble_jacobian_residual(args)
        w, cmap, indices, indptr = jac._csr_tables()
    return dict(jac=jac, w=w, cmap=cmap, indices=indices, indptr=indptr, n=jac.shape[0])


def test_tables_gather_the_csr_values(ns):
    # the int32 tables of the block-grid operator give its CSR values
    for t in (ns['cmap'], ns['indices'], ns['indptr']):
        assert t.dtype == torch.int32
    data = ns['w'][ns['cmap'].long()].numpy()
    assert numpy.array_equal(data, ns['jac'].data)


def test_schur_diag_matches_jax_and_host(ns):
    # the same sums in another order: 1e-14 relative
    n = ns['n']
    got = sp_torch.schur_diag_inverse_device(ns['w'], ns['cmap'], ns['indices'], ns['indptr'], n).numpy()
    data = ns['w'][ns['cmap'].long()].numpy()
    indices, indptr = ns['indices'].numpy(), ns['indptr'].numpy()
    rows = numpy.repeat(numpy.arange(n), numpy.diff(indptr))
    want_jax = numpy.asarray(sp_jax.schur_diag_inverse_device(jnp.asarray(data), jnp.asarray(indices),
                                                              jnp.asarray(rows), n))
    want_host = sp_jax.schur_diag_inverse(data, indices, indptr, n)
    assert tp.rel(got, want_jax) <= 1e-14
    assert tp.rel(got, want_host) <= 1e-14
    # the pressure rows (saddle point) take the Schur estimate, the velocity
    # rows plain Jacobi
    offs = ns['jac']._field_offsets
    d = numpy.zeros(n)
    isdiag = indices == rows
    d[rows[isdiag]] = data[isdiag]
    assert numpy.allclose(got[:offs[1]], 1 / d[:offs[1]], rtol=1e-14)
    assert not numpy.allclose(got[offs[1]:], 1 / d[offs[1]:])


def test_default_preconditioner_is_the_device_schur_diagonal(ns):
    # Matrix._device_precon(None) builds it from the device weights (K7 on a
    # card, its plain version here) and caches it per matrix
    jac = ns['jac']
    kind, minv = jac._device_precon(None, None)
    assert kind == 'diag' and isinstance(minv, torch.Tensor)
    want = sp_jax.schur_diag_inverse(jac.data, jac.indices, jac.indptr, jac.shape[0])
    assert tp.rel(minv.numpy(), want) <= 1e-14
    assert jac._device_precon(None, None)[1] is minv


@pytest.mark.parametrize('dtype', [numpy.float64, numpy.float32])
def test_schur_diag_random_csr(dtype):
    # strong and weak rows of a random CSR, its values scattered into a
    # larger buffer; float32 against the float64 host reference at 1e-6
    import scipy.sparse
    rng = numpy.random.default_rng(2)
    n = 400
    A = (scipy.sparse.random(n, n, density=0.02, random_state=3, format='csr') + scipy.sparse.eye(n)).tocsr()
    A.sort_indices()
    rows = numpy.repeat(numpy.arange(n), numpy.diff(A.indptr))
    weak = numpy.repeat(rng.random(n) < 0.3, numpy.diff(A.indptr)) & (A.indices == rows)
    A.data[weak] = 1e-9
    cmap = rng.permutation(A.nnz + 50)[:A.nnz]
    wbuf = numpy.zeros(A.nnz + 50, dtype=dtype)
    wbuf[cmap] = A.data
    got = sp_torch.schur_diag_inverse_device(torch.as_tensor(wbuf), torch.as_tensor(cmap.astype(numpy.int32)),
                                             torch.as_tensor(A.indices.astype(numpy.int32)),
                                             torch.as_tensor(A.indptr.astype(numpy.int32)), n).numpy()
    want = sp_jax.schur_diag_inverse(wbuf[cmap], A.indices, A.indptr, n)
    assert tp.rel(got, want) <= (1e-14 if dtype == numpy.float64 else 1e-6)


@pytest.mark.parametrize('mapped', [True, False])
def test_schur_diag_long_and_empty_rows(mapped):
    # rows longer than K7's block (sparse.CSR_CAP), rows of more than half of
    # it (a block of their own), empty rows and weak rows, against the JAX
    # package's kernel at 1e-12
    rng = numpy.random.default_rng(7)
    n = 3000
    lens = rng.integers(0, 40, n)
    lens[rng.random(n) < 0.05] = 0
    lens[[5, 1200, 2999]] = [sp_torch.CSR_CAP + 77, 3 * sp_torch.CSR_CAP + 5, sp_torch.CSR_CAP // 2 + 1]
    lens[[6, 7]] = [sp_torch.CSR_CAP // 2 + 300, 0]
    cols = [numpy.sort(rng.choice(n, size=min(k, n), replace=False)) for k in lens]
    for i, c in enumerate(cols):
        if len(c) and rng.random() < 0.8 and i not in c:
            c[rng.integers(len(c))] = i  # a diagonal entry in most non-empty rows
        cols[i] = numpy.sort(c)
    indptr = numpy.concatenate([[0], numpy.cumsum([len(c) for c in cols])])
    indices = numpy.concatenate(cols)
    rows = numpy.repeat(numpy.arange(n), numpy.diff(indptr))
    data = rng.standard_normal(len(indices))
    data[(indices == rows) & numpy.repeat(rng.random(n) < 0.3, numpy.diff(indptr))] = 1e-9  # weak rows
    cmap = rng.permutation(len(data) + 100)[:len(data)]
    wbuf = numpy.zeros(len(data) + 100)
    wbuf[cmap] = data
    tabs = [torch.as_tensor(a.astype(numpy.int32)) for a in (indices, indptr)]
    if mapped:
        got = sp_torch.schur_diag_inverse_device(torch.as_tensor(wbuf), torch.as_tensor(cmap.astype(numpy.int32)),
                                                 *tabs, n)
    else:
        got = sp_torch.schur_diag_inverse_device(torch.as_tensor(data), None, *tabs, n)
    want = numpy.asarray(sp_jax._schur_diag_kernel(n, 1e-3)(jnp.asarray(data), jnp.asarray(indices),
                                                             jnp.asarray(rows)))
    assert want.dtype == numpy.float64
    assert tp.rel(got.numpy(), want) <= 1e-12
    assert numpy.all(got.numpy()[lens == 0] == 1)  # an empty row's minv is 1
