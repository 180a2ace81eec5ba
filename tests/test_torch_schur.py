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
