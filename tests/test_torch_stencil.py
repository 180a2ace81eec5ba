'''Stencil matvec of the PyTorch port against nutils_tpu.ops.stencil.'''

import jax.numpy as jnp
import numpy
import pytest
import torch

from nutils_tpu.ops import stencil as st_jax
from nutils_tpu_torch.ops import stencil as st_torch

CASES = [
    ((17,), (3,), (False,)),
    ((17,), (2,), (True,)),
    ((9, 11), (1, 1), (False, False)),
    ((9, 11), (2, 3), (True, False)),
    ((9, 11), (3, 1), (False, True)),
    ((5, 7, 9), (1, 1, 1), (False, False, False)),
    ((5, 7, 9), (1, 2, 1), (True, False, True)),
    ((9, 7, 2), (1, 1, 1), (False, False, False)),
    ((6, 9, 3), (1, 1, 1), (True, False, False)),
]


def _operands(shape, ks, seed):
    rng = numpy.random.default_rng(seed)
    W = int(numpy.prod([2 * k + 1 for k in ks]))
    return rng.standard_normal((W,) + shape), rng.standard_normal(shape)


@pytest.mark.parametrize('shape,ks,periodic', CASES)
def test_matvec_matches_jax(shape, ks, periodic):
    # same sum, possibly in another order: 1e-13 relative
    w, x = _operands(shape, ks, 0)
    form = st_jax.StencilForm(w, ks, shape, periodic=periodic)
    want = numpy.asarray(st_jax.matvec(form, jnp.asarray(w), jnp.asarray(x.ravel())))
    tform = st_torch.StencilForm(w, ks, shape, periodic=periodic)
    got = st_torch.matvec(tform, torch.as_tensor(w), torch.as_tensor(x.ravel())).numpy()
    numpy.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13 * numpy.abs(want).max())
    # the host float64 twin agrees too
    numpy.testing.assert_allclose(st_torch.matvec_numpy(w, x, ks, shape, periodic).ravel(), want,
                                  rtol=1e-13, atol=1e-13 * numpy.abs(want).max())


def test_from_csr_grid_matches_jax():
    import scipy.sparse
    rng = numpy.random.default_rng(1)
    offsets = (-9, -8, -1, 0, 1, 8, 9)
    A = scipy.sparse.diags([rng.standard_normal(40 - abs(o)) for o in offsets], offsets, format='csr')
    a = st_jax.from_csr_grid(A.data, A.indices, A.indptr, (5, 8))
    b = st_torch.from_csr_grid(A.data, A.indices, A.indptr, (5, 8))
    assert (a.ks, a.shape, a.periodic) == (b.ks, b.shape, b.periodic)
    numpy.testing.assert_array_equal(a.w, b.w)


@pytest.mark.parametrize('ks,shape,periodic,form', [
    ((1, 1), (1025, 1025), (False, False), 'tile'),               # the slice
    ((1, 1), (2049, 2049), (False, False), 'tile'),               # the Laplace example
    ((1, 1), (1024, 1025), (True, False), 'tile'),
    ((1, 1), (3, 40), (True, True), 'tile'),
    ((1, 1, 1), (721, 721, 2), (False, False, False), 'tile'),    # the finite-strain levels
    ((1, 1, 1), (361, 361, 2), (False, False, False), 'tile'),
    ((1, 1, 1), (181, 181, 2), (False, False, False), 'tile'),
    ((1, 1, 1), (91, 91, 2), (False, False, False), 'tile'),
    ((1, 1, 1), (5, 9, 3), (True, True, False), 'tile'),
    ((1, 1, 1), (2, 40, 1), (False, False, False), 'tile'),
    ((1, 1), (8 * 65535, 3), (False, False), 'tile'),
    ((2, 2, 1), (513, 513, 2), (False, False, False), 'generic'),  # the elasticity squares (degree 2)
    ((2, 2), (513, 513), (False, False), 'generic'),               # the degree-2 example's fine level
    ((1, 1, 1), (129, 129, 65), (False, False, False), 'generic'),  # more components than a tile holds
    ((1, 1, 1), (9, 9, 4), (False, False, False), 'generic'),
    ((1, 1, 1), (9, 9, 2), (False, False, True), 'generic'),       # a periodic component axis
    ((1, 1, 0), (9, 9, 2), (False, False, False), 'generic'),
    ((1,), (17,), (False,), 'generic'),
    ((1, 1, 1, 1), (3, 5, 7, 9), (False, False, False, False), 'generic'),
    ((1, 1), (8 * 65535 + 1, 3), (False, False), 'generic'),       # more rows of tiles than a launch holds
])
def test_matvec_form(ks, shape, periodic, form):
    # K1's form is a pure function of the grid: tiled on every stencil of
    # half-width 1 that the paths' operators have
    assert st_torch.matvec_form(ks, shape, periodic) == form
