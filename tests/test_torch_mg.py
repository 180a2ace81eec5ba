'''Multigrid set-up and V-cycle of the PyTorch port against nutils_tpu.ops.mg,
on the operator each package assembles for the bench's Laplace slice.'''

import jax.numpy as jnp
import numpy
import pytest
import torch

import _torch_parity as tp
from nutils_tpu.ops import mg as mg_jax
from nutils_tpu_torch.ops import mg as mg_torch
from nutils_tpu_torch.utils import config


@pytest.fixture(scope='module')
def hierarchies():
    out = {}
    with config.device('cpu'):
        for pkg in tp.PACKAGES:
            system = tp.build_laplace(pkg, 64, numpy.float64, reaction=True)
            jac, _res = system.assemble_jacobian_residual({'u': numpy.zeros(system.trial_shapes[0][0])})
            out[pkg] = jac._mg()
    return out['nutils_tpu'], out['nutils_tpu_torch']


def test_setup_matches_jax(hierarchies):
    # host Galerkin products from the same assembled values: 1e-12 relative
    a, b = hierarchies
    assert [lev[1] for lev in b.levels] == [(65, 65), (33, 33), (17, 17)]
    assert b.levels == a.levels
    for wa, wb in zip(a.ws, b.ws):
        assert tp.rel(wb.numpy(), wa) <= 1e-12
    for da, db in zip(a.dinvs, b.dinvs):
        assert tp.rel(db.numpy(), da) <= 1e-12
    assert tp.rel(b.coarse_inv.numpy(), a.coarse_inv) <= 1e-12


def test_vcycle_matches_jax(hierarchies):
    a, b = hierarchies
    r = numpy.random.default_rng(0).standard_normal(65 * 65)
    want = numpy.asarray(mg_jax.apply_vcycle(a, jnp.asarray(r)))
    got = mg_torch.apply_vcycle(b, torch.as_tensor(r)).numpy()
    assert tp.rel(got, want) <= 1e-12


@pytest.mark.parametrize('shape,cshape', [((9,), (5,)), ((9, 7), (5, 4)), ((9, 7), (9, 4)), ((5, 7, 3), (3, 4, 3)),
                                          ((9, 7, 2), (5, 4, 2)), ((11, 9, 3), (6, 5, 3))])
def test_transfers_match_jax(shape, cshape):
    rng = numpy.random.default_rng(1)
    f = rng.standard_normal(shape)
    c = rng.standard_normal(cshape)
    want = numpy.asarray(mg_jax._restrict(jnp.asarray(f), cshape))
    numpy.testing.assert_allclose(mg_torch.restrict_plain(torch.as_tensor(f), cshape).numpy(), want, rtol=1e-14)
    want = numpy.asarray(mg_jax._prolong(jnp.asarray(c), shape))
    numpy.testing.assert_allclose(mg_torch.prolong_plain(torch.as_tensor(c), shape).numpy(), want, rtol=1e-14)


@pytest.mark.parametrize('shape,cshape,form', [
    ((1025, 1025), (513, 513), 'tile'),            # the slice's finest transfer
    ((2049, 2049), (1025, 1025), 'tile'),          # the example's
    ((721, 721, 2), (361, 361, 2), 'tile'),        # finite strain: the component axis kept
    ((5, 7, 3), (3, 4, 3), 'tile'),
    ((5, 5, 1), (3, 3, 1), 'tile'),
    ((3, 3), (2, 2), 'tile'),
    ((9, 7, 4), (5, 4, 4), 'generic'),             # more components than the tiled form takes
    ((9, 16), (5, 16), 'generic'),                 # semi-coarsening beside a periodic axis
    ((16, 9), (16, 5), 'generic'),
    ((9, 7), (9, 4), 'generic'),                   # beside a short odd axis kept
    ((9, 7, 5), (5, 4, 3), 'generic'),             # 3-D, every axis coarsened
    ((9, 7, 5, 3), (5, 4, 3, 3), 'generic'),       # 4-D
    ((9,), (5,), 'generic'),
    ((10, 7), (5, 4), 'generic'),                  # not n = 2 nc - 1
    ((9, 7, 2), (5, 4, 1), 'generic'),
    ((8 * 65535 * 2 + 1, 3), (8 * 65535 + 1, 2), 'generic'),  # more rows of tiles than a launch holds
])
def test_transfer_form(shape, cshape, form):
    # K3's form is a pure function of the two grids; every grid the
    # hierarchies make for the three paths takes the tiled form
    assert mg_torch.transfer_form(shape, cshape) == form


@pytest.mark.parametrize('shape,periodic', [((1025, 1025), (False, False)), ((721, 721, 2), (False, False, False)),
                                            ((513, 513), (False, False)), ((1024, 1025), (True, False)),
                                            ((129, 129, 65), (False, False, False))])
def test_hierarchy_transfers_take_their_form(shape, periodic):
    # each level's transfer of a hierarchy (coarse shapes by _coarsen_flags):
    # tiled on the paths' grids (2-D, or a vector field's), generic beside a
    # periodic axis and in 3-D
    tiled = len(shape) == 2 and not any(periodic) or shape[-1] <= mg_torch.TILE_COMPONENTS
    while (flags := mg_torch._coarsen_flags(shape, periodic, 1024)) is not None:
        cshape = tuple((s + 1) // 2 if f else s for s, f in zip(shape, flags))
        assert mg_torch.transfer_form(shape, cshape) == ('tile' if tiled else 'generic')
        shape = cshape
