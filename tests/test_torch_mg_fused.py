'''K2's fused sweeps (``jacobi_pre``, ``jacobi_post``) of the PyTorch port on
the CPU: the same bits as the ``jacobi_plain`` sweeps they fuse, the
V-cycle through them, and the shape dispatch between the fused and the
single sweeps.  The kernels themselves are held against the single sweeps
on the card (``tests/test_torch_kernels.py``, ``chip_smoke.py``).'''

import jax.numpy as jnp
import numpy
import pytest
import torch

from nutils_tpu.ops import mg as mg_jax
from nutils_tpu_torch.ops import mg

CASES = [((9, 11), (1, 1), (False, False)),
         ((9, 11), (1, 1), (True, False)),
         ((8, 11), (1, 1), (False, True)),
         ((5, 7, 9), (1, 1, 1), (False, False, False)),
         ((5, 6, 9), (1, 1, 1), (True, False, True)),
         ((9, 7, 2), (1, 1, 1), (False, False, False)),
         ((6, 5, 3), (1, 1, 1), (True, False, False))]


def _operands(shape, ks, seed):
    rng = numpy.random.default_rng(seed)
    W = int(numpy.prod([2 * k + 1 for k in ks]))
    return [torch.as_tensor(a) for a in (rng.standard_normal((W,) + shape), rng.random(shape) + 1,
                                         rng.standard_normal(shape), rng.standard_normal(shape))]


@pytest.mark.parametrize('nu', [1, 2])
@pytest.mark.parametrize('shape,ks,per', CASES)
def test_pre_is_its_sweeps(shape, ks, per, nu):
    w, dinv, r, _x = _operands(shape, ks, 0)
    x, res = mg.jacobi_pre(w, dinv, r, ks, shape, per, nu)
    want = mg.jacobi_plain(w, dinv, r, None, ks, shape, per, mg.OMEGA, 0)
    for _ in range(nu - 1):
        want = mg.jacobi_plain(w, dinv, r, want, ks, shape, per, mg.OMEGA, 1)
    assert x.dtype == torch.float64 and torch.equal(x, want)
    assert torch.equal(res, mg.jacobi_plain(w, dinv, r, want, ks, shape, per, mg.OMEGA, 2))


@pytest.mark.parametrize('nu', [1, 2])
@pytest.mark.parametrize('shape,ks,per', CASES)
def test_post_is_its_sweeps(shape, ks, per, nu):
    w, dinv, r, x = _operands(shape, ks, 1)
    got = mg.jacobi_post(w, dinv, r, x, ks, shape, per, nu)
    want = x
    for _ in range(nu):
        want = mg.jacobi_plain(w, dinv, r, want, ks, shape, per, mg.OMEGA, 1)
    assert torch.equal(got, want)


@pytest.mark.parametrize('ks,shape,periodic,nu,form', [
    ((1, 1), (1025, 1025), (False, False), 2, '2d'),                 # the slice
    ((1, 1), (3, 40), (True, True), 1, '2d'),
    ((1, 1, 1), (721, 721, 2), (False, False, False), 2, 'components'),  # the finite-strain levels
    ((1, 1, 1), (361, 361, 2), (False, False, False), 2, 'components'),
    ((1, 1, 1), (181, 181, 2), (False, False, False), 2, 'components'),
    ((1, 1, 1), (91, 91, 2), (False, False, False), 1, 'components'),
    ((1, 1, 1), (5, 9, 3), (False, False, False), 2, 'components'),
    ((1, 1, 1), (2, 40, 1), (False, False, False), 2, 'components'),
    ((1, 1, 1), (9, 35, 2), (True, False, False), 2, 'components'),  # a periodic axis beside the components
    ((1, 1, 1), (8 * 65535, 3, 2), (False, False, False), 2, 'components'),
    ((1, 1, 1), (8 * 65535 + 1, 3, 2), (False, False, False), 2, 'box'),  # more rows of tiles than a launch holds
    ((1, 1, 1), (129, 129, 65), (False, False, False), 2, 'box'),    # a true 3-D grid
    ((1, 1, 1), (5, 6, 9), (True, False, True), 1, 'box'),
    ((1, 1, 1), (9, 9, 4), (False, False, False), 2, 'box'),         # more components than the form holds
    ((1, 1, 1), (9, 9, 2), (False, False, True), 2, 'box'),          # a periodic component axis
    ((2, 2), (513, 513), (False, False), 2, None),                   # the degree-2 example's fine level
    ((2, 2, 1), (513, 513, 2), (False, False, False), 2, None),
    ((1, 2), (9, 9), (False, False), 2, None),
    ((0, 1), (9, 9), (False, False), 2, None),
    ((1,), (17,), (False,), 2, None),
    ((1, 1, 1, 1), (3, 5, 7, 9), (False,) * 4, 2, None),
    ((1, 1), (9, 9), (False, False), 0, None),                       # nu outside FUSED_NU
    ((1, 1, 1), (9, 9, 2), (False, False, False), max(mg.FUSED_NU) + 1, None),
])
def test_fused_shape(ks, shape, periodic, nu, form):
    # the fused form is a pure function of the level: 2-D, components (a
    # vector field's levels) or the 3-D box for half-width 1 and nu in
    # FUSED_NU; every other level: the single sweeps (None)
    assert mg.fused_form(ks, shape, periodic, nu) == form
    assert form is None or form in mg.FORM_CODES


@pytest.mark.parametrize('nu', [1, 2])
@pytest.mark.parametrize('n', [9, 17])
def test_component_vcycle_matches_jax(n, nu):
    # the plain sweeps, transfers and the coarsest product of a vector
    # field's hierarchy, (n, n, 2) levels of 27 slots, against the JAX
    # package's V-cycle on the same operands (sums in another order: 1e-12)
    levels, shape = [], (n, n, 2)
    while shape[0] > 5:
        levels.append(((1, 1, 1), shape, (False, False, False)))
        shape = ((shape[0] + 1) // 2, (shape[1] + 1) // 2, 2)
    levels = tuple(levels) + (((0, 0, 0), shape, (False, False, False)),)
    rng = numpy.random.default_rng(5)
    ws = [rng.standard_normal((27,) + lev[1]) for lev in levels[:-1]]
    dinvs = [rng.random(lev[1]) + 1 for lev in levels[:-1]]
    coarse_inv = rng.standard_normal((int(numpy.prod(shape)),) * 2)
    r = rng.standard_normal(levels[0][1])
    want = numpy.asarray(mg_jax._vcycle_fn(levels, nu)(([jnp.asarray(w) for w in ws], [jnp.asarray(d) for d in dinvs],
                                                        jnp.asarray(coarse_inv)), jnp.asarray(r)))
    got = mg.vcycle(levels, ([torch.as_tensor(w) for w in ws], [torch.as_tensor(d) for d in dinvs],
                             torch.as_tensor(coarse_inv)), torch.as_tensor(r), nu).numpy()
    assert got.shape == levels[0][1]
    numpy.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * numpy.abs(want).max())


def _vcycle_by_sweeps(levels, mg_ops, r_nd, nu):
    '''The V-cycle as single sweeps, transfers and the coarsest product.'''
    ws, dinvs, coarse_inv = mg_ops

    def cycle(level, r):
        if level == len(levels) - 1:
            return (coarse_inv @ r.reshape(-1)).reshape(levels[-1][1])
        ks, shape, per = levels[level]
        w, dinv = ws[level], dinvs[level]
        x = mg.jacobi_plain(w, dinv, r, None, ks, shape, per, mg.OMEGA, 0)
        for _ in range(nu - 1):
            x = mg.jacobi_plain(w, dinv, r, x, ks, shape, per, mg.OMEGA, 1)
        res = mg.jacobi_plain(w, dinv, r, x, ks, shape, per, mg.OMEGA, 2)
        x = x + mg.prolong_plain(cycle(level + 1, mg.restrict_plain(res, levels[level + 1][1])), shape)
        for _ in range(nu):
            x = mg.jacobi_plain(w, dinv, r, x, ks, shape, per, mg.OMEGA, 1)
        return x
    return cycle(0, r_nd)


@pytest.mark.parametrize('nu', [1, 2])
def test_vcycle_goes_through_the_fused_sweeps(monkeypatch, nu):
    # a 2-D hierarchy with a k = 2 fine level (single sweeps on the card)
    # over k = 1 levels: every level smooths through jacobi_pre/jacobi_post,
    # and the cycle is the one the single sweeps make, bit for bit
    levels = (((2, 2), (17, 9), (False, False)), ((1, 1), (9, 5), (False, False)), ((0, 0), (5, 3), (False, False)))
    rng = numpy.random.default_rng(2)
    ws = tuple(torch.as_tensor(rng.standard_normal(((2 * ks[0] + 1) * (2 * ks[1] + 1),) + shape))
               for ks, shape, _per in levels[:-1])
    dinvs = tuple(torch.as_tensor(rng.random(shape) + 1) for _ks, shape, _per in levels[:-1])
    coarse_inv = torch.as_tensor(rng.standard_normal((15, 15)))
    r = torch.as_tensor(rng.standard_normal((17, 9)))
    calls = []
    for name, at in (('jacobi_pre', 3), ('jacobi_post', 4)):  # where ks stands
        wrapped = getattr(mg, name)
        monkeypatch.setattr(mg, name, lambda *a, _f=wrapped, _n=name, _at=at, **k: calls.append((_n, a[_at]))
                            or _f(*a, **k))
    got = mg.vcycle(levels, (ws, dinvs, coarse_inv), r, nu)
    assert calls == [('jacobi_pre', (2, 2)), ('jacobi_pre', (1, 1)), ('jacobi_post', (1, 1)),
                     ('jacobi_post', (2, 2))]
    assert torch.equal(got, _vcycle_by_sweeps(levels, (ws, dinvs, coarse_inv), r, nu))
