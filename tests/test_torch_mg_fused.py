'''K2's fused sweeps (``jacobi_pre``, ``jacobi_post``) of the PyTorch port on
the CPU: the same bits as the ``jacobi_plain`` sweeps they fuse, the
V-cycle through them, and the shape dispatch between the fused and the
single sweeps.  The kernels themselves are held against the single sweeps
on the card (``tests/test_torch_kernels.py``, ``chip_smoke.py``).'''

import itertools

import numpy
import pytest
import torch

from nutils_tpu_torch.ops import mg

CASES = [((9, 11), (1, 1), (False, False)),
         ((9, 11), (1, 1), (True, False)),
         ((8, 11), (1, 1), (False, True)),
         ((5, 7, 9), (1, 1, 1), (False, False, False)),
         ((5, 6, 9), (1, 1, 1), (True, False, True))]


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


def test_fused_shape():
    # 2-D and 3-D grids of half-width 1, nu in FUSED_NU: two launches a
    # level; every other level: the single sweeps
    for ks, nu in itertools.product([(1, 1), (1, 1, 1)], mg.FUSED_NU):
        assert mg.fused_shape(ks, nu)
    for ks in [(1,), (2,), (2, 2), (1, 2), (0, 1), (1, 1, 2), (1, 1, 1, 1)]:
        assert not mg.fused_shape(ks, 2)
    for nu in (0, max(mg.FUSED_NU) + 1):
        assert not mg.fused_shape((1, 1), nu)


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
