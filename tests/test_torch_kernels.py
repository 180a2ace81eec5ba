'''The hand kernels of nutils_tpu_torch (K1-K15) against their plain PyTorch
versions, on a CUDA card.  This file imports no jax, so it runs where the
card is:

    python -m pytest tests/test_torch_kernels.py -m gpu

Without a card every test skips.  Tolerances: float32 1e-6 and float64 1e-14
of the largest plain value (the sums run in another order, with fused
multiply-adds); reductions on the scale of their terms.'''

import ctypes
import hashlib

import numpy
import pytest
import torch

from nutils_tpu_torch import _kernels, matrix
from nutils_tpu_torch.ops import assembly, bicgstab, blockgrid, cg, gmres, mg, precon, sparse, stencil

pytestmark = pytest.mark.gpu

TOLS = [(torch.float32, 1e-6), (torch.float64, 1e-14)]
STENCILS = [
    ((17,), (3,), (False,)),
    ((17,), (2,), (True,)),
    ((9, 11), (1, 1), (False, False)),
    ((9, 11), (2, 3), (True, False)),
    ((9, 11), (3, 1), (False, True)),
    ((5, 7, 9), (1, 1, 1), (False, False, False)),
    ((5, 7, 9), (1, 2, 1), (True, False, True)),
    ((3, 5, 7, 9), (1, 1, 1, 1), (False, True, False, False)),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('no CUDA card: the kernels run only there')
    return torch.device('cuda')


def _rel(got, want):
    torch.cuda.synchronize()
    return float((got - want).abs().max() / want.abs().max())


def _close(got, want, tol, scale=None):
    """Within ``tol`` of ``scale`` (the largest plain value unless given;
    all zeros must then be equal)."""
    torch.cuda.synchronize()
    return float((got - want).abs().max()) <= tol * float(want.abs().max() if scale is None else scale)


@pytest.mark.parametrize('dtype,tol', TOLS)
@pytest.mark.parametrize('shape,ks,periodic', STENCILS)
def test_stencil_matvec(cuda, shape, ks, periodic, dtype, tol):
    rng = numpy.random.default_rng(0)
    W = int(numpy.prod([2 * k + 1 for k in ks]))
    w = torch.as_tensor(rng.standard_normal((W,) + shape), dtype=dtype, device=cuda)
    x = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=cuda)
    launches = stencil.stencil_matvec.launches
    got = stencil.stencil_matvec(w, x, ks, shape, periodic)
    assert stencil.stencil_matvec.launches == launches + 1
    assert _rel(got, stencil.matvec_plain(w, x, ks, shape, periodic)) <= tol


@pytest.mark.parametrize('dtype,tol', TOLS)
@pytest.mark.parametrize('shape,cshape,ks,per', [((33, 17), (17, 9), (1, 1), (False, False)),
                                                 ((9, 16, 7), (5, 16, 4), (1, 1, 1), (False, True, False))])
def test_multigrid_kernels(cuda, shape, cshape, ks, per, dtype, tol):
    rng = numpy.random.default_rng(1)
    W = int(numpy.prod([2 * k + 1 for k in ks]))
    w, dinv, r, x = (torch.as_tensor(a, dtype=dtype, device=cuda) for a in (
        rng.standard_normal((W,) + shape), rng.random(shape) + 1, rng.standard_normal(shape),
        rng.standard_normal(shape)))
    for mode in (0, 1, 2):
        got = mg.jacobi_smooth(w, dinv, r, x, ks, shape, per, mode=mode)
        assert _rel(got, mg.jacobi_plain(w, dinv, r, x, ks, shape, per, mg.OMEGA, mode)) <= tol
    xc = mg.mg_restrict(r, cshape)
    assert _rel(xc, mg.restrict_plain(r, cshape)) <= tol
    got = mg.mg_prolong_add(x.clone(), xc)
    assert _rel(got, x + mg.prolong_plain(xc, shape)) <= tol


def _same_bits(a, b):
    ints = {4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(ints), b.view(ints))


def _digest(t):
    return hashlib.sha1(t.contiguous().cpu().numpy().tobytes()).hexdigest()


# K1's tiled form: the half-width-1 grids of STENCILS, the component grids
# of K2's component form, a periodic axis beside the components, and grids
# whose tiles end mid-block (neither rows of 8 or 16 nor columns of 32)
TILE_STENCILS = [case for case in STENCILS if stencil.matvec_form(*case[1::-1], case[2]) == 'tile'] + [
    ((33, 17, 2), (1, 1, 1), (False, False, False)),
    ((5, 9, 3), (1, 1, 1), (False, False, False)),
    ((2, 40, 1), (1, 1, 1), (False, False, False)),
    ((9, 35, 2), (1, 1, 1), (True, False, False)),
    ((3, 4, 2), (1, 1, 1), (True, True, False)),
    ((3, 40), (1, 1), (True, True)),
    ((37, 65), (1, 1), (False, True)),
    ((91, 91, 2), (1, 1, 1), (False, False, False)),
]


@pytest.mark.parametrize('dtype,tol', TOLS)
@pytest.mark.parametrize('shape,ks,periodic', TILE_STENCILS)
def test_stencil_tile_is_the_generic_kernel(cuda, shape, ks, periodic, dtype, tol):
    # stencil_matvec takes the tiled form here and gives the generic
    # kernel's bits (launched directly), zeros of either sign included; the
    # launch is counted once, in its form
    assert stencil.matvec_form(ks, shape, periodic) == 'tile'
    rng = numpy.random.default_rng(17)
    W = int(numpy.prod([2 * k + 1 for k in ks]))
    w, x = rng.standard_normal((W,) + shape), rng.standard_normal(shape)
    x.flat[::7] = 0.0
    x.flat[1::11] = -0.0
    w[0] = -0.0
    w, x = (torch.as_tensor(a, dtype=dtype, device=cuda) for a in (w, x))
    before = stencil.stencil_matvec.launches, stencil.stencil_matvec.forms['tile']
    got = stencil.stencil_matvec(w, x, ks, shape, periodic)
    assert (stencil.stencil_matvec.launches, stencil.stencil_matvec.forms['tile']) == (before[0] + 1, before[1] + 1)
    want = torch.full(shape, 7.0, dtype=dtype, device=cuda)
    _kernels.launch('ntt_stencil_matvec', x, [w, x, want, None], shape, ks=ks, periodic=periodic)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and _same_bits(got, want) and _digest(got) == _digest(want)
    assert _rel(got, stencil.matvec_plain(w, x, ks, shape, periodic)) <= tol


@pytest.mark.parametrize('shape,ks,periodic', [((33, 65), (1, 1), (False, False)), ((17, 9, 2), (1, 1, 1), (False,) * 3)])
def test_stencil_tile_does_nothing_while_inactive(cuda, shape, ks, periodic):
    rng = numpy.random.default_rng(18)
    W = 3 ** len(shape)
    w, x = (torch.as_tensor(a, device=cuda) for a in (rng.standard_normal((W,) + shape), rng.standard_normal(shape)))
    for flag in (0, 1):
        active = torch.full((1,), flag, dtype=torch.int32, device=cuda)
        y = torch.full(shape, 7.0, dtype=x.dtype, device=cuda)
        _kernels.launch('ntt_stencil_tile', x, [w, x, y, active], shape, ks=ks, periodic=periodic)
        torch.cuda.synchronize()
        if flag:
            assert _rel(y, stencil.matvec_plain(w, x, ks, shape, periodic)) <= 1e-14
        else:
            assert bool((y == 7.0).all())


# K3's tiled form: odd sizes from 5 up, tiles that end mid-block (the
# coarse rows are not multiples of the tile's 8 or 16 rows, nor its 32
# columns), V = 1, 2, 3, and the three paths' transfers at reduced size
# (the slice's and the example's 2-D grids, finite strain's two components)
TILE_TRANSFERS = [(5, 5), (7, 9), (5, 67), (35, 67), (67, 131), (131, 65), (5, 5, 1), (5, 7, 2), (9, 71, 2),
                  (37, 35, 3), (67, 5, 3), (257, 257), (129, 129), (81, 81, 2), (161, 161, 2)]


@pytest.mark.parametrize('dtype,tol', TOLS)
@pytest.mark.parametrize('shape', TILE_TRANSFERS)
def test_transfer_tile_is_the_generic_kernel(cuda, shape, dtype, tol):
    # mg_restrict / mg_prolong_add take the tiled form here and give the
    # generic kernel's bits (launched directly), zeros of either sign and
    # the grid's edges included
    cshape = tuple((s + 1) // 2 for s in shape[:2]) + tuple(shape[2:])
    assert mg.transfer_form(shape, cshape) == 'tile'
    rng = numpy.random.default_rng(13)
    f, x = (rng.standard_normal(shape) for _ in range(2))
    xc = rng.standard_normal(cshape)
    f[0] = -0.0
    f[:, -1] = 0.0
    xc[0] = -0.0
    f, x, xc = (torch.as_tensor(a, dtype=dtype, device=cuda) for a in (f, x, xc))
    launches = mg.mg_restrict.launches, mg.mg_prolong_add.launches
    got_r = mg.mg_restrict(f, cshape)
    got_p = mg.mg_prolong_add(x.clone(), xc)
    assert (mg.mg_restrict.launches, mg.mg_prolong_add.launches) == (launches[0] + 1, launches[1] + 1)
    want_r = torch.full(cshape, 7.0, dtype=dtype, device=cuda)
    _kernels.launch('ntt_restrict', f, [f, want_r, None], shape, cshape=cshape)
    want_p = x.clone()
    _kernels.launch('ntt_prolong_add', want_p, [want_p, xc, None], shape, cshape=cshape)
    torch.cuda.synchronize()
    assert _same_bits(got_r, want_r)
    assert _same_bits(got_p, want_p)
    assert _rel(got_r, mg.restrict_plain(f, cshape)) <= tol
    assert _rel(got_p, x + mg.prolong_plain(xc, shape)) <= tol


@pytest.mark.parametrize('shape,cshape', [((33, 65), (17, 33)), ((17, 17, 2), (9, 9, 2)), ((9, 7, 5), (5, 4, 3)),
                                          ((9, 16), (5, 16))])
def test_transfers_do_nothing_while_inactive(cuda, shape, cshape):
    # both forms (tiled: the first two, generic: the others) read the CG
    # loop's flag first: at 0 they write nothing, at 1 they run
    rng = numpy.random.default_rng(14)
    f, x = (torch.as_tensor(rng.standard_normal(shape), device=cuda) for _ in range(2))
    xc = torch.as_tensor(rng.standard_normal(cshape), device=cuda)
    for flag in (0, 1):
        active = torch.full((1,), flag, dtype=torch.int32, device=cuda)
        rc = torch.full(cshape, 7.0, dtype=f.dtype, device=cuda)
        mg._transfer('mg_restrict', True, f, cshape, f, rc, active)
        xp = mg.mg_prolong_add(x.clone(), xc, active)
        torch.cuda.synchronize()
        if flag:
            assert _rel(rc, mg.restrict_plain(f, cshape)) <= 1e-14
            assert _rel(xp, x + mg.prolong_plain(xc, shape)) <= 1e-14
        else:
            assert bool((rc == 7.0).all()) and torch.equal(xp, x)


FUSED_CASES = [((1025, 1025), (1, 1), (True, False)),
               ((1024, 1025), (1, 1), (False, True)),
               ((3, 40), (1, 1), (True, True)),
               ((129, 129, 65), (1, 1, 1), (False, True, False)),
               ((2, 5, 33), (1, 1, 1), (True, True, False)),
               # the component form: V = 1-3, a periodic axis 0, tiles that
               # end mid-block, the finite strain's coarsest smoothed level
               ((33, 17, 2), (1, 1, 1), (False, False, False)),
               ((5, 9, 3), (1, 1, 1), (False, False, False)),
               ((2, 40, 1), (1, 1, 1), (False, False, False)),
               ((9, 35, 2), (1, 1, 1), (True, False, False)),
               ((91, 91, 2), (1, 1, 1), (False, False, False))]


@pytest.mark.parametrize('nu', [1, 2])
@pytest.mark.parametrize('dtype,tol', TOLS)
@pytest.mark.parametrize('shape,ks,per', FUSED_CASES)
def test_fused_jacobi_is_its_single_sweeps(cuda, shape, ks, per, dtype, tol, nu):
    # K2's fused launches give the bits of the single sweeps they replace
    # (the Laplace grid, periodic axes, axes shorter than the halo, 3-D,
    # component axes), and agree with the plain sweeps; the component form
    # gives the box form's bits too
    rng = numpy.random.default_rng(11)
    W = int(numpy.prod([2 * k + 1 for k in ks]))
    w, dinv, r, x = (torch.as_tensor(a, dtype=dtype, device=cuda) for a in (
        rng.standard_normal((W,) + shape), rng.random(shape) + 1, rng.standard_normal(shape),
        rng.standard_normal(shape)))
    form = mg.fused_form(ks, shape, per, nu)
    assert form == ('2d' if len(shape) == 2 else 'components' if shape[2] <= 3 else 'box')
    before = mg.jacobi_pre.launches, mg.jacobi_post.launches, mg.jacobi_smooth.launches, mg.jacobi_pre.forms[form]
    xf, resf = mg.jacobi_pre(w, dinv, r, ks, shape, per, nu)
    post = mg.jacobi_post(w, dinv, r, x, ks, shape, per, nu)
    assert (mg.jacobi_pre.launches, mg.jacobi_post.launches, mg.jacobi_smooth.launches, mg.jacobi_pre.forms[form]) \
        == (before[0] + 1, before[1] + 1, before[2], before[3] + 1)
    for code in (0, 1) if form == 'components' else ():
        outs = [torch.full(shape, 7.0, dtype=dtype, device=cuda) for _ in range(3)]
        _kernels.launch('ntt_jacobi_fused', r, [w, dinv, r, None, outs[0], outs[1], None], shape, ks=ks, periodic=per,
                        scalars=(mg.OMEGA, nu, 1, code))
        _kernels.launch('ntt_jacobi_fused', r, [w, dinv, r, x, outs[2], None, None], shape, ks=ks, periodic=per,
                        scalars=(mg.OMEGA, nu, 0, code))
        torch.cuda.synchronize()
        assert all(_same_bits(a, b) for a, b in zip(outs, (xf, resf, post))), code
    xs = mg.jacobi_smooth(w, dinv, r, None, ks, shape, per, mode=0)
    for _ in range(nu - 1):
        xs = mg.jacobi_smooth(w, dinv, r, xs, ks, shape, per, mode=1)
    ress = mg.jacobi_smooth(w, dinv, r, xs, ks, shape, per, mode=2)
    posts = x
    for _ in range(nu):
        posts = mg.jacobi_smooth(w, dinv, r, posts, ks, shape, per, mode=1)
    torch.cuda.synchronize()
    assert torch.equal(xf, xs) and torch.equal(resf, ress) and torch.equal(post, posts)
    xp, resp = mg.jacobi_pre_plain(w, dinv, r, ks, shape, per, mg.OMEGA, nu)
    assert _rel(xf, xp) <= tol and _rel(resf, resp) <= tol
    assert _rel(post, mg.jacobi_post_plain(w, dinv, r, x, ks, shape, per, mg.OMEGA, nu)) <= tol


def _cg_state(dev, dtype, rz, pap, rzold, atol=0.0, maxiter=1000, k=0, reason=cg.RUNNING, active=1):
    """A K4 state with the given scalars (rounded to ``dtype``)."""
    st = cg.new_state(dev)
    cg.reset(st, atol, maxiter)
    for slot, v in ((cg.RZ, rz), (cg.PAP, pap), (cg.RZOLD, rzold)):
        st[slot] = float(torch.tensor(v, dtype=dtype))
    ints = st.view(torch.int32)
    ints[cg.K], ints[cg.REASON], ints[cg.ACTIVE] = k, reason, active
    return st


def _k4_cases():
    """(name, kernel, plain, state arguments): every K4 entry, with each
    decision it can take."""
    def dot(fn, start=False):
        return lambda v, st: fn(v['p'], v['ap'] if not start else v['p'], st, cg.RR0 if start else cg.PAP,
                                start=start)

    def step(fn):
        return lambda v, st: fn(v['x'], v['r'], v['p'], v['ap'], st)

    def xpby(fn):
        return lambda v, st: fn(v['p'], v['z'], st)
    return [
        ('dot', dot(cg.cg_dot), dot(cg.dot_plain), {}),
        ('dot start go', dot(cg.cg_dot, True), dot(cg.dot_plain, True), {}),
        ('dot start stop', dot(cg.cg_dot, True), dot(cg.dot_plain, True), {'atol': 1e300}),
        ('step', step(cg.cg_step), step(cg.step_plain), {}),
        ('step scheduled', step(cg.cg_step), step(cg.step_plain), {'k': 63}),
        ('step claimed', step(cg.cg_step), step(cg.step_plain), {'atol': 1e300}),
        ('step capped', step(cg.cg_step), step(cg.step_plain), {'k': 4, 'maxiter': 5}),
        ('xpby', xpby(cg.cg_xpby), xpby(cg.xpby_plain), {}),
        ('xpby restart', xpby(cg.cg_xpby), xpby(cg.xpby_plain), {'reason': cg.CLAIMED}),
    ]


def _k4_vectors(dev, dtype, n, seed=2):
    rng = numpy.random.default_rng(seed)
    return {k: torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev) for k in ('x', 'r', 'p', 'ap', 'z')}


def _k4_run(fn, vectors, dev, dtype, kwargs):
    v = {k: t.clone() for k, t in vectors.items()}
    st = _cg_state(dev, dtype, 0.7, 1.3, 0.4, **kwargs)
    fn(v, st)
    torch.cuda.synchronize()
    return v, st


@pytest.mark.parametrize('dtype,tol', TOLS)
@pytest.mark.parametrize('n', [1, 1023, 1050625])
def test_cg_kernels(cuda, n, dtype, tol):
    # each K4 entry against its plain version on the same state: vectors to
    # the tolerance of their largest value, sums on the scale of their
    # terms, the loop's decisions (k, flag, reason) equal
    vectors = _k4_vectors(cuda, dtype, n)
    for name, kernel, plain, kwargs in _k4_cases():
        (vk, sk), (vp, sp) = _k4_run(kernel, vectors, cuda, dtype, kwargs), _k4_run(plain, vectors, cuda, dtype, kwargs)
        for key in vectors:
            assert _rel(vk[key], vp[key]) <= tol, (name, key)
        ik, ip = sk.view(torch.int32), sp.view(torch.int32)
        assert torch.equal(ik[cg.K:cg.REASON + 1], ip[cg.K:cg.REASON + 1]) and int(ik[cg.TICKET]) == 0, name
        terms = float((vectors['p'] * vectors['ap']).abs().sum() + (vectors['p'] * vectors['p']).sum()
                      + (vp['r'] * vp['r']).sum())
        for slot in (cg.RZ, cg.PAP, cg.RR, cg.RZOLD, cg.RR0):
            assert abs(float(sk[slot] - sp[slot])) <= tol * terms, (name, slot)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n', [1, 1023, 1050625])
def test_cg_kernels_are_deterministic_and_predicated(cuda, n, dtype):
    # bitwise equal over two runs; nothing written while the flag is clear
    vectors = _k4_vectors(cuda, dtype, n)
    for name, kernel, _plain, kwargs in _k4_cases():
        (v1, s1), (v2, s2) = _k4_run(kernel, vectors, cuda, dtype, kwargs), _k4_run(kernel, vectors, cuda, dtype, kwargs)
        assert all(torch.equal(v1[k], v2[k]) for k in vectors) and torch.equal(s1, s2), name
        v, st = _k4_run(kernel, vectors, cuda, dtype, dict(kwargs, active=0))
        assert all(torch.equal(v[k], vectors[k]) for k in vectors), name
        assert torch.equal(st, _cg_state(cuda, dtype, 0.7, 1.3, 0.4, **dict(kwargs, active=0))), name


@pytest.mark.parametrize('precon', ['mg', 'diag'])
def test_cg_graph_driver_is_the_host_loop(cuda, precon):
    # the 65^2-dof slice in float32: the chunked driver replayed from CUDA
    # graphs returns the eager host loop's (x, rnorm, k) bit for bit, and a
    # refined solve its x, iterations and rounds; a warm solve grows the
    # launch counters by its replays times each graph's launches
    from nutils_tpu_torch import function, mesh
    from nutils_tpu_torch.solver import System
    from nutils_tpu_torch.utils import config
    with config.device('cuda'):
        config.floatx.value = numpy.float32
        try:
            topo, geom = mesh.unitsquare(64, 'square')
            u = topo.field('u', btype='std', degree=1)
            g = function.grad(u, geom)
            f = function.sin(geom[0]) * function.cosh(geom[1])
            energy = topo.integral(((g @ g) / 2 + (u * u) / 2 - f * u) * function.J(geom), degree=2)
            jac, res = System(energy, trial='u').assemble_jacobian_residual({'u': numpy.zeros(65 * 65)})
        finally:
            config.floatx.value = numpy.float64
    mv_kind, op = jac._device_op()
    if precon == 'mg':
        m = jac._mg()
        kind, minv = ('mg', m.levels), (m.ws, m.dinvs, m.coarse_inv)
    else:
        kind, minv = 'diag', torch.as_tensor(1.0 / jac.diagonal(), dtype=torch.float32, device=cuda)
    b = torch.as_tensor(res, dtype=torch.float32, device=cuda)
    atol = 1e-5 * float(numpy.linalg.norm(res))
    host = sparse.cg_op(mv_kind, op, b, atol=atol, maxiter=2000, minv=minv, precon=kind, chunk=None)
    for chunk in (1, 3, 8, 8):
        stats = {}
        before = {w.__name__: w.launches for w in _kernels.COUNTED}
        graph = sparse.cg_op(mv_kind, op, b, atol=atol, maxiter=2000, minv=minv, precon=kind, chunk=chunk,
                             stats=stats)
        assert stats['driver'] == 'graph' and stats['c'] == chunk
        assert graph[1:] == host[1:] and torch.equal(graph[0], host[0])
        grown = {w.__name__: w.launches - before[w.__name__] for w in _kernels.COUNTED}
        replayed = {}
        for name, counts in stats['graph_launches'].items():
            for wrapper, count in counts.items():
                replayed[wrapper] = replayed.get(wrapper, 0) + count * stats['replays'][name]
        if stats['t_capture'] == 0:  # a warm solve launches only its replays
            assert all(grown[k] == replayed.get(k, 0) for k in grown), (grown, replayed)
    kw = dict(target=1e-10 * float(numpy.linalg.norm(res)), maxiter=1024, minv=minv, precon=kind)
    want = sparse.refined_solve_op('cg', mv_kind, op, res, chunk=None, **kw)
    got = sparse.refined_solve_op('cg', mv_kind, op, res, chunk=8, **kw)
    assert got[1:] == want[1:] and numpy.array_equal(got[0], want[0])


def test_cuda_slice_goes_through_the_kernels(cuda):
    # the 65^2-dof slice in float64 on the card: every kernel launches (K2
    # as the fused sweeps alone: its levels are 2-D, k = 1), and the
    # solution is the CPU's (plain versions) to 1e-8
    from nutils_tpu_torch import function, mesh
    from nutils_tpu_torch.solver import System
    from nutils_tpu_torch.utils import config
    wrappers = [stencil.stencil_matvec, mg.jacobi_pre, mg.jacobi_post, mg.mg_restrict, mg.mg_prolong_add,
                cg.cg_dot, cg.cg_step, cg.cg_xpby]
    xs = []
    for device in ('cuda', 'cpu'):
        with config.device(device):
            topo, geom = mesh.unitsquare(64, 'square')
            u = topo.field('u', btype='std', degree=1)
            g = function.grad(u, geom)
            f = function.sin(geom[0]) * function.cosh(geom[1])
            energy = topo.integral(((g @ g) / 2 + (u * u) / 2 - f * u) * function.J(geom), degree=2)
            jac, res = System(energy, trial='u').assemble_jacobian_residual({'u': numpy.zeros(65 * 65)})
            before = [wr.launches for wr in wrappers]
            single = mg.jacobi_smooth.launches
            xs.append(jac.solve(res, solver='cg', rtol=1e-10))
            if device == 'cuda':
                assert all(wr.launches > b for wr, b in zip(wrappers, before))
                assert mg.jacobi_smooth.launches == single
                assert jac._solve_stats['driver'] == 'graph'
    assert numpy.linalg.norm(xs[0] - xs[1]) <= 1e-8 * numpy.linalg.norm(xs[1])


def _blockgrid_operator(name):
    """K5's compact plan of a small Taylor-Hood jacobian assembled by the
    port on the CPU: the Stokes system on the unit square, or the periodic
    Navier-Stokes step (whose wrapped rows take the checked path)."""
    import _torch_parity as tp
    from nutils_tpu_torch.utils import config
    with config.device('cpu'):
        if name == 'stokes':
            jac = tp.build_stokes('nutils_tpu_torch', 8)
        else:
            system = tp.build_th_periodic('nutils_tpu_torch', 12)
            args = {t: numpy.zeros(s) for t, s in zip(system.trials, system.trial_shapes)}
            jac, _res = system.assemble_jacobian_residual(args)
    return jac._k5_plan()


@pytest.mark.parametrize('dtype,tol', TOLS)
@pytest.mark.parametrize('name', ['stokes', 'periodic'])
def test_blockgrid_matvec(cuda, name, dtype, tol):
    # random values at the pattern's entries (the weight buffer is zero
    # elsewhere): the kernel against its plain version on the compact
    # operand and against the literal port on the weights, one launch
    plan = _blockgrid_operator(name)
    rng = numpy.random.default_rng(3)
    v = torch.as_tensor(rng.standard_normal(plan.nv), dtype=dtype, device=cuda)
    x = torch.as_tensor(rng.standard_normal(plan.n), dtype=dtype, device=cuda)
    launches = blockgrid.blockgrid_matvec.launches
    got = blockgrid.blockgrid_matvec(v, x, plan)
    assert blockgrid.blockgrid_matvec.launches == launches + 1
    assert _rel(got, blockgrid.compact_matvec_plain(v, x, plan)) <= tol
    assert _rel(got, blockgrid.matvec_plain(blockgrid.unpack(v, plan), x, plan.meta, plan.woff)) <= tol
    assert name == 'stokes' or plan.ctab[:, 5].any()


def test_blockgrid_matvec_takes_the_flag(cuda):
    # K5 under a Krylov loop's flag: the same bits while it is set; while
    # it is clear the kernel writes nothing (its output then keeps what the
    # caching allocator's reused block held)
    plan = _blockgrid_operator('stokes')
    rng = numpy.random.default_rng(5)
    v = torch.as_tensor(rng.standard_normal(plan.nv), dtype=torch.float32, device=cuda)
    x = torch.as_tensor(rng.standard_normal(plan.n), dtype=torch.float32, device=cuda)
    on, off = torch.ones(1, dtype=torch.int32, device=cuda), torch.zeros(1, dtype=torch.int32, device=cuda)
    want = blockgrid.blockgrid_matvec(v, x, plan)
    assert torch.equal(blockgrid.blockgrid_matvec(v, x, plan, on), want)
    filler = torch.full_like(x, 7.0)
    del filler
    idle = blockgrid.blockgrid_matvec(v, x, plan, off)
    torch.cuda.synchronize()
    assert bool((idle == 7.0).all())


K6_RESTART = 64
KRYLOV_SIZES = [1, 1023, 983403]


def _np(dtype):
    return numpy.float32 if dtype == torch.float32 else numpy.float64


def _gmres_state(dev, dtype, n, j, inner=1, active=1, atol=1.0, inner_tol=1e-3, maxiter=1000, it=0, stall=0,
                 resnorm=1.0, hn=0.8, beta=1.3, seed=11):
    """A K6 state at step ``j`` of a cycle of restart K6_RESTART: random
    h1, h2, g, rotations (cs, sn of random angles) and an upper triangular
    R = I + 0.1 U, every value rounded to ``dtype``."""
    m, dt = K6_RESTART, _np(dtype)
    rng = numpy.random.default_rng(seed)
    L = gmres.layout(m)
    s = numpy.zeros(L['parts'])
    s[gmres.ATOL], s[gmres.BETA], s[gmres.RN], s[gmres.INNER_TOL] = dt(atol), dt(beta), dt(0.9), dt(inner_tol)
    s[gmres.RESNORM], s[gmres.HN], s[gmres.RES] = dt(resnorm), dt(hn), dt(0.5)
    ints = s.view(numpy.int32)
    ints[gmres.J], ints[gmres.IT], ints[gmres.STALL], ints[gmres.INNER], ints[gmres.ACTIVE] = j, it, stall, inner, active
    ints[gmres.MAXITER], ints[gmres.CYCLES] = maxiter, 2
    theta = rng.random(m) * 2 * numpy.pi
    for key, values in (('h1', rng.standard_normal(m + 1)), ('h2', 0.01 * rng.standard_normal(m + 1)),
                        ('g', rng.standard_normal(m + 1)), ('cs', numpy.cos(theta)), ('sn', numpy.sin(theta)),
                        ('R', (numpy.eye(m) + 0.1 * numpy.triu(rng.standard_normal((m, m)))).ravel())):
        s[L[key]:L[key] + len(values)] = values.astype(dt)
    st = gmres.new_state(n, m, dtype, dev)
    st[:L['parts']] = torch.as_tensor(s, device=dev)
    return st


def _gmres_vectors(dev, dtype, n, seed=12):
    rng = numpy.random.default_rng(seed)
    V = gmres.basis(n, K6_RESTART, dtype, dev)
    V.copy_(torch.as_tensor(rng.standard_normal((K6_RESTART + 1, n)) / n ** 0.5, dtype=dtype, device=dev))
    out = {k: torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev) for k in ('w', 'src', 'x', 'b', 'y', 'r')}
    out['vcur'] = torch.zeros(n, dtype=dtype, device=dev)
    out['V'] = V
    return out


def _k6_cases():
    """(name, call, the state's arguments, the sums its last block takes):
    every K6 entry with each decision it can take; ``call(f, v, st)`` runs
    the entry ``f[name]`` (the kernel's or the plain version)."""
    m = K6_RESTART

    def proj(second):
        return lambda f, v, st: f['project'](v['V'], v['w'], st, second)

    def upd(second):
        return lambda f, v, st: f['update'](v['V'], v['w'] if second else v['src'], v['w'], st, second)

    def norm(first):
        return lambda f, v, st: f['normalize'](v['w'], v['V'], v['vcur'], st, first)

    def start(f, v, st):
        f['start'](v['w'], v['r'], st, m)

    def resid(first, with_y=True):
        return lambda f, v, st: f['residual'](v['b'], v['y'] if with_y else None, v['r'], st, m, first)

    def solve(f, v, st):
        f['solve_combine'](v['V'], v['x'], st)
    return [
        ('project 1', proj(False), {}, None),
        ('project 2', proj(True), {}, None),
        ('update 1', upd(False), {}, None),
        ('update 2', upd(True), {}, 'step'),
        ('update 2 below inner_tol', upd(True), {'inner_tol': 1e30}, 'step'),
        ('normalize', norm(False), {}, None),
        ('normalize first', norm(True), {}, None),
        ('normalize hn <= eps', norm(False), {'hn': 0.0}, None),
        ('start', start, {'atol': 1e-3}, 'start'),
        ('start below inner_tol', start, {'atol': 1e30}, 'start'),
        ('residual first', resid(True, False), {'atol': 1e-3}, 'first'),
        ('residual first at atol', resid(True, False), {'atol': 1e30}, 'first'),
        ('residual stalled once', resid(False), {'atol': 1e-3, 'resnorm': 1e-30, 'stall': 1}, 'residual'),
        ('residual progress', resid(False), {'atol': 1e-3, 'resnorm': 1e30, 'stall': 3}, 'residual'),
        ('residual fifth stall', resid(False), {'atol': 1e-3, 'resnorm': 1e-30, 'stall': 4}, 'residual'),
        ('residual capped', resid(False), {'atol': 1e-3, 'resnorm': 1e30, 'it': 995}, 'residual'),
        ('solve_combine', solve, {}, None),
    ]


K6_KERNELS = {'project': gmres.gmres_project, 'update': gmres.gmres_update, 'normalize': gmres.gmres_normalize,
              'start': gmres.gmres_start, 'residual': gmres.gmres_residual, 'solve_combine': gmres.gmres_solve_combine}
K6_PLAIN = {'project': gmres.project_plain, 'update': gmres.update_plain, 'normalize': gmres.normalize_plain,
            'start': gmres.start_plain, 'residual': gmres.residual_plain, 'solve_combine': gmres.solve_combine_plain}


def _k6_run(call, f, vectors, dev, dtype, n, j, kwargs):
    v = {k: t.clone() for k, t in vectors.items() if k != 'V'}
    v['V'] = gmres.basis(n, K6_RESTART, dtype, dev)
    v['V'].copy_(vectors['V'])
    st = _gmres_state(dev, dtype, n, j, **kwargs)
    call(f, v, st)
    torch.cuda.synchronize()
    return v, st


def _k6_replay(sums, st_in, st_k, n, dtype):
    """The plain scalar work of the entry's last block on the input state,
    fed the kernel's own sums (its WW and RR slots): the state the kernel
    must have written, bit for bit."""
    m, dt = K6_RESTART, _np(dtype)
    s = st_in[:gmres.layout(m)['parts']].cpu().numpy().copy()
    k = st_k.cpu().numpy()
    if sums == 'step':
        gmres.step_scalars(s, m, k[gmres.WW], dt)
    elif sums == 'start':
        gmres.start_scalars(s, m, k[gmres.WW], k[gmres.RR], dt)
    else:
        gmres.residual_scalars(s, k[gmres.RR], sums == 'first', dt)
    return s


@pytest.mark.parametrize('dtype,tol', TOLS)
@pytest.mark.parametrize('j', [0, 7, K6_RESTART - 1])
@pytest.mark.parametrize('n', KRYLOV_SIZES)
def test_gmres_kernels(cuda, n, j, dtype, tol):
    # each K6 entry against its plain version on the same state: vectors to
    # the tolerance of their largest value, the projections on the scale of
    # their terms, the sums of squares relatively; the last block's scalar
    # work (rotations, R, g, the tests, the back-substitution) bit for bit
    # the plain scalar functions' on the kernel's own sums; no ticket left
    vectors = _gmres_vectors(cuda, dtype, n)
    L = gmres.layout(K6_RESTART)
    for name, call, kwargs, sums in _k6_cases():
        (vk, sk), (vp, sp) = (_k6_run(call, f, vectors, cuda, dtype, n, j, kwargs) for f in (K6_KERNELS, K6_PLAIN))
        for key in vp:
            assert _close(vk[key], vp[key], tol), (name, key)
        ik = sk.view(torch.int32)
        assert int(ik[gmres.TICKET]) == 0, name
        if name.startswith('project'):
            at = L['h2' if name.endswith('2') else 'h1']
            scale = float((vectors['V'][:j + 1].abs() @ vectors['w'].abs()).max())
            assert float((sk[at:at + j + 1] - sp[at:at + j + 1]).abs().max()) <= tol * scale, name
            continue
        for slot in (gmres.WW, gmres.RR):
            assert abs(float(sk[slot] - sp[slot])) <= tol * abs(float(sp[slot])), (name, slot)
        want = _k6_replay(sums, _gmres_state(cuda, dtype, n, j, **kwargs), sk, n, dtype) if sums else \
            sp[:L['parts']].cpu().numpy()
        got = sk[:L['parts']].cpu().numpy()
        assert numpy.array_equal(got, want), (name, numpy.flatnonzero(got != want)[:8])


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n', KRYLOV_SIZES)
def test_gmres_kernels_are_deterministic_and_predicated(cuda, n, dtype):
    # bitwise equal over two runs; nothing written while the entry's flag
    # (the inner one for the Arnoldi entries, the outer one for the cycle's)
    # is clear
    vectors = _gmres_vectors(cuda, dtype, n)
    for name, call, kwargs, _sums in _k6_cases():
        (v1, s1), (v2, s2) = (_k6_run(call, K6_KERNELS, vectors, cuda, dtype, n, 7, kwargs) for _ in range(2))
        assert all(torch.equal(v1[k], v2[k]) for k in vectors) and torch.equal(s1, s2), name
        idle = dict(kwargs, inner=0, active=0)
        v, st = _k6_run(call, K6_KERNELS, vectors, cuda, dtype, n, 7, idle)
        assert all(torch.equal(v[k], vectors[k]) for k in vectors), name
        assert torch.equal(st, _gmres_state(cuda, dtype, n, 7, **idle)), name


@pytest.mark.parametrize('mapped', [True, False])
@pytest.mark.parametrize('dtype,tol', TOLS)
def test_schur_diag(cuda, dtype, tol, mapped):
    # random CSR with strong rows and weak (near-zero diagonal) rows, its
    # values scattered through a map into a larger buffer
    import scipy.sparse
    rng = numpy.random.default_rng(5)
    n = 20000
    A = scipy.sparse.random(n, n, density=4e-4, random_state=6, format='csr') + scipy.sparse.eye(n)
    A = A.tocsr()
    A.sort_indices()
    weak = rng.random(n) < 0.3
    A.data[numpy.repeat(weak, numpy.diff(A.indptr)) & (A.indices == numpy.repeat(numpy.arange(n),
                                                                              numpy.diff(A.indptr)))] = 1e-9
    cmap = rng.permutation(A.nnz + 1000)[:A.nnz]
    wbuf = numpy.zeros(A.nnz + 1000)
    wbuf[cmap] = A.data
    args = [torch.as_tensor(a, device=cuda) for a in (wbuf.astype(numpy.float64), cmap.astype(numpy.int32),
                                                      A.indices.astype(numpy.int32), A.indptr.astype(numpy.int32))]
    args[0] = args[0].to(dtype)
    if not mapped:
        # the CSR form: the values themselves, no map
        args[:2] = [args[0][args[1].long()], None]
    launches = sparse.schur_diag_inverse_device.launches
    got = sparse.schur_diag_inverse_device(*args, n)
    assert sparse.schur_diag_inverse_device.launches == launches + 1
    assert _rel(got, sparse.schur_diag_plain(*args, n)) <= tol


def _schur_rows(n, seed):
    '''A CSR operator (data, indices, indptr) of n rows for K7: rows longer
    than its block (sparse.CSR_CAP), rows of more than half of it (a block
    of their own), empty rows, weak rows (a near-zero diagonal) and short
    ordinary ones.'''
    rng = numpy.random.default_rng(seed)
    cap = sparse.CSR_CAP
    lens = rng.integers(1, 60, n)
    lens[rng.random(n) < 0.03] = 0
    lens[[3, n // 2, n - 1]] = [cap + 37, 2 * cap + 300, cap // 2 + 1]
    lens[[4, 5]] = [cap // 2 + 200, 0]
    cols = []
    for i, k in enumerate(lens):
        c = rng.choice(n, size=k, replace=False)
        if k and i not in c and rng.random() < 0.9:
            c[0] = i
        cols.append(numpy.sort(c))
    indptr = numpy.concatenate([[0], numpy.cumsum(lens)])
    indices = numpy.concatenate(cols)
    rows = numpy.repeat(numpy.arange(n), lens)
    data = rng.standard_normal(len(indices))
    data[(indices == rows) & numpy.repeat(rng.random(n) < 0.3, lens)] = 1e-9
    return data, indices, indptr


def _schur_args(cuda, dtype, mapped, n=6000, seed=8):
    data, indices, indptr = _schur_rows(n, seed)
    tabs = [torch.as_tensor(a.astype(numpy.int32), device=cuda) for a in (indices, indptr)]
    if not mapped:
        return [torch.as_tensor(data, dtype=dtype, device=cuda), None, *tabs, n]
    cmap = numpy.random.default_rng(seed + 1).permutation(len(data) + 500)[:len(data)]
    wbuf = numpy.zeros(len(data) + 500)
    wbuf[cmap] = data
    return [torch.as_tensor(wbuf, dtype=dtype, device=cuda), torch.as_tensor(cmap.astype(numpy.int32), device=cuda),
            *tabs, n]


@pytest.mark.parametrize('mapped', [True, False])
@pytest.mark.parametrize('dtype,tol', TOLS)
def test_schur_diag_long_short_and_empty_rows(cuda, dtype, tol, mapped):
    # K7 on its row blocks: long rows staged a block at a time, rows alone
    # in a block, empty rows (minv 1) and weak rows, against the plain version
    args = _schur_args(cuda, dtype, mapped)
    launches = sparse.schur_diag_inverse_device.launches
    got = sparse.schur_diag_inverse_device(*args)
    assert sparse.schur_diag_inverse_device.launches == launches + 1
    assert _rel(got, sparse.schur_diag_plain(*args)) <= tol
    empty = torch.diff(args[3]) == 0
    assert bool(empty.any()) and bool((got[empty] == 1).all())


@pytest.mark.parametrize('mapped', [True, False])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_schur_diag_is_deterministic(cuda, dtype, mapped):
    # two K7 calls give the same bits (each row summed in a fixed order)
    args = _schur_args(cuda, dtype, mapped, seed=9)
    first = sparse.schur_diag_inverse_device(*args).clone()
    assert _same_bits(sparse.schur_diag_inverse_device(*args), first)


def test_cuda_ns_step_goes_through_the_kernels(cuda):
    # a small Navier-Stokes step in float64 on the card: K5-K7 launch, the
    # GMRES loop replays CUDA graphs, and the solution is the CPU's (plain
    # versions) to 1e-8 in as many iterations
    import _torch_parity as tp
    from nutils_tpu_torch.utils import config
    wrappers = [blockgrid.blockgrid_matvec, gmres.gmres_project, gmres.gmres_update, gmres.gmres_normalize,
                gmres.gmres_start, gmres.gmres_residual, gmres.gmres_solve_combine, sparse.schur_diag_inverse_device]
    out = []
    for device in ('cuda', 'cpu'):
        with config.device(device):
            system, args = tp.build_ns('nutils_tpu_torch', 6, numpy.float64)
            jac, res = system.assemble_jacobian_residual(args)
            before = [wr.launches for wr in wrappers]
            out.append((jac.solve_leniently(res, solver='gmres', rtol=1e-3), dict(jac._solve_stats)))
            if device == 'cuda':
                assert all(wr.launches > b for wr, b in zip(wrappers, before))
    (xa, sa), (xb, sb) = out
    assert sa['iters'] == sb['iters'] and sa['driver'] == 'graph' and sb['driver'] == 'host'
    assert sa['host_reads'] <= sa['chunks'] + sa.get('cycles', 0) + sa['rounds']
    assert numpy.linalg.norm(xa - xb) <= 1e-8 * numpy.linalg.norm(xb)


def _krylov_operands(method, dtype):
    """(mv_kind, op, minv, b) of the 6 x 6 Navier-Stokes step on the card,
    assembled by the port in ``dtype``: its block-grid operator (K5) for
    GMRES, the triangles' CSR operator (K9) for BiCGStab; the Schur
    diagonal (K7)."""
    import _torch_parity as tp
    from nutils_tpu_torch.utils import config
    with config.device('cuda'):
        try:
            system, args = (tp.build_ns if method == 'gmres' else tp.build_ns_tri)('nutils_tpu_torch', 6, dtype)
            jac, res = system.assemble_jacobian_residual(args)
        finally:
            config.floatx.value = numpy.float64
    mv_kind, op = jac._device_op()
    _kind, minv = jac._device_precon(None, None)
    return mv_kind, op, minv.to(op[0].dtype), torch.as_tensor(res, dtype=op[0].dtype, device='cuda')


@pytest.mark.parametrize('dtype', [numpy.float32, numpy.float64])
@pytest.mark.parametrize('method', ['gmres', 'bicgstab'])
def test_krylov_graph_driver_is_the_host_loop(cuda, method, dtype):
    # the chunked driver replayed from CUDA graphs returns the eager host
    # loop's (x, resnorm, iters) bit for bit, GMRES(15) across several
    # cycles; a warm solve grows the launch counters by its replays times
    # each graph's launches; two graph solves give the same bits
    mv_kind, op, minv, b = _krylov_operands(method, dtype)
    atol = (1e-10 if dtype == numpy.float64 else 1e-5) * float(torch.linalg.norm(b))
    solve = sparse.gmres_op if method == 'gmres' else sparse.bicgstab_op
    kw = dict(atol=atol, maxiter=2000, minv=minv, precon='diag', **({'restart': 15} if method == 'gmres' else {}))
    host_stats = {}
    host = solve(mv_kind, op, b, chunk=None, stats=host_stats, **kw)
    assert host_stats['driver'] == 'host' and host_stats['host_reads'] >= host[2]
    for chunk in (1, 3, 8, 8):
        stats = {}
        before = {w.__name__: w.launches for w in _kernels.COUNTED}
        graph = solve(mv_kind, op, b, chunk=chunk, stats=stats, **kw)
        assert stats['driver'] == 'graph' and stats['c'] == chunk
        assert graph[1:] == host[1:] and torch.equal(graph[0], host[0]), chunk
        assert stats['host_reads'] == stats['chunks'] + stats.get('cycles', 0)
        grown = {w.__name__: w.launches - before[w.__name__] for w in _kernels.COUNTED}
        replayed = {}
        for name, counts in stats['graph_launches'].items():
            for wrapper, count in counts.items():
                replayed[wrapper] = replayed.get(wrapper, 0) + count * stats['replays'][name]
        if stats['t_capture'] == 0:  # a warm solve launches only its replays
            assert all(grown[k] == replayed.get(k, 0) for k in grown), (grown, replayed)
    if method == 'gmres':
        assert host_stats['cycles'] >= 2 and host[2] > 15


def _random_csr(n, rowlen, seed):
    """A random n x n CSR matrix with rows of 0..2*rowlen entries (sorted,
    distinct columns): (data, indices, indptr) as numpy arrays."""
    import scipy.sparse
    rng = numpy.random.default_rng(seed)
    counts = rng.integers(0, 2 * rowlen + 1, n)
    rows = numpy.repeat(numpy.arange(n), counts)
    cols = rng.integers(0, n, len(rows))
    A = scipy.sparse.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)), shape=(n, n))
    A.sum_duplicates()
    return A.data, A.indices.astype(numpy.int32), A.indptr.astype(numpy.int32)


@pytest.mark.parametrize('dtype,tol', TOLS)
@pytest.mark.parametrize('rowlen', [3, 29])
def test_csr_matvec(cuda, rowlen, dtype, tol):
    # rows of 0..6 entries (fewer than K9's four lanes, empty rows included)
    # and of 0..58, the triangle operator's range
    data, indices, indptr = _random_csr(30011, rowlen, 7 + rowlen)
    x = numpy.random.default_rng(8).standard_normal(30011)
    data, x = (torch.as_tensor(a, dtype=dtype, device=cuda) for a in (data, x))
    indices, indptr = (torch.as_tensor(a, device=cuda) for a in (indices, indptr))
    launches = sparse.csr_matvec.launches
    got = sparse.csr_matvec(data, indices, indptr, x)
    assert sparse.csr_matvec.launches == launches + 1
    assert _rel(got, sparse.csr_matvec_plain(data, indices, indptr, x)) <= tol


@pytest.mark.parametrize('dtype,tol', TOLS)
def test_csr_matvec_rows(cuda, dtype, tol):
    # rows of 0, 1, 3, 59 and more than CSR_CAP nonzeros, in an order that
    # starts rows at every offset modulo K9's 16-byte loads; the same bits
    # twice; with the flag at 0 nothing is written
    import _torch_parity as tp
    cap = sparse.CSR_CAP
    lens = [0, 1, 3, 59, 0, 2 * cap + 5, 1, 59, cap // 2 + 1, 0, 3] * 40 + [cap, 7, 59, 1]
    data, indices, indptr = tp.csr_of_rows(lens, 12)
    xn = numpy.random.default_rng(13).standard_normal(len(indptr) - 1)
    data, x = (torch.as_tensor(a, dtype=dtype, device=cuda) for a in (data, xn))
    indices, indptr = (torch.as_tensor(a, device=cuda) for a in (indices, indptr))
    got = sparse.csr_matvec(data, indices, indptr, x)
    want = sparse.csr_matvec_plain(data, indices, indptr, x)
    scale = sparse.csr_matvec_plain(data.abs(), indices, indptr, x.abs()).max()
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / scale) <= tol
    assert torch.equal(got, sparse.csr_matvec(data, indices, indptr, x))
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    out = torch.full_like(got, 7.0)
    sparse.csr_matvec(data, indices, indptr, x, active=flag, out=out)
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())
    flag.fill_(1)
    sparse.csr_matvec(data, indices, indptr, x, active=flag, out=out)
    torch.cuda.synchronize()
    assert torch.equal(out, got)


@pytest.mark.parametrize('dtype,tol', TOLS)
def test_csr_scatter(cuda, dtype, tol):
    # COO entries with repeats into their CSR slots: K8 against index_add_,
    # and bitwise the same on a second launch
    rng = numpy.random.default_rng(9)
    n, m = 5003, 200000
    rows, cols = rng.integers(0, n, m), rng.integers(0, n // 50, m)
    pattern = matrix.SparsePattern(rows, cols, (n, n // 50))
    values = torch.as_tensor(rng.standard_normal(m), dtype=dtype, device=cuda)
    launches = sparse.csr_scatter.launches
    got = pattern.scatter(values)
    assert sparse.csr_scatter.launches == launches + 1
    want = sparse.scatter_plain(values, torch.as_tensor(pattern.slot, device=cuda), pattern.nnz)
    assert _rel(got, want) <= tol
    assert torch.equal(got, pattern.scatter(values))


def _bicg_state(dev, dtype, n, active=1, need=0, atol=1e-3, k=5, maxiter=1000, stall=0, claimed=0, breakdown=0,
                lastres=1.0, seed=13, **slots):
    """A K10 state with random scalars (rounded to ``dtype``), the given
    flags and counts, and ``slots`` ({name: value}) over them."""
    rng = numpy.random.default_rng(seed)
    dt = _np(dtype)
    s = numpy.zeros(bicgstab.HEAD)
    s[:bicgstab.RNORM + 1] = (rng.random(bicgstab.RNORM + 1) + 0.5).astype(dt)
    s[bicgstab.ATOL], s[bicgstab.LASTRES] = dt(atol), dt(lastres)
    for name, value in slots.items():
        s[getattr(bicgstab, name.upper())] = dt(value)
    ints = s.view(numpy.int32)
    for slot, value in ((bicgstab.ACTIVE, active), (bicgstab.NEED, need), (bicgstab.K, k),
                        (bicgstab.MAXITER, maxiter), (bicgstab.STALL, stall), (bicgstab.CLAIMED, claimed),
                        (bicgstab.BREAKDOWN, breakdown), (bicgstab.REFRESHES, 3)):
        ints[slot] = value
    st = bicgstab.new_state(n, dtype, dev)
    st[:bicgstab.HEAD] = torch.as_tensor(s, device=dev)
    return st


def _k10_cases():
    """(name, call, the state's arguments, the replay of its scalars):
    every K10 entry with each decision it can take."""
    B = bicgstab

    def dots(two=False, start=False):
        def call(f, v, st):
            if start:
                f['dots'](v['b'], v['b'], None, st, B.RR, start=True)
            elif two:
                f['dots'](v['t'], v['t'], v['s'], st, B.TT, B.TS)
            else:
                f['dots'](v['rhat'], v['v'], None, st, B.RV)
        return call

    def s_(f, v, st):
        f['s'](v['r'], v['v'], st, v['s'])

    def xr(f, v, st):
        f['xr'](v['x'], v['r'], v['phat'], v['shat'], v['s'], v['t'], v['rhat'], st)

    def refresh(f, v, st):
        f['refresh'](v['b'], v['y'], v['r'], v['rhat'], st)

    def p(f, v, st):
        f['p'](v['p'], v['r'], v['v'], v['rhat'], st)

    def start(s, k, dt):
        s[B.RR] = k[B.RR]
        B.start_scalars(s, k[B.RR], dt)

    def claim(s, k, dt):
        tt = dt(s[B.TT])
        B.claim_scalars(s, k[B.RR], k[B.RHOR], dt(s[B.TS]) / (tt if tt > dt(numpy.finfo(dt).tiny * 16) else dt(1)), dt)

    def decide(need):
        def replay(s, k, dt):
            if need:
                s[B.RR], s[B.RHOR] = k[B.RR], k[B.RHOR]
                s.view(numpy.int32)[B.REFRESHES] += 1
            B.decide_plain(s, need, dt)
        return replay
    return [
        ('dots', dots(), {}, None),
        ('dots two', dots(two=True), {}, None),
        ('dots start', dots(start=True), {'k': 0}, start),
        ('dots start at atol', dots(start=True), {'k': 0, 'atol': 1e30}, start),
        ('s', s_, {}, None),
        ('s rv <= eps', s_, {'rv': 0.0}, None),
        ('xr', xr, {}, claim),
        ('xr tt <= eps', xr, {'tt': 0.0}, claim),
        ('xr claimed', xr, {'atol': 1e30}, claim),
        ('xr scheduled', xr, {'k': 63}, claim),
        ('refresh none', refresh, {}, decide(False)),
        ('refresh', refresh, {'need': 1, 'lastres': 1e30, 'stall': 2}, decide(True)),
        ('refresh stalled', refresh, {'need': 1, 'lastres': 1e-30, 'stall': 3}, decide(True)),
        ('refresh refuted claim', refresh, {'need': 1, 'claimed': 1}, decide(True)),
        ('refresh accepted claim', refresh, {'need': 1, 'claimed': 1, 'atol': 1e30}, decide(True)),
        ('refresh rho breakdown', refresh, {'rhor': 0.0}, decide(False)),
        ('refresh omega breakdown', refresh, {'omega': 0.0, 'rho': 0.0}, decide(False)),
        ('refresh capped', refresh, {'k': 999}, decide(False)),
        ('p', p, {}, None),
        ('p breakdown', p, {'breakdown': 1}, None),
    ]


K10_KERNELS = {'dots': bicgstab.bicg_dots, 's': bicgstab.bicg_s, 'xr': bicgstab.bicg_xr,
               'refresh': bicgstab.bicg_refresh, 'p': bicgstab.bicg_p}
K10_PLAIN = {'dots': bicgstab.dots_plain, 's': bicgstab.s_plain, 'xr': bicgstab.xr_plain,
             'refresh': bicgstab.refresh_plain, 'p': bicgstab.p_plain}
K10_SUMS = {bicgstab.RV: ('rhat', 'v'), bicgstab.TT: ('t', 't'), bicgstab.TS: ('t', 's'), bicgstab.RR: ('r', 'r'),
            bicgstab.RHOR: ('rhat', 'r')}


def _bicg_vectors(dev, dtype, n, seed=14):
    rng = numpy.random.default_rng(seed)
    return {k: torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev)
            for k in ('x', 'r', 'phat', 'shat', 's', 't', 'rhat', 'v', 'p', 'b', 'y')}


def _k10_run(call, f, vectors, dev, dtype, n, kwargs):
    v = {k: t.clone() for k, t in vectors.items()}
    st = _bicg_state(dev, dtype, n, **kwargs)
    call(f, v, st)
    torch.cuda.synchronize()
    return v, st


@pytest.mark.parametrize('dtype,tol', TOLS)
@pytest.mark.parametrize('n', KRYLOV_SIZES)
def test_bicgstab_kernels(cuda, n, dtype, tol):
    # each K10 entry against its plain version on the same state: vectors to
    # the tolerance of their largest value, sums on the scale of their
    # terms; the last block's decisions (the claim, the refresh, the stall,
    # the breakdown, beta, rho, k and the exit) bit for bit the plain scalar
    # functions' on the kernel's own sums; no ticket left
    vectors = _bicg_vectors(cuda, dtype, n)
    B = bicgstab
    for name, call, kwargs, replay in _k10_cases():
        (vk, sk), (vp, sp) = (_k10_run(call, f, vectors, cuda, dtype, n, kwargs) for f in (K10_KERNELS, K10_PLAIN))
        for key in vp:
            assert _close(vk[key], vp[key], tol), (name, key)
        assert int(sk.view(torch.int32)[B.TICKET]) == 0, name
        for slot, (a, b) in K10_SUMS.items():
            # the sums over this run's vectors (r is the updated one)
            va, vb = (vp[key] for key in (a, b))
            assert abs(float(sk[slot] - sp[slot])) <= tol * float((va * vb).abs().sum()), (name, slot)
        got = sk[:B.HEAD].cpu().numpy()
        if replay is None:
            want = sp[:B.HEAD].cpu().numpy().copy()
            for slot in K10_SUMS:
                want[slot] = got[slot]
        else:
            want = _bicg_state(cuda, dtype, n, **kwargs)[:B.HEAD].cpu().numpy().copy()
            replay(want, got, _np(dtype))
        assert numpy.array_equal(got, want), (name, numpy.flatnonzero(got != want)[:8])


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n', KRYLOV_SIZES)
def test_bicgstab_kernels_are_deterministic_and_predicated(cuda, n, dtype):
    # bitwise equal over two runs; nothing written while the active flag is
    # clear
    vectors = _bicg_vectors(cuda, dtype, n)
    for name, call, kwargs, _replay in _k10_cases():
        (v1, s1), (v2, s2) = (_k10_run(call, K10_KERNELS, vectors, cuda, dtype, n, kwargs) for _ in range(2))
        assert all(torch.equal(v1[k], v2[k]) for k in vectors) and torch.equal(s1, s2), name
        v, st = _k10_run(call, K10_KERNELS, vectors, cuda, dtype, n, dict(kwargs, active=0))
        assert all(torch.equal(v[k], vectors[k]) for k in vectors), name
        assert torch.equal(st, _bicg_state(cuda, dtype, n, **dict(kwargs, active=0))), name


def test_cuda_ns_tri_step_goes_through_the_kernels(cuda):
    # the triangle Navier-Stokes step at 6x6 in float64 on the card: K6-K10
    # launch, both loops replay CUDA graphs, and the GMRES and BiCGStab
    # solutions are the CPU's (plain versions) to 1e-8, in as many
    # iterations
    import _torch_parity as tp
    from nutils_tpu_torch.utils import config
    wrappers = {'gmres': [gmres.gmres_project, gmres.gmres_update, gmres.gmres_normalize, gmres.gmres_start,
                          gmres.gmres_residual, gmres.gmres_solve_combine],
                'bicgstab': [bicgstab.bicg_dots, bicgstab.bicg_s, bicgstab.bicg_xr, bicgstab.bicg_refresh,
                             bicgstab.bicg_p]}
    shared = [sparse.csr_scatter, sparse.csr_matvec, sparse.schur_diag_inverse_device]
    out = {}
    for device in ('cuda', 'cpu'):
        with config.device(device):
            system, args = tp.build_ns_tri('nutils_tpu_torch', 6, numpy.float64)
            before = [wr.launches for wr in shared]
            jac, res = system.assemble_jacobian_residual(args)
            for method, own in wrappers.items():
                own_before = [wr.launches for wr in own]
                out[device, method] = (jac.solve_leniently(res, solver=method, rtol=1e-3),
                                       dict(jac._solve_stats))
                if device == 'cuda':
                    assert all(wr.launches > b for wr, b in zip(own, own_before)), method
            if device == 'cuda':
                assert all(wr.launches > b for wr, b in zip(shared, before))
    for method in wrappers:
        (xa, sa), (xb, sb) = out['cuda', method], out['cpu', method]
        assert sa['op_form'] == 'csr' and sa['accepted_on_device'] and sa['iters'] == sb['iters']
        assert sa['driver'] == 'graph' and sb['driver'] == 'host'
        assert sa['host_reads'] <= sa['chunks'] + sa.get('cycles', 0) + sa['rounds']
        assert numpy.linalg.norm(xa - xb) <= 1e-8 * numpy.linalg.norm(xb)


def test_cuda_triangle_residual_is_deterministic(cuda):
    # the triangle step's residual, assembled twice on the card through the
    # sorted segment sums (K8): bitwise equal, and the CPU's to 1e-14
    import _torch_parity as tp
    from nutils_tpu_torch.utils import config
    out = []
    for device in ('cuda', 'cpu'):
        with config.device(device):
            system, args = tp.build_ns_tri('nutils_tpu_torch', 6, numpy.float64)
            fn = system._compiled('residual')
            clean = system._clean(args)
            launches = sparse.csr_scatter.launches
            out.append([fn(clean) for _ in range(2)])
            if device == 'cuda':
                assert sparse.csr_scatter.launches > launches
    (r1, r2), (want, _) = out
    assert torch.equal(r1, r2)
    assert float((r1.cpu() - want).abs().max()) <= 1e-14 * float(want.abs().max())


# (Q, A, I, B, J, shared operators) of the factored assembly's element
# contractions on the paths: Navier-Stokes velocity-velocity,
# velocity-pressure and pressure-velocity blocks, the triangle step's
# (operators the same for every element), the Laplace slice's, the
# elasticity example's (P2 vector triangles) and the Laplace example's
CONTRACTIONS = {'ns_uu': (16, 6, 18, 6, 18, False), 'ns_up': (16, 6, 18, 1, 4, False),
                'ns_pu': (16, 1, 4, 6, 18, False), 'tri_uu': (12, 6, 12, 6, 12, True),
                'tri_pu': (12, 1, 3, 6, 12, True), 'laplace': (4, 3, 4, 3, 4, False),
                'elasticity': (6, 6, 12, 6, 12, True), 'example': (4, 2, 4, 2, 4, False)}
# K11's operands: 'route' as the factored assembly hands them over (K a
# permuted slice of the Hessian [B, E, Q, A_total], the seed axis first),
# 'contiguous' (K contiguous); where test and trial shapes agree, 'one'
# (Bs is Bt, staged once) and 'equal' (Bs a copy of Bt)
OPERANDS = [(case, ops) for case, (_Q, A, I, B, J, _sh) in CONTRACTIONS.items()
            for ops in ('route', 'contiguous') + (('one', 'equal') if (A, I) == (B, J) else ())]


@pytest.mark.parametrize('size', ['1001', 'one element', 'ragged'])
@pytest.mark.parametrize('dtype,tol', TOLS)
@pytest.mark.parametrize('case,ops', OPERANDS)
def test_assembly_contractions(cuda, case, ops, dtype, tol, size):
    # K11 and K12 against their plain versions (one einsum each), on the
    # scale of the terms' magnitudes, at E = 1001, at E = 1 and at an E that
    # is not a multiple of K11's group (plan); two launches bitwise equal;
    # Bs as Bt itself and as a copy of it give the same bits
    Q, A, I, B, J, shared = CONTRACTIONS[case]

    def operands(E):
        rng = numpy.random.default_rng(5)
        Et = 1 if shared else E
        Bt = torch.as_tensor(rng.standard_normal((Et, Q, A, I)), dtype=dtype, device=cuda)
        Bs = {'one': Bt, 'equal': Bt.clone()}.get(ops)
        if Bs is None:
            Bs = torch.as_tensor(rng.standard_normal((Et, Q, B, J)), dtype=dtype, device=cuda)
        if ops == 'contiguous':
            K = torch.as_tensor(rng.standard_normal((E, Q, A, B)), dtype=dtype, device=cuda)
        else:
            K = torch.as_tensor(rng.standard_normal((B, E, Q, A + 1)), dtype=dtype, device=cuda)[..., 1:]
            K = K.permute(1, 2, 3, 0)
        g = torch.as_tensor(rng.standard_normal((E, Q, A + 2)), dtype=dtype, device=cuda)[..., 1:A + 1]
        return Bt, K, Bs, g
    E = {'1001': 1001, 'one element': 1}.get(size)
    if E is None:  # a ragged last group of the plan these very operands take
        E = 3 * assembly.elem_matrix_plan(*operands(1001)[:3])['G'] + 1
    Bt, K, Bs, g = operands(E)
    if size == 'ragged':
        G = assembly.elem_matrix_plan(Bt, K, Bs)['G']
        assert E > G and (E % G or G == 1)  # a group of one element has no ragged end
    launches = assembly.elem_matrix.launches, assembly.elem_vector.launches
    V, V2 = assembly.elem_matrix(Bt, K, Bs), assembly.elem_matrix(Bt, K, Bs)
    r, r2 = assembly.elem_vector(Bt, g), assembly.elem_vector(Bt, g)
    assert (assembly.elem_matrix.launches, assembly.elem_vector.launches) == (launches[0] + 2, launches[1] + 2)
    torch.cuda.synchronize()
    assert V.shape == (E, I, J) and r.shape == (E, I)
    assert torch.equal(V, V2) and torch.equal(r, r2)
    assert assembly.elem_matrix_plan(Bt, K, Bs)['same'] == (ops == 'one')
    if ops in ('one', 'equal'):
        other = Bt.clone() if ops == 'one' else Bt
        assert torch.equal(V, assembly.elem_matrix(Bt, K, other))
    scale = assembly.elem_matrix_plain(Bt.abs(), K.abs(), Bs.abs()).max()
    assert float((V - assembly.elem_matrix_plain(Bt, K, Bs)).abs().max() / scale) <= tol
    scale = assembly.elem_vector_plain(Bt.abs(), g.abs()).max()
    assert float((r - assembly.elem_vector_plain(Bt, g)).abs().max() / scale) <= tol


@pytest.mark.parametrize('case', ['laplace', 'ns', 'ns_tri'])
def test_cuda_assembly_goes_through_the_contractions(cuda, case):
    # each path at a small size in float64: every chunk takes the factored
    # route, K11 and K12 launch on the card, and the jacobian and residual
    # are the CPU's (plain versions) to 1e-12
    import _torch_parity as tp
    from nutils_tpu_torch.utils import config
    out = []
    for device in ('cuda', 'cpu'):
        with config.device(device):
            if case == 'laplace':
                system = tp.build_laplace('nutils_tpu_torch', 16, numpy.float64, reaction=True)
                args = {'u': numpy.random.default_rng(0).standard_normal(17 * 17)}
            else:
                system, args = tp.build_ns('nutils_tpu_torch', 6, numpy.float64, 'triangle' if case == 'ns_tri'
                                           else 'square')
            launches = assembly.elem_matrix.launches, assembly.elem_vector.launches
            w, r = system._compiled('jacres')(system._clean(args))
            out.append((w.cpu(), r.cpu()))
            assert set(system._assembly_routes.values()) == {'factored'}
            if device == 'cuda':
                assert assembly.elem_matrix.launches > launches[0] and assembly.elem_vector.launches > launches[1]
    (wa, ra), (wb, rb) = out
    assert float((wa - wb).abs().max()) <= 1e-12 * float(wb.abs().max())
    assert float((ra - rb).abs().max()) <= 1e-12 * float(rb.abs().max())


@pytest.mark.parametrize('dtype,tol', TOLS)
@pytest.mark.parametrize('case', ['ns_uu', 'tri_uu', 'laplace'])
def test_assembly_contractions_into_chunk_rows(cuda, case, dtype, tol):
    # K11 and K12 with ``out`` the middle chunk's rows of a buffer of three
    # chunks: they write there in place, leave the other rows alone and
    # equal their plain versions writing into another such buffer
    Q, A, I, B, J, shared = CONTRACTIONS[case]
    E = 1001
    rng = numpy.random.default_rng(6)
    Et = 1 if shared else E
    Bt, Bs = (torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=cuda)
              for s in ((Et, Q, A, I), (Et, Q, B, J)))
    K = torch.as_tensor(rng.standard_normal((B, E, Q, A)), dtype=dtype, device=cuda).permute(1, 2, 3, 0)
    g = torch.as_tensor(rng.standard_normal((E, Q, A)), dtype=dtype, device=cuda)
    rows = slice(E, 2 * E)
    for kernel, plain, operands, shape, magnitude in (
            (assembly.elem_matrix, assembly.elem_matrix_plain, (Bt, K, Bs), (3 * E, I, J),
             lambda: assembly.elem_matrix_plain(Bt.abs(), K.abs(), Bs.abs())),
            (assembly.elem_vector, assembly.elem_vector_plain, (Bt, g), (3 * E, I),
             lambda: assembly.elem_vector_plain(Bt.abs(), g.abs()))):
        buf, want = (torch.zeros(shape, dtype=dtype, device=cuda) for _ in range(2))
        launches = kernel.launches
        got = kernel(*operands, out=buf[rows])
        plain(*operands, out=want[rows])
        torch.cuda.synchronize()
        assert kernel.launches == launches + 1
        assert got.data_ptr() == buf[rows].data_ptr()
        assert not buf[:E].any() and not buf[2 * E:].any()
        assert float((buf[rows] - want[rows]).abs().max() / magnitude().max()) <= tol
        assert torch.equal(buf[rows], kernel(*operands))
        with pytest.raises(ValueError):
            kernel(*operands, out=buf[rows].transpose(0, -1))


def _generic_vector(Bt, g):
    """K12's generic kernel (one thread an output, the order of sums of the
    kernel the staged one replaced), launched directly."""
    E, Q, A = g.shape
    I = Bt.shape[-1]
    out = torch.empty((E, I), dtype=g.dtype, device=g.device)
    strides = (ctypes.c_int64 * 7)(*assembly._strides(Bt, E), *assembly._strides(g, E))
    _kernels.call('ntt_elem_vector', g, [Bt, g, out], scalars=(E, Q, A, I, strides, None))
    return out


# K12's operands on the paths ((Q, A, I, shared Bt, g's features a point),
# g a slice of them at an offset: the residual's view of the point
# gradient): the Navier-Stokes velocity and pressure residuals, the
# triangles', the slice's, the example's, the elasticity example's and the
# finite-strain example's
VECTOR_CASES = {'ns_v': (16, 6, 18, False, 14, 7), 'ns_q': (16, 1, 4, False, 14, 13),
                'tri_v': (12, 6, 12, True, 14, 7), 'tri_q': (12, 1, 3, True, 14, 13),
                'laplace': (4, 3, 4, False, 3, 0), 'example': (4, 2, 4, False, 4, 2),
                'elasticity': (6, 6, 12, True, 6, 0), 'finitestrain': (4, 4, 8, False, 4, 0)}


@pytest.mark.parametrize('size', ['1001', 'one element', 'ragged'])
@pytest.mark.parametrize('dtype,tol', TOLS)
@pytest.mark.parametrize('case', list(VECTOR_CASES))
def test_elem_vector_staged_is_the_generic_kernel(cuda, case, dtype, tol, size):
    # K12 on its plan (element lanes or tile lanes; Bt per element or
    # shared; g a strided slice) against its plain version, and bit for bit
    # the generic kernel, whose order of sums is that of the kernel it
    # replaced; a chunk's rows of a buffer written in place, the rest left
    # alone; launches counted by regime
    Q, A, I, shared, width, offset = VECTOR_CASES[case]

    def operands(E):
        rng = numpy.random.default_rng(8)
        Bt = torch.as_tensor(rng.standard_normal((1 if shared else E, Q, A, I)), dtype=dtype, device=cuda)
        g = torch.as_tensor(rng.standard_normal((E, Q, width)), dtype=dtype, device=cuda)[..., offset:offset + A]
        return Bt, g
    E = {'1001': 1001, 'one element': 1}.get(size)
    if E is None:
        E = 3 * assembly.elem_vector_plan(*operands(1001))['G'] + 1
    Bt, g = operands(E)
    plan = assembly.elem_vector_plan(Bt, g)
    assert plan['regime'] in ('element_lanes', 'tile_lanes')
    forms = dict(assembly.elem_vector.forms)
    r = assembly.elem_vector(Bt, g)
    assert assembly.elem_vector.forms[plan['regime']] == forms[plan['regime']] + 1
    assert torch.equal(r, _generic_vector(Bt, g)) and torch.equal(r, assembly.elem_vector(Bt, g))
    scale = assembly.elem_vector_plain(Bt.abs(), g.abs()).max()
    assert float((r - assembly.elem_vector_plain(Bt, g)).abs().max() / scale) <= tol
    buf = torch.zeros((3 * E, I), dtype=dtype, device=cuda)
    got = assembly.elem_vector(Bt, g, out=buf[E:2 * E])
    torch.cuda.synchronize()
    assert got.data_ptr() == buf[E].data_ptr() and torch.equal(buf[E:2 * E], r)
    assert not buf[:E].any() and not buf[2 * E:].any()


def test_elem_vector_generic_regime(cuda):
    # an element too large for shared memory in two stages: the plan says
    # so, and the wrapper launches the generic kernel
    rng = numpy.random.default_rng(9)
    Bt = torch.as_tensor(rng.standard_normal((1, 64, 32, 64)), device=cuda, dtype=torch.float64)
    g = torch.as_tensor(rng.standard_normal((10, 64, 32)), device=cuda, dtype=torch.float64)
    assert assembly.elem_vector_plan(Bt, g)['regime'] == 'generic'
    before = assembly.elem_vector.forms['generic']
    r = assembly.elem_vector(Bt, g)
    assert assembly.elem_vector.forms['generic'] == before + 1
    assert torch.equal(r, _generic_vector(Bt, g))
    assert _close(r, assembly.elem_vector_plain(Bt, g), 1e-14, assembly.elem_vector_plain(Bt.abs(), g.abs()).max())


@pytest.mark.parametrize('case', ['laplace', 'ns', 'ns_tri'])
def test_cuda_chunked_assembly_is_the_unchunked(cuda, case):
    # each path at a small size in float64 in element chunks on the card:
    # the same bits as the whole batch's assembly on the card, and the
    # CPU's chunked assembly (plain versions) to 1e-12
    import _torch_parity as tp
    from nutils_tpu_torch.utils import config
    out = []
    for device in ('cuda', 'cpu'):
        with config.device(device):
            if case == 'laplace':
                system = tp.build_laplace('nutils_tpu_torch', 16, numpy.float64, reaction=True)
                args = {'u': numpy.random.default_rng(0).standard_normal(17 * 17)}
            else:
                system, args = tp.build_ns('nutils_tpu_torch', 6, numpy.float64, 'triangle' if case == 'ns_tri'
                                           else 'square')
            fn, clean = system._compiled('jacres'), system._clean(args)
            whole = fn(clean)
            with config.assembly_chunk(20):
                launches = assembly.elem_matrix.launches
                chunked = fn(clean)
                assert system._chunk_plan()['nc'] > 1
                if device == 'cuda':
                    assert assembly.elem_matrix.launches - launches >= system._chunk_plan()['nc']
            assert all(torch.equal(a, b) for a, b in zip(whole, chunked))
            out.append(tuple(t.cpu() for t in chunked))
    (wa, ra), (wb, rb) = out
    assert float((wa - wb).abs().max()) <= 1e-12 * float(wb.abs().max())
    assert float((ra - rb).abs().max()) <= 1e-12 * float(rb.abs().max())


# K13 and K14 on vectors of one row, of 1,003 rows (a ragged last block
# for every block size from 2 to 8) and of the elasticity path's 1,039,682
APPLY_ROWS = [1, 1003, 1039682]


@pytest.mark.parametrize('dtype,tol', TOLS)
@pytest.mark.parametrize('bs', range(1, 9))
@pytest.mark.parametrize('n', APPLY_ROWS)
def test_block_apply(cuda, n, bs, dtype, tol):
    rng = numpy.random.default_rng(n + bs)
    nb = -(-n // bs)
    minv = torch.as_tensor(rng.standard_normal((nb, bs, bs)), dtype=dtype, device=cuda)
    r = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=cuda)
    launches = precon.block_apply.launches
    got = precon.block_apply(minv, r)
    assert precon.block_apply.launches == launches + 1
    want = precon.block_apply_plain(minv, r)
    scale = precon.block_apply_plain(minv.abs(), r.abs())
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / scale.max()) <= tol
    assert torch.equal(got, precon.block_apply(minv, r))
    # the loop's flag: 0 leaves out untouched, 1 writes it
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    out = torch.full_like(r, 7.0)
    assert precon.block_apply(minv, r, active=flag, out=out) is out
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())
    flag.fill_(1)
    precon.block_apply(minv, r, active=flag, out=out)
    assert torch.equal(out, got)


def test_block_apply_refuses(cuda):
    r = torch.zeros(10, device=cuda)
    with pytest.raises(ValueError):
        precon.block_apply(torch.zeros((2, 9, 9), device=cuda), torch.zeros(18, device=cuda))
    with pytest.raises(ValueError):
        precon.block_apply(torch.zeros((2, 4, 4), device=cuda), r)  # 10 rows, 8 in the blocks
    with pytest.raises(TypeError):
        precon.block_apply(torch.zeros((5, 2, 2), dtype=torch.float64, device=cuda), r)


@pytest.mark.parametrize('offset', range(4))
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n', APPLY_ROWS)
def test_mask_passes(cuda, n, dtype, offset):
    # products by 0 and 1 are exact: the kernels give the plain versions'
    # values (a zero's sign aside), on views ``offset`` entries into their
    # buffers (a scalar head, 16-byte vectors, a scalar tail), and with x
    # and the output at another offset than m (scalar throughout); the
    # loop's flag at 0 writes nothing
    rng = numpy.random.default_rng(n)

    def view(a, at=offset):
        buf = torch.empty(n + 4, dtype=dtype, device=cuda)
        buf[at:at + n] = torch.as_tensor(a, dtype=dtype, device=cuda)
        return buf[at:at + n]
    m = view(rng.random(n) > 0.25)
    x, y = (view(rng.standard_normal(n)) for _ in range(2))
    launches = sparse.mask_pre.launches, sparse.mask_post.launches
    xm, z = sparse.mask_pre(m, x, out=view(numpy.zeros(n))), sparse.mask_post(m, y, x, out=view(numpy.zeros(n)))
    assert (sparse.mask_pre.launches, sparse.mask_post.launches) == (launches[0] + 1, launches[1] + 1)
    assert bool((xm == sparse.mask_pre_plain(m, x)).all()) and bool((z == sparse.mask_post_plain(m, y, x)).all())
    y2 = y.clone()
    assert sparse.mask_post(m, y2, x, out=y2) is y2 and bool((y2 == z).all())
    xs, ys = view(x.cpu(), (offset + 1) % 4), view(y.cpu(), (offset + 1) % 4)
    assert bool((sparse.mask_pre(m, xs) == xm).all()) and bool((sparse.mask_post(m, ys, xs) == z).all())
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    out = view(numpy.full(n, 7.0))
    sparse.mask_pre(m, x, active=flag, out=out)
    sparse.mask_post(m, y, x, active=flag, out=out)
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())
    flag.fill_(1)
    assert bool((sparse.mask_post(m, y, x, active=flag, out=out) == z).all())
    assert bool((sparse.mask_pre(m, x, active=flag, out=out) == xm).all())


def test_cuda_elasticity_goes_through_the_block_and_mask_kernels(cuda):
    # examples/elasticity.py at 8 triangles a side in float64: block-Jacobi
    # CG from CUDA graphs through K13 (and K9), and the masked operator's
    # CG through K14 around K9; both the CPU's (plain versions) to 1e-8
    import _torch_parity as tp
    from nutils_tpu_torch.utils import config
    block = dict(solver='cg', precon='block', preconargs={'blocksize': 2})
    out = {}
    for device in ('cuda', 'cpu'):
        with config.device(device), config.floatx(numpy.float64):
            before = precon.block_apply.launches, sparse.mask_pre.launches, sparse.mask_post.launches
            cons, u, t, F, system = tp.elasticity('nutils_tpu_torch', 8, 'triangle', **block)
            stats = dict(system._cache['jacmat']._solve_stats)
            isfree = numpy.isnan(cons).ravel()
            jac, res = system.assemble_jacobian_residual({'u': numpy.zeros(system.trial_shapes[0])})
            dx = jac._solve_cg(numpy.where(isfree, res, 0.), atol=0., rtol=1e-11, precon='block',
                               preconargs={'blocksize': 2}, _isfree=isfree)
            out[device] = u, t, F, dx, stats, dict(jac._solve_stats)
            if device == 'cuda':
                after = precon.block_apply.launches, sparse.mask_pre.launches, sparse.mask_post.launches
                assert all(a > b for a, b in zip(after, before))
    (u, t, F, dx, st, sm), (uc, tc, _Fc, dxc, _stc, _smc) = out['cuda'], out['cpu']
    assert st['precon'] == 'block' and st['driver'] == 'graph' and st['accepted_on_device']
    assert sm['op_form'] == 'masked' and sm['precon'] == 'block' and sm['accepted_on_device']
    assert numpy.abs(F - [0., 1.]).max() <= 1e-10
    for a, b in ((u, uc), (t, tc), (dx, dxc)):
        assert numpy.linalg.norm(a - b) <= 1e-8 * numpy.linalg.norm(b)


VALUE_SHAPES = [(518, 4), (1, 1), (300, 9), (1024, 6), (4096, 4), (0, 4)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('E,P', VALUE_SHAPES)
def test_elem_value(cuda, E, P, dtype):
    # K15's partials and their sum: the plain version's bits (the same
    # order of sums), two launches the same, chunks of a multiple of the
    # span into their rows of one buffer the same as one piece
    rng = numpy.random.default_rng(E * 10 + P)
    f = torch.as_tensor(rng.standard_normal((E, P)), dtype=dtype, device=cuda)
    launches = assembly.elem_value.launches, assembly.elem_value_sum.launches
    got = assembly.elem_value(f)
    again = assembly.elem_value(f)
    nb = assembly.value_blocks(E, P)
    total = assembly.elem_value_sum(got, [0, nb])
    torch.cuda.synchronize()
    assert assembly.elem_value.launches == launches[0] + (2 if E else 0)
    assert assembly.elem_value_sum.launches == launches[1] + 1
    assert torch.equal(got, assembly.elem_value_plain(f)) and torch.equal(got, again)
    assert torch.equal(total, assembly.elem_value_sum_plain(got, [0, nb]))
    if E:
        assert abs(float(total) - float(f.double().sum())) <= 1e-5 * float(f.double().abs().sum())
    span = assembly.value_span(P)
    if E >= 2 * span and E % (2 * span) == 0:
        buf = torch.empty_like(got)
        half = E // 2
        for c in range(2):
            assembly.elem_value(f[c * half:(c + 1) * half], out=buf[c * (nb // 2):(c + 1) * (nb // 2)])
        assert torch.equal(buf, got)


def test_elem_value_sum_segments(cuda):
    # segments reduced each in the fixed order, their values added in order
    rng = numpy.random.default_rng(31)
    for dtype in (torch.float32, torch.float64):
        parts = torch.as_tensor(rng.standard_normal(1000), dtype=dtype, device=cuda)
        # a few segments, one empty, and 40 segments (a functional of that
        # many additive terms)
        for offsets in ([0, 0, 7, 300, 1000], [0, *range(25, 1001, 25)]):
            assert torch.equal(assembly.elem_value_sum(parts, offsets), assembly.elem_value_sum_plain(parts, offsets))


def _value_parts(rng, shapes, dtype, device):
    """Integrands of a functional's parts, [E, P] each."""
    return [torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=device) for shape in shapes]


def _fold(fs, total=None):
    """The value of parts ``fs`` as the solver takes it: every part's
    partials into its segment of one buffer, the last launch finishing."""
    sizes = [assembly.value_blocks(*f.shape) for f in fs]
    offsets = numpy.cumsum([0] + sizes).tolist()
    partials = fs[0].new_empty(offsets[-1])
    total = fs[0].new_empty(1) if total is None else total
    for k, f in enumerate(fs):
        assembly.elem_value(f, out=partials[offsets[k]:offsets[k + 1]],
                            finish=(partials, offsets, total) if k == len(fs) - 1 else None)
    return partials, offsets, total


# parts of a value: one (the finite-strain path's), two, 40 (a functional
# of that many terms, some of one element), and two whose last is empty
FOLDS = {'one': [(518, 4)], 'two': [(300, 9), (1, 1)], 'forty': [(37 * k % 300 + 1, 1 + k % 6) for k in range(40)],
         'empty last': [(1024, 4), (0, 4)]}


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('parts', list(FOLDS))
def test_elem_value_fold_is_the_two_launches(cuda, parts, dtype):
    # the folded launch: the partials and the value bit for bit those of
    # elem_value followed by elem_value_sum over the segments, one finishing
    # launch, no elem_value_sum launch, the counter back at 0
    fs = _value_parts(numpy.random.default_rng(41), FOLDS[parts], dtype, cuda)
    before = dict(assembly.elem_value.forms), assembly.elem_value_sum.launches
    partials, offsets, total = _fold(fs)
    torch.cuda.synchronize()
    assert assembly.elem_value.forms['finish'] == before[0]['finish'] + 1
    assert assembly.elem_value_sum.launches == before[1]
    want = torch.cat([assembly.elem_value(f) for f in fs])
    assert torch.equal(partials, want)
    assert torch.equal(total, assembly.elem_value_sum(want, offsets))
    assert torch.equal(total, assembly.elem_value_sum_plain(want, offsets))
    assert int(assembly._ticket(cuda)[0]) == 0


def test_elem_value_fold_replays(cuda):
    # ten replays of a CUDA graph holding a folded value of three parts: the
    # same bits each time (the counter starts each replay at 0), counted
    # at each replay
    fs = _value_parts(numpy.random.default_rng(43), [(518, 4), (1, 1), (2048, 4)], torch.float64, cuda)
    partials, offsets, total = _fold(fs)  # the counter and the segment table, made before the capture
    want = total.clone()
    torch.cuda.synchronize()
    total.zero_()
    graph = _kernels.Graph(lambda: _fold(fs, total))
    before = assembly.elem_value.forms['finish']
    for k in range(10):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(total, want), k
        total.zero_()
    assert assembly.elem_value.forms['finish'] == before + 10
    assert int(assembly._ticket(cuda)[0]) == 0


def test_cuda_value_goes_through_k15(cuda):
    # the finite-strain energy at 8 elements a side: assemble_value through
    # K15 on the card equals the CPU's (plain versions) to 1e-12, and a
    # Minimize solve on the card launches K15 on every trial, each value
    # finished in its last launch
    import _torch_parity as tp
    from nutils_tpu_torch import solver
    from nutils_tpu_torch.utils import config
    values = {}
    for device in ('cuda', 'cpu'):
        with config.device(device), config.floatx(numpy.float64):
            system = solver.System(tp.finitestrain_forms('nutils_tpu_torch', 8, 'mixed')[4], trial='u')
            args = {'u': 0.1 * numpy.random.default_rng(37).standard_normal(system.trial_shapes[0])}
            before = assembly.elem_value.launches
            values[device] = system.assemble_value(args)
            if device == 'cuda':
                assert assembly.elem_value.launches > before
    assert abs(values['cuda'] - values['cpu']) <= 1e-12 * abs(values['cpu'])
    with config.device('cuda'), config.floatx(numpy.float64):
        before = assembly.elem_value.forms['finish'], assembly.elem_value_sum.launches
        _cons, _u0, u1, system = tp.finitestrain('nutils_tpu_torch', 8)
        # one finishing launch a value, the segment sum folded into it
        assert assembly.elem_value.forms['finish'] > before[0] + 1
        assert assembly.elem_value_sum.launches == before[1]
        assert numpy.isfinite(u1).all()
