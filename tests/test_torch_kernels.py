'''The hand kernels of nutils_tpu_torch (K1-K7) against their plain PyTorch
versions, on a CUDA card.  This file imports no jax, so it runs where the
card is:

    python -m pytest tests/test_torch_kernels.py -m gpu

Without a card every test skips.  Tolerances: float32 1e-6 and float64 1e-14
of the largest plain value (the sums run in another order, with fused
multiply-adds); reductions on the scale of their terms.'''

import numpy
import pytest
import torch

from nutils_tpu_torch.ops import _triton_cg as tcg
from nutils_tpu_torch.ops import _triton_gmres as tgm
from nutils_tpu_torch.ops import blockgrid, mg, sparse, stencil

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


@pytest.mark.parametrize('dtype,tol', TOLS)
def test_cg_kernels(cuda, dtype, tol):
    rng = numpy.random.default_rng(2)
    x, r, p, ap, z = (torch.as_tensor(rng.standard_normal(100003), dtype=dtype, device=cuda) for _ in range(5))
    alpha = torch.tensor(0.3, dtype=dtype, device=cuda)
    got, want = tcg.cg_dot(p, ap), tcg.dot_plain(p, ap)
    assert abs(float(got - want)) <= tol * float((p * ap).abs().sum())
    x1, r1, x2, r2 = x.clone(), r.clone(), x.clone(), r.clone()
    n1 = tcg.cg_axpy_norm(x1, r1, p, ap, alpha)
    n2 = tcg.axpy_norm_plain(x2, r2, p, ap, alpha)
    assert abs(float(n1 - n2)) <= tol * float(n2)
    assert _rel(x1, x2) <= tol and _rel(r1, r2) <= tol
    p1, p2 = p.clone(), p.clone()
    assert _rel(tcg.cg_xpby(p1, z, alpha), tcg.xpby_plain(p2, z, alpha)) <= tol


def test_cuda_slice_goes_through_the_kernels(cuda):
    # the 65^2-dof slice in float64 on the card: every kernel launches, and
    # the solution is the CPU's (plain versions) to 1e-8
    from nutils_tpu_torch import function, mesh
    from nutils_tpu_torch.solver import System
    from nutils_tpu_torch.utils import config
    wrappers = [stencil.stencil_matvec, mg.jacobi_smooth, mg.mg_restrict, mg.mg_prolong_add,
                tcg.cg_dot, tcg.cg_axpy_norm, tcg.cg_xpby]
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
            xs.append(jac.solve(res, solver='cg', rtol=1e-10))
            if device == 'cuda':
                assert all(wr.launches > b for wr, b in zip(wrappers, before))
    assert numpy.linalg.norm(xs[0] - xs[1]) <= 1e-8 * numpy.linalg.norm(xs[1])


def _blockgrid_operator(name):
    """(w, meta, woff) of a small Taylor-Hood jacobian assembled by the port
    on the CPU: the Stokes system on the unit square, or the periodic
    Navier-Stokes step."""
    import _torch_parity as tp
    from nutils_tpu_torch.utils import config
    with config.device('cpu'):
        if name == 'stokes':
            jac = tp.build_stokes('nutils_tpu_torch', 8)
        else:
            system = tp.build_th_periodic('nutils_tpu_torch', 12)
            args = {t: numpy.zeros(s) for t, s in zip(system.trials, system.trial_shapes)}
            jac, _res = system.assemble_jacobian_residual(args)
    (_kind, meta, woff), (w,) = jac._device_op()
    return w, meta, woff


@pytest.mark.parametrize('dtype,tol', TOLS)
@pytest.mark.parametrize('name', ['stokes', 'periodic'])
def test_blockgrid_matvec(cuda, name, dtype, tol):
    w, meta, woff = _blockgrid_operator(name)
    rng = numpy.random.default_rng(3)
    w = torch.as_tensor(rng.standard_normal(w.shape[0]), dtype=dtype, device=cuda)
    x = torch.as_tensor(rng.standard_normal(meta[0][-1]), dtype=dtype, device=cuda)
    launches = blockgrid.blockgrid_matvec.launches
    got = blockgrid.blockgrid_matvec(w, x, meta, woff)
    assert blockgrid.blockgrid_matvec.launches == launches + 1
    assert _rel(got, blockgrid.matvec_plain(w, x, meta, woff)) <= tol


@pytest.mark.parametrize('dtype,tol', TOLS)
@pytest.mark.parametrize('j', [0, 7, 63])
def test_gmres_kernels(cuda, j, dtype, tol):
    rng = numpy.random.default_rng(4 + j)
    n = 100003
    V = torch.as_tensor(rng.standard_normal((65, n)), dtype=dtype, device=cuda)
    w, x = (torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=cuda) for _ in range(2))
    h = torch.as_tensor(rng.standard_normal(j + 1), dtype=dtype, device=cuda)
    # reductions on the scale of their terms
    got, want = tgm.gmres_project(V, j, w), tgm.project_plain(V, j, w)
    assert float((got - want).abs().max()) <= tol * float((V[:j + 1].abs() @ w.abs()).max())
    w1, w2 = w.clone(), w.clone()
    n1, n2 = tgm.gmres_update(V, j, h, w1), tgm.update_plain(V, j, h, w2)
    assert _rel(w1, w2) <= tol and abs(float(n1 - n2)) <= tol * float(n2)
    hn, eps = torch.sqrt(n2), torch.tensor(1e-30, dtype=dtype, device=cuda)
    out1, out2 = torch.empty_like(w), torch.empty_like(w)
    assert _rel(tgm.gmres_normalize(w2, hn, eps, out1), tgm.normalize_plain(w2, hn, eps, out2)) <= tol
    x1, x2 = x.clone(), x.clone()
    assert _rel(tgm.gmres_combine(V, j + 1, h, x1), tgm.combine_plain(V, j + 1, h, x2)) <= tol


@pytest.mark.parametrize('dtype,tol', TOLS)
def test_schur_diag(cuda, dtype, tol):
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
    launches = sparse.schur_diag_inverse_device.launches
    got = sparse.schur_diag_inverse_device(*args, n)
    assert sparse.schur_diag_inverse_device.launches == launches + 1
    assert _rel(got, sparse.schur_diag_plain(*args, n)) <= tol


def test_cuda_ns_step_goes_through_the_kernels(cuda):
    # a small Navier-Stokes step in float64 on the card: K5-K7 launch, and
    # the GMRES solution is the CPU's (plain versions) to 1e-8
    import _torch_parity as tp
    from nutils_tpu_torch.utils import config
    wrappers = [blockgrid.blockgrid_matvec, tgm.gmres_project, tgm.gmres_update, tgm.gmres_normalize,
                tgm.gmres_combine, sparse.schur_diag_inverse_device]
    out = []
    for device in ('cuda', 'cpu'):
        with config.device(device):
            system, args = tp.build_ns('nutils_tpu_torch', 6, numpy.float64)
            jac, res = system.assemble_jacobian_residual(args)
            before = [wr.launches for wr in wrappers]
            out.append((jac.solve_leniently(res, solver='gmres', rtol=1e-3), jac._solve_stats['iters']))
            if device == 'cuda':
                assert all(wr.launches > b for wr, b in zip(wrappers, before))
    (xa, ia), (xb, ib) = out
    assert ia == ib
    assert numpy.linalg.norm(xa - xb) <= 1e-8 * numpy.linalg.norm(xb)
