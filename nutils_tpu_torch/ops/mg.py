'''Geometric multigrid preconditioner for grid-stencil operators,
dimension-generic (1-D/2-D/3-D grids, any stencil width the stencil matvec
supports).

Float32 Krylov on its own cannot solve large second-order problems; a
geometric V-cycle over the stencil grid makes the preconditioned system O(1)
conditioned.  Setup is host-side and matrix-algebraic (copied from
``nutils_tpu.ops.mg``): coarse operators are Galerkin products A_c = P^T A P
computed with scipy sparse and re-expressed as stencils over the KNOWN
coarse grid; the coarsest level is inverted densely once.

The V(2,2) cycle (:func:`apply_vcycle`) runs on the device through three
hand-written kernels: K2 :func:`jacobi_smooth` (weighted-Jacobi sweep, or the
residual r - A x, fused with the stencil matvec), K3 :func:`mg_restrict`
(full weighting) and :func:`mg_prolong_add` (x += P xc, linear
interpolation); the coarsest level is a plain ``torch.matmul`` with the
dense inverse.  Each kernel's plain torch version (the literal port of
``_vcycle_fn``'s updates, ``_restrict`` and ``_prolong``) runs for tensors on
the CPU.
'''

import numpy
import torch

from .. import _kernels
from ..utils import config
from . import stencil as _st

OMEGA = 0.8


class MGData:
    '''Per-matrix multigrid hierarchy: stencil weights per level, inverse
    diagonals, the dense coarsest inverse, and static per-level
    (ks, shape) metadata.'''

    __slots__ = ('ws', 'dinvs', 'coarse_inv', 'levels')

    def __init__(self, ws, dinvs, coarse_inv, levels):
        self.ws = ws                  # list of [W, *shape] device arrays
        self.dinvs = dinvs            # list of [*shape] device arrays
        self.coarse_inv = coarse_inv  # [nc, nc] dense inverse (device)
        self.levels = levels          # static ((ks, shape, periodic), ...) incl. coarsest


def _prolong_1d(n_fine):
    '''Sparse 1-D linear interpolation [n_fine, n_coarse] for a vertex grid
    (n_fine odd), coarse vertices at the even fine vertices.'''
    import scipy.sparse
    nc = (n_fine + 1) // 2
    rows, cols, vals = [], [], []
    for i in range(nc):
        rows.append(2 * i)
        cols.append(i)
        vals.append(1.0)
    for i in range(nc - 1):
        rows += [2 * i + 1, 2 * i + 1]
        cols += [i, i + 1]
        vals += [0.5, 0.5]
    return scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(n_fine, nc))


def _coarsen_flags(shape, periodic, min_coarse):
    '''Per-axis semi-coarsening flags: odd non-periodic vertex axes >= 5
    coarsen, short/even/periodic axes (vector components, wrapped pitches)
    are kept — returns None when nothing coarsens or the level is already
    small.'''
    flags = tuple(s >= 5 and s % 2 == 1 and not per for s, per in zip(shape, periodic))
    if not any(flags) or int(numpy.prod(shape)) <= min_coarse:
        return None
    return flags


def setup(form, data, indices, indptr, *, dtype=numpy.float32, min_coarse=1024, max_levels=12,
          device=None):
    '''Build the hierarchy for a StencilForm (ops/stencil.py) whose CSR
    arrays are given; returns MGData or None when the grid cannot coarsen
    (even pitch or too small).  Host work (scipy Galerkin products, dense
    coarsest inverse); the level operands become tensors of ``dtype`` on
    ``device`` (default: config.device).'''
    dev = config.torch_device() if device is None else torch.device(device)
    tdt = config.torch_dtype(dtype)

    def put(a):
        return torch.as_tensor(numpy.ascontiguousarray(a, dtype=dtype), device=dev).to(tdt)

    import scipy.sparse
    n = int(numpy.prod(form.shape))
    A = scipy.sparse.csr_matrix((numpy.asarray(data, dtype=numpy.float64),
                                 numpy.asarray(indices), numpy.asarray(indptr)),
                                shape=(n, n))
    shapes = [form.shape]
    ops = [A]
    while len(ops) < max_levels:
        flags = _coarsen_flags(shapes[-1], form.periodic, min_coarse)
        if flags is None:
            break
        P = None
        for s, f in zip(shapes[-1], flags):
            P1 = _prolong_1d(s) if f else scipy.sparse.eye(s, format='csr')
            P = P1 if P is None else scipy.sparse.kron(P, P1)
        P = P.tocsr()
        Ac = (P.T @ ops[-1] @ P).tocsr()
        Ac.sum_duplicates()
        shapes.append(tuple((s + 1) // 2 if f else s for s, f in zip(shapes[-1], flags)))
        ops.append(Ac)
    if len(ops) == 1:
        return None
    ws, dinvs, levels = [], [], []
    for shape, Al in zip(shapes[:-1], ops[:-1]):
        fl = _st.from_csr_grid(Al.data, Al.indices, Al.indptr, shape)
        if fl is None:
            return None  # Galerkin operator left the window: bail out
        ws.append(put(fl.w))
        d = Al.diagonal()
        d[d == 0] = 1.0
        dinvs.append(put((1.0 / d).reshape(shape)))
        levels.append((fl.ks, fl.shape, fl.periodic))
    levels.append(((0,) * len(shapes[-1]), shapes[-1], form.periodic))
    coarse_inv = put(numpy.linalg.inv(ops[-1].toarray()))
    return MGData(tuple(ws), tuple(dinvs), coarse_inv, tuple(levels))


# ------------------------------------------------------------ plain versions

def _restrict_1d(f):
    '''Full weighting (P^T of linear interpolation) along axis 0,
    n odd -> (n+1)//2; pure strided slices.'''
    n = f.shape[0]
    fp = torch.nn.functional.pad(f.movedim(0, -1), (1, 1)).movedim(-1, 0)
    return fp[1:n + 1:2] + 0.5 * (fp[0:n:2] + fp[2:n + 2:2])


def restrict_plain(f, cshape):
    '''Full weighting on every coarsened axis (axes whose target size in
    ``cshape`` differs) [*shape] -> [*cshape].'''
    for ax in range(f.ndim):
        if f.shape[ax] != cshape[ax]:
            f = torch.movedim(_restrict_1d(torch.movedim(f, ax, 0)), 0, ax)
    return f


def _interleave_1d(a, n_fine):
    '''Linear interpolation along axis 0 [nc, ...] -> [n_fine, ...];
    stack/reshape interleaving, no scatters.'''
    odd = 0.5 * (a[:-1] + a[1:])
    odd = torch.cat([odd, torch.zeros((1,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)])
    out = torch.stack([a, odd], dim=1).reshape((2 * a.shape[0],) + tuple(a.shape[1:]))
    return out[:n_fine]


def prolong_plain(c, shape):
    '''Linear interpolation [*coarse] -> [*shape] on the coarsened axes.'''
    for ax, nf in enumerate(shape):
        if c.shape[ax] != nf:
            c = torch.movedim(_interleave_1d(torch.movedim(c, ax, 0), nf), 0, ax)
    return c


def jacobi_plain(w, dinv, r, x, ks, shape, periodic, omega, mode):
    '''Plain version of :func:`jacobi_smooth`: mode 0 ``omega dinv r``,
    mode 1 ``x + omega dinv (r - A x)``, mode 2 ``r - A x``.'''
    if mode == 0:
        return omega * dinv * r
    res = r - _st.matvec_plain(w, x, ks, shape, periodic)
    return res if mode == 2 else x + omega * dinv * res


# ------------------------------------------------------------ kernels K2, K3

def jacobi_smooth(w, dinv, r, x, ks, shape, periodic, omega=OMEGA, mode=1, active=None):
    '''One weighted-Jacobi sweep of the V-cycle, fused with its stencil
    matvec (kernel K2, ``csrc/mg.cu``): mode 0 is the first sweep from
    x = 0 (``omega dinv r``, no stencil read; ``x`` is ignored), mode 1 the
    sweep ``x + omega dinv (r - A x)``, mode 2 the residual ``r - A x``.
    Replaces the matvec-then-update of ``nutils_tpu.ops.mg._vcycle_fn``.
    Returns a new tensor, left unwritten while the int32 flag ``active``
    (the CG loop's, ``ops/cg.py``) is 0.'''
    ks = tuple(int(k) for k in ks)
    shape = tuple(int(s) for s in shape)
    periodic = tuple(bool(p) for p in periodic)
    if r.device.type == 'cpu':
        return jacobi_plain(w, dinv, r, x, ks, shape, periodic, omega, mode)
    W = int(numpy.prod([2 * k + 1 for k in ks]))
    x = r if mode == 0 else x
    _kernels.check_operands('jacobi_smooth', r, shape, r.dtype, w=(w, (W,) + shape),
                            dinv=(dinv, shape), xin=(x, shape))
    _kernels.check_flag('jacobi_smooth', active, r)
    out = torch.empty_like(r)
    _kernels.launch('ntt_jacobi', r, [w, dinv, r, x, out, active], shape, ks=ks, periodic=periodic,
                    scalars=(float(omega), int(mode)))
    jacobi_smooth.launches += 1
    return out


_kernels.counted(jacobi_smooth)


def mg_restrict(f, cshape, active=None):
    '''Full-weighting restriction [*shape] -> [*cshape] over the coarsened
    axes (kernel K3, ``csrc/mg.cu``; replaces ``_restrict``/``_restrict_1d``
    of ``nutils_tpu.ops.mg``); does nothing while ``active`` is 0.'''
    cshape = tuple(int(s) for s in cshape)
    if f.device.type == 'cpu':
        return restrict_plain(f, cshape)
    shape = tuple(f.shape)
    _kernels.check_operands('mg_restrict', f, shape, f.dtype)
    _kernels.check_flag('mg_restrict', active, f)
    rc = torch.empty(cshape, dtype=f.dtype, device=f.device)
    _kernels.launch('ntt_restrict', f, [f, rc, active], shape, cshape=cshape)
    mg_restrict.launches += 1
    return rc


_kernels.counted(mg_restrict)


def mg_prolong_add(x, xc, active=None):
    '''x += P xc, linear interpolation over the coarsened axes, in place
    (kernel K3, ``csrc/mg.cu``; replaces ``x + _prolong(xc, shape)`` of
    ``nutils_tpu.ops.mg``); does nothing while ``active`` is 0.  Returns
    ``x``.'''
    if x.device.type == 'cpu':
        x += prolong_plain(xc, tuple(x.shape))
        return x
    shape = tuple(x.shape)
    _kernels.check_operands('mg_prolong_add', x, shape, x.dtype, xc=(xc, tuple(xc.shape)))
    _kernels.check_flag('mg_prolong_add', active, x)
    _kernels.launch('ntt_prolong_add', x, [x, xc, active], shape, cshape=tuple(xc.shape))
    mg_prolong_add.launches += 1
    return x


_kernels.counted(mg_prolong_add)


# ------------------------------------------------------------ V-cycle

def vcycle(levels, mg_ops, r_nd, nu=2, active=None):
    '''V(nu, nu) cycle with weighted-Jacobi smoothing for the static
    ((ks, shape, periodic), ...) level tuple (the coarsest included) on the
    operands ``(ws, dinvs, coarse_inv)``; ``r_nd`` has the finest shape.
    K2 and K3 do nothing while the CG loop's flag ``active`` is 0 (the
    coarsest level's product still runs).'''
    ws, dinvs, coarse_inv = mg_ops
    nlev = len(levels) - 1

    def cycle(level, r):
        if level == nlev:
            cshape = levels[-1][1]
            return (coarse_inv @ r.reshape(-1)).reshape(cshape)
        ks, shape, per = levels[level]
        w, dinv = ws[level], dinvs[level]
        x = jacobi_smooth(w, dinv, r, None, ks, shape, per, mode=0, active=active)
        for _ in range(nu - 1):
            x = jacobi_smooth(w, dinv, r, x, ks, shape, per, active=active)
        rc = mg_restrict(jacobi_smooth(w, dinv, r, x, ks, shape, per, mode=2, active=active),
                         levels[level + 1][1], active)
        x = mg_prolong_add(x, cycle(level + 1, rc), active)
        for _ in range(nu):
            x = jacobi_smooth(w, dinv, r, x, ks, shape, per, active=active)
        return x
    return cycle(0, r_nd)


def apply_vcycle(mg, r):
    '''z = M^-1 r for flat r (used inside the Krylov loop).'''
    shape = mg.levels[0][1]
    return vcycle(mg.levels, (mg.ws, mg.dinvs, mg.coarse_inv), r.reshape(shape)).reshape(-1)
