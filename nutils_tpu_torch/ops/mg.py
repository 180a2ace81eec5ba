'''Geometric multigrid preconditioner for grid-stencil operators,
dimension-generic (1-D/2-D/3-D grids, any stencil width the stencil matvec
supports).

Float32 Krylov on its own cannot solve large second-order problems; a
geometric V-cycle over the stencil grid makes the preconditioned system O(1)
conditioned.  Setup is matrix-algebraic (copied from ``nutils_tpu.ops.mg``):
coarse operators are Galerkin products A_c = P^T A P, scipy's (or, for a
pattern met before, the same sums from a plan, on the device:
:func:`galerkin`), re-expressed as stencils over the KNOWN coarse grid on
the host; the coarsest level is inverted densely once.

The V(2,2) cycle (:func:`apply_vcycle`) runs on the device through
hand-written kernels: K2 smooths a level in two launches, :func:`jacobi_pre`
(the pre-smoothing sweeps and the residual r - A x) and :func:`jacobi_post`
(the post-smoothing sweeps), each fused with the stencil matvec, on grids
of half-width 1 in the form the level's shape takes (:func:`fused_form`):
``'2d'`` (a 2-D grid: the slice's and the Laplace example's levels),
``'components'`` (a grid (n0, n1, V) of V = 1-3 components, its last axis
not periodic: the finite-strain levels, (721, 721, 2) down to (91, 91, 2))
or ``'box'`` (any other 3-D grid); other levels (half-widths 2, 1-D, 4-D)
take K2's single sweeps, :func:`jacobi_smooth`, one launch a sweep.  K3
:func:`mg_restrict` (full weighting) and :func:`mg_prolong_add` (x += P xc,
linear interpolation) move between levels, tiled where axes 0 and 1
coarsen beside at most a kept axis of components (:func:`transfer_form`),
generic elsewhere, with the same bits; the coarsest level is a plain
``torch.matmul`` with the dense inverse.  Each kernel's plain torch version
(the literal port of ``_vcycle_fn``'s updates, ``_restrict`` and
``_prolong``) runs for tensors on the CPU.
'''

import numpy
import torch

from .. import _kernels
from ..utils import config
from . import stencil as _st

OMEGA = 0.8
# A level's weighted Jacobi sweep x += OMEGA D^-1 (r - A x) converges while
# OMEGA times the largest eigenvalue of D^-1 A stays below 2.  A Laplacian's
# is near 1.5 (2.1 on the coarse levels of a degree-2 one); the couplings of
# a vector field can lift it far past 2.5 (the finite-strain jacobian at
# 720^2: some 8.6, from rows whose off-diagonal sum is several times their
# diagonal), where the sweep amplifies the top modes and the V-cycle stops
# being a preconditioner for CG; so it does where a diagonal entry is not
# positive (compressed elements of a St. Venant-Kirchhoff energy).  On a
# level whose estimate puts OMEGA times it above SMOOTHING_BOUND, or whose
# diagonal is not positive, each row's diagonal is raised to OMEGA /
# SMOOTHING_BOUND times the row's absolute sum where it is below that (l1
# Jacobi on the rows that need it), so that OMEGA times every Gershgorin
# row sum of D^-1 A is at most SMOOTHING_BOUND; the other rows, and other
# levels, keep their bits.  The estimate runs only where the largest of
# those row sums (:func:`gershgorin_bound`, which bounds the eigenvalue
# from above) is past SMOOTHING_BOUND / OMEGA: a Laplacian of degree 1 has
# 2 on every level and keeps its bits without one.
SMOOTHING_BOUND = 1.8
POWER_STEPS = 20
# The coarsest level is inverted densely, on the host (as the JAX package
# does) below DEVICE_INVERSE_MIN unknowns and on the hierarchy's device, in
# float64, from there on: a vector field's grid whose axes stop coarsening
# at an even size keeps thousands of unknowns there (4,232 on the
# finite-strain path at 720^2), whose n^3 inverse takes the host seconds.
DEVICE_INVERSE_MIN = 2048


class MGData:
    '''Per-matrix multigrid hierarchy: stencil weights per level, inverse
    diagonals, the dense coarsest inverse, static per-level
    (ks, shape) metadata, and what each smoothed level's smoother was made
    from (``smoothing``: (shape, Gershgorin bound or None, power-step
    estimate or None, whether diagonals were raised) a level).'''

    __slots__ = ('ws', 'dinvs', 'coarse_inv', 'levels', 'smoothing')

    def __init__(self, ws, dinvs, coarse_inv, levels, smoothing=()):
        self.ws = ws                  # list of [W, *shape] device arrays
        self.dinvs = dinvs            # list of [*shape] device arrays
        self.coarse_inv = coarse_inv  # [nc, nc] dense inverse (device)
        self.levels = levels          # static ((ks, shape, periodic), ...) incl. coarsest
        self.smoothing = smoothing


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
          device=None, plans=None):
    '''Build the hierarchy for a StencilForm (ops/stencil.py) whose CSR
    arrays are given; returns MGData or None when the grid cannot coarsen
    (even pitch or too small).  Host work (scipy Galerkin products, dense
    coarsest inverse); the level operands become tensors of ``dtype`` on
    ``device`` (default: config.device).  ``plans`` (a dict, kept by the
    caller with the matrix's pattern) keeps what depends on the patterns
    alone, the prolongations and each level's stencil plan, for the next
    matrix of that pattern: a level whose Galerkin pattern is the same
    refills its plan with its values, the same form as a fresh inference.'''
    plans = {} if plans is None else plans
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
        P = plans.get(('P', shapes[-1], flags))
        if P is None:
            for s, f in zip(shapes[-1], flags):
                P1 = _prolong_1d(s) if f else scipy.sparse.eye(s, format='csr')
                P = P1 if P is None else scipy.sparse.kron(P, P1)
            P = plans['P', shapes[-1], flags] = P.tocsr()
        Ac = galerkin(plans, len(ops) - 1, ops[-1], P, dev)
        shapes.append(tuple((s + 1) // 2 if f else s for s, f in zip(shapes[-1], flags)))
        ops.append(Ac)
    if len(ops) == 1:
        return None
    ws, dinvs, levels, smoothing = [], [], [], []
    for level, (shape, Al) in enumerate(zip(shapes[:-1], ops[:-1])):
        held = plans.get(('level', level, shape))
        if held is not None and numpy.array_equal(held[0], Al.indptr) and numpy.array_equal(held[1], Al.indices):
            fl = held[2] and _st.StencilForm(_st.refill(held[2][0], shape, *held[2][1:3], Al.data), held[2][0], shape,
                                             *held[2][1:])
        else:
            fl = _st.from_csr_grid(Al.data, Al.indices, Al.indptr, shape)
            plans['level', level, shape] = Al.indptr, Al.indices, fl and (fl.ks, fl.slot, fl.rows, fl.periodic)
        if fl is None:
            return None  # Galerkin operator left the window: bail out
        ws.append(put(fl.w))
        d = Al.diagonal()
        d[d == 0] = 1.0
        dinvs.append(put((1.0 / d).reshape(shape)))
        bound = gershgorin_bound(ws[-1], dinvs[-1])
        lam = None
        if bound is not None and OMEGA * bound > SMOOTHING_BOUND:
            lam = smoothing_estimate(ws[-1], dinvs[-1], fl.ks, shape, fl.periodic)
        raised = bound is None or lam is not None and OMEGA * lam > SMOOTHING_BOUND
        if raised:
            rows = numpy.asarray(abs(Al).sum(axis=1)).ravel()
            dinvs[-1] = put((1.0 / numpy.maximum(d, OMEGA / SMOOTHING_BOUND * rows)).reshape(shape))
        smoothing.append((shape, bound, lam, raised))
        levels.append((fl.ks, fl.shape, fl.periodic))
    levels.append(((0,) * len(shapes[-1]), shapes[-1], form.periodic))
    coarse = ops[-1].toarray()
    if len(coarse) < DEVICE_INVERSE_MIN:
        coarse_inv = put(numpy.linalg.inv(coarse))
    else:
        coarse_inv = torch.linalg.inv(torch.as_tensor(coarse, device=dev)).to(tdt)
    return MGData(tuple(ws), tuple(dinvs), coarse_inv, tuple(levels), tuple(smoothing))


def galerkin(plans, level, A, P, device):
    '''The Galerkin product ``(P.T @ A @ P).tocsr()`` of a level, bit for
    bit scipy's: by scipy where the level meets a pattern of ``A`` for the
    first time; where it met the same pattern before (a fresh jacobian of
    one System), from a plan of scipy's sums (:func:`galerkin_plan`, made
    at the second meeting and kept in ``plans``) whose products and sums
    run on ``device``.  A plan holds index arrays of a few times A's size
    and takes a sort of them, so a hierarchy built once does not make one.
    The planned product keeps
    the entries that come out zero, which scipy drops: the same operator,
    and the same bits wherever it is read.'''
    import scipy.sparse
    key = 'galerkin', level, P.shape
    held = plans.get(key)
    if held is None or not (numpy.array_equal(held[0], A.indptr) and numpy.array_equal(held[1], A.indices)):
        plans[key] = A.indptr, A.indices, None
        Ac = (P.T @ A @ P).tocsr()
        Ac.sum_duplicates()
        return Ac
    plan = held[2]
    if plan is None:
        plan = galerkin_plan(A.indptr, A.indices, P, device)
        plans[key] = A.indptr, A.indices, plan
    at, e_plan, pv, ptv, d_plan, dperm, indptr, indices = plan
    a = torch.as_tensor(numpy.asarray(A.data, dtype=numpy.float64), device=device)
    dt = _pair_values(d_plan, ptv, _pair_values(e_plan, a[at], pv))
    return scipy.sparse.csr_matrix((dt[dperm].cpu().numpy(), indices, indptr), shape=(P.shape[1],) * 2)


def galerkin_plan(indptr, indices, P, device):
    '''The sums of scipy's ``P.T @ A @ P`` for a CSR pattern (``indptr``,
    ``indices``) of A, as :func:`galerkin` reads them, made on ``device``.
    scipy takes ``P.T @ A`` (a CSC matrix times a CSR one) as
    ``csr_matmat`` of A's CSC arrays and P's CSR arrays, which is
    E = A^T P in CSR, and ``E @ P`` (CSC times CSR) as ``csr_matmat`` of
    P's CSC arrays and E, which is P^T E = (P^T A P)^T in CSR; ``tocsr``
    then transposes it.  Each product adds its terms in the order of its
    left operand's row, from 0 (:func:`_pair_plan`).'''
    n, nc = P.shape

    def put(a):
        return torch.as_tensor(numpy.asarray(a, dtype=numpy.int64), device=device)

    def transposed(ptr, idx, ncols):
        # CSR arrays of the transpose, its entries in the order of
        # csr_tocsc's stable counting sort, and that order
        perm = torch.argsort(idx, stable=True)
        tptr = torch.cat([idx.new_zeros(1), torch.cumsum(torch.bincount(idx, minlength=ncols), 0)])
        rows = torch.repeat_interleave(torch.arange(len(ptr) - 1, device=device), ptr[1:] - ptr[:-1])
        return tptr, rows[perm], perm
    atptr, atidx, at = transposed(put(indptr), put(indices), n)
    pptr, pidx = put(P.indptr), put(P.indices)
    e_plan = _pair_plan(atptr, atidx, pptr, pidx, nc)
    ptptr, ptidx, pt = transposed(pptr, pidx, nc)
    d_plan = _pair_plan(ptptr, ptidx, e_plan[0], e_plan[1], nc)
    dptr, drow, dperm = transposed(d_plan[0], d_plan[1], nc)
    pv = torch.as_tensor(numpy.asarray(P.data, dtype=numpy.float64), device=device)
    return at, e_plan, pv, pv[pt], d_plan, dperm, dptr.cpu().numpy(), drow.cpu().numpy()


def _pair_plan(lptr, lidx, rptr, ridx, ncols):
    '''The sums of scipy's ``csr_matmat`` of L and R (CSR index arrays,
    int64 tensors on one device, R with ``ncols`` columns): (indptr,
    indices, groups), the pattern of L R in CSR with sorted columns (every
    product kept) and its products L[q] R[s] in groups (out, q, s) of index
    tensors, group p the products of the p-th entry of each row of L.
    ``csr_matmat`` adds an output's products from 0 in the order of the
    left row's entries, so the groups in order give its sums, and no group
    adds twice into an output.'''
    device = lptr.device
    # every product: entry q of L (row i, column k) times entry s of row k of R
    width = (rptr[1:] - rptr[:-1])[lidx]
    q = torch.repeat_interleave(torch.arange(len(lidx), device=device), width)
    s = torch.arange(len(q), device=device) + torch.repeat_interleave(rptr[lidx] - (torch.cumsum(width, 0) - width),
                                                                      width)
    row = torch.repeat_interleave(torch.arange(len(lptr) - 1, device=device), lptr[1:] - lptr[:-1])
    keys, out = torch.unique(row[q] * ncols + ridx[s], sorted=True, return_inverse=True)
    indptr = torch.cat([keys.new_zeros(1), torch.cumsum(torch.bincount(keys // ncols, minlength=len(lptr) - 1), 0)])
    p = (torch.arange(len(lidx), device=device) - lptr[row])[q]
    order = torch.argsort(p)
    out, q, s = out[order], q[order], s[order]
    bounds = [0, *torch.cumsum(torch.bincount(p), 0).tolist()]
    return indptr, keys % ncols, [(out[lo:hi], q[lo:hi], s[lo:hi]) for lo, hi in zip(bounds[:-1], bounds[1:])]


def _pair_values(plan, lv, rv):
    '''The values of a :func:`_pair_plan` product of the values ``lv``
    (L's, in its order) and ``rv`` (R's).'''
    _indptr, indices, groups = plan
    acc = torch.zeros(len(indices), dtype=lv.dtype, device=lv.device)
    for out, q, s in groups:
        acc[out] += lv[q] * rv[s]
    return acc


def gershgorin_bound(w, dinv):
    '''The largest row sum of |D^-1 A| of a level (stencil ``w``, inverse
    diagonal ``dinv``), which bounds the largest eigenvalue of D^-1 A from
    above; None where D is not positive.  One host read.'''
    bound, positive = torch.stack([(w.abs().sum(0) * dinv).amax(), (dinv > 0).all().to(w.dtype)]).tolist()
    return bound if positive else None


def smoothing_estimate(w, dinv, ks, shape, periodic):
    '''The largest eigenvalue of D^-1 A of a level (stencil ``w``, inverse
    diagonal ``dinv``) as POWER_STEPS power steps from a fixed start
    estimate it: the Rayleigh quotient x.Ax / x.Dx, which lies below it
    (A symmetric, D positive).  None where D is not positive.'''
    if not bool((dinv > 0).all()):
        return None
    x = torch.as_tensor(numpy.random.default_rng(0).standard_normal(shape), dtype=w.dtype, device=w.device)
    for _ in range(POWER_STEPS):
        x = dinv * _st.stencil_matvec(w, x, ks, shape, periodic)
        x = x / torch.linalg.norm(x)
    return float((x * _st.stencil_matvec(w, x, ks, shape, periodic)).sum() / (x * x / dinv).sum())


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


def _pre_sweeps(sweep, nu):
    '''(x, r - A x) of the sweeps a level's pre-smoothing makes, each
    ``sweep(x, mode)``: mode 0, ``nu - 1`` times mode 1, then mode 2.'''
    x = sweep(None, 0)
    for _ in range(nu - 1):
        x = sweep(x, 1)
    return x, sweep(x, 2)


def _post_sweeps(sweep, x, nu):
    '''x after a level's post-smoothing: ``nu`` times ``sweep(x, 1)``.'''
    for _ in range(nu):
        x = sweep(x, 1)
    return x


def jacobi_pre_plain(w, dinv, r, ks, shape, periodic, omega, nu):
    '''Plain version of :func:`jacobi_pre`: the :func:`jacobi_plain` sweeps
    it fuses.'''
    return _pre_sweeps(lambda x, mode: jacobi_plain(w, dinv, r, x, ks, shape, periodic, omega, mode), nu)


def jacobi_post_plain(w, dinv, r, x, ks, shape, periodic, omega, nu):
    '''Plain version of :func:`jacobi_post`: the :func:`jacobi_plain` sweeps
    it fuses.'''
    return _post_sweeps(lambda x, mode: jacobi_plain(w, dinv, r, x, ks, shape, periodic, omega, mode), x, nu)


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

# the sweeps a fused K2 launch may hold (its instantiations in csrc/mg.cu)
FUSED_NU = (1, 2)
# K2's fused forms and their codes in ``ntt_jacobi_fused`` (the 2-D tile and
# the 3-D box: 0, by rank; the component form: 1)
FORM_CODES = {'2d': 0, 'components': 1, 'box': 0}


def fused_form(ks, shape, periodic, nu):
    '''The form in which a level of half-widths ``ks`` on the grid
    ``shape`` smooths (a pure function of the level), through the fused
    sweeps :func:`jacobi_pre` and :func:`jacobi_post` where every
    half-width is 1 and ``nu`` is in :data:`FUSED_NU`: ``'2d'`` on a 2-D
    grid, ``'components'`` on a grid (n0, n1, V) that K1 tiles too (V at
    most 3, its last axis not periodic: a vector field's levels,
    :func:`ops.stencil.matvec_form`), ``'box'`` on any other 3-D grid;
    None where the level smooths through 2 ``nu`` single sweeps.'''
    ks = tuple(int(k) for k in ks)
    if len(ks) not in (2, 3) or any(k != 1 for k in ks) or int(nu) not in FUSED_NU:
        return None
    if len(ks) == 2:
        return '2d'
    return 'components' if _st.matvec_form(ks, shape, periodic) == 'tile' else 'box'


def _fused(name, pre, w, dinv, r, x, ks, shape, periodic, omega, nu, active, form):
    '''Launch the fused K2 kernel (``ntt_jacobi_fused``) in ``form``;
    returns its outputs (x, and the residual where ``pre``).'''
    W = int(numpy.prod([2 * k + 1 for k in ks]))
    named = dict(w=(w, (W,) + shape), dinv=(dinv, shape))
    if not pre:
        named['xin'] = (x, shape)
    _kernels.check_operands(name, r, shape, r.dtype, **named)
    _kernels.check_flag(name, active, r)
    out = torch.empty_like(r)
    res = torch.empty_like(r) if pre else None
    _kernels.launch('ntt_jacobi_fused', r, [w, dinv, r, None if pre else x, out, res, active], shape, ks=ks,
                    periodic=periodic, scalars=(float(omega), int(nu), int(pre), FORM_CODES[form]))
    return (out, res) if pre else out


def _grid(ks, shape, periodic):
    return tuple(int(k) for k in ks), tuple(int(s) for s in shape), tuple(bool(p) for p in periodic)


def jacobi_pre(w, dinv, r, ks, shape, periodic, nu=2, omega=OMEGA, active=None):
    '''A level's pre-smoothing and residual in one launch (kernel K2,
    ``csrc/mg.cu``, in its form for the level, :func:`fused_form`): the
    first sweep from x = 0, ``nu - 1`` sweeps, then ``r - A x``; returns
    (x, residual).  The same bits as those :func:`jacobi_smooth` sweeps
    (modes 0, 1 ... 1, 2), which it replaces where the level has a fused
    form and which run in its place elsewhere.  Outputs are left unwritten
    while ``active`` is 0.  ``jacobi_pre.forms`` counts the launches by
    form.'''
    ks, shape, periodic = _grid(ks, shape, periodic)
    if r.device.type == 'cpu':
        return jacobi_pre_plain(w, dinv, r, ks, shape, periodic, omega, nu)
    form = fused_form(ks, shape, periodic, nu)
    if form is None:
        return _pre_sweeps(lambda x, mode: jacobi_smooth(w, dinv, r, x, ks, shape, periodic, omega, mode, active),
                           nu)
    out = _fused('jacobi_pre', True, w, dinv, r, None, ks, shape, periodic, omega, nu, active, form)
    _kernels.count(jacobi_pre, form)
    return out


_kernels.counted(jacobi_pre, forms=tuple(FORM_CODES))


def jacobi_post(w, dinv, r, x, ks, shape, periodic, nu=2, omega=OMEGA, active=None):
    '''A level's post-smoothing in one launch (kernel K2, ``csrc/mg.cu``,
    in its form for the level, :func:`fused_form`): ``nu`` sweeps from
    ``x``; returns the new x.  The same bits as those :func:`jacobi_smooth`
    sweeps, which it replaces where the level has a fused form and which
    run in its place elsewhere.  The output is left unwritten while
    ``active`` is 0.  ``jacobi_post.forms`` counts the launches by form.'''
    ks, shape, periodic = _grid(ks, shape, periodic)
    if r.device.type == 'cpu':
        return jacobi_post_plain(w, dinv, r, x, ks, shape, periodic, omega, nu)
    form = fused_form(ks, shape, periodic, nu)
    if form is None:
        return _post_sweeps(lambda x, mode: jacobi_smooth(w, dinv, r, x, ks, shape, periodic, omega, mode, active),
                            x, nu)
    out = _fused('jacobi_post', False, w, dinv, r, x, ks, shape, periodic, omega, nu, active, form)
    _kernels.count(jacobi_post, form)
    return out


_kernels.counted(jacobi_post, forms=tuple(FORM_CODES))


# K3's tiled form (``csrc/mg.cu``): components a kept trailing axis may have,
# and the tiles of coarse points a launch's grid may hold along axis 0
# (restrict: 8 or 16 rows a tile; prolong-add: 8)
TILE_COMPONENTS = 3
TILE_ROWS = 8
MAX_GRID_Y = 65535


def transfer_form(shape, cshape):
    '''The form of K3 that moves between the grids ``shape`` and ``cshape``
    (a pure function of the two): ``'tile'`` where axes 0 and 1 coarsen
    (n = 2 nc - 1) and the grid has no other axis, or a trailing one of at
    most :data:`TILE_COMPONENTS` components that is kept (the transfers of
    the Laplace levels and of a vector field's, as ``_coarsen_flags``
    makes them), within the launch grid's rows; ``'generic'`` for every
    other pattern (semi-coarsening beside a periodic or short axis, 3-D and
    4-D grids).'''
    shape, cshape = tuple(int(s) for s in shape), tuple(int(s) for s in cshape)
    if len(shape) != len(cshape) or len(shape) not in (2, 3):
        return 'generic'
    coarsened = all(n == 2 * c - 1 and c >= 2 for n, c in zip(shape[:2], cshape[:2]))
    kept = len(shape) == 2 or shape[2] == cshape[2] and 1 <= shape[2] <= TILE_COMPONENTS
    fits = -(-cshape[0] // TILE_ROWS) <= MAX_GRID_Y
    return 'tile' if coarsened and kept and fits else 'generic'


def _transfer(name, restrict_, fine, coarse_shape, src, out, active):
    '''Launch K3 in its form for the grids (``transfer_form``): restrict
    ``src`` (fine) into ``out`` (coarse), or add the prolongation of
    ``src`` (coarse) into ``out`` (fine) in place.'''
    shape = tuple(fine.shape)
    if transfer_form(shape, coarse_shape) == 'tile':
        if int(numpy.prod(shape)) >= 2**31:
            raise ValueError(f'{name}: grid {shape} has 2^31 points or more: the kernels index in 32 bits')
        V = shape[2] if len(shape) == 3 else 1
        _kernels.call('ntt_transfer_tile', fine, [src, out, active], scalars=(int(restrict_), *shape[:2], V))
    elif restrict_:
        _kernels.launch('ntt_restrict', fine, [src, out, active], shape, cshape=coarse_shape)
    else:
        _kernels.launch('ntt_prolong_add', fine, [out, src, active], shape, cshape=coarse_shape)


def mg_restrict(f, cshape, active=None):
    '''Full-weighting restriction [*shape] -> [*cshape] over the coarsened
    axes (kernel K3, ``csrc/mg.cu``, in its form for the grids,
    :func:`transfer_form`; replaces ``_restrict``/``_restrict_1d`` of
    ``nutils_tpu.ops.mg``); does nothing while ``active`` is 0.'''
    cshape = tuple(int(s) for s in cshape)
    if f.device.type == 'cpu':
        return restrict_plain(f, cshape)
    shape = tuple(f.shape)
    _kernels.check_operands('mg_restrict', f, shape, f.dtype)
    _kernels.check_flag('mg_restrict', active, f)
    rc = torch.empty(cshape, dtype=f.dtype, device=f.device)
    _transfer('mg_restrict', True, f, cshape, f, rc, active)
    mg_restrict.launches += 1
    return rc


_kernels.counted(mg_restrict)


def mg_prolong_add(x, xc, active=None):
    '''x += P xc, linear interpolation over the coarsened axes, in place
    (kernel K3, ``csrc/mg.cu``, in its form for the grids,
    :func:`transfer_form`; replaces ``x + _prolong(xc, shape)`` of
    ``nutils_tpu.ops.mg``); does nothing while ``active`` is 0.  Returns
    ``x``.'''
    if x.device.type == 'cpu':
        x += prolong_plain(xc, tuple(x.shape))
        return x
    shape = tuple(x.shape)
    _kernels.check_operands('mg_prolong_add', x, shape, x.dtype, xc=(xc, tuple(xc.shape)))
    _kernels.check_flag('mg_prolong_add', active, x)
    _transfer('mg_prolong_add', False, x, tuple(xc.shape), xc, x, active)
    mg_prolong_add.launches += 1
    return x


_kernels.counted(mg_prolong_add)


# ------------------------------------------------------------ V-cycle

def vcycle(levels, mg_ops, r_nd, nu=2, active=None):
    '''V(nu, nu) cycle with weighted-Jacobi smoothing for the static
    ((ks, shape, periodic), ...) level tuple (the coarsest included) on the
    operands ``(ws, dinvs, coarse_inv)``; ``r_nd`` has the finest shape.
    Each level smooths in two K2 launches where it has a fused form
    (:func:`fused_form`).
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
        x, res = jacobi_pre(w, dinv, r, ks, shape, per, nu, active=active)
        x = mg_prolong_add(x, cycle(level + 1, mg_restrict(res, levels[level + 1][1], active)), active)
        return jacobi_post(w, dinv, r, x, ks, shape, per, nu, active=active)
    return cycle(0, r_nd)


def apply_vcycle(mg, r):
    '''z = M^-1 r for flat r (used inside the Krylov loop).'''
    shape = mg.levels[0][1]
    return vcycle(mg.levels, (mg.ws, mg.dinvs, mg.coarse_inv), r.reshape(shape)).reshape(-1)
