'''K6: restarted GMRES(m) with CGS2 in CUDA (``csrc/gmres.cu``), on a state
buffer in device memory: the Arnoldi vector work, the Givens rotations, the
triangular solve and the loop's tests.

Replaces ``nutils_tpu.ops.sparse._gmres_driver`` (``sparse.py:408``), whose
nested ``lax.while_loop``\\ s run on the device, apart from the matvec and
the preconditioner:

* :func:`gmres_project` — ``h = V[:j+1] . w`` into the state's ``h1`` (the
  first CGS2 pass) or ``h2``;
* :func:`gmres_update` — ``w = src - h . V[:j+1]``; on the second pass also
  ``|w|^2``, then the step's scalars (:func:`step_scalars`): the rotations,
  R's column, g, res, ``j + 1`` and the inner test;
* :func:`gmres_normalize` — ``V[j] = w / max(hn, eps)`` (0 where ``hn <=
  eps``) and the same into ``vcur``, the buffer the next step's matvec
  reads; ``first``: ``V[0] = z / max(beta, eps)``;
* :func:`gmres_start` — a cycle's start: ``beta = |z|``, ``rn = |r|``,
  ``inner_tol``, ``g[0]``, ``j = 0`` and the inner flag;
* :func:`gmres_residual` — ``r = b - y`` (``r = b`` where ``y`` is None)
  and ``|r|``, then the stall test, ``it += j`` and the outer test (with
  ``first`` the entry test alone);
* :func:`gmres_solve_combine` — ``R[:j,:j] y = g[:j]`` by back-substitution,
  columns ``j-1`` down to 0, then ``x += y . V[:j]``.

The JAX package multiplies the whole ``[m+1, n]`` basis by a mask of the
active rows; the rows above ``j`` are zero there, so reading only the
``j+1`` active rows gives the same values.  The Arnoldi entries run while
the state's inner flag is set, the cycle's while its outer (active) flag
is: the chunked driver of ``ops/sparse.py`` replays steps and cycle ends
from CUDA graphs and reads the state once a chunk and once a cycle.

The state (:func:`new_state`) is one float64 tensor: the slots ATOL ... RR
(working-dtype values, widened exactly; WW and RR keep the last launch's
sums, from which the scalar functions below replay its decisions), int32
slots J ... CYCLES of its int32 view, then the arrays of :func:`layout`
and, on the card, ``m + 1`` partial sums per row tile of the vectors
(:func:`_state.row_tiles`).  Sums accumulate in float64 and are
rounded to the working dtype once; the scalar work is the working dtype's,
one rounding per operation.  The basis (:func:`basis`) is ``[m+1, ld]``
with rows padded to 16 bytes.

Bound: device memory; see ``csrc/gmres.cu`` for the design.  Each entry
keeps a plain PyTorch version beside it on the same state (numpy for the
scalars); tensors on the CPU take it, a CUDA tensor launches the kernel or
raises.
'''

import numpy
import torch

from .. import _kernels
from . import _state

# float64 slots of the state (WW and RR: the last launch's sums of squares,
# |w|^2 or |z|^2 and |r|^2)
ATOL, BETA, RN, INNER_TOL, RES, RESNORM, HN, WW, RR = range(9)
HEAD = 24
# int32 slots of its int32 view
J, IT, STALL, INNER, ACTIVE, TICKET, MAXITER, CYCLES = range(32, 40)
# csrc/gmres.cu: rows of V a projection block takes, and the largest restart
ROWS = 32
MAX_RESTART = 512


def layout(m):
    '''The state's arrays for restart ``m``: offsets of h1, h2, g (m + 1
    each), cs, sn, y (m each), R (m x m, row-major), the projection's
    tickets (one int32 a group of :data:`ROWS` rows) and the partial
    sums.'''
    h1 = HEAD
    h2 = h1 + m + 1
    g = h2 + m + 1
    cs = g + m + 1
    sn = cs + m
    y = sn + m
    R = y + m
    tickets = R + m * m
    return dict(h1=h1, h2=h2, g=g, cs=cs, sn=sn, y=y, R=R, tickets=tickets, parts=tickets + (m + ROWS) // ROWS)


def _parts(n, m):
    '''Partial sums a state holds on the card: m + 1 per row tile.'''
    return (m + 1) * _state.row_tiles(n)


def new_state(n, m, dtype, device):
    '''A zeroed state for one solve of ``n`` unknowns at restart ``m`` on
    ``device``.'''
    device = torch.device(device)
    m = int(m)
    parts = 0
    if device.type == 'cuda':
        if not 1 <= m <= MAX_RESTART:
            raise ValueError(f'GMRES on the card: restart {m} is outside 1..{MAX_RESTART}')
        parts = _parts(n, m)
    return torch.zeros(layout(m)['parts'] + parts, dtype=torch.float64, device=device)


def basis(n, m, dtype, device):
    '''The Krylov basis ``V`` as an ``[m + 1, n]`` view of rows padded to
    16 bytes.'''
    lanes = 16 // torch.empty((), dtype=dtype).element_size()
    ld = -(-int(n) // lanes) * lanes
    if (m + 1) * ld >= 2**31:
        raise ValueError(f'GMRES basis of {m + 1} x {ld} entries: the kernels index rows in 32 bits')
    return torch.empty((m + 1, ld), dtype=dtype, device=device)[:, :n]


def reset(st, atol, maxiter):
    '''Start a solve: atol, maxiter, the outer flag set, every other slot 0
    (one copy to the device, no read).'''
    _state.reset(st, HEAD, {ATOL: atol}, {MAXITER: maxiter, ACTIVE: 1})


def read(st):
    '''One read of the state: dict(inner, active, it, resnorm).'''
    head = _state.read(st, HEAD)
    ints = head.view(numpy.int32)
    return dict(inner=bool(ints[INNER]), active=bool(ints[ACTIVE]), it=int(ints[IT]), resnorm=float(head[RESNORM]))


def inner_flag(st):
    '''The inner flag as a one-element int32 view of the state (the step's
    matvec and preconditioner take it as their ``active`` argument).'''
    return st.view(torch.int32)[INNER:INNER + 1]


def active_flag(st):
    '''The outer flag as a one-element int32 view of the state (the cycle
    end's matvec and preconditioner take it).'''
    return st.view(torch.int32)[ACTIVE:ACTIVE + 1]


# ------------------------------------------------------------ plain versions

def step_scalars(s, m, ww, dt):
    '''The step's scalar work on the host view ``s`` of the state from
    ``ww = |w|^2``, in the working dtype ``dt`` with numpy's scalars
    (``csrc/gmres.cu`` finish_step): ``hn = sqrt(ww)``, the earlier
    rotations on ``h = h1 + h2``, the new rotation, R's column, g, res,
    ``j + 1`` and the inner test.'''
    ints = s.view(numpy.int32)
    L = layout(m)
    j = int(ints[J])
    eps = dt(numpy.finfo(dt).tiny * 16)
    s[WW] = ww
    hn = numpy.sqrt(dt(ww))
    h = list(s[L['h1']:L['h1'] + j + 1].astype(dt) + s[L['h2']:L['h2'] + j + 1].astype(dt)) + [hn]  # j + 2 values
    cs, sn = s[L['cs']:L['cs'] + j].astype(dt), s[L['sn']:L['sn'] + j].astype(dt)
    for i in range(j):  # the earlier rotations
        t = cs[i] * h[i] + sn[i] * h[i + 1]
        h[i + 1] = -sn[i] * h[i] + cs[i] * h[i + 1]
        h[i] = t
    # the new rotation annihilating h[j+1]
    denom = numpy.sqrt(h[j] * h[j] + h[j + 1] * h[j + 1])
    safe = eps if eps > denom else denom
    c, sj = h[j] / safe, h[j + 1] / safe
    s[L['cs'] + j], s[L['sn'] + j] = c, sj
    h[j] = denom
    s[L['R'] + numpy.arange(j + 1) * m + j] = h[:j + 1]
    gj = dt(s[L['g'] + j])
    gn = -sj * gj
    s[L['g'] + j + 1], s[L['g'] + j] = gn, c * gj
    res = abs(gn)
    s[RES], s[HN] = res, hn
    ints[J] = j + 1
    if not (j + 1 < m and res > dt(s[INNER_TOL])):
        ints[INNER] = 0


def start_scalars(s, m, zz, rr, dt):
    '''A cycle's start on the host view ``s`` from ``zz = |z|^2`` and ``rr =
    |r|^2`` (``csrc/gmres.cu`` start_kernel): beta, rn, inner_tol, g[0],
    res, ``j = 0`` and the inner flag.'''
    ints = s.view(numpy.int32)
    eps = dt(numpy.finfo(dt).tiny * 16)
    s[WW], s[RR] = zz, rr
    beta, rn = numpy.sqrt(dt(zz)), numpy.sqrt(dt(rr))
    beta_safe = eps if eps > beta else beta
    rn_safe = eps if eps > rn else rn
    # the true-residual tolerance in the preconditioned scale
    inner_tol = dt(0.25) * dt(s[ATOL]) * beta_safe / rn_safe
    s[BETA], s[RN], s[INNER_TOL], s[RES], s[layout(m)['g']] = beta, rn, inner_tol, beta, beta
    ints[J] = 0
    ints[INNER] = int(0 < m and beta > inner_tol)


def residual_scalars(s, rr, first, dt):
    '''The true residual's tests on the host view ``s`` from ``rr = |r|^2``
    (``csrc/gmres.cu`` residual_kernel): resnorm, and unless ``first`` the
    stall test, ``it += j`` and the cycle count; then the outer test.'''
    ints = s.view(numpy.int32)
    s[RR] = rr
    resnorm = numpy.sqrt(dt(rr))
    if not first:
        # restart cycles that stop reducing the true residual: stalled
        ints[STALL] = ints[STALL] + 1 if resnorm > dt(0.999) * dt(s[RESNORM]) else 0
        ints[IT] += ints[J]
        ints[CYCLES] += 1
    s[RESNORM] = resnorm
    if not (resnorm > dt(s[ATOL]) and ints[IT] < ints[MAXITER] and ints[STALL] < 5):
        ints[ACTIVE] = ints[INNER] = 0


def back_substitute(s, m, dt):
    '''``R[:j,:j] y = g[:j]`` on the host view ``s`` of the state, columns
    ``j-1`` down to 0 (``csrc/gmres.cu`` solve_kernel's order); returns y
    in ``dt``.'''
    j = int(s.view(numpy.int32)[J])
    L = layout(m)
    R = s[L['R']:L['R'] + m * m].reshape(m, m).astype(dt)
    rest = s[L['g']:L['g'] + j].astype(dt)
    y = numpy.zeros(j, dtype=dt)
    for k in range(j - 1, -1, -1):
        y[k] = rest[k] / R[k, k]
        rest[:k] = rest[:k] - R[:k, k] * y[k]
    s[L['y']:L['y'] + j] = y
    return y


def _sum(a, b):
    return float(_state.dot(a, b))


def project_plain(V, w, st, second=False):
    m = V.shape[0] - 1
    with _state.host(st) as s:
        ints = s.view(numpy.int32)
        if not ints[INNER]:
            return
        j = int(ints[J])
        h = (V[:j + 1].double() @ w.double()).to(w.dtype).double().cpu().numpy()
        at = layout(m)['h2' if second else 'h1']
        s[at:at + j + 1] = h


def update_plain(V, src, w, st, second=False):
    m = V.shape[0] - 1
    with _state.host(st) as s:
        ints = s.view(numpy.int32)
        if not ints[INNER]:
            return
        j = int(ints[J])
        at = layout(m)['h2' if second else 'h1']
        h = torch.as_tensor(s[at:at + j + 1], device=w.device).to(w.dtype)
        torch.sub(src, h @ V[:j + 1], out=w)
        if second:
            step_scalars(s, m, _sum(w, w), _state.numpy_dtype(w.dtype))


def normalize_plain(w, V, vcur, st, first=False):
    dt = _state.numpy_dtype(w.dtype)
    with _state.host(st) as s:
        ints = s.view(numpy.int32)
        if not ints[INNER]:
            return
        j = 0 if first else int(ints[J])
        hn = dt(s[BETA if first else HN])
    eps = dt(numpy.finfo(dt).tiny * 16)
    d = torch.tensor(eps if eps > hn else hn, dtype=w.dtype, device=w.device)
    out = torch.zeros_like(w) if not first and not hn > eps else w / d
    V[j].copy_(out)
    vcur.copy_(out)


def start_plain(z, r, st, m):
    with _state.host(st) as s:
        if s.view(numpy.int32)[ACTIVE]:
            start_scalars(s, m, _sum(z, z), _sum(r, r), _state.numpy_dtype(z.dtype))


def residual_plain(b, y, r, st, m, first=False):
    with _state.host(st) as s:
        if not s.view(numpy.int32)[ACTIVE]:
            return
        if y is None:
            r.copy_(b)
        else:
            torch.sub(b, y, out=r)
        residual_scalars(s, _sum(r, r), first, _state.numpy_dtype(b.dtype))


def solve_combine_plain(V, x, st):
    m = V.shape[0] - 1
    with _state.host(st) as s:
        if not s.view(numpy.int32)[ACTIVE]:
            return
        y = back_substitute(s, m, _state.numpy_dtype(x.dtype))
    if len(y):
        x += torch.as_tensor(y, device=x.device) @ V[:len(y)]


# ------------------------------------------------------------ kernels

def _check(name, V, *vectors):
    '''(n, m, the basis' row stride) after the checks of a K6 launch.'''
    ref = vectors[0]
    n = int(ref.shape[0])
    for v in vectors:
        _kernels.check_operands(name, v, (n,), ref.dtype)
    if n < 1:
        raise ValueError(f'{name}: vectors of no entries')
    m = None
    ld = 0
    if V is not None:
        m = V.shape[0] - 1
        if V.device != ref.device or V.dtype != ref.dtype or V.ndim != 2 or V.shape[1] != n or V.stride(1) != 1:
            raise ValueError(f'{name}: V must be a [m + 1, {n}] basis of unit column stride beside the vectors')
        ld = V.stride(0)
        if (m + 1) * ld >= 2**31:
            raise ValueError(f'{name}: the basis has 2^31 entries or more')
    return n, m, ld


def _check_state(name, st, n, m, dtype, device):
    want = layout(m)['parts'] + _parts(n, m)
    if st.device != device or st.dtype != torch.float64 or st.ndim != 1 or st.shape[0] < want \
            or not st.is_contiguous():
        raise ValueError(f'{name}: the state must be a contiguous float64 tensor of {want} slots on {device} '
                         f'(new_state)')


@_kernels.counted
def gmres_project(V, w, st, second=False):
    '''``h = V[:j+1] . w`` into the state's h2 (``second``) or h1: one
    launch, deterministic.'''
    if w.device.type == 'cpu':
        return project_plain(V, w, st, second)
    n, m, ld = _check('gmres_project', V, w)
    _check_state('gmres_project', st, n, m, w.dtype, w.device)
    _kernels.call('ntt_gmres_project', w, [V, w, st], scalars=(ld, n, m, int(bool(second))))
    gmres_project.launches += 1


@_kernels.counted
def gmres_update(V, src, w, st, second=False):
    '''``w = src - h . V[:j+1]`` (``w`` may be ``src``); on the second
    pass also the step's scalars (see the module).'''
    if w.device.type == 'cpu':
        return update_plain(V, src, w, st, second)
    n, m, ld = _check('gmres_update', V, w, src)
    _check_state('gmres_update', st, n, m, w.dtype, w.device)
    _kernels.call('ntt_gmres_update', w, [V, src, w, st], scalars=(ld, n, m, int(bool(second))))
    gmres_update.launches += 1


@_kernels.counted
def gmres_normalize(w, V, vcur, st, first=False):
    '''``V[j] = vcur = w / max(hn, eps)``, or 0 where ``hn <= eps``;
    ``first``: ``V[0] = vcur = w / max(beta, eps)``.'''
    if w.device.type == 'cpu':
        return normalize_plain(w, V, vcur, st, first)
    n, m, ld = _check('gmres_normalize', V, w, vcur)
    _check_state('gmres_normalize', st, n, m, w.dtype, w.device)
    _kernels.call('ntt_gmres_normalize', w, [w, V, vcur, st], scalars=(ld, n, int(bool(first))))
    gmres_normalize.launches += 1


@_kernels.counted
def gmres_start(z, r, st, m):
    '''A cycle's start from ``z = M r``: beta, rn, inner_tol, g[0], j = 0
    and the inner flag.'''
    if z.device.type == 'cpu':
        return start_plain(z, r, st, m)
    n, _m, _ld = _check('gmres_start', None, z, r)
    _check_state('gmres_start', st, n, m, z.dtype, z.device)
    _kernels.call('ntt_gmres_start', z, [z, r, st], scalars=(n, int(m)))
    gmres_start.launches += 1


@_kernels.counted
def gmres_residual(b, y, r, st, m, first=False):
    '''``r = b - y`` (``r = b`` where ``y`` is None) and ``|r|``, then the
    stall test, ``it += j`` and the outer test; ``first``: the entry test
    alone.'''
    if b.device.type == 'cpu':
        return residual_plain(b, y, r, st, m, first)
    n, _m, _ld = _check('gmres_residual', None, b, r, *(() if y is None else (y,)))
    _check_state('gmres_residual', st, n, m, b.dtype, b.device)
    _kernels.call('ntt_gmres_residual', b, [b, y, r, st], scalars=(n, int(m), int(bool(first))))
    gmres_residual.launches += 1


@_kernels.counted
def gmres_solve_combine(V, x, st):
    '''``R[:j,:j] y = g[:j]`` (one block, fixed order), then ``x += y .
    V[:j]``; nothing where j = 0.'''
    if x.device.type == 'cpu':
        return solve_combine_plain(V, x, st)
    n, m, ld = _check('gmres_solve_combine', V, x)
    _check_state('gmres_solve_combine', st, n, m, x.dtype, x.device)
    _kernels.call('ntt_gmres_solve_combine', x, [V, x, st], scalars=(ld, n, m))
    gmres_solve_combine.launches += 1
