'''K10: right-preconditioned BiCGStab in CUDA (``csrc/bicgstab.cu``), on a
state buffer in device memory: the vector work, the scalars and every test
of the loop.

Replaces ``nutils_tpu.ops.sparse._bicgstab_driver`` (``sparse.py:531``),
whose ``lax.while_loop`` runs on the device, apart from the three matvecs
(the third, the refresh's, predicated on the state's refresh flag) and the
two preconditioner applies of an iteration:

* :func:`bicg_dots` — ``a . b`` and optionally ``a . c`` in one launch
  (``rhat . v``; ``t . t`` with ``t . s``); ``start``: ``|b|^2`` as rho,
  ``|b|`` and the entry test;
* :func:`bicg_s` — ``alpha = rho / rv`` (guarded) and ``s = r - alpha v``;
* :func:`bicg_xr` — ``omega = ts / tt`` (guarded), ``x += alpha phat +
  omega shat``, ``r = s - omega t`` with ``r . r`` and ``rhat . r``, then
  the claim and the refresh flag (every 64 iterations, or on a claim);
* :func:`bicg_refresh` — where the refresh flag is set, ``r = b - A x``
  with ``r . r`` and ``rhat . r``; then the loop's decisions
  (:func:`decide_plain`): the stall, the breakdown, beta, the next rho,
  ``k + 1`` and the exit test;
* :func:`bicg_p` — ``p = r + beta (p - omega v)`` in place, or on a
  breakdown ``p = r`` and ``rhat = r``.

The state (:func:`new_state`) is one float64 tensor: the slots ATOL ...
RNORM (working-dtype values, widened exactly), int32 slots K ...
BREAKDOWNS of its int32 view (the last three count refreshes, refuted
claims and breakdowns) and, on the card, two partial sums per tile of the
vectors.  Every entry does nothing while the active flag is clear, so the
chunked driver of ``ops/sparse.py`` replays chunks of iterations from CUDA
graphs and reads the state once a chunk.  Sums accumulate in float64 and
are rounded to the working dtype once; the decisions are the working
dtype's, one rounding per operation, in the host loop's order.

Bound: device memory; see ``csrc/bicgstab.cu``.  Each entry keeps a plain
PyTorch version beside it on the same state (numpy for the scalars); tensors
on the CPU take it, a CUDA tensor launches the kernel or raises.
'''

import numpy
import torch

from .. import _kernels
from . import _state

# float64 slots of the state
ATOL, RHO, RV, ALPHA, TT, TS, OMEGA, RR, RHOR, BETA, LASTRES, RNORM = range(12)
HEAD = 20
# int32 slots of its int32 view
K, MAXITER, ACTIVE, NEED, STALL, CLAIMED, BREAKDOWN, TICKET, REFRESHES, REFUTED, BREAKDOWNS = range(24, 35)
REFRESH_EVERY = 64


def new_state(n, dtype, device):
    '''A zeroed state for one solve of ``n`` unknowns on ``device``.'''
    device = torch.device(device)
    parts = 2 * _state.tiles(n, dtype) if device.type == 'cuda' else 0
    return torch.zeros(HEAD + parts, dtype=torch.float64, device=device)


def reset(st, atol, maxiter):
    '''Start a solve: atol, maxiter, the active flag set, every other slot
    0 (one copy to the device, no read).'''
    _state.reset(st, HEAD, {ATOL: atol}, {MAXITER: maxiter, ACTIVE: 1})


def read(st):
    '''One read of the state: dict(k, active, rnorm, refreshes, refuted,
    breakdowns).'''
    head = _state.read(st, HEAD)
    ints = head.view(numpy.int32)
    return dict(k=int(ints[K]), active=bool(ints[ACTIVE]), rnorm=float(head[RNORM]), refreshes=int(ints[REFRESHES]),
                refuted=int(ints[REFUTED]), breakdowns=int(ints[BREAKDOWNS]))


def active_flag(st):
    '''The active flag as a one-element int32 view of the state (the
    matvecs and preconditioners take it as their ``active`` argument).'''
    return st.view(torch.int32)[ACTIVE:ACTIVE + 1]


def need_flag(st):
    '''The refresh flag as a one-element int32 view (the refresh's
    matvec takes it).'''
    return st.view(torch.int32)[NEED:NEED + 1]


# ------------------------------------------------------------ plain versions

def _eps(dt):
    return dt(numpy.finfo(dt).tiny * 16)


def _guard(v, ok):
    return v if ok else type(v)(1)


def start_scalars(s, bb, dt):
    '''The loop's start on the host view ``s`` of the state from ``bb =
    |b|^2`` (``csrc/bicgstab.cu`` dots_kernel): rho, rnorm, lastres and the
    entry test.'''
    ints = s.view(numpy.int32)
    rnorm = numpy.sqrt(dt(bb))
    s[RHO], s[RNORM], s[LASTRES] = bb, rnorm, rnorm
    if not (rnorm > dt(s[ATOL]) and ints[K] < ints[MAXITER]):
        ints[ACTIVE] = 0


def claim_scalars(s, rr, rhor, omega, dt):
    '''``|r|^2``, ``rhat . r`` and omega into the host view ``s``, then the
    claim and the refresh flag (``csrc/bicgstab.cu`` xr_kernel).'''
    ints = s.view(numpy.int32)
    s[RR], s[RHOR], s[OMEGA] = rr, rhor, omega
    # refresh the true residual on a 64-iteration schedule and whenever the
    # recursion claims convergence
    claimed = bool(numpy.sqrt(dt(rr)) <= dt(s[ATOL]))
    ints[CLAIMED] = claimed
    ints[NEED] = claimed or (ints[K] + 1) % REFRESH_EVERY == 0


def _sum(a, b, dt):
    return dt(float(_state.dot(a, b)))


def dots_plain(a, b, c, st, slot_b, slot_c=None, start=False):
    dt = _state.numpy_dtype(a.dtype)
    with _state.host(st) as s:
        if not s.view(numpy.int32)[ACTIVE]:
            return
        ab = _sum(a, b, dt)
        s[slot_b] = ab
        if c is not None:
            s[slot_c] = _sum(a, c, dt)
        if start:
            start_scalars(s, ab, dt)


def s_plain(r, v, st, s_out):
    dt = _state.numpy_dtype(r.dtype)
    with _state.host(st) as s:
        if not s.view(numpy.int32)[ACTIVE]:
            return
        rv = dt(s[RV])
        alpha = dt(s[RHO]) / _guard(rv, abs(rv) > _eps(dt))
        s[ALPHA] = alpha
    torch.sub(r, float(alpha) * v, out=s_out)


def xr_plain(x, r, phat, shat, s_vec, t, rhat, st):
    dt = _state.numpy_dtype(x.dtype)
    with _state.host(st) as s:
        if not s.view(numpy.int32)[ACTIVE]:
            return
        tt = dt(s[TT])
        omega = dt(s[TS]) / _guard(tt, tt > _eps(dt))
        alpha = dt(s[ALPHA])
        x.copy_(x + float(alpha) * phat + float(omega) * shat)
        torch.sub(s_vec, float(omega) * t, out=r)
        claim_scalars(s, _sum(r, r, dt), _sum(rhat, r, dt), omega, dt)


def decide_plain(s, need, dt):
    '''The loop's decisions after the refresh on the host view ``s`` of
    the state (``csrc/bicgstab.cu`` decide): the stall, the breakdown,
    beta, the next rho, ``k + 1`` and the exit test.'''
    ints = s.view(numpy.int32)
    eps = _eps(dt)
    rr = dt(s[RR])
    rnorm = numpy.sqrt(rr)
    if need:
        # stagnating refreshes end the loop
        ints[STALL] = ints[STALL] + 1 if rnorm > dt(0.99) * dt(s[LASTRES]) else 0
        s[LASTRES] = rnorm
    rhor, omega, rho, alpha = dt(s[RHOR]), dt(s[OMEGA]), dt(s[RHO]), dt(s[ALPHA])
    # rho/omega breakdown or refuted convergence: restart the recurrence
    # from the true residual
    breakdown = abs(rhor) <= eps or abs(omega) <= eps or bool(ints[CLAIMED])
    s[BETA] = (rhor / _guard(rho, abs(rho) > eps)) * (alpha / _guard(omega, abs(omega) > eps))
    s[RHO] = rr if breakdown else rhor
    s[RNORM] = rnorm
    ints[BREAKDOWN] = breakdown
    ints[BREAKDOWNS] += breakdown
    ints[REFUTED] += bool(ints[CLAIMED]) and not rnorm <= dt(s[ATOL])
    ints[NEED] = 0
    ints[K] += 1
    if not (rnorm > dt(s[ATOL]) and ints[K] < ints[MAXITER] and ints[STALL] < 4):
        ints[ACTIVE] = 0


def refresh_plain(b, y, r, rhat, st):
    dt = _state.numpy_dtype(b.dtype)
    with _state.host(st) as s:
        ints = s.view(numpy.int32)
        if not ints[ACTIVE]:
            return
        need = bool(ints[NEED])
        if need:
            torch.sub(b, y, out=r)
            s[RR], s[RHOR] = _sum(r, r, dt), _sum(rhat, r, dt)
            ints[REFRESHES] += 1
        decide_plain(s, need, dt)


def p_plain(p, r, v, rhat, st):
    dt = _state.numpy_dtype(p.dtype)
    with _state.host(st) as s:
        ints = s.view(numpy.int32)
        if not ints[ACTIVE]:
            return
        breakdown = bool(ints[BREAKDOWN])
        beta, omega = dt(s[BETA]), dt(s[OMEGA])
    if breakdown:
        p.copy_(r)
        rhat.copy_(r)
    else:
        p.copy_(r + float(beta) * (p - float(omega) * v))


# ------------------------------------------------------------ kernels

def _check(name, st, *vectors):
    ref = vectors[0]
    n = int(ref.shape[0])
    for v in vectors:
        _kernels.check_operands(name, v, (n,), ref.dtype)
    if not 1 <= n < 2**31:
        raise ValueError(f'{name}: {n} entries: the kernels take 1 to 2^31 - 1')
    want = HEAD + 2 * _state.tiles(n, ref.dtype)
    if st.device != ref.device or st.dtype != torch.float64 or st.ndim != 1 or st.shape[0] < want \
            or not st.is_contiguous():
        raise ValueError(f'{name}: the state must be a contiguous float64 tensor of {want} slots on {ref.device} '
                         f'(new_state)')
    return n


@_kernels.counted
def bicg_dots(a, b, c, st, slot_b, slot_c=None, start=False):
    '''``st[slot_b] = a . b`` and, unless ``c`` is None, ``st[slot_c] =
    a . c``: one launch, deterministic; ``start``: rho, rnorm and the entry
    test from ``|b|^2``.'''
    if a.device.type == 'cpu':
        return dots_plain(a, b, c, st, slot_b, slot_c, start)
    n = _check('bicg_dots', st, a, b, *(() if c is None else (c,)))
    _kernels.call('ntt_bicg_dots', a, [a, b, c, st],
                  scalars=(n, int(slot_b), int(slot_b if slot_c is None else slot_c), int(bool(start))))
    bicg_dots.launches += 1


@_kernels.counted
def bicg_s(r, v, st, s):
    '''``alpha = rho / rv`` (rv = 1 where ``|rv| <= eps``) into the state
    and ``s = r - alpha v``.'''
    if r.device.type == 'cpu':
        return s_plain(r, v, st, s)
    n = _check('bicg_s', st, r, v, s)
    _kernels.call('ntt_bicg_s', r, [r, v, s, st], scalars=(n,))
    bicg_s.launches += 1


@_kernels.counted
def bicg_xr(x, r, phat, shat, s, t, rhat, st):
    '''``omega = ts / tt`` (tt = 1 where ``tt <= eps``), ``x += alpha phat
    + omega shat`` and ``r = s - omega t`` in place, ``r . r`` and ``rhat .
    r``; then the claim and the refresh flag.'''
    if x.device.type == 'cpu':
        return xr_plain(x, r, phat, shat, s, t, rhat, st)
    n = _check('bicg_xr', st, x, r, phat, shat, s, t, rhat)
    _kernels.call('ntt_bicg_xr', x, [x, r, phat, shat, s, t, rhat, st], scalars=(n,))
    bicg_xr.launches += 1


@_kernels.counted
def bicg_refresh(b, y, r, rhat, st):
    '''Where the refresh flag is set, ``r = b - y`` (``y = A x`` from the
    matvec predicated on that flag) with ``r . r`` and ``rhat . r``; then
    the loop's decisions (:func:`decide_plain`).'''
    if b.device.type == 'cpu':
        return refresh_plain(b, y, r, rhat, st)
    n = _check('bicg_refresh', st, b, y, r, rhat)
    _kernels.call('ntt_bicg_refresh', b, [b, y, r, rhat, st], scalars=(n,))
    bicg_refresh.launches += 1


@_kernels.counted
def bicg_p(p, r, v, rhat, st):
    '''``p = r + beta (p - omega v)`` in place, or on a breakdown ``p = r``
    and ``rhat = r``.'''
    if p.device.type == 'cpu':
        return p_plain(p, r, v, rhat, st)
    n = _check('bicg_p', st, p, r, v, rhat)
    _kernels.call('ntt_bicg_p', p, [p, r, v, rhat, st], scalars=(n,))
    bicg_p.launches += 1
