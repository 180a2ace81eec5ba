'''K4: the vector work of the preconditioned CG loop and the loop's
decisions, in CUDA (``csrc/cg.cu``), on a small state buffer in device
memory.

Replaces the device work of ``nutils_tpu.ops.sparse._cg_driver``'s body
(``sparse.py:330-364``) apart from the matvec and the preconditioner, and
the tests of its ``lax.while_loop``:

* :func:`cg_dot` — ``a . b`` into a state slot (``p . Ap``, ``r . z``, the
  refreshed ``|r|^2``); into :data:`RR0` it also takes the loop's entry test;
* :func:`cg_step` — ``alpha = rz / pAp``; ``x += alpha p``; ``r -= alpha Ap``
  in place; ``rr = |r|^2`` of the recursive residual; ``rz_old = rz``; then
  the convergence claim (``sqrt(max(rr, 0)) <= atol`` in float64), the
  64-iteration refresh schedule and the iteration cap, any of which clears
  the active flag and records why;
* :func:`cg_xpby` — ``beta = rz / rz_old`` (0 after a claimed refresh);
  ``p = z + beta p`` in place.

The state (:func:`new_state`) is one float64 tensor: the slots ATOL ... RR0
(all but ATOL hold working-dtype values, widened exactly; the sums
accumulate in float64 and are rounded to the working dtype), int32 slots
K ... TICKET of its int32 view, and one partial sum per block of the
kernels' grid from slot HEAD on.  The dot of ``r . z`` writes the new rz
over the old one, which the step has saved in RZOLD.  Every entry does nothing while the
active flag is clear, so a loop may enqueue iterations past its exit: the
chunked driver of ``ops/sparse.py`` replays chunks of iterations from CUDA
graphs and reads the state once a chunk.

Bound: device memory; see ``csrc/cg.cu`` for the design.  Each entry keeps a
plain PyTorch version beside it on the same state (``torch.where`` on the
flag); tensors on the CPU take it, a CUDA tensor launches the kernel or
raises.
'''

import functools
import math

import numpy
import torch

from .. import _kernels

# float64 slots of the state
ATOL, RZ, PAP, RR, RZOLD, RR0 = range(6)
HEAD = 16  # slots before the per-block partial sums
# int32 slots of its int32 view
K, MAXITER, ACTIVE, REASON, TICKET = 12, 13, 14, 15, 16
# why the active flag fell
RUNNING, CLAIMED, SCHEDULED, CAPPED, START = range(5)
REFRESH_EVERY = 64
# blocks of 256 threads a streaming multiprocessor in every K4 launch, or as
# many as fit (chosen on the card, PERF.md)
BLOCKS_PER_SM = 3


@functools.lru_cache(maxsize=None)
def grid(device_index, per_sm=BLOCKS_PER_SM):
    '''Blocks of every K4 launch on the card: its SM count times
    ``per_sm``, or times the blocks of the least occupant kernel that fit on
    one SM if fewer.'''
    with torch.cuda.device(device_index):
        g = _kernels.library().ntt_cg_grid(int(per_sm))
    if g <= 0:
        raise RuntimeError(f'ntt_cg_grid failed with code {g}')
    return g


def new_state(device):
    '''A zeroed state for one solve on ``device``.'''
    device = torch.device(device)
    parts = grid(torch.cuda.current_device() if device.index is None else device.index) \
        if device.type == 'cuda' else 0
    return torch.zeros(HEAD + parts, dtype=torch.float64, device=device)


def reset(st, atol, maxiter):
    '''Start a solve: atol, maxiter, k = 0, active, no reason, and every
    scalar 0.  A copy to the device (from pinned memory on the card), no
    read.'''
    head = numpy.zeros(HEAD)
    head[ATOL] = atol
    ints = head.view(numpy.int32)
    ints[MAXITER] = maxiter
    ints[ACTIVE] = 1
    src = torch.from_numpy(head)
    if st.device.type == 'cuda':
        st[:HEAD].copy_(src.pin_memory(), non_blocking=True)
    else:
        st[:HEAD].copy_(src)


def read(st):
    '''One read of the state: (k, reason, rr, rr0); from the card through
    pinned memory.'''
    if st.device.type == 'cuda':
        head = torch.empty(HEAD, dtype=torch.float64, pin_memory=True)
        head.copy_(st[:HEAD], non_blocking=True)
        torch.cuda.current_stream(st.device).synchronize()
        head = head.numpy()
    else:
        head = st[:HEAD].numpy()
    ints = head.view(numpy.int32)
    return int(ints[K]), int(ints[REASON]), float(head[RR]), float(head[RR0])


def active_flag(st):
    '''The active flag as a one-element int32 view of the state (K1-K3 take
    it as their ``active`` argument).'''
    return st.view(torch.int32)[ACTIVE:ACTIVE + 1]


def norm(rr):
    '''The loop's norm of a squared norm read from the state:
    ``sqrt(max(rr, 0.0))`` (a NaN stays a NaN).'''
    return math.sqrt(max(rr, 0.0))


# ------------------------------------------------------------ plain versions

def _norm_t(rr):
    return torch.sqrt(torch.where(rr < 0, torch.zeros_like(rr), rr))


def _dot(a, b):
    '''``a . b`` summed in float64 and rounded to the working dtype, as the
    kernels sum; widened back for the state.'''
    return torch.dot(a.double(), b.double()).to(a.dtype).double()


def dot_plain(a, b, st, slot, start=False):
    ints = st.view(torch.int32)
    act = ints[ACTIVE] != 0
    total = _dot(a, b)
    st[slot] = torch.where(act, total, st[slot])
    if start:
        stop = act & ~((_norm_t(total) > st[ATOL]) & (ints[K] < ints[MAXITER]))
        ints[REASON] = torch.where(stop, START, ints[REASON])
        ints[ACTIVE] = torch.where(stop, 0, ints[ACTIVE])


def step_plain(x, r, p, ap, st):
    ints = st.view(torch.int32)
    act = ints[ACTIVE] != 0
    alpha = st[RZ].to(x.dtype) / st[PAP].to(x.dtype)
    x.copy_(torch.where(act, x + alpha * p, x))
    r.copy_(torch.where(act, r - alpha * ap, r))
    rr = _dot(r, r)
    claimed = _norm_t(rr) <= st[ATOL]
    k = ints[K] + 1
    need = claimed | (k % REFRESH_EVERY == 0)
    stop = need | (k >= ints[MAXITER])
    reason = torch.where(~stop, RUNNING, torch.where(claimed, CLAIMED, torch.where(need, SCHEDULED, CAPPED)))
    st[RR] = torch.where(act, rr, st[RR])
    st[RZOLD] = torch.where(act, st[RZ], st[RZOLD])
    ints[K] = torch.where(act, k, ints[K])
    ints[REASON] = torch.where(act, reason.to(torch.int32), ints[REASON])
    ints[ACTIVE] = torch.where(act & stop, 0, ints[ACTIVE])


def xpby_plain(p, z, st):
    ints = st.view(torch.int32)
    act = ints[ACTIVE] != 0
    beta = torch.where(ints[REASON] == CLAIMED, torch.zeros((), dtype=p.dtype, device=p.device),
                       st[RZ].to(p.dtype) / st[RZOLD].to(p.dtype))
    p.copy_(torch.where(act, z + beta * p, p))


# ------------------------------------------------------------ kernels

def _check(name, st, *vectors):
    ref = vectors[0]
    n = ref.shape[0]
    for v in vectors:
        _kernels.check_operands(name, v, (n,), ref.dtype)
    if n >= 2**31:
        raise ValueError(f'{name}: vectors of 2^31 elements or more: the kernels index in 32 bits')
    g = grid(ref.device.index)
    if st.device != ref.device or st.dtype != torch.float64 or st.ndim != 1 or st.shape[0] < HEAD + g \
            or not st.is_contiguous():
        raise ValueError(f'{name}: the state must be a contiguous float64 tensor of {HEAD + g} slots on '
                         f'{ref.device} (new_state)')
    return n, g


@_kernels.counted
def cg_dot(a, b, st, slot, start=False):
    '''``st[slot] = a . b`` (one launch, deterministic); with ``start`` also
    the loop's entry test ``sqrt(max(a . b, 0)) > atol and k < maxiter``,
    whose failure clears the flag with reason :data:`START`.'''
    if a.device.type == 'cpu':
        return dot_plain(a, b, st, slot, start)
    n, g = _check('cg_dot', st, a, b)
    _kernels.call('ntt_cg_dot', a, [a, b, st], scalars=(n, g, int(slot), int(bool(start))))
    cg_dot.launches += 1


@_kernels.counted
def cg_step(x, r, p, ap, st):
    '''``alpha = rz / pAp``; ``x += alpha p``; ``r -= alpha ap`` in place;
    ``rr = |r|^2``; ``rz_old = rz``; then the loop's decisions (see the
    module).'''
    if x.device.type == 'cpu':
        return step_plain(x, r, p, ap, st)
    n, g = _check('cg_step', st, x, r, p, ap)
    _kernels.call('ntt_cg_step', x, [x, r, p, ap, st], scalars=(n, g))
    cg_step.launches += 1


@_kernels.counted
def cg_xpby(p, z, st):
    '''``p = z + beta p`` in place with ``beta = rz / rz_old``, or 0 after
    a claimed refresh.'''
    if p.device.type == 'cpu':
        return xpby_plain(p, z, st)
    n, g = _check('cg_xpby', st, p, z)
    _kernels.call('ntt_cg_xpby', p, [p, z, st], scalars=(n, g))
    cg_xpby.launches += 1
