'''K10: the vector work of the right-preconditioned BiCGStab loop, in Triton.

Replaces the device work of ``nutils_tpu.ops.sparse._bicgstab_driver``'s
body (``sparse.py:550-579``) apart from the two matvecs (K9 or another
operator kernel) and the two preconditioner applies:

* :func:`bicg_dots` — ``a . b`` and optionally ``a . c`` in one pass
  (``rhat . v``; ``t . t`` with ``t . s``; after a true-residual refresh
  ``r . r`` with ``r . rhat``);
* :func:`bicg_s` — ``alpha = rho / rv`` (guarded) and ``s = r - alpha v``;
* :func:`bicg_xr` — ``omega = (t . s) / (t . t)`` (guarded),
  ``x += alpha phat + omega shat`` in place and ``r = s - omega t`` fused
  with ``r . r`` and ``rhat . r``;
* :func:`bicg_p` — ``beta``, ``p = r + beta (p - omega v)`` in place, or on
  a breakdown ``p = r`` and ``rhat = r``, and the next ``rho``.

The loop's scalars live in one small device tensor ``sc`` (slots below);
each kernel reads the ones it needs and the first program writes the one it
forms, so no kernel waits for the host.  ``rho`` has two slots used in
turn, so that :func:`bicg_p` reads the old one while it writes the new one.
The guards compare with ``eps = finfo.tiny * 16``, held in ``sc`` as well.
The JAX iteration forms no ``|s|``, so neither does :func:`bicg_s`.

Bound: device memory; streaming elementwise arithmetic and reductions.
Reductions are two passes (per-block partial sums, then one program per sum
over the partials), so every sum is taken in a fixed order and the
iteration counts do not vary from run to run.  Triton is imported inside the
launching functions: the module imports where Triton is absent, and tensors
on the CPU take the plain versions, which share the kernels' signatures.
'''

import functools

import torch

BLOCK = 1024
RHO = (0, 1)
RV, ALPHA, TT, TS, OMEGA, RR, RHOR, EPS = range(2, 10)
NSLOTS = 10


def scalars(dtype, device):
    '''A fresh ``sc`` with ``eps`` set.'''
    sc = torch.zeros(NSLOTS, dtype=dtype, device=device)
    sc[EPS] = torch.finfo(dtype).tiny * 16
    return sc


@functools.lru_cache(maxsize=None)
def _compiled():
    import triton
    import triton.language as tl

    @triton.jit
    def dots_partial(a_ptr, b_ptr, c_ptr, part_ptr, n, nparts, TWO: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        a = tl.load(a_ptr + offs, mask=m, other=0.0)
        b = tl.load(b_ptr + offs, mask=m, other=0.0)
        tl.store(part_ptr + pid, tl.sum(a * b, axis=0))
        if TWO:
            c = tl.load(c_ptr + offs, mask=m, other=0.0)
            tl.store(part_ptr + nparts + pid, tl.sum(a * c, axis=0))

    @triton.jit
    def sums_to_slots(part_ptr, sc_ptr, nparts, slot0, slot1, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        offs = tl.arange(0, BLOCK)
        base = part_ptr + row * nparts
        acc = tl.load(base + offs, mask=offs < nparts, other=0.0)
        for start in range(BLOCK, nparts, BLOCK):
            o = start + offs
            acc += tl.load(base + o, mask=o < nparts, other=0.0)
        tl.store(sc_ptr + tl.where(row == 0, slot0, slot1), tl.sum(acc, axis=0))

    @triton.jit
    def s_update(r_ptr, v_ptr, sc_ptr, s_ptr, n, rho_slot, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        rho = tl.load(sc_ptr + rho_slot)
        rv = tl.load(sc_ptr + 2)
        eps = tl.load(sc_ptr + 9)
        alpha = rho / tl.where(tl.abs(rv) > eps, rv, 1.0)
        r = tl.load(r_ptr + offs, mask=m, other=0.0)
        v = tl.load(v_ptr + offs, mask=m, other=0.0)
        tl.store(s_ptr + offs, r - alpha * v, mask=m)
        tl.store(sc_ptr + 3, alpha, mask=pid == 0)

    @triton.jit
    def xr_update(x_ptr, r_ptr, ph_ptr, sh_ptr, s_ptr, t_ptr, rh_ptr, sc_ptr, part_ptr, n, nparts,
                  BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        alpha = tl.load(sc_ptr + 3)
        tt = tl.load(sc_ptr + 4)
        ts = tl.load(sc_ptr + 5)
        eps = tl.load(sc_ptr + 9)
        omega = ts / tl.where(tt > eps, tt, 1.0)
        x = tl.load(x_ptr + offs, mask=m, other=0.0)
        ph = tl.load(ph_ptr + offs, mask=m, other=0.0)
        sh = tl.load(sh_ptr + offs, mask=m, other=0.0)
        s = tl.load(s_ptr + offs, mask=m, other=0.0)
        t = tl.load(t_ptr + offs, mask=m, other=0.0)
        rh = tl.load(rh_ptr + offs, mask=m, other=0.0)
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        tl.store(x_ptr + offs, x, mask=m)
        tl.store(r_ptr + offs, r, mask=m)
        tl.store(part_ptr + pid, tl.sum(r * r, axis=0))
        tl.store(part_ptr + nparts + pid, tl.sum(rh * r, axis=0))
        tl.store(sc_ptr + 6, omega, mask=pid == 0)

    @triton.jit
    def p_update(p_ptr, r_ptr, v_ptr, rh_ptr, sc_ptr, n, breakdown, rho_old, rho_new, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        rho = tl.load(sc_ptr + rho_old)
        alpha = tl.load(sc_ptr + 3)
        omega = tl.load(sc_ptr + 6)
        rr = tl.load(sc_ptr + 7)
        rhor = tl.load(sc_ptr + 8)
        eps = tl.load(sc_ptr + 9)
        beta = (rhor / tl.where(tl.abs(rho) > eps, rho, 1.0)) * (alpha / tl.where(tl.abs(omega) > eps, omega, 1.0))
        p = tl.load(p_ptr + offs, mask=m, other=0.0)
        r = tl.load(r_ptr + offs, mask=m, other=0.0)
        v = tl.load(v_ptr + offs, mask=m, other=0.0)
        p = tl.where(breakdown != 0, r, r + beta * (p - omega * v))
        tl.store(p_ptr + offs, p, mask=m)
        tl.store(rh_ptr + offs, r, mask=m & (breakdown != 0))
        tl.store(sc_ptr + rho_new, tl.where(breakdown != 0, rr, rhor), mask=pid == 0)

    return triton, dots_partial, sums_to_slots, s_update, xr_update, p_update


def _check(name, sc, *vectors):
    ref = vectors[0]
    if ref.device.type != 'cuda':
        raise ValueError(f'{name}: expected CUDA tensors, got a tensor on {ref.device}')
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'{name}: dtype {ref.dtype} is not float32 or float64')
    if sc.shape != (NSLOTS,) or not sc.is_contiguous():
        raise ValueError(f'{name}: the scalar slots must be a contiguous tensor of {NSLOTS}')
    for t in (sc,) + vectors:
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f'{name}: operands differ in device or dtype')
    for t in vectors:
        if t.shape != ref.shape or t.ndim != 1 or not t.is_contiguous():
            raise ValueError(f'{name}: vector operands must be contiguous and of equal length')
    if ref.shape[0] >= 2**31:
        raise ValueError(f'{name}: 2^31 entries or more; the kernels index in 32 bits')


# ------------------------------------------------------------ plain versions

def _safe(v, eps, absolute=True):
    return torch.where((v.abs() if absolute else v) > eps, v, torch.ones_like(v))


def dots_plain(a, b, c, sc, slot_b, slot_c=None):
    sc[slot_b] = torch.dot(a, b)
    if c is not None:
        sc[slot_c] = torch.dot(a, c)
    return sc


def s_plain(r, v, sc, s, rho_slot):
    alpha = sc[rho_slot] / _safe(sc[RV], sc[EPS])
    torch.sub(r, alpha * v, out=s)
    sc[ALPHA] = alpha
    return s


def xr_plain(x, r, phat, shat, s, t, rhat, sc):
    omega = sc[TS] / _safe(sc[TT], sc[EPS], absolute=False)
    x.copy_(x + sc[ALPHA] * phat + omega * shat)
    torch.sub(s, omega * t, out=r)
    sc[RR] = torch.dot(r, r)
    sc[RHOR] = torch.dot(rhat, r)
    sc[OMEGA] = omega
    return sc


def p_plain(p, r, v, rhat, sc, breakdown, rho_old, rho_new):
    eps = sc[EPS]
    beta = (sc[RHOR] / _safe(sc[rho_old], eps)) * (sc[ALPHA] / _safe(sc[OMEGA], eps))
    if breakdown:
        p.copy_(r)
        rhat.copy_(r)
        sc[rho_new] = sc[RR]
    else:
        p.copy_(r + beta * (p - sc[OMEGA] * v))
        sc[rho_new] = sc[RHOR]
    return p


# ------------------------------------------------------------ kernels

def bicg_dots(a, b, c, sc, slot_b, slot_c=None):
    '''``sc[slot_b] = a . b`` and, unless ``c`` is None, ``sc[slot_c] =
    a . c``, in one pass with two-pass fixed-order reductions.'''
    if a.device.type == 'cpu':
        return dots_plain(a, b, c, sc, slot_b, slot_c)
    _check('bicg_dots', sc, a, b, *(() if c is None else (c,)))
    triton, dots_partial, sums_to_slots, _s, _xr, _p = _compiled()
    n = a.shape[0]
    two = c is not None
    nparts = triton.cdiv(n, BLOCK)
    part = torch.empty((2 if two else 1, nparts), dtype=a.dtype, device=a.device)
    dots_partial[(nparts,)](a, b, c if two else b, part, n, nparts, TWO=two, BLOCK=BLOCK)
    sums_to_slots[(part.shape[0],)](part, sc, nparts, slot_b, slot_c if two else slot_b, BLOCK=BLOCK)
    bicg_dots.launches += 1
    return sc


bicg_dots.launches = 0


def bicg_s(r, v, sc, s, rho_slot):
    '''``sc[ALPHA] = sc[rho_slot] / rv`` (rv = 1 where ``|rv| <= eps``) and
    ``s = r - alpha v``; returns ``s``.'''
    if r.device.type == 'cpu':
        return s_plain(r, v, sc, s, rho_slot)
    _check('bicg_s', sc, r, v, s)
    triton, _dots, _sums, s_update, _xr, _p = _compiled()
    n = r.shape[0]
    s_update[(triton.cdiv(n, BLOCK),)](r, v, sc, s, n, rho_slot, BLOCK=BLOCK)
    bicg_s.launches += 1
    return s


bicg_s.launches = 0


def bicg_xr(x, r, phat, shat, s, t, rhat, sc):
    '''``sc[OMEGA] = sc[TS] / sc[TT]`` (tt = 1 where ``tt <= eps``),
    ``x += alpha phat + omega shat`` and ``r = s - omega t`` in place, and
    ``sc[RR] = r . r``, ``sc[RHOR] = rhat . r``; returns ``sc``.'''
    if x.device.type == 'cpu':
        return xr_plain(x, r, phat, shat, s, t, rhat, sc)
    _check('bicg_xr', sc, x, r, phat, shat, s, t, rhat)
    triton, _dots, sums_to_slots, _s, xr_update, _p = _compiled()
    n = x.shape[0]
    nparts = triton.cdiv(n, BLOCK)
    part = torch.empty((2, nparts), dtype=x.dtype, device=x.device)
    xr_update[(nparts,)](x, r, phat, shat, s, t, rhat, sc, part, n, nparts, BLOCK=BLOCK)
    sums_to_slots[(2,)](part, sc, nparts, RR, RHOR, BLOCK=BLOCK)
    bicg_xr.launches += 1
    return sc


bicg_xr.launches = 0


def bicg_p(p, r, v, rhat, sc, breakdown, rho_old, rho_new):
    '''``p = r + beta (p - omega v)`` in place with ``beta = (rhor / rho) *
    (alpha / omega)`` (guarded) and ``sc[rho_new] = sc[RHOR]``; on a
    breakdown ``p = r``, ``rhat = r`` and ``sc[rho_new] = sc[RR]``.  Returns
    ``p``.'''
    if p.device.type == 'cpu':
        return p_plain(p, r, v, rhat, sc, breakdown, rho_old, rho_new)
    _check('bicg_p', sc, p, r, v, rhat)
    if rho_old == rho_new:
        raise ValueError('bicg_p: the old and the new rho need slots of their own')
    triton, _dots, _sums, _s, _xr, p_update = _compiled()
    n = p.shape[0]
    p_update[(triton.cdiv(n, BLOCK),)](p, r, v, rhat, sc, n, int(bool(breakdown)), rho_old, rho_new, BLOCK=BLOCK)
    bicg_p.launches += 1
    return p


bicg_p.launches = 0
