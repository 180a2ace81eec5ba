'''K6: the vector work of GMRES's Arnoldi step (CGS2) and of its update, in
Triton.

Replaces the device work of ``nutils_tpu.ops.sparse._gmres_driver``
(``sparse.py:423-482``) apart from the matvec, the preconditioner and the
small Givens/triangular algebra (which the port does on the host):

* :func:`gmres_project` — ``h = V[:j+1] @ w``;
* :func:`gmres_update` — ``w -= h @ V[:j+1]`` in place, returning ``|w|^2``;
* :func:`gmres_normalize` — ``V[j+1] = w / max(|w|, eps)``, or 0 when
  ``|w| <= eps`` (the norm and eps are 0-d device tensors);
* :func:`gmres_combine` — ``x += y @ V[:k]`` in place.

The JAX package multiplies the full ``[m+1, n]`` basis by a mask of the
active rows; the rows above ``j`` are zero there, so reading only the
``j+1`` active rows gives the same values.

Bound: device memory.  Each is a tall-skinny product with at most 101 rows,
or a streaming update with a reduction: no tensor-core tiling and no
shared-memory reuse that Triton's block reductions cannot express.  One CGS2
step reads ``V[:j+1]`` four times, 16 (j+1) n bytes in float32 (about
0.8 GB at j = 50 and n = 983,403).  Each program streams one column block of
``w`` (or ``x``) once and loops over the active rows of ``V``, so ``w`` is
read once per pass, not once per row.  Reductions are two passes
(per-block partial sums, then one program per row over the partials), so
every sum is taken in a fixed order and the iteration counts do not vary
from run to run.  Triton is imported inside the launching functions: the
module imports where Triton is absent, and tensors on the CPU take the plain
versions.
'''

import functools

import torch

BLOCK = 1024


@functools.lru_cache(maxsize=None)
def _compiled():
    import triton
    import triton.language as tl

    @triton.jit
    def project_partial(v_ptr, w_ptr, part_ptr, n, nrows, nparts, stride, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        w = tl.load(w_ptr + offs, mask=m, other=0.0)
        for r in range(0, nrows):
            v = tl.load(v_ptr + r * stride + offs, mask=m, other=0.0)
            tl.store(part_ptr + r * nparts + pid, tl.sum(v * w, axis=0))

    @triton.jit
    def rows_of_partials(part_ptr, out_ptr, nparts, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        offs = tl.arange(0, BLOCK)
        base = part_ptr + row * nparts
        acc = tl.load(base + offs, mask=offs < nparts, other=0.0)
        for start in range(BLOCK, nparts, BLOCK):
            o = start + offs
            acc += tl.load(base + o, mask=o < nparts, other=0.0)
        tl.store(out_ptr + row, tl.sum(acc, axis=0))

    @triton.jit
    def combine_rows(v_ptr, c_ptr, t_ptr, part_ptr, n, nrows, stride, SIGN: tl.constexpr,
                     NORM: tl.constexpr, BLOCK: tl.constexpr):
        # t += SIGN * sum_r c[r] V[r] (the sum formed first, then added)
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        acc = tl.zeros((BLOCK,), dtype=t_ptr.dtype.element_ty)
        for r in range(0, nrows):
            c = tl.load(c_ptr + r)
            v = tl.load(v_ptr + r * stride + offs, mask=m, other=0.0)
            acc += c * v
        t = tl.load(t_ptr + offs, mask=m, other=0.0)
        t = t + SIGN * acc
        tl.store(t_ptr + offs, t, mask=m)
        if NORM:
            tl.store(part_ptr + pid, tl.sum(t * t, axis=0))

    @triton.jit
    def normalize(w_ptr, hn_ptr, eps_ptr, out_ptr, n, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        hn = tl.load(hn_ptr)
        eps = tl.load(eps_ptr)
        w = tl.load(w_ptr + offs, mask=m, other=0.0)
        out = tl.where(hn > eps, w / tl.maximum(hn, eps), 0.0)
        tl.store(out_ptr + offs, out, mask=m)

    return triton, project_partial, rows_of_partials, combine_rows, normalize


def _check(name, V, rows, *vectors):
    if V.device.type != 'cuda':
        raise ValueError(f'{name}: expected CUDA tensors, got a tensor on {V.device}')
    if V.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'{name}: dtype {V.dtype} is not float32 or float64')
    if V.ndim != 2 or V.stride(1) != 1 or not 1 <= rows <= V.shape[0]:
        raise ValueError(f'{name}: V must be [m+1, n] with unit column stride and {rows} rows active')
    for t in vectors:
        if t.device != V.device or t.dtype != V.dtype:
            raise ValueError(f'{name}: operands differ from V in device or dtype')
        if not t.is_contiguous():
            raise ValueError(f'{name}: vector operands must be contiguous')
    if vectors[-1].shape != (V.shape[1],):
        raise ValueError(f'{name}: vector of shape {tuple(vectors[-1].shape)}, expected ({V.shape[1]},)')
    if V.shape[0] * V.stride(0) >= 2**31:
        raise ValueError(f'{name}: the basis has 2^31 entries or more; the kernels index in 32 bits')


# ------------------------------------------------------------ plain versions

def project_plain(V, j, w):
    return V[:j + 1] @ w


def update_plain(V, j, h, w):
    w -= h @ V[:j + 1]
    return torch.dot(w, w)


def normalize_plain(w, hn, eps, out):
    out.copy_(torch.where(hn > eps, w / torch.maximum(hn, eps), torch.zeros_like(w)))
    return out


def combine_plain(V, k, y, x):
    x += y @ V[:k]
    return x


# ------------------------------------------------------------ kernels

def gmres_project(V, j, w):
    '''``V[:j+1] @ w`` as a [j+1] tensor, two-pass fixed-order reduction.'''
    if w.device.type == 'cpu':
        return project_plain(V, j, w)
    _check('gmres_project', V, j + 1, w)
    triton, project_partial, rows_of_partials, _combine, _norm = _compiled()
    n = w.shape[0]
    nparts = triton.cdiv(n, BLOCK)
    part = torch.empty((j + 1, nparts), dtype=w.dtype, device=w.device)
    project_partial[(nparts,)](V, w, part, n, j + 1, nparts, V.stride(0), BLOCK=BLOCK)
    h = torch.empty(j + 1, dtype=w.dtype, device=w.device)
    rows_of_partials[(j + 1,)](part, h, nparts, BLOCK=BLOCK)
    gmres_project.launches += 1
    return h


gmres_project.launches = 0


def gmres_update(V, j, h, w):
    '''``w -= h @ V[:j+1]`` in place; returns ``|w|^2`` (0-d).'''
    if w.device.type == 'cpu':
        return update_plain(V, j, h, w)
    _check('gmres_update', V, j + 1, h, w)
    if h.shape != (j + 1,):
        raise ValueError(f'gmres_update: h has shape {tuple(h.shape)}, expected ({j + 1},)')
    triton, _proj, rows_of_partials, combine_rows, _norm = _compiled()
    n = w.shape[0]
    nparts = triton.cdiv(n, BLOCK)
    part = torch.empty(nparts, dtype=w.dtype, device=w.device)
    combine_rows[(nparts,)](V, h, w, part, n, j + 1, V.stride(0), SIGN=-1.0, NORM=True, BLOCK=BLOCK)
    out = torch.empty(1, dtype=w.dtype, device=w.device)
    rows_of_partials[(1,)](part, out, nparts, BLOCK=BLOCK)
    gmres_update.launches += 1
    return out.reshape(())


gmres_update.launches = 0


def gmres_normalize(w, hn, eps, out):
    '''``out = w / max(hn, eps)`` where ``hn > eps``, else 0 (``hn`` and
    ``eps`` 0-d tensors beside ``w``); returns ``out``.'''
    if w.device.type == 'cpu':
        return normalize_plain(w, hn, eps, out)
    if not (w.device == hn.device == eps.device == out.device and w.dtype == hn.dtype == eps.dtype == out.dtype):
        raise ValueError('gmres_normalize: operands differ in device or dtype')
    if w.device.type != 'cuda' or not (w.is_contiguous() and out.is_contiguous()) or out.shape != w.shape:
        raise ValueError('gmres_normalize: expected contiguous CUDA vectors of one length')
    triton, _proj, _rows, _combine, normalize = _compiled()
    n = w.shape[0]
    normalize[(triton.cdiv(n, BLOCK),)](w, hn, eps, out, n, BLOCK=BLOCK)
    gmres_normalize.launches += 1
    return out


gmres_normalize.launches = 0


def gmres_combine(V, k, y, x):
    '''``x += y @ V[:k]`` in place; returns ``x``.'''
    if x.device.type == 'cpu':
        return combine_plain(V, k, y, x)
    if k == 0:
        return x
    _check('gmres_combine', V, k, y, x)
    if y.shape != (k,):
        raise ValueError(f'gmres_combine: y has shape {tuple(y.shape)}, expected ({k},)')
    triton, _proj, _rows, combine_rows, _norm = _compiled()
    n = x.shape[0]
    nparts = triton.cdiv(n, BLOCK)
    combine_rows[(nparts,)](V, y, x, x, n, k, V.stride(0), SIGN=1.0, NORM=False, BLOCK=BLOCK)
    gmres_combine.launches += 1
    return x


gmres_combine.launches = 0
