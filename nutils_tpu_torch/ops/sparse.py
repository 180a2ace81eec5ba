'''Device Krylov solvers with float64 iterative refinement: preconditioned
CG, left-preconditioned restarted GMRES(m) and right-preconditioned
BiCGStab, the unstructured (CSR) operator, the CSR value scatter of
assembly, and the Schur-aware inverse diagonal.

The CG, GMRES and BiCGStab parts of ``nutils_tpu.ops.sparse`` with their
exact semantics.  The JAX package runs the loops as ``lax.while_loop``; here
the loops' decisions run on the device too, and the host reads their state
between chunks of iterations.

* CG: a true-residual refresh every 64 iterations and whenever the recursion
  claims convergence, a stall exit after four refreshes without 1%
  progress, and a direction restart (beta = 0) after a refuted claim.  The
  vector work, the scalars and the per-iteration tests run on the device on
  a small state (kernel K4, ``ops/cg.py``), which stops itself at a claim,
  a scheduled refresh or the iteration cap; the host reads the state once
  a chunk of iterations, runs the refresh and decides the stall and the
  exit.  On the card the chunks replay from CUDA graphs (:data:`CG_CHUNK`
  iterations each); the host loop (one iteration a read) is the plain
  driver, the CPU's, and on the card the reference the graphs are held
  against.
* GMRES: CGS2 orthogonalization, Givens rotations, a triangular solve, true-
  residual restarts and a stall exit after five restarts without 0.1%
  progress.  The Arnoldi vector work, the rotations, the solve and the
  tests run on the device on a state (kernel K6, ``ops/gmres.py``) whose
  inner flag stops the Arnoldi steps and whose outer flag stops the
  cycles; the host reads it once a chunk of steps and once a cycle end.
* BiCGStab: two matvecs and two preconditioner applies an iteration, the
  CG driver's refresh and stall discipline, and a restart of the recurrence
  from the true residual on a rho or omega breakdown or a refuted claim.
  The vector work, the scalars, the refresh (its matvec predicated on the
  state's refresh flag) and every test run on the device on a state
  (kernel K10, ``ops/bicgstab.py``); the host reads it once a chunk.
* On the card the three loops replay CUDA graphs (a start, a chunk of
  iterations or steps, and CG's refresh or GMRES's cycle end); the host
  loop (one iteration a read) is the plain driver, the CPU's, and on the
  card the reference the graphs are held against.
* The Schur-aware inverse diagonal is kernel K7 (``csrc/schur.cu``,
  :func:`schur_diag_inverse_device`).

Operators: the stencil matvec K1 (``ops/stencil.py``), the block-grid
matvec K5 (``ops/blockgrid.py``), the CSR matvec K9 (``csrc/csr_spmv.cu``,
:func:`csr_matvec`, on a row-block plan kept with the operand), and any of
them masked, ``('masked', kind)``: ``m A(m x) + (1 - m) x`` through the two
passes of kernel K14 (``csrc/masked.cu``, :func:`mask_pre`,
:func:`mask_post`).  Preconditioners: ``diag``, ``block`` (kernel K13,
``ops/precon.py``), ``('mg', levels)`` (kernels K2 and K3, ``ops/mg.py``)
and ``('fieldsplit', offsets, subkinds)``.  The CSR value scatter of
assembly is kernel K8 (``csrc/csr_scatter.cu``, :func:`csr_scatter`).
'''

import collections
import math
import time

import numpy
import torch

from .. import _kernels
from . import blockgrid as _bg
from . import cg as _cg
from . import _state
from . import mg as _mg
from . import precon as _precon
from . import stencil as _st
from . import bicgstab as _bi
from . import gmres as _gm


def schur_diag_inverse(data, indices, indptr, n, weak_rel=1e-3):
    '''Host: Schur-aware inverse-diagonal scaling for general CSR systems
    (copied from ``nutils_tpu.ops.sparse``).  Rows with a healthy diagonal
    get plain Jacobi ``1/d_i``; rows whose diagonal is negligible against
    the row norm get the inverse of ``s_i = sum_k A_ik^2 / |d_k|`` over the
    columns with a healthy diagonal.'''
    data = numpy.asarray(data, dtype=numpy.float64)
    indices = numpy.asarray(indices)
    counts = numpy.diff(indptr)
    rows = numpy.repeat(numpy.arange(n), counts)
    d = numpy.zeros(n, dtype=data.dtype)
    isdiag = indices == rows
    d[rows[isdiag]] = data[isdiag]
    sq = data * data
    rownorm2 = numpy.zeros(n, dtype=data.dtype)
    numpy.add.at(rownorm2, rows, sq)
    strong = numpy.abs(d) > weak_rel * numpy.sqrt(rownorm2)
    dsafe = numpy.where(strong, numpy.abs(d), 1.0)
    schur = numpy.zeros(n, dtype=data.dtype)
    numpy.add.at(schur, rows, sq / dsafe[indices])
    minv = numpy.where(strong, numpy.divide(1.0, numpy.where(strong, d, 1.0)),
                       numpy.where(schur > 0, numpy.divide(1.0, numpy.where(schur > 0, schur, 1.0)), 1.0))
    return minv


def schur_diag_plain(w, csr_map, indices, indptr, n, weak_rel=1e-3):
    '''Plain torch version of :func:`schur_diag_inverse_device`: the segment
    sums of ``nutils_tpu.ops.sparse._schur_diag_kernel`` over the CSR values
    ``w[csr_map]``, or ``w`` itself where ``csr_map`` is None.'''
    data = w if csr_map is None else w[csr_map.long()]
    idx = indices.long()
    rows = torch.repeat_interleave(torch.arange(n, device=w.device), torch.diff(indptr.long()),
                                   output_size=idx.shape[0])
    sq = data * data
    zero = torch.zeros(n, dtype=w.dtype, device=w.device)
    d = zero.index_add(0, rows, torch.where(idx == rows, data, torch.zeros_like(data)))
    rownorm2 = zero.index_add(0, rows, sq)
    strong = d.abs() > weak_rel * torch.sqrt(rownorm2)
    one = torch.ones((), dtype=w.dtype, device=w.device)
    dsafe = torch.where(strong, d.abs(), one)
    schur = zero.index_add(0, rows, sq / dsafe[idx])
    return torch.where(strong, 1.0 / torch.where(strong, d, one),
                       torch.where(schur > 0, 1.0 / torch.where(schur > 0, schur, one), one))


def schur_diag_inverse_device(w, csr_map, indices, indptr, n, weak_rel=1e-3):
    '''Device Schur-aware inverse diagonal of the CSR operator whose values
    are ``w[csr_map]`` (a stencil or block-grid weight buffer), or ``w``
    itself where ``csr_map`` is None (a CSR matrix): kernel K7
    (``csrc/schur.cu``), replacing
    ``nutils_tpu.ops.sparse._schur_diag_kernel``.  ``csr_map``, ``indices``
    and ``indptr`` are int32 tables beside ``w``.  Memory-bound: two passes
    over K9's row blocks (:func:`csr_plan_of`, kept on ``indptr``), each
    staging a block's span in shared memory; the first gathers the values
    through the map once (into a scratch of nnz values, which the second
    reads).  A few threads sum each row in the order of a warp's butterfly
    (the bits of the one-warp-a-row kernel it replaced), so the result does
    not depend on scheduling.  Tensors on the CPU take
    :func:`schur_diag_plain`; a CUDA tensor launches the kernel or raises.'''
    n = int(n)
    if w.device.type == 'cpu':
        return schur_diag_plain(w, csr_map, indices, indptr, n, weak_rel)
    nnz = int(indices.shape[0])
    tables = (('indices', indices, (nnz,)), ('indptr', indptr, (n + 1,)))
    if csr_map is not None:
        tables += (('csr_map', csr_map, (nnz,)),)
    for name, t, shape in tables:
        if t.device != w.device or t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f'schur_diag_inverse_device: {name} must be a contiguous int32 tensor of shape '
                             f'{shape} on {w.device}')
    _kernels.check_operands('schur_diag_inverse_device', w, (w.shape[0] if csr_map is not None else nnz,),
                            w.dtype)
    d = torch.empty(n, dtype=w.dtype, device=w.device)
    dsafe = torch.empty_like(d)
    strong = torch.empty(n, dtype=torch.uint8, device=w.device)
    minv = torch.empty_like(d)
    if n:
        vals = None if csr_map is None else torch.empty(nnz, dtype=w.dtype, device=w.device)
        plan = csr_plan_of(indptr)
        _kernels.call('ntt_schur_diag', w, [w, csr_map, indices, indptr, plan, d, dsafe, strong, minv, vals],
                      scalars=(int(plan.shape[0]) - 1, CSR_CAP, float(weak_rel)))
        schur_diag_inverse_device.launches += 1
    return minv


_kernels.counted(schur_diag_inverse_device)


# ------------------------------------------------------------ CSR kernels

def csr_matvec_plain(data, indices, indptr, x):
    '''Plain torch version of :func:`csr_matvec`: an ``index_add_`` of
    ``data * x[indices]`` into the rows.'''
    n = indptr.shape[0] - 1
    rows = torch.repeat_interleave(torch.arange(n, device=x.device), torch.diff(indptr.long()),
                                   output_size=indices.shape[0])
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(0, rows, data * x[indices.long()])


# K9's plan: nonzeros a block stages in shared memory (csr_lanes_sweep.py
# times other values on the card: larger blocks leave L1 too little room
# for the gathers of x in float64)
CSR_CAP = 1024


def csr_plan(indptr, cap=CSR_CAP):
    '''K9's plan for the row pointers ``indptr``: int32 row starts
    ``[0, ..., n]`` cutting the rows into blocks of at most ``cap``
    nonzeros, except that a row of more than ``cap // 2`` nonzeros is a
    block of its own.  Made on ``indptr``'s device from the targets
    ``0, s, 2 s, ...`` along the nonzeros with ``s = cap - m`` (``m`` the
    longest other row): the first row starting at or after a target opens
    a block, so a block ends before it holds ``s + m`` nonzeros.  Two reads
    of the device (nnz and ``m``).'''
    ip = indptr.long()
    n = int(ip.shape[0]) - 1
    dev = ip.device
    if n <= 0:
        return torch.zeros(1, dtype=torch.int32, device=dev)
    lens = ip[1:] - ip[:-1]
    long_rows = lens > cap // 2
    nnz = int(ip[-1])
    step = cap - int(torch.where(long_rows, 0, lens).max())
    lr = torch.nonzero(long_rows).flatten()
    cuts = torch.cat([torch.searchsorted(ip, torch.arange(0, nnz, step, device=dev)), lr, lr + 1,
                      torch.tensor([0, n], device=dev)])
    return torch.unique(cuts).to(torch.int32)


def csr_plan_of(indptr):
    '''K9's plan (:func:`csr_plan`) for ``indptr``, made at the first
    call and kept on the tensor itself, so that it lives and dies with the
    operand it describes.'''
    plan = getattr(indptr, '_k9_plan', None)
    if plan is None:
        plan = indptr._k9_plan = csr_plan(indptr)
    return plan


def csr_matvec(data, indices, indptr, x, active=None, out=None):
    '''``y = A x`` for the CSR matrix (data, indices, indptr), kernel K9
    (``csrc/csr_spmv.cu``), replacing the unstructured operator kinds of
    ``nutils_tpu.ops.sparse._make_matvec`` (csr, ell, bell: the TPU's
    layouts of one function).  ``indices`` and ``indptr`` are int32 beside
    ``data``.  Memory-bound: row blocks of :func:`csr_plan_of` staged
    through shared memory, each row summed in a fixed order.  ``y`` goes
    into ``out`` where given; it is left unwritten while the int32 flag
    ``active`` (the CG loop's, ``ops/cg.py``) is 0.  Tensors on the CPU take
    :func:`csr_matvec_plain`; a CUDA tensor launches the kernel or
    raises.'''
    if x.device.type == 'cpu':
        y = csr_matvec_plain(data, indices, indptr, x)
        return y if out is None else out.copy_(y)
    n = int(indptr.shape[0]) - 1
    nnz = int(indices.shape[0])
    for name, t, shape in (('indices', indices, (nnz,)), ('indptr', indptr, (n + 1,))):
        if t.device != x.device or t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f'csr_matvec: {name} must be a contiguous int32 tensor of shape {shape} on {x.device}')
    y = torch.empty(n, dtype=x.dtype, device=x.device) if out is None else out
    _kernels.check_operands('csr_matvec', x, (n,), x.dtype, data=(data, (nnz,)), out=(y, (n,)))
    _kernels.check_flag('csr_matvec', active, x)
    plan = csr_plan_of(indptr)
    _kernels.call('ntt_csr_spmv', x, [data, indices, indptr, plan, x, y, active],
                  scalars=(int(plan.shape[0]) - 1, CSR_CAP))
    csr_matvec.launches += 1
    return y


_kernels.counted(csr_matvec)


def scatter_plain(values, slot, nnz):
    '''Plain torch version of :func:`csr_scatter`:
    ``zeros(nnz).index_add_(0, slot, values)``.'''
    return torch.zeros(nnz, dtype=values.dtype, device=values.device).index_add_(0, slot, values)


def csr_scatter(values, order, segptr, slot=None):
    '''CSR values ``data[s] = sum(values[j] for slot[j] == s)`` of an
    assembly's entry values, kernel K8 (``csrc/csr_scatter.cu``), replacing
    ``nutils_tpu.matrix.SparsePattern.scatter``.  ``order`` (the entries
    sorted by slot, stable) and ``segptr`` (each slot's first position in
    ``order``, nnz + 1) are int32 tables of the pattern; one thread per slot
    sums its entries in that order, so the result is bitwise reproducible.
    Tensors on the CPU take :func:`scatter_plain` with ``slot`` (int64); a
    CUDA tensor launches the kernel or raises.'''
    nnz = int(segptr.shape[0]) - 1
    if values.device.type == 'cpu':
        return scatter_plain(values, slot, nnz)
    m = int(values.shape[0])
    for name, t, shape in (('order', order, (m,)), ('segptr', segptr, (nnz + 1,))):
        if t.device != values.device or t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f'csr_scatter: {name} must be a contiguous int32 tensor of shape {shape} on '
                             f'{values.device}')
    _kernels.check_operands('csr_scatter', values, (m,), values.dtype)
    data = torch.empty(nnz, dtype=values.dtype, device=values.device)
    _kernels.call('ntt_csr_scatter', values, [values, order, segptr, data], scalars=(nnz,))
    csr_scatter.launches += 1
    return data


_kernels.counted(csr_scatter)


# ------------------------------------------------------------ masked operator

def mask_pre_plain(m, x):
    '''Plain torch version of :func:`mask_pre`: ``m * x``.'''
    return m * x


def mask_post_plain(m, y, x):
    '''Plain torch version of :func:`mask_post`: ``m * y + (1 - m) * x``.'''
    return m * y + (1.0 - m) * x


def _check_mask(name, m, x, active, **named):
    n = int(x.shape[0])
    if n >= 2**31:
        raise ValueError(f'{name}: {n} entries pass 2^31')
    _kernels.check_operands(name, x, (n,), x.dtype, m=(m, (n,)), **{k: (t, (n,)) for k, t in named.items()})
    _kernels.check_flag(name, active, x)
    return n


MASK_THREADS = 256  # csrc/masked.cu: threads a block


def mask_plan(n, itemsize, offsets):
    '''K14's split of ``[0, n)`` and its grid (a pure function): ``offsets``
    are the operands' addresses modulo 16 bytes.  Where they agree, a scalar
    head runs up to the first 16-byte boundary, then a body of ``nvec``
    vectors of 16 bytes (``vec`` values each) and a scalar tail; where they
    differ, every entry is in the head.  The grid gives each thread one
    vector of the body (at least one block, enough for the scalar
    entries).  Returns dict(vec, head, nvec, tail, grid, threads).'''
    vec = 16 // itemsize
    if len(set(offsets)) == 1 and offsets[0] % itemsize == 0:
        head = min(n, (16 - offsets[0]) % 16 // itemsize)
    else:
        head = n
    nvec = (n - head) // vec
    tail = n - head - nvec * vec
    grid = max(1, -(-nvec // MASK_THREADS), -(-(head + tail) // MASK_THREADS))
    return dict(vec=vec, head=head, nvec=nvec, tail=tail, grid=grid, threads=MASK_THREADS)


def _mask_scalars(n, *tensors):
    plan = mask_plan(n, tensors[0].element_size(), tuple(t.data_ptr() % 16 for t in tensors))
    return n, plan['head'], plan['nvec'], plan['grid']


def mask_pre(m, x, active=None, out=None):
    '''``xm = m x`` for the free-dof mask ``m`` (1 free, 0 fixed, in
    ``x``'s dtype), the first pass of the masked operator ``m A(m x) +
    (1 - m) x`` of ``nutils_tpu.ops.sparse._make_matvec``: kernel K14
    (``csrc/masked.cu``, 16 bytes of each operand at a time on the split
    of :func:`mask_plan`).  ``xm`` goes into ``out`` where given; it is
    left unwritten while the int32 flag ``active`` (the CG loop's) is 0.
    Tensors on the CPU take :func:`mask_pre_plain`; a CUDA tensor launches
    the kernel or raises.'''
    if x.device.type == 'cpu':
        xm = mask_pre_plain(m, x)
        return xm if out is None else out.copy_(xm)
    xm = torch.empty_like(x) if out is None else out
    n = _check_mask('mask_pre', m, x, active, out=xm)
    if n:
        _kernels.call('ntt_mask_pre', x, [m, x, xm, active], scalars=_mask_scalars(n, m, x, xm))
        mask_pre.launches += 1
    return xm


_kernels.counted(mask_pre)


def mask_post(m, y, x, active=None, out=None):
    '''``m y + (1 - m) x`` for the free-dof mask ``m`` and ``y = A(m x)``,
    the second pass of the masked operator: kernel K14
    (``csrc/masked.cu``, split as :func:`mask_pre`).  The result goes into
    ``out`` where given, which may be ``y`` itself; it is left unwritten
    while the int32 flag ``active`` is 0.  Tensors on the CPU take
    :func:`mask_post_plain`; a CUDA tensor launches the kernel or raises.'''
    if x.device.type == 'cpu':
        z = mask_post_plain(m, y, x)
        return z if out is None else out.copy_(z)
    z = torch.empty_like(x) if out is None else out
    n = _check_mask('mask_post', m, x, active, y=y, out=z)
    if n:
        _kernels.call('ntt_mask_post', x, [m, y, x, z, active], scalars=_mask_scalars(n, m, y, x, z))
        mask_post.launches += 1
    return z


_kernels.counted(mask_post)


# ------------------------------------------------------------ precon apply

def _precon_apply(kind):
    '''Resolve a precon kind — ``'diag'``, ``'block'``, ``('mg', levels)``
    with the static per-level (ks, shape, periodic) tuple, or
    ``('fieldsplit', offsets, subkinds)`` — to apply(operand, r, active=None);
    the block-Jacobi and multigrid kernels do nothing while the CG loop's
    flag ``active`` is 0.'''
    if isinstance(kind, tuple) and kind[0] == 'mg':
        levels = kind[1]
        shape = levels[0][1]

        def apply(operand, r, active=None):
            return _mg.vcycle(levels, operand, r.reshape(shape), active=active).reshape(-1)
        return apply
    if isinstance(kind, tuple) and kind[0] == 'fieldsplit':
        offs, subkinds = kind[1], kind[2]
        subs = [_precon_apply(k) for k in subkinds]

        def apply(operand, r, active=None):
            return torch.cat([sub(op_i, r[lo:hi], active) for sub, op_i, lo, hi
                              in zip(subs, operand, offs[:-1], offs[1:])])
        return apply
    if kind == 'diag':
        return lambda minv, r, active=None: minv * r
    if kind == 'block':
        return _precon.block_apply
    raise ValueError(f'unknown preconditioner kind {kind!r}')


def _make_matvec(mv_kind):
    '''Resolve an operator kind to mv(op, x, active=None); the stencil,
    CSR and mask kernels do nothing while the CG loop's flag ``active`` is
    0.  ``('masked', kind)`` takes the mask first in its operand, then
    ``kind``'s.'''
    if mv_kind[0] == 'masked':
        inner = _make_matvec(mv_kind[1])

        def mv(op, x, active=None):
            m = op[0]
            y = inner(op[1:], mask_pre(m, x, active), active)
            return mask_post(m, y, x, active, out=y)
        return mv
    if mv_kind[0] == 'stencil':
        _kind, ks, shape, periodic = mv_kind

        def mv(op, x, active=None):
            (w,) = op
            return _st.stencil_matvec(w, x.reshape(shape), ks, shape, periodic, active).reshape(-1)
        return mv
    if mv_kind[0] == 'blockgrid':
        plan = mv_kind[1]

        def mv(op, x, active=None):
            (v,) = op
            return _bg.blockgrid_matvec(v, x, plan, active)
        return mv
    if mv_kind[0] == 'csr':
        def mv(op, x, active=None):
            data, indices, indptr = op
            return csr_matvec(data, indices, indptr, x, active)
        return mv
    raise ValueError(f'unknown matvec kind {mv_kind[0]!r}')


# ------------------------------------------------------------ CG

# Iterations a chunk graph holds on the card (chosen on the card, PERF.md):
# the host reads the loop's state once a chunk.
CG_CHUNK = 2


class _CGLoop:
    '''The buffers of one CG solve (right-hand side ``b``, ``x``, ``r``,
    ``p`` and the K4 state) and the loop's three pieces over them.  Each
    piece only launches work, so each can be captured into a CUDA graph;
    with ``predicate`` the stencil matvec and the V-cycle take the state's
    active flag, so an iteration after the loop has stopped costs empty
    launches.'''

    def __init__(self, precon_kind, mv_kind, op, minv, b, predicate=True):
        self.apply_m = _precon_apply(precon_kind)
        self.matvec = _make_matvec(mv_kind)
        self.op, self.minv = op, minv
        self.b = b
        self.x, self.r, self.p = (torch.empty_like(b) for _ in range(3))
        self.st = _cg.new_state(b.device)
        self.active = _cg.active_flag(self.st) if predicate else None

    def start(self):
        '''x = 0, r = b, p = z = M b, rz = r . z, and the entry test on
        |b|.'''
        self.x.zero_()
        self.r.copy_(self.b)
        z = self.apply_m(self.minv, self.r)
        self.p.copy_(z)
        _cg.cg_dot(self.r, z, self.st, _cg.RZ)
        _cg.cg_dot(self.b, self.b, self.st, _cg.RR0, start=True)

    def iteration(self):
        '''One iteration of ``nutils_tpu.ops.sparse._cg_driver``'s body up to
        the refresh; it stops the loop at a claim, a scheduled refresh or the
        cap (then its tail does nothing).'''
        ap = self.matvec(self.op, self.p, self.active)
        _cg.cg_dot(self.p, ap, self.st, _cg.PAP)
        _cg.cg_step(self.x, self.r, self.p, ap, self.st)
        z = self.apply_m(self.minv, self.r, self.active)
        _cg.cg_dot(self.r, z, self.st, _cg.RZ)
        _cg.cg_xpby(self.p, z, self.st)

    def iterations(self, c):
        for _ in range(c):
            self.iteration()

    def refresh(self):
        '''The stopped iteration's tail on the true residual: r = b - A x,
        |r|^2, z = M r, rz_new and the direction (restarted after a claim);
        the loop runs again.'''
        _cg.active_flag(self.st).fill_(1)
        torch.sub(self.b, self.matvec(self.op, self.x), out=self.r)
        _cg.cg_dot(self.r, self.r, self.st, _cg.RR)
        z = self.apply_m(self.minv, self.r)
        _cg.cg_dot(self.r, z, self.st, _cg.RZ)
        _cg.cg_xpby(self.p, z, self.st)

    def reset(self, atol, maxiter):
        _cg.reset(self.st, atol, maxiter)

    def pieces(self, c):
        return {'start': self.start, 'chunk': lambda: self.iterations(c), 'refresh': self.refresh}

    def warm(self):
        return self.start, self.iteration, self.refresh

    def run(self, pieces, atol, maxiter, stats):
        '''The host's part of a CG solve: after the start, run a chunk of
        iterations (which stop themselves) and read the state, run the
        refresh where the state asks for one and read it again, and decide
        the stall and the exit with the JAX package's expressions.  Returns
        (rnorm, k).'''
        self.reset(atol, maxiter)
        pieces['start']()
        stall = 0
        lastres = None
        while True:
            pieces['chunk']()
            k, reason, rr, rr0 = _cg.read(self.st)
            stats['host_reads'] += 1
            stats['chunks'] = stats.get('chunks', 0) + 1
            if lastres is None:
                rnorm = lastres = _cg.norm(rr0)
            if reason == _cg.START:
                return rnorm, k
            if reason in (_cg.CLAIMED, _cg.SCHEDULED):
                pieces['refresh']()
                rnorm = _cg.norm(_cg.read(self.st)[2])
                stats['host_reads'] += 1
                stats['refreshes'] = stats.get('refreshes', 0) + 1
                if reason == _cg.CLAIMED and not rnorm <= atol:
                    stats['refuted'] = stats.get('refuted', 0) + 1
                # stagnating refreshes end the loop
                stall = stall + 1 if rnorm > 0.99 * lastres else 0
                lastres = rnorm
            else:
                rnorm = _cg.norm(rr)
            if not (rnorm > atol and k < maxiter and stall < 4):
                return rnorm, k


# ------------------------------------------------------------ GMRES(m)

# Arnoldi steps a chunk graph holds on the card: the host reads the state
# once a chunk and once a cycle end
GMRES_CHUNK = 8


class _GMRESLoop:
    '''The buffers of one GMRES(m) solve (right-hand side ``b``, ``x``,
    ``r``, ``w``, ``vcur``, the basis ``V`` and the K6 state) and the loop's
    three pieces over them, each of which only launches work.  The step's
    matvec and preconditioner take the state's inner flag, the cycle end's
    its outer flag, so a step after the inner loop has stopped, or a cycle
    end after the outer one has, costs empty launches.'''

    def __init__(self, precon_kind, mv_kind, m, op, minv, b):
        self.apply_m = _precon_apply(precon_kind)
        self.matvec = _make_matvec(mv_kind)
        self.op, self.minv, self.m = op, minv, m
        self.b = b
        n = b.shape[0]
        self.x, self.r, self.w, self.vcur = (torch.empty_like(b) for _ in range(4))
        self.V = _gm.basis(n, m, b.dtype, b.device)
        self.st = _gm.new_state(n, m, b.dtype, b.device)
        self.inner, self.active = _gm.inner_flag(self.st), _gm.active_flag(self.st)

    def _cycle(self):
        '''A cycle's start from r: z = M r, beta, rn, inner_tol and V[0].'''
        z = self.apply_m(self.minv, self.r, self.active)
        _gm.gmres_start(z, self.r, self.st, self.m)
        _gm.gmres_normalize(z, self.V, self.vcur, self.st, first=True)

    def start(self):
        '''x = 0, r = b, resnorm = |b| with the entry test, and the first
        cycle's start.'''
        self.x.zero_()
        _gm.gmres_residual(self.b, None, self.r, self.st, self.m, first=True)
        self._cycle()

    def step(self):
        '''One Arnoldi step of ``nutils_tpu.ops.sparse._gmres_driver``'s inner
        body: w = M A V[j], CGS2 against V[:j+1], the rotations and V[j+1];
        it stops the inner loop at j = m or res <= inner_tol.'''
        src = self.apply_m(self.minv, self.matvec(self.op, self.vcur, self.inner), self.inner)
        _gm.gmres_project(self.V, src, self.st)
        _gm.gmres_update(self.V, src, self.w, self.st)
        _gm.gmres_project(self.V, self.w, self.st, second=True)
        _gm.gmres_update(self.V, self.w, self.w, self.st, second=True)
        _gm.gmres_normalize(self.w, self.V, self.vcur, self.st)

    def steps(self, c):
        for _ in range(c):
            self.step()

    def end(self):
        '''A cycle's end: x += y V[:j] with R y = g, the true residual, the
        stall and exit tests, and the next cycle's start.'''
        _gm.gmres_solve_combine(self.V, self.x, self.st)
        _gm.gmres_residual(self.b, self.matvec(self.op, self.x, self.active), self.r, self.st, self.m)
        self._cycle()

    def reset(self, atol, maxiter):
        _gm.reset(self.st, atol, maxiter)

    def pieces(self, c):
        return {'start': self.start, 'chunk': lambda: self.steps(c), 'end': self.end}

    def warm(self):
        return self.start, self.step, self.end

    def run(self, pieces, atol, maxiter, stats):
        '''The host's part of a GMRES solve: after the start, run a chunk of
        Arnoldi steps (which stop themselves) and read the state; where the
        inner loop has stopped, run the cycle end and read it again; stop
        where the state's outer flag has fallen.  Returns (resnorm, it).'''
        self.reset(atol, maxiter)
        pieces['start']()
        while True:
            pieces['chunk']()
            state = _gm.read(self.st)
            stats['host_reads'] += 1
            stats['chunks'] = stats.get('chunks', 0) + 1
            if state['active'] and not state['inner']:
                pieces['end']()
                state = _gm.read(self.st)
                stats['host_reads'] += 1
                stats['cycles'] = stats.get('cycles', 0) + 1
            if not state['active']:
                return state['resnorm'], state['it']


# ------------------------------------------------------------ BiCGStab

# iterations a chunk graph holds on the card
BICGSTAB_CHUNK = 8


class _BiCGLoop:
    '''The buffers of one BiCGStab solve (right-hand side ``b``, ``x``,
    ``r``, ``rhat``, ``p``, ``s`` and the K10 state) and the loop's two
    pieces over them, each of which only launches work.  The matvecs and
    preconditioner take the state's active flag, the refresh's matvec its
    refresh flag, so an iteration after the loop has stopped costs empty
    launches.'''

    def __init__(self, precon_kind, mv_kind, op, minv, b):
        self.apply_m = _precon_apply(precon_kind)
        self.matvec = _make_matvec(mv_kind)
        self.op, self.minv = op, minv
        self.b = b
        self.x, self.r, self.rhat, self.p, self.s = (torch.empty_like(b) for _ in range(5))
        self.st = _bi.new_state(b.shape[0], b.dtype, b.device)
        self.active, self.need = _bi.active_flag(self.st), _bi.need_flag(self.st)

    def start(self):
        '''x = 0, r = rhat = p = b, rho = |b|^2 and the entry test.'''
        self.x.zero_()
        for t in (self.r, self.rhat, self.p):
            t.copy_(self.b)
        _bi.bicg_dots(self.b, self.b, None, self.st, _bi.RR, start=True)

    def iteration(self):
        '''One iteration of ``nutils_tpu.ops.sparse._bicgstab_driver``'s body,
        the refresh and the decisions included.'''
        phat = self.apply_m(self.minv, self.p, self.active)
        v = self.matvec(self.op, phat, self.active)
        _bi.bicg_dots(self.rhat, v, None, self.st, _bi.RV)
        _bi.bicg_s(self.r, v, self.st, self.s)
        shat = self.apply_m(self.minv, self.s, self.active)
        t = self.matvec(self.op, shat, self.active)
        _bi.bicg_dots(t, t, self.s, self.st, _bi.TT, _bi.TS)
        _bi.bicg_xr(self.x, self.r, phat, shat, self.s, t, self.rhat, self.st)
        _bi.bicg_refresh(self.b, self.matvec(self.op, self.x, self.need), self.r, self.rhat, self.st)
        _bi.bicg_p(self.p, self.r, v, self.rhat, self.st)

    def iterations(self, c):
        for _ in range(c):
            self.iteration()

    def reset(self, atol, maxiter):
        _bi.reset(self.st, atol, maxiter)

    def pieces(self, c):
        return {'start': self.start, 'chunk': lambda: self.iterations(c)}

    def warm(self):
        return self.start, self.iteration

    def run(self, pieces, atol, maxiter, stats):
        '''The host's part of a BiCGStab solve: after the start, run chunks
        of iterations (which stop themselves) and read the state until its
        active flag has fallen.  Returns (rnorm, k).'''
        self.reset(atol, maxiter)
        pieces['start']()
        while True:
            pieces['chunk']()
            state = _bi.read(self.st)
            stats['host_reads'] += 1
            stats['chunks'] = stats.get('chunks', 0) + 1
            if not state['active']:
                for key in ('refreshes', 'refuted', 'breakdowns'):
                    stats[key] = stats.get(key, 0) + state[key]
                return state['rnorm'], state['k']


# ------------------------------------------------------------ the drivers

class _Graphs:
    '''A loop whose pieces are captured as CUDA graphs (after one eager
    warm-up of its ``warm()`` pieces on a side stream: first calls upload
    tables, make plans and load kernels); ``t_capture`` is the time both
    took.'''

    def __init__(self, loop, c):
        t0 = time.perf_counter()
        self.loop = loop
        device = loop.b.device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for piece in loop.warm():
                piece()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        self.graphs = {name: _kernels.Graph(fn) for name, fn in loop.pieces(c).items()}
        torch.cuda.synchronize(device)
        self.t_capture = time.perf_counter() - t0


# the graphs of recent solves, keyed by the loop, its kinds, the chunk and
# the operands' identity (each entry holds its operands, so their storage
# is not reused)
_GRAPHS = collections.OrderedDict()
_GRAPHS_KEPT = 4


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _tensors(o)]
    return []


def _graphs(key, op, minv, make):
    '''The cached graphs of ``key`` and the operands, or ``make()``'s
    (the oldest entries dropped first); returns (entry, fresh).'''
    key = key + tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in _tensors((op, minv)))
    entry = _GRAPHS.pop(key, None)
    fresh = entry is None
    if fresh:
        while len(_GRAPHS) >= _GRAPHS_KEPT:
            _GRAPHS.popitem(last=False)
        entry = (make(), (op, minv))
    _GRAPHS[key] = entry
    return entry[0], fresh


def _resolve_chunk(chunk, device, default):
    '''``'auto'``: ``default`` on the card, the host loop (None) on the
    CPU.'''
    if chunk == 'auto':
        return default if device.type == 'cuda' else None
    return chunk


def _driver(loop_class, default_chunk, chunk, *kinds):
    '''The Krylov loop ``loop_class`` (:class:`_CGLoop`, :class:`_GMRESLoop`
    or :class:`_BiCGLoop`, made from ``kinds`` and the operands) with the
    semantics of the JAX package's driver, iteration for iteration.
    ``chunk`` None is the host loop: one iteration (an Arnoldi step), then
    one read of the state.  An int ``chunk`` runs that many between reads:
    replayed from CUDA graphs (cached, :func:`_graphs`) for CUDA tensors,
    eagerly (the plain predicated steps) on the CPU.  Both return what the
    host loop returns, bit for bit.  ``'auto'`` is ``default_chunk`` on
    the card, the host loop on the CPU.'''

    def run(op, b, minv, atol, maxiter, stats=None):
        '''Returns (x, resnorm, iters); b is not modified.  On the graph
        path ``x`` is the graphs' buffer, valid until their next solve.
        ``stats`` (a dict) gathers the driver, the chunk, replays and host
        reads.'''
        stats = {} if stats is None else stats
        atol = float(numpy.asarray(atol, dtype=_state.numpy_dtype(b.dtype)))
        maxiter = int(maxiter)
        c = _resolve_chunk(chunk, b.device, default_chunk)
        stats.setdefault('host_reads', 0)
        if c is not None and b.device.type == 'cuda':
            c = int(c)

            def make():
                loop = loop_class(*kinds, op, minv, torch.empty_like(b))
                loop.b.copy_(b)
                loop.reset(atol, maxiter)
                return _Graphs(loop, c)
            entry, fresh = _graphs((loop_class.__name__, *kinds, c, b.dtype, b.device, b.shape[0]), op, minv, make)
            graphs = entry.graphs
            stats.update(driver='graph', c=c)
            stats['t_capture'] = stats.get('t_capture', 0.0) + (entry.t_capture if fresh else 0.0)
            before = {name: g.replays for name, g in graphs.items()}
            loop = entry.loop
            loop.b.copy_(b)
            rnorm, k = loop.run({name: g.replay for name, g in graphs.items()}, atol, maxiter, stats)
            replays = stats.setdefault('replays', {})
            for name, g in graphs.items():
                replays[name] = replays.get(name, 0) + g.replays - before[name]
            stats['graph_launches'] = {name: g.counts for name, g in graphs.items()}
            return loop.x, rnorm, k
        loop = loop_class(*kinds, op, minv, b)
        stats.update(driver='host' if c is None else 'chunked', c=int(c or 1))
        rnorm, k = loop.run(loop.pieces(int(c or 1)), atol, maxiter, stats)
        return loop.x, rnorm, k

    return run


def _cg_driver(precon_kind, mv_kind, chunk='auto'):
    '''Preconditioned CG with the semantics of
    ``nutils_tpu.ops.sparse._cg_driver`` (:func:`_driver`; on the card
    :data:`CG_CHUNK` iterations a chunk).'''
    return _driver(_CGLoop, CG_CHUNK, chunk, precon_kind, mv_kind)


def _gmres_driver(precon_kind, restart, mv_kind, chunk='auto'):
    '''Left-preconditioned restarted GMRES(m) with the semantics of
    ``nutils_tpu.ops.sparse._gmres_driver`` (:func:`_driver`; on the card
    :data:`GMRES_CHUNK` Arnoldi steps a chunk, and a cycle end where the
    inner loop has stopped).'''
    return _driver(_GMRESLoop, GMRES_CHUNK, chunk, precon_kind, mv_kind, int(restart))


def _bicgstab_driver(precon_kind, mv_kind, chunk='auto'):
    '''Right-preconditioned BiCGStab with the semantics of
    ``nutils_tpu.ops.sparse._bicgstab_driver`` (:func:`_driver`; on the
    card :data:`BICGSTAB_CHUNK` iterations a chunk).'''
    return _driver(_BiCGLoop, BICGSTAB_CHUNK, chunk, precon_kind, mv_kind)


def cg_op(mv_kind, op, b, *, atol, maxiter, minv, precon='diag', chunk='auto', stats=None):
    '''Preconditioned CG over an operator-kind/operand pair; returns
    (x, resnorm, iters).'''
    x, rnorm, k = _cg_driver(precon, mv_kind, chunk)(tuple(op), b, minv, atol, maxiter, stats)
    return x.clone(), rnorm, k


def gmres_op(mv_kind, op, b, *, atol, maxiter, restart=60, minv, precon='diag', chunk='auto', stats=None):
    '''Left-preconditioned restarted GMRES(m) over an operator-kind/operand
    pair; returns (x, resnorm, iters).'''
    restart = max(2, min(int(restart), int(len(b))))
    x, rnorm, k = _gmres_driver(precon, restart, mv_kind, chunk)(tuple(op), b, minv, atol, maxiter, stats)
    return x.clone(), rnorm, k


def bicgstab_op(mv_kind, op, b, *, atol, maxiter, minv, precon='diag', chunk='auto', stats=None):
    '''Right-preconditioned BiCGStab over an operator-kind/operand pair;
    returns (x, resnorm, iters).'''
    x, rnorm, k = _bicgstab_driver(precon, mv_kind, chunk)(tuple(op), b, minv, atol, maxiter, stats)
    return x.clone(), rnorm, k


# ---------------------------------------- iterative refinement (device)

def _refined_driver(method, precon_kind, mv_kind, restart, chunk='auto'):
    '''The mixed-precision refined solve: the working-precision inner CG,
    GMRES or BiCGStab nested in a float64 outer refinement loop whose true
    residual is computed on the device with the operator weights widened to
    float64 (exact, since they were assembled in the lower precision).  The
    rounds run on the host, one read of the residual norm a round; ``chunk``
    is the inner driver's (:func:`_driver`).'''
    matvec_op = _make_matvec(mv_kind)
    if method == 'cg':
        inner = _cg_driver(precon_kind, mv_kind, chunk)
    elif method == 'gmres':
        inner = _gmres_driver(precon_kind, restart, mv_kind, chunk)
    elif method == 'bicgstab':
        inner = _bicgstab_driver(precon_kind, mv_kind, chunk)
    else:
        raise ValueError(f'unknown refined method {method!r}')

    def run(op32, op64, b64, minv, target, inner_floor, cap, maxrounds, rn0=None, stats=None):
        '''``rn0``: |b64| where the caller has it on the host, else read
        here.  ``stats`` (a dict) gathers the inner driver's record with the
        rounds' host reads.'''
        stats = {} if stats is None else stats
        reads = 0
        dt32 = op32[0].dtype
        np32 = numpy.float32 if dt32 == torch.float32 else numpy.float64
        x = torch.zeros_like(b64)
        r = b64
        if rn0 is None:
            rn = float(torch.linalg.norm(b64))
            reads += 1
        else:
            rn = rn0
        prevrn = math.inf
        rounds = total_it = 0
        # continue while above target, under the round budget, still
        # contracting by >5% per round, and finite
        while rn > target and rounds < maxrounds and (rounds == 0 or rn < 0.95 * prevrn) \
                and math.isfinite(rn):
            inner_atol = float(np32(max(target / rn, inner_floor)))
            d, _rnin, it = inner(op32, (r / rn).to(dt32), minv, inner_atol, cap, stats)
            x_new = x + rn * d.to(torch.float64)
            r_new = b64 - matvec_op(op64, x_new)
            rn_new = float(torch.linalg.norm(r_new))
            reads += 1
            prevrn = rn
            # keep the better iterate even when the round failed to contract
            if rn_new < rn and math.isfinite(rn_new):
                x, r, rn = x_new, r_new, rn_new
            rounds += 1
            total_it += it
        stats['host_reads'] = stats.get('host_reads', 0) + reads
        return x, rn, total_it, rounds

    return run


def widen(op):
    '''The float64 operator of the refinement: floating operands widened
    (a block-grid operator's compact values, not its weight buffer), index
    tables (CSR columns and row pointers) as they are.'''
    return tuple(o.to(torch.float64) if o.is_floating_point() else o for o in op)


def refined_solve_op(method, mv_kind, op, b, *, target, maxiter, restart=100,
                     minv, precon, op64=None, maxrounds=30, chunk='auto', stats=None):
    '''Refined device solve; returns (x64 numpy, resnorm, iters, rounds).
    ``op64`` defaults to widening ``op``; ``b`` is a host or device vector.
    ``chunk``: the inner driver's (:func:`_driver`; ``'auto'`` replays
    CUDA graphs on the card and runs the host loop on the CPU); ``stats``
    (a dict) receives the driver's record.'''
    x, rn, it, rounds = refined_solve_device(method, mv_kind, op, b, target=target, maxiter=maxiter,
                                             restart=restart, minv=minv, precon=precon, op64=op64,
                                             maxrounds=maxrounds, chunk=chunk, stats=stats)
    return x.cpu().numpy(), rn, it, rounds


def refined_solve_device(method, mv_kind, op, b, *, target, maxiter, restart=100,
                         minv, precon, op64=None, maxrounds=30, chunk='auto', stats=None):
    ''':func:`refined_solve_op` with the solution left on the device as a
    float64 tensor; returns (x64, resnorm, iters, rounds).'''
    if method == 'gmres':
        restart = max(2, min(int(restart), int(len(b))))
    run = _refined_driver(method, precon, mv_kind, restart, chunk)
    if op64 is None:
        op64 = widen(op)
    rn0 = None
    if not isinstance(b, torch.Tensor):
        # a host right-hand side: its norm needs no read of the device
        b = numpy.asarray(b, dtype=numpy.float64)
        rn0 = float(numpy.linalg.norm(b))
    b64 = torch.as_tensor(b, device=op[0].device).to(torch.float64)
    inner_floor = float(numpy.sqrt(numpy.finfo(numpy.float32 if op[0].dtype == torch.float32
                                               else numpy.float64).eps))
    x, rn, it, rounds = run(tuple(op), tuple(op64), b64, minv, float(target), inner_floor,
                            int(maxiter), int(maxrounds), rn0, stats)
    return x, float(rn), int(it), int(rounds)
