'''Sparse matrices: host-built CSR pattern, the CSR, stencil- and
block-grid-form device operators and the refined device Krylov solves.

The part of ``nutils_tpu.matrix`` that the structured Laplace, the
structured Taylor-Hood and the triangle Navier-Stokes slices reach.  The
sparsity pattern is argument-independent and built once host-side
(``SparsePattern``, numpy lexsort).  Assembly writes the jacobian straight
into stencil weights (``_StencilMatrix``) or block-grid weights
(``_BlockGridMatrix``), which go to the device solver with zero copies, or,
on patterns with neither form, into CSR values on the device through the
pattern's value scatter (kernel K8); a ``Matrix`` of CSR values routes its
device operator as the JAX package does: stencil, else block-grid, else the
CSR operand itself (kernel K9).  Solve backends:

* ``direct`` — scipy sparse LU on the host (small systems);
* ``cg``, ``gmres`` and ``bicgstab`` — preconditioned Krylov on the device
  in the assembly dtype, inside a float64 iterative refinement whose true
  residual is computed on the device (``ops/sparse.refined_solve_op``).
  Stencil operators get the multigrid V-cycle, others the Schur-aware
  inverse diagonal computed on the device (kernel K7); a multi-field system
  whose diagonal scaling stalls is retried with the fieldsplit
  preconditioner (velocity multigrid, pressure scaling).  ``precon=`` picks
  a preconditioner of :meth:`Matrix.getprecon` instead: ``diag``,
  ``schurdiag`` or ``block`` (block Jacobi, kernel K13).  Float64 is native
  on the card, so the device residual is accepted under the same
  ``_accept`` contract as the JAX package's host polish loop, which is not
  ported;
* ``scipy:<name>``, ``bicg``, ``cgs``, ``lgmres`` (and ``bicgstab`` under a
  host preconditioner, ``splu`` or ``spilu``) — scipy's iterative solvers on
  the host in float64.

Constrained solves (``solve(constrain=)``, ``submatrix``) follow the JAX
package: the device Krylov methods solve the masked operator
``M A M + (I - M)``, built on the host with scipy once per mask and routed
to its stencil, block-grid or CSR form like any other matrix; the other
methods solve the free submatrix.  The device solvers' ``_isfree=``
keyword solves ``m A(m x) + (1 - m) x`` instead, the operator wrapped on
the device by the mask (kernel K14).  The constructors (``assemble_csr``,
``assemble_coo``, ``empty``, ``diag``, ``eye``, ``assemble_block_csr``) and
the algebra (``+``, ``-``, scalar ``*`` and ``/``, ``T``) are the JAX
package's host scipy, bit for bit; a scalar product of values on the device
stays there.
'''

import time

import numpy
import torch

from .utils import _log as log
from .utils import config


class MatrixError(Exception):
    pass


class ToleranceNotReached(MatrixError):

    def __init__(self, best):
        super().__init__('solver failed to reach tolerance')
        self.best = best


class SparsePattern:
    '''Deduplicated CSR pattern from concatenated COO chunks, with the map
    from original entry order to CSR slots (numpy lexsort).'''

    def __init__(self, rows, cols, shape):
        rows = numpy.asarray(rows)
        cols = numpy.asarray(cols)
        self.shape = shape
        order = numpy.lexsort((cols, rows))
        rs, cs = rows[order], cols[order]
        if len(rs):
            newpair = numpy.empty(len(rs), dtype=bool)
            newpair[0] = True
            numpy.logical_or(rs[1:] != rs[:-1], cs[1:] != cs[:-1], out=newpair[1:])
        else:
            newpair = numpy.zeros(0, dtype=bool)
        slot_sorted = numpy.cumsum(newpair) - 1
        self.nnz = int(slot_sorted[-1]) + 1 if len(rs) else 0
        urows = rs[newpair]
        self.indices = cs[newpair].astype(config.int_dtype())
        self.indptr = numpy.concatenate([[0], numpy.cumsum(numpy.bincount(urows, minlength=shape[0]))]).astype(numpy.int64)
        # slot id per original (pre-sort) entry
        self.slot = numpy.empty(len(rows), dtype=numpy.int64)
        self.slot[order] = slot_sorted
        self.urows = urows
        # the value scatter's plan: entries in slot order (lexsort is
        # stable, so a slot's entries keep their original order) and each
        # slot's first position in that order
        self._order = order
        self._segptr = numpy.append(numpy.flatnonzero(newpair), len(rs))

    def scatter(self, values):
        '''Device: accumulate a flat entry-value tensor into CSR data
        (kernel K8 on a card; ``index_add_`` for a tensor on the CPU).  The
        pattern's tables move to the device once and stay cached here.'''
        from .ops.sparse import csr_scatter
        tabs = getattr(self, '_scatter_tables', None)
        if tabs is None or tabs[0].device != values.device:
            if values.device.type == 'cpu':
                # the plain version adds through each entry's slot
                tabs = (torch.as_tensor(self._segptr), None, torch.as_tensor(self.slot))
            else:
                if len(self.slot) >= 2**31:
                    raise ValueError('the value scatter indexes entries in 32 bits: 2^31 entries or more')
                tabs = (torch.as_tensor(self._segptr.astype(numpy.int32), device=values.device),
                        torch.as_tensor(self._order.astype(numpy.int32), device=values.device), None)
            self._scatter_tables = tabs
        segptr, order, slot = tabs
        return csr_scatter(values, order, segptr, slot)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else numpy.asarray(a)


def device_csr_tables(pattern, csr_map, device):
    '''(csr_map, indices, indptr) of ``pattern`` as int32 tensors on
    ``device``: CSR value k of a matrix on the pattern is ``w[csr_map[k]]``
    of its flat weight buffer, or value k itself where ``csr_map`` is None
    (a CSR matrix; the first entry is then None).  The tables depend on the
    pattern only, so they are uploaded once per device, cached on
    ``pattern`` and shared by every Newton-step matrix and the fused step.'''
    def upload(a):
        return torch.as_tensor(numpy.asarray(a, dtype=numpy.int32), device=device)
    idx = getattr(pattern, '_device_index_tables', None)
    if idx is None or idx[0].device != device:
        idx = pattern._device_index_tables = (upload(pattern.indices), upload(pattern.indptr))
    if csr_map is None:
        return (None,) + idx
    cmap = getattr(pattern, '_device_csr_map', None)
    if cmap is None or cmap.device != device:
        cmap = pattern._device_csr_map = upload(csr_map)
    return (cmap,) + idx


def _masked_csr(data, indices, indptr, isfree):
    '''(indptr, indices, data) of ``M A M + (I - M)``, ``M`` the diagonal of
    the free mask ``isfree``, for a square CSR matrix ``A`` with sorted,
    distinct columns in each row: the entries of A in free rows and
    columns whose value is not zero, and a 1 on the diagonal of each fixed
    row.  Bit for bit what scipy's products give (``diags(m) @ A @ diags(m)
    + diags(1 - m)``, which drop the zeros they make), in O(nnz) vectorized
    host work.'''
    n = len(indptr) - 1
    rows = numpy.repeat(numpy.arange(n, dtype=indices.dtype), numpy.diff(indptr))
    keep = isfree[rows] & isfree[indices] & (data != 0)
    fixed = numpy.flatnonzero(~isfree)
    cnt = numpy.bincount(rows[keep], minlength=n)
    cnt[fixed] += 1
    idt = numpy.int32 if cnt.sum() < 2**31 else numpy.int64
    mptr = numpy.concatenate([[0], numpy.cumsum(cnt)]).astype(idt)
    # a fixed row keeps no entry of A: its diagonal alone; the kept entries
    # fill the other slots in their order
    diag = numpy.zeros(int(mptr[-1]), dtype=bool)
    diag[mptr[fixed]] = True
    mind = numpy.empty(int(mptr[-1]), dtype=idt)
    mdat = numpy.empty(int(mptr[-1]), dtype=data.dtype)
    mind[diag], mdat[diag] = fixed, 1.
    mind[~diag], mdat[~diag] = indices[keep], data[keep]
    return mptr, mind, mdat


def blockgrid_plan(pattern, meta, woff, csr_map):
    '''The compact plan of kernel K5 (``ops/blockgrid.compact_plan``) for
    the block-grid layout (meta, woff) of ``pattern``, whose CSR value k
    sits at ``w[csr_map[k]]``.  It depends on the pattern only, so it is
    built once, cached on ``pattern`` and shared by every Newton-step matrix
    and the fused step.'''
    plan = getattr(pattern, '_k5_plan', None)
    if plan is None:
        from .ops import blockgrid as _bg
        plan = pattern._k5_plan = _bg.compact_plan(meta, woff, csr_map, pattern.indptr, pattern.indices)
    return plan


def assemble_csr(data, indices, indptr, shape):
    '''CSR constructor (reference: ``nutils_tpu/matrix.py:89``).

    >>> import numpy
    >>> from nutils_tpu_torch import matrix
    >>> A = matrix.assemble_csr(numpy.array([2., -1., -1., 2.]),
    ...                         numpy.array([0, 1, 0, 1]),
    ...                         numpy.array([0, 2, 4]), (2, 2))
    >>> x = A.solve(numpy.array([1., 1.]))
    >>> numpy.round(x, 12).tolist()
    [1.0, 1.0]
    '''
    return Matrix(indptr, indices, numpy.asarray(data), shape)


def assemble_coo(data, rows, cols, shape):
    '''COO constructor, duplicates summed into CSR in their order
    (reference: ``nutils_tpu/matrix.py:104``).

    >>> import numpy
    >>> from nutils_tpu_torch import matrix
    >>> A = matrix.assemble_coo(numpy.array([1., 1., 3.]),
    ...                         numpy.array([0, 0, 1]),
    ...                         numpy.array([0, 0, 1]), (2, 2))
    >>> A.export('dense').tolist()
    [[2.0, 0.0], [0.0, 3.0]]
    '''
    pattern = SparsePattern(numpy.asarray(rows), numpy.asarray(cols), shape)
    out = numpy.zeros(pattern.nnz)
    numpy.add.at(out, pattern.slot, numpy.asarray(data, dtype=float))
    return Matrix.from_pattern(pattern, out)


def empty(shape):
    return Matrix(numpy.zeros(shape[0] + 1, dtype=int), numpy.zeros(0, dtype=int), numpy.zeros(0), shape)


def diag(d):
    d = numpy.asarray(d, dtype=float)
    n = len(d)
    return Matrix(numpy.arange(n + 1), numpy.arange(n), d, (n, n))


def eye(n):
    return diag(numpy.ones(n))


class Matrix:
    '''Square or rectangular CSR matrix with a solve (reference:
    matrix/_base.py:33).  ``data`` is a numpy array or a tensor (assembly
    leaves it on the device).'''

    def __init__(self, indptr, indices, data, shape):
        self.indptr = numpy.asarray(indptr)
        self.indices = numpy.asarray(indices)
        self.data = data
        self.shape = tuple(shape)

    @classmethod
    def from_pattern(cls, pattern, data):
        m = cls(pattern.indptr, pattern.indices, data, pattern.shape)
        m._pattern = pattern  # device-op plans and tables cache there across
        return m              # Newton steps (constant pattern, fresh values)

    def _scipy(self):
        import scipy.sparse
        return scipy.sparse.csr_matrix((_host(self.data), self.indices, self.indptr), shape=self.shape)

    def export(self, form):
        '''The matrix on the host as ``'csr'`` (data, indices, indptr),
        ``'dense'`` or ``'coo'`` (data, (rows, cols)).'''
        if form == 'csr':
            return _host(self.data), self.indices, self.indptr
        if form == 'dense':
            return self._scipy().toarray()
        if form == 'coo':
            m = self._scipy().tocoo()
            return numpy.asarray(m.data), (m.row, m.col)
        raise ValueError(form)

    def __matmul__(self, vec):
        return self._scipy() @ numpy.asarray(vec)

    # the algebra (reference: ``nutils_tpu/matrix.py:175-207``) is scipy's
    # on the host, as in the JAX package, whatever form the operands have:
    # the result is a plain CSR matrix of host values with scipy's pattern
    # (a sum drops the entries it makes zero)

    @staticmethod
    def _from_scipy(m):
        m = m.tocsr()
        return Matrix(m.indptr, m.indices, m.data, m.shape)

    def __add__(self, other):
        if not isinstance(other, Matrix):
            return NotImplemented
        return self._from_scipy(self._scipy() + other._scipy())

    def __sub__(self, other):
        if not isinstance(other, Matrix):
            return NotImplemented
        return self._from_scipy(self._scipy() - other._scipy())

    def __mul__(self, scale):
        if not numpy.isscalar(scale):
            return NotImplemented
        if isinstance(self.data, torch.Tensor):
            # values on the device stay there where the product keeps
            # their dtype: one multiply an entry, the host product's bits
            dtype = torch.empty(0, dtype=self.data.dtype).numpy().dtype
            if numpy.result_type(dtype, scale) == dtype:
                m = Matrix(self.indptr, self.indices, self.data * scale, self.shape)
                for name in ('_pattern', '_field_offsets', '_field_grids'):
                    if getattr(self, name, None) is not None:
                        setattr(m, name, getattr(self, name))
                return m
        return Matrix(self.indptr, self.indices, _host(self.data) * scale, self.shape)

    __rmul__ = __mul__

    def __truediv__(self, scale):
        return self * (1. / scale)

    def __neg__(self):
        return self * -1.

    @property
    def T(self):
        t = self._scipy().T.tocsr()
        return Matrix(t.indptr, t.indices, t.data, (self.shape[1], self.shape[0]))

    def diagonal(self):
        return self._scipy().diagonal()

    def submatrix(self, rows, cols):
        '''Restrict to boolean-masked rows and columns (reference:
        ``nutils_tpu/matrix.py:212``).  All-true masks return the matrix
        itself; the symmetric square case returns a lazy view whose ``solve``
        is a masked solve on the whole operator, which keeps its stencil or
        block-grid form and its preconditioner.'''
        rows = numpy.asarray(rows)
        cols = numpy.asarray(cols)
        if rows.dtype == bool and cols.dtype == bool:
            if rows.all() and cols.all():
                return self
            if self.shape[0] == self.shape[1] and numpy.array_equal(rows, cols):
                return _SubMatrix(self, rows)
        m = self._scipy()[rows][:, cols].tocsr()
        return Matrix(m.indptr, m.indices, m.data, m.shape)

    def solve(self, rhs=None, *, constrain=None, lhs0=None, solver=None, atol=0., rtol=0., symmetric=False,
              precon=None, **kwargs):
        '''Solve A x = b, optionally under constraints (reference:
        ``nutils_tpu/matrix.py:319``).

        ``constrain``: a boolean mask (True: x fixed to 0) or a float vector
        whose NaN entries are free and whose finite entries prescribe x.  The
        device Krylov methods solve ``M A M y = M (b - A xfix)`` with the
        identity on the fixed rows: the masked operator, built on the host
        once per mask and cached on the matrix, keeps the stencil or
        block-grid form (and the multigrid preconditioner) of the
        original, and is solved by :meth:`_solve_free` as an unconstrained
        matrix is: under ``auto`` a device method that misses its tolerance
        is demoted to a host direct solve, and the solve record
        (``_solve_stats``) says so.  Other methods solve the free submatrix
        directly.'''
        rhs = numpy.zeros(self.shape[0]) if rhs is None else numpy.asarray(rhs, dtype=float)
        if constrain is None:
            return self._solve_free(rhs, solver, atol, rtol, symmetric, precon, **kwargs)
        constrain = numpy.asarray(constrain)
        if constrain.dtype == bool:
            isfree = ~constrain
            xfix = numpy.zeros(self.shape[1])
        else:
            isfree = numpy.isnan(constrain)
            xfix = numpy.where(isfree, 0.0, constrain)
        eff = solver if solver is not None else config.matrix.value
        if eff == 'auto':
            eff = ('cg' if symmetric else 'gmres') if self.shape[0] >= config.device_solve_min.value else 'direct'
        if eff in ('cg', 'gmres', 'bicgstab') and self.shape[0] == self.shape[1]:
            Mm = self._masked(isfree)
            # a zero xfix (a boolean mask, a submatrix's solve) needs no
            # product: rhs - A 0 is rhs
            b = numpy.where(isfree, rhs - (self @ xfix) if xfix.any() else rhs, 0.0)
            try:
                y = Mm._solve_free(b, solver, atol, rtol, symmetric, precon, **kwargs)
            except ToleranceNotReached as e:  # the best iterate, constrained as the solution would be
                self._solve_stats = getattr(Mm, '_solve_stats', None)
                raise ToleranceNotReached(numpy.where(isfree, e.best, xfix)) from e
            self._solve_stats = Mm._solve_stats
            return numpy.where(isfree, y, xfix)
        sub = self.submatrix(isfree, isfree)
        b = rhs[isfree] - (self @ xfix)[isfree]
        xf = sub._solve_free(b, 'direct' if eff in ('cg', 'gmres', 'bicgstab') else solver,
                             atol, rtol, symmetric, precon, **kwargs)
        self._solve_stats = getattr(sub, '_solve_stats', None)
        x = xfix.copy()
        x[isfree] = xf
        return x

    def _masked(self, isfree):
        '''The masked operator ``M A M + (I - M)`` of free mask ``isfree``
        as a fresh :class:`Matrix` with this matrix's field hints, built on
        the host (:func:`_masked_csr`) and cached per mask, so repeated
        solves (Newton steps on one jacobian, a submatrix view) reuse its
        operator form and preconditioner.  A later matrix of this pattern
        under the same mask whose zeros lie where they lay refills the
        masked pattern's values (:meth:`_MaskedPattern.refill`).'''
        key = isfree.tobytes()
        cached = getattr(self, '_masked_solve_cache', None)
        if cached is not None and cached[0] == key:
            return cached[1]
        A = self._scipy()
        if not A.has_canonical_format:  # sorted distinct columns (assembled patterns have them)
            A = A.copy()
            A.sum_duplicates()
        src = self._pattern_of()
        held = getattr(src, '_masked_pattern', None) if src is not self else None
        values = held[1].refill(A.data) if held is not None and held[0] == key else None
        if values is not None:
            Mm = Matrix(held[1].indptr, held[1].indices, values, self.shape)
        else:
            Mm = Matrix(*_masked_csr(A.data, A.indices, A.indptr, isfree), self.shape)
        for name in ('_field_offsets', '_field_grids'):
            if getattr(self, name, None) is not None:
                setattr(Mm, name, getattr(self, name))
        if getattr(self, '_grid', None) is not None and getattr(Mm, '_field_grids', None) is None:
            # a stencil-form matrix's masked operator lies on its grid: the
            # operator form and the multigrid hierarchy start from it, not
            # from an inferred one (which may merge the component axis of a
            # vector field into a spatial one and stop coarsening early)
            Mm._field_grids = ((self._grid, self._periodic),)
        # the masked pattern's plans (its operator form's slot map, kept by
        # _device_op, and the multigrid's, kept by _mg) depend on that
        # pattern alone: a later matrix of this pattern (a fresh jacobian of
        # the same System) under the same mask that refills it reuses them
        if src is not self:
            if values is None:
                held = src._masked_pattern = (key, _MaskedPattern(Mm.indptr, Mm.indices, Mm.shape, A.indptr,
                                                                  A.indices, A.data, isfree))
            Mm._pattern_src = held[1]
        self._masked_solve_cache = (key, Mm)
        return Mm

    def solve_leniently(self, *args, **kwargs):
        try:
            return self.solve(*args, **kwargs)
        except ToleranceNotReached as e:
            log.warning('solver failed to reach tolerance; continuing with best iterate')
            return e.best

    def getprecon(self, precon='diag', **args):
        '''Build (and cache, per name and arguments) a preconditioner
        handle :class:`_Precon` (reference: ``nutils_tpu/matrix.py:400``).

        Device kinds, fed to the Krylov loops on the card:

        * ``diag`` — the inverse diagonal;
        * ``schurdiag`` / ``schur-diag`` — the Schur-aware inverse diagonal
          (:func:`ops.sparse.schur_diag_inverse`, on the host);
        * ``block`` — block Jacobi of ``blocksize`` (4) rows: the dense
          diagonal blocks inverted on the host once
          (:func:`ops.precon.block_jacobi_inverse`), applied by kernel K13.

        Host kinds, for scipy's solvers: ``direct`` / ``splu`` (sparse LU)
        and ``spilu`` / ``spilu0`` (incomplete LU).'''
        key = (precon, tuple(sorted(args.items())))
        cached = getattr(self, '_precon_cache', None)
        if cached is not None and cached[0] == key:
            return cached[1]
        if self.shape[0] != self.shape[1]:
            raise MatrixError('matrix must be square')
        if precon == 'diag':
            d = self.diagonal()
            if not d.all():
                raise MatrixError("building 'diag' preconditioner: diagonal has zero entries")
            obj = _Precon('diag', minv=1.0 / d)
        elif precon in ('schurdiag', 'schur-diag'):
            from .ops.sparse import schur_diag_inverse
            obj = _Precon('diag', minv=schur_diag_inverse(_host(self.data), self.indices, self.indptr, self.shape[0]))
        elif precon == 'block':
            from .ops.precon import block_jacobi_inverse
            bs = int(args.get('blocksize', 4))
            obj = _Precon('block', minv=block_jacobi_inverse(_host(self.data), self.indices, self.indptr,
                                                             self.shape[0], bs))
        elif precon in ('direct', 'splu'):
            import scipy.sparse.linalg
            try:
                obj = _Precon('host', apply=scipy.sparse.linalg.factorized(self._scipy().tocsc()))
            except RuntimeError as e:
                raise MatrixError(f'failed to create preconditioner: {e}') from e
        elif precon in ('spilu', 'spilu0'):
            import scipy.sparse.linalg
            if precon == 'spilu0':
                args = dict(args, fill_factor=1.)
            try:
                obj = _Precon('host', apply=scipy.sparse.linalg.spilu(self._scipy().tocsc(), **args).solve)
            except RuntimeError as e:
                raise MatrixError(f'failed to create preconditioner: {e}') from e
        else:
            raise MatrixError(f'unknown preconditioner {precon!r}')
        self._precon_cache = (key, obj)
        return obj

    def _solve_free(self, rhs, solver, atol, rtol, symmetric, precon, **kwargs):
        if not len(rhs):
            return numpy.zeros(0)
        fallback = False
        if solver is None:
            solver = config.matrix.value
        if solver == 'auto':
            if self.shape[0] < config.device_solve_min.value:
                solver = 'direct'
            else:
                solver = 'cg' if symmetric else 'gmres'
                fallback = True  # auto mode: demote to host direct on failure
        if solver in ('direct', 'scipy', 'dense'):
            return self._solve_direct(rhs)
        try:
            if solver == 'cg':
                return self._solve_cg(rhs, atol=atol, rtol=rtol or 1e-11, precon=precon, **kwargs)
            if solver == 'gmres':
                return self._solve_gmres(rhs, atol=atol, rtol=rtol or 1e-11, precon=precon, **kwargs)
            if solver == 'bicgstab' and not (precon in ('direct', 'splu', 'spilu', 'spilu0')
                                             or getattr(precon, 'kind', None) == 'host'):
                return self._solve_bicgstab(rhs, atol=atol, rtol=rtol or 1e-11, precon=precon, **kwargs)
        except ToleranceNotReached:
            if not fallback:
                raise
            log.warning(f'device {solver} failed to reach tolerance; falling back to host direct solve')
            # the record says the host solved it, and keeps the failed
            # device attempt's own
            failed = getattr(self, '_solve_stats', None)
            x = self._solve_direct(rhs)
            self._solve_stats = {'method': 'direct', 'accepted_on_device': False, 'fallback_from': failed}
            return x
        if solver.startswith('scipy:'):
            return self._solver_scipy(rhs, solver[6:], atol=atol, rtol=rtol, precon=precon, **kwargs)
        if solver in ('bicg', 'bicgstab', 'cgs', 'lgmres'):  # host-precon bicgstab lands here
            return self._solver_scipy(rhs, solver, atol=atol, rtol=rtol, precon=precon, **kwargs)
        raise ValueError(f'unknown solver {solver!r}')

    def _solver_scipy(self, rhs, method, *, atol, rtol, maxiter=None, precon=None, preconargs=None, **kwargs):
        '''scipy's iterative solver ``method`` (``cg``, ``bicg``,
        ``bicgstab``, ``cgs``, ``gmres``, ``lgmres``, ...) on the host CSR in
        float64 (reference: ``nutils_tpu/matrix.py:893``), preconditioned by
        the host apply of any :class:`_Precon`.'''
        import scipy.sparse.linalg
        solverfun = getattr(scipy.sparse.linalg, method, None)
        if not callable(solverfun):
            raise ValueError(f'unknown solver {"scipy:" + method!r}')
        # the host solved it, whatever the outcome: no device record stays
        self._solve_stats = {'method': f'scipy:{method}', 'accepted_on_device': False}
        A = self._scipy().astype(numpy.float64)
        M = None
        if precon is not None:
            obj = precon if isinstance(precon, _Precon) else self.getprecon(precon, **(preconargs or {}))
            apply = obj.apply_host()
            # rmatvec: exact for the symmetric diag and block kinds, the
            # customary same-operator approximation for ILU (bicg needs it)
            M = scipy.sparse.linalg.LinearOperator(A.shape, apply, rmatvec=apply, dtype=float)
        target = max(atol, rtol * float(numpy.linalg.norm(rhs)))
        if maxiter is None and method == 'lgmres':
            maxiter = 1000
        x, info = solverfun(A, rhs, M=M, atol=target, rtol=0., maxiter=maxiter, **kwargs)
        if info != 0:
            raise ToleranceNotReached(x)
        return x

    def _solve_direct(self, rhs):
        import scipy.sparse.linalg
        try:
            x = scipy.sparse.linalg.spsolve(self._scipy().tocsc(), rhs)
        except RuntimeError as e:
            raise MatrixError(str(e)) from e
        self._solve_stats = {'method': 'direct', 'accepted_on_device': False}
        return x

    def _pattern_of(self):
        '''Where the device tables and plans cache: the assembly's pattern,
        or this matrix itself when it was built from CSR arrays.'''
        return getattr(self, '_pattern', None) or getattr(self, '_pattern_src', None) or self

    def _device_data(self):
        '''CSR values as a tensor on the device: assembled values as they
        are, host values uploaded once.'''
        if isinstance(self.data, torch.Tensor):
            return self.data
        cached = getattr(self, '_device_data_cache', None)
        if cached is None:
            cached = self._device_data_cache = torch.as_tensor(numpy.asarray(self.data), device=config.torch_device())
        return cached

    def _weights(self):
        '''The device tensor that holds the operator's values: the CSR
        values here, the flat weight buffer of a stencil- or block-grid-form
        matrix.'''
        return self._device_data()

    def _csr_tables(self):
        '''(w, csr_map, indices, indptr) on the device: a stencil- or
        block-grid-form matrix's flat weight buffer and the pattern's int32
        tables (:func:`device_csr_tables`), so a fresh Newton jacobian
        uploads nothing but its weights; for a CSR matrix its values, None
        and the tables.'''
        w = self._weights()
        cmap = getattr(self, '_csr_map', None)
        if callable(cmap):
            cmap = self._csr_map = cmap()
        return (w,) + device_csr_tables(self._pattern_of(), cmap, w.device)

    def _device_op(self):
        '''(mv_kind, operands) for the device Krylov drivers, routed as the
        JAX package routes it (``nutils_tpu/matrix.py:230``) and cached: a
        verified grid stencil (kernel K1), else a block-grid form (K5, on the
        compact operand of its plan, ``('blockgrid', plan)``), else
        the CSR operand itself, ``('csr',)`` with (data, indices, indptr)
        (K9; its row-block plan is made here and kept on ``indptr``),
        whatever ``spmv`` layout the JAX package would pick (its ``bell``,
        ``ell`` and ``csr`` forms are the TPU's layouts of one function).
        The plan depends on the pattern only and caches there.'''
        cached = getattr(self, '_device_op_cache', None)
        if cached is not None:
            return cached
        from .ops import blockgrid as _bg
        from .ops import stencil as _st
        pattern = self._pattern_of()
        plan = getattr(pattern, '_device_op_plan', None)
        if plan is None:
            data = _host(self.data)
            grids = getattr(self, '_field_grids', None)
            form = bgform = None
            if self.shape[0] == self.shape[1]:
                if grids is not None and len(grids) == 1 and grids[0] is not None:
                    # exact dof-grid hint from the solver: no inference
                    form = _st.from_csr_grid(data, self.indices, self.indptr, grids[0][0])
                if form is None:
                    form = _st.from_csr(data, self.indices, self.indptr, self.shape[0])
                if form is None and getattr(self, '_field_offsets', None) is not None:
                    bgform = _bg.detect(data, self.indices, self.indptr, self._field_offsets, grids=grids)
            if form is not None:
                plan = ('stencil', (form.ks, form.shape, form.slot, form.rows, form.periodic))
            elif bgform is not None:
                woff = numpy.concatenate([[0], numpy.cumsum(bgform.fill[0])[:-1]]).astype(numpy.int64)
                plan = ('blockgrid', (bgform.meta, bgform.fill, tuple(int(o) for o in woff)))
            else:
                plan = ('csr', None)
            pattern._device_op_plan = plan
        kind, payload = plan
        if kind == 'stencil':
            ks, gshape, slot, rows, per = payload
            w = _st.refill(ks, gshape, slot, rows, _host(self.data))
            cached = (('stencil', ks, gshape, per), (torch.as_tensor(w, device=config.torch_device()),))
        elif kind == 'blockgrid':
            meta, fill, woff = payload
            w = numpy.concatenate([a.ravel() for a in _bg.refill(fill, _host(self.data), meta)])
            kplan = blockgrid_plan(pattern, meta, woff, numpy.asarray(woff)[fill[1]] + fill[2])
            cached = (('blockgrid', kplan), (_bg.pack(torch.as_tensor(w, device=config.torch_device()), kplan),))
        else:
            from .ops.sparse import csr_plan_of
            data, _cmap, indices, indptr = self._csr_tables()
            csr_plan_of(indptr)  # K9's row blocks, kept on the pattern's row pointers
            cached = (('csr',), (data, indices, indptr))
        self._device_op_cache = cached
        return cached

    def _device_precon(self, precon, preconargs):
        '''(kind, minv) for the device Krylov solvers, from a
        :class:`_Precon` or a name of :meth:`getprecon`; a host kind raises.
        The default (``None``) is the Schur-aware inverse diagonal: plain
        Jacobi on rows with a healthy diagonal, a diagonal Schur-complement
        estimate on rows whose diagonal is negligible (the pressure block of
        saddle-point systems).  It is computed on the device (kernel K7) from
        the device weights or CSR values and pattern-cached tables, and
        cached per matrix.'''
        if precon is None:
            cached = getattr(self, '_device_precon_cache', None)
            if cached is None:
                from .ops.sparse import schur_diag_inverse_device
                w, cmap, indices, indptr = self._csr_tables()
                cached = self._device_precon_cache = (
                    'diag', schur_diag_inverse_device(w, cmap, indices, indptr, self.shape[0]))
            return cached
        obj = precon if isinstance(precon, _Precon) else self.getprecon(precon, **(preconargs or {}))
        if obj.kind == 'host':
            raise MatrixError('host preconditioner cannot feed the device solver')
        return obj.kind, obj.minv

    def _device_minv(self, minv, device, dtype, isfree=None):
        '''``minv`` (a host array or a device tensor of any shape) as a
        tensor of ``dtype`` on ``device``, set to 1 on the rows that
        ``isfree`` fixes where given (a diagonal's); kept for the same
        ``minv`` and mask, so repeated solves hand the CG graphs the same
        operand.'''
        key = (device, dtype, None if isfree is None else isfree.tobytes())
        cached = getattr(self, '_device_minv_cache', None)
        if cached is not None and cached[0] is minv and cached[1] == key:
            return cached[2]
        t = torch.as_tensor(minv, device=device).to(dtype)
        if isfree is not None:
            t = torch.where(torch.as_tensor(isfree, device=device), t, torch.ones((), dtype=dtype, device=device))
        self._device_minv_cache = (minv, key, t)
        return t

    def _masked_op(self, mv_kind, op, op64, isfree):
        '''The masked operator ``m A(m x) + (1 - m) x`` of free mask
        ``isfree`` around the operator (mv_kind, op) and its float64 twin
        ``op64``: ``('masked', mv_kind)``, the mask (in each operand's dtype)
        first in each operand (reference: ``nutils_tpu/matrix.py:538``).
        Kept per mask and operator.'''
        key = isfree.tobytes()
        cached = getattr(self, '_masked_op_cache', None)
        if cached is None or cached[0] != key or cached[1] is not op:
            m = torch.as_tensor(isfree, device=op[0].device)
            cached = self._masked_op_cache = (key, op, ('masked', mv_kind), (m.to(op[0].dtype),) + tuple(op),
                                              (m.to(torch.float64),) + tuple(op64))
        return cached[2:]

    def _mg(self):
        '''Cached geometric-multigrid hierarchy for a matrix whose device
        operator (:meth:`_device_op`) is a grid stencil, on that stencil's
        grid (None for another operator form, or when the grid cannot
        coarsen); see ops/mg.py.'''
        cached = getattr(self, '_mg_cache', '?')
        if cached != '?':
            return cached
        from .ops import mg as _mg
        from .ops import stencil as _stencil
        out = None
        mv_kind, op = self._device_op()
        if mv_kind[0] == 'stencil':
            _kind, ks, gshape, per = mv_kind
            # the hierarchy's pattern-only plans are kept with the pattern
            plans = self._pattern_of().__dict__.setdefault('_mg_plans', {})
            data = _host(self.data)
            out = _mg.setup(_stencil.StencilForm(None, ks, gshape, periodic=per), data, self.indices, self.indptr,
                            dtype=data.dtype, device=op[0].device, plans=plans)
        self._mg_cache = out
        return out

    def _fieldsplit(self):
        '''Cached block-diagonal (fieldsplit) preconditioner for multi-field
        systems: each diagonal field block that is a coarsenable grid stencil
        gets a geometric-multigrid V-cycle (kernels K1-K3), the rest get the
        Schur-aware inverse diagonal.  Returns (kind, operands) or None when
        no field coarsens.'''
        cached = getattr(self, '_fieldsplit_cache', '?')
        if cached != '?':
            return cached
        from .ops import mg as _mgmod
        from .ops import stencil as _st
        from .ops.sparse import schur_diag_inverse
        offsets = tuple(int(o) for o in self._field_offsets)
        A = self._scipy()
        data = _host(self.data)
        dt = data.dtype
        dev = self._weights().device
        minv_full = schur_diag_inverse(data, self.indices, self.indptr, self.shape[0])
        # strong-diagonal test against the FULL row norm: a saddle-point
        # pressure block (diagonal = eps-stabilization only) keeps the
        # Schur-complement scaling
        d_full = A.diagonal()
        rownorm = numpy.sqrt(numpy.asarray(A.multiply(A).sum(axis=1)).ravel())
        strong = numpy.abs(d_full) > 1e-3 * numpy.maximum(rownorm, 1e-300)
        grids = getattr(self, '_field_grids', None)
        kinds, ops = [], []
        any_mg = False
        for i in range(len(offsets) - 1):
            lo, hi = offsets[i], offsets[i + 1]
            Ab = A[lo:hi, lo:hi].tocsr()
            mg = None
            if strong[lo:hi].mean() > 0.9 and Ab.nnz:
                hint = grids[i] if grids is not None else None
                form = _st.from_csr_grid(Ab.data, Ab.indices, Ab.indptr, hint[0]) if hint is not None else None
                if form is None:
                    form = _st.from_csr(Ab.data, Ab.indices, Ab.indptr, hi - lo)
                if form is not None:
                    mg = _mgmod.setup(form, Ab.data, Ab.indices, Ab.indptr, dtype=dt, device=dev)
            if mg is not None:
                kinds.append(('mg', mg.levels))
                ops.append((mg.ws, mg.dinvs, mg.coarse_inv))
                any_mg = True
            else:
                kinds.append('diag')
                ops.append(torch.as_tensor(minv_full[lo:hi].astype(dt), device=dev))
        out = (('fieldsplit', offsets, tuple(kinds)), tuple(ops)) if any_mg else None
        self._fieldsplit_cache = out
        return out

    def _inf_norm(self):
        cached = getattr(self, '_inf_norm_cache', None)
        if cached is None:
            counts = numpy.diff(self.indptr)
            rows = numpy.repeat(numpy.arange(self.shape[0]), counts)
            sums = numpy.zeros(self.shape[0])
            numpy.add.at(sums, rows, numpy.abs(numpy.asarray(_host(self.data), dtype=numpy.float64)))
            cached = self._inf_norm_cache = float(sums.max(initial=0.0))
        return cached

    def _accept(self, x, resnorm, target, dt):
        '''True residual acceptance with the attainable floating-point floor:
        ||b - A x|| cannot drop below ~eps ||A|| ||x|| no matter the solver,
        so a target beneath it is granted at the floor.'''
        if not numpy.isfinite(x).all():
            return False
        if float(resnorm) <= target * 1.001:
            return True
        floor = 16 * numpy.finfo(dt).eps * self._inf_norm() * max(1.0, float(numpy.linalg.norm(x)))
        return float(resnorm) <= floor

    def _device_krylov(self, method, rhs, *, atol, rtol, maxiter=None, restart=100,
                       precon=None, preconargs=None, _isfree=None):
        '''Mixed-precision iteratively refined device Krylov solve: the inner
        CG, GMRES or BiCGStab runs on the device in the assembly dtype inside a float64
        refinement loop whose true residual is computed on the device
        (ops/sparse.refined_solve_op).  Stencil operators get the geometric
        multigrid V-cycle as preconditioner (it also preconditions GMRES on
        nonsymmetric stencils), others the device Schur diagonal; a
        multi-field solve that the diagonal scaling does not carry to the
        target is retried with the fieldsplit preconditioner.  ``_isfree``
        (a boolean mask of the free rows) solves the masked operator
        ``m A(m x) + (1 - m) x`` instead, with neither the multigrid default
        nor the retry, and a diagonal preconditioner set to 1 on the fixed
        rows.  The float64 device residual (of the masked operator, where
        masked) is the acceptance test (``_accept``).'''
        from .ops.sparse import refined_solve_op, widen
        b64 = numpy.asarray(rhs, dtype=numpy.float64)
        target = max(atol, rtol * float(numpy.linalg.norm(b64)))
        mv_kind, op = self._device_op()
        dt = op[0].dtype
        if _isfree is not None:
            _isfree = numpy.asarray(_isfree, dtype=bool)
        kind = minv = None
        if precon is None and _isfree is None and mv_kind[0] == 'stencil':
            mg = self._mg()
            if mg is not None:
                kind = ('mg', mg.levels)
                minv = (mg.ws, mg.dinvs, mg.coarse_inv)
        elif precon == 'fieldsplit' and getattr(self, '_field_offsets', None) is not None:
            # opt-in segregated preconditioner (velocity-block MG + Schur
            # diagonal); also the second tier below
            fs = self._fieldsplit()
            if fs is not None:
                kind, minv = fs
            else:
                precon = None
        if kind is None:
            kind, minv = self._device_precon(precon, preconargs)
            minv = self._device_minv(minv, op[0].device, dt, _isfree if kind == 'diag' else None)
        n = self.shape[0]
        cap = maxiter or max(1024, int(16 * numpy.sqrt(n)))
        op64 = getattr(self, '_op64_cache', None)
        if op64 is None:
            op64 = self._op64_cache = widen(op)
        if _isfree is not None:
            mv_kind, op, op64 = self._masked_op(mv_kind, op, op64, _isfree)
        t0 = time.perf_counter()
        driver = {}
        x, resnorm, iters, rounds = refined_solve_op(
            method, mv_kind, op, b64, target=target, maxiter=cap, restart=restart,
            minv=minv, precon=kind, op64=op64, stats=driver)
        # attribution record for benches/logs: which operator form, precon
        # and iteration counts this solve used, and how its loop ran (graphs
        # or host loop, the chunk, replays, host reads, capture time)
        self._solve_stats = {
            'method': method,
            'op_form': mv_kind[0],
            'precon': kind if isinstance(kind, str) else kind[0],
            'iters': int(iters), 'rounds': int(rounds),
            't_fused': time.perf_counter() - t0,
            'accepted_on_device': False,
            **driver,
        }
        if not self._accept(x, resnorm, target, numpy.float64):
            if precon is None and _isfree is None and getattr(self, '_field_offsets', None) is not None \
                    and self._fieldsplit() is not None:
                # second tier: stiff (diffusion-dominant) multi-field systems
                # defeat the diagonal scaling but converge under the
                # segregated velocity-MG preconditioner
                log.debug(f'{method} with diagonal scaling stalled; retrying with fieldsplit')
                return self._device_krylov(method, rhs, atol=atol, rtol=rtol, maxiter=maxiter,
                                           restart=restart, precon='fieldsplit')
            raise ToleranceNotReached(numpy.where(numpy.isfinite(x), x, 0.0))
        self._solve_stats['accepted_on_device'] = True
        log.debug(f'{method} converged in {iters} device iterations / {rounds} refinement rounds '
                  f'(device resnorm {resnorm:.1e}, target {target:.1e})')
        return x

    def _solve_cg(self, rhs, *, atol, rtol, maxiter=None, precon=None, preconargs=None, _isfree=None):
        '''Preconditioned CG: device inner loop + float64 iterative
        refinement (see _device_krylov).'''
        return self._device_krylov('cg', rhs, atol=atol, rtol=rtol, maxiter=maxiter,
                                   precon=precon, preconargs=preconargs, _isfree=_isfree)

    def _solve_gmres(self, rhs, *, atol, rtol, maxiter=None, restart=100, precon=None, preconargs=None,
                     _isfree=None):
        '''Restarted GMRES(m): device inner loop + float64 iterative
        refinement (see _device_krylov).'''
        return self._device_krylov('gmres', rhs, atol=atol, rtol=rtol, maxiter=maxiter,
                                   restart=restart, precon=precon, preconargs=preconargs, _isfree=_isfree)

    def _solve_bicgstab(self, rhs, *, atol, rtol, maxiter=None, precon=None, preconargs=None, _isfree=None):
        '''Right-preconditioned BiCGStab: device inner loop + float64
        iterative refinement (see _device_krylov).'''
        return self._device_krylov('bicgstab', rhs, atol=atol, rtol=rtol, maxiter=maxiter,
                                   precon=precon, preconargs=preconargs, _isfree=_isfree)


class _MaskedPattern:
    '''The pattern of a masked operator ``M A M + (I - M)`` (``indptr``,
    ``indices``, as :func:`_masked_csr` made it from the CSR matrix
    ``aindptr``, ``aindices``, ``adata`` and the free mask ``isfree``),
    shared by the masked operators of the matrices of one pattern under one
    mask (:meth:`Matrix._masked`): their device tables and operator-form
    and multigrid plans cache here, and their values refill it.'''

    def __init__(self, indptr, indices, shape, aindptr, aindices, adata, isfree):
        self.indptr = indptr
        self.indices = indices
        self.shape = tuple(shape)
        rows = numpy.repeat(numpy.arange(len(aindptr) - 1), numpy.diff(aindptr))
        self._free = isfree[rows] & isfree[aindices]
        self._keep = self._free & (adata != 0)
        self._kept = numpy.flatnonzero(self._keep)
        fixed = numpy.zeros(len(indices), dtype=bool)
        fixed[numpy.asarray(indptr)[numpy.flatnonzero(~isfree)]] = True
        self._fixed, self._slots = numpy.flatnonzero(fixed), numpy.flatnonzero(~fixed)

    def refill(self, data):
        '''The masked operator's values for the values ``data`` of a
        matrix of the source pattern, the bits :func:`_masked_csr` gives;
        None where ``data``'s zeros in the free rows and columns lie
        elsewhere (then the masked pattern is another).'''
        keep = self._free & (data != 0)
        if not numpy.array_equal(keep, self._keep):
            return None
        values = numpy.empty(len(self.indices), dtype=data.dtype)
        values[self._fixed] = 1.
        values[self._slots] = data[self._kept]
        return values


class _Precon:
    '''Preconditioner handle (reference: ``nutils_tpu/matrix.py:1062``):
    the device kinds ``'diag'`` and ``'block'`` carry ``minv`` (an ``[n]``
    or ``[nb, bs, bs]`` host array) for the device Krylov loops, the kind
    ``'host'`` an ``apply`` callable for scipy's solvers; every kind has a
    host apply (:meth:`apply_host`).'''

    def __init__(self, kind, minv=None, apply=None):
        self.kind = kind
        self.minv = minv
        self.apply = apply

    def apply_host(self):
        if self.kind == 'host':
            return self.apply
        if self.kind == 'diag':
            minv = self.minv
            return lambda v: minv * v
        if self.kind == 'block':
            minv = numpy.asarray(self.minv)
            nb, bs, _ = minv.shape

            def apply(v):
                n = len(v)
                vp = numpy.pad(v, (0, nb * bs - n))
                return numpy.einsum('bij,bj->bi', minv, vp.reshape(nb, bs)).ravel()[:n]
            return apply
        raise MatrixError(self.kind)


class _SubMatrix(Matrix):
    '''Lazy view of the rows and columns ``mask`` of a square matrix:
    ``solve`` is a masked solve on the parent, which keeps its stencil form
    and multigrid preconditioner; the CSR arrays materialize only when some
    other operation needs them.'''

    def __init__(self, parent, mask):
        self._parent = parent
        self._mask = numpy.asarray(mask, dtype=bool)
        nf = int(self._mask.sum())
        self.shape = (nf, nf)

    def __getattr__(self, name):
        if name in ('indptr', 'indices', 'data'):
            m = self._parent._scipy()[self._mask][:, self._mask].tocsr()
            self.indptr = m.indptr
            self.indices = m.indices
            self.data = m.data
            return getattr(self, name)
        raise AttributeError(name)

    def __matmul__(self, vec):
        '''The product with the free rows and columns, through the parent's
        device operator in float64: ``(A e(v))[mask]``, ``e(v)`` the vector
        embedded with zeros on the other rows.  The scipy submatrix is not
        built (it took seconds a fresh jacobian at a million dofs).'''
        from .ops.sparse import _make_matvec, widen
        parent = self._parent
        mv_kind, op = parent._device_op()
        op64 = getattr(parent, '_op64_cache', None)
        if op64 is None:
            op64 = parent._op64_cache = widen(op)
        v = numpy.asarray(vec)
        mask = getattr(self, '_mask_device', None)
        if mask is None or mask.device != op[0].device:
            mask = self._mask_device = torch.as_tensor(self._mask, device=op[0].device)
        full = torch.zeros(parent.shape[1], dtype=torch.float64, device=op[0].device)
        full[mask] = torch.as_tensor(v, dtype=torch.float64, device=op[0].device)
        return _host(_make_matvec(mv_kind)(op64, full)[mask])

    def solve(self, rhs=None, *, constrain=None, **kwargs):
        if constrain is None:
            full = numpy.zeros(self._parent.shape[0])
            if rhs is not None:
                full[self._mask] = numpy.asarray(rhs, dtype=float)
            try:
                x = self._parent.solve(full, constrain=~self._mask, **kwargs)
            except ToleranceNotReached as e:  # the best iterate of the free rows
                self._solve_stats = getattr(self._parent, '_solve_stats', None)
                raise ToleranceNotReached(e.best[self._mask]) from e
            self._solve_stats = getattr(self._parent, '_solve_stats', None)
            return x[self._mask]
        return super().solve(rhs, constrain=constrain, **kwargs)


class _StencilMatrix(Matrix):
    '''Matrix whose device payload is a verified grid-stencil weight array
    w[prod(2k_i+1) * prod(shape)] (solver stencil-form jacobian assembly):
    the device solver consumes the stencil directly with zero copies, and
    the CSR data array materializes lazily (host gather) only when some
    other operation needs it.'''

    def __init__(self, pattern, w_flat, ks, grid_shape, csr_map, periodic=None):
        self._pattern_src = pattern  # solver._LazyPattern or SparsePattern
        self.shape = tuple(pattern.shape)
        self._w = w_flat  # torch tensor on the device
        self._ks = tuple(int(k) for k in ks)
        self._grid = tuple(int(s) for s in grid_shape)
        self._csr_map = csr_map  # index array, or 0-arg callable (deferred)
        self._periodic = tuple(bool(p) for p in periodic) if periodic is not None \
            else (False,) * len(self._grid)

    def __getattr__(self, name):
        # the CSR face of the operator materializes on first touch only
        if name in ('indptr', 'indices'):
            pat = self._pattern_src
            self.indptr = pat.indptr
            self.indices = pat.indices
            return getattr(self, name)
        if name == 'data':
            if callable(self._csr_map):
                self._csr_map = self._csr_map()
            self.data = _host(self._w)[self._csr_map]
            return self.data
        raise AttributeError(name)

    def _w64_host(self):
        w64 = getattr(self, '_w64_cache', None)
        if w64 is None:
            w64 = self._w64_cache = numpy.asarray(_host(self._w), dtype=numpy.float64)
        return w64

    def __matmul__(self, vec):
        from .ops import stencil as _st
        v = numpy.asarray(vec)
        return _st.matvec_numpy(self._w64_host(), v, self._ks, self._grid,
                                self._periodic).astype(v.dtype, copy=False)

    def diagonal(self):
        # the center window slot (zero shift on every axis) holds the diagonal
        W = int(numpy.prod([2 * k + 1 for k in self._ks]))
        return _host(self._w).reshape(W, -1)[(W - 1) // 2][:self.shape[0]].astype(numpy.float64)

    def _weights(self):
        return self._device_op()[1][0].reshape(-1)

    def _device_op(self):
        cached = getattr(self, '_device_op_cache', None)
        if cached is None:
            W = int(numpy.prod([2 * k + 1 for k in self._ks]))
            w = self._w if isinstance(self._w, torch.Tensor) \
                else torch.as_tensor(numpy.asarray(self._w), device=config.torch_device())
            cached = self._device_op_cache = (('stencil', self._ks, self._grid, self._periodic),
                                              (w.reshape((W,) + self._grid),))
        return cached


class _BlockGridMatrix(Matrix):
    '''Matrix whose device payload is the flat block-grid weight buffer
    (solver block-grid-form jacobian assembly of multi-field structured
    systems): the Schur diagonal reads it directly, the device solvers read
    its compact operand (the values at the pattern's entries, one gather),
    and the CSR data array materializes lazily (host gather through
    ``csr_map``) only when some other operation needs it.'''

    def __init__(self, pattern, w_flat, meta, sizes, csr_map, woff=None):
        self._pattern = pattern  # pattern-level device-table caches persist across Newton steps
        self.shape = tuple(pattern.shape)
        self._w = w_flat
        self._meta = meta
        self._sizes = tuple(int(s) for s in sizes)
        self._woff = tuple(int(o) for o in woff) if woff is not None \
            else tuple(int(o) for o in numpy.concatenate([[0], numpy.cumsum(self._sizes)[:-1]]))
        self._csr_map = csr_map

    def __getattr__(self, name):
        if name in ('indptr', 'indices'):
            self.indptr = self._pattern.indptr
            self.indices = self._pattern.indices
            return getattr(self, name)
        if name == 'data':
            self.data = _host(self._w)[self._csr_map]
            return self.data
        raise AttributeError(name)

    def _device_data(self):
        '''CSR values gathered on the device from the weight buffer.'''
        w, cmap, _indices, _indptr = self._csr_tables()
        return w[cmap.long()]

    def _weights(self):
        if not isinstance(self._w, torch.Tensor):
            self._w = torch.as_tensor(numpy.asarray(self._w), device=config.torch_device())
        return self._w.reshape(-1)

    def _k5_plan(self):
        '''K5's compact plan of the pattern (:func:`blockgrid_plan`).'''
        return blockgrid_plan(self._pattern, self._meta, self._woff, self._csr_map)

    def _device_op(self):
        '''``('blockgrid', plan)`` and the compact operand: the weights'
        values at the pattern's entries only, gathered on the device once
        per matrix (``ops/blockgrid.pack``).  The float64 operator of the
        refinement widens that operand, not the weight buffer.'''
        cached = getattr(self, '_device_op_cache', None)
        if cached is None:
            from .ops import blockgrid as _bg
            plan = self._k5_plan()
            cached = self._device_op_cache = (('blockgrid', plan), (_bg.pack(self._weights(), plan),))
        return cached


def assemble_block_csr(blocks):
    '''Stitch a dense 2-D grid of Matrix blocks into one CSR matrix on the
    host (reference: ``nutils_tpu/matrix.py:1089``).'''
    import scipy.sparse
    grid = [[b._scipy() for b in row] for row in blocks]
    out = scipy.sparse.bmat(grid, format='csr')
    return Matrix(out.indptr, out.indices, out.data, out.shape)
