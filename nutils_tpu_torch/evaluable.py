'''Batched, statically-shaped expression IR evaluated eagerly on torch tensors.

The node classes, builders and rewrite rules are those of
``nutils_tpu.evaluable`` (numpy-only, copied); what differs is evaluation:

* every ``evalf`` computes on torch tensors on ``config.device``;
* ``_Evaluator`` walks the DAG eagerly (there is no jit): sums over product
  trees become one ``torch.einsum`` each, coordinate gradients (``Grad``)
  are unit-seeded ``torch.func.jvp`` passes, and ``ArgGrad``/``LeafGrad``
  are seeded ``torch.func.jvp`` passes over the argument or leaf binding;
* residual/jacobian assembly (solver.py) differentiates the evaluator with
  ``torch.func.grad``, ``jvp`` and ``vmap``.

Abstract dtypes ``bool``/``int``/``float`` map to concrete dtypes at
evaluation time via ``utils.config`` (float64 for parity, float32 for the
bench slice).
'''

import contextlib
import functools
import itertools

import numpy
import torch
from torch._C import _functorch

from .utils import config

# ------------------------------------------------------------------ helpers

_Tuple = tuple


def _astuple(x):
    return x if isinstance(x, tuple) else tuple(x)


def _norm_axis(axis, ndim):
    if axis < 0:
        axis += ndim
    assert 0 <= axis < ndim, f'axis {axis} out of range for ndim {ndim}'
    return axis


class _ArrayKey:
    '''Hashable wrapper for numpy arrays used in node identity keys.

    Identity is a sha1 content digest computed once over the raw buffer (no
    copy for contiguous arrays): equality of multi-hundred-MB element tables
    is O(1) instead of an ``array_equal`` scan per comparison, which
    dominated System construction at ~1M dofs.'''

    __slots__ = 'array', '_digest', '_hash'

    def __init__(self, array):
        import hashlib
        self.array = array
        a = array if array.flags['C_CONTIGUOUS'] else numpy.ascontiguousarray(array)
        h = hashlib.sha1(str((a.shape, a.dtype.str)).encode())
        if a.size:
            h.update(memoryview(a).cast('B'))
        self._digest = h.digest()
        self._hash = hash(self._digest)

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return isinstance(other, _ArrayKey) and self._digest == other._digest


# ------------------------------------------------------------------ node base

class Array:
    '''Base class of all IR nodes.

    Subclasses set ``children`` (tuple of Array) and ``params`` (hashable
    static attributes) in ``__init__`` and define ``shape``/``dtype``.
    Equality and hashing are structural with a cached key, giving cheap DAG
    deduplication without an intern table.
    '''

    children = ()
    params = ()

    def __init__(self, children, params, shape, dtype):
        self.children = _astuple(children)
        self.params = params
        self.shape = _astuple(shape)
        self.dtype = dtype
        assert all(isinstance(n, (int, numpy.integer)) and n >= 0 for n in self.shape), self.shape
        assert dtype in (bool, int, float), dtype
        self.shape = tuple(int(n) for n in self.shape)
        self._hash = hash((type(self).__name__, self.params, tuple(id(c) if False else hash(c) for c in self.children)))

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        return int(numpy.prod(self.shape, dtype=numpy.int64)) if self.shape else 1

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        if self is other:
            return True
        return type(self) is type(other) and self._hash == other._hash \
            and self.params == other.params and self.children == other.children

    def __repr__(self):
        return f'{type(self).__name__}{list(self.shape)}'

    @functools.cached_property
    def leafdeps(self):
        '''Frozenset of Leaf nodes this expression depends on.'''
        return frozenset().union(*(c.leafdeps for c in self.children)) if self.children else frozenset()

    @functools.cached_property
    def arguments(self):
        '''Frozenset of Argument nodes this expression depends on.'''
        return frozenset().union(*(c.arguments for c in self.children)) if self.children else frozenset()

    @functools.cached_property
    def isconstant(self):
        return not self.arguments and not self.leafdeps

    @functools.cached_property
    def _has_sparse_structure(self):
        '''True if the subtree contains an Inflate or Concatenate (structure
        the contraction-localization rules still need to reach).'''
        return any(c._has_sparse_structure for c in self.children)

    # Subclasses: evalf(*child_values) -> torch tensor.  Nodes whose evaluation
    # needs the evaluator itself (Grad) are special-cased in _Evaluator.

    def _unbroadcast(self, axis):
        '''Return self without ``axis`` if syntactically invariant along it, else None.'''
        return None

    def asciitree(self, maxdepth=8):
        lines = []

        def rec(node, prefix, depth):
            lines.append(f'{prefix}{node!r} {node.dtype.__name__}')
            if depth < maxdepth:
                for c in node.children:
                    rec(c, prefix + '  ', depth + 1)
        rec(self, '', 0)
        return '\n'.join(lines)


# ------------------------------------------------------------------ leaves

class Constant(Array):

    def __init__(self, value):
        value = numpy.asarray(value)
        if value.dtype.kind == 'b':
            dtype = bool
        elif value.dtype.kind in 'iu':
            dtype = int
            value = value.astype(numpy.int64)
        elif value.dtype.kind == 'f':
            dtype = float
            value = value.astype(numpy.float64)
        else:
            raise ValueError(f'unsupported dtype {value.dtype}')
        value.flags.writeable = False
        self.value = value
        super().__init__((), (_ArrayKey(value),), value.shape, dtype)

    def evalf(self):
        raise AssertionError('constants are bound by the evaluator')

    def _unbroadcast(self, axis):
        if self.shape[axis] == 1:
            return Constant(numpy.squeeze(self.value, axis))
        return None


class Argument(Array):
    '''Named runtime input (the solver's trial/test vectors, parameters).'''

    def __init__(self, name, shape, dtype=float):
        self.name = name
        super().__init__((), (name, _astuple(shape), dtype), shape, dtype)

    @functools.cached_property
    def arguments(self):
        return frozenset({self})

    def __repr__(self):
        return f'Argument({self.name!r}){list(self.shape)}'


class Leaf(Array):
    '''Compile-time binding point (sample coordinate tables, localized dofs).

    A Leaf is bound to a concrete array when the compiled function is called,
    via the ``leaves`` dict keyed by ``self.key``.  ``Grad`` nodes
    differentiate with respect to Leafs.
    '''

    def __init__(self, key, shape, dtype=float, value=None):
        self.key = key
        self.value = value  # optional default binding (not part of identity)
        super().__init__((), (key, _astuple(shape), dtype), shape, dtype)

    @functools.cached_property
    def leafdeps(self):
        return frozenset({self})

    def __repr__(self):
        return f'Leaf({self.key!r}){list(self.shape)}'


class Zeros(Array):

    def __init__(self, shape, dtype=float):
        super().__init__((), (_astuple(shape), dtype), shape, dtype)

    def evalf(self):
        raise AssertionError('zeros are bound by the evaluator')


class Range(Array):

    def __init__(self, length):
        self.length = int(length)
        super().__init__((), (self.length,), (self.length,), int)

    def evalf(self):
        raise AssertionError('ranges are bound by the evaluator')


# ------------------------------------------------------------------ structure

class InsertAxis(Array):
    '''Broadcast: insert a new axis of given length at ``axis``.'''

    def __init__(self, func, axis, length):
        axis = _norm_axis(axis, func.ndim + 1)
        self.func = func
        self.axis = axis
        self.length = int(length)
        shape = func.shape[:axis] + (self.length,) + func.shape[axis:]
        super().__init__((func,), (axis, self.length), shape, func.dtype)

    def evalf(self, func):
        return torch.unsqueeze(func, self.axis).expand(self.shape)

    def _unbroadcast(self, axis):
        if axis == self.axis:
            return self.func
        inner = self.func._unbroadcast(axis if axis < self.axis else axis - 1)
        if inner is not None:
            return InsertAxis(inner, self.axis if axis > self.axis else self.axis - 1, self.length)
        return None


class Transpose(Array):

    def __init__(self, func, axes):
        axes = _astuple(axes)
        assert sorted(axes) == list(range(func.ndim))
        self.func = func
        self.axes = axes
        super().__init__((func,), (axes,), tuple(func.shape[i] for i in axes), func.dtype)

    def evalf(self, func):
        return func.permute(self.axes)

    def _unbroadcast(self, axis):
        inner_axis = self.axes[axis]
        inner = self.func._unbroadcast(inner_axis)
        if inner is not None:
            newaxes = tuple(i if i < inner_axis else i - 1 for i in self.axes if i != inner_axis)
            return transpose(inner, newaxes)
        return None


class Ravel(Array):
    '''Merge axes ``axis`` and ``axis+1`` into one.'''

    def __init__(self, func, axis):
        axis = _norm_axis(axis, func.ndim - 1)
        self.func = func
        self.axis = axis
        shape = func.shape[:axis] + (func.shape[axis] * func.shape[axis + 1],) + func.shape[axis + 2:]
        super().__init__((func,), (axis,), shape, func.dtype)

    def evalf(self, func):
        return func.reshape(self.shape)


class Unravel(Array):
    '''Split axis ``axis`` into two axes of lengths (m, n).'''

    def __init__(self, func, axis, m, n):
        axis = _norm_axis(axis, func.ndim)
        assert func.shape[axis] == m * n
        self.func = func
        self.axis = axis
        self.m, self.n = int(m), int(n)
        shape = func.shape[:axis] + (self.m, self.n) + func.shape[axis + 1:]
        super().__init__((func,), (axis, self.m, self.n), shape, func.dtype)

    def evalf(self, func):
        return func.reshape(self.shape)


class Take(Array):
    '''numpy.take semantics: gather ``func`` along ``axis`` at ``indices``.

    Output shape: func.shape[:axis] + indices.shape + func.shape[axis+1:].
    '''

    def __init__(self, func, indices, axis):
        axis = _norm_axis(axis, func.ndim)
        assert indices.dtype == int
        self.func = func
        self.indices = indices
        self.axis = axis
        shape = func.shape[:axis] + indices.shape + func.shape[axis + 1:]
        super().__init__((func, indices), (axis,), shape, func.dtype)

    def evalf(self, func, indices):
        n = func.shape[self.axis]
        idx = indices.reshape(-1).long().clamp(0, n - 1)
        return torch.index_select(func, self.axis, idx).reshape(self.shape)


class Inflate(Array):
    '''Scatter-add axis ``axis`` of ``values`` into a new axis of ``length``.

    ``dofs`` (int) must have the same ndim as ``values`` with each dim equal
    to the corresponding values dim or 1 (explicit broadcast); output
    ``out[..., n, ...] = sum_{L : dofs[..., L, ...] == n} values[..., L, ...]``.
    Duplicate dofs accumulate.  This is the only sparsity-carrying node; the
    builder-level rules in ``multiply``/``sum_`` keep it at the outside of
    expressions so that contractions against it become local gathers.
    '''

    def __init__(self, values, dofs, length, axis):
        axis = _norm_axis(axis, values.ndim)
        assert dofs.dtype == int and dofs.ndim == values.ndim
        assert all(ds in (1, vs) for ds, vs in zip(dofs.shape, values.shape)), (dofs.shape, values.shape)
        self.values = values
        self.dofs = dofs
        self.length = int(length)
        self.axis = axis
        shape = values.shape[:axis] + (self.length,) + values.shape[axis + 1:]
        super().__init__((values, dofs), (self.length, axis), shape, values.dtype)

    @functools.cached_property
    def _has_sparse_structure(self):
        return True

    def evalf(self, values, dofs):
        dofs = dofs.expand(values.shape)
        # Move the scattered axis last, flatten the batch, one segment scatter.
        vm = torch.movedim(values, self.axis, -1)
        dm = torch.movedim(dofs, self.axis, -1)
        batch = tuple(vm.shape[:-1])
        nbatch = int(numpy.prod(batch, dtype=numpy.int64)) if batch else 1
        ids = torch.arange(nbatch, dtype=torch.int64, device=vm.device).reshape(batch + (1,)) * self.length \
            + dm.long()
        flat = torch.zeros(nbatch * self.length, dtype=vm.dtype, device=vm.device) \
            .index_add(0, ids.reshape(-1), vm.reshape(-1))
        out = flat.reshape(batch + (self.length,))
        return torch.movedim(out, -1, self.axis)

    def _unbroadcast(self, axis):
        if axis == self.axis:
            return None
        v = self.values._unbroadcast(axis)
        if v is None or self.dofs.shape[axis] != 1:
            return None
        d = self.dofs._unbroadcast(axis)
        if d is None:
            return None
        return Inflate(v, d, self.length, self.axis - (1 if axis < self.axis else 0))


class GatherAlong(Array):
    '''Batched gather along one axis: out[..., l, ...] = func[..., dofs[..., l, ...], ...].

    ``dofs`` has func.ndim dims, unit-broadcastable against func except along
    ``axis`` where its length L becomes the output length.  This is the dual
    of Inflate and the workhorse of the contraction-localization rules: a
    gather on a broadcast operand gathers without ever materializing the
    broadcast.
    '''

    def __init__(self, func, dofs, axis):
        axis = _norm_axis(axis, func.ndim)
        assert dofs.dtype == int and dofs.ndim == func.ndim
        assert all(i == axis or ds in (1, fs) for i, (ds, fs) in enumerate(zip(dofs.shape, func.shape))), (dofs.shape, func.shape)
        self.func = func
        self.dofs = dofs
        self.axis = axis
        shape = func.shape[:axis] + (dofs.shape[axis],) + func.shape[axis + 1:]
        super().__init__((func, dofs), (axis,), shape, func.dtype)

    def evalf(self, func, dofs):
        n = func.shape[self.axis]
        return torch.take_along_dim(func, dofs.expand(self.shape).long().clamp(0, n - 1), dim=self.axis)


class Concatenate(Array):

    def __init__(self, funcs, axis):
        funcs = _astuple(funcs)
        axis = _norm_axis(axis, funcs[0].ndim)
        assert all(f.ndim == funcs[0].ndim for f in funcs)
        assert all(f.shape[:axis] == funcs[0].shape[:axis] and f.shape[axis + 1:] == funcs[0].shape[axis + 1:] for f in funcs)
        assert all(f.dtype == funcs[0].dtype for f in funcs)
        self.axis = axis
        shape = list(funcs[0].shape)
        shape[axis] = sum(f.shape[axis] for f in funcs)
        super().__init__(funcs, (axis,), tuple(shape), funcs[0].dtype)

    @functools.cached_property
    def _has_sparse_structure(self):
        return True

    def evalf(self, *funcs):
        return torch.cat(funcs, dim=self.axis)


# ------------------------------------------------------------------ arithmetic

class Add(Array):

    def __init__(self, a, b):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
        super().__init__((a, b), (), a.shape, a.dtype)

    def evalf(self, a, b):
        return a + b


class Multiply(Array):

    def __init__(self, a, b):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
        super().__init__((a, b), (), a.shape, a.dtype)

    def evalf(self, a, b):
        return a * b


class Sum(Array):
    '''Sum over a frozenset of axes; compiled as an einsum when the operand is
    a product tree (the per-element quadrature contraction).'''

    def __init__(self, func, axes):
        axes = tuple(sorted(_norm_axis(a, func.ndim) for a in axes))
        assert len(set(axes)) == len(axes) and axes
        self.func = func
        self.axes = axes
        shape = tuple(n for i, n in enumerate(func.shape) if i not in axes)
        super().__init__((func,), (axes,), shape, func.dtype)

    def evalf(self, func):
        return torch.sum(func, dim=self.axes)


class Power(Array):
    '''base ** exp.  When the exponent is a broadcast constant scalar it is
    lowered statically (integer pow / sqrt / python-scalar pow): feeding the
    exponent as a tensor would make the pow jvp emit a log(base) term that
    produces NaN tangents at base == 0 (ubiquitous in FEM: fields vanish on
    element boundaries).'''

    def __init__(self, base, exp):
        assert base.shape == exp.shape and base.dtype == exp.dtype == float
        e = exp
        while isinstance(e, InsertAxis):
            e = e.func
        self.static_exp = float(e.value) if isinstance(e, Constant) and e.ndim == 0 else None
        super().__init__((base, exp), (self.static_exp,), base.shape, float)

    def evalf(self, base, exp):
        p = self.static_exp
        if p is not None:
            if p == 0:
                return torch.ones_like(base)
            if p == int(p) and abs(p) <= 64:
                return torch.pow(base, int(p))
            if p == 0.5:
                return torch.sqrt(base)
            if p == -0.5:
                return torch.rsqrt(base)
            return torch.pow(base, p)
        return base ** exp


class Pointwise(Array):
    '''Unary/binary elementwise math, parameterized by op name.'''

    UNARY = {
        'negative': (lambda d: d, 'negative'),
        'reciprocal': (lambda d: d, 'reciprocal'),
        'sin': (lambda d: d, 'sin'), 'cos': (lambda d: d, 'cos'), 'tan': (lambda d: d, 'tan'),
        'arcsin': (lambda d: d, 'arcsin'), 'arccos': (lambda d: d, 'arccos'), 'arctan': (lambda d: d, 'arctan'),
        'sinh': (lambda d: d, 'sinh'), 'cosh': (lambda d: d, 'cosh'), 'tanh': (lambda d: d, 'tanh'),
        'arctanh': (lambda d: d, 'arctanh'), 'arcsinh': (lambda d: d, 'arcsinh'), 'arccosh': (lambda d: d, 'arccosh'),
        'exp': (lambda d: d, 'exp'), 'log': (lambda d: d, 'log'), 'log2': (lambda d: d, 'log2'), 'log10': (lambda d: d, 'log10'),
        'sqrt': (lambda d: d, 'sqrt'), 'abs': (lambda d: d, 'abs'), 'sign': (lambda d: d, 'sign'),
        'floor': (lambda d: d, 'floor'), 'ceil': (lambda d: d, 'ceil'),
    }
    BINARY = {'arctan2', 'minimum', 'maximum', 'mod', 'floor_divide'}

    def __init__(self, op, *args, dtype=None):
        assert (op in self.UNARY and len(args) == 1) or (op in self.BINARY and len(args) == 2), op
        if len(args) == 2:
            assert args[0].shape == args[1].shape and args[0].dtype == args[1].dtype
        self.op = op
        super().__init__(args, (op,), args[0].shape, dtype if dtype is not None else args[0].dtype)

    _TORCH = {'mod': 'remainder', 'arctan2': 'atan2'}

    def evalf(self, *args):
        return getattr(torch, self._TORCH.get(self.op, self.op))(*args)


class Cast(Array):

    def __init__(self, func, dtype):
        assert dtype in (bool, int, float)
        self.func = func
        super().__init__((func,), (dtype,), func.shape, dtype)

    def evalf(self, func):
        return func.to(_torch_dtype(self.dtype))


class Less(Array):

    def __init__(self, a, b):
        assert a.shape == b.shape and a.dtype == b.dtype
        super().__init__((a, b), (), a.shape, bool)

    def evalf(self, a, b):
        return a < b


class Equal(Array):

    def __init__(self, a, b):
        assert a.shape == b.shape and a.dtype == b.dtype
        super().__init__((a, b), (), a.shape, bool)

    def evalf(self, a, b):
        return a == b


class LogicalNot(Array):

    def __init__(self, a):
        assert a.dtype == bool
        super().__init__((a,), (), a.shape, bool)

    def evalf(self, a):
        return torch.logical_not(a)


class LogicalAnd(Array):

    def __init__(self, a, b):
        assert a.shape == b.shape and a.dtype == b.dtype == bool
        super().__init__((a, b), (), a.shape, bool)

    def evalf(self, a, b):
        return torch.logical_and(a, b)


class Choose(Array):
    '''Elementwise select: where(cond, iftrue, iffalse).'''

    def __init__(self, cond, iftrue, iffalse):
        assert cond.dtype == bool and cond.shape == iftrue.shape == iffalse.shape
        assert iftrue.dtype == iffalse.dtype
        super().__init__((cond, iftrue, iffalse), (), iftrue.shape, iftrue.dtype)

    def evalf(self, cond, iftrue, iffalse):
        return torch.where(cond, iftrue, iffalse)


# ------------------------------------------------------------------ linalg

class Inverse(Array):
    '''Matrix inverse over the last two axes; closed-form for d <= 3 (batched
    elementwise arithmetic, no batched LU).'''

    def __init__(self, func):
        assert func.ndim >= 2 and func.shape[-1] == func.shape[-2] and func.dtype == float
        self.func = func
        super().__init__((func,), (), func.shape, float)

    def evalf(self, A):
        d = self.shape[-1]
        if d == 1:
            return 1.0 / A
        if d == 2:
            a, b, c, dd = A[..., 0, 0], A[..., 0, 1], A[..., 1, 0], A[..., 1, 1]
            det = a * dd - b * c
            inv = torch.stack([torch.stack([dd, -b], -1), torch.stack([-c, a], -1)], -2)
            return inv / det[..., None, None]
        if d == 3:
            cof = _cofactor3(A)
            det = (A[..., 0, 0] * cof[..., 0, 0] + A[..., 0, 1] * cof[..., 0, 1]
                   + A[..., 0, 2] * cof[..., 0, 2])[..., None, None]
            return torch.swapaxes(cof, -1, -2) / det
        return torch.linalg.inv(A)


def _cofactor3(A):
    '''Cofactor matrix of batched 3x3 (cof[i,j] = d det/d A[i,j]).'''
    def minor(i, j):
        rows = [r for r in range(3) if r != i]
        cols = [c for c in range(3) if c != j]
        return A[..., rows[0], cols[0]] * A[..., rows[1], cols[1]] - A[..., rows[0], cols[1]] * A[..., rows[1], cols[0]]
    return torch.stack([torch.stack([minor(i, j) * (-1) ** (i + j) for j in range(3)], -1) for i in range(3)], -2)


class Determinant(Array):

    def __init__(self, func):
        assert func.ndim >= 2 and func.shape[-1] == func.shape[-2] and func.dtype == float
        self.func = func
        super().__init__((func,), (), func.shape[:-2], float)

    def evalf(self, A):
        d = A.shape[-1]
        if d == 1:
            return A[..., 0, 0]
        if d == 2:
            return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
        if d == 3:
            cof = _cofactor3(A)
            return A[..., 0, 0] * cof[..., 0, 0] + A[..., 0, 1] * cof[..., 0, 1] + A[..., 0, 2] * cof[..., 0, 2]
        return torch.linalg.det(A)


class Eigh(Array):
    '''Symmetric eigendecomposition over last two axes; param selects values
    (shape [..., n]) or vectors (shape [..., n, n]).'''

    def __init__(self, func, what):
        assert func.ndim >= 2 and func.shape[-1] == func.shape[-2] and func.dtype == float
        assert what in ('values', 'vectors')
        self.func = func
        self.what = what
        shape = func.shape[:-1] if what == 'values' else func.shape
        super().__init__((func,), (what,), shape, float)

    def evalf(self, A):
        w, v = torch.linalg.eigh(A)
        return w if self.what == 'values' else v


class EigGeneral(Array):
    '''General (non-symmetric) eigendecomposition over the last two axes
    (reference: evaluable.Eig with symmetric=False, evaluable.py:3149).

    ``what`` selects values [..., n] or vectors [..., n, n]; ``part`` selects
    the real or imaginary component — the complex pair is assembled at the
    function layer (function.eig), which carries complex arrays split into
    real/imag.  LAPACK's ``geev`` (``numpy.linalg.eig``) runs on the host,
    as the JAX package's callback runs it, and the part returns to the
    operand's device: nonsymmetric eigensolves are never on a solve's hot
    path, and they have no derivative here as they have none there.'''

    def __init__(self, func, what, part):
        assert func.ndim >= 2 and func.shape[-1] == func.shape[-2] and func.dtype == float
        assert what in ('values', 'vectors') and part in ('real', 'imag')
        self.func = func
        self.what = what
        self.part = part
        shape = func.shape[:-1] if what == 'values' else func.shape
        super().__init__((func,), (what, part), shape, float)

    def evalf(self, A):
        w, v = numpy.linalg.eig(A.detach().cpu().numpy().astype(numpy.float64))
        out = w if self.what == 'values' else v
        out = out.real if self.part == 'real' else out.imag
        return torch.as_tensor(numpy.ascontiguousarray(out), device=A.device).to(A.dtype)


# ------------------------------------------------------------------ calculus

class Grad(Array):
    '''Gradient of ``func`` with respect to the last axis of Leaf ``wrt``.

    Evaluated as ``torch.func.jvp`` passes seeded with the unit vectors of
    the leaf's last axis, with tangents broadcast over the leading (element/point) axes.
    This is valid because all expressions produced by the lowering are
    pointwise in those leading axes.  Output shape: func.shape + (d,).
    '''

    def __init__(self, func, wrt):
        assert isinstance(wrt, Leaf) and wrt.dtype == float and func.dtype == float
        self.func = func
        self.wrt = wrt
        d = wrt.shape[-1]
        super().__init__((func, wrt), (), func.shape + (d,), float)


class ArgGrad(Array):
    '''Directional derivative of ``func`` with respect to the named Argument
    in the direction of ``direction`` (the function-level linearize,
    reference: function.py:1924): evaluated as one ``torch.func.jvp`` pass
    over the argument binding.'''

    def __init__(self, func, name, direction):
        assert func.dtype == float
        self.func = func
        self.name = name
        self.direction = direction
        super().__init__((func, direction), (), func.shape, float)


class LeafGrad(Array):
    '''Directional derivative of ``func`` with respect to the Leaf with the
    given key, in the direction of ``seed`` (shape = leaf shape).  This is the
    localized form of :class:`ArgGrad`: the solver rewrites each ArgGrad over
    a localized argument into a sum of LeafGrads whose seeds are the argument
    direction routed through the same gather tables as the leaf itself, so
    that linearize directions stay element-batched.'''

    def __init__(self, func, key, seed):
        assert func.dtype == float
        self.func = func
        self.key = key
        self.seed = seed
        super().__init__((func, seed), (key,), func.shape, float)


class ArgJac(Array):
    '''Full derivative of ``func`` with respect to the named Argument: output
    shape func.shape + argshape (the function-level ``derivative``, reference:
    function.py:2021).  Evaluated as a single ``torch.func.jacrev`` (when the
    output is no larger than the argument, e.g. gradients of scalar
    functionals) or ``jacfwd`` pass over the argument binding.'''

    def __init__(self, func, name, argshape):
        assert func.dtype == float
        self.func = func
        self.name = name
        self.argshape = _astuple(int(n) for n in argshape)
        super().__init__((func,), (name, self.argshape), func.shape + self.argshape, float)

    @functools.cached_property
    def arguments(self):
        return self.func.arguments | {Argument(self.name, self.argshape)}


class CustomNode(Array):
    '''User-supplied operation (the IR side of function.Custom;
    reference: function.py:665).  ``fn(*args)`` receives each operand as a
    torch tensor with its leading ``nprefix`` (element/point) axes flattened
    into one, and must return a tensor of shape (npoints,) + pershape,
    computed with torch operations: derivatives flow through ``torch.func``.
    An optional ``partials(iarg, *args)`` callback (returning d out/d
    args[iarg], shape (npoints,) + pershape + args[iarg].shape[1:]) overrides
    them through a ``torch.autograd.Function`` whose ``jvp`` and
    ``backward`` contract the partials with the tangents (the JAX package's
    ``jax.custom_jvp``).'''

    def __init__(self, fn, args, pershape, dtype, nprefix, partials=None):
        args = _astuple(args)
        self.fn = fn
        self.partials = partials
        self.nprefix = int(nprefix)
        self.pershape = _astuple(int(n) for n in pershape)
        prefix = args[0].shape[:self.nprefix] if args else ()
        assert all(a.shape[:self.nprefix] == prefix for a in args), 'inconsistent leading axes'
        super().__init__(args, (getattr(fn, '__qualname__', repr(fn)), fn, partials, self.nprefix, self.pershape, dtype),
                         prefix + self.pershape, dtype)

    @functools.cached_property
    def _wrapped(self):
        if self.partials is None:
            return self.fn
        fn, partials, pershape = self.fn, self.partials, self.pershape
        out_size = int(numpy.prod(pershape, dtype=numpy.int64))

        def flat_partials(primals):
            # [(i, d out / d args[i] as [n, out_size, arg_size], arg_size)]
            for i, a in enumerate(primals):
                arg_size = int(numpy.prod(a.shape[1:], dtype=numpy.int64))
                yield i, torch.reshape(partials(i, *primals), (a.shape[0], out_size, arg_size)), arg_size

        class Partials(torch.autograd.Function):
            generate_vmap_rule = True

            @staticmethod
            def forward(*args):
                return fn(*args)

            @staticmethod
            def setup_context(ctx, inputs, output):
                ctx.save_for_forward(*inputs)
                ctx.save_for_backward(*inputs)

            @staticmethod
            def jvp(ctx, *tangents):
                primals = ctx.saved_tensors
                n = primals[0].shape[0]
                tot = None
                for i, p, arg_size in flat_partials(primals):
                    if tangents[i] is None:
                        continue
                    term = torch.einsum('nij,nj->ni', p, torch.reshape(tangents[i], (n, arg_size)))
                    tot = term if tot is None else tot + term
                return torch.reshape(tot, (n,) + pershape)

            @staticmethod
            def backward(ctx, grad):
                primals = ctx.saved_tensors
                n = primals[0].shape[0]
                g = torch.reshape(grad, (n, out_size))
                return tuple(torch.reshape(torch.einsum('nij,ni->nj', p, g), primals[i].shape)
                             for i, p, _arg_size in flat_partials(primals))
        return Partials.apply

    def evalf(self, *vals):
        k = self.nprefix
        pshape = tuple(vals[0].shape[:k]) if vals else ()
        npts = int(numpy.prod(pshape, dtype=numpy.int64)) if pshape else 1
        flat = [torch.reshape(v, (npts,) + tuple(v.shape[k:])) for v in vals]
        out = self._wrapped(*flat)
        assert tuple(out.shape) == (npts,) + self.pershape, \
            f'Custom evalf returned shape {tuple(out.shape)}, expected {(npts,) + self.pershape}'
        return torch.reshape(out, pshape + self.pershape)


class Monomials(Array):
    '''Power features [1, x, x^2, ..., x^(K-1)] appended as a new last axis.

    Evaluated as a running product so that the jvp at x=0 is well defined
    (naive x**k produces NaN tangents at zero).
    '''

    def __init__(self, func, count):
        assert func.dtype == float
        self.func = func
        self.count = int(count)
        super().__init__((func,), (self.count,), func.shape + (self.count,), float)

    def evalf(self, x):
        # the running product 1, 1*x, (1*x)*x, ... multiplies in the same
        # order as the JAX package's cumprod, and its jvp is as NaN-free;
        # torch's scan kernels are slow over so short an axis
        powers = [torch.ones_like(x)]
        for _ in range(self.count - 1):
            powers.append(powers[-1] * x)
        return torch.stack(powers, dim=-1)


class Legendre(Array):
    '''Legendre polynomials P_0..P_degree of ``func``, appended as a last axis.'''

    def __init__(self, func, degree):
        assert func.dtype == float
        self.func = func
        self.degree = int(degree)
        super().__init__((func,), (self.degree,), func.shape + (self.degree + 1,), float)

    def evalf(self, x):
        polys = [torch.ones_like(x)]
        if self.degree >= 1:
            polys.append(x)
        for n in range(1, self.degree):
            polys.append(((2 * n + 1) * x * polys[n] - n * polys[n - 1]) / (n + 1))
        return torch.stack(polys, dim=-1)


# ------------------------------------------------------------------ dtype map

def _concrete_dtype(dtype):
    if dtype is bool:
        return numpy.bool_
    if dtype is int:
        return config.int_dtype()
    return config.float_dtype()


def _torch_dtype(dtype):
    return config.torch_dtype(_concrete_dtype(dtype))


# ------------------------------------------------------------------ builders

def constant(value):
    return Constant(value)


def asarray(value):
    if isinstance(value, Array):
        return value
    return Constant(value)


def zeros(shape, dtype=float):
    return Zeros(tuple(shape), dtype)


def ones(shape, dtype=float):
    out = Constant(numpy.ones((), dtype=numpy.float64 if dtype is float else numpy.int64))
    for i, n in enumerate(shape):
        out = InsertAxis(out, i, n)
    return out


def insertaxis(func, axis, length):
    axis = _norm_axis(axis, func.ndim + 1)
    if isinstance(func, Zeros):
        return Zeros(func.shape[:axis] + (int(length),) + func.shape[axis:], func.dtype)
    if isinstance(func, Inflate):
        # keep the scatter at the outside so contraction rules can see it
        new_ax = func.axis + (1 if axis <= func.axis else 0)
        return inflate(insertaxis(func.values, axis, length),
                       InsertAxis(func.dofs, axis, 1), func.length, new_ax)
    if isinstance(func, Concatenate):
        new_ax = func.axis + (1 if axis <= func.axis else 0)
        return Concatenate([insertaxis(p, axis, length) for p in func.children], new_ax)
    return InsertAxis(func, axis, length)


def transpose(func, axes):
    axes = _astuple(axes)
    if axes == tuple(range(func.ndim)):
        return func
    if isinstance(func, Zeros):
        return Zeros(tuple(func.shape[i] for i in axes), func.dtype)
    if isinstance(func, Transpose):
        return transpose(func.func, tuple(func.axes[i] for i in axes))
    if isinstance(func, Inflate):
        return inflate(transpose(func.values, axes), transpose(func.dofs, axes),
                       func.length, axes.index(func.axis))
    if isinstance(func, Concatenate):
        return Concatenate([transpose(p, axes) for p in func.children], axes.index(func.axis))
    return Transpose(func, axes)


def ravel(func, axis):
    axis = _norm_axis(axis, func.ndim - 1)
    if isinstance(func, Zeros):
        return Zeros(func.shape[:axis] + (func.shape[axis] * func.shape[axis + 1],) + func.shape[axis + 2:], func.dtype)
    if func.shape[axis] == 1:
        return _squeeze(func, axis)
    if func.shape[axis + 1] == 1:
        return _squeeze(func, axis + 1)
    return Ravel(func, axis)


def _squeeze(func, axis):
    assert func.shape[axis] == 1
    dropped = func._unbroadcast(axis)
    if dropped is not None:
        return dropped
    return Ravel(func, axis if axis < func.ndim - 1 else axis - 1)


def unravel(func, axis, m, n):
    if isinstance(func, Zeros):
        axis = _norm_axis(axis, func.ndim)
        return Zeros(func.shape[:axis] + (m, n) + func.shape[axis + 1:], func.dtype)
    return Unravel(func, axis, m, n)


def add(a, b):
    a, b = asarray(a), asarray(b)
    if isinstance(a, Zeros):
        return b
    if isinstance(b, Zeros):
        return a
    if isinstance(a, Constant) and isinstance(b, Constant):
        return Constant(a.value + b.value)
    return Add(a, b)


def multiply(a, b):
    a, b = asarray(a), asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if isinstance(a, Zeros) or isinstance(b, Zeros):
        return Zeros(a.shape, a.dtype)
    if isinstance(a, Constant) and isinstance(b, Constant):
        return Constant(a.value * b.value)
    # Sparsity rule: a product with an Inflate localizes unconditionally,
    # since inflate(v)[..,n] * y[..,n] == inflate(v * y[..,dofs,..])[..,n]
    # (duplicate-dof accumulation distributes over the product).  This keeps
    # the scatter at the outside of every expression so that contractions
    # against it become per-element gathers (see ``sum_``).
    for x, y in ((a, b), (b, a)):
        if isinstance(x, Inflate):
            L = x.values.shape[x.axis]
            y_local = gather_along(y, x.dofs, x.axis, L)
            return inflate(multiply(x.values, y_local), x.dofs, x.length, x.axis)
    return Multiply(a, b)


def negative(x):
    x = asarray(x)
    if isinstance(x, Zeros):
        return x
    if isinstance(x, Constant):
        return Constant(-x.value)
    if x.dtype == float:
        return Pointwise('negative', x)
    return Pointwise('negative', x)


def subtract(a, b):
    return add(a, negative(b))


def sum_(func, axes):
    if isinstance(axes, int):
        axes = (axes,)
    axes = tuple(sorted(_norm_axis(a, func.ndim) for a in axes))
    if not axes:
        return func
    if isinstance(func, Zeros):
        return Zeros(tuple(n for i, n in enumerate(func.shape) if i not in axes), func.dtype)
    if isinstance(func, Sum):
        # merge nested sums: remap our axes to the inner operand's axes
        inner_axes = set(func.axes)
        remaining = [i for i in range(func.func.ndim) if i not in inner_axes]
        return sum_(func.func, tuple(func.axes) + tuple(remaining[a] for a in axes))
    if isinstance(func, Inflate):
        if func.axis in axes:
            # full sum over a scattered axis == sum over the local axis
            return sum_(func.values, axes)
        # dofs invariant along summed axes: move the sum inside; otherwise
        # fold the summed axes into the scattered axis (scatter accumulates).
        dofs = func.dofs
        dep_axes = [a for a in axes if dofs.shape[a] != 1]
        if not dep_axes:
            sq = dofs
            for a in reversed(axes):
                sq = _drop_unit_axis(sq, a)
            newaxis = func.axis - sum(1 for a in axes if a < func.axis)
            return Inflate(sum_(func.values, axes), sq, func.length, newaxis)
        return _fold_sum_into_inflate(func, axes)
    if isinstance(func, Multiply):
        # search the whole product tree for a scatter (Inflate) or block
        # structure (Concatenate) whose structural axis is being contracted;
        # the basis-dot-argument pattern may be arbitrarily nested in products
        # (e.g. Piola-transformed bases).
        factors = _decompose_product(func)
        if len(factors) > 1:
            for fi, f in enumerate(factors):
                core = f.core
                if isinstance(core, (Inflate, Concatenate)):
                    core_struct_ax = core.axis
                    prod_axes = [pa for pa, ca in enumerate(f.axismap) if ca == core_struct_ax]
                    if prod_axes and prod_axes[0] in axes:
                        x = _rebuild_factor(f, func.shape)  # bubbling rules keep the structure on top
                        y = None
                        for gj, g in enumerate(factors):
                            if gj != fi:
                                gfull = _rebuild_factor(g, func.shape)
                                y = gfull if y is None else multiply(y, gfull)
                        if isinstance(x, Inflate) and x.axis in axes:
                            L = x.values.shape[x.axis]
                            return sum_(multiply(x.values, gather_along(y, x.dofs, x.axis, L)), axes)
                        if isinstance(x, Concatenate) and x.axis in axes:
                            out = None
                            offset = 0
                            for part in x.children:
                                n_i = part.shape[x.axis]
                                y_i = take(y, Constant(numpy.arange(offset, offset + n_i)), x.axis)
                                term = sum_(multiply(part, y_i), axes)
                                out = term if out is None else add(out, term)
                                offset += n_i
                            return out
            # no directly visible structure: flatten one nested contraction
            # (sum-of-products inside a factor) into this sum so that deeper
            # Inflate/Concatenate structure becomes reachable; restricted to
            # factors that still hide such structure, to avoid blowing up
            # ordinary products of contractions
            for fi, f in enumerate(factors):
                if isinstance(f.core, Sum) and f.core.func._has_sparse_structure:
                    inner = f.core.func
                    in_axes = f.core.axes
                    k = len(in_axes)
                    newshape = func.shape + tuple(inner.shape[a] for a in in_axes)
                    sum_out_to_op = [i for i in range(inner.ndim) if i not in in_axes]
                    newfs = []
                    for gj, g in enumerate(factors):
                        if gj == fi:
                            amap = tuple(sum_out_to_op[ca] if ca is not None else None for ca in g.axismap) + tuple(in_axes)
                            newfs.append(_Factor(inner, amap))
                        else:
                            newfs.append(_Factor(g.core, tuple(g.axismap) + (None,) * k))
                    newfunc = None
                    for g in newfs:
                        gfull = _rebuild_factor(g, newshape)
                        newfunc = gfull if newfunc is None else multiply(newfunc, gfull)
                    return sum_(newfunc, tuple(axes) + tuple(range(func.ndim, func.ndim + k)))
    return Sum(func, axes)


def _rebuild_factor(f, shape):
    '''Reassemble a _Factor (core + axismap) into a node of the full product
    shape via transpose + insertaxis (whose builder rules re-bubble any
    Inflate inside the core to the outside).'''
    core = f.core
    mapped = [(pa, ca) for pa, ca in enumerate(f.axismap) if ca is not None]
    perm = tuple(ca for pa, ca in mapped)
    out = transpose(core, perm) if perm != tuple(range(core.ndim)) else core
    for pa, ca in enumerate(f.axismap):
        if ca is None:
            out = insertaxis(out, pa, shape[pa])
    assert out.shape == tuple(shape)
    return out


def _drop_unit_axis(node, axis):
    assert node.shape[axis] == 1
    dropped = node._unbroadcast(axis)
    if dropped is not None:
        return dropped
    return ravel(node, axis if axis < node.ndim - 1 else axis - 1)


def _fold_sum_into_inflate(func, axes):
    '''Rewrite sum_axes(Inflate(v, d, n, ax)) with axis-dependent dofs into a
    single Inflate whose scattered axis absorbs the summed axes (duplicate
    dofs accumulate), avoiding a dense [batch, length] intermediate.  This is
    the residual-assembly path: sum over elements of per-element scatters
    becomes one segment-sum.'''
    v = func.values
    ax = func.axis
    order = [i for i in range(v.ndim) if i not in axes and i != ax] + list(axes) + [ax]
    vt = transpose(v, order)
    dt = transpose(_broadcast_like(func.dofs, v), order)
    for _ in range(len(axes)):  # merge the summed axes into the scattered axis
        vt = ravel(vt, vt.ndim - 2)
        dt = ravel(dt, dt.ndim - 2)
    out = Inflate(vt, dt, func.length, vt.ndim - 1)
    # move the scattered axis back to its place among the remaining axes
    remaining = [i for i in range(v.ndim) if i not in axes and i != ax]
    pos = sum(1 for i in remaining if i < ax)
    perm = list(range(out.ndim - 1))
    perm.insert(pos, out.ndim - 1)
    return transpose(out, perm)


def _broadcast_like(d, v):
    '''Broadcast int array node d (unit dims) to v's shape via insertaxis.'''
    out = d
    for i, (ds, vs) in enumerate(zip(d.shape, v.shape)):
        if ds == 1 and vs != 1:
            out = insertaxis(_drop_unit_axis(out, i), i, vs)
    assert out.shape == v.shape
    return out


def gather_along(y, dofs, axis, L):
    '''Batched gather of y along ``axis`` at ``dofs`` (length L); see GatherAlong.'''
    axis = _norm_axis(axis, y.ndim)
    if isinstance(y, Zeros):
        return Zeros(y.shape[:axis] + (L,) + y.shape[axis + 1:], y.dtype)
    y0 = y._unbroadcast(axis)
    if y0 is not None:  # y constant along the gathered axis: pure broadcast
        return insertaxis(y0, axis, L)
    if isinstance(y, Constant) and isinstance(dofs, Constant):
        return Constant(numpy.take_along_axis(y.value, numpy.broadcast_to(dofs.value, y.shape[:axis] + (L,) + y.shape[axis + 1:]), axis=axis))
    if False and isinstance(y, InsertAxis) and y.axis != axis and dofs.shape[y.axis] == 1:
        # Push the gather through an unrelated broadcast axis, so localization
        # reaches the pre-broadcast operand without materializing it.  The
        # guard is essential: when the gather indices VARY along the broadcast
        # axis, dropping that axis from the dofs silently gathers the same
        # indices everywhere (the round-1 reverted-pushdown bug class, caught
        # by tests/test_evaluable_rewrites.py
        # test_gather_along_dofs_vary_along_other_axis_equiv).
        inner_axis = axis if axis < y.axis else axis - 1
        d = _drop_unit_axis(dofs, y.axis)
        return insertaxis(gather_along(y.func, d, inner_axis, L), y.axis, y.length)
    if isinstance(y, (Multiply, Add)):  # gathers distribute over pointwise ops
        cls = add if isinstance(y, Add) else multiply
        return cls(gather_along(y.children[0], dofs, axis, L), gather_along(y.children[1], dofs, axis, L))
    if isinstance(y, Sum):  # gathers commute with sums over other axes
        inner_axes = y.axes
        # map our axis (in y's reduced shape) to the operand's axis
        remaining = [i for i in range(y.func.ndim) if i not in inner_axes]
        op_axis = remaining[axis]
        d = dofs
        for a in sorted(inner_axes):
            d = InsertAxis(d, a, 1)
        return sum_(gather_along(y.func, d, op_axis, L), inner_axes)
    return GatherAlong(y, dofs, axis)


def take(func, indices, axis):
    indices = asarray(indices)
    axis = _norm_axis(axis, func.ndim)
    if isinstance(func, Zeros):
        return Zeros(func.shape[:axis] + indices.shape + func.shape[axis + 1:], func.dtype)
    if isinstance(func, Constant) and isinstance(indices, Constant):
        # fold only non-expanding gathers: folding an element-upsampling
        # gather (few variant rows -> per-element table) would materialize
        # the dense table the variant compression exists to avoid
        result_size = (func.size // max(func.shape[axis], 1)) * indices.size
        if result_size <= max(func.size, 4096):
            return Constant(numpy.take(func.value, indices.value, axis=axis))
    if isinstance(func, InsertAxis):
        if func.axis == axis:
            out = func.func
            for i, n in enumerate(indices.shape):
                out = insertaxis(out, axis + i, n)
            return out
        # push the gather through an unrelated broadcast axis
        inner_axis = axis if axis < func.axis else axis - 1
        inner = take(func.func, indices, inner_axis)
        new_pos = func.axis if func.axis < axis else func.axis + indices.ndim - 1
        return insertaxis(inner, new_pos, func.length)
    if isinstance(func, (Multiply, Add)):  # gathers distribute over pointwise ops
        cls = add if isinstance(func, Add) else multiply
        return cls(take(func.children[0], indices, axis), take(func.children[1], indices, axis))
    return Take(func, indices, axis)


def power(base, exp):
    base, exp = asarray(base), asarray(exp)
    if isinstance(exp, Constant) and exp.ndim == 0:
        e = float(exp.value)
        if e == 1:
            return base
        if e == 0:
            return ones(base.shape)
        if isinstance(base, Constant):
            return Constant(base.value ** e)
    if exp.shape != base.shape:
        assert exp.ndim == 0
        for i, n in enumerate(base.shape):
            exp = insertaxis(exp, i, n)
    return Power(base, exp)


def inflate(values, dofs, length, axis):
    if isinstance(values, Zeros):
        axis = _norm_axis(axis, values.ndim)
        return Zeros(values.shape[:axis] + (int(length),) + values.shape[axis + 1:], values.dtype)
    return Inflate(values, dofs, length, axis)


def pointwise(op, *args, dtype=None):
    args = tuple(asarray(a) for a in args)
    if all(isinstance(a, Constant) for a in args):
        return Constant(getattr(numpy, op if op != 'abs' else 'absolute')(*[a.value for a in args]))
    return Pointwise(op, *args, dtype=dtype)


def astype(func, dtype):
    func = asarray(func)
    if func.dtype == dtype:
        return func
    if isinstance(func, Constant):
        return Constant(func.value.astype(numpy.float64 if dtype is float else numpy.int64 if dtype is int else bool))
    if isinstance(func, Zeros):
        return Zeros(func.shape, dtype)
    if isinstance(func, InsertAxis):  # keep broadcast structure visible outside
        return insertaxis(astype(func.func, dtype), func.axis, func.length)
    if isinstance(func, Transpose):
        return transpose(astype(func.func, dtype), func.axes)
    return Cast(func, dtype)


def grad(func, wrt):
    if isinstance(func, Zeros) or wrt not in func.leafdeps:
        return Zeros(func.shape + (wrt.shape[-1],), float)
    # Structural pushdowns: the gradient is linear and acts pointwise in
    # non-coordinate axes, so it commutes with scatters (Inflate), broadcasts,
    # transposes and concatenations.  Keeping the Inflate OUTSIDE the Grad is
    # what lets the contraction-localization rules in ``multiply``/``sum_``
    # reach the basis scatter of k-indexed (vector) residuals — a bare
    # ``∇_i(basis_k)`` otherwise hides its dof structure inside the jvp trace
    # and the synthetic test argument of System([res], trial=...) degrades to
    # a dense localization (reference analogue: evaluable derivative rules,
    # reference evaluable.py:1502+ per-node _derivative).
    if isinstance(func, Inflate) and wrt not in func.dofs.leafdeps and not func.dofs.arguments:
        g = grad(func.values, wrt)
        dofs = InsertAxis(func.dofs, func.dofs.ndim, 1)
        return inflate(g, dofs, func.length, func.axis)
    if isinstance(func, InsertAxis):
        return insertaxis(grad(func.func, wrt), func.axis, func.length)
    if isinstance(func, Transpose):
        return transpose(grad(func.func, wrt), tuple(func.axes) + (func.ndim,))
    if isinstance(func, Add) and func._has_sparse_structure:
        return add(grad(func.children[0], wrt), grad(func.children[1], wrt))
    if isinstance(func, Concatenate) and func._has_sparse_structure:
        return Concatenate(tuple(grad(f, wrt) for f in func.children), func.axis)
    return Grad(func, wrt)


# ------------------------------------------------------------ sparse sanitizer
#
# NUTILS_TPU_TORCH_DEBUG=sparse (the analogue of the reference's NUTILS_DEBUG=sparse
# ``verify_sparse_chunks``, evaluable.py:440): every call of a rewriting
# builder additionally constructs the naive (rewrite-free) node and verifies
# both evaluate identically on random float bindings.  Catches any
# semantics-changing rewrite (e.g. the round-1 reverted gather_along pushdown)
# at the exact call site that introduced it.

_SANITIZE_MAX_SIZE = 65536
_sanitize_guard = [False]


def _sanitize_bindings(*nodes, seed=0):
    rng = numpy.random.RandomState(seed)
    args, leaves = {}, {}
    for node in nodes:
        for a in node.arguments:
            if a.dtype != float:
                return None  # cannot randomize ints (may be used as indices)
            args.setdefault(a.name, rng.uniform(-1, 1, a.shape))
        for l in node.leafdeps:
            if l.value is not None:
                continue
            if l.dtype != float:
                return None
            leaves.setdefault(l.key, rng.uniform(-1, 1, l.shape))
    return args, leaves


def _assert_rewrite_equivalent(built, naive, what):
    assert built.shape == naive.shape and built.dtype == naive.dtype, \
        f'sparse-debug: {what} changed shape/dtype ({built.shape}/{built.dtype} vs {naive.shape}/{naive.dtype})'
    if built.size > _SANITIZE_MAX_SIZE or any(c.size > _SANITIZE_MAX_SIZE for c in naive.children):
        return
    b = _sanitize_bindings(built, naive)
    if b is None:
        return
    args, leaves = b
    cpu = torch.device('cpu')
    x = Compiled(built).trace(args, leaves, cpu).numpy()
    y = Compiled(naive).trace(args, leaves, cpu).numpy()
    numpy.testing.assert_allclose(
        x, y, rtol=1e-10, atol=1e-12,
        err_msg=f'sparse-debug: builder {what} rewrite changed semantics')


def _sanitized(make_naive):
    def deco(builder):
        @functools.wraps(builder)
        def wrapped(*args, **kw):
            from .utils import config
            out = builder(*args, **kw)
            if _sanitize_guard[0] or not config.debug_enabled('sparse') or not isinstance(out, Array):
                return out
            _sanitize_guard[0] = True
            try:
                try:
                    naive = make_naive(*args, **kw)
                except Exception:
                    return out  # builder-side normalization has no naive twin
                if naive is not None:
                    _assert_rewrite_equivalent(out, naive, builder.__name__)
            finally:
                _sanitize_guard[0] = False
            return out
        return wrapped
    return deco


insertaxis = _sanitized(lambda func, axis, length: InsertAxis(func, axis, length))(insertaxis)
transpose = _sanitized(lambda func, axes: Transpose(func, _astuple(axes)) if _astuple(axes) != tuple(range(func.ndim)) else None)(transpose)
ravel = _sanitized(lambda func, axis: Ravel(func, axis))(ravel)
add = _sanitized(lambda a, b: Add(asarray(a), asarray(b)))(add)
multiply = _sanitized(lambda a, b: Multiply(asarray(a), asarray(b)))(multiply)
sum_ = _sanitized(lambda func, axes: Sum(func, (axes,) if isinstance(axes, int) else axes) if (axes if isinstance(axes, int) else tuple(axes)) != () else None)(sum_)
gather_along = _sanitized(lambda y, dofs, axis, L: GatherAlong(y, dofs, axis))(gather_along)
take = _sanitized(lambda func, indices, axis: Take(func, asarray(indices), axis))(take)
inflate = _sanitized(lambda values, dofs, length, axis: Inflate(values, dofs, length, axis))(inflate)


# ------------------------------------------------------------------ analysis

@functools.cache
def _poly_degree(node, names):
    '''Polynomial degree of ``node`` in the Arguments named in ``names``;
    numpy.inf for non-polynomial dependence, 0 for independence.  Used by the
    solver for is_linear / is_constant_matrix detection (the reference derives
    the same facts from its symbolic jacobian, solver.py:255-256).'''
    if isinstance(node, Argument):
        return 1 if node.name in names else 0
    if isinstance(node, Leaf):
        return 1 if node.key in names else 0
    if not any(arg.name in names for arg in node.arguments) and not any(l.key in names for l in node.leafdeps):
        return 0
    if isinstance(node, (Add, Concatenate, Choose)):
        return max(_poly_degree(c, names) for c in node.children)
    if isinstance(node, Multiply):
        return sum(_poly_degree(c, names) for c in node.children)
    if isinstance(node, (InsertAxis, Transpose, Ravel, Unravel, Sum, Inflate, Cast)):
        return _poly_degree(node.children[0], names)
    if isinstance(node, Pointwise) and node.op == 'negative':
        return _poly_degree(node.children[0], names)
    if isinstance(node, (Take, GatherAlong)):
        return _poly_degree(node.children[0], names) if not any(a.name in names for a in node.children[1].arguments) else numpy.inf
    if isinstance(node, Power):
        base, exp = node.children
        if not any(a.name in names for a in exp.arguments) and isinstance(exp, (Constant, InsertAxis)):
            e = exp
            while isinstance(e, InsertAxis):
                e = e.func
            if isinstance(e, Constant) and e.ndim == 0 and float(e.value) == int(e.value) and e.value >= 0:
                return _poly_degree(base, names) * int(e.value)
        return numpy.inf
    if isinstance(node, Grad):
        return _poly_degree(node.func, names)
    if isinstance(node, ArgGrad):
        d = _poly_degree(node.func, names)
        if node.name in names and d > 0:
            d = d - 1
        return d + _poly_degree(node.direction, names)
    if isinstance(node, ArgJac):
        d = _poly_degree(node.func, names)
        if node.name in names and d > 0:
            d = d - 1
        return d
    if isinstance(node, LeafGrad):
        return _poly_degree(node.func, names) + _poly_degree(node.seed, names)
    return numpy.inf


def poly_degree(node, names):
    '''Polynomial degree of ``node`` in the Arguments named in ``names`` and
    the Leafs whose keys are in ``names``.'''
    return _poly_degree(node, frozenset(names))


class _Coupled(Exception):
    '''A node mixes the values of different points (see _point_axes).'''


_POINTWISE = (Add, Multiply, Pointwise, Power, Cast, Choose, Less, Equal, LogicalNot, LogicalAnd)
_LINEAR = (Add, Multiply, Sum, InsertAxis, Transpose)


def _point_axes(root, sources, npt, allow_grad=False):
    '''Where the ``npt`` leading (element and point) axes of the leaves
    ``sources`` sit in each node of ``root`` that depends on them: {node:
    tuple of axis positions, None for an axis summed away}.  Raises _Coupled
    where a node mixes the values of different points: a ravel, gather or
    matrix operation over a point axis, a node that is not pointwise in
    them, or anything but a linear map (a sum, a broadcast, a sum or a
    product with an independent factor) after a sum over a point axis.
    With ``allow_grad`` a Grad of a dependent function is
    pointwise (the evaluator's Grad assumes it); without, it is refused: a
    leaf that stands for a function of the coordinates would differentiate
    to zero.'''
    keys = {leaf.key for leaf in sources}
    pos = {}
    for node in find(root, lambda n: any(l.key in keys for l in n.leafdeps)):
        if isinstance(node, Leaf):
            pos[node] = tuple(range(npt))
            continue
        kids = [pos[c] for c in node.children if c in pos]
        p = kids[0]
        summed = None in p
        if summed and not (isinstance(node, _LINEAR) or isinstance(node, Pointwise) and node.op == 'negative'):
            raise _Coupled(node)
        if isinstance(node, InsertAxis):
            p = tuple(x if x is None or x < node.axis else x + 1 for x in p)
        elif isinstance(node, Transpose):
            p = tuple(None if x is None else node.axes.index(x) for x in p)
        elif isinstance(node, Sum):
            p = tuple(None if x is None or x in node.axes else x - sum(a < x for a in node.axes) for x in p)
        elif isinstance(node, _POINTWISE):
            if any(k != p for k in kids) or summed and isinstance(node, Multiply) and len(kids) > 1:
                raise _Coupled(node)
        elif isinstance(node, (Monomials, Legendre)) or allow_grad and isinstance(node, Grad) \
                and node.wrt not in pos:
            pass
        elif isinstance(node, (Inverse, Determinant)):
            if any(x >= node.func.ndim - 2 for x in p):
                raise _Coupled(node)
        elif isinstance(node, Ravel):
            if node.axis in p or node.axis + 1 in p:
                raise _Coupled(node)
            p = tuple(x - (x > node.axis) for x in p)
        elif isinstance(node, Unravel):
            if node.axis in p:
                raise _Coupled(node)
            p = tuple(x + (x > node.axis) for x in p)
        elif isinstance(node, Take) and node.indices not in pos:
            if node.axis in p:
                raise _Coupled(node)
            p = tuple(x + (node.indices.ndim - 1) * (x > node.axis) for x in p)
        else:
            raise _Coupled(node)
        pos[node] = p
    return pos


def separable(root, sources, npt, allow_grad=False):
    '''True if the scalar ``root`` is a sum over the points of terms that
    each depend on one point of the leaves ``sources`` (see _point_axes).'''
    try:
        pos = _point_axes(root, sources, npt, allow_grad)
    except _Coupled:
        return False
    return root not in pos or all(x is None for x in pos[root])


def point_integrand(root, sources, npt, allow_grad=False):
    '''The scalar ``root``, a sum over the ``npt`` leading (element and
    point) axes of the leaves ``sources`` of terms that each depend on one
    point (:func:`separable`), without that outer sum: a node of shape
    ``sources[0].shape[:npt]`` whose entries sum to ``root``.  The sums over
    the point axes lose those axes; the linear maps above them (sums of the
    terms, broadcasts, transposes, negation, products with a factor that
    depends on no source) act on each point.  None where ``root`` is not
    such a sum: a point axis summed in two steps, or an addend or a whole
    that depends on no source.  ``allow_grad`` as for :func:`_point_axes`.'''
    if not sources:
        return None
    lead = tuple(sources[0].shape[:npt])
    if any(tuple(s.shape[:npt]) != lead for s in sources):
        return None
    try:
        pos = _point_axes(root, sources, npt, allow_grad)
    except _Coupled:
        return None
    if root not in pos or any(x is not None for x in pos[root]):
        return None

    def broadcast(node):
        for ax, n in enumerate(lead):
            node = InsertAxis(node, ax, n)
        return node

    def lift(node):
        '''``lead + node.shape``, summing over ``lead`` to ``node``, whose
        point axes are all summed.'''
        if isinstance(node, Sum):
            p = pos[node.func]
            if all(x is None for x in p):
                return Sum(lift(node.func), tuple(a + npt for a in node.axes))
            if any(x is None for x in p):
                raise _Coupled(node)
            rest = tuple(a for a in node.axes if a not in p)
            inner = Sum(node.func, rest) if rest else node.func
            at = [x - sum(a < x for a in rest) for x in p]
            return transpose(inner, tuple(at) + tuple(i for i in range(inner.ndim) if i not in at))
        if isinstance(node, Add):
            a, b = node.children
            if a not in pos or b not in pos:
                raise _Coupled(node)
            return Add(lift(a), lift(b))
        if isinstance(node, Multiply):
            a, b = node.children
            if a in pos and b in pos:
                raise _Coupled(node)
            return Multiply(lift(a), broadcast(b)) if a in pos else Multiply(broadcast(a), lift(b))
        if isinstance(node, Pointwise) and node.op == 'negative':
            return Pointwise('negative', lift(node.children[0]))
        if isinstance(node, InsertAxis):
            return InsertAxis(lift(node.func), node.axis + npt, node.length)
        if isinstance(node, Transpose):
            return transpose(lift(node.func), tuple(range(npt)) + tuple(a + npt for a in node.axes))
        raise _Coupled(node)
    try:
        return lift(root)
    except _Coupled:
        return None


_feature_counter = itertools.count()


def fixed_parts(root):
    '''The largest subtrees of ``root`` that depend on no argument and on no
    leaf but those with a default binding (coordinate and constant tables):
    a functional's geometry, weights and coefficient functions, the same at
    every call.  Below a derivative (``Grad``, ``LeafGrad``) that depends on
    an argument, a subtree that depends on the leaf it differentiates by is
    not taken: bound as a leaf, it would differentiate to zero (the basis
    under the gradient of a field that is an argument but no trial).  Nor
    is it taken anywhere else: a part is bound wherever it occurs (the
    geometry of a tensor-product topology, under the gradient in one space
    and beside the gradient in the other).'''
    blocked = set()
    seen = set()

    def below(node, wrt):
        if (node, wrt) in seen:
            return
        seen.add((node, wrt))
        if wrt and any(l.key in wrt for l in node.leafdeps):
            blocked.add(node)
        if isinstance(node, Grad):
            wrt = wrt | {node.wrt.key}
        elif isinstance(node, LeafGrad):
            wrt = wrt | {node.key}
        for c in node.children:
            below(c, wrt)
    below(root, frozenset())
    out = []
    seen = set()

    def rec(node):
        if node in seen:
            return
        seen.add(node)
        if not node.arguments and all(l.value is not None for l in node.leafdeps) and node not in blocked:
            if node.children:
                out.append(node)
            return
        for c in node.children:
            rec(c)
    rec(root)
    return list(dict.fromkeys(out))


def feature_leaves(nodes):
    '''{node: a new Leaf of its shape and dtype}, to bind point-level
    features and call-invariant parts (an integer one: the dof table of a
    field that is an argument but no trial, such as a time step's history).'''
    return {n: Leaf(('feature', next(_feature_counter)), n.shape, n.dtype) for n in nodes}


def feature_cut(expr, leaf, npt=2):
    '''The point-level features of the localized dofs ``leaf`` in the scalar
    functional ``expr``: a tuple of nodes of ``expr`` through which alone
    ``expr`` depends on ``leaf``, each affine in it and pointwise in its
    ``npt`` leading (element and point) axes, or None.

    The leaf's axes after the first ``npt`` are its seed axes (a local dof
    and component each).  The cut takes, on every path up from the leaf, the
    lowest node that sums a seed axis away (the field's value at the
    points: ``Sum(basis * leaf)``), and then steps up past every ``Grad``
    whose function depends on the leaf, since a feature bound inside a Grad
    would differentiate to zero: the outermost such Grad is a feature
    itself (the field's gradient).  Features no path reaches are dropped.
    None where no such cut exists: a node below the cut is not a broadcast,
    a product with a leaf-free factor or a sum; the leaf reaches the
    functional through a node that couples points (a sum over a point axis
    below the integral); through a ``LeafGrad``, ``ArgGrad``, ``ArgJac`` or
    ``CustomNode``; or through a cut node of degree above one.'''
    if not 0 < npt < leaf.ndim:
        return None
    nodes = find(expr, lambda n: leaf in n.leafdeps)
    if len(nodes) < 2 or any(isinstance(n, (LeafGrad, ArgGrad, ArgJac, CustomNode)) for n in nodes):
        return None
    parents = {}
    for n in nodes:
        for c in n.children:
            if leaf in c.leafdeps:
                parents.setdefault(c, []).append(n)
    points = tuple(range(npt))
    # up from the leaf to the first sums over a seed axis, tracking the leaf
    # axis each axis holds (None: a broadcast)
    cut = []
    maps = {leaf: tuple(range(leaf.ndim))}
    todo = [leaf]
    while todo:
        node = todo.pop()
        amap = maps[node]
        for p in parents.get(node, ()):
            if isinstance(p, Multiply) and sum(leaf in c.leafdeps for c in p.children) == 1:
                pmap = amap
            elif isinstance(p, InsertAxis):
                pmap = amap[:p.axis] + (None,) + amap[p.axis:]
            elif isinstance(p, Transpose):
                pmap = tuple(amap[i] for i in p.axes)
            elif isinstance(p, Sum):
                summed = {amap[i] for i in p.axes} - {None}
                pmap = tuple(a for i, a in enumerate(amap) if i not in p.axes)
                if not summed.isdisjoint(points) or summed and pmap[:npt] != points:
                    return None
                if summed:
                    if p not in cut:
                        cut.append(p)
                    continue
            else:
                return None
            if p in maps:
                if maps[p] != pmap:
                    return None
                continue
            maps[p] = pmap
            todo.append(p)
    grads = [n for n in nodes if isinstance(n, Grad) and leaf in n.func.leafdeps]
    inner = {g for h in grads for g in find(h.func, lambda n: isinstance(n, Grad))}
    cut += [g for g in grads if g not in inner]
    feats = feature_leaves(cut)
    rest = replace(expr, feats)
    try:
        pos = _point_axes(expr, [leaf], npt, allow_grad=True)
    except _Coupled:
        return None
    if leaf in rest.leafdeps or any(x is not None for x in pos[expr]):
        return None
    cut = tuple(n for n in cut if feats[n] in rest.leafdeps)
    if any(pos[n] != points or _poly_degree(n, frozenset([leaf.key])) > 1 for n in cut):
        return None
    return cut


def replace(func, mapping):
    '''Deep structural substitution: every node appearing as a key in
    ``mapping`` is replaced by its value.  Returns the rewritten DAG.'''
    memo = {}

    def rec(node):
        if node in mapping:
            return mapping[node]
        hit = memo.get(node)
        if hit is not None:
            return hit
        if not node.children:
            out = node
        else:
            newc = tuple(rec(c) for c in node.children)
            out = node if all(a is b for a, b in zip(newc, node.children)) else _rebuild(node, newc)
        memo[node] = out
        return out
    return rec(func)


def _rebuild(node, children):
    cls = type(node)
    if cls is Add:
        return add(*children)
    if cls is Multiply:
        return multiply(*children)
    if cls is Sum:
        return sum_(children[0], node.axes)
    if cls is InsertAxis:
        return insertaxis(children[0], node.axis, node.length)
    if cls is Transpose:
        return transpose(children[0], node.axes)
    if cls is Ravel:
        return ravel(children[0], node.axis)
    if cls is Unravel:
        return unravel(children[0], node.axis, node.m, node.n)
    if cls is Take:
        return take(children[0], children[1], node.axis)
    if cls is GatherAlong:
        return gather_along(children[0], children[1], node.axis, node.shape[node.axis])
    if cls is Inflate:
        return inflate(children[0], children[1], node.length, node.axis)
    if cls is Concatenate:
        return Concatenate(children, node.axis)
    if cls is Power:
        return Power(*children)
    if cls is Pointwise:
        return Pointwise(node.op, *children, dtype=node.dtype)
    if cls is Cast:
        return Cast(children[0], node.dtype)
    if cls is Less:
        return Less(*children)
    if cls is Equal:
        return Equal(*children)
    if cls is LogicalNot:
        return LogicalNot(*children)
    if cls is LogicalAnd:
        return LogicalAnd(*children)
    if cls is Choose:
        return Choose(*children)
    if cls is Inverse:
        return Inverse(children[0])
    if cls is Determinant:
        return Determinant(children[0])
    if cls is Eigh:
        return Eigh(children[0], node.what)
    if cls is Grad:
        return grad(children[0], children[1])
    if cls is ArgGrad:
        return ArgGrad(children[0], node.name, children[1])
    if cls is ArgJac:
        return ArgJac(children[0], node.name, node.argshape)
    if cls is CustomNode:
        return CustomNode(node.fn, children, node.pershape, node.dtype, node.nprefix, node.partials)
    if cls is LeafGrad:
        return LeafGrad(children[0], node.key, children[1])
    if cls is Monomials:
        return Monomials(children[0], node.count)
    if cls is Legendre:
        return Legendre(children[0], node.degree)
    raise NotImplementedError(f'rebuild of {cls.__name__}')


def find(func, predicate):
    '''Collect (deduplicated, in dependency order) all nodes matching predicate.'''
    seen = set()
    out = []

    def rec(node):
        if node in seen:
            return
        seen.add(node)
        for c in node.children:
            rec(c)
        if predicate(node):
            out.append(node)
    rec(func)
    return out


# ------------------------------------------------------------------ compile

class _Factor:
    __slots__ = 'core', 'axismap'  # axismap: product axis -> core axis or None

    def __init__(self, core, axismap):
        self.core = core
        self.axismap = axismap


def _decompose_product(node):
    '''Decompose a Multiply/InsertAxis/Transpose tree into factors with axis
    maps, for einsum emission.  Returns a list of _Factor.'''
    if isinstance(node, Multiply):
        return _decompose_product(node.children[0]) + _decompose_product(node.children[1])
    if isinstance(node, InsertAxis):
        inner = _decompose_product(node.func)
        out = []
        for f in inner:
            amap = list(f.axismap)
            amap.insert(node.axis, None)
            out.append(_Factor(f.core, tuple(amap)))
        return out
    if isinstance(node, Transpose):
        inner = _decompose_product(node.func)
        return [_Factor(f.core, tuple(f.axismap[i] for i in node.axes)) for f in inner]
    return [_Factor(node, tuple(range(node.ndim)))]


# _Evaluator._eval_sum: a sum of products whose product has at most this many
# times the entries of its largest factor is evaluated as the product and a
# reduction, a larger one as an einsum.  Measured by sum_ratio_sweep.py: the
# point-level products of the three ported forms are 1-3 times their largest
# factor, and as einsums (batched products of tiny matrices) they make the
# assembly 4-6 times slower; the triangles' 18-fold products (a factor every
# element shares) are faster as einsums, and as products raise the peak by a
# third.
SUM_PRODUCT_RATIO = 16


class _Evaluator:
    '''Recursive eager DAG evaluation on torch tensors, with Grad frames.

    The root frame memoizes every node; a Grad introduces a child frame that
    overrides one Leaf and re-evaluates (only) the leaf-dependent cone, while
    leaf-independent values already in the parent frame are read from it.
    Values computed inside a ``torch.func.jvp`` stay in the child frame: a
    tensor created under a transform level must not outlive it in the parent
    frame.  Constants and default leaf bindings become tensors on
    ``device``.
    '''

    def __init__(self, arguments, leaves, device=None):
        self.arguments = arguments
        self.leaves = leaves
        self.device = device if device is not None else config.torch_device()

    def run(self, node):
        return self._eval(node, {}, frozenset())

    def _tensor(self, val, dtype):
        tdt = _torch_dtype(dtype)
        if isinstance(val, torch.Tensor):
            return val if val.dtype == tdt else val.to(tdt)
        a = numpy.asarray(val, dtype=_concrete_dtype(dtype))
        # IR constants are read-only arrays; torch wants storage it may write
        return torch.as_tensor(a if a.flags.writeable else a.copy(), device=self.device)

    def _eval(self, node, frame, overridden):
        memo_key = node
        if memo_key in frame:
            return frame[memo_key]
        val = self._compute(node, frame, overridden)
        if config.debug_enabled('evalf'):
            # NUTILS_TPU_TORCH_DEBUG=evalf: assert shape/dtype kind of every
            # intermediate against the node declaration
            assert tuple(val.shape) == tuple(node.shape), \
                f'evalf-debug: {type(node).__name__} declared shape {node.shape}, evaluated {tuple(val.shape)}'
            assert val.dtype.is_floating_point == (node.dtype is float), \
                f'evalf-debug: {type(node).__name__} declared dtype {node.dtype}, evaluated {val.dtype}'
        frame[memo_key] = val
        return val

    def _compute(self, node, frame, overridden):
        if isinstance(node, Constant):
            return self._tensor(node.value, node.dtype)
        if isinstance(node, Zeros):
            return torch.zeros(node.shape, dtype=_torch_dtype(node.dtype), device=self.device)
        if isinstance(node, Range):
            return torch.arange(node.length, dtype=_torch_dtype(int), device=self.device)
        if isinstance(node, Argument):
            val = self.arguments[node.name]
            assert tuple(val.shape) == node.shape, f'argument {node.name!r}: expected shape {node.shape}, got {tuple(val.shape)}'
            return self._tensor(val, node.dtype)
        if isinstance(node, Leaf):
            val = self.leaves[node.key]
            assert tuple(val.shape) == node.shape, f'leaf {node.key!r}: expected shape {node.shape}, got {tuple(val.shape)}'
            return self._tensor(val, node.dtype)
        if isinstance(node, Grad):
            return self._eval_grad(node, frame, overridden)
        if isinstance(node, ArgGrad):
            dirval = self._eval(node.direction, frame, overridden)
            x0 = self._tensor(self.arguments[node.name], float)

            def fun(x):
                return _Evaluator({**self.arguments, node.name: x}, self.leaves, self.device).run(node.func)
            return torch.func.jvp(fun, (x0.contiguous(),), (dirval.to(x0.dtype).contiguous(),))[1]
        if isinstance(node, ArgJac):
            x0 = self._tensor(self.arguments[node.name], float)

            def fun(x):
                return _Evaluator({**self.arguments, node.name: x}, self.leaves, self.device).run(node.func)
            jacfn = torch.func.jacrev if node.func.size <= max(x0.numel(), 1) else torch.func.jacfwd
            return jacfn(fun)(x0)
        if isinstance(node, LeafGrad):
            seedval = self._eval(node.seed, frame, overridden)
            x0 = self._tensor(self.leaves[node.key], float)

            def fun(x):
                return _Evaluator(self.arguments, {**self.leaves, node.key: x}, self.device).run(node.func)
            return torch.func.jvp(fun, (x0.contiguous(),), (seedval.to(x0.dtype).contiguous(),))[1]
        if isinstance(node, Sum):
            return self._eval_sum(node, frame, overridden)
        childvals = [self._eval(c, frame, overridden) for c in node.children]
        return node.evalf(*childvals)

    def _eval_sum(self, node, frame, overridden):
        factors = _decompose_product(node.func)
        if len(factors) == 1 and factors[0].core is node.func \
                or node.func.size <= SUM_PRODUCT_RATIO * max(f.core.size for f in factors):
            # a contraction no larger than its operands (a dot product per
            # point, a basis sum): an elementwise product and a reduction; as
            # an einsum it would become a batched matrix product of tiny
            # matrices over every point, which the card runs as many small
            # matrix-vector launches
            return torch.sum(self._eval(node.func, frame, overridden), dim=node.axes)
        # einsum emission: letters per product axis
        letters = [chr(ord('a') + i) for i in range(node.func.ndim)]
        subs = []
        vals = []
        covered = set()
        for f in factors:
            core_letters = [''] * f.core.ndim
            for prod_ax, core_ax in enumerate(f.axismap):
                if core_ax is not None:
                    core_letters[core_ax] = letters[prod_ax]
                    covered.add(prod_ax)
            subs.append(''.join(core_letters))
        out_letters = ''.join(letters[i] for i in range(node.func.ndim) if i not in node.axes)
        for i in range(node.func.ndim):
            if i not in covered and i not in node.axes:
                # broadcast output axis: einsum can't produce it
                return torch.sum(self._eval(node.func, frame, overridden), dim=node.axes)
        # summed axes that no factor covers scale the result by their length
        scale = 1
        for i in node.axes:
            if i not in covered:
                scale = scale * node.func.shape[i]
        vals = [self._eval(f.core, frame, overridden) for f in factors]
        out = torch.einsum(','.join(subs) + '->' + out_letters, *vals)
        if scale != 1:
            out = out * scale
        return out

    def _eval_grad(self, node, frame, overridden):
        leaf = node.wrt
        x0 = self._eval(leaf, frame, overridden)
        d = leaf.shape[-1]
        new_overridden = overridden | {leaf}

        def fun(x):
            subframe = _SubFrame(frame, new_overridden)
            subframe[leaf] = x
            return self._eval(node.func, subframe, new_overridden)

        if _REVERSE_GRADS[0] and not _functorch.get_interpreter_stack() and _reversible(node):
            return self._reverse_grad(node, frame, new_overridden, x0)
        # forward-mode duals need primal and tangent with their own storage
        x0 = x0.contiguous()
        eye = torch.eye(d, dtype=x0.dtype, device=x0.device)
        outs = []
        for k in range(d):
            _, tangent = torch.func.jvp(fun, (x0,), (eye[k].expand(x0.shape).contiguous(),))
            outs.append(tangent)
        return torch.stack(outs, dim=-1)

    def _reverse_grad(self, node, frame, overridden, x0):
        '''``node`` (a Grad whose function is pointwise in its leaf's
        leading axes) by reverse-mode autograd: one backward pass per entry
        of a point's value, each the sum over the points.'''
        leaf = node.wrt
        x = x0.detach().requires_grad_(True)
        lead = x.ndim - 1
        with torch.enable_grad():
            subframe = _SubFrame(frame, overridden)
            subframe[leaf] = x
            y = self._eval(node.func, subframe, overridden)
            flat = y.reshape(tuple(y.shape[:lead]) + (-1,))
            cols = []
            for c in range(flat.shape[-1]):
                g = torch.autograd.grad(flat[..., c].sum(), x, retain_graph=True, allow_unused=True)[0] \
                    if flat.requires_grad else None
                cols.append(torch.zeros_like(x) if g is None else g)
        return torch.stack(cols, dim=-2).reshape(tuple(y.shape) + (x.shape[-1],)).detach()


# Grads outside any torch.func transform by reverse-mode autograd instead of
# forward-mode jvp passes (see reverse_grads)
_REVERSE_GRADS = [False]


@contextlib.contextmanager
def reverse_grads():
    '''While open, a Grad evaluated outside any ``torch.func`` transform,
    with no other derivative or user node below it and its function
    pointwise in the leaf's leading axes, takes reverse-mode autograd.  A
    forward-mode pass costs 0.44 ms an elementwise operation on an H100
    and 0.28 ms on its host's CPU, against 0.027 and 0.014 ms in reverse
    mode (torch 2.11, ``cahnhilliard_probe.py``), and point location's
    Newton evaluations of the geometry's root gradient pay that per
    operation.  The values agree with the jvp passes' to rounding.'''
    saved = _REVERSE_GRADS[0]
    _REVERSE_GRADS[0] = True
    try:
        yield
    finally:
        _REVERSE_GRADS[0] = saved


@functools.lru_cache(maxsize=4096)
def _reversible(node):
    lead = node.wrt.ndim - 1
    return node.func.shape[:lead] == node.wrt.shape[:lead] and not find(
        node.func, lambda n: isinstance(n, (Grad, LeafGrad, ArgGrad, ArgJac, CustomNode, EigGeneral)))


class _SubFrame(dict):
    '''Evaluation frame for a Grad closure: reads through to the parent frame
    for nodes that do not depend on any overridden leaf, and keeps what it
    computes itself (see _Evaluator).'''

    def __init__(self, parent, overridden):
        super().__init__()
        self.parent = parent
        self.overridden = overridden

    def __contains__(self, node):
        if dict.__contains__(self, node):
            return True
        if node.leafdeps.isdisjoint(self.overridden):
            return node in self.parent
        return False

    def __getitem__(self, node):
        if dict.__contains__(self, node):
            return dict.__getitem__(self, node)
        if node.leafdeps.isdisjoint(self.overridden):
            return self.parent[node]
        raise KeyError(node)


# Constants above this many elements are promoted to value-carrying Leafs at
# compile time: the System moves their values to the device once and binds
# them on every call, instead of converting them per evaluation.
CONST_LEAF_THRESHOLD = 4096
_const_leaf_counter = itertools.count()


def _promote_big_constants(flat):
    mapping = {}

    def collect(node, seen):
        if node in seen:
            return
        seen.add(node)
        if isinstance(node, Constant) and (node.size > CONST_LEAF_THRESHOLD
                                           or (node.ndim >= 1 and node.shape[0] >= 1024)):
            # the second clause promotes every possibly element-batched table,
            # as the JAX package does, so both packages bind the same leaves
            if node not in mapping:
                v = node.value
                if config.uniform_tables.value and node.ndim >= 1 and node.shape[0] > 1 \
                        and v.size and bool((v == v[:1]).all()):
                    # element-uniform table (e.g. basis coefficients or
                    # reference quadrature weights on a structured grid):
                    # store one row and broadcast — the memory traffic of
                    # the assembly drops by the batch factor
                    row = v[0]
                    if row.size > CONST_LEAF_THRESHOLD:
                        inner = Leaf(('const', next(_const_leaf_counter)), row.shape, node.dtype, value=row)
                    else:
                        inner = Constant(row)
                    mapping[node] = insertaxis(inner, 0, node.shape[0])
                else:
                    mapping[node] = Leaf(('const', next(_const_leaf_counter)), node.shape, node.dtype,
                                         value=node.value)
            return
        for c in node.children:
            collect(c, seen)
    seen = set()
    for f in flat:
        collect(f, seen)
    if not mapping:
        return flat
    return [replace(f, mapping) for f in flat]


def _flatten(funcs):
    '''Flatten a pytree (nested list/tuple/dict) of Arrays: (flat, rebuild).'''
    if isinstance(funcs, Array):
        return [funcs], lambda vals: vals[0]
    if isinstance(funcs, (list, tuple)):
        parts = [_flatten(f) for f in funcs]
        sizes = [len(p[0]) for p in parts]

        def rebuild(vals):
            out, pos = [], 0
            for (_, rb), n in zip(parts, sizes):
                out.append(rb(vals[pos:pos + n]))
                pos += n
            return type(funcs)(out)
        return [x for p in parts for x in p[0]], rebuild
    if isinstance(funcs, dict):
        keys = list(funcs)
        flat, rb = _flatten([funcs[k] for k in keys])
        return flat, lambda vals: dict(zip(keys, rb(vals)))
    raise AssertionError('compile expects Array nodes')


class Compiled:
    '''A compiled expression (tree): a pure eager function of argument and
    leaf bindings.  ``funcs`` may be a single Array or a nested
    list/tuple/dict of Arrays.'''

    def __init__(self, funcs):
        self.funcs = funcs
        flat, self._rebuild = _flatten(funcs)
        flat = _promote_big_constants(flat)
        self.flat = flat
        argnodes = {}
        for f in flat:
            for a in f.arguments:
                prev = argnodes.setdefault(a.name, a)
                assert prev == a, f'inconsistent argument {a.name!r}'
        self.argnodes = argnodes
        self.leafnodes = {}
        for f in flat:
            for l in f.leafdeps:
                prev = self.leafnodes.setdefault(l.key, l)
                assert prev == l, f'inconsistent leaf {l.key!r}'

    def trace(self, arguments, leaves=None, device=None):
        '''Dict of argument arrays, dict of leaf arrays -> output pytree of
        tensors.  Leaves not supplied explicitly fall back to their default
        bindings.'''
        return self._rebuild(self.trace_flat(arguments, leaves, device))

    def trace_flat(self, arguments, leaves=None, device=None):
        leaves = dict(leaves or {})
        for key, node in self.leafnodes.items():
            if key not in leaves:
                assert node.value is not None, f'missing leaf binding: {key!r}'
                leaves[key] = node.value
        ev = _Evaluator(arguments, leaves, device)
        frame = {}
        return [ev._eval(f, frame, frozenset()) for f in self.flat]

    def __call__(self, arguments=None, leaves=None):
        arguments = {k: v for k, v in (arguments or {}).items() if k in self.argnodes}
        leaves = {k: v for k, v in (leaves or {}).items() if k in self.leafnodes}
        missing = set(self.argnodes) - set(arguments)
        if missing:
            raise ValueError(f'missing arguments: {sorted(missing)}')
        return self.trace(arguments, leaves)


def compile(funcs):
    '''Compile expression(s) to a callable evaluating them eagerly on torch
    tensors (reference: evaluable.compile, evaluable.py:6532).

    >>> import numpy
    >>> from nutils_tpu_torch import evaluable as ev
    >>> from nutils_tpu_torch.utils import config
    >>> a = ev.Argument('a', (3,), float)
    >>> f = ev.sum_(ev.multiply(a, a), 0)
    >>> with config.device('cpu'):
    ...     float(ev.compile(f)({'a': numpy.arange(3.0)}))
    5.0
    '''
    return Compiled(funcs)


def stable_digest(*roots):
    '''Process-stable content hash of expression tree(s) (the analogue of the
    reference's ``nutils_hash``, types.py:74, which keys its disk cache):
    sha1 over a DFS serialization of node types, parameters and child links.
    Python's built-in ``hash`` is salted per process and unusable for disk
    keys.'''
    import hashlib
    h = hashlib.sha1()
    ids = {}

    def feed(x):
        if isinstance(x, _ArrayKey):
            h.update(b'arr')
            h.update(x._digest)
        elif isinstance(x, type):
            h.update(b'typ')
            h.update(x.__name__.encode())
        elif isinstance(x, tuple):
            h.update(b'tup')
            for y in x:
                feed(y)
        elif isinstance(x, numpy.ndarray):
            h.update(b'nda')
            h.update(str(x.shape).encode())
            h.update(x.tobytes())
        else:
            h.update(repr(x).encode())

    def rec(node):
        nid = ids.get(node)
        if nid is not None:
            h.update(b'ref%d' % nid)
            return
        ids[node] = len(ids)
        h.update(type(node).__name__.encode())
        feed(node.params)
        if isinstance(node, Leaf) and node.value is not None:
            feed(numpy.asarray(node.value))
        for c in node.children:
            rec(c)
    for root in roots:
        rec(root)
    return h.hexdigest()


def eval_once(funcs, arguments=None, leaves=None, on_host=False):
    '''Evaluate expression(s) once, returning numpy arrays.  ``on_host``
    evaluates on the CPU whatever the configured device: set-up constants
    (dof tables) never need the card.'''
    comp = Compiled(funcs)
    device = torch.device('cpu') if on_host else None
    vals = comp.trace_flat(arguments or {}, leaves or {}, device)
    return comp._rebuild([v.detach().cpu().numpy().reshape(tuple(n.shape))
                          for v, n in zip(vals, comp.flat)])

