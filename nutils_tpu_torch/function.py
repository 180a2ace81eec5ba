'''User-facing lazy array layer with the lowering protocol.

Mirrors the reference's ``function.Array`` (reference: function.py:257): every
object is a lazy, numpy-operator-supporting array annotated with ``spaces``
and ``arguments``; calling ``lower(args)`` produces an evaluable-IR expression
of shape ``args.points_shape + self.shape``.

Differences from the reference (shared with nutils_tpu):

* ``LowerArgs`` carries a *batched* view of a sample: one coordinate Leaf
  ``X`` of shape [E, P, d] (root coordinates of all quadrature points of all
  elements), constant per-element tables (parent indices, affine maps, root
  normals), and the parent-local coordinate expression.  There are no
  per-element transform chains at lowering time — chains are flattened into
  tables host-side by the topology layer.

* Coordinate derivatives (grad, normal, jacobian) lower to ``evaluable.Grad``
  nodes — seeded ``torch.func.jvp`` passes at evaluation time — instead of symbolic
  per-node derivative rules (reference: function.py:2051-2316 lowers to
  ``evaluable.derivative``).
'''

import functools
import itertools

import numpy

from . import evaluable as ev

_token_counter = itertools.count()


class Chart:
    '''Per-space lowering data of a sample (one coordinate chart).

    Attributes: ``X`` (root-coordinate Leaf [E, P, d]), ``index`` (parent
    element ids [E], numpy), ``xi`` (parent-local coordinate expression),
    ``tangents`` ([E, d, ds] numpy), ``normal_root`` ([E, d] numpy or None),
    ``origin_topo``.
    '''

    def __init__(self, X=None, index=None, xi=None, tangents=None, normal_root=None, origin_topo=None, lineage=None):
        self.X = X
        self.index = index
        self.xi = xi
        self.tangents = tangents
        self.normal_root = normal_root
        self.origin_topo = origin_topo
        self.lineage = lineage  # (family, levels [E], elems [E]) for samples of
        # hierarchical refinement families (see hierarchical._Family)


class LowerArgs:
    '''Lowering context: one Chart per space sharing a common points_shape
    (the reference's multi-space LowerArgs, function.py:77, with batched
    tables instead of per-element transform chains).'''

    def __init__(self, space=None, points_shape=(), X=None, index=None, xi=None, tangents=None, normal_root=None, opposite=None, part_ids=None, part_topos=None, origin_topo=None, charts=None):
        self.points_shape = tuple(points_shape)
        if charts is not None:
            self.charts = dict(charts)
        elif space is not None:
            self.charts = {space: Chart(X, index, xi, tangents, normal_root, origin_topo)}
        else:
            self.charts = {}
        self.opposite = opposite  # LowerArgs of the other side of an interface
        self.part_ids = part_ids  # int [E]: originating part in a union topology
        self.part_topos = part_topos  # topologies aligned with part_ids

    def chart(self, space):
        try:
            return self.charts[space]
        except KeyError:
            raise ValueError(f'space {space!r} is not part of this sample (has: {sorted(self.charts)})')

    @property
    def _single(self):
        assert len(self.charts) == 1, 'operation requires a single-space sample'
        return next(iter(self.charts.values()))

    @property
    def space(self):
        return next(iter(self.charts), None)

    @property
    def X(self):
        return self._single.X

    @property
    def index(self):
        return self._single.index

    @property
    def xi(self):
        return self._single.xi

    @property
    def tangents(self):
        return self._single.tangents

    @property
    def normal_root(self):
        return self._single.normal_root

    @property
    def origin_topo(self):
        return self._single.origin_topo

    @property
    def nprefix(self):
        return len(self.points_shape)


EMPTY_LOWER_ARGS = LowerArgs()


def _prefix_broadcast(expr, points_shape, own_prefix=0):
    '''Insert leading axes so expr (with own_prefix leading point axes) is
    broadcast to the requested points_shape prefix.'''
    assert own_prefix == 0, 'unexpected pre-lowered prefix'
    for i, n in enumerate(points_shape):
        expr = ev.insertaxis(expr, i, n)
    return expr


class Array:
    '''Base class of lazy user arrays.'''

    def __init__(self, shape, dtype, spaces, arguments):
        self.shape = tuple(int(n) for n in shape)
        self.dtype = dtype
        self.spaces = frozenset(spaces)
        self.arguments = dict(arguments)  # name -> (shape, dtype)

    def __init_subclass__(cls, **kwargs):
        # debug sanitizer (the analogue of NUTILS_DEBUG=lower, reference:
        # function.py:219-234): check every lower() result's trailing shape
        # against the declaration
        super().__init_subclass__(**kwargs)
        from .utils import config
        if config.debug_enabled('lower') and 'lower' in cls.__dict__:
            inner = cls.__dict__['lower']

            def checked_lower(self, args, _inner=inner, _cls=cls):
                out = _inner(self, args)
                assert out.ndim >= self.ndim and tuple(out.shape[out.ndim - self.ndim:]) == self.shape, (
                    f'{_cls.__name__}.lower: lowered shape {tuple(out.shape)} does not end in declared {self.shape}')
                return out
            cls.lower = checked_lower

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        return int(numpy.prod(self.shape, dtype=numpy.int64)) if self.shape else 1

    def lower(self, args):
        raise NotImplementedError

    # -------------------------------------------------- numpy-like operators

    def __add__(self, other):
        return add(self, other)
    __radd__ = __add__

    def __sub__(self, other):
        return subtract(self, other)

    def __rsub__(self, other):
        return subtract(other, self)

    def __mul__(self, other):
        return multiply(self, other)
    __rmul__ = __mul__

    def __truediv__(self, other):
        return divide(self, other)

    def __rtruediv__(self, other):
        return divide(other, self)

    def __pow__(self, other):
        return power(self, other)

    def __neg__(self):
        return negative(self)

    def __pos__(self):
        return self

    def __abs__(self):
        return abs_(self)

    def __matmul__(self, other):
        return matmul(self, other)

    def __rmatmul__(self, other):
        return matmul(other, self)

    def __getitem__(self, item):
        return getitem(self, item)

    # elementwise comparisons (reference: Array inherits them from
    # NDArrayOperatorsMixin).  __eq__/__ne__ stay identity-based so Arrays
    # remain hashable and usable in containers; use function.equal/not_equal
    # (or numpy.equal) for elementwise equality.
    def __lt__(self, other):
        return less(self, other)

    def __gt__(self, other):
        return greater(self, other)

    def __le__(self, other):
        return less_equal(self, other)

    def __ge__(self, other):
        return greater_equal(self, other)

    def __iter__(self):
        if not self.ndim:
            raise TypeError('iteration over a 0-d array')
        return (getitem(self, i) for i in range(self.shape[0]))

    def __len__(self):
        if not self.ndim:
            raise TypeError('len() of a 0-d array')
        return self.shape[0]

    def sum(self, axis=None):
        return sum_(self, axis)

    def prod(self, axis=-1):
        return prod(self, axis)

    @property
    def T(self):
        return transpose(self)

    def transpose(self, axes=None):
        return transpose(self, axes)

    def grad(self, geom, ndims=0):
        return grad(self, geom)

    def div(self, geom):
        return div(self, geom)

    def curl(self, geom):
        return curl(self, geom)

    def laplace(self, geom):
        return laplace(self, geom)

    def normal(self, *args):
        raise NotImplementedError('use function.normal(geom)')

    def dot(self, other, axes=None):
        if axes is None:
            return matmul(self, other)
        return sum_(multiply(self, other), axes)

    def eval(self, arguments=None, /, **kwargs):
        return eval(self, arguments or kwargs)

    def derivative(self, var):
        return derivative(self, var)

    def replace(self, arguments):
        return replace_arguments(self, arguments)

    def conjugate(self):
        return self

    conj = conjugate

    @property
    def real(self):
        return self

    @property
    def imag(self):
        return zeros(self.shape)

    def __repr__(self):
        return f'Array<{"x".join(map(str, self.shape))}>'

    # numpy interop: allow numpy scalars/arrays on the left of operators
    __array_priority__ = 100.0

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != '__call__' or kwargs.get('out') is not None:
            return NotImplemented
        handler = _UFUNC_MAP.get(ufunc)
        if handler is None:
            return NotImplemented
        return handler(*inputs)

    def __array_function__(self, func, types, args, kwargs):
        handler = _FUNC_MAP.get(func)
        if handler is None:
            return NotImplemented
        return handler(*args, **kwargs)


def _merge_args(arrays):
    out = {}
    for a in arrays:
        for name, spec in a.arguments.items():
            prev = out.setdefault(name, spec)
            assert prev == spec, f'inconsistent argument {name!r}: {prev} vs {spec}'
    return out


def _merge_spaces(arrays):
    return frozenset().union(*(a.spaces for a in arrays))


def asarray(value):
    if isinstance(value, Array):
        return value
    if isinstance(value, (list, tuple)) and any(isinstance(v, Array) for v in _flatten(value)):
        return stack([asarray(v) for v in value], axis=0)
    value = numpy.asarray(value)
    if value.dtype.kind == 'c':
        return _Complex(_Constant(numpy.array(value.real)), _Constant(numpy.array(value.imag)))
    return _Constant(value)


def _flatten(x):
    if isinstance(x, (list, tuple)):
        for v in x:
            yield from _flatten(v)
    else:
        yield x


class _Constant(Array):

    def __init__(self, value):
        self.value = numpy.asarray(value)
        dtype = bool if self.value.dtype.kind == 'b' else int if self.value.dtype.kind in 'iu' else float
        super().__init__(self.value.shape, dtype, frozenset(), {})

    def lower(self, args):
        return _prefix_broadcast(ev.constant(self.value), args.points_shape)


class _Complex(Array):
    '''Complex array as a (real, imag) pair of real Arrays.

    Complex values are carried as split real arithmetic: a complex argument of logical shape S is backed by a
    real argument of shape S + (2,), every complex operation expands into real
    arithmetic on the parts at the function layer, and the solver assembles
    the equivalent real system — Re(res) stationary in the packed test dofs is
    exactly res == 0 for the complex residual.  Mirrors the reference's
    complex dtype support (reference: function.py:257, examples/coil.py).'''

    def __init__(self, real, imag):
        real = asarray(real)
        imag = asarray(imag)
        if real.dtype != float:
            real = _cast(real, float)
        if imag.dtype != float:
            imag = _cast(imag, float)
        assert real.shape == imag.shape, (real.shape, imag.shape)
        self._re = real
        self._im = imag
        super().__init__(real.shape, complex, _merge_spaces((real, imag)), _merge_args((real, imag)))

    @property
    def real(self):
        return self._re

    @property
    def imag(self):
        return self._im

    def conjugate(self):
        return _Complex(self._re, negative(self._im))

    conj = conjugate

    def lower(self, args):
        raise TypeError('complex arrays cannot be lowered directly; lower .real and .imag separately')


def iscomplex(a):
    return isinstance(a, Array) and a.dtype == complex


def _as_complex(a):
    a = asarray(a)
    if isinstance(a, _Complex):
        return a
    return _Complex(a if a.dtype == float else _cast(a, float), zeros(a.shape))


def _map_parts(f, *arrays):
    '''Apply a real-array building function to the real and imag parts of
    (possibly complex) operands, recombining into a complex array.'''
    cs = [_as_complex(a) for a in arrays]
    return _Complex(f(*[c.real for c in cs]), f(*[c.imag for c in cs]))


class Argument(Array):
    '''Named argument; the solver's trial/test vectors and parameters.

    A complex argument of logical shape S is backed by a real argument of
    shape S + (2,); its arguments-dict spec records the backing shape with
    dtype complex so solver/eval layers pack and unpack transparently.'''

    def __new__(cls, name, shape, dtype=float):
        if dtype is complex:
            backing = _RealBacking(name, tuple(int(n) for n in shape) + (2,))
            return _Complex(getitem(backing, (Ellipsis, 0)), getitem(backing, (Ellipsis, 1)))
        return super().__new__(cls)

    def __init__(self, name, shape, dtype=float):
        self.name = name
        super().__init__(shape, dtype, frozenset(), {name: (tuple(int(n) for n in shape), dtype)})

    def lower(self, args):
        return _prefix_broadcast(ev.Argument(self.name, self.shape, self.dtype), args.points_shape)


class _RealBacking(Array):
    '''The real storage of a complex argument: shape S + (2,), declared with
    dtype complex in the arguments dict (spec shape = backing shape).'''

    def __init__(self, name, shape):
        self.name = name
        super().__init__(shape, float, frozenset(), {name: (tuple(int(n) for n in shape), complex)})

    def lower(self, args):
        return _prefix_broadcast(ev.Argument(self.name, self.shape, float), args.points_shape)


def _arg_from_spec(name, spec):
    shape, dtype = spec
    if dtype is complex:
        return Argument(name, tuple(shape)[:-1], complex)
    return Argument(name, shape, dtype)


def _broadcast_shapes(*shapes):
    return tuple(numpy.broadcast_shapes(*shapes))


def _align_lowered(expr, own_shape, out_shape, nprefix):
    '''Align a lowered array (prefix + own_shape) to prefix + out_shape by
    numpy broadcasting rules (prepend axes, broadcast unit axes).'''
    # prepend missing axes after the prefix
    for _ in range(len(out_shape) - len(own_shape)):
        expr = ev.insertaxis(expr, nprefix, 1)
    own = (1,) * (len(out_shape) - len(own_shape)) + tuple(own_shape)
    for i, (a, b) in enumerate(zip(own, out_shape)):
        if a == 1 and b != 1:
            expr = ev._drop_unit_axis(expr, nprefix + i)
            expr = ev.insertaxis(expr, nprefix + i, b)
        else:
            assert a == b, f'cannot broadcast {own} to {out_shape}'
    return expr


class _Broadcast(Array):
    '''Helper base for n-ary ops with numpy broadcasting.'''

    def __init__(self, operands, shape, dtype):
        operands = tuple(operands)
        self.operands = operands
        super().__init__(shape, dtype, _merge_spaces(operands), _merge_args(operands))

    def _lowered_operands(self, args):
        return [_align_lowered(op.lower(args), op.shape, self.shape, args.nprefix) for op in self.operands]


def _result_dtype(*ops):
    dtypes = [op.dtype for op in ops]
    if float in dtypes:
        return float
    if int in dtypes:
        return int
    return bool


def _coerce_pair(a, b):
    a, b = asarray(a), asarray(b)
    dtype = _result_dtype(a, b)
    return _cast(a, dtype), _cast(b, dtype), dtype


def _cast(a, dtype):
    if a.dtype == dtype:
        return a
    return _Cast(a, dtype)


class _Cast(Array):

    def __init__(self, arg, dtype):
        self.arg = arg
        super().__init__(arg.shape, dtype, arg.spaces, arg.arguments)

    def lower(self, args):
        return ev.astype(self.arg.lower(args), self.dtype)


class _Add(_Broadcast):

    def __init__(self, a, b):
        super().__init__((a, b), _broadcast_shapes(a.shape, b.shape), _result_dtype(a, b))

    def lower(self, args):
        la, lb = self._lowered_operands(args)
        return ev.add(la, lb)


class _Multiply(_Broadcast):

    def __init__(self, a, b):
        super().__init__((a, b), _broadcast_shapes(a.shape, b.shape), _result_dtype(a, b))

    def lower(self, args):
        la, lb = self._lowered_operands(args)
        return ev.multiply(la, lb)


class _Power(_Broadcast):

    def __init__(self, a, b):
        super().__init__((a, b), _broadcast_shapes(a.shape, b.shape), float)

    def lower(self, args):
        la, lb = self._lowered_operands(args)
        return ev.power(la, lb)


class _Pointwise(_Broadcast):

    def __init__(self, op, *operands, force_dtype=None):
        self.op = op
        self.force_dtype = force_dtype
        dtype = force_dtype if force_dtype is not None else _result_dtype(*operands)
        super().__init__(operands, _broadcast_shapes(*(o.shape for o in operands)), dtype)

    def lower(self, args):
        lowered = self._lowered_operands(args)
        return ev.pointwise(self.op, *lowered, dtype=self.force_dtype)


class _Neg(_Broadcast):

    def __init__(self, a):
        super().__init__((a,), a.shape, a.dtype)

    def lower(self, args):
        return ev.negative(self.operands[0].lower(args))


class _Sum(Array):

    def __new__(cls, arg, axes):
        if iscomplex(arg):
            return _map_parts(lambda x: _Sum(x, axes), arg)
        return super().__new__(cls)

    def __init__(self, arg, axes):
        self.arg = arg
        self.axes = tuple(sorted(ax % arg.ndim for ax in axes))
        shape = tuple(n for i, n in enumerate(arg.shape) if i not in self.axes)
        super().__init__(shape, arg.dtype, arg.spaces, arg.arguments)

    def lower(self, args):
        expr = self.arg.lower(args)
        return ev.sum_(expr, tuple(args.nprefix + ax for ax in self.axes))


class _Transpose(Array):

    def __new__(cls, arg, axes):
        if iscomplex(arg):
            return _map_parts(lambda x: _Transpose(x, axes), arg)
        return super().__new__(cls)

    def __init__(self, arg, axes):
        self.arg = arg
        self.axes = tuple(ax % arg.ndim for ax in axes)
        super().__init__(tuple(arg.shape[i] for i in self.axes), arg.dtype, arg.spaces, arg.arguments)

    def lower(self, args):
        expr = self.arg.lower(args)
        pre = tuple(range(args.nprefix))
        return ev.transpose(expr, pre + tuple(args.nprefix + i for i in self.axes))


class _InsertAxis(Array):

    def __new__(cls, arg, axis, length):
        if iscomplex(arg):
            return _map_parts(lambda x: _InsertAxis(x, axis, length), arg)
        return super().__new__(cls)

    def __init__(self, arg, axis, length):
        self.arg = arg
        self.axis = axis % (arg.ndim + 1)
        self.length = int(length)
        shape = arg.shape[:self.axis] + (self.length,) + arg.shape[self.axis:]
        super().__init__(shape, arg.dtype, arg.spaces, arg.arguments)

    def lower(self, args):
        return ev.insertaxis(self.arg.lower(args), args.nprefix + self.axis, self.length)


class _Take(Array):
    '''Gather along axis at constant indices.'''

    def __new__(cls, arg, indices, axis):
        if iscomplex(arg):
            return _map_parts(lambda x: _Take(x, indices, axis), arg)
        return super().__new__(cls)

    def __init__(self, arg, indices, axis):
        self.arg = arg
        self.indices = numpy.asarray(indices)
        assert self.indices.dtype.kind in 'iu'
        self.axis = axis % arg.ndim
        shape = arg.shape[:self.axis] + self.indices.shape + arg.shape[self.axis + 1:]
        super().__init__(shape, arg.dtype, arg.spaces, arg.arguments)

    def lower(self, args):
        return ev.take(self.arg.lower(args), ev.constant(self.indices), args.nprefix + self.axis)


class _Concatenate(Array):

    def __new__(cls, arrays, axis):
        arrays = tuple(arrays)
        if any(iscomplex(a) for a in arrays):
            return _map_parts(lambda *xs: _Concatenate(xs, axis), *arrays)
        return super().__new__(cls)

    def __init__(self, arrays, axis):
        arrays = tuple(arrays)
        self.arrays = arrays
        self.axis = axis % arrays[0].ndim
        shape = list(arrays[0].shape)
        shape[self.axis] = sum(a.shape[self.axis] for a in arrays)
        dtype = _result_dtype(*arrays)
        arrays = tuple(_cast(a, dtype) for a in arrays)
        self.arrays = arrays
        super().__init__(shape, dtype, _merge_spaces(arrays), _merge_args(arrays))

    def lower(self, args):
        return ev.Concatenate([a.lower(args) for a in self.arrays], args.nprefix + self.axis)


class _Choose(_Broadcast):

    def __init__(self, cond, iftrue, iffalse):
        iftrue, iffalse, dtype = _coerce_pair(iftrue, iffalse)
        self._dtype = dtype
        super().__init__((cond, iftrue, iffalse), _broadcast_shapes(cond.shape, iftrue.shape, iffalse.shape), dtype)

    def lower(self, args):
        c, t, f = self._lowered_operands(args)
        return ev.Choose(c, t, f)


class _Compare(_Broadcast):

    def __init__(self, op, a, b):
        self.op = op
        super().__init__((a, b), _broadcast_shapes(a.shape, b.shape), bool)

    def lower(self, args):
        la, lb = self._lowered_operands(args)
        return {'less': ev.Less, 'equal': ev.Equal}[self.op](la, lb)


class _Inverse(Array):

    def __init__(self, arg):
        assert arg.ndim >= 2 and arg.shape[-1] == arg.shape[-2]
        self.arg = arg
        super().__init__(arg.shape, float, arg.spaces, arg.arguments)

    def lower(self, args):
        return ev.Inverse(ev.astype(self.arg.lower(args), float))


class _Determinant(Array):

    def __init__(self, arg):
        assert arg.ndim >= 2 and arg.shape[-1] == arg.shape[-2]
        self.arg = arg
        super().__init__(arg.shape[:-2], float, arg.spaces, arg.arguments)

    def lower(self, args):
        return ev.Determinant(ev.astype(self.arg.lower(args), float))


class _Eig(Array):

    def __init__(self, arg, what):
        self.arg = arg
        self.what = what
        shape = arg.shape[:-1] if what == 'values' else arg.shape
        super().__init__(shape, float, arg.spaces, arg.arguments)

    def lower(self, args):
        return ev.Eigh(ev.astype(self.arg.lower(args), float), self.what)


class _EigGeneral(Array):
    '''One real/imag part of the general eigendecomposition (reference:
    evaluable.Eig symmetric=False, evaluable.py:3149).'''

    def __init__(self, arg, what, part):
        self.arg = arg
        self.what = what
        self.part = part
        shape = arg.shape[:-1] if what == 'values' else arg.shape
        super().__init__(shape, float, arg.spaces, arg.arguments)

    def lower(self, args):
        return ev.EigGeneral(ev.astype(self.arg.lower(args), float), self.what, self.part)


# -------------------------------------------------------------- geometry ops

class _RootCoords(Array):
    '''The root (mesh-parametric) coordinates of a space.'''

    def __init__(self, space, ndims):
        self.space = space
        super().__init__((ndims,), float, frozenset({space}), {})

    def lower(self, args):
        return args.chart(self.space).X


def _chart_list(args):
    '''Charts in deterministic (space-name) order.'''
    return [args.charts[k] for k in sorted(args.charts)]


def _grad_all_charts(expr, args):
    '''d(expr)/d(all root coordinates): per-chart seeded jvp, concatenated
    along a new last axis (total root dimension).'''
    parts = [ev.grad(expr, c.X) for c in _chart_list(args)]
    return parts[0] if len(parts) == 1 else ev.Concatenate(parts, parts[0].ndim - 1)


class _Gradient(Array):
    '''grad(arg, geom): shape arg.shape + (len(geom),).  The root chart is the
    concatenation of all the sample's space charts (multi-space geometries as
    in the reference's tensorial topologies).'''

    def __new__(cls, arg, geom):
        if iscomplex(arg):
            return _map_parts(lambda x: _Gradient(x, geom), arg)
        return super().__new__(cls)

    def __init__(self, arg, geom):
        assert geom.ndim == 1
        self.arg = arg
        self.geom = geom
        super().__init__(arg.shape + (geom.shape[0],), float,
                         _merge_spaces((arg, geom)), _merge_args((arg, geom)))

    def lower(self, args):
        assert args.charts, 'gradient requires a coordinate sample'
        F = _grad_all_charts(ev.astype(self.arg.lower(args), float), args)   # [E,P,*shape,d]
        G = _grad_all_charts(ev.astype(self.geom.lower(args), float), args)  # [E,P,g,d]
        d = G.shape[-1]
        g = self.geom.shape[0]
        assert g == d, f'gradient requires a square geometry jacobian (geom dim {g}, root dim {d})'
        Ginv = ev.Inverse(G)  # (G^{-1})[j,k] = dX_j/dgeom_k
        # grad_k = sum_j F[..., j] * (G^{-1})[j, k]; align axes for contraction
        n = F.ndim
        Fx = ev.insertaxis(F, n, g)           # [..., *shape, j, k_new]
        Gx = Ginv                             # [E,P,j,k]
        for ax in range(args.nprefix, n - 1):  # broadcast Ginv over *shape axes
            Gx = ev.insertaxis(Gx, ax, F.shape[ax])
        return ev.sum_(ev.multiply(Fx, Gx), n - 1)


class _Normal(Array):

    def __init__(self, geom):
        assert geom.ndim == 1
        self.geom = geom
        super().__init__(geom.shape, float, geom.spaces, geom.arguments)

    def lower(self, args):
        charts = _chart_list(args)
        assert any(c.normal_root is not None for c in charts), 'normal is only defined on boundary samples'
        G = _grad_all_charts(ev.astype(self.geom.lower(args), float), args)  # [E,P,g,d]
        d = G.shape[-1]
        g = self.geom.shape[0]
        assert g == d
        # normals transform as n ~ G^{-T} n_root, oriented by the parametric
        # outward direction (NOT the cofactor: that would flip the normal for
        # orientation-reversing geometries, whereas the reference's transform-
        # chain orientation is parametric; function.py:530 normal).
        GinvT = ev.transpose(ev.Inverse(G), tuple(range(G.ndim - 2)) + (G.ndim - 1, G.ndim - 2))
        nroot_np = numpy.concatenate(
            [c.normal_root if c.normal_root is not None else numpy.zeros((args.points_shape[0], c.X.shape[-1]))
             for c in charts], axis=1)
        nroot = ev.insertaxis(ev.constant(nroot_np), 1, args.points_shape[1])  # [E,P,j]
        # v_i = sum_j G^{-T}[i,j] nroot[j]: broadcast nroot over the new i axis
        v = ev.sum_(ev.multiply(GinvT, ev.insertaxis(nroot, 2, d)), GinvT.ndim - 1)
        norm = ev.power(ev.sum_(ev.multiply(v, v), v.ndim - 1), ev.constant(0.5))
        return ev.multiply(v, _insertlast(ev.power(norm, ev.constant(-1.0)), d))


def _insert2(expr, shape):
    expr = ev.insertaxis(expr, expr.ndim, shape[-2])
    expr = ev.insertaxis(expr, expr.ndim, shape[-1])
    return expr


def _insertlast(expr, n):
    return ev.insertaxis(expr, expr.ndim, n)


class _Jacobian(Array):
    '''Integration measure: sqrt(det(T^T T)) with T = d(geom)/d(sample local).

    Lowers against the sample's intrinsic dimension (interior: |det|;
    boundary: surface measure), covering both dV and dS (reference:
    function.py:2206 jacobian / expression_v2 define_for jacobians).
    '''

    def __init__(self, geom, ndims=None):
        assert geom.ndim == 1
        self.geom = geom
        self.ndims_expected = ndims
        super().__init__((), float, geom.spaces, geom.arguments)

    def lower(self, args):
        charts = _chart_list(args)
        if self.geom.spaces and set(self.geom.spaces) < set(args.charts):
            # restrict to the geometry's own spaces: on zipped samples (two
            # aligned charts of the same physical domain, sample.zip) the
            # measure of a single-space geometry must not pick up the foreign
            # chart's tangent directions
            restricted = LowerArgs(points_shape=args.points_shape,
                                   charts={s: c for s, c in args.charts.items() if s in self.geom.spaces},
                                   opposite=args.opposite, part_ids=args.part_ids, part_topos=args.part_topos)
            return self.lower(restricted)
        # block-diagonal tangent matrix over the concatenated root chart
        E = args.points_shape[0]
        ds = sum(c.tangents.shape[-1] for c in charts)
        dtot = sum(c.X.shape[-1] for c in charts)
        if self.ndims_expected is not None:
            assert ds == self.ndims_expected, f'jacobian dimension mismatch: sample dim {ds}, expected {self.ndims_expected}'
        if ds == 0:
            return _prefix_broadcast(ev.constant(1.0), args.points_shape)
        tang_np = numpy.zeros((E, dtot, ds))
        r0 = c0 = 0
        for c in charts:
            dr, dc = c.tangents.shape[-2:]
            tang_np[:, r0:r0 + dr, c0:c0 + dc] = c.tangents
            r0 += dr
            c0 += dc
        G = _grad_all_charts(ev.astype(self.geom.lower(args), float), args)  # [E,P,g,d]
        tang = ev.insertaxis(ev.constant(tang_np), 1, args.points_shape[1])  # [E,P,d,ds]
        g = self.geom.shape[0]
        d = dtot
        # T[i,s] = sum_j G[i,j] tang[j,s]
        Gx = ev.insertaxis(G, G.ndim, ds)                       # [E,P,g,d,ds]
        Tx = ev.insertaxis(tang, tang.ndim - 2, g)              # [E,P,g,d,ds]
        T = ev.sum_(ev.multiply(Gx, Tx), G.ndim - 1)            # [E,P,g,ds]
        if g == ds:
            return ev.pointwise('abs', ev.Determinant(T))
        # gram determinant
        Ta = ev.insertaxis(T, T.ndim, ds)                        # [E,P,g,s,t]
        Tb = ev.insertaxis(T, T.ndim - 1, ds)                    # [E,P,g,s,t] (second copy transposed roles)
        gram = ev.sum_(ev.multiply(Ta, Tb), T.ndim - 2)          # [E,P,s,t]
        return ev.power(ev.Determinant(gram), ev.constant(0.5))


# ---------------------------------------------------------------- bases

class Basis(Array):
    '''Abstract basis: an array of ``ndofs`` scalar functions.

    Subclasses provide ``get_tables(elem_indices) -> (dofs [E, L],
    coeffs [E, L, K_1, ..., K_d])``: per-element local dof numbers and local
    polynomial coefficients (power basis in parent-local coordinates), and
    ``get_support(dof)`` / ``get_dofs(ielem)`` for constraint bookkeeping
    (reference: function.py:2704-2860).
    '''

    _origin = None  # home topology; set by the topology that built the basis

    def __init__(self, ndofs, nelems, space):
        self.ndofs = int(ndofs)
        self.nelems = int(nelems)
        self.space = space
        super().__init__((self.ndofs,), float, frozenset({space}), {})

    def get_tables(self, elem_indices):
        raise NotImplementedError

    def get_tables_factored(self, elem_indices):
        '''(dofs [E, L], variants [V, L, K...], vindex [E]) with
        ``coeffs[e] == variants[vindex[e]]``: the variant-compressed form of
        ``get_tables``.  Structured bases override this with an O(V) build —
        on a uniform grid V is 1 and the dense per-element coefficient table
        (hundreds of MB at ~1M dofs) never exists, neither on the host nor
        on the device.  ``vindex is None`` marks the trivial (identity) factoring, the
        default.'''
        dofs, coeffs = self.get_tables(elem_indices)
        return dofs, coeffs, None

    def get_dofs(self, ielem):
        dofs, _ = self.get_tables(numpy.asarray([ielem]))
        return numpy.unique(dofs[0])

    @functools.cached_property
    def _support(self):
        '''dof -> element index lists, inverted from the per-element tables.'''
        sup = [[] for _ in range(self.ndofs)]
        dofs, coeffs = self.get_tables(numpy.arange(self.nelems))
        nz = numpy.abs(coeffs.reshape(coeffs.shape[:2] + (-1,))).max(-1) > 0
        for ielem in range(self.nelems):
            for d in numpy.unique(dofs[ielem][nz[ielem]]):
                sup[d].append(ielem)
        return [numpy.asarray(s, dtype=int) for s in sup]

    def get_support(self, dof):
        '''Element indices supporting the given dof(s); boolean masks and
        index arrays take the union (reference: function.py:2754).'''
        dof = numpy.asarray(dof)
        if dof.dtype == bool:
            dof = dof.nonzero()[0]
        if dof.ndim == 0:
            return self._support[int(dof)]
        if len(dof) == 0:
            return numpy.empty(0, dtype=int)
        return numpy.unique(numpy.concatenate([self._support[int(d)] for d in dof]))

    def _resolve_chart(self, chart, E, P):
        '''Resolve a chart to (elem_indices [E], xi expression [E, P, d]) in
        this basis' home element numbering.  Samples of other members of the
        same refinement family resolve through the chart lineage (the analogue
        of the reference's index_with_tail chain resolution,
        transformseq.py:15).  Wrapper bases (Masked/Pruned) delegate to their
        parent so topology-specific resolutions (e.g. the structured
        root-coordinate lookup for sliced sub-grids) stay in effect.'''
        own = self._origin
        hier = getattr(own, '_hier', None) if own is not None else None
        if chart.origin_topo is own or hier is None or chart.lineage is None:
            return chart.index, chart.xi
        family, mylevel = hier
        cfamily, levels, elems = chart.lineage
        assert cfamily is family, 'sample belongs to a different refinement family'
        anc = family.ancestors_at(levels, elems, mylevel)
        lin, off = family.to_local(mylevel, anc)  # [E,d,d], [E,d]
        xi = _affine_of_X(chart.X, lin, off, E, P)
        return anc, xi

    def _chart_tables(self, chart, E, P):
        '''(dofs [E, L], coeffs (variants [V, L, K...], vindex [E]) or dense
        [E, L, K...], xi expression [E, P, d]).'''
        idx, xi = self._resolve_chart(chart, E, P)
        dofs, variants, vindex = self.get_tables_factored(idx)
        return dofs, (variants, vindex), xi

    def lower(self, args):
        chart = args.chart(self.space)
        E, P = args.points_shape
        dofs, coeffs, xi = self._chart_tables(chart, E, P)
        return _lower_poly_tables(dofs, coeffs, xi, P, self.ndofs)


def _affine_of_X(X, lin, off, E, P):
    '''xi[e,p,i] = lin[e,i,j] X[e,p,j] + off[e,i] as an expression.'''
    d_out = lin.shape[1]
    linx = ev.insertaxis(ev.constant(lin), 1, P)        # [E,P,d_out,d]
    Xx = ev.insertaxis(X, 2, d_out)                     # [E,P,d_out,d]
    xi = ev.sum_(ev.multiply(linx, Xx), 3)              # [E,P,d_out]
    return ev.add(xi, ev.insertaxis(ev.constant(off), 1, P))


def _lower_poly_tables(dofs, coeffs, xi, P, ndofs):
    '''Batched polynomial basis evaluation from per-element tables:
    vals[e,p,l] = sum_k coeffs[e,l,k...] prod_i xi_i^k_i, scattered to ndofs.

    ``coeffs`` is either dense [E, L, K...] or the variant-compressed pair
    (variants [V, L, K...], vindex [E]) from ``Basis.get_tables_factored``:
    the per-element table is then an in-kernel gather from the tiny variant
    table, so neither host memory, nor the transfer to the device, nor the
    device reads of the assembly ever touch a dense [E, L, K...] array.'''
    if isinstance(coeffs, tuple):
        variants, vindex = coeffs
        K = variants.shape[2:]
        if vindex is None:
            table = ev.constant(variants)  # identity factoring: already [E, L, K...]
        elif len(variants) == 1:
            table = ev.insertaxis(ev.constant(variants[0]), 0, len(vindex))
        else:
            table = ev.take(ev.constant(variants), ev.constant(vindex), 0)
    else:
        K = coeffs.shape[2:]
        table = ev.constant(coeffs)
    L = dofs.shape[1]
    dp = len(K)
    expr = ev.insertaxis(table, 1, P)  # [E,P,L,K...]
    for i in range(dp):
        xi_i = ev.take(xi, ev.constant(numpy.array(i)), 2)  # [E,P]
        mono = ev.Monomials(xi_i, K[i])  # [E,P,Ki]
        m = ev.insertaxis(mono, 2, L)  # [E,P,L,Ki]
        for j in range(i):
            m = ev.insertaxis(m, 3, K[j])
        for j in range(i + 1, dp):
            m = ev.insertaxis(m, m.ndim, K[j])
        expr = ev.multiply(expr, m)
    vals = ev.sum_(expr, tuple(range(3, 3 + dp)))  # [E,P,L]
    dofs_b = ev.constant(dofs[:, None, :])  # [E,1,L]
    return ev.inflate(vals, dofs_b, ndofs, 2)


class StructuredBasis(Basis):
    '''Tensor-product (B-)spline basis on a structured topology.

    Stores per-dimension offset/coefficient tables (O(n) memory) and builds
    per-element-batch tables on demand (reference: function.py:3029).  When
    lowered on a sample of a *different* (e.g. refined) topology of the same
    root chart, element membership and local coordinates are recovered from
    the root coordinates (the analogue of the reference's
    ``index_with_tail`` chain resolution, transformseq.py:15).
    '''

    def __init__(self, space, offsets_per_dim, coeffs_per_dim, ndofs_per_dim, shape, topo=None, root_h=1.0):
        from .ops import spline as _spline
        self._offsets = offsets_per_dim
        self._coeffs = coeffs_per_dim
        self._ndofs_per_dim = ndofs_per_dim
        self._shape = tuple(shape)  # elements per dim
        self._topo = topo
        self._root_h = float(root_h)
        self._tensor_tables = _spline.tensor_tables
        ndofs = int(numpy.prod(ndofs_per_dim, dtype=numpy.int64))
        nelems = int(numpy.prod(shape, dtype=numpy.int64))
        super().__init__(ndofs, nelems, space)

    def get_tables(self, elem_indices):
        multi = numpy.stack(numpy.unravel_index(
            numpy.asarray(elem_indices, dtype=numpy.int32), self._shape), axis=1)
        return self._tensor_tables(self._offsets, self._coeffs, self._ndofs_per_dim, multi)

    def get_tables_factored(self, elem_indices):
        from .ops import spline as _spline
        multi = numpy.stack(numpy.unravel_index(
            numpy.asarray(elem_indices, dtype=numpy.int32), self._shape), axis=1)
        return _spline.tensor_tables_factored(self._offsets, self._coeffs,
                                              self._ndofs_per_dim, multi)

    def lower(self, args):
        '''Axis-factored evaluation: per-dimension 1-D polynomial values are
        multiplied pointwise instead of tensorizing the coefficient tables
        into one joint [K_1,...,K_d] monomial sum.  Same result up to float
        associativity, fewer flops, and — decisive for nodal (lagrange)
        bases — per-axis cancellation stays exact: a factor that is exactly
        zero on an element face zeroes the product exactly, where the joint
        sum mixes axes and leaves ~1e-14 residue that droptol-based
        constraint detection (solver.solve_constraints) mistakes for
        support.'''
        chart = args.chart(self.space)
        E, P = args.points_shape
        idx, xi = self._resolve_chart(chart, E, P)
        multi = numpy.stack(numpy.unravel_index(
            numpy.asarray(idx, dtype=numpy.int64), self._shape), axis=1)  # [E, d]
        vals = None
        dofs = None
        for i in range(len(self._shape)):
            ci = numpy.asarray(self._coeffs[i])  # [n_i, p+1 funcs, K powers]
            ni, p1, K = ci.shape
            ei = multi[:, i]
            u, inv = numpy.unique(ci.reshape(ni, p1 * K), axis=0, return_inverse=True)
            if len(u) == 1:
                tab = ev.insertaxis(ev.constant(u.reshape(p1, K)), 0, E)
            else:
                tab = ev.take(ev.constant(u.reshape(len(u), p1, K)),
                              ev.constant(inv[ei]), 0)
            tab = ev.insertaxis(tab, 1, P)                          # [E,P,p+1,K]
            xi_i = ev.take(xi, ev.constant(numpy.array(i)), 2)      # [E,P]
            mono = ev.insertaxis(ev.Monomials(xi_i, K), 2, p1)      # [E,P,p+1,K]
            v_i = ev.sum_(ev.multiply(tab, mono), 3)                # [E,P,p+1]
            nd = int(self._ndofs_per_dim[i])
            d_i = (numpy.asarray(self._offsets[i], dtype=numpy.int64)[ei][:, None]
                   + numpy.arange(p1)) % nd                         # [E,p+1]
            if vals is None:
                vals, dofs = v_i, d_i
            else:
                Lprev = dofs.shape[1]
                vals = ev.multiply(ev.insertaxis(vals, 3, p1),
                                   ev.insertaxis(v_i, 2, Lprev))    # [E,P,Lprev,p+1]
                vals = ev.ravel(vals, 2)                            # [E,P,Lprev*(p+1)]
                dofs = (dofs[:, :, None] * nd + d_i[:, None, :]).reshape(len(dofs), Lprev * p1)
        return ev.inflate(vals, ev.constant(dofs[:, None, :]), self.ndofs, 2)

    def _resolve_chart(self, chart, E, P):
        if self._topo is None or chart.origin_topo is self._topo:
            return super()._resolve_chart(chart, E, P)
        # cross-topology (refined, sliced, located samples): locate our
        # elements from the root coordinate table
        Xtab = numpy.asarray(chart.X.value)  # [E, P, d]
        cent = Xtab.mean(axis=1) / self._root_h
        multi = numpy.minimum(numpy.maximum(numpy.floor(cent).astype(int), 0),
                              numpy.array(self._shape) - 1)  # [E, d]
        flat = numpy.ravel_multi_index(tuple(multi.T), self._shape)
        dp = multi.shape[1]
        # local coords in our elements: X / h - elem_multi
        origin = ev.insertaxis(ev.constant(multi.astype(float)), 1, P)  # [E,P,d]
        xi = ev.add(ev.multiply(chart.X, _prefix_broadcast(ev.constant(1.0 / self._root_h), (E, P, dp))), ev.negative(origin))
        return flat, xi


class MaskedBasis(Basis):
    '''An order-preserving subset of a basis: removed functions evaluate to
    zero (reference: function.py:2990).  Per-element tables keep their static
    shape; removed local functions get zeroed coefficients and dof 0.'''

    def __init__(self, parent, mask):
        self._parent = parent
        self._origin = parent._origin
        mask = numpy.asarray(mask, dtype=bool)
        assert mask.shape == (parent.ndofs,)
        self._renumber = numpy.cumsum(mask) - 1
        self._mask = mask
        super().__init__(int(mask.sum()), parent.nelems, parent.space)

    def _resolve_chart(self, chart, E, P):
        return self._parent._resolve_chart(chart, E, P)

    def get_tables(self, elem_indices):
        pd, pc = self._parent.get_tables(elem_indices)
        keep = self._mask[pd]
        ren = self._renumber[pd]
        # removed functions carry zero coefficients; point their dof slot at
        # a kept dof OF THE SAME ELEMENT (the first one) rather than dof 0,
        # so the structurally-zero pattern entries stay inside the stencil
        # window of the dof grid instead of linking every boundary element
        # to dof 0 (which would defeat the slice-form device operators)
        has = keep.any(axis=1)
        firstk = keep.argmax(axis=1)
        fallback = numpy.where(has, numpy.take_along_axis(ren, firstk[:, None], 1)[:, 0], 0)
        dofs = numpy.where(keep, ren, fallback[:, None])
        coeffs = numpy.where(keep.reshape(keep.shape + (1,) * (pc.ndim - 2)), pc, 0.0)
        return dofs, coeffs

    def get_tables_factored(self, elem_indices):
        pd, variants, vindex = self._parent.get_tables_factored(elem_indices)
        keep = self._mask[pd]
        ren = self._renumber[pd]
        has = keep.any(axis=1)
        firstk = keep.argmax(axis=1)
        fallback = numpy.where(has, numpy.take_along_axis(ren, firstk[:, None], 1)[:, 0], 0)
        dofs = numpy.where(keep, ren, fallback[:, None])
        if vindex is None:
            coeffs = numpy.where(keep.reshape(keep.shape + (1,) * (variants.ndim - 2)), variants, 0.0)
            return dofs, coeffs, None
        # the zeroing pattern joins the variant key: realized (variant,
        # keep-row) pairs stay few because masking follows grid boundaries
        krows, kinv = numpy.unique(keep, axis=0, return_inverse=True)
        combo = vindex * len(krows) + kinv
        realized, new_vindex = numpy.unique(combo, return_inverse=True)
        v_id = realized // len(krows)
        k_id = realized % len(krows)
        shaped = krows[k_id].reshape((len(realized),) + krows.shape[1:] + (1,) * (variants.ndim - 2))
        new_variants = numpy.where(shaped, variants[v_id], 0.0)
        return dofs, new_variants, new_vindex.astype(numpy.int64)


class PrunedBasis(Basis):
    '''Restriction of a basis to the dofs supported on a subset of elements
    (reference: function.py:3103 PrunedBasis).  The element index space stays
    that of the parent topology — only the dof axis is renumbered — so charts
    of trimmed topologies (which carry base element ids) lower unchanged.'''

    def __init__(self, parent, kept_elems):
        self._parent = parent
        self._origin = parent._origin
        kept_elems = numpy.asarray(kept_elems, dtype=int)
        pd, pc = parent.get_tables(kept_elems)
        nz = numpy.abs(pc.reshape(pc.shape[:2] + (-1,))).max(-1) > 0
        self._dofmap = numpy.unique(pd[nz])
        self._renumber = numpy.full(parent.ndofs, -1, dtype=int)
        self._renumber[self._dofmap] = numpy.arange(len(self._dofmap))
        super().__init__(len(self._dofmap), parent.nelems, parent.space)

    def _resolve_chart(self, chart, E, P):
        return self._parent._resolve_chart(chart, E, P)

    def get_tables(self, elem_indices):
        pd, pc = self._parent.get_tables(elem_indices)
        rd = self._renumber[pd]
        bad = rd < 0
        if bad.any():
            rd = numpy.where(bad, 0, rd)
            pc = numpy.where(bad.reshape(bad.shape + (1,) * (pc.ndim - 2)), 0.0, pc)
        return rd, pc

    def get_tables_factored(self, elem_indices):
        pd, variants, vindex = self._parent.get_tables_factored(elem_indices)
        rd = self._renumber[pd]
        bad = rd < 0
        if not bad.any():
            return rd, variants, vindex
        rd = numpy.where(bad, 0, rd)
        if vindex is None:
            pc = numpy.where(bad.reshape(bad.shape + (1,) * (variants.ndim - 2)), 0.0, variants)
            return rd, pc, None
        brows, binv = numpy.unique(bad, axis=0, return_inverse=True)
        combo = vindex * len(brows) + binv
        realized, new_vindex = numpy.unique(combo, return_inverse=True)
        v_id = realized // len(brows)
        b_id = realized % len(brows)
        shaped = brows[b_id].reshape((len(realized),) + brows.shape[1:] + (1,) * (variants.ndim - 2))
        new_variants = numpy.where(shaped, 0.0, variants[v_id])
        return rd, new_variants, new_vindex.astype(numpy.int64)


class PlainBasis(Basis):
    '''Basis from explicit per-element tables (unstructured topologies).

    With ``ragged=True`` the tables are python lists (mixed element types);
    any requested element subset must then be type-uniform (one bucket), which
    the sampling layer guarantees.
    '''

    def __init__(self, space, dofs, coeffs, ndofs, ragged=False):
        self._ragged = ragged
        if ragged:
            self._dofs = [numpy.asarray(d) for d in dofs]
            self._elemcoeffs = [numpy.asarray(c) for c in coeffs]
            nelems = len(self._dofs)
        else:
            self._dofs = numpy.asarray(dofs)
            self._elemcoeffs = numpy.asarray(coeffs)
            nelems = len(self._dofs)
        super().__init__(ndofs, nelems, space)

    def get_tables(self, elem_indices):
        if not self._ragged:
            return self._dofs[elem_indices], self._elemcoeffs[elem_indices]
        lens = [len(self._dofs[i]) for i in elem_indices]
        Lmax = max(lens, default=1)
        if all(n == Lmax for n in lens):
            dofs = numpy.stack([self._dofs[i] for i in elem_indices])
            coeffs = numpy.stack([self._elemcoeffs[i] for i in elem_indices])
            return dofs, coeffs
        # mixed-size batch (e.g. triangles and squares): pad with zero
        # coefficients on dof 0, which inflate sums to nothing
        Kshape = self._elemcoeffs[elem_indices[0]].shape[1:]
        dofs = numpy.zeros((len(elem_indices), Lmax), dtype=int)
        coeffs = numpy.zeros((len(elem_indices), Lmax) + Kshape)
        for k, i in enumerate(elem_indices):
            n = lens[k]
            dofs[k, :n] = self._dofs[i]
            coeffs[k, :n] = self._elemcoeffs[i]
        return dofs, coeffs

    @functools.cached_property
    def _support(self):
        sup = [[] for _ in range(self.ndofs)]
        for ielem in range(self.nelems):
            for d in numpy.unique(self._dofs[ielem]):
                sup[d].append(ielem)
        return [numpy.asarray(s, dtype=int) for s in sup]


# ---------------------------------------------------------------- builders

def add(a, b):
    a, b = asarray(a), asarray(b)
    if iscomplex(a) or iscomplex(b):
        return _map_parts(add, a, b)
    a, b, _ = _coerce_pair(a, b)
    return _Add(a, b)


def subtract(a, b):
    return add(a, negative(b))


def multiply(a, b):
    a, b = asarray(a), asarray(b)
    if iscomplex(a) or iscomplex(b):
        ca, cb = _as_complex(a), _as_complex(b)
        return _Complex(subtract(multiply(ca.real, cb.real), multiply(ca.imag, cb.imag)),
                        add(multiply(ca.real, cb.imag), multiply(ca.imag, cb.real)))
    a, b, _ = _coerce_pair(a, b)
    return _Multiply(a, b)


def divide(a, b):
    a, b = asarray(a), asarray(b)
    if iscomplex(b):
        cb = _as_complex(b)
        den = add(multiply(cb.real, cb.real), multiply(cb.imag, cb.imag))
        return multiply(a, _Complex(divide(cb.real, den), negative(divide(cb.imag, den))))
    return multiply(a, power(b, -1))


def negative(a):
    a = asarray(a)
    if iscomplex(a):
        return _map_parts(negative, a)
    return _Neg(a)


def power(a, b):
    a, b = asarray(a), asarray(b)
    if iscomplex(b):
        raise NotImplementedError('complex exponents are not supported')
    if iscomplex(a):
        if isinstance(b, _Constant) and b.ndim == 0 and float(b.value) == int(b.value):
            n = int(b.value)
            if n < 0:
                return divide(asarray(1.), power(a, -n))
            out = _Complex(ones(a.shape), zeros(a.shape))
            for _ in range(n):
                out = multiply(out, a)
            return out
        raise NotImplementedError('complex base requires a constant integer exponent')
    return _Power(_cast(a, float), _cast(b, float))


def sqrt(a):
    return power(a, .5)


def real(a):
    return asarray(a).real


def imag(a):
    return asarray(a).imag


def conjugate(a):
    return asarray(a).conjugate()


conj = conjugate


def sum_(a, axis=None):
    a = asarray(a)
    if axis is None:
        axes = tuple(range(a.ndim))
    elif isinstance(axis, int):
        axes = (axis,)
    else:
        axes = tuple(axis)
    if not axes:
        return a
    return _Sum(a, axes)


def matmul(a, b):
    '''numpy.matmul semantics for ndim <= 2 operands (vector dot, mat-vec,
    vec-mat, mat-mat); higher-rank batched matmul is not needed by the API.'''
    a, b = asarray(a), asarray(b)
    assert a.ndim >= 1 and b.ndim >= 1
    if a.ndim == 1 and b.ndim == 1:
        return _Sum(multiply(a, b), (0,))
    if b.ndim == 1:  # [..., i, k] @ [k] -> [..., i]
        return _Sum(multiply(a, b), (a.ndim - 1,))
    if a.ndim == 1:  # [k] @ [..., k, j] -> [..., j]
        ax = _InsertAxis(a, 1, 1)  # [k, 1]
        for _ in range(b.ndim - 2):
            ax = _InsertAxis(ax, 0, 1)
        return _Sum(multiply(ax, b), (b.ndim - 2,))
    assert a.ndim == 2 and b.ndim == 2, 'batched matmul not supported'
    an = _InsertAxis(a, 2, b.shape[1])      # [i, k, j]
    bn = _InsertAxis(b, 0, a.shape[0])      # [i, k, j]
    return _Sum(multiply(an, bn), (1,))


def transpose(a, axes=None):
    a = asarray(a)
    if axes is None:
        axes = tuple(reversed(range(a.ndim)))
    return _Transpose(a, axes)


def insertaxis(a, axis, length):
    return _InsertAxis(asarray(a), axis, length)


def stack(arrays, axis=0):
    arrays = [asarray(a) for a in arrays]
    expanded = [_InsertAxis(a, axis, 1) for a in arrays]
    return _Concatenate(expanded, axis)


def concatenate(arrays, axis=0):
    return _Concatenate([asarray(a) for a in arrays], axis)


def getitem(a, item):
    a = asarray(a)
    if not isinstance(item, tuple):
        item = (item,)
    # expand ellipsis (None entries add axes and consume none)
    if Ellipsis in item:
        i = item.index(Ellipsis)
        nmissing = a.ndim - sum(1 for x in item if x is not None and x is not Ellipsis)
        item = item[:i] + (slice(None),) * nmissing + item[i + 1:]
    out = a
    axis = 0
    for it in item:
        if it is None:  # numpy.newaxis
            out = insertaxis(out, axis, 1)
            axis += 1
        elif isinstance(it, slice):
            if it == slice(None):
                axis += 1
                continue
            idx = numpy.arange(*it.indices(out.shape[axis]))
            out = _Take(out, idx, axis)
            axis += 1
        elif isinstance(it, (int, numpy.integer)):
            it = it % out.shape[axis]
            out = _TakeScalar(out, it, axis)
        elif isinstance(it, (list, numpy.ndarray)):
            out = _Take(out, numpy.asarray(it), axis)
            axis += numpy.asarray(it).ndim
        else:
            raise NotImplementedError(f'index {it!r}')
    return out


class _TakeScalar(Array):

    def __new__(cls, arg, index, axis):
        if iscomplex(arg):
            return _map_parts(lambda x: _TakeScalar(x, index, axis), arg)
        return super().__new__(cls)

    def __init__(self, arg, index, axis):
        self.arg = arg
        self.index = int(index)
        self.axis = axis
        shape = arg.shape[:axis] + arg.shape[axis + 1:]
        super().__init__(shape, arg.dtype, arg.spaces, arg.arguments)

    def lower(self, args):
        expr = ev.take(self.arg.lower(args), ev.constant(numpy.array(self.index)), args.nprefix + self.axis)
        return expr


def grad(arg, geom):
    geom = asarray(geom)
    if geom.ndim == 0:  # scalar geometry: promote, differentiate, squeeze
        g = _Gradient(asarray(arg), stack([geom], axis=0))
        return _TakeScalar(g, 0, g.ndim - 1)
    return _Gradient(asarray(arg), geom)


def div(arg, geom):
    return trace(grad(arg, geom))


def trace(a, axis1=-2, axis2=-1):
    a = asarray(a)
    axis1 = axis1 % a.ndim
    axis2 = axis2 % a.ndim
    assert a.shape[axis1] == a.shape[axis2]
    n = a.shape[axis1]
    parts = []
    for i in range(n):
        x = _TakeScalar(a, i, max(axis1, axis2))
        x = _TakeScalar(x, i, min(axis1, axis2))
        parts.append(x)
    out = parts[0]
    for p in parts[1:]:
        out = add(out, p)
    return out


def levicivita(n):
    eps = numpy.zeros((n,) * n)
    for perm in itertools.permutations(range(n)):
        eps[perm] = numpy.linalg.det(numpy.eye(n)[list(perm)])
    return _Constant(eps)


def curl(arg, geom):
    '''curl_i(a) = eps_ijk d_j a_k for 3-D vector fields (and the scalar/2-D
    analogues via the k-slot of the gradient).'''
    geom = asarray(geom)
    assert geom.shape == (3,), 'curl requires 3-D geometry'
    g = grad(asarray(arg), geom)  # [..., k, j]
    # out[..., i] = sum_{j,k} eps[i,j,k] g[..., k, j], assembled per component
    comps = []
    for i in range(3):
        term = None
        for j in range(3):
            for k in range(3):
                e = float(numpy.linalg.det(numpy.eye(3)[[i, j, k]])) if len({i, j, k}) == 3 else 0.0
                if e:
                    t = multiply(e, _TakeScalar(_TakeScalar(g, j, g.ndim - 1), k, g.ndim - 2))
                    term = t if term is None else add(term, t)
        comps.append(term)
    return stack(comps, axis=-1)


def surfgrad(arg, geom):
    '''Surface (tangential) gradient: the gradient projected onto the plane
    orthogonal to the boundary normal (reference: function.py:2253).'''
    g = grad(arg, geom)                      # [..., d]
    n = normal(geom)                         # [d]
    gn = sum_(multiply(g, n), g.ndim - 1)    # [...]
    return subtract(g, multiply(insertaxis(gn, gn.ndim, n.shape[0]), n))


def curvature(geom, ndims=-1):
    '''Additive curvature of the geometry: the surface divergence of the
    normal (reference: function.py:2272).'''
    return trace(surfgrad(normal(geom), geom))


def kronecker(arg, axis, length, pos):
    '''Position ``pos`` of a new length-``length`` axis carries ``arg``, the
    rest zeros (reference: function.py kronecker).'''
    arg = asarray(arg)
    parts = [arg if i == pos else zeros(arg.shape, arg.dtype) for i in range(length)]
    return stack(parts, axis=axis)


def scatter(arr, length, indices):
    '''Distribute the last axis of ``arr`` over a new axis of the given length
    at the (unique) indices (reference: function.py:1799).'''
    arr = asarray(arr)
    indices = numpy.asarray(indices)
    assert indices.ndim == 1 and arr.shape[-1] == len(indices)
    parts = []
    for i in range(int(length)):
        hits = numpy.nonzero(indices == i)[0]
        parts.append(getitem(arr, (Ellipsis, int(hits[0]))) if len(hits) else zeros(arr.shape[:-1]))
    return stack(parts, axis=-1)


def trignormal(angle):
    '''Unit vector [cos, sin] (reference: function.py:2579).'''
    angle = asarray(angle)
    return stack([cos(angle), sin(angle)], axis=-1)


def trigtangent(angle):
    '''Unit vector [-sin, cos] (reference: function.py:2583).'''
    angle = asarray(angle)
    return stack([negative(sin(angle)), cos(angle)], axis=-1)


def rotmat(angle):
    return stack([trignormal(angle), trigtangent(angle)], axis=0)


def _unwrap_linearized(res, trials):
    '''If res is a sum of _Linearized terms of one functional covering all
    trials, return that functional (System then uses the symmetric path).'''
    terms = []

    def walk(a):
        if isinstance(a, _Add):
            walk(a.operands[0])
            walk(a.operands[1])
        else:
            terms.append(a)
    try:
        walk(asarray(res))
    except Exception:
        return None
    if not terms or not all(isinstance(t, _Linearized) and isinstance(t.direction, Argument) for t in terms):
        return None
    base = terms[0].func
    if not all(t.func is base for t in terms):
        return None
    if set(t.uname for t in terms) != set(trials):
        return None
    return base


def linearize(functional, targets):
    '''Directional derivative of ``functional`` toward new (test) arguments:
    'u:v' (or a dict {name: direction}) introduces v dual to u (reference:
    function.py:1924); evaluated as one jvp pass over the argument binding
    (evaluable.ArgGrad).  A direction may be a plain test-argument name or an
    Array of the argument's shape (e.g. a masked test argument).'''
    functional = asarray(functional)
    if isinstance(targets, str):
        targets = dict(t.split(':') for t in targets.split(','))
    out = None
    for u, v in targets.items():
        shape = arguments_for(functional)[u].shape
        direction = Argument(v, shape) if isinstance(v, str) else asarray(v)
        assert direction.shape == tuple(shape), 'direction shape must match the argument'
        term = _Linearized(functional, u, direction, shape)
        out = term if out is None else add(out, term)
    return out


class _Linearized(Array):
    def __init__(self, func, uname, direction, ushape):
        self.func = func
        self.uname = uname
        self.direction = direction
        self.ushape = tuple(ushape)
        args = dict(func.arguments)
        for name, spec in direction.arguments.items():
            prev = args.setdefault(name, spec)
            assert prev == spec
        super().__init__(func.shape, float, func.spaces, args)

    @property
    def vname(self):
        return self.direction.name if isinstance(self.direction, Argument) else None

    def lower(self, args):
        inner = ev.astype(self.func.lower(args), float)
        direction = ev.astype(self.direction.lower(EMPTY_LOWER_ARGS), float)
        return ev.ArgGrad(inner, self.uname, direction)


def laplace(arg, geom):
    return trace(grad(grad(arg, geom), geom))


def normal(geom):
    geom = asarray(geom)
    if geom.ndim == 0:
        return _TakeScalar(_Normal(stack([geom], axis=0)), 0, 0)
    return _Normal(geom)


def jacobian(geom, ndims=None):
    geom = asarray(geom)
    if geom.ndim == 0:
        geom = stack([geom], axis=0)
    return _Jacobian(geom, ndims)


def J(geom):
    return jacobian(geom, None)


def normalized(a):
    a = asarray(a)
    return divide(a, sqrt(_Sum(multiply(a, a), (a.ndim - 1,))))


def symgrad(arg, geom):
    '''Symmetric gradient .5 (∇_j u_i + ∇_i u_j) (reference: function.py
    symgrad).'''
    g = grad(arg, geom)
    axes = list(range(g.ndim))
    axes[-1], axes[-2] = axes[-2], axes[-1]
    return 0.5 * (g + transpose(g, tuple(axes)))


def dotnorm(arg, geom, axis=-1):
    '''Inner product of ``arg``'s ``axis`` with the geometry normal
    (reference: function.py:2161).'''
    arg = asarray(arg)
    axis = axis % arg.ndim
    if axis != arg.ndim - 1:
        order = [i for i in range(arg.ndim) if i != axis] + [axis]
        arg = transpose(arg, tuple(order))
    return sum_(multiply(arg, normal(geom)), -1)


def ngrad(arg, geom):
    '''Normal derivative n_i ∇_i(u) (reference: function.py ngrad).'''
    return dotnorm(grad(arg, geom), geom)


def nsymgrad(arg, geom):
    '''Normal component of the symmetric gradient (reference: function.py
    nsymgrad).'''
    return dotnorm(symgrad(arg, geom), geom)


def tangent(geom, vec):
    '''Tangential component of ``vec``: vec - (vec.n) n (reference:
    function.py:2185).'''
    vec = asarray(vec)
    n = normal(geom)
    return subtract(vec, multiply(dotnorm(vec, geom), n))


def sign(a):
    return _Pointwise('sign', _cast(asarray(a), float))


def piecewise(level, intervals, *funcs):
    '''Piecewise function of a scalar ``level``: ``funcs[i]`` on the i-th
    interval, bins split strictly at ``intervals`` (reference:
    function.py:2468).'''
    level = asarray(level)
    assert len(funcs) == len(tuple(intervals)) + 1, 'need len(intervals)+1 functions'
    out = asarray(funcs[0])
    for iv, f in zip(intervals, funcs[1:]):
        out = _Choose(_Compare('less', asarray(iv), level), asarray(f), out)
    return out


def partition(f, *levels):
    '''Partition of unity from a scalar function: n levels give n+1
    indicators, 1 inside their bin and 1/2 exactly at the bin boundaries
    (reference: function.py:2474).'''
    f = asarray(f)
    signs = [sign(subtract(f, lvl)) for lvl in levels]
    steps = [0.5 * (s + 1.0) for s in signs]  # 0 below, 1/2 at, 1 above each level
    out = [1.0 - steps[0]]
    out.extend(steps[i] - steps[i + 1] for i in range(len(steps) - 1))
    out.append(steps[-1])
    return out


def chain(funcs):
    '''Embed each function into the concatenated dof space, zero-padded over
    the other functions' blocks (reference: function.py:2546).'''
    funcs = [asarray(f) for f in funcs]
    sizes = [int(f.shape[0]) for f in funcs]
    return [concatenate([f if i == j else zeros((n,) + tuple(int(s) for s in f.shape[1:]), dtype=f.dtype)
                         for j, n in enumerate(sizes)], axis=0)
            for i, f in enumerate(funcs)]


def broadcast_shapes(*shapes):
    '''numpy broadcasting of shape tuples (reference: function.py
    broadcast_shapes).'''
    return numpy.broadcast_shapes(*shapes)


def broadcast_to(arg, shape):
    '''Broadcast a function array to ``shape`` (new leading axes and
    length-1 expansion).'''
    a = asarray(arg)
    shape = tuple(int(n) for n in shape)
    if len(shape) < a.ndim:
        raise ValueError(f'cannot broadcast {a.shape} to smaller rank {shape}')
    for n in shape[:len(shape) - a.ndim][::-1]:
        a = _InsertAxis(a, 0, n)
    for i, (have, want) in enumerate(zip(a.shape, shape)):
        if int(have) == want:
            continue
        if int(have) != 1:
            raise ValueError(f'cannot broadcast axis {i} of length {have} to {want}')
        a = _InsertAxis(getitem(a, (slice(None),) * i + (0,)), i, want)
    return a


def broadcast_arrays(*arrays):
    '''Broadcast function arrays against each other (reference: function.py
    broadcast_arrays).'''
    arrays = [asarray(a) for a in arrays]
    shape = broadcast_shapes(*[tuple(int(n) for n in a.shape) for a in arrays])
    return tuple(broadcast_to(a, shape) for a in arrays)


def typecast_arrays(*arrays, min_dtype=bool):
    '''Promote function arrays to their joint dtype, at least ``min_dtype``
    (reference: function.py typecast_arrays).'''
    arrays = [asarray(a) for a in arrays]
    order = [bool, int, float]
    dtype = max([_result_dtype(*arrays), min_dtype], key=order.index)
    return tuple(_cast(a, dtype) for a in arrays)


def evaluate(*funcs, arguments=None, **kwargs):
    '''Evaluate space-less function arrays to numpy values (reference:
    function.py evaluate).'''
    out = eval(list(funcs), arguments, **kwargs)
    return tuple(numpy.asarray(v) for v in out)


def dotarg(name, *arrays, shape=(), dtype=float):
    '''Contraction of a new argument with bases (reference: function.py:2591).

    The argument has shape (len(b_1), ..., len(b_k)) + shape; each basis's
    leading axis is contracted in turn and its trailing axes (e.g. the vector
    components of a ``vectorize``d basis) are appended to the result.
    '''
    result = Argument(name, tuple(b.shape[0] for b in arrays) + tuple(shape), dtype)
    for b in arrays:
        b = asarray(b)
        nrest = result.ndim - 1
        ntrail = b.ndim - 1
        # b: [n, tb...] -> [n, 1 x nrest, tb...]
        bx = b
        for _ in range(nrest):
            bx = _InsertAxis(bx, 1, 1)
        # result: [n, rest...] -> [n, rest..., 1 x ntrail]
        rx = result
        for _ in range(ntrail):
            rx = _InsertAxis(rx, rx.ndim, 1)
        result = _Sum(multiply(bx, rx), (0,))
    return result


def field(name, *arrays, shape=(), dtype=float):
    for a in arrays:
        parts = getattr(a, '_field_parts', None)
        if parts is not None and not shape:
            total = sum(p[0] for p in parts)
            register_field_parts(name, total, parts)
            break
        grid = getattr(a, '_ndofs_per_dim', None)
        if grid is not None:
            topo = getattr(a, '_topo', None)
            per = tuple(i in getattr(topo, 'periodic', ()) for i in range(len(grid)))
            size = int(numpy.prod(tuple(grid) + tuple(shape), dtype=numpy.int64))
            register_field_grid(name, size, tuple(grid) + tuple(shape), per)
            break
    else:
        # a field without a grid layout (an unstructured basis) replaces any
        # earlier field of the same name and size: its hint would be stale
        size = int(numpy.prod([asarray(a).shape[0] for a in arrays] + list(shape), dtype=numpy.int64))
        _FIELD_GRIDS.pop((name, size), None)
    return dotarg(name, *arrays, shape=shape, dtype=dtype)


# Structured dof-grid layouts of named field arguments, recorded by
# topology.field / function.vectorize for bases with a tensor-product dof
# numbering: the solver hands them to the matrix layer, where they replace
# pattern INFERENCE of the grid (exact, alias-free) for the stencil/
# block-grid device operators and the multigrid setup.  Values are lists of
# (size, grid, periodic) parts — one for plain fields, several for
# composite (vectorized) fields whose dof vector concatenates sub-bases on
# different grids.  Keyed by (name, flat size); the latest field of a name
# and size holds the key, and a System reads its fields' layouts when it is
# made.
_FIELD_GRIDS = {}


def register_field_parts(name, size, parts):
    key = (name, int(size))
    val = tuple((int(s), tuple(int(g) for g in grid),
                 tuple(bool(p) for p in per) + (False,) * (len(grid) - len(per)))
                for s, grid, per in parts)
    _FIELD_GRIDS[key] = val


def register_field_grid(name, size, grid, periodic=()):
    register_field_parts(name, size, [(size, grid, periodic)])


def field_parts(name, size):
    '''List of (size, grid shape, per-axis periodicity) parts of a
    registered field, or None.'''
    return _FIELD_GRIDS.get((name, int(size)))


def field_grid(name, size):
    '''(grid shape, per-axis periodicity) of a single-part registered
    field, or None.'''
    parts = _FIELD_GRIDS.get((name, int(size)))
    if parts is not None and len(parts) == 1:
        return parts[0][1], parts[0][2]
    return None


def eye(n):
    return _Constant(numpy.eye(n))


def ones(shape, dtype=float):
    return _Constant(numpy.ones(shape))


def zeros(shape, dtype=float):
    return _Constant(numpy.zeros(shape))


def heaviside(a):
    return _Choose(_Compare('less', asarray(0.0), asarray(a)), asarray(1.0), asarray(0.0))


def min_(a, b):
    return _Pointwise('minimum', *(_coerce_pair(a, b)[:2]))


def max_(a, b):
    return _Pointwise('maximum', *(_coerce_pair(a, b)[:2]))


def arctan2(a, b):
    a, b, _ = _coerce_pair(a, b)
    return _Pointwise('arctan2', _cast(a, float), _cast(b, float))


def less(a, b):
    a, b, _ = _coerce_pair(a, b)
    return _Compare('less', a, b)


def greater(a, b):
    a, b, _ = _coerce_pair(a, b)
    return _Compare('less', b, a)


def equal(a, b):
    a, b, _ = _coerce_pair(a, b)
    return _Compare('equal', a, b)


def logical_not(a):
    return equal(asarray(a), False)


def not_equal(a, b):
    return logical_not(equal(a, b))


def less_equal(a, b):
    return logical_not(greater(a, b))


def greater_equal(a, b):
    return logical_not(less(a, b))


def logical_and(a, b):
    return _Choose(asarray(a), asarray(b), asarray(False))


def logical_or(a, b):
    return _Choose(asarray(a), asarray(True), asarray(b))


def where(cond, iftrue, iffalse):
    '''Elementwise select (numpy.where semantics).'''
    return _Choose(asarray(cond), asarray(iftrue), asarray(iffalse))


def prod(a, axis=-1):
    '''Product over a static axis (unrolled; axes are small in FEM use).'''
    a = asarray(a)
    axis = axis % a.ndim
    pre = (slice(None),) * axis
    out = getitem(a, pre + (0,))
    for i in range(1, int(a.shape[axis])):
        out = multiply(out, getitem(a, pre + (i,)))
    return out


def choose(index, choices):
    '''Select elementwise among ``choices`` by integer ``index``
    (numpy.choose semantics; reference: Array.choose).'''
    assert len(choices) > 0
    out = asarray(choices[0])
    for j, c in enumerate(choices[1:], start=1):
        out = _Choose(equal(asarray(index), j), asarray(c), out)
    return out


def einsum(subscripts, *operands):
    '''Einstein summation over function arrays: explicit or implicit output
    spec, no ellipsis, no repeated index within one operand (use trace).'''
    in_spec, arrow, out_spec = subscripts.replace(' ', '').partition('->')
    terms = in_spec.split(',')
    if len(terms) != len(operands):
        raise ValueError(f'einsum: {len(terms)} subscript terms for {len(operands)} operands')
    operands = [asarray(op) for op in operands]
    sizes = {}
    order = []
    for term, op in zip(terms, operands):
        if len(term) != op.ndim:
            raise ValueError(f'einsum: term {term!r} does not match operand of rank {op.ndim}')
        if len(set(term)) != len(term):
            raise NotImplementedError('einsum: repeated index within one operand')
        for ax, (letter, n) in enumerate(zip(term, op.shape)):
            n = int(n)
            if letter in sizes:
                if sizes[letter] != n and 1 not in (sizes[letter], n):
                    raise ValueError(f'einsum: size mismatch for index {letter!r}')
                sizes[letter] = max(sizes[letter], n)
            else:
                sizes[letter] = n
                order.append(letter)
    if not arrow:
        counts = {}
        for term in terms:
            for letter in term:
                counts[letter] = counts.get(letter, 0) + 1
        out_spec = ''.join(sorted(letter for letter, c in counts.items() if c == 1))
    if len(set(out_spec)) != len(out_spec) or not set(out_spec) <= set(sizes):
        raise ValueError(f'einsum: invalid output spec {out_spec!r}')
    # align every operand to the union index order, multiply, contract
    aligned = []
    for term, op in zip(terms, operands):
        perm = sorted(range(len(term)), key=lambda ax: order.index(term[ax]))
        op = transpose(op, tuple(perm)) if list(perm) != list(range(len(term))) else op
        for i, letter in enumerate(order):
            if letter not in term:
                op = _InsertAxis(op, i, sizes[letter])
        aligned.append(op)
    prod = aligned[0]
    for op in aligned[1:]:
        prod = multiply(prod, op)
    contract = tuple(i for i, letter in enumerate(order) if letter not in out_spec)
    if contract:
        prod = sum_(prod, contract)
    kept = [letter for letter in order if letter in out_spec]
    perm = tuple(kept.index(letter) for letter in out_spec)
    if list(perm) != list(range(len(kept))):
        prod = transpose(prod, perm)
    return prod


def _unary(op):
    def f(a):
        return _Pointwise(op, _cast(asarray(a), float))
    f.__name__ = op
    return f


sin = _unary('sin')
cos = _unary('cos')
tan = _unary('tan')
arcsin = _unary('arcsin')
arccos = _unary('arccos')
arctan = _unary('arctan')
sinh = _unary('sinh')
cosh = _unary('cosh')
tanh = _unary('tanh')
arctanh = _unary('arctanh')
exp = _unary('exp')
ln = _unary('log')
log = ln
log2 = _unary('log2')
log10 = _unary('log10')
_abs_real = _unary('abs')


def abs_(a):
    a = asarray(a)
    if iscomplex(a):
        return sqrt(add(multiply(a.real, a.real), multiply(a.imag, a.imag)))
    return _abs_real(a)


_exp_real = exp


def exp(a):
    a = asarray(a)
    if iscomplex(a):
        m = _exp_real(a.real)
        return _Complex(multiply(m, cos(a.imag)), multiply(m, sin(a.imag)))
    return _exp_real(a)


sign = _unary('sign')


def inverse(a):
    return _Inverse(asarray(a))


def determinant(a):
    return _Determinant(asarray(a))


def eig_values(a):
    return _Eig(asarray(a), 'values')


def eigh(a):
    '''(values, vectors) of a symmetric matrix over the last two axes
    (reference: function.py:3670 via numpy.linalg.eigh).'''
    a = asarray(a)
    assert a.ndim >= 2 and a.shape[-1] == a.shape[-2], 'eigh requires square trailing axes'
    return _Eig(a, 'values'), _Eig(a, 'vectors')


def eig(a):
    '''(values, vectors) of a general square matrix over the last two axes,
    complex-valued (reference: function.py:3666 / evaluable.Eig,
    evaluable.py:3149).'''
    a = asarray(a)
    assert a.ndim >= 2 and a.shape[-1] == a.shape[-2], 'eig requires square trailing axes'
    assert a.dtype != complex, 'eig of a complex operand is not supported'
    w = _Complex(_EigGeneral(a, 'values', 'real'), _EigGeneral(a, 'values', 'imag'))
    v = _Complex(_EigGeneral(a, 'vectors', 'real'), _EigGeneral(a, 'vectors', 'imag'))
    return w, v


def opposite(a):
    return _Opposite(asarray(a))


def mean(a):
    return multiply(asarray(0.5), add(a, opposite(a)))


def jump(a):
    # sign convention: jump = opposite - self (reference: function.py:1619)
    return subtract(opposite(a), a)


class _Indicator(Array):
    '''1 on elements originating from the target part topologies, 0 elsewhere
    (reference: topology.py:760 indicator).'''

    def __init__(self, targets):
        self.targets = tuple(targets)
        spaces = frozenset().union(*(frozenset({t.space}) for t in targets))
        super().__init__((), float, spaces, {})

    def lower(self, args):
        E = args.points_shape[0]
        if args.part_topos is not None and args.part_ids is not None:
            target_ids = [i for i, t in enumerate(args.part_topos) if any(t is tt for tt in self.targets)]
            mask = numpy.isin(args.part_ids, target_ids).astype(float)  # [E]
        else:
            mask = numpy.zeros(E)
        expr = ev.constant(mask)
        for i, n in enumerate(args.points_shape[1:], start=1):
            expr = ev.insertaxis(expr, i, n)
        return expr


def vectorize(bases):
    '''Combine scalar bases into a block-diagonal vector basis of shape
    (sum(len(b_i)), len(bases)) (reference: function.vectorize).'''
    bases = [asarray(b) for b in bases]
    n = len(bases)
    parts = []
    for k, b in enumerate(bases):
        unit = numpy.zeros((1, n))
        unit[0, k] = 1.0
        parts.append(multiply(_InsertAxis(b, 1, 1), _Constant(unit)))
    out = concatenate(parts, axis=0)
    # composite dof-grid layout: when every component basis is structured,
    # a field over this array concatenates their grids (consumed by the
    # solver's block-grid device operators, see register_field_parts)
    meta = []
    for b in bases:
        grid = getattr(b, '_ndofs_per_dim', None)
        if grid is None:
            meta = None
            break
        topo = getattr(b, '_topo', None)
        per = tuple(i in getattr(topo, 'periodic', ()) for i in range(len(grid)))
        meta.append((int(b.shape[0]), tuple(grid), per))
    if meta:
        out._field_parts = meta
    return out


class _Opposite(Array):

    def __init__(self, arg):
        self.arg = arg
        super().__init__(arg.shape, arg.dtype, arg.spaces, arg.arguments)

    def lower(self, args):
        if args.opposite is not None:
            return self.arg.lower(args.opposite)
        return self.arg.lower(args)


# ---------------------------------------------------------------- evaluation

def eval(funcs, arguments=None, /, **kwargs):
    '''Evaluate space-free function array(s) with given argument values.
    Complex arrays evaluate per part and recombine to complex numpy.'''
    arguments = dict(arguments or {}, **kwargs)
    single = isinstance(funcs, Array)
    flist = [asarray(f) for f in ([funcs] if single else list(funcs))]
    parts = []
    for f in flist:
        if iscomplex(f):
            c = _as_complex(f)
            parts.append((c.real, c.imag))
        else:
            parts.append((f, None))
    exprs = [p.lower(EMPTY_LOWER_ARGS) for pair in parts for p in pair if p is not None]
    vals = list(ev.eval_once(exprs, arguments=_clean_args(arguments)))
    out = []
    for f, (re, im) in zip(flist, parts):
        if im is None:
            out.append(vals.pop(0))
        else:
            out.append(vals.pop(0) + 1j * vals.pop(0))
    return out[0] if single else out


def _clean_args(arguments):
    '''Normalize argument values: complex user values are packed into the real
    backing layout (trailing axis [re, im]); all evaluable Arguments are real.
    NaN markers propagate to both parts so constraint masks stay atomic.'''
    out = {}
    for k, v in arguments.items():
        if isinstance(v, str):
            continue
        v = numpy.asarray(v)
        if v.dtype.kind == 'c':
            im = numpy.where(numpy.isnan(v.real), numpy.nan, v.imag)
            v = numpy.stack([v.real, im], axis=-1)
        out[k] = v
    return out


def derivative(func, var):
    '''Derivative of ``func`` with respect to argument ``var`` (a name or an
    :class:`Argument`): a new Array of shape func.shape + var.shape
    (reference: function.py:2021).

    The canonical use — building a residual vector from an energy functional,
    ``residual = energy.derivative('u')`` — feeds :class:`nutils_tpu_torch.solver.
    System`, which recognizes the pattern and assembles it through the same
    localized-AD path as the energy formulation itself (sparse jacobians, no
    dense ndofs x ndofs intermediate).  Standalone evaluation lowers to a
    dense jacobian pass (evaluable.ArgJac: one torch.func.jacrev/jacfwd), suitable
    for small argument counts.'''
    func = asarray(func)
    if iscomplex(func):
        c = _as_complex(func)
        return _Complex(derivative(c.real, var), derivative(c.imag, var))
    if isinstance(var, str):
        name = var
        spec = func.arguments.get(name)
        if spec is None:
            raise ValueError(f'argument {name!r} does not appear in the function')
        argshape, argdtype = spec
    else:
        var = asarray(var)
        assert isinstance(var, Argument), 'var must be an argument name or Argument'
        name = var.name
        argshape, argdtype = var.shape, var.dtype
    if argdtype is complex:
        raise NotImplementedError('derivative with respect to a complex argument')
    return _Derivative(func, name, tuple(argshape))


class _Derivative(Array):
    '''Deferred full derivative with respect to a named argument.'''

    def __init__(self, func, name, argshape):
        self.func = func
        self.name = name
        self.argshape = tuple(int(n) for n in argshape)
        args = dict(func.arguments)
        args.setdefault(name, (self.argshape, float))
        super().__init__(func.shape + self.argshape, float, func.spaces, args)

    def lower(self, args):
        inner = ev.astype(self.func.lower(args), float)
        return ev.ArgJac(inner, self.name, self.argshape)


class Custom(Array):
    '''User-defined array operation with custom evaluation and derivatives
    (reference: function.py:665).

    Subclass and provide a static method ``evalf(*args)`` written in torch
    operations: it receives each constructor argument as a tensor with ONE
    leading axis of evaluation points prepended to the argument's declared
    shape, and must return a tensor of shape ``(npoints,) + shape``.
    Derivatives (grad, solver AD) flow through ``torch.func`` of ``evalf``;
    optionally provide a static method ``partial_derivative(iarg, *args)``
    returning d evalf / d args[iarg] of shape ``(npoints,) + shape +
    args[iarg].shape`` (torch operations too) to override them, through a
    ``torch.autograd.Function``.

    This is a deliberate deviation from ``nutils_tpu.function.Custom``,
    whose ``evalf`` is written in ``jax.numpy``: a subclass written for one
    package does not run in the other.

    >>> import torch
    >>> from nutils_tpu_torch import function
    >>> from nutils_tpu_torch.utils import config
    >>> class Sigmoid(function.Custom):
    ...     @staticmethod
    ...     def evalf(x):
    ...         return 1 / (1 + torch.exp(-x))
    >>> x = function.Argument('x', (3,))
    >>> s = Sigmoid(args=[x], shape=(3,))
    >>> import numpy
    >>> with config.device('cpu'):
    ...     bool(numpy.allclose(s.eval(x=numpy.zeros(3)), 0.5))
    True
    '''

    def __init__(self, args, shape, dtype=float):
        ops = tuple(asarray(a) for a in args)
        assert all(op.dtype != complex for op in ops), 'complex Custom arguments are not supported'
        self._custom_operands = ops
        super().__init__(tuple(shape), dtype, _merge_spaces(ops), _merge_args(ops))

    @staticmethod
    def evalf(*args):
        raise NotImplementedError('Custom subclasses must implement evalf')

    partial_derivative = None

    def lower(self, args):
        lowered = []
        nprefix = len(args.points_shape)
        for op in self._custom_operands:
            node = op.lower(args)
            assert node.ndim == nprefix + op.ndim
            lowered.append(node)
        cls = type(self)
        return ev.CustomNode(cls.evalf, lowered, self.shape, self.dtype, nprefix, cls.partial_derivative)


def factor(func):
    '''The reference expands residuals into precomputed sparse Taylor
    coefficients so time loops avoid re-assembly (reference: function.py:2630,
    evaluable.py:5785).  Here assembly plans are cached per System and
    constant tables live on the device, so factoring is the natural state of
    affairs: this is the identity.'''
    return asarray(func)


def arguments_for(*funcs):
    '''Dict of name -> Argument for all arguments of the given arrays
    (reference: function.arguments_for).'''
    out = {}
    for f in funcs:
        for name, spec in asarray(f).arguments.items():
            out.setdefault(name, _arg_from_spec(name, spec))
    return out


def replace_arguments(func, arguments):
    '''Substitute arguments: mapping name -> replacement Array, or the string
    shorthand 'old1:new1,old2:new2' renaming arguments (reference:
    function.py:1906).'''
    func = asarray(func)
    if isinstance(arguments, str):
        repl = {}
        for pair in arguments.split(','):
            old, new = pair.split(':')
            old = old.strip()
            spec = func.arguments.get(old)
            if spec is None:
                continue  # absent argument: rename is a no-op (reference semantics)
            repl[old] = _arg_from_spec(new.strip(), spec)
        arguments = repl
    if isinstance(arguments, (list, tuple)):
        # sequence of (old, new-name) pairs (reference: replace_arguments
        # accepts an items-like iterable, examples/turek.py:174)
        repl = {}
        for old, new in arguments:
            spec = func.arguments.get(old)
            if spec is None and isinstance(new, str):
                continue  # absent argument: rename is a no-op (reference semantics)
            repl[old] = _arg_from_spec(new, spec) if isinstance(new, str) else new
        arguments = repl
    repl = {}
    for k, v in arguments.items():
        if isinstance(v, str):
            # string value = rename (reference: function.py:1906 accepts
            # Mapping[str, Union[IntoArray, str]]); absent names are a no-op
            spec = func.arguments.get(k)
            if spec is None:
                continue
            v = _arg_from_spec(v, spec)
        v = asarray(v) if not isinstance(v, Array) else v
        if iscomplex(v):
            # complex replacement values substitute the real backing argument
            c = _as_complex(v)
            v = stack([c.real, c.imag], axis=c.ndim)
        repl[k] = v
    if iscomplex(func):
        c = _as_complex(func)
        return _Complex(replace_arguments(c.real, repl), replace_arguments(c.imag, repl))
    return _Replaced(func, repl)


class _Replaced(Array):
    '''Substitute arguments by other function arrays at lowering time.'''

    def __init__(self, arg, repl):
        self.arg = arg
        self.repl = repl
        args = {k: v for k, v in arg.arguments.items() if k not in repl}
        for r in repl.values():
            for name, spec in r.arguments.items():
                prev = args.setdefault(name, spec)
                assert prev == spec
        spaces = arg.spaces | _merge_spaces(tuple(repl.values()))
        super().__init__(arg.shape, arg.dtype, spaces, args)

    def lower(self, args):
        inner = self.arg.lower(args)
        mapping = {}
        for name, rep in self.repl.items():
            spec = self.arg.arguments.get(name)
            if spec is None:
                continue
            # complex-argument specs record the real backing shape (..., 2)
            argnode = ev.Argument(name, spec[0], float if spec[1] is complex else spec[1])
            mapping[argnode] = rep.lower(LowerArgs())  # replacement must be space-free
        return ev.replace(inner, mapping)


# --------------------------------------------------- quantity dispatch hook

_DISPATCHEES = ()


def _register_dispatchee(cls):
    '''Register a wrapper type (e.g. SI.Quantity) whose
    ``__nutils_dispatch__(func, args, kwargs)`` intercepts function-layer
    operations (the analogue of the reference's __nutils_dispatch__ protocol,
    function.py:96).'''
    global _DISPATCHEES
    _DISPATCHEES = _DISPATCHEES + (cls,)


def _find_dispatchee(args):
    for a in args:
        if isinstance(a, _DISPATCHEES):
            return type(a)
        if isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, _DISPATCHEES):
                    return type(b)
    return None


def _dispatchable(f):
    @functools.wraps(f)
    def wrapper(*args, **kwargs):
        cls = _find_dispatchee(args)
        if cls is not None:
            r = cls.__nutils_dispatch__(wrapper, args, kwargs)
            if r is not NotImplemented:
                return r
        return f(*args, **kwargs)
    wrapper.__wrapped__ = f
    return wrapper


for _n in ('asarray', 'add', 'subtract', 'multiply', 'divide', 'negative', 'power',
           'sqrt', 'sum_', 'matmul', 'transpose', 'getitem', 'grad', 'div', 'curl',
           'laplace', 'normal', 'jacobian', 'J', 'normalized', 'trace', 'opposite',
           'mean', 'jump', 'eval', 'derivative', 'factor', 'arguments_for',
           'replace_arguments', 'min_', 'max_', 'stack', 'concatenate', 'abs_',
           'insertaxis'):
    globals()[_n] = _dispatchable(globals()[_n])


# numpy ufunc/function dispatch tables
_UFUNC_MAP = {
    numpy.add: add, numpy.subtract: subtract, numpy.multiply: multiply,
    numpy.true_divide: divide, numpy.power: power, numpy.negative: negative,
    numpy.sin: sin, numpy.cos: cos, numpy.tan: tan, numpy.sinh: sinh,
    numpy.cosh: cosh, numpy.tanh: tanh, numpy.exp: exp, numpy.log: ln,
    numpy.sqrt: sqrt, numpy.absolute: abs_, numpy.sign: sign,
    numpy.arctan2: arctan2, numpy.minimum: min_, numpy.maximum: max_,
    numpy.matmul: matmul,
    numpy.arcsin: arcsin, numpy.arccos: arccos, numpy.arctan: arctan,
    numpy.arctanh: arctanh, numpy.real: real, numpy.imag: imag,
    numpy.conjugate: conjugate,
    numpy.less: less, numpy.greater: greater,
    numpy.less_equal: less_equal, numpy.greater_equal: greater_equal,
    numpy.equal: equal, numpy.not_equal: not_equal,
    numpy.logical_and: logical_and, numpy.logical_or: logical_or,
    numpy.logical_not: logical_not,
}

def norm(a, ord=None, axis=None):
    assert ord is None, 'only the 2-norm is supported'
    a = asarray(a)
    if axis is None:
        assert a.ndim == 1
        axis = 0
    return sqrt(sum_(a * a, axis))


_FUNC_MAP = {
    numpy.sum: sum_, numpy.transpose: transpose, numpy.stack: stack,
    numpy.concatenate: concatenate, numpy.einsum: einsum,
    numpy.linalg.inv: inverse, numpy.linalg.det: determinant,
    numpy.linalg.norm: norm, numpy.linalg.eig: eig, numpy.linalg.eigh: eigh,
    numpy.sqrt: sqrt, numpy.trace: trace,
    numpy.where: where, numpy.choose: choose, numpy.prod: prod,
    numpy.broadcast_arrays: broadcast_arrays, numpy.broadcast_to: broadcast_to,
}
