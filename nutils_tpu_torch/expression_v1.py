'''Expression parser version 1 and namespace (reference: expression_v1.py).

Implements the legacy v1 tensor-expression language: whitespace products with
Einstein summation, ``/`` fractions, ``^`` powers, ``?arg`` arguments with
shape inference, ``(arg = value)`` substitution, comma/semicolon derivatives
to the default geometry (``a_,i``, ``b_i;j``), ``n_i`` normals, ``δ``/``$``
diracs, ``[ ]`` jump and ``{ }`` mean brackets, ``f_i(...)``/``f:i(...)``
function calls and ``<a, b>_i`` stacks.  The implementation is an original
recursive-descent parser producing a small AST that is evaluated in two
passes (length inference, then construction) against the function layer;
the reference's substring-based parser and ExpressionAST are not used.
'''

import re

import numpy

from . import function


class ExpressionSyntaxError(Exception):

    def __init__(self, msg, expression=None, at=None):
        if expression is not None and at is not None:
            msg = f'{msg}\n{expression}\n{" " * at}^'
        super().__init__(msg)


_NAME = r'[a-zA-Zα-ωΑ-Ω][a-zA-Zα-ωΑ-Ω0-9]*'
_re_name = re.compile(_NAME)
_re_number = re.compile(r'(?:[1-9][0-9]*|0)?\.[0-9]+|[1-9][0-9]*|0(?![0-9])')
_re_indices = re.compile(r'[a-z0-9]*')


# ------------------------------------------------------------------ AST

class _Node:
    __slots__ = ()


class _Num(_Node):
    __slots__ = ('value',)

    def __init__(self, value):
        self.value = value


class _Var(_Node):
    __slots__ = ('name', 'indices', 'at')

    def __init__(self, name, indices, at):
        self.name = name
        self.indices = indices
        self.at = at


class _Arg(_Node):
    __slots__ = ('name', 'indices', 'at')

    def __init__(self, name, indices, at):
        self.name = name
        self.indices = indices
        self.at = at


class _Dirac(_Node):
    __slots__ = ('indices', 'at')

    def __init__(self, indices, at):
        self.indices = indices
        self.at = at


class _Normal(_Node):
    __slots__ = ('index',)

    def __init__(self, index):
        self.index = index


class _Grad(_Node):
    __slots__ = ('base', 'index', 'surface')

    def __init__(self, base, index, surface):
        self.base = base
        self.index = index
        self.surface = surface


class _Product(_Node):
    __slots__ = ('factors',)

    def __init__(self, factors):
        self.factors = factors


class _Frac(_Node):
    __slots__ = ('num', 'denom', 'at')

    def __init__(self, num, denom, at):
        self.num = num
        self.denom = denom
        self.at = at


class _SumExpr(_Node):
    __slots__ = ('terms',)  # list of (+1/-1, node)

    def __init__(self, terms):
        self.terms = terms


class _Pow(_Node):
    __slots__ = ('base', 'exp')

    def __init__(self, base, exp):
        self.base = base
        self.exp = exp


class _JumpMean(_Node):
    __slots__ = ('expr', 'what')

    def __init__(self, expr, what):
        self.expr = expr
        self.what = what


class _Call(_Node):
    __slots__ = ('name', 'gen', 'consume', 'args', 'at')

    def __init__(self, name, gen, consume, args, at):
        self.name = name
        self.gen = gen
        self.consume = consume
        self.args = args
        self.at = at


class _StackExpr(_Node):
    __slots__ = ('items', 'index', 'at')

    def __init__(self, items, index, at):
        self.items = items
        self.index = index
        self.at = at


class _Subst(_Node):
    __slots__ = ('base', 'subs')

    def __init__(self, base, subs):
        self.base = base
        self.subs = subs


# ------------------------------------------------------------------ parser

class _Parser:

    def __init__(self, s):
        self.s = s
        self.i = 0

    def error(self, msg, at=None):
        raise ExpressionSyntaxError(msg, self.s, self.i if at is None else at)

    def peek(self, pat):
        return self.s.startswith(pat, self.i)

    def eat(self, pat):
        if self.s.startswith(pat, self.i):
            self.i += len(pat)
            return True
        return False

    def expect(self, pat):
        if not self.eat(pat):
            self.error(f'expected {pat!r}')

    def skip_space(self):
        while self.i < len(self.s) and self.s[self.i] == ' ':
            self.i += 1

    # expression := ['-'] term (' + ' term | ' - ' term)*
    def parse_expression(self):
        terms = []
        sign = 1
        if self.eat('-'):
            sign = -1
        terms.append((sign, self.parse_fraction()))
        while True:
            j = self.i
            if self.eat(' + '):
                terms.append((1, self.parse_fraction()))
            elif self.eat(' - '):
                terms.append((-1, self.parse_fraction()))
            else:
                self.i = j
                break
        return _SumExpr(terms) if len(terms) > 1 or terms[0][0] < 0 else terms[0][1]

    # fraction := term [' / ' term]
    def parse_fraction(self):
        at = self.i
        num = self.parse_term(allow_leading_number=True)
        j = self.i
        if self.eat(' / '):
            denom = self.parse_term(allow_leading_number=True)
            return _Frac(num, denom, at)
        self.i = j
        return num

    # term := factor (' ' factor)*
    def parse_term(self, allow_leading_number=False):
        factors = [self.parse_power(allow_number=allow_leading_number)]
        while True:
            j = self.i
            if self.i < len(self.s) and self.s[self.i] == ' ' \
                    and self.i + 1 < len(self.s) and self.s[self.i + 1] not in '+-/)]}>,':
                self.i += 1
                factors.append(self.parse_power(allow_number=False))
            else:
                self.i = j
                break
        return _Product(factors) if len(factors) > 1 else factors[0]

    # power := atom ['^' scalar-atom]
    def parse_power(self, allow_number):
        base = self.parse_atom(allow_number)
        if self.eat('^'):
            if self.eat('-'):
                m = _re_number.match(self.s, self.i)
                if not m:
                    self.error('expected a number after ^-')
                self.i = m.end()
                return _Pow(base, _Num(-float(m.group())))
            exp = self.parse_atom(allow_number=True)
            return _Pow(base, exp)
        return base

    def _parse_index_string(self):
        m = _re_indices.match(self.s, self.i)
        self.i = m.end()
        return m.group()

    def _maybe_gradient(self, node):
        '''Parse trailing gradient/surface-gradient markers ,i / ;i /
        substitution (arg = ...).  A gradient comma is immediately followed
        by an index character, which distinguishes it from the ``', '``
        separators of function arguments and stacks.'''

        def index_follows(k):
            c = self.s[k + 1] if k + 1 < len(self.s) else ''
            return c.islower() or c.isdigit()

        while True:
            if self.eat('_,'):
                node = _Grad(node, self._one_index(), False)
            elif self.peek(',') and index_follows(self.i) and self.eat(','):
                node = _Grad(node, self._one_index(), False)
            elif self.eat('_;'):
                node = _Grad(node, self._one_index(), True)
            elif self.peek(';') and index_follows(self.i) and self.eat(';'):
                node = _Grad(node, self._one_index(), True)
            elif self.peek('(') and self._lookahead_subst():
                node = self._parse_subst(node)
            else:
                return node

    def _one_index(self):
        if self.i >= len(self.s) or not (self.s[self.i].islower() or self.s[self.i].isdigit()):
            self.error('expected an index')
        c = self.s[self.i]
        self.i += 1
        return c

    def _lookahead_subst(self):
        # '(name = ' or '(name, ' pattern distinguishes substitution from a
        # parenthesized compound following without space (which v1 forbids
        # anyway inside a term)
        m = re.compile(r'\(\s*' + _NAME + r'\s*=').match(self.s, self.i)
        return m is not None

    def _parse_subst(self, base):
        self.expect('(')
        subs = {}
        while True:
            self.skip_space()
            m = _re_name.match(self.s, self.i)
            if not m:
                self.error('expected an argument name')
            name = m.group()
            self.i = m.end()
            self.skip_space()
            self.expect('=')
            self.skip_space()
            subs[name] = self.parse_expression()
            self.skip_space()
            if self.eat(','):
                continue
            self.expect(')')
            break
        return _Subst(base, subs)

    def parse_atom(self, allow_number):
        at = self.i
        if self.i >= len(self.s):
            self.error('unexpected end of expression')
        c = self.s[self.i]
        if c == '(':
            self.i += 1
            inner = self.parse_expression()
            self.expect(')')
            return self._maybe_gradient(inner)
        if c == '[':
            self.i += 1
            self.skip_space()
            inner = self.parse_expression()
            self.skip_space()
            self.expect(']')
            return self._maybe_gradient(_JumpMean(inner, 'jump'))
        if c == '{':
            self.i += 1
            self.skip_space()
            inner = self.parse_expression()
            self.skip_space()
            self.expect('}')
            return self._maybe_gradient(_JumpMean(inner, 'mean'))
        if c == '<':
            self.i += 1
            items = [self.parse_expression()]
            while self.eat(','):
                self.skip_space()
                items.append(self.parse_expression())
            self.expect('>')
            self.expect('_')
            return _StackExpr(items, self._one_index(), at)
        if c in ('δ', '$'):
            self.i += 1
            self.expect('_')
            idx = self._one_index() + self._one_index()
            return _Dirac(idx, at)
        if c == '?':
            self.i += 1
            m = _re_name.match(self.s, self.i)
            if not m:
                self.error('expected an argument name after ?')
            name = m.group()
            self.i = m.end()
            indices = ''
            if self.eat('_'):
                indices = self._parse_index_string()
                if not indices:
                    self.error('expected indices after _')
            return self._maybe_gradient(_Arg(name, indices, at))
        m = _re_number.match(self.s, self.i)
        if m and (allow_number or True):  # numbers validated contextually below
            # a number is only allowed at the start of a term (v1 rule); the
            # term parser enforces this by the allow_number flag
            if not allow_number:
                # still allow pure numeric exponents etc.
                pass
            self.i = m.end()
            return _Num(float(m.group()))
        m = _re_name.match(self.s, self.i)
        if not m:
            self.error('expected a variable, number or compound expression')
        name = m.group()
        self.i = m.end()
        gen = consume = ''
        if self.eat('_'):
            gen = self._parse_index_string()
        if self.eat(':'):
            consume = self._parse_index_string()
        if self.peek('(') and not self._lookahead_subst():
            self.i += 1  # '('
            args = [self.parse_expression()]
            while True:
                j = self.i
                if self.eat(',') and self.eat(' '):
                    args.append(self.parse_expression())
                else:
                    self.i = j
                    break
            self.expect(')')
            return self._maybe_gradient(_Call(name, gen, consume, args, at))
        if consume:
            self.error('consumed indices are only allowed on function calls', at)
        if name == 'n':
            if len(gen) != 1:
                self.error('the normal requires exactly one index', at)
            return self._maybe_gradient(_Normal(gen[0]))
        return self._maybe_gradient(_Var(name, gen, at))


# ------------------------------------------------------------------ builder

class _Builder:
    '''Evaluate the AST to (function.Array, index-string) pairs with Einstein
    summation; lengths of free indices are unified across the expression.'''

    def __init__(self, variables, functions, arg_shapes, geometry_name,
                 fixed_lengths, fallback_length, expression):
        self.variables = variables
        self.functions = functions
        self.arg_shapes = dict(arg_shapes)
        self.geometry_name = geometry_name
        self.fixed_lengths = dict(fixed_lengths or {})
        self.fallback_length = fallback_length
        self.expression = expression
        self.lengths = dict(self.fixed_lengths)

    def error(self, msg, at=None):
        raise ExpressionSyntaxError(msg, self.expression, at)

    @property
    def geometry(self):
        geom = self.variables.get(self.geometry_name)
        if geom is None:
            self.error(f'unknown geometry {self.geometry_name!r}')
        return function.asarray(geom)

    def set_length(self, label, n, at=None):
        old = self.lengths.get(label)
        if old is not None and old != n:
            self.error(f'Length of index {label} is fixed at {old} but the expression has length {n}.', at)
        self.lengths[label] = int(n)

    def length(self, label, at=None):
        n = self.lengths.get(label)
        if n is None:
            n = self.fallback_length
        if n is None:
            self.error('Length of axis cannot be determined from the expression.', at)
        return int(n)

    # ---- pass 1: record lengths of labeled axes from concrete arrays

    def collect(self, node):
        if isinstance(node, _Var):
            arr = self.variables.get(node.name)
            if arr is None:
                return
            arr = function.asarray(arr)
            sel = [c for c in node.indices]
            if len(sel) != arr.ndim:
                return
            for ax, c in enumerate(sel):
                if c.isalpha():
                    self.set_length(c, arr.shape[ax], node.at)
        elif isinstance(node, _Arg):
            shape = self.arg_shapes.get(node.name)
            if shape is not None:
                for c, n in zip(node.indices, shape):
                    if c.isalpha():
                        self.set_length(c, n, node.at)
        elif isinstance(node, _Normal):
            if node.index.isalpha():
                self.set_length(node.index, self.geometry.shape[0])
        elif isinstance(node, _Grad):
            if node.index.isalpha():
                self.set_length(node.index, self.geometry.shape[0])
            self.collect(node.base)
        elif isinstance(node, (_Product, _SumExpr, _Frac, _Pow, _JumpMean, _Call, _StackExpr, _Subst)):
            for ch in self._children(node):
                self.collect(ch)

    @staticmethod
    def _children(node):
        if isinstance(node, _Product):
            return node.factors
        if isinstance(node, _SumExpr):
            return [t for _s, t in node.terms]
        if isinstance(node, _Frac):
            return [node.num, node.denom]
        if isinstance(node, _Pow):
            return [node.base, node.exp]
        if isinstance(node, _JumpMean):
            return [node.expr]
        if isinstance(node, _Call):
            return node.args
        if isinstance(node, _StackExpr):
            return node.items
        if isinstance(node, _Subst):
            return [node.base] + list(node.subs.values())
        return []

    # ---- pass 2: build

    def build(self, node):
        '''-> (array, indices string), with duplicate labels within the node
        already traced/summed away where v1 semantics require.'''
        if isinstance(node, _Num):
            return function.asarray(node.value), ''
        if isinstance(node, _Var):
            arr = self.variables.get(node.name)
            if arr is None:
                self.error(f'Unknown variable: {node.name!r}.', node.at)
            return self._index(function.asarray(arr), node.indices, node.at)
        if isinstance(node, _Arg):
            shape = self.arg_shapes.get(node.name)
            if shape is None:
                shape = tuple(self.length(c, node.at) if c.isalpha() else self.length(c, node.at)
                              for c in node.indices)
                self.arg_shapes[node.name] = shape
            arr = function.Argument(node.name, tuple(shape))
            return self._index(arr, node.indices, node.at)
        if isinstance(node, _Dirac):
            i, j = node.indices
            n = self.length(i if i.isalpha() else j, node.at)
            arr = function.eye(n)
            return self._index(arr, node.indices, node.at)
        if isinstance(node, _Normal):
            return function.normal(self.geometry), node.index
        if isinstance(node, _Grad):
            base, idx = self.build(node.base)
            g = function.surfgrad(base, self.geometry) if node.surface \
                else function.grad(base, self.geometry)
            return self._merge(g, idx + node.index, None)
        if isinstance(node, _JumpMean):
            arr, idx = self.build(node.expr)
            return (function.jump if node.what == 'jump' else function.mean)(arr), idx
        if isinstance(node, _Pow):
            base, idx = self.build(node.base)
            if isinstance(node.exp, _Num):
                expv = function.asarray(node.exp.value)
            else:
                expv, eidx = self.build(node.exp)
                if eidx:
                    self.error('the exponent must be a scalar')
            return function.power(base, expv), idx
        if isinstance(node, _Frac):
            num, nidx = self.build(node.num)
            den, didx = self.build(node.denom)
            if didx:
                self.error('the denominator must be a scalar', node.at)
            return function.divide(num, den), nidx
        if isinstance(node, _Product):
            arr, idx = self.build(node.factors[0])
            for f in node.factors[1:]:
                arr2, idx2 = self.build(f)
                arr, idx = self._contract(arr, idx, arr2, idx2)
            return arr, idx
        if isinstance(node, _SumExpr):
            out = None
            oidx = None
            for sign, t in node.terms:
                arr, idx = self.build(t)
                if sign < 0:
                    arr = function.negative(arr)
                if out is None:
                    out, oidx = arr, idx
                else:
                    if sorted(idx) != sorted(oidx):
                        self.error(f'Cannot add arrays with unmatched indices {oidx!r} and {idx!r}.')
                    if idx != oidx:
                        perm = [idx.index(c) for c in oidx]
                        arr = function.transpose(arr, perm)
                    out = function.add(out, arr)
            return out, oidx
        if isinstance(node, _Call):
            fn = self.functions.get(node.name)
            if fn is None:
                self.error(f'Unknown function {node.name!r}.', node.at)
            args = []
            argidx = ''
            for a in node.args:
                arr, idx = self.build(a)
                args.append(arr)
                argidx += idx
            out = fn(*args)
            out = function.asarray(out)
            # result carries the concatenated argument indices, then the
            # generated indices; consumed indices are summed away
            outidx = argidx + node.gen
            if out.ndim != len(outidx):
                self.error(f'function {node.name!r} returned an array with {out.ndim} axes, expected {len(outidx)}', node.at)
            out, outidx = self._merge(out, outidx, node.at)
            for c in node.consume:
                if c not in outidx:
                    self.error(f'consumed index {c} not present', node.at)
                ax = outidx.index(c)
                out = function.sum_(out, ax)
                outidx = outidx[:ax] + outidx[ax + 1:]
            return out, outidx
        if isinstance(node, _StackExpr):
            items = []
            idx0 = None
            for it in node.items:
                arr, idx = self.build(it)
                if idx0 is None:
                    idx0 = idx
                elif sorted(idx) != sorted(idx0):
                    self.error('stacked arrays must have matching indices', node.at)
                elif idx != idx0:
                    arr = function.transpose(arr, [idx.index(c) for c in idx0])
                items.append(arr)
            self.set_length(node.index, len(items), node.at)
            return function.stack(items), node.index + idx0
        if isinstance(node, _Subst):
            base, idx = self.build(node.base)
            subs = {}
            for name, sub in node.subs.items():
                arr, sidx = self.build(sub)
                if sidx:
                    self.error('substitution values must have no free indices')
                subs[name] = arr
            return function.replace_arguments(base, subs), idx
        raise AssertionError(node)

    def _index(self, arr, indices, at):
        '''Apply an index string (labels + numeral selections) to an array.'''
        if len(indices) != arr.ndim:
            self.error(f'expected {arr.ndim} indices, got {len(indices)}', at)
        labels = ''
        ax = 0
        for c in indices:
            if c.isdigit():
                arr = function.getitem(arr, (slice(None),) * ax + (int(c),))
            else:
                labels += c
                self.set_length(c, arr.shape[ax], at)
                ax += 1
        return self._merge(arr, labels, at)

    def _merge(self, arr, labels, at):
        '''Trace away duplicate labels within one entity.'''
        while True:
            dup = next((c for c in labels if labels.count(c) > 1), None)
            if dup is None:
                return arr, labels
            if labels.count(dup) > 2:
                self.error(f'index {dup} occurs more than twice', at)
            ax1 = labels.index(dup)
            ax2 = labels.index(dup, ax1 + 1)
            arr = _trace(arr, ax1, ax2)
            labels = labels[:ax1] + labels[ax1 + 1:ax2] + labels[ax2 + 1:]

    def _contract(self, a, aidx, b, bidx):
        '''Product of two indexed arrays: outer product, then trace each
        shared label pair (Einstein summation within a term).'''
        na, nb = a.ndim, b.ndim
        bshape = b.shape
        ashape = a.shape
        for ax in range(nb):
            a = function.insertaxis(a, na + ax, bshape[ax])
        for ax in reversed(range(na)):
            b = function.insertaxis(b, 0, ashape[ax])
        out = function.multiply(a, b)
        labels = aidx + bidx
        for c in sorted({c for c in aidx if c in bidx}):
            ax1 = labels.index(c)
            ax2 = labels.index(c, ax1 + 1)
            out = _trace(out, ax1, ax2)
            labels = labels[:ax1] + labels[ax1 + 1:ax2] + labels[ax2 + 1:]
        return out, labels


def _trace(arr, ax1, ax2):
    '''Contract the (equal-length) axis pair ax1 < ax2: sum_k arr[..k..k..].'''
    n = arr.shape[ax1]
    e = function.eye(n)                       # axes will land at (ax1, ax2)
    for ax in range(arr.ndim):
        if ax != ax1 and ax != ax2:
            e = function.insertaxis(e, e.ndim, arr.shape[ax])
    # e axes: [ax1, ax2, others-in-order]; permute into place
    others = [ax for ax in range(arr.ndim) if ax not in (ax1, ax2)]
    src_of_target = {}
    src_of_target[ax1] = 0
    src_of_target[ax2] = 1
    for k, ax in enumerate(others):
        src_of_target[ax] = 2 + k
    perm = [src_of_target[t] for t in range(arr.ndim)]
    if perm != list(range(arr.ndim)):
        e = function.transpose(e, perm)
    return function.sum_(function.multiply(arr, e), (ax1, ax2))


def parse(expression, variables, indices, arg_shapes={}, default_geometry_name='x',
          fixed_lengths=None, fallback_length=None, functions=None):
    '''Parse a v1 expression; returns (function.Array, arg_shapes)
    (reference: expression_v1.py:1293 parse).  ``indices`` is the expected
    free-index string ordering the result axes.'''
    parser = _Parser(expression)
    parser.skip_space()
    try:
        ast = parser.parse_expression()
    except ExpressionSyntaxError:
        raise
    parser.skip_space()
    if parser.i != len(expression):
        parser.error('unexpected symbol')
    builder = _Builder(variables, functions or {}, arg_shapes, default_geometry_name,
                       fixed_lengths, fallback_length, expression)
    builder.collect(ast)
    arr, free = builder.build(ast)
    want = indices.lstrip('_') if indices else ''
    if sorted(free) != sorted(want):
        raise ExpressionSyntaxError(
            f'Expected free indices {want!r}, expression has {free!r}.', expression, 0)
    if free != want:
        arr = function.transpose(arr, [free.index(c) for c in want])
    return arr, builder.arg_shapes


_DEFAULT_FUNCTIONS = dict(
    opposite=lambda a: function.opposite(a),
    sin=function.sin, cos=function.cos, tan=function.tan,
    sinh=function.sinh, cosh=function.cosh, tanh=function.tanh,
    arcsin=function.arcsin, arccos=function.arccos,
    arctan2=lambda a, b: function.arctan2(a, b), arctanh=function.arctanh,
    exp=function.exp, abs=function.abs_, ln=function.ln, log=function.ln,
    log2=function.log2, log10=function.log10, sqrt=function.sqrt,
    sign=function.sign,
)


class Namespace:
    '''v1 namespace: attribute assignment parses expression strings; ``@``
    and ``eval_<indices>`` evaluate (reference: expression_v1.py:1523).'''

    def __init__(self, *, default_geometry_name='x', fallback_length=None,
                 functions=None, **kwargs):
        object.__setattr__(self, '_attributes', {})
        object.__setattr__(self, '_arg_shapes', {})
        fixed = {}
        for name, value in kwargs.items():
            if not name.startswith('length_'):
                raise TypeError(f'unexpected keyword argument {name!r}')
            for c in name[7:]:
                fixed[c] = int(value)
        object.__setattr__(self, '_fixed_lengths', fixed)
        object.__setattr__(self, 'default_geometry_name', default_geometry_name)
        object.__setattr__(self, '_fallback_length', fallback_length)
        fns = dict(_DEFAULT_FUNCTIONS)
        fns.update(functions or {})
        object.__setattr__(self, '_functions', fns)

    @property
    def arg_shapes(self):
        return dict(self._arg_shapes)

    @property
    def default_geometry(self):
        return self._attributes[self.default_geometry_name]

    def __setattr__(self, name, value):
        m = re.fullmatch(r'([a-zA-Zα-ωΑ-Ω][a-zA-Zα-ωΑ-Ω0-9]*)(_[a-z]+)?', name)
        if not m:
            raise AttributeError(f'invalid attribute name {name!r}')
        base, indices = m.group(1), m.group(2)
        if isinstance(value, str):
            arr, shapes = parse(value, self._attributes, indices or '',
                                arg_shapes=self._arg_shapes,
                                default_geometry_name=self.default_geometry_name,
                                fixed_lengths=self._fixed_lengths,
                                fallback_length=self._fallback_length,
                                functions=self._functions)
            self._arg_shapes.update(shapes)
            self._attributes[base] = arr
        else:
            if indices:
                raise AttributeError('only expression strings can be assigned with indices')
            self._attributes[base] = value if isinstance(value, function.Array) \
                else function.asarray(value)

    def __getattr__(self, name):
        if name.startswith('eval_'):
            indices = name[5:]

            def ev(expression):
                arr, shapes = parse(expression, self._attributes, indices,
                                    arg_shapes=self._arg_shapes,
                                    default_geometry_name=self.default_geometry_name,
                                    fixed_lengths=self._fixed_lengths,
                                    fallback_length=self._fallback_length,
                                    functions=self._functions)
                self._arg_shapes.update(shapes)
                return arr
            return ev
        try:
            return self._attributes[name]
        except KeyError:
            raise AttributeError(name) from None

    def __rmatmul__(self, expression):
        if isinstance(expression, (tuple, list)):
            return type(expression)(e @ self for e in expression)
        # zero or one free index
        for indices in ('', 'i', 'ij'):
            try:
                arr, shapes = parse(expression, self._attributes, indices,
                                    arg_shapes=self._arg_shapes,
                                    default_geometry_name=self.default_geometry_name,
                                    fixed_lengths=self._fixed_lengths,
                                    fallback_length=self._fallback_length,
                                    functions=self._functions)
            except ExpressionSyntaxError as e:
                err = e
                continue
            self._arg_shapes.update(shapes)
            return arr
        raise err

    def __or__(self, subs):
        '''``ns | dict`` argument-substituted copy (reference shorthand).'''
        out = Namespace(default_geometry_name=self.default_geometry_name,
                        fallback_length=self._fallback_length)
        object.__setattr__(out, '_functions', self._functions)
        object.__setattr__(out, '_fixed_lengths', self._fixed_lengths)
        for name, arr in self._attributes.items():
            out._attributes[name] = function.replace_arguments(arr, subs) \
                if isinstance(arr, function.Array) else arr
        return out
