'''Tensor-index expression language and Namespace (reference: expression_v2.py).

Implements the nutils v2 expression grammar: Einstein-summed products with
index notation (``a_ij b_j``), fractions, ``+``/``-`` with index alignment,
powers, compound/jump/mean brackets, numeral item selection (``x_0``), traces
(``b_iji``), and pointwise function calls with generated axes (``∇_i(u)``).
The parser is a fresh recursive-descent implementation over a simple
tokenizer; fragments carry (array, index-string) pairs and contraction happens
pairwise during product parsing.
'''

import re
import unicodedata

import numpy

from . import function


class ExpressionSyntaxError(Exception):
    pass


def _fail(s, msg, *regions):
    '''Raise in the reference's annotated format — the message, the
    expression, and a marker line with ``^`` under the primary region and
    ``~`` under secondary ones (reference: expression_v2.py:208
    ExpressionSyntaxError carets).  Each region is ((start, end), char).'''
    line = [' '] * (len(s) + 1)
    for (start, end), ch in regions:
        for k in range(max(start, 0), min(max(end, start + 1), len(line))):
            line[k] = ch
    raise ExpressionSyntaxError(msg + '\n' + s + '\n' + ''.join(line).rstrip())


def _ordinal(n):
    return ('first', 'second', 'third', 'fourth', 'fifth', 'sixth', 'seventh',
            'eighth', 'ninth', 'tenth')[n] if n < 10 else f'{n + 1}th'


_TOKEN = re.compile(r'''
      (?P<number>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?)
    | (?P<name>[^\W\d_0-9]\w*|[^\x00-\x7F][\w]*)
    | (?P<lpar>\()|(?P<rpar>\))
    | (?P<lbrk>\[)|(?P<rbrk>\])
    | (?P<lbrc>\{)|(?P<rbrc>\})
    | (?P<pow>\^)
    | (?P<slash>/)
    | (?P<plus>\+)
    | (?P<minus>-)
    | (?P<under>_)
''', re.VERBOSE | re.UNICODE)


def _isname_char(c):
    return c.isalpha() and not c.isdigit() or not c.isascii() and unicodedata.category(c).startswith(('L', 'S', 'M'))


class _Token:
    __slots__ = 'kind', 'text', 'spaced', 'start', 'end'

    def __init__(self, kind, text, spaced, start=0):
        self.kind = kind
        self.text = text
        self.spaced = spaced  # whitespace preceded this token
        self.start = start
        self.end = start + len(text)

    @property
    def span(self):
        return self.start, self.end

    def __repr__(self):
        return f'{self.kind}:{self.text}'


def _tokenize(s):
    tokens = []
    i = 0
    n = len(s)
    while i < n:
        spaced = False
        while i < n and s[i].isspace():
            spaced = True
            i += 1
        if i >= n:
            break
        c = s[i]
        if c.isdigit() or c == '.':
            m = re.match(r'(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?', s[i:])
            tokens.append(_Token('number', m.group(), spaced, i))
            i += m.end()
        elif c in '()[]{}^/+-_':
            kind = {'(': 'lpar', ')': 'rpar', '[': 'lbrk', ']': 'rbrk', '{': 'lbrc', '}': 'rbrc',
                    '^': 'pow', '/': 'slash', '+': 'plus', '-': 'minus', '_': 'under'}[c]
            tokens.append(_Token(kind, c, spaced, i))
            i += 1
        elif _isname_char(c):
            j = i + 1
            while j < n and (_isname_char(s[j]) or s[j].isdigit()):
                j += 1
            tokens.append(_Token('name', s[i:j], spaced, i))
            i = j
        else:
            _fail(s, f'Unexpected character {c!r}.', ((i, i + 1), '^'))
    return tokens


class _Frag:
    '''A parsed fragment: array plus one index character per axis.'''

    __slots__ = 'array', 'indices'

    def __init__(self, array, indices):
        self.array = function.asarray(array)
        assert self.array.ndim == len(indices), (self.array.shape, indices)
        self.indices = indices


def _align(frag, out_indices):
    '''Transpose/broadcast a fragment's array to the given index order.'''
    a, ai = frag.array, frag.indices
    assert all(i in out_indices for i in ai)
    perm = sorted(range(len(ai)), key=lambda k: out_indices.index(ai[k]))
    if perm != list(range(len(ai))):
        a = function.transpose(a, perm)
        ai = ''.join(ai[k] for k in perm)
    for pos, idx in enumerate(out_indices):
        if idx not in ai:
            length = 1  # resolved by broadcasting in multiply/add
            a = function.insertaxis(a, pos, 1)
            ai = ai[:pos] + idx + ai[pos:]
    return a


def _mul(a, b, s):
    '''Product of fragments with Einstein summation over shared indices.'''
    shared = [i for i in a.indices if i in b.indices]
    out = ''.join(dict.fromkeys(a.indices + b.indices))
    A = _align(a, out)
    B = _align(b, out)
    r = function.multiply(A, B)
    indices = out
    for i in shared:
        ax = indices.index(i)
        r = function.sum_(r, ax)
        indices = indices[:ax] + indices[ax + 1:]
    return _Frag(r, indices)


def _addsub(a, b, op):
    B = _align(b, a.indices)
    r = function.add(a.array, B) if op == '+' else function.subtract(a.array, B)
    return _Frag(r, a.indices)


class _Parser:

    def __init__(self, namespace, s):
        self.ns = namespace
        self.s = s
        self.toks = _tokenize(s)
        self.pos = 0
        self._last_end = 0
        # per-term index-occurrence scopes (the reference's occurs-more-than-
        # twice rule counts textual occurrences across a whole fraction;
        # parenthesized subexpressions open a fresh scope and contribute only
        # their free indices)
        self._occ = [{}]

    def _note(self, indices):
        c = self._occ[-1]
        for ch in indices:
            if ch.isalpha():
                c[ch] = c.get(ch, 0) + 1

    def _push_scope(self):
        self._occ.append({})

    def _pop_scope(self):
        self._occ.pop()

    def peek(self, k=0):
        return self.toks[self.pos + k] if self.pos + k < len(self.toks) else None

    def next(self):
        t = self.peek()
        if t is None:
            _fail(self.s, 'Unexpected end of expression.', ((len(self.s), len(self.s) + 1), '^'))
        self.pos += 1
        self._last_end = t.end
        return t

    def expect(self, kind):
        t = self.next()
        if t.kind != kind:
            sym = {'rpar': "')'", 'rbrk': "']'", 'rbrc': "'}'", 'number': 'a number'}.get(kind, kind)
            _fail(self.s, f'Expected {sym} but found {t.text!r}.', (t.span, '^'))
        return t

    def _start(self):
        t = self.peek()
        return t.start if t is not None else len(self.s)

    # expression := ['-'] term (('+'|'-') term)*
    def parse_expression(self):
        neg = False
        t = self.peek()
        first_start = self._start()
        if t is not None and t.kind == 'minus':
            self.next()
            neg = True
        frag = self.parse_term()
        first_span = (first_start, self._last_end)
        first = frag
        if neg:
            frag = _Frag(function.negative(frag.array), frag.indices)
        nterm = 1
        while True:
            t = self.peek()
            if t is None or t.kind not in ('plus', 'minus'):
                break
            op = self.next().text
            t_start = self._start()
            rhs = self.parse_term()
            rhs_span = (t_start, self._last_end)
            nterm += 1
            self._check_term_indices(first, first_span, rhs, rhs_span, nterm)
            frag = _addsub(frag, rhs, op)
        return frag

    def _check_term_indices(self, first, first_span, rhs, rhs_span, nterm):
        '''Index-set and index-length agreement of term ``nterm`` against the
        first term, with both terms marked (reference error surface:
        test_expression_v2.Parser.test_parse_expression).'''
        for i in first.indices:
            if i not in rhs.indices:
                _fail(self.s, f'Index {i} of the first term [^] is missing in the '
                      f'{_ordinal(nterm - 1)} term [~].', (first_span, '^'), (rhs_span, '~'))
        for i in rhs.indices:
            if i not in first.indices:
                _fail(self.s, f'Index {i} of the {_ordinal(nterm - 1)} term [~] is '
                      'missing in the first term [^].', (first_span, '^'), (rhs_span, '~'))
        for i in first.indices:
            la = first.array.shape[first.indices.index(i)]
            lb = rhs.array.shape[rhs.indices.index(i)]
            if la != lb:
                _fail(self.s, f'Index {i} has length {la} in the first term [^] but '
                      f'length {lb} in the {_ordinal(nterm - 1)} term [~].',
                      (first_span, '^'), (rhs_span, '~'))

    # term := factors ['/' factors]
    def parse_term(self):
        start = self._start()
        self._push_scope()
        try:
            frag = self.parse_factors(allow_leading_number=True)
            t = self.peek()
            if t is not None and t.kind == 'slash':
                self.next()
                den_start = self._start()
                den = self.parse_factors(allow_leading_number=True)
                den_span = (den_start, self._last_end)
                if den.indices:
                    _fail(self.s, 'The denominator must have dimension zero.', (den_span, '^'))
                t = self.peek()
                if t is not None and t.kind == 'slash':
                    # scan to the end of the repeated fraction for the marker
                    while self.peek() is not None and self.peek().kind not in ('plus', 'minus', 'rpar', 'rbrk', 'rbrc'):
                        self.next()
                    _fail(self.s, 'Repeated fractions are not allowed. Use parentheses '
                          'if necessary.', ((start, self._last_end), '^'))
                frag = _Frag(function.divide(frag.array, den.array), frag.indices)
            over = [ch for ch, cnt in self._occ[-1].items() if cnt > 2]
            if over:
                _fail(self.s, f'Index {sorted(over)[0]} occurs more than twice.',
                      ((start, self._last_end), '^'))
        finally:
            self._pop_scope()
        return frag

    def parse_factors(self, allow_leading_number):
        start = self._start()
        frag = self.parse_factor(allow_number=allow_leading_number)
        while True:
            t = self.peek()
            if t is None or t.kind in ('plus', 'minus', 'slash', 'rpar', 'rbrk', 'rbrc'):
                break
            if not t.spaced and t.kind not in ('name', 'number', 'lpar', 'lbrk', 'lbrc'):
                break
            shared_pre = {i: frag.array.shape[frag.indices.index(i)] for i in frag.indices}
            rhs = self.parse_factor(allow_number=False)
            span = (start, self._last_end)
            for i in rhs.indices:
                if i in shared_pre and shared_pre[i] != rhs.array.shape[rhs.indices.index(i)]:
                    _fail(self.s, f'Index {i} is assigned to axes with different '
                          f'lengths: {shared_pre[i]} and {rhs.array.shape[rhs.indices.index(i)]}.',
                          (span, '^'))
            frag = _mul(frag, rhs, self.s)
        return frag

    # factor := atom ['^' exponent]
    def parse_factor(self, allow_number):
        frag = self.parse_atom(allow_number)
        t = self.peek()
        if t is not None and t.kind == 'pow':
            self.next()
            exp = self.parse_exponent()
            frag = _Frag(function.power(frag.array, exp), frag.indices)
        return frag

    def parse_exponent(self):
        start = self._start()
        t = self.next()
        if t.kind == 'minus':
            t2 = self.expect('number')
            return -_number(t2.text)
        if t.kind == 'number':
            return _number(t.text)
        if t.kind == 'lpar':
            frag = self.parse_expression()
            self.expect('rpar')
            if frag.indices:
                _fail(self.s, 'The exponent must have dimension zero.',
                      ((start, self._last_end), '^'))
            return frag.array
        if t.kind == 'name':
            frag = self._resolve(t)
            if frag.indices:
                _fail(self.s, 'The exponent must have dimension zero.',
                      ((start, self._last_end), '^'))
            return frag.array
        _fail(self.s, f'Expected a number, variable or parenthesized expression '
              f'but found {t.text!r}.', (t.span, '^'))

    def parse_atom(self, allow_number):
        t = self.next()
        if t.kind == 'number':
            if not allow_number:
                _fail(self.s, 'Numbers are only allowed at the start of a term.', (t.span, '^'))
            return _Frag(function.asarray(_number(t.text)), '')
        if t.kind == 'lpar':
            frag = self.parse_expression()
            self.expect('rpar')
            self._note(frag.indices)
            return frag
        if t.kind == 'lbrk':
            frag = self.parse_expression()
            self.expect('rbrk')
            self._note(frag.indices)
            return _Frag(function.jump(frag.array), frag.indices)
        if t.kind == 'lbrc':
            frag = self.parse_expression()
            self.expect('rbrc')
            self._note(frag.indices)
            return _Frag(function.mean(frag.array), frag.indices)
        if t.kind == 'name':
            name = t.text
            indices = ''
            indices_span = (t.end, t.end)
            nt = self.peek()
            if nt is not None and nt.kind == 'under' and not nt.spaced:
                self.next()
                it = self.next()
                if it.kind not in ('name', 'number') or not it.text.isalnum():
                    _fail(self.s, 'Expected indices after the underscore.', (it.span, '^'))
                indices = it.text
                indices_span = it.span
                # a digit-leading subscript tokenizes as number + name
                # ('t3_0jk' -> '0', 'jk'): keep consuming adjacent runs
                while True:
                    ct2 = self.peek()
                    if ct2 is None or ct2.spaced or ct2.kind not in ('name', 'number') \
                            or not ct2.text.isalnum():
                        break
                    ct2 = self.next()
                    indices += ct2.text
                    indices_span = (indices_span[0], ct2.end)
            # function call: name or name_gen directly followed by '('
            ct = self.peek()
            if ct is not None and ct.kind == 'lpar' and not ct.spaced:
                value = getattr(self.ns, name, None)
                if value is None:
                    _fail(self.s, f'Unknown function {name!r}.', (t.span, '^'))
                if not callable(value):
                    _fail(self.s, f'{name!r} is not callable.', (t.span, '^'))
                self.next()
                arg = self.parse_expression()
                self.expect('rpar')
                out = function.asarray(value(arg.array))
                ngen = out.ndim - arg.array.ndim
                if len(indices) != ngen:
                    _fail(self.s, f'Expected {ngen} indices for the axes generated by '
                          f'{name!r} but got {len(indices)}.',
                          ((t.start, max(indices_span[1], t.end)), '^'))
                self._note(arg.indices)
                self._note(indices)
                frag = _Frag(out, arg.indices + indices)
                return _trace_repeated(frag, self.s, (t.start, self._last_end))
            return self._resolve(t, indices, indices_span)
        _fail(self.s, f'Unexpected {t.text!r}.', (t.span, '^'))

    def _resolve(self, name_tok, indices='', indices_span=None):
        name = name_tok.text
        value = getattr(self.ns, name, None)
        if value is None:
            _fail(self.s, f'Unknown variable {name!r}.', (name_tok.span, '^'))
        arr = function.asarray(value)
        self._note(indices)
        if len(indices) != arr.ndim:
            span = (name_tok.start, (indices_span or name_tok.span)[1])
            _fail(self.s, f'Expected {arr.ndim} indices for variable {name!r} '
                  f'but got {len(indices)}.', (span, '^'))
        # numeral indices select items
        out_indices = ''
        for pos, ch in enumerate(indices):
            if ch.isdigit():
                ax = len(out_indices)
                length = arr.shape[ax]
                if int(ch) >= length:
                    _fail(self.s, f'Index {ch} is out of range for axis of length '
                          f'{length}.', (((indices_span or name_tok.span)[0] + pos,
                                          (indices_span or name_tok.span)[0] + pos + 1), '^'))
                arr = function.getitem(arr, (slice(None),) * ax + (int(ch),))
            else:
                out_indices += ch
        return _trace_repeated(_Frag(arr, out_indices), self.s,
                               (name_tok.start, (indices_span or name_tok.span)[1]))


def _trace_repeated(frag, s, span=None):
    arr, indices = frag.array, frag.indices
    while True:
        dup = None
        for i, ch in enumerate(indices):
            j = indices.find(ch, i + 1)
            if j != -1:
                dup = (i, j, ch)
                break
        if dup is None:
            return _Frag(arr, indices)
        i, j, ch = dup
        if indices.count(ch) > 2:
            _fail(s, f'Index {ch} occurs more than twice.',
                  ((span or (0, len(s))), '^'))
        arr = function.trace(arr, i, j)
        indices = ''.join(c for k, c in enumerate(indices) if k not in (i, j))


def _number(text):
    return float(text) if ('.' in text or 'e' in text or 'E' in text) else float(int(text))


def parse(string, namespace):
    p = _Parser(namespace, string)
    frag = p.parse_expression()
    if p.peek() is not None:
        t = p.peek()
        _fail(string, f'Unexpected trailing {t.text!r}.', ((t.start, len(string)), '^'))
    return frag


def _grad(geom, spaces, arg):
    return function.grad(arg, geom)


def _curl(geom, spaces, arg):
    '''Two-generated-axes curl: curl_ki(u...) = ε_kji ∇_j(u...), used as
    curl_ki(u_i) (reference: expression_v2.py:542,714).'''
    arg = function.asarray(arg)
    g = function.grad(arg, geom)  # [..., j]
    g = function.insertaxis(g, g.ndim - 1, 3)   # [..., k, j]
    g = function.insertaxis(g, g.ndim, 3)       # [..., k, j, i]
    eps = function.levicivita(3)                # [k, j, i]
    return function.sum_(function.multiply(g, eps), g.ndim - 2)  # [..., k, i]


class Namespace:
    '''Namespace with expression-string assignment (reference:
    expression_v2.py:546).

    Attribute assignment parses tensor-index expression strings into
    :class:`nutils_tpu_torch.function.Array` objects; ``expr @ ns`` evaluates an
    expression in the namespace:

    >>> from nutils_tpu_torch import mesh
    >>> from nutils_tpu_torch.expression import Namespace
    >>> ns = Namespace()
    >>> topo, ns.x = mesh.rectilinear([2, 2])
    >>> ns.define_for('x', gradient='∇', jacobians=('dV', 'dS'))
    >>> ns.u = 'x_0^2 + sin(x_1)'
    >>> ns.v_i = '∇_i(u)'
    >>> ns.v.shape
    (2,)
    '''

    def __init__(self):
        self.opposite = function.opposite
        self.sin = function.sin
        self.cos = function.cos
        self.tan = function.tan
        self.sinh = function.sinh
        self.cosh = function.cosh
        self.tanh = function.tanh
        self.arcsin = function.arcsin
        self.arccos = function.arccos
        self.arctan = function.arctan
        self.arctanh = function.arctanh
        self.exp = function.exp
        self.abs = function.abs_
        self.ln = function.ln
        self.log = function.ln
        self.log2 = function.log2
        self.log10 = function.log10
        self.sqrt = function.sqrt
        self.sign = function.sign
        self.conj = function.conjugate
        self.real = function.real
        self.imag = function.imag

    def __setattr__(self, attr, value):
        name, underscore, indices = attr.partition('_')
        if isinstance(value, (int, float, complex, numpy.ndarray)):
            value = function.asarray(value)
        if isinstance(value, function._DISPATCHEES):
            # unit-carrying wrappers (SI.Quantity) are stored as-is; the
            # fragment operations dispatch through the function layer
            if underscore:
                raise AttributeError('cannot assign an array to an attribute with an underscore')
            object.__setattr__(self, name, value)
        elif isinstance(value, function.Array):
            if underscore:
                raise AttributeError('cannot assign an array to an attribute with an underscore')
            object.__setattr__(self, name, value)
        elif isinstance(value, str):
            frag = parse(value, self)
            if set(frag.indices) != set(indices) or len(set(indices)) != len(indices):
                raise AttributeError(
                    f'expression indices {frag.indices!r} do not match attribute indices {indices!r}')
            arr = _align(frag, indices) if frag.indices != indices else frag.array
            object.__setattr__(self, name, arr)
        elif callable(value):
            if underscore:
                raise AttributeError('cannot assign a function to an attribute with an underscore')
            object.__setattr__(self, name, value)
        else:
            raise AttributeError(f'cannot assign {type(value)} to namespace')

    def __rmatmul__(self, expression):
        if isinstance(expression, str):
            frag = parse(expression, self)
            out = ''.join(sorted(frag.indices))
            return _align(frag, out) if frag.indices != out else frag.array
        if isinstance(expression, (tuple, list)):
            return type(expression)(item @ self for item in expression)
        return NotImplemented

    def define_for(self, __name, *, gradient=None, curl=None, normal=None, jacobians=(), spaces=None):
        '''Define gradient/normal/jacobian helpers for a geometry
        (reference: expression_v2.py:668).'''
        import functools
        geom = getattr(self, __name)
        if gradient:
            setattr(self, gradient, functools.partial(_grad, geom, spaces))
        if curl:
            if geom.shape != (3,):
                raise ValueError('curl requires a 3-D geometry')
            setattr(self, curl, functools.partial(_curl, geom, spaces))
        if normal:
            setattr(self, normal, function.normal(geom))
        size = geom.shape[0] if geom.ndim else 1
        for i, jacobian in enumerate(jacobians):
            if i > size:
                raise ValueError(f'cannot define jacobian {jacobian!r}: dimension is negative')
            setattr(self, jacobian, function.jacobian(geom, size - i))

    def add_field(self, __names, *__bases, shape=(), dtype=float):
        for name in (__names,) if isinstance(__names, str) else __names:
            setattr(self, name, function.field(name, *__bases, shape=shape, dtype=dtype))

    def copy_(self, **replacements):
        ns = Namespace()
        for attr, value in vars(self).items():
            if replacements and isinstance(value, function.Array):
                value = function.replace_arguments(value, replacements)
            object.__setattr__(ns, attr, value)
        return ns
