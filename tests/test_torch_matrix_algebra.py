'''The constructors and the algebra of ``nutils_tpu_torch.matrix``
(``assemble_csr``, ``assemble_coo``, ``empty``, ``diag``, ``eye``,
``assemble_block_csr``; ``+``, ``-``, ``*``, ``/``, unary ``-``, ``T``)
against nutils_tpu on the CPU, bit for bit: the doctests, random CSR and COO
operands (duplicates, empty rows, rectangular blocks), and the port's
stencil-, block-grid- and CSR-form jacobians, whose CSR faces hold the JAX
package's pattern and whose algebra is the JAX package's scipy on the same
values.  A scalar product of values on the device keeps the host product's
bits.'''

import doctest
import inspect

import numpy
import pytest
import torch

import _torch_parity as tp
from nutils_tpu import matrix as mj
from nutils_tpu_torch import matrix as mt
from nutils_tpu_torch.utils import config


def _csr(m):
    data, indices, indptr = m.export('csr')
    return numpy.asarray(data), numpy.asarray(indices), numpy.asarray(indptr)


def _assert_same(got, want):
    '''The same shape, pattern and value bits (the dtype included).'''
    assert got.shape == want.shape
    (dg, ig, pg), (dw, iw, pw) = _csr(got), _csr(want)
    assert numpy.array_equal(pg, pw) and numpy.array_equal(ig, iw)
    assert dg.dtype == dw.dtype and dg.tobytes() == dw.tobytes()


def _coo(m, seed, shape, n=24):
    '''A COO matrix of ``n`` entries from ``seed`` in the rows of even index
    only (the odd rows empty), with duplicates.'''
    rng = numpy.random.default_rng(seed)
    rows = rng.choice(numpy.arange(0, shape[0], 2), n)
    cols = rng.integers(0, shape[1], n)
    return m.assemble_coo(rng.standard_normal(n), rows, cols, shape)


def _random_csr(m, seed, shape, density=.4):
    import scipy.sparse
    a = scipy.sparse.random(*shape, density=density, format='csr', random_state=seed)
    return m.assemble_csr(a.data, a.indices, a.indptr, shape)


CASES = {
    'assemble_coo': lambda m: _coo(m, 0, (7, 5)),
    'assemble_coo_square': lambda m: _coo(m, 1, (6, 6), n=60),
    'assemble_csr': lambda m: _random_csr(m, 2, (6, 4)),
    'empty': lambda m: m.empty((4, 3)),
    'diag': lambda m: m.diag(numpy.random.default_rng(3).standard_normal(5)),
    'eye': lambda m: m.eye(5),
    'add': lambda m: _coo(m, 0, (7, 5)) + _random_csr(m, 4, (7, 5)),
    'add_cancels': lambda m: _coo(m, 0, (7, 5)) + (-1.) * _coo(m, 0, (7, 5)),
    'sub': lambda m: _coo(m, 1, (6, 6), n=60) - m.eye(6),
    'sub_cancels': lambda m: m.eye(6) * 2 - (m.eye(6) + m.eye(6)),
    'mul': lambda m: _coo(m, 0, (7, 5)) * 0.3,
    'mul_int': lambda m: _coo(m, 0, (7, 5)) * 3,
    'mul_numpy': lambda m: _coo(m, 0, (7, 5)) * numpy.float64(0.3),
    'rmul': lambda m: 0.3 * _coo(m, 0, (7, 5)),
    'truediv': lambda m: _coo(m, 0, (7, 5)) / 3.,
    'neg': lambda m: -_coo(m, 0, (7, 5)),
    'transpose': lambda m: _coo(m, 0, (7, 5)).T,
    'transpose_empty_rows': lambda m: _random_csr(m, 5, (3, 8), density=.2).T,
    'block_csr': lambda m: m.assemble_block_csr([[_coo(m, 0, (7, 5)), _random_csr(m, 6, (7, 3))],
                                                 [_random_csr(m, 7, (2, 5)), m.empty((2, 3))]]),
    'block_csr_algebra': lambda m: m.assemble_block_csr([[m.eye(3), _coo(m, 8, (3, 4)).T.T],
                                                         [_coo(m, 8, (3, 4)).T, -m.diag(numpy.arange(4.))]]) * 2,
}


@pytest.mark.parametrize('case', CASES)
def test_against_nutils_tpu(case):
    want = CASES[case](mj)
    got = CASES[case](mt)
    assert type(got) is mt.Matrix and isinstance(got.data, numpy.ndarray)
    _assert_same(got, want)
    if case.endswith('cancels'):
        assert _csr(got)[0].size == 0  # scipy drops the entries that sum to zero


@pytest.mark.parametrize('name', ('assemble_csr', 'assemble_coo'))
def test_doctest(name):
    fn = getattr(mt, name)
    runner = doctest.DocTestRunner()
    for test in doctest.DocTestFinder().find(fn, name, globs={}):
        runner.run(test)
    assert runner.tries >= 3 and runner.failures == 0
    assert fn.__doc__.replace('nutils_tpu_torch', 'nutils_tpu').split('>>>', 1)[1] \
        == getattr(mj, name).__doc__.split('>>>', 1)[1]


FORMS = {'stencil': mt._StencilMatrix, 'blockgrid': mt._BlockGridMatrix, 'csr': mt.Matrix}

OPS = tp.MATRIX_OPS


@pytest.fixture(scope='module')
def jacobians():
    out = {}
    for form in FORMS:
        want, _res = tp.spd_jacobian('nutils_tpu', form)
        with config.device('cpu'):
            got, _res = tp.spd_jacobian('nutils_tpu_torch', form)
        out[form] = got, want
    return out


@pytest.mark.parametrize('op', OPS)
@pytest.mark.parametrize('form', FORMS)
def test_jacobian_algebra(jacobians, form, op):
    '''The port's algebra on its jacobian of each form is the JAX package's
    on the same CSR values, bit for bit, and 1e-13 from the JAX package's
    algebra on its own jacobian, with its pattern.'''
    got, want = jacobians[form]
    assert type(got) is FORMS[form]
    data, indices, indptr = _csr(got)
    wdata, windices, windptr = _csr(want)
    assert numpy.array_equal(indptr, windptr) and numpy.array_equal(indices, windices)
    assert numpy.abs(data - wdata).max() <= 1e-13 * numpy.abs(wdata).max()
    out = OPS[op](got)
    # the CSR jacobian's values lie on the device, and stay there under a
    # scalar product; the other forms' CSR faces are host values
    on_device = form == 'csr' and op in ('mul', 'rmul', 'truediv', 'neg')
    assert type(out) is mt.Matrix and isinstance(out.data, torch.Tensor if on_device else numpy.ndarray)
    _assert_same(out, OPS[op](mj.assemble_csr(data, indices, indptr, got.shape)))
    ref = OPS[op](want)
    (d, i, p), (rd, ri, rp) = _csr(out), _csr(ref)
    assert numpy.array_equal(p, rp) and numpy.array_equal(i, ri)
    assert numpy.abs(d - rd).max() <= 1e-13 * numpy.abs(rd).max()


def test_submatrix_algebra(jacobians):
    # a constrained jacobian (the lazy _SubMatrix view) materializes its
    # free rows and columns for the algebra, as the JAX package's does
    got, want = jacobians['stencil']
    free = numpy.arange(got.shape[0]) % 7 != 0
    sub = got.submatrix(free, free)
    assert type(sub) is mt._SubMatrix
    data, indices, indptr = _csr(got)
    ref = mj.assemble_csr(data, indices, indptr, got.shape).submatrix(free, free)
    _assert_same(sub + sub * 0.5, ref + ref * 0.5)
    _assert_same(sub.T, ref.T)


@pytest.mark.parametrize('dtype', (numpy.float32, numpy.float64))
@pytest.mark.parametrize('scale', (0.3, -1., 7, 1e-3))
def test_device_product_keeps_the_host_bits(dtype, scale):
    '''A scalar product of values that lie on the device stays there (one
    multiply an entry in their dtype) and has the host product's bits; the
    matrix keeps its pattern and field hints.'''
    a = _random_csr(mj, 9, (40, 40))
    values = a.data.astype(dtype)
    with config.device('cpu'):
        m = mt.Matrix.from_pattern(mt.SparsePattern(*numpy.nonzero(a._scipy().toarray()), (40, 40)),
                                   torch.as_tensor(values))
        m._field_grids = ((None, None),)
        out = m * scale
        neg = -m
    assert isinstance(out.data, torch.Tensor) and out._pattern is m._pattern and out._field_grids == m._field_grids
    assert out.data.numpy().tobytes() == (values * scale).tobytes()
    assert neg.data.numpy().tobytes() == (-values).tobytes()
    _assert_same(out, mj.Matrix(m.indptr, m.indices, values, m.shape) * scale)


def test_device_product_to_another_dtype():
    # a numpy float64 scale of float32 values gives float64 values in
    # numpy (and in the JAX package): the product is the host's
    a = _random_csr(mj, 10, (12, 12))
    values = a.data.astype(numpy.float32)
    m = mt.Matrix(a.indptr, a.indices, torch.as_tensor(values), a.shape)
    out = m * numpy.float64(0.3)
    assert isinstance(out.data, numpy.ndarray) and out.data.dtype == numpy.float64
    _assert_same(out, mj.Matrix(a.indptr, a.indices, values, a.shape) * numpy.float64(0.3))


def test_csr_jacobian_product_on_the_device(jacobians):
    got, _want = jacobians['csr']
    assert isinstance(got.data, torch.Tensor)
    out = got * 0.3
    assert isinstance(out.data, torch.Tensor) and out._pattern is got._pattern
    assert out.data.numpy().tobytes() == (got.data.numpy() * 0.3).tobytes()


NAMES = ('assemble_csr', 'assemble_coo', 'empty', 'diag', 'eye', 'assemble_block_csr', 'Matrix.__add__',
         'Matrix.__sub__', 'Matrix.__mul__', 'Matrix.__rmul__', 'Matrix.__truediv__', 'Matrix.__neg__')


@pytest.mark.parametrize('name', NAMES)
def test_signature_is_the_reference(name):
    def get(mod):
        obj = mod
        for part in name.split('.'):
            obj = getattr(obj, part)
        return obj
    assert inspect.signature(get(mt)) == inspect.signature(get(mj))


def test_transpose_is_a_property():
    assert isinstance(inspect.getattr_static(mt.Matrix, 'T'), property)
    assert isinstance(inspect.getattr_static(mj.Matrix, 'T'), property)


@pytest.mark.parametrize('form,want', [('stencil', 'stencil'), ('blockgrid', 'csr'), ('csr', 'csr')])
def test_sum_operator_form(jacobians, form, want):
    '''A sum (``Pseudotime``'s ``jac + djac / dt``) is a plain CSR matrix
    without field hints, as in the JAX package: its device operator is
    inferred from its values, a stencil where one field's pattern has one,
    the CSR operand (K9) for the block-grid and unstructured forms.'''
    with config.device('cpu'):
        got = jacobians[form][0]
        total = got + got * 0.5
        assert total._device_op()[0][0] == want
        x = numpy.random.default_rng(11).standard_normal(got.shape[0])
        assert tp.rel(total @ x, 1.5 * (got @ x)) <= 1e-14
