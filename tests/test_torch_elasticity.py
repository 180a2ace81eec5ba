'''``examples/elasticity.py`` through the PyTorch port against nutils_tpu, at
8 elements a side, its displacement solved by block-Jacobi CG over the
nodal 2 x 2 blocks (``Direct(solver='cg', precon='block',
preconargs={'blocksize': 2})``): the example's own test cases (square
elements at degree 1 and 2, mixed at degree 1, Poisson's ratio 0.25) and
triangles at degree 2 (0.3).  The JAX package solves as the example does
(a direct solve at this size; its block-Jacobi CG is held against the
port's in ``test_torch_precon.py``).  Tolerances: the assembled values to
1e-12 of their largest (the same sums in another order); u and t to 1e-8
relative (the port solves to rtol 1e-11; the condition numbers are below
1e3);
the clamping force F to 1e-10 of its exact value (0, 1), which testing the
weak form with a constant v gives: F = -∫ q dV.'''

import numpy
import pytest

import _torch_parity as tp
from nutils_tpu_torch.utils import config

CASES = [('square', 1, .25), ('mixed', 1, .25), ('square', 2, .25), ('triangle', 2, .3)]
BLOCK = dict(solver='cg', precon='block', preconargs={'blocksize': 2})


@pytest.fixture(scope='module', params=CASES, ids=lambda c: f'{c[0]}-p{c[1]}')
def example(request):
    '''(etype, degree, poisson, the port's results, the JAX package's).'''
    etype, degree, poisson = request.param
    with config.device('cpu'):
        got = tp.elasticity('nutils_tpu_torch', 8, etype, degree=degree, poisson=poisson, **BLOCK)
    want = tp.elasticity('nutils_tpu', 8, etype, degree=degree, poisson=poisson)
    return etype, degree, poisson, got, want


def test_assembled_values(example):
    etype, degree, poisson, (_c, _u, _t, _F, st), (_cj, _uj, _tj, _Fj, sj) = example
    args = {'u': numpy.zeros(st.trial_shapes[0])}
    with config.device('cpu'):
        jt, rt = st.assemble_jacobian_residual(args)
        jt = jt.export('dense')
    jj, rj = sj.assemble_jacobian_residual(args)
    jj = jj.export('dense')
    assert numpy.abs(jt - jj).max() <= 1e-12 * numpy.abs(jj).max()
    rj = numpy.asarray(rj)
    assert numpy.abs(numpy.asarray(rt) - rj).max() <= 1e-12 * numpy.abs(rj).max()


def test_solution(example):
    etype, degree, poisson, (ct, ut, tt, Ft, st), (cj, uj, tj, Fj, _sj) = example
    assert numpy.array_equal(numpy.isnan(ct), numpy.isnan(cj))
    assert numpy.array_equal(ct[~numpy.isnan(ct)], cj[~numpy.isnan(cj)])
    stats = st._cache['jacmat']._solve_stats
    assert stats['method'] == 'cg' and stats['precon'] == 'block' and stats['accepted_on_device']
    assert tp.rel(ut, uj) <= 1e-8
    assert tp.rel(tt, tj) <= 1e-8
    assert numpy.abs(Ft - [0., 1.]).max() <= 1e-10
    assert numpy.abs(Fj - [0., 1.]).max() <= 1e-10


def test_masked_operator(example):
    '''The block-Jacobi CG on the device's masked operator (``_isfree=``)
    of the example's whole jacobian: its free rows are the public
    constrained solve's displacement.'''
    etype, degree, poisson, (ct, ut, _t, _F, st), _want = example
    isfree = numpy.isnan(ct).ravel()
    with config.device('cpu'):
        jac, res = st.assemble_jacobian_residual({'u': numpy.zeros(st.trial_shapes[0])})
        dx = jac._solve_cg(numpy.where(isfree, res, 0.), atol=0., rtol=1e-11, precon='block',
                           preconargs={'blocksize': 2}, _isfree=isfree)
    stats = jac._solve_stats
    assert stats['op_form'] == 'masked' and stats['precon'] == 'block' and stats['accepted_on_device']
    assert tp.rel(-dx[isfree], ut.ravel()[isfree]) <= 1e-8
    assert not dx[~isfree].any()
