'''The Taylor-Hood Navier-Stokes Newton step end to end through nutils_tpu
and the PyTorch port: block-grid assembly, the GMRES solve with the Schur
diagonal, the fused step, and the fieldsplit retry.  Assembled CSR values
and residuals agree to 1e-12 relative (the raw weight buffers differ in
layout: the JAX package permutes block axes for the TPU); solutions to the
solve contract as stated at each test.'''

import numpy
import pytest
import torch

import _torch_parity as tp
from nutils_tpu_torch import evaluable as ev
from nutils_tpu_torch.utils import config

_PLAN_RANK = {'slice': 0, 'grouped': 1, 'banded': 2, 'scatter': 3}


def _build(pkg, name):
    if name == 'ns6':
        return tp.build_ns(pkg, 6, numpy.float64)
    system = tp.build_th_periodic(pkg, 12)
    rng = numpy.random.default_rng(0)
    return system, {t: 0.1 * rng.standard_normal(s) for t, s in zip(system.trials, system.trial_shapes)}


@pytest.fixture(scope='module', params=['ns6', 'th_periodic12'])
def assembled(request):
    '''Per package: (system, args, jacobian, residual, jacres weights).'''
    out = {}
    with config.device('cpu'):
        for pkg in tp.PACKAGES:
            system, args = _build(pkg, request.param)
            jac, res = system.assemble_jacobian_residual(args)
            w, _r = system._compiled('jacres')(system._clean(args))
            out[pkg] = system, args, jac, numpy.asarray(res), numpy.asarray(w)
    return out


def test_blockgrid_plan_and_partition(assembled):
    sj, _a, jj, _r, _w = assembled['nutils_tpu']
    st, _a, jt, _r, wt = assembled['nutils_tpu_torch']
    pj, pt = sj._jac_layout[2], st._jac_layout[2]
    assert pj['form'] == pt['form'] == 'blockgrid'
    assert pt['field_offsets'] == pj['field_offsets'] and pt['field_grids'] == pj['field_grids']
    assert type(jt).__name__ == '_BlockGridMatrix' and jt._field_offsets == jj._field_offsets
    assert wt.shape == (pt['total'],) and sum(pt['sizes']) == sum(pj['sizes'])
    # the velocity block's weights keep the component axis minor
    assert pt['meta'][2][0][2] == pt['field_grids'][0][0]


def test_csr_values_and_residual(assembled):
    _s, _a, jj, rj, _w = assembled['nutils_tpu']
    st, _a, jt, rt, wt = assembled['nutils_tpu_torch']
    assert numpy.array_equal(jt.indptr, jj.indptr) and numpy.array_equal(jt.indices, jj.indices)
    # the port's weights read through its own csr_map give the JAX package's
    # CSR values
    assert tp.rel(wt[st._jac_layout[2]['csr_map']], numpy.asarray(jj.data)) <= 1e-12
    assert tp.rel(jt.data, numpy.asarray(jj.data)) <= 1e-12
    assert tp.rel(rt, rj) <= 1e-12


def test_value_plans_no_worse_than_jax(assembled):
    # every value segment accumulates through slices where the JAX package's
    # does: the natural axis order costs no scatter fallback
    kinds_j = [seg[0] for seg in assembled['nutils_tpu'][0]._jac_layout[2]['segs']]
    kinds_t = [seg[0] for seg in assembled['nutils_tpu_torch'][0]._jac_layout[2]['segs']]
    assert len(kinds_t) == len(kinds_j)
    assert all(_PLAN_RANK[t] <= _PLAN_RANK[j] for t, j in zip(kinds_t, kinds_j)), (kinds_t, kinds_j)


def test_gmres_solve_matches_jax(assembled):
    # both accept on the device at rtol 1e-3 after one refinement round; dx
    # agrees to 1e-8 (the same float64 iteration, sums in another order)
    _s, _a, jj, rj, _w = assembled['nutils_tpu']
    _s, _a, jt, rt, _w = assembled['nutils_tpu_torch']
    dxj = jj.solve_leniently(rj, solver='gmres', rtol=1e-3)
    with config.device('cpu'):
        dxt = jt.solve_leniently(rt, solver='gmres', rtol=1e-3)
    keys = ('method', 'op_form', 'precon', 'accepted_on_device')
    assert {k: jt._solve_stats[k] for k in keys} == {k: jj._solve_stats[k] for k in keys}
    assert jt._solve_stats['op_form'] == 'blockgrid' and jt._solve_stats['precon'] == 'diag'
    assert abs(jt._solve_stats['iters'] - jj._solve_stats['iters']) <= 1
    assert tp.rel(dxt, dxj) <= 1e-8
    assert numpy.linalg.norm(rt - jt @ dxt) <= 1e-3 * numpy.linalg.norm(rt)


def test_fused_step_matches_split(assembled):
    # the fused step is the split path's arithmetic: dx to 1e-12, the same
    # iteration count; it reads the CSR tables the split path uploaded
    system, args, jac, res, _w = assembled['nutils_tpu_torch']
    with config.device('cpu'):
        dx = jac.solve_leniently(res, solver='gmres', rtol=1e-3)
        tables = jac._csr_tables()[1:]
        dxf, resnorm, iters = system.fused_step_op(solver='gmres', rtol=1e-3)(system._clean(args))
    assert all(a is b for a, b in zip(jac._csr_tables()[1:], tables))
    assert isinstance(dxf, torch.Tensor) and dxf.dtype == torch.float64
    assert tp.rel(dxf.numpy(), dx) <= 1e-12
    assert iters == jac._solve_stats['iters']
    assert resnorm <= 1e-3 * numpy.linalg.norm(res)


def test_every_ns_node_has_a_torch_evaluation(assembled):
    system = assembled['nutils_tpu_torch'][0]
    types = {type(n) for n in ev.find(system._expr, lambda n: True)}
    # the vector fields and their gradients reach Take and Ravel (the
    # Namespace lowering of the component index), beyond the Laplace slice
    assert {ev.Grad, ev.Sum, ev.Leaf, ev.Multiply, ev.Take, ev.Ravel}.issubset(types)
    evaluator_nodes = (ev.Constant, ev.Zeros, ev.Range, ev.Argument, ev.Leaf, ev.Grad, ev.ArgGrad, ev.ArgJac,
                       ev.LeafGrad, ev.Sum)
    for cls in types:
        assert cls not in (ev.EigGeneral, ev.CustomNode), cls
        assert issubclass(cls, evaluator_nodes) or hasattr(cls, 'evalf'), cls


def test_fieldsplit_retry_on_stiff_stokes():
    # diffusion-dominant Stokes: with GMRES(50) and 50 iterations a
    # refinement round the diagonal scaling stops contracting before rtol
    # 1e-8, and the retry tier engages velocity multigrid + pressure Schur
    # scaling (the system of tests/test_device_op.py's fieldsplit test)
    with config.device('cpu'):
        jac = tp.build_stokes('nutils_tpu_torch', 12, numpy.float32, mass=0.01, nu=1.0)
        fs = jac._fieldsplit()
        assert fs is not None
        kinds = [k if isinstance(k, str) else k[0] for k in fs[0][2]]
        assert kinds == ['mg', 'diag']
        b = numpy.random.default_rng(0).standard_normal(jac.shape[0])
        x = jac.solve(b, solver='gmres', rtol=1e-8, maxiter=50, restart=50)
    assert jac._solve_stats['precon'] == 'fieldsplit' and jac._solve_stats['accepted_on_device']
    A64 = jac._scipy().astype(numpy.float64)
    assert numpy.linalg.norm(b - A64 @ x) / numpy.linalg.norm(b) < 1e-6
