'''The element-chunked assembly of the PyTorch port (``System._chunk_plan``,
a chunk loop around the factored route's contractions or the generic
route) against its unchunked assembly and against nutils_tpu, in stencil,
block-grid and CSR form.  Chunked and unchunked assemblies give the same
bits; the JAX package's values agree to 1e-12 relative (float64).

At 64 and 81 elements the JAX package's chunk plan fails (its rewrite meets
tables of the element count that it binds as constants below 1,024 rows)
and it assembles unchunked, so there the port is held against that; at
1,024 elements and more the JAX package's own chunked scan runs, and the
port's chunk count is held against its ``_scan_plan``.'''

import contextlib
import functools

import numpy
import pytest
import torch

import _torch_parity as tp
from nutils_tpu.utils import config as config_jax
from nutils_tpu_torch.utils import config


def _build(pkg, case):
    '''(system, its trial arguments) of a case: ``laplace<n>``,
    ``th<n>`` (Taylor-Hood, the Stokes-like form of tests/test_solver.py
    ``test_chunked_assembly_lands_in_blockgrid_form``) or ``tri<n>``.'''
    kind, n = case.rstrip('0123456789'), int(case.lstrip('abcdefghijklmnopqrstuvwxyz_'))
    if kind == 'laplace':
        system = tp.build_laplace(pkg, n, reaction=True)
    elif kind == 'th':
        function, mesh, solver, _config = tp.modules(pkg)
        topo, geom = mesh.rectilinear([numpy.linspace(0, 1, n + 1)] * 2)
        ns = tp._taylor_hood_namespace(pkg, topo, geom)
        ns.nu = 0.1
        res = topo.integral('(v_i u_j ∇_j(u_i) + nu ∇_j(v_i) ∇_j(u_i) - p ∇_i(v_i) + q ∇_i(u_i) + 0.01 p q) dV'
                            @ ns, degree=6)
        system = solver.System(res, trial='u,p', test='v,q')
    else:
        system = tp.build_ns_tri(pkg, n)[0]
    rng = numpy.random.default_rng(3)
    return system, {t: 0.1 * rng.standard_normal(s) for t, s in zip(system.trials, system.trial_shapes)}


@functools.lru_cache
def _reference(case, chunk):
    '''The JAX package's (scan plan, CSR values, residual) of a case under
    ``assembly_chunk`` = ``chunk``, once a test run.'''
    system, args = _build('nutils_tpu', case)
    with config_jax.assembly_chunk(chunk):
        jac, res = system.assemble_jacobian_residual(args)
        return system._scan_plan(), numpy.asarray(jac.export('csr')[0]), numpy.asarray(res)


# (case, assembly_chunk, elements, chunk elements, chunks, form, route);
# the generic route (the factored route's reference) at the smaller sizes
CASES = [('laplace8', 16, 64, 16, 4, 'stencil', 'factored'), ('laplace8', 16, 64, 16, 4, 'stencil', 'generic'),
         ('laplace9', 16, 81, 9, 9, 'stencil', 'factored'), ('th8', 16, 64, 16, 4, 'blockgrid', 'factored'),
         ('th8', 16, 64, 16, 4, 'blockgrid', 'generic'), ('th9', 16, 81, 9, 9, 'blockgrid', 'factored'),
         ('tri6', 16, 72, 12, 6, 'csr', 'factored'), ('tri6', 16, 72, 12, 6, 'csr', 'generic'),
         ('tri7', 16, 98, 14, 7, 'csr', 'factored')]


@pytest.mark.parametrize('case,chunk,E,ce,nc,form,route', CASES)
def test_chunked_is_unchunked(case, chunk, E, ce, nc, form, route):
    with config.device('cpu'):
        system, args = _build('nutils_tpu_torch', case)
        assert set(system._assembly_routes.values()) == {'factored'}
        clean = system._clean(args)
        fn = system._compiled('jacres')
        with system._generic_route() if route == 'generic' else contextlib.nullcontext():
            with config.assembly_chunk(chunk):
                plan = system._chunk_plan()
                assert (plan['E'], plan['ce'], plan['nc']) == (E, ce, nc)
                chunked = fn(clean)  # the feature operators too are made a chunk at a time
                jac, res = system.assemble_jacobian_residual(args)
                alone = system._compiled('residual')(clean), system._compiled('jacobian')(clean)
            tp.forget_assembly(system)
            whole = fn(clean)
            assert system._chunk_plan() is None
    assert all(torch.equal(a, b) for a, b in zip(whole, chunked))
    assert torch.equal(alone[1], chunked[0])
    assert {'stencil': 'StencilMatrix', 'blockgrid': 'BlockGridMatrix', 'csr': 'Matrix'}[form] \
        == type(jac).__name__.lstrip('_')
    scan, data, r = _reference(case, chunk)
    assert scan is None  # the JAX package's plan fails here, and it does not chunk
    assert tp.rel(jac.export('csr')[0], data) <= 1e-12
    assert tp.rel(res, r) <= 1e-12


@pytest.mark.parametrize('case,chunk', [('laplace32', 256), ('th32', 256), ('tri23', 256)])
def test_chunks_of_the_jax_scan(case, chunk):
    # at 1,024 elements and more the JAX package assembles in a scan over
    # element chunks: the same chunks, and the same values to 1e-12
    scan, data, r = _reference(case, chunk)
    with config.device('cpu'), config.assembly_chunk(chunk):
        system, args = _build('nutils_tpu_torch', case)
        jac, res = system.assemble_jacobian_residual(args)
        plan = system._chunk_plan()
    assert (plan['E'], plan['ce'], plan['nc']) == (scan['E'], scan['ce'], scan['nc'])
    assert tp.rel(jac.export('csr')[0], data) <= 1e-12
    assert tp.rel(res, r) <= 1e-12


def test_small_batches_assemble_whole():
    # the Laplace example's boundary integrals (8 elements a side) stay
    # whole while its 64 volume elements are cut in four
    with config.device('cpu'):
        _domain, _ns, res, _sqr = tp.laplace_example_forms('nutils_tpu_torch', 8)
        system = tp.modules('nutils_tpu_torch')[2].System(res, trial='u', test='v')
        args = {'u': numpy.random.default_rng(4).standard_normal(system.trial_shapes[0])}
        clean = system._clean(args)
        whole = system._compiled('jacres')(clean)
        with config.assembly_chunk(16):
            plan = system._chunk_plan()
            chunked = system._compiled('jacres')(clean)
    assert plan['nc'] == 4 and len(plan['res']) == 1 and len(system._blocks[0]) == 2
    assert all(torch.equal(a, b) for a, b in zip(whole, chunked))


def test_awkward_element_count_raises():
    # 17^2 = 289 elements have no divisor between 1 and 17: chunks of one
    # element would be 289 rounds from the host, so the plan raises and
    # names the settings that work
    with config.device('cpu'):
        system, args = _build('nutils_tpu_torch', 'laplace17')
        with config.assembly_chunk(16), pytest.raises(ValueError, match='no divisor near assembly_chunk = 16'):
            system.assemble_jacobian_residual(args)
        with config.assembly_chunk(17):
            plan = system._chunk_plan()
            jac, res = system.assemble_jacobian_residual(args)
        tp.forget_assembly(system)
        whole = system.assemble_jacobian_residual(args)
    assert (plan['ce'], plan['nc']) == (17, 17)
    assert numpy.array_equal(jac.export('csr')[0], whole[0].export('csr')[0])
    assert numpy.array_equal(res, whole[1])
