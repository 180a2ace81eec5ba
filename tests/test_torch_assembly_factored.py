'''The factored assembly of the PyTorch port (point-level features, the
element contractions K11/K12 through their plain versions on the CPU)
against nutils_tpu and against the port's generic vmap(jvp) route: CSR
values and residuals agree to 1e-12 relative in float64.'''

import contextlib

import numpy
import pytest
import torch

import _torch_parity as tp
from nutils_tpu_torch import evaluable as ev
from nutils_tpu_torch import solver
from nutils_tpu_torch.ops import assembly
from nutils_tpu_torch.utils import config


def _args(system, seed=0):
    rng = numpy.random.default_rng(seed)
    return {t: 0.1 * rng.standard_normal(s) for t, s in zip(system.trials, system.trial_shapes)}


def _build(pkg, case):
    '''(system, arguments) of a parity case.'''
    if case == 'laplace8':
        system = tp.build_laplace(pkg, 8, numpy.float64, reaction=True)
        return system, _args(system)
    if case.startswith('ns_tri'):
        return tp.build_ns_tri(pkg, int(case[6:]))
    if case.startswith('ns'):
        return tp.build_ns(pkg, int(case[2:]))
    system = tp.build_th_periodic(pkg, 12)
    return system, _args(system)


def _jacres(pkg, case):
    with config.device('cpu'):
        system, args = _build(pkg, case)
        jac, res = system.assemble_jacobian_residual(args)
    return system, numpy.asarray(jac.data), numpy.asarray(res)


@pytest.mark.parametrize('case', ['laplace8', 'ns10', 'ns12', 'ns_tri6', 'th_periodic12'])
def test_jacres_matches_jax(case):
    # ROADMAP parity rule: assembled values and residuals to 1e-12 relative
    _sj, data_j, res_j = _jacres('nutils_tpu', case)
    system, data_t, res_t = _jacres('nutils_tpu_torch', case)
    assert set(system._assembly_routes.values()) == {'factored'}
    assert data_t.shape == data_j.shape and res_t.shape == res_j.shape
    assert tp.rel(data_t, data_j) <= 1e-12
    assert tp.rel(res_t, res_j) <= 1e-12


def _cut_widths(system):
    '''{argument name: feature entries a point} of every localization.'''
    names = {loc.leaf.key: loc.name for ll in system._locs.values() for loc in ll}
    out = {}
    for chunks in system._blocks:
        for c in chunks:
            for key, cut in c.factored.cuts.items():
                widths = [int(numpy.prod(n.shape[2:], dtype=int)) for n in cut]
                assert out.setdefault(names[key], sum(widths)) == sum(widths)
    return out


@pytest.mark.parametrize('case,want', [
    ('laplace8', {'u': 3}),                         # u and grad u
    ('ns10', {'u': 6, 'v': 6, 'p': 1, 'q': 1}),     # u_i and grad_j u_i
    ('ns_tri6', {'u': 6, 'v': 6, 'p': 1, 'q': 1}),
])
def test_feature_cut_sizes(case, want):
    with config.device('cpu'):
        system, _args = _build('nutils_tpu_torch', case)
    assert _cut_widths(system) == want
    # each cut node is affine in its leaf and carries the element and point axes
    for chunks in system._blocks:
        for c in chunks:
            for key, cut in c.factored.cuts.items():
                leaf = c.factored.locs[key].leaf
                assert all(n.shape[:2] == leaf.shape[:2] and ev.poly_degree(n, [key]) == 1 for n in cut)
                assert {type(n).__name__ for n in cut} <= {'Sum', 'Grad'}


def _energy(pkg, kind):
    '''A scalar energy in u (and a coefficient field a): ``refused`` has the
    gradient of u**2, a feature of degree 2 in the dofs; ``coefficient``
    differentiates a * u, a feature that depends on another argument.'''
    function, mesh, solver, _config = tp.modules(pkg)
    topo, geom = mesh.rectilinear([5, 5])
    u = topo.field('u', btype='std', degree=1)
    a = topo.field('a', btype='std', degree=1)
    w = u ** 2 if kind == 'refused' else a * u
    energy = topo.integral((function.grad(w, geom) @ function.grad(w, geom) / 2 + u ** 2 / 2 - u)
                           * function.J(geom), degree=4)
    return solver.System(energy, trial='u')


@pytest.mark.parametrize('kind,route', [('refused', 'generic'), ('coefficient', 'factored')])
def test_other_forms(kind, route):
    rng = numpy.random.default_rng(3)
    args = [{'u': rng.standard_normal(36), 'a': 1 + rng.standard_normal(36)} for _ in range(2)]
    sj = _energy('nutils_tpu', kind)
    with config.device('cpu'):
        st = _energy('nutils_tpu_torch', kind)
        assert set(st._assembly_routes.values()) == {route}
        for arg in args:  # a second call with another coefficient: the operator is not kept
            jt, rt = st.assemble_jacobian_residual(arg)
            jj, rj = sj.assemble_jacobian_residual(arg)
            assert tp.rel(jt.data, numpy.asarray(jj.data)) <= 1e-12
            assert tp.rel(rt, numpy.asarray(rj)) <= 1e-12
    if route == 'factored':
        assert not st._operators


def _values(system, c, args, tables, overrides=None):
    '''The generic route's values of chunk ``c``: its functional's gradient
    in its test leaf, the leaves bound to ``overrides`` where given.'''
    return solver._leaf_grad(c.comp, c.key, args, system._bound_leaves(args, overrides or {}, tables))


def test_contractions_match_the_generic_route():
    # the plain versions of K11 and K12 on the factored operands give the
    # generic route's values chunk by chunk
    with config.device('cpu'):
        system, args = tp.build_ns('nutils_tpu_torch', 10)
        generic = tp.build_ns('nutils_tpu_torch', 10)[0]
        with generic._generic_route():
            clean = system._clean(args)
            dargs, tables = system._device_args(clean), system._tables()
            gargs, gtables = generic._device_args(clean), generic._tables()
            leaves = system._bound_leaves(dargs, {}, tables)
            meta = system._jac_layout[0]
            assert [m[:4] + m[5:] for m in meta] == [m[:4] + m[5:] for m in generic._jac_layout[0]]
            for bi, ci, u, li, reduce_axes, _size in meta:
                c, cg = system._blocks[bi][ci], generic._blocks[bi][ci]
                f = c.factored
                g, K = f.point_terms(dargs, leaves)
                Bt = f.operator(c.key, dargs, leaves)
                key = system._trial_locs[u][li].leaf.key
                Bs = f.operator(key, dargs, leaves)
                Ks = K[f.layout[key][0]][..., f.layout[c.key][0]].permute(1, 2, 3, 0)
                V = assembly.elem_matrix_plain(Bt, Ks, Bs)
                assert torch.equal(V, f.block(c.key, key, K, dargs, leaves))
                loc = generic._trial_locs[u][li]
                x0 = loc.leaf_value(gargs).contiguous()
                Vg = torch.func.vmap(lambda s: torch.func.jvp(
                    lambda x: _values(generic, cg, gargs, gtables, {loc.leaf.key: x}), (x0,), (s.contiguous(),))[1])(
                    loc.seeds())
                Vg = torch.movedim(Vg, 0, -1).sum(dim=reduce_axes)
                assert tp.rel(V.reshape(Vg.shape), Vg) <= 1e-12
                r = assembly.elem_vector_plain(Bt, g[..., f.layout[c.key][0]])
                assert torch.equal(r, f.residual(c.key, g, dargs, leaves))
                rg = _values(generic, cg, gargs, gtables).sum(dim=reduce_axes)
                assert tp.rel(r.reshape(rg.shape), rg) <= 1e-12


def test_shared_operators_broadcast():
    # an operator of element extent 1 (the triangle step's) is the same
    # operator for every element
    rng = numpy.random.default_rng(4)
    E, Q, A, B, I, J = 5, 3, 4, 2, 6, 7
    Bt1, Bs1 = (torch.as_tensor(rng.standard_normal(s)) for s in ((1, Q, A, I), (1, Q, B, J)))
    K, g = torch.as_tensor(rng.standard_normal((E, Q, A, B))), torch.as_tensor(rng.standard_normal((E, Q, A)))
    Bt, Bs = Bt1.expand(E, Q, A, I), Bs1.expand(E, Q, B, J)
    for got, want in ((assembly.elem_matrix(Bt1, K, Bs1), numpy.einsum('eqai,eqab,eqbj->eij', Bt, K, Bs)),
                      (assembly.elem_vector(Bt1, g), numpy.einsum('eqai,eqa->ei', Bt, g))):
        assert got.shape == want.shape
        assert numpy.abs(got.numpy() - want).max() <= 1e-14 * numpy.abs(want).max()


def test_operators_are_kept_once():
    # the velocity test and trial share one operator, the pressure's one
    # other; the triangle step's are the same for every element; the two
    # tests' chunks of the one functional share one point-level form
    for case, extent in (('ns10', 100), ('ns_tri6', 1)):
        with config.device('cpu'):
            system, args = _build('nutils_tpu_torch', case)
            system._compiled('jacres')(system._clean(args))
        ops = {id(B): B for _tag, B in system._operators.values()}
        assert len(system._operators) == 4 and len(ops) == 2
        # both tests' chunks share their functional: one point-level form
        assert len({id(c.factored) for chunks in system._blocks for c in chunks}) == 1
        assert {B.shape[0] for B in ops.values()} == {extent}


def test_float32_assembly():
    # the bench step assembles in float32: the factored route follows
    # config.floatx and stays within float32 rounding of the float64 values
    _s, data64, res64 = _jacres('nutils_tpu_torch', 'ns10')
    with config.device('cpu'):
        try:
            system, args = tp.build_ns('nutils_tpu_torch', 10, numpy.float32)
            jac, res = system.assemble_jacobian_residual(args)
            w, r = system._compiled('jacres')(system._clean(args))
        finally:
            config.floatx.value = numpy.float64
    assert w.dtype == torch.float32 and r.dtype == torch.float32
    assert set(system._assembly_routes.values()) == {'factored'}
    assert tp.rel(jac.data, data64) <= 1e-6 and tp.rel(res, res64) <= 1e-6


def test_zero_base_tangents_are_finite():
    # the form of test_torch_assembly.py's hazard test: u**4 at u = 0 keeps
    # its Power in the point-level AD, whose tangents stay finite
    from nutils_tpu_torch import function, mesh, solver
    with config.device('cpu'):
        topo, geom = mesh.rectilinear([6, 6])
        u = topo.field('u', btype='std', degree=1)
        energy = topo.integral((function.grad(u, geom) @ function.grad(u, geom) / 2 + u ** 4 / 4 - u)
                               * function.J(geom), degree=4)
        out = []
        for factored in (True, False):
            system = solver.System(energy, trial='u')
            assert system._assembly_routes == {('u', 0): 'factored'}
            with contextlib.nullcontext() if factored else system._generic_route():
                out.append(system._compiled('jacres')(system._clean({'u': numpy.zeros(49)})))
    (w, r), (wg, rg) = out
    assert numpy.isfinite(w.numpy()).all() and numpy.isfinite(r.numpy()).all()
    assert tp.rel(w.numpy(), wg.numpy()) <= 1e-12 and tp.rel(r.numpy(), rg.numpy()) <= 1e-12
