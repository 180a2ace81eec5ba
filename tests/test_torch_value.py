'''The value assembly of the PyTorch port (``System.assemble_value``,
kernel K15's plain version) against nutils_tpu on the CPU.

Tolerances: 1e-12 relative against the JAX package (both sum the same
float64 integrand, in another order); the same bits between repeated
calls and between an element-chunked assembly whose chunk is a multiple of
K15's span and one piece (the partials of a block depend on its values
only); 1e-13 where the order of the sums differs (the generic route's
integrand, chunks off the span).'''

import contextlib
from unittest import mock

import numpy
import pytest
import torch

import _torch_parity as tp
from nutils_tpu_torch import evaluable as ev
from nutils_tpu_torch import solver
from nutils_tpu_torch.ops import assembly
from nutils_tpu_torch.utils import config

CASES = [('square', 'std', 1), ('mixed', 'std', 1), ('square', 'spline', 2)]


def _args(system, seed, scale=.1):
    rng = numpy.random.default_rng(seed)
    return {t: scale * rng.standard_normal(s) for t, s in zip(system.trials, system.trial_shapes)}


def _value_pair(forms, which, seed):
    '''(port's value, JAX package's value) of functional ``which`` of the
    finite-strain forms ``forms`` (a function of the package) at arguments
    made from ``seed``.'''
    sj = solver_jax().System(forms('nutils_tpu')[which], trial='u')
    args = _args(sj, seed)
    with config.device('cpu'):
        st = solver.System(forms('nutils_tpu_torch')[which], trial='u')
        return st.assemble_value(args), float(sj.assemble_value(args))


def solver_jax():
    return tp.modules('nutils_tpu')[2]


@pytest.mark.parametrize('nelems', (4, 8))
@pytest.mark.parametrize('etype,btype,degree', CASES)
def test_finitestrain_values(etype, btype, degree, nelems):
    # the linear energy and the finite-strain one, at the same arguments
    def forms(pkg):
        _domain, _ns, _sqr, energy, energy1 = tp.finitestrain_forms(pkg, nelems, etype, btype, degree)
        return {'linear': energy, 'finite': energy1}
    for seed, which in enumerate(('linear', 'finite')):
        got, want = _value_pair(forms, which, seed)
        assert abs(got - want) <= 1e-12 * abs(want), (which, got, want)


@pytest.mark.parametrize('reaction', (False, True))
def test_laplace_value(reaction):
    sj = tp.build_laplace('nutils_tpu', 8, reaction=reaction)
    args = _args(sj, 5, 1.)
    want = float(sj.assemble_value(args))
    with config.device('cpu'):
        st = tp.build_laplace('nutils_tpu_torch', 8, reaction=reaction)
        got = st.assemble_value(args)
    assert abs(got - want) <= 1e-12 * abs(want)


def _finite_system(nelems, etype='square', btype='std', degree=1):
    return solver.System(tp.finitestrain_forms('nutils_tpu_torch', nelems, etype, btype, degree)[4], trial='u')


@pytest.mark.parametrize('etype,btype,degree', CASES)
def test_repeated_calls_same_bits(etype, btype, degree):
    with config.device('cpu'):
        system = _finite_system(8, etype, btype, degree)
        args = _args(system, 7)
        values = [system.assemble_value(args) for _ in range(3)]
    assert values[0] == values[1] == values[2]


def test_chunked_is_one_piece():
    # 1,024 elements of 4 points: K15's span is 256 elements, so chunks of
    # 512 and 256 give one piece's partials, chunks of 16 another order
    with config.device('cpu'):
        system = _finite_system(32)
        args = _args(system, 11)
        whole = system.assemble_value(args)
        assert system._chunk_plan() is None
        for chunk in (512, 256):
            with config.assembly_chunk(chunk):
                assert system._chunk_plan()['ce'] == chunk
                assert system.assemble_value(args) == whole
        with config.assembly_chunk(16):
            part = system.assemble_value(args)
    assert abs(part - whole) <= 1e-13 * abs(whole)


def test_generic_route_value():
    # every term through its point integrand over the dof leaves
    with config.device('cpu'):
        system = _finite_system(8, 'mixed')
        args = _args(system, 13)
        factored = system.assemble_value(args)
        with system._generic_route():
            generic = system.assemble_value(args)
            parts = system._value_parts()
        assert [p[0] for p in system._value_parts()] == ['form'] * len(system._value_parts())
    assert [p[0] for p in parts] == ['term'] * len(parts) and all(p[2] is not None for p in parts)
    assert abs(generic - factored) <= 1e-13 * abs(factored)


def test_assemble_and_unsymmetric():
    with config.device('cpu'):
        system = _finite_system(4)
        args = _args(system, 17)
        jac, res, val = system.assemble(args)
        jac2, res2 = system.assemble_jacobian_residual(args)
        assert val == system.assemble_value(args)
        assert numpy.array_equal(res, res2) and numpy.array_equal(jac.export('dense'), jac2.export('dense'))
        _domain, ns, res_form, _sqr = tp.laplace_example_forms('nutils_tpu_torch', 4)
        unsym = solver.System(res_form, trial='u', test='v')
        with pytest.raises(solver.SolverError):
            unsym.assemble_value({'u': numpy.zeros(unsym.trial_shapes[0])})
        assert unsym.assemble({'u': numpy.zeros(unsym.trial_shapes[0])})[2] is None


def test_point_integrand_sums_to_the_functional():
    with config.device('cpu'):
        system = _finite_system(4, 'square', 'spline', 2)
        form = system._blocks[0][0].factored
        feats = [leaf for _sl, entries in form.layout.values() for leaf, _shape, _a in entries]
        lifted = ev.point_integrand(form._rest, feats, form.npt)
        assert lifted.shape == feats[0].shape[:2]
        args = system._device_args(system._clean(_args(system, 19)))
        leaves = system._bound_leaves(args, {}, system._tables())
        f = form.integrand(args, leaves)
        lv = {**leaves, **form._fixed_values(args, leaves)}
        for key in form.locs:
            for (leaf, shape, _a), v in zip(form.layout[key][1], form.comp[key].trace(args, leaves)):
                lv[leaf.key] = v.reshape(shape)
        scalar = float(form.rest.trace(args, lv))
    assert abs(float(f.sum()) - scalar) <= 1e-13 * abs(scalar)
    # no point integrand: a whole that depends on no source, a point axis
    # summed in two steps
    x = ev.Leaf(('x',), (3, 4))
    assert ev.point_integrand(ev.Sum(ev.Sum(x, (1,)), (0,)), [x], 2) is None
    assert ev.point_integrand(ev.add(ev.Sum(x, (0, 1)), ev.Constant(numpy.float64(1.))), [x], 2) is None
    assert ev.point_integrand(ev.Sum(x, (0, 1)), [x], 2) is x


@pytest.mark.parametrize('dtype', (torch.float32, torch.float64))
@pytest.mark.parametrize('E,P', [(518, 4), (1, 1), (300, 9), (1024, 6), (0, 4)])
def test_elem_value_plain(E, P, dtype):
    rng = numpy.random.default_rng(E + P)
    f = torch.as_tensor(rng.standard_normal((E, P)), dtype=dtype)
    parts = assembly.elem_value(f)
    span = assembly.value_span(P)
    assert parts.shape == (assembly.value_blocks(E, P),) and span * P <= assembly.VALUE_SPAN
    for b in range(len(parts)):  # each block's sum, in any order
        want = f[b * span:(b + 1) * span].double().sum()
        assert abs(float(parts[b]) - float(want)) <= (1e-5 if dtype == torch.float32 else 1e-13) * span * P
    total = assembly.elem_value_sum(parts, [0, len(parts)])
    assert abs(float(total) - float(f.double().sum())) <= (1e-4 if dtype == torch.float32 else 1e-12) * max(E, 1)
    # the lanes' order: the plain version's sums, value by value
    if E >= span:
        rows = f[:span].reshape(-1)
        lanes = [rows[t::assembly.VALUE_THREADS] for t in range(assembly.VALUE_THREADS)]
        acc = [torch.zeros((), dtype=dtype) for _ in lanes]
        for t, lane in enumerate(lanes):
            for v in lane:
                acc[t] = acc[t] + v
        h = assembly.VALUE_THREADS // 2
        while h:
            acc = [acc[t] + acc[t + h] for t in range(h)]
            h //= 2
        assert torch.equal(acc[0], parts[0])


def test_elem_value_chunks_and_segments():
    rng = numpy.random.default_rng(23)
    f = torch.as_tensor(rng.standard_normal((2048, 4)))
    whole = assembly.elem_value(f)
    buf = torch.empty_like(whole)
    n = len(whole) // 4
    for c in range(4):  # chunks of 512 elements, a multiple of the span
        assembly.elem_value(f[c * 512:(c + 1) * 512], out=buf[c * n:(c + 1) * n])
    assert torch.equal(buf, whole)
    g = torch.as_tensor(rng.standard_normal((33, 1)))
    both = torch.cat([whole, assembly.elem_value(g)])
    total = assembly.elem_value_sum(both, [0, len(whole), len(both)])
    want = assembly.elem_value_sum(whole, [0, len(whole)]) + assembly.elem_value_sum(both[len(whole):],
                                                                                       [0, len(both) - len(whole)])
    assert torch.equal(total, want)
    with pytest.raises(ValueError):
        assembly.elem_value_sum(both, [0, 3])
    with pytest.raises(ValueError):
        assembly.elem_value_sum(both, [0])
    # any number of segments: 41 here, one empty, their values added in
    # order
    parts = torch.as_tensor(rng.standard_normal(1000))
    offsets = [0, 0, *range(25, 1001, 25)]
    total = assembly.elem_value_sum(parts, offsets)
    want = None
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        v = assembly.elem_value_sum(parts[lo:hi], [0, hi - lo])
        want = v if want is None else want + v
    assert torch.equal(total, want)


def _many_terms(pkg, nterms):
    '''A functional of ``nterms`` integrals on 4 x 4 squares, each a
    nonlinear energy of its own weights: (System, its additive terms).'''
    function, mesh, solver_, _config = tp.modules(pkg)
    topo, geom = mesh.unitsquare(4, 'square')
    u = topo.field('u', btype='std', degree=1)
    J = function.J(geom)
    g = function.grad(u, geom)
    energy = None
    for k in range(nterms):
        term = topo.integral(((1 + k / 10) * (g @ g) / 2 + u ** (k % 3 + 2) / (k + 2) - u / (k + 1)) * J, degree=3)
        energy = term if energy is None else energy + term
    return solver_.System(energy, trial='u')


def test_value_of_many_terms():
    # 18 integrals: more parts than one struct of segment bounds would hold
    # where each term is a part of its own (the generic route); the value
    # against the JAX package's to 1e-12 on both routes
    sj = _many_terms('nutils_tpu', 18)
    args = _args(sj, 29, 1.)
    want = float(sj.assemble_value(args))
    with config.device('cpu'):
        st = _many_terms('nutils_tpu_torch', 18)
        got = st.assemble_value(args)
        with st._generic_route():
            generic = st.assemble_value(args)
            nparts = len(st._value_parts())
    assert nparts >= 18
    for value in (got, generic):
        assert abs(value - want) <= 1e-12 * abs(want), (value, want)


def _parent_route(system, args):
    """The value as the port took it before K15's fold: each part's
    partials in a buffer of its own (a chunked form's chunk by chunk into
    its rows), the buffers concatenated, then one elem_value_sum over the
    parts' segments: the reference of the folded route's bits."""
    plan = system._chunk_plan()
    tables = system._tables()
    if plan is not None and plan['consts']:
        tables = {**tables, **solver._device_tables(plan['consts'], plan)}
    dargs = system._device_args(system._clean(args))
    leaves = system._bound_leaves(dargs, {}, tables)
    bufs = []
    for part in system._value_parts():
        if part[0] == 'term':
            _kind, comp, lead = part
            f = comp.trace(dargs, leaves)
            bufs.append(assembly.elem_value(f.reshape((1, 1) if lead is None else (lead[0], int(numpy.prod(lead[1:]))))))
        elif plan is None or id(part[1]) not in plan['forms']:
            bufs.append(assembly.elem_value(part[1].integrand(dargs, leaves)))
        else:
            chunks = []
            for lo in range(0, plan['E'], plan['ce']):
                rows = slice(lo, lo + plan['ce'])
                chunks.append(assembly.elem_value(plan['forms'][id(part[1])].integrand(
                    dargs, solver._chunk_leaves(leaves, plan['keys'], rows), rows)))
            bufs.append(torch.cat(chunks))
    offsets = numpy.cumsum([0] + [len(b) for b in bufs]).tolist()
    return float(assembly.elem_value_sum(torch.cat(bufs), offsets))


class _EmptyTerm:
    """A term whose integrand has no elements (a part of P = 4 values a
    point over no element)."""

    def trace(self, args, leaves):
        return torch.zeros((0, 4), dtype=torch.float64)


@pytest.mark.parametrize('case', ['one part', 'eighteen parts', 'chunks', 'chunks and parts', 'empty last part'])
def test_folded_value_is_the_parent_route(case):
    # the value through one buffer and a finishing launch (the plain
    # versions here) has the bits of the route it replaced (a buffer a part,
    # their concatenation, elem_value_sum), and the JAX package's value to
    # 1e-12
    if case == 'eighteen parts' or case == 'chunks and parts':
        sj = _many_terms('nutils_tpu', 18)
        with config.device('cpu'):
            st = _many_terms('nutils_tpu_torch', 18)
    else:
        sj = solver_jax().System(tp.finitestrain_forms('nutils_tpu', 32, 'square', 'std', 1)[4], trial='u')
        with config.device('cpu'):
            st = _finite_system(32)
    args = _args(sj, 47, .1)
    want = float(sj.assemble_value(args))
    with config.device('cpu'), contextlib.ExitStack() as stack:
        if case in ('chunks', 'chunks and parts'):
            stack.enter_context(config.assembly_chunk(256 if case == 'chunks' else 8))
            assert st._chunk_plan()['nc'] > 1
        if case == 'eighteen parts':
            stack.enter_context(st._generic_route())
            assert len(st._value_parts()) == 18
        if case == 'empty last part':
            parts = st._value_parts() + [('term', _EmptyTerm(), (0, 4))]
            stack.enter_context(mock.patch.object(st, '_value_parts', lambda: parts))
        got = st.assemble_value(args)
        assert got == _parent_route(st, args)
    assert abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize('dtype', (torch.float32, torch.float64))
def test_elem_value_finish_plain(dtype):
    # the plain fold over parts of 1,024 x 4, 300 x 9, 1 x 1 and an empty
    # last part: each part's partials in its segment, the value the bits of
    # elem_value_sum over them; out defaults to the partials' last rows;
    # offsets that do not cut the partials raise
    rng = numpy.random.default_rng(53)
    fs = [torch.as_tensor(rng.standard_normal(shape), dtype=dtype) for shape in ((1024, 4), (300, 9), (1, 1), (0, 4))]
    sizes = [assembly.value_blocks(*f.shape) for f in fs]
    offsets = numpy.cumsum([0] + sizes).tolist()
    partials, total = torch.full((offsets[-1],), numpy.nan, dtype=dtype), torch.empty(1, dtype=dtype)
    for k, f in enumerate(fs[:-1]):
        assembly.elem_value(f, out=partials[offsets[k]:offsets[k + 1]])
    assert assembly.elem_value(fs[-1], finish=(partials, offsets, total)).shape == (0,)
    want = torch.cat([assembly.elem_value(f) for f in fs])
    assert torch.equal(partials, want) and torch.equal(total, assembly.elem_value_sum(want, offsets))
    last = assembly.elem_value(fs[0], finish=(want[:sizes[0]], [0, sizes[0]], total))
    assert torch.equal(last, want[:sizes[0]]) and torch.equal(total, assembly.elem_value_sum(want[:sizes[0]],
                                                                                           [0, sizes[0]]))
    with pytest.raises(ValueError):
        assembly.elem_value(fs[0], finish=(partials, [0, 3], total))
