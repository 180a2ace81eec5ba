'''The launch plans of kernels K11 (``ops/assembly.matrix_plan``), K12
(``ops/assembly.vector_plan``) and K14 (``ops/sparse.mask_plan``): pure
functions of shapes, strides and addresses, checked here on the CPU by
walking their index maps as the CUDA kernels walk them
(``csrc/assembly.cu``, ``csrc/masked.cu``).'''

import numpy
import pytest

from nutils_tpu_torch.ops import assembly, sparse

# (Q, A, I, B, J, shared operators, Bt and Bs one tensor) of K11 on the
# paths: the Navier-Stokes step's blocks, the triangle step's, the Laplace
# slice's, the elasticity example's (P2 vector triangles) and the Laplace
# example's (tests/test_torch_kernels.py CONTRACTIONS, the same shapes)
SHAPES = {'ns_uu': (16, 6, 18, 6, 18, False, True), 'ns_up': (16, 6, 18, 1, 4, False, False),
          'ns_pu': (16, 1, 4, 6, 18, False, False), 'ns_pp': (16, 1, 4, 1, 4, False, True),
          'tri_uu': (12, 6, 12, 6, 12, True, True), 'tri_pu': (12, 1, 3, 6, 12, True, False),
          'laplace': (4, 3, 4, 3, 4, False, True), 'elasticity': (6, 6, 12, 6, 12, True, True),
          'example': (4, 2, 4, 2, 4, False, True)}
ITEMSIZES = [4, 8]


def operands(E, Q, A, I, B, J, shared, same, layout):
    '''Strides (in values) of Bt, K and Bs as the factored assembly hands
    them over: contiguous operators (element stride 0 where shared), K a
    permuted slice of the Hessian [B, E, Q, A + 1] ('route') or contiguous.'''
    st = (0 if shared else Q * A * I, A * I, I, 1)
    ss = st if same else (0 if shared else Q * B * J, B * J, J, 1)
    n = A + 1
    sk = (Q * n, n, 1, E * Q * n) if layout == 'route' else (Q * A * B, A * B, B, 1)
    return st, sk, ss


def walk_copy(c, ne, threads):
    '''(destination, source) offsets in values of every value a copy moves
    for a group of ``ne`` elements, thread by thread as the kernel's
    stage_copy advances its indices by carries.'''
    n = [c[f'n{d}'] for d in range(4)]
    if c['kd'] >= 0:
        n[c['kd']] = ne
    s = [c[f's{d}'] for d in range(4)]
    d = [c[f'd{k}'] for k in range(4)]
    total = n[0] * n[1] * n[2] * n[3]
    step = []
    r = threads
    for k in (3, 2, 1):
        step.insert(0, r % n[k])
        r //= n[k]
    step.insert(0, r)
    out = []
    for t in range(min(threads, total)):
        i, r = [0] * 4, t
        for k in (3, 2, 1):
            i[k], r = r % n[k], r // n[k]
        i[0] = r
        for _ in range(t, total, threads):
            dst = sum(a * b for a, b in zip(i, d))
            src = sum(a * b for a, b in zip(i, s))
            out.extend((dst + v, src + v) for v in range(c['vec']))
            carry = 0
            for k in (3, 2, 1):
                i[k] += step[k] + carry
                carry = int(i[k] >= n[k])
                i[k] -= n[k] if carry else 0
            i[0] += step[0] + carry
    return out


def want_copy(name, ne, Q, A, I, B, J, strides, plan):
    '''The (destination, source) pairs an operand's copy must move.'''
    st, sk, ss = strides
    if name == 'K':
        return {(k * plan['nK'] + (b * Q + q) * A + a, k * sk[0] + q * sk[1] + a * sk[2] + b * sk[3])
                for k in range(ne) for q in range(Q) for a in range(A) for b in range(B)}
    s, nl, L, n = (st, A, I, plan['nBt']) if name == 'Bt' else (ss, B, J, plan['nBs'])
    return {(k * n + (q * nl + a) * L + i, k * s[0] + q * s[1] + a * s[2] + i * s[3])
            for k in range(ne if s[0] else 1) for q in range(Q) for a in range(nl) for i in range(L)}


def cover(plan, E, Q, A, I, J):
    '''How many times each output V[e, i, j] and each T[e, q, a, j] is
    written, as the kernel's phases map tasks to tiles.'''
    V = numpy.zeros((E, I, J), int)
    T = numpy.zeros((E, Q, A, J), int)
    G = plan['G']
    for e0 in range(0, E, G):
        ne = min(G, E - e0)
        for phase, (M, N, tm, tn, lead) in (('T', (A, J, plan['ta'], plan['tjt'], Q)),
                                             ('V', (I, J, plan['ti'], plan['tj'], 1))):
            mt, nt = -(-M // tm), -(-N // tn)
            per = lead * mt * nt
            t = numpy.arange(G * per)
            k, rest = (t % G, t // G) if plan['kfast'] else (t // per, t % per)
            keep = k < ne
            k, rest = k[keep], rest[keep]
            jt, rest = rest % nt, rest // nt
            it, q = rest % mt, rest // mt
            for a in range(tm):
                for b in range(tn):
                    m, n = it * tm + a, jt * tn + b
                    ok = (m < M) & (n < N)
                    if phase == 'T':
                        numpy.add.at(T, (e0 + k[ok], q[ok], m[ok], n[ok]), 1)
                    else:
                        numpy.add.at(V, (e0 + k[ok], m[ok], n[ok]), 1)
    return V, T


def regions(plan, Q, A, I, B, J):
    '''[(start, stop)] in values of every shared-memory region the plan
    lays out: the operators staged once, each stage's slices, T and V.'''
    G, out = plan['G'], []
    if plan['shBt']:
        out.append((plan['oBt'], plan['oBt'] + Q * A * I))
    if plan['shBs'] and not plan['same']:
        out.append((plan['oBs'], plan['oBs'] + Q * B * J))
    for s in range(plan['stages']):
        base = plan['oStage'] + s * plan['stage']
        if not plan['shBt']:
            out.append((base + plan['oBt'], base + plan['oBt'] + G * plan['nBt']))
        if not plan['shBs'] and not plan['same']:
            out.append((base + plan['oBs'], base + plan['oBs'] + G * plan['nBs']))
        out.append((base + plan['oK'], base + plan['oK'] + G * plan['nK']))
    out.append((plan['oT'], plan['oT'] + G * plan['nT']))
    out.append((plan['oV'], plan['oV'] + G * plan['nV']))
    return out


# the plan's constants as the source sets them, and two settings the sweep
# (kernel_plan_sweep.py) tries: a budget of three blocks a multiprocessor,
# and three stages
SETTINGS = {'default': {}, 'three blocks': {'SMEM_BUDGET': 76800}, 'three stages': {'STAGES': 3}}


@pytest.fixture
def setting(request, monkeypatch):
    for name, value in SETTINGS[request.param].items():
        monkeypatch.setattr(assembly, name, value)
    assembly.matrix_plan.cache_clear()
    yield request.param
    assembly.matrix_plan.cache_clear()


@pytest.mark.parametrize('setting', list(SETTINGS), indirect=True)
@pytest.mark.parametrize('layout', ['route', 'contiguous'])
@pytest.mark.parametrize('itemsize', ITEMSIZES)
@pytest.mark.parametrize('case', list(SHAPES))
def test_matrix_plan(case, itemsize, layout, setting):
    # every shape gets a plan within 227 KB whose regions do not overlap,
    # whose tasks write every output of V (and of T) exactly once, for a
    # ragged last group too, and whose copies move every operand value
    # once from where it lies; an operator that is shared, or that is both
    # Bt and Bs, is staged once
    Q, A, I, B, J, shared, same = SHAPES[case]
    E0 = 1001
    plan = assembly.matrix_plan(E0, Q, A, B, I, J, itemsize, operands(E0, Q, A, I, B, J, shared, same, layout), same)
    E = 2 * plan['G'] + 1  # not a multiple of the group
    strides = operands(E, Q, A, I, B, J, shared, same, layout)
    plan = assembly.matrix_plan(E, Q, A, B, I, J, itemsize, strides, same)
    assert (E % plan['G'] or plan['G'] == 1) and plan['stages'] == assembly.STAGES
    assert plan['smem'] <= assembly.SMEM_BYTES and plan['threads'] <= assembly.MAX_THREADS
    assert plan['threads'] % 32 == 0 and plan['regime'] in ('element_lanes', 'tile_lanes')
    assert plan['smem'] == max(stop for _start, stop in regions(plan, Q, A, I, B, J)) * itemsize
    spans = sorted(regions(plan, Q, A, I, B, J))
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    if plan['kfast'] and not plan['align16']:  # odd strides: no bank conflicts
        assert all(plan[f'n{x}'] % 2 for x in ('K', 'T', 'V'))
    else:  # on 16 bytes
        assert all(plan[f'n{x}'] * itemsize % 16 == 0 for x in ('Bt', 'Bs', 'K', 'T', 'V'))
    V, T = cover(plan, E, Q, A, I, J)
    assert (V == 1).all() and (T == 1).all()
    assert plan['shBt'] == int(shared) and plan['shBs'] == int(shared)
    if same:
        assert plan['copies']['Bs']['n0'] == 0 and plan['oBs'] == plan['oBt']
    for name in ('Bt', 'Bs', 'K'):
        c = plan['copies'][name]
        if name == 'Bs' and same:
            continue
        ne = plan['G'] if name == 'K' or not shared else 1
        moved = walk_copy(c, ne, plan['threads'])
        assert len(moved) == len(set(moved)) == len(want_copy(name, ne, Q, A, I, B, J, strides, plan))
        assert set(moved) == want_copy(name, ne, Q, A, I, B, J, strides, plan)
        assert (c['kd'] == -1) == (name != 'K' and shared)


@pytest.mark.parametrize('itemsize', ITEMSIZES)
def test_matrix_plan_single_element_and_alignment(itemsize):
    # E = 1 takes one group of one element; a base off 16 bytes, or a run
    # that is not contiguous, copies one value at a time
    Q, A, I, B, J = 16, 6, 18, 6, 18
    strides = operands(1, Q, A, I, B, J, False, True, 'contiguous')
    plan = assembly.matrix_plan(1, Q, A, B, I, J, itemsize, strides, True)
    assert plan['G'] == 1 and (cover(plan, 1, Q, A, I, J)[0] == 1).all()
    assert plan['copies']['Bt']['vec'] == 16 // itemsize
    off = assembly.matrix_plan(1, Q, A, B, I, J, itemsize, strides, True, (False, True, True))
    assert off['copies']['Bt']['vec'] == 1
    assert set(walk_copy(off['copies']['Bt'], 1, off['threads'])) == want_copy('Bt', 1, Q, A, I, B, J, strides, off)
    route = operands(1001, Q, A, I, B, J, False, True, 'route')
    assert assembly.matrix_plan(1001, Q, A, B, I, J, itemsize, route, True)['copies']['K']['vec'] == 1


def test_matrix_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        assembly.matrix_plan(10, 64, 32, 32, 64, 64, 8, ((0, 1, 1, 1),) * 3)


# (Q, A, I, shared Bt, features a point of the gradient g slices, the
# slice's first feature, E) of K12 on the paths: the Navier-Stokes step's
# velocity and pressure residuals, the triangle step's, the Laplace
# slice's, one chunk of the Laplace example's, the elasticity example's
# and the finite-strain example's, at their element counts
VECTOR_SHAPES = {'ns_v': (16, 6, 18, False, 14, 7, 108900), 'ns_q': (16, 1, 4, False, 14, 13, 108900),
                 'tri_v': (12, 6, 12, True, 14, 7, 217800), 'tri_q': (12, 1, 3, True, 14, 13, 217800),
                 'laplace': (4, 3, 4, False, 3, 0, 1048576), 'example': (4, 2, 4, False, 4, 2, 2097152),
                 'elasticity': (6, 6, 12, True, 6, 0, 259200), 'finitestrain': (4, 4, 8, False, 4, 0, 518400)}
# K12's constants as the source sets them, and settings the sweep
# (kernel_plan_sweep.py --k12) tries
VECTOR_SETTINGS = {'default': {}, 'tiles of one element': {'VECTOR_TE': 1},
                   'three stages, two blocks': {'STAGES': 3, 'VECTOR_BUDGET': 115712},
                   'one block where Bt is shared': {'VECTOR_SHARED_BUDGET': 232448},
                   'g at odd strides': {'VECTOR_ALIGN_G': False}}


def vector_operands(E, Q, A, I, shared, At, a0, itemsize):
    '''Strides (in values) of Bt and of g as the factored assembly hands
    them over (g a slice of a gradient of At features a point), and whether
    each base lies on 16 bytes (Bt's does, g's where its first feature
    does).'''
    return ((0 if shared else Q * A * I, A * I, I, 1), (Q * At, At, 1)), (True, a0 * itemsize % 16 == 0)


def cover_vector(plan, E, I):
    '''How many times each output r[e, i] is written, as the kernel's
    phase maps tasks to register tiles of ``ti`` outputs and ``te``
    elements.'''
    r = numpy.zeros((E, I), int)
    G, ti, te = plan['G'], plan['ti'], plan['te']
    mt = -(-I // ti)
    for e0 in range(0, E, G):
        ne = min(G, E - e0)
        GB = G // te
        t = numpy.arange(GB * mt)
        if te > 1:
            kb, it = t % GB, t // GB
        elif plan['kfast']:
            kb, it = t % G, t // G
        else:
            kb, it = t // mt, t % mt
        keep = kb < ne
        kb, it = kb[keep], it[keep]
        for e in range(te):
            k = kb + e * GB
            for a in range(ti):
                m = it * ti + a
                ok = (k < ne) & (m < I)
                numpy.add.at(r, (e0 + k[ok], m[ok]), 1)
    return r


def vector_regions(plan, Q, A, I):
    '''[(start, stop)] in values of K12's shared-memory regions.'''
    G, QA, out = plan['G'], Q * A, []
    if plan['shBt']:
        out.append((plan['oBt'], plan['oBt'] + QA * I))
    for s in range(plan['stages']):
        base = plan['oStage'] + s * plan['stage']
        if not plan['shBt']:
            out.append((base + plan['oBt'], base + plan['oBt'] + G * plan['nBt']))
        out.append((base + plan['og'], base + plan['og'] + G * plan['ng']))
    out.append((plan['oR'], plan['oR'] + G * plan['nr']))
    return out


@pytest.fixture
def vector_setting(request, monkeypatch):
    for name, value in VECTOR_SETTINGS[request.param].items():
        monkeypatch.setattr(assembly, name, value)
    assembly.vector_plan.cache_clear()
    yield request.param
    assembly.vector_plan.cache_clear()


@pytest.mark.parametrize('vector_setting', list(VECTOR_SETTINGS), indirect=True)
@pytest.mark.parametrize('size', ['path', 'ragged'])
@pytest.mark.parametrize('itemsize', ITEMSIZES)
@pytest.mark.parametrize('case', list(VECTOR_SHAPES))
def test_vector_plan(case, itemsize, size, vector_setting):
    # every path's residual gets a plan within 227 KB whose regions do not
    # overlap, whose tasks write every output exactly once (for a ragged
    # last group too), and whose copies move every value of Bt (once a
    # block where it is shared) and of the strided slice g once from where
    # it lies, 16 bytes at a time where the runs allow
    Q, A, I, shared, At, a0, E = VECTOR_SHAPES[case]
    strides, aligned = vector_operands(E, Q, A, I, shared, At, a0, itemsize)
    plan = assembly.vector_plan(E, Q, A, I, itemsize, strides, aligned)
    if size == 'ragged':  # the plan of E = 2 G + 1: two groups and a ragged one
        E = 2 * plan['G'] + 1
        plan = assembly.vector_plan(E, Q, A, I, itemsize, strides, aligned)
        assert E % plan['G'] or plan['G'] == 1
    assert plan['regime'] in ('element_lanes', 'tile_lanes') and plan['stages'] == assembly.STAGES
    assert plan['smem'] <= assembly.SMEM_BYTES and plan['threads'] <= assembly.MAX_THREADS
    assert plan['threads'] % 32 == 0 and plan['threads'] >= assembly.VECTOR_THREADS
    assert plan['G'] % plan['te'] == 0 and plan['te'] in (1, assembly.VECTOR_TE)
    assert plan['te'] == 1 or (shared and plan['kfast'])
    spans = sorted(vector_regions(plan, Q, A, I))
    assert plan['smem'] == max(stop for _start, stop in spans) * itemsize
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    # a tile running past a row of Bt reads inside shared memory
    assert spans[0][0] + Q * A * I + plan['ti'] - 1 <= plan['smem'] // itemsize
    assert (cover_vector(plan, E, I) == 1).all()
    if not plan['kfast']:  # tile lanes: slices on 16 bytes
        assert all(plan[f'n{x}'] * itemsize % 16 == 0 for x in ('Bt', 'g', 'r'))
    if plan['kfast']:  # odd strides, or odd multiples of 16 bytes
        assert plan['nr'] % 2
        for name in ('Bt', 'g'):
            n = plan['nBt'] if name == 'Bt' else plan['ng']
            if plan['align16'][name]:
                assert n * itemsize % 32 == 16 and plan['copies'][name]['vec'] == 16 // itemsize
                assert name == 'Bt' or Q * A * itemsize % 16 == 0
            elif name == 'g' or not shared:
                assert n % 2
    for ne in {plan['G'], E % plan['G'] or plan['G']}:
        for name, sh in (('Bt', shared), ('g', False)):
            c = plan['copies'][name]
            k = 1 if sh else ne
            moved = walk_copy(c, k, plan['threads'])
            if name == 'Bt':
                st, n, L = strides[0], plan['nBt'], A * I
                want = {(e * n + (q * A + a) * I + i, e * st[0] + q * st[1] + a * st[2] + i)
                        for e in range(k) for q in range(Q) for a in range(A) for i in range(I)}
            else:
                sg, n = strides[1], plan['ng']
                want = {(e * n + q * A + a, e * sg[0] + q * sg[1] + a * sg[2])
                        for e in range(k) for q in range(Q) for a in range(A)}
            assert len(moved) == len(set(moved)) and set(moved) == want
            assert (c['kd'] == -1) == sh


@pytest.mark.parametrize('itemsize', ITEMSIZES)
def test_vector_plan_single_element_and_alignment(itemsize):
    # E = 1 takes one group of one element; a base off 16 bytes copies one
    # value at a time; g's runs of A values A_total apart go by single
    # values, a contiguous g by 16 bytes
    Q, A, I = 16, 6, 18
    strides, _aligned = vector_operands(1, Q, A, I, False, 14, 7, itemsize)
    plan = assembly.vector_plan(1, Q, A, I, itemsize, strides, (True, False))
    assert plan['G'] == 1 and (cover_vector(plan, 1, I) == 1).all()
    assert plan['copies']['Bt']['vec'] == 16 // itemsize and plan['copies']['g']['vec'] == 1
    off = assembly.vector_plan(1, Q, A, I, itemsize, strides, (False, False))
    assert off['copies']['Bt']['vec'] == 1
    moved = walk_copy(off['copies']['Bt'], 1, off['threads'])
    assert len(set(moved)) == Q * A * I
    contiguous = ((Q * A * I, A * I, I, 1), (Q * A, A, 1))
    assert assembly.vector_plan(1001, Q, A, I, itemsize, contiguous, (True, True))['copies']['g']['vec'] > 1


def test_vector_plan_refuses_what_does_not_fit():
    # one element of Q A I = 131,072 values: the generic kernel
    plan = assembly.vector_plan(10, 64, 32, 64, 8, ((0, 2048, 64, 1), (2048, 32, 1)))
    assert plan == {'regime': 'generic'}


@pytest.mark.parametrize('itemsize', ITEMSIZES)
@pytest.mark.parametrize('n', [0, 1, 2, 3, 5, 1003, 1039682])
@pytest.mark.parametrize('offset', range(4))
def test_mask_plan_covers_each_entry_once(offset, n, itemsize):
    # views at ``offset`` entries from a 16-byte boundary: a scalar head to
    # the boundary, 16-byte vectors, a scalar tail; operands at different
    # offsets take the scalar path throughout; each entry exactly once, and
    # the vectors start on 16 bytes
    for offsets in ((offset * itemsize % 16,) * 3, (0, offset * itemsize % 16, 8)):
        plan = sparse.mask_plan(n, itemsize, offsets)
        head, nvec, tail, vec = plan['head'], plan['nvec'], plan['tail'], plan['vec']
        assert vec * itemsize == 16 and head + nvec * vec + tail == n and min(head, nvec, tail) >= 0
        seen = numpy.zeros(n, int)
        seen[:head] += 1
        seen[head:head + nvec * vec] += 1
        seen[n - tail:] += 1 if tail else 0
        assert (seen == 1).all()
        if len(set(offsets)) == 1:
            assert tail < vec and (nvec == 0 or (offsets[0] + head * itemsize) % 16 == 0)
            assert head < vec or nvec == 0
        else:
            assert head == n
        threads = plan['grid'] * plan['threads']
        assert threads >= nvec and threads >= head + tail and plan['grid'] >= 1
