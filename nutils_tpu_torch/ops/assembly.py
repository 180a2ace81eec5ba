'''Element contractions of the factored assembly (kernels K11 and K12) and
the value of a functional (kernel K15).

A functional of the factored assembly (``solver._FactoredForm``) reaches its
localized dofs only through point-level features ``z`` (a field's value and
gradient at the quadrature points), affine in the dofs:
``Bt``/``Bs = dz/dc`` are the feature operators of the test and the trial
dofs, ``[E, Q, A, L]`` (element, point, feature, local dof), and ``g`` /
``K`` the gradient ``[E, Q, A]`` and Hessian ``[E, Q, A, B]`` of the
integrand in the features.  The element blocks are then

    V[e, i, j] = sum_q sum_a sum_b Bt[e, q, a, i] K[e, q, a, b] Bs[e, q, b, j]   (K11, elem_matrix)
    r[e, i]    = sum_q sum_a Bt[e, q, a, i] g[e, q, a]                          (K12, elem_vector)

the values ``nutils_tpu.solver.System._jacobian_trace`` (solver.py:1231) and
``_residual_trace`` (:950) compute as the jvp of the localized gradient over
the dofs' unit seeds, with the point axis summed (``reduce_axes``).  An
operator whose element extent is 1 is the same for every element (stride
0 in the kernels).

Each kernel has a plain version, one ``torch.einsum`` over the same
operands.  Tensors on the CPU take it; a CUDA tensor launches the kernel
(``csrc/assembly.cu``) or raises.  Both write into ``out`` where it is
given: an element chunk's rows of a batch's value buffer, which the kernel
fills in place.  K11 launches on a plan that :func:`matrix_plan`, a pure
function of the shapes, strides and alignment, chooses on the host.

K15 sums a functional's integrand at the points, ``f[E, P]`` (the
quadrature weights and jacobians folded in), to its value: the value
``System._value_trace`` (solver.py:985) computes as the compiled scalar.
:func:`elem_value` writes one partial sum a block of :func:`value_span`
elements, :func:`elem_value_sum` reduces segments of partials and adds the
segments' values in order, both in a fixed order of sums
(``csrc/value.cu``) that their plain versions take too, bit for bit.
'''

import ctypes
import functools

import torch

from .. import _kernels


def elem_matrix_plain(Bt, K, Bs, out=None):
    '''Plain torch version of :func:`elem_matrix`.'''
    V = torch.einsum('eqai,eqab,eqbj->eij', Bt, K, Bs)
    return V if out is None else out.copy_(V)


def elem_vector_plain(Bt, g, out=None):
    '''Plain torch version of :func:`elem_vector`.'''
    r = torch.einsum('eqai,eqa->ei', Bt, g)
    return r if out is None else out.copy_(r)


def _strides(t, E):
    '''Strides of a 4-d (or 3-d) operand in elements, the element stride 0
    where its element extent is 1.'''
    return ((0,) if t.shape[0] == 1 and E != 1 else (t.stride(0),)) + tuple(t.stride()[1:])


def _check(name, ref, **named):
    '''Raise unless every named (tensor, shape) pair is a CUDA tensor of
    ``ref``'s float dtype on its device with the given shape (a leading None:
    the element extent E or 1) and non-negative strides.'''
    if ref.device.type != 'cuda':
        raise ValueError(f'{name}: expected CUDA tensors, got a tensor on {ref.device}')
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'{name}: dtype {ref.dtype} is not float32 or float64')
    E = ref.shape[0]
    for key, (t, shape) in named.items():
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f'{name}: {key} is {t.dtype} on {t.device}, expected {ref.dtype} on {ref.device}')
        if t.ndim != len(shape) or t.shape[0] not in (1, E) or tuple(t.shape[1:]) != tuple(shape[1:]):
            raise ValueError(f'{name}: {key} has shape {tuple(t.shape)}, expected {tuple(shape)} with an '
                             'element extent of E or 1')
        if any(s < 0 for s in t.stride()):
            raise ValueError(f'{name}: {key} has a negative stride')
    if max(max(t.shape) for t, _shape in named.values()) >= 2**31 or max(ref.shape) >= 2**31:
        raise ValueError(f'{name}: an extent of 2^31 or more: the kernel takes 32-bit extents')


def _output(name, ref, shape, out):
    '''``out``, checked to be a contiguous CUDA tensor of ``ref``'s dtype
    on its device with ``shape``, or a new one.'''
    if out is None:
        return torch.empty(shape, dtype=ref.dtype, device=ref.device)
    if out.device != ref.device or out.dtype != ref.dtype or tuple(out.shape) != tuple(shape) \
            or not out.is_contiguous():
        raise ValueError(f'{name}: out is {out.dtype} {tuple(out.shape)} on {out.device} (contiguous: '
                         f'{out.is_contiguous()}), expected a contiguous {ref.dtype} {tuple(shape)} on {ref.device}')
    return out


# ------------------------------------------------------------ K11's plan

SMEM_BYTES = 232448  # the shared memory one block of an H100 may take (227 KB)
SMEM_SM = 233472  # a multiprocessor's, of which each resident block reserves 1 KB
SMEM_BUDGET = SMEM_SM // 2 - 1024  # K11's share: two blocks a multiprocessor
MAX_THREADS = 512  # K11's launch bound
STAGES = 2  # the ring's stages (a larger group measured better than a deeper ring)
TILE_ORDER = (3, 4, 2)  # register tile extents, preferred in this order where one divides the outputs
# the plan's scalars, in the order the kernel reads them (csrc/assembly.cu
# launch_matrix); the copies of Bt, Bs and K follow, COPY_FIELDS each
PLAN_FIELDS = ('G', 'threads', 'stages', 'kfast', 'ti', 'tj', 'ta', 'tjt', 'nBt', 'nBs', 'nK', 'nT', 'nV', 'oBt',
               'oBs', 'oK', 'oStage', 'stage', 'oT', 'oV', 'shBt', 'shBs', 'smem')
COPY_FIELDS = ('s0', 's1', 's2', 's3', 'se', 'n0', 'n1', 'n2', 'n3', 'd0', 'd1', 'd2', 'd3', 'kd', 'vec')


def _tile(n):
    '''A register tile's extent (1 to 4) along an axis of n outputs: the
    first of TILE_ORDER that divides n (3 x 3 tiles measured best on the
    18 x 18 and 12 x 12 blocks, kernel_plan_sweep.py), else the largest
    that wastes at most a quarter.'''
    for t in TILE_ORDER:
        if n % t == 0:
            return t
    return next(t for t in (4, 3, 2, 1) if n >= 0.75 * t * -(-n // t))


def _copy(dims, vec, aligned):
    '''One operand's copy of a group into shared memory: ``dims`` are
    (extent, source stride, destination stride, is the element dim), in
    values.  The dims go in order of source stride, largest first, so that
    neighbouring threads read neighbouring values; dims of extent 1 go,
    dims contiguous in both source and destination merge; the innermost
    copies ``vec`` values (16 bytes) at a time where it is contiguous on
    both sides, ``aligned`` (the source's base on 16 bytes) and every other
    stride a multiple of ``vec``, else one value.  Returns the COPY_FIELDS
    as a dict, padded to 4 dims outermost first.'''
    kept = sorted((d for d in dims if d[0] != 1 or d[3]), key=lambda d: -d[1])
    merged = []
    for d in kept:
        o = merged[-1] if merged else None
        if o and not o[3] and not d[3] and o[1] == d[0] * d[1] and o[2] == d[0] * d[2]:
            merged[-1] = (o[0] * d[0], d[1], d[2], False)
        else:
            merged.append(d)
    merged = [(1, 0, 0, False)] * (4 - len(merged)) + merged
    n, s, dst, el = (list(x) for x in zip(*merged))
    width = 1
    if vec > 1 and aligned and not el[3] and s[3] == 1 and dst[3] == 1 and n[3] % vec == 0 \
            and all(x % vec == 0 for x in s[:3] + dst[:3]):
        width, n[3], s[3], dst[3] = vec, n[3] // vec, vec, vec
    kd = el.index(True) if True in el else -1
    return dict(zip(COPY_FIELDS, (*s, s[kd] if kd >= 0 else 0, *n, *dst, kd, width)))


_NO_COPY = dict(zip(COPY_FIELDS, (0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0, -1, 1)))


@functools.lru_cache(maxsize=256)
def matrix_plan(E, Q, A, B, I, J, itemsize, strides, same=False, aligned=(True, True, True)):
    '''The launch plan of K11 for ``V[e,i,j] = sum_qab Bt[e,q,a,i]
    K[e,q,a,b] Bs[e,q,b,j]`` (a pure function; cached).  ``strides`` are
    those of Bt (e, q, a, i), K (e, q, a, b) and Bs (e, q, b, j) in values,
    an element stride of 0 for an operator every element shares; ``same``:
    Bt and Bs are one tensor; ``aligned``: the base of Bt, K and Bs on 16
    bytes.  Returns a dict:

    - ``regime``: ``'element_lanes'`` where an element has fewer than 32
      tiles of V and a group 32 elements or more (a warp's lanes take 32
      elements, whose slices lie at odd strides in shared memory: no bank
      conflicts; with ``align16``, at odd multiples of 16 bytes, for
      16-byte copies), else ``'tile_lanes'`` (a warp's lanes take one
      element's tiles; slices on 16 bytes for 16-byte copies, the
      elements of a warp 32 / (its elements) banks apart);
    - ``G`` elements a group (as many as the budget, :data:`SMEM_BUDGET`,
      holds, up to one V tile a thread for MAX_THREADS threads),
      ``threads`` a block, ``stages`` in the ring (:data:`STAGES`);
    - the register tiles of V (``ti`` x ``tj``) and of T (``ta`` x ``tjt``);
    - each region's element stride (``nBt`` ... ``nV``) and offset, in
      values, ``smem`` bytes (within :data:`SMEM_BYTES`);
    - ``shBt``/``shBs``: an operator staged once a block (shared, or Bs
      being Bt where Bt is);
    - ``copies``: the copy of each operand (:func:`_copy`); Bs has none
      where it is Bt.

    Raises ValueError where even one element does not fit in shared
    memory.'''
    st, sk, ss = strides
    vec = 16 // itemsize
    shBt = st[0] == 0
    shBs = shBt if same else ss[0] == 0
    ti, tj, ta, tjt = _tile(I), _tile(J), _tile(A), _tile(J)
    tasks_v = -(-I // ti) * -(-J // tj)
    tasks_t = Q * -(-A // ta) * -(-J // tjt)
    stages = STAGES

    def up(n):
        return -(-n // vec) * vec

    # tile_lanes: a warp's lanes take epw elements; their slices start
    # 32 / epw banks apart (at least 4: 16-byte copies stay aligned)
    epw = 1 << (max(1, 32 // tasks_v) - 1).bit_length()
    shift = max(4, 32 // epw) if epw > 1 else 0

    def strides_of(kfast, align16):
        def pad(n):
            if kfast and align16:
                return up(n) + vec * (up(n) // vec % 2 == 0)
            if kfast:
                return n | 1
            n = up(n)
            while shift and n * itemsize // 4 % 32 != shift:
                n += vec
            return n
        nBt = pad(Q * A * I)
        return nBt, nBt if same else pad(Q * B * J), pad(Q * B * A), pad(Q * A * J), pad(I * J)

    def layout(G, kfast, align16):
        nBt, nBs, nK, nT, nV = strides_of(kfast, align16)
        # the operators staged once a block, then the ring, then T and V
        oBt, end = 0, Q * A * I if shBt else 0
        oBs = 0
        if shBs and not same:
            oBs = up(end)
            end = oBs + Q * B * J
        oStage = up(end)
        s_Bt = 0
        s_Bs = (s_Bt if same else up(s_Bt + (0 if shBt else G * nBt))) if not shBs else 0
        s_K = up(max(s_Bt + (0 if shBt else G * nBt), s_Bs + (0 if shBs or same else G * nBs)))
        stage = up(s_K + G * nK)
        oT = oStage + stages * stage
        oV = up(oT + G * nT)
        return dict(nBt=nBt, nBs=nBs, nK=nK, nT=nT, nV=nV, oBt=oBt if shBt else s_Bt, oBs=oBs if shBs else s_Bs,
                    oK=s_K, oStage=oStage, stage=stage, oT=oT, oV=oV, smem=(oV + G * nV) * itemsize)

    def group(kfast, align16):
        nBt, nBs, nK, nT, nV = strides_of(kfast, align16)
        per = stages * ((0 if shBt else nBt) + (0 if shBs or same else nBs) + nK) + nT + nV
        G = max(1, min(E, MAX_THREADS // tasks_v, SMEM_BUDGET // itemsize // per))
        while G > 1 and layout(G, kfast, align16)['smem'] > SMEM_BUDGET:
            G -= 1
        return G

    def copies_of(G, lay):
        return {'Bt': _copy([(G, st[0], lay['nBt'], True)] * (not shBt)
                            + [(Q, st[1], A * I, False), (A, st[2], I, False), (I, st[3], 1, False)], vec, aligned[0]),
                'K': _copy([(G, sk[0], lay['nK'], True), (Q, sk[1], A, False), (A, sk[2], 1, False),
                            (B, sk[3], Q * A, False)], vec, aligned[1]),
                'Bs': _NO_COPY if same else _copy(
                    [(G, ss[0], lay['nBs'], True)] * (not shBs)
                    + [(Q, ss[1], B * J, False), (B, ss[2], J, False), (J, ss[3], 1, False)], vec, aligned[2])}
    kfast = tasks_v < 32 and group(True, False) >= 32
    # element lanes: slices on 16 bytes where that lets an operand of each
    # element go by 16-byte copies (despite the bank conflicts of an odd
    # multiple of 16 bytes: fewer copy instructions)
    align16 = kfast and any(c['vec'] > 1 and c['kd'] >= 0 for c in copies_of(1, layout(1, True, True)).values())
    G = group(kfast, align16)
    lay = layout(G, kfast, align16)
    if lay['smem'] > SMEM_BYTES:
        raise ValueError(f'elem_matrix: {G} elements of Q {Q}, A {A}, B {B}, I {I}, J {J} in {stages} stages do '
                         f'not fit in {SMEM_BYTES} bytes of shared memory')
    threads = min(MAX_THREADS, max(32 * -(-G * tasks_v // 32), min(256, 32 * -(-G * tasks_t // 32))))
    return dict(regime='element_lanes' if kfast else 'tile_lanes', G=G, threads=threads, stages=stages,
                kfast=int(kfast), align16=bool(align16), ti=ti, tj=tj, ta=ta, tjt=tjt, shBt=int(shBt),
                shBs=int(shBs), same=bool(same), copies=copies_of(G, lay), **lay)


@functools.lru_cache(maxsize=256)
def _packed(*key):
    plan = matrix_plan(*key)
    vals = [plan[f] for f in PLAN_FIELDS] + [plan['copies'][name][f] for name in ('Bt', 'Bs', 'K')
                                              for f in COPY_FIELDS]
    return (ctypes.c_int64 * len(vals))(*vals)


def _plan_key(Bt, K, Bs):
    E, Q, A, B = K.shape
    same = Bt is Bs or (Bt.data_ptr() == Bs.data_ptr() and Bt.shape == Bs.shape and Bt.stride() == Bs.stride())
    return (E, Q, A, B, Bt.shape[-1], Bs.shape[-1], K.element_size(),
            (_strides(Bt, E), _strides(K, E), _strides(Bs, E)), bool(same),
            tuple(t.data_ptr() % 16 == 0 for t in (Bt, K, Bs)))


def elem_matrix_plan(Bt, K, Bs):
    '''The plan (:func:`matrix_plan`) on which :func:`elem_matrix` launches
    for these operands.'''
    return matrix_plan(*_plan_key(Bt, K, Bs))


def elem_matrix(Bt, K, Bs, out=None):
    '''Element blocks ``V[e, i, j] = sum_qab Bt[e,q,a,i] K[e,q,a,b]
    Bs[e,q,b,j]``, kernel K11: ``[E, I, J]``, contiguous, in ``out`` where
    given.  ``K`` is ``[E, Q, A, B]``, ``Bt`` ``[E or 1, Q, A, I]``, ``Bs``
    ``[E or 1, Q, B, J]``, any strides.  Persistent blocks stage groups of
    elements by asynchronous copies and form each output in registers, summed
    over ``b`` and then ``q, a`` in a fixed order (:func:`matrix_plan`): no
    atomics, bitwise reproducible.'''
    if K.device.type == 'cpu':
        return elem_matrix_plain(Bt, K, Bs, out)
    E, Q, A, B = K.shape
    I, J = Bt.shape[-1], Bs.shape[-1]
    _check('elem_matrix', K, Bt=(Bt, (None, Q, A, I)), Bs=(Bs, (None, Q, B, J)))
    out = _output('elem_matrix', K, (E, I, J), out)
    if E * I * J:
        plan = _packed(*_plan_key(Bt, K, Bs))
        _kernels.call('ntt_elem_matrix', K, [Bt, K, Bs, out], scalars=(E, Q, A, B, I, J, plan))
        elem_matrix.launches += 1
    return out


# ------------------------------------------------------------ K12's plan

VECTOR_BUDGET = SMEM_BYTES  # K12's share of a multiprocessor: one block (kernel_plan_sweep.py --k12) ...
VECTOR_SHARED_BUDGET = SMEM_BUDGET  # ... two blocks where every element shares Bt (only g is staged a group)
VECTOR_THREADS = 256  # K12's least threads a block (more than its tiles: more threads issue the copies)
VECTOR_TE = 4  # elements a register tile of K12 where every element shares Bt (a Bt value feeds TE of them)
VECTOR_GROUPS = 4 * 132  # K12's groups, at least, where E allows: four on each multiprocessor of an H100
VECTOR_ALIGN_G = True  # element lanes: g's slices on 16 bytes where its copies and loads allow (else odd strides)
# the plan's scalars, in the order the kernel reads them (csrc/assembly.cu
# launch_vector); the copies of Bt and g follow, COPY_FIELDS each
VECTOR_FIELDS = ('G', 'threads', 'stages', 'kfast', 'ti', 'te', 'nBt', 'ng', 'nr', 'oBt', 'og', 'oStage', 'stage',
                 'oR', 'shBt', 'smem')


@functools.lru_cache(maxsize=256)
def vector_plan(E, Q, A, I, itemsize, strides, aligned=(True, True)):
    '''The launch plan of K12 for ``r[e,i] = sum_qa Bt[e,q,a,i] g[e,q,a]``
    (a pure function; cached), on K11's pattern (:func:`matrix_plan`):
    ``strides`` are those of Bt (e, q, a, i) and g (e, q, a) in values, an
    element stride of 0 for an operator every element shares;
    ``aligned``: the base of Bt and of g on 16 bytes.  Returns a dict:

    - ``regime``: ``'element_lanes'`` where an element has fewer than 32
      register tiles of outputs and a group 32 elements or more (a warp's
      lanes take 32 elements, their slices at odd strides in shared
      memory, or at odd multiples of 16 bytes where that lets an operand
      go by 16-byte copies and 16-byte loads: ``align16[name]``),
      ``'tile_lanes'`` (a warp's
      lanes take an element's tiles, slices on 16 bytes, the elements of
      a warp 32 / (its elements) banks apart), or ``'generic'`` where
      one element does not fit in shared memory in two stages (the generic
      kernel, one thread an output; no other key then);
    - ``G`` elements a group (as many as the budget, :data:`VECTOR_BUDGET`,
      or :data:`VECTOR_SHARED_BUDGET` where Bt is shared, holds, up to one
      register tile a thread for MAX_THREADS threads, and no more than
      makes :data:`VECTOR_GROUPS` groups, or 32 tiles), ``threads`` a
      block (at least :data:`VECTOR_THREADS`), ``stages`` in the ring
      (:data:`STAGES`); a register tile holds ``ti`` outputs (:func:`_tile`)
      of ``te`` elements: :data:`VECTOR_TE` where every element shares Bt
      (in element lanes; its elements kb, kb + G / te, ..., G a multiple of
      te), else 1;
    - each region's element stride (``nBt``, ``ng``, ``nr``: the outputs)
      and offset in values (``oBt`` in the shared region where ``shBt``,
      else in a stage, ``og`` in a stage, ``oStage``, ``stage``, ``oR``),
      ``smem`` bytes (within :data:`SMEM_BYTES`);
    - ``copies``: the copy of Bt and of g (:func:`_copy`).'''
    st, sg = strides
    vec = 16 // itemsize
    shBt = st[0] == 0
    stages = STAGES
    budget = VECTOR_SHARED_BUDGET if shBt else VECTOR_BUDGET
    ti = _tile(I)
    tasks = -(-I // ti)

    def up(n):
        return -(-n // vec) * vec

    # tile_lanes: a warp's lanes take epw elements; their slices start
    # 32 / epw banks apart (at least 4: 16-byte copies stay aligned)
    epw = 1 << (max(1, 32 // tasks) - 1).bit_length()
    shift = max(4, 32 // epw) if epw > 1 else 0

    def strides_of(kfast, align):
        def pad(n, a16):
            if kfast and a16:
                return up(n) + vec * (up(n) // vec % 2 == 0)
            if kfast:
                return n | 1
            n = up(n)
            while shift and n * itemsize // 4 % 32 != shift:
                n += vec
            return n
        return pad(Q * A * I, align[0]), pad(Q * A, align[1]), pad(I, False)
    def layout(G, kfast, align):
        nBt, ng, nr = strides_of(kfast, align)
        # the operator staged once a block, then the ring, then the outputs
        oStage = up(Q * A * I) if shBt else 0
        og = 0 if shBt else up(G * nBt)
        stage = up(og + G * ng)
        oR = oStage + stages * stage
        return dict(nBt=nBt, ng=ng, nr=nr, oBt=0, og=og, oStage=oStage, stage=stage, oR=oR,
                    smem=(oR + G * nr) * itemsize)

    def group(kfast, align, te=1):
        nBt, ng, nr = strides_of(kfast, align)
        per = stages * ((0 if shBt else nBt) + ng) + nr
        G = max(1, min(E, MAX_THREADS // tasks * te, budget // itemsize // per,
                       max(32 * te, -(-E // VECTOR_GROUPS))))
        while G > 1 and layout(G, kfast, align)['smem'] > budget:
            G -= 1
        return G if G < te else G // te * te

    def copies_of(G, lay):
        return {'Bt': _copy([(G, st[0], lay['nBt'], True)] * (not shBt)
                            + [(Q, st[1], A * I, False), (A, st[2], I, False), (I, st[3], 1, False)], vec, aligned[0]),
                'g': _copy([(G, sg[0], lay['ng'], True), (Q, sg[1], A, False), (A, sg[2], 1, False)], vec,
                           aligned[1])}
    kfast = tasks < 32 and group(True, (False, False)) >= 32
    # element lanes: an operand's slices on odd multiples of 16 bytes where
    # that lets it go by 16-byte copies and be read 16 bytes a lane (Bt's
    # rows of outputs, g's runs of r = (q, a): Q A a multiple of 16 bytes),
    # without bank conflicts; at odd strides otherwise
    probe = copies_of(1, layout(1, True, (True, True)))
    align = (kfast and probe['Bt']['vec'] > 1 and probe['Bt']['kd'] >= 0,
             VECTOR_ALIGN_G and kfast and probe['g']['vec'] > 1 and Q * A % vec == 0)
    te = VECTOR_TE if shBt and kfast else 1
    G = group(kfast, align, te)
    te = min(te, G)
    lay = layout(G, kfast, align)
    if lay['smem'] > SMEM_BYTES:
        return dict(regime='generic')
    threads = min(MAX_THREADS, max(VECTOR_THREADS, 32 * -(-(G // te) * tasks // 32)))
    return dict(regime='element_lanes' if kfast else 'tile_lanes', G=G, threads=threads, stages=stages,
                kfast=int(kfast), align16=dict(zip(('Bt', 'g'), align)), ti=ti, te=te, shBt=int(shBt),
                copies=copies_of(G, lay), **lay)


@functools.lru_cache(maxsize=256)
def _packed_vector(*key):
    plan = vector_plan(*key)
    if plan['regime'] == 'generic':
        return None
    vals = [plan[f] for f in VECTOR_FIELDS] + [plan['copies'][name][f] for name in ('Bt', 'g') for f in COPY_FIELDS]
    return (ctypes.c_int64 * len(vals))(*vals)


def _vector_key(Bt, g):
    E, Q, A = g.shape
    return (E, Q, A, Bt.shape[-1], g.element_size(), (_strides(Bt, E), _strides(g, E)),
            tuple(t.data_ptr() % 16 == 0 for t in (Bt, g)))


def elem_vector_plan(Bt, g):
    '''The plan (:func:`vector_plan`) on which :func:`elem_vector` launches
    for these operands.'''
    return vector_plan(*_vector_key(Bt, g))


def elem_vector(Bt, g, out=None):
    '''Element vectors ``r[e, i] = sum_qa Bt[e,q,a,i] g[e,q,a]``, kernel
    K12: ``[E, I]``, contiguous, in ``out`` where given.  ``g`` is ``[E, Q,
    A]``, ``Bt`` ``[E or 1, Q, A, I]``, any strides.  Persistent blocks
    stage groups of elements by asynchronous copies (:func:`vector_plan`;
    the generic kernel where one element does not fit), each output one
    chain of fused multiply-adds over ``q, a`` in a fixed order: no
    atomics, bitwise reproducible, the same bits on every plan.  Counts its
    launches by regime (``elem_vector.forms``).'''
    if g.device.type == 'cpu':
        return elem_vector_plain(Bt, g, out)
    E, Q, A = g.shape
    I = Bt.shape[-1]
    _check('elem_vector', g, Bt=(Bt, (None, Q, A, I)))
    out = _output('elem_vector', g, (E, I), out)
    if E * I:
        key = _vector_key(Bt, g)
        strides = (ctypes.c_int64 * 7)(*_strides(Bt, E), *_strides(g, E))
        _kernels.call('ntt_elem_vector', g, [Bt, g, out], scalars=(E, Q, A, I, strides, _packed_vector(*key)))
        _kernels.count(elem_vector, vector_plan(*key)['regime'])
    return out


_kernels.counted(elem_matrix)
_kernels.counted(elem_vector, forms=('element_lanes', 'tile_lanes', 'generic'))


# ------------------------------------------------------------ K15

VALUE_THREADS = 256  # lanes of a K15 block (csrc/value.cu THREADS)
VALUE_SPAN = 1024  # values a block of elem_value sums, at most


def value_span(P):
    '''Elements a block of :func:`elem_value` sums at ``P`` values an
    element: the largest power of two whose values fit in VALUE_SPAN (at
    least 1), so that an element chunk of a power-of-two size gives its
    blocks' partials.'''
    span = 1
    while 2 * span * P <= VALUE_SPAN:
        span *= 2
    return span


def value_blocks(E, P):
    '''The partials :func:`elem_value` writes for ``E`` elements of ``P``
    values.'''
    return -(-E // value_span(P))


def _lane_sums(x, rounds):
    '''K15's sum of each row of ``x`` [rows, rounds * VALUE_THREADS]: lane
    t adds the values t, t + T, ... in rounds, then the lanes add pairwise,
    lane t + h into lane t for h = T/2, ..., 1.'''
    x = x.view(x.shape[0], rounds, VALUE_THREADS)
    acc = torch.zeros((x.shape[0], VALUE_THREADS), dtype=x.dtype, device=x.device)
    for r in range(rounds):
        acc = acc + x[:, r]
    h = VALUE_THREADS // 2
    while h:
        acc = acc[:, :h] + acc[:, h:2 * h]
        h //= 2
    return acc[:, 0]


def elem_value_plain(f, out=None, finish=None):
    '''Plain torch version of :func:`elem_value`, in the kernel's order of
    sums; with ``finish``, then :func:`elem_value_sum_plain`.'''
    E, P = f.shape
    if finish is not None:
        partials, offsets, total = finish
        out = _last_rows(partials, value_blocks(E, P)) if out is None else out
    span = value_span(P) * P
    nb = value_blocks(E, P)
    rounds = -(-span // VALUE_THREADS)
    x = f.new_zeros((nb, rounds * VALUE_THREADS))
    flat = f.reshape(-1)
    full = E // value_span(P)
    x[:full, :span] = flat[:full * span].view(full, span)
    if full < nb:
        x[full, :E * P - full * span] = flat[full * span:]
    parts = _lane_sums(x, rounds)
    out = parts if out is None else out.copy_(parts)
    if finish is not None:
        elem_value_sum_plain(partials, offsets, out=total)
    return out


def elem_value_sum_plain(partials, offsets, out=None):
    '''Plain torch version of :func:`elem_value_sum`, in the kernel's order
    of sums.'''
    total = None
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        rounds = -(-(hi - lo) // VALUE_THREADS)
        x = partials.new_zeros((1, rounds * VALUE_THREADS))
        x[0, :hi - lo] = partials[lo:hi]
        v = _lane_sums(x, rounds)
        total = v if total is None else total + v
    return total if out is None else out.copy_(total)


def _last_rows(partials, n):
    '''The last ``n`` entries of ``partials`` (a view).'''
    return partials[partials.shape[0] - n:]


def _segments(name, partials, offsets):
    '''``offsets`` as ints, checked to cut ``partials`` [N] into one or
    more segments.'''
    offsets = [int(o) for o in offsets]
    if len(offsets) < 2 or offsets[0] != 0 or offsets[-1] != partials.shape[0] \
            or any(b < a for a, b in zip(offsets[:-1], offsets[1:])):
        raise ValueError(f'{name}: offsets {tuple(offsets)} do not cut {partials.shape[0]} partials into segments')
    return offsets


_TICKETS = {}


def _ticket(device):
    '''The fold's int32 counter on ``device``, made once at 0 (its last
    drawer sets it back to 0): make it, by a first call, before a CUDA
    graph's capture.  One counter a device: folded launches of one device
    run on one stream.'''
    ticket = _TICKETS.get(device)
    if ticket is None:
        ticket = _TICKETS[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return ticket


def elem_value(f, out=None, finish=None):
    '''Partial sums of a functional's integrand ``f`` [E, P], kernel K15:
    ``[value_blocks(E, P)]``, partial b the sum over the elements [b span,
    (b + 1) span) (span :func:`value_span`), contiguous, in ``out`` where
    given.  Each block sums its values in a fixed order: no atomics, bitwise
    reproducible, the plain version's bits.

    ``finish=(partials, offsets, total)`` makes this the value's last
    launch: ``partials`` [N] holds every part's partials in its segment
    [offsets[s], offsets[s + 1]), ``out`` its last rows (by default the last
    ``value_blocks(E, P)``), and the launch's last block writes their sum,
    :func:`elem_value_sum`'s bits, into ``total`` [1].  Such a launch has
    at least one block, for an empty ``f`` too.  Counts its launches by
    form (``elem_value.forms``: ``'partials'``, ``'finish'``).'''
    E, P = f.shape
    if finish is not None:
        partials, offsets, total = finish
        offsets = _segments('elem_value', partials, offsets)
        finish = partials, offsets, total
    if f.device.type == 'cpu':
        return elem_value_plain(f, out, finish)
    _kernels.check_operands('elem_value', f, (E, P), f.dtype)
    nb = value_blocks(E, P)
    span = value_span(P) * P
    scalars = (E * P, span, -(-span // VALUE_THREADS))
    if finish is None:
        out = _output('elem_value', f, (nb,), out)
        if E * P:
            _kernels.call('ntt_elem_value', f, [f, out], scalars=(*scalars, None, None, None, 0, None))
            _kernels.count(elem_value, 'partials')
        return out
    _kernels.check_operands('elem_value', f, (E, P), f.dtype, partials=(partials, (offsets[-1],)),
                            total=(total, (1,)))
    out = _output('elem_value', f, (nb,), _last_rows(partials, nb) if out is None else out)
    isz = f.element_size()
    if nb and (out.data_ptr() + nb * isz != partials.data_ptr() + offsets[-1] * isz
               or out.data_ptr() < partials.data_ptr()):
        raise ValueError('elem_value: out is not the last rows of the partials that finish sums')
    _kernels.call('ntt_elem_value', f, [f, out], scalars=(
        *scalars, partials.data_ptr(), _segment_table(offsets, f.device).data_ptr(), total.data_ptr(),
        len(offsets) - 1, _ticket(f.device).data_ptr()))
    _kernels.count(elem_value, 'finish')
    return out


_SEGMENT_TABLES = {}


def _segment_table(offsets, device):
    '''``offsets`` as an int64 tensor on ``device``, made once for each
    cut and device (a value assembly cuts its partials the same way on
    every call), so that a call inside a CUDA graph's capture copies
    nothing.'''
    key = tuple(offsets), device
    table = _SEGMENT_TABLES.get(key)
    if table is None:
        if len(_SEGMENT_TABLES) >= 64:
            _SEGMENT_TABLES.clear()
        table = _SEGMENT_TABLES[key] = torch.tensor(offsets, dtype=torch.int64, device=device)
    return table


def elem_value_sum(partials, offsets, out=None):
    '''The sum of ``partials`` [N] in segments [offsets[s], offsets[s + 1])
    (one or more), kernel K15: each segment reduced in a fixed order, the
    segments' values added in order; ``[1]``, in ``out`` where given.  The
    value assembly folds this sum into its last :func:`elem_value` launch
    (``finish=``); this launch of its own stays for tests and checks.'''
    offsets = _segments('elem_value_sum', partials, offsets)
    if partials.device.type == 'cpu':
        return elem_value_sum_plain(partials, offsets, out)
    _kernels.check_operands('elem_value_sum', partials, (offsets[-1],), partials.dtype)
    out = _output('elem_value_sum', partials, (1,), out)
    _kernels.call('ntt_elem_value_sum', partials, [partials, _segment_table(offsets, partials.device), out],
                  scalars=(len(offsets) - 1,))
    elem_value_sum.launches += 1
    return out


_kernels.counted(elem_value, forms=('partials', 'finish'))
_kernels.counted(elem_value_sum)
