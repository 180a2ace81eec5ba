#!/usr/bin/env python3
'''Time kernels K11 (``nutils_tpu_torch/csrc/assembly.cu``, the element
matrices) and K14 (``csrc/masked.cu``, the masked operator's passes) under
variants of their plans, at the shapes the paths give them, on one CUDA
card.

    python3 kernel_plan_sweep.py

K11's plan (``ops/assembly.matrix_plan``) chooses elements a group,
threads, the regime and shared-memory layout from three module constants:
``SMEM_BUDGET`` (a block's share of a multiprocessor), ``STAGES`` (the
ring's depth) and ``TILE_ORDER`` (the register tiles preferred).  Here
every block K11 assembles on the five paths (the Navier-Stokes step's four,
the triangle step's four, the Laplace slice's, one chunk of the Laplace
example's and the elasticity example's) gets random operands of its shape,
strides and precision (K as the factored assembly hands it over: a
permuted slice of the Hessian [B, E, Q, A_total]; a shared operator with
element stride 0; Bs as Bt where the test and trial operators are one
tensor) and runs under the constants as committed and under other
settings of them (budgets of one to four blocks a multiprocessor, three
stages, other tile orders): each setting must give the committed plan's
bits (the sums' order does not depend on the plan), and its device time
is printed beside the committed one's.  Where that time goes: two child
processes (``--probe copies_only``, ``--probe without_copies``) each build
the package's library from a copy of its sources with K11's products cut
out (the copies alone) or its copies cut out (all but the copies), into
``build/nutils_tpu_torch/plan_sweep/``, and time K11 on the committed plan
at every block.  K14 is rebuilt with 1, 2 and 4 vectors a thread (the
constant ``PER``; one nvcc each, in parallel) and runs at the elasticity
path's n = 1,039,682 beside the package's own launch and ``torch.mul``.
One JSON line a case; measure with ``chip_smoke.py`` (``--only kernels``)
once a plan is chosen.

    python3 kernel_plan_sweep.py --k12

K12 (the element vectors, ``ops/assembly.vector_plan``) the same way at
the eight operand shapes of the paths' residuals (g a strided slice of the
point gradient where the paths hand it over so): under settings of
``VECTOR_THREADS`` (a block's least threads), ``STAGES``,
``VECTOR_BUDGET`` and ``VECTOR_SHARED_BUDGET`` (set alike), ``VECTOR_TE`` (elements a register tile where Bt is
shared) and ``VECTOR_GROUPS`` (groups at least), each the committed plan's
bits; a child process (``--probe k12_copies_only``) times K12's copies
alone; then K15's folded value launch beside the two launches it replaced
(``chip_smoke.fold_row``) on random integrands of the finite-strain path's
shape, float32 and float64, as committed and, in child processes
(``--probe fold_spans<n>``), with 1, 2 or 4 spans a block.
'''

import contextlib
import ctypes
import hashlib
import json
import subprocess
import sys

import chip_smoke

# (path, block): (E, Q, A, B, I, J, A_total of K's Hessian, shared operators,
# Bs is Bt, dtype)
BLOCKS = {('ns', 'vu'): (108900, 16, 6, 6, 18, 18, 7, False, True, 'float32'),
          ('ns', 'vp'): (108900, 16, 6, 1, 18, 4, 7, False, False, 'float32'),
          ('ns', 'qu'): (108900, 16, 1, 6, 4, 18, 7, False, False, 'float32'),
          ('ns', 'qp'): (108900, 16, 1, 1, 4, 4, 7, False, True, 'float32'),
          ('ns_tri', 'vu'): (217800, 12, 6, 6, 12, 12, 7, True, True, 'float32'),
          ('ns_tri', 'vp'): (217800, 12, 6, 1, 12, 3, 7, True, False, 'float32'),
          ('ns_tri', 'qu'): (217800, 12, 1, 6, 3, 12, 7, True, False, 'float32'),
          ('ns_tri', 'qp'): (217800, 12, 1, 1, 3, 3, 7, True, True, 'float32'),
          ('slice', 'uu'): (1048576, 4, 3, 3, 4, 4, 3, False, True, 'float32'),
          ('laplace_example', 'chunk'): (2097152, 4, 2, 2, 4, 4, 4, False, True, 'float64'),
          ('elasticity', 'uu'): (259200, 6, 6, 6, 12, 12, 6, True, True, 'float64')}

# K12's operands: (path, residual): (E, Q, A, I, shared Bt, features a
# point of the gradient g slices, the slice's first feature, dtype)
VECTORS = {('ns', 'v'): (108900, 16, 6, 18, False, 14, 7, 'float32'),
           ('ns', 'q'): (108900, 16, 1, 4, False, 14, 13, 'float32'),
           ('ns_tri', 'v'): (217800, 12, 6, 12, True, 14, 7, 'float32'),
           ('ns_tri', 'q'): (217800, 12, 1, 3, True, 14, 13, 'float32'),
           ('slice', 'u'): (1048576, 4, 3, 4, False, 3, 0, 'float32'),
           ('laplace_example', 'chunk'): (2097152, 4, 2, 4, False, 4, 2, 'float64'),
           ('elasticity', 'u'): (259200, 6, 6, 12, True, 6, 0, 'float64'),
           ('finitestrain', 'u'): (518400, 4, 4, 8, False, 4, 0, 'float64')}

# K11's probes: label -> (text of csrc/assembly.cu as committed, its
# replacement)
PROBE = '    T* sV = sm + p.oV;\n'
COPIES = '  auto issue = [&](long long grp, int slot) {\n'
PROBES = {'copies_only': (PROBE, PROBE + '    if (E >= 0) continue;  // the copies alone\n'),
          'without_copies': (COPIES, COPIES + '    if (E >= 0) return;  // no copies\n')}
# K12's: its copies alone
K12_PROBE = '    T* sR = sm + p.oR;\n'
K12_PROBES = {'k12_copies_only': (K12_PROBE, K12_PROBE + '    if (E >= 0) continue;  // the copies alone\n')}
# K15's fold (csrc/value.cu): spans a block
SPANS = 'constexpr int SPANS = 2;'
FOLD_PROBES = {f'fold_spans{n}': [(SPANS, f'constexpr int SPANS = {n};')] for n in (1, 2, 4)}
# K14's variants: vectors a thread
PER = 'constexpr int PER = 1;'
PERS = (1, 2, 4)


def patched(name, old, new):
    '''The text of csrc/``name`` with ``old`` (there once) replaced.'''
    from nutils_tpu_torch import _kernels
    src = (_kernels.CSRC / name).read_text()
    if src.count(old) != 1:
        raise RuntimeError(f'{name} no longer holds {old!r} once')
    return src.replace(old, new)


def sweep_dir(*parts):
    from nutils_tpu_torch import _kernels
    h = hashlib.sha1(' '.join(_kernels.NVCC_FLAGS).encode())
    for src in _kernels.sources():
        h.update(src.read_bytes())
    out = _kernels.BUILD_ROOT.joinpath('plan_sweep', h.hexdigest()[:16], *parts)
    out.mkdir(parents=True, exist_ok=True)
    return out


def build_k14_variants():
    '''{vectors a thread: path of a shared library built from csrc/masked.cu
    with that PER}, one nvcc each, all started together.'''
    from nutils_tpu_torch import _kernels
    out = sweep_dir('k14')
    paths, procs = {}, []
    for per in PERS:
        cu = out / f'masked_per{per}.cu'
        cu.write_text(patched('masked.cu', PER, f'constexpr int PER = {per};'))
        paths[per] = out / f'libmasked_per{per}.so'
        procs.append(subprocess.Popen([_kernels._nvcc(), *_kernels.NVCC_FLAGS, '-shared', '-o', str(paths[per]),
                                       str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for per, proc in zip(PERS, procs):
        diag = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for masked.cu at PER = {per}:\n{diag}')
    return paths


def entry(path, name):
    '''The C entry point ``name`` of the library at ``path``, with the
    package's signature.'''
    from nutils_tpu_torch import _kernels
    fn = getattr(ctypes.CDLL(str(path)), name)
    fn.argtypes = _kernels._SIG[name]
    fn.restype = ctypes.c_int
    return fn


@contextlib.contextmanager
def constants(**values):
    '''K11's and K12's plans under other values of ops/assembly's
    constants.'''
    from nutils_tpu_torch.ops import assembly
    old = {key: getattr(assembly, key) for key in values}

    def clear():
        assembly.matrix_plan.cache_clear()
        assembly._packed.cache_clear()
        assembly.vector_plan.cache_clear()
        assembly._packed_vector.cache_clear()
    for key, value in values.items():
        setattr(assembly, key, value)
    clear()
    try:
        yield
    finally:
        for key, value in old.items():
            setattr(assembly, key, value)
        clear()


def settings():
    '''Other settings of K11's constants: budgets of one to four blocks a
    multiprocessor, each with two and with three stages, and with two
    other tile orders.'''
    from nutils_tpu_torch.ops import assembly
    out = []
    for k in (1, 2, 3, 4):
        budget = assembly.SMEM_SM // k - 1024
        out.append({'SMEM_BUDGET': budget})
        out.append({'SMEM_BUDGET': budget, 'STAGES': 3})
        for order in ((4, 2, 3), (2, 4, 3)):
            out.append({'SMEM_BUDGET': budget, 'TILE_ORDER': order})
    return out


def operands(E, Q, A, B, I, J, At, shared, same, dname):
    '''Random Bt, K, Bs of a block, as the factored assembly lays them
    out, and the block's bound in ms.'''
    import numpy
    import torch
    dtype = getattr(torch, dname)
    rng = numpy.random.default_rng(0)
    Et = 1 if shared else E
    Bt = torch.as_tensor(rng.standard_normal((Et, Q, A, I), dtype=numpy.float32), device='cuda').to(dtype)
    Bs = Bt if same else torch.as_tensor(rng.standard_normal((Et, Q, B, J), dtype=numpy.float32),
                                         device='cuda').to(dtype)
    H = torch.as_tensor(rng.standard_normal((B, E, Q, At), dtype=numpy.float32), device='cuda').to(dtype)
    K = H[..., :A].permute(1, 2, 3, 0)
    peak = chip_smoke.F32_FLOPS if dname == 'float32' else chip_smoke.F64_FLOPS
    bound_ms, _by = chip_smoke.bound((chip_smoke._distinct_numel(Bt, K, Bs) + E * I * J) * K.element_size(),
                                     2 * E * Q * A * J * (B + I), peak)
    return Bt, K, Bs, bound_ms


def sweep_k11():
    import torch
    from nutils_tpu_torch.ops import assembly
    for (path, block), shape in BLOCKS.items():
        dname = shape[-1]
        Bt, K, Bs, bound_ms = operands(*shape)
        plan = assembly.elem_matrix_plan(Bt, K, Bs)
        want = assembly.elem_matrix(Bt, K, Bs)
        base_ms = chip_smoke.time_ms(lambda: assembly.elem_matrix(Bt, K, Bs, out=want))[0]
        out = torch.empty_like(want)
        best = (base_ms, {})
        for setting in settings():
            with constants(**setting):
                try:
                    p = assembly.elem_matrix_plan(Bt, K, Bs)
                except ValueError:
                    continue
                got = assembly.elem_matrix(Bt, K, Bs, out=out)
                torch.cuda.synchronize()
                same_bits = bool(torch.equal(got, want))
                ms = chip_smoke.time_ms(lambda: assembly.elem_matrix(Bt, K, Bs, out=out))[0]
            chip_smoke.emit('k11_setting', path=path, block=block, dtype=dname, setting=setting, regime=p['regime'],
                            G=p['G'], threads=p['threads'], stages=p['stages'],
                            tiles=[p['ti'], p['tj'], p['ta'], p['tjt']], smem=p['smem'], ms=ms, committed_ms=base_ms,
                            bound_ms=bound_ms, same_bits_as_committed=same_bits)
            if not same_bits:
                raise AssertionError(f'K11 {path} {block} under {setting} differs from its committed plan')
            if ms < best[0]:
                best = (ms, setting)
        chip_smoke.emit('k11_best', path=path, block=block, dtype=dname, committed_ms=base_ms, bound_ms=bound_ms,
                        committed=dict(regime=plan['regime'], G=plan['G'], threads=plan['threads'],
                                       stages=plan['stages'], tiles=[plan['ti'], plan['tj'], plan['ta'], plan['tjt']]),
                        best_ms=best[0], best_setting=best[1])
        del Bt, Bs, K, want, out
        torch.cuda.empty_cache()


def probe_k11(label):
    '''``--probe label`` (a child process): the package's library built
    from its sources with PROBES[label] applied to csrc/assembly.cu, and K11
    timed on the committed plan at every block beside its bound.'''
    import shutil
    import torch
    from nutils_tpu_torch import _kernels
    from nutils_tpu_torch.ops import assembly
    csrc = sweep_dir(label, 'csrc')
    for src in _kernels.sources():
        shutil.copy(src, csrc / src.name)
    (csrc / 'assembly.cu').write_text(patched('assembly.cu', *PROBES[label]))
    _kernels.CSRC, _kernels.BUILD_ROOT = csrc, csrc.parent / 'build'
    _path, seconds, _diag = _kernels.build()
    for (path, block), shape in BLOCKS.items():
        Bt, K, Bs, bound_ms = operands(*shape)
        out = assembly.elem_matrix(Bt, K, Bs)
        chip_smoke.emit('k11_probe', probe=label, path=path, block=block, dtype=shape[-1], nvcc_seconds=seconds,
                        ms=chip_smoke.time_ms(lambda: assembly.elem_matrix(Bt, K, Bs, out=out))[0],
                        bound_ms=bound_ms)
        del Bt, Bs, K, out
        torch.cuda.empty_cache()


def vector_settings():
    '''Settings of K12's constants: its least threads a block, the ring's
    stages, a block's share of a multiprocessor (one or two blocks), the
    elements of a register tile where Bt is shared (1 or 4) and the groups
    the elements make at least, each combination; and g's slices the other
    way (``VECTOR_ALIGN_G``).'''
    from nutils_tpu_torch.ops import assembly
    return [{'VECTOR_THREADS': threads, 'STAGES': stages, 'VECTOR_BUDGET': assembly.SMEM_SM // k - 1024,
             'VECTOR_SHARED_BUDGET': assembly.SMEM_SM // k - 1024, 'VECTOR_TE': te, 'VECTOR_GROUPS': groups}
            for threads in (0, 256, 512) for stages in (2, 3) for k in (1, 2) for te in (1, 4)
            for groups in (264, 528, 1056)] + [{'VECTOR_ALIGN_G': not assembly.VECTOR_ALIGN_G}]


def vector_operands(E, Q, A, I, shared, At, a0, dname):
    '''Random Bt and g of a residual, g a slice of a gradient of At
    features a point, and its bound in ms.'''
    import numpy
    import torch
    dtype = getattr(torch, dname)
    rng = numpy.random.default_rng(0)
    Bt = torch.as_tensor(rng.standard_normal((1 if shared else E, Q, A, I), dtype=numpy.float32),
                         device='cuda').to(dtype)
    g = torch.as_tensor(rng.standard_normal((E, Q, At), dtype=numpy.float32), device='cuda').to(dtype)[..., a0:a0 + A]
    peak = chip_smoke.F32_FLOPS if dname == 'float32' else chip_smoke.F64_FLOPS
    bound_ms, _by = chip_smoke.bound((Bt.numel() + g.numel() + E * I) * g.element_size(), 2 * E * Q * A * I, peak)
    return Bt, g, bound_ms


def k12_fields(p):
    return {key: p.get(key) for key in ('regime', 'G', 'threads', 'stages', 'ti', 'te', 'smem')}


def sweep_k12():
    import torch
    from nutils_tpu_torch.ops import assembly
    for (path, block), shape in VECTORS.items():
        dname = shape[-1]
        Bt, g, bound_ms = vector_operands(*shape)
        plan = assembly.elem_vector_plan(Bt, g)
        want = assembly.elem_vector(Bt, g)
        base_ms = chip_smoke.time_ms(lambda: assembly.elem_vector(Bt, g, out=want))[0]
        out = torch.empty_like(want)
        best = (base_ms, {})
        for setting in vector_settings():
            with constants(**setting):
                p = assembly.elem_vector_plan(Bt, g)
                got = assembly.elem_vector(Bt, g, out=out)
                torch.cuda.synchronize()
                same_bits = bool(torch.equal(got, want))
                ms = chip_smoke.time_ms(lambda: assembly.elem_vector(Bt, g, out=out))[0]
            chip_smoke.emit('k12_setting', path=path, block=block, dtype=dname, setting=setting, **k12_fields(p),
                            ms=ms, committed_ms=base_ms, bound_ms=bound_ms, same_bits_as_committed=same_bits)
            if not same_bits:
                raise AssertionError(f'K12 {path} {block} under {setting} differs from its committed plan')
            if ms < best[0]:
                best = (ms, setting)
        chip_smoke.emit('k12_best', path=path, block=block, dtype=dname, committed_ms=base_ms, bound_ms=bound_ms,
                        committed=k12_fields(plan), best_ms=best[0], best_setting=best[1])
        del Bt, g, want, out
        torch.cuda.empty_cache()


def probe_k12(label):
    '''``--probe k12_copies_only`` (a child process): K12's copies alone
    (its products and writes cut out) on the committed plan at every
    residual, beside its bound.'''
    import shutil
    import torch
    from nutils_tpu_torch import _kernels
    from nutils_tpu_torch.ops import assembly
    csrc = sweep_dir(label, 'csrc')
    for src in _kernels.sources():
        shutil.copy(src, csrc / src.name)
    (csrc / 'assembly.cu').write_text(patched('assembly.cu', *K12_PROBES[label]))
    _kernels.CSRC, _kernels.BUILD_ROOT = csrc, csrc.parent / 'build'
    _path, seconds, _diag = _kernels.build()
    for (path, block), shape in VECTORS.items():
        Bt, g, bound_ms = vector_operands(*shape)
        out = assembly.elem_vector(Bt, g)
        chip_smoke.emit('k12_probe', probe=label, path=path, block=block, dtype=shape[-1], nvcc_seconds=seconds,
                        ms=chip_smoke.time_ms(lambda: assembly.elem_vector(Bt, g, out=out))[0], bound_ms=bound_ms)
        del Bt, g, out
        torch.cuda.empty_cache()


def probe_fold(label):
    '''``--probe fold_...`` (a child process): K15 built with
    FOLD_PROBES[label] applied to csrc/value.cu, its fold and its two
    launches timed (:func:`fold_rows`).'''
    import shutil
    from nutils_tpu_torch import _kernels
    csrc = sweep_dir(label, 'csrc')
    for src in _kernels.sources():
        shutil.copy(src, csrc / src.name)
    text = (_kernels.CSRC / 'value.cu').read_text()
    for old, new in FOLD_PROBES[label]:
        if text.count(old) != 1:
            raise RuntimeError(f'value.cu no longer holds {old!r} once')
        text = text.replace(old, new)
    (csrc / 'value.cu').write_text(text)
    _kernels.CSRC, _kernels.BUILD_ROOT = csrc, csrc.parent / 'build'
    _kernels.build()
    fold_rows(label)


def fold_rows(label='committed', E=518400, P=4):
    '''K15's folded launch beside its two launches on a random integrand of
    the finite-strain path's shape.'''
    import numpy
    import torch
    f = numpy.random.default_rng(2).standard_normal((E, P))
    for dtype in (torch.float32, torch.float64):
        chip_smoke.fold_row(torch.as_tensor(f, dtype=dtype, device='cuda'), f'random finitestrain shape, {label}')


def sweep_k14(paths, n=1039682):
    import numpy
    import torch
    from nutils_tpu_torch.ops import sparse
    rng = numpy.random.default_rng(1)
    for dtype in (torch.float32, torch.float64):
        m = torch.as_tensor(rng.random(n) > 0.01, device='cuda').to(dtype)
        x, y = (torch.as_tensor(rng.standard_normal(n), dtype=dtype, device='cuda') for _ in range(2))
        z = torch.empty_like(x)
        plan = sparse.mask_plan(n, x.element_size(), (x.data_ptr() % 16,) * 4)
        want = {'mask_pre': sparse.mask_pre_plain(m, x), 'mask_post': sparse.mask_post_plain(m, y, x)}
        row = dict(dtype=str(dtype).split('.')[1], n=n, head=plan['head'], nvec=plan['nvec'])
        row['package_mask_pre_ms'] = chip_smoke.time_ms(lambda: sparse.mask_pre(m, x, out=z))[0]
        row['package_mask_post_ms'] = chip_smoke.time_ms(lambda: sparse.mask_post(m, y, x, out=z))[0]
        row['torch_mul_ms'] = chip_smoke.time_ms(lambda: torch.mul(m, x, out=z))[0]
        for per, lib in paths.items():
            grid = max(1, -(-plan['nvec'] // (sparse.MASK_THREADS * per)),
                       -(-(plan['head'] + plan['tail']) // sparse.MASK_THREADS))
            for name, tensors in (('mask_pre', (m, x, z)), ('mask_post', (m, y, x, z))):
                fn = entry(lib, 'ntt_' + name)

                def run(fn=fn, tensors=tensors, name=name):
                    err = fn(0 if dtype == torch.float32 else 1, *(t.data_ptr() for t in tensors), None, n,
                             plan['head'], plan['nvec'], grid, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f'ntt_{name} ({per} vectors a thread): CUDA error {err}')
                run()
                torch.cuda.synchronize()
                row[f'{name}_per{per}_equal'] = bool(torch.equal(z, want[name]))
                row[f'{name}_per{per}_ms'] = chip_smoke.time_ms(run)[0]
                if not row[f'{name}_per{per}_equal']:
                    raise AssertionError(f'K14 {name} at {per} vectors a thread differs from its plain version')
        chip_smoke.emit('k14_per', **row)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('kernel_plan_sweep.py: torch.cuda.is_available() is false; this sweep needs a CUDA card')
    sys.path.insert(0, str(chip_smoke.ROOT))
    if sys.argv[1:2] == ['--probe'] and len(sys.argv) == 3 and sys.argv[2] in PROBES:
        return probe_k11(sys.argv[2])
    if sys.argv[1:2] == ['--probe'] and len(sys.argv) == 3 and sys.argv[2] in K12_PROBES:
        return probe_k12(sys.argv[2])
    if sys.argv[1:2] == ['--probe'] and len(sys.argv) == 3 and sys.argv[2] in FOLD_PROBES:
        return probe_fold(sys.argv[2])
    if sys.argv[1:] == ['--k12']:
        chip_smoke.phase_device()
        chip_smoke.phase_build()
        fold_rows()
        sweep_k12()
        for label in list(K12_PROBES) + list(FOLD_PROBES):
            subprocess.run([sys.executable, __file__, '--probe', label], check=True)
        fold_rows()
        print(json.dumps({'done': True}), flush=True)
        return
    if sys.argv[1:]:
        raise SystemExit(f'kernel_plan_sweep.py: unknown arguments {sys.argv[1:]} (none, --k12, or --probe '
                         f'{"|".join(list(PROBES) + list(K12_PROBES) + list(FOLD_PROBES))})')
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    paths = build_k14_variants()
    sweep_k14(paths)
    sweep_k11()
    for label in PROBES:  # one at a time: each times the card alone
        subprocess.run([sys.executable, __file__, '--probe', label], check=True)
    sweep_k14(paths)
    print(json.dumps({'done': True}), flush=True)


if __name__ == '__main__':
    main()
