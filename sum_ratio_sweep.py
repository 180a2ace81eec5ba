#!/usr/bin/env python3
'''Time the warm assembly and take its peak device memory on the three paths
of ``chip_smoke.py`` at several values of
``nutils_tpu_torch.evaluable.SUM_PRODUCT_RATIO``, on one CUDA card.

    python3 sum_ratio_sweep.py [ratio ...]

The evaluator computes a sum of products whose product has at most
SUM_PRODUCT_RATIO times the entries of its largest factor as the product
and a reduction, a larger one as one ``torch.einsum`` (ratio 0: every sum of
products as an einsum).  For each path (the 1,050,625-dof Laplace slice, the
983,403-dof Taylor-Hood and triangle Navier-Stokes steps, float32, as
``chip_smoke.py`` builds them) and each ratio (default 16, 0, 4, 8, 32, 16:
the first value again last, to see the spread) the script builds the System
anew, assembles once (the first call also evaluates the call-invariant
parts and the feature operators) and three times more, and prints one JSON
line: the first call's time, the best of the last two, the peak device
memory of the four calls, and how many sums of products the warm assembly
evaluated at each ratio of product to largest factor.
'''

import collections
import gc
import json
import sys
import time

import chip_smoke

RATIOS = (16, 0, 4, 8, 32, 16)


def _paths(nelems_slice=1024, nelems_ns=330):
    import numpy
    yield 'slice', lambda: chip_smoke.build_laplace(nelems_slice, numpy.float32, reaction=True)
    yield 'ns', lambda: chip_smoke.build_ns(nelems_ns, numpy.float32)
    yield 'ns_tri', lambda: chip_smoke.build_ns(nelems_ns, numpy.float32, 'triangle')


def _product_ratios(fn, clean):
    '''{ratio of product to largest factor: count} of the sums of products
    that one call of ``fn`` evaluates.'''
    from nutils_tpu_torch import evaluable as ev
    seen = collections.Counter()
    orig = ev._Evaluator._eval_sum

    def spy(self, node, frame, overridden):
        factors = ev._decompose_product(node.func)
        if not (len(factors) == 1 and factors[0].core is node.func):
            seen[node.func.size / max(f.core.size for f in factors)] += 1
        return orig(self, node, frame, overridden)
    ev._Evaluator._eval_sum = spy
    try:
        fn(clean)
    finally:
        ev._Evaluator._eval_sum = orig
    return {str(k): v for k, v in sorted(seen.items())}


def main(ratios=RATIOS, device='cuda', **sizes):
    import numpy
    import torch
    from nutils_tpu_torch import _kernels
    from nutils_tpu_torch import evaluable as ev
    from nutils_tpu_torch.utils import config
    cuda = device == 'cuda'
    if cuda:
        if not torch.cuda.is_available():
            raise SystemExit('sum_ratio_sweep.py: torch.cuda.is_available() is false; this sweep needs a CUDA card')
        chip_smoke.phase_device()
        _kernels.build()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    default = ev.SUM_PRODUCT_RATIO
    try:
        for path, build in _paths(**sizes):
            for ratio in ratios:
                ev.SUM_PRODUCT_RATIO = ratio
                with config.device(device):
                    system = build()
                    if isinstance(system, tuple):
                        system, args = system
                    else:
                        args = {'u': numpy.zeros(system.trial_shapes[0][0])}
                    clean = system._clean(args)
                    fn = system._compiled('jacres')
                    system._jac_layout  # the host's pattern and plans, outside the timed calls
                    if cuda:
                        torch.cuda.empty_cache()
                        torch.cuda.reset_peak_memory_stats()
                    times = []
                    for _ in range(4):
                        sync()
                        t0 = time.perf_counter()
                        fn(clean)
                        sync()
                        times.append(time.perf_counter() - t0)
                    peak = torch.cuda.max_memory_allocated() if cuda else None
                    print(json.dumps({'phase': 'sum_ratio', 'path': path, 'ratio': ratio,
                                      't_assemble_first': times[0], 't_assemble': min(times[2:]),
                                      'peak_device_bytes': peak, 'product_ratios': _product_ratios(fn, clean)}),
                          flush=True)
                del system, fn, clean
                gc.collect()
                if cuda:
                    torch.cuda.empty_cache()
    finally:
        ev.SUM_PRODUCT_RATIO = default


if __name__ == '__main__':
    main(tuple(int(a) for a in sys.argv[1:]) or RATIOS)
