#!/usr/bin/env python3
'''Two probes of ``chip_smoke.py``'s cahnhilliard cell on one CUDA card
(``examples/cahnhilliard.py``'s problem through nutils_tpu_torch, built as
that phase builds it, float64, degree 1, the example's defaults).

    python3 cahnhilliard_probe.py             # at chip_smoke.CH_NELEMS
    python3 cahnhilliard_probe.py --nelems 100

1. ``exact``: the first step's Newton run at the full timestep (``dt`` 1,
   the example's 0.1 s; 5 iterations; tolerance 1; from the seeded initial
   phase field; ``step``'s halving switched off), once with the phase's
   inner solves (GMRES with K7's diagonal on the card, ``CH_SOLVER``) and
   once with exact ones (scipy's sparse LU on the host).  Each
   iteration's residual norm, time and inner solve, and the run's
   outcome: whether the step's halving belongs to the example or to the
   inexact inner solves.
2. ``ad``: the cost of point-level derivatives.  (a) A chain of 64
   elementwise multiplications of a vector of 480 float64 values (the
   flux grid's points), plain, under ``torch.func.jvp`` and with reverse
   autograd, on the card and on the host CPU: seconds an operation.
   (b) One Newton evaluation of the locate, the geometry and its root
   gradient at the flux grid's points (spacing 1/20) in their nearest
   elements, on the card: the first (lowering it) and a warm one, with
   the root gradient by forward mode and by reverse mode
   (``evaluable.reverse_grads``), and the largest difference of their
   values.  Also the seconds the candidates' argsort took at this mesh.

One JSON line a measurement; the card's name and power limit first.
'''

import contextlib
import sys
import time

import chip_smoke
from chip_smoke import ROOT, emit


def run_full_timestep(prob, method):
    '''The first step's Newton run at the full timestep with ``method``:
    (converged, seconds, per-iteration records).'''
    from nutils_tpu_torch import matrix, solver
    solve_leniently = matrix.Matrix.solve_leniently
    sink = []

    def recorded(jac, res, **kw):
        t, out = chip_smoke._sync_time(lambda: solve_leniently(jac, res, **kw))
        stats = dict(getattr(jac, '_solve_stats', None) or {})
        sink.append({'ev': 'newton_solve', 't': t, 'stats': {k: stats.get(k) for k in
                                                               ('method', 'iters', 'accepted_on_device', 'driver')}})
        return out
    matrix.Matrix.solve_leniently = recorded
    converged = True
    try:
        with chip_smoke.solve_events() as evs:
            t0 = time.perf_counter()
            try:
                prob['step'](prob['args'], method=method, maxretry=0)
            except (solver.SolverError, matrix.MatrixError) as e:
                converged = str(e)
            seconds = time.perf_counter() - t0
    finally:
        matrix.Matrix.solve_leniently = solve_leniently
    its = [dict(resnorm=e['resnorm']) for e in evs if e['ev'] == 'jacres']
    for it, s in zip(its, sink):
        it.update(t_solve=s['t'], **s['stats'])
    return converged, seconds, its


def probe_exact(nelems):
    import _torch_parity as tp
    import numpy
    from nutils_tpu_torch import solver
    from nutils_tpu_torch.utils import config
    with config.floatx(numpy.float64), config.device('cuda'):
        t0 = time.perf_counter()
        prob = tp.cahnhilliard('nutils_tpu_torch', nelems=nelems, locate=False,
                               **{k: v for k, v in chip_smoke.CH_PROBLEM.items() if k != 'gridstep'})
        emit('probe_problem', nelems=nelems, ndofs=int(prob['args']['φ'].size) * 2, seconds=time.perf_counter() - t0)
        for name, method in (('gmres', solver.Newton(solver=chip_smoke.CH_SOLVER)),
                             ('exact', solver.Newton(solver='direct'))):
            converged, seconds, its = run_full_timestep(prob, method)
            emit('probe_exact', nelems=nelems, inner=name, dt=1., maxiter=5, tol=1, converged=converged,
                 seconds=seconds, iterations=its)
    return prob


@contextlib.contextmanager
def forward_grads():
    '''Root gradients by forward mode (``torch.func.jvp``), the evaluator's
    default, inside point location's evaluations too.'''
    from nutils_tpu_torch import evaluable
    saved = evaluable.reverse_grads
    evaluable.reverse_grads = contextlib.nullcontext
    try:
        yield
    finally:
        evaluable.reverse_grads = saved


def probe_ops(device, n=480, k=64, reps=20):
    import torch
    x = torch.rand(n, dtype=torch.float64, device=device)

    def chain(v):
        for _ in range(k):
            v = v * 1.0000001
        return v

    def plain():
        chain(x)

    def forward():
        torch.func.jvp(chain, (x,), (torch.ones_like(x),))

    def reverse():
        xr = x.detach().requires_grad_()
        chain(xr).sum().backward()
    out = {}
    for name, fn in (('plain', plain), ('jvp', forward), ('reverse', reverse)):
        fn()
        if device == 'cuda':
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if device == 'cuda':
            torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / reps / k
    emit('probe_ops', device=device, n=n, ops=k, seconds_an_op=out)


def probe_locate_eval(prob, device='cuda'):
    import numpy
    from nutils_tpu_torch import function, unstructured
    from nutils_tpu_torch.utils import config, numeric
    topo, geom = prob['domain'], prob['geom']
    coords = numeric.simplex_grid([1, 1], chip_smoke.CH_PROBLEM['gridstep'])
    with config.floatx(numpy.float64), config.device(device):
        csmp = topo.sample('_centroid')
        cent = numpy.empty((len(topo), 2))
        for s in getattr(csmp, 'samples', [csmp]):
            cent[s.index] = numpy.asarray(s.eval(geom)).reshape(s.nelems, -1)
        t0 = time.perf_counter()
        cand = unstructured._nearest_elements(cent, coords, 32)[:, 0]
        t_candidates = time.perf_counter() - t0
        xi = topo._locate_start(cand)
        rootgrad = function.grad(geom, function._RootCoords(topo.space, 2))
        out = {}
        for mode, ctx in (('reverse', contextlib.nullcontext), ('forward', forward_grads)):
            with ctx():
                evaluate = unstructured._PointEval(geom, rootgrad, {}, 2)
                t_first, first = chip_smoke._sync_time(lambda: topo._locate_eval(cand, xi, evaluate))
                t_warm, warm = chip_smoke._sync_time(lambda: topo._locate_eval(cand, xi + .1, evaluate))
            out[mode] = first, warm
            emit('probe_locate_eval', mode=mode, elements=len(topo), points=len(coords), t_first=t_first,
                 t_warm=t_warm, lowered=evaluate.lowered)
        diff = max(float(numpy.abs(a - b).max()) for pair in zip(out['reverse'], out['forward'])
                   for a, b in zip(*pair))
        emit('probe_locate_eval_agree', max_abs_diff=diff, t_candidates=t_candidates, elements=len(topo),
             points=len(coords))


def main():
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / 'tests'))  # _torch_parity: the tests' problem builders (no JAX)
    args = sys.argv[1:]
    nelems = int(args[args.index('--nelems') + 1]) if '--nelems' in args else chip_smoke.CH_NELEMS
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    for device in ('cuda', 'cpu'):
        probe_ops(device)
    prob = probe_exact(nelems)
    probe_locate_eval(prob)


if __name__ == '__main__':
    main()
