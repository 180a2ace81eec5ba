#!/usr/bin/env python3
'''Time kernel K9 (``nutils_tpu_torch/csrc/csr_spmv.cu``, the CSR matvec)
at 1, 2, 4 and 8 lanes a row and on row-block plans of 1,024 to 4,096
nonzeros a block, on the jacobian of the triangle Navier-Stokes step, on
one CUDA card.

    python3 csr_lanes_sweep.py [nelems]

K9's two tunables: the lanes that sum a row of a block (the constant
``LANES`` of the source) and the nonzeros a block stages (the plan's
``cap``, ``ops/sparse.CSR_CAP``).  This script rebuilds the source once for
each lane count (one nvcc each, in parallel, into
``build/nutils_tpu_torch/lanes_sweep/``), makes the plan at each cap, runs
every pair on the step's operator (``unitsquare(nelems, 'triangle')``,
default 330) in float32 and float64, checks it against the plain version
and prints one JSON line per case with the device time and the bytes
bound, as ``chip_smoke.py`` measures them.  Rerun it when a ported path
brings rows of another length.
'''

import ctypes
import hashlib
import itertools
import json
import subprocess
import sys

import chip_smoke

LANES = (1, 2, 4, 8)
CAPS = (1024, 2048, 3072, 4096)
CONSTANT = 'constexpr int LANES = 2;'


def build_variants():
    '''{lanes: path of a shared library exporting ``ntt_csr_spmv``}.'''
    from nutils_tpu_torch import _kernels
    src = (_kernels.CSRC / 'csr_spmv.cu').read_text()
    if CONSTANT not in src:
        raise RuntimeError(f'csr_spmv.cu no longer declares {CONSTANT!r}')
    out = _kernels.BUILD_ROOT / 'lanes_sweep' / hashlib.sha1(src.encode()).hexdigest()[:16]
    out.mkdir(parents=True, exist_ok=True)
    paths, procs = {}, []
    for lanes in LANES:
        cu = out / f'csr_spmv_{lanes}.cu'
        cu.write_text(src.replace(CONSTANT, f'constexpr int LANES = {lanes};'))
        paths[lanes] = out / f'libcsr_spmv_{lanes}.so'
        procs.append(subprocess.Popen([_kernels._nvcc(), *_kernels.NVCC_FLAGS, '-shared', '-o', str(paths[lanes]),
                                       str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for lanes, proc in zip(LANES, procs):
        diag = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {lanes} lanes:\n{diag}')
    return paths


def main(nelems=330):
    import numpy
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('csr_lanes_sweep.py: torch.cuda.is_available() is false; this sweep needs a CUDA card')
    from nutils_tpu_torch.ops import sparse
    from nutils_tpu_torch.utils import config
    chip_smoke.phase_device()
    paths = build_variants()
    with config.device('cuda'):
        system, args = chip_smoke.build_ns(nelems, numpy.float32, 'triangle')
        jac, _res = system.assemble_jacobian_residual(args)
        data32, _none, indices, indptr = jac._csr_tables()
    n, nnz = jac.shape[0], int(indices.shape[0])
    del system, jac
    x64 = numpy.random.default_rng(2).standard_normal(n)
    plans = {cap: sparse.csr_plan(indptr, cap) for cap in CAPS}
    for dtype in (torch.float32, torch.float64):
        isz = 4 if dtype == torch.float32 else 8
        data, x = data32.to(dtype), torch.as_tensor(x64, dtype=dtype, device='cuda')
        want = sparse.csr_matvec_plain(data, indices, indptr, x)
        scale = float(sparse.csr_matvec_plain(data.abs(), indices, indptr, x.abs()).max())
        bound_ms, bound_by = chip_smoke.bound(nnz * (isz + 4) + (n + 1) * 4 + 2 * n * isz, 2 * nnz)
        for (lanes, path), (cap, plan) in itertools.product(paths.items(), plans.items()):
            fn = ctypes.CDLL(str(path)).ntt_csr_spmv
            fn.argtypes = (ctypes.c_int,) + (ctypes.c_void_p,) * 7 + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
            fn.restype = ctypes.c_int
            y = torch.empty(n, dtype=dtype, device='cuda')

            def run():
                err = fn(0 if dtype == torch.float32 else 1, data.data_ptr(), indices.data_ptr(), indptr.data_ptr(),
                         plan.data_ptr(), x.data_ptr(), y.data_ptr(), None, int(plan.shape[0]) - 1, cap,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f'ntt_csr_spmv ({lanes} lanes, cap {cap}): CUDA error {err}')
            run()
            torch.cuda.synchronize()
            relerr = float((y.double() - want.double()).abs().max()) / scale
            ms, call_ms = chip_smoke.time_ms(run)
            print(json.dumps({'phase': 'csr_lanes', 'lanes': lanes, 'cap': cap, 'blocks': int(plan.shape[0]) - 1,
                              'dtype': str(dtype).split('.')[1], 'n': n, 'nnz': nnz, 'ms': ms, 'call_ms': call_ms,
                              'bound_ms': bound_ms, 'bound_by': bound_by, 'max_rel_err': relerr}), flush=True)
            if not relerr <= chip_smoke.TOL[str(dtype).split('.')[1]]:
                raise AssertionError(f'K9 at {lanes} lanes, cap {cap} disagrees with its plain version: {relerr:.3e}')


if __name__ == '__main__':
    main(*[int(a) for a in sys.argv[1:]])
