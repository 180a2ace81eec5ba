'''Build, load and launch of the hand-written CUDA kernels.

K1 (``csrc/stencil.cu``), K2 and K3 (``csrc/mg.cu``), K4 (``csrc/cg.cu``),
K5 (``csrc/blockgrid.cu``), K6 (``csrc/gmres.cu``), K7 (``csrc/schur.cu``),
K8 (``csrc/csr_scatter.cu``), K9 (``csrc/csr_spmv.cu``), K10
(``csrc/bicgstab.cu``), K11 and K12 (``csrc/assembly.cu``), K13
(``csrc/block_jacobi.cu``), K14 (``csrc/masked.cu``) and K15
(``csrc/value.cu``) compile with ``nvcc`` for ``sm_90a``, one ``nvcc`` per
source, all started together, and link into one shared library with a
plain C interface, loaded with ``ctypes``.  The build happens at first use,
into ``build/nutils_tpu_torch/<hash of the sources and flags>/`` at the
root of the checkout, so a change of any source rebuilds.  Every C entry
point launches on the stream it is given (PyTorch's current stream),
allocates nothing, and returns ``cudaGetLastError()``; :func:`launch` and
:func:`call` turn a nonzero code into an exception.

Each CUDA wrapper counts its launches (:func:`counted`); a :class:`Graph`
captured from code that calls the wrappers adds, at each replay, what the
capture would have launched.
'''

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy
import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / 'csrc'
BUILD_ROOT = _PKG.parent / 'build' / 'nutils_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3', '-Xcompiler', '-fPIC')
LIBNAME = 'libnutils_tpu_torch.so'

_I64x4 = ctypes.c_int64 * 4
_I32x4 = ctypes.c_int * 4
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_PI64 = ctypes.POINTER(ctypes.c_int64)
_PI32 = ctypes.POINTER(ctypes.c_int)
_SIG = {
    'ntt_stencil_matvec': (_I, _P, _P, _P, _P, _I, _PI64, _PI32, _PI32, _P),
    'ntt_jacobi': (_I, _P, _P, _P, _P, _P, _P, ctypes.c_double, _I, _I, _PI64, _PI32, _PI32, _P),
    'ntt_stencil_tile': (_I, _P, _P, _P, _P, _I, _PI64, _PI32, _PI32, _P),
    'ntt_jacobi_fused': (_I, _P, _P, _P, _P, _P, _P, _P, ctypes.c_double, _I, _I, _I, _I, _PI64, _PI32, _PI32, _P),
    'ntt_restrict': (_I, _P, _P, _P, _I, _PI64, _PI64, _P),
    'ntt_prolong_add': (_I, _P, _P, _P, _I, _PI64, _PI64, _P),
    'ntt_transfer_tile': (_I, _P, _P, _P, _I, _I, _I, _I, _P),
    'ntt_cg_dot': (_I, _P, _P, _P, _I, _I, _I, _I, _P),
    'ntt_cg_step': (_I, _P, _P, _P, _P, _P, _I, _I, _P),
    'ntt_cg_xpby': (_I, _P, _P, _P, _I, _I, _P),
    'ntt_blockgrid_matvec': (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P),
    'ntt_schur_diag': (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_double, _P),
    'ntt_csr_scatter': (_I, _P, _P, _P, _P, _I, _P),
    'ntt_csr_spmv': (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    'ntt_elem_matrix': (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _PI64, _P),
    'ntt_elem_vector': (_I, _P, _P, _P, _I, _I, _I, _I, _PI64, _PI64, _P),
    'ntt_block_apply': (_I, _P, _P, _P, _P, _I, _I, _P),
    'ntt_mask_pre': (_I, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    'ntt_mask_post': (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    'ntt_elem_value': (_I, _P, _P, ctypes.c_int64, _I, _I, _P, _P, _P, _I, _P, _P),
    'ntt_elem_value_sum': (_I, _P, _P, _P, _I, _P),
    'ntt_gmres_project': (_I, _P, _P, _P, _L, _I, _I, _I, _P),
    'ntt_gmres_update': (_I, _P, _P, _P, _P, _L, _I, _I, _I, _P),
    'ntt_gmres_normalize': (_I, _P, _P, _P, _P, _L, _I, _I, _P),
    'ntt_gmres_start': (_I, _P, _P, _P, _I, _I, _P),
    'ntt_gmres_residual': (_I, _P, _P, _P, _P, _I, _I, _I, _P),
    'ntt_gmres_solve_combine': (_I, _P, _P, _P, _L, _I, _I, _P),
    'ntt_bicg_dots': (_I, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    'ntt_bicg_s': (_I, _P, _P, _P, _P, _I, _P),
    'ntt_bicg_xr': (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P),
    'ntt_bicg_refresh': (_I, _P, _P, _P, _P, _P, _I, _P),
    'ntt_bicg_p': (_I, _P, _P, _P, _P, _P, _I, _P),
}


def sources():
    return sorted(CSRC.glob('*.cu')) + sorted(CSRC.glob('*.cuh'))


def library_path():
    h = hashlib.sha1(' '.join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIBNAME


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    for home in (os.environ.get('CUDA_HOME'), os.environ.get('CUDA_PATH'), '/usr/local/cuda'):
        if home and (Path(home) / 'bin' / 'nvcc').exists():
            return str(Path(home) / 'bin' / 'nvcc')
    raise RuntimeError('nvcc not found: the CUDA kernels of nutils_tpu_torch build with the CUDA toolkit')


def build(verbose=False):
    '''Compile the CUDA sources unless the hash-keyed library exists: one
    ``nvcc -c`` per source, all running at once, then one link.  Returns
    (path, seconds spent compiling and linking, compiler diagnostics).  With
    ``verbose`` the compiler reports registers and spills per kernel
    (``-Xptxas=-v``) into the diagnostics.'''
    path = library_path()
    if path.exists():
        return path, 0.0, ''
    path.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f'{os.getpid()}.tmp'
    srcs = sorted(CSRC.glob('*.cu'))
    objs = [path.with_name(f'{src.stem}.{tag}.o') for src in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *(['-Xptxas=-v'] if verbose else []), '-c', '-o', str(obj),
                               str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    diags = [proc.communicate()[0] for proc in procs]
    for src, proc, diag in zip(srcs, procs, diags):
        if proc.returncode:
            raise RuntimeError(f'nvcc failed on {src.name} with code {proc.returncode}:\n{diag}')
    tmp = path.with_name(f'{LIBNAME}.{tag}')
    link = subprocess.run([nvcc, *NVCC_FLAGS, '-shared', '-o', str(tmp), *[str(o) for o in objs]],
                          capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if link.returncode:
        raise RuntimeError(f'nvcc link failed with code {link.returncode}:\n{link.stdout}\n{link.stderr}')
    for obj in objs:
        obj.unlink()
    os.replace(tmp, path)
    return path, seconds, ''.join(diags) + link.stdout + link.stderr


@functools.lru_cache(maxsize=None)
def library():
    path, _seconds, _diag = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIG.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ntt_error_string.argtypes = (ctypes.c_int,)
    lib.ntt_error_string.restype = ctypes.c_char_p
    lib.ntt_cg_grid.argtypes = (ctypes.c_int,)
    lib.ntt_cg_grid.restype = ctypes.c_int
    return lib


COUNTED = []


def counted(wrapper, forms=()):
    '''Register a kernel wrapper whose ``launches`` attribute counts its
    launches (set to 0 here), and, for a kernel that comes in several
    forms, whose ``forms`` dict counts them by form (:func:`count`);
    returns the wrapper.'''
    wrapper.launches = 0
    wrapper.forms = dict.fromkeys(forms, 0)
    COUNTED.append(wrapper)
    return wrapper


def count(wrapper, form):
    '''One launch of ``wrapper``'s kernel, in ``form``.'''
    wrapper.launches += 1
    wrapper.forms[form] += 1


class Graph:
    '''A ``torch.cuda.CUDAGraph`` captured from ``fn()`` on the current
    device.  The wrappers' counters do not count the capture; each
    :meth:`replay` adds what it launched (``counts``: wrapper name ->
    launches a replay).  A capture that fails raises.'''

    def __init__(self, fn):
        before = [(w.launches, dict(w.forms)) for w in COUNTED]
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                fn()
        finally:
            self._deltas = [(w, w.launches - b, {k: w.forms[k] - v for k, v in f.items() if w.forms[k] != v})
                            for w, (b, f) in zip(COUNTED, before) if w.launches != b]
            for w, (b, f) in zip(COUNTED, before):
                w.launches, w.forms = b, f
        self.counts = {w.__name__: d for w, d, _f in self._deltas}
        self.replays = 0

    def replay(self):
        self.graph.replay()
        for w, d, f in self._deltas:
            w.launches += d
            for k, v in f.items():
                w.forms[k] += v
        self.replays += 1


def check_operands(name, ref, shape, dtype, **named):
    '''Raise unless ``ref`` and every named (tensor, shape) pair is a
    contiguous CUDA tensor of ``dtype`` on one device with the given shape.'''
    if ref.device.type != 'cuda':
        raise ValueError(f'{name}: expected CUDA tensors, got a tensor on {ref.device}')
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f'{name}: dtype {dtype} is not float32 or float64')
    for key, (t, tshape) in dict(named, x=(ref, shape)).items():
        if t.device != ref.device:
            raise ValueError(f'{name}: {key} is on {t.device}, expected {ref.device}')
        if t.dtype != dtype:
            raise TypeError(f'{name}: {key} has dtype {t.dtype}, expected {dtype}')
        if tuple(t.shape) != tuple(tshape):
            raise ValueError(f'{name}: {key} has shape {tuple(t.shape)}, expected {tuple(tshape)}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: {key} is not contiguous')


def check_flag(name, active, ref):
    """Raise unless ``active`` is None or an int32 tensor beside ``ref``
    whose first element is a loop's active flag (the kernel does nothing
    while it is 0)."""
    if active is not None and (active.device != ref.device or active.dtype != torch.int32
                               or active.numel() < 1 or not active.is_contiguous()):
        raise ValueError(f'{name}: active must be an int32 tensor on {ref.device}')


@functools.lru_cache(maxsize=256)
def _grid_args(shape, ks, periodic, cshape):
    '''ctypes arrays describing a grid (cached: the kernels only read them).'''
    for s in (shape,) if cshape is None else (shape, cshape):
        if not 1 <= len(s) <= 4:
            raise ValueError(f'grid rank {len(s)} is outside 1..4')
        if int(numpy.prod(s, dtype=numpy.int64)) >= 2**31:
            raise ValueError(f'grid {s} has 2^31 points or more: the kernels index in 32 bits')

    def i64x4(vals):
        return _I64x4(*vals, *[1] * (4 - len(vals)))

    def i32x4(vals):
        return _I32x4(*[int(v) for v in vals], *[0] * (4 - len(vals)))
    if cshape is not None:
        return i64x4(shape), i64x4(cshape)
    return i64x4(shape), i32x4(ks), i32x4(periodic)


def launch(fn, ref, tensors, shape, *, ks=None, periodic=None, cshape=None, scalars=()):
    '''Call grid kernel entry point ``fn`` (see :func:`call`): the scalars,
    then the grid description (rank, shape, and either ks/periodic or the
    coarse shape).'''
    grid = _grid_args(tuple(shape), ks and tuple(ks), periodic and tuple(periodic),
                      cshape and tuple(cshape))
    call(fn, ref, tensors, scalars=(*scalars, len(shape), *grid))


def call(fn, ref, tensors, scalars=()):
    '''Call C entry point ``fn`` on PyTorch's current stream: dtype code of
    ``ref``, the tensors' pointers, then the scalars.'''
    lib = library()
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        err = getattr(lib, fn)(0 if ref.dtype == torch.float32 else 1,
                               *[None if t is None else t.data_ptr() for t in tensors], *scalars, stream)
    if err:
        raise RuntimeError(f'{fn}: CUDA error {err}: {lib.ntt_error_string(err).decode()}')
