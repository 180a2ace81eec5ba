'''Global configuration with environment-variable defaults and scoped overrides.

The settings of ``nutils_tpu.utils.config`` that the structured assemble-and-
solve path reads, plus the device the port places its tensors on.
Environment variables use the ``NUTILS_TPU_TORCH_`` prefix.

Key settings:

``floatx``
    Concrete dtype that abstract ``float`` expressions compile to.  Defaults to
    ``float64`` (required for reference-parity regression tests); the bench
    slice sets ``float32``.
``intx``
    Concrete dtype for abstract ``int`` in the host plans; ``int32``, as in
    the JAX package, so host tables stay byte-identical to its.  Index
    tensors are widened to int64 where torch indexing needs them.
``matrix``
    Linear algebra backend: ``auto``/``direct``/``cg``.
``device``
    Torch device of every tensor the package creates (default ``cuda``).  The
    first tensor made on ``cuda`` raises when no card is present; the package
    never moves to the CPU by itself.  Tests select ``cpu`` with
    ``with config.device('cpu'):``.
'''

import contextlib
import os

import numpy


class _Setting:

    def __init__(self, name, default, parse=str):
        self.name = name
        env = os.environ.get('NUTILS_TPU_TORCH_' + name.upper())
        self.value = parse(env) if env is not None else default

    @contextlib.contextmanager
    def __call__(self, value):
        old, self.value = self.value, value
        try:
            yield value
        finally:
            self.value = old


floatx = _Setting('floatx', numpy.float64, numpy.dtype)
intx = _Setting('intx', numpy.int32, numpy.dtype)
matrix = _Setting('matrix', 'auto')
device = _Setting('device', 'cuda')
# Under matrix='auto', systems with at least this many free dofs solve with
# the device Krylov backend; smaller systems use the host direct solver.
device_solve_min = _Setting('device_solve_min', 25000, int)
# Upper bound on elements per assembly chunk: a larger element batch is
# assembled in chunks of the largest divisor of its size not above this
# (System._chunk_plan), so that one chunk's point-level tensors are live at
# a time.
assembly_chunk = _Setting('assembly_chunk', 2**21, int)
# Colon-separated internal sanitizer flags: 'evalf' checks the shape and
# dtype kind of every evaluated node; 'all' enables everything.
debug = _Setting('debug', frozenset(), lambda s: frozenset(s.split(':')) - {''})
# Collapse element-uniform constant tables (identical rows along the element
# axis) to a single broadcast row during constant promotion.
uniform_tables = _Setting('uniform_tables', 1, int)


def debug_enabled(flag):
    d = debug.value
    return flag in d or 'all' in d


def float_dtype():
    return numpy.dtype(floatx.value)


def int_dtype():
    return numpy.dtype(intx.value)


def torch_device():
    '''The configured device as a ``torch.device``; raises for ``cuda`` when
    no card is visible (the package never falls back to the CPU).'''
    import torch
    dev = torch.device(device.value)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("nutils_tpu_torch: config.device is 'cuda' but torch.cuda.is_available() "
                           "is false; select the CPU explicitly with config.device('cpu') or "
                           "NUTILS_TPU_TORCH_DEVICE=cpu")
    return dev


def torch_dtype(dt):
    '''numpy dtype (or abstract float/int/bool) -> torch dtype.'''
    import torch
    if dt is float:
        dt = float_dtype()
    elif dt is int:
        dt = int_dtype()
    elif dt is bool:
        dt = numpy.bool_
    return {numpy.dtype(numpy.float64): torch.float64, numpy.dtype(numpy.float32): torch.float32,
            numpy.dtype(numpy.int64): torch.int64, numpy.dtype(numpy.int32): torch.int32,
            numpy.dtype(numpy.bool_): torch.bool}[numpy.dtype(dt)]
