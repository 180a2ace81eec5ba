'''nutils_tpu_torch — the structured assemble-and-solve path of nutils_tpu on
PyTorch and CUDA.

The same lazy expression IR and host planning as ``nutils_tpu`` (owned
copies, so the package never imports jax), evaluated eagerly on torch
tensors, with hand-written Hopper kernels for the device operators of the
structured Laplace solve:

  L0 utils/      config (floatx, intx, matrix, device), numeric helpers, logging
  L1 evaluable   batched expression IR -> eager torch evaluation (torch.func AD)
  L2 element     reference square, Gauss quadrature
  L3 topology    structured topology, mesh, sample, function
  L4 matrix      stencil-form matrix, multigrid-preconditioned refined CG
  L5 solver      System: localized-AD assembly straight into stencil weights
  ops/           stencil matvec, multigrid cycle, CG and the other Krylov
                 solvers; their kernels in csrc/ (CUDA, built by _kernels.py)
'''

__version__ = '0.1.0'
version = __version__

import torch as _torch

# FEM regression tolerances need full float32 products in every contraction:
# TF32 keeps about three decimal digits, which corrupts assembled stencil
# weights the same way reduced-precision matmuls do (nutils_tpu/__init__.py).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision('highest')

from .utils import config, numeric  # noqa: E402
from .utils import _log as log  # noqa: E402
