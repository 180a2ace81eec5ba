'''Block Jacobi: the host set-up of the inverted diagonal blocks and their
apply on the device, kernel K13 (``csrc/block_jacobi.cu``).

Replaces ``nutils_tpu.ops.sparse.block_jacobi_inverse`` (the set-up,
``sparse.py:225``) and ``_apply_block`` (``sparse.py:122``), the
preconditioner that ``Matrix.getprecon('block', blocksize=bs)`` builds and
every Krylov loop applies under ``precon='block'``.  With ``bs`` the number
of a vector field's components (their grid keeps the component axis last,
so dof = bs node + component), the blocks are the nodal blocks of point-
block Jacobi.
'''

import numpy
import torch

from .. import _kernels

# K13 takes blocks of 1 to MAX_BS rows (the kernel's own instances: 1, 2, 4
# and 8, and one loop for the sizes between)
MAX_BS = 8


def block_jacobi_inverse(data, indices, indptr, n, blocksize):
    '''Host: the dense diagonal blocks of the CSR matrix (data, indices,
    indptr) of ``n`` rows, inverted: an ``[nb, bs, bs]`` array of ``data``'s
    dtype, ``nb = ceil(n / bs)``, whose rows and columns past ``n`` are the
    identity's, so the apply is a batched product.  The same values as the
    JAX package's loop over blocks: the entries of each block are added
    into a zero block (no entry, a zero), the whole stack is inverted by
    one ``numpy.linalg.inv`` (LAPACK inverts each matrix of a stack as it
    inverts one alone), and only where a block is singular does it go
    block by block, a singular block falling back to its inverse diagonal
    (zero diagonals taken as 1).'''
    bs = int(blocksize)
    if bs < 1:
        raise ValueError(f'block size {bs} is not positive')
    n = int(n)
    nb = -(-n // bs)
    data = numpy.asarray(data)
    indices = numpy.asarray(indices, dtype=numpy.int64)
    rows = numpy.repeat(numpy.arange(n, dtype=numpy.int64), numpy.diff(numpy.asarray(indptr)))
    inblock = rows // bs == indices // bs
    r, c = rows[inblock], indices[inblock]
    blocks = numpy.zeros((nb, bs, bs), dtype=data.dtype)
    numpy.add.at(blocks.reshape(-1), r * bs + c % bs, data[inblock])
    pad = numpy.arange(n, nb * bs)
    blocks.reshape(-1)[pad * bs + pad % bs] = 1
    try:
        return numpy.linalg.inv(blocks)
    except numpy.linalg.LinAlgError:
        pass
    out = numpy.empty_like(blocks)
    for b in range(nb):
        try:
            out[b] = numpy.linalg.inv(blocks[b])
        except numpy.linalg.LinAlgError:
            d = numpy.diag(blocks[b]).copy()
            d[d == 0] = 1.0
            out[b] = numpy.diag(1.0 / d)
    return out


def block_apply_plain(minv, r):
    '''Plain torch version of :func:`block_apply`: ``r`` padded with zeros
    to ``nb * bs``, ``einsum('bij,bj->bi')``, cut to ``n``.'''
    nb, bs, _ = minv.shape
    n = r.shape[0]
    rp = torch.nn.functional.pad(r, (0, nb * bs - n))
    return torch.einsum('bij,bj->bi', minv, rp.reshape(nb, bs)).reshape(-1)[:n]


def block_apply(minv, r, active=None, out=None):
    '''``z = M r`` for the inverted diagonal blocks ``minv`` ``[nb, bs, bs]``
    (:func:`block_jacobi_inverse`, on ``r``'s device) and a vector ``r`` of
    ``n <= nb bs`` values, kernel K13 (``csrc/block_jacobi.cu``):
    ``z[i] = sum_j minv[i // bs, i % bs, j] r[(i // bs) bs + j]`` over the
    ``j`` with ``(i // bs) bs + j < n``, in the order of ``j``.  ``z`` goes
    into ``out`` where given; it is left unwritten while the int32 flag
    ``active`` (the CG loop's, ``ops/cg.py``) is 0.  Tensors on the CPU
    take :func:`block_apply_plain`; a CUDA tensor launches the kernel or
    raises.'''
    if r.device.type == 'cpu':
        z = block_apply_plain(minv, r)
        return z if out is None else out.copy_(z)
    if minv.dim() != 3 or minv.shape[1] != minv.shape[2] or not 1 <= minv.shape[1] <= MAX_BS:
        raise ValueError(f'block_apply: minv must be [nb, bs, bs] with bs in 1..{MAX_BS}, got {tuple(minv.shape)}')
    nb, bs, _ = minv.shape
    n = int(r.shape[0])
    if n > nb * bs or n >= 2**31:
        raise ValueError(f'block_apply: {n} rows do not fit {nb} blocks of {bs}, or pass 2^31')
    z = torch.empty_like(r) if out is None else out
    _kernels.check_operands('block_apply', r, (n,), r.dtype, minv=(minv, (nb, bs, bs)), out=(z, (n,)))
    _kernels.check_flag('block_apply', active, r)
    _kernels.call('ntt_block_apply', r, [minv, r, z, active], scalars=(n, bs))
    block_apply.launches += 1
    return z


_kernels.counted(block_apply)
