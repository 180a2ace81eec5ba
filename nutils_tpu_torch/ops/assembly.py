'''Element contractions of the factored assembly: kernels K11 and K12.

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
fills in place.
'''

import ctypes

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


def elem_matrix(Bt, K, Bs, out=None):
    '''Element blocks ``V[e, i, j] = sum_qab Bt[e,q,a,i] K[e,q,a,b]
    Bs[e,q,b,j]``, kernel K11: ``[E, I, J]``, contiguous, in ``out`` where
    given.  ``K`` is ``[E, Q, A, B]``, ``Bt`` ``[E or 1, Q, A, I]``, ``Bs``
    ``[E or 1, Q, B, J]``, any strides.  One thread block stages an
    element's slices in shared memory and each thread sums its outputs over
    ``q, a, b`` in a fixed order: no atomics, bitwise reproducible.'''
    if K.device.type == 'cpu':
        return elem_matrix_plain(Bt, K, Bs, out)
    E, Q, A, B = K.shape
    I, J = Bt.shape[-1], Bs.shape[-1]
    _check('elem_matrix', K, Bt=(Bt, (None, Q, A, I)), Bs=(Bs, (None, Q, B, J)))
    out = _output('elem_matrix', K, (E, I, J), out)
    strides = (ctypes.c_int64 * 12)(*_strides(Bt, E), *_strides(K, E), *_strides(Bs, E))
    _kernels.call('ntt_elem_matrix', K, [Bt, K, Bs, out], scalars=(E, Q, A, B, I, J, strides))
    elem_matrix.launches += 1
    return out


def elem_vector(Bt, g, out=None):
    '''Element vectors ``r[e, i] = sum_qa Bt[e,q,a,i] g[e,q,a]``, kernel
    K12: ``[E, I]``, contiguous, in ``out`` where given.  ``g`` is ``[E, Q,
    A]``, ``Bt`` ``[E or 1, Q, A, I]``, any strides.  One thread an output,
    summing over ``q, a`` in a fixed order.'''
    if g.device.type == 'cpu':
        return elem_vector_plain(Bt, g, out)
    E, Q, A = g.shape
    I = Bt.shape[-1]
    _check('elem_vector', g, Bt=(Bt, (None, Q, A, I)))
    out = _output('elem_vector', g, (E, I), out)
    strides = (ctypes.c_int64 * 7)(*_strides(Bt, E), *_strides(g, E))
    _kernels.call('ntt_elem_vector', g, [Bt, g, out], scalars=(E, Q, A, I, strides))
    elem_vector.launches += 1
    return out


_kernels.counted(elem_matrix)
_kernels.counted(elem_vector)
