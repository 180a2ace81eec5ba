'''The device state buffers of the GMRES (K6, ``ops/gmres.py``) and
BiCGStab (K10, ``ops/bicgstab.py``) loops: their tilings of the vectors
(``csrc/krylov.cuh``), their start, their one read, and the host view the
plain versions take of them.'''

import contextlib

import numpy
import torch

THREADS = 256  # csrc/krylov.cuh: threads a block
VPT = 4  # 16-byte chunks a thread holds of each vector in a tile


def tiles(n, dtype):
    '''Blocks of every launch over vectors of ``n`` entries of ``dtype``:
    the tiles of ``THREADS * VPT`` 16-byte chunks that cover them.'''
    per = THREADS * VPT * (16 // torch.empty((), dtype=dtype).element_size())
    return -(-int(n) // per)


ROW_TILE = 1024  # csrc/krylov.cuh: elements a block of K6's row kernels takes


def row_tiles(n):
    '''Blocks of K6's row kernels (the projection, the update and the
    combination) over vectors of ``n`` entries.'''
    return -(-int(n) // ROW_TILE)


def numpy_dtype(dtype):
    return numpy.float32 if dtype == torch.float32 else numpy.float64


def reset(st, head, floats, ints):
    '''Write the state's first ``head`` slots: every slot 0 but the float64
    slots ``floats`` and the int32 slots ``ints`` ({slot: value}).  A copy to
    the device (from pinned memory on the card), no read.'''
    h = numpy.zeros(head)
    for slot, value in floats.items():
        h[slot] = value
    iv = h.view(numpy.int32)
    for slot, value in ints.items():
        iv[slot] = value
    src = torch.from_numpy(h)
    if st.device.type == 'cuda':
        st[:head].copy_(src.pin_memory(), non_blocking=True)
    else:
        st[:head].copy_(src)


def read(st, head):
    '''One read of the state's first ``head`` slots, a float64 numpy array
    (its int32 view holds the int slots); from the card through pinned
    memory.'''
    if st.device.type == 'cuda':
        h = torch.empty(head, dtype=torch.float64, pin_memory=True)
        h.copy_(st[:head], non_blocking=True)
        torch.cuda.current_stream(st.device).synchronize()
        return h.numpy()
    return st[:head].numpy().copy()


@contextlib.contextmanager
def host(st):
    '''The whole state as a numpy array for a plain version: a view on the
    CPU; on the card a copy, written back on exit.'''
    if st.device.type == 'cpu':
        yield st.numpy()
        return
    s = st.cpu().numpy()
    yield s
    st.copy_(torch.from_numpy(s).to(st.device))


def dot(a, b):
    '''``a . b`` summed in float64 and rounded to the working dtype, as the
    kernels sum (a 0-d tensor of the working dtype).'''
    return torch.dot(a.double(), b.double()).to(a.dtype)
