"""Native (C++) host components, loaded with ctypes.

The shared library is built from the repository's ``native/*.cpp`` with
g++ on first use, into ``ompi_tpu_torch/_build/`` (``loader``). Each
native path declines (returns False or None) when the library is
unavailable or the operands are not its kind, and its caller runs its
torch or numpy route. Components:

- ``convertor.cpp`` — run-coalesced pack/unpack of host buffers
  (``core/convertor``);
- ``ops.cpp``       — host reduction kernels over ten dtypes, the
  unsigned ones included (``core/op.reduce_local``, ``core/rankcomm``'s
  host fold, ``coll/basic``);
- ``memheap.cpp``   — the buddy allocator of the symmetric heap;
- ``matching.cpp``  — the stacked pt2pt matching core (``pml/stacked``);
- ``containers.cpp`` — lock-free fifo/lifo, ring, hotel, bitmap and
  pointer array (``native/containers``).

The kernels read host memory only: a CUDA tensor's pointer handed to
them would be a segfault, not an error, so only numpy arrays and CPU
tensors are accepted.
"""
from __future__ import annotations

import numpy as _np
import torch as _torch

from ompi_tpu_torch.native.loader import (build_error, get_lib,  # noqa: F401
                                          native_available)

# (op name -> id) and (dtype -> id) tables mirroring ops.cpp's enums
_OP_IDS = {"sum": 0, "prod": 1, "max": 2, "min": 3, "band": 4, "bor": 5,
           "bxor": 6, "land": 7, "lor": 8, "lxor": 9}
_DT_IDS = {_np.dtype(k): v for k, v in {
    _np.int8: 0, _np.int16: 1, _np.int32: 2, _np.int64: 3,
    _np.uint8: 4, _np.uint16: 5, _np.uint32: 6, _np.uint64: 7,
    _np.float32: 8, _np.float64: 9}.items()}
_TORCH_DT_IDS = {
    _torch.int8: 0, _torch.int16: 1, _torch.int32: 2, _torch.int64: 3,
    _torch.uint8: 4, _torch.uint16: 5, _torch.uint32: 6, _torch.uint64: 7,
    _torch.float32: 8, _torch.float64: 9}


def _operands(inbuf, inout):
    """``(dtype id, in pointer, inout pointer, n, keepalive)`` when the
    pair is native-eligible: two numpy arrays, or two CPU tensors, of one
    dtype and shape, ``inout`` C-contiguous and writable. None
    otherwise."""
    if isinstance(inbuf, _np.ndarray) and isinstance(inout, _np.ndarray):
        if not (inbuf.dtype == inout.dtype and inbuf.shape == inout.shape
                and inout.flags["C_CONTIGUOUS"]
                and inout.flags["WRITEABLE"]):
            return None
        dt = _DT_IDS.get(inbuf.dtype)
        if dt is None:
            return None
        a = _np.ascontiguousarray(inbuf)
        return dt, a.ctypes.data, inout.ctypes.data, a.size, a
    if isinstance(inbuf, _torch.Tensor) and isinstance(inout, _torch.Tensor):
        if not (inbuf.device.type == "cpu" and inout.device.type == "cpu"
                and inbuf.dtype == inout.dtype
                and inbuf.shape == inout.shape
                and inout.is_contiguous() and not inout.requires_grad):
            return None
        dt = _TORCH_DT_IDS.get(inbuf.dtype)
        if dt is None:
            return None
        a = inbuf.detach().contiguous()
        return dt, a.data_ptr(), inout.data_ptr(), a.numel(), a
    return None


def native_reduce_into(op_name: str, inbuf, inout) -> bool:
    """In place ``inout = inbuf OP inout`` through the C++ kernel table.
    Returns False, and leaves ``inout`` alone, when the (op, dtype,
    layout, device) is not native; the caller then runs its own route."""
    lib = get_lib()
    op_id = _OP_IDS.get(op_name)
    if lib is None or op_id is None:
        return False
    ops = _operands(inbuf, inout)
    if ops is None:
        return False
    dt, a_ptr, b_ptr, n, _keep = ops
    return lib.ompi_tpu_reduce_local(op_id, dt, a_ptr, b_ptr, n) == 0


def native_reduce_local(op_name: str, inbuf, inout):
    """Functional variant: the combined array or tensor (``inout`` is
    left alone), or None when not native."""
    if get_lib() is None or _OP_IDS.get(op_name) is None:
        return None
    if isinstance(inout, _np.ndarray):
        out = _np.ascontiguousarray(inout).copy()
    elif isinstance(inout, _torch.Tensor) and inout.device.type == "cpu":
        out = inout.detach().clone(memory_format=_torch.contiguous_format)
    else:
        return None
    return out if native_reduce_into(op_name, inbuf, out) else None
