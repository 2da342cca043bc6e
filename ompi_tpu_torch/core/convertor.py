"""Convertor — pack/unpack between user datatype layouts and the wire
(contiguous) representation.

Behavioral spec: ``opal/datatype/opal_convertor.c`` (pack/unpack engines,
resumable positioning); the JAX package's ``core/convertor.py``. A
derived layout is a flat element-index map (``core/datatype``), so pack
is a gather and unpack a scatter on the last dim:

- a tensor packs with ``index_select`` and unpacks with ``index_copy_``
  on its own device, from index tensors the datatype copied there once;
  nothing moves through the host;
- a numpy array packs and unpacks with fancy indexing.

Unpack of a type whose instances overlap (a resized extent below the
true extent, an indexed map that repeats a position) writes each
position once, from the last element numpy's fancy assignment would
write there (``datatype.keep_last``): ``index_copy_`` with repeated
indices is non-deterministic on CUDA.

``mpi_pack``/``mpi_unpack`` (MPI_Pack with an explicit byte position)
and ``pack_external``/``unpack_external`` (the big-endian external32
representation, MPI-3.1 §13.5.2) run on the host through numpy: torch
has no big-endian dtype.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ompi_tpu_torch.accelerator import to_numpy
from ompi_tpu_torch.core.datatype import Datatype, numpy_dtype
# torch has no index_copy_ for its unsigned types wider than a byte; the
# copy moves bits, so it runs on the signed type of the same width
from ompi_tpu_torch.core.op import SIGNED_TWIN as _SIGNED_TWIN


def _bits_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a view of its bits as the signed type of the same
    width when torch cannot index-copy its dtype."""
    twin = _SIGNED_TWIN.get(t.dtype)
    return t if twin is None else t.view(twin)


def _need(datatype: Optional[Datatype], count: int) -> int:
    return count * (datatype.count if datatype is not None else 1)


def _check_span(length: int, datatype: Datatype, count: int) -> None:
    """A tensor's index past its last axis raises here, on the host: on
    a CUDA tensor it would be a device-side assert."""
    if count == 0 or datatype.count == 0:
        return
    last = (count - 1) * datatype.extent
    lo, hi = datatype.index_range()
    lo, hi = lo + min(0, last), hi + max(0, last)
    if lo < 0 or hi >= length:
        raise IndexError(f"{count} instances of {datatype} need elements "
                         f"{lo}..{hi} on the last axis; it has {length}")


def pack(buf, datatype: Optional[Datatype], count: int):
    """Pack ``count`` instances of ``datatype`` from ``buf`` (…, extent*count
    flat elements on the last axis) into a contiguous (…, count*dt.count)
    array. Contiguous types return views/slices — no copy is forced."""
    if datatype is None or datatype.is_contiguous:
        need = _need(datatype, count)
        if buf.shape[-1] == need:
            return buf
        return buf[..., :need]
    if isinstance(buf, torch.Tensor):
        _check_span(buf.shape[-1], datatype, count)
        return buf.index_select(
            -1, datatype.device_indices("gather", count, buf.device))
    return np.ascontiguousarray(np.asarray(buf)[...,
                                                datatype.flat_indices(count)])


def unpack(out_buf, packed, datatype: Optional[Datatype], count: int):
    """Scatter packed contiguous data back into ``out_buf`` at the
    datatype's element positions, in place; returns ``out_buf``. Elements
    outside the map (the holes) are left as they were."""
    if datatype is None or datatype.is_contiguous:
        need = _need(datatype, count)
        if out_buf is None or out_buf.shape[-1] == need:
            return packed
        out_buf[..., :need] = packed
        return out_buf
    if out_buf is None:
        raise ValueError("unpack of a non-contiguous datatype needs an "
                         "output buffer (extent holes are preserved)")
    if isinstance(out_buf, torch.Tensor):
        _check_span(out_buf.shape[-1], datatype, count)
        out = _bits_view(out_buf)
        packed = _bits_view(packed.to(out_buf.dtype))
        if datatype.scatter_indices(count)[1] is None:
            idx = datatype.device_indices("gather", count, out_buf.device)
            out.index_copy_(-1, idx, packed)
        else:
            dst = datatype.device_indices("dst", count, out_buf.device)
            src = datatype.device_indices("src", count, out_buf.device)
            out.index_copy_(-1, dst, packed.index_select(-1, src))
        return out_buf
    out_buf[..., datatype.flat_indices(count)] = packed
    return out_buf


# ---------------------------------------------------------------------------
# MPI_Pack / MPI_Unpack with explicit position, and the external32
# canonical representation (MPI_Pack_external). Behavioral spec:
# ``ompi/datatype/ompi_datatype_pack_external.c`` and the convertor's
# resumable positioning (``opal_datatype_fake_stack.c``).
# ---------------------------------------------------------------------------

def _host(a) -> np.ndarray:
    """A contiguous host copy; bfloat16 travels as its int16 bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return np.ascontiguousarray(to_numpy(a))
    return np.ascontiguousarray(np.asarray(a))


def _np_elem(dt) -> np.dtype:
    return np.dtype(np.int16) if dt == torch.bfloat16 else numpy_dtype(dt)


def _base_dtype(datatype: Optional[Datatype], out_buf) -> np.dtype:
    """Host element dtype for the raw-byte APIs: the datatype's base,
    else the output buffer's dtype (datatype=None means "typed raw
    elements" of whatever the destination holds), else bytes."""
    if datatype is not None:
        return _np_elem(datatype.base)
    if isinstance(out_buf, torch.Tensor):
        return _np_elem(out_buf.dtype)
    if out_buf is not None and hasattr(out_buf, "dtype"):
        return np.dtype(out_buf.dtype)
    return np.dtype(np.uint8)


def _into(out_buf, packed: np.ndarray, datatype, count: int):
    """Unpack host elements into ``out_buf`` (a tensor gets them on its
    own device) — or return them when there is no buffer."""
    if isinstance(out_buf, torch.Tensor):
        t = torch.from_numpy(packed)
        if out_buf.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        packed = t.to(out_buf.device)
    return unpack(out_buf, packed, datatype, count)


def pack_size(datatype: Optional[Datatype], count: int,
              dtype=None) -> int:
    """MPI_Pack_size: bytes needed to pack ``count`` instances. With
    ``datatype=None`` the element width comes from ``dtype`` (the
    buffer's numpy or torch dtype), defaulting to raw bytes."""
    if datatype is None:
        if dtype is None:
            return count
        if isinstance(dtype, torch.dtype):
            return count * dtype.itemsize
        return count * np.dtype(dtype).itemsize
    return count * datatype.get_size()


def mpi_pack(buf, datatype: Optional[Datatype], count: int,
             outbuf: bytearray, position: int) -> int:
    """MPI_Pack: append ``count`` instances of ``datatype`` from ``buf``
    into ``outbuf`` at byte offset ``position``; returns the new
    position. Successive calls with the returned position concatenate
    (the reference convertor's resumable-positioning contract)."""
    raw = _host(pack(buf, datatype, count)).tobytes()
    end = position + len(raw)
    if len(outbuf) < end:
        outbuf.extend(b"\0" * (end - len(outbuf)))
    outbuf[position:end] = raw
    return end


def mpi_unpack(inbuf, position: int, out_buf, datatype: Optional[Datatype],
               count: int):
    """MPI_Unpack: read ``count`` instances from ``inbuf`` at byte offset
    ``position`` into ``out_buf``; returns (out, new_position)."""
    base = _base_dtype(datatype, out_buf)
    n = _need(datatype, count)
    raw = bytes(inbuf[position:position + n * base.itemsize])
    packed = np.frombuffer(raw, dtype=base).copy()
    if out_buf is not None and hasattr(out_buf, "shape"):
        packed = packed.reshape(tuple(out_buf.shape[:-1]) + (n,))
    return (_into(out_buf, packed, datatype, count),
            position + n * base.itemsize)


def pack_external(datatype: Optional[Datatype], buf, count: int) -> bytes:
    """MPI_Pack_external("external32"): canonical big-endian fixed-size
    representation, portable across architectures."""
    packed = _host(pack(buf, datatype, count))
    return packed.astype(packed.dtype.newbyteorder(">"), copy=False).tobytes()


def unpack_external(datatype: Optional[Datatype], data: bytes, count: int,
                    out_buf=None):
    """MPI_Unpack_external: decode external32 bytes back to native
    layout (scattering into ``out_buf`` for non-contiguous types)."""
    base = _base_dtype(datatype, out_buf)
    n = _need(datatype, count)
    packed = np.frombuffer(data, dtype=base.newbyteorder(">"),
                           count=n).astype(base)
    if out_buf is not None and hasattr(out_buf, "shape"):
        packed = packed.reshape(tuple(out_buf.shape[:-1]) + (n,))
    return _into(out_buf, packed, datatype, count)
