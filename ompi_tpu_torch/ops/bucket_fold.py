"""Bucket fold — one bucket flush's allreduce in one pass, as a
hand-written CUDA kernel.

A bucket flush on a stacked comm whose rows all sit in this process
(``coll/persistent.BucketFuser``) holds members ``x_i`` of shape
``(n, w_i)``, one row per rank. The fold reads every member's rows in
place and writes their reduction, in rank order, into each of the n rank
rows of one flat output of ``n * total`` elements (``total = sum w_i``),
where member i occupies ``[n*off_i, n*(off_i + w_i))`` as a contiguous
``(n, w_i)`` block, ``off_i`` the sum of the widths before it. So each
member's result is a view of the output, with no copy.

The kernel (``csrc/bucket_fold.cu``) replaces no TPU kernel: it was added
for this flush, which packed, reduced, expanded and unpacked the bucket
in four passes. Its bound is bytes, ``2 * n * total * itemsize``
(``fold_bytes``): each input element read once, each output element
written once.

This module owns:

- ``fold_plain`` — the plain torch version, in the same rank order and
  accumulation type, into the same layout: the CPU path and the oracle
  the kernel is held against.
- ``Table`` — a bucket's layout (each member's width and offset) and, on
  a CUDA device, the kernel's table on the device: built once per bucket
  shape by its caller, which keys it by the members' pointers and widths.
- ``fold`` — the public entry. On CUDA tensors it launches the kernel or
  raises; on CPU tensors it runs ``fold_plain``.
- ``launches`` — how many times the kernel was launched.

Ops: predefined SUM, MAX and MIN (``takes``); MAX and MIN give NaN where
any row holds one. Dtypes: float32, bfloat16 and float16 accumulate in
float32 and round once; float64 in float64.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from ompi_tpu_torch.ops import _build

OPS = {"sum": 0, "max": 1, "min": 2}
DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
          torch.float16: 3}
_ENTRY = 4          # int64 words per member in the kernel's table

launches = 0        # kernel launches, counted where the kernel launches


def takes(dtype, op) -> bool:
    """Whether the fold computes ``op`` on ``dtype``: a predefined SUM,
    MAX or MIN (a user op may reuse a predefined name) on a float dtype
    of ``DTYPES``."""
    return (dtype in DTYPES and getattr(op, "predefined", False)
            and getattr(op, "name", None) in OPS)


def fold_bytes(n: int, total: int, itemsize: int) -> int:
    """The least bytes one fold moves: every element of the n rank rows
    read once and written once."""
    return 2 * n * total * itemsize


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def fold_plain(parts: Sequence[torch.Tensor], op_name: str,
               out: torch.Tensor) -> torch.Tensor:
    """Reduce each ``(n, w_i)`` part over its rows in rank order, in the
    accumulation type, and write the result, rounded once, into all n
    rows of its block of the flat ``out``. Returns ``out``."""
    combine = {"sum": torch.add, "max": torch.maximum,
               "min": torch.minimum}[op_name]
    acc_dt = _acc_dtype(out.dtype)
    off = 0
    for p in parts:
        n, w = p.shape
        acc = p[0].to(acc_dt)
        for r in range(1, n):
            acc = combine(acc, p[r].to(acc_dt))
        out[n * off:n * (off + w)].view(n, w).copy_(
            acc.to(out.dtype).expand(n, w))
        off += w
    return out


def _kernel() -> ctypes.CDLL:
    lib = _build.load("bucket_fold")
    fn = lib.bucket_fold
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        cols = lib.bucket_fold_block_columns
        cols.argtypes = [ctypes.c_int]
        cols.restype = ctypes.c_int
    return lib


class Table:
    """One bucket's layout: ``n`` rank rows, ``widths`` and ``offsets``
    (per-rank columns) of its members, ``total`` columns, its ``dtype``
    and ``op``. On a CUDA device it also holds the kernel's table on the
    device (per member: source pointer, width, output offset ``n*off_i``,
    first block; then the block -> member map) and the block count. The
    device table names the parts' pointers: it serves only parts at the
    same addresses, with the same widths."""

    __slots__ = ("n", "widths", "offsets", "sizes", "total", "dtype", "op",
                 "ptrs", "blocks", "dev")

    def __init__(self, parts: Sequence[torch.Tensor], op_name: str):
        p0 = parts[0]
        self.n = int(p0.shape[0])
        self.dtype = p0.dtype
        self.op = op_name
        self.widths: List[int] = [int(p.shape[1]) for p in parts]
        self.offsets: List[int] = np.concatenate(
            ([0], np.cumsum(self.widths[:-1], dtype=np.int64))).tolist()
        self.sizes: List[int] = [self.n * w for w in self.widths]
        self.total = int(sum(self.widths))
        self.ptrs: List[int] = [p.data_ptr() for p in parts]
        self.blocks = 0
        self.dev = None
        if p0.is_cuda:
            cols = _kernel().bucket_fold_block_columns(p0.element_size())
            per = [-(-w // cols) for w in self.widths]
            first = np.concatenate(([0], np.cumsum(per[:-1], dtype=np.int64)))
            ent = np.stack([np.array(self.ptrs, np.int64),
                            np.array(self.widths, np.int64),
                            self.n * np.array(self.offsets, np.int64),
                            first], axis=1)
            self.blocks = int(sum(per))
            raw = np.empty(ent.size * 8 + self.blocks * 4, np.uint8)
            raw[:ent.size * 8].view(np.int64)[:] = ent.reshape(-1)
            raw[ent.size * 8:].view(np.int32)[:] = np.repeat(
                np.arange(len(parts), dtype=np.int32), per)
            self.dev = torch.from_numpy(raw).to(p0.device)

    def views(self, out: torch.Tensor) -> List[torch.Tensor]:
        """Each member's result: its block of ``out``, a contiguous flat
        view of its n rank rows of ``w_i`` in rank order."""
        return list(out.split_with_sizes(self.sizes))


def _check(parts, table: Table, out) -> None:
    """What the kernel takes; raises on anything else: ``out`` a
    contiguous, 16-byte aligned tensor of the table's dtype and size, each
    part the contiguous ``(n, w_i)`` tensor of the table's dtype at the
    address the table names, all on ``out``'s card."""
    dev, n = out.device, table.n
    if (out.dtype != table.dtype or not out.is_contiguous()
            or out.numel() != n * table.total or out.data_ptr() % 16):
        raise ValueError(f"bucket_fold: out must be a contiguous, 16-byte "
                         f"aligned {table.dtype} tensor of "
                         f"{n * table.total} elements")
    if table.dev is None or table.dev.device != dev:
        raise ValueError(f"bucket_fold: the table has no device table on "
                         f"{dev}")
    if [p.data_ptr() for p in parts] != table.ptrs or not all(
            p.is_contiguous() and p.dtype == table.dtype and p.device == dev
            and p.shape == (n, w) for p, w in zip(parts, table.widths)):
        raise ValueError(f"bucket_fold: each part must be a contiguous "
                         f"({n}, w) {table.dtype} tensor on {dev} at the "
                         f"address its table names")


def _launch(parts, table: Table, out) -> torch.Tensor:
    global launches
    _check(parts, table, out)
    lib = _kernel()
    base = table.dev.data_ptr()
    idx = out.get_device()
    args = (base, base + 8 * _ENTRY * len(parts), out.data_ptr(),
            table.blocks, table.n, DTYPES[table.dtype], OPS[table.op],
            # the current stream's handle, without a Stream object
            torch._C._cuda_getCurrentRawStream(idx))
    if torch.cuda.current_device() == idx:
        rc = lib.bucket_fold(*args)
    else:
        with torch.cuda.device(idx):
            rc = lib.bucket_fold(*args)
    if rc != 0:
        raise RuntimeError(f"bucket_fold kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return out


def fold(parts: Sequence[torch.Tensor], table: Table,
         out: torch.Tensor) -> torch.Tensor:
    """The allreduce of a bucket's members into ``out`` (flat, ``n *
    total`` elements, laid out as ``Table.views``). CPU tensors take the
    plain fold; CUDA tensors take the kernel, which raises on what it
    does not take — there is no fallback. Returns ``out``."""
    if out.device.type == "cpu" and all(p.device.type == "cpu"
                                        for p in parts):
        return fold_plain(parts, table.op, out)
    return _launch(parts, table, out)
