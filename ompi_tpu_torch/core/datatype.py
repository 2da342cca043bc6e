"""Datatypes: the predefined set over torch dtypes, and derived datatypes
as flat element-index maps.

Behavioral spec from the reference: ``ompi/datatype`` (the predefined
set; constructors contiguous/vector/indexed/indexed_block/subarray/
resized/struct) over the OPAL convertor.

A datatype over one base element type (``base``, a ``torch.dtype``) is
described, as in the JAX package, by a *flat element-index map*:
``indices`` are the positions of the type's ``count`` base elements
within one ``extent``-element window, in serialization order. Pack and
unpack (``core/convertor``) then lower to ``index_select`` /
``index_copy_`` on the last dim of a tensor, or to numpy fancy indexing
on the host. Heterogeneous struct types (mixed base types) are rejected:
a tensor holds one element type. MINLOC/MAXLOC pair types carry
(value, index) as a trailing axis of size 2 in the value dtype.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def coalesce_runs(idx: np.ndarray):
    """Coalesce an element-index array into (offsets, lengths) of runs of
    consecutive indices, preserving order."""
    idx = np.asarray(idx, dtype=np.int64)
    if idx.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    breaks = np.where(np.diff(idx) != 1)[0]
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks, [idx.size - 1]))
    return idx[starts], (ends - starts + 1).astype(np.int64)


def keep_last(idx: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(dst, src) for a scatter of ``packed[..., src]`` to ``dst`` that
    equals numpy's ``out[..., idx] = packed`` when ``idx`` repeats a
    position: the last write to each position wins, and every position
    appears once in ``dst`` (an ``index_copy_`` with repeated indices is
    non-deterministic on CUDA). ``src`` is None when no position repeats:
    then ``dst`` is ``idx`` itself."""
    idx = np.asarray(idx, dtype=np.int64)
    if idx.size < 2 or bool((np.diff(idx) > 0).all()):
        return idx, None
    rev = idx[::-1]
    dst, first = np.unique(rev, return_index=True)
    if dst.size == idx.size:
        return idx, None
    return dst, (idx.size - 1 - first).astype(np.int64)


class Datatype:
    """An MPI datatype.

    Attributes:
      base:     torch dtype of the underlying elements.
      indices:  int64 array of element offsets (in base elements) selected
                by one instance of this type, in serialization order.
      extent:   extent in base elements (stride between consecutive
                instances, MPI_Type_get_extent semantics).
      count:    len(indices) — base elements per instance.
    """

    _uid_counter = itertools.count(1)

    def __init__(self, base: torch.dtype, indices=(0,), extent: int = 1, *,
                 name: str = "", predefined: bool = False,
                 pair: bool = False, lb: int = 0):
        self.base = base
        self.indices = np.asarray(indices, dtype=np.int64)
        self.extent = int(extent)
        self.lb = int(lb)
        self.name = name
        self.predefined = predefined
        self.pair = pair               # MINLOC/MAXLOC pair type
        self._committed = predefined
        # identity for schedule caches (datatypes are immutable once
        # committed; names are not unique)
        self.uid = next(Datatype._uid_counter)
        self._flat_cache: Dict[int, np.ndarray] = {}
        self._scatter_cache: Dict[int, tuple] = {}
        # (kind, count, device) -> index tensor on that device, built once
        self._dev_cache: Dict[tuple, torch.Tensor] = {}

    # -- introspection (MPI_Type_get_extent / MPI_Type_size) ---------------
    @property
    def count(self) -> int:
        return int(self.indices.size)

    def get_size(self) -> int:
        """Size in bytes of the data content (MPI_Type_size)."""
        return self.count * self.base.itemsize

    def get_extent(self) -> Tuple[int, int]:
        """(lb, extent) in base-element units."""
        return (self.lb, self.extent)

    def get_true_extent(self) -> Tuple[int, int]:
        if self.count == 0:
            return (0, 0)
        lo = int(self.indices.min())
        hi = int(self.indices.max()) + 1
        return (lo, hi - lo)

    @property
    def is_contiguous(self) -> bool:
        n = self.count
        return (n == self.extent
                and bool(np.array_equal(self.indices, np.arange(n))))

    def commit(self) -> "Datatype":
        """MPI_Type_commit: finalize the flat index map."""
        self.indices = np.ascontiguousarray(self.indices, dtype=np.int64)
        self._committed = True
        return self

    def free(self) -> None:
        if self.predefined:
            raise ValueError("cannot free a predefined datatype")
        self._committed = False

    # -- constructors (MPI_Type_*) -----------------------------------------
    def _blocks(self, n: int) -> np.ndarray:
        """Element offsets of ``n`` consecutive instances of this type."""
        return (np.arange(n)[:, None] * self.extent
                + self.indices[None, :]).ravel()

    def create_contiguous(self, count: int) -> "Datatype":
        return Datatype(self.base, self._blocks(count), count * self.extent,
                        name=f"contig({count},{self.name})")

    def create_vector(self, count: int, blocklength: int,
                      stride: int) -> "Datatype":
        """count blocks of blocklength instances, stride instances apart."""
        idx = (np.arange(count)[:, None] * (stride * self.extent)
               + self._blocks(blocklength)[None, :]).ravel()
        extent = ((count - 1) * stride + blocklength) * self.extent
        return Datatype(self.base, idx, extent,
                        name=f"vector({count},{blocklength},{stride})")

    def create_indexed(self, blocklengths: Sequence[int],
                       displacements: Sequence[int]) -> "Datatype":
        parts: List[np.ndarray] = [disp * self.extent + self._blocks(bl)
                                   for bl, disp in zip(blocklengths,
                                                       displacements)]
        idx = np.concatenate(parts) if parts else np.empty(0, np.int64)
        extent = max((d + b for d, b in zip(displacements, blocklengths)),
                     default=0) * self.extent
        return Datatype(self.base, idx, extent, name="indexed")

    def create_indexed_block(self, blocklength: int,
                             displacements: Sequence[int]) -> "Datatype":
        return self.create_indexed([blocklength] * len(displacements),
                                   displacements)

    def create_subarray(self, sizes: Sequence[int], subsizes: Sequence[int],
                        starts: Sequence[int], order: str = "C") -> "Datatype":
        """MPI_Type_create_subarray over a C- or F-ordered array."""
        sizes, subsizes, starts = list(sizes), list(subsizes), list(starts)
        if order.upper() == "F":
            sizes, subsizes, starts = sizes[::-1], subsizes[::-1], starts[::-1]
        grids = np.meshgrid(*[np.arange(st, st + ss)
                              for st, ss in zip(starts, subsizes)],
                            indexing="ij")
        flat = np.ravel_multi_index([g.ravel() for g in grids], sizes)
        idx = (flat[:, None] * self.extent + self.indices[None, :]).ravel()
        extent = int(np.prod(sizes)) * self.extent
        return Datatype(self.base, idx, extent, name="subarray")

    def create_resized(self, lb: int, extent: int) -> "Datatype":
        return Datatype(self.base, self.indices.copy(), extent,
                        name=f"resized({self.name})", lb=lb)

    @staticmethod
    def create_struct(blocklengths: Sequence[int],
                      displacements: Sequence[int],
                      types: Sequence["Datatype"]) -> "Datatype":
        """Homogeneous struct (all fields share one base dtype) lowers to
        an indexed layout; a heterogeneous struct raises, as a tensor
        holds one element type — send per-field messages or use a pair
        type instead."""
        if len({t.base for t in types}) != 1:
            raise TypeError(
                "heterogeneous MPI_Type_create_struct is host-only; "
                "decompose into per-field messages for device transfer")
        parts: List[np.ndarray] = [disp + t._blocks(bl) for bl, disp, t in
                                   zip(blocklengths, displacements, types)]
        idx = np.concatenate(parts) if parts else np.empty(0, np.int64)
        extent = max((d + bl * t.extent for d, bl, t in
                      zip(displacements, blocklengths, types)), default=0)
        return Datatype(types[0].base, idx, extent, name="struct")

    # -- index maps ------------------------------------------------------
    def index_range(self) -> Tuple[int, int]:
        """(min, max) of the index map of one instance; cached, as the
        convertor checks every tensor call against it."""
        r = getattr(self, "_range", None)
        if r is None:
            r = self._range = (int(self.indices.min()),
                               int(self.indices.max()))
        return r

    def runs(self):
        """The element-index map coalesced into contiguous runs (offset,
        length); cached."""
        r = getattr(self, "_runs", None)
        if r is None:
            r = self._runs = coalesce_runs(self.indices)
        return r

    def flat_indices(self, count: int) -> np.ndarray:
        """Flat element indices for ``count`` consecutive instances —
        cached per count."""
        got = self._flat_cache.get(count)
        if got is None:
            got = self._blocks(count)
            if len(self._flat_cache) < 64:
                self._flat_cache[count] = got
        return got

    def scatter_indices(self, count: int) -> Tuple[np.ndarray, np.ndarray]:
        """:func:`keep_last` of :meth:`flat_indices` — cached per count."""
        got = self._scatter_cache.get(count)
        if got is None:
            got = keep_last(self.flat_indices(count))
            if len(self._scatter_cache) < 64:
                self._scatter_cache[count] = got
        return got

    def device_indices(self, kind: str, count: int,
                       device: torch.device) -> torch.Tensor:
        """An index map as an int64 tensor on ``device``, copied there
        once and reused by every later call: ``gather`` (the flat
        indices), ``dst`` and ``src`` (the keep-last scatter pair)."""
        key = (kind, count, device)
        t = self._dev_cache.get(key)
        if t is None:
            host = (self.flat_indices(count) if kind == "gather"
                    else self.scatter_indices(count)[kind == "src"])
            t = torch.as_tensor(host, device=device)
            if len(self._dev_cache) < 64:
                self._dev_cache[key] = t
        return t

    def __repr__(self):
        return f"Datatype({self.name or self.base}, count={self.count})"


def _predef(base: torch.dtype, name: str, pair: bool = False) -> Datatype:
    return Datatype(base, name=name, predefined=True, pair=pair)


# Predefined datatypes (ompi/datatype predefined set; names mirror MPI).
FLOAT = _predef(torch.float32, "float")
DOUBLE = _predef(torch.float64, "double")
FLOAT16 = _predef(torch.float16, "float16")
BFLOAT16 = _predef(torch.bfloat16, "bfloat16")
INT = _predef(torch.int32, "int")
LONG = _predef(torch.int64, "long")
SHORT = _predef(torch.int16, "short")
CHAR = _predef(torch.int8, "char")
BYTE = _predef(torch.uint8, "byte")
UNSIGNED = _predef(torch.uint32, "unsigned")
UNSIGNED_LONG = _predef(torch.uint64, "unsigned_long")
INT8_T = _predef(torch.int8, "int8_t")
INT16_T = _predef(torch.int16, "int16_t")
INT32_T = _predef(torch.int32, "int32_t")
INT64_T = _predef(torch.int64, "int64_t")
UINT8_T = _predef(torch.uint8, "uint8_t")
UINT16_T = _predef(torch.uint16, "uint16_t")
UINT32_T = _predef(torch.uint32, "uint32_t")
UINT64_T = _predef(torch.uint64, "uint64_t")
C_BOOL = _predef(torch.bool, "c_bool")
C_FLOAT_COMPLEX = _predef(torch.complex64, "c_float_complex")
C_DOUBLE_COMPLEX = _predef(torch.complex128, "c_double_complex")
FLOAT_INT = _predef(torch.float32, "float_int", pair=True)
DOUBLE_INT = _predef(torch.float64, "double_int", pair=True)
LONG_INT = _predef(torch.int64, "long_int", pair=True)
SHORT_INT = _predef(torch.int16, "short_int", pair=True)
TWOINT = _predef(torch.int32, "2int", pair=True)

_BY_TORCH: dict = {}
for _t in (FLOAT, DOUBLE, FLOAT16, BFLOAT16, INT, LONG, SHORT, CHAR, BYTE,
           UNSIGNED, UNSIGNED_LONG, C_BOOL, C_FLOAT_COMPLEX,
           C_DOUBLE_COMPLEX):
    _BY_TORCH.setdefault(_t.base, _t)

# numpy has no bfloat16; every other predefined base has a numpy twin
_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16, np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64, np.dtype(np.bool_): torch.bool,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}
_TORCH_TO_NP = {t: n for n, t in _NP_TO_TORCH.items()}


def torch_dtype(dt) -> torch.dtype:
    """A torch dtype from a torch dtype, numpy dtype or Datatype."""
    if isinstance(dt, torch.dtype):
        return dt
    if isinstance(dt, Datatype):
        return dt.base
    try:
        return _NP_TO_TORCH[np.dtype(dt)]
    except (KeyError, TypeError):
        raise TypeError(f"no torch dtype for {dt!r}") from None


def numpy_dtype(dt: torch.dtype) -> np.dtype:
    """The numpy twin of a torch dtype (none for bfloat16)."""
    try:
        return _TORCH_TO_NP[dt]
    except KeyError:
        raise TypeError(f"no numpy dtype for {dt}") from None


def from_numpy_dtype(dt) -> Datatype:
    """Map a numpy dtype to the matching predefined Datatype."""
    try:
        return _BY_TORCH[_NP_TO_TORCH[np.dtype(dt)]]
    except KeyError:
        raise TypeError(f"no predefined MPI datatype for {dt}") from None


def from_torch_dtype(dt: torch.dtype) -> Datatype:
    try:
        return _BY_TORCH[dt]
    except KeyError:
        raise TypeError(f"no predefined MPI datatype for {dt}") from None
