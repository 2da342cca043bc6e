"""Predefined datatypes mapped to torch dtypes.

Behavioral spec from the reference: ``ompi/datatype``'s predefined set.
Every predefined type names one element type (``base``, a
``torch.dtype``); a rank's buffer is a tensor of that dtype, so the
datatype's job is the MPI name and the numpy mapping. MINLOC/MAXLOC pair
types carry (value, index) as a trailing axis of size 2 in the value
dtype. Derived datatypes (vector, indexed, struct, subarray) and the
convertor wait for a later slice of the port.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class Datatype:
    """A predefined MPI datatype over one torch element type."""

    def __init__(self, base: torch.dtype, *, name: str = "",
                 predefined: bool = False, pair: bool = False):
        self.base = base
        self.name = name
        self.predefined = predefined
        self.pair = pair               # MINLOC/MAXLOC pair type

    @property
    def count(self) -> int:
        return 2 if self.pair else 1

    def get_size(self) -> int:
        """Size in bytes of the data content (MPI_Type_size)."""
        return self.count * self.base.itemsize

    def get_extent(self) -> Tuple[int, int]:
        """(lb, extent) in base-element units."""
        return (0, self.count)

    def free(self) -> None:
        if self.predefined:
            raise ValueError("cannot free a predefined datatype")

    def __repr__(self):
        return f"Datatype({self.name or self.base})"


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
