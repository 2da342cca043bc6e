"""Pythonic handles over the native container library (opal/class role).

Each class wraps one handle from ``native/containers.cpp``. The FIFO and
LIFO are genuinely lock-free (Vyukov MPMC queue; Treiber stack with ABA
tags) and safe to drive from multiple Python threads — ctypes releases
the GIL around calls, so the thread-stress tests exercise real
concurrency, mirroring ``test/class/opal_fifo.c`` / ``opal_lifo.c``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

from ompi_tpu_torch.native.loader import get_lib


def available() -> bool:
    return get_lib() is not None


class _Native:
    kind = ""

    def __init__(self, capacity: int = 1024):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = getattr(lib, f"ompi_tpu_{self.kind}_create")(capacity)

    def close(self) -> None:
        if self._h:
            getattr(self._lib, f"ompi_tpu_{self.kind}_destroy")(self._h)
            self._h = 0

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Queue(_Native):
    def push(self, value: int) -> bool:
        return bool(getattr(self._lib,
                            f"ompi_tpu_{self.kind}_push")(self._h, value))

    def pop(self) -> Optional[int]:
        out = ctypes.c_int64()
        ok = getattr(self._lib, f"ompi_tpu_{self.kind}_pop")(
            self._h, ctypes.byref(out))
        return int(out.value) if ok else None


class Fifo(_Queue):
    """Lock-free bounded MPMC FIFO (opal_fifo)."""
    kind = "fifo"


class Lifo(_Queue):
    """Lock-free LIFO / free-list (opal_lifo)."""
    kind = "lifo"


class RingBuffer(_Queue):
    """Fixed-capacity ring buffer (opal_ring_buffer)."""
    kind = "ring"


class Hotel(_Native):
    """Timeout manager (opal_hotel): occupants check into rooms with a
    deadline; expired occupants are evicted one at a time."""
    kind = "hotel"

    def checkin(self, occupant: int, deadline: int) -> int:
        """Returns the room number, or -1 when the hotel is full."""
        return int(self._lib.ompi_tpu_hotel_checkin(self._h, occupant,
                                                    deadline))

    def checkout(self, room: int) -> Optional[int]:
        out = ctypes.c_int64()
        ok = self._lib.ompi_tpu_hotel_checkout(self._h, room,
                                               ctypes.byref(out))
        return int(out.value) if ok else None

    def evict_one(self, now: int) -> Optional[Tuple[int, int]]:
        """Evict one occupant whose deadline has passed; returns
        (room, occupant) or None."""
        out = ctypes.c_int64()
        room = self._lib.ompi_tpu_hotel_evict_one(self._h, now,
                                                  ctypes.byref(out))
        return (int(room), int(out.value)) if room >= 0 else None

    @property
    def occupancy(self) -> int:
        return int(self._lib.ompi_tpu_hotel_occupancy(self._h))


class Bitmap(_Native):
    """Growable bitmap (opal_bitmap) with find-and-set allocation."""
    kind = "bitmap"

    def set(self, bit: int) -> None:
        self._lib.ompi_tpu_bitmap_set(self._h, bit)

    def clear(self, bit: int) -> None:
        self._lib.ompi_tpu_bitmap_clear(self._h, bit)

    def test(self, bit: int) -> bool:
        return bool(self._lib.ompi_tpu_bitmap_test(self._h, bit))

    def find_and_set(self) -> int:
        return int(self._lib.ompi_tpu_bitmap_find_and_set(self._h))


class PointerArray(_Native):
    """Index-recycling registry (opal_pointer_array)."""
    kind = "parray"

    def add(self, value: int) -> int:
        return int(self._lib.ompi_tpu_parray_add(self._h, value))

    def set(self, index: int, value: int) -> bool:
        return bool(self._lib.ompi_tpu_parray_set(self._h, index, value))

    def get(self, index: int) -> Optional[int]:
        out = ctypes.c_int64()
        ok = self._lib.ompi_tpu_parray_get(self._h, index,
                                           ctypes.byref(out))
        return int(out.value) if ok else None

    def remove(self, index: int) -> bool:
        return bool(self._lib.ompi_tpu_parray_remove(self._h, index))
