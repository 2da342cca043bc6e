"""sharedfp framework — shared file pointer (``ompi/mca/sharedfp``; the
port of ``ompi_tpu/io/sharedfp.py``).

Reference components: *sm* (pointer in a shared-memory segment),
*lockedfile* (pointer in a sidecar file advanced under fcntl locks —
works across unrelated processes), *individual* (no shared pointer at
all: each process logs its writes locally with timestamps and the logs
are merged into the file in timestamp order at close/sync).

All three are real here: sm is the in-process pointer (controller
threads), lockedfile persists the pointer beside the file under an OS
file lock (two controller processes on one host coordinate through it),
individual defers ordering until sync exactly like the reference.
"""
from __future__ import annotations

import os
import struct
import threading
import time
from typing import List, Tuple

import numpy as np


class SmSharedfp:
    """In-process shared pointer under a lock (``sharedfp/sm``)."""

    name = "sm"

    def __init__(self, path: str):
        self._off = 0
        self._lock = threading.Lock()

    def fetch_add(self, nelems: int) -> int:
        with self._lock:
            off = self._off
            self._off += nelems
            return off

    def seek(self, offset: int) -> None:
        with self._lock:
            self._off = offset

    def get(self) -> int:
        return self._off

    def close(self) -> None:
        pass


class LockedFileSharedfp:
    """Pointer in a sidecar file under fcntl.flock
    (``sharedfp/lockedfile``): any process opening the same file shares
    the pointer through the filesystem."""

    name = "lockedfile"

    def __init__(self, path: str):
        self._path = path + ".sharedfp"
        self._fd = os.open(self._path, os.O_RDWR | os.O_CREAT, 0o644)
        # initialize under the same lock fetch_add takes — an unlocked
        # check-and-write could reset a pointer another process already
        # advanced (init racing its fetch_add)
        def init():
            if os.fstat(self._fd).st_size < 8:
                os.pwrite(self._fd, struct.pack("<q", 0), 0)
        self._locked(init)

    def _locked(self, fn):
        import fcntl
        fcntl.flock(self._fd, fcntl.LOCK_EX)
        try:
            return fn()
        finally:
            fcntl.flock(self._fd, fcntl.LOCK_UN)

    def fetch_add(self, nelems: int) -> int:
        def op():
            off = struct.unpack("<q", os.pread(self._fd, 8, 0))[0]
            os.pwrite(self._fd, struct.pack("<q", off + nelems), 0)
            return off
        return self._locked(op)

    def seek(self, offset: int) -> None:
        self._locked(lambda: os.pwrite(self._fd,
                                       struct.pack("<q", offset), 0))

    def get(self) -> int:
        return self._locked(
            lambda: struct.unpack("<q", os.pread(self._fd, 8, 0))[0])

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1
            try:
                os.unlink(self._path)
            except OSError:
                pass


class IndividualSharedfp:
    """No live shared pointer (``sharedfp/individual``): writes are
    logged with timestamps and sequenced into file offsets at sync, in
    global timestamp order."""

    name = "individual"

    def __init__(self, path: str):
        self._log: List[Tuple[float, np.ndarray]] = []
        self._lock = threading.Lock()
        self._base = 0

    def log_write(self, arr: np.ndarray) -> None:
        with self._lock:
            self._log.append((time.monotonic(), arr.copy()))

    def drain(self) -> List[Tuple[int, np.ndarray]]:
        """Assign offsets in timestamp order; returns (offset, data)
        pairs and advances the base pointer."""
        with self._lock:
            entries = sorted(self._log, key=lambda e: e[0])
            self._log.clear()
            out = []
            off = self._base
            for _ts, arr in entries:
                out.append((off, arr))
                off += arr.size
            self._base = off
            return out

    # the shared pointer is only defined at sync boundaries
    def fetch_add(self, nelems: int) -> int:
        raise RuntimeError("sharedfp/individual has no live pointer; "
                           "writes are ordered at sync")

    def seek(self, offset: int) -> None:
        with self._lock:
            self._base = offset

    def get(self) -> int:
        return self._base

    def close(self) -> None:
        pass


from ompi_tpu_torch.mca import var  # noqa: E402


def register_vars() -> None:
    var.var_register("io", "base", "sharedfp", vtype="str", default="sm",
                     help="Shared-file-pointer component: "
                          "sm | lockedfile | individual")


register_vars()


def select_sharedfp(path: str):
    name = (var.var_get("io_base_sharedfp", "sm") or "sm").strip()
    if name == "lockedfile":
        return LockedFileSharedfp(path)
    if name == "individual":
        return IndividualSharedfp(path)
    return SmSharedfp(path)
