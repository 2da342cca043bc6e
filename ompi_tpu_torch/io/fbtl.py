"""fbtl framework — individual file byte transfer (``ompi/mca/fbtl``;
the port of ``ompi_tpu/io/fbtl.py``).

The reference's fbtl/posix issues one positioned request per iovec
entry. Runs arrive here already coalesced (``coalesce_runs`` merged
adjacent element offsets upstream in the datatype/fcoll layers), so the
transfer loop is one ``pread``/``pwrite`` per *disjoint* file run — the
minimal syscall count for the access pattern.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


class PosixFbtl:
    """Positioned IO over an fd. Runs are (byte_off, nbytes), disjoint
    and sorted (the upstream coalescer's contract)."""

    name = "posix"

    def pwritev_runs(self, fd: int, runs: List[Tuple[int, int]],
                     payload: bytes) -> int:
        written = 0
        pos = 0
        mv = memoryview(payload)
        for off, ln in runs:
            written += os.pwrite(fd, mv[pos:pos + ln], off)
            pos += ln
        return written

    def preadv_runs(self, fd: int, runs: List[Tuple[int, int]]) -> bytes:
        out = bytearray()
        for off, ln in runs:
            chunk = os.pread(fd, ln, off)
            if len(chunk) < ln:                  # short read past EOF
                chunk = chunk + b"\0" * (ln - len(chunk))
            out += chunk
        return bytes(out)


def elem_runs_to_bytes(starts: np.ndarray, lens: np.ndarray,
                       ebytes: int) -> List[Tuple[int, int]]:
    return [(int(s) * ebytes, int(l) * ebytes)
            for s, l in zip(starts, lens)]
