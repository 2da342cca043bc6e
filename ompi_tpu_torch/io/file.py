"""MPI-IO — parallel file I/O (mirrors ``ompi/mca/io/ompio`` +
``ompi/mca/common/ompio`` orchestration over real sub-frameworks; the
port of ``ompi_tpu/io/file.py``):

- fs    (``io/fs.py``)       — filesystem glue selected per file from
  the mount table (ufs fallback; lustre/gpfs claim their types).
- fbtl  (``io/fbtl.py``)     — individual byte transfer: vectored
  positioned IO batching noncontiguous runs.
- fcoll (``io/fcoll.py``)    — collective algorithms: individual /
  two-phase dynamic / vulcan aggregation, selected by MCA var.
- sharedfp (``io/sharedfp.py``) — shared file pointer: sm / lockedfile /
  individual components.

File views (etype + filetype displacement maps) reuse the datatype
engine's index maps, so a strided view is the same object as a derived
datatype (``opal/datatype`` heritage).

Writes take tensors anywhere: a CUDA tensor comes to the host through
the accelerator's ``to_host``, one device-to-host copy per call (a
collective write copies the whole stacked tensor once). Reads return
host numpy, as the reference's do; the nonblocking variants return a
completed ``Request``.
"""
from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np
import torch

from ompi_tpu_torch.accelerator import to_host
from ompi_tpu_torch.core.datatype import Datatype, numpy_dtype
from ompi_tpu_torch.core.errhandler import ERR_ARG, MPIError
from ompi_tpu_torch.core.request import Request
from ompi_tpu_torch.io.fbtl import PosixFbtl, elem_runs_to_bytes
from ompi_tpu_torch.io.fcoll import select_fcoll
from ompi_tpu_torch.io.fs import select_fs
from ompi_tpu_torch.io.sharedfp import IndividualSharedfp, select_sharedfp

MODE_RDONLY = os.O_RDONLY
MODE_WRONLY = os.O_WRONLY
MODE_RDWR = os.O_RDWR
MODE_CREATE = os.O_CREAT
MODE_EXCL = os.O_EXCL
MODE_APPEND = os.O_APPEND


def _np_etype(etype) -> np.dtype:
    """A numpy etype from a numpy dtype, torch dtype or Datatype."""
    if isinstance(etype, Datatype):
        etype = etype.base
    if isinstance(etype, torch.dtype):
        return numpy_dtype(etype)
    return np.dtype(etype)


class File:
    """An MPI file handle over a communicator."""

    def __init__(self, comm, path: str, amode: int = MODE_RDWR | MODE_CREATE,
                 etype: Optional[np.dtype] = None):
        self.comm = comm
        self.path = path
        self.amode = amode
        self.etype = _np_etype(np.uint8 if etype is None else etype)
        self.fs = select_fs(path)
        self.fbtl = PosixFbtl()
        self.fcoll = select_fcoll(self.fbtl)
        self.sharedfp = select_sharedfp(path)
        self._fd = self.fs.open(path, amode)
        self._lock = threading.RLock()
        self._view_disp = 0                  # view displacement, elements
        self._view_type: Optional[Datatype] = None
        self.atomicity = False

    @classmethod
    def open(cls, comm, path: str,
             amode: int = MODE_RDWR | MODE_CREATE) -> "File":
        return cls(comm, path, amode)

    # -- geometry -------------------------------------------------------
    def _ebytes(self) -> int:
        return self.etype.itemsize

    def get_size(self) -> int:
        return os.fstat(self._fd).st_size // self._ebytes()

    def set_size(self, nelems: int) -> None:
        self.fs.resize(self._fd, nelems * self._ebytes())

    def preallocate(self, nelems: int) -> None:
        if self.get_size() < nelems:
            self.set_size(nelems)

    def get_amode(self) -> int:
        return self.amode

    def get_group(self):
        return self.comm.group

    # -- views (MPI_File_set_view) -------------------------------------
    def set_view(self, disp: int = 0, etype=None,
                 filetype: Optional[Datatype] = None) -> None:
        """disp in elements of ``etype``; ``filetype`` selects visible
        elements per extent window (the datatype engine's index map)."""
        if etype is not None:
            self.etype = _np_etype(etype)
        self._view_disp = int(disp)
        self._view_type = filetype

    def get_view(self):
        return self._view_disp, self.etype, self._view_type

    def _map_offset(self, offset: int, count: int) -> np.ndarray:
        """Element file-offsets for ``count`` elements starting at view
        element ``offset`` (applying the filetype's index map)."""
        if self._view_type is None:
            return np.arange(offset, offset + count) + self._view_disp
        ft = self._view_type
        inst0, within = divmod(offset, ft.count)
        n_inst = -(-(within + count) // ft.count)
        idx = ft.flat_indices(inst0 + n_inst)[inst0 * ft.count:]
        return idx[within:within + count] + self._view_disp

    # -- individual I/O (fbtl role) ------------------------------------
    def _runs_bytes(self, offs: np.ndarray):
        from ompi_tpu_torch.core.datatype import coalesce_runs
        starts, lens = coalesce_runs(offs)
        return elem_runs_to_bytes(starts, lens, self._ebytes())

    def write_at(self, offset: int, data) -> int:
        """Write ``data`` (any array; device buffers are fetched D2H by
        the accelerator framework) at view offset (elements)."""
        arr = np.ascontiguousarray(to_host(data)).astype(self.etype,
                                                         copy=False).ravel()
        offs = self._map_offset(offset, arr.size)
        with self._lock:
            self.fbtl.pwritev_runs(self._fd, self._runs_bytes(offs),
                                   arr.tobytes())
        return arr.size

    def read_at(self, offset: int, count: int) -> np.ndarray:
        offs = self._map_offset(offset, count)
        with self._lock:
            raw = self.fbtl.preadv_runs(self._fd, self._runs_bytes(offs))
        return np.frombuffer(raw, self.etype, count=count).copy()

    # -- nonblocking ----------------------------------------------------
    def iwrite_at(self, offset: int, data) -> Request:
        return Request.completed(self.write_at(offset, data))

    def iread_at(self, offset: int, count: int) -> Request:
        return Request.completed(self.read_at(offset, count))

    # -- collective I/O (fcoll role) -----------------------------------
    def _per_rank_io(self, offset: int, host: np.ndarray):
        """Per-rank (element offsets, data) with each rank's block at
        ``offset + r*block`` of the view — the interleaving the fcoll
        aggregation policies operate on."""
        n = self.comm.size
        block = int(np.prod(host.shape[1:])) if host.ndim > 1 else 1
        out = []
        for r in range(n):
            offs = self._map_offset(offset + r * block, block)
            out.append((offs, np.ascontiguousarray(host[r]).astype(
                self.etype, copy=False).ravel()))
        return out

    def write_at_all(self, offset: int, stacked) -> int:
        """Collective write: rank r's block (stacked axis 0) lands at
        view offset ``offset + r*block``, aggregated by the selected
        fcoll component."""
        host = np.asarray(to_host(stacked))
        if host.shape[0] != self.comm.size:
            raise MPIError(ERR_ARG, "stacked buffer must have one block "
                                    "per rank")
        with self._lock:
            return self.fcoll.write(self._fd,
                                    self._per_rank_io(offset, host),
                                    self._ebytes())

    def read_at_all(self, offset: int, count_per_rank: int) -> np.ndarray:
        """Collective read: returns stacked (nranks, count_per_rank)."""
        n = self.comm.size
        per_rank = [self._map_offset(offset + r * count_per_rank,
                                     count_per_rank) for r in range(n)]
        with self._lock:
            chunks = self.fcoll.read(self._fd, per_rank, self.etype)
        return np.stack([c.reshape(count_per_rank) for c in chunks])

    def iwrite_at_all(self, offset: int, stacked) -> Request:
        return Request.completed(self.write_at_all(offset, stacked))

    def iread_at_all(self, offset: int, count_per_rank: int) -> Request:
        return Request.completed(self.read_at_all(offset, count_per_rank))

    # -- shared file pointer (sharedfp role) ---------------------------
    def write_shared(self, data) -> int:
        arr = np.ascontiguousarray(to_host(data)).astype(
            self.etype, copy=False).ravel()
        if isinstance(self.sharedfp, IndividualSharedfp):
            self.sharedfp.log_write(arr)      # ordered at sync
            return arr.size
        off = self.sharedfp.fetch_add(arr.size)
        return self.write_at(off, arr)

    def read_shared(self, count: int) -> np.ndarray:
        off = self.sharedfp.fetch_add(count)
        return self.read_at(off, count)

    def seek_shared(self, offset: int) -> None:
        self.sharedfp.seek(offset)

    def get_position_shared(self) -> int:
        return self.sharedfp.get()

    def write_ordered(self, stacked) -> int:
        """MPI_File_write_ordered: collective; rank r's block lands at
        the shared pointer after ranks < r, pointer advances by the
        total."""
        host = np.asarray(to_host(stacked))
        if host.shape[0] != self.comm.size:
            raise MPIError(ERR_ARG, "stacked buffer must have one block "
                                    "per rank")
        flat = np.ascontiguousarray(host).astype(self.etype,
                                                 copy=False)
        total = int(flat.size)
        if isinstance(self.sharedfp, IndividualSharedfp):
            self.sharedfp.log_write(flat.ravel())
            return total
        off = self.sharedfp.fetch_add(total)
        return self.write_at(off, flat.ravel())

    def read_ordered(self, count_per_rank: int) -> np.ndarray:
        n = self.comm.size
        off = self.sharedfp.fetch_add(count_per_rank * n)
        flat = self.read_at(off, count_per_rank * n)
        return flat.reshape(n, count_per_rank)

    # -- sync/close ----------------------------------------------------
    def sync(self) -> None:
        if isinstance(self.sharedfp, IndividualSharedfp):
            for off, arr in self.sharedfp.drain():
                self.write_at(off, arr)
        self.fs.sync(self._fd)

    def close(self) -> None:
        if self._fd >= 0:
            self.sync()
            self.sharedfp.close()
            os.close(self._fd)
            self._fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
