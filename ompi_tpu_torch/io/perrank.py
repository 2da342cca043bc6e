"""MPI-IO for the per-rank execution model — N OS processes, ONE file.

Behavioral spec: ``ompi/mca/io/ompio`` orchestration where it matters
most — genuinely concurrent processes sharing a file:

- independent positioned IO (`MPI_File_read_at/write_at`) = pread/
  pwrite, no coordination (the fbtl/posix role);
- collective IO (`*_at_all`) = TWO-PHASE aggregation (the
  fcoll/dynamic design): ranks ship (offset, bytes) segments to the
  aggregator, which coalesces adjacent runs and issues few large
  writes — the whole point of collective IO on shared filesystems;
- the SHARED FILE POINTER (`sharedfp/sm` role) is a one-slot RMA
  window on rank 0: `write_shared` claims its region with a window
  fetch-and-add, so concurrent appends from different processes land
  disjoint by construction;
- ordered IO (`*_ordered`) = rank-ordered regions from an exscan of
  the contribution sizes on top of the shared pointer.

Writes take tensors anywhere: a CUDA tensor is staged with one
``.cpu()`` copy (``osc/perrank.host_array``), as the per-rank windows
stage it; reads return host numpy. File views reduce to
(displacement, etype) here; the strided-filetype
machinery stays with the single-controller `io/file.py` (the two share
the MODE_* surface).
"""
from __future__ import annotations

import os

import numpy as np

from ompi_tpu_torch.core import op as op_mod
from ompi_tpu_torch.core.errhandler import ERR_ARG, MPIError
from ompi_tpu_torch.io.file import (MODE_APPEND, MODE_CREATE, MODE_EXCL,
                              MODE_RDONLY, MODE_RDWR, MODE_WRONLY)
from ompi_tpu_torch.osc.perrank import RankWindow, host_array

__all__ = ["RankFile", "MODE_RDONLY", "MODE_WRONLY", "MODE_RDWR",
           "MODE_CREATE", "MODE_EXCL", "MODE_APPEND"]


class RankFile:
    """One rank's handle on a collectively-opened file."""

    def __init__(self, comm, path: str,
                 amode: int = MODE_RDWR | MODE_CREATE,
                 etype=np.float64):
        self.comm = comm
        self.path = path
        self.amode = amode
        self.etype = np.dtype(etype)
        self._disp = 0
        # collective open (MPI_File_open): creation races are real
        # across processes — rank 0 creates and BROADCASTS the outcome
        # (a bare barrier would strand the other ranks if the create
        # raised: the collective-hang class) before everyone opens
        err = ""
        if comm.rank() == 0:
            try:
                fd = os.open(path, amode | os.O_CREAT
                             if amode & MODE_CREATE else amode, 0o644)
                os.close(fd)
            except OSError as e:
                err = str(e)
        err = comm.bcast(err, root=0)
        if err:
            raise MPIError(ERR_ARG, f"MPI_File_open: {err}")
        self.fd = os.open(path, amode & ~MODE_EXCL)
        # shared file pointer = one int64 slot on rank 0's window
        # (sharedfp/sm: a shared counter all processes atomically
        # bump); element units, like the reference's etype-relative
        # shared pointer
        self._sp = RankWindow(comm, 1, dtype=np.int64,
                              name=f"sharedfp:{os.path.basename(path)}")
        comm.barrier()

    @classmethod
    def open(cls, comm, path: str,
             amode: int = MODE_RDWR | MODE_CREATE,
             etype=np.float64) -> "RankFile":
        return cls(comm, path, amode, etype)

    # -- view ----------------------------------------------------------
    def set_view(self, disp: int = 0, etype=None) -> None:
        """MPI_File_set_view (displacement in BYTES + etype)."""
        self._disp = int(disp)
        if etype is not None:
            self.etype = np.dtype(etype)

    def get_view(self):
        return self._disp, self.etype

    def _byte_off(self, offset: int) -> int:
        return self._disp + int(offset) * self.etype.itemsize

    # -- sizes ---------------------------------------------------------
    def get_size(self) -> int:
        return os.fstat(self.fd).st_size

    def set_size(self, nbytes: int) -> None:
        """Collective (MPI_File_set_size); entry barrier for the same
        reason as seek_shared — a fast rank's truncate must not
        overtake a slow rank's pre-collective reads."""
        self.comm.barrier()
        if self.comm.rank() == 0:
            os.ftruncate(self.fd, nbytes)
        self.comm.barrier()

    def preallocate(self, nbytes: int) -> None:
        self.comm.barrier()
        if self.comm.rank() == 0 and self.get_size() < nbytes:
            os.ftruncate(self.fd, nbytes)
        self.comm.barrier()

    # -- independent positioned IO (fbtl/posix) ------------------------
    def write_at(self, offset: int, data) -> int:
        arr = np.ascontiguousarray(host_array(data, self.etype))
        os.pwrite(self.fd, arr.tobytes(), self._byte_off(offset))
        return arr.size

    def read_at(self, offset: int, count: int) -> np.ndarray:
        raw = os.pread(self.fd, count * self.etype.itemsize,
                       self._byte_off(offset))
        return np.frombuffer(raw, dtype=self.etype).copy()

    def iwrite_at(self, offset: int, data):
        return self.comm._nb(self.write_at, offset, data)

    def iread_at(self, offset: int, count: int):
        return self.comm._nb(self.read_at, offset, count)

    # -- collective IO: two-phase aggregation (fcoll/dynamic) ----------
    def write_at_all(self, offset: int, data) -> int:
        """Every rank contributes its own (offset, data); the
        aggregator coalesces adjacent byte runs and issues ONE write
        per run — interleaved per-rank patterns become large
        sequential IO (the two-phase optimization)."""
        arr = np.ascontiguousarray(host_array(data, self.etype))
        segs = self.comm.gather((self._byte_off(offset),
                                 arr.tobytes()), root=0)
        if self.comm.rank() == 0:
            for off, blob in self._coalesce(segs):
                os.pwrite(self.fd, blob, off)
            os.fsync(self.fd)
        self.comm.barrier()
        return arr.size

    @staticmethod
    def _coalesce(segs):
        """Sort segments by offset and merge touching/overlapping runs
        (later contributions win overlaps, matching rank order)."""
        runs = []
        for off, blob in sorted(segs, key=lambda s: s[0]):
            if runs and off <= runs[-1][0] + len(runs[-1][1]):
                prev_off, prev = runs[-1]
                cut = off - prev_off
                runs[-1] = (prev_off, prev[:cut] + blob) \
                    if cut + len(blob) >= len(prev) \
                    else (prev_off,
                          prev[:cut] + blob + prev[cut + len(blob):])
            else:
                runs.append((off, blob))
        return runs

    def read_at_all(self, offset: int, count: int) -> np.ndarray:
        """Aggregator reads the whole span once, scatters each rank's
        slice (two-phase read). A span extending past EOF zero-fills
        the tail (a short pread must neither raise on the aggregator —
        stranding the others in the scatter — nor misalign the element
        grid)."""
        my_off = self._byte_off(offset)
        nbytes = count * self.etype.itemsize
        spans = self.comm.allgather((my_off, nbytes))
        chunks = None
        if self.comm.rank() == 0:
            lo = min(s[0] for s in spans)
            hi = max(s[0] + s[1] for s in spans)
            blob = os.pread(self.fd, hi - lo, lo)
            if len(blob) < hi - lo:
                blob = blob + b"\0" * (hi - lo - len(blob))
            chunks = [np.frombuffer(
                blob[s[0] - lo:s[0] - lo + s[1]],
                dtype=self.etype).copy() for s in spans]
        return np.asarray(self.comm.scatter(chunks, root=0))

    # -- shared file pointer (sharedfp/sm over window atomics) ---------
    def write_shared(self, data) -> int:
        arr = np.ascontiguousarray(host_array(data, self.etype))
        start = int(self._sp.fetch_and_op(arr.size, 0, 0, op="sum"))
        os.pwrite(self.fd, arr.tobytes(), self._byte_off(start))
        return start

    def read_shared(self, count: int) -> np.ndarray:
        start = int(self._sp.fetch_and_op(count, 0, 0, op="sum"))
        return self.read_at(start, count)

    def seek_shared(self, offset: int) -> None:
        """Collective per MPI (all ranks same offset). The ENTRY
        barrier matters: every rank's pre-seek shared-pointer reads
        (get_position_shared is NOT collective) must land before the
        write, or a fast rank's seek overwrites the pointer a slow
        rank is still about to read — observed as a real race in
        c24_io_rma's ordered section."""
        self.comm.barrier()
        if self.comm.rank() == 0:
            self._sp.accumulate([offset], 0, 0, op="replace")
        self.comm.barrier()

    def get_position_shared(self) -> int:
        return int(self._sp.fetch_and_op(0, 0, 0, op="no_op"))

    # -- ordered IO (rank-ordered regions over the shared pointer) -----
    def write_ordered(self, data) -> int:
        arr = np.ascontiguousarray(host_array(data, self.etype))
        base = self.get_position_shared()
        before = self.comm.exscan(np.int64(arr.size), op_mod.SUM)
        before = 0 if before is None else int(before)
        os.pwrite(self.fd, arr.tobytes(),
                  self._byte_off(base + before))
        total = int(self.comm.allreduce(np.int64(arr.size), op_mod.SUM))
        self.seek_shared(base + total)
        return base + before

    def read_ordered(self, count: int) -> np.ndarray:
        base = self.get_position_shared()
        before = self.comm.exscan(np.int64(count), op_mod.SUM)
        before = 0 if before is None else int(before)
        out = self.read_at(base + before, count)
        total = int(self.comm.allreduce(np.int64(count), op_mod.SUM))
        self.seek_shared(base + total)
        return out

    # -- completion ----------------------------------------------------
    def sync(self) -> None:
        """MPI_File_sync: flush to storage, then a barrier so every
        rank's writes are visible to every rank's reads."""
        os.fsync(self.fd)
        self.comm.barrier()

    def close(self) -> None:
        """Collective (MPI_File_close)."""
        self.sync()
        os.close(self.fd)
        self._sp.free()

    def delete(self) -> None:
        self.comm.barrier()
        err = ""
        if self.comm.rank() == 0:
            try:
                os.unlink(self.path)
            except OSError as e:
                err = str(e)
        # outcome reaches every rank (a rank-0 raise between barriers
        # would strand the others)
        err = self.comm.bcast(err, root=0)
        if err:
            raise MPIError(ERR_ARG, f"MPI_File_delete: {err}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
