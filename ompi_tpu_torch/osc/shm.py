"""osc/shm — same-host windows over /dev/shm segments (load/store RMA).

Behavioral spec: ``ompi/mca/osc/sm``, as the JAX package's
``osc/shm.py`` ports it — when every rank of the communicator shares
the host, each rank's exposure region lives in a raw mmap'd /dev/shm
file (``btl/shmseg._PoolFile``: the creator owns and unlinks, attachers
never unlink, POSIX keeps mapped views valid past the unlink). Every
peer maps every other peer's segment lazily on first access, and the
data ops become memory ops instead of messages:

- ``put``          — ONE copy, straight into the target's window slice
  (a CUDA origin takes its one ``.cpu()`` staging copy first);
- ``get``          — ZERO copies: an ``np.frombuffer`` view adopted in
  place (valid for the window's lifetime; callers that need a
  snapshot ``.copy()``);
- ``accumulate`` / ``get_accumulate`` / ``compare_and_swap`` — an
  in-segment typed fold under the target file's ``flock`` (the
  cross-process atomicity domain MPI_Accumulate requires; all ranks
  are same-host by selection, so one file lock covers every origin).

After a remote put/accumulate the origin sends the target a
descriptor-only NOTE frame (no payload, no ack) so the target's pvars
account bytes landed in its window.

Synchronization is inherited from ``RankWindow`` unchanged: the
passive-lock FIFO grant queue, PSCW tokens and the barrier fence all
operate on wid-addressed ctl frames, and since ``self.local`` IS the
shared mapping, both the RPC path and direct loads observe the same
bytes.

Segment files are named ``otptwin_<tag>_<wrank>_<suffix>``: the port's
prefix, beside ``otptsm`` and ``otptpool``, which the port's launcher
sweeps after a job (``tools/mpirun.py`` imports ``WIN_PREFIX``). It is
never the JAX package's ``otpuwin``, whose launcher sweep would reclaim
a live port window.
"""
from __future__ import annotations

import fcntl
import itertools
import os
import threading
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import numpy as np

from ompi_tpu_torch.accelerator import job_tag
from ompi_tpu_torch.btl.shmseg import _PoolFile, coll_token
from ompi_tpu_torch.core.errhandler import ERR_ARG, ERR_WIN, MPIError
from ompi_tpu_torch.mca import var

from ompi_tpu_torch.osc import base as _base
from ompi_tpu_torch.osc.perrank import _ACC_OPS, RankWindow, host_array

# the launcher's post-reap sweep globs on this prefix
# (tools/mpirun.py imports it) — prefix and glob must never diverge
WIN_PREFIX = "otptwin"


def _win_name(world_rank: int, suffix: str) -> str:
    tag = job_tag()
    if tag:
        return f"{WIN_PREFIX}_{tag}_{world_rank}_{suffix}"
    return (f"{WIN_PREFIX}_{os.getpid():x}_{world_rank}_{suffix}_"
            f"{os.urandom(4).hex()}")


class ShmWindow(RankWindow):
    """A window whose exposure region is a mapped /dev/shm segment."""

    component = "shm"

    def __init__(self, comm, size: int, dtype=np.float32,
                 name: str = ""):
        dt = np.dtype(dtype)
        nbytes = int(size) * dt.itemsize
        # window ids must agree across ranks and the segment must be
        # published BEFORE the creation barrier (RankWindow's sizes
        # allgather) so any peer's first op finds the name in the KV —
        # a dedicated collective-order counter keys both
        if not hasattr(comm, "_osc_shm_seq"):
            comm._osc_shm_seq = itertools.count(0)
        self._shm_seq = next(comm._osc_shm_seq)
        tok = coll_token(comm.cid)
        me = comm.rank()
        wrank = comm.world_rank_of(me)
        try:
            pf = _PoolFile(_win_name(wrank, f"w{tok}{self._shm_seq}"),
                           max(nbytes, 1), max(nbytes, 1), create=True)
        except OSError as e:
            raise MPIError(ERR_WIN,
                           f"cannot allocate window segment: {e}")
        self._pf = pf
        self._kv_key = f"ompi_tpu_torch/oscwin/{tok}/{self._shm_seq}"
        comm.router.kv_set(f"{self._kv_key}/{me}", pf.name)
        storage = np.frombuffer(pf.buf, dtype=dt, count=int(size))
        self._maps_lock = threading.Lock()
        self._peer_maps: Dict[int, Tuple[_PoolFile, np.ndarray]] = {}
        super().__init__(comm, size, dtype, name=name, storage=storage)

    # -- peer mappings -------------------------------------------------
    def _peer_entry(self, target: int) -> Tuple[_PoolFile, np.ndarray]:
        if target == self.comm.rank():
            return self._pf, self.local
        with self._maps_lock:
            ent = self._peer_maps.get(target)
        if ent is not None:
            return ent
        val = self.comm.router.kv_get(f"{self._kv_key}/{target}")
        if isinstance(val, bytes):
            val = val.decode()
        if not val:
            raise MPIError(ERR_WIN,
                           f"no window segment published by rank "
                           f"{target}")
        peer_bytes = self.sizes[target] * self.dtype.itemsize
        pf = _PoolFile(str(val), max(peer_bytes, 1),
                       max(peer_bytes, 1), create=False)
        arr = np.frombuffer(pf.buf, dtype=self.dtype,
                            count=self.sizes[target])
        with self._maps_lock:
            cur = self._peer_maps.setdefault(target, (pf, arr))
        if cur[0] is not pf:
            pf.close()                   # lost the attach race (never
        return cur                       # unlinks: not the creator)

    @contextmanager
    def _atomic(self, pf: _PoolFile):
        """The accumulate atomicity domain: the target file's flock
        excludes every other same-host origin; the window lock
        excludes this process's own reader thread."""
        with self._lock:
            fcntl.flock(pf._fd, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(pf._fd, fcntl.LOCK_UN)

    def _note(self, target: int, kind: str, nbytes: int) -> None:
        """Descriptor-only completion note to the target (accounting
        plane; best-effort, gated, never carries data)."""
        if target == self.comm.rank():
            return
        _base.register_params()
        if not var.var_get("mpi_base_osc_shm_notes", True):
            return
        router = self.comm.router
        header = {"rma": True, "wid": self.wid, "op": "note",
                  "origin": router.rank, "kind": kind,
                  "nb": int(nbytes)}
        try:
            router.endpoint.send_frame(
                self.comm.world_rank_of(target), header, b"")
        except Exception:                # noqa: BLE001 — accounting
            pass                         # must never fail the op

    # -- data ops: direct load/store -----------------------------------
    def put(self, data, target: int, disp: int = 0) -> None:
        arr = host_array(data, self.dtype).ravel()
        self._bounds(disp, arr.size, target)
        _pf, dst = self._peer_entry(target)
        dst[disp:disp + arr.size] = arr
        self._note(target, "put", arr.nbytes)

    def get(self, target: int, disp: int = 0, count: int = 1):
        self._bounds(disp, count, target)
        _pf, src = self._peer_entry(target)
        return src[disp:disp + count]    # zero-copy in-place adoption

    def accumulate(self, data, target: int, disp: int = 0,
                   op: str = "sum") -> None:
        if op not in _ACC_OPS or _ACC_OPS[op] is False:
            raise MPIError(ERR_ARG, f"bad accumulate op {op!r}")
        arr = host_array(data, self.dtype).ravel()
        self._bounds(disp, arr.size, target)
        pf, dst = self._peer_entry(target)
        fn = _ACC_OPS[op]
        with self._atomic(pf):
            seg = dst[disp:disp + arr.size]
            dst[disp:disp + arr.size] = (arr if fn is None
                                         else fn(seg, arr))
        self._note(target, "acc", arr.nbytes)

    def get_accumulate(self, data, target: int, disp: int = 0,
                       op: str = "sum"):
        if op not in _ACC_OPS:           # no_op is legal here (fetch)
            raise MPIError(ERR_ARG, f"bad accumulate op {op!r}")
        arr = host_array(data, self.dtype).ravel()
        self._bounds(disp, arr.size, target)
        pf, dst = self._peer_entry(target)
        fn = _ACC_OPS[op]
        with self._atomic(pf):
            seg = dst[disp:disp + arr.size]
            prior = seg.copy()
            if fn is not False:          # MPI_NO_OP fetches only
                dst[disp:disp + arr.size] = (arr if fn is None
                                             else fn(prior, arr))
        self._note(target, "acc", arr.nbytes)
        return prior

    def compare_and_swap(self, compare, origin, target: int,
                         disp: int = 0):
        self._bounds(disp, 1, target)
        pf, dst = self._peer_entry(target)
        cmp_v = host_array(compare, self.dtype).ravel()[0]
        org_v = host_array(origin, self.dtype).ravel()[0]
        with self._atomic(pf):
            prior = dst[disp].copy()
            if prior == cmp_v:
                dst[disp] = org_v
        self._note(target, "acc", int(self.dtype.itemsize))
        return prior

    # -- typed ops against byte-addressed (C ABI) windows --------------
    def accumulate_typed(self, data, target: int, byte_disp: int,
                         op: str = "sum") -> None:
        if self.dtype != np.dtype(np.uint8):
            raise MPIError(ERR_ARG,
                           "accumulate_typed requires a byte window")
        if op not in _ACC_OPS or _ACC_OPS[op] is False:
            raise MPIError(ERR_ARG, f"bad accumulate op {op!r}")
        arr = np.ascontiguousarray(host_array(data)).ravel()
        self._bounds(byte_disp, arr.nbytes, target)
        pf, dst = self._peer_entry(target)
        fn = _ACC_OPS[op]
        nb = arr.nbytes
        with self._atomic(pf):
            seg = dst[byte_disp:byte_disp + nb].view(arr.dtype)
            out = arr if fn is None else fn(seg, arr)
            dst[byte_disp:byte_disp + nb] = \
                np.ascontiguousarray(out).view(np.uint8)
        self._note(target, "acc", nb)

    def get_accumulate_typed(self, data, target: int, byte_disp: int,
                             op: str = "sum"):
        if self.dtype != np.dtype(np.uint8):
            raise MPIError(ERR_ARG, "typed RMA requires a byte window")
        if op not in _ACC_OPS:
            raise MPIError(ERR_ARG, f"bad accumulate op {op!r}")
        arr = np.ascontiguousarray(host_array(data)).ravel()
        self._bounds(byte_disp, arr.nbytes, target)
        pf, dst = self._peer_entry(target)
        fn = _ACC_OPS[op]
        nb = arr.nbytes
        with self._atomic(pf):
            seg = dst[byte_disp:byte_disp + nb].view(arr.dtype)
            prior = seg.copy()
            if fn is not False:
                out = arr if fn is None else fn(prior, arr)
                dst[byte_disp:byte_disp + nb] = \
                    np.ascontiguousarray(out).view(np.uint8)
        self._note(target, "acc", nb)
        return prior

    def compare_and_swap_typed(self, compare, origin, target: int,
                               byte_disp: int):
        if self.dtype != np.dtype(np.uint8):
            raise MPIError(ERR_ARG, "typed RMA requires a byte window")
        org = np.ascontiguousarray(host_array(origin).ravel()[:1])
        cmp_v = host_array(compare, org.dtype).ravel()[0]
        esz = org.dtype.itemsize
        self._bounds(byte_disp, esz, target)
        pf, dst = self._peer_entry(target)
        with self._atomic(pf):
            seg = dst[byte_disp:byte_disp + esz].view(org.dtype)
            prior = seg.copy()[0]
            if prior == cmp_v:
                dst[byte_disp:byte_disp + esz] = org.view(np.uint8)
        self._note(target, "acc", esz)
        return prior

    # -- note frames (target side) -------------------------------------
    def _handle_inner(self, header: dict, raw: bytes) -> None:
        if header.get("op") == "note":
            _base.stats["notes"] += 1
            return                       # descriptor-only: no ack
        super()._handle_inner(header, raw)

    # -- FT / lifecycle ------------------------------------------------
    def peer_failed(self, world_rank: int) -> None:
        super().peer_failed(world_rank)  # passive-lock queue purge
        # reclaim the dead peer's mapping: the segment file itself is
        # the dead creator's to unlink (the launcher sweep's job after
        # a SIGKILL); dropping our view releases the memory here
        dead = []
        with self._maps_lock:
            for r, (pf, _arr) in list(self._peer_maps.items()):
                try:
                    if self.comm.world_rank_of(r) == world_rank:
                        dead.append(pf)
                        del self._peer_maps[r]
                except Exception:        # noqa: BLE001 — shrinking
                    pass                 # comm: rank may be gone
        for pf in dead:
            pf.close()

    def free(self) -> None:
        # reclaim the segments even when the completion barrier raises
        # over a dead peer (the FT drill's survivor-side free)
        try:
            super().free()
        finally:
            with self._maps_lock:
                maps = [pf for pf, _ in self._peer_maps.values()]
                self._peer_maps.clear()
            for pf in maps:
                pf.close()
            self._pf.close()             # creator: unlinks the file
