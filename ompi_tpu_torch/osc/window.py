"""osc/window — the framework window: selection, epochs, instruments.

``RmaWindow`` is what ``MPI_Win_allocate`` / ``MPI_Win_create`` hand
back in the per-rank model: ONE component selection at creation
(osc/decision — shm for same-host communicators, pt2pt emulation
otherwise), then every call goes through three framework layers before
the component:

1. the epoch state machine (osc/base.EpochState) — data ops outside
   every open access epoch raise ``MPI_ERR_RMA_SYNC`` and leave a
   flight-recorder snapshot;
2. fault tolerance — an ft-registry listener marks dead peers, ops
   targeting them and epoch boundaries (``fence``) raise
   ``MPI_ERR_PROC_FAILED`` instead of hanging, and the component's
   ``peer_failed`` reclaims lock grants and segment mappings;
3. telemetry — ``tele_osc_{put,get,acc}_us`` latency histograms, the
   ``osc_*`` op/byte pvars, a per-window byte counter pvar (retired
   with the window or its communicator), and ``osc.put`` /
   ``osc.get`` / ``osc.acc`` / ``osc.epoch`` trace spans.

Anything not wrapped here (``local``, ``sizes``, ``wid``, ``dtype``)
delegates to the component window — the component IS the window, this
class is the framework's policy around it. The JAX package's
``osc/window.py`` is the reference. The exposure memory is host memory:
an origin CUDA tensor is staged with one ``.cpu()`` copy, ``get``
returns numpy (a zero-copy view of the segment on osc/shm), and
``win_create`` takes a numpy array or a CPU tensor (aliased, so remote
puts land in the caller's tensor).
"""
from __future__ import annotations

import threading
import time as _time
import weakref
from typing import Any, Optional, Set

import numpy as np

import torch

from ompi_tpu_torch import telemetry as _tele
from ompi_tpu_torch.core.datatype import numpy_dtype
from ompi_tpu_torch.core.errhandler import (ERR_PROC_FAILED, ERR_WIN,
                                            MPIError)
from ompi_tpu_torch.mca import pvar as _pvar
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.runtime import ft as _ft
from ompi_tpu_torch.telemetry import flightrec as _flightrec
from ompi_tpu_torch.trace import core as _trace

from ompi_tpu_torch.osc import base as _base
from ompi_tpu_torch.osc import decision as _decision
from ompi_tpu_torch.osc.perrank import (LOCK_EXCLUSIVE, LOCK_SHARED,
                                        host_array)
from ompi_tpu_torch.osc.pt2pt import Pt2ptWindow
from ompi_tpu_torch.osc.shm import ShmWindow


def _ft_callback(ref):
    """The registry listener: closes over a weakref ONLY (the PR-5
    finalizer lesson — a listener must not pin a freed window)."""
    def _cb(world_rank: int, reason: str) -> None:
        w = ref()
        if w is not None:
            w._peer_dead(world_rank, reason)
    return _cb


class RmaWindow:
    """A framework window over one osc component."""

    def __init__(self, comm, size: int, dtype=np.float32,
                 name: str = "", storage: Optional[np.ndarray] = None,
                 force: Optional[str] = None):
        _base.register_params()
        _base.register_pvars()
        self.comm = comm
        self.component = _decision.select(comm, storage=storage,
                                          force=force)
        self._epoch = _base.EpochState()
        self._epoch_check = bool(
            var.var_get("mpi_base_osc_epoch_check", True))
        self._dead: Set[int] = set()
        self._dead_lock = threading.Lock()
        self._bytes = 0                  # per-window traffic counter
        if self.component == "shm":
            self._w = ShmWindow(comm, size, dtype, name=name)
            _base.stats["windows_shm"] += 1
        else:
            self._w = Pt2ptWindow(comm, size, dtype, name=name,
                                  storage=storage)
            _base.stats["windows_pt2pt"] += 1
        self.name = self._w.name
        try:
            self._world = {comm.world_rank_of(r)
                           for r in range(comm.size)}
        except Exception:                # noqa: BLE001 — exotic comm:
            self._world = set()          # accept every failure event
        # peers that died BEFORE creation stay dead for this window
        for wr in (_ft.default_registry().failed_ranks() or []):
            if not self._world or wr in self._world:
                self._dead.add(wr)
        self._ft_cb = _ft_callback(weakref.ref(self))
        _ft.add_listener(self._ft_cb)
        # per-window byte-counter pvar, retired with the window (or
        # with its communicator: comm= tags it for pvar_retire_comm)
        ref = weakref.ref(self)
        self._pvar_name = (f"osc_win_{_tele._cid_token(comm.cid)}"
                           f"_{self._w.wid[-1]}_r{comm.rank()}_bytes")
        _pvar.pvar_register(
            self._pvar_name,
            lambda r=ref: (r()._bytes if r() is not None else 0),
            unit="bytes", comm=comm.cid,
            help=f"Origin-side RMA bytes moved through window "
                 f"{self.name} ({self.component})")
        _base.track_window(self)
        self._freed = False

    # -- framework guards ----------------------------------------------
    def _guard(self, fn, *args) -> None:
        """Run one epoch-machine transition/check; an RMA_SYNC refusal
        is counted and flight-recorded before it propagates."""
        if not self._epoch_check:
            return
        try:
            fn(*args)
        except MPIError as e:
            _base.stats["epoch_errors"] += 1
            _flightrec.record("rma_sync",
                              {"win": self.name, "error": str(e)})
            raise

    def _check_dead(self, what: str,
                    target: Optional[int] = None) -> None:
        if _ft.any_failed():
            # the registry records a failure before it calls its
            # listeners, so a caller that already sees a peer failed
            # can get here before this window's listener ran
            for wr in _ft.failed_ranks() - self._dead:
                self._peer_dead(wr, _ft.failure_reason(wr))
        if not self._dead:
            return
        if target is not None:
            wt = self.comm.world_rank_of(target)
            if wt not in self._dead:
                return
            raise MPIError(ERR_PROC_FAILED,
                           f"{what}: window peer rank {target} "
                           f"(world {wt}) has failed")
        raise MPIError(ERR_PROC_FAILED,
                       f"{what}: window peer(s) "
                       f"{sorted(self._dead)} have failed")

    def _peer_dead(self, world_rank: int, reason: str) -> None:
        if self._world and world_rank not in self._world:
            return
        with self._dead_lock:            # the listener or _check_dead,
            if world_rank in self._dead:  # whichever comes first
                return
            self._dead.add(world_rank)
        try:
            self._w.peer_failed(world_rank)
        except Exception:                # noqa: BLE001 — reclaim is
            pass                         # best-effort on this path
        ep = self._epoch
        if (ep.fenced or ep.lock_all or ep.locked or ep.pscw_access
                or ep.pscw_exposure):
            _base.stats["ft_failed_epochs"] += 1
            _flightrec.record("rma_proc_failed",
                              {"rank": world_rank, "win": self.name,
                               "reason": reason})

    def _instrumented(self, kind: str, target: int, nbytes: int,
                      thunk):
        tok = (_trace.begin(f"osc.{kind}", target=target,
                            bytes=nbytes)
               if _trace.active else None)
        t0 = _time.perf_counter() if _tele.active else 0.0
        ok = False
        try:
            out = thunk()
            ok = True
            return out
        finally:
            if tok is not None:
                _trace.end(tok, ok=ok)
            if _tele.active:
                _base.op_hist(kind).record(
                    (_time.perf_counter() - t0) * 1e6)

    def _account(self, kind: str, nbytes: int) -> None:
        _base.stats[f"{kind}s"] += 1
        _base.stats[f"{kind}_bytes"] += int(nbytes)
        self._bytes += int(nbytes)

    # -- data ops --------------------------------------------------------
    def put(self, data, target: int, disp: int = 0) -> None:
        self._guard(self._epoch.check_access, target, "put")
        self._check_dead("RMA put", target)
        arr = host_array(data, self._w.dtype)
        n = int(arr.nbytes)
        self._instrumented("put", target, n,
                           lambda: self._w.put(arr, target, disp))
        self._account("put", n)

    def get(self, target: int, disp: int = 0, count: int = 1):
        self._guard(self._epoch.check_access, target, "get")
        self._check_dead("RMA get", target)
        n = int(count) * self._w.dtype.itemsize
        out = self._instrumented(
            "get", target, n,
            lambda: self._w.get(target, disp, count))
        self._account("get", n)
        return out

    def accumulate(self, data, target: int, disp: int = 0,
                   op: str = "sum") -> None:
        self._guard(self._epoch.check_access, target, "accumulate")
        self._check_dead("RMA accumulate", target)
        arr = host_array(data, self._w.dtype)
        n = int(arr.nbytes)
        self._instrumented(
            "acc", target, n,
            lambda: self._w.accumulate(arr, target, disp, op))
        self._account("acc", n)

    def get_accumulate(self, data, target: int, disp: int = 0,
                       op: str = "sum"):
        self._guard(self._epoch.check_access, target, "accumulate")
        self._check_dead("RMA get_accumulate", target)
        arr = host_array(data, self._w.dtype)
        n = int(arr.nbytes)
        out = self._instrumented(
            "acc", target, n,
            lambda: self._w.get_accumulate(arr, target, disp, op))
        self._account("acc", n)
        return out

    def fetch_and_op(self, value, target: int, disp: int = 0,
                     op: str = "sum"):
        out = self.get_accumulate(
            host_array(value, self._w.dtype).ravel()[:1], target, disp,
            op)
        return out[0]

    def compare_and_swap(self, compare, origin, target: int,
                         disp: int = 0):
        self._guard(self._epoch.check_access, target, "accumulate")
        self._check_dead("RMA compare_and_swap", target)
        n = int(self._w.dtype.itemsize)
        out = self._instrumented(
            "acc", target, n,
            lambda: self._w.compare_and_swap(compare, origin, target,
                                             disp))
        self._account("acc", n)
        return out

    # -- typed ops (byte-addressed C ABI windows) ----------------------
    def accumulate_typed(self, data, target: int, byte_disp: int,
                         op: str = "sum") -> None:
        self._guard(self._epoch.check_access, target, "accumulate")
        self._check_dead("RMA accumulate", target)
        arr = np.ascontiguousarray(host_array(data)).ravel()
        n = int(arr.nbytes)
        self._instrumented(
            "acc", target, n,
            lambda: self._w.accumulate_typed(arr, target, byte_disp,
                                             op))
        self._account("acc", n)

    def get_accumulate_typed(self, data, target: int, byte_disp: int,
                             op: str = "sum"):
        self._guard(self._epoch.check_access, target, "accumulate")
        self._check_dead("RMA get_accumulate", target)
        arr = np.ascontiguousarray(host_array(data)).ravel()
        n = int(arr.nbytes)
        out = self._instrumented(
            "acc", target, n,
            lambda: self._w.get_accumulate_typed(arr, target,
                                                 byte_disp, op))
        self._account("acc", n)
        return out

    def compare_and_swap_typed(self, compare, origin, target: int,
                               byte_disp: int):
        self._guard(self._epoch.check_access, target, "accumulate")
        self._check_dead("RMA compare_and_swap", target)
        out = self._instrumented(
            "acc", target, 0,
            lambda: self._w.compare_and_swap_typed(compare, origin,
                                                   target, byte_disp))
        self._account("acc", host_array(origin).ravel()[:1].nbytes)
        return out

    # -- request-based ops ---------------------------------------------
    def rput(self, data, target: int, disp: int = 0):
        self._guard(self._epoch.check_access, target, "put")
        self._check_dead("RMA rput", target)
        arr = host_array(data, self._w.dtype)
        self._account("put", int(arr.nbytes))
        return self._w.rput(arr, target, disp)

    def rget(self, target: int, disp: int = 0, count: int = 1):
        self._guard(self._epoch.check_access, target, "get")
        self._check_dead("RMA rget", target)
        self._account("get", int(count) * self._w.dtype.itemsize)
        return self._w.rget(target, disp, count)

    def raccumulate(self, data, target: int, disp: int = 0,
                    op: str = "sum"):
        self._guard(self._epoch.check_access, target, "accumulate")
        self._check_dead("RMA raccumulate", target)
        arr = host_array(data, self._w.dtype)
        self._account("acc", int(arr.nbytes))
        return self._w.raccumulate(arr, target, disp, op)

    # -- synchronization -------------------------------------------------
    def _epoch_span(self, phase: str, thunk):
        tok = (_trace.begin("osc.epoch", phase=phase,
                            win=self.name)
               if _trace.active else None)
        ok = False
        try:
            out = thunk()
            ok = True
            return out
        finally:
            if tok is not None:
                _trace.end(tok, ok=ok)

    def fence(self) -> None:
        self._guard(self._epoch.fence)
        self._check_dead("Win_fence")
        self._epoch_span("fence", self._w.fence)
        _base.stats["fences"] += 1

    def lock(self, target: int,
             lock_type: int = LOCK_EXCLUSIVE) -> None:
        self._guard(self._epoch.lock, target)
        self._check_dead("Win_lock", target)
        self._epoch_span("lock",
                         lambda: self._w.lock(target, lock_type))
        self._epoch.locked_ok(target, lock_type)
        _base.stats["locks"] += 1

    def unlock(self, target: int) -> None:
        self._guard(self._epoch.unlock, target)
        self._epoch_span("unlock", lambda: self._w.unlock(target))
        self._epoch.unlocked_ok(target)

    def lock_all(self) -> None:
        self._guard(self._epoch.lock_all_begin)
        self._check_dead("Win_lock_all")

        def _all():
            for r in range(self.comm.size):
                self._w.lock(r, LOCK_SHARED)
        self._epoch_span("lock_all", _all)
        self._epoch.lock_all_ok()
        _base.stats["locks"] += 1

    def unlock_all(self) -> None:
        self._guard(self._epoch.unlock_all)

        def _all():
            for r in range(self.comm.size):
                self._w.unlock(r)
        self._epoch_span("unlock_all", _all)

    def flush(self, target: int = -1) -> None:
        self._guard(self._epoch.flush,
                    None if target < 0 else target)
        self._w.flush(target)

    def flush_all(self) -> None:
        self.flush(-1)

    def flush_local(self, target: int = -1) -> None:
        self.flush(target)

    def flush_local_all(self) -> None:
        self.flush(-1)

    # -- PSCW ------------------------------------------------------------
    def start(self, target_ranks) -> None:
        self._check_dead("Win_start")
        self._epoch_span("start",
                         lambda: self._w.start(target_ranks))
        self._epoch.start(target_ranks)

    def complete(self) -> None:
        self._guard(self._epoch.complete)
        self._epoch_span("complete", self._w.complete)
        if not self._epoch_check:        # keep both paths consistent
            self._epoch.pscw_access = set()

    def post(self, origin_ranks) -> None:
        self._check_dead("Win_post")
        self._epoch_span("post", lambda: self._w.post(origin_ranks))
        self._epoch.post(origin_ranks)

    def wait(self) -> None:
        self._guard(self._epoch.wait)
        self._epoch_span("wait", self._w.wait)
        if not self._epoch_check:
            self._epoch.pscw_exposure = set()

    # -- lifecycle -------------------------------------------------------
    def free(self) -> None:
        if self._freed:
            return
        self._freed = True
        _base.untrack_window(self)
        try:
            _ft.remove_listener(self._ft_cb)
        except Exception:                # noqa: BLE001 — registry may
            pass                         # already be torn down
        _pvar.pvar_unregister(self._pvar_name)
        self._epoch_span("free", self._w.free)

    def __getattr__(self, name: str):
        # framework attrs live on self; everything else (local, sizes,
        # wid, dtype, size, the C-ABI pins) is the component's
        if name.startswith("__"):
            raise AttributeError(name)
        return getattr(object.__getattribute__(self, "_w"), name)


def _host_dtype(dtype) -> np.dtype:
    return numpy_dtype(dtype) if isinstance(dtype, torch.dtype) \
        else np.dtype(dtype)


def win_allocate(comm, size: int, dtype=np.float32, name: str = "",
                 force: Optional[str] = None) -> RmaWindow:
    """MPI_Win_allocate: the framework owns the exposure memory, so
    the selection step may place it in a /dev/shm segment. ``dtype`` is
    a numpy or torch dtype."""
    if getattr(comm, "router", None) is None:
        raise MPIError(ERR_WIN,
                       "framework windows require the per-rank "
                       "execution model (the stacked world keeps "
                       "MPI.Win)")
    return RmaWindow(comm, size, _host_dtype(dtype), name=name,
                     force=force)


def win_create(comm, storage, name: str = "",
               force: Optional[str] = None) -> RmaWindow:
    """MPI_Win_create: caller-owned memory — a numpy array, or a CPU
    tensor whose memory the window aliases — pinned to osc/pt2pt by
    selection (user memory cannot be retroactively shm-backed). Device
    memory is refused: the exposure region is host memory."""
    if getattr(comm, "router", None) is None:
        raise MPIError(ERR_WIN,
                       "framework windows require the per-rank "
                       "execution model (the stacked world keeps "
                       "MPI.Win)")
    if isinstance(storage, torch.Tensor):
        if storage.device.type != "cpu":
            raise MPIError(ERR_WIN,
                           f"window storage on {storage.device}: "
                           f"per-rank windows expose host memory")
        storage = storage.detach().numpy()
    return RmaWindow(comm, int(storage.size), storage.dtype,
                     name=name, storage=storage, force=force)
