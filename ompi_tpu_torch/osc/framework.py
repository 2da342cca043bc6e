"""OSC — one-sided communication on the stacked communicator (RMA windows).

Behavioral spec: ``ompi/mca/osc/osc.h:373`` (module interface; put :210,
get :220, request-based rput/rget :269/:279), osc/rdma's active-target
(``osc_rdma_active_target.c``) and passive-target (``osc_rdma_lock.h``)
synchronization; the JAX package's ``osc/framework.py`` is the
reference.

Single controller: a window is one stacked ``(nranks, size)`` buffer,
one row per rank, from ``comm.alloc`` on the communicator's device (a
CUDA card, or the CPU). ``put`` and ``accumulate`` update the target's
row IN PLACE on that device (``copy_`` of a slice; an accumulate
combines through ``Op.__call__``, so uint16/32/64 take the signed twin),
and a CUDA origin never leaves the card. A numpy origin takes its one
host-to-device copy. ``get`` returns a host numpy copy of the region,
as the reference does; ``fetch_and_op`` and ``compare_and_swap`` read
the one element they need.

``Win.create(comm, buffer)`` exposes the caller's stacked tensor (or
numpy array) itself: updates change the caller's buffer, MPI's
semantics. Epochs follow the stream: request-based operations complete
on a CUDA event recorded after their work, ``fence`` and ``flush``
synchronize the window's stream, and passive-target ``lock/unlock``
serialize controller-side access.
"""
from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np
import torch

from ompi_tpu_torch.accelerator import to_numpy
from ompi_tpu_torch.core import op as op_mod
from ompi_tpu_torch.core.errhandler import (ERR_ARG, ERR_INTERN, ERR_RANK,
                                            MPIError)
from ompi_tpu_torch.core.request import Request, event_after

LOCK_EXCLUSIVE = 1
LOCK_SHARED = 2


def _origin(data, like):
    """``data`` as a 1-D run of the window's dtype where the window
    lives: a tensor on the window's device stays there (a cast at most),
    a host value takes one copy to it."""
    if isinstance(like, torch.Tensor):
        if isinstance(data, torch.Tensor):
            return data.reshape(-1).to(device=like.device, dtype=like.dtype)
        arr = np.ascontiguousarray(np.asarray(data).reshape(-1))
        return torch.from_numpy(arr).to(device=like.device,
                                        dtype=like.dtype)
    if isinstance(data, torch.Tensor):
        data = to_numpy(data)
    return np.asarray(data, dtype=like.dtype).reshape(-1)


class Win:
    """An RMA window over per-rank buffers of ``comm``.

    ``win = Win(comm, size)`` or ``Win.create(comm, stacked_buffer)``.
    All offsets/counts are in elements of the window's dtype.
    """

    def __init__(self, comm, size: int, dtype=np.float32,
                 buffer: Optional[Any] = None, name: str = ""):
        self.comm = comm
        if (getattr(comm, "is_multiprocess", False)
                or getattr(comm, "router", None) is not None):
            # window state is controller-local; a communicator whose
            # ranks are processes has no stacked rows to update
            raise MPIError(
                ERR_INTERN,
                "stacked RMA windows are single-controller only: this "
                "communicator spans processes. For cross-process RMA "
                "use Win_allocate / Win_create (osc/window.RmaWindow, "
                "under mpirun --per-rank).")
        if buffer is not None:
            if buffer.ndim < 2 or buffer.shape[0] != comm.size:
                raise MPIError(ERR_ARG,
                               "window buffer must be stacked (nranks, n)")
            self._buf = buffer
            self.size = int(buffer.shape[-1])
        else:
            self._buf = comm.alloc((size,), dtype)
            self.size = int(size)
        self.dtype = self._buf.dtype
        self.name = name or f"win#{comm.cid}"
        self._lock = threading.RLock()
        self._lock_state = {}           # rank -> lock type
        self.attributes = {}
        self._freed = False

    @classmethod
    def create(cls, comm, buffer, name: str = "") -> "Win":
        return cls(comm, 0, buffer=buffer, name=name)

    @classmethod
    def allocate(cls, comm, size: int, dtype=np.float32) -> "Win":
        return cls(comm, size, dtype=dtype)

    # -- access ---------------------------------------------------------
    def _check_rank(self, rank: int) -> None:
        if not (0 <= rank < self.comm.size):
            raise MPIError(ERR_RANK, f"target rank {rank} out of range")

    def _region(self, target_rank: int, target_disp: int, n: int):
        """The target's slice of the window: a view, updated in place."""
        self._check_rank(target_rank)
        if target_disp < 0 or target_disp + n > self.size:
            raise MPIError(ERR_ARG, "RMA access beyond window bounds")
        return self._buf[target_rank, target_disp:target_disp + n]

    def _update(self, target_rank: int, target_disp: int, data,
                op: Optional[op_mod.Op] = None) -> None:
        """``target = data`` (``op`` None) or ``target = op(target,
        data)`` on the target's row, in place where the window lives."""
        data = _origin(data, self._buf)
        with self._lock:
            cur = self._region(target_rank, target_disp, data.shape[0])
            if op is None:
                cur[...] = data
            elif isinstance(cur, torch.Tensor):
                cur.copy_(op(cur, data))
            else:
                cur[...] = op_mod.np_combiner(op)(cur, data)

    def put(self, origin_data, target_rank: int, target_disp: int = 0):
        """MPI_Put (osc.h:210)."""
        self._update(target_rank, target_disp, origin_data)

    def get(self, target_rank: int, target_disp: int = 0,
            count: Optional[int] = None) -> np.ndarray:
        """MPI_Get (osc.h:220): a host copy of the target region
        (functional API: recvbuf is the return value)."""
        count = count if count is not None else self.size - target_disp
        with self._lock:
            reg = self._region(target_rank, target_disp, count)
            if isinstance(reg, torch.Tensor) and reg.is_cuda:
                return to_numpy(reg)     # the device-to-host copy
            return np.array(to_numpy(reg) if isinstance(reg, torch.Tensor)
                            else reg)    # a copy, not a view of the row

    def accumulate(self, origin_data, target_rank: int,
                   op: op_mod.Op = op_mod.SUM, target_disp: int = 0):
        """MPI_Accumulate: REPLACE overwrites, NO_OP leaves the target."""
        if op is op_mod.NO_OP:
            return
        self._update(target_rank, target_disp, origin_data,
                     None if op is op_mod.REPLACE else op)

    def get_accumulate(self, origin_data, target_rank: int,
                       op: op_mod.Op = op_mod.SUM, target_disp: int = 0):
        """MPI_Get_accumulate: fetch-then-accumulate, atomic under the
        window lock."""
        n = (origin_data.numel() if isinstance(origin_data, torch.Tensor)
             else np.asarray(origin_data).size)
        with self._lock:
            old = self.get(target_rank, target_disp, n)
            self.accumulate(origin_data, target_rank, op, target_disp)
        return old

    def fetch_and_op(self, value, target_rank: int,
                     op: op_mod.Op = op_mod.SUM, target_disp: int = 0):
        return self.get_accumulate(np.asarray([value]), target_rank, op,
                                   target_disp)[0]

    def compare_and_swap(self, value, compare, target_rank: int,
                         target_disp: int = 0):
        with self._lock:
            old = self.get(target_rank, target_disp, 1)[0]
            if old == compare:
                self.put(np.asarray([value]), target_rank, target_disp)
        return old

    def _done(self) -> Request:
        """A request that completes on an event recorded after the
        window's queued work (complete at once on the CPU)."""
        return Request(event=event_after(self._buf)
                       if isinstance(self._buf, torch.Tensor) else None)

    def rput(self, origin_data, target_rank: int,
             target_disp: int = 0) -> Request:
        self.put(origin_data, target_rank, target_disp)
        return self._done()

    def rget(self, target_rank: int, target_disp: int = 0,
             count: Optional[int] = None) -> Request:
        return Request.completed(self.get(target_rank, target_disp, count))

    def raccumulate(self, origin_data, target_rank: int,
                    op: op_mod.Op = op_mod.SUM,
                    target_disp: int = 0) -> Request:
        """MPI_Raccumulate (osc.h request-based variants)."""
        self.accumulate(origin_data, target_rank, op, target_disp)
        return self._done()

    def rget_accumulate(self, origin_data, target_rank: int,
                        op: op_mod.Op = op_mod.SUM,
                        target_disp: int = 0) -> Request:
        return Request.completed(
            self.get_accumulate(origin_data, target_rank, op, target_disp))

    # -- synchronization ------------------------------------------------
    def _drain(self) -> None:
        if isinstance(self._buf, torch.Tensor) and self._buf.is_cuda:
            torch.cuda.current_stream(self._buf.device).synchronize()

    def fence(self) -> None:
        """MPI_Win_fence: drain outstanding device updates (the active
        target epoch boundary)."""
        self._drain()
        self.comm.barrier()

    def lock(self, target_rank: int, lock_type: int = LOCK_EXCLUSIVE):
        self._lock.acquire()
        self._lock_state[target_rank] = lock_type

    def unlock(self, target_rank: int):
        self._lock_state.pop(target_rank, None)
        self._lock.release()

    def lock_all(self):
        self.lock(-1)

    def unlock_all(self):
        self.unlock(-1)

    def flush(self, target_rank: int = -1) -> None:
        self._drain()

    def flush_all(self) -> None:
        self.flush()

    def sync(self) -> None:
        self.flush()

    # -- PSCW active-target (MPI_Win_post/start/complete/wait;
    #    osc_rdma_active_target.c generalized-sync semantics) -----------
    def post(self, group) -> None:
        """Expose this window to an access epoch by ``group``'s ranks."""
        self._exposure = tuple(group.world_ranks)

    def start(self, group) -> None:
        """Begin an access epoch targeting ``group``'s ranks; must pair
        with a matching ``post`` (checked at ``complete``)."""
        self._access = tuple(group.world_ranks)

    def complete(self) -> None:
        """End the access epoch: drain origin-side updates."""
        if getattr(self, "_access", None) is None:
            raise MPIError(ERR_ARG, "Win.complete without Win.start")
        self.flush()
        self._access = None

    def wait(self) -> None:
        """End the exposure epoch (accesses drain in stream order, so
        this is a flush)."""
        if getattr(self, "_exposure", None) is None:
            raise MPIError(ERR_ARG, "Win.wait without Win.post")
        self.flush()
        self._exposure = None

    def test(self) -> bool:
        """MPI_Win_test: nonblocking ``wait`` — exposure always drains
        in one flush here, so report completion and end the epoch."""
        if getattr(self, "_exposure", None) is None:
            return True
        self.wait()
        return True

    # -- dynamic windows (MPI_Win_create_dynamic / attach / detach) ----
    @classmethod
    def create_dynamic(cls, comm, dtype=np.float32) -> "Win":
        """A zero-size window that memory is attached to later."""
        w = cls(comm, 0, dtype=dtype, name=f"win_dyn#{comm.cid}")
        w._dynamic = True
        return w

    def attach(self, size: int) -> int:
        """Attach ``size`` elements (symmetrically, every rank) and
        return the base displacement of the new region — the analogue of
        the address the reference exchanges out-of-band after
        MPI_Win_attach."""
        if not getattr(self, "_dynamic", False):
            raise MPIError(ERR_ARG, "attach on a non-dynamic window")
        base = self.size
        if isinstance(self._buf, torch.Tensor):
            grown = self._buf.new_zeros((self.comm.size, base + size))
        else:
            grown = np.zeros((self.comm.size, base + size), self.dtype)
        grown[:, :base] = self._buf
        self._buf = grown
        self.size = base + size
        return base

    def detach(self, base: int) -> None:
        """Detach a region; the displacement range becomes invalid (the
        storage is kept — displacement validity is the MPI contract)."""
        if not getattr(self, "_dynamic", False):
            raise MPIError(ERR_ARG, "detach on a non-dynamic window")

    def get_group(self):
        """MPI_Win_get_group: the group of the window's communicator."""
        return self.comm.group

    # -- introspection ---------------------------------------------------
    @property
    def buffer(self):
        """The stacked window contents (rank-major)."""
        return self._buf

    def free(self) -> None:
        self._freed = True
        self._buf = None

    def __repr__(self):
        return f"Win({self.name}, size={self.size}, dtype={self.dtype})"
