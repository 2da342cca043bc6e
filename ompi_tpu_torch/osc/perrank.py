"""osc/perrank — one-sided RMA windows for the per-rank execution model.

Behavioral spec: ``ompi/mca/osc/rdma`` — put/get/accumulate against a
remote exposure region (``osc_rdma_comm.c`` fragments the transfer and
targets the peer's registered memory), active-target ``fence`` epochs,
and passive-target ``lock/unlock`` built on remote atomics
(``osc_rdma_lock.h``); ``osc/sm`` services the same interface over
shared memory. The JAX package's ``osc/perrank.py`` is the reference.

Every rank is an OS process, so a window is a LOCAL exposure region (a
numpy buffer in host memory) plus an active-message handler registered
with the process Router (``register_rma``): an origin's put, get,
accumulate, fetch_op or compare_and_swap is one framed message over the
byte planes, applied to the target's region ON THE TARGET'S READER
THREAD under the window lock — the target's application thread never
participates. Every operation is acked (a get's or fetch's data rides
its ack), so origin-side completion is remote completion and ``fence``
is a comm barrier. Passive-target ``lock/unlock`` run a FIFO grant queue
at the target (exclusive vs shared), with grants delivered as acks.

A CUDA tensor handed to an origin call is staged to the host with one
``.cpu()`` copy (``host_array``): the exposure region is host memory.
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ompi_tpu_torch.accelerator import to_numpy
from ompi_tpu_torch.core.errhandler import ERR_ARG, ERR_RANK, MPIError
# dtype-preserving numpy combiners (the shared host fold table)
from ompi_tpu_torch.core.op import NP_COMBINERS as _NP_COMBINERS

LOCK_EXCLUSIVE = 1
LOCK_SHARED = 2

# the host fold table plus the two accumulate-only pseudo-ops
_ACC_OPS = {
    **_NP_COMBINERS,
    "replace": None,                    # MPI_REPLACE
    "no_op": False,                     # MPI_NO_OP (fetch only)
}


def host_array(data, dtype=None) -> np.ndarray:
    """``data`` as a host numpy array of ``dtype``: a tensor (on any
    device) takes one ``.cpu()`` copy, anything else ``np.asarray``."""
    if isinstance(data, torch.Tensor):
        data = to_numpy(data)
    return np.asarray(data) if dtype is None else np.asarray(data, dtype)


class RankWindow:
    """An RMA window whose caller is one rank (collective creation)."""

    # osc framework component name (osc/pt2pt is the emulation over
    # the acked active-message plane — this class IS that component;
    # osc/shm subclasses it and overrides the data ops)
    component = "pt2pt"

    def __init__(self, comm, size: int, dtype=np.float32,
                 name: str = "", storage: Optional[np.ndarray] = None):
        """``storage``: use the CALLER's memory as the exposure region
        (MPI_Win_create over user-allocated memory,
        win_create.c.in:79): remote puts applied by the reader thread
        land directly in it, so the owner's plain loads observe them —
        the osc/sm shared-window model."""
        self.comm = comm
        self.size = int(size)
        self.dtype = np.dtype(dtype)
        if storage is not None:
            if (storage.dtype != self.dtype or storage.ndim != 1
                    or storage.size != self.size
                    or not storage.flags.writeable):
                raise MPIError(ERR_ARG, "bad window storage array")
        # window id must agree across ranks: creation is collective ON
        # THIS communicator, so the sequence lives on the comm — a
        # process-global counter would diverge when ranks have created
        # different numbers of windows on OTHER comms
        if not hasattr(comm, "_win_seq"):
            comm._win_seq = itertools.count(0)
        seq = next(comm._win_seq)
        self.wid = ("win", comm.cid, seq)
        self.name = name or f"win#{seq}"
        self.local = (storage if storage is not None
                      else np.zeros(self.size, self.dtype))
        self._lock = threading.Lock()
        # passive-target lock state (target side)
        self._holders: List[Tuple[int, int]] = []   # (origin, type)
        self._waiters: List[Tuple[int, int, int]] = []  # (+ack id)
        self.comm.router.register_rma(self.wid, self._handle)
        # per-process window sizes may legitimately differ (MPI_Win):
        # exchange them so origin-side bounds checks use the TARGET's
        # exposure size (the osc_rdma region-table role); doubles as
        # the expose-epoch barrier
        self.sizes = [int(x) for x in self.comm.allgather(self.size)]

    # ------------------------------------------------------------------
    def _check_target(self, rank: int) -> int:
        if not (0 <= rank < self.comm.size):
            raise MPIError(ERR_RANK, f"bad target rank {rank}")
        return self.comm.world_rank_of(rank)

    def _rpc(self, target: int, header: dict, payload: Any = None,
             timeout: float = 120):
        """One acked active message to ``target``'s window handler."""
        from ompi_tpu_torch.btl.tcp import encode_payload
        router = self.comm.router
        aid, ev = router.new_ack()
        header.update(rma=True, wid=self.wid, ack_id=aid,
                      origin=router.rank)
        raw = b""
        if payload is not None:
            header["desc"], raw = encode_payload(payload)
        router.endpoint.send_frame(self._check_target(target), header,
                                   raw)
        if not ev.wait(timeout):
            router.cancel_ack(aid)
            raise MPIError(ERR_ARG, f"RMA {header.get('op')} to rank "
                                    f"{target} timed out")
        reply = router.take_ack_reply(aid)
        if isinstance(reply, dict) and "rma_error" in reply:
            # target-side failure travels back as an error reply, so
            # the origin raises promptly instead of timing out
            raise MPIError(ERR_ARG,
                           f"RMA {header.get('op')} failed at rank "
                           f"{target}: {reply['rma_error']}")
        return reply

    # -- origin-side API -------------------------------------------------
    def put(self, data, target: int, disp: int = 0) -> None:
        arr = host_array(data, self.dtype).ravel()
        self._bounds(disp, arr.size, target)
        self._rpc(target, {"op": "put", "disp": int(disp)}, arr)

    def get(self, target: int, disp: int = 0, count: int = 1):
        self._bounds(disp, count, target)
        return self._rpc(target, {"op": "get", "disp": int(disp),
                                  "count": int(count)})

    def accumulate(self, data, target: int, disp: int = 0,
                   op: str = "sum") -> None:
        if op not in _ACC_OPS or _ACC_OPS[op] is False:
            raise MPIError(ERR_ARG, f"bad accumulate op {op!r}")
        arr = host_array(data, self.dtype).ravel()
        self._bounds(disp, arr.size, target)
        self._rpc(target, {"op": "acc", "disp": int(disp), "acc": op},
                  arr)

    def get_accumulate(self, data, target: int, disp: int = 0,
                       op: str = "sum"):
        if op not in _ACC_OPS:           # no_op is legal here (fetch)
            raise MPIError(ERR_ARG, f"bad accumulate op {op!r}")
        arr = host_array(data, self.dtype).ravel()
        self._bounds(disp, arr.size, target)
        return self._rpc(target, {"op": "getacc", "disp": int(disp),
                                  "acc": op}, arr)

    def accumulate_typed(self, data, target: int, byte_disp: int,
                         op: str = "sum") -> None:
        """Typed accumulate into a BYTE-addressed (uint8) window: the
        value keeps its own dtype and the target combines through a
        typed view of its byte storage — the C ABI's MPI_Accumulate
        path, where the window is raw allocated memory and each call
        brings its own datatype."""
        if self.dtype != np.dtype(np.uint8):
            raise MPIError(ERR_ARG,
                           "accumulate_typed requires a byte window")
        if op not in _ACC_OPS or _ACC_OPS[op] is False:
            raise MPIError(ERR_ARG, f"bad accumulate op {op!r}")
        arr = np.ascontiguousarray(host_array(data)).ravel()
        self._bounds(byte_disp, arr.nbytes, target)
        self._rpc(target, {"op": "acc", "disp": int(byte_disp),
                           "acc": op}, arr)

    def fetch_and_op(self, value, target: int, disp: int = 0,
                     op: str = "sum"):
        out = self.get_accumulate(host_array(value, self.dtype).ravel()[:1],
                                  target, disp, op)
        return out[0]

    # -- typed origin entry points for byte-addressed (C ABI) windows --
    def get_accumulate_typed(self, data, target: int, byte_disp: int,
                             op: str = "sum"):
        """Fetch-and-accumulate with the VALUE's dtype against a uint8
        window (MPI_Get_accumulate from C: raw window memory, each
        call brings its own datatype). Returns the prior typed
        contents."""
        if self.dtype != np.dtype(np.uint8):
            raise MPIError(ERR_ARG, "typed RMA requires a byte window")
        if op not in _ACC_OPS:
            raise MPIError(ERR_ARG, f"bad accumulate op {op!r}")
        arr = np.ascontiguousarray(host_array(data)).ravel()
        self._bounds(byte_disp, arr.nbytes, target)
        return self._rpc(target, {"op": "getacc",
                                  "disp": int(byte_disp), "acc": op},
                         arr)

    def compare_and_swap_typed(self, compare, origin, target: int,
                               byte_disp: int):
        if self.dtype != np.dtype(np.uint8):
            raise MPIError(ERR_ARG, "typed RMA requires a byte window")
        pair = np.ascontiguousarray(
            np.stack([host_array(origin).ravel()[0],
                      host_array(compare).ravel()[0]]))
        self._bounds(byte_disp, pair.dtype.itemsize, target)
        return self._rpc(target, {"op": "cas", "disp": int(byte_disp)},
                         pair)[0]

    # -- request-based operations (osc.h:269-279 rput/rget) ------------
    def rput(self, data, target: int, disp: int = 0):
        """MPI_Rput: returns a request; completion == remote completion
        (every op here is target-acked)."""
        from ompi_tpu_torch.pml.perrank import thread_request
        return thread_request(lambda: self.put(data, target, disp))

    def rget(self, target: int, disp: int = 0, count: int = 1):
        """MPI_Rget: the request's payload is the fetched array."""
        from ompi_tpu_torch.pml.perrank import thread_request
        return thread_request(lambda: self.get(target, disp, count))

    def raccumulate(self, data, target: int, disp: int = 0,
                    op: str = "sum"):
        from ompi_tpu_torch.pml.perrank import thread_request
        return thread_request(
            lambda: self.accumulate(data, target, disp, op))

    def compare_and_swap(self, compare, origin, target: int,
                         disp: int = 0):
        self._bounds(disp, 1, target)
        # compare travels IN the typed payload next to the origin value
        # (a float() round-trip would corrupt int64 values > 2**53)
        pair = np.stack([host_array(origin, self.dtype).ravel()[0],
                         host_array(compare, self.dtype).ravel()[0]])
        return self._rpc(target, {"op": "cas", "disp": int(disp)},
                         pair)[0]

    # -- synchronization ---------------------------------------------
    def fence(self) -> None:
        """Active target: all ops are remotely complete when acked, so
        the epoch boundary is the comm barrier."""
        self.comm.barrier()

    def lock(self, target: int, lock_type: int = LOCK_EXCLUSIVE) -> None:
        self._rpc(target, {"op": "lock", "lt": int(lock_type)})

    def unlock(self, target: int) -> None:
        self._rpc(target, {"op": "unlock"})

    def flush(self, target: int = -1) -> None:
        pass                            # every op is acked: always flushed

    # -- PSCW active-target epochs (MPI_Win_post/start/complete/wait,
    # osc_rdma_active_target.c semantics): every RMA op here is
    # target-acked before returning, so origin completion already
    # implies remote completion — the epochs reduce to their token
    # exchanges over a hidden pt2pt channel, which is exactly the
    # synchronization contract the standard requires.
    def _pscw_engine(self):
        from ompi_tpu_torch.core.rankcomm import hidden_engine
        return hidden_engine(self.comm, "pscw")

    def _pscw_tag(self, phase: int) -> int:
        # per-window tags: seq * 2 + phase (0 = post, 1 = complete)
        return int(self.wid[-1]) * 2 + phase

    def post(self, origin_ranks) -> None:
        """Target side: expose the window to ``origin_ranks``."""
        eng = self._pscw_engine()
        self._pscw_origins = list(origin_ranks)
        for o in self._pscw_origins:
            eng.send(None, o, self._pscw_tag(0))

    def start(self, target_ranks) -> None:
        """Origin side: wait for each target's post token."""
        eng = self._pscw_engine()
        self._pscw_targets = list(target_ranks)
        for t in self._pscw_targets:
            eng.recv(t, self._pscw_tag(0))

    def complete(self) -> None:
        """Origin side: epoch ends — ops are already target-acked, so
        one token per target carries the completion."""
        eng = self._pscw_engine()
        for t in getattr(self, "_pscw_targets", []):
            eng.send(None, t, self._pscw_tag(1))
        self._pscw_targets = []

    def wait(self) -> None:
        """Target side: block until every origin completed."""
        eng = self._pscw_engine()
        for o in getattr(self, "_pscw_origins", []):
            eng.recv(o, self._pscw_tag(1))
        self._pscw_origins = []

    def free(self) -> None:
        # the completion barrier can raise over a dead/revoked peer
        # (ULFM free); the handler must unregister regardless or the
        # router keeps dispatching frames into a freed window
        try:
            self.comm.barrier()
        finally:
            self.comm.router.unregister_rma(self.wid)

    def peer_failed(self, world_rank: int) -> None:
        """FT reclaim hook (osc/window wires it to the ft registry):
        a dead origin can never send its unlock, so purge it from the
        passive-lock queue and hand its grant to the next waiter —
        otherwise one SIGKILL wedges every survivor's Win_lock."""
        grants = []
        with self._lock:
            self._holders = [(o, t) for (o, t) in self._holders
                             if o != world_rank]
            self._waiters = [(o, t, a) for (o, t, a) in self._waiters
                             if o != world_rank]
            while self._waiters:
                o, t, a = self._waiters[0]
                ok = (not self._holders if t == LOCK_EXCLUSIVE
                      else all(ht == LOCK_SHARED
                               for _, ht in self._holders))
                if not ok:
                    break
                self._waiters.pop(0)
                self._holders.append((o, t))
                grants.append((o, a))
                if t == LOCK_EXCLUSIVE:
                    break
        for o, a in grants:
            try:
                self.comm.router.send_ack(o, a)
            except Exception:            # noqa: BLE001 — a grant to a
                pass                     # failing peer is best-effort

    def _bounds(self, disp: int, count: int,
                target: Optional[int] = None) -> None:
        limit = (self.sizes[target] if target is not None
                 else self.size)
        if disp < 0 or disp + count > limit:
            raise MPIError(ERR_ARG,
                           f"window access [{disp}, {disp + count}) "
                           f"outside [0, {limit}) at rank "
                           f"{target if target is not None else 'self'}")

    # -- target-side handler (runs on btl reader threads) --------------
    def _handle(self, header: dict, raw: bytes) -> None:
        # runs on a btl reader thread: NOTHING may escape (an uncaught
        # exception would kill the reader and silently drop every later
        # frame from that peer) — failures reply as rma_error
        try:
            self._handle_inner(header, raw)
        except Exception as e:          # noqa: BLE001
            self.comm.router.send_ack(
                header["origin"], header["ack_id"],
                {"rma_error": f"{type(e).__name__}: {e}"})

    def _handle_inner(self, header: dict, raw: bytes) -> None:
        from ompi_tpu_torch.btl.tcp import decode_payload
        router = self.comm.router
        origin_world = header["origin"]          # world rank of origin
        op = header["op"]
        aid = header["ack_id"]
        data = (decode_payload(header["desc"], raw)
                if "desc" in header else None)
        if op == "lock":
            self._lock_request(origin_world, header["lt"], aid)
            return
        reply = None
        with self._lock:
            if op == "put":
                d = header["disp"]
                if d + data.size > self.size:
                    raise MPIError(ERR_ARG, "put past exposure region")
                self.local[d:d + data.size] = data
            elif op == "get":
                d, c = header["disp"], header["count"]
                if d + c > self.size:
                    raise MPIError(ERR_ARG, "get past exposure region")
                reply = self.local[d:d + c].copy()
            elif op == "acc":
                d = header["disp"]
                fn = _ACC_OPS[header["acc"]]
                if self.dtype == np.uint8 and data.dtype != np.uint8:
                    # typed accumulate into a BYTE-addressed window
                    # (the C ABI's Win_allocate windows): combine
                    # through a typed view of the byte storage, still
                    # atomically on this reader thread
                    nb = data.nbytes
                    seg = self.local[d:d + nb].view(data.dtype)
                    out = data if fn is None else fn(seg, data)
                    self.local[d:d + nb] = \
                        np.ascontiguousarray(out).view(np.uint8)
                else:
                    seg = self.local[d:d + data.size]
                    self.local[d:d + data.size] = (
                        data if fn is None else fn(seg, data))
            elif op == "getacc":
                d = header["disp"]
                fn = _ACC_OPS.get(header["acc"])
                if self.dtype == np.uint8 and data.dtype != np.uint8:
                    # typed fetch-accumulate into a byte-addressed
                    # window (C ABI Get_accumulate/Fetch_and_op)
                    nb = data.nbytes
                    seg = self.local[d:d + nb].view(data.dtype)
                    reply = seg.copy()
                    if fn is not False:  # MPI_NO_OP fetches only
                        out = data if fn is None else fn(seg, data)
                        self.local[d:d + nb] = \
                            np.ascontiguousarray(out).view(np.uint8)
                else:
                    seg = self.local[d:d + data.size]
                    reply = seg.copy()
                    if fn is not False:  # MPI_NO_OP fetches only
                        self.local[d:d + data.size] = (
                            data if fn is None else fn(seg, data))
            elif op == "cas":
                d = header["disp"]
                if self.dtype == np.uint8 and data.dtype != np.uint8:
                    # typed CAS against a byte-addressed window
                    esz = data.dtype.itemsize
                    seg = self.local[d:d + esz].view(data.dtype)
                    reply = seg.copy()
                    if seg[0] == data[1]:
                        self.local[d:d + esz] = np.ascontiguousarray(
                            data[0:1]).view(np.uint8)
                else:
                    reply = np.array([self.local[d]], self.dtype)
                    if self.local[d] == data[1]:  # typed compare
                        self.local[d] = data[0]
            elif op == "unlock":
                self._unlock(origin_world, aid)
                return
        router.send_ack(origin_world, aid, reply)

    # -- passive-target lock queue (target side, non-blocking) --------
    def _lock_request(self, origin: int, lt: int, aid: int) -> None:
        with self._lock:
            grant = (not self._holders if lt == LOCK_EXCLUSIVE
                     else all(t == LOCK_SHARED
                              for _, t in self._holders))
            if grant and not self._waiters:
                self._holders.append((origin, lt))
            else:
                self._waiters.append((origin, lt, aid))
                return
        self.comm.router.send_ack(origin, aid)   # grant

    def _unlock(self, origin: int, aid: int) -> None:
        # caller holds self._lock
        self._holders = [(o, t) for (o, t) in self._holders
                         if o != origin]
        grants = []
        while self._waiters:
            o, t, a = self._waiters[0]
            ok = (not self._holders if t == LOCK_EXCLUSIVE
                  else all(ht == LOCK_SHARED
                           for _, ht in self._holders))
            if not ok:
                break
            self._waiters.pop(0)
            self._holders.append((o, t))
            grants.append((o, a))
            if t == LOCK_EXCLUSIVE:
                break
        router = self.comm.router
        router.send_ack(origin, aid)             # unlock complete
        for o, a in grants:
            router.send_ack(o, a)                # deferred lock grants
