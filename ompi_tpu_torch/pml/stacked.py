"""pml/stacked — the single-controller matching engine.

Behavioral spec: ob1's receive-side matching
(``ompi/mca/pml/ob1/pml_ob1_recvfrag.c:296-330``), as the JAX package's
``pml/stacked.py`` ports it: an arriving message is matched against the
posted-receive queue (source + tag, with MPI_ANY_SOURCE / MPI_ANY_TAG
wildcards); unmatched messages go to the unexpected queue in arrival
order; a new receive first searches the unexpected queue. Ordering is
FIFO per (source, dest, comm) — MPI's non-overtaking rule — so queues
are keyed by (dest, src) and the receiving rank is an explicit argument
(the controller performs every rank's receives).

Ranks share a controller, so "the wire" is queue state plus a device
copy. Torch tensors are mutable, so every tensor payload is snapshotted
at send with ``clone()`` on the current stream (a numpy payload with
``copy()``): MPI lets the sender reuse its buffer the moment send
returns, and a view into a stacked tensor written later must not change
the message. The protocol switch (``pml_ob1_sendreq.h:389``) keeps its
var: a payload above ``pml_stacked_eager_limit`` is cloned onto the
destination rank's device (the rendezvous/RDMA-put tier); at or below
it the clone stays where the payload was (the eager copy). Partitioned
pt2pt rides a separate matching *channel*, so its fragments can never
cross-match user tags.

The pessimist message-logging engine (``pml/vprotocol``) subclasses this
one. Matching has two equivalent backends: the C++ core
(``native/matching.cpp``, integer descriptors in native queues, payloads
held here by handle) when the native library loaded, else the Python
queues; ``OMPI_TPU_TORCH_DISABLE_NATIVE_MATCH=1`` forces the Python one.
"""
from __future__ import annotations

import os
import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ompi_tpu_torch.core.errhandler import (ERR_BUFFER, ERR_PENDING, ERR_RANK,
                                            ERR_TAG, MPIError)
from ompi_tpu_torch.core.request import Request, Status

ANY_SOURCE = -1
ANY_TAG = -1
PROC_NULL = -2

CH_P2P = 0          # ordinary sends/recvs (int tags)
CH_PART = 1         # partitioned pt2pt fragments (tuple tags)

# the C++ matching core keeps its engines in one process-wide table, and
# ctypes releases the GIL around every call: one lock orders them all
_NATIVE_LOCK = threading.RLock()


def _register_vars() -> None:
    from ompi_tpu_torch.mca import var
    var.var_register(
        "pml", "stacked", "eager_limit", vtype="int",
        default=1 << 16,
        help="Tensor payloads above this many bytes are cloned onto the "
             "destination rank's device at send time (the rendezvous/"
             "RDMA-put tier); smaller ones are cloned where they are (the "
             "eager copy), mirroring btl_eager_limit's protocol switch")


_register_vars()


def elements(data) -> int:
    """MPI_Get_count's element count of a payload: ``numel()`` of a
    tensor, ``size`` of a numpy array or scalar, 1 for anything else."""
    if isinstance(data, torch.Tensor):
        return data.numel()
    if isinstance(data, (np.ndarray, np.generic)):
        return int(data.size)
    return 1


def _nbytes(data) -> int:
    if isinstance(data, torch.Tensor):
        return data.numel() * data.element_size()
    return int(getattr(data, "nbytes", 0) or 0)


class _Msg:
    __slots__ = ("src", "dest", "tag", "data", "synchronous", "channel")

    def __init__(self, src: int, dest: int, tag, data: Any,
                 synchronous: bool = False, channel: int = CH_P2P):
        self.src = src
        self.dest = dest
        self.tag = tag
        self.data = data
        self.synchronous = synchronous
        self.channel = channel


class _PostedRecv:
    __slots__ = ("src", "dest", "tag", "channel", "req")

    def __init__(self, src: int, dest: int, tag, channel: int,
                 req: "PtpRequest"):
        self.src = src
        self.dest = dest
        self.tag = tag
        self.channel = channel
        self.req = req

    def matches(self, msg: _Msg) -> bool:
        return (self.channel == msg.channel
                and self.dest == msg.dest
                and (self.src == ANY_SOURCE or self.src == msg.src)
                and (self.tag == ANY_TAG or self.tag == msg.tag))


def _status(msg: _Msg) -> Status:
    return Status(source=msg.src,
                  tag=msg.tag if isinstance(msg.tag, int) else -1,
                  count=elements(msg.data))


class PtpRequest(Request):
    """A receive request completed by the matching engine (not by device
    readiness): ``test`` polls match state."""

    def __init__(self, engine: "MatchingEngine", src: int, tag):
        super().__init__()
        self._complete = False
        self._engine = engine
        self.status = Status(source=src,
                             tag=tag if isinstance(tag, int) else -1)

    def deliver(self, msg: _Msg) -> None:
        self._result = msg.data
        st = _status(msg)
        self.status.source = st.source
        if isinstance(msg.tag, int):
            self.status.tag = st.tag
        self.status.count = st.count
        self._complete = True

    def _check_ft(self) -> None:
        """Request-level fault tolerance (ompi/request/req_ft.c): a
        pending receive whose communicator was revoked, or whose (named)
        peer has failed, completes in error rather than deadlocking."""
        comm = getattr(self._engine, "comm", None)
        if comm is None or getattr(comm, "group", None) is None:
            return
        from ompi_tpu_torch.core.errhandler import (ERR_PROC_FAILED,
                                                    ERR_REVOKED)
        if getattr(comm, "_revoked", False):
            raise MPIError(ERR_REVOKED,
                           "pending receive on a revoked communicator")
        from ompi_tpu_torch.runtime import ft
        reg = getattr(comm, "_ft", ft)   # the comm's failure domain
        src = self.status.source
        if src == ANY_SOURCE:
            unacked = [w for w in comm.group.world_ranks
                       if reg.is_failed(w)
                       and w not in comm._acked_failures]
            if unacked:
                raise MPIError(ERR_PROC_FAILED,
                               f"wildcard receive with unacknowledged "
                               f"failed world rank(s) {unacked}")
        elif 0 <= src < comm.size and reg.is_failed(
                comm.group.world_ranks[src]):
            raise MPIError(ERR_PROC_FAILED,
                           f"receive peer rank {src} has failed")

    def test(self):
        if not self._complete:
            self._check_ft()
        return (True, self.status) if self._complete else (False, None)

    def wait(self):
        if not self._complete:
            self._check_ft()
            # Single controller: no other thread can produce the matching
            # send while we block — this is the deadlock MPI semantics
            # prescribe; surface it instead of hanging.
            raise MPIError(
                ERR_PENDING,
                "recv would deadlock: no matching send has been posted "
                "(single-controller pt2pt requires the send first, or "
                "irecv + later send)")
        return self.status


class MatchingEngine:
    """Per-communicator pt2pt state: one unexpected FIFO per (dest, src)
    (non-overtaking), one posted-receive list (match order), and the
    (src, dest) -> [messages, bytes] traffic table (the pml/monitoring
    role). The queues live in the C++ matching core when the native
    library loaded (see the module doc), else in ``unexpected`` and
    ``posted``."""

    def __init__(self, comm):
        self.comm = comm
        # Matching is check-then-act over shared queues; the GIL makes
        # single ops atomic but not the compound sequences — a lock
        # keeps MPI_THREAD_MULTIPLE honest (ob1 guards its match with the
        # comm matching lock for the same reason).
        self._mlock = threading.RLock()
        self.unexpected: Dict[Tuple[int, int], Deque[_Msg]] = {}
        self.posted: List[_PostedRecv] = []
        self.traffic: Dict[Tuple[int, int], List[int]] = {}
        self._lib = None
        self._h = -1
        if not os.environ.get("OMPI_TPU_TORCH_DISABLE_NATIVE_MATCH"):
            from ompi_tpu_torch.native import get_lib
            lib = get_lib()
            if lib is not None:
                with _NATIVE_LOCK:
                    self._h = lib.ompi_tpu_match_create(comm.size)
                self._lib = lib
                self._msgs: Dict[int, _Msg] = {}        # unexpected payloads
                self._reqs: Dict[int, PtpRequest] = {}   # posted receives
                self._next_handle = 1
                self._tag_ids: Dict[Any, int] = {}       # tuple-tag intern

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", -1)
        if lib is not None and h >= 0:
            try:
                with _NATIVE_LOCK:
                    lib.ompi_tpu_match_destroy(h)
            except Exception:            # noqa: BLE001 — interpreter exit
                pass

    def _tag_id(self, tag) -> int:
        """Native tags are int64; tuple tags (the partitioned channel)
        are interned: equal ids for equal tags."""
        if isinstance(tag, int):
            return tag
        tid = self._tag_ids.get(tag)
        if tid is None:
            tid = self._tag_ids[tag] = (1 << 40) + len(self._tag_ids)
        return tid

    def _handle(self) -> int:
        h = self._next_handle
        self._next_handle += 1
        return h

    def _q(self, dest: int, src: int) -> Deque[_Msg]:
        return self.unexpected.setdefault((dest, src), deque())

    def _snapshot(self, data, dest: int):
        """The message's own copy of ``data`` (see the module doc)."""
        if isinstance(data, np.ndarray):
            return data.copy()
        if not isinstance(data, torch.Tensor):
            return data
        devs = self.comm.devices
        if data.device not in devs:
            raise MPIError(ERR_BUFFER,
                           f"send buffer on {data.device}; this "
                           f"communicator's ranks are on {set(devs)}")
        from ompi_tpu_torch.mca import var
        from ompi_tpu_torch.runtime import spc
        limit = var.var_get("pml_stacked_eager_limit", 1 << 16)
        if _nbytes(data) > limit and devs[dest] != data.device:
            spc.record("pml_rndv", 1)
            return data.to(devs[dest], copy=True)
        spc.record("pml_eager", 1)
        return data.clone()

    # -- send side -----------------------------------------------------
    def send(self, data: Any, src: int, dest: int, tag,
             synchronous: bool = False, channel: int = CH_P2P) -> Request:
        """Returns a completed Request; ``Request.status.count`` != 0
        indicates the message already matched a posted receive (the
        synchronous-send completion condition)."""
        if dest == PROC_NULL:
            return Request.completed()
        if not (0 <= dest < self.comm.size) or not (0 <= src < self.comm.size):
            raise MPIError(ERR_RANK, f"bad rank (src={src}, dest={dest})")
        if channel == CH_P2P and (not isinstance(tag, int) or tag < 0):
            raise MPIError(ERR_TAG, f"send tag must be an int >= 0, "
                                    f"got {tag!r}")
        data = self._snapshot(data, dest)
        if channel == CH_P2P:
            # partitioned fragments are not user messages; keep the
            # traffic matrix honest
            t = self.traffic.setdefault((src, dest), [0, 0])
            t[0] += 1
            t[1] += _nbytes(data)
        msg = _Msg(src, dest, tag, data, synchronous, channel)
        with self._mlock:
            if self._lib is not None:
                mh = self._handle()
                with _NATIVE_LOCK:
                    r = self._lib.ompi_tpu_match_send(
                        self._h, src, dest, self._tag_id(tag), channel, mh,
                        0 if synchronous else 1)
                if r >= 0:                   # matched a posted receive
                    self._reqs.pop(r).deliver(msg)
                    req = Request.completed()
                    req.status.count = 1
                    return req
                if not synchronous:
                    self._msgs[mh] = msg
            for i, pr in enumerate(self.posted):
                if pr.matches(msg):
                    self.posted.pop(i)
                    pr.req.deliver(msg)
                    req = Request.completed()
                    req.status.count = 1
                    return req
            if not synchronous and self._lib is None:
                # enqueue INSIDE the lock: a concurrent irecv that found
                # the queue empty must not post between our scan and this
                # append, or message and receive strand in opposite queues
                self._q(dest, src).append(msg)
        if synchronous:
            # MPI_Ssend completes only once the receive has started; in a
            # single-controller world an unmatched synchronous send can
            # never complete — surface the deadlock (it was not enqueued).
            raise MPIError(
                ERR_PENDING,
                "ssend would deadlock: no matching receive posted "
                "(post irecv first)")
        return Request.completed()

    # -- receive side --------------------------------------------------
    def _match_unexpected(self, dest: int, source: int, tag,
                          channel: int = CH_P2P,
                          remove: bool = True) -> Optional[_Msg]:
        with self._mlock:
            return self._match_unexpected_locked(dest, source, tag,
                                                 channel, remove)

    def _match_unexpected_locked(self, dest: int, source: int, tag,
                                 channel: int = CH_P2P,
                                 remove: bool = True) -> Optional[_Msg]:
        if self._lib is not None:
            with _NATIVE_LOCK:
                mh = self._lib.ompi_tpu_match_take(
                    self._h, dest, source, self._tag_id(tag), channel,
                    1 if remove else 0)
            if mh < 0:
                return None
            return self._msgs.pop(mh) if remove else self._msgs[mh]
        srcs = (range(self.comm.size) if source == ANY_SOURCE
                else [source])
        for s in srcs:
            q = self.unexpected.get((dest, s))
            if not q:
                continue
            for i, msg in enumerate(q):
                if msg.channel == channel and (
                        tag == ANY_TAG or tag == msg.tag):
                    if remove:
                        del q[i]
                    return msg
        return None

    def irecv(self, dest: int, source: int, tag,
              channel: int = CH_P2P) -> PtpRequest:
        """Post rank ``dest``'s receive."""
        req = PtpRequest(self, source, tag)
        req.dest = dest               # receiving rank
        if source == PROC_NULL:
            req.deliver(_Msg(PROC_NULL, dest, tag, None))
            return req
        with self._mlock:
            msg = self._match_unexpected_locked(dest, source, tag, channel)
            if msg is None and self._lib is not None:
                rh = self._handle()
                self._reqs[rh] = req
                with _NATIVE_LOCK:
                    self._lib.ompi_tpu_match_post(
                        self._h, dest, source, self._tag_id(tag), channel,
                        rh)
            elif msg is None:
                self.posted.append(
                    _PostedRecv(source, dest, tag, channel, req))
        if msg is not None:
            req.deliver(msg)
        return req

    def recv(self, dest: int, source: int, tag) -> Tuple[Any, Status]:
        req = self.irecv(dest, source, tag)
        st = req.wait()
        return req.get(), st

    # -- probe ---------------------------------------------------------
    def iprobe(self, dest: int, source: int, tag
               ) -> Tuple[bool, Optional[Status]]:
        msg = self._match_unexpected(dest, source, tag, CH_P2P,
                                     remove=False)
        if msg is None:
            return False, None
        return True, _status(msg)

    def probe(self, dest: int, source: int, tag) -> Status:
        ok, st = self.iprobe(dest, source, tag)
        if not ok:
            raise MPIError(
                ERR_PENDING,
                "probe would deadlock: no matching message pending")
        return st

    def mprobe(self, dest: int, source: int, tag):
        """Matched probe (MPI_Mprobe): removes the message from matching
        and returns it as a handle for mrecv."""
        msg = self._match_unexpected(dest, source, tag)
        if msg is None:
            raise MPIError(ERR_PENDING, "no matching message pending")
        return msg

    @staticmethod
    def mrecv(msg: _Msg) -> Tuple[Any, Status]:
        return msg.data, _status(msg)
