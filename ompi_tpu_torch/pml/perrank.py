"""pml/perrank — the per-rank (multi-controller) matching engine.

Behavioral spec: ob1's receive-side matching
(``ompi/mca/pml/ob1/pml_ob1_recvfrag.c:296-330``): arriving fragments are
matched against posted receives (source/tag with wildcards); unmatched
fragments queue in arrival order; order is FIFO per (source, comm) — MPI's
non-overtaking rule. The port of ``ompi_tpu/pml/perrank.py``. Unlike the
stacked engine, this one serves exactly one rank per process, frames
arrive from btl reader threads, and a blocking receive really blocks: the
matching send comes from another process.

Synchronous send (MPI_Ssend): the sender attaches an ack id, the
receiver's match sends a control frame back, and the send completes on
the ack — the rendezvous-ACK handshake of ``pml_ob1_sendreq.h:389-460``.

Frame routing: one process-wide :class:`Router` owns the endpoint and
demultiplexes frames by communicator CID; frames for a CID whose engine
does not exist yet (a peer raced ahead through communicator creation)
wait in a pending queue, as the reference holds fragments until the
communicator exists (comm_cid.c activation).

Protocol switch at send, in the reference's order
(``ompi_tpu/pml/perrank.py:722-756``): a large device tensor rides
btl/devxfer; else a same-host bulk payload is packed once into a shared
segment (btl/shmseg, with ``mpi_base_shm_zerocopy``); else a large host
payload, or a device tensor devxfer declined, takes the segment-pipelined
rendezvous (pml/pipeline); else the eager frame. Every protocol copies the
payload out before ``send`` returns (into the frame, a send slot, a shared
segment or the segment train), so a sender may overwrite its buffer as
soon as ``send`` returns.

ULFM over real process death: whatever learns of a death (an identified
connection's EOF, the heartbeat detector, a peer's obituary) reports it
into ``runtime/ft``'s registry; the router's listener fails every
pending operation on the dead rank and re-broadcasts the obituary as an
unsequenced ``ftdead`` ctl frame, and ``revoke`` floods a ``revoke``
frame the same way (every first receipt re-forwards).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _prof

from ompi_tpu_torch import telemetry as _tele
from ompi_tpu_torch.btl import shmseg as _shmseg
from ompi_tpu_torch.btl.bml import BmlEndpoint
from ompi_tpu_torch.btl.devxfer import DevPayload, DevXfer, maybe_resolve
from ompi_tpu_torch.btl.tcp import PeerDownError, decode_payload, \
    encode_payload
from ompi_tpu_torch.core.errhandler import (ERR_PENDING, ERR_PROC_FAILED,
                                            ERR_RANK, ERR_TAG, MPIError)
from ompi_tpu_torch.core.request import Request, Status
from ompi_tpu_torch.mca import pvar
from ompi_tpu_torch.pml import pipeline as _pipeline
from ompi_tpu_torch.runtime import ft
from ompi_tpu_torch.runtime import progress as _progress
from ompi_tpu_torch.trace import core as _trace

ANY_SOURCE = -1
ANY_TAG = -1
PROC_NULL = -2

# how long a blocking wait on a peer may take before it reports the job
# stuck (the reference's bound)
WAIT_TIMEOUT = 600.0


def _send(router: "Router", wdest: int, header: dict, raw) -> None:
    """Send, mapping a link that died under the send to
    ``ERR_PROC_FAILED`` — never a raw socket error. The death is
    reported into the failure registry."""
    try:
        router.endpoint.send_frame(wdest, header, raw)
    except PeerDownError as e:
        ft.fail_rank(e.world_rank, "connection down during send")
        raise MPIError(ERR_PROC_FAILED, f"peer world rank {e.world_rank} "
                                        f"failed during send") from e


class Router:
    """Process-wide frame router: CID -> engine, the ack table, the
    endpoint (bml over tcp and sm) and the device payload plane. The tcp
    listener binds ``bind`` (loopback unless Init gives another)."""

    def __init__(self, rank: int, nprocs: int, kv_set, kv_get,
                 device=None, bind: str = "127.0.0.1"):
        self.rank = rank
        self.nprocs = nprocs
        self.kv_set = kv_set
        self.kv_get = kv_get
        self.device = torch.device(device or "cpu")
        self._engines: Dict[Any, "PerRankEngine"] = {}
        self._pending: Dict[Any, List[Tuple[dict, bytes]]] = {}
        self._acks: Dict[int, threading.Event] = {}
        # payloads carried by acks (the one-sided plane's get, fetch and
        # error replies), kept until their waiter takes them
        self._ack_replies: Dict[int, Any] = {}
        self._ack_ids = itertools.count(1)
        self._lock = threading.Lock()
        self._closing = False
        self._departed: set = set()      # peers that said goodbye
        # -- resilience plane -------------------------------------------
        # revoked communicator CIDs + per-cid callbacks (the reliable
        # revoke broadcast's local state, coll_base_revoke_local.c) and
        # the optional heartbeat detector (ft/detector, attached by
        # runtime/init after wire_up)
        self._revoked: set = set()
        self._revoke_cbs: Dict[Any, list] = {}
        self.detector = None
        # one-sided handlers by id: frames carrying "rma" run their
        # handler on the reader thread, with no matching (the bridge
        # relay of core/dpm_perrank)
        self._rma: Dict[Any, Callable[[dict, Any], None]] = {}
        # whatever ingress learns of a death (EOF monitor, heartbeat
        # declaration, remote obituary) funnels through the registry;
        # the listener does the local cleanup and re-broadcasts — the
        # registry's first-report dedup terminates the flood
        ft.add_listener(self._on_rank_failed)
        self.xfer = DevXfer(self)
        # segment-train reassembly of the pipelined rendezvous, fed by
        # rail reader threads below the matching layer: built before the
        # endpoint, so no reader thread can race it
        self.pipes = _pipeline.PipeStore()
        self.endpoint = BmlEndpoint(rank, nprocs, kv_set, kv_get,
                                    self._deliver,
                                    on_peer_lost=self._peer_lost, bind=bind)
        # the ctl flush-window counters ride the MPI_T pvar plumbing
        pvar.pvar_register_dict(
            "btl_ctl", self.endpoint.tcp.ctl_stats,
            help_prefix="ctl flush window: ")

    def wire_up(self) -> None:
        """Connect to every peer eagerly (add_procs): each pair then has
        identified connections both ways, so a process death is seen by
        every survivor."""
        for peer in range(self.nprocs):
            if peer != self.rank:
                try:
                    self.endpoint._connect(peer)
                except OSError:
                    pass                 # dead already; detector covers

    def begin_shutdown(self) -> None:
        """At finalize: tell every peer this is a departure, not a death,
        then stop reading EOFs as failures."""
        for peer in list(self.endpoint._peers):
            try:
                self.endpoint.send_frame(peer, {"ctl": "bye",
                                                "peer": self.rank})
            except OSError:
                pass
        self._closing = True

    def _peer_lost(self, world_rank: int) -> None:
        """An identified peer link died: the ULFM event. Report it into
        the failure registry; the registry listener
        (:meth:`_on_rank_failed`) does the local cleanup and the
        obituary broadcast — same path whatever the ingress."""
        if self._closing or world_rank in self._departed:
            return                       # graceful exit, not death
        ft.fail_rank(world_rank, "peer connection lost")

    def _on_rank_failed(self, world_rank: int, reason: str) -> None:
        """Registry listener (fires once per failed rank): complete every
        pending operation that could have matched the dead rank in error
        (``req_ft.c`` over a real dead process), release what it held,
        and fan the obituary out as a ``ftdead`` broadcast. Receivers
        dedup through their own registries, so the flood terminates."""
        if self._closing:
            return
        # its unfinished segment trains never complete, and the slots
        # parked for it are never freed by it
        self.pipes.fail_peer(world_rank)
        plane = getattr(getattr(self, "endpoint", None), "shm_seg", None)
        if plane is not None:
            try:
                plane.peer_failed(world_rank)
            except Exception:            # noqa: BLE001
                pass
        with self._lock:
            engines = list(self._engines.values())
        for eng in engines:
            try:
                eng._peer_failed(world_rank)
            except Exception:            # noqa: BLE001
                pass
        self._broadcast_ctl({"ctl": "ftdead", "rank": world_rank,
                             "peer": self.rank})

    def _broadcast_ctl(self, header: dict) -> None:
        """Best-effort fan-out of a ctl frame to every live peer over the
        unsequenced tcp path (no ``_sq``, so a lost one leaves no
        reorder-buffer hole; reliability comes from every learner
        re-forwarding on first receipt)."""
        failed = ft.failed_ranks()
        for peer in range(self.nprocs):
            if peer == self.rank or peer in failed:
                continue
            try:
                self.endpoint.tcp.send_frame(peer, dict(header))
            except Exception:            # noqa: BLE001 — a dying
                pass                     # learner is its own obituary

    # -- revoke plane (MPIX_Comm_revoke over the ctl wire) -------------
    def revoke(self, rcid) -> None:
        """Locally revoke ``rcid`` and start the reliable broadcast
        (coll_base_revoke_local.c: first receipt re-forwards, the
        revoked-set test terminates the flood)."""
        self._on_revoke(rcid)

    def is_revoked(self, rcid) -> bool:
        return rcid in self._revoked

    def register_revoke_cb(self, rcid, cb) -> None:
        with self._lock:
            self._revoke_cbs.setdefault(rcid, []).append(cb)

    def unregister_revoke_cb(self, rcid) -> None:
        with self._lock:
            self._revoke_cbs.pop(rcid, None)

    def _on_revoke(self, rcid) -> None:
        with self._lock:
            if rcid in self._revoked:
                return                   # flood termination
            self._revoked.add(rcid)
            cbs = list(self._revoke_cbs.get(rcid, []))
        if _tele.active:
            # flight-recorder trigger: first receipt of a revocation is
            # incident evidence worth freezing (rate-limited inside)
            from ompi_tpu_torch.telemetry import flightrec as _flightrec
            _flightrec.record("revoke", {"rcid": str(rcid),
                                         "rank": self.rank})
        self._broadcast_ctl({"ctl": "revoke", "rcid": rcid,
                             "peer": self.rank})
        for cb in cbs:
            try:
                cb()
            except Exception:            # noqa: BLE001
                pass

    def register(self, cid, engine: "PerRankEngine") -> None:
        with self._lock:
            self._engines[cid] = engine
            backlog = self._pending.pop(cid, [])
        for header, raw in backlog:
            engine._incoming(header, raw)

    def unregister(self, cid) -> None:
        with self._lock:
            self._engines.pop(cid, None)

    def register_rma(self, wid, handler) -> None:
        with self._lock:
            self._rma[wid] = handler

    def unregister_rma(self, wid) -> None:
        with self._lock:
            self._rma.pop(wid, None)

    def new_ack(self) -> Tuple[int, threading.Event]:
        aid = next(self._ack_ids)
        ev = threading.Event()
        with self._lock:
            self._acks[aid] = ev
        return aid, ev

    def cancel_ack(self, aid: int) -> None:
        with self._lock:
            self._acks.pop(aid, None)
            self._ack_replies.pop(aid, None)

    def take_ack_reply(self, aid: int) -> Any:
        """The payload the ack ``aid`` carried (None for a bare ack);
        read once, after its event was set."""
        with self._lock:
            return self._ack_replies.pop(aid, None)

    def _deliver(self, header: dict, raw) -> None:
        """Called from btl reader threads (and loopback sends)."""
        ctl = header.get("ctl")
        if ctl == "hb":
            d = self.detector
            if d is not None:
                d.on_heartbeat(header["peer"])
            # telemetry RTT echo: the sender stamped "ht" only while its
            # telemetry was on; reply in kind only while ours is on too —
            # with the plane off neither side's frames change
            if _tele.active and "ht" in header:
                try:
                    self.endpoint.tcp.send_frame(
                        header["peer"],
                        {"ctl": "hbr", "peer": self.rank,
                         "ht": header["ht"]})
                except Exception:        # noqa: BLE001 — best-effort
                    pass
            return
        if ctl == "hbr":
            if _tele.active:
                hist = _tele.HB_RTT
                if hist is not None:
                    rtt = time.perf_counter() - float(header["ht"])
                    hist.record(max(rtt, 0.0) * 1e6)
            return
        if ctl == "ftdead":
            # remote obituary: feed the registry (dedups); our own
            # listener re-forwards on first receipt. An obituary about
            # ourselves is a false accusation — the accusers exclude us
            # either way; don't poison our own registry.
            r = header["rank"]
            if not (self._closing or r == self.rank
                    or r in self._departed):
                ft.fail_rank(r, "obituary from rank %s"
                             % header.get("peer"))
            return
        if ctl == "revoke":
            self._on_revoke(header["rcid"])
            return
        if ctl == "bye":
            with self._lock:
                self._departed.add(header["peer"])
            return
        if ctl == "ack":
            aid = header["ack_id"]
            with self._lock:
                ev = self._acks.pop(aid, None)
            if ev is not None:
                if "desc" in header:
                    reply = decode_payload(header["desc"], raw)
                    with self._lock:
                        self._ack_replies[aid] = reply
                _progress.wake(ev)
            return
        if ctl == "xferack":
            self.xfer.release(header["slot"])
            return
        if ctl == "segfree":
            # the receiver is done with a shared slot of ours
            plane = getattr(self.endpoint, "shm_seg", None)
            if plane is not None:
                plane.release(header["peer"], header["i"])
            return
        if "rma" in header:
            with self._lock:
                h = self._rma.get(header["wid"])
            if h is not None:
                h(header, raw)
            return
        if "pipeseg" in header:
            # a rail-striped segment of a pipelined train: reassembled by
            # index below the matching layer; only the train's ordered
            # init frame matches
            self.pipes.deliver(header, raw)
            return
        cid = header["cid"]
        with self._lock:
            eng = self._engines.get(cid)
            if eng is None:
                self._pending.setdefault(cid, []).append((header, raw))
                return
        eng._incoming(header, raw)

    def send_ack(self, world_rank: int, ack_id: int,
                 reply: Any = None) -> None:
        """Complete the sender's ack ``ack_id``, carrying ``reply`` as its
        payload when given."""
        header = {"ctl": "ack", "ack_id": ack_id}
        raw = b""
        if reply is not None:
            header["desc"], raw = encode_payload(reply)
        self.endpoint.send_frame(world_rank, header, raw)

    def close(self) -> None:
        self._closing = True
        ft.remove_listener(self._on_rank_failed)
        d, self.detector = self.detector, None
        if d is not None:
            try:
                d.stop()
            except Exception:            # noqa: BLE001
                pass
        self.endpoint.close()
        self.xfer.close()


class _Msg:
    __slots__ = ("src", "tag", "data", "ack")

    def __init__(self, src: int, tag: int, data: Any,
                 ack: Optional[Tuple[int, int]] = None):
        self.src = src                  # comm-local source rank
        self.tag = tag
        self.data = data
        self.ack = ack                  # (sender world rank, ack id)


def _count(data) -> Tuple[int, int]:
    """(element count, bytes) of a payload for its Status."""
    if isinstance(data, torch.Tensor):
        return max(data.numel(), 1), data.numel() * data.element_size()
    return (int(getattr(data, "size", 1) or 1),
            int(getattr(data, "nbytes", -1)))


class RankRequest(Request):
    """A receive completed by the engine from a btl reader thread; ``wait``
    blocks on a real Event, then reads a device payload through its handle
    on the waiting (consumer) thread."""

    def __init__(self, src: int, tag: int):
        super().__init__(status=Status(source=src, tag=tag))
        self._complete = False
        self._done = threading.Event()
        self._cancel_fn = None

    def cancel(self) -> None:
        """MPI_Cancel: succeeds only while the receive is still posted."""
        fn = self._cancel_fn
        if fn is not None:
            fn()

    def _deliver(self, msg: _Msg) -> None:
        self._result = msg.data
        self.status.source = msg.src
        self.status.tag = msg.tag
        self.status.count, self.status.nbytes = _count(msg.data)
        self._complete = True
        self._cancel_fn = None           # completion: past cancellation
        _progress.wake(self._done)

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._complete = True
        self._cancel_fn = None
        _progress.wake(self._done)

    def test(self):
        if self._complete and self._done.is_set():
            self.wait()
            return True, self.status
        return False, None

    def wait(self, timeout: Optional[float] = None) -> Status:
        if not self._done.wait(WAIT_TIMEOUT if timeout is None
                               else timeout):
            raise MPIError(ERR_PENDING,
                           "recv timed out waiting for a matching send")
        if self._error is not None:
            raise self._error
        # completion means the data is placed: read a device payload, or
        # assemble a segment train (releasing the store's buffer), now
        self._result = _pipeline.maybe_resolve(maybe_resolve(self._result))
        return self.status

    def get(self):
        self.wait()
        return self._result


def thread_request(job) -> RankRequest:
    """Run ``job`` on a daemon thread; the returned request completes with
    its result, or in error (the generic request-based-operation
    primitive, ``osc.h:269-279``)."""
    req = RankRequest(ANY_SOURCE, ANY_TAG)

    def run():
        try:
            req._deliver(_Msg(ANY_SOURCE, 0, job()))
        except BaseException as e:      # noqa: BLE001 — raised at wait
            req._fail(e)
    threading.Thread(target=run, daemon=True).start()
    return req


class CombineSlot:
    """An inline-combining receive slot (the ``btl_sendi`` role applied to
    the receive side): reader threads park small collective contributions
    into the slot; the last arrival folds them in rank order and wakes the
    consumer once."""

    __slots__ = ("_vals", "_need", "_fold", "_event", "_lock", "_error",
                 "result")

    def __init__(self, nranks: int, need: int, fold):
        self._vals: List[Any] = [None] * nranks   # by source rank
        self._need = need
        self._fold = fold                 # fold(ordered_values) -> result
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self.result: Any = None

    def feed(self, src: int, value: Any) -> None:
        with self._lock:
            if self._vals[src] is not None or self._need <= 0:
                return                    # duplicate / already failed
            self._vals[src] = value
            self._need -= 1
            done = self._need == 0
        if done:
            # rank-ordered fold: allreduce returns the same value on
            # every rank, which arrival-order float folding would not
            try:
                self.result = self._fold(self._vals)
            except BaseException as e:    # noqa: BLE001 — raised at wait
                self._error = e
            _progress.wake(self._event)

    def put_own(self, rank: int, value: Any) -> None:
        """The caller's own contribution (never counted in _need)."""
        self._vals[rank] = value

    def fail(self, err: BaseException) -> None:
        with self._lock:
            self._need = -1
        self._error = err
        _progress.wake(self._event)

    def wait(self, timeout: float = WAIT_TIMEOUT):
        if not self._event.wait(timeout):
            raise MPIError(ERR_PENDING, "combining collective timed out")
        if self._error is not None:
            raise self._error
        return self.result


class PerRankEngine:
    """Matching state for one rank of one communicator. ``comm`` provides
    ``cid``, ``size``, ``rank()`` and ``world_rank_of(local)``."""

    def __init__(self, comm, router: Router):
        self.comm = comm
        self.router = router
        self._lock = threading.Lock()
        self.unexpected: Dict[int, Deque[_Msg]] = {}   # src -> FIFO
        self._arrival: Deque[int] = deque()            # src arrival order
        self.posted: List[Tuple[int, int, RankRequest]] = []
        self._combine: Dict[int, CombineSlot] = {}     # tag -> slot
        # per-(dtype, shape) descriptor templates of the small multicast
        self._small_desc: Dict[Tuple[str, tuple], dict] = {}
        # this rank's traffic by comm-local (src, dest): [messages, bytes]
        # (the pml/monitoring role)
        self.traffic: Dict[Tuple[int, int], List[int]] = {}
        router.register(comm.cid, self)

    # -- wire side -----------------------------------------------------
    def _incoming(self, header: dict, raw) -> None:
        d = header["desc"]
        kind = d.get("kind")
        if kind in ("devipc", "devlocal"):
            payload = DevPayload(self.router.xfer, d)
        elif kind == "pipe":
            # the pipelined rendezvous' init frame matches now, with the
            # right counts; the train assembles on the consumer thread
            payload = _pipeline.PipePayload(self.router, d)
        elif kind == "shmseg":
            # adopt the payload in place over the sender's shared slot
            payload = _shmseg.adopt(self.router.endpoint, d)
        else:
            payload = decode_payload(d, raw)
            # a posted combining slot for this tag absorbs the value right
            # here: no matching, no request, no per-message wakeup
            with self._lock:
                slot = self._combine.get(header["tag"])
            if slot is not None:
                slot.feed(header["src"], payload)
                return
        msg = _Msg(header["src"], header["tag"], payload,
                   ack=(header["wsrc"], header["ack_id"])
                   if header.get("ack_id") else None)
        with self._lock:
            for i, (src, tag, req) in enumerate(self.posted):
                if ((src == ANY_SOURCE or src == msg.src)
                        and (tag == ANY_TAG or tag == msg.tag)):
                    self.posted.pop(i)
                    matched = req
                    break
            else:
                self.unexpected.setdefault(msg.src, deque()).append(msg)
                self._arrival.append(msg.src)
                matched = None
        if matched is not None:
            self._ack(msg)
            matched._deliver(msg)

    def _ack(self, msg: _Msg) -> None:
        if msg.ack is not None:
            self.router.send_ack(*msg.ack)

    # -- inline-combining slots ----------------------------------------
    def post_combine(self, tag: int, nranks: int, need: int, fold,
                     own: Optional[Tuple[int, Any]] = None) -> CombineSlot:
        """Post a combining slot for one collective round; contributions
        that raced ahead sit in the unexpected queue and are drained here.
        The caller's own value goes in before the slot is visible."""
        slot = CombineSlot(nranks, need, fold)
        if own is not None:
            slot.put_own(*own)
        drained: List[_Msg] = []
        with self._lock:
            self._combine[tag] = slot
            for s, q in list(self.unexpected.items()):
                keep = deque()
                for m in q:
                    (drained if m.tag == tag else keep).append(m)
                if len(keep) != len(q):
                    self.unexpected[s] = keep
                    for _ in range(len(q) - len(keep)):
                        self._arrival.remove(s)
        for m in drained:
            slot.feed(m.src, m.data)
        return slot

    def end_combine(self, tag: int) -> None:
        with self._lock:
            self._combine.pop(tag, None)

    def _take_unexpected(self, source: int, tag: int,
                         remove: bool = True) -> Optional[_Msg]:
        """Caller holds self._lock. A wildcard source scans in arrival
        order (the unexpected queue's FIFO across sources)."""
        srcs = (list(dict.fromkeys(self._arrival))
                if source == ANY_SOURCE else [source])
        for s in srcs:
            q = self.unexpected.get(s)
            if not q:
                continue
            for i, msg in enumerate(q):
                if tag == ANY_TAG or tag == msg.tag:
                    if remove:
                        del q[i]
                        self._arrival.remove(s)
                    return msg
        return None

    # -- send side -----------------------------------------------------
    def send(self, data: Any, dest: int, tag: int = 0,
             synchronous: bool = False) -> Request:
        # telemetry gate: one attribute read when off; the histogram
        # times the full post-to-wire-handoff service (the degraded
        # self-health signal reads its p99)
        if _tele.active:
            hist = _tele.PML_SEND
            tok = hist.start()
            try:
                return self._send_traced(data, dest, tag, synchronous)
            finally:
                hist.observe(tok)
        return self._send_traced(data, dest, tag, synchronous)

    def _send_traced(self, data: Any, dest: int, tag: int = 0,
                     synchronous: bool = False) -> Request:
        # tracing gate: one attribute read when off (the hooks event name
        # "pml_send"); the cid rides in args, so pt2pt spans stay out of
        # the collective sequence space the attribution groups on
        if _trace.active or _prof._is_profiler_enabled:
            tok = _trace.begin("pml_send", cid=None,
                               cc=str(self.comm.cid), dest=dest, tag=tag)
            try:
                return self._send_impl(data, dest, tag, synchronous)
            finally:
                _trace.end(tok)
        return self._send_impl(data, dest, tag, synchronous)

    def _send_impl(self, data: Any, dest: int, tag: int = 0,
                   synchronous: bool = False) -> Request:
        if dest == PROC_NULL:
            return Request.completed()
        if not (0 <= dest < self.comm.size):
            raise MPIError(ERR_RANK, f"bad destination rank {dest}")
        if not isinstance(tag, int) or tag < 0:
            raise MPIError(ERR_TAG, f"send tag must be an int >= 0, "
                                    f"got {tag!r}")
        wdest = self.comm.world_rank_of(dest)
        if ft.is_failed(wdest):
            # symmetric with the recv fail-fast: no silent buffering
            # into a dead socket, no raw OSError later
            raise MPIError(ERR_PROC_FAILED,
                           f"send peer rank {dest} has failed")
        # protocol switch: large device tensors ride the IPC plane (a
        # descriptor-only frame, the receiver reads the sender's slot);
        # then the shared-segment plane, then the pipelined rendezvous,
        # each returning None when it declines without touching the wire;
        # everything else goes eager over the host byte path
        desc = self.router.xfer.try_register(data, wdest)
        if desc is not None:
            raw = b""
            wire_bytes = data.numel() * data.element_size()
        else:
            req = _shmseg.maybe_send_zerocopy(self, data, dest, tag,
                                              synchronous)
            if req is None:
                req = _pipeline.maybe_send_pipelined(self, data, dest, tag,
                                                     synchronous)
            if req is not None:
                return req
            desc, raw = encode_payload(data)
            wire_bytes = len(raw)
        me = self.comm.rank()
        t = self.traffic.setdefault((me, dest), [0, 0])
        t[0] += 1
        t[1] += wire_bytes
        header = {"cid": self.comm.cid, "src": me, "tag": tag,
                  "desc": desc}
        ev = aid = None
        if synchronous:
            aid, ev = self.router.new_ack()
            header["ack_id"] = aid
            header["wsrc"] = self.comm.world_rank_of(me)
        _send(self.router, wdest, header, raw)
        if ev is not None and not ev.wait(WAIT_TIMEOUT):
            self.router.cancel_ack(aid)
            raise MPIError(ERR_PENDING,
                           "ssend timed out waiting for the receive")
        return Request.completed()

    def send_small(self, data: Any, dests, tag: int) -> None:
        """Sub-eager multicast (the combined small-message collectives):
        marshal the payload once with a cached per-(dtype, shape)
        descriptor and push one frame per destination. ``dests`` are
        comm-local ranks and exclude the caller."""
        if _tele.active:
            hist = _tele.PML_SEND
            tok = hist.start()
            try:
                return self._send_small_traced(data, dests, tag)
            finally:
                hist.observe(tok)
        return self._send_small_traced(data, dests, tag)

    def _send_small_traced(self, data: Any, dests, tag: int) -> None:
        if _trace.active or _prof._is_profiler_enabled:
            tok = _trace.begin("pml_send", cid=None,
                               cc=str(self.comm.cid), tag=tag,
                               ndest=(len(dests)
                                      if hasattr(dests, "__len__")
                                      else -1), small=True)
            try:
                return self._send_small_impl(data, dests, tag)
            finally:
                _trace.end(tok)
        return self._send_small_impl(data, dests, tag)

    def _send_small_impl(self, data: Any, dests, tag: int) -> None:
        if isinstance(data, np.generic):
            data = np.asarray(data)      # raw 0-d array, not a pickle
        if isinstance(data, np.ndarray):
            arr = np.ascontiguousarray(data)
            key = (arr.dtype.str, arr.shape)
            desc = self._small_desc.get(key)
            if desc is None:
                desc = self._small_desc[key] = {
                    "kind": "nd", "dtype": arr.dtype.str,
                    "shape": arr.shape}
            raw = arr.tobytes()
        else:
            desc, raw = encode_payload(data)
        me = self.comm.rank()
        header = {"cid": self.comm.cid, "src": me, "tag": tag,
                  "desc": desc}
        for dest in dests:
            wdest = self.comm.world_rank_of(dest)
            if ft.is_failed(wdest):
                raise MPIError(ERR_PROC_FAILED,
                               f"send peer rank {dest} has failed")
            t = self.traffic.setdefault((me, dest), [0, 0])
            t[0] += 1
            t[1] += len(raw)
            # the bml copies the header before stamping its sequence
            # number, so one template serves every destination
            _send(self.router, wdest, header, raw)

    def bind_small_multicast(self, example: Any, dests):
        """Pre-bound sub-eager multicast (the persistent small allreduce's
        prebind, ``coll/persistent``): the descriptor template, the world
        ranks and the traffic rows resolve once here; each send is the
        byte copy, the per-peer liveness check (peers may die between
        rounds) and the frame pushes. A refill that changes the buffer's
        (dtype, shape) gets a fresh descriptor."""
        arr = np.asarray(example)
        key = (arr.dtype.str, arr.shape)
        desc = self._small_desc.get(key)
        if desc is None:
            desc = self._small_desc[key] = {
                "kind": "nd", "dtype": arr.dtype.str, "shape": arr.shape}
        me = self.comm.rank()
        peers = [(d, self.comm.world_rank_of(d),
                  self.traffic.setdefault((me, d), [0, 0])) for d in dests]
        router = self.router
        cid = self.comm.cid

        def send(data: Any, tag: int) -> None:
            a = np.ascontiguousarray(np.asarray(data))
            d0 = desc
            if (a.dtype.str, a.shape) != key:
                d0 = {"kind": "nd", "dtype": a.dtype.str, "shape": a.shape}
            raw = a.tobytes()
            header = {"cid": cid, "src": me, "tag": tag, "desc": d0}
            for dest, wdest, t in peers:
                if ft.is_failed(wdest):
                    raise MPIError(ERR_PROC_FAILED,
                                   f"send peer rank {dest} has failed")
                t[0] += 1
                t[1] += len(raw)
                _send(router, wdest, header, raw)
        return send

    # -- receive side --------------------------------------------------
    def _cancel_posted(self, req: RankRequest) -> None:
        with self._lock:
            present = any(e[2] is req for e in self.posted)
            self.posted = [e for e in self.posted if e[2] is not req]
        if present:
            req.status.cancelled = True
            req._deliver(_Msg(ANY_SOURCE, ANY_TAG, None))

    def irecv(self, source: int = ANY_SOURCE,
              tag: int = ANY_TAG) -> RankRequest:
        req = RankRequest(source, tag)
        req._cancel_fn = lambda: self._cancel_posted(req)
        if source == PROC_NULL:
            req._deliver(_Msg(PROC_NULL, tag, None))
            return req
        with self._lock:
            msg = self._take_unexpected(source, tag)
            if msg is None:
                self.posted.append((source, tag, req))
        if msg is not None:
            self._ack(msg)
            req._deliver(msg)
            return req
        # a receive posted after its peer died can never match (req_ft.c:
        # fail fast instead of hanging); in-flight failures are flushed
        # by _peer_failed
        if (source != ANY_SOURCE and 0 <= source < self.comm.size
                and ft.is_failed(self.comm.world_rank_of(source))):
            self._peer_failed(self.comm.world_rank_of(source))
        return req

    def _peer_failed(self, world_rank: int) -> None:
        """Complete pending named receives on the dead peer, and combining
        slots still waiting for it, in error. Wildcard receives stay
        posted: a live sender may still match them. An intercomm engine
        (``no_peer_map``) maps no local death to a remote rank."""
        if getattr(self.comm, "no_peer_map", False):
            return
        local = next((i for i in range(self.comm.size)
                      if self.comm.world_rank_of(i) == world_rank), None)
        if local is None:
            return
        with self._lock:
            hit = [e for e in self.posted if e[0] == local]
            self.posted = [e for e in self.posted if e[0] != local]
            slots = [s for s in self._combine.values()
                     if s._vals[local] is None]
        err = MPIError(ERR_PROC_FAILED, f"peer rank {local} died while an "
                                        f"operation on it was pending")
        for (_, _, req) in hit:
            req._fail(err)
        for s in slots:
            s.fail(err)

    def _flush_all(self, make_err) -> None:
        """Revocation flush (MPIX_Comm_revoke): complete every pending
        operation on this engine in error — wildcards included. Unlike a
        single peer death, a revoked communicator can never match
        anything again (req_ft.c's revocation branch)."""
        with self._lock:
            hit, self.posted = self.posted, []
            slots = [s for s in self._combine.values()
                     if any(v is None for v in s._vals)]
        for (_, _, req) in hit:
            req._fail(make_err())
        for s in slots:
            try:
                s.fail(make_err())
            except Exception:            # noqa: BLE001
                pass

    def recv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
             timeout: Optional[float] = None) -> Tuple[Any, Status]:
        # telemetry: the recv histogram's duration is blocked-waiting; it
        # doubles as the health monitor's per-peer wait ingress (the
        # matched source is only known at completion)
        if _tele.active:
            hist = _tele.PML_RECV
            tok = hist.start()
            try:
                data, st = self._recv_traced(source, tag, timeout)
            finally:
                hist.observe(tok)
            from ompi_tpu_torch.telemetry import health as _health
            _health.note_wait(self.comm.world_rank_of(st.source),
                              time.perf_counter() - tok)
            return data, st
        return self._recv_traced(source, tag, timeout)

    def _recv_traced(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
                     timeout: Optional[float] = None
                     ) -> Tuple[Any, Status]:
        # the span covers post-to-completion: its duration is the time a
        # late sender costs this rank
        if _trace.active or _prof._is_profiler_enabled:
            tok = _trace.begin("pml_recv", cid=None,
                               cc=str(self.comm.cid), src=source, tag=tag)
            try:
                req = self.irecv(source, tag)
                st = req.wait(timeout)
                return req.get(), st
            finally:
                _trace.end(tok)
        req = self.irecv(source, tag)
        st = req.wait(timeout)
        return req.get(), st

    # -- probe ---------------------------------------------------------
    def iprobe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG
               ) -> Tuple[bool, Optional[Status]]:
        with self._lock:
            msg = self._take_unexpected(source, tag, remove=False)
        if msg is None:
            return False, None
        count, nbytes = _count(msg.data)
        return True, Status(source=msg.src, tag=msg.tag, count=count,
                            nbytes=nbytes)

    def probe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
              timeout: float = WAIT_TIMEOUT) -> Status:
        """Blocking probe: poll with backoff until a match is pending."""
        deadline = time.monotonic() + timeout
        poll = 0.0005
        while True:
            ok, st = self.iprobe(source, tag)
            if ok:
                return st
            if time.monotonic() > deadline:
                raise MPIError(ERR_PENDING, "probe timed out")
            time.sleep(poll)
            poll = min(poll * 2, 0.01)

    def mprobe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
               timeout: float = WAIT_TIMEOUT) -> _Msg:
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                msg = self._take_unexpected(source, tag)
            if msg is not None:
                self._ack(msg)
                return msg
            if time.monotonic() > deadline:
                raise MPIError(ERR_PENDING, "mprobe timed out")
            time.sleep(0.0005)

    @staticmethod
    def mrecv(msg: _Msg) -> Tuple[Any, Status]:
        data = _pipeline.maybe_resolve(maybe_resolve(msg.data))
        count, nbytes = _count(data)
        return data, Status(source=msg.src, tag=msg.tag, count=count,
                            nbytes=nbytes)

    def close(self) -> None:
        self.router.unregister(self.comm.cid)
