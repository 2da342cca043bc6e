"""bml/r2 — the BTL multiplexer: per-peer transport selection.

Behavioral spec: ``ompi/mca/bml/r2`` over ``ompi/mca/bml/bml.h`` — each peer
endpoint carries its eligible BTLs and the PML picks per message. The port
of ``ompi_tpu/btl/bml.py``.

Two byte planes exist in the per-rank world: the shared-memory rings
(btl/sm, same host) and framed TCP (btl/tcp, universal). This multiplexer
exposes the TcpEndpoint surface the Router binds (``send_frame``,
``_connect``, ``_peers``, ``close``). Per frame: self -> loopback
(btl/self); a same-host peer and a payload of at least ``btl_sm_min_bytes``
that fits the ring -> sm; otherwise tcp. TCP connections are wired to
every peer all the same: the connection monitor is the failure detector.

Large-message segments (``send_segment``, the pipelined rendezvous of
``pml/pipeline``) are striped round-robin over ``mpi_base_btl_rails``
rails: rail r >= 1 is an extra tcp connection per peer with its own lock
and its own sender thread. Segments carry a per-(sender, rail) stamp
``_rq`` instead of the ordered ``_sq`` and are delivered at once: the pml
reassembles them by index. The bml also owns the zero-copy segment plane
(``btl/shmseg``); with ``mpi_base_shm_zerocopy`` on, a same-host segment
is parked in a shared slot and only its descriptor (``_seg``) travels.

Locality (the hwloc modex): every rank publishes its host and boot
identity; peers that share it are same-host. The environment variable
``OMPI_TPU_TORCH_DISABLE_SM`` (any non-empty value) keeps the sm rings
and the segment plane out of the bml, as the reference's
``OMPI_TPU_DISABLE_SM`` does.
"""
from __future__ import annotations

import itertools
import os
import queue
import socket
import threading
import time
import traceback
import uuid
from collections import deque
from typing import Callable, Dict, Optional, Tuple

from ompi_tpu_torch import telemetry as _tele
from ompi_tpu_torch.btl import shmseg as _shmseg
from ompi_tpu_torch.btl.sm import Ring, SmEndpoint
from ompi_tpu_torch.btl.tcp import PeerDownError, TcpEndpoint
from ompi_tpu_torch.ft import inject as _inject
from ompi_tpu_torch.mca import pvar as _pvar
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.runtime import ft
from ompi_tpu_torch.runtime import progress as _progress
from ompi_tpu_torch.trace import core as _trace

_BOOT_ID: Optional[str] = None

_DEF_RING_BYTES = 4 << 20
_DEF_MIN_BYTES = 32 << 10


def _host_identity() -> str:
    """hostname + a per-boot token: two containers may share a hostname
    without sharing /dev/shm."""
    global _BOOT_ID
    if _BOOT_ID is None:
        try:
            with open("/proc/sys/kernel/random/boot_id") as f:
                _BOOT_ID = f.read().strip()
        except OSError:
            _BOOT_ID = uuid.uuid4().hex     # never matches: sm off
    return f"{socket.gethostname()}/{_BOOT_ID}"


def register_params() -> None:
    var.var_register("btl", "sm", "enable", vtype="bool", default=True,
                     help="Use shared-memory rings for same-host pt2pt "
                          "frames (bml routes the rest via tcp)")
    var.var_register("btl", "sm", "ring_bytes", vtype="int",
                     default=_DEF_RING_BYTES,
                     help="Per-peer SPSC ring capacity in bytes; frames "
                          "that cannot fit route via tcp")
    var.var_register("btl", "sm", "min_bytes", vtype="int",
                     default=_DEF_MIN_BYTES,
                     help="Smallest payload routed through the sm "
                          "bandwidth plane; smaller frames stay on tcp")
    var.var_register("btl", "devxfer", "min_bytes", vtype="int",
                     default=1 << 20,
                     help="Device-tensor payloads at or above this ride "
                          "the IPC plane (the rndv eager limit, "
                          "pml_ob1_sendreq.h:389-460 role)")
    var.var_register("mpi", "base", "btl_rails", vtype="int", default=1,
                     help="Channels per peer for large-message segment "
                          "striping (extra tcp connections with their own "
                          "send locks and sender threads); 1 = one rail. "
                          "Read per segment")
    _shmseg.register_params()
    # the resilience plane's vars register beside the btl tuning vars:
    # injection (mpi_base_ft_inject_*) and the heartbeat detector
    # (mpi_base_ft_hb_*)
    _inject.register_params()
    from ompi_tpu_torch.ft import detector as _detector
    _detector.register_params()


def _probe_stream(chunk: int = 64 << 10, reps: int = 8,
                  probe_sm: bool = True) -> "tuple[float, float]":
    """~1 ms micro-probe of the two planes on this host: bytes/s pushing
    and popping a loopback ring against writing and reading a local
    socketpair. Returns (sm_bps, tcp_bps); sm_bps is 0.0 when the ring
    half is skipped. The tcp half always runs: its number is also the
    per-rail bandwidth estimate the segment decision rows read
    (``coll/decision.pipeline_plan``)."""
    payload = b"\x5a" * chunk
    sm_s = 0.0
    if probe_sm:
        ring = Ring(None, capacity=max(2 * chunk + (1 << 12), 1 << 20),
                    create=True)
        try:
            ring.push(payload)           # warm the mapping
            ring.pop()
            t0 = time.perf_counter()
            for _ in range(reps):
                ring.push(payload)
                ring.pop()
            sm_s = time.perf_counter() - t0
        finally:
            ring.close()
    a, b = socket.socketpair()
    try:
        a.sendall(payload)
        _drain_sock(b, chunk)
        t0 = time.perf_counter()
        for _ in range(reps):
            a.sendall(payload)
            _drain_sock(b, chunk)
        tcp_s = time.perf_counter() - t0
    finally:
        a.close()
        b.close()
    total = float(reps * chunk)
    sm_bps = total / max(sm_s, 1e-9) if sm_s > 0 else 0.0
    return sm_bps, total / max(tcp_s, 1e-9)


def _drain_sock(sock, n: int) -> None:
    got = 0
    while got < n:
        got += len(sock.recv(n - got))


class BmlEndpoint:
    """Composite endpoint: TcpEndpoint surface, sm fast path.

    Two transports per peer would break MPI's non-overtaking rule (a small
    tcp frame could pass a large sm frame sent earlier), so every outbound
    frame is stamped with a per-destination sequence number and the
    receive side delivers strictly in sequence, holding early arrivals
    back — ob1's recv-fragment sequencing (``pml_ob1_recvfrag.c:296-330``)
    at the bml boundary.
    """

    def __init__(self, rank: int, nprocs: int,
                 kv_set: Callable[[str, str], None],
                 kv_get: Callable[[str], str],
                 sink: Callable[[dict, bytes], None],
                 on_peer_lost: Optional[Callable[[int], None]] = None,
                 bind: str = "127.0.0.1"):
        register_params()
        # bind the injection plane to this process's world rank and
        # (re)compile the fault specs — a no-op leaving the gate cold
        # when mpi_base_ft_inject is unset
        _inject.refresh(rank)
        self.rank = rank
        self.nprocs = nprocs
        self._kv_get = kv_get
        self.sink = sink
        self._send_seq: Dict[int, "itertools.count"] = {
            p: itertools.count(1) for p in range(nprocs)}
        self._expect: Dict[int, int] = {}
        self._held: Dict[int, Dict[int, tuple]] = {}
        self._ready: Dict[int, deque] = {}
        self._draining: Dict[int, bool] = {}
        self._order_lock = threading.Lock()
        self.tcp = TcpEndpoint(rank, nprocs, kv_set, kv_get,
                               self._ordered_sink, on_peer_lost=on_peer_lost,
                               bind=bind)
        kv_set(f"ompi_tpu_torch/btl/host/{rank}", _host_identity())
        self.sm: Optional[SmEndpoint] = None
        # OMPI_TPU_TORCH_DISABLE_SM (the reference's OMPI_TPU_DISABLE_SM)
        # keeps both shared-memory planes out: tcp carries every frame
        no_sm = bool(os.environ.get("OMPI_TPU_TORCH_DISABLE_SM"))
        if var.var_get("btl_sm_enable", True) and nprocs > 1 and not no_sm:
            try:
                self.sm = SmEndpoint(
                    rank, nprocs, kv_set, kv_get, self._ordered_sink,
                    ring_bytes=int(var.var_get("btl_sm_ring_bytes",
                                               _DEF_RING_BYTES)))
            except OSError:              # no /dev/shm: tcp carries all
                self.sm = None
        # the zero-copy segment plane: built in every multi-rank world (it
        # allocates nothing until a send packs, and a receiver must be
        # able to adopt whatever its own send gate says); segfree frames
        # ride the unsequenced tcp plane, as the sm doorbells do
        self.shm_seg: Optional[_shmseg.SegPlane] = None
        if nprocs > 1 and not no_sm:
            self.shm_seg = _shmseg.SegPlane(rank, kv_set, kv_get,
                                            ctl_send=self.tcp.send_frame)
        self._same_host: Dict[int, bool] = {}
        self._sm_min = int(var.var_get("btl_sm_min_bytes", _DEF_MIN_BYTES))
        self.stats = {"sm": 0, "tcp": 0, "self": 0}
        # -- multi-rail striping state (send_segment) ------------------
        self._rail_lock = threading.Lock()
        self._rail_rr: Dict[int, "itertools.count"] = {}   # peer -> rr
        self._rail_seq: Dict[Tuple[int, int], "itertools.count"] = {}
        self._rail_expect: Dict[Tuple[int, int], int] = {}
        self._rail_qs: Dict[Tuple[int, int], "queue.Queue"] = {}
        # segment payload bytes per rail, sent + received, as the
        # btl_rail_bytes_c<r> pvars
        self.rail_bytes: Dict[int, int] = {}
        self.rail_stats = {"ooo": 0, "fallback": 0, "recv_frames": 0}
        self._rail_pvars(self.rails)
        # routing earns its default from data: sm is demoted for bulk
        # unless the micro-probe shows it beats tcp on this host. A
        # user-set btl_sm_min_bytes suppresses the routing half ("ran"
        # stays False); the tcp half always runs, since its number is
        # the per-rail bandwidth estimate (rail_gbps)
        self.probe_basis: Dict[str, object] = {"ran": False}
        user_min = var.var_overridden("btl_sm_min_bytes")
        sm_bps, tcp_bps = _probe_stream(
            probe_sm=self.sm is not None and not user_min)
        self.probe_basis["rail_gbps"] = round(tcp_bps / 1e9, 3)
        if not user_min:
            self.probe_basis.update({
                "ran": True,
                "sm_gbps": round(sm_bps / 1e9, 3) if sm_bps else None,
                "tcp_gbps": round(tcp_bps / 1e9, 3),
                "sm_demoted": False})
            if sm_bps > 0:
                demote = sm_bps <= tcp_bps * 1.1
                if demote:
                    self._sm_min = 1 << 62   # bulk stays on tcp
                self.probe_basis["sm_demoted"] = bool(demote)

    # -- rails ---------------------------------------------------------
    @property
    def rails(self) -> int:
        """``mpi_base_btl_rails``, read per segment: a change takes effect
        at the next segment (rail connections open lazily)."""
        return max(1, int(var.var_get("mpi_base_btl_rails", 1)))

    def _rail_pvars(self, rails: int) -> None:
        """A ``btl_rail_bytes_c<r>`` pvar for every rail up to ``rails``."""
        for r in range(rails):
            if r in self.rail_bytes:
                continue
            self.rail_bytes[r] = 0
            _pvar.pvar_register(
                f"btl_rail_bytes_c{r}",
                (lambda rr=r, ep=self: ep.rail_bytes.get(rr, 0)),
                unit="bytes",
                help=f"Segment payload bytes carried on rail {r} by this "
                     f"endpoint, send + receive")

    # -- the TcpEndpoint surface the Router binds ----------------------
    @property
    def _peers(self):
        return self.tcp._peers

    def _connect(self, peer: int):
        return self.tcp._connect(peer)

    def _is_same_host(self, peer: int) -> bool:
        cached = self._same_host.get(peer)
        if cached is None:
            theirs = self._kv_get(f"ompi_tpu_torch/btl/host/{peer}")
            if isinstance(theirs, bytes):
                theirs = theirs.decode()
            cached = self._same_host[peer] = theirs == _host_identity()
        return cached

    def _ordered_sink(self, header: dict, payload: bytes) -> None:
        """Deliver frames per sender in sequence order; early arrivals
        wait for their predecessors. The sink runs outside the order lock
        (it may send acks); a single drainer per sender keeps order."""
        if header.get("ctl") == "_smpoke":
            # doorbell: the peer parked records in our rings; drain them
            # on this already-awake reader thread, in one wake batch
            if self.sm is not None:
                _progress.wake_begin()
                try:
                    self.sm.drain(header.get("peer"))
                finally:
                    _progress.wake_end()
            return
        rq = header.pop("_rq", None)
        if rq is not None:
            self._rail_deliver(rq, header, payload)
            return
        sq = header.pop("_sq", None)
        if sq is None:                   # unsequenced (ctl) frame
            _progress.wake_note_frame()
            self.sink(header, payload)
            return
        src, seq = sq
        with self._order_lock:
            exp = self._expect.setdefault(src, 1)
            held = self._held.setdefault(src, {})
            ready = self._ready.setdefault(src, deque())
            if seq != exp:
                held[seq] = (header, payload)
                return                   # predecessors still in flight
            ready.append((header, payload))
            exp += 1
            while exp in held:
                ready.append(held.pop(exp))
                exp += 1
            self._expect[src] = exp
            if self._draining.get(src):
                return                   # the active drainer takes it
            self._draining[src] = True
        _progress.wake_begin()
        try:
            while True:
                with self._order_lock:
                    if not ready:
                        self._draining[src] = False
                        return
                    h, p = ready.popleft()
                _progress.wake_note_frame()
                try:
                    self.sink(h, p)
                except Exception:        # noqa: BLE001
                    # one bad frame drops only itself: an escaping error
                    # would leave _draining set and wedge this sender
                    traceback.print_exc()
        finally:
            _progress.wake_end()

    def _rail_deliver(self, rq, header: dict, payload) -> None:
        """A rail-striped segment: per-rail FIFO is tracked (a gap means
        cross-rail overtaking or a detour through rail 0: counted, never
        held back) and delivery is immediate, since the pml reassembles
        by segment index and MPI order was fixed by the train's init
        frame on the ordered stream. A ``_seg`` descriptor points at a
        shared slot: the segment is read from the mapping and the slot is
        freed once the sink's synchronous copy-out has returned."""
        src, rail, rseq = rq
        with self._order_lock:
            key = (src, rail)
            exp = self._rail_expect.get(key, 1)
            if rseq != exp:
                self.rail_stats["ooo"] += 1
            self._rail_expect[key] = max(exp, rseq + 1)
            self.rail_stats["recv_frames"] += 1
        seg = header.pop("_seg", None)
        view = None
        if seg is not None and self.shm_seg is not None:
            view = payload = self.shm_seg.view(seg)
        with self._rail_lock:
            self._rail_pvars(rail + 1)
            self.rail_bytes[rail] += len(payload)
        _progress.wake_note_frame()
        if view is None:
            self.sink(header, payload)
            return
        try:
            self.sink(header, payload)
        finally:
            view.release()
            self.shm_seg.send_free(seg["o"], seg["i"])

    def send_frame(self, peer: int, header: dict,
                   payload: bytes = b"") -> None:
        if peer == self.rank:            # btl/self loopback
            self.stats["self"] += 1
            self.sink(header, payload)
            return
        if _inject.active:
            # pml-plane fault hook (ft/inject): a "drop" fires here,
            # before the sequence stamp, so the loss models a message
            # that never reached the wire — the receiver never matches
            # it and no reorder-buffer hole is created
            act = _inject.frame_fault("pml", peer)
            if act is not None:
                if act[0] == "drop":
                    return
                _inject.delay_now(act[1])
        header = dict(header)
        header["_sq"] = (self.rank, next(self._send_seq[peer]))
        if (self.sm is not None and len(payload) >= self._sm_min
                and self._is_same_host(peer)):
            # a reader thread must never park behind a full peer ring:
            # try once and let tcp carry the frame instead (the sequence
            # number keeps the order whichever plane delivers)
            timeout = 0.0 if getattr(self.tcp._reader_tls, "active",
                                     False) else 60.0
            try:
                pushed = not ft.is_failed(peer) and \
                    self.sm.try_send(peer, header, payload,
                                     timeout=timeout)
            except (OSError, ValueError):    # ring closed mid-shutdown
                pushed = False
            if pushed:
                self.stats["sm"] += 1
                # the frame is published: a failed poke must not fall
                # back to tcp (a duplicate sequence number); the next
                # poke or frame drains the backlog
                try:
                    self.tcp.send_frame(peer, {"ctl": "_smpoke",
                                               "peer": self.rank})
                except OSError:
                    pass
                return
        self.stats["tcp"] += 1
        self.tcp.send_frame(peer, header, payload)

    # -- rail-striped segments (the pipelined rendezvous data plane) ---
    def send_segment(self, peer: int, header: dict, payload,
                     on_done=None) -> None:
        """Queue one unordered large-message segment on the next rail
        (round robin over ``mpi_base_btl_rails``). Each (peer, rail) has
        its own sender thread, so the caller returns at once and the
        next segment's preparation overlaps this one's wire time.
        ``on_done(wire_seconds)`` runs on the sender thread once the
        segment has left (0.0 for loopback): the pml's window and
        overlap accounting hang off it."""
        if peer == self.rank:            # btl/self loopback
            self.stats["self"] += 1
            with self._rail_lock:
                self.rail_bytes[0] = self.rail_bytes.get(0, 0) \
                    + len(payload)
            self.sink(dict(header), payload)
            if on_done is not None:
                on_done(0.0)
            return
        rails = self.rails
        with self._rail_lock:
            self._rail_pvars(rails)
            rr = self._rail_rr.get(peer)
            if rr is None:
                rr = self._rail_rr[peer] = itertools.count()
            rail = next(rr) % rails
            key = (peer, rail)
            seq = self._rail_seq.get(key)
            if seq is None:
                seq = self._rail_seq[key] = itertools.count(1)
            rseq = next(seq)
            q = self._rail_qs.get(key)
            if q is None:
                q = self._rail_qs[key] = queue.Queue()
                threading.Thread(
                    target=self._rail_send_loop, args=(q, peer, rail),
                    daemon=True,
                    name=f"btl-rail-{self.rank}-{peer}-{rail}").start()
            self.rail_bytes[rail] += len(payload)
        header = dict(header)
        header["_rq"] = (self.rank, rail, rseq)
        q.put((header, payload, on_done))

    def _rail_send_loop(self, q: "queue.Queue", peer: int,
                        rail: int) -> None:
        while True:
            item = q.get()
            if item is None:
                return                   # close(): retire
            header, payload, on_done = item
            t0 = time.perf_counter()
            tok = (_trace.begin("btl.rail", rail=rail, peer=peer,
                                bytes=len(payload))
                   if _trace.active else None)
            if _tele.active:
                # telemetry: payload bytes per rail frame — the stripe
                # width the rendezvous scheduler actually produced
                _tele.RAIL.record(len(payload))
            seg = None
            if (self.shm_seg is not None and _shmseg.enabled()
                    and "off" in header
                    and len(payload) >= self.shm_seg.min_bytes
                    and not ft.is_failed(peer)
                    and self._is_same_host(peer)):
                # zero-copy: park the segment in a shared slot and ship
                # only its descriptor. Offset-addressed segments only:
                # compressed ones lack "off" and are kept by the
                # receiving PipeStore, so they must not ride a slot the
                # receiver frees at once. A dry pool packs nothing.
                seg = self.shm_seg.pack(peer, payload)
                if seg is not None:
                    header["_seg"] = seg
                    payload = b""
            sent = False
            try:
                if not ft.is_failed(peer):
                    sent = self._rail_push(peer, header, payload, rail)
            finally:
                if seg is not None and not sent:
                    # the descriptor never left: the receiver will never
                    # free the slot, so reclaim it here
                    self.shm_seg.release(peer, seg["i"])
                if tok is not None:
                    _trace.end(tok, sent=sent)
                if on_done is not None:
                    on_done(time.perf_counter() - t0)
            # the payload may view a staging buffer or the sender's
            # array: hold nothing while waiting for the next segment
            del item, header, payload, on_done

    def _rail_push(self, peer: int, header: dict, payload,
                   rail: int) -> bool:
        """One segment onto the wire: a same-host peer's sm ring (all
        rails share the one ring per peer; index reassembly absorbs the
        interleaving), else the rail's socket, else a detour through
        rail 0's socket. False when the peer is gone (the failure
        detector reports that)."""
        if (self.sm is not None and len(payload) >= self._sm_min
                and self._is_same_host(peer)):
            try:
                pushed = self.sm.try_send(peer, header, payload,
                                          timeout=60.0)
            except (OSError, ValueError):    # ring closed mid-shutdown
                pushed = False
            if pushed:
                self.stats["sm"] += 1
                try:
                    self.tcp.send_frame(peer, {"ctl": "_smpoke",
                                               "peer": self.rank})
                except OSError:
                    pass
                return True
        try:
            self.tcp.send_frame_rail(peer, header, payload, rail)
            self.stats["tcp"] += 1
            return True
        except PeerDownError:
            pass
        try:                             # dropped rail: detour via rail 0
            self.tcp.send_frame(peer, header, payload)
        except OSError:
            return False
        self.stats["tcp"] += 1
        with self._rail_lock:
            self.rail_stats["fallback"] += 1
        return True

    def close(self) -> None:
        with self._rail_lock:
            rail_qs = list(self._rail_qs.values())
        for q in rail_qs:                # retire the rail senders
            q.put(None)
        if self.shm_seg is not None:
            self.shm_seg.close()
        if self.sm is not None:
            self.sm.close()
        self.tcp.close()
