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

Locality (the hwloc modex): every rank publishes its host and boot
identity; peers that share it are same-host.
"""
from __future__ import annotations

import itertools
import socket
import threading
import time
import traceback
import uuid
from collections import deque
from typing import Callable, Dict, Optional

from ompi_tpu_torch.btl.sm import Ring, SmEndpoint
from ompi_tpu_torch.btl.tcp import TcpEndpoint
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.runtime import progress as _progress

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


def _probe_stream(chunk: int = 64 << 10,
                  reps: int = 8) -> "tuple[float, float]":
    """~1 ms micro-probe of the two planes on this host: bytes/s pushing
    and popping a loopback ring against writing and reading a local
    socketpair. Returns (sm_bps, tcp_bps)."""
    payload = b"\x5a" * chunk
    ring = Ring(None, capacity=max(2 * chunk + (1 << 12), 1 << 20),
                create=True)
    try:
        ring.push(payload)               # warm the mapping
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
    return total / max(sm_s, 1e-9), total / max(tcp_s, 1e-9)


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
                 on_peer_lost: Optional[Callable[[int], None]] = None):
        register_params()
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
                               self._ordered_sink, on_peer_lost=on_peer_lost)
        kv_set(f"ompi_tpu_torch/btl/host/{rank}", _host_identity())
        self.sm: Optional[SmEndpoint] = None
        if var.var_get("btl_sm_enable", True) and nprocs > 1:
            try:
                self.sm = SmEndpoint(
                    rank, nprocs, kv_set, kv_get, self._ordered_sink,
                    ring_bytes=int(var.var_get("btl_sm_ring_bytes",
                                               _DEF_RING_BYTES)))
            except OSError:              # no /dev/shm: tcp carries all
                self.sm = None
        self._same_host: Dict[int, bool] = {}
        self._sm_min = int(var.var_get("btl_sm_min_bytes", _DEF_MIN_BYTES))
        self.stats = {"sm": 0, "tcp": 0, "self": 0}
        # routing earns its default from data: sm is demoted for bulk
        # unless the micro-probe shows it beats tcp on this host. A
        # user-set btl_sm_min_bytes suppresses the probe.
        self.probe_basis: Dict[str, object] = {"ran": False}
        if self.sm is not None and var.var_source("btl_sm_min_bytes") \
                in (None, var.SOURCE_DEFAULT):
            sm_bps, tcp_bps = _probe_stream()
            demote = sm_bps <= tcp_bps * 1.1
            if demote:
                self._sm_min = 1 << 62       # bulk stays on tcp
            self.probe_basis = {"ran": True,
                                "sm_gbps": round(sm_bps / 1e9, 3),
                                "tcp_gbps": round(tcp_bps / 1e9, 3),
                                "sm_demoted": demote}

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

    def send_frame(self, peer: int, header: dict,
                   payload: bytes = b"") -> None:
        if peer == self.rank:            # btl/self loopback
            self.stats["self"] += 1
            self.sink(header, payload)
            return
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
                pushed = self.sm.try_send(peer, header, payload,
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

    def close(self) -> None:
        if self.sm is not None:
            self.sm.close()
        self.tcp.close()
