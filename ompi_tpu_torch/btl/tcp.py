"""btl/tcp — framed TCP byte transport between ranks of a per-rank world.

Behavioral spec: ``opal/mca/btl/tcp`` — sockets carrying fragments between
peers whose addresses were exchanged through the PMIx modex
(``btl_tcp_component.c:109,498-520``); plus ``btl/self`` loopback. The port
of ``ompi_tpu/btl/tcp.py``.

Each OS process is one MPI rank. The modex is the job's
``torch.distributed.TCPStore`` (the PMIx stand-in): every rank binds an
ephemeral listening port and publishes ``ompi_tpu_torch/btl/<rank> ->
host:port``; peers connect lazily on first send. One frame = magic +
header length + payload length + pickled header + raw payload; arrays and
tensors travel as raw buffers described by (dtype, shape) in the header —
bulk data is never pickled. A reader thread per connection delivers frames
to the registered sink (the matching engine), the BTL active-message
callback into ob1's ``recv_frag_match``.
"""
from __future__ import annotations

import pickle
import queue
import socket
import struct
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ompi_tpu_torch import telemetry as _tele
from ompi_tpu_torch.ft import inject as _inject
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.trace import core as _trace

MAGIC = 0x7f4d5049          # "\x7fMPI"
_LEN = struct.Struct("!IQQ")  # magic, header_len, payload_len

# ctl-queue backpressure bound in BYTES (see _ctl_submit): far above
# anything a live link queues, far below address-space trouble
_CTL_MAX_BYTES = 256 << 20
_CTL_FRAME_OVERHEAD = 256   # accounting estimate per queued frame
# payloads at least this big go as a second sendall instead of being
# concatenated to the header, and are received straight into their own
# buffer; it is also the size of the reader's buffer
_BULK_MIN = 64 << 10
# kernel socket buffers: a bulk frame in flight must not wait for the
# peer's reader thread to be scheduled
_SOCK_BUF = 8 << 20
# paced-wire catch-up credit (btl_tcp_sim_gbps): a frame whose pace sleep
# woke late starts its wire slot where the previous slot ended, up to
# this much wall time earlier, so the simulated rate holds in aggregate
# and many small frames are not punished against one large frame
_PACE_CREDIT = 0.05


class PeerDownError(ConnectionError):
    """A send hit a dead or broken peer link, carrying whose link died."""

    def __init__(self, world_rank: int,
                 cause: Optional[BaseException] = None):
        msg = f"peer rank {world_rank} connection down"
        if cause is not None:
            msg += f": {type(cause).__name__}: {cause}"
        super().__init__(msg)
        self.world_rank = world_rank


def _raw_tensor(t: torch.Tensor) -> bytes:
    """The bytes of a CPU tensor in its own dtype (bf16 included: the
    bits are reinterpreted, never converted)."""
    t = t.detach().contiguous()
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def encode_payload(data: Any) -> Tuple[dict, bytes]:
    """(descriptor, raw bytes). A numpy array goes as raw bytes with its
    dtype and shape ("nd"); a CPU tensor likewise with its torch dtype
    name ("pt"). A CUDA tensor takes one device-to-host copy and arrives
    as a numpy array, as the reference's small ``jax.Array`` does; bf16,
    which numpy lacks, arrives as a CPU tensor. Anything else is pickled
    (the mpi4py generic-object convention)."""
    if isinstance(data, torch.Tensor):
        if data.is_cuda:
            host = data.detach().cpu()
            data = host if host.dtype == torch.bfloat16 else host.numpy()
        else:
            return ({"kind": "pt", "dtype": str(data.dtype)[6:],
                     "shape": tuple(data.shape)}, _raw_tensor(data))
    if isinstance(data, np.ndarray):
        arr = np.ascontiguousarray(data)
        return ({"kind": "nd", "dtype": arr.dtype.str,
                 "shape": arr.shape}, arr.tobytes())
    return {"kind": "obj"}, pickle.dumps(data)


def decode_payload(desc: dict, raw) -> Any:
    kind = desc.get("kind")
    if kind == "nd":
        return np.frombuffer(raw, dtype=np.dtype(desc["dtype"])) \
                 .reshape(desc["shape"]).copy()
    if kind == "pt":
        dtype = getattr(torch, desc["dtype"])
        if not len(raw):
            buf = torch.empty(0, dtype=torch.uint8)
        else:
            buf = torch.frombuffer(raw if isinstance(raw, bytearray)
                                   else bytearray(raw), dtype=torch.uint8)
        return buf.view(dtype).reshape(desc["shape"])
    return pickle.loads(raw)


def coordinator_facing(coord: str) -> str:
    """The address of this host's interface toward ``coord``
    (``host:port``, the job's store): the local address the kernel picks
    for a datagram socket connected there. Connecting a datagram socket
    sends nothing; it only routes."""
    host, port = coord.rsplit(":", 1)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.connect((host.strip("[]"), int(port)))
        return s.getsockname()[0]


def register_params() -> None:
    var.var_register(
        "btl", "tcp", "sim_gbps", vtype="float", default=0.0,
        help="When > 0, pace tcp frame sends to this many GB/s (wall-time "
             "floor per frame): a simulated slow tier for algorithm and "
             "compression A/Bs; 0 disables")


class TcpEndpoint:
    """One per process: the rank's listen socket + lazy peer connections.

    ``sink(header, payload)`` is called from reader threads for every
    arriving frame; it must be thread-safe. ``on_peer_lost(rank)`` is
    called when an identified inbound connection dies before ``close``.
    The listener binds ``bind`` and publishes it: loopback for the ranks
    of one host, the coordinator-facing interface for controllers that
    may sit on other hosts (``runtime/init``).
    """

    def __init__(self, rank: int, nprocs: int,
                 kv_set: Callable[[str, str], None],
                 kv_get: Callable[[str], str],
                 sink: Callable[[dict, bytes], None],
                 on_peer_lost: Optional[Callable[[int], None]] = None,
                 bind: str = "127.0.0.1"):
        self.rank = rank
        self.nprocs = nprocs
        self._kv_get = kv_get
        self.sink = sink
        self.on_peer_lost = on_peer_lost
        self._peers: Dict[int, socket.socket] = {}
        self._peer_locks: Dict[int, threading.Lock] = {}
        # multi-rail striping (bml.send_segment): rails >= 1 are extra
        # connections to the same peer listener, each with its own send
        # lock, so bulk sends on different rails overlap; rail 0 is the
        # ordinary _peers socket
        self._rail_peers: Dict[Tuple[int, int], socket.socket] = {}
        self._rail_locks: Dict[Tuple[int, int], threading.Lock] = {}
        self._lock = threading.Lock()
        self._closed = False
        # reader threads never block sending (acks): a reader stuck in
        # sendall stops recv()ing, and two ranks doing bidirectional bulk
        # sends then deadlock. Reader-originated frames divert to a
        # per-peer ctl sender thread instead.
        self._reader_tls = threading.local()
        self._ctl_qs: Dict[int, "queue.Queue"] = {}
        self._ctl_failed: set = set()
        self._ctl_q_bytes: Dict[int, int] = {}
        # flush-window counters, published by pml/perrank's Router as the
        # pvars btl_ctl_frames / btl_ctl_batches / btl_ctl_poke_dedup
        self.ctl_stats = {"frames": 0, "batches": 0, "poke_dedup": 0}
        # the paced-wire mode: btl_tcp_sim_gbps > 0 floors each frame's
        # send wall time at nbytes / rate, a simulated slow tier for
        # algorithm and compression A/Bs on hosts whose loopback is far
        # faster than a cross-host link. Off (0) by default: no pacing
        # and no extra clock reads
        register_params()
        self._sim_bps = float(var.var_get("btl_tcp_sim_gbps", 0.0)) * 1e9
        # per-socket pacing clocks, keyed by send-lock identity; an entry
        # is only touched under that lock (see _pace)
        self._pace_clock: Dict[int, float] = {}

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((bind, 0))
        self._listener.listen(max(nprocs, 8))
        host, port = self._listener.getsockname()
        kv_set(f"ompi_tpu_torch/btl/{rank}", f"{host}:{port}")
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"btl-tcp-accept-{rank}").start()

    # -- receive side --------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return                       # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                _SOCK_BUF)
            except OSError:
                pass
            threading.Thread(target=self._read_loop, args=(conn,),
                             daemon=True,
                             name=f"btl-tcp-read-{self.rank}").start()

    def _read_loop(self, conn: socket.socket) -> None:
        peer = -1                            # set by the hello frame
        rail = 0                             # ditto (extra-rail conns)
        self._reader_tls.active = True
        # a buffered reader takes a frame's prefix, header and small
        # payload in one recv where they arrived together
        rf = conn.makefile("rb", buffering=_BULK_MIN)
        try:
            while not self._closed:
                head = rf.read(_LEN.size)
                if len(head) < _LEN.size:
                    break
                magic, hlen, plen = _LEN.unpack(head)
                if magic != MAGIC:
                    peer = -1                # corrupt stream: drop the
                    break                    # conn, not a death report
                hraw = rf.read(hlen)
                praw = bytearray(plen) if plen >= _BULK_MIN else b""
                if plen >= _BULK_MIN:
                    got = rf.readinto(praw)
                elif plen:
                    praw = rf.read(plen)
                    got = len(praw)
                else:
                    got = 0
                if len(hraw) < hlen or got < plen:
                    break
                try:
                    header = pickle.loads(hraw)
                    if header.get("ctl") == "hello":
                        peer = header["peer"]
                        rail = int(header.get("rail", 0))
                        continue
                    self.sink(header, praw)
                except Exception:            # noqa: BLE001
                    # one bad frame must not kill the reader (the finally
                    # would then report a live peer dead); the lengths
                    # were consumed exactly, so framing stays aligned
                    traceback.print_exc()
        except (OSError, ValueError):
            pass
        finally:
            for c in (rf, conn):
                try:
                    c.close()
                except OSError:
                    pass
            # a dropped extra rail is degraded mode (its segments detour
            # to rail 0), not a death: only rail 0 reports the peer lost
            if peer >= 0 and rail == 0 and not self._closed \
                    and self.on_peer_lost:
                try:
                    self.on_peer_lost(peer)
                except Exception:            # noqa: BLE001
                    pass

    # -- send side -----------------------------------------------------
    def _connect(self, peer: int) -> socket.socket:
        with self._lock:
            s = self._peers.get(peer)
            if s is not None:
                return s
        addr = self._kv_get(f"ompi_tpu_torch/btl/{peer}")
        if isinstance(addr, bytes):
            addr = addr.decode()
        host, port = addr.rsplit(":", 1)
        s = socket.create_connection((host, int(port)), timeout=60)
        # the timeout bounds the connect only: death is the reader's EOF
        # business, and a multi-GB sendall may take minutes
        s.settimeout(None)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, _SOCK_BUF)
        except OSError:
            pass
        with self._lock:
            cur = self._peers.setdefault(peer, s)
            won = cur is s
            self._peer_locks.setdefault(peer, threading.Lock())
        if not won:
            s.close()                        # lost the race, never sent
            return cur
        hraw = pickle.dumps({"ctl": "hello", "peer": self.rank})
        with self._peer_locks[peer]:
            s.sendall(_LEN.pack(MAGIC, len(hraw), 0) + hraw)
        return s

    def _connect_rail(self, peer: int, rail: int) -> socket.socket:
        """An extra per-peer channel (multi-rail striping): rails >= 1
        open more connections to the same published listener. The hello
        carries the rail index, so the peer's reader knows this
        connection's EOF is a dropped rail, not a dead process: rail 0
        stays the failure detector's wire."""
        key = (peer, rail)
        with self._lock:
            s = self._rail_peers.get(key)
            if s is not None:
                return s
        addr = self._kv_get(f"ompi_tpu_torch/btl/{peer}")
        if isinstance(addr, bytes):
            addr = addr.decode()
        host, port = addr.rsplit(":", 1)
        s = socket.create_connection((host, int(port)), timeout=60)
        s.settimeout(None)               # as _connect: death is EOF's
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, _SOCK_BUF)
        except OSError:
            pass
        with self._lock:
            cur = self._rail_peers.setdefault(key, s)
            won = cur is s
            self._rail_locks.setdefault(key, threading.Lock())
        if not won:
            s.close()                        # lost the race, never sent
            return cur
        hraw = pickle.dumps({"ctl": "hello", "peer": self.rank,
                             "rail": rail})
        with self._rail_locks[key]:
            s.sendall(_LEN.pack(MAGIC, len(hraw), 0) + hraw)
        return s

    def evict_rail_socket(self, peer: int, rail: int) -> None:
        """Drop a broken rail connection; the next segment on this rail
        reconnects (meanwhile the caller detours through rail 0)."""
        with self._lock:
            s = self._rail_peers.pop((peer, rail), None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def send_frame_rail(self, peer: int, header: dict, payload,
                        rail: int) -> None:
        """Blocking send over one rail's own socket (rail <= 0 is the
        ordinary path). Each rail holds its own lock, so N rails carry N
        frames at once. A broken rail raises :class:`PeerDownError`
        after evicting the socket."""
        if rail <= 0 or peer == self.rank:
            self.send_frame(peer, header, payload)
            return
        try:
            s = self._connect_rail(peer, rail)
            self._sendmsg(s, self._rail_locks[(peer, rail)], header,
                          payload)
        except OSError as e:
            self.evict_rail_socket(peer, rail)
            raise PeerDownError(peer, e) from e

    def _evict_peer_socket(self, peer: int) -> None:
        with self._lock:
            s = self._peers.pop(peer, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def _ctl_peer_down(self, peer: int) -> None:
        """The peer's ctl link is dead: report once, drop its queue."""
        with self._lock:
            if peer in self._ctl_failed:
                return
            self._ctl_failed.add(peer)
            self._ctl_q_bytes[peer] = 0
            q = self._ctl_qs.get(peer)
        if q is not None:
            _drain(q)
        if not self._closed and self.on_peer_lost:
            try:
                self.on_peer_lost(peer)
            except Exception:                # noqa: BLE001
                pass

    def _ctl_send_loop(self, q: "queue.Queue", peer: int) -> None:
        try:
            self._ctl_send_loop_inner(q, peer)
        finally:
            _drain(q)

    def _ctl_send_loop_inner(self, q: "queue.Queue", peer: int) -> None:
        while True:
            item = q.get()
            if item is None or self._closed:
                return
            # everything already queued coalesces into ONE sendall; an
            # isolated frame goes out at once. Duplicate sm doorbells in
            # one window collapse to one: every record they announce is
            # published before the surviving poke's drain runs.
            batch = [item]
            retire = False
            while True:
                try:
                    nxt = q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    retire = True
                    break
                batch.append(nxt)
            cost = sum(len(p) + _CTL_FRAME_OVERHEAD for _, p in batch)
            if len(batch) > 1:
                seen_poke, deduped = False, []
                for header, payload in batch:
                    if header.get("ctl") == "_smpoke":
                        if seen_poke:
                            self.ctl_stats["poke_dedup"] += 1
                            continue
                        seen_poke = True
                    deduped.append((header, payload))
                batch = deduped
            with self._lock:
                self._ctl_q_bytes[peer] = max(
                    0, self._ctl_q_bytes.get(peer, 0) - cost)
            # frames carry the bml's sequence number: a dropped one would
            # park every later frame of this rank at the receiver. Retry
            # transient failures; a persistent one is a dead link. The
            # flush window is a span ("btl_ctl_flush"): a collective
            # blocked behind a big sendall shows there.
            tok = (_trace.begin("btl_ctl_flush", peer=peer,
                                frames=len(batch), bytes=cost)
                   if _trace.active else None)
            if _tele.active:
                # telemetry: flush-window width — frames coalesced per
                # sendall; a widening histogram means the ctl sender is
                # falling behind its queue
                _tele.FLUSH.record(len(batch))
            sent = False
            try:
                for attempt in range(3):
                    try:
                        self._send_batch_blocking(peer, batch)
                        sent = True
                        break
                    except Exception:        # noqa: BLE001
                        if self._closed:
                            return
                        self._evict_peer_socket(peer)
                        time.sleep(0.05 * (attempt + 1))
            finally:
                if tok is not None:
                    _trace.end(tok, sent=sent)
            if not sent:
                self._ctl_peer_down(peer)
                return
            self.ctl_stats["frames"] += len(batch)
            self.ctl_stats["batches"] += 1
            if retire:
                return

    def _ctl_submit(self, peer: int, header: dict, payload: bytes) -> None:
        with self._lock:
            if self._closed or peer in self._ctl_failed:
                return                       # undeliverable: drop
            pending = self._ctl_q_bytes.get(peer, 0) \
                + len(payload) + _CTL_FRAME_OVERHEAD
            over = pending > _CTL_MAX_BYTES
            if not over:
                self._ctl_q_bytes[peer] = pending
                q = self._ctl_qs.get(peer)
                if q is None:
                    q = self._ctl_qs[peer] = queue.Queue()
                    threading.Thread(
                        target=self._ctl_send_loop, args=(q, peer),
                        daemon=True,
                        name=f"btl-tcp-ctl-{self.rank}-{peer}").start()
        if over:
            self._ctl_peer_down(peer)
            return
        try:
            q.put_nowait((header, payload))  # never block a reader
        except queue.Full:                   # a bounded queue: the same
            self._ctl_peer_down(peer)        # contract as the byte cap

    def send_frame(self, peer: int, header: dict,
                   payload: bytes = b"") -> None:
        """Self-sends loop back without a socket (btl/self); frames sent
        from a reader thread go through the peer's ctl sender."""
        if peer == self.rank:
            self.sink(header, payload)
            return
        if getattr(self._reader_tls, "active", False):
            self._ctl_submit(peer, header, payload)
            return
        if _inject.active:               # fault-injection plane: one
            self._inject_faults(peer)    # attribute read when off
        self._send_frame_blocking(peer, header, payload)

    # -- fault injection (ft/inject: the tcp-plane hook site) ----------
    def _inject_faults(self, peer: int) -> None:
        """Runs only on app/sender threads (never readers — a delayed
        reader would stall every peer's drain) with the gate open."""
        act = _inject.frame_fault("tcp", peer)
        if act is not None and act[0] == "delay":
            _inject.delay_now(act[1])
        if _inject.should_sever(peer):
            self._sever_peer(peer)
        if _inject.should_corrupt(peer):
            self._send_corrupt(peer)
            # evict our own socket too: the receiver drops its end at
            # the bad magic, and a sequence-stamped frame still in
            # flight there would be lost — a permanent hole in the
            # peer's reorder buffer. A fresh connection carries the
            # frame that triggered the injection, so corruption costs
            # one reconnect and no sequenced frame.
            self._evict_peer_socket(peer)

    def _sever_peer(self, peer: int) -> None:
        """Abruptly cut the rail-0 connection (an injected network cut):
        SO_LINGER 0 turns the close into an RST, so the peer's reader
        sees what a process death looks like on the wire — an error on
        an identified connection."""
        with self._lock:
            s = self._peers.pop(peer, None)
        if s is None:
            return
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                         struct.pack("ii", 1, 0))
        except OSError:
            pass
        try:
            s.close()
        except OSError:
            pass

    def _send_corrupt(self, peer: int) -> None:
        """Injected wire corruption: a frame whose magic is wrong. The
        peer's framing check drops the connection without a death report
        (``_read_loop``'s corrupt-stream rule); the caller evicts this
        side's socket too, so the next send reconnects."""
        try:
            s = self._connect(peer)
            hraw = pickle.dumps({"ctl": "_corrupt"})
            bad = _LEN.pack(MAGIC ^ 0x00BAD000, len(hraw), 0) + hraw
            with self._peer_locks[peer]:
                s.sendall(bad)
        except OSError:
            pass

    def _send_frame_blocking(self, peer: int, header: dict,
                             payload: bytes = b"") -> None:
        """One reconnect retry absorbs a stale cached socket; a failure on
        a fresh connection raises :class:`PeerDownError`."""
        last: Optional[BaseException] = None
        for _ in range(2):
            try:
                s = self._connect(peer)
                self._sendmsg(s, self._peer_locks[peer], header, payload)
                return
            except OSError as e:
                last = e
                self._evict_peer_socket(peer)
                if self._closed:
                    break
        raise PeerDownError(peer, last)

    def _pace(self, key: int, nbytes: int, t0: float) -> None:
        """The paced-wire floor (btl_tcp_sim_gbps): hold the sender until
        the frame's simulated wire slot has elapsed. Slots come from a
        per-socket clock: a frame's slot begins where the previous one
        ended (with at most ``_PACE_CREDIT`` of catch-up), so sleep
        overshoot does not compound and a segment train paces at the
        rate of one large frame. Callers hold the socket's send lock,
        which serializes access to this key's clock."""
        budget = nbytes / self._sim_bps
        clock = self._pace_clock.get(key)
        start = t0 if clock is None else max(clock, t0 - _PACE_CREDIT)
        deadline = start + budget
        self._pace_clock[key] = deadline
        remain = deadline - time.perf_counter()
        if remain > 0:
            time.sleep(remain)

    def _sendmsg(self, s: socket.socket, lock: threading.Lock, header: dict,
                 payload) -> None:
        """One frame under the socket's send lock; a bulk payload goes as
        a second sendall under the same lock, so the frame stays
        contiguous on the wire."""
        hraw = pickle.dumps(header)
        nbytes = len(payload)
        head = _LEN.pack(MAGIC, len(hraw), nbytes) + hraw
        with lock:
            t0 = time.perf_counter() if self._sim_bps > 0 else 0.0
            if nbytes >= _BULK_MIN:
                s.sendall(head)
                s.sendall(payload)
            else:
                s.sendall(head + payload if nbytes else head)
            if self._sim_bps > 0:
                self._pace(id(lock), len(head) + nbytes, t0)

    def _send_batch_blocking(self, peer: int, frames) -> None:
        """One sendall for a whole flush window."""
        if len(frames) == 1:
            self._send_frame_blocking(peer, *frames[0])
            return
        s = self._connect(peer)
        parts = []
        for header, payload in frames:
            hraw = pickle.dumps(header)
            parts.append(_LEN.pack(MAGIC, len(hraw), len(payload)))
            parts.append(hraw)
            if payload:
                parts.append(payload)
        msg = b"".join(parts)
        lock = self._peer_locks[peer]
        with lock:
            t0 = time.perf_counter() if self._sim_bps > 0 else 0.0
            s.sendall(msg)
            if self._sim_bps > 0:
                self._pace(id(lock), len(msg), t0)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self._lock:
            ctl_qs = list(self._ctl_qs.values())
        for q in ctl_qs:                     # retire the ctl senders;
            try:                             # a full queue must not block
                q.put_nowait(None)           # close: its sender exits on
            except queue.Full:               # _closed once the sockets
                pass                         # below are shut
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            for s in (list(self._peers.values())
                      + list(self._rail_peers.values())):
                try:
                    s.close()
                except OSError:
                    pass
            self._peers.clear()
            self._rail_peers.clear()


def _drain(q: "queue.Queue") -> None:
    while True:
        try:
            q.get_nowait()
        except queue.Empty:
            return
