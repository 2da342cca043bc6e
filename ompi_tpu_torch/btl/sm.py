"""btl/sm — shared-memory byte transport between same-host ranks.

Behavioral spec: ``opal/mca/btl/sm`` — per-peer single-producer/single-
consumer FIFOs over POSIX shared memory (``btl_sm_module.c:34-36,95-98``,
``btl_sm_fifo.h``). The port of ``ompi_tpu/btl/sm.py``.

One SPSC ring per ordered rank pair, a file under ``/dev/shm`` mapped by
both sides. The receiver creates its inbound rings at init and publishes
their names through the store (the modex); senders attach lazily. Frames
reuse btl/tcp's wire format, so the matching engine cannot tell which
transport delivered a frame.

Wakeup model: a thread polling the rings would convoy with the delivery
path under the GIL, so this btl is the bandwidth plane only: payload bytes
ride the ring, and the sender's bml follows each push with a tiny tcp
"poke" whose blocking reader thread drains the rings. Drains are
serialized by a consumer lock (the single-consumer contract).

SPSC memory model: head (consumer-owned) and tail (producer-owned) are
monotonic u64 byte counters, each on its own cache line; data is written
before the tail store that publishes it, and each side stores only its
own counter.
"""
from __future__ import annotations

import mmap
import os
import pickle
import struct
import threading
import time
import traceback
from typing import Callable, Dict, Optional

from ompi_tpu_torch.accelerator import framework as _fw
from ompi_tpu_torch.accelerator import job_tag
from ompi_tpu_torch.btl.tcp import _LEN, MAGIC
from ompi_tpu_torch.ft import inject as _inject
from ompi_tpu_torch.trace import core as _trace

_REC = struct.Struct("<Q")           # counter / per-record length prefix
_TAIL_OFF = 64
DATA_OFF = 128
RING_PREFIX = "otptsm"


class Ring:
    """SPSC byte ring over one shared-memory file.

    Layout: [head u64 @0][tail u64 @64][data @128 .. 128+capacity). head
    and tail count bytes consumed/produced since creation; the data offset
    is counter % capacity. The creator owns the file and unlinks it at
    close.
    """

    def __init__(self, name: Optional[str], capacity: int = 1 << 20,
                 create: bool = False):
        self.capacity = capacity
        size = DATA_OFF + capacity
        if create:
            name = name or f"{RING_PREFIX}__{os.getpid():x}_" \
                           f"{os.urandom(6).hex()}"
            path = os.path.join(_fw.SHM_DIR, name)
            self._fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR,
                               0o600)
            os.ftruncate(self._fd, size)
        else:
            path = os.path.join(_fw.SHM_DIR, name)
            self._fd = os.open(path, os.O_RDWR)
        self.name = name
        self._path = path
        self._created = create
        self._buf = mmap.mmap(self._fd, size)
        if create:
            self._buf[:DATA_OFF] = b"\0" * DATA_OFF

    def _head(self) -> int:
        return _REC.unpack_from(self._buf, 0)[0]

    def _tail(self) -> int:
        return _REC.unpack_from(self._buf, _TAIL_OFF)[0]

    # -- producer side -------------------------------------------------
    def fits(self, nbytes: int) -> bool:
        """Can a record of nbytes ever fit (the eager limit)?"""
        return _REC.size + nbytes <= self.capacity

    def push(self, record: bytes, timeout: float = 60.0) -> bool:
        """Append one length-prefixed record, waiting for space; False on
        timeout. ``timeout=0`` is a strict try-push."""
        need = _REC.size + len(record)
        if need > self.capacity:
            return False
        if timeout <= 0:
            if self.capacity - (self._tail() - self._head()) < need:
                return False
        else:
            deadline = time.monotonic() + timeout
            spins = 0
            while self.capacity - (self._tail() - self._head()) < need:
                spins += 1
                if spins > 200:
                    if time.monotonic() > deadline:
                        return False
                    time.sleep(0.00005)
        tail = self._tail()
        self._write(tail, _REC.pack(len(record)))
        self._write(tail + _REC.size, record)
        _REC.pack_into(self._buf, _TAIL_OFF, tail + need)   # publish last
        return True

    def _write(self, counter: int, data: bytes) -> None:
        off = counter % self.capacity
        first = min(len(data), self.capacity - off)
        base = DATA_OFF + off
        self._buf[base:base + first] = data[:first]
        if first < len(data):                    # wrap
            rest = len(data) - first
            self._buf[DATA_OFF:DATA_OFF + rest] = data[first:]

    # -- consumer side -------------------------------------------------
    def pop(self) -> Optional[bytes]:
        """Take one record, or None if the ring is empty."""
        head = self._head()
        if self._tail() - head < _REC.size:
            return None
        n = _REC.unpack(self._read(head, _REC.size))[0]
        record = self._read(head + _REC.size, n)
        _REC.pack_into(self._buf, 0, head + _REC.size + n)
        return record

    def _read(self, counter: int, n: int) -> bytes:
        off = counter % self.capacity
        first = min(n, self.capacity - off)
        base = DATA_OFF + off
        out = bytes(self._buf[base:base + first])
        if first < n:
            out += bytes(self._buf[DATA_OFF:DATA_OFF + n - first])
        return out

    def close(self) -> None:
        try:
            self._buf.close()
        except (BufferError, ValueError):
            pass
        try:
            os.close(self._fd)
        except OSError:
            pass
        if self._created:
            try:
                os.unlink(self._path)
            except OSError:
                pass


class SmEndpoint:
    """The rank's shared-memory plane: inbound rings (created here, names
    modex'd) and lazily attached outbound rings, one per peer."""

    def __init__(self, rank: int, nprocs: int,
                 kv_set: Callable[[str, str], None],
                 kv_get: Callable[[str], str],
                 sink: Callable[[dict, bytes], None],
                 ring_bytes: int = 1 << 20):
        self.rank = rank
        self.nprocs = nprocs
        self._kv_get = kv_get
        self.sink = sink
        self.ring_bytes = ring_bytes
        self._closed = False
        self._out: Dict[int, Ring] = {}
        self._out_lock = threading.Lock()
        self._drain_lock = threading.Lock()  # single-consumer contract
        # one producer per ring: app threads and reader threads may both
        # send to a peer, so each outbound ring has a producer lock
        self._push_locks: Dict[int, threading.Lock] = {}
        # names carry the job tag so the launcher can sweep rings that a
        # killed rank leaked
        tag = job_tag()
        self._in: Dict[int, Ring] = {}
        for src in range(nprocs):
            if src == rank:
                continue
            name = f"{RING_PREFIX}_{tag}_{rank}_{src}" if tag else None
            if name:
                try:                     # a crashed same-tag job's
                    os.unlink(os.path.join(_fw.SHM_DIR, name))   # leftover
                except OSError:
                    pass
            ring = Ring(name, ring_bytes, create=True)
            self._in[src] = ring
            kv_set(f"ompi_tpu_torch/btlsm/{rank}/{src}", ring.name)

    # -- receive side --------------------------------------------------
    def drain(self, src: Optional[int] = None) -> int:
        """Pop and deliver every pending record (from one sender, or all);
        called from the tcp reader thread that received the poke."""
        if self._closed:
            return 0
        rings = ([self._in[src]] if src is not None and src in self._in
                 else list(self._in.values()))
        n = 0
        tok = (_trace.begin("btl_sm_drain", src=src)
               if _trace.active else None)
        try:
            with self._drain_lock:
                for ring in rings:
                    rec = ring.pop()
                    while rec is not None:
                        n += 1
                        self._deliver(rec)
                        rec = ring.pop()
        finally:
            if tok is not None and n:    # empty polls would swamp the
                _trace.end(tok, frames=n)    # ring with noise
        return n

    def _deliver(self, rec: bytes) -> None:
        try:
            magic, hlen, plen = _LEN.unpack_from(rec, 0)
            if magic != MAGIC:
                return
            hraw = rec[_LEN.size:_LEN.size + hlen]
            praw = rec[_LEN.size + hlen:_LEN.size + hlen + plen]
            self.sink(pickle.loads(hraw), praw)
        except Exception:                # noqa: BLE001
            traceback.print_exc()

    # -- send side -----------------------------------------------------
    def _attach(self, peer: int) -> Ring:
        with self._out_lock:
            ring = self._out.get(peer)
            if ring is not None:
                return ring
        name = self._kv_get(f"ompi_tpu_torch/btlsm/{peer}/{self.rank}")
        if isinstance(name, bytes):
            name = name.decode()
        ring = Ring(name, self.ring_bytes)
        with self._out_lock:
            return self._out.setdefault(peer, ring)

    def try_send(self, peer: int, header: dict, payload: bytes,
                 timeout: float = 60.0) -> bool:
        """Send one frame if it fits the ring; False tells the bml to
        route it through tcp. Reader threads pass ``timeout=0``: a full
        ring must divert the frame at once, not stall inbound progress."""
        if _inject.active:
            # sm-plane fault hook (ft/inject): "drop" here means this
            # transport refuses the frame — bml's fallback carries it
            # over tcp (a full ring's signature), so delivery stays
            # correct while the fallback path is exercised. A delay runs
            # only on callers that may block (the routing timeout's rule)
            act = _inject.frame_fault("sm", peer)
            if act is not None:
                if act[0] == "drop":
                    return False
                if timeout > 0:
                    _inject.delay_now(act[1])
        hraw = pickle.dumps(header)
        rec = _LEN.pack(MAGIC, len(hraw), len(payload)) + hraw + payload
        ring = self._attach(peer)
        if not ring.fits(len(rec)):
            return False
        with self._out_lock:
            lock = self._push_locks.setdefault(peer, threading.Lock())
        if timeout <= 0:
            if not lock.acquire(blocking=False):
                return False             # a busy producer is a wait
            try:
                return ring.push(rec, timeout=0)
            finally:
                lock.release()
        with lock:
            return ring.push(rec, timeout=timeout)

    def close(self) -> None:
        self._closed = True
        with self._drain_lock:           # no drain mid-teardown
            for ring in self._out.values():
                ring.close()
            for ring in self._in.values():
                ring.close()
