"""btl/shmseg — zero-copy shared-memory segment pools (the bulk plane).

The port of ``ompi_tpu/btl/shmseg.py``. Behavioral spec: the
Process-in-Process observation (arXiv:2305.10612) — same-node ranks that
share memory move a payload with about two byte-touches instead of the
ring path's copy-in and copy-out per hop. The sm rings stay the frame
plane (headers, doorbells, everything under ``mpi_base_shm_seg_min_bytes``);
a payload at or above it is packed once into a slot of a per-(sender,
peer) segment pool — a raw mmap'd file under ``/dev/shm`` named with the
job's tag, as the rings are — and only a small descriptor frame rides the
ordered stream. The receiver adopts the payload in place with
``np.frombuffer``: single-copy pt2pt.

Reclaim is tied to MPI completion: a ``weakref.finalize`` on the adopted
array sends a small unsequenced ``segfree`` frame back to the owner when
the last reference dies. The finalizer holds slot ids and the plane, never
the array, so no reference cycle pins a slot. A receiver that keeps an
adopted array forever pins one slot; the sender's pool then runs dry and
new sends take the ring/tcp path. POSIX keeps a mapping valid after its
owner unlinks the file.

On top of the pools sit the fold workspaces: one segment per (rank,
communicator), named through the KV, in which ``core/rankcomm``'s
node-local allreduce folds every member's contribution in place.

Everything here is off by default (``mpi_base_shm_zerocopy=0``); off, the
byte path is the ring plane's.
"""
from __future__ import annotations

import hashlib
import mmap
import os
import threading
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ompi_tpu_torch import telemetry as _tele
from ompi_tpu_torch.accelerator import framework as _fw
from ompi_tpu_torch.accelerator import job_tag
from ompi_tpu_torch.mca import pvar as _pvar
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.trace import core as _trace

# the launcher's post-job sweep globs on this prefix (tools/mpirun.py
# imports it), as it does on the rings' and the IPC segments'
POOL_PREFIX = "otptpool"

_DEF_MIN_BYTES = 256 << 10
_DEF_SEG_BYTES = 32 << 20
_DEF_SEG_COUNT = 4


def register_params() -> None:
    var.var_register(
        "mpi", "base", "shm_zerocopy", vtype="bool", default=False,
        help="Zero-copy shared-memory bulk plane: same-host payloads at or "
             "above mpi_base_shm_seg_min_bytes are packed once into a "
             "per-peer segment pool and adopted in place by the receiver "
             "(single-copy pt2pt and the in-segment node-local fold); off "
             "keeps the ring data plane")
    var.var_register(
        "mpi", "base", "shm_seg_min_bytes", vtype="int",
        default=_DEF_MIN_BYTES,
        help="Smallest payload routed through the zero-copy segment pool; "
             "smaller frames stay on the ring/tcp planes")
    var.var_register(
        "mpi", "base", "shm_seg_bytes", vtype="int",
        default=_DEF_SEG_BYTES,
        help="Per-slot capacity of the shared segment pools (also the "
             "per-communicator fold workspace size); larger payloads ride "
             "the pipelined rendezvous, whose segments use the pool slot "
             "by slot")
    var.var_register(
        "mpi", "base", "shm_seg_count", vtype="int",
        default=_DEF_SEG_COUNT,
        help="Slots per (sender, peer) segment pool; when every slot is "
             "pinned by an adoption not yet freed, new sends take the "
             "ring/tcp path")


def enabled() -> bool:
    register_params()
    return bool(var.var_get("mpi_base_shm_zerocopy", False))


def min_bytes() -> int:
    register_params()
    return int(var.var_get("mpi_base_shm_seg_min_bytes", _DEF_MIN_BYTES))


def coll_token(cid) -> str:
    """File- and KV-safe token for a communicator id: the fold
    workspace's key (CIDs agree across ranks by construction)."""
    return hashlib.md5(str(cid).encode()).hexdigest()[:8]


# -- pvars ------------------------------------------------------------------
stats = {"packs": 0, "adoptions": 0, "frees": 0, "no_slot": 0, "folds": 0}
_stats_lock = threading.Lock()


def count(key: str) -> None:
    """One more ``key`` event: reader, rail and app threads all count."""
    with _stats_lock:
        stats[key] += 1


def _register_pvars() -> None:
    _pvar.pvar_register(
        "btl_shm_adoptions", lambda: stats["adoptions"],
        help="Payloads adopted in place from a peer's shared segment (the "
             "zero-copy receive)")
    _pvar.pvar_register(
        "btl_shm_seg_packs", lambda: stats["packs"],
        help="Payloads packed into a shared segment slot by this process "
             "(the one sender-side copy)")
    _pvar.pvar_register(
        "btl_shm_seg_frees", lambda: stats["frees"],
        help="Segment slots returned to this process's pools by peers' "
             "segfree frames")
    _pvar.pvar_register(
        "btl_shm_seg_fallbacks", lambda: stats["no_slot"],
        help="Zero-copy-eligible sends that took the ring/tcp path because "
             "every pool slot was pinned")
    _pvar.pvar_register(
        "btl_shm_fold_ops", lambda: stats["folds"],
        help="In-segment node-local reductions this rank took part in "
             "(core/rankcomm shm fold)")


class _PoolFile:
    """One raw mmap'd ``/dev/shm`` file: ``count`` fixed-size slots, or one
    fold workspace. The creator owns the path and unlinks it at close;
    attachers never unlink. Close tolerates exported buffers (adopted
    arrays keep the mapping alive)."""

    def __init__(self, name: str, size: int, slot_bytes: int,
                 create: bool):
        path = os.path.join(_fw.SHM_DIR, name)
        if create:
            try:                         # a crashed same-tag job's file
                os.unlink(path)
            except OSError:
                pass
            self._fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR,
                               0o600)
            os.ftruncate(self._fd, size)
        else:
            self._fd = os.open(path, os.O_RDWR)
        self.name = name
        self.slot_bytes = slot_bytes
        self._path = path
        self._created = create
        self.buf = mmap.mmap(self._fd, size)

    def close(self) -> None:
        try:
            self.buf.close()
        except BufferError:              # exported views keep it mapped
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


def _send_free(plane: "SegPlane", owner: int, idx: int) -> None:
    """The adopted array's finalizer: return slot ``idx`` to ``owner``. A
    module function of ids only, so registering it never closes over the
    array. It runs on whatever thread drops the last reference, maybe at
    interpreter exit: best effort, never raises."""
    try:
        plane.send_free(owner, idx)
    except Exception:                    # noqa: BLE001
        pass


class SegPlane:
    """The rank's shared-segment plane: sender-owned per-peer slot pools,
    receiver-side attachments, and per-communicator fold workspaces.
    Built by the bml in every multi-rank world; it allocates nothing
    until first use."""

    def __init__(self, rank: int, kv_set, kv_get, ctl_send=None):
        register_params()
        self.rank = rank
        self._kv_set = kv_set
        self._kv_get = kv_get
        self._ctl = ctl_send             # unsequenced ctl frame sender
        self.slot_bytes = max(64 << 10, int(var.var_get(
            "mpi_base_shm_seg_bytes", _DEF_SEG_BYTES)))
        self.slot_count = max(1, int(var.var_get(
            "mpi_base_shm_seg_count", _DEF_SEG_COUNT)))
        self.min_bytes = min_bytes()
        self._lock = threading.Lock()
        self._closed = False
        # sender side: peer -> (pool file, free slot ids)
        self._pools: Dict[int, Tuple[_PoolFile, set]] = {}
        # receiver side: owner -> attached pool file
        self._attached: Dict[int, _PoolFile] = {}
        # fold workspaces: token -> own segment; (token, owner) -> peer's
        self._coll: Dict[str, _PoolFile] = {}
        self._coll_peers: Dict[Tuple[str, int], _PoolFile] = {}

    def _name_for(self, suffix: str) -> str:
        tag = job_tag()
        if tag:
            return f"{POOL_PREFIX}_{tag}_{self.rank}_{suffix}"
        return (f"{POOL_PREFIX}__{os.getpid():x}_{self.rank}_{suffix}_"
                f"{os.urandom(4).hex()}")

    # -- sender side ---------------------------------------------------
    def pack(self, peer: int, payload) -> Optional[dict]:
        """Copy ``payload`` into a free slot of the (rank -> peer) pool,
        the one sender-side copy. Returns the descriptor ``{"o", "i",
        "n"}``, or None (pool dry, too big, closed, no ``/dev/shm`` room):
        the caller takes the ring/tcp path."""
        mv = payload if isinstance(payload, (bytes, bytearray)) \
            else memoryview(payload).cast("B")
        n = len(mv)
        if n <= 0 or n > self.slot_bytes:
            return None
        publish = None
        with self._lock:
            if self._closed:
                return None
            ent = self._pools.get(peer)
            if ent is None:
                try:
                    pf = _PoolFile(self._name_for(str(peer)),
                                   self.slot_count * self.slot_bytes,
                                   self.slot_bytes, create=True)
                except OSError:
                    return None
                ent = self._pools[peer] = (pf, set(range(self.slot_count)))
                publish = (f"ompi_tpu_torch/shmseg/{self.rank}/{peer}",
                           f"{pf.name}:{self.slot_count}:"
                           f"{self.slot_bytes}")
            pf, free = ent
            if not free:
                count("no_slot")
                return None
            idx = free.pop()
        if publish is not None:
            # named before any descriptor can leave, so the receiver's
            # lazy attach always finds it
            self._kv_set(*publish)
        tok = (_trace.begin("btl.shm_seg", peer=peer, bytes=n)
               if _trace.active else None)
        ok = False
        try:
            off = idx * self.slot_bytes
            pf.buf[off:off + n] = mv
            ok = True
        finally:
            if tok is not None:
                _trace.end(tok, idx=idx, ok=ok)
            if not ok:
                with self._lock:         # a failed pack must not leak
                    free.add(idx)        # its slot
        count("packs")
        if _tele.active:
            _tele.SHMSEG.record(n)
        return {"o": self.rank, "i": idx, "n": n}

    def release(self, peer: int, idx: int) -> None:
        """A segfree arrived: ``peer`` is done with slot ``idx`` of our
        pool for it (a set absorbs a duplicate free)."""
        with self._lock:
            ent = self._pools.get(peer)
            if ent is not None and 0 <= idx < self.slot_count:
                ent[1].add(idx)
        count("frees")

    def peer_failed(self, world_rank: int) -> None:
        """Slots in flight to a dead peer are never freed by it: reclaim
        its whole pool."""
        with self._lock:
            ent = self._pools.get(world_rank)
            if ent is not None:
                ent[1].update(range(self.slot_count))

    # -- receiver side -------------------------------------------------
    def _attach(self, owner: int) -> _PoolFile:
        with self._lock:
            pf = self._attached.get(owner)
        if pf is not None:
            return pf
        val = self._kv_get(f"ompi_tpu_torch/shmseg/{owner}/{self.rank}")
        if isinstance(val, bytes):
            val = val.decode()
        name, count, slot_bytes = str(val).rsplit(":", 2)
        pf = _PoolFile(name, int(count) * int(slot_bytes), int(slot_bytes),
                       create=False)
        with self._lock:
            cur = self._attached.setdefault(owner, pf)
        if cur is not pf:
            pf.close()                   # lost the race (not the creator)
        return cur

    def adopt(self, desc: dict, inner: dict) -> np.ndarray:
        """An ``np.frombuffer`` view of the owner's slot, the zero-copy
        receive; its finalizer returns the slot when the last reference
        dies."""
        owner, idx, n = int(desc["o"]), int(desc["i"]), int(desc["n"])
        pf = self._attach(owner)
        dtype = np.dtype(inner["dtype"])
        flat = np.frombuffer(pf.buf, dtype=dtype,
                             count=n // max(dtype.itemsize, 1),
                             offset=idx * pf.slot_bytes)
        weakref.finalize(flat, _send_free, self, owner, idx)
        count("adoptions")
        if _tele.active:
            _tele.SHMSEG.record(n)
        return flat.reshape(tuple(inner["shape"]))

    def view(self, desc: dict) -> memoryview:
        """A transient view of the owner's slot for a caller that copies
        synchronously (a pipelined segment: the PipeStore assembles in
        place, then the bml frees the slot)."""
        pf = self._attach(int(desc["o"]))
        off = int(desc["i"]) * pf.slot_bytes
        return memoryview(pf.buf)[off:off + int(desc["n"])]

    def send_free(self, owner: int, idx: int) -> None:
        """Return slot ``idx`` to ``owner`` over the unsequenced ctl plane
        (best effort: a dead owner's pool no longer matters)."""
        send = self._ctl
        if send is None or self._closed:
            return
        try:
            send(owner, {"ctl": "segfree", "peer": self.rank, "i": idx})
        except OSError:
            pass

    # -- fold workspaces (core/rankcomm's in-segment reduction) --------
    def coll_segment(self, token: str) -> _PoolFile:
        """This rank's fold workspace for communicator ``token``: one
        slot-sized segment, created on first use and named through the KV.
        A comm's collectives run one at a time, so one workspace per
        (rank, comm) needs no bookkeeping."""
        publish = None
        with self._lock:
            pf = self._coll.get(token)
            if pf is None:
                pf = _PoolFile(self._name_for(f"c{token}"), self.slot_bytes,
                               self.slot_bytes, create=True)
                self._coll[token] = pf
                publish = (f"ompi_tpu_torch/shmseg/coll/{token}/{self.rank}",
                           f"{pf.name}:1:{self.slot_bytes}")
        if publish is not None:
            self._kv_set(*publish)
        return pf

    def coll_attach(self, token: str, owner: int) -> _PoolFile:
        """Member ``owner``'s fold workspace (call only after a barrier
        that orders its ``coll_segment`` before this)."""
        if owner == self.rank:
            return self.coll_segment(token)
        key = (token, owner)
        with self._lock:
            pf = self._coll_peers.get(key)
        if pf is not None:
            return pf
        val = self._kv_get(f"ompi_tpu_torch/shmseg/coll/{token}/{owner}")
        if isinstance(val, bytes):
            val = val.decode()
        name, _count, slot_bytes = str(val).rsplit(":", 2)
        pf = _PoolFile(name, int(slot_bytes), int(slot_bytes), create=False)
        with self._lock:
            cur = self._coll_peers.setdefault(key, pf)
        if cur is not pf:
            pf.close()
        return cur

    # -- lifecycle -----------------------------------------------------
    def close(self) -> None:
        """Unlink everything this rank created; attached mappings stay
        valid for adopted arrays still alive. Called from the bml's close
        at Finalize; the launcher sweeps what a killed rank left."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            files = ([pf for pf, _ in self._pools.values()]
                     + list(self._coll.values())
                     + list(self._attached.values())
                     + list(self._coll_peers.values()))
            self._pools.clear()
            self._coll.clear()
            self._attached.clear()
            self._coll_peers.clear()
        for pf in files:
            pf.close()


def adopt(endpoint, d: dict) -> np.ndarray:
    """Receive-side hook (``pml/perrank``'s ``_incoming``, kind
    ``shmseg``)."""
    plane = getattr(endpoint, "shm_seg", None)
    if plane is None:
        raise RuntimeError("shmseg descriptor with no segment plane")
    return plane.adopt(d, d["inner"])


def _host_array(data) -> Optional[np.ndarray]:
    """The numpy form the segment carries, or None to decline: numpy
    arrays, and CUDA tensors with a numpy dtype (their eager frame would
    arrive as numpy too, after the same device-to-host copy). CPU tensors
    arrive as tensors on the eager path, so they keep it."""
    if isinstance(data, np.ndarray):
        return None if data.dtype.hasobject else data
    if isinstance(data, torch.Tensor) and data.is_cuda \
            and data.dtype != torch.bfloat16:
        return data.detach().cpu().numpy()
    return None


def maybe_send_zerocopy(engine, data, dest: int, tag: int,
                        synchronous: bool):
    """The pml's same-host protocol switch: returns a completed Request
    when the payload was packed into a shared segment and announced by a
    small ordered descriptor frame, or None to fall through. When it
    returns None, nothing here has touched the wire."""
    if not enabled():
        return None
    router = engine.router
    ep = router.endpoint
    plane = getattr(ep, "shm_seg", None)
    if plane is None:
        return None
    total = getattr(data, "nbytes", None)
    if isinstance(data, torch.Tensor):
        total = data.numel() * data.element_size()
    if total is None or total < plane.min_bytes or total > plane.slot_bytes:
        return None
    wdest = engine.comm.world_rank_of(dest)
    if wdest == router.rank or not ep._is_same_host(wdest):
        return None
    arr = _host_array(data)
    if arr is None:
        return None
    arr = np.ascontiguousarray(arr)
    seg = plane.pack(wdest, arr)
    if seg is None:
        return None                      # pool pressure: ring path
    from ompi_tpu_torch.core.errhandler import ERR_PENDING, MPIError
    from ompi_tpu_torch.core.request import Request
    from ompi_tpu_torch.pml.perrank import WAIT_TIMEOUT, _send
    me = engine.comm.rank()
    t = engine.traffic.setdefault((me, dest), [0, 0])
    t[0] += 1
    t[1] += int(total)
    header = {"cid": engine.comm.cid, "src": me, "tag": tag,
              "desc": {"kind": "shmseg", "o": seg["o"], "i": seg["i"],
                       "n": seg["n"],
                       "inner": {"kind": "nd", "dtype": arr.dtype.str,
                                 "shape": tuple(arr.shape)}}}
    ev = aid = None
    if synchronous:
        aid, ev = router.new_ack()
        header["ack_id"] = aid
        header["wsrc"] = engine.comm.world_rank_of(me)
    # the descriptor rides the ordered stream: it is what matches, so
    # zero-copy and fallback sends to one peer never overtake each other
    try:
        _send(router, wdest, header, b"")
    except BaseException:
        plane.release(wdest, seg["i"])   # undelivered: the slot must not
        raise                            # leak
    if ev is not None and not ev.wait(WAIT_TIMEOUT):
        router.cancel_ack(aid)
        raise MPIError(ERR_PENDING,
                       "ssend timed out waiting for the receive")
    return Request.completed()


def _reset_for_tests() -> None:
    for k in stats:
        stats[k] = 0


register_params()
_register_pvars()
