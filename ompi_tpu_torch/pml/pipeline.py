"""pml/pipeline — segment-pipelined rendezvous for large host payloads.

The port of ``ompi_tpu/pml/pipeline.py``. Behavioral spec: ob1's pipelined
rendezvous (``pml_ob1_sendreq.h:389-460``) — above the rendezvous
threshold a payload leaves the single-copy eager path and moves as a
train of fragments, so packing overlaps the wire, and the send scheduler
(``mca_pml_ob1_send_request_schedule``) spreads fragments over every
eligible BTL.

Host payloads at or above ``mpi_base_pipeline_min_bytes`` are cut into
segments (size from ``coll/decision.pipeline_plan``, fed by the bml
probe's per-rail bandwidth; ``mpi_base_pipeline_segment_bytes``
overrides) with ``mpi_base_pipeline_depth`` segments in flight. A small
init frame rides the ordered bml stream — it is what matches, so MPI's
non-overtaking rule holds — while the segments travel unordered, striped
round robin over ``mpi_base_btl_rails`` rails (``btl/bml.send_segment``).
Each segment is sliced, staged to the host (a device tensor through
``btl/devxfer.SegmentStager``'s double buffer) and compressed
(``compress/wire`` per segment, gated on the whole message) while earlier
ones are on the wire. The receiver reassembles by segment index
(:class:`PipeStore`), so rails may deliver in any order.

A tensor on the rank's device counts as the reference's ``jax.Array``:
it is staged segment by segment and never copied whole to the host. What
arrives is what the eager path would deliver for the same payload: a
numpy array, or a CPU tensor for a CPU tensor (and for a dtype numpy
lacks, such as bf16, whose bytes travel as they are).

Observability: the ``pml_pipeline_segments``, ``pml_pipeline_inits`` and
``pml_overlap_ratio`` pvars, and ``stats["staged"]`` (segments staged
from a device tensor).
"""
from __future__ import annotations

import itertools
import pickle
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _prof

from ompi_tpu_torch import accelerator
from ompi_tpu_torch import telemetry as _tele
from ompi_tpu_torch.btl.tcp import decode_payload
from ompi_tpu_torch.compress import wire as _cwire
from ompi_tpu_torch.core.errhandler import ERR_PENDING, ERR_PROC_FAILED, \
    MPIError
from ompi_tpu_torch.mca import pvar as _pvar
from ompi_tpu_torch.mca import var as _var
from ompi_tpu_torch.runtime import progress as _progress
from ompi_tpu_torch.trace import core as _trace

_DEF_MIN_BYTES = 4 << 20
_DEF_SEG_BYTES = 1 << 20
_DEF_DEPTH = 4
WAIT_TIMEOUT = 600.0

_uids = itertools.count(1)


def register_params() -> None:
    _var.var_register(
        "mpi", "base", "pipeline_enable", vtype="bool", default=True,
        help="Segment-pipelined rendezvous for large host-path pt2pt "
             "payloads; off restores the serial eager path")
    _var.var_register(
        "mpi", "base", "pipeline_min_bytes", vtype="int",
        default=_DEF_MIN_BYTES,
        help="Host payloads at or above this take the pipelined "
             "rendezvous (ordered init frame + unordered striped segment "
             "train)")
    _var.var_register(
        "mpi", "base", "pipeline_segment_bytes", vtype="int",
        default=_DEF_SEG_BYTES,
        help="Segment size of the pipelined rendezvous; left at the "
             "default, the size comes from the decision rows "
             "(coll/decision.pipeline_plan, fed by the bml probe's "
             "per-rail bandwidth)")
    _var.var_register(
        "mpi", "base", "pipeline_depth", vtype="int", default=_DEF_DEPTH,
        help="Segments in flight per pipelined send (preparing segment "
             "s+depth waits for segment s to leave)")


def enabled() -> bool:
    register_params()
    return bool(_var.var_get("mpi_base_pipeline_enable", True))


def min_bytes() -> int:
    register_params()
    return int(_var.var_get("mpi_base_pipeline_min_bytes", _DEF_MIN_BYTES))


def depth() -> int:
    register_params()
    return max(1, int(_var.var_get("mpi_base_pipeline_depth", _DEF_DEPTH)))


def segment_bytes_for(total: int, endpoint=None) -> int:
    """Segment size for one ``total``-byte transfer: a user-set
    ``mpi_base_pipeline_segment_bytes`` wins; otherwise the decision row
    picks by message size and the probed per-rail bandwidth."""
    register_params()
    if _var.var_overridden("mpi_base_pipeline_segment_bytes"):
        return max(64 << 10, int(_var.var_get(
            "mpi_base_pipeline_segment_bytes", _DEF_SEG_BYTES)))
    from ompi_tpu_torch.coll import decision
    basis = getattr(endpoint, "probe_basis", None) or {}
    plan = decision.pipeline_plan(
        total, rails=int(getattr(endpoint, "rails", 1) or 1),
        rail_gbps=basis.get("rail_gbps"))
    return int(plan["segment_bytes"])


# -- pvars ------------------------------------------------------------------
stats = {"segments": 0, "inits": 0, "staged": 0}
_gauges = {"overlap_ratio": 0.0}
_stats_lock = threading.Lock()      # sends may run on several threads


def _register_pvars() -> None:
    _pvar.pvar_register(
        "pml_pipeline_segments", lambda: stats["segments"],
        help="Segments sent by the pipelined rendezvous")
    _pvar.pvar_register(
        "pml_pipeline_inits", lambda: stats["inits"],
        help="Pipelined rendezvous trains started by this process")
    _pvar.pvar_register(
        "pml_overlap_ratio", lambda: _gauges["overlap_ratio"],
        unit="ratio", var_class=_pvar.CLASS_LEVEL,
        help="Share of the serial cost (segment preparation + summed "
             "per-rail wire time) hidden by overlap on the most recent "
             "pipelined send")


# -- receive-side reassembly ------------------------------------------------
class _PipeBuf:
    __slots__ = ("lock", "segs", "nseg", "event", "error", "buf", "have")

    def __init__(self):
        self.lock = threading.Lock()
        self.segs: Dict[int, Any] = {}
        self.nseg: Optional[int] = None
        self.event = threading.Event()
        self.error: Optional[BaseException] = None
        # offset-addressed trains (uncompressed): one payload-sized buffer
        # assembled in place; resolve() hands it over without a copy
        self.buf: Optional[bytearray] = None
        self.have = 0


class PipeStore:
    """Segment-train reassembly, keyed (source world rank, pipe id).

    Segments arrive unordered from any rail's reader thread; the init
    frame may land before, between or after them (it rides the ordered
    stream, they do not), so both sides get-or-create the buffer. One
    store per Router."""

    def __init__(self):
        self._lock = threading.Lock()
        self._bufs: Dict[Tuple[int, int], _PipeBuf] = {}

    def _buf(self, key: Tuple[int, int]) -> _PipeBuf:
        with self._lock:
            b = self._bufs.get(key)
            if b is None:
                b = self._bufs[key] = _PipeBuf()
        return b

    def deliver(self, header: dict, raw) -> None:
        """One segment frame, on a btl reader thread. An offset-addressed
        segment (``off``/``tb``) is copied straight into the one assembly
        buffer, so ``raw`` may be a transient view (a shared slot the bml
        frees after this returns). A compressed segment has an irregular
        length and is decoded on the consumer thread, so it is kept as
        is (its ``raw`` is always a buffer of its own)."""
        b = self._buf((int(header["psrc"]), int(header["pipe"])))
        off = header.get("off")
        with b.lock:
            if b.nseg is None:
                b.nseg = int(header["n"])
            if off is not None:
                if b.buf is None:
                    b.buf = bytearray(int(header["tb"]))
                b.buf[off:off + len(raw)] = raw
                b.have += 1
                done = b.have >= b.nseg
            else:
                b.segs[int(header["idx"])] = raw
                done = len(b.segs) >= b.nseg
        if done:
            _progress.wake(b.event)

    def claim(self, psrc: int, uid: int, nseg: int) -> _PipeBuf:
        """The init frame's side: bind the train's length."""
        b = self._buf((int(psrc), int(uid)))
        with b.lock:
            b.nseg = int(nseg)
            done = (b.have if b.buf is not None
                    else len(b.segs)) >= b.nseg
        if done:
            b.event.set()                # the whole train raced the init
        return b

    def forget(self, psrc: int, uid: int) -> None:
        with self._lock:
            self._bufs.pop((int(psrc), int(uid)), None)

    def pending(self) -> int:
        with self._lock:
            return len(self._bufs)

    def fail_peer(self, world_rank: int) -> None:
        """A dead sender's unfinished trains never complete: fail their
        waiters instead of letting them run into the timeout."""
        with self._lock:
            bufs = [b for (src, _), b in self._bufs.items()
                    if src == world_rank]
        err = MPIError(ERR_PROC_FAILED, f"pipelined payload source rank "
                                        f"{world_rank} died mid-train")
        for b in bufs:
            b.error = err
            _progress.wake(b.event)


class PipePayload:
    """Descriptor of a segmented payload in flight: the object that
    matches (probe and status see the right counts) while segments are
    still landing. ``resolve()`` waits for the train and assembles it on
    the consumer thread, never on a reader thread."""

    def __init__(self, router, desc: dict):
        self._desc = desc
        self._store: PipeStore = router.pipes
        self._buf = self._store.claim(desc["psrc"], desc["pipe"],
                                      desc["nseg"])
        self._result: Any = None
        self._done = False
        self._rlock = threading.Lock()
        inner = desc["inner"]
        self.nbytes = int(desc["nbytes"])
        self.shape = tuple(inner["shape"])
        self.size = int(np.prod(self.shape)) if self.shape else 1

    def resolve(self):
        with self._rlock:                # exactly once
            if self._done:
                return self._result
            b = self._buf
            if not b.event.wait(WAIT_TIMEOUT):
                raise MPIError(ERR_PENDING, "pipelined payload timed out "
                                            "waiting for its segments")
            if b.error is not None:
                raise b.error
            desc = self._desc
            inner = desc["inner"]
            n = int(desc["nseg"])
            with b.lock:
                buf = b.buf
                segs = None if buf is not None \
                    else [b.segs[i] for i in range(n)]
                b.buf = None
                b.segs = {}
            if inner.get("comp"):
                # each segment is an independently quantized slice of the
                # flattened payload
                parts = [_cwire.decode(pickle.loads(s)) for s in segs]
                flat = parts[0] if len(parts) == 1 else np.concatenate(
                    [p.reshape(-1) for p in parts])
                out = flat.reshape(self.shape)
            else:
                raw = buf if buf is not None else bytearray(b"".join(segs))
                out = _adopt(inner, raw)
            self._store.forget(desc["psrc"], desc["pipe"])
            self._result = out
            self._done = True
            return out


def _adopt(inner: dict, raw: bytearray):
    """The assembled bytes as the payload the eager path would deliver,
    without a copy: numpy for "nd", a CPU tensor for "pt"."""
    if inner["kind"] == "pt":
        return decode_payload(inner, raw)
    return np.frombuffer(raw, dtype=np.dtype(inner["dtype"])) \
        .reshape(inner["shape"])


def maybe_resolve(data):
    """Consumer-side hook: assemble a pipelined payload; anything else
    passes through (composes after devxfer's hook)."""
    if isinstance(data, PipePayload):
        return data.resolve()
    return data


# -- send side --------------------------------------------------------------
def _comp_codec(dtype_name: str, total: int) -> Optional[str]:
    """Per-segment compression gate: ``compress/wire.eligible``'s gates
    applied to the whole message (a segment alone may sit under the
    floor)."""
    from ompi_tpu_torch import compress as _c
    if not _c.enabled():
        return None
    if dtype_name not in ("float32", "float64"):
        return None
    if total < _c.min_bytes():
        return None
    return _c.codec_name()


def _carried(data):
    """(flat source, numpy dtype of its elements, bytes, inner descriptor,
    on the device) of a payload the pipeline can carry, or None. The
    inner descriptor is what the eager path would deliver: numpy for an
    array or a CUDA tensor, a CPU tensor for a CPU tensor. A tensor whose
    dtype numpy lacks (bf16, fp8) travels as its bytes and arrives as a
    tensor of its dtype, as it does on the eager path."""
    if isinstance(data, np.ndarray):
        if data.dtype.hasobject or data.ndim == 0:
            return None
        return (np.ascontiguousarray(data).reshape(-1), data.dtype,
                int(data.nbytes), {"kind": "nd", "dtype": data.dtype.str,
                                   "shape": tuple(data.shape)}, False)
    if not isinstance(data, torch.Tensor) or data.dim() == 0:
        return None
    t = data.detach().contiguous().reshape(-1)
    shape, name = tuple(data.shape), str(t.dtype)[6:]
    try:
        np_dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
    except TypeError:
        np_dtype = None
    if np_dtype is None:
        t, np_dtype = t.view(torch.uint8), np.dtype(np.uint8)
        inner = {"kind": "pt", "dtype": name, "shape": shape}
    elif data.is_cuda:
        inner = {"kind": "nd", "dtype": np_dtype.str, "shape": shape}
    else:
        inner = {"kind": "pt", "dtype": name, "shape": shape}
    dev = accelerator.check_addr(data) == accelerator.LOCUS_DEVICE
    return t, np_dtype, t.numel() * t.element_size(), inner, dev


def maybe_send_pipelined(engine, data: Any, dest: int, tag: int,
                         synchronous: bool):
    """The pml's host-path protocol switch: returns a completed Request
    when the payload took the pipelined rendezvous, or None to fall
    through to the eager path. When it returns None, nothing here has
    touched the wire."""
    if not enabled():
        return None
    spec = _carried(data)
    if spec is None:
        return None
    src, np_dtype, total, inner, is_dev = spec
    if total < min_bytes():
        return None
    router = engine.router
    ep = router.endpoint
    seg_bytes = segment_bytes_for(total, ep)
    epseg = max(1, seg_bytes // max(np_dtype.itemsize, 1))
    nseg = -(-(total // np_dtype.itemsize) // epseg)
    if nseg < 2:
        return None                      # nothing to overlap
    stager = flat = None
    if is_dev or (isinstance(src, torch.Tensor) and src.is_cuda):
        # a device tensor is staged segment by segment, never copied
        # whole to the host
        from ompi_tpu_torch.btl.devxfer import SegmentStager
        stager = SegmentStager(src, epseg)
    elif isinstance(src, torch.Tensor):      # a host tensor: its bytes
        flat = src.numpy()
    else:
        flat = src
    codec = _comp_codec(np_dtype.name, total)
    inner = dict(inner)
    if codec:
        inner["comp"] = codec
    uid = next(_uids)
    me = engine.comm.rank()
    wdest = engine.comm.world_rank_of(dest)
    t = engine.traffic.setdefault((me, dest), [0, 0])
    t[0] += 1
    t[1] += total
    header = {"cid": engine.comm.cid, "src": me, "tag": tag,
              "desc": {"kind": "pipe", "pipe": uid, "psrc": router.rank,
                       "nseg": nseg, "nbytes": total, "inner": inner}}
    ev = aid = None
    if synchronous:
        aid, ev = router.new_ack()
        header["ack_id"] = aid
        header["wsrc"] = engine.comm.world_rank_of(me)
    from ompi_tpu_torch.pml.perrank import _send
    # the init frame rides the ordered stream: it is what matches, so two
    # sends to one peer never overtake each other, while their segment
    # trains interleave freely on the rails
    _send(router, wdest, header, b"")

    window = threading.Semaphore(depth())
    lock = threading.Lock()
    state = {"pending": nseg, "wire_s": 0.0}
    done_evt = threading.Event()

    def make_done(i: int):
        def on_done(dt: float) -> None:  # on a rail sender thread
            if stager is not None:
                stager.release(i)        # its staging buffer is free
            window.release()
            with lock:
                state["wire_s"] += dt
                state["pending"] -= 1
                if state["pending"] == 0:
                    done_evt.set()
        return on_done

    t_start = time.perf_counter()
    prep_s = 0.0
    for i in range(nseg):
        if not window.acquire(timeout=WAIT_TIMEOUT):
            raise MPIError(ERR_PENDING, "pipelined send window never "
                                        "drained")
        tok = (_trace.begin("pml.segment", idx=i, pipe=uid, dest=dest)
               if _trace.active or _prof._is_profiler_enabled else None)
        t0 = time.perf_counter()
        nraw = 0
        try:
            if stager is not None:
                seg = stager.get(i)      # staged D2H; the next copy is
            else:                        # already in flight
                seg = flat[i * epseg:(i + 1) * epseg]
            seg_header = {"pipeseg": 1, "pipe": uid, "psrc": router.rank,
                          "idx": i, "n": nseg}
            if codec:
                w = _cwire.encode(np.ascontiguousarray(seg))
                raw = pickle.dumps(w, protocol=pickle.HIGHEST_PROTOCOL)
            else:
                # zero-copy pack: the segment rides the source (or
                # staging) buffer straight to sendall; the byte offset
                # lets the receiver assemble in place
                raw = memoryview(seg).cast("B")
                seg_header["off"] = i * epseg * np_dtype.itemsize
                seg_header["tb"] = total
            nraw = len(raw) if codec else raw.nbytes
        finally:
            # all exits: a staging or encode error must not leak the span
            if tok is not None:
                _trace.end(tok, bytes=nraw)
        dt = time.perf_counter() - t0
        prep_s += dt
        if _tele.active:
            # telemetry: per-segment stage+encode service time — the
            # same interval the pml.segment span covers
            _tele.SEGMENT.record(dt * 1e6)
        ep.send_segment(wdest, seg_header, raw, make_done(i))
    if not done_evt.wait(WAIT_TIMEOUT):
        raise MPIError(ERR_PENDING, "pipelined send timed out draining "
                                    "its segment train")
    wall = time.perf_counter() - t_start
    with lock:
        serial = prep_s + state["wire_s"]
    with _stats_lock:
        stats["segments"] += nseg
        stats["inits"] += 1
        if stager is not None:
            stats["staged"] += stager.staged
        if serial > 1e-9:
            _gauges["overlap_ratio"] = round(
                max(0.0, min(1.0, (serial - wall) / serial)), 4)
    if ev is not None and not ev.wait(WAIT_TIMEOUT):
        router.cancel_ack(aid)
        raise MPIError(ERR_PENDING, "ssend timed out waiting for the "
                                    "receive")
    from ompi_tpu_torch.core.request import Request
    return Request.completed()


def reset_stats() -> None:
    """Tests and a new measurement window."""
    for k in stats:
        stats[k] = 0
    _gauges["overlap_ratio"] = 0.0


register_params()
_register_pvars()
