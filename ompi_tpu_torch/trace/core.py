"""The tracer — per-rank span recording (the port of
``ompi_tpu/trace/core.py``).

Design contract:

- **Armed three ways, free when off.** The tracer records while the
  MCA var ``mpi_base_trace_enable`` is on (env
  ``OMPI_TPU_TORCH_MCA_mpi_base_trace_enable=1``), after
  ``trace.enable()``, or while a ``torch.profiler`` session records
  (torch's module attribute
  ``torch.autograd.profiler._is_profiler_enabled``, set for the length
  of a session, the gate of DDP's and c10d's ``record_function``
  ranges). Every instrumentation point guards on ``_trace.active or
  _prof._is_profiler_enabled``: two module-attribute reads, and no
  call, no span allocation and no range when both are off.
- **Mirrored as profiler ranges while one records.** ``begin`` also
  opens a profiler range of the span's name (``_Range``) and ``end``
  closes it, so the spans sit in the profiler's timeline on its clock,
  each kernel launch correlated with its innermost span, and
  ``export_chrome_trace`` shows both. Instants open no range.
- **Bounded when on.** Spans land in a fixed-capacity
  :class:`~ompi_tpu_torch.trace.ring.SpanRing`
  (``mpi_base_trace_buffer_spans``), made with the first span where
  ``enable()`` has not made it; overflow drops-and-counts, never
  blocks.
- **One event namespace.** Span names reuse the ``utils/hooks`` event
  names (``coll_allreduce``, ``pml_send``, ...), so the PERUSE/MPI_T
  event stream and the trace describe the same operations.
- **One timebase.** Ring timestamps are ``time.perf_counter()`` —
  exactly ``CLOCK_MONOTONIC``, which every process of one host shares,
  so per-rank dumps from one host align with zero offsets, and dumps
  from different hosts by subtracting a measured offset. The mirrored
  ranges carry the profiler's own stamps.

Counters ride the MPI_T pvar plumbing: ``trace_spans`` (accepted),
``trace_dropped`` (ring-full refusals); the attribution layer adds
per-communicator skew watermarks.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _prof

from ompi_tpu_torch.mca import pvar as _pvar
from ompi_tpu_torch.mca import var as _var
from ompi_tpu_torch.trace.ring import Span, SpanRing

DEFAULT_CAPACITY = 65536

# THE hot-path gate, with torch's ``_prof._is_profiler_enabled``:
# instrumentation points read the two module attributes and do nothing
# else when both are off. Rebound (never mutated in place) by
# enable()/disable(), so readers need no lock.
active: bool = False

# The profiler range a span opens while a profiler records: one C++
# RecordFunction behind a Python object, without the op dispatch that
# ``torch.profiler.record_function`` makes on enter and on exit.
_Range = torch._C._profiler._RecordFunctionFast

_ring: Optional[SpanRing] = None
_ring_lock = threading.Lock()
_process_rank: int = -1          # per-rank worlds stamp their rank here
# per-(cid, name) occurrence counters: rank-symmetric sequencing so the
# attribution layer can match the Nth allreduce on a communicator
# across every participant's dump (next() on itertools.count is atomic
# under the GIL)
_seqs: Dict[Tuple[str, str], "itertools.count"] = {}
_seq_lock = threading.Lock()


def _register_vars() -> None:
    _var.var_register(
        "mpi", "base", "trace_enable", vtype="bool", default=False,
        help="Record begin/end spans at collective, pt2pt, btl-flush "
             "and progress-wakeup boundaries into the per-rank span "
             "ring")
    _var.var_register(
        "mpi", "base", "trace_buffer_spans", vtype="int",
        default=DEFAULT_CAPACITY,
        help="Span ring capacity; overflow drops-and-counts "
             "(trace_dropped pvar), never blocks the hot path")


def tracing_enabled() -> bool:
    """The MCA-var truth — consulted at comm construction / selection
    time (the composer wraps vtables only when this is on). Hot paths
    read ``active`` instead."""
    _register_vars()
    return bool(_var.var_get("mpi_base_trace_enable", False))


def enable(capacity: Optional[int] = None) -> None:
    """Turn tracing on (idempotent): sets the MCA var and arms the
    ring. Call BEFORE ``MPI.Init`` for collective-entry spans — the
    coll composer wraps vtables at communicator construction."""
    global active
    _register_vars()
    try:
        _var.var_set("mpi_base_trace_enable", True)
    except KeyError:                     # var store reset mid-session
        pass
    _arm_ring(capacity)
    active = True


def _arm_ring(capacity: Optional[int] = None) -> SpanRing:
    """The ring, made anew at ``capacity`` (or the var's) when there is
    none or a capacity is given."""
    global _ring
    with _ring_lock:
        if _ring is None or capacity is not None:
            _register_vars()
            cap = capacity if capacity is not None else int(
                _var.var_get("mpi_base_trace_buffer_spans",
                             DEFAULT_CAPACITY))
            _ring = SpanRing(cap)
        return _ring


def disable() -> None:
    """Stop recording; the ring stays readable (dump/export after)."""
    global active
    active = False
    _register_vars()
    try:
        _var.var_set("mpi_base_trace_enable", False)
    except KeyError:
        pass


def maybe_enable_from_var() -> None:
    """Arm the tracer when the MCA var (env/file-sourced) says so —
    called from runtime init so ``OMPI_TPU_TORCH_MCA_mpi_base_trace_enable=1``
    works without code changes."""
    if tracing_enabled() and not active:
        enable()


def set_process_rank(rank: int) -> None:
    """Per-rank worlds stamp their world rank so every span carries it
    (single-controller spans keep rank -1: one process drives all
    ranks and the exporter maps them to pid 0)."""
    global _process_rank
    _process_rank = int(rank)


def process_rank() -> int:
    return _process_rank


def _next_seq(cid: str, name: str) -> int:
    key = (cid, name)
    c = _seqs.get(key)
    if c is None:
        with _seq_lock:
            c = _seqs.setdefault(key, itertools.count(0))
    return next(c)


# -- recording --------------------------------------------------------------
def begin(name: str, cid: Any = None, rank: Optional[int] = None,
          **args) -> tuple:
    """Open a span, and its profiler range while a profiler records;
    returns the token ``end`` consumes. Callers guard with ``if
    _trace.active or _prof._is_profiler_enabled:`` — this function
    assumes the tracer is armed."""
    rng = None
    if _prof._is_profiler_enabled:
        rng = _Range(name)
        rng.__enter__()
    scid = None if cid is None else str(cid)
    seq = None if scid is None else _next_seq(scid, name)
    return (name, time.perf_counter(),
            _process_rank if rank is None else rank,
            scid, seq, args or None, rng)


def end(token: tuple, **extra) -> None:
    if token is None:
        return
    name, t0, rank, cid, seq, args, rng = token
    dur = time.perf_counter() - t0
    if rng is not None:
        rng.__exit__(None, None, None)
    if extra:
        args = dict(args) if args else {}
        args.update(extra)
    ring = _ring if _ring is not None else _arm_ring()
    ring.push(Span(name, t0, dur, threading.get_ident(), rank, cid,
                   seq, "span", args))


def instant(name: str, cid: Any = None, rank: Optional[int] = None,
            **args) -> None:
    """A zero-duration event (wakeup flushes, ctl flushes, sm drains);
    it opens no profiler range."""
    ring = _ring if _ring is not None else _arm_ring()
    ring.push(Span(name, time.perf_counter(), 0.0,
                   threading.get_ident(),
                   _process_rank if rank is None else rank,
                   None if cid is None else str(cid), None,
                   "instant", args or None))


class span:
    """Context-manager form, for call sites where a call and an
    allocation per use, armed or not, cost nothing that matters."""

    __slots__ = ("_name", "_cid", "_args", "_tok")

    def __init__(self, name: str, cid: Any = None, **args):
        self._name = name
        self._cid = cid
        self._args = args
        self._tok = None

    def __enter__(self):
        if active or _prof._is_profiler_enabled:
            self._tok = begin(self._name, cid=self._cid, **self._args)
        return self

    def __exit__(self, *exc):
        if self._tok is not None:
            end(self._tok)
        return False


# -- reading ----------------------------------------------------------------
def spans() -> List[Span]:
    ring = _ring
    return ring.snapshot() if ring is not None else []


def span_dicts() -> List[Dict[str, Any]]:
    return [s.to_dict() for s in spans()]


def stats() -> Dict[str, int]:
    ring = _ring
    if ring is None:
        return {"spans": 0, "dropped": 0, "capacity": 0, "stored": 0}
    return {"spans": ring.pushed, "dropped": ring.dropped,
            "capacity": ring.capacity, "stored": len(ring)}


def reset() -> None:
    """Clear the ring and the per-comm sequence counters (tests; a new
    measurement window)."""
    ring = _ring
    if ring is not None:
        ring.clear()
    with _seq_lock:
        _seqs.clear()


def dump(path: str, offset_s: float = 0.0) -> str:
    """Persist this process's spans for a merger to read:
    ``{"rank", "offset_s", "stats", "spans"}``. ``offset_s`` is this
    controller's clock offset against the reference controller (0 on
    one host); the merger subtracts it so all
    dumps share rank 0's timebase."""
    payload = {"rank": _process_rank, "offset_s": float(offset_s),
               "stats": stats(), "spans": span_dicts()}
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def load_dump(path: str) -> Dict[str, Any]:
    with open(path) as f:
        d = json.load(f)
    if not isinstance(d, dict) or "spans" not in d:
        raise ValueError(f"not a trace dump: {path}")
    return d


# -- coll vtable interposition (stacked world) ------------------------------
class _TracedSlot:
    """Wraps ONE selected coll slot: the slot's own function records a
    ``coll_<func>`` span; every other attribute (``allreduce_dtype``,
    ``_ibarrier_arrays``, ...) delegates to the real winner so fused
    fast paths keep working under tracing. The shims exist only on a
    communicator built while the MCA var was on (an operator's
    ``--mca mpi_base_trace_enable 1`` before ``Init``); a profiler
    session alone sees the span inside the collectives instead
    (``coll.body``)."""

    def __init__(self, cid: Any, func: str, inner: Any):
        self._inner = inner
        target = getattr(inner, func)
        event = f"coll_{func}"

        def call(*a, **kw):
            if not (active or _prof._is_profiler_enabled):   # disarmed
                return target(*a, **kw)
            tok = begin(event, cid=cid)
            try:
                return target(*a, **kw)
            finally:
                end(tok)
        call.__name__ = func
        setattr(self, func, call)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def wrap_coll_vtable(comm, vtable: Dict[str, Any]) -> Dict[str, Any]:
    """Called by the selection composer (coll/framework) when the MCA
    var is on at the communicator's construction: each selected slot
    is served through a span-recording shim that delegates to that
    slot's winner (monitoring's wrap runs beneath, so spans measure the
    app-visible call)."""
    cid = getattr(comm, "cid", None)
    return {f: _TracedSlot(cid, f, m) for f, m in vtable.items()}


# -- pvars ------------------------------------------------------------------
def _register_pvars() -> None:
    _pvar.pvar_register(
        "trace_spans", lambda: stats()["spans"],
        help="Spans accepted into the trace ring "
             "(mpi_base_trace_enable)")
    _pvar.pvar_register(
        "trace_dropped", lambda: stats()["dropped"],
        help="Spans dropped because the trace ring was full "
             "(raise mpi_base_trace_buffer_spans)")


_register_pvars()
