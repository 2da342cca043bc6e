"""Interposition-level MCA selection for per-rank communicators (the port
of ``ompi_tpu/coll/interpose_perrank.py``).

The stacked world runs full framework selection (priority-sorted
``comm_query`` per function, `coll/framework.py`); per-rank
communicators carry their collective algorithms as bound methods
(textbook p2p schedules + the shared-buffer device tier chosen per
buffer), so
the FRAMEWORK boundary that still applies to them is the reference's
interposition tier: coll/sync (barrier every Nth operation, the
flow-control debugging aid), coll/monitoring (per-(comm, func)
call/byte counters feeding the pvar/profile tools), the telemetry
plane's latency histograms and the tracer (one ``coll_<func>`` span
per application call).

This module applies those components to a RankCommunicator by wrapping
and REBINDING its collective methods at construction, honoring the
same MCA vars as the stacked components (``coll_sync_barrier_before``,
``coll_monitoring_enable``) — one config plane, two execution models.
The wrap order mirrors the stacked composer: sync innermost, then
monitoring (counts what the app called; sync's injected barrier is not
itself counted), then the histograms, then the tracer outermost. The base barrier is
captured unwrapped, so sync's injections cannot recurse. Nonblocking
collectives are sync-exempt —
their worker threads would race the op counter across ranks, exactly
why the stacked coll/sync skips i-slots — but ARE monitored, under
their own names (the rankcomm i-methods call the class-level blocking
implementations, bypassing these rebindings, so nothing
double-counts). The communicator's serial collective worker marks every
layer's depth as 1, so a body it runs records nothing either.
"""
from __future__ import annotations

import threading

from ompi_tpu_torch.mca import var

# Reentrancy depth per layer: rankcomm collectives COMPOSE (allreduce =
# reduce + bcast through the same bound methods), but the reference's
# interposition sits at the vtable — the winner's internal traffic
# never re-enters it. Only the outermost call is an application
# operation; inner frames pass through unobserved.
_tls = threading.local()

PERRANK_COLL_FUNCS = (
    "barrier", "bcast", "reduce", "allreduce", "gather", "scatter",
    "allgather", "alltoall", "scan", "exscan", "reduce_scatter_block",
    "neighbor_allgather", "neighbor_alltoall",
)
PERRANK_ICOLL_FUNCS = ("ibarrier", "ibcast", "iallreduce",
                       "iallgather", "ireduce")


def _wrap(comm, funcs, depth_attr: str, on_outermost) -> None:
    """Rebind each method with a reentrancy-guarded shim: the
    ``on_outermost(func, args, kw)`` hook fires only for the outermost
    frame of this layer."""
    def make(func, inner):
        def call(*args, **kw):
            depth = getattr(_tls, depth_attr, 0)
            if depth == 0:
                on_outermost(func, args, kw)
            setattr(_tls, depth_attr, depth + 1)
            try:
                return inner(*args, **kw)
            finally:
                setattr(_tls, depth_attr, depth)
        call.__name__ = func
        return call
    for f in funcs:
        setattr(comm, f, make(f, getattr(comm, f)))


def _wrap_span(comm, funcs) -> None:
    """Rebind each collective with a begin/end span shim (the tracing
    tier). Only the outermost frame of this layer records — rankcomm
    collectives COMPOSE (allreduce = reduce + bcast), and the span must
    describe the application operation, not its internal schedule. The
    live gate (``trace.core.active`` or a recording profiler) is re-read
    per call, so disarming the tracer mid-run drops the overhead back to
    two attribute reads."""
    from torch.autograd import profiler as _prof

    from ompi_tpu_torch.trace import core as _trace
    cid = comm.cid

    def make(func, inner):
        event = f"coll_{func}"

        def call(*args, **kw):
            if (not (_trace.active or _prof._is_profiler_enabled)
                    or getattr(_tls, "trace_depth", 0)):
                return inner(*args, **kw)
            tok = _trace.begin(event, cid=cid)
            _tls.trace_depth = 1
            try:
                return inner(*args, **kw)
            finally:
                _tls.trace_depth = 0
                _trace.end(tok)
        call.__name__ = func
        return call
    for f in funcs:
        setattr(comm, f, make(f, getattr(comm, f)))


def _wrap_hist(comm, funcs) -> None:
    """Rebind each collective with a latency-histogram shim (the
    telemetry tier). Same outermost-only reentrancy contract as the
    span shim; the live ``telemetry.active`` gate is re-read per call,
    so the disabled cost is one attribute read. Per-(comm, func)
    histogram tuples are resolved once at wrap time; the per-call work
    is a size-class index plus a shard increment."""
    from ompi_tpu_torch import telemetry as _tele
    cid = comm.cid

    def make(func, inner):
        hists = _tele.coll_hists(cid, func)

        def call(*args, **kw):
            if not _tele.active or getattr(_tls, "tele_depth", 0):
                return inner(*args, **kw)
            hist = hists[_tele.size_class(_payload_nbytes(args, kw))]
            tok = hist.start()
            _tls.tele_depth = 1
            try:
                return inner(*args, **kw)
            finally:
                _tls.tele_depth = 0
                hist.observe(tok)
        call.__name__ = func
        return call
    for f in funcs:
        setattr(comm, f, make(f, getattr(comm, f)))


def _payload_nbytes(args, kw) -> int:
    """Bytes of the call's first buffer-ish argument: arrays directly,
    chunk lists by summation, keyword buffers included."""
    for cand in list(args) + list(kw.values()):
        nb = getattr(cand, "nbytes", None)
        if nb is not None:
            return int(nb)
        if isinstance(cand, (list, tuple)) and cand:
            total = 0
            for e in cand:
                total += int(getattr(e, "nbytes", 0))
            if total:
                return total
    return 0


def interpose(comm) -> None:
    """Wrap ``comm``'s collective methods per the enabled interposer
    components. No-op (and no per-call overhead) when neither is on."""
    # component register_params runs at framework OPEN (mca_base
    # convention) — per-rank worlds don't run the stacked selection
    # that normally opens the framework, so open it here for the MCA
    # vars (and their env overrides) to exist
    from ompi_tpu_torch.coll.framework import _ensure_components, \
        coll_framework
    _ensure_components()
    coll_framework.open()
    every = int(var.var_get("coll_sync_barrier_before", 0) or 0)
    if every < 0:
        every = 0                        # stacked semantics: <=0 is off
    mon = bool(var.var_get("coll_monitoring_enable", False))
    from ompi_tpu_torch import trace as _trace_pkg
    traced = _trace_pkg.tracing_enabled()
    from ompi_tpu_torch import telemetry as _tele_pkg
    tele = _tele_pkg.telemetry_enabled()
    comm._coll_interposers = []
    if not every and not mon and not traced and not tele:
        return

    base_barrier = comm.barrier          # unwrapped: sync's injections
    #                                      must not recurse or be
    #                                      counted as app traffic
    if every:
        state = {"count": 0}

        def sync_hook(func, args, kw):
            state["count"] += 1
            if state["count"] % every == 0 and func != "barrier":
                base_barrier()
        _wrap(comm, PERRANK_COLL_FUNCS, "sync_depth", sync_hook)
        comm._coll_interposers.append("sync")

    if mon:
        from ompi_tpu_torch.coll.monitoring import record

        def mon_hook(func, args, kw):
            record(comm.cid, func, _payload_nbytes(args, kw))
        _wrap(comm, PERRANK_COLL_FUNCS, "mon_depth", mon_hook)
        # i-collectives: monitored under their own names (the stacked
        # table has separate i-slots); their worker threads run the
        # CLASS implementations, so nothing here re-fires
        _wrap(comm, PERRANK_ICOLL_FUNCS, "mon_depth", mon_hook)
        comm._coll_interposers.append("monitoring")

    if tele:
        # between monitoring and trace, mirroring the stacked composer:
        # histograms time the app-visible call without the tracer's
        # ring-append cost riding inside the measurement
        _wrap_hist(comm, PERRANK_COLL_FUNCS + PERRANK_ICOLL_FUNCS)
        comm._coll_interposers.append("telemetry")

    if traced:
        # outermost, mirroring the stacked composer: spans measure the
        # app-visible call, monitoring/sync overhead rides inside
        _wrap_span(comm, PERRANK_COLL_FUNCS + PERRANK_ICOLL_FUNCS)
        comm._coll_interposers.append("trace")
