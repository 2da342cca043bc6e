"""Chrome-trace / Perfetto JSON export with mpisync timebase alignment.

Produces the ``traceEvents`` JSON array format (the Trace Event Format
both ``chrome://tracing`` and https://ui.perfetto.dev load): one *pid*
per MPI rank, one *tid* per OS thread, complete-duration events
(``ph: "X"``) for spans and thread-scoped instants (``ph: "i"``) for
wakeup/ctl-flush markers, plus ``ph: "M"`` metadata naming each rank's
process track.

Cross-controller alignment: each rank's dump may carry a clock offset
measured against rank 0 by ``tools/mpisync.measure_offset`` (offset =
remote_now - local_now at the best-RTT sample). A remote timestamp
``t`` maps onto rank 0's timebase as ``t - offset``; the exporter
applies the per-rank offset before emitting, so every pid shares one
timebase and cross-rank skew in the UI is real skew, not clock error.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Optional, Union

from ompi_tpu_torch.trace.ring import Span

SpanLike = Union[Span, Dict[str, Any]]


def _field(s: SpanLike, key: str, default=None):
    if isinstance(s, dict):
        return s.get(key, default)
    return getattr(s, key, default)


def _pid(s: SpanLike) -> int:
    r = _field(s, "rank", -1)
    # single-controller spans (rank -1): the controller process is the
    # only timeline owner — map to pid 0
    return int(r) if r is not None and int(r) >= 0 else 0


def offsets_from_sync_rows(rows: Iterable[Mapping[str, Any]]
                           ) -> Dict[int, float]:
    """Convert a ``tools/mpisync.sync_report*`` table into the
    ``rank_offsets`` mapping the exporter takes. Unprobed rows
    (offset None) align with offset 0 — unknown beats fabricated."""
    out: Dict[int, float] = {}
    for row in rows:
        off = row.get("offset_s")
        out[int(row["rank"])] = float(off) if off is not None else 0.0
    return out


def to_events(spans: Iterable[SpanLike],
              rank_offsets: Optional[Mapping[int, float]] = None,
              ) -> List[Dict[str, Any]]:
    """Flatten spans into sorted Chrome trace events (metadata first,
    then timeline events in aligned-timestamp order)."""
    rank_offsets = rank_offsets or {}
    events: List[Dict[str, Any]] = []
    pids = {}                            # pid -> representative rank
    tids = set()
    for s in spans:
        pid = _pid(s)
        off = float(rank_offsets.get(pid, 0.0))
        ts_us = (float(_field(s, "ts", 0.0)) - off) * 1e6
        tid = int(_field(s, "tid", 0) or 0)
        args: Dict[str, Any] = {}
        for k in ("cid", "seq"):
            v = _field(s, k)
            if v is not None:
                args[k] = v
        extra = _field(s, "args")
        if extra:
            args.update(extra)
        ev: Dict[str, Any] = {
            "name": _field(s, "name", "?"),
            "cat": "ompi_tpu",
            "pid": pid, "tid": tid,
            "ts": ts_us,
        }
        if args:
            ev["args"] = args
        if _field(s, "kind", "span") == "instant":
            ev["ph"] = "i"
            ev["s"] = "t"                # thread-scoped instant
        else:
            ev["ph"] = "X"
            ev["dur"] = max(float(_field(s, "dur", 0.0)), 0.0) * 1e6
        events.append(ev)
        pids[pid] = _field(s, "rank", -1)
        tids.add((pid, tid))
    events.sort(key=lambda e: e["ts"])

    meta: List[Dict[str, Any]] = []
    for pid in sorted(pids):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "ts": 0,
                     "args": {"name": f"rank {pid}"}})
    for pid, tid in sorted(tids):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "ts": 0,
                     "args": {"name": f"thread {tid}"}})
    return meta + events


def export(spans: Iterable[SpanLike],
           rank_offsets: Optional[Mapping[int, float]] = None,
           ) -> Dict[str, Any]:
    """The Perfetto-loadable JSON object (dump with ``json.dump``)."""
    return {"traceEvents": to_events(spans, rank_offsets),
            "displayTimeUnit": "ms"}


def export_file(path: str, spans: Iterable[SpanLike],
                rank_offsets: Optional[Mapping[int, float]] = None,
                ) -> str:
    import json
    with open(path, "w") as f:
        json.dump(export(spans, rank_offsets), f)
    return path
