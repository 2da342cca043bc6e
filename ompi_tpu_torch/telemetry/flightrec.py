"""telemetry/flightrec — the fault flight recorder (the port of
``ompi_tpu/telemetry/flightrec.py``).

When something goes wrong in a fleet, the evidence is gone by the time
a human attaches: rings wrap, processes exit, the straggler recovers.
The flight recorder snapshots the process's observability state AT the
moment of the trigger — atomically, to ``flightrec_<rank>.json`` —
so the post-mortem starts from data, not reproduction attempts.

Triggers (each wired at its source, all funneling into ``record``):

- ``proc_failed``  — the ft registry reported a dead rank (listener
  installed by ``arm``; covers both the heartbeat detector and the
  btl EOF monitor ingress);
- ``revoke``       — a communicator revocation reached this rank
  (pml/perrank Router);
- ``lockwitness_cycle`` — the lock-order witness found a potential
  deadlock cycle (the reference's analyze/lockwitness; the port has no
  lock witness yet, so no caller fires it);
- ``straggler``    — this rank's health monitor declared a peer
  (telemetry/health).

Snapshot content: the trace SpanRing tail, every pvar (histograms
included — they read as merged snapshots), the ft registry's
epoch-ordered failure events, the health monitor's scores and the
open one-sided epochs (``osc_epochs``), and the coll decision table
(``decision``, from ``api/tool``). Writes are
tmp + ``os.replace`` so a merge (``merge`` here, or the reference's
``tools/tracedump --format flightrec``) never sees a torn file — a rank
killed mid-write leaves the previous complete snapshot or nothing.

Rate limiting: one snapshot per (trigger, subject-rank) per process,
16 total — a revocation storm must not turn the recorder into the
incident.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ompi_tpu_torch.mca import var as _var

SPAN_TAIL = 500          # spans kept per snapshot (merge trims to 100)
MAX_RECORDS = 16

_lock = threading.Lock()
_fired: set = set()
_count = 0
_armed_rank: Optional[int] = None
_listener = None


def _out_dir() -> str:
    from ompi_tpu_torch import telemetry as _t
    _t.register_params()
    d = str(_var.var_get("mpi_base_telemetry_flightrec_dir", "") or "")
    return d or "."


def _safe(fn, default=None):
    try:
        return fn()
    except Exception:                    # noqa: BLE001 — the recorder
        return default                   # must never add a failure


def _pvar_values() -> Dict[str, Any]:
    """Every pvar, read defensively: one raising read must not cost
    the snapshot the rest of the surface."""
    from ompi_tpu_torch.mca import pvar as _pvar
    out: Dict[str, Any] = {}
    for name in _safe(_pvar.pvar_names, []) or []:
        val = _safe(lambda n=name: _pvar.pvar_read(n), "<unreadable>")
        out[name] = val
    return out


def snapshot(trigger: str, detail: Optional[Dict[str, Any]] = None,
             rank: Optional[int] = None) -> Dict[str, Any]:
    """Assemble (but do not write) one flight-recorder payload."""
    from ompi_tpu_torch import trace as _trace
    from ompi_tpu_torch.runtime import ft as _ft
    from ompi_tpu_torch.telemetry import health as _health
    if rank is None:
        rank = _armed_rank if _armed_rank is not None \
            else _trace.process_rank()
    spans = _safe(_trace.span_dicts, []) or []
    payload: Dict[str, Any] = {
        "flightrec": 1,
        "rank": int(rank),
        "trigger": trigger,
        "detail": detail or {},
        "wall_time": time.time(),
        "trace_stats": _safe(_trace.stats, {}),
        "spans": spans[-SPAN_TAIL:],
        "pvars": _pvar_values(),
        "ft_events": [dict(e._asdict()) for e in
                      (_safe(_ft.default_registry().events, []) or [])],
        "health": _safe(_health.scores_snapshot, {}) or {},
    }
    # open one-sided epochs (osc/base's live-window registry): which
    # windows were mid-epoch when the incident fired
    def _osc_epochs():
        from ompi_tpu_torch.osc import base as _osc_base
        return _osc_base.open_epoch_state()
    payload["osc_epochs"] = _safe(_osc_epochs, []) or []
    # the coll decision-table state (api/tool) — which algorithm each
    # size class would take right now; advisory, skipped on any error
    try:
        from ompi_tpu_torch.api import tool as _tool
        payload["decision"] = _tool.decision_table()
    except Exception:                    # noqa: BLE001
        pass
    return payload


def record(trigger: str, detail: Optional[Dict[str, Any]] = None,
           path: Optional[str] = None) -> Optional[str]:
    """Snapshot-and-write, rate-limited. Returns the written path, or
    None when telemetry is off / the limiter refused. Atomic: tmp +
    os.replace, so readers never see a torn file."""
    from ompi_tpu_torch import telemetry as _t
    global _count
    if not _t.active:
        return None
    subject = (detail or {}).get("rank", -1)
    key = (trigger, subject)
    with _lock:
        if key in _fired or _count >= MAX_RECORDS:
            return None
        _fired.add(key)
        _count += 1
        seq = _count
    payload = snapshot(trigger, detail)
    if path is None:
        # later triggers get suffixed siblings — a revoke must not
        # overwrite the proc_failed accusation (the merge unions them)
        fname = f"flightrec_{payload['rank']}.json" if seq == 1 \
            else f"flightrec_{payload['rank']}_{seq}.json"
        path = os.path.join(_out_dir(), fname)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    except OSError:
        _safe(lambda: os.unlink(tmp))
        return None
    return path


# -- arming ------------------------------------------------------------------
def arm(rank: int) -> None:
    """Wire the proc-failed trigger: a listener on the default ft
    registry (the PMIx event-handler role). The revoke / lockwitness /
    straggler triggers call ``record`` from their own planes."""
    global _armed_rank, _listener
    disarm()
    _armed_rank = int(rank)

    def _on_proc_failed(dead: int, reason: str) -> None:
        record("proc_failed", {"rank": dead, "reason": reason})

    from ompi_tpu_torch.runtime import ft as _ft
    _ft.default_registry().add_listener(_on_proc_failed)
    _listener = _on_proc_failed


def disarm() -> None:
    global _armed_rank, _listener
    cb = _listener
    _listener = None
    _armed_rank = None
    if cb is not None:
        from ompi_tpu_torch.runtime import ft as _ft
        _safe(lambda: _ft.default_registry().remove_listener(cb))


def _reset_for_tests() -> None:
    global _count
    disarm()
    with _lock:
        _fired.clear()
        _count = 0


# -- merge (the reference's tools/tracedump flightrec backend) ----------------
def merge(payloads: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Union per-rank flight-recorder snapshots into ONE incident
    report: what fired where, the accused set, the critical rank, and
    its last 100 spans. Critical-rank election: the rank most accused
    by proc_failed / straggler triggers; ties and trigger-free merges
    fall back to the rank with the worst own-latency p99."""
    triggers: List[Dict[str, Any]] = []
    accusations: Dict[int, int] = {}
    by_rank: Dict[int, Dict[str, Any]] = {}
    for p in payloads:
        rank = int(p.get("rank", -1))
        by_rank[rank] = p
        trig = {"rank": rank, "trigger": p.get("trigger", "?"),
                "detail": p.get("detail", {}),
                "wall_time": p.get("wall_time", 0.0)}
        triggers.append(trig)
        subject = trig["detail"].get("rank")
        if subject is not None and p.get("trigger") in (
                "proc_failed", "straggler"):
            accusations[int(subject)] = \
                accusations.get(int(subject), 0) + 1
    triggers.sort(key=lambda t: t.get("wall_time", 0.0))

    critical: Optional[int] = None
    if accusations:
        critical = max(sorted(accusations),
                       key=lambda r: accusations[r])
    else:
        worst = -1.0
        for rank, p in by_rank.items():
            for h in (p.get("pvars") or {}).values():
                if isinstance(h, dict) and "p99" in h:
                    p99 = float(h.get("p99", 0.0) or 0.0)
                    if p99 > worst:
                        worst, critical = p99, rank

    report: Dict[str, Any] = {
        "incident": 1,
        "ranks": sorted(by_rank),
        "triggers": triggers,
        "accusations": {str(r): n
                        for r, n in sorted(accusations.items())},
        "critical_rank": critical,
    }
    crit = by_rank.get(critical) if critical is not None else None
    if crit is not None:
        report["critical_spans"] = (crit.get("spans") or [])[-100:]
        report["critical_health"] = crit.get("health", {})
    elif critical is not None:
        # the critical rank died without writing a snapshot (killed
        # mid-collective): its accusers' spans are the best evidence
        spans = [s for p in payloads for s in (p.get("spans") or [])
                 if int(s.get("rank", -2)) == critical]
        report["critical_spans"] = spans[-100:]
        report["critical_absent"] = True
    return report
