"""Late-arrival attribution — who was late, by how much, and what it
cost.

Collective-algorithm tuning lives or dies on measured per-rank arrival
skew (EQuARX, HiCCL), not aggregate counters. Given aligned spans from
every participant, each traced collective occurrence — the
(communicator, event, sequence) triple, rank-symmetric because the
tracer sequences per (cid, name) — is attributed:

- **arrival** per rank: the span's begin timestamp (aligned timebase);
- **critical rank**: the last arriver — everyone else's wait is its
  fault;
- **skew**: last arrival minus first arrival;
- per rank, **blocked** (time spent waiting for the critical rank:
  ``t_last - arrival``) vs **in-op** (``end - t_last``, the part the
  algorithm actually used, clamped at 0 for ranks that finished before
  the last arriver even entered — pure overlap).

The per-communicator skew *watermark* (max skew ever attributed) is
surfaced as pvars: the aggregate ``trace_skew_watermarks`` dict plus a
lazily-registered ``trace_skew_c<cid>`` per communicator.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Mapping, Optional, Union

from ompi_tpu_torch.mca import pvar as _pvar
from ompi_tpu_torch.trace.ring import Span

SpanLike = Union[Span, Dict[str, Any]]

_lock = threading.Lock()
_watermarks: Dict[str, float] = {}       # cid -> max skew seconds
_registered_cids: set = set()


def _field(s: SpanLike, key: str, default=None):
    if isinstance(s, dict):
        return s.get(key, default)
    return getattr(s, key, default)


def _note_skew(cid: str, skew_s: float) -> None:
    with _lock:
        prev = _watermarks.get(cid, 0.0)
        if skew_s > prev:
            _watermarks[cid] = skew_s
        fresh = cid not in _registered_cids
        if fresh:
            _registered_cids.add(cid)
    if fresh:
        _pvar.pvar_register(
            f"trace_skew_c{cid}",
            lambda c=cid: _watermarks.get(c, 0.0),
            unit="seconds", var_class="highwatermark", comm=cid,
            help=f"Max collective arrival skew attributed on comm "
                 f"{cid}")


def skew_watermarks() -> Dict[str, float]:
    with _lock:
        return dict(_watermarks)


def retire_comm(cid: Any) -> List[str]:
    """Drop comm ``cid``'s skew watermark and its per-comm pvar —
    called when the communicator is freed
    or shrunk away, so a later read can't report dead-rank-era skew
    under a recycled cid."""
    scid = str(cid)
    with _lock:
        _watermarks.pop(scid, None)
        registered = scid in _registered_cids
        _registered_cids.discard(scid)
    name = f"trace_skew_c{scid}"
    if registered and _pvar.pvar_unregister(name):
        return [name]
    return []


def reset_watermarks() -> None:
    with _lock:
        _watermarks.clear()


def late_arrival(spans: Iterable[SpanLike],
                 rank_offsets: Optional[Mapping[int, float]] = None,
                 min_ranks: int = 2,
                 names: Optional[Iterable[str]] = None,
                 ) -> List[Dict[str, Any]]:
    """Attribute every traced collective occurrence observed by at
    least ``min_ranks`` distinct ranks. ``rank_offsets`` aligns raw
    per-rank timestamps onto one timebase (mpisync offsets against
    rank 0); pre-aligned spans pass None. Returns one report per
    occurrence, worst skew first, and updates the per-comm skew
    watermarks (pvar-surfaced). ``names`` restricts which span names
    count as occurrences; the default is the collective entry events
    (``coll_*`` — the hooks namespace), since only those are sequenced
    rank-symmetrically."""
    rank_offsets = rank_offsets or {}
    name_set = None if names is None else set(names)
    groups: Dict[tuple, Dict[int, tuple]] = {}
    for s in spans:
        if _field(s, "kind", "span") != "span":
            continue
        name = str(_field(s, "name", "?"))
        if (name not in name_set) if name_set is not None \
                else (not name.startswith("coll_")):
            continue
        cid, seq = _field(s, "cid"), _field(s, "seq")
        rank = _field(s, "rank", -1)
        if cid is None or seq is None or rank is None or int(rank) < 0:
            continue                     # unsequenced / single-process
        rank = int(rank)
        off = float(rank_offsets.get(rank, 0.0))
        t0 = float(_field(s, "ts", 0.0)) - off
        t1 = t0 + max(float(_field(s, "dur", 0.0)), 0.0)
        key = (str(cid), _field(s, "name", "?"), int(seq))
        # duplicate (rank re-traced same seq): keep the first arrival
        groups.setdefault(key, {}).setdefault(rank, (t0, t1))

    reports: List[Dict[str, Any]] = []
    for (cid, name, seq), arrivals in groups.items():
        if len(arrivals) < min_ranks:
            continue
        t_first = min(t0 for t0, _ in arrivals.values())
        t_last = max(t0 for t0, _ in arrivals.values())
        critical = max(arrivals, key=lambda r: arrivals[r][0])
        skew = t_last - t_first
        ranks = []
        for r in sorted(arrivals):
            t0, t1 = arrivals[r]
            ranks.append({
                "rank": r,
                "arrival_s": round(t0 - t_first, 9),
                "blocked_s": round(t_last - t0, 9),
                "in_op_s": round(max(t1 - t_last, 0.0), 9),
            })
        reports.append({
            "name": name, "cid": cid, "seq": seq,
            "skew_s": round(skew, 9),
            "critical_rank": critical,
            "nranks": len(arrivals),
            "ranks": ranks,
        })
        _note_skew(cid, skew)
    reports.sort(key=lambda r: -r["skew_s"])
    return reports


def compress_by_rank(spans: Iterable[SpanLike]) -> Dict[str, Any]:
    """Aggregate ``compress.quant`` / ``compress.dequant`` span time
    per rank (keys are strings for JSON round-tripping; rank -1 is the
    single-controller world). Empty dict when no compression spans are
    present — the summary omits the section entirely."""
    agg: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        name = str(_field(s, "name", "?"))
        if name not in ("compress.quant", "compress.dequant"):
            continue
        rank = str(int(_field(s, "rank", -1)))
        e = agg.setdefault(rank, {"quant_us": 0.0, "quant_n": 0,
                                  "dequant_us": 0.0, "dequant_n": 0})
        us = max(float(_field(s, "dur", 0.0)), 0.0) * 1e6
        if name == "compress.quant":
            e["quant_us"] += us
            e["quant_n"] += 1
        else:
            e["dequant_us"] += us
            e["dequant_n"] += 1
    for e in agg.values():
        e["quant_us"] = round(e["quant_us"], 2)
        e["dequant_us"] = round(e["dequant_us"], 2)
    return agg


def bucket_flushes_by_reason(spans: Iterable[SpanLike]
                             ) -> Dict[str, Any]:
    """Aggregate ``coll.bucket_flush`` spans by flush reason (bytes /
    startall / idle / explicit — coll/persistent's BucketFuser):
    count, fused member collectives, fused bytes, and span time per
    reason. Empty dict when no bucket fusion ran — the summary omits
    the section entirely."""
    agg: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        if str(_field(s, "name", "?")) != "coll.bucket_flush":
            continue
        args = _field(s, "args", None) or {}
        reason = str(args.get("reason", "?"))
        e = agg.setdefault(reason, {"flushes": 0, "members": 0,
                                    "bytes": 0, "total_us": 0.0})
        e["flushes"] += 1
        e["members"] += int(args.get("members", 0) or 0)
        e["bytes"] += int(args.get("nbytes", 0) or 0)
        e["total_us"] += max(float(_field(s, "dur", 0.0)), 0.0) * 1e6
    for e in agg.values():
        e["total_us"] = round(e["total_us"], 2)
    return agg


def shm_seg_by_rank(spans: Iterable[SpanLike]) -> Dict[str, Any]:
    """Aggregate the zero-copy segment plane's ``btl.shm_seg`` spans
    (the single sender-side pack copy, btl/shmseg) per rank: packs,
    packed bytes, and pack time. Empty dict when the zero-copy plane
    never ran — the summary omits the section entirely."""
    agg: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        if str(_field(s, "name", "?")) != "btl.shm_seg":
            continue
        args = _field(s, "args", None) or {}
        rank = str(int(_field(s, "rank", -1)))
        e = agg.setdefault(rank, {"packs": 0, "bytes": 0,
                                  "pack_us": 0.0})
        e["packs"] += 1
        e["bytes"] += int(args.get("bytes", 0) or 0)
        e["pack_us"] += max(float(_field(s, "dur", 0.0)), 0.0) * 1e6
    for e in agg.values():
        e["pack_us"] = round(e["pack_us"], 2)
    return agg


def ft_by_rank(spans: Iterable[SpanLike]) -> Dict[str, Any]:
    """Aggregate the resilience plane's ``ft.*`` spans per OBSERVING
    rank (the rank whose detector suspected/declared — each span also
    names the suspect in its args): suspicion episodes and their open
    time, declarations, and how many suspicions cleared (the hysteresis
    saves — a suspect that came back). Empty dict
    when no FT activity was traced — the summary omits the section
    entirely."""
    agg: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        name = str(_field(s, "name", "?"))
        if not name.startswith("ft."):
            continue
        args = _field(s, "args", None) or {}
        rank = str(int(args.get("by", _field(s, "rank", -1))))
        e = agg.setdefault(rank, {"suspects": 0, "suspect_us": 0.0,
                                  "cleared": 0, "declared": 0})
        if name == "ft.suspect":
            e["suspects"] += 1
            e["suspect_us"] += max(float(_field(s, "dur", 0.0)),
                                   0.0) * 1e6
            if not args.get("declared", False):
                e["cleared"] += 1
        elif name == "ft.declare":
            e["declared"] += 1
    for e in agg.values():
        e["suspect_us"] = round(e["suspect_us"], 2)
    return agg


def osc_by_rank(spans: Iterable[SpanLike]) -> Dict[str, Any]:
    """Aggregate the one-sided plane's ``osc.*`` spans per ORIGIN rank
    (RMA is origin-driven; the target never traces):
    put/get/accumulate counts, the bytes they moved, their origin-side
    time, and the epoch-boundary crossings (``osc.epoch`` spans:
    fence/lock/unlock/PSCW/free). Empty dict when the RMA plane never
    ran — the summary omits the section entirely."""
    agg: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        name = str(_field(s, "name", "?"))
        if not name.startswith("osc."):
            continue
        args = _field(s, "args", None) or {}
        rank = str(int(_field(s, "rank", -1)))
        e = agg.setdefault(rank, {"puts": 0, "gets": 0, "accs": 0,
                                  "bytes": 0, "op_us": 0.0,
                                  "epochs": 0, "epoch_us": 0.0})
        dur = max(float(_field(s, "dur", 0.0)), 0.0) * 1e6
        if name == "osc.epoch":
            e["epochs"] += 1
            e["epoch_us"] += dur
            continue
        kind = name.split(".", 1)[1]     # put / get / acc
        if kind in ("put", "get"):
            e[f"{kind}s"] += 1
        else:
            e["accs"] += 1
        e["bytes"] += int(args.get("bytes", 0) or 0)
        e["op_us"] += dur
    for e in agg.values():
        e["op_us"] = round(e["op_us"], 2)
        e["epoch_us"] = round(e["epoch_us"], 2)
    return agg


def summarize(spans: Iterable[SpanLike],
              stats: Optional[Mapping[str, int]] = None,
              top: int = 5) -> Dict[str, Any]:
    """The compact, JSON-round-trippable trace summary a benchmark
    record can carry: span/drop totals, per-name
    aggregates, per-rank quant/dequant time (when compression ran),
    and the worst late-arrival attributions."""
    spans = list(spans)
    by_name: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        name = str(_field(s, "name", "?"))
        e = by_name.setdefault(name, {"count": 0, "total_us": 0.0})
        e["count"] += 1
        e["total_us"] += max(float(_field(s, "dur", 0.0)), 0.0) * 1e6
    for e in by_name.values():
        e["total_us"] = round(e["total_us"], 2)
    reports = late_arrival(spans)
    out: Dict[str, Any] = {
        "spans": int((stats or {}).get("spans", len(spans))),
        "dropped": int((stats or {}).get("dropped", 0)),
        "by_name": by_name,
        "skew_watermarks": {k: round(v, 9)
                            for k, v in skew_watermarks().items()},
    }
    comp = compress_by_rank(spans)
    if comp:
        out["compress"] = comp
    buck = bucket_flushes_by_reason(spans)
    if buck:
        out["bucket_flush"] = buck
    shm = shm_seg_by_rank(spans)
    if shm:
        out["shm_seg"] = shm
    ftagg = ft_by_rank(spans)
    if ftagg:
        out["ft"] = ftagg
    osc = osc_by_rank(spans)
    if osc:
        out["osc"] = osc
    if reports:
        out["late_arrival_top"] = reports[:top]
    return out


def _register_pvars() -> None:
    _pvar.pvar_register(
        "trace_skew_watermarks", skew_watermarks,
        unit="seconds", var_class="highwatermark",
        help="Per-communicator max collective arrival skew "
             "(cid -> seconds) attributed by trace.attribution")


_register_pvars()
