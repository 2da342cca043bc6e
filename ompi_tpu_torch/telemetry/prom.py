"""telemetry/prom — Prometheus textfile exporter (the port of
``ompi_tpu/telemetry/prom.py``).

The fleet story's scrape target: render every pvar as Prometheus
exposition text — scalars as gauges, ``CLASS_HISTOGRAM`` pvars as
native Prometheus histograms (cumulative ``_bucket{le=...}`` series
with ``+Inf``, ``_sum``, ``_count``) — labeled with ``rank`` /
``comm`` / ``func`` / ``sclass`` where the instrument carries them.

Intended use is the node-exporter *textfile collector*:
``write_textfile(path)`` writes atomically (tmp + rename, the
collector's torn-read contract) on whatever cadence the caller picks;
no HTTP listener, no dependency. Merged multi-rank exposition renders
explicit rows (``pvars``/``hist_rows``) read from per-rank dumps.

Metric names keep the reference's ``ompi_tpu_`` prefix: both packages
export the same families, so one dashboard reads either.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterable, List, Mapping, Optional

from ompi_tpu_torch.telemetry.hist import bucket_bounds

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
PREFIX = "ompi_tpu_"


def _metric_name(name: str) -> str:
    return PREFIX + _NAME_RE.sub("_", name)


def _labels(label_map: Mapping[str, Any]) -> str:
    items = [(k, str(v)) for k, v in sorted(label_map.items())
             if v is not None and v != ""]
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in items)
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _render_histogram(name: str, snap: Mapping[str, Any],
                      labels: Mapping[str, Any],
                      lines: List[str], seen: set) -> None:
    metric = _metric_name(name)
    if metric not in seen:
        seen.add(metric)
        lines.append(f"# HELP {metric} {snap.get('unit', 'us')} "
                     f"histogram (ompi_tpu telemetry)")
        lines.append(f"# TYPE {metric} histogram")
    cum = 0
    sparse = {int(k): int(v)
              for k, v in (snap.get("buckets") or {}).items()}
    for i in sorted(sparse):
        cum += sparse[i]
        le = bucket_bounds(i)[1]
        lab = dict(labels)
        lab["le"] = f"{le:g}"
        lines.append(f"{metric}_bucket{_labels(lab)} {cum}")
    lab = dict(labels)
    lab["le"] = "+Inf"
    count = int(snap.get("count", 0))
    lines.append(f"{metric}_bucket{_labels(lab)} {count}")
    lines.append(f"{metric}_sum{_labels(labels)} "
                 f"{float(snap.get('sum', 0.0)):g}")
    lines.append(f"{metric}_count{_labels(labels)} {count}")


def _render_gauge(name: str, value: Any, labels: Mapping[str, Any],
                  lines: List[str], seen: set) -> None:
    try:
        num = float(value)
    except (TypeError, ValueError):
        return                           # non-numeric scalar: skip
    metric = _metric_name(name)
    if metric not in seen:
        seen.add(metric)
        lines.append(f"# TYPE {metric} gauge")
    lines.append(f"{metric}{_labels(labels)} {num:g}")


def render(rank: Optional[int] = None,
           pvars: Optional[Iterable[Mapping[str, Any]]] = None,
           hist_rows: Optional[Iterable[Mapping[str, Any]]] = None
           ) -> str:
    """Exposition text for ONE process's telemetry. With no arguments,
    reads the live pvar surface and histogram registry; merged
    multi-rank rendering passes explicit rows:
    ``pvars`` rows shaped like ``pvar_list()`` entries, ``hist_rows``
    shaped like ``telemetry.snapshot_hists()`` entries plus ``rank``.
    """
    from ompi_tpu_torch import telemetry as _t
    lines: List[str] = []
    seen: set = set()
    base: Dict[str, Any] = {}
    if rank is None:
        from ompi_tpu_torch import trace as _trace
        rank = _trace.process_rank()
    if rank is not None and int(rank) >= 0:
        base["rank"] = int(rank)

    if hist_rows is None:
        hist_rows = _t.snapshot_hists()
    hist_names = set()
    for row in hist_rows:
        labels = dict(base)
        labels.update(row.get("labels") or {})
        if "rank" in row:
            labels["rank"] = int(row["rank"])
        name = str(row["name"])
        hist_names.add(name)
        # per-comm-per-sclass series share ONE metric family per func:
        # the comm/func/sclass labels carry the dimensions. The suffix
        # is reconstructed from the labels (a left-anchored regex would
        # eat any earlier "_c" in the family name itself)
        family = name
        labs = row.get("labels") or {}
        if labs.get("comm") is not None and labs.get("sclass"):
            from ompi_tpu_torch.telemetry import _cid_token
            suffix = f"_c{_cid_token(labs['comm'])}_{labs['sclass']}"
            if name.endswith(suffix):
                family = name[: -len(suffix)]
        _render_histogram(family, row.get("snap") or {}, labels,
                          lines, seen)

    if pvars is None:
        from ompi_tpu_torch.mca import pvar as _pvar
        try:
            pvars = _pvar.pvar_list()
        except Exception:                # noqa: BLE001 — one raising
            pvars = []                   # read must not kill the scrape
    for ent in pvars:
        name = str(ent.get("name", ""))
        if not name or name in hist_names:
            continue
        if ent.get("class") == "histogram":
            continue                     # rendered from hist_rows
        labels = dict(base)
        if "rank" in ent:
            labels["rank"] = int(ent["rank"])
        val = ent.get("value")
        if isinstance(val, dict):
            # dict-valued pvars (watermark maps): one sample per key
            for k, v in sorted(val.items()):
                _render_gauge(name, v, {**labels, "key": str(k)},
                              lines, seen)
        else:
            _render_gauge(name, val, labels, lines, seen)
    return "\n".join(lines) + "\n" if lines else ""


def write_textfile(path: str, text: Optional[str] = None) -> str:
    """Atomic write for the node-exporter textfile collector (it
    requires rename-into-place — a torn read of a half-written file
    poisons the whole scrape)."""
    if text is None:
        text = render()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return path
