"""mpitop — the fleet's `top` for an ompi_tpu_torch job (the port of
``ompi_tpu/tools/mpitop.py``).

Merges per-rank telemetry snapshots (``telemetry.dump()`` files,
``telemetry_<rank>.json`` by convention) into one table: per rank —
collective p50/p99, pml send/recv p99, operation and byte throughput,
and the straggler score its PEERS assign it (health-monitor scores are
accusations: rank 0's snapshot scores rank 1, so a rank's column is
the worst accusation against it). ``--per-comm`` expands rows to
(rank, comm) using the histogram labels. When the one-sided plane ran,
an ``osc`` section follows the table: per-origin put/get/accumulate
counts and bytes, the ``tele_osc_*`` p99s, epoch-boundary counts, and
RMA_SYNC / torn-epoch flags.

The ``slow_rank`` election mirrors the flight recorder's: the most
straggler-declared/accused rank wins; with no accusations, the rank
with the worst OWN-latency p99 — max(coll p99, send p99); recv waits
are deliberately excluded (blocked-waiting is the victim's symptom,
not the straggler's — the attribution layer's blocked vs in-op split).

Curses-free by design: single-shot prints one table; ``--watch N``
re-reads the files every N seconds and reprints (throughput columns
become deltas/s between reads). ``--format json`` emits the merged
machine-readable form; ``--format prom`` emits one Prometheus
exposition for ALL ranks (telemetry/prom over the merged rows).

Usage::

    python -m ompi_tpu_torch.tools.mpitop [--watch N] [--per-comm] \
        [--format table|json|prom] telemetry_*.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from ompi_tpu_torch.telemetry.hist import merge_snapshots


def load_snapshots(files: List[str]) -> Tuple[List[Dict[str, Any]],
                                              List[Dict[str, str]]]:
    """Parse telemetry.dump() files; unreadable/truncated ones are
    skipped with a warning (tracedump's contract — one dead rank must
    not cost the table the others)."""
    snaps: List[Dict[str, Any]] = []
    skipped: List[Dict[str, str]] = []
    for path in files:
        try:
            with open(path) as f:
                d = json.load(f)
            if not isinstance(d, dict) or "telemetry" not in d:
                raise ValueError("not a telemetry dump")
        except (OSError, json.JSONDecodeError, ValueError,
                UnicodeDecodeError) as e:
            skipped.append({"file": path, "error": str(e)})
            print(f"mpitop: warning: skipped {path}: {e}",
                  file=sys.stderr)
            continue
        snaps.append(d)
    return snaps, skipped


def _merge_named(hists: List[Dict[str, Any]],
                 pred) -> Dict[str, Any]:
    return merge_snapshots([h.get("snap") or {} for h in hists
                            if pred(h)])


def summarize(snaps: List[Dict[str, Any]],
              per_comm: bool = False) -> Dict[str, Any]:
    """The merged machine-readable form every output format renders
    from: one row per rank (or per (rank, comm)), plus the slow-rank
    election."""
    rows: List[Dict[str, Any]] = []
    accusations: Dict[int, float] = {}   # subject -> worst peer score
    declared: Dict[int, int] = {}        # subject -> declaring peers
    for d in snaps:
        health = d.get("health") or {}
        for peer, score in (health.get("scores") or {}).items():
            p = int(peer)
            accusations[p] = max(accusations.get(p, 0.0), float(score))
        for p in health.get("declared") or []:
            declared[int(p)] = declared.get(int(p), 0) + 1

    def is_coll(h):
        return str(h.get("name", "")).startswith("tele_coll_")

    for d in sorted(snaps, key=lambda s: int(s.get("rank", -1))):
        rank = int(d.get("rank", -1))
        hists = d.get("hists") or []
        keys: List[Optional[str]] = [None]
        if per_comm:
            keys = sorted({(h.get("labels") or {}).get("comm")
                           for h in hists if is_coll(h)} - {None}) \
                or [None]
        for comm in keys:
            if comm is None:
                coll = _merge_named(hists, is_coll)
            else:
                coll = _merge_named(
                    hists, lambda h, c=comm: is_coll(h)
                    and (h.get("labels") or {}).get("comm") == c)
            send = _merge_named(
                hists, lambda h: h.get("name") == "tele_pml_send_us")
            recv = _merge_named(
                hists, lambda h: h.get("name") == "tele_pml_recv_us")
            rail = _merge_named(
                hists, lambda h: h.get("name") == "tele_btl_rail_bytes")
            shm = _merge_named(
                hists,
                lambda h: h.get("name") == "tele_btl_shm_seg_bytes")
            row: Dict[str, Any] = {
                "rank": rank,
                "coll_ops": coll["count"],
                "coll_p50_us": coll["p50"],
                "coll_p99_us": coll["p99"],
                "send_p99_us": send["p99"],
                "recv_p99_us": recv["p99"],
                "rail_bytes": round(rail["sum"], 0),
                "shm_bytes": round(shm["sum"], 0),
                "straggler_score": accusations.get(rank, 0.0),
                "declared_by": declared.get(rank, 0),
                "time": float(d.get("time", 0.0)),
            }
            if comm is not None:
                row["comm"] = comm
            rows.append(row)

    # the one-sided plane: per-origin op/byte counters from the dump's
    # ``osc`` block, latencies from the tele_osc_* histograms — present
    # only when RMA ran at all
    osc_rows: List[Dict[str, Any]] = []
    for d in sorted(snaps, key=lambda s: int(s.get("rank", -1))):
        o = d.get("osc") or {}
        if not o:
            continue
        hists = d.get("hists") or []
        put = _merge_named(
            hists, lambda h: h.get("name") == "tele_osc_put_us")
        get = _merge_named(
            hists, lambda h: h.get("name") == "tele_osc_get_us")
        acc = _merge_named(
            hists, lambda h: h.get("name") == "tele_osc_acc_us")
        osc_rows.append({
            "rank": int(d.get("rank", -1)),
            "puts": int(o.get("puts", 0)),
            "gets": int(o.get("gets", 0)),
            "accs": int(o.get("accs", 0)),
            "bytes": int(o.get("put_bytes", 0))
            + int(o.get("get_bytes", 0)) + int(o.get("acc_bytes", 0)),
            "put_p99_us": put["p99"],
            "get_p99_us": get["p99"],
            "acc_p99_us": acc["p99"],
            "fences": int(o.get("fences", 0)),
            "locks": int(o.get("locks", 0)),
            "epoch_errors": int(o.get("epoch_errors", 0)),
            "ft_failed_epochs": int(o.get("ft_failed_epochs", 0)),
        })

    slow: Optional[int] = None
    if declared:
        slow = max(sorted(declared), key=lambda r: declared[r])
    elif accusations and max(accusations.values()) > 0.0:
        slow = max(sorted(accusations), key=lambda r: accusations[r])
    else:
        worst = -1.0
        for row in rows:
            own = max(float(row["coll_p99_us"]),
                      float(row["send_p99_us"]))
            if own > worst:
                worst, slow = own, int(row["rank"])
    out = {"mpitop": 1, "rows": rows, "slow_rank": slow,
           "accusations": {str(r): s
                           for r, s in sorted(accusations.items())},
           "declared": {str(r): n
                        for r, n in sorted(declared.items())}}
    if osc_rows:
        out["osc"] = osc_rows
    return out


def _fmt_us(v: float) -> str:
    if v >= 1e6:
        return f"{v / 1e6:.2f}s"
    if v >= 1e3:
        return f"{v / 1e3:.1f}ms"
    return f"{v:.0f}us"


def render_table(summary: Dict[str, Any],
                 rates: Optional[Dict[Any, Tuple[float, float]]] = None
                 ) -> str:
    per_comm = any("comm" in r for r in summary["rows"])
    hdr = ["rank"] + (["comm"] if per_comm else []) + \
        ["coll_ops", "coll_p50", "coll_p99", "send_p99", "recv_p99",
         "straggler", "flags"]
    if rates is not None:
        hdr.insert(-2, "ops/s")
    lines = []
    widths = [len(h) for h in hdr]
    table = []
    for row in summary["rows"]:
        flags = []
        if row["declared_by"]:
            flags.append(f"STRAGGLER(x{row['declared_by']})")
        if summary["slow_rank"] == row["rank"]:
            flags.append("SLOW")
        cells = [str(row["rank"])] + \
            ([str(row.get("comm", "-"))] if per_comm else []) + \
            [str(row["coll_ops"]), _fmt_us(row["coll_p50_us"]),
             _fmt_us(row["coll_p99_us"]), _fmt_us(row["send_p99_us"]),
             _fmt_us(row["recv_p99_us"])]
        if rates is not None:
            key = (row["rank"], row.get("comm"))
            ops_s, _ = rates.get(key, (0.0, 0.0))
            cells.append(f"{ops_s:.1f}")
        cells += [f"{row['straggler_score']:.3f}",
                  " ".join(flags) or "-"]
        table.append(cells)
        widths = [max(w, len(c)) for w, c in zip(widths, cells)]
    lines.append("  ".join(h.ljust(w) for h, w in zip(hdr, widths)))
    for cells in table:
        lines.append("  ".join(c.ljust(w)
                               for c, w in zip(cells, widths)))
    lines.append(f"slow_rank: {summary['slow_rank']}")
    if summary.get("osc"):
        lines.append("")
        ohdr = ["rank", "puts", "gets", "accs", "bytes", "put_p99",
                "get_p99", "acc_p99", "fences", "locks", "flags"]
        otab = []
        owid = [len(h) for h in ohdr]
        for o in summary["osc"]:
            oflags = []
            if o["epoch_errors"]:
                oflags.append(f"RMA_SYNC(x{o['epoch_errors']})")
            if o["ft_failed_epochs"]:
                oflags.append(f"FT_EPOCH(x{o['ft_failed_epochs']})")
            cells = [str(o["rank"]), str(o["puts"]), str(o["gets"]),
                     str(o["accs"]), str(o["bytes"]),
                     _fmt_us(o["put_p99_us"]), _fmt_us(o["get_p99_us"]),
                     _fmt_us(o["acc_p99_us"]), str(o["fences"]),
                     str(o["locks"]), " ".join(oflags) or "-"]
            otab.append(cells)
            owid = [max(w, len(c)) for w, c in zip(owid, cells)]
        lines.append("osc (one-sided):")
        lines.append("  ".join(h.ljust(w) for h, w in zip(ohdr, owid)))
        for cells in otab:
            lines.append("  ".join(c.ljust(w)
                                   for c, w in zip(cells, owid)))
    return "\n".join(lines)


def render_prom(snaps: List[Dict[str, Any]]) -> str:
    from ompi_tpu_torch.telemetry import prom
    hist_rows = []
    pvars: List[Dict[str, Any]] = []
    for d in snaps:
        rank = int(d.get("rank", -1))
        for h in d.get("hists") or []:
            hist_rows.append(dict(h, rank=rank))
        health = d.get("health") or {}
        if health.get("scores"):
            pvars.append({"name": "tele_straggler_scores",
                          "value": health["scores"], "rank": rank})
    return prom.render(rank=-1, pvars=pvars, hist_rows=hist_rows)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ompi_tpu_torch.tools.mpitop",
        description="Merge per-rank telemetry snapshots into a "
                    "per-rank/per-comm latency + straggler table.")
    ap.add_argument("files", nargs="+",
                    help="telemetry snapshot files written by "
                         "ompi_tpu_torch.telemetry.dump()")
    ap.add_argument("--format", "-f", default="table",
                    choices=("table", "json", "prom"))
    ap.add_argument("--per-comm", action="store_true",
                    help="one row per (rank, comm) instead of per rank")
    ap.add_argument("--watch", type=float, default=0.0, metavar="N",
                    help="re-read and reprint every N seconds "
                         "(throughput becomes delta ops/s)")
    ap.add_argument("--out", "-o", default="-",
                    help="output path (default: stdout)")
    args = ap.parse_args(argv)

    prev: Dict[Any, Tuple[float, float]] = {}
    prev_t = 0.0
    while True:
        snaps, skipped = load_snapshots(args.files)
        if not snaps:
            print("mpitop: no readable telemetry snapshots",
                  file=sys.stderr)
            return 1
        summary = summarize(snaps, per_comm=args.per_comm)
        if skipped:
            summary["skipped"] = len(skipped)
        if args.format == "json":
            text = json.dumps(summary, indent=1)
        elif args.format == "prom":
            text = render_prom(snaps)
        else:
            rates = None
            if args.watch and prev_t:
                dt = max(time.monotonic() - prev_t, 1e-9)
                rates = {}
                for row in summary["rows"]:
                    key = (row["rank"], row.get("comm"))
                    p_ops, p_bytes = prev.get(
                        key, (row["coll_ops"], row["rail_bytes"]))
                    rates[key] = (
                        max(0.0, (row["coll_ops"] - p_ops) / dt),
                        max(0.0, (row["rail_bytes"] - p_bytes) / dt))
            text = render_table(summary, rates)
        if args.out == "-":
            sys.stdout.write(text + "\n")
            sys.stdout.flush()
        else:
            with open(args.out, "w") as f:
                f.write(text + ("\n" if not text.endswith("\n")
                                else ""))
        if not args.watch:
            return 0
        prev = {(r["rank"], r.get("comm")):
                (r["coll_ops"], r["rail_bytes"])
                for r in summary["rows"]}
        prev_t = time.monotonic()
        time.sleep(args.watch)


if __name__ == "__main__":
    sys.exit(main())
