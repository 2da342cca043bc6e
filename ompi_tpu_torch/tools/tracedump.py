"""tracedump — merge per-rank trace dumps and render them (the port of
``ompi_tpu/tools/tracedump.py``).

The mpirun-style companion to ``ompi_tpu_torch.trace``: each rank persists
its span ring with ``trace.dump(path, offset_s=...)`` (offset measured
against rank 0 by ``tools/mpisync``); this tool merges the dumps onto
one timebase and emits either a Perfetto-loadable JSON
(``--format perfetto``, open at https://ui.perfetto.dev), the
late-arrival attribution report (``--format report``), the compact
summary (``--format summary``; includes per-rank ``compress.quant`` /
``compress.dequant`` time aggregation when compressed collectives ran,
per-rank ``ft.*`` suspicion/declaration aggregation when the resilience
plane saw action, per-origin ``osc.*`` op/byte/epoch aggregation when
the one-sided plane ran, and the merged lock-witness graph when
``analyze/lockwitness`` dumps are given), or the flight-recorder
incident report (``--format flightrec``: merges ``flightrec_<rank>.json``
snapshots written by the telemetry plane's fault flight recorder and
names the critical rank).

Unreadable or truncated dump files are SKIPPED with a warning naming
the file (a rank killed mid-write must not cost the merge the other
ranks' evidence); the summary carries a ``skipped`` count and
``--strict`` turns any skip into a nonzero exit for CI.

Without input files it renders the CURRENT process's ring — the
in-process escape hatch (call ``ompi_tpu_torch.tools.tracedump.main([...])``
at the end of a traced program, or rely on ``bench.py --trace``).

Usage::

    python -m ompi_tpu_torch.tools.tracedump [-o OUT] [--strict] \
        [--format perfetto|report|summary|flightrec] [DUMP.json ...]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from ompi_tpu_torch import trace
from ompi_tpu_torch.trace import attribution, perfetto


def _gather(files: List[str]) -> tuple:
    """(spans, rank_offsets, live, witness_reports, flightrecs,
    skipped) merged from dump files, or the live ring (live=True).
    Lock-witness dumps (``lockwitness.dump()`` files, recognized by
    their ``lockwitness`` key) and flight-recorder snapshots
    (``flightrec`` key) ride the same file list and are split out.
    Files that don't parse or aren't any known dump shape are skipped
    and reported in ``skipped`` — never raised past the merge."""
    if not files:
        return trace.span_dicts(), {}, True, [], [], []
    spans: List[Dict[str, Any]] = []
    offsets: Dict[int, float] = {}
    witness: List[Dict[str, Any]] = []
    flightrecs: List[Dict[str, Any]] = []
    skipped: List[Dict[str, str]] = []
    for path in files:
        try:
            with open(path) as f:
                d = json.load(f)
            if isinstance(d, dict) and "lockwitness" in d:
                witness.append(d)
                continue
            if isinstance(d, dict) and "flightrec" in d:
                flightrecs.append(d)
                continue
            if not isinstance(d, dict) or "spans" not in d:
                raise ValueError("not a trace dump")
        except (OSError, json.JSONDecodeError, ValueError,
                UnicodeDecodeError) as e:
            skipped.append({"file": path, "error": str(e)})
            print(f"tracedump: warning: skipped {path}: {e}",
                  file=sys.stderr)
            continue
        rank = int(d.get("rank", -1))
        off = float(d.get("offset_s", 0.0))
        for s in d["spans"]:
            # a dump written before the world knew its rank (-1) keeps
            # per-span ranks; otherwise the file's rank is authoritative
            if rank >= 0 and int(s.get("rank", -1)) < 0:
                s = dict(s, rank=rank)
            spans.append(s)
        if rank >= 0:
            offsets[rank] = off
    return spans, offsets, False, witness, flightrecs, skipped


def render(spans, offsets, fmt: str, live: bool = False,
           witness: Optional[List[Dict[str, Any]]] = None,
           flightrecs: Optional[List[Dict[str, Any]]] = None,
           skipped: Optional[List[Dict[str, str]]] = None
           ) -> Dict[str, Any]:
    if fmt == "perfetto":
        return perfetto.export(spans, offsets)
    if fmt == "report":
        return {"late_arrival": attribution.late_arrival(spans, offsets),
                "skew_watermarks": attribution.skew_watermarks()}
    if fmt == "flightrec":
        from ompi_tpu_torch.telemetry import flightrec as _flightrec
        out = _flightrec.merge(flightrecs or [])
        if skipped:
            out["skipped"] = len(skipped)
            out["skipped_files"] = skipped
        return out
    # file mode: span/drop totals come from the dumps themselves, not
    # this (tool) process's empty live ring
    out = attribution.summarize(spans,
                                trace.stats() if live else None)
    if witness:
        # per-rank lockwitness dumps merged into one graph, cycle
        # detection re-run on the union
        from ompi_tpu_torch.analyze import lockwitness as _lockwitness
        out["lockwitness"] = _lockwitness.merge_reports(witness)
    if flightrecs:
        from ompi_tpu_torch.telemetry import flightrec as _fr
        out["flightrec"] = _fr.merge(flightrecs)
    if skipped:
        out["skipped"] = len(skipped)
        out["skipped_files"] = skipped
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ompi_tpu_torch.tools.tracedump",
        description="Merge per-rank trace dumps; emit Perfetto JSON, "
                    "a late-arrival report, a summary, or a "
                    "flight-recorder incident report.")
    ap.add_argument("files", nargs="*",
                    help="trace dump files written by trace.dump(); "
                         "empty = this process's live ring")
    ap.add_argument("--format", "-f", default="perfetto",
                    choices=("perfetto", "report", "summary",
                             "flightrec"))
    ap.add_argument("--out", "-o", default="-",
                    help="output path (default: stdout)")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero when any input file was "
                         "skipped as unreadable/truncated")
    args = ap.parse_args(argv)

    spans, offsets, live, witness, flightrecs, skipped = \
        _gather(args.files)
    obj = render(spans, offsets, args.format, live, witness,
                 flightrecs, skipped)
    text = json.dumps(obj, indent=None if args.format == "perfetto"
                      else 1)
    if args.out == "-":
        sys.stdout.write(text + "\n")
    else:
        with open(args.out, "w") as f:
            f.write(text)
    if skipped:
        print(f"tracedump: warning: {len(skipped)} file(s) skipped",
              file=sys.stderr)
        if args.strict:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
