#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result.

    python3 benchmarks/run.py --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

The cell, its configuration, its traffic mix, the mix's driver and the
metrics' readers are found by name (``BENCHMARK.json``, then
``configs/``, ``traffic/``, ``drivers/``, ``metrics/`` under this
directory). The run needs as many CUDA cards as the cell asks for and
exits non-zero without them: it never falls back to the CPU. Its last
line on standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: every number compared beside its limit); the same
numbers are the last lines on standard error."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"
# every compile and kernel cache at a fixed place inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton",
          "TORCHINDUCTOR_CACHE_DIR": "inductor",
          "CUDA_CACHE_PATH": "nv"}
# top-level module names the measured process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "ompi_tpu")

for _p in (str(ROOT), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def set_caches() -> None:
    for var, sub in CACHES.items():
        os.environ[var] = str(CACHE / sub)


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".")[0] in FORBIDDEN)


def execute(workload, seed, seconds, trace, device, t_start,
            bench=None, cfg=None, mix=None, chips=1):
    """Drive one run on ``device`` and return (result, stderr lines). The
    look for a card is the caller's; ``cfg`` and ``mix`` replace the
    named files' contents (the tests' small sizes)."""
    import torch
    from benchlib import compare, spec
    bench = spec.load_spec() if bench is None else bench
    c = spec.cell(bench, workload)
    cfg = spec.config(c["config"]) if cfg is None else cfg
    mix = spec.traffic(c["traffic"]) if mix is None else mix
    rec = spec.driver(mix["kind"]).run(cfg, mix, seed, seconds, trace,
                                       device, t_start)
    dev = torch.device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rec["device_kind"] = kind
    metrics = {}
    for m in spec.metrics_for(bench, workload, bool(trace)):
        v = spec.reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": kind, "count": int(chips),
                   "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    if dev.type == "cuda":
        from benchlib.device import power_limit
        device_info["power_limit"] = power_limit()
    checks = rec["checks"]
    ok = (compare.passed(checks) and rec["failed"] == 0
          and rec["attempted"] > 0)
    result = {"correct": bool(ok), "attempted": int(rec["attempted"]),
              "failed": int(rec["failed"]), "metrics": metrics,
              "device": device_info}
    notes = [f"cell {workload} seed {seed}: {kind}, power limit "
             f"{device_info.get('power_limit', 'n/a')}, setup "
             f"{rec['setup_s']!r} s, window {rec['window_s']!r} s, "
             f"attempted {rec['attempted']}, failed {rec['failed']}"]
    if rec.get("setup_parts"):
        notes.append("setup: " + ", ".join(
            f"{k} {v!r} s" for k, v in rec["setup_parts"].items()))
    if rec.get("errors"):
        notes.append(f"first error: {rec['errors'][0]}")
    if rec.get("worst_tensor"):
        notes.append(f"widest gap in {rec['worst_tensor']}")
    notes += rec.get("notes", [])
    if trace:
        p = rec.get("profile") or {}
        if p.get("busy_s"):
            device_info["busy_s"] = float(p["busy_s"])
            device_info["window_s"] = float(p["window_s"])
        else:
            notes.append("the profiler recorded no device activity")
        result["breakdown"] = {"device_ops": p.get("device_ops", []),
                               "idle_gaps": p.get("idle_gaps", [])}
    result["checks"] = compare.as_json(checks)
    return result, notes + compare.lines(checks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_caches()
    from benchlib import device, spec
    bench = spec.load_spec()
    chips = int(spec.cell(bench, args.workload)["chips"])
    device.require_cuda(chips)
    import torch
    torch.cuda.set_device(0)
    result, lines = execute(args.workload, args.seed, args.seconds,
                            args.trace, "cuda:0", T_START, bench=bench,
                            chips=chips)
    bad = forbidden_modules()
    if bad:
        sys.stderr.write(f"benchmark: the measured process loaded "
                         f"{', '.join(bad)}\n")
        return 4
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
