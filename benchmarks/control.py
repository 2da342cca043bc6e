#!/usr/bin/env python3
"""The control of a cell's comparison, with the program's own readings.

    python3 benchmarks/control.py --workload <name> --seconds 2 \\
        --seeds 11 12 13 ...

For each seed, in one process: the cell's inputs, a short window of the
program on the cell's own traffic, and the numbers its comparison reads
(the lower readings); then the control, the reference computed in
bfloat16 and put in the program's place on the same inputs (the upper
readings). One JSON line per seed, then one with the program's largest
and the control's smallest reading of each number. Like ``run.py`` it
needs the card the cell asks for; the benchmark's own runs never run
it."""
import argparse
import json
import math
import sys
import time

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    run.set_caches()
    from benchlib import compare, device, spec
    bench = spec.load_spec()
    c = spec.cell(bench, args.workload)
    device.require_cuda(int(c["chips"]))
    import torch
    torch.cuda.set_device(0)
    cfg, mix = spec.config(c["config"]), spec.traffic(c["traffic"])
    cell = spec.driver(mix["kind"]).Cell(cfg, mix, "cuda:0")
    lo, hi = {}, {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell.load(seed)
        cell.warm()
        rec = cell.window(args.seconds, timed=False)
        prog = cell.checks(cell.outputs())
        ctrl = cell.checks(cell.control())
        for name, v, _ in prog:
            lo[name] = max(lo.get(name, 0.0), v)
        for name, v, _ in ctrl:
            hi[name] = min(hi.get(name, math.inf), v)
        print(json.dumps({
            "seed": seed, "attempted": rec.get("calls", rec.get("steps")),
            "program": {n: v for n, v, _ in prog},
            "program_passed": compare.passed(prog),
            "control": {n: v for n, v, _ in ctrl},
            "control_passed": compare.passed(ctrl),
            "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"workload": args.workload,
                      "device": torch.cuda.get_device_name(0),
                      "power_limit": device.power_limit(),
                      "program_max": lo, "control_min": hi}), flush=True)
    bad = run.forbidden_modules()
    if bad:
        sys.stderr.write(f"control: loaded {', '.join(bad)}\n")
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
