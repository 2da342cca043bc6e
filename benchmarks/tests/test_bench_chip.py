"""On the card: one short run of each cell through the command, its last
line held to the result's contract, and the control on one seed. Skips
on a machine without a CUDA card.

    python -m pytest benchmarks/tests -q -m chip
"""
import json
import subprocess
import sys

import pytest

import run
from benchlib import spec

BENCH = spec.load_spec()


@pytest.mark.chip
@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(card, w, trace):
    out = subprocess.run(
        [sys.executable, str(run.BENCH / "run.py"), "--workload", w,
         "--seed", "4100000001", "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, timeout=360, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] > 0 and dev["power_limit"]
    want = {m["name"] for m in spec.metrics_for(BENCH, w, bool(trace))}
    assert set(res["metrics"]) == want
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, m in res["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100, name


@pytest.mark.chip
def test_control_on_the_card(card):
    out = subprocess.run(
        [sys.executable, str(run.BENCH / "control.py"), "--workload",
         "ddp_gpt2m_bucket25", "--seconds", "0.5", "--seeds", "4100000002"],
        capture_output=True, text=True, timeout=360, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    seed = json.loads(out.stdout.strip().splitlines()[0])
    assert seed["program_passed"] and not seed["control_passed"]
