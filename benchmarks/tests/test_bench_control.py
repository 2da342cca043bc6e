"""The control of each cell's comparison comes out not correct: the
reference computed in bfloat16 (the nearest precision below the cells'
float32) and put in the program's place, on the inputs of a short window
of the program, which itself passes. On the card ``control.py`` reads
the same at the cells' own sizes."""
import pytest

from benchlib import compare, spec
from conftest import tiny

WORKLOADS = [w["name"] for w in spec.load_spec()["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("seed", [1, 2**31 + 9, 4_000_000_004])
def test_control_fails_where_the_program_passes(fresh_world, workload, seed):
    cfg, mix = tiny(workload)
    cell = spec.driver(mix["kind"]).Cell(cfg, mix, "cpu")
    cell.load(seed)
    cell.warm()
    cell.window(0.05, timed=False)
    prog = cell.checks(cell.outputs())
    ctrl = cell.checks(cell.control())
    assert compare.passed(prog), prog
    assert not compare.passed(ctrl), ctrl
    if mix["kind"] == "collectives":
        # every number, the exact ones included, sees the rounding
        assert all(v > lim for _, v, lim in ctrl), ctrl
