"""Configurations, mixes, drivers and metric readers are found by the
names ``BENCHMARK.json`` gives them, and the file keeps the contract's
shape."""
import json
import re

import pytest

from benchlib import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
BENCH = spec.load_spec()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmarks/run.py"]
    assert BENCH["paths"] == ["benchmarks"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(c):
    assert NAME.match(c["name"])
    assert c["file"] == f"benchmarks/configs/{c['name']}.json"
    cfg = spec.config(c["name"])
    assert cfg["name"] == c["name"]
    assert all(k in cfg for k in c["reduced"])
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_mix_driver_and_metrics(w):
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and len(w["why"]) <= 200
    mix = spec.traffic(w["traffic"])
    drv = spec.driver(mix["kind"])
    assert callable(drv.run) and hasattr(drv, "Cell")
    e2e = [m["name"] for m in spec.metrics_for(BENCH, w["name"], False)]
    per = [m["name"] for m in spec.metrics_for(BENCH, w["name"], True)]
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    moved = {m["moves"] for m in spec.metrics_for(BENCH, w["name"], True)}
    assert moved <= set(e2e)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    assert NAME.match(m["name"])
    assert callable(spec.reader(m["name"]).read)
    assert m["better"] in ("lower", "higher")
    assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"])
    assert spec.reader(m["name"]).read({}) is None


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_unknown_and_unsafe_names_are_refused():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no_such_cell")
    with pytest.raises(FileNotFoundError):
        spec.traffic("no_such_mix")
    with pytest.raises(ValueError):
        spec.config("../BENCHMARK")
