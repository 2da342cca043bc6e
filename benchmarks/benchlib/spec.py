"""Find a cell, its configuration, its traffic mix, its driver and its
metric readers by the names ``BENCHMARK.json`` gives them. Everything is
looked up by name under ``benchmarks/``, so a later cell or metric is a
new file and a new entry, never an edit."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
REPO_ROOT = BENCH_DIR.parent
SPEC_FILE = REPO_ROOT / "BENCHMARK.json"
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def load_spec(path: Path = SPEC_FILE) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def cell(spec: Dict[str, Any], workload: str) -> Dict[str, Any]:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def _json(sub: str, name: str) -> Dict[str, Any]:
    with open(BENCH_DIR / sub / f"{_name(sub, name)}.json") as f:
        return json.load(f)


def config(name: str) -> Dict[str, Any]:
    """``configs/<name>.json``: the deployment's sizes."""
    return _json("configs", name)


def traffic(name: str) -> Dict[str, Any]:
    """``traffic/<name>.json``: the mix's parameters and its limits."""
    return _json("traffic", name)


def _module(sub: str, name: str) -> ModuleType:
    path = BENCH_DIR / sub / f"{_name(sub, name)}.py"
    mod_name = f"_bench_{sub}_{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str) -> ModuleType:
    """``drivers/<kind>.py``: the code that runs one traffic kind."""
    return _module("drivers", kind)


def reader(metric: str) -> ModuleType:
    """``metrics/<metric>.py``: ``read(record) -> float | None``."""
    return _module("metrics", metric)


def metrics_for(spec: Dict[str, Any], workload: str,
                trace: bool) -> List[Dict[str, Any]]:
    """The metrics a run of ``workload`` prints: the end-to-end ones
    untraced, the per-layer ones traced; a metric with ``workloads``
    only in those cells."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


def model(model_type: str) -> ModuleType:
    """``models/<model_type>.py``: ``shapes(cfg)``, a model's parameter
    tensors from its configuration."""
    return _module("models", model_type)
