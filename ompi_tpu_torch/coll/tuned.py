"""coll/tuned — the dynamic-rules file of the decision layer.

The port of ``ompi_tpu/coll/tuned.py``'s rule loading: the JSON file named
by ``coll_tuned_dynamic_rules`` overrides :mod:`coll.decision`'s rows per
collective (``{func: {"algorithm_rules": [[min_comm_size, min_bytes,
algorithm], ...]}}``), as tuned's dynamic file does
(``coll_tuned_component.c:187-191``). The per-rank tier reads two more
of its vars here: the staging switch point of host buffers onto the device
tier (``coll_tuned_stage_min_bytes``, overridable per collective by the
rules file) and the combined small-message allreduce's limits. The staging
probe that earns the switch point on the reference, and the tuned
component itself, wait for a later slice: here the var's value stands.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Tuple

from ompi_tpu_torch.mca import var

_rules_cache: Dict[str, Tuple[float, Dict]] = {}


def register_vars() -> None:
    """Register ``coll_tuned_dynamic_rules`` (at import, and again by
    ``init`` after a reset of the var store)."""
    var.var_register(
        "coll", "tuned", "dynamic_rules", vtype="str", default="",
        help="Path to a JSON per-collective decision-rule override file "
             "(re-design of coll/tuned dynamic rules)")
    var.var_register(
        "coll", "tuned", "stage_min_bytes", vtype="int", default=1 << 20,
        help="Per-rank tier: host buffers at least this large are staged "
             "onto the device and run on the shared-buffer tier; smaller "
             "ones run the host algorithms")
    var.var_register(
        "coll", "tuned", "small_allreduce_max_bytes", vtype="int",
        default=4096,
        help="Per-rank tier: host payloads at or below this take the "
             "combined small-message allreduce (one eager send per peer, "
             "reader-thread combining, one wakeup)")
    var.var_register(
        "coll", "tuned", "small_allreduce_max_ranks", vtype="int",
        default=32,
        help="The combined small-message allreduce sends rank-count "
             "squared messages; larger worlds use the tree algorithms")


register_vars()


def _load_rules(path: str) -> Dict[str, Dict]:
    """The rules in ``path``, memoized by mtime: the decision layer asks
    on every memo miss, so the JSON is parsed only when the file
    changed. A reload bumps the var epoch, so warm (shape, dtype, op)
    memo entries of coll/torch decide again."""
    if not path:
        return {}
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return {}
    cached = _rules_cache.get(path)
    if cached is not None and cached[0] == mtime:
        return cached[1]
    try:
        with open(path) as f:
            data = json.load(f)
        rules = data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        rules = {}
    _rules_cache[path] = (mtime, rules)
    var.bump_epoch()
    return rules


def stage_min_for(func: str) -> int:
    """The staging switch point of one collective: the rules file's
    per-collective ``stage_min_bytes`` where it has one, else the var."""
    rules = _load_rules(var.var_get("coll_tuned_dynamic_rules", ""))
    override = rules.get(func, {}).get("stage_min_bytes")
    if override is not None:
        return int(override)
    return int(var.var_get("coll_tuned_stage_min_bytes", 1 << 20))


def small_allreduce_limits() -> Tuple[int, int]:
    """(max_bytes, max_ranks) of the combined small-message allreduce."""
    return (int(var.var_get("coll_tuned_small_allreduce_max_bytes", 4096)),
            int(var.var_get("coll_tuned_small_allreduce_max_ranks", 32)))
