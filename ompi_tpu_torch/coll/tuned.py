"""coll/tuned — the dynamic-rules file of the decision layer.

The port of ``ompi_tpu/coll/tuned.py``'s rule loading: the JSON file named
by ``coll_tuned_dynamic_rules`` overrides :mod:`coll.decision`'s rows per
collective (``{func: {"algorithm_rules": [[min_comm_size, min_bytes,
algorithm], ...]}}``), as tuned's dynamic file does
(``coll_tuned_component.c:187-191``). The staging probe and the tuned
component itself belong to the per-rank tier.
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
