"""The comparison that decides ``correct``: one number per compared
output, each held to its own limit (set from the program's and the
control's readings, ``PERF.md`` section 2)."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Check = Tuple[str, float, float]        # (name, value, limit)


def rel_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap between ``got`` and the float64 reference, over the
    reference's largest magnitude. ``inf`` where the shapes differ or a
    value is not finite."""
    if tuple(got.shape) != tuple(ref.shape):
        return math.inf
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    gap = float((got.to(torch.float64) - ref.to(torch.float64)).abs().max())
    if not math.isfinite(gap):
        return math.inf
    return gap / scale if scale > 0 else gap


def max_abs(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest absolute gap: 0 exactly when every value is equal.
    Computed in the expected values' type (an output in another type is
    converted to it, never the other way), one row block at a time, so
    no float64 copy of a large output is made. ``inf`` where shapes
    differ or a value is not finite."""
    if tuple(got.shape) != tuple(want.shape):
        return math.inf
    worst = 0.0
    for a, b in zip(got, want):
        if a.dtype != b.dtype:
            a = a.to(b.dtype)
        d = float((a - b).abs().max()) if a.numel() else 0.0
        if not math.isfinite(d):
            return math.inf
        worst = max(worst, d)
    return worst


def passed(checks: List[Check]) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def as_json(checks: List[Check]) -> Dict[str, Dict[str, float]]:
    return {name: {"value": v, "limit": lim} for name, v, lim in checks}


def lines(checks: List[Check]) -> List[str]:
    return [f"check {name}: {v!r} (limit {lim!r}) "
            f"{'ok' if math.isfinite(v) and v <= lim else 'FAILED'}"
            for name, v, lim in checks]
