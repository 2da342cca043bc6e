"""The device trace of a short stretch before the measured window, reduced to
the device's busy seconds, the window's length, the device operations
that took most time and the longest idle gaps by what the host was
doing. The measured window itself runs untraced, so the profiler's cost
never reaches an end-to-end metric.

The work runs twice under ``torch.profiler`` (CUPTI). The first pass
records the device alone, which costs the host little, and gives the
busy share and the operations; the second records the host too, whose
events cost host time, and gives only the idle gaps' attribution."""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

WINDOW = "bench.window"      # the record_function around the traced work
TOP = 10                     # entries of each breakdown list
ATTRIBUTED_GAPS = 400        # longest gaps attributed to a host activity
NAME_CHARS = 120


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _device_events(events, lo=float("-inf"), hi=float("inf")):
    """(start, end, name) in µs of every device operation, clipped to
    [lo, hi]; the host's labels mirrored on the device's row are not
    operations."""
    from torch.autograd import DeviceType
    out = []
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name.startswith("bench."):
            continue
        a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if b > a:
            out.append((a, b, e.name))
    return out


def trace(work: Callable[[], None]) -> Dict[str, Any]:
    """Run ``work`` twice under the profiler, as the module says, and
    reduce. Returns ``busy_s``, ``window_s``, ``device_ops`` and
    ``idle_gaps``; ``busy_s`` is None where the profiler recorded no
    device activity (no card, or no CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        work()
        return {"busy_s": None, "window_s": None, "device_ops": [],
                "idle_gaps": []}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev = _device_events(prof.events())
    if not dev:
        return {"busy_s": None, "window_s": window_s, "device_ops": [],
                "idle_gaps": []}
    busy_s = sum(b - a for a, b in _union([(a, b) for a, b, _ in dev])) * 1e-6
    by_op: Dict[str, float] = defaultdict(float)
    for a, b, name in dev:
        by_op[_short(name)] += (b - a) * 1e-6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_s, "window_s": window_s,
            "device_ops": [[k, v] for k, v in ops],
            "idle_gaps": _idle_gaps(work)}


def _idle_gaps(work: Callable[[], None]) -> List[List[Any]]:
    """The second pass: idle gaps on the device, each put to what the host
    was doing at its middle, summed by that and the longest kept."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            work()
            torch.cuda.synchronize()
    events = list(prof.events())
    win = [e for e in events if e.name == WINDOW
           and e.device_type == DeviceType.CPU]
    if not win:
        return []
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    busy = _union([(a, b) for a, b, _ in _device_events(events, w0, w1)])
    if not busy:
        return []
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU and e.name != WINDOW]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    by_host: Dict[str, float] = defaultdict(float)
    doing = _Host(host)
    for a, b in gaps[:ATTRIBUTED_GAPS]:
        by_host[doing.at((a + b) / 2)] += (b - a) * 1e-6
    rest = sum(b - a for a, b in gaps[ATTRIBUTED_GAPS:]) * 1e-6
    if rest > 0:
        by_host["(shorter gaps)"] += rest
    return [[k, v] for k, v in
            sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]]


class _Host:
    """What the host was doing at a time: the benchmark's own outermost
    label (``bench.*``) and the innermost host event there."""

    def __init__(self, host: List[Tuple[float, float, str]]):
        import numpy as np
        self._np = np
        self.a = np.array([h[0] for h in host], dtype=np.float64)
        self.b = np.array([h[1] for h in host], dtype=np.float64)
        self.names = [h[2] for h in host]
        self.label = np.array([n.startswith("bench.") for n in self.names],
                              dtype=bool)

    def at(self, t: float) -> str:
        np = self._np
        hit = np.nonzero((self.a <= t) & (self.b >= t))[0]
        if hit.size == 0:
            return "(host outside any recorded event)"
        dur = self.b[hit] - self.a[hit]
        inner = self.names[int(hit[np.argmin(dur)])]
        lab = hit[self.label[hit]]
        label = (self.names[int(lab[np.argmax(self.b[lab] - self.a[lab])])]
                 if lab.size else "(no benchmark label)")
        return _short(label if inner == label else f"{label} > {inner}")
