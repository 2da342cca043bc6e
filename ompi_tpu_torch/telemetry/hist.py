"""Log2-bucket HDR-style histograms — the telemetry plane's value type.
The port of ``ompi_tpu/telemetry/hist.py``, line for line: pure Python,
so both packages bucket, merge and derive percentiles identically.

Design constraints (the 3% overhead contract on an 8 B allreduce):

- **Lock-free recording.** Each recording thread owns a private shard
  (``threading.local``); ``record()`` touches only that shard — plain
  list-index increments, atomic under the GIL, no lock, no allocation
  after the first call per thread. The one lock in this module guards
  shard *enrollment* (first record from a new thread) and merge-on-read.
- **Fixed log2 buckets.** Bucket ``b`` holds values whose integer part
  has bit_length ``b`` — i.e. ``[2^(b-1), 2^b)`` for ``b >= 1``, and
  ``{0}`` for bucket 0. 64 buckets cover any latency this stack can
  produce in microseconds; HDR-style relative error is bounded at 2x,
  tightened by in-bucket linear interpolation at percentile time.
- **Merge on read.** ``snapshot()``/``percentile()`` sum the shards
  under the enrollment lock; writers never wait on readers (a reader
  sees each shard's counters at whatever point the GIL serialized —
  monotonically fresh, never torn across the fixed-size int list).

Timer API: ``tok = h.start()`` then ``h.observe(tok)`` records the
elapsed microseconds. ``observe(None)`` is a no-op so the gated idiom
``tok = h.start() if telemetry.active else None`` composes with an
unconditional ``finally``. Every started token reaches ``observe`` in a
``finally``. Timings are host time of the app-visible call: on a CUDA
tensor that is dispatch plus whatever the call waits on, not kernel
completion.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Mapping, Optional

NBUCKETS = 64


class _Shard:
    __slots__ = ("buckets", "count", "sum", "max")

    def __init__(self):
        self.buckets = [0] * NBUCKETS
        self.count = 0
        self.sum = 0.0
        self.max = 0.0


class Histogram:
    """One named histogram with per-thread shards. ``labels`` carry the
    export dimensions (comm/func/sclass for the Prometheus exporter and
    mpitop); ``comm`` tags per-communicator instances for retirement."""

    __slots__ = ("name", "unit", "help", "comm", "labels", "_lock",
                 "_shards", "_tls", "registered")

    def __init__(self, name: str, *, unit: str = "us", help: str = "",
                 comm: Any = None,
                 labels: Optional[Mapping[str, str]] = None):
        self.name = name
        self.unit = unit
        self.help = help
        self.comm = None if comm is None else str(comm)
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._shards: List[_Shard] = []
        self._tls = threading.local()
        # pvar registration is deferred to first record (the registry
        # flips this) so never-hit instruments don't flood pvar_list
        self.registered = False

    # -- recording (hot path) ------------------------------------------
    def _shard(self) -> _Shard:
        sh = getattr(self._tls, "sh", None)
        if sh is None:
            sh = _Shard()
            with self._lock:
                self._shards.append(sh)
            self._tls.sh = sh
        return sh

    def record(self, value: float) -> None:
        """Record one sample (in ``unit``). Negative values clamp to 0
        (clock skew must not corrupt the bucket index)."""
        if not self.registered:
            from ompi_tpu_torch import telemetry as _t
            _t._register_hist_pvar(self)
        v = float(value)
        if v < 0.0:
            v = 0.0
        b = int(v).bit_length()
        if b >= NBUCKETS:
            b = NBUCKETS - 1
        sh = self._shard()
        sh.buckets[b] += 1
        sh.count += 1
        sh.sum += v
        if v > sh.max:
            sh.max = v

    def start(self) -> float:
        """Open a timing sample; returns the token ``observe`` consumes
        (the raw perf_counter — callers may subtract it directly for
        side-channel uses like the health monitor's wait ingress)."""
        return time.perf_counter()

    def observe(self, token: Optional[float]) -> None:
        """Record elapsed microseconds since ``start()``. ``None`` is a
        no-op — the gated-start idiom's disabled branch."""
        if token is None:
            return
        self.record((time.perf_counter() - token) * 1e6)

    # -- merge on read --------------------------------------------------
    def merged(self) -> Dict[str, Any]:
        buckets = [0] * NBUCKETS
        count = 0
        total = 0.0
        mx = 0.0
        with self._lock:
            shards = list(self._shards)
        for sh in shards:
            bs = sh.buckets
            for i in range(NBUCKETS):
                buckets[i] += bs[i]
            count += sh.count
            total += sh.sum
            if sh.max > mx:
                mx = sh.max
        return {"buckets": buckets, "count": count, "sum": total,
                "max": mx}

    def percentile(self, p: float,
                   merged: Optional[Dict[str, Any]] = None) -> float:
        m = self.merged() if merged is None else merged
        return percentile_from_buckets(m["buckets"], m["count"], p)

    def snapshot(self) -> Dict[str, Any]:
        """The pvar read value: merged counters plus derived
        percentiles; ``buckets`` is sparse ({index: count}) for compact
        JSON round-tripping."""
        m = self.merged()
        return {
            "count": m["count"],
            "sum": round(m["sum"], 3),
            "max": round(m["max"], 3),
            "p50": round(self.percentile(50, m), 3),
            "p90": round(self.percentile(90, m), 3),
            "p99": round(self.percentile(99, m), 3),
            "unit": self.unit,
            "buckets": {str(i): n for i, n in enumerate(m["buckets"])
                        if n},
        }

    def reset(self) -> None:
        """Zero every shard in place (a new measurement window; shards
        stay enrolled so recording threads keep their references)."""
        with self._lock:
            shards = list(self._shards)
        for sh in shards:
            sh.buckets = [0] * NBUCKETS
            sh.count = 0
            sh.sum = 0.0
            sh.max = 0.0


def bucket_bounds(index: int) -> tuple:
    """[lo, hi) value range of one bucket."""
    if index <= 0:
        return (0.0, 1.0)
    return (float(1 << (index - 1)), float(1 << index))


def percentile_from_buckets(buckets, count: int, p: float) -> float:
    """Derive a percentile from (possibly merged) log2 buckets with
    linear interpolation inside the landing bucket. Accepts either the
    dense list or the sparse {index: count} snapshot form."""
    if count <= 0:
        return 0.0
    if isinstance(buckets, Mapping):
        dense = [0] * NBUCKETS
        for k, n in buckets.items():
            i = int(k)
            if 0 <= i < NBUCKETS:
                dense[i] += int(n)
        buckets = dense
    target = max(1.0, (p / 100.0) * count)
    cum = 0
    for i, n in enumerate(buckets):
        if not n:
            continue
        if cum + n >= target:
            lo, hi = bucket_bounds(i)
            frac = (target - cum) / n
            return lo + frac * (hi - lo)
        cum += n
    lo, hi = bucket_bounds(NBUCKETS - 1)
    return hi


def merge_snapshots(snaps) -> Dict[str, Any]:
    """Combine several ``snapshot()`` dicts (different ranks/shards of
    the same logical metric) into one: summed buckets/count/sum, max of
    max, re-derived percentiles. The mpitop/tracedump merge primitive."""
    buckets = [0] * NBUCKETS
    count = 0
    total = 0.0
    mx = 0.0
    unit = "us"
    for s in snaps:
        if not s:
            continue
        unit = s.get("unit", unit)
        count += int(s.get("count", 0))
        total += float(s.get("sum", 0.0))
        mx = max(mx, float(s.get("max", 0.0)))
        for k, n in (s.get("buckets") or {}).items():
            i = int(k)
            if 0 <= i < NBUCKETS:
                buckets[i] += int(n)
    return {
        "count": count, "sum": round(total, 3), "max": round(mx, 3),
        "p50": round(percentile_from_buckets(buckets, count, 50), 3),
        "p90": round(percentile_from_buckets(buckets, count, 90), 3),
        "p99": round(percentile_from_buckets(buckets, count, 99), 3),
        "unit": unit,
        "buckets": {str(i): n for i, n in enumerate(buckets) if n},
    }
