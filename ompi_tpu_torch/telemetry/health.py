"""telemetry/health — the straggler health monitor (the port of
``ompi_tpu/telemetry/health.py``).

A serving fleet's question is not "did rank 3 die" (the ft detector's
job) but "is rank 3 *slow*, and how slow, right now". This monitor
maintains rolling windows of peer-attributable delay and scores them:

- **recv-wait ingress** (pml recv completion): how long this rank sat
  blocked on each peer. Waits are scored against the cross-peer median
  of the same window — a straggler is an *outlier among peers*, so a
  uniformly slow phase (everyone computing) scores nobody.
- **heartbeat-gap ingress** (ft detector): inter-arrival gap of the
  ring predecessor's heartbeats beyond the configured period — the
  signal that works even when no data-plane traffic flows.

The **straggler score** of a peer is its excess blocked-seconds per
second of window (dimensionless; 0.2 means "this peer cost me 200 ms
of outlier wait per second"). Scores at or above
``mpi_base_telemetry_straggler_score`` make the peer a SUSPECT;
``mpi_base_telemetry_straggler_miss`` consecutive suspect samples
declare it — the ft detector's suspect->declare hysteresis, reused so
a one-off GC pause raises the score and then clears without paging.
Declaration fires the ``telemetry.straggler`` hook event, a trace
instant, and a flight-recorder snapshot; a declared peer whose score
falls below half the threshold is cleared (``telemetry.recovered``)
and may be re-declared later.

``telemetry.degraded`` is the self-health half: fired when this rank's
OWN pml send p99 exceeds ``mpi_base_telemetry_degraded_ms`` — the
"I am the straggler" signal (blocked-waiting is deliberately excluded
from self-slowness, mirroring the attribution layer's blocked vs in-op
split: waiting is the victim's symptom, not the straggler's).

Sampling is driven two ways: a low-priority progress callback (the
stacked/nbc spin loops) and opportunistic rate-limited ticks from the
ingress paths themselves (per-rank blocking waits don't spin the
progress engine) — both funnel into ``sample()``, which also takes a
synthetic clock for the hysteresis unit tests.
"""
from __future__ import annotations

import statistics
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from torch.autograd import profiler as _prof

from ompi_tpu_torch.mca import var as _var
from ompi_tpu_torch.trace import core as _trace


class HealthMonitor:
    def __init__(self, rank: int, nprocs: int, *,
                 sample_s: Optional[float] = None,
                 window_s: Optional[float] = None,
                 threshold: Optional[float] = None,
                 miss: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        from ompi_tpu_torch import telemetry as _t
        _t.register_params()
        self.rank = int(rank)
        self.nprocs = int(nprocs)
        self.sample_s = (float(_var.var_get("mpi_base_telemetry_sample_s",
                                            0.25))
                         if sample_s is None else float(sample_s))
        self.window_s = (float(_var.var_get("mpi_base_telemetry_window_s",
                                            5.0))
                         if window_s is None else float(window_s))
        self.threshold = (float(_var.var_get(
            "mpi_base_telemetry_straggler_score", 0.05))
            if threshold is None else float(threshold))
        self.miss = (int(_var.var_get("mpi_base_telemetry_straggler_miss",
                                      3))
                     if miss is None else int(miss))
        self.degraded_ms = float(_var.var_get(
            "mpi_base_telemetry_degraded_ms", 0.0))
        self._clock = clock
        self._lock = threading.Lock()
        self._waits: Dict[int, deque] = {}    # peer -> (t, wait_s)
        self._excess: Dict[int, deque] = {}   # peer -> (t, excess_s)
        self._misses: Dict[int, int] = {}
        self._scores: Dict[int, float] = {}
        self._declared: set = set()
        self._degraded = False
        self._last_sample = 0.0
        self.stats = {"samples": 0, "stragglers": 0, "recovered": 0,
                      "degraded": 0}
        self._pvars_registered = False

    # -- ingress (hot paths, gated on telemetry.active by callers) -----
    def note_wait(self, peer: int, wait_s: float) -> None:
        """pml recv completed after ``wait_s`` blocked on ``peer``."""
        if peer == self.rank or peer < 0:
            return
        now = self._clock()
        with self._lock:
            q = self._waits.get(peer)
            if q is None:
                q = self._waits[peer] = deque(maxlen=4096)
            q.append((now, float(wait_s)))
        self.maybe_sample(now)

    def note_heartbeat_gap(self, peer: int, gap_s: float,
                           period_s: float) -> None:
        """Ring heartbeat from ``peer`` arrived ``gap_s`` after the
        previous one; anything beyond 1.5 periods is excess."""
        excess = float(gap_s) - 1.5 * float(period_s)
        if excess <= 0.0 or peer == self.rank:
            return
        now = self._clock()
        with self._lock:
            q = self._excess.get(peer)
            if q is None:
                q = self._excess[peer] = deque(maxlen=4096)
            q.append((now, excess))
        self.maybe_sample(now)

    # -- scoring -------------------------------------------------------
    def maybe_sample(self, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        if now - self._last_sample >= self.sample_s:
            self.sample(now)

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        for table in (self._waits, self._excess):
            for q in table.values():
                while q and q[0][0] < horizon:
                    q.popleft()

    def sample(self, now: Optional[float] = None) -> Dict[int, float]:
        """One scoring pass; returns the per-peer scores. Separated
        from the progress callback (and clock-injectable) for the
        hysteresis unit tests — the ft detector's check_once shape."""
        now = self._clock() if now is None else now
        declare: List[tuple] = []
        recover: List[tuple] = []
        with self._lock:
            self._last_sample = now
            self.stats["samples"] += 1
            self._prune(now)
            all_waits = [w for q in self._waits.values()
                         for _, w in q]
            med = (statistics.median(all_waits)
                   if len(self._waits) >= 2 and all_waits else 0.0)
            peers = set(self._waits) | set(self._excess)
            scores: Dict[int, float] = {}
            for peer in peers:
                excess = sum(max(0.0, w - med)
                             for _, w in self._waits.get(peer, ()))
                excess += sum(e for _, e in self._excess.get(peer, ()))
                scores[peer] = round(excess / self.window_s, 6)
            self._scores = scores
            for peer, score in scores.items():
                if score >= self.threshold:
                    n = self._misses.get(peer, 0) + 1
                    self._misses[peer] = n
                    if n >= self.miss and peer not in self._declared:
                        self._declared.add(peer)
                        self.stats["stragglers"] += 1
                        declare.append((peer, score))
                else:
                    self._misses[peer] = 0
                    if peer in self._declared \
                            and score < self.threshold / 2.0:
                        self._declared.discard(peer)
                        self.stats["recovered"] += 1
                        recover.append((peer, score))
        for peer, score in declare:
            self._fire("telemetry.straggler", peer, score)
        for peer, score in recover:
            self._fire("telemetry.recovered", peer, score)
        self._check_degraded()
        return scores

    def _fire(self, event: str, peer: int, score: float) -> None:
        from ompi_tpu_torch.utils import hooks as _hooks
        info = {"rank": peer, "by": self.rank, "score": score,
                "threshold": self.threshold}
        _hooks.fire(event, None, info)
        if _trace.active or _prof._is_profiler_enabled:
            _trace.instant(event, rank=peer, by=self.rank, score=score)
        if event == "telemetry.straggler":
            from ompi_tpu_torch.telemetry import flightrec as _flightrec
            _flightrec.record("straggler", info)

    def _check_degraded(self) -> None:
        if self.degraded_ms <= 0.0:
            return
        from ompi_tpu_torch import telemetry as _t
        own_hist = _t.PML_SEND
        if own_hist is None:
            return
        p99_us = own_hist.percentile(99)
        over = p99_us > self.degraded_ms * 1000.0
        fire = False
        with self._lock:
            if over and not self._degraded:
                self._degraded = True
                self.stats["degraded"] += 1
                fire = True
            elif not over:
                self._degraded = False
        if fire:
            from ompi_tpu_torch.utils import hooks as _hooks
            _hooks.fire("telemetry.degraded", None,
                        {"rank": self.rank, "p99_us": round(p99_us, 1),
                         "limit_ms": self.degraded_ms})

    # -- surfaces ------------------------------------------------------
    def scores(self) -> Dict[int, float]:
        with self._lock:
            return dict(self._scores)

    def declared(self) -> List[int]:
        with self._lock:
            return sorted(self._declared)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"scores": {str(p): s
                               for p, s in self._scores.items()},
                    "declared": sorted(self._declared),
                    "misses": {str(p): n
                               for p, n in self._misses.items() if n},
                    "stats": dict(self.stats)}

    # -- wiring --------------------------------------------------------
    def _progress_cb(self) -> int:
        self.maybe_sample()
        return 0

    def _register_pvars(self) -> None:
        if self._pvars_registered:
            return
        self._pvars_registered = True
        from ompi_tpu_torch.mca import pvar
        pvar.pvar_register(
            "tele_straggler_scores", self.scores,
            unit="ratio", var_class="level",
            help="Per-peer straggler score (excess blocked-seconds per "
                 "second of window; telemetry/health)")
        pvar.pvar_register(
            "tele_stragglers", lambda: self.stats["stragglers"],
            help="telemetry.straggler declarations fired by this "
                 "rank's health monitor")
        pvar.pvar_register(
            "tele_degraded", lambda: self.stats["degraded"],
            help="telemetry.degraded episodes (own pml send p99 over "
                 "mpi_base_telemetry_degraded_ms)")


_monitor: Optional[HealthMonitor] = None


def install(rank: int, nprocs: int, **kw) -> HealthMonitor:
    """Create and wire the process-wide monitor: pvars + a low-priority
    progress callback (ingress paths also tick it — per-rank blocking
    waits don't spin the progress engine)."""
    global _monitor
    uninstall()
    mon = HealthMonitor(rank, nprocs, **kw)
    mon._register_pvars()
    from ompi_tpu_torch.runtime import progress as _progress
    _progress.register(mon._progress_cb, low_priority=True)
    _monitor = mon
    return mon


def uninstall() -> None:
    global _monitor
    mon = _monitor
    if mon is None:
        return
    _monitor = None
    from ompi_tpu_torch.runtime import progress as _progress
    _progress.unregister(mon._progress_cb)


def monitor() -> Optional[HealthMonitor]:
    return _monitor


def note_wait(peer: int, wait_s: float) -> None:
    mon = _monitor
    if mon is not None:
        mon.note_wait(peer, wait_s)


def note_heartbeat_gap(peer: int, gap_s: float, period_s: float) -> None:
    mon = _monitor
    if mon is not None:
        mon.note_heartbeat_gap(peer, gap_s, period_s)


def scores_snapshot() -> Dict[str, Any]:
    mon = _monitor
    return mon.snapshot() if mon is not None else {}
