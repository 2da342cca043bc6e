"""ft/detector — ring heartbeat failure detection (the port of
``ompi_tpu/ft/detector.py``).

Behavioral spec: the PRRTE daemon's liveness plane — each daemon
watches its ring neighbor and PMIx fans the obituary out (the role
``docs/features/ulfm.rst`` assigns to the runtime). The reference MPI
library itself never runs a detector; it TRUSTS the launcher. Our
per-rank world has no daemon, so the detector rides the library's own
ctl plane: rank ``r`` heartbeats its live ring successor every
``mpi_base_ft_hb_period`` seconds and watches its live ring
predecessor; a predecessor silent past ``mpi_base_ft_hb_timeout`` for
``mpi_base_ft_hb_miss`` consecutive checks (the hysteresis that keeps
a GC pause or an injected sub-timeout delay from reading as a death —
the false-positive contract) is declared failed
into :mod:`ompi_tpu_torch.runtime.ft`'s registry, whose listener plane
(Router) spreads the obituary as a reliable ``ftdead`` broadcast.

Complementary ingress: the btl/tcp connection monitor (an identified
peer's EOF) usually reports a real death FIRST — both paths funnel
through ``Registry.fail_rank``, which dedups. The detector's value is
the case EOF cannot see: a wedged-but-connected peer, and a peer
whose connections were never established. Detection latency (time
since the victim was last known alive, minus one period) is recorded
on the registry whatever the ingress and surfaced as the
``ft_detect_latency_us`` pvar; the drills assert it under 2x the
configured timeout.

On the card, eight rank processes time-slice one device: a rank inside
``torch.cuda.synchronize()`` still beats, because the duty cycle runs on
its own thread and the wait releases the GIL. A job that expects long
host folds sets ``mpi_base_ft_hb_timeout``/``_miss`` to cover them.

Off by default (``period = 0``): zero threads, zero frames, zero
clock reads — the subsystem gate the injection plane also follows.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from torch.autograd import profiler as _prof

from ompi_tpu_torch.mca import var as _var
from ompi_tpu_torch.trace import core as _trace

# the wall-clock check cadence is the heartbeat period itself: one
# thread wake per period covers both emit and check duties


def register_params() -> None:
    _var.var_register(
        "mpi", "base", "ft_hb_period", vtype="float", default=0.0,
        help="Ring heartbeat period in seconds; 0 disables the "
             "detector entirely (no thread, no frames) — the btl "
             "connection monitor remains the EOF-based ingress")
    _var.var_register(
        "mpi", "base", "ft_hb_timeout", vtype="float", default=2.0,
        help="Silence past this many seconds makes the watched "
             "predecessor a SUSPECT (declaration additionally needs "
             "ft_hb_miss consecutive suspect checks)")
    _var.var_register(
        "mpi", "base", "ft_hb_miss", vtype="int", default=3,
        help="Consecutive suspect checks before a suspect is declared "
             "failed — the hysteresis that keeps sub-timeout delays "
             "from reading as deaths")


class Detector:
    """One per process. ``send_hb(peer)`` is the transport (unsequenced
    ctl frame); the registry is the failure-knowledge sink."""

    def __init__(self, rank: int, nprocs: int,
                 send_hb: Callable[[int], None], registry, *,
                 period: Optional[float] = None,
                 timeout: Optional[float] = None,
                 miss: Optional[int] = None):
        register_params()
        self.rank = rank
        self.nprocs = nprocs
        self._send_hb = send_hb
        self._reg = registry
        self.period = (float(_var.var_get("mpi_base_ft_hb_period", 0.0))
                       if period is None else float(period))
        self.timeout = (float(_var.var_get("mpi_base_ft_hb_timeout", 2.0))
                        if timeout is None else float(timeout))
        self.miss = (int(_var.var_get("mpi_base_ft_hb_miss", 3))
                     if miss is None else int(miss))
        self.stats: Dict[str, int] = {"heartbeats": 0, "suspects": 0,
                                      "detect_latency_us": 0,
                                      "declared": 0}
        # optional rank -> bool predicate: ranks that announced a
        # GRACEFUL departure (the router's 'bye' set) rotate out of the
        # ring instead of being declared dead — the same false-obituary
        # suppression the EOF monitor applies
        self.departed: Optional[Callable[[int], bool]] = None
        self._lock = threading.Lock()
        self._last_seen: Dict[int, float] = {}
        self._misses = 0
        self._watched: Optional[int] = None
        self._suspect_tok = None         # open ft.suspect trace span
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started_at = 0.0

    # -- ring geometry over the CURRENT live set -----------------------
    def _live(self):
        failed = self._reg.failed_ranks()
        gone = self.departed
        return [r for r in range(self.nprocs)
                if r == self.rank
                or (r not in failed
                    and not (gone is not None and gone(r)))]

    def successor(self) -> Optional[int]:
        live = self._live()
        if len(live) < 2:
            return None
        i = live.index(self.rank)
        return live[(i + 1) % len(live)]

    def predecessor(self) -> Optional[int]:
        live = self._live()
        if len(live) < 2:
            return None
        i = live.index(self.rank)
        return live[(i - 1) % len(live)]

    # -- ingress (Router._deliver's "hb" ctl frames) -------------------
    def on_heartbeat(self, src: int) -> None:
        now = time.monotonic()
        tok = None
        with self._lock:
            self.stats["heartbeats"] += 1
            prev = self._last_seen.get(src)
            self._last_seen[src] = now
            if src == self._watched and self._misses:
                # the suspect came back: hysteresis did its job
                self._misses = 0
                self.stats["suspects"] = 0
                tok, self._suspect_tok = self._suspect_tok, None
        if tok is not None:
            _trace.end(tok, declared=False)
        from ompi_tpu_torch import telemetry as _tele
        if _tele.active and prev is not None:
            # telemetry ingress: the inter-arrival gap feeds both the
            # gap histogram and the health monitor's excess scoring
            # (beyond 1.5 periods) — the no-data-plane straggler signal
            gap = now - prev
            hist = _tele.HB_GAP
            if hist is not None:
                hist.record(gap * 1e6)
            from ompi_tpu_torch.telemetry import health as _health
            _health.note_heartbeat_gap(src, gap, self.period)

    def record_latency(self, rank: int, _reason: str) -> None:
        """Registry listener: whatever ingress reported the death
        (EOF monitor or this detector), detection latency is the time
        since the victim was last KNOWN alive, less one period (the
        beat it was allowed to still have in flight)."""
        now = time.monotonic()
        with self._lock:
            seen = self._last_seen.get(rank, self._started_at or now)
            lat_us = int(max(0.0, (now - seen - self.period)) * 1e6)
            self.stats["detect_latency_us"] = lat_us
        self._reg.detect_latency_us = lat_us

    # -- the periodic duty cycle ---------------------------------------
    def check_once(self, now: Optional[float] = None) -> Optional[int]:
        """One emit+check tick (separated from the thread loop for the
        hysteresis unit tests). Returns a newly declared rank or
        None."""
        now = time.monotonic() if now is None else now
        succ = self.successor()
        if succ is not None:
            try:
                self._send_hb(succ)
            except Exception:            # noqa: BLE001 — a dying
                pass                     # successor is the EOF
            #                              monitor's business
        pred = self.predecessor()
        declared: Optional[int] = None
        end_tok = None
        with self._lock:
            if pred != self._watched:
                # ring repair (first tick, or the old predecessor was
                # declared elsewhere): restart the silence clock
                self._watched = pred
                self._misses = 0
                self.stats["suspects"] = 0
                if pred is not None:
                    self._last_seen.setdefault(pred, now)
            if pred is None:
                return None
            seen = self._last_seen.get(pred, now)
            if now - seen <= self.timeout:
                if self._misses:
                    self._misses = 0
                    self.stats["suspects"] = 0
                    end_tok, self._suspect_tok = self._suspect_tok, None
            else:
                self._misses += 1
                self.stats["suspects"] = 1
                if self._misses == 1 and (
                        _trace.active or _prof._is_profiler_enabled):
                    self._suspect_tok = _trace.begin(
                        "ft.suspect", rank=pred, by=self.rank)
                if self._misses >= self.miss:
                    declared = pred
                    self._misses = 0
                    self.stats["suspects"] = 0
                    self.stats["declared"] += 1
                    end_tok, self._suspect_tok = self._suspect_tok, None
        if end_tok is not None:
            _trace.end(end_tok, declared=declared is not None)
        if declared is not None:
            if _trace.active or _prof._is_profiler_enabled:
                _trace.instant("ft.declare", rank=declared,
                               by=self.rank)
            self._reg.fail_rank(declared, "heartbeat timeout")
        return declared

    def _loop(self) -> None:
        while not self._stop.wait(self.period):
            try:
                self.check_once()
            except Exception:            # noqa: BLE001 — the detector
                pass                     # must outlive transient wire
            #                              errors; EOFs have their own
            #                              ingress

    def start(self) -> bool:
        """Spawn the duty-cycle thread; False when disabled (period
        0) or trivially complete (single-rank world)."""
        if self.period <= 0 or self.nprocs < 2:
            return False
        self._started_at = time.monotonic()
        self._reg.add_listener(self.record_latency)
        self._register_pvars()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"ft-detector-{self.rank}")
        self._thread.start()
        return True

    def stop(self) -> None:
        self._stop.set()
        self._reg.remove_listener(self.record_latency)
        t = self._thread
        if t is not None:
            t.join(timeout=2 * max(self.period, 0.05))
            self._thread = None

    def _register_pvars(self) -> None:
        from ompi_tpu_torch.mca import pvar
        pvar.pvar_register(
            "ft_heartbeats", lambda: self.stats["heartbeats"],
            help="Ring heartbeats received by this rank's detector")
        pvar.pvar_register(
            "ft_suspects", lambda: self.stats["suspects"],
            var_class="level",
            help="1 while the watched predecessor is past "
                 "ft_hb_timeout but not yet past the ft_hb_miss "
                 "hysteresis, else 0")
        pvar.pvar_register(
            "ft_detect_latency_us",
            lambda: self._reg.detect_latency_us, unit="us",
            var_class="level",
            help="Last failure's detection latency: time since the "
                 "victim was last known alive less one heartbeat "
                 "period, whichever ingress (EOF monitor or "
                 "heartbeat declaration) reported it first")
