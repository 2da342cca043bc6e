"""Failure detection and propagation — the ULFM runtime plane.

Behavioral spec: the reference's ULFM support (``docs/features/ulfm.rst``)
detects process failure through PMIx/PRRTE events and propagates it to
every layer: requests complete with ``MPI_ERR_PROC_FAILED``
(``ompi/request/req_ft.c``), collectives bail out, revocation spreads via
a reliable broadcast (``ompi/mca/coll/base/coll_base_revoke_local.c``),
and the pml exposes a ``revoke_comm`` hook (``ompi/mca/pml/pml.h:244``).

The port of ``ompi_tpu/runtime/ft.py``. The "process" is a rank bound
to a torch device. Failure events come from a device health probe (a
tiny op on each rank's device, read back to the host: a failed card
surfaces as a CUDA error), the per-rank tier's detectors (an identified
connection's EOF, the ring heartbeat) and explicit injection (the
test surface). A :class:`Registry` is the source of truth a stack
consults: communicator collectives, the pt2pt matching engine, and the
ftagree component all read their communicator's registry. The
module-level functions operate on the process-wide default registry (the
World Process Model); MPI-4 Sessions own private registries
(``instance.c:361-720`` — per-instance state), so failure knowledge
injected in one session never bleeds into another. Epochs order failure
knowledge the way PMIx event sequence numbers do.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, FrozenSet, List, NamedTuple


class FailureEvent(NamedTuple):
    """One epoch-ordered failure record (the PMIx event payload shape:
    who, why, when, and the sequence number ordering the knowledge)."""
    rank: int
    reason: str
    epoch: int
    timestamp: float


class Registry:
    """One failure-knowledge domain (per instance/session)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._failed: Dict[int, str] = {}      # world rank -> reason
        self._epoch = 0
        self._events: List[FailureEvent] = []
        self._listeners: List[Callable[[int, str], None]] = []
        # last failure-detection latency in microseconds (written by the
        # heartbeat detector, read by the ft_detect_latency_us pvar)
        self.detect_latency_us = 0

    def fail_rank(self, world_rank: int, reason: str = "injected") -> None:
        """Report rank failure (detector ingress + fault injection)."""
        with self._lock:
            if world_rank in self._failed:
                return
            self._failed[world_rank] = reason
            self._epoch += 1
            self._events.append(FailureEvent(world_rank, reason,
                                             self._epoch, time.time()))
            listeners = list(self._listeners)
        for cb in listeners:
            cb(world_rank, reason)

    def any_failed(self) -> bool:
        """Fast-path check for the per-call FT guards (hot path: every
        collective entry)."""
        return bool(self._failed)

    def is_failed(self, world_rank: int) -> bool:
        return world_rank in self._failed

    def failed_ranks(self) -> FrozenSet[int]:
        with self._lock:
            return frozenset(self._failed)

    def failure_reason(self, world_rank: int) -> str:
        return self._failed.get(world_rank, "")

    def epoch(self) -> int:
        return self._epoch

    def events(self) -> List[FailureEvent]:
        """Epoch-ordered failure history (MPIX get_failed's ordering
        contract: later knowledge never reorders earlier events)."""
        with self._lock:
            return list(self._events)

    def add_listener(self, cb: Callable[[int, str], None]) -> None:
        """Register a failure-event callback (the PMIx event-handler
        role)."""
        with self._lock:
            self._listeners.append(cb)

    def remove_listener(self, cb: Callable[[int, str], None]) -> None:
        """Deregister (router/detector teardown — a listener surviving
        its owner would fire into a closed object on the next event)."""
        with self._lock:
            if cb in self._listeners:
                self._listeners.remove(cb)

    def probe_devices(self, devices, world_ranks=None) -> List[int]:
        """Health-check each rank's device with a trivial computation;
        mark ranks whose device errors as failed. Returns newly failed
        *world* ranks. ``world_ranks[i]`` is the world rank owning
        ``devices[i]`` (identity when omitted — correct only for
        COMM_WORLD-shaped device lists).

        The probe really touches the device: a 1-element tensor made on
        it, incremented there, and read back with ``.item()`` (which
        synchronizes a CUDA device). Any exception marks the rank failed
        with ``"device probe: <type>"``; the probe never moves the rank
        to another device."""
        import torch
        if world_ranks is None:
            world_ranks = range(len(devices))
        newly = []
        for w, d in zip(world_ranks, devices):
            if self.is_failed(w):
                continue
            try:
                x = torch.ones((1,), dtype=torch.float32,
                               device=torch.device(d))
                if float((x + 1.0).item()) != 2.0:
                    raise RuntimeError("device returned a wrong value")
            except Exception as e:      # noqa: BLE001 — any device error
                self.fail_rank(w, f"device probe: {type(e).__name__}")
                newly.append(w)
        return newly

    def _reset(self) -> None:
        with self._lock:
            self._failed.clear()
            self._listeners.clear()
            self._events.clear()
            self._epoch = 0
            self.detect_latency_us = 0


# -- process-wide default domain (World Process Model) ---------------------
_default = Registry()


def default_registry() -> Registry:
    return _default


def fail_rank(world_rank: int, reason: str = "injected") -> None:
    _default.fail_rank(world_rank, reason)


def any_failed() -> bool:
    return _default.any_failed()


def is_failed(world_rank: int) -> bool:
    return _default.is_failed(world_rank)


def failed_ranks() -> FrozenSet[int]:
    return _default.failed_ranks()


def failure_reason(world_rank: int) -> str:
    return _default.failure_reason(world_rank)


def epoch() -> int:
    return _default.epoch()


def add_listener(cb: Callable[[int, str], None]) -> None:
    _default.add_listener(cb)


def remove_listener(cb: Callable[[int, str], None]) -> None:
    _default.remove_listener(cb)


def events() -> List[FailureEvent]:
    return _default.events()


def probe_devices(devices, world_ranks=None) -> List[int]:
    return _default.probe_devices(devices, world_ranks)


def _reset_for_tests() -> None:
    _default._reset()
