"""The progress engine — mirrors ``opal/runtime/opal_progress.c``.

Reference behavior: a flat array of registered callbacks
(``opal_progress.c:58-65``) spun by every blocking wait (``:216``) and a
low-priority list for rarely-needed progress.

A CUDA stream runs queued work without host help, so the engine's job is
what libnbc uses it for: advancing host-side state machines — the
round-by-round dispatch of ``coll/nbc`` schedules and the idle sweep of
``coll/persistent``'s bucket fuser. ``progress()`` runs every registered
callback once (the low-priority ones every ``_LOW_EVERY``-th spin) and
returns the number of events they reported. The port of
``ompi_tpu/runtime/progress.py:22-52``; the wake-batch half belongs to
the per-rank tier.
"""
from __future__ import annotations

from typing import Callable, List

_callbacks: List[Callable[[], int]] = []
_low_priority: List[Callable[[], int]] = []
_low_tick = 0
_LOW_EVERY = 8          # low-priority cbs run every Nth spin (opal's idea)


def register(cb: Callable[[], int], low_priority: bool = False) -> None:
    (_low_priority if low_priority else _callbacks).append(cb)


def unregister(cb: Callable[[], int]) -> None:
    for lst in (_callbacks, _low_priority):
        if cb in lst:
            lst.remove(cb)


def progress() -> int:
    """One spin: run every callback, return total events produced."""
    global _low_tick
    events = 0
    for cb in list(_callbacks):
        events += int(cb() or 0)
    _low_tick += 1
    if _low_priority and _low_tick % _LOW_EVERY == 0:
        for cb in list(_low_priority):
            events += int(cb() or 0)
    return events


def callback_count() -> int:
    return len(_callbacks) + len(_low_priority)


def _reset_for_tests() -> None:
    global _low_tick
    _callbacks.clear()
    _low_priority.clear()
    _low_tick = 0
