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
``ompi_tpu/runtime/progress.py``.

The per-rank tier adds the wake batch (below): btl delivery loops defer
the ``Event.set`` of every match they complete and flush them once at the
end of the drain, instead of one cross-thread wake per frame.
"""
from __future__ import annotations

import threading
from typing import Callable, List

from torch.autograd import profiler as _prof

from ompi_tpu_torch.trace import core as _trace

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


# -- wakeup coalescing ---------------------------------------------------
# Delivery loops open a wake batch; completions inside it are deferred and
# deduplicated by Event identity, and the outermost ``wake_end`` sets each
# once. Batches nest (the sm ring drain runs inside the bml's ordered
# drain). Outside a batch ``wake`` sets the Event at once, so an isolated
# frame keeps its latency. The counters are the MPI_T pvars
# ``pml_wakeups``, ``pml_completions``, ``pml_frames_delivered`` and
# ``pml_frames_per_wakeup``.
_wake_tls = threading.local()
_wake_lock = threading.Lock()
_wake_stats = {"wakeups": 0, "completions": 0, "frames": 0, "batches": 0}


def wake_begin() -> None:
    """Open (or nest into) this thread's wake batch."""
    depth = getattr(_wake_tls, "depth", 0)
    if depth == 0:
        _wake_tls.events = {}
        _wake_tls.frames = 0
        _wake_tls.completions = 0
    _wake_tls.depth = depth + 1


def wake_note_frame(n: int = 1) -> None:
    """Count ``n`` delivered frames against the open batch (or the
    totals, outside one)."""
    if getattr(_wake_tls, "depth", 0):
        _wake_tls.frames += n
    else:
        with _wake_lock:
            _wake_stats["frames"] += n


def wake(event: threading.Event) -> None:
    """Complete a waiter: defer into the open batch, or set now."""
    if getattr(_wake_tls, "depth", 0):
        _wake_tls.events[id(event)] = event
        _wake_tls.completions += 1
        return
    event.set()
    with _wake_lock:
        _wake_stats["wakeups"] += 1
        _wake_stats["completions"] += 1


def wake_end() -> None:
    """Close the batch; the outermost close sets every deferred Event
    exactly once."""
    depth = getattr(_wake_tls, "depth", 0)
    if depth > 1:
        _wake_tls.depth = depth - 1
        return
    _wake_tls.depth = 0
    events = getattr(_wake_tls, "events", {})
    frames = getattr(_wake_tls, "frames", 0)
    completions = getattr(_wake_tls, "completions", 0)
    _wake_tls.events = {}
    for ev in events.values():
        ev.set()
    with _wake_lock:
        _wake_stats["wakeups"] += len(events)
        _wake_stats["completions"] += completions
        _wake_stats["frames"] += frames
        _wake_stats["batches"] += 1
    # a timeline marker per flushed batch; two attribute reads when the
    # tracer is disarmed
    if (events or frames) and (_trace.active
                               or _prof._is_profiler_enabled):
        _trace.instant("pml_wakeup_flush", wakeups=len(events),
                       completions=completions, frames=frames)


def wake_stats() -> dict:
    with _wake_lock:
        return dict(_wake_stats)


def _register_wake_pvars() -> None:
    from ompi_tpu_torch.mca import pvar
    pvar.pvar_register(
        "pml_wakeups", lambda: wake_stats()["wakeups"],
        help="Event.set calls flushed by the delivery path (one per "
             "drain batch, not per frame)")
    pvar.pvar_register(
        "pml_completions", lambda: wake_stats()["completions"],
        help="Matches and acks completed by the delivery path")
    pvar.pvar_register(
        "pml_frames_delivered", lambda: wake_stats()["frames"],
        help="Frames that crossed a btl delivery loop")
    pvar.pvar_register(
        "pml_frames_per_wakeup",
        lambda: round(wake_stats()["frames"]
                      / max(wake_stats()["wakeups"], 1), 3),
        unit="ratio", var_class="level",
        help="Delivered frames per flushed wakeup (1.0 = one wake per "
             "frame)")


_register_wake_pvars()


def _reset_for_tests() -> None:
    global _low_tick
    _callbacks.clear()
    _low_priority.clear()
    _low_tick = 0
    with _wake_lock:
        for k in _wake_stats:
            _wake_stats[k] = 0
