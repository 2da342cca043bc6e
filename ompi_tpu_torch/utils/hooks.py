"""Profiling interposition — the PMPI re-design (the port of
``ompi_tpu/utils/hooks.py``).

The reference generates every binding twice (``MPI_*`` weak-aliased over
``PMPI_*``, ``ompi/mpi/c/Makefile.am:43,522-533``) so tools interpose by
defining ``MPI_*``. In Python the same capability is an explicit hook
chain: ``register_profiler(fn)`` installs ``fn(event, comm, info)``
callbacks fired at every collective/pt2pt entry — the MPI_T events /
PERUSE instrumentation point (``ompi/peruse``)."""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List

_lock = threading.Lock()
_hooks: List[Callable[[str, Any, Dict[str, Any]], None]] = []

# Event-name registry backing the MPI_T events API (``MPI_T_event_*``,
# ``ompi/mpi/tool/events.c`` semantics): the event types a tool can bind
# handlers to. Components pre-declare theirs; names are also learned
# dynamically the first time they fire. Registration order is the index
# space — MPI_T requires an event-type index to stay valid once handed
# out, so this is an append-only list (never sorted, never compacted).
_known_events: List[str] = [
    "coll_allreduce", "coll_reduce", "coll_bcast", "coll_allgather",
    "coll_gather", "coll_scatter", "coll_alltoall",
    "coll_reduce_scatter_block", "coll_scan", "coll_exscan",
    "coll_barrier", "pml_send", "pml_recv",
]
_known_event_set = set(_known_events)


def declare_event(name: str) -> None:
    with _lock:
        if name not in _known_event_set:
            _known_event_set.add(name)
            _known_events.append(name)


def known_events() -> List[str]:
    with _lock:
        return list(_known_events)


def register_profiler(fn: Callable[[str, Any, Dict[str, Any]], None]):
    """Install a profiling hook; returns a handle for unregister."""
    with _lock:
        _hooks.append(fn)
    return fn


def unregister_profiler(handle) -> None:
    with _lock:
        try:
            _hooks.remove(handle)
        except ValueError:
            pass


# Dropped-callback accounting: a raising profiler must not break
# communication, but silently eating its exceptions made tool bugs
# undiagnosable (and MPI_T's event-handle ``dropped`` count was never
# incremented). Every swallowed exception is now counted globally
# (pvar ``hooks_dropped``) and the FIRST failure of each hook logs its
# traceback once — later failures of the same hook stay silent.
_drop_lock = threading.Lock()
_dropped_total = 0
_logged_hooks: set = set()               # id(hook) already tracebacked


def _count_drop(h, event: str) -> None:
    global _dropped_total
    with _drop_lock:
        _dropped_total += 1
        first = id(h) not in _logged_hooks
        if first:
            _logged_hooks.add(id(h))
    if first:
        import sys
        import traceback
        sys.stderr.write(
            f"ompi_tpu_torch: profiler hook "
            f"{getattr(h, '__name__', repr(h))} raised on event "
            f"{event!r}; dropping (counted in the hooks_dropped pvar; "
            f"further failures of this hook are silent):\n")
        traceback.print_exc(file=sys.stderr)


def dropped() -> int:
    with _drop_lock:
        return _dropped_total


def _reset_drops_for_tests() -> None:
    global _dropped_total
    with _drop_lock:
        _dropped_total = 0
        _logged_hooks.clear()


def fire(event: str, comm, info: Dict[str, Any]) -> None:
    # Hot path (every collective and pt2pt entry): stay lock-free when
    # there is nothing to do — membership reads on builtins are safe.
    if event not in _known_event_set:
        declare_event(event)
    if not _hooks:
        return
    with _lock:
        hooks = list(_hooks)
    for h in hooks:
        try:
            h(event, comm, info)
        except Exception:
            _count_drop(h, event)


def _register_pvar() -> None:
    from ompi_tpu_torch.mca import pvar
    pvar.pvar_register(
        "hooks_dropped", dropped,
        help="Profiler-hook exceptions swallowed by utils.hooks.fire "
             "(first failure per hook logged with traceback)")


_register_pvar()
