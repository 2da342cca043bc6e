"""Coll framework: per-communicator, per-function module selection.

Mirrors ``ompi/mca/coll/base/coll_base_comm_select.c:234-273`` — query
every component, keep priority >= 0, sort descending, then enable winners
*per function* into the communicator's ``c_coll`` vtable (a component may
provide only some collectives; the next-priority component backfills the
rest).
"""
from __future__ import annotations

from typing import Any, Dict

from ompi_tpu_torch.mca.base import register_framework

COLL_FUNCS = (
    "allreduce", "reduce", "bcast", "allgather", "gather", "scatter",
    "alltoall", "reduce_scatter_block", "scan", "exscan", "barrier",
    # schedule-based nonblocking collectives (provided by coll/nbc, the
    # libnbc role; blocking-slot winners serve the rest of the i-surface
    # through async dispatch)
    "iallreduce", "ibcast", "iallgather", "ibarrier",
    # ULFM fault-tolerant agreement (reference vtable slots
    # ompi/mca/coll/coll.h:215-220, provided by coll/ftagree)
    "agree", "iagree",
)

coll_framework = register_framework("coll")

_components_loaded = False


def _ensure_components() -> None:
    global _components_loaded
    if _components_loaded:
        return
    # Importing registers each component with the framework.
    from ompi_tpu_torch.coll import (acoll, adapt, basic,  # noqa: F401
                                     compressed, ftagree, han,
                                     monitoring, nbc, self_, sync,
                                     torch_, tuned, xhc)
    _components_loaded = True


def select_winners(comm):
    """Run selection and pick the highest-priority provider per
    collective function. Returns (winners: func -> (component, module),
    selected: [(prio, component, module)] descending)."""
    _ensure_components()
    selected = coll_framework.comm_select(comm)   # descending priority
    winners: Dict[str, Any] = {}
    for func in COLL_FUNCS:
        for _prio, comp, module in selected:
            if getattr(module, func, None) is not None:
                winners[func] = (comp, module)
                break
    return winners, selected


def comm_select_coll(comm) -> Dict[str, Any]:
    """Build the c_coll vtable for ``comm``: highest-priority provider per
    collective function; when monitoring is enabled, every slot is
    served by the counting shim (which delegates to the slot's real
    winner), the telemetry histogram shim wraps that, and when tracing
    is enabled the span shim wraps outermost. All are off by default,
    and the vtable is then the winners' modules themselves."""
    winners, selected = select_winners(comm)
    # Cache the selection outcome: introspection, and the ordered list
    # coll/compressed delegates through.
    comm._coll_selected = selected
    comm._coll_winners = {f: comp.name
                          for f, (comp, _m) in winners.items()}
    comm._coll_priorities = [(comp.name, prio)
                             for prio, comp, _m in selected]
    vtable: Dict[str, Any] = {f: m for f, (_c, m) in winners.items()}
    from ompi_tpu_torch.coll import monitoring
    if vtable and monitoring.enabled():
        vtable = monitoring.wrap_vtable(comm, vtable)
    # telemetry's latency histograms ride between monitoring and the
    # tracer: they time the same app-visible call the spans do without
    # paying the tracer's ring append; off by default
    from ompi_tpu_torch import telemetry
    if vtable and telemetry.telemetry_enabled():
        vtable = telemetry.wrap_coll_vtable(comm, vtable)
    # the tracer wraps outermost, so spans measure the app-visible call
    # with monitoring's counters and the histograms inside
    from ompi_tpu_torch import trace
    if vtable and trace.tracing_enabled():
        vtable = trace.wrap_coll_vtable(comm, vtable)
    return vtable
