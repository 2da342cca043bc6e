"""coll/monitoring — interposition counting operations and bytes per
collective per communicator (the port of ``ompi_tpu/coll/monitoring.py``).

Mirrors the reference's monitoring stack (pml/coll/osc ``monitoring``
components aggregated by ``ompi/mca/common/monitoring``): when enabled
(MCA var ``coll_monitoring_enable``), the selection composer wraps the
communicator's *per-function vtable* — each call is counted and passed
through to the function's actual priority winner, preserving the
framework's per-function backfill (a component providing only
``barrier`` keeps its slot, monitored). Results are read through pvars /
the info tool (the MPI_T path the reference uses)."""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Any, Dict, Tuple

from ompi_tpu_torch.coll.framework import COLL_FUNCS, coll_framework
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.mca.base import Component

_lock = threading.Lock()
# (comm_cid, func) -> [calls, bytes]
_table: Dict[Tuple[int, str], list] = defaultdict(lambda: [0, 0])


def record(cid: int, func: str, nbytes: int) -> None:
    with _lock:
        e = _table[(cid, func)]
        e[0] += 1
        e[1] += nbytes


def snapshot() -> Dict[Tuple[int, str], Tuple[int, int]]:
    with _lock:
        return {k: tuple(v) for k, v in _table.items()}


def reset() -> None:
    with _lock:
        _table.clear()


class MonitoringCollModule:
    """Counting shim over a communicator's selected per-function vtable
    (``vtable``: func name -> the real winning module)."""

    def __init__(self, comm, vtable: Dict[str, Any]):
        self.comm = comm
        self.vtable = vtable

    def barrier(self) -> None:
        record(self.comm.cid, "barrier", 0)
        self.vtable["barrier"].barrier()

    def ibarrier(self):
        # its own key: conflating blocking and nonblocking counts hid
        # the i-surface from the monitoring tables (the stacked table
        # has separate i-slots, and the per-rank interposer already
        # records i-collectives under their own names)
        record(self.comm.cid, "ibarrier", 0)
        m = self.vtable.get("ibarrier")
        if m is not None:
            return m.ibarrier()
        from ompi_tpu_torch.core.request import Request, event_after
        inner = self.vtable["barrier"]
        fn = getattr(inner, "_ibarrier_arrays", None)
        if fn is not None:
            arrays = fn()
            return Request(result=arrays, event=event_after(arrays))
        inner.barrier()
        return Request.completed()


for _f in COLL_FUNCS:
    if _f not in ("barrier", "ibarrier"):
        def _mk(f):
            def method(self, buf, *args):
                record(self.comm.cid, f, int(getattr(buf, "nbytes", 0)))
                return getattr(self.vtable[f], f)(buf, *args)
            method.__name__ = f
            return method
        setattr(MonitoringCollModule, _f, _mk(_f))


def wrap_vtable(comm, vtable: Dict[str, Any]) -> Dict[str, Any]:
    """Called by the selection composer when monitoring is enabled:
    every selected slot is served by one counting shim that delegates to
    that slot's winner."""
    mon = MonitoringCollModule(comm, vtable)
    return {f: mon for f in vtable}


def enabled() -> bool:
    return bool(var.var_get("coll_monitoring_enable", False))


class MonitoringCollComponent(Component):
    """Registers the MCA vars; the interposition itself happens in the
    selection composer (coll/framework.py) so per-function backfill is
    preserved — this component never claims a slot directly."""

    name = "monitoring"

    def register_params(self):
        var.var_register("coll", "monitoring", "enable", vtype="bool",
                         default=False,
                         help="Interpose byte/call counters on every "
                              "collective (reference: coll/monitoring)")

    def comm_query(self, comm):
        return None


coll_framework.register(MonitoringCollComponent())
