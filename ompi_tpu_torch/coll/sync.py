"""coll/sync — periodic-barrier interposition (debug flow control; the
port of ``ompi_tpu/coll/sync.py``).

Behavioral spec: ``ompi/mca/coll/sync`` (926 LoC) — wraps the selected
collective modules and injects an ``MPI_Barrier`` before every Nth
operation (MCA var ``coll_sync_barrier_before``), reining in unbounded
unexpected-message growth when one rank races ahead (the classic
debugging aid for flow-control hangs).

The same interposition shape over the per-function vtable —
the shim counts operations per communicator and, at the threshold, runs
the *underlying* barrier winner before delegating. Disabled by default,
exactly like the reference (priority only queried when the var is set).
"""
from __future__ import annotations

from typing import Any, Dict

import threading as _threading

from ompi_tpu_torch.coll.framework import coll_framework
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.mca.base import Component

_tls = _threading.local()


class SyncCollModule:
    """Counting shim: every ``every``-th collective is preceded by a
    barrier on the wrapped vtable."""

    def __init__(self, comm, every: int):
        self.comm = comm
        self.every = max(1, every)
        self.count = 0
        self._inner: Dict[str, Any] = {}

    def _wrap(self, func: str):
        def call(*args, **kw):
            self.count += 1
            if self.count % self.every == 0:
                inner_barrier = self._inner.get("barrier")
                if inner_barrier is not None and func != "barrier":
                    inner_barrier.barrier()
            return getattr(self._inner[func], func)(*args, **kw)
        call.__name__ = func
        return call


class SyncCollComponent(Component):
    """Claims every slot at maximal priority when enabled, then
    delegates to the next-priority winner per function (the reference's
    interposition layering)."""

    name = "sync"

    def register_params(self) -> None:
        var.var_register("coll", "sync", "barrier_before", vtype="int",
                         default=0,
                         help="Insert a barrier before every Nth "
                              "collective (0 = disabled; debug flow "
                              "control, reference coll/sync)")

    def comm_query(self, comm):
        if getattr(_tls, "busy", False):
            return None                 # re-entrant inner selection
        every = var.var_get("coll_sync_barrier_before", 0)
        if not every or every <= 0:
            return None
        module = SyncCollModule(comm, every)
        # wrap every function some other component provides
        from ompi_tpu_torch.coll.framework import COLL_FUNCS
        _tls.busy = True
        try:
            selected = coll_framework.comm_select(comm)
        finally:
            _tls.busy = False
        shim = _Shim(module)
        for func in COLL_FUNCS:
            # Interpose only on blocking collectives, as the reference
            # does: wrapping the nonblocking schedule slots would run
            # the injected barrier synchronously inside i-collective
            # *initiation*, and agree/iagree are fault-tolerance paths
            # that must not pick up extra synchronization.
            if func.startswith("i") or func in ("agree",):
                continue
            for _p, _c, m in selected:
                if getattr(m, func, None) is not None:
                    module._inner[func] = m
                    setattr(shim, func, module._wrap(func))
                    break
        return (95, shim)


class _Shim:
    """Bag of wrapped per-function callables (the module the selection
    composer sees)."""

    def __init__(self, module: SyncCollModule):
        self._module = module


coll_framework.register(SyncCollComponent())
