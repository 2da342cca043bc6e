"""PERUSE instrumentation — mirrors ``ompi/peruse/peruse.c`` (the port of
``ompi_tpu/tools/peruse.py``).

Reference behavior: the PERUSE spec's event model — a tool initializes,
queries supported events by name (``PERUSE_COMM_REQ_ACTIVATE``,
``PERUSE_COMM_MSG_ARRIVED``, ...), creates per-communicator event
handles bound to callbacks, and starts/stops them; the pml fires the
events at request state transitions.

Design: events ride the same hook chain as the PMPI/MPI_T
instrumentation (``utils/hooks``) — PERUSE event names are mapped onto
the framework's entry events, handles filter by communicator, and
start/stop is handle state (exactly the reference's event-handle life
cycle, ``peruse.c`` event table). The hooks see the call, never its
payload, so they fire alike for numpy, CPU-tensor and CUDA-tensor
buffers.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from ompi_tpu_torch.utils import hooks

PERUSE_SUCCESS = 0
PERUSE_ERR_EVENT = -1
PERUSE_ERR_COMM = -2

# PERUSE event name -> framework hook event(s)
_EVENT_MAP: Dict[str, List[str]] = {
    "PERUSE_COMM_REQ_ACTIVATE": ["pml_send", "pml_recv"],
    "PERUSE_COMM_REQ_XFER_BEGIN": ["pml_send"],
    "PERUSE_COMM_REQ_XFER_END": ["pml_recv"],
    "PERUSE_COMM_MSG_ARRIVED": ["pml_recv"],
    "PERUSE_COMM_SEARCH_POSTED_Q_BEGIN": ["pml_recv"],
    "PERUSE_COMM_COLL_BEGIN": [f"coll_{c}" for c in (
        "allreduce", "reduce", "bcast", "allgather", "gather", "scatter",
        "alltoall", "barrier")],
}

_initialized = False


def Init() -> int:
    global _initialized
    _initialized = True
    return PERUSE_SUCCESS


def Query_supported_events() -> List[str]:
    return list(_EVENT_MAP)


def Query_event(name: str) -> bool:
    return name in _EVENT_MAP


class EventHandle:
    """A per-communicator event subscription (PERUSE event handle)."""

    def __init__(self, comm, event: str,
                 callback: Callable[[str, Any, dict], None]):
        self.comm = comm
        self.event = event
        self.callback = callback
        self.active = False
        self.fired = 0
        self._hook = None

    def start(self) -> int:
        if self._hook is None:
            targets = set(_EVENT_MAP[self.event])

            def hook(ev, comm, info, _self=self, _targets=targets):
                if _self.active and ev in _targets \
                        and comm is _self.comm:
                    _self.fired += 1
                    _self.callback(_self.event, comm, info)
            self._hook = hooks.register_profiler(hook)
        self.active = True
        return PERUSE_SUCCESS

    def stop(self) -> int:
        self.active = False
        return PERUSE_SUCCESS

    def free(self) -> int:
        self.stop()
        if self._hook is not None:
            hooks.unregister_profiler(self._hook)
            self._hook = None
        return PERUSE_SUCCESS


def Event_comm_register(event: str, comm,
                        callback: Callable[[str, Any, dict], None]
                        ) -> Optional[EventHandle]:
    """PERUSE_Event_comm_register: returns a handle or None for an
    unsupported event."""
    if event not in _EVENT_MAP:
        return None
    return EventHandle(comm, event, callback)
