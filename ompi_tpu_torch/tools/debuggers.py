"""Debugger interface — mirrors ``ompi/debuggers`` (MPIR + DLL); the port
of ``ompi_tpu/tools/debuggers.py``.

Reference behavior: the MPIR specification — a debugger attaches to the
launcher, reads ``MPIR_proctable`` (one {host, executable, pid} entry
per rank) once ``MPIR_Breakpoint`` fires, and sets
``MPIR_being_debugged`` so the MPI library cooperates (holds ranks in
init until released). The message-queue DLL (``ompi_msgq_dll.c``) lets
the debugger walk posted/unexpected queues.

Design: ranks are rows of one controller process's stacked tensor, so
the proctable maps rank -> (host, pid, device), the device named
``type:index`` as the affinity strings name it (eight ranks on one card
each name ``cuda:0``); the "message queue dump" walks the live matching
engines — the Python queues or the native ones — the same introspection
the DLL provides, without the ptrace indirection.
"""
from __future__ import annotations

import os
import socket
import sys
from typing import Any, Callable, Dict, List, Optional

MPIR_being_debugged = False

_breakpoint_hooks: List[Callable[[], None]] = []


def proctable(comm) -> List[Dict[str, Any]]:
    """MPIR_proctable: one entry per rank."""
    host = socket.gethostname()
    exe = sys.argv[0] or "<python>"
    pid = os.getpid()
    return [{
        "rank": r,
        "host_name": host,
        "executable_name": exe,
        "pid": pid,
        "device": f"{d.type}:{d.index or 0}",
    } for r, d in enumerate(comm.devices)]


def set_being_debugged(flag: bool) -> None:
    global MPIR_being_debugged
    MPIR_being_debugged = flag


def on_breakpoint(fn: Callable[[], None]) -> None:
    """Debugger-side hook run when MPIR_Breakpoint fires."""
    _breakpoint_hooks.append(fn)


def MPIR_Breakpoint() -> None:
    """The rendezvous point: the launcher calls this once the job is
    wired up; an attached debugger's hooks run here."""
    for fn in list(_breakpoint_hooks):
        fn()


def message_queues(comm, *, dst: Optional[int] = None
                   ) -> Dict[str, List[Dict[str, Any]]]:
    """The message-queue DLL role: posted receives and unexpected
    messages of ``comm``'s matching engine, as the debugger would
    display them."""
    eng = comm._pml
    posted, unexpected = [], []
    if getattr(eng, "_lib", None) is not None:
        # native queues: surface the Python-side payload registries
        for rh, req in getattr(eng, "_reqs", {}).items():
            posted.append({"handle": rh,
                           "dest": getattr(req, "dest", -1),
                           "source": req.status.source,
                           "tag": req.status.tag})
        for mh, msg in getattr(eng, "_msgs", {}).items():
            unexpected.append({"handle": mh, "src": msg.src,
                               "dest": msg.dest, "tag": msg.tag})
    else:
        for pr in eng.posted:
            posted.append({"dest": pr.dest, "source": pr.src,
                           "tag": pr.tag})
        for (d, s), q in eng.unexpected.items():
            for msg in q:
                unexpected.append({"src": s, "dest": d, "tag": msg.tag})
    if dst is not None:
        posted = [p for p in posted if p.get("dest") == dst]
        unexpected = [u for u in unexpected if u["dest"] == dst]
    return {"posted": posted, "unexpected": unexpected}
