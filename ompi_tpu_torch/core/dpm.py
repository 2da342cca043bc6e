"""Dynamic process management — mirrors ``ompi/dpm``. The port of
``ompi_tpu/core/dpm.py``.

Reference behavior: ``MPI_Comm_spawn`` launches a child job through PRRTE
and wires an intercommunicator to it over PMIx; ``MPI_Open_port`` /
``MPI_Comm_accept`` / ``MPI_Comm_connect`` rendezvous two independent
jobs through a PMIx-published port string; ``MPI_Publish_name`` /
``MPI_Lookup_name`` are the naming service over the same KV;
``MPI_Comm_join`` bootstraps an intercomm across an existing socket.

Single controller: a "job" is a communicator over a list of rank slots.
A rank is a row of the stacked tensor, not a device of its own, so
spawning allocates a child world of ``maxprocs`` slots (``spawn(main, 4,
world)`` on one card gives a 4-row child on ``cuda:0``) and returns the
parent⇄child intercommunicator. Ports and names live in a
controller-scope registry (the PMIx KV role). Rendezvous follows the
pt2pt matching engine's discipline: the first side *posts*, the second
*completes*; a blocking call that would deadlock raises instead, while
the i-variants return pollable requests.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ompi_tpu_torch.core.communicator import Communicator
from ompi_tpu_torch.core.errhandler import (ERR_ARG, ERR_NAME, ERR_PENDING,
                                            ERR_PORT, ERR_SERVICE,
                                            ERR_SPAWN, MPIError)
from ompi_tpu_torch.core.group import Group
from ompi_tpu_torch.core.intercomm import Intercomm
from ompi_tpu_torch.core.request import Request

_port_counter = itertools.count(0)
_ports: Dict[str, dict] = {}           # open ports: port -> rendezvous slot
_names: Dict[str, str] = {}            # published names: service -> port
_joins: Dict[Any, dict] = {}           # Comm_join rendezvous by fd token


class _PendingIntercomm(Request):
    """Request returned by iaccept/iconnect before the peer arrives."""

    def __init__(self):
        super().__init__()
        self._complete = False

    def deliver(self, inter: Intercomm) -> None:
        self._result = inter
        self._complete = True

    def test(self):
        return (True, self.status) if self._complete else (False, None)

    def wait(self):
        if not self._complete:
            raise MPIError(
                ERR_PENDING,
                "accept/connect would deadlock: the peer side has not "
                "been posted (single-controller requires one side to use "
                "the i-variant)")
        return self.status


def open_port(info=None) -> str:
    """MPI_Open_port: returns a port string usable by accept/connect."""
    port = f"torch://port/{next(_port_counter)}"
    _ports[port] = {"accept": [], "connect": []}
    return port


def close_port(port: str) -> None:
    _ports.pop(port, None)


def publish_name(service: str, port: str, info=None) -> None:
    """MPI_Publish_name (the PMIx naming-service role)."""
    if service in _names:
        raise MPIError(ERR_SERVICE,
                       f"service {service!r} already published")
    _names[service] = port


def lookup_name(service: str, info=None) -> str:
    port = _names.get(service)
    if port is None:
        raise MPIError(ERR_NAME, f"service {service!r} not published")
    return port


def unpublish_name(service: str, info=None) -> None:
    _names.pop(service, None)


def _slot(port: str) -> dict:
    slot = _ports.get(port)
    if slot is None:
        raise MPIError(ERR_PORT, f"port {port!r} is not open")
    return slot


def _rendezvous(slot: dict, side: str, comm: Communicator,
                req: _PendingIntercomm) -> Optional[Intercomm]:
    """One side arrives; if the other is already posted, both complete.
    Each side is a FIFO, so repeated posts pair in order (a port may
    serve several clients, as the reference's accept loop does).
    accept's group is the intercomm's *local* group on the accept side."""
    other = "connect" if side == "accept" else "accept"
    if slot[other]:
        peer_comm, peer_req = slot[other].pop(0)
        mine = Intercomm(comm, peer_comm)
        theirs = Intercomm(peer_comm, comm)
        peer_req.deliver(theirs)
        req.deliver(mine)
        return mine
    slot[side].append((comm, req))
    return None


def iaccept(port: str, comm: Communicator) -> _PendingIntercomm:
    """MPI_Comm_accept, nonblocking posting side."""
    req = _PendingIntercomm()
    _rendezvous(_slot(port), "accept", comm, req)
    return req


def iconnect(port: str, comm: Communicator) -> _PendingIntercomm:
    req = _PendingIntercomm()
    _rendezvous(_slot(port), "connect", comm, req)
    return req


def _blocking(port: str, side: str, comm: Communicator) -> Intercomm:
    req = _PendingIntercomm()
    slot = _slot(port)
    if _rendezvous(slot, side, comm, req) is None:
        # a blocking call that cannot complete must not stay posted: it
        # raises, it does not wait
        slot[side].remove((comm, req))
        req.wait()                       # raises the deadlock error
    return req.get()


def accept(port: str, comm: Communicator) -> Intercomm:
    """MPI_Comm_accept (blocking): completes only if a connect is
    already posted on the port; raises the deadlock otherwise."""
    return _blocking(port, "accept", comm)


def connect(port: str, comm: Communicator) -> Intercomm:
    return _blocking(port, "connect", comm)


def join(fd: Any, comm: Communicator) -> "Intercomm | _PendingIntercomm":
    """MPI_Comm_join: rendezvous over an existing channel token (the
    reference exchanges port names over a connected socket ``fd``). The
    first caller posts and receives a pending request; the second
    completes both sides."""
    slot = _joins.setdefault(fd, {"accept": [], "connect": []})
    req = _PendingIntercomm()
    side = "accept" if not slot["accept"] and not slot["connect"] \
        else "connect"
    inter = _rendezvous(slot, side, comm, req)
    if inter is not None:
        _joins.pop(fd, None)
        return inter
    return req


def spawn(fn: Optional[Callable], maxprocs: int, comm: Communicator,
          *, devices: Optional[Sequence[Any]] = None, root: int = 0,
          info=None, appnum: int = 0, soft: bool = False) -> Intercomm:
    """MPI_Comm_spawn: create a child world of ``maxprocs`` ranks and
    return the parent⇄child intercommunicator (the child side is
    ``intercomm.remote_comm``; ``get_parent(child_world)`` recovers the
    reverse view, as MPI_Comm_get_parent does in the child).

    Child placement: a rank is a slot. The pool is ``devices`` as given
    (the ``host`` info key role; repeats are slots of their own and are
    not de-duplicated), else the parent's slots (``comm.devices``).
    ``maxprocs`` beyond the pool raises MPI_ERR_SPAWN unless
    ``soft=True`` (the MPI ``soft`` info key: spawn as many as
    possible). ``fn``, when given, is the child program's main, called
    as ``fn(child_world)``."""
    if maxprocs < 1:
        raise MPIError(ERR_ARG, f"maxprocs must be >= 1, got {maxprocs}")
    comm._validate_root(root)
    pool = list(devices) if devices is not None else list(comm.devices)
    if not pool:
        raise MPIError(ERR_ARG, "spawn needs at least one device")
    if len(pool) < maxprocs:
        if not soft:
            raise MPIError(
                ERR_SPAWN,
                f"cannot spawn {maxprocs} ranks on {len(pool)} slot(s); "
                f"pass soft=True to spawn fewer")
        maxprocs = len(pool)
    devs = pool[:maxprocs]
    # the child's world ranks live in a fresh slice of the namespace, so
    # parent and child groups stay disjoint (a separate PMIx nspace)
    base = _next_world_base(comm)
    g = Group(list(range(base, base + maxprocs)))
    child = Communicator(g, devs, name=f"spawn#{appnum}",
                         errhandler=comm.errhandler)
    inter = Intercomm(comm, child)
    child._spawn_parent = Intercomm(child, comm)
    child._spawn_appnum = appnum
    if fn is not None:
        fn(child)
    return inter


def spawn_multiple(apps: List[Tuple[Optional[Callable], int]],
                   comm: Communicator, *, root: int = 0,
                   info=None) -> Intercomm:
    """MPI_Comm_spawn_multiple: one child world running several apps;
    ranks are ordered by app, each app's main sees the whole child world
    (one MPI_COMM_WORLD for all apps; appnum tells them apart)."""
    total = sum(n for _f, n in apps)
    inter = spawn(None, total, comm, root=root)
    child = inter.remote_comm
    child._spawn_appnums = []
    for appnum, (_fn, n) in enumerate(apps):
        child._spawn_appnums += [appnum] * n
    for appnum, (fn, _n) in enumerate(apps):
        if fn is not None:
            fn(child, appnum)
    return inter


def get_parent(comm) -> Optional[Any]:
    """MPI_Comm_get_parent: the child-side intercomm, or None
    (MPI_COMM_NULL) for worlds that were not spawned. A per-rank job
    launched with a parent port holds the dial-back's intercomm."""
    parent = getattr(comm, "_spawn_parent", None)
    if parent is None and getattr(comm, "is_per_rank", False):
        from ompi_tpu_torch.runtime import init as _rt
        parent = _rt._parent_intercomm
    return parent


def disconnect(comm) -> None:
    """MPI_Comm_disconnect: collective teardown of a connected comm.
    With no pending-operation queue to drain (requests complete at
    creation or raise), this is free() plus dropping the parent link."""
    if isinstance(comm, Intercomm):
        comm.free()
        return
    if getattr(comm, "_spawn_parent", None) is not None:
        comm._spawn_parent = None
    comm.free()


_world_hwm = 0          # high-water mark of handed-out world-rank blocks


def _next_world_base(comm: Communicator) -> int:
    """A world-rank namespace slice disjoint from every group allocated
    so far, nested spawns included, via one global high-water mark (the
    PMIx nspace-uniqueness property). Deterministic: allocation order is
    program order."""
    global _world_hwm
    step = 1 << 20
    floor = max(_world_hwm, max(comm.group.world_ranks, default=0) + 1)
    base = ((floor + step - 1) // step) * step
    _world_hwm = base + step
    return base


def _reset_for_tests() -> None:
    global _port_counter, _world_hwm
    _ports.clear()
    _names.clear()
    _joins.clear()
    _port_counter = itertools.count(0)
    _world_hwm = 0
