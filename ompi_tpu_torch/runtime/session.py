"""MPI-4 Sessions — mirrors ``ompi/instance`` (``ompi_instance_t``,
refcounted bring-up, ``instance.c:825`` / common path ``:361-720``). The
port of ``ompi_tpu/runtime/session.py``.

A Session is an independent handle onto the runtime: it exposes process
sets ("mpi://WORLD", "mpi://SELF", plus one "mpix://shared/<k>" per
shared-memory domain when the rows span several: per controller process
in a multi-controller world, else per CUDA device), builds Groups from
psets, and creates communicators
from groups without touching COMM_WORLD. Each Session owns, per
``instance.c:361-720``'s per-instance bootstrap,

- a private **MCA var scope** (:class:`ompi_tpu_torch.mca.var.VarScope`):
  ``session.var_set`` overrides are visible only inside this session's
  communicator creation and collective dispatch, so two sessions can
  select different coll components or algorithms without bleeding into
  each other or the global store;
- a private **CID space**: session communicators draw from the
  session's counter (``comm_cid.c`` allocates within the instance's
  communicator namespace);
- a private **failure registry** (:class:`ompi_tpu_torch.runtime.ft.
  Registry`): failures injected in one session never poison another's
  collectives;
- a refcount on the shared runtime bring-up (``instance.c:825``
  ``ompi_mpi_instance_retain``), released at ``finalize``.

A rank is a row of the stacked tensor, not a device of its own, so the
session's rows come from a device list with repeats allowed. It resolves
it in this order: an explicit ``devices=[...]`` wins; else, once
``Init`` has run, the world's device list; else one rank per visible
CUDA device; with no CUDA device and no list it raises ``MPIError`` —
it never moves to the CPU on its own.

In a per-rank job (one OS process per rank) psets enumerate processes,
and session communicators are ``RankCommunicator``s whose CIDs are the
tuple ``("s", tag, group, ordinal)``, which every member derives alike.
A multi-controller job (``mpirun --coordinator``) also has a router, but
one that joins controllers: its psets enumerate the world's ranks, as
the reference's device psets do, and its session communicators are
stacked ``SessionCommunicator``s whose collectives cross the controller
tier (``core/multictl``).
"""
from __future__ import annotations

import itertools
import os
import threading
from typing import Any, Dict, List, Optional

import torch

from ompi_tpu_torch.core.communicator import Communicator
from ompi_tpu_torch.core.errhandler import ERR_ARG, ERR_OTHER, MPIError
from ompi_tpu_torch.core.group import Group
from ompi_tpu_torch.core.info import Info
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.runtime import ft

_instance_lock = threading.Lock()
_instance_refcount = 0

# Per-rank comm_create_from_group call ordinals, keyed (tag, group):
# process-global (not per session) because the CID they feed must agree
# across processes however many local Session objects exist. SPMD
# collective-call order keeps the counters aligned.
_pr_seq_lock = threading.Lock()
_pr_create_seq: Dict[Any, int] = {}


def _instance_retain() -> None:
    global _instance_refcount
    with _instance_lock:
        _instance_refcount += 1


def _instance_release() -> None:
    global _instance_refcount
    with _instance_lock:
        _instance_refcount = max(0, _instance_refcount - 1)


def instance_refcount() -> int:
    return _instance_refcount


class SessionCommunicator(Communicator):
    """A communicator owned by a Session: every public operation runs
    inside the session's var scope (so decision layers and component
    selection read the session's overrides), draws CIDs from the
    session's space, and consults the session's failure registry.
    Children (split/dup/cart/shrink) inherit all of it through
    ``parent``."""

    def __init__(self, group, devices, *, session: "Session" = None,
                 parent: Optional[Communicator] = None, **kw):
        sess = session or getattr(parent, "_session", None)
        if sess is None:
            raise MPIError(ERR_ARG,
                           "SessionCommunicator needs a session or a "
                           "session-owned parent")
        # bound before super().__init__, which calls _alloc_cid
        self._session = sess
        with var.scope(sess.scope):
            super().__init__(group, devices, parent=parent, **kw)
        self._ft = sess.ft_registry
        # every session communicator, children included, registers with
        # its instance so finalize frees all of them
        sess._comms.append(self)

    def _alloc_cid(self) -> int:
        return self._session._next_cid()


def _scoped(name: str):
    base = getattr(Communicator, name)

    def wrapper(self, *args, **kw):
        with var.scope(self._session.scope):
            return base(self, *args, **kw)
    wrapper.__name__ = name
    wrapper.__doc__ = base.__doc__
    return wrapper


# Public operations whose behavior can depend on MCA vars (algorithm
# decisions, staging thresholds, schedule knobs, component priorities in
# child-communicator creation).
for _name in ("allreduce", "reduce", "bcast", "allgather", "gather",
              "scatter", "gather_root", "scatter_root", "alltoall",
              "reduce_scatter_block", "reduce_scatter", "scan", "exscan",
              "barrier", "allgatherv", "gatherv", "scatterv", "alltoallv",
              "alltoallw", "iallreduce", "ibcast", "ireduce",
              "iallgather", "igather", "iscatter", "ialltoall",
              "ibarrier", "dup", "split", "split_type", "create",
              "create_cart", "create_graph", "shrink",
              "allreduce_bind", "allreduce_init", "bcast_init"):
    setattr(SessionCommunicator, _name, _scoped(_name))


_session_names = itertools.count(0)


def _session_devices(devices) -> List[torch.device]:
    """The session's rows: an explicit list, else the world's, else one
    per visible CUDA device; never the CPU unasked."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise MPIError(ERR_ARG, "Session needs at least one device")
        return devs
    from ompi_tpu_torch.runtime import init as _rt
    w = _rt._state.get("world")
    if _rt._state.get("initialized") and w is not None \
            and not _rt._state.get("finalized"):
        return list(w.devices) if hasattr(w, "devices") else [w.device]
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    raise MPIError(ERR_OTHER,
                   "Session found no CUDA device and no running world; "
                   "pass devices=[...] (e.g. ['cpu'] * 8) to run its "
                   "ranks elsewhere")


def _device_key(d: torch.device) -> int:
    """The shared-memory domain of a row: its CUDA device index (every
    CPU row reads as 0)."""
    return int(d.index or 0) if d.type == "cuda" else 0


class Session:
    def __init__(self, info: Optional[Info] = None, errhandler=None, *,
                 devices=None):
        self.info = info or Info()
        self.errhandler = errhandler
        self._finalized = False
        self.name = f"session#{next(_session_names)}"
        # -- per-instance state (instance.c:361-720) -------------------
        self.scope = var.VarScope()
        self.ft_registry = ft.Registry()
        self._cids = itertools.count(0)
        self._cid_lock = threading.Lock()
        self._comms: List[Any] = []
        # Per-rank world (one OS process == one rank): psets enumerate
        # processes, and session communicators are RankCommunicators
        # drawing CIDs from the (tag, group) ordinals. The router
        # (endpoints, modex) is the shared instance state the refcount
        # guards.
        from ompi_tpu_torch.core import multictl
        from ompi_tpu_torch.runtime import init as _rt
        # a multi-controller world's router joins its controllers, not
        # its ranks: such a job takes the device-pset branch below
        self._router = (None if multictl.active()
                        else _rt._state.get("router"))
        if self._router is None and os.environ.get(
                var.ENV_PREFIX + "mpi_base_per_rank"):
            # a per-rank process without a live router would build
            # in-process comms whose collectives see only local data
            raise MPIError(ERR_OTHER,
                           "Session in a per-rank job requires the "
                           "runtime to be up (call Init first; Init-free "
                           "session bootstrap is not supported)")
        if self._router is not None:
            self.devices = [self._router.device]
            n = self._router.nprocs
            self._my_world = self._router.rank
            self._psets: Dict[str, List[int]] = {
                "mpi://WORLD": list(range(n)),
                "mpi://SELF": [self._my_world],
            }
        else:
            self.devices = _session_devices(devices)
            self._my_world = None
            self._psets = {
                "mpi://WORLD": list(range(len(self.devices))),
                "mpi://SELF": [0],
            }
            # one pset per shared-memory domain, the reference's mpix://
            # locality psets: a controller process in a multi-controller
            # world (the reference's process_index), else a CUDA device;
            # none on one card
            ctl = None
            if multictl.active():
                if len(self.devices) != multictl.nranks():
                    raise MPIError(ERR_ARG,
                                   f"a multi-controller Session holds the "
                                   f"world's {multictl.nranks()} rows, not "
                                   f"{len(self.devices)}")
                ctl = multictl.controllers_of(range(len(self.devices)))
            by_dom: Dict[int, List[int]] = {}
            for i, d in enumerate(self.devices):
                by_dom.setdefault(_device_key(d) if ctl is None else ctl[i],
                                  []).append(i)
            if len(by_dom) > 1:
                for k, ranks in sorted(by_dom.items()):
                    self._psets[f"mpix://shared/{k}"] = ranks
        _instance_retain()

    def _check(self) -> None:
        if self._finalized:
            raise MPIError(ERR_OTHER, "session has been finalized")

    def _next_cid(self) -> int:
        with self._cid_lock:
            return next(self._cids)

    # -- per-session config (the instance's MCA scope) -----------------
    def var_set(self, full: str, value: Any) -> None:
        """Override an MCA var for this session only."""
        self._check()
        self.scope.set(full, value)

    def var_get(self, full: str, default: Any = None) -> Any:
        if full in self.scope.values:
            return self.scope.values[full]
        return var.var_get(full, default)

    # -- pset enumeration ----------------------------------------------
    def get_num_psets(self) -> int:
        return len(self._psets)

    def get_nth_pset(self, n: int) -> str:
        return list(self._psets.keys())[n]

    def get_pset_info(self, name: str) -> Info:
        if name not in self._psets:
            raise MPIError(ERR_ARG, f"unknown pset {name}")
        i = Info()
        i.set("size", str(len(self._psets[name])))
        return i

    # -- group / communicator construction -----------------------------
    def group_from_pset(self, name: str) -> Group:
        self._check()
        if name not in self._psets:
            raise MPIError(ERR_ARG, f"unknown pset {name}")
        return Group(self._psets[name])

    def comm_create_from_group(self, group: Group, tag: str = "",
                               info: Optional[Info] = None):
        self._check()
        if self._router is not None:
            # Per-rank world: the CID must agree across processes, and a
            # rank may hold extra local sessions, so session identity
            # cannot be part of it. MPI-4's matching rule for
            # comm_create_from_group is (group, tag) in collective-call
            # order: ("s", tag, group, per-(tag, group) ordinal).
            from ompi_tpu_torch.core.rankcomm import RankCommunicator
            if self._my_world not in group.world_ranks:
                return None
            gkey = tuple(group.world_ranks)
            with _pr_seq_lock:
                ordinal = _pr_create_seq.get((tag, gkey), 0)
                _pr_create_seq[(tag, gkey)] = ordinal + 1
            c = RankCommunicator(
                group, self._my_world, self._router, self._router.device,
                cid=("s", tag, gkey, ordinal),
                name=tag or f"{self.name}.comm", info=info,
                errhandler=self.errhandler)
            # derived comms (dup/split/shrink) self-register through the
            # ownership list, so finalize frees the whole family
            c._owner_list = self._comms
            self._comms.append(c)
            return c
        devs = [self.devices[r] for r in group.world_ranks]
        return SessionCommunicator(
            group, devs, session=self,
            name=tag or f"{self.name}.comm", info=info,
            errhandler=self.errhandler)

    def finalize(self) -> None:
        """``MPI_Session_finalize``: communicators created from the
        session must already be freed (they are freed here, as the
        ERRORS_RETURN quality of implementation); releases the instance
        refcount."""
        if self._finalized:
            return
        for c in self._comms:
            if not c._freed:
                c.free()
        self._comms.clear()
        self._finalized = True
        _instance_release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finalize()
        return False


def _reset_for_tests() -> None:
    """Zero the instance refcount and the per-rank create ordinals."""
    global _instance_refcount
    with _instance_lock:
        _instance_refcount = 0
    with _pr_seq_lock:
        _pr_create_seq.clear()
