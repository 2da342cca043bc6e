"""coll/han — hierarchical collectives by sub-communicator composition.
The port of ``ompi_tpu/coll/han.py``.

Behavioral spec: ``ompi/mca/coll/han`` — split the communicator into
*low* (intra-node) and *up* (inter-node leaders) sub-communicators per
topology level and compose each collective from per-level modules
(``coll_han.h:29-33,180-195``); which level runs first is governed by a
dynamic run-time rule table (``coll_han_dynamic.c``) keyed on collective
and message size, overridable from an MCA-supplied rule file.

Levels map to shared-memory domains: rows on one CUDA device form a low
group, the groups' leaders form the up tier. Sub-communicators are real
row subsets whose own ``c_coll`` vtables were priority-selected by the
framework, so each tier uses its best component (the composition
property han exists for). Where every row shares one device the
hierarchy can be imposed synthetically (``coll_han_split`` = low-group
size), which is how the tests and one card model the tiers. The leader
rows stay on the device at every tier boundary: an ``index_select``
into the up-comm's stack, then a gather back down; a row crosses to
another device only where the tiers' devices differ. The module keeps
out of its own tiers' selection (a thread-local construction guard and
``_han_inner``), as the reference han refuses comms without hierarchy.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ompi_tpu_torch.accelerator import to_device
from ompi_tpu_torch.coll.framework import coll_framework
from ompi_tpu_torch.core import op as op_mod
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.mca.base import Component
from ompi_tpu_torch.utils.locality import device_key

_tls = threading.local()


def _in_construction() -> bool:
    return getattr(_tls, "constructing", False)


def locality_groups(comm, group_size: int = 0) -> Optional[List[List[int]]]:
    """Partition comm ranks into low-level groups. ``group_size`` > 0
    forces a synthetic split (rank // group_size); otherwise rows are
    grouped by their CUDA device index. Returns None when the hierarchy
    is trivial (one group, or all singleton groups)."""
    n = comm.size
    groups: Dict[int, List[int]] = {}
    if group_size > 0:
        for r in range(n):
            groups.setdefault(r // group_size, []).append(r)
    else:
        for r, d in enumerate(comm.devices):
            groups.setdefault(device_key(d), []).append(r)
    out = [sorted(g) for _k, g in sorted(groups.items())]
    if len(out) <= 1 or all(len(g) == 1 for g in out):
        return None
    return out


class Hierarchy:
    """Materialized 2-level hierarchy: low sub-comms + the up (leader)
    sub-comm, built through the ordinary communicator algebra so every
    tier re-enters framework selection (coll_han.h:180-195)."""

    def __init__(self, comm, groups: List[List[int]]):
        self.comm = comm
        self.groups = groups
        self.group_of = np.empty(comm.size, np.int64)
        for gi, g in enumerate(groups):
            self.group_of[np.asarray(g)] = gi
        colors = [int(self.group_of[r]) for r in range(comm.size)]
        _tls.constructing = True   # han never claims its own tiers
        try:
            subs = comm.split(colors)
            self.low = []
            for g in groups:
                sub = subs[g[0]]
                sub._han_inner = True   # keep han out of reselects
                self.low.append(sub)
            self.leaders = [g[0] for g in groups]
            from ompi_tpu_torch.core.group import Group
            up = comm.create(Group([comm.group.world_ranks[r]
                                    for r in self.leaders]))
            up._han_inner = True
            self.up = up
        finally:
            _tls.constructing = False
        # index tensors, built once on the devices that read them
        self._rows = [torch.tensor(g, dtype=torch.long, device=comm.device)
                      for g in groups]
        self._down = torch.tensor(self.group_of, dtype=torch.long,
                                  device=self.up.device)
        order = np.concatenate([np.asarray(g) for g in groups])
        pos = np.empty(comm.size, np.int64)
        pos[order] = np.arange(comm.size)
        self._pos = torch.tensor(pos, dtype=torch.long,
                                 device=self.up.device)

    def rows(self, gi: int) -> torch.Tensor:
        return self._rows[gi]

    def low_parts(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Each low group's rows of ``x``, on that group's device."""
        return [to_device(x.index_select(0, self.rows(gi)), low.device)
                for gi, low in enumerate(self.low)]

    def leader_stack(self, rows: List[torch.Tensor]) -> torch.Tensor:
        """The up tier's stacked buffer from one row per group."""
        return torch.stack([to_device(r, self.up.device) for r in rows])

    def down(self, lead: torch.Tensor) -> torch.Tensor:
        """Rank r's row = its group leader's row of ``lead``, on the
        communicator's device."""
        return to_device(lead.index_select(0, self._down), self.comm.device)


class HanModule:
    """Two-level composed collectives over stacked tensors (N, *s)."""

    def __init__(self, comm, groups: List[List[int]]):
        self.comm = comm
        self._groups = groups
        self._h: Optional[Hierarchy] = None

    @property
    def h(self) -> Hierarchy:
        if self._h is None:
            self._h = Hierarchy(self.comm, self._groups)
        return self._h

    # -- dynamic rule table (coll_han_dynamic.c) -----------------------
    def _strategy(self, func: str, nbytes: int) -> str:
        """'hier' (compose levels) or 'flat' (delegate to the next
        component) per the dynamic table."""
        rules = _dynamic_rules()
        for rule in rules.get(func, []):
            if nbytes <= int(rule.get("max_bytes", 1 << 62)):
                return rule.get("algorithm", "hier")
        # default: the hierarchy pays off except for tiny messages, where
        # the extra level's latency dominates (barrier is latency-only
        # and always takes the two-tier fan-in)
        if func == "barrier":
            return "hier"
        return "flat" if nbytes <= 256 else "hier"

    def _flat(self, func: str):
        """The next-priority provider of ``func`` below han (the
        reference's fallback module pointer)."""
        for _prio, comp, module in self.comm._coll_selected:
            if comp.name == "han":
                continue
            m = getattr(module, func, None)
            if m is not None:
                return m
        raise RuntimeError(f"no fallback provider for {func}")

    # -- collectives ---------------------------------------------------
    def allreduce(self, x, op: op_mod.Op = op_mod.SUM):
        if self._strategy("allreduce", int(getattr(x, "nbytes", 0))) \
                == "flat":
            return self._flat("allreduce")(x, op)
        h = self.h
        x = to_device(x, self.comm.device)
        # level 1: intra-group allreduce on each low comm
        partials = [low.allreduce(sub, op)
                    for low, sub in zip(h.low, h.low_parts(x))]
        # level 2: the leaders' allreduce across groups (the up tier)
        reduced = h.up.allreduce(h.leader_stack([p[0] for p in partials]),
                                 op)
        # level 3: the result goes back down the low tier
        return h.down(reduced)

    def bcast(self, x, root: int = 0):
        if self._strategy("bcast", int(getattr(x, "nbytes", 0))) == "flat":
            return self._flat("bcast")(x, root)
        h = self.h
        x = to_device(x, self.comm.device)
        root_gi = int(h.group_of[root])
        # up tier: the root's row reaches every leader
        lead = h.leader_stack([x[root]] * len(h.leaders))
        lead_out = h.up.bcast(lead, root_gi)
        # low tier: each leader's row fills its group
        return h.down(lead_out)

    def reduce(self, x, op: op_mod.Op = op_mod.SUM, root: int = 0):
        if self._strategy("reduce", int(getattr(x, "nbytes", 0))) == "flat":
            return self._flat("reduce")(x, op, root)
        h = self.h
        x = to_device(x, self.comm.device)
        partials = [low.allreduce(sub, op)
                    for low, sub in zip(h.low, h.low_parts(x))]
        root_gi = int(h.group_of[root])
        red = h.up.reduce(h.leader_stack([p[0] for p in partials]), op,
                          root_gi)
        out = torch.zeros_like(x)
        out[root] = to_device(red[root_gi], self.comm.device)
        return out

    def allgather(self, x):
        if self._strategy("allgather",
                          int(getattr(x, "nbytes", 0))) == "flat":
            return self._flat("allgather")(x)
        h = self.h
        x = to_device(x, self.comm.device)
        n = self.comm.size
        # the low tier gathers per group; the leaders exchange their
        # group blocks over the up tier (v-collective: group sizes may
        # differ)
        gathered = [low.allgather(sub)[0]
                    for low, sub in zip(h.low, h.low_parts(x))]
        blocks = h.up.allgatherv([to_device(g, h.up.device).reshape(-1)
                                  for g in gathered])
        full = blocks[0].reshape((n,) + tuple(x.shape[1:]))
        # rows arrive in group order; permute back to rank order
        full = to_device(full.index_select(0, h._pos), self.comm.device)
        return full.unsqueeze(0).expand((n,) + tuple(full.shape)) \
            .contiguous()

    def barrier(self) -> None:
        if self._strategy("barrier", 0) == "flat":
            self._flat("barrier")()
            return
        h = self.h
        for low in h.low:
            low.barrier()
        h.up.barrier()


def _dynamic_rules() -> Dict[str, List[dict]]:
    """The run-time rule table: MCA var ``coll_han_dynamic_rules`` names
    a JSON file {collective: [{max_bytes, algorithm}...]} (the
    coll_han_dynamic.c idea). Parsing rides tuned's mtime-memoized
    loader, so the two components' file handling cannot drift."""
    from ompi_tpu_torch.coll.tuned import _load_rules
    return _load_rules(var.var_get("coll_han_dynamic_rules", "") or "")


def _reset_rules_for_tests() -> None:
    from ompi_tpu_torch.coll import tuned
    tuned._rules_cache.clear()


class HanComponent(Component):
    name = "han"

    def register_params(self) -> None:
        var.var_register("coll", "han", "priority", vtype="int", default=35,
                         help="Selection priority of the hierarchical "
                              "composition component")
        var.var_register("coll", "han", "split", vtype="int", default=0,
                         help="Synthetic low-group size (0 = group rows "
                              "by CUDA device); models the tiers where "
                              "every row shares one device")
        var.var_register("coll", "han", "dynamic_rules", vtype="str",
                         default="",
                         help="JSON rule file keyed by collective: "
                              "[{max_bytes, algorithm: hier|flat}]")

    def comm_query(self, comm):
        if _in_construction() or getattr(comm, "_han_inner", False):
            return None                   # never recurse into own tiers
        prio = var.var_get("coll_han_priority", 35)
        if prio < 0 or getattr(comm, "is_multiprocess", False):
            # its tiers index every row of the stack; across controllers
            # coll/torch's hier schedules are the two-tier path
            return None
        groups = locality_groups(comm, var.var_get("coll_han_split", 0))
        if groups is None:
            return None                   # no hierarchy, no han
        return (prio, HanModule(comm, groups))


coll_framework.register(HanComponent())
