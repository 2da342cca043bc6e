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

Across controllers (``core/multictl``) rows are keyed by controller
first, so a low group is one controller's rows and the leaders' up tier
spans the controllers. Every controller builds every sub-comm (SPMD) and
runs the low tiers that hold its rows, on those rows (``Rows.local``);
the up tier crosses through ``coll/torch_``'s controller bodies, and the
result comes down to this controller's rows from the leader row held
here. Where a synthetic split (``coll_han_split``) gives a low group
rows on several controllers, that low tier crosses too, and a group
whose leader another controller holds takes its value by a low-tier
bcast from the leader. No step reads a row another controller holds.
One body serves every comm: where a comm spans no other controller,
every row is held here and no tier crosses.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ompi_tpu_torch.accelerator import to_device
from ompi_tpu_torch.coll.framework import coll_framework
from ompi_tpu_torch.core import multictl
from ompi_tpu_torch.core import op as op_mod
from ompi_tpu_torch.core.multictl import Rows
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.mca.base import Component
from ompi_tpu_torch.utils.locality import row_controllers, row_keys

_tls = threading.local()


def _in_construction() -> bool:
    return getattr(_tls, "constructing", False)


def locality_groups(comm, group_size: int = 0) -> Optional[List[List[int]]]:
    """Partition comm ranks into low-level groups. ``group_size`` > 0
    forces a synthetic split (rank // group_size); otherwise rows are
    grouped by their (controller,) CUDA device index. Returns None when
    the hierarchy is trivial (one group, or all singleton groups)."""
    n = comm.size
    groups: Dict[object, List[int]] = {}
    if group_size > 0:
        for r in range(n):
            groups.setdefault(r // group_size, []).append(r)
    else:
        keys = row_keys(comm.devices, row_controllers(comm))
        for r, k in enumerate(keys):
            groups.setdefault(k, []).append(r)
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
        # built lazily, inside a collective that may run on a tier's
        # worker while the user's thread creates comms on the same parent:
        # the sub-comms' tier keys derive from the parent's and the
        # hidden comms it made so far, never from its creation ordinal
        key = getattr(comm, "_tier_key", None)
        base = (None if key is None else multictl.child_key(
            key, "han", len(comm.__dict__.get("_inner_comms", ()))))
        _tls.constructing = True   # han never claims its own tiers
        try:
            subs = (comm.split(colors) if base is None
                    else comm.split(colors, _key=base))
            self.low = []
            for g in groups:
                sub = subs[g[0]]
                sub._han_inner = True   # keep han out of reselects
                self.low.append(sub)
            self.leaders = [g[0] for g in groups]
            from ompi_tpu_torch.core.group import Group
            lead = Group([comm.group.world_ranks[r] for r in self.leaders])
            up = (comm.create(lead) if base is None
                  else comm.create(lead, _key=multictl.child_key(base, "up")))
            up._han_inner = True
            self.up = up
        finally:
            _tls.constructing = False
        # freed with the parent (Communicator.free): every sub-comm the
        # split made, in color order, then the up tier
        made = {id(c): c for c in subs if c is not None}
        comm.__dict__.setdefault("_inner_comms", []).extend(
            list(made.values()) + [up])
        # index tensors, built once: the positions of each group's rows
        # held here among this controller's rows (every row, where the
        # comm spans no other controller), and the rank order of a stack
        # in group order
        at = {r: i for i, r in enumerate(comm._local)}
        self.rows = [torch.tensor([at[r] for r in g if r in at],
                                  dtype=torch.long, device=comm.device)
                     for g in groups]
        order = np.concatenate([np.asarray(g) for g in groups])
        pos = np.empty(comm.size, np.int64)
        pos[order] = np.arange(comm.size)
        self.pos = torch.tensor(pos, dtype=torch.long, device=comm.device)


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

    # -- the tiers, over the rows held here ----------------------------
    # A tier comm whose rows are all held here takes a plain stacked
    # tensor; one whose rows span controllers takes its ``Rows``.
    @staticmethod
    def _unwrap(y) -> torch.Tensor:
        return y.local if isinstance(y, Rows) else y

    def _low(self, X: torch.Tensor, fn):
        """``fn(low, buf)`` on every low tier holding rows here, each
        given its rows of ``X``; returns {group: its result rows here}."""
        h = self.h
        out = {}
        for gi, low in enumerate(h.low):
            if low._local:
                out[gi] = self._unwrap(fn(low, low._as_buffer(to_device(
                    X.index_select(0, h.rows[gi]), low.device))))
        return out

    def _up(self, rows: Dict[int, torch.Tensor],
            fn) -> Dict[int, torch.Tensor]:
        """``fn(up, buf)`` over the leaders' rows held here (``rows[gi]``
        is group gi's leader row); returns {group: its up result row}
        for the leaders held here."""
        up = self.h.up
        if not up._local:
            return {}
        y = self._unwrap(fn(up, up._as_buffer(torch.stack(
            [to_device(rows[gi], up.device) for gi in up._local]))))
        return {gi: y[i] for i, gi in enumerate(up._local)}

    def _down(self, like: torch.Tensor, lead: Dict[int, torch.Tensor],
              groups=None) -> torch.Tensor:
        """The rows held here of the result: each row takes its group's
        value, from the leader row held here, or by a low-tier bcast from
        the leader where another controller holds it."""
        h = self.h
        dev = self.comm.device
        out = torch.empty((len(self.comm._local),) + tuple(like.shape),
                          dtype=like.dtype, device=dev)
        for gi, low in enumerate(h.low):
            if not low._local or (groups is not None and gi not in groups):
                continue
            if low.is_multiprocess:
                # every controller of the group joins; the leader's
                # controller writes its row
                buf = low.alloc(tuple(like.shape), like.dtype)
                if 0 in low._local:
                    buf.local[0] = lead[gi]
                val = low.bcast(buf, 0).local[0]
            else:
                val = lead[gi]
            out.index_copy_(0, h.rows[gi], to_device(val, dev).unsqueeze(
                0).expand((h.rows[gi].numel(),) + tuple(like.shape)))
        return out

    # -- collectives ---------------------------------------------------
    def allreduce(self, x, op: op_mod.Op = op_mod.SUM):
        if self._strategy("allreduce", int(getattr(x, "nbytes", 0))) \
                == "flat":
            return self._flat("allreduce")(x, op)
        comm = self.comm
        X = comm._local_rows(x)
        if not comm._local:
            return comm._as_buffer(X.clone())
        # level 1: intra-group allreduce on each low comm
        part = self._low(X, lambda c, b: c.allreduce(b, op))
        lead = {gi: p[0] for gi, p in part.items()
                if 0 in self.h.low[gi]._local}
        # level 2: the leaders' allreduce across groups (the up tier)
        red = self._up(lead, lambda c, b: c.allreduce(b, op))
        # level 3: the result goes back down the low tier
        return comm._as_buffer(self._down(X[0], red))

    def bcast(self, x, root: int = 0):
        if self._strategy("bcast", int(getattr(x, "nbytes", 0))) == "flat":
            return self._flat("bcast")(x, root)
        h = self.h
        comm = self.comm
        X = comm._local_rows(x)
        if not comm._local:
            return comm._as_buffer(X.clone())
        rg = int(h.group_of[root])
        low = h.low[rg]
        k = h.groups[rg].index(root)          # the root's low-tier rank
        lead = {}
        if low._local and low.is_multiprocess \
                and low.controller_of(0) != low.controller_of(k):
            # the root's row reaches its leader over its low tier first
            y = self._unwrap(low.bcast(low._as_buffer(
                X.index_select(0, h.rows[rg])), k))
            if 0 in low._local:
                lead[rg] = y[0]
        elif 0 in low._local and root in comm._local:
            lead[rg] = X[comm._local.index(root)]
        for gi in h.up._local:                # only the root group's row
            lead.setdefault(gi, X[0])         # is read
        # up tier: the root's row reaches every leader; the low tier
        # fills each group from its leader
        out = self._up(lead, lambda c, b: c.bcast(b, rg))
        return comm._as_buffer(self._down(X[0], out))

    def reduce(self, x, op: op_mod.Op = op_mod.SUM, root: int = 0):
        if self._strategy("reduce", int(getattr(x, "nbytes", 0))) == "flat":
            return self._flat("reduce")(x, op, root)
        h = self.h
        comm = self.comm
        X = comm._local_rows(x)
        out = torch.zeros_like(X)
        if not comm._local:
            return comm._as_buffer(out)
        rg = int(h.group_of[root])
        part = self._low(X, lambda c, b: c.allreduce(b, op))
        lead = {gi: p[0] for gi, p in part.items()
                if 0 in h.low[gi]._local}
        red = self._up(lead, lambda c, b: c.reduce(b, op, rg))
        # the root group's leader holds the total; its low tier brings it
        # to the root's row
        val = self._down(X[0], red, groups=(rg,))
        if root in comm._local:
            i = comm._local.index(root)
            out[i] = val[i]
        return comm._as_buffer(out)

    def allgather(self, x):
        if self._strategy("allgather",
                          int(getattr(x, "nbytes", 0))) == "flat":
            return self._flat("allgather")(x)
        h = self.h
        comm = self.comm
        X = comm._local_rows(x)
        n = comm.size
        s = tuple(X.shape[1:])
        if not comm._local:
            return comm._as_buffer(X.new_empty((0, n) + s))
        # the low tier gathers per group; the leaders exchange their group
        # blocks, padded to the largest group, over the up tier
        gmax = max(len(g) for g in h.groups)
        blocks = self._low(X, lambda c, b: c.allgather(b))
        lead = {}
        for gi, b in blocks.items():
            if 0 in h.low[gi]._local:
                blk = b[0]
                pad = blk.new_zeros((gmax - blk.shape[0],) + s)
                lead[gi] = torch.cat([blk, pad]) if pad.shape[0] else blk
        got = self._up(lead, lambda c, b: c.allgather(b))
        full = None
        if got:
            every = to_device(next(iter(got.values())), comm.device)
            # rows arrive in group order, (n_up, gmax, *s); permute back
            # to rank order
            full = torch.cat([every[gi][:len(g)] for gi, g in
                              enumerate(h.groups)]).index_select(0, h.pos)
        return comm._as_buffer(self._down(X.new_empty((n,) + s),
                                          {gi: full for gi in got}))

    def barrier(self) -> None:
        if self._strategy("barrier", 0) == "flat":
            self._flat("barrier")()
            return
        h = self.h
        for low in h.low:
            if low._local:
                low.barrier()
        if h.up._local:
            h.up.barrier()
        for low in h.low:                 # the fan-out of a spanning group
            if low._local and low.is_multiprocess:
                low.barrier()


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
                              "by controller, then CUDA device); models "
                              "the tiers where every row shares one device")
        var.var_register("coll", "han", "dynamic_rules", vtype="str",
                         default="",
                         help="JSON rule file keyed by collective: "
                              "[{max_bytes, algorithm: hier|flat}]")

    def comm_query(self, comm):
        if _in_construction() or getattr(comm, "_han_inner", False):
            return None                   # never recurse into own tiers
        prio = var.var_get("coll_han_priority", 35)
        if prio < 0:
            return None
        groups = locality_groups(comm, var.var_get("coll_han_split", 0))
        if groups is None:
            return None                   # no hierarchy, no han
        return (prio, HanModule(comm, groups))


coll_framework.register(HanComponent())
