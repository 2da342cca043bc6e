"""coll/xhc — n-level hierarchical intra-node collectives. The port of
``ompi_tpu/coll/xhc.py``.

Behavioral spec: ``ompi/mca/coll/xhc`` — builds an n-level hierarchy from
hwloc locality (NUMA / socket / cache levels, ``xhc/README.md``) and runs
each collective level by level over shared memory: members combine into
their level leader, leaders repeat one level up, and the result fans back
down.

Here "shared memory" is the communicator's stacked tensor on its device:
combining into a leader is an index gather of the level's rows and
``Op.reduce_tree`` over them, written into the leaders' rows; fanning
down is a row broadcast. Nothing leaves the device. Levels come from the
MCA var ``coll_xhc_levels`` ("2,2" = pairs, then pairs of leaders), else
from device locality (rows grouped by (controller,) CUDA device index),
else from the host ladder of ``utils/locality`` — on one card every row
shares the device, so the ladder comes from the host, as the reference's
does on its flat CPU mesh. Unlike han (which composes components over
sub-communicators), xhc owns the whole ladder.

Across controllers (``core/multictl``) a buffer is this controller's
rows (``multictl.Rows``). A level's groups whose members are all held
here fold on those rows, as above; a group that spans controllers has
its remote members' rows shipped to its leader's controller in one
exchange per level over the controller tier, and folds there in group
order. The fan-down is one tier bcast from the source row's controller.
With the ladder keyed by controller, only the top level crosses. One
body serves every comm: where a comm spans no other controller, every
row is held here and no level crosses.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ompi_tpu_torch.coll.framework import coll_framework
from ompi_tpu_torch.core import multictl
from ompi_tpu_torch.core import op as op_mod
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.mca.base import Component
from ompi_tpu_torch.utils.locality import row_controllers, row_keys


def build_levels(n: int, sizes: List[int]) -> List[List[List[int]]]:
    """Partition ranks into an n-level ladder. ``sizes[l]`` is the group
    size at level l (innermost first). Returns per level the list of
    groups (each a list of member ranks); level l's members are level
    l-1's leaders. A final top level groups all remaining leaders."""
    levels: List[List[List[int]]] = []
    members = list(range(n))
    for s in sizes:
        if s <= 1 or len(members) <= 1:
            break
        groups = [members[i:i + s] for i in range(0, len(members), s)]
        levels.append(groups)
        members = [g[0] for g in groups]
    if len(members) > 1:
        levels.append([members])
    return levels


def locality_sizes(devices, controllers=None) -> Optional[List[int]]:
    """Ladder sizes from device locality: rows per (controller,) CUDA
    device (innermost), then everything. None if the ladder is trivial
    (one domain, or one row per domain)."""
    per_dev: Dict[object, int] = {}
    for k in row_keys(devices, controllers):
        per_dev[k] = per_dev.get(k, 0) + 1
    if len(per_dev) <= 1:
        return None
    per = max(per_dev.values())
    return [per] if per > 1 else None


class XhcModule:
    def __init__(self, comm, sizes: List[int]):
        self.comm = comm
        self.levels = build_levels(comm.size, sizes)
        self._plan: Optional[List[Tuple]] = None

    def _level_plan(self) -> List[Tuple]:
        """Per level: (steps, cross). ``steps`` folds the groups whose
        rows are all held here: per group width, (member positions,
        leader positions, width) over this controller's rows, as index
        tensors on the device (built once, never per call). ``cross`` is
        None unless a group spans controllers; then it ships the group's
        remote members' rows to its leader's controller in one tier round
        (``multictl.ship_rows``): (counts, the positions of the rows sent
        from here, grouped by destination), and per spanning group led
        here its leader's position and each member's (source controller,
        index), in group order (source -1: held here). A comm that spans
        no other controller holds every row here and never crosses.
        Every controller builds the same plan from the global layout."""
        if self._plan is None:
            comm = self.comm
            lay = comm.layout
            dev = comm.device
            pos = {r: i for i, r in enumerate(comm._local)}
            at = [lay.ctrls.index(comm.controller_of(r))
                  for r in range(comm.size)]
            me = lay.h
            nc = len(lay.ctrls)
            plan = []
            for groups in self.levels:
                by_width: Dict[int, List[List[int]]] = {}
                spanning = []
                for g in groups:
                    owners = {at[r] for r in g}
                    if len(owners) > 1:
                        spanning.append(g)
                    elif len(g) > 1 and owners == {me}:
                        by_width.setdefault(len(g), []).append(g)
                steps = []
                for width, gs in sorted(by_width.items()):
                    steps.append((
                        torch.tensor([pos[r] for g in gs for r in g],
                                     dtype=torch.long, device=dev),
                        torch.tensor([pos[g[0]] for g in gs],
                                     dtype=torch.long, device=dev), width))
                cross = None
                if spanning:
                    # (source, destination, rank) of every shipped row,
                    # in the order each source writes them
                    ship = sorted((at[r], at[g[0]], r) for g in spanning
                                  for r in g[1:] if at[r] != at[g[0]])
                    counts = [[0] * nc for _ in range(nc)]
                    where, k = {}, [0] * nc
                    for src, dst, r in ship:
                        counts[src][dst] += 1
                        if dst == me:
                            where[r] = (src, k[src])
                            k[src] += 1
                    send = torch.tensor([pos[r] for src, _d, r in ship
                                         if src == me],
                                        dtype=torch.long, device=dev)
                    folds = [(pos[g[0]], [(-1, pos[r]) if at[r] == me
                                          else where[r] for r in g])
                             for g in spanning if at[g[0]] == me]
                    cross = (counts, send, folds)
                plan.append((steps, cross))
            self._plan = plan
        return self._plan

    @property
    def _top(self) -> int:
        return self.levels[-1][0][0] if self.levels else 0

    # -- the ladder passes --------------------------------------------
    def _reduce_up(self, X: torch.Tensor, op: op_mod.Op) -> torch.Tensor:
        """Combine members into leaders, level by level, over this
        controller's rows ``X`` (L, *s); returns a new tensor whose every
        level's leader row held here holds its subtree reduction (the top
        leader holds the total)."""
        X = X.clone()
        s = tuple(X.shape[1:])
        for steps, cross in self._level_plan():
            for members, leaders, width in steps:
                rows = X.index_select(0, members).view(
                    (leaders.numel(), width) + s)
                X.index_copy_(0, leaders, op.reduce_tree(rows, axis=1))
            if cross is None:
                continue
            counts, send, folds = cross
            got = multictl.ship_rows(self.comm.layout.ctrls, counts,
                                     X.index_select(0, send))
            for lead, members in folds:
                rows = torch.stack([X[i] if src < 0 else got[src][i]
                                    for src, i in members])
                X[lead] = op.reduce_tree(rows, axis=0)
        return X

    def _row(self, X: torch.Tensor, src: int) -> torch.Tensor:
        """Comm rank ``src``'s row of ``X`` (this controller's rows), on
        every controller: a tier bcast from the controller holding it
        where the comm spans controllers."""
        comm = self.comm
        lay = comm.layout
        if len(lay.ctrls) == 1:
            return X[comm._local.index(src)]
        g = lay.ctrls.index(comm.controller_of(src))
        row = (X[comm._local.index(src)] if g == lay.h
               else X.new_empty(X.shape[1:]))
        return multictl.bcast(lay.ctrls, row, g)

    def _fan_down(self, X: torch.Tensor, one: torch.Tensor):
        """Every row held here takes ``one``, as the comm's buffer."""
        return self.comm._as_buffer(
            one.unsqueeze(0).expand(X.shape).contiguous())

    # -- collectives ----------------------------------------------------
    def allreduce(self, x, op: op_mod.Op = op_mod.SUM):
        X = self.comm._local_rows(x)
        if not self.comm._local:
            return self.comm._as_buffer(X.clone())
        up = self._reduce_up(X, op)
        return self._fan_down(X, self._row(up, self._top))

    def reduce(self, x, op: op_mod.Op = op_mod.SUM, root: int = 0):
        comm = self.comm
        X = comm._local_rows(x)
        out = torch.zeros_like(X)
        if not comm._local:
            return comm._as_buffer(out)
        up = self._reduce_up(X, op)
        lay = comm.layout
        g_top = lay.ctrls.index(comm.controller_of(self._top))
        g_root = lay.ctrls.index(comm.controller_of(root))
        if g_top == g_root:
            if lay.h == g_top:
                out[comm._local.index(root)] = up[
                    comm._local.index(self._top)]
            return comm._as_buffer(out)
        # the total crosses to the root's controller only
        counts = [[0] * len(lay.ctrls) for _ in lay.ctrls]
        counts[g_top][g_root] = 1
        send = (up[comm._local.index(self._top)].unsqueeze(0)
                if lay.h == g_top else up[:0])
        got = multictl.ship_rows(lay.ctrls, counts, send)
        if lay.h == g_root:
            out[comm._local.index(root)] = got[g_top][0]
        return comm._as_buffer(out)

    def bcast(self, x, root: int = 0):
        X = self.comm._local_rows(x)
        if not self.comm._local:
            return self.comm._as_buffer(X.clone())
        return self._fan_down(X, self._row(X, root))

    def barrier(self) -> None:
        self.allreduce(self.comm.alloc((1,), fill=1.0), op_mod.SUM)
        if self.comm.device.type == "cuda":
            torch.cuda.synchronize(self.comm.device)


class XhcComponent(Component):
    name = "xhc"

    def register_params(self) -> None:
        var.var_register("coll", "xhc", "priority", vtype="int", default=25,
                         help="Selection priority of the n-level "
                              "hierarchical component")
        var.var_register("coll", "xhc", "levels", vtype="str", default="",
                         help="Comma list of group sizes per level, "
                              "innermost first (empty = device locality, "
                              "then the host ladder)")

    def comm_query(self, comm):
        from ompi_tpu_torch.coll import han as _han
        if _han._in_construction() or getattr(comm, "_han_inner", False):
            return None
        prio = var.var_get("coll_xhc_priority", 25)
        if prio < 0:
            return None
        spec = (var.var_get("coll_xhc_levels", "") or "").strip()
        basis = "var"
        if spec:
            try:
                sizes = [int(s) for s in spec.split(",") if s.strip()]
            except ValueError:
                return None
        else:
            ctls = row_controllers(comm)
            sizes = locality_sizes(comm.devices, ctls)
            if sizes is None:
                # the hwloc-depth walk: OS topology levels, else a
                # labeled synthetic factorization
                from ompi_tpu_torch.utils.locality import ladder_sizes
                sizes, basis = ladder_sizes(comm.size, comm.devices, ctls)
                if sizes is None:
                    return None
            else:
                basis = "device-locality"
        if comm.size <= 1 or not sizes:
            return None
        mod = XhcModule(comm, sizes)
        mod.level_basis = basis          # provenance for introspection
        return (prio, mod)


coll_framework.register(XhcComponent())
