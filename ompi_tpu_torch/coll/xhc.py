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
from device locality (rows grouped by CUDA device index), else from the
host ladder of ``utils/locality`` — on one card every row shares the
device, so the ladder comes from the host, as the reference's does on
its flat CPU mesh. Unlike han (which composes components over
sub-communicators), xhc owns the whole ladder.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ompi_tpu_torch.accelerator import to_device
from ompi_tpu_torch.coll.framework import coll_framework
from ompi_tpu_torch.core import op as op_mod
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.mca.base import Component
from ompi_tpu_torch.utils.locality import device_key


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


def locality_sizes(devices) -> Optional[List[int]]:
    """Ladder sizes from device locality: rows per CUDA device
    (innermost), then everything. None if the ladder is trivial (one
    device, or one row per device)."""
    per_dev: Dict[int, int] = {}
    for d in devices:
        k = device_key(d)
        per_dev[k] = per_dev.get(k, 0) + 1
    if len(per_dev) <= 1:
        return None
    per = max(per_dev.values())
    return [per] if per > 1 else None


class XhcModule:
    def __init__(self, comm, sizes: List[int]):
        self.comm = comm
        self.levels = build_levels(comm.size, sizes)
        # per level: (member rows, leader rows, group width) for each
        # group width present, as index tensors on the device (built
        # once, never per call)
        self._plan: Optional[List[List[Tuple]]] = None

    def _level_plan(self) -> List[List[Tuple]]:
        if self._plan is None:
            dev = self.comm.device
            plan = []
            for groups in self.levels:
                by_width: Dict[int, List[List[int]]] = {}
                for g in groups:
                    if len(g) > 1:
                        by_width.setdefault(len(g), []).append(g)
                steps = []
                for width, gs in sorted(by_width.items()):
                    members = torch.tensor([r for g in gs for r in g],
                                           dtype=torch.long, device=dev)
                    leaders = torch.tensor([g[0] for g in gs],
                                           dtype=torch.long, device=dev)
                    steps.append((members, leaders, width))
                plan.append(steps)
            self._plan = plan
        return self._plan

    @property
    def _top(self) -> int:
        return self.levels[-1][0][0] if self.levels else 0

    # -- the ladder passes --------------------------------------------
    def _reduce_up(self, xg: torch.Tensor, op: op_mod.Op) -> torch.Tensor:
        """Combine members into leaders, level by level; returns a new
        tensor whose every level's leader row holds its subtree
        reduction (the top leader holds the total)."""
        xg = xg.clone()
        for steps in self._level_plan():
            for members, leaders, width in steps:
                rows = xg.index_select(0, members)
                rows = rows.view((leaders.numel(), width)
                                 + tuple(xg.shape[1:]))
                xg.index_copy_(0, leaders, op.reduce_tree(rows, axis=1))
        return xg

    def _fan_down(self, xg: torch.Tensor, src_row: int) -> torch.Tensor:
        """Broadcast ``src_row``'s value down the ladder."""
        return xg[src_row].unsqueeze(0).expand(xg.shape).contiguous()

    def allreduce(self, x, op: op_mod.Op = op_mod.SUM):
        up = self._reduce_up(to_device(x, self.comm.device), op)
        return self._fan_down(up, self._top)

    def reduce(self, x, op: op_mod.Op = op_mod.SUM, root: int = 0):
        up = self._reduce_up(to_device(x, self.comm.device), op)
        out = torch.zeros_like(up)
        out[root] = up[self._top]
        return out

    def bcast(self, x, root: int = 0):
        return self._fan_down(to_device(x, self.comm.device), root)

    def barrier(self) -> None:
        token = torch.ones((self.comm.size, 1), dtype=torch.float32,
                           device=self.comm.device)
        self.allreduce(token, op_mod.SUM)
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
        if prio < 0 or getattr(comm, "is_multiprocess", False):
            return None                   # the ladder indexes every row
        spec = (var.var_get("coll_xhc_levels", "") or "").strip()
        basis = "var"
        if spec:
            try:
                sizes = [int(s) for s in spec.split(",") if s.strip()]
            except ValueError:
                return None
        else:
            sizes = locality_sizes(comm.devices)
            if sizes is None:
                # the hwloc-depth walk: OS topology levels, else a
                # labeled synthetic factorization
                from ompi_tpu_torch.utils.locality import ladder_sizes
                sizes, basis = ladder_sizes(comm.size, comm.devices)
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
