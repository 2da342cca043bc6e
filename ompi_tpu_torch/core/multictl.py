"""The multi-controller world: one COMM_WORLD over several controller
processes.

Behavioral spec: the JAX package's multi-controller model
(``ompi_tpu/runtime/init.py:102-122``, ``core/communicator.py:141-219``):
``mpirun --coordinator host:port --num-hosts H --host-id I`` starts one
controller process per host; each calls ``Init`` with its local devices,
and the world's ranks are every controller's rows in controller order,
so controller h holds ranks ``[sum of L_g for g < h, ...)``. A
communicator whose rows are not all on this controller is
*multiprocess*; one whose rows sit on more than one controller *spans
processes* (the fact that turns on the hier rows of ``coll/decision``).

The port's controllers talk over the per-rank tier: the controllers of a
communicator form a hidden ``RankCommunicator`` (one member per
controller, CID ``("mc", controllers)``, wired through
``pml/perrank.Router`` and the job's ``TCPStore``), and a tensor payload
crosses through that tier's device slots (CUDA IPC on the card, shared
memory segments on the CPU) without touching the host. The hidden CID
keeps its traffic apart from any user communicator.

A multiprocess communicator's stacked buffers are :class:`Rows`: this
controller's rows of the global ``(N, *local)`` stack, in rank order,
with the global shape. A controller holds O(L) rows, never the whole
stack; reading a row another controller holds raises ``ERR_RANK``
(``Communicator.shard``), as the reference's does.

This module keeps the process's controller table (world rank ->
controller), this controller's index and device, and the hidden tiers.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_state: Dict[str, object] = {
    "ctl": None,          # world rank -> controller index, or None
    "me": 0,              # this controller's index
    "router": None,       # the controllers' per-rank Router
    "device": None,       # this controller's device
    "tiers": {},          # controllers tuple -> hidden RankCommunicator
}


def configure(ctl: Sequence[int], me: int, router, device) -> None:
    """Enter multi-controller mode (``runtime/init``): ``ctl[w]`` is the
    controller of world rank ``w``."""
    _state.update(ctl=tuple(int(c) for c in ctl), me=int(me), router=router,
                  device=torch.device(device), tiers={})


def active() -> bool:
    return _state["ctl"] is not None


def me() -> int:
    return int(_state["me"])


def device() -> Optional[torch.device]:
    return _state["device"]


def controllers_of(world_ranks: Sequence[int]) -> Optional[Tuple[int, ...]]:
    """The controller of each of ``world_ranks``; None outside a
    multi-controller world."""
    ctl = _state["ctl"]
    if ctl is None:
        return None
    return tuple(ctl[w] for w in world_ranks)


def tier(ctrls: Tuple[int, ...]):
    """The hidden controller tier over ``ctrls`` (sorted controller
    indices, this one among them), made on first use. Every controller of
    the set builds the same one: its CID is a function of the set."""
    tiers = _state["tiers"]
    t = tiers.get(ctrls)
    if t is None:
        from ompi_tpu_torch.core.group import Group
        from ompi_tpu_torch.core.rankcomm import RankCommunicator
        t = tiers[ctrls] = RankCommunicator(
            Group(list(ctrls)), me(), _state["router"], _state["device"],
            cid=("mc",) + tuple(ctrls), name=f"controllers{list(ctrls)}")
    return t


def close() -> None:
    """Finalize: free the hidden tiers and leave multi-controller mode
    (the router is closed by ``runtime/init``)."""
    for t in list(_state["tiers"].values()):
        try:
            t.free()
        except Exception:                # noqa: BLE001 — teardown
            pass
    _reset_for_tests()


def _reset_for_tests() -> None:
    """Forget the controller table and tiers without fencing (the test
    reset closes the router)."""
    _state.update(ctl=None, me=0, router=None, device=None, tiers={})


class Rows:
    """This controller's rows of a multiprocess communicator's stacked
    buffer: ``local`` is an ``(L, *s)`` tensor on the controller's device
    holding ranks ``ranks`` (ascending) of an ``n``-rank stack; ``key``
    names the communicator's rows (its members' world ranks), so a buffer
    of another communicator is refused. ``shape`` and ``nbytes`` are the
    global stack's."""

    __slots__ = ("local", "ranks", "n", "key")

    def __init__(self, local: torch.Tensor, ranks: Sequence[int], n: int,
                 key: Tuple[int, ...]):
        self.local = local
        self.ranks = tuple(ranks)
        self.n = int(n)
        self.key = key

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.n,) + tuple(self.local.shape[1:])

    @property
    def ndim(self) -> int:
        return self.local.dim()

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def nbytes(self) -> int:
        per = int(np.prod(self.local.shape[1:], dtype=np.int64))
        return self.n * per * self.local.element_size()

    def row(self, rank: int) -> Optional[torch.Tensor]:
        """Rank ``rank``'s row, or None when another controller holds
        it."""
        try:
            return self.local[self.ranks.index(rank)]
        except ValueError:
            return None

    def like(self, local: torch.Tensor) -> "Rows":
        """A buffer of the same rows holding ``local``."""
        return Rows(local, self.ranks, self.n, self.key)

    def __repr__(self):
        return (f"Rows(shape={self.shape}, ranks={list(self.ranks)}, "
                f"dtype={self.dtype}, device={self.local.device})")


class Layout:
    """Where a multiprocess communicator's ranks live: ``parts[g]`` is
    the ascending comm ranks of its g-th controller (controllers in
    ascending order, only those holding rows), ``h`` this controller's
    position, ``ordered`` whether concatenating the parts gives rank
    order (then a fold in controller order is a fold in rank order), and
    ``perm`` the index that puts concatenated rows into rank order."""

    def __init__(self, ctl: Sequence[int], me_: int):
        self.ctrls = tuple(sorted(set(ctl)))
        self.parts: List[Tuple[int, ...]] = [
            tuple(r for r, c in enumerate(ctl) if c == g) for g in self.ctrls]
        self.h = self.ctrls.index(me_) if me_ in self.ctrls else -1
        flat = [r for p in self.parts for r in p]
        self.ordered = flat == sorted(flat)
        self.perm = np.argsort(np.asarray(flat, dtype=np.int64))
        self.sizes = [len(p) for p in self.parts]
        self.offs = np.concatenate([[0], np.cumsum(self.sizes)]).astype(
            np.int64)

    @property
    def mine(self) -> Tuple[int, ...]:
        return self.parts[self.h] if self.h >= 0 else ()
