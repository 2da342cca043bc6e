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
controller, wired through ``pml/perrank.Router`` and the job's
``TCPStore``), and a tensor payload crosses through that tier's device
slots (CUDA IPC on the card, shared memory segments on the CPU) without
touching the host. Every spanning communicator has a tier of its own,
CID ``("mc", key, controllers)``: its own round sequence, collective
worker and slots, so its rounds meet only its own rounds on the other
controllers (MPI orders collectives per communicator, not across
communicators), and two comms' nonblocking collectives started in
opposite orders run side by side instead of waiting on each other.

The *tier key* names a communicator alike on every controller without a
round: the world's and every parentless comm's is a function of its
world ranks, a tag and how many comms this process made over the same
(ranks, tag) (:func:`root_key`); a child's is a function of its
parent's key, the ordinal of the creation call on the parent and, for a
split, the color (:func:`child_key`). MPI orders the creation calls on
one communicator alike on every member, so the ordinal agrees; a
communicator's ``cid`` is a process-local counter and does not (a
controller may create comms that the others do not). A tier is made at
the comm's first crossing and freed with the comm (``Communicator.free``)
or at Finalize (:func:`close`).

A multiprocess communicator's stacked buffers are :class:`Rows`: this
controller's rows of the global ``(N, *local)`` stack, in rank order,
with the global shape. A controller holds O(L) rows, never the whole
stack; reading a row another controller holds raises ``ERR_RANK``
(``Communicator.shard``), as the reference's does.

This module keeps the process's controller table (world rank ->
controller), this controller's index and device, and the hidden tiers.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_state: Dict[str, object] = {
    "ctl": None,          # world rank -> controller index, or None
    "me": 0,              # this controller's index
    "router": None,       # the controllers' per-rank Router
    "device": None,       # this controller's device
    "tiers": {},          # (tier key, controllers) -> RankCommunicator
    "roots": {},          # (world ranks, tag) -> parentless comms made
    "holds": [],          # release callbacks of the held tasks (hold)
}
_lock = threading.Lock()


def configure(ctl: Sequence[int], me: int, router, device) -> None:
    """Enter multi-controller mode (``runtime/init``): ``ctl[w]`` is the
    controller of world rank ``w``."""
    _state.update(ctl=tuple(int(c) for c in ctl), me=int(me), router=router,
                  device=torch.device(device), tiers={}, roots={}, holds=[])


def active() -> bool:
    return _state["ctl"] is not None


def me() -> int:
    return int(_state["me"])


def nranks() -> int:
    """The world's rank count (0 outside a multi-controller world)."""
    return len(_state["ctl"] or ())


def device() -> Optional[torch.device]:
    return _state["device"]


def controllers_of(world_ranks: Sequence[int]) -> Optional[Tuple[int, ...]]:
    """The controller of each of ``world_ranks``; None outside a
    multi-controller world."""
    ctl = _state["ctl"]
    if ctl is None:
        return None
    return tuple(ctl[w] for w in world_ranks)


# -- tier keys ---------------------------------------------------------------
def child_key(parent: str, *parts) -> str:
    """The tier key of a communicator derived from ``parent``'s by
    ``parts`` (the creation ordinal, a split's color): a short digest,
    alike on every controller that derives it from the same values."""
    return hashlib.sha1(repr((parent,) + parts).encode()).hexdigest()[:16]


def root_key(world_ranks: Sequence[int], tag: str) -> str:
    """The tier key of a communicator made from no parent (the world, a
    Session's ``comm_create_from_group``, an intercomm merge): its world
    ranks, ``tag``, and how many such comms this process made before over
    the same (ranks, tag), which agrees across controllers because every
    controller makes them in program order (MPI-4's matching rule for
    ``comm_create_from_group``)."""
    k = (tuple(int(w) for w in world_ranks), str(tag))
    with _lock:
        roots = _state["roots"]
        n = roots[k] = roots.get(k, -1) + 1
    return child_key("root", k, n)


# -- the hidden tiers ---------------------------------------------------------
def tier(lay: "Layout"):
    """The hidden controller tier of the communicator laid out as ``lay``
    (its tier key and controllers, this one among them), made on first
    use. Every controller of the comm builds the same one: its CID is a
    function of the key and the controller set."""
    k = (lay.key, lay.ctrls)
    with _lock:
        t = _state["tiers"].get(k)
        if t is None:
            from ompi_tpu_torch.core.group import Group
            from ompi_tpu_torch.core.rankcomm import RankCommunicator
            t = _state["tiers"][k] = RankCommunicator(
                Group(list(lay.ctrls)), me(), _state["router"],
                _state["device"], cid=("mc",) + k,
                name=f"controllers{list(lay.ctrls)}:{lay.key}")
    return t


def run(lay: "Layout", body: str, *args):
    """``body`` (a device-slot method of ``RankCommunicator``:
    ``_device_exchange``, ``_device_allreduce``, ``_device_bcast``) of
    the comm's hidden tier, on the tier's collective context. The tier's
    own entries are not the user's collectives: no SPC count, hook or
    interposer sees them. Releases every held task first (:func:`hold`)."""
    release()
    t = tier(lay)
    t._check()
    return t._coll_serial(getattr(t, body), *args)


def submit(lay: "Layout", fn) -> None:
    """Queue ``fn`` on the collective worker of the comm's tier, behind
    the comm's earlier requests (alike on every controller), after
    releasing every held task (:func:`hold`)."""
    release()
    tier(lay)._coll_submit(fn)


def hold(lay: "Layout", fn, close) -> None:
    """Queue ``fn`` on the comm's tier worker, held: the worker waits at
    it until :func:`release`, which every crossing (``run``, ``submit``)
    and every wait on another controller calls first, so nothing queued
    behind a held task waits on it, and no controller waits on a held
    task of another. ``close()`` runs at the release, on the releasing
    thread, and the worker then runs ``fn(close())``: what the caller
    issued before the release (``coll/persistent``'s bucket drain)."""
    ev = threading.Event()
    box: List[object] = []

    def rel() -> None:
        box.append(close())
        ev.set()

    def held() -> None:
        ev.wait()
        fn(box[0])
    with _lock:
        _state["holds"].append(rel)
    tier(lay)._coll_submit(held)


def release() -> None:
    """Release every held task of this controller (:func:`hold`)."""
    if not _state["holds"]:
        return
    with _lock:
        rels, _state["holds"] = _state["holds"], []
    for rel in rels:
        rel()


def ship_rows(lay: "Layout", counts: Sequence[Sequence[int]],
              rows: torch.Tensor) -> List[Optional[torch.Tensor]]:
    """Move rows between the comm's controllers ``lay.ctrls`` in one
    round of its hidden tier, on the device. ``counts[g][d]`` is how many
    rows controller ``ctrls[g]`` sends to ``ctrls[d]``, alike on every
    controller (SPMD); ``rows`` are this controller's outgoing rows
    ``(sum(counts[h]), *s)``, grouped by destination in controller order.
    Returns per source g the ``(counts[g][h], *s)`` rows it sent here
    (None where it sent none)."""
    h = lay.h
    s = tuple(rows.shape[1:])
    per = int(np.prod(s, dtype=np.int64))
    cap = max(sum(c) for c in counts) * per * rows.element_size()
    want = []
    for g, c in enumerate(counts):
        a = sum(c[:h])
        want.append((0, 0) if g == h else (a * per, (a + c[h]) * per))
    got = run(lay, "_device_exchange", rows.reshape(-1), cap, want)
    return [None if t is None else t.view((-1,) + s) for t in got]


class Take:
    """A gather along a multiprocess communicator's rank axis, planned
    once from global index arrays (alike on every controller) and applied
    to this controller's rows.

    Item ``k`` is "comm rank ``dst[k]`` takes rank ``src[k]``'s row", or,
    with ``pos``, only part of it along the row's first axis: the slice
    ``pos[k]`` (an int, or a row of ``pos`` of shape ``(m, d)``). Applied
    to ``X`` (this controller's rows ``(L, *s)``, in rank order), it
    returns the items whose ``dst`` is held here, in item order. Items
    whose source is held here are an ``index_select`` of ``X``; the
    others come in one round of the controller tier
    (:func:`ship_rows`), in which a controller writes only the slices
    another controller asks for, each once per destination controller. A
    take whose sources all sit with their destinations makes no round.
    Several tensors of the same rows (codes and scales) cross in one
    round as bytes."""

    def __init__(self, lay: Layout, n: int, dst, src, pos=None,
                 device=None):
        dst = np.asarray(dst, dtype=np.int64).reshape(-1)
        src = np.asarray(src, dtype=np.int64).reshape(-1)
        m = len(dst)
        self.lay = lay
        nc = len(lay.parts)
        at = np.zeros(n, np.int64)                 # rank -> controller
        loc = np.full(n, -1, np.int64)             # rank -> local row
        for g, part in enumerate(lay.parts):
            at[list(part)] = g
        loc[list(lay.mine)] = np.arange(len(lay.mine))
        if pos is not None:
            pos = np.asarray(pos, dtype=np.int64)
        self.dst, self.src, self.pos = dst, src, pos
        mat = pos is not None and pos.ndim == 2
        keys = [(int(s),) if pos is None else
                (int(s),) + tuple(np.atleast_1d(pos[k]).tolist())
                for k, s in enumerate(src)]

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64),
                                   device=device)

        def sel(items):
            # the index of X's slices for ``items`` (keys)
            rows = loc[[k[0] for k in items]]
            if pos is None:
                return (dev(rows),)
            cols = np.asarray([k[1:] for k in items], np.int64).reshape(
                len(items), pos.shape[1] if mat else 1)
            if mat:
                return dev(rows)[:, None], dev(cols)
            return dev(rows), dev(cols[:, 0])
        h = lay.h
        gd, gs = at[dst], at[src]
        here = np.nonzero(gd == h)[0]
        self.m_here = len(here)
        # the slices each (source, destination) pair ships: distinct, in
        # order of first need; every controller lists them alike
        ships = [[{} for _ in range(nc)] for _ in range(nc)]
        for k in range(m):
            if gs[k] != gd[k]:
                box = ships[gs[k]][gd[k]]
                box.setdefault(keys[k], len(box))
        self.counts = [[len(ships[g][d]) for d in range(nc)]
                       for g in range(nc)]
        self.cross = any(any(c) for c in self.counts)
        lk = here[gs[here] == h]                   # local-source items
        self.l_sel = sel([keys[k] for k in lk])
        self.l_out = dev(np.searchsorted(here, lk))
        self.s_sel = sel([key for d in range(nc) if d != h
                          for key in ships[h][d]])
        self.r_out, self.r_idx = [], []
        for g in range(nc):
            ks = here[gs[here] == g] if g != h else here[:0]
            self.r_out.append(dev(np.searchsorted(here, ks)))
            self.r_idx.append(dev([ships[g][h][keys[k]] for k in ks]))

    def __call__(self, *xs: torch.Tensor):
        """The items held here of each of ``xs`` (a tensor for one, a
        tuple for several)."""
        outs = [x[self.l_sel] for x in xs]
        if self.cross:
            sends = [x[self.s_sel] for x in xs]
            if len(xs) == 1:
                got = ship_rows(self.lay, self.counts, sends[0])
                parts = [got]
            else:
                # one round for every tensor: each slice crosses as bytes
                k = sends[0].shape[0]
                flat = [s.reshape(k, -1) for s in sends]
                widths = [f.shape[1] * f.element_size() for f in flat]
                got = ship_rows(self.lay, self.counts, torch.cat(
                    [f.view(torch.uint8) for f in flat], 1))
                parts = []
                at = 0
                for f, s, w in zip(flat, sends, widths):
                    parts.append([None if t is None else
                                  t[:, at:at + w].contiguous().reshape(-1)
                                  .view(f.dtype).view((-1,) + s.shape[1:])
                                  for t in got])
                    at += w
            full = []
            for x, loc, got in zip(xs, outs, parts):
                item = tuple(loc.shape[1:])
                o = loc.new_empty((self.m_here,) + item)
                o[self.l_out] = loc
                for g, t in enumerate(got):
                    if t is not None and self.r_idx[g].numel():
                        o[self.r_out[g]] = t[self.r_idx[g]]
                full.append(o)
            outs = full
        return outs[0] if len(xs) == 1 else tuple(outs)


def bcast(lay: "Layout", x: torch.Tensor, root: int) -> torch.Tensor:
    """Controller ``lay.ctrls[root]``'s ``x`` on every controller of the
    comm (one round of its hidden tier, on the device); the others pass a
    tensor of the same shape and dtype."""
    return run(lay, "_device_bcast", x, root)


def _free(ts) -> None:
    for t in ts:
        try:
            t.free()
        except Exception:                # noqa: BLE001 — teardown
            pass


def free_tiers(key: str) -> None:
    """Free the hidden tiers of the communicator whose tier key is
    ``key``: each drains its worker, fences and drops its slots and
    mappings (``RankCommunicator.free``). ``MPI_Comm_free`` is
    collective, so every controller of the comm frees it at the same
    point; a comm that never crossed has none."""
    release()
    with _lock:
        tiers = _state["tiers"]
        ks = sorted(k for k in tiers if k[0] == key)
        ts = [tiers[k] for k in ks]
    _free(ts)          # each drains its worker first: that work finds it
    with _lock:
        for k in ks:
            _state["tiers"].pop(k, None)


def live() -> Dict[str, int]:
    """The live tiers of this controller: how many, their collective
    workers alive, and their slots' bytes (both parity regions of this
    controller's exported slot)."""
    with _lock:
        ts = list(_state["tiers"].values())
    slots = [t._slots for t in ts if t._slots is not None]
    return {"tiers": len(ts),
            "workers": sum(1 for t in ts if t._cworker is not None
                           and t._cworker.is_alive()),
            "slot_bytes": sum(2 * s.cap for s in slots
                              if s.buf is not None)}


def close() -> None:
    """Finalize: free the hidden tiers and leave multi-controller mode
    (the router is closed by ``runtime/init``). Tiers free in key order,
    alike on every controller, since each one's free fences."""
    release()
    with _lock:
        tiers = _state["tiers"]
        ts = [tiers[k] for k in sorted(tiers)]
    _free(ts)
    _reset_for_tests()


def _reset_for_tests() -> None:
    """Forget the controller table and tiers without fencing (the test
    reset closes the router)."""
    _state.update(ctl=None, me=0, router=None, device=None, tiers={},
                  roots={}, holds=[])


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
    order (then a fold in controller order is a fold in rank order),
    ``perm`` the index that puts concatenated rows into rank order, and
    ``key`` the comm's tier key (which hidden tier its rounds cross)."""

    def __init__(self, ctl: Sequence[int], me_: int,
                 key: Optional[str] = None):
        self.key = key
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
