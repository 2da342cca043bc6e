"""coll/ftagree — fault-tolerant agreement.

Behavioral spec: the reference's ULFM agreement component
(``ompi/mca/coll/ftagree/coll_ftagree_earlyreturning.c``) — the
Early-Returning Agreement (ERA): ranks combine contributions up a binary
tree with bitwise AND, the root decides, and the decision is broadcast
down; dead ranks are routed around, and ranks that discover new failures
re-elect subtree roots. The result is a uniform decision every *live*
rank observes, plus a flag telling the caller whether any participant
failed (``MPIX_Comm_agree`` semantics: unacknowledged failures make the
call return ``MPI_ERR_PROC_FAILED`` while still agreeing).

The port of ``ompi_tpu/coll/ftagree.py``. Contributions are host-side
ints (control plane — agreement never rides the device data plane in the
reference either; it rides the PML), so nothing here touches a tensor. The controller owns global knowledge, so the ERA
re-election dance collapses, but the tree pass is kept explicit: the
same up-AND / down-broadcast structure, skipping failed ranks, so the
decision provably only includes live contributions in tree order.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ompi_tpu_torch.coll.framework import coll_framework
from ompi_tpu_torch.mca.base import Component
from ompi_tpu_torch.runtime import ft


def _tree_agree(contribs: Sequence[int], alive: Sequence[bool]) -> int:
    """One ERA round: AND contributions up a binomial tree rooted at the
    lowest live rank, skipping failed ranks (their subtree still
    percolates through the live parent chain)."""
    n = len(contribs)
    acc: List[Optional[int]] = [int(contribs[r]) if alive[r] else None
                                for r in range(n)]
    dist = 1
    while dist < n:
        for r in range(0, n, 2 * dist):
            peer = r + dist
            if peer >= n:
                continue
            a, b = acc[r], acc[peer]
            if a is None:
                acc[r] = b
            elif b is not None:
                acc[r] = a & b
        dist *= 2
    root = acc[0]
    if root is None:                    # every rank failed
        return ~0
    return root


class FtAgreeModule:
    """Provides the ``agree``/``iagree`` slots of the coll module vtable
    (reference vtable slots: ``ompi/mca/coll/coll.h:215-220``)."""

    def __init__(self, comm):
        self.comm = comm

    def _alive_mask(self) -> List[bool]:
        wr = self.comm.group.world_ranks
        # the communicator's failure domain (a session's private
        # registry, or the process default) — NOT the module globals,
        # so session-injected failures stay in their instance
        reg = getattr(self.comm, "_ft", ft)
        return [not reg.is_failed(w) for w in wr]

    def agree(self, flags: Sequence[int]) -> Tuple[int, List[int]]:
        """Returns (agreed_value, failed_local_ranks). The caller (the
        communicator layer) converts unacked failures into
        MPIX_ERR_PROC_FAILED per the ULFM contract."""
        flags = list(flags)[:self.comm.size]
        if len(flags) < self.comm.size:
            # Missing contributions are the AND identity (the rank "had
            # nothing to veto").
            flags += [~0] * (self.comm.size - len(flags))
        alive = self._alive_mask()
        value = _tree_agree(flags, alive)
        failed = [r for r, ok in enumerate(alive) if not ok]
        return value, failed

    def iagree(self, flags: Sequence[int]):
        from ompi_tpu_torch.core.request import Request
        return Request.completed(self.agree(flags))


# -- per-rank (multi-controller) agreement ------------------------------
# The distributed counterpart of _tree_agree, used by the real recovery
# path (RankCommunicator.agree / MPIX_Comm_shrink): no controller holds
# global knowledge, so survivors run a leader-collect round over the
# comm's hidden collective channel. "Early-returning" concretely means
# ranks ALREADY known dead are excluded before any wait (zero timeout
# spent on them); only a rank dying DURING the round costs the leader
# one recv timeout, after which it is suspected into the agreed failed
# set — the ERA suspicion rule. The exchange rides one reserved tag
# outside the per-collective sequence space so a survivor retrying
# after a stale leader election still matches the true leader's
# collection (the same reservation the shrink exchange used before it
# was rebased onto this protocol).

_AGREE_TAG = 1 << 30


def perrank_agree(comm, flag: int,
                  timeout: float = 20.0) -> Tuple[int, List[int]]:
    """Fault-tolerant agreement among a per-rank comm's survivors.
    Returns ``(agreed_value, agreed_failed_local_ranks)`` — the same
    value and the same failed set on every live member. Retried when a
    survivor's stale failure view elected a dead leader (the failed
    exchange itself surfaces the death; the retry settles)."""
    from ompi_tpu_torch.core.errhandler import MPIError
    last: Optional[BaseException] = None
    for _ in range(3):
        try:
            return _perrank_agree_once(comm, int(flag), timeout)
        except (MPIError, OSError) as e:
            # OSError: a send raced the EOF monitor onto a just-dead
            # leader's broken socket (EPIPE beats the callback)
            last = e
            import time
            time.sleep(0.2)              # let detection settle
    raise last


def _perrank_agree_once(comm, flag: int,
                        timeout: float) -> Tuple[int, List[int]]:
    from ompi_tpu_torch.core.errhandler import MPIError
    eng = comm._coll_pml
    t = _AGREE_TAG
    my_failed = set(comm.get_failed())
    alive = [r for r in range(comm.size) if r not in my_failed]
    leader = alive[0]
    if comm.rank() == leader:
        value = int(flag)
        union = set(my_failed)
        for r in alive:
            if r == leader:
                continue
            try:
                data, _ = eng.recv(r, t, timeout=timeout)
                rflag, rfailed = data
                value &= int(rflag)
                union |= set(int(x) for x in rfailed)
            except MPIError:
                union.add(r)             # silent: suspect it too
        final = sorted(union)
        for r in range(comm.size):
            if r not in union and r != leader:
                try:
                    eng.send((value, final), r, t)
                except (MPIError, OSError):
                    pass                 # died since; it is in no set
        return value, final
    eng.send((int(flag), sorted(my_failed)), leader, t)
    # the leader may serially spend up to `timeout` on each rank that
    # dies mid-round before deciding: wait proportionally longer
    data, _ = eng.recv(leader, t, timeout=timeout * max(2, len(alive)))
    value, final = data
    return int(value), [int(x) for x in final]


class FtAgreeComponent(Component):
    name = "ftagree"

    def comm_query(self, comm):
        # Always available; only provider of agree/iagree, so priority
        # does not contend with the data-plane components.
        return (5, FtAgreeModule(comm))


coll_framework.register(FtAgreeComponent())
