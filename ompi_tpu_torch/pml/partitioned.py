"""Partitioned point-to-point (MPI-4 ``MPI_Psend_init`` family).

Behavioral spec: ``ompi/mca/part/persist``, as the JAX package's
``pml/partitioned.py`` ports it — a persistent partitioned send whose
buffer is contributed partition by partition (``MPI_Pready``); the
transfer completes once every partition is marked ready. The receive side
exposes ``MPI_Parrived`` per-partition arrival. Each partition rides the
matching engine's partitioned channel as its own message, snapshotted at
``pready`` like every send. The memchecker's ownership checks (a write to
a partition between ``pready`` and completion) wait for the tools plane.
"""
from __future__ import annotations

from typing import Any, List, Sequence

from ompi_tpu_torch.core.errhandler import ERR_ARG, MPIError
from ompi_tpu_torch.core.request import Request
from ompi_tpu_torch.pml.stacked import CH_PART


class PartitionedSend(Request):
    def __init__(self, comm, parts: Sequence[Any], src: int, dest: int,
                 tag: int):
        super().__init__()
        self._complete = False
        self.comm = comm
        self.parts = list(parts)
        self.src, self.dest, self.tag = src, dest, tag
        self.ready: List[bool] = [False] * len(self.parts)
        self._started = False

    @property
    def partitions(self) -> int:
        return len(self.parts)

    def start(self) -> "PartitionedSend":
        self._started = True
        self._complete = False
        self.ready = [False] * len(self.parts)
        return self

    def pready(self, i: int) -> None:
        if not self._started:
            raise MPIError(ERR_ARG, "pready before start")
        if not (0 <= i < len(self.parts)):
            raise MPIError(ERR_ARG, f"partition {i} out of range")
        if not self.ready[i]:
            self.ready[i] = True
            # structured (tag, partition) tags on their own channel: no
            # arithmetic encoding, no collision with user int tags
            self.comm._pml.send(self.parts[i], self.src, self.dest,
                                (self.tag, i), channel=CH_PART)
        if all(self.ready):
            self._complete = True

    def pready_range(self, lo: int, hi: int) -> None:
        for i in range(lo, hi + 1):
            self.pready(i)

    def test(self):
        return (True, self.status) if self._complete else (False, None)

    def wait(self):
        if not self._complete:
            raise MPIError(ERR_ARG,
                           "partitioned send incomplete: not all "
                           "partitions marked ready")
        return self.status


class PartitionedRecv(Request):
    def __init__(self, comm, source: int, tag: int, partitions: int,
                 dst: int = 0):
        super().__init__()
        self._complete = False
        self.comm = comm
        self.source, self.tag, self.dst = source, tag, dst
        self.partitions = partitions
        self._reqs: List[Request] = []
        self._started = False

    def start(self) -> "PartitionedRecv":
        self._started = True
        self._complete = False
        self._reqs = [
            self.comm._pml.irecv(self.dst, self.source, (self.tag, i),
                                 channel=CH_PART)
            for i in range(self.partitions)]
        return self

    def parrived(self, i: int) -> bool:
        if not self._started:
            return False
        return self._reqs[i].test()[0]

    def test(self):
        if self._started and all(r.test()[0] for r in self._reqs):
            self._result = [r.get() for r in self._reqs]
            self._complete = True
            return True, self.status
        return False, None

    def wait(self):
        ok, _ = self.test()
        if not ok:
            raise MPIError(ERR_ARG,
                           "partitioned recv incomplete: partitions "
                           "missing (send them first)")
        return self.status
