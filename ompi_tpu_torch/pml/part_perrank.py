"""Partitioned point-to-point for the per-rank world (MPI-4
``MPI_Psend_init`` family; the port of ``ompi_tpu/pml/part_perrank.py``).

Behavioral spec: ``ompi/mca/part/persist`` — a persistent partitioned
send whose buffer is contributed partition-by-partition
(``MPI_Pready``), completing once every partition is transferred; the
receive side exposes per-partition arrival (``MPI_Parrived``).

Per-rank re-design: partitions ride the btl as independent fragments
on a HIDDEN matching channel (own CID, the _CollChannel pattern — a
user receive can never match a partition fragment), tagged
``(tag, init-order seq, k)`` flattened into one int so the matching
engine's (source, tag) lookup IS the per-partition arrival state:
``parrived`` is an iprobe, no extra bookkeeping, and two concurrently
active requests on the same (peer, tag) pair match in initialization
order (the MPI-4 channel-pairing rule) instead of cross-delivering. A
partition is on the wire the moment its ``pready`` runs — genuinely
incremental transfer across OS processes, which is the entire point of
the MPI-4 feature (early partitions overlap the production of late
ones).

A partition is whatever the engine sends: a numpy array, a Python
object, or a tensor. A device tensor at or above
``btl_devxfer_min_bytes`` rides devxfer's per-destination IPC slots, so
several partitions to one peer are in flight at once and are read in
whatever order the receiver polls them. Each takes a slot of its own
(a new one when every slot of the pool is busy), and a slot is free for
reuse only after the receiver's ack, so reuse never overwrites a
partition's bytes. The flattened tag is a Python int;
every engine path carries it as one (a pickled header field), so large
values survive.
"""
from __future__ import annotations

import threading
from typing import Any, List, Optional, Sequence

from ompi_tpu_torch.core.errhandler import ERR_ARG, ERR_PENDING, MPIError
from ompi_tpu_torch.core.rankcomm import hidden_engine
from ompi_tpu_torch.core.request import Request, Status

MAX_PARTITIONS = 1 << 14
_SEQ_MOD = 1 << 20


def _part_engine(comm):
    return hidden_engine(comm, "part")


def _channel_seq(comm, side: str, peer: int, tag: int) -> int:
    """Init-order channel number for (peer, tag): MPI-4 matches
    partitioned requests in initialization order per (comm, peer,
    tag) — without this, two concurrently active requests on the same
    pair would cross-deliver partitions. Sender and receiver advance
    mirrored counters, so the i-th psend_init to (dest, tag) pairs
    with the i-th precv_init from (source, tag)."""
    with comm._lock:
        table = getattr(comm, "_part_seq", None)
        if table is None:
            table = comm._part_seq = {}
        key = (side, peer, tag)
        seq = table.get(key, 0)
        table[key] = seq + 1
    return seq % _SEQ_MOD


def _ptag(tag: int, seq: int, k: int) -> int:
    return (tag * _SEQ_MOD + seq) * MAX_PARTITIONS + k


class RankPartitionedSend(Request):
    """MPI_Psend_init: persistent; each start() opens a new round of
    pready contributions."""

    def __init__(self, comm, parts: Sequence[Any], dest: int, tag: int):
        super().__init__()
        if not parts or len(parts) > MAX_PARTITIONS:
            raise MPIError(ERR_ARG,
                           f"1..{MAX_PARTITIONS} partitions required")
        self.comm = comm
        self.engine = _part_engine(comm)
        self.parts = list(parts)
        self.dest, self.tag = dest, tag
        self.seq = _channel_seq(comm, "send", dest, tag)
        self.ready: List[bool] = [False] * len(parts)
        self._started = False
        self._complete = False
        self._sent = 0
        self._lock = threading.Lock()

    @property
    def partitions(self) -> int:
        return len(self.parts)

    def start(self) -> "RankPartitionedSend":
        with self._lock:
            self._started = True
            self._complete = False
            self.ready = [False] * len(self.parts)
            self._sent = 0
        return self

    def pready(self, k: int) -> None:
        """MPI_Pready: partition k's data is final — it leaves NOW."""
        with self._lock:
            if not self._started:
                raise MPIError(ERR_PENDING, "pready before start")
            if not 0 <= k < len(self.parts):
                raise MPIError(ERR_ARG, f"bad partition {k}")
            if self.ready[k]:
                raise MPIError(ERR_ARG, f"partition {k} already ready")
            self.ready[k] = True
        try:
            self.engine.send(self.parts[k], self.dest,
                             _ptag(self.tag, self.seq, k))
        except BaseException:
            # transfer failed (e.g. peer death): the partition was NOT
            # contributed — roll back so a recovery path can retry (or
            # cleanly abandon) instead of wedging on 'already ready'
            with self._lock:
                self.ready[k] = False
            raise
        # completion is counted AFTER the btl accepted the fragment —
        # with concurrent pready threads (MPI-4's intended use), an
        # all(ready) check taken before another thread's send would
        # report completion while that partition is still unsent
        with self._lock:
            self._sent += 1
            if self._sent == len(self.parts):
                self._complete = True

    def pready_range(self, lo: int, hi: int) -> None:
        for k in range(lo, hi + 1):
            self.pready(k)

    def pready_list(self, ks: Sequence[int]) -> None:
        for k in ks:
            self.pready(k)

    def test(self):
        return ((True, Status(source=self.comm.rank(), tag=self.tag))
                if self._complete else (False, None))

    def wait(self, timeout: Optional[float] = None):
        if not self._complete:
            raise MPIError(ERR_PENDING,
                           "partitioned send incomplete: partitions "
                           "not all pready (a wait here would deadlock"
                           " — the sender itself must contribute them)")
        return Status(source=self.comm.rank(), tag=self.tag)


class RankPartitionedRecv(Request):
    """MPI_Precv_init: per-partition arrival via the matching engine's
    unexpected queue (parrived == iprobe on the partition's tag)."""

    def __init__(self, comm, nparts: int, source: int, tag: int):
        super().__init__()
        if not 1 <= nparts <= MAX_PARTITIONS:
            raise MPIError(ERR_ARG,
                           f"1..{MAX_PARTITIONS} partitions required")
        self.comm = comm
        self.engine = _part_engine(comm)
        self.nparts = nparts
        self.source, self.tag = source, tag
        self.seq = _channel_seq(comm, "recv", source, tag)
        self._got: List[Any] = [None] * nparts
        self._have: List[bool] = [False] * nparts
        self._complete = False
        self.status = Status(source=source, tag=tag)

    def start(self) -> "RankPartitionedRecv":
        self._got = [None] * self.nparts
        self._have = [False] * self.nparts
        self._complete = False
        return self

    def parrived(self, k: int) -> bool:
        """MPI_Parrived: has partition k landed?"""
        if not 0 <= k < self.nparts:
            raise MPIError(ERR_ARG, f"bad partition {k}")
        if self._have[k]:
            return True
        ok, _ = self.engine.iprobe(self.source,
                                   _ptag(self.tag, self.seq, k))
        if ok:
            data, _ = self.engine.recv(self.source,
                                       _ptag(self.tag, self.seq, k))
            self._got[k] = data
            self._have[k] = True
        return self._have[k]

    def test(self):
        if not self._complete:
            if all(self.parrived(k) for k in range(self.nparts)):
                self._finish()
        return ((True, self.status) if self._complete else (False, None))

    def wait(self, timeout: Optional[float] = None) -> Status:
        """Blocks for real: late partitions are produced by another OS
        process. ``timeout`` bounds the WHOLE wait, not each
        partition's receive."""
        import time
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        for k in range(self.nparts):
            if not self._have[k]:
                left = (None if deadline is None
                        else max(deadline - time.monotonic(), 0.001))
                data, _ = self.engine.recv(self.source,
                                           _ptag(self.tag, self.seq,
                                                 k),
                                           timeout=left)
                self._got[k] = data
                self._have[k] = True
        self._finish()
        return self.status

    def _finish(self) -> None:
        self._result = list(self._got)
        self._complete = True

    def get(self):
        return self._result


def psend_init(comm, parts: Sequence[Any], dest: int,
               tag: int = 0) -> RankPartitionedSend:
    return RankPartitionedSend(comm, parts, dest, tag)


def precv_init(comm, nparts: int, source: int,
               tag: int = 0) -> RankPartitionedRecv:
    return RankPartitionedRecv(comm, nparts, source, tag)
