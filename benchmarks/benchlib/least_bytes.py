"""The least HBM traffic a collective's MPI semantics need, from its
shapes alone: every send buffer that carries data read once, every
receive buffer MPI defines written once. Never taken from what the
program's schedule does, so a schedule that moves more bytes reads a
lower share of the peak, never a higher one.

``n`` ranks and a call of ``b`` bytes, nccl-tests' size: the larger of a
rank's send and receive buffers. ``allreduce``, ``bcast`` and ``reduce``
send and receive ``b``; ``alltoall``, ``reduce_scatter_block`` and
``scatter`` send ``n`` blocks of ``b / n``; ``allgather`` and ``gather``
send one block of ``b / n`` and receive ``n`` of them."""
from __future__ import annotations

from typing import Dict, Tuple


def collective(func: str, n: int, b: int) -> Tuple[int, int]:
    """(bytes read, bytes written) at least, over all ranks."""
    blk = b // n
    table: Dict[str, Tuple[int, int]] = {
        # every rank's send read; every rank's result written
        "allreduce": (n * b, n * b),
        # every rank's block read; every rank receives n blocks
        "allgather": (n * blk, n * b),
        # every rank's n blocks read; every rank receives n blocks
        "alltoall": (n * b, n * b),
        # the root's buffer read; the n - 1 others' written
        "bcast": (b, (n - 1) * b),
        # every rank's send read; the root's result written
        "reduce": (n * b, b),
        # every rank's n blocks read; every rank's one block written
        "reduce_scatter_block": (n * b, n * blk),
        # every rank's block read; the root's n blocks written
        "gather": (n * blk, b),
        # the root's n blocks read; every rank's one block written
        "scatter": (b, n * blk),
    }
    if func not in table:
        raise KeyError(f"no least-byte rule for {func!r}")
    return table[func]


def total(func: str, n: int, b: int) -> int:
    r, w = collective(func, n, b)
    return r + w


def grad_sync(n: int, per_rank_bytes: int) -> int:
    """A data-parallel gradient mean: each rank's gradients read once and
    its mean written once."""
    return 2 * n * per_rank_bytes
