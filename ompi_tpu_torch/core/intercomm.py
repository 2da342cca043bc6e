"""Intercommunicators — two disjoint rank groups communicating (mirrors
``ompi/communicator`` intercomm create/merge + ``coll/inter``). The port
of ``ompi_tpu/core/intercomm.py``.

MPI intercomm collective semantics: operations are *between* groups —
allreduce reduces group A's contributions and delivers the result to
group B (and vice versa); bcast has a root in one group and receivers in
the other; alltoall sends local rank i's chunk j to remote rank j.

Both groups' stacked tensors usually sit on the same card: a crossing is
then a broadcast view or a transpose on ``comm.device`` with no copy to
the host. Rows cross with ``.to(device)`` only where the two
communicators' devices differ; host (numpy) operands are put on the
receiving group's device, as its ``stack`` would.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ompi_tpu_torch.accelerator import to_device
from ompi_tpu_torch.core import op as op_mod
from ompi_tpu_torch.core.communicator import Communicator
from ompi_tpu_torch.core.errhandler import ERR_ARG, ERR_ROOT, MPIError
from ompi_tpu_torch.core.group import Group


def _rows_of(row, comm: Communicator) -> torch.Tensor:
    """``comm.size`` copies of one rank's row, stacked on ``comm``'s
    device (a broadcast view made contiguous: the result owns its
    memory)."""
    row = to_device(row, comm.device)
    return row.unsqueeze(0).expand((comm.size,) + tuple(row.shape)) \
        .contiguous()


class Intercomm:
    def __init__(self, local: Communicator, remote: Communicator,
                 tag: int = 0):
        overlap = (set(local.group.world_ranks)
                   & set(remote.group.world_ranks))
        if overlap:
            raise MPIError(ERR_ARG,
                           f"intercomm groups must be disjoint: {overlap}")
        self.local_comm = local
        self.remote_comm = remote
        self.tag = tag

    # -- introspection (MPI_Comm_remote_size / _remote_group) ----------
    @property
    def size(self) -> int:
        return self.local_comm.size

    @property
    def remote_size(self) -> int:
        return self.remote_comm.size

    @property
    def group(self) -> Group:
        return self.local_comm.group

    @property
    def remote_group(self) -> Group:
        return self.remote_comm.group

    def is_inter(self) -> bool:
        return True

    # -- merge (MPI_Intercomm_merge) -----------------------------------
    def merge(self, high: bool = False) -> Communicator:
        """Union intracomm; ``high`` orders the local group last. Its
        rows are the two groups' slots, repeats kept: 8 rows on
        ``cuda:0`` merged with 4 more give a 12-row comm on ``cuda:0``."""
        a, b = ((self.remote_comm, self.local_comm) if high
                else (self.local_comm, self.remote_comm))
        g = Group(a.group.world_ranks + b.group.world_ranks)
        return Communicator(g, a.devices + b.devices,
                            name="intercomm.merge",
                            errhandler=self.local_comm.errhandler)

    # -- collectives (coll/inter semantics) ----------------------------
    def bcast(self, sendbuf_root, root: int = 0, *,
              root_side: str = "local"):
        """Root (rank ``root`` of the ``root_side`` group) broadcasts its
        buffer to every rank of the *other* group; returns the receiving
        group's stacked buffer."""
        src_comm = (self.local_comm if root_side == "local"
                    else self.remote_comm)
        dst_comm = (self.remote_comm if root_side == "local"
                    else self.local_comm)
        if not (0 <= root < src_comm.size):
            src_comm._err(ERR_ROOT, f"root {root} out of range")
        return _rows_of(sendbuf_root, dst_comm)

    def allreduce(self, local_stacked, remote_stacked,
                  op: op_mod.Op = op_mod.SUM) -> Tuple[Any, Any]:
        """Each group receives the reduction of the *other* group's
        contributions: returns (local_out, remote_out)."""
        lred = self.local_comm.allreduce(local_stacked, op)
        rred = self.remote_comm.allreduce(remote_stacked, op)
        return (_rows_of(rred[0], self.local_comm),
                _rows_of(lred[0], self.remote_comm))

    def allgather(self, local_stacked, remote_stacked) -> Tuple[Any, Any]:
        """Each group receives the concatenation of the other group's
        buffers."""
        return (_rows_of(remote_stacked, self.local_comm),
                _rows_of(local_stacked, self.remote_comm))

    def alltoall(self, local_stacked, remote_stacked) -> Tuple[Any, Any]:
        """Local rank i's chunk j goes to remote rank j (and vice versa).
        local_stacked: (lsize, rsize, *s); remote: (rsize, lsize, *s).
        The exchange is a transpose of the two leading axes on the
        receiving group's device."""
        if local_stacked.shape[1] != self.remote_size or \
                remote_stacked.shape[1] != self.size:
            raise MPIError(ERR_ARG, "alltoall chunk counts must match "
                                    "the remote group size")
        return (to_device(remote_stacked, self.local_comm.device)
                .transpose(0, 1).contiguous(),
                to_device(local_stacked, self.remote_comm.device)
                .transpose(0, 1).contiguous())

    def barrier(self) -> None:
        self.local_comm.barrier()
        self.remote_comm.barrier()

    def free(self) -> None:
        pass

    def __repr__(self):
        return (f"Intercomm(local={self.size}, "
                f"remote={self.remote_size})")


def intercomm_create(local: Communicator, remote: Communicator,
                     tag: int = 0) -> Intercomm:
    """MPI_Intercomm_create (leaders collapse in single-controller)."""
    return Intercomm(local, remote, tag)
