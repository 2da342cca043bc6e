"""coll/self — trivial implementations for size-1 communicators
(mirrors ``ompi/mca/coll/self``, priority-selected only for COMM_SELF
and other single-rank communicators). Results are copies: a torch tensor
is mutable, so a result never aliases the send buffer."""
from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch.coll.framework import coll_framework
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.mca.base import Component


def _copy(x):
    return x.clone() if isinstance(x, torch.Tensor) else np.array(x)


class SelfCollModule:
    def __init__(self, comm):
        self.comm = comm

    def allreduce(self, x, op):
        return _copy(x)

    def reduce(self, x, op, root):
        return _copy(x)

    def bcast(self, x, root):
        return _copy(x)

    def allgather(self, x):
        return _copy(x[:, None])

    def gather(self, x, root):
        return _copy(x[:, None])

    def scatter(self, x, root):
        return _copy(x[:, 0])

    def alltoall(self, x):
        return _copy(x)

    def reduce_scatter_block(self, x, op):
        return _copy(x[:, 0])

    def scan(self, x, op):
        return _copy(x)

    def exscan(self, x, op):
        return _copy(x)                     # rank 0 recvbuf is undefined

    def barrier(self) -> None:
        pass


class SelfCollComponent(Component):
    name = "self"

    def register_params(self):
        var.var_register("coll", "self", "priority", vtype="int", default=75,
                         help="Selection priority for single-rank comms")

    def comm_query(self, comm):
        if comm is None or comm.size != 1:
            return None
        return (var.var_get("coll_self_priority", 75), SelfCollModule(comm))


coll_framework.register(SelfCollComponent())
