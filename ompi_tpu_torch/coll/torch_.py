"""coll/torch — the device collective component.

The counterpart of the JAX package's ``coll/xla``: a collective on a
stacked ``(N, *local)`` tensor lowers to tensor operations over dim 0 on
the communicator's device. Each public entry ports the **direct**
lowering of ``coll/xla.py:1209-1660`` with the same shape contract:

- allreduce           (N, *s) -> (N, *s): ``sum``/``amax``/``amin`` over
  dim 0 for ops with a one-shot reduction (``op.xla_prim``), else the
  ordered fold ``op.reduce_tree``; the reduced row is materialized to
  every rank's row.
- reduce              the allreduce alias (root's row significant).
- bcast               (N, *s) -> (N, *s): root's row to every row.
- allgather / gather  (N, *s) -> (N, N, *s): out[r, j] = in[j].
- scatter             (N, N, *s) -> (N, *s): out[r] = in[root, r].
- alltoall            (N, N, *s) -> (N, N, *s): out[j, i] = in[i, j].
- reduce_scatter_block (N, N, *s) -> (N, *s): out[r] = reduce_i in[i, r].
- scan / exscan       inclusive / exclusive prefix over dim 0 (rank 0's
  exscan row keeps the prefix's row 0, as ``coll/xla`` does).
- barrier             drains the device's queued work.

``bind_allreduce`` (the persistent plan's pre-bound allreduce) and
``_ibarrier_arrays`` (an async barrier's token) port
``coll/xla.py:1199-1207,1655-1658``.

Results are always materialized tensors, never ``expand`` views: torch
tensors are mutable, so one rank's row must not alias another's.

The algorithm schedules of ``coll/xla`` (ring, recursive doubling,
binomial, ...) and the tuned decision layer wait for a later slice; the
``coll_torch_<func>_algorithm`` vars accept ``auto`` and ``direct`` (the
same lowering) and anything else is an error.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ompi_tpu_torch.coll.framework import coll_framework
from ompi_tpu_torch.core.errhandler import ERR_ARG
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.mca.base import Component

_ALGORITHM_FUNCS = ("allreduce", "reduce", "bcast", "allgather", "gather",
                    "scatter", "alltoall", "reduce_scatter_block", "scan",
                    "barrier")
_ACCEPTED = ("auto", "direct")


def _reduce0(x: torch.Tensor, op) -> torch.Tensor:
    """Reduce dim 0 with ``op``: the one-shot reduction where the op has
    one, else the ordered fold."""
    if op.xla_prim == "sum":
        return torch.sum(x, dim=0, dtype=x.dtype)
    if op.xla_prim == "max":
        return torch.amax(x, dim=0)
    if op.xla_prim == "min":
        return torch.amin(x, dim=0)
    return op.reduce_tree(x, axis=0)


def _prefix(x: torch.Tensor, op) -> torch.Tensor:
    """Inclusive prefix over dim 0. Fused prefix ops only for the
    *predefined* ops: a user op may reuse a predefined name but carry any
    combiner; it takes the ordered left fold."""
    if op.predefined:
        if op.name == "sum":
            return torch.cumsum(x, dim=0, dtype=x.dtype)
        if op.name == "prod":
            return torch.cumprod(x, dim=0, dtype=x.dtype)
        if op.name == "max":
            return torch.cummax(x, dim=0).values
        if op.name == "min":
            return torch.cummin(x, dim=0).values
    rows = [x[0]]
    for i in range(1, x.shape[0]):
        rows.append(op.fn(rows[-1], x[i]))
    return torch.stack(rows)


class TorchCollModule:
    def __init__(self, comm):
        self.comm = comm
        self._checked: Dict[str, int] = {}    # func -> var epoch checked
        self._token = None                    # the async barrier's token

    def _direct(self, func: str) -> None:
        """Enforce the algorithm var: ``direct`` is the only lowering
        this component has. Re-read only when the var store changed."""
        ep = var.epoch()
        if self._checked.get(func) == ep:
            return
        alg = var.var_get(f"coll_torch_{func}_algorithm", "auto")
        if alg not in _ACCEPTED:
            self.comm._err(ERR_ARG,
                           f"coll_torch_{func}_algorithm={alg!r}: only "
                           f"'direct' (or 'auto') is available")
        self._checked[func] = ep

    def _to_dev(self, x) -> torch.Tensor:
        dev = self.comm.device
        if isinstance(x, torch.Tensor):
            return x if x.device == dev else x.to(dev)
        return torch.tensor(np.asarray(x), device=dev)

    def _allreduce(self, x, op):
        x = self._to_dev(x)
        return _reduce0(x, op).expand(x.shape).contiguous()

    def allreduce(self, x, op):
        self._direct("allreduce")
        return self._allreduce(x, op)

    def bind_allreduce(self, example, op):
        """Pre-bound hot-path handle (``MPI_Allreduce_init``'s point):
        the algorithm check runs and the lowering is warmed on
        ``example`` once, here; the returned callable is the direct
        lowering alone."""
        self.allreduce(example, op)
        return lambda buf: self._allreduce(buf, op)

    def reduce(self, x, op, root: int):
        self._direct("reduce")
        return self.allreduce(x, op)

    def bcast(self, x, root: int):
        self._direct("bcast")
        x = self._to_dev(x)
        return x[root].expand(x.shape).contiguous()

    def allgather(self, x):
        self._direct("allgather")
        x = self._to_dev(x)
        return x.expand((self.comm.size,) + tuple(x.shape)).contiguous()

    def gather(self, x, root: int):
        self._direct("gather")
        return self.allgather(x)

    def scatter(self, x, root: int):
        self._direct("scatter")
        return self._to_dev(x)[root].clone()

    def alltoall(self, x):
        self._direct("alltoall")
        return self._to_dev(x).transpose(0, 1).contiguous()

    def reduce_scatter_block(self, x, op):
        self._direct("reduce_scatter_block")
        return _reduce0(self._to_dev(x), op).contiguous()

    def scan(self, x, op):
        self._direct("scan")
        return _prefix(self._to_dev(x), op).contiguous()

    def exscan(self, x, op):
        self._direct("scan")
        pre = _prefix(self._to_dev(x), op)
        return torch.cat([pre[:1], pre[:-1]])

    def barrier(self) -> None:
        self._direct("barrier")
        if self.comm.device.type == "cuda":
            torch.cuda.synchronize(self.comm.device)

    def _ibarrier_arrays(self):
        """The tensors backing an async barrier: a token on the
        communicator's device. The event a request records after it
        marks every rank's work queued before it on the stream (the
        coll/nbc component owns the schedule-based MPI_Ibarrier slot)."""
        self._direct("barrier")
        if self._token is None:
            self._token = torch.ones(self.comm.size, dtype=torch.int32,
                                     device=self.comm.device)
        return [self._token]


class TorchCollComponent(Component):
    name = "torch"

    def register_params(self):
        var.var_register("coll", "torch", "priority", vtype="int", default=40,
                         help="Selection priority of the torch device "
                              "collective component")
        for func in _ALGORITHM_FUNCS:
            var.var_register(
                "coll", "torch", f"{func}_algorithm", vtype="str",
                default="auto",
                help=f"{func} lowering: 'direct' tensor ops over the "
                     f"rank axis ('auto' = direct; the algorithm "
                     f"schedules are not ported yet)")

    def comm_query(self, comm):
        if comm is None:
            return None
        return (var.var_get("coll_torch_priority", 40), TorchCollModule(comm))


coll_framework.register(TorchCollComponent())
