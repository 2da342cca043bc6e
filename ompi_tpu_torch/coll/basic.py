"""coll/basic — host (NumPy) linear algorithms.

Mirrors ``ompi/mca/coll/basic``: simple, always-correct implementations
on host copies. It is (a) the fallback when the device component is
excluded (``coll_base_include``), and (b) the correctness oracle the tests
compare the device component against. Results are numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch.accelerator import to_numpy
from ompi_tpu_torch.coll.framework import coll_framework
from ompi_tpu_torch.core.op import np_combiner
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.mca.base import Component


def _np_fold(op, stacked, axis=0):
    """Ordered left fold along ``axis`` with an Op's combiner on host.
    Results keep the operand dtype."""
    name = op.name if op.predefined else None
    if name == "sum":
        return np.sum(stacked, axis=axis, dtype=stacked.dtype)
    if name == "prod":
        return np.prod(stacked, axis=axis, dtype=stacked.dtype)
    if name == "max":
        return np.max(stacked, axis=axis)
    if name == "min":
        return np.min(stacked, axis=axis)
    fn = np_combiner(op)
    acc = np.array(np.take(stacked, 0, axis=axis))
    if op.predefined and not op.is_loc and op.commute:
        # the C++ kernel table (native/ops.cpp, the op/avx role) for the
        # remaining predefined commutative ops: one accumulator reduced
        # into in place; operand order is irrelevant by commutativity,
        # and a step the table declines takes the numpy combiner
        from ompi_tpu_torch.native import native_reduce_into
        acc = np.ascontiguousarray(acc)
        rows = np.moveaxis(stacked, axis, 0)   # views: no copy per step
        for i in range(1, stacked.shape[axis]):
            step = np.ascontiguousarray(rows[i])
            if not native_reduce_into(op.name, step, acc):
                acc = np.asarray(fn(acc, step), dtype=acc.dtype)
        return acc
    for i in range(1, stacked.shape[axis]):
        acc = np.asarray(fn(acc, np.take(stacked, i, axis=axis)),
                         dtype=acc.dtype)
    return acc


class BasicCollModule:
    def __init__(self, comm):
        self.comm = comm

    @staticmethod
    def _np(x) -> np.ndarray:
        return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)

    def allreduce(self, x, op):
        x = self._np(x)
        red = _np_fold(op, x, axis=0)
        return np.broadcast_to(red, x.shape).copy()

    def reduce(self, x, op, root):
        return self.allreduce(x, op)

    def bcast(self, x, root):
        x = self._np(x)
        return np.broadcast_to(x[root], x.shape).copy()

    def allgather(self, x):
        x = self._np(x)
        n = self.comm.size
        return np.broadcast_to(x[None], (n,) + x.shape).copy()

    def gather(self, x, root):
        return self.allgather(x)

    def scatter(self, x, root):
        x = self._np(x)
        return x[root].copy()

    def alltoall(self, x):
        x = self._np(x)
        return np.swapaxes(x, 0, 1).copy()

    def reduce_scatter_block(self, x, op):
        x = self._np(x)                      # (N, N, *s)
        return _np_fold(op, x, axis=0)       # (N, *s)

    def scan(self, x, op):
        x = self._np(x)
        fn = np_combiner(op)
        out = np.empty_like(x)
        acc = x[0].copy()
        out[0] = acc
        for i in range(1, x.shape[0]):
            acc = np.asarray(fn(acc, x[i]), dtype=x.dtype)
            out[i] = acc
        return out

    def exscan(self, x, op):
        x = self._np(x)
        pre = self.scan(x, op)
        out = np.empty_like(x)
        out[0] = x[0]                        # rank 0 undefined; keep input
        out[1:] = pre[:-1]
        return out

    def barrier(self) -> None:
        pass                                 # controller-driven: trivially met


class BasicCollComponent(Component):
    name = "basic"

    def register_params(self):
        var.var_register("coll", "basic", "priority", vtype="int", default=20,
                         help="Selection priority of the host/NumPy "
                              "collective component")

    def comm_query(self, comm):
        if comm is None:
            return None
        return (var.var_get("coll_basic_priority", 20), BasicCollModule(comm))


coll_framework.register(BasicCollComponent())
