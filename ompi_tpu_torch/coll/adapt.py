"""coll/adapt — event-driven asynchronous bcast/reduce. The port of
``ompi_tpu/coll/adapt.py``.

Behavioral spec: ``ompi/mca/coll/adapt`` — ibcast/ireduce built as trees
of context-free callbacks: each fragment's completion event fires the
next action (forward to children / combine toward parent) with no
central scheduler state, letting fragments from different subtrees
progress independently.

Over the schedule engine (``coll/nbc``), adapt adds (a) fragmentation —
the stacked tensor is cut into segments along its flattened row, each a
view of the flat tensor and its own ``ScheduleRequest`` advancing through
the shared progress engine (a segment's round k does not wait for the
other segments' round k) — and (b) a completion callback — user code
runs the moment the last segment retires. The segments' results are
joined on the communicator's device.

Across controllers (``core/multictl``) a buffer is this controller's
rows (``multictl.Rows``): the segments are column slices of those rows,
and each runs as the communicator's own i-collective, which completes
on the controller tier (``coll/nbc`` schedules index every rank's row,
so they stay single-controller).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ompi_tpu_torch.accelerator import to_device
from ompi_tpu_torch.coll.framework import coll_framework
from ompi_tpu_torch.coll.nbc import NbcModule, ScheduleRequest
from ompi_tpu_torch.core import op as op_mod
from ompi_tpu_torch.core.multictl import Rows
from ompi_tpu_torch.core.request import Request
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.mca.base import Component
from ompi_tpu_torch.runtime import progress as prog


class AdaptRequest(Request):
    """Umbrella over per-segment schedules; completes when all segments
    have, then fires the completion callback (the event-driven hook)
    exactly once."""

    def __init__(self, segments: List[ScheduleRequest],
                 assemble: Callable[[List], object],
                 on_complete: Optional[Callable] = None):
        super().__init__()
        self._complete = False
        self._segments = segments
        self._assemble = assemble
        self._cb = on_complete

    @property
    def segments_done(self) -> int:
        return sum(1 for s in self._segments if s._complete)

    def _try_finish(self) -> bool:
        if all(s._complete for s in self._segments):
            self._result = self._assemble(
                [s._result for s in self._segments])
            self._complete = True
            if self._cb is not None:
                cb, self._cb = self._cb, None
                cb(self._result)
            return True
        return False

    def test(self):
        if not self._complete:
            prog.progress()
            for s in self._segments:
                if not s._complete and not isinstance(s, ScheduleRequest):
                    s.test()              # an i-collective's own request
            self._try_finish()
        return (True, self.status) if self._complete else (False, None)

    def wait(self):
        while not self._complete:
            for s in self._segments:
                if not s._complete:
                    s.wait()
            self._try_finish()
        return self.status


class AdaptModule:
    """Segmented event-driven ibcast/ireduce over the schedule engine."""

    def __init__(self, comm, segsize_elems: int):
        self.comm = comm
        self.seg = max(1, segsize_elems)
        self._nbc = NbcModule(comm)

    def _operand(self, x):
        """The stacked tensor on the comm's device, or this controller's
        rows of a multi-controller buffer."""
        if self.comm.is_multiprocess:
            return self.comm._rows_of(x)
        return to_device(x, self.comm.device)

    def _segments(self, x) -> List[torch.Tensor]:
        if isinstance(x, Rows):
            flat = x.local.reshape(x.local.shape[0], -1)
            segs = [x.like(flat[:, i:i + self.seg])
                    for i in range(0, flat.shape[1], self.seg)]
            return segs or [x.like(flat)]
        flat = x.reshape(self.comm.size, -1)
        segs = [flat[:, i:i + self.seg]
                for i in range(0, flat.shape[1], self.seg)]
        return segs or [flat]       # count=0 collective: one empty seg

    @staticmethod
    def _assemble(x):
        if isinstance(x, Rows):
            shape = tuple(x.local.shape)

            def put_rows(parts):
                return x.like(torch.cat([p.local for p in parts],
                                        dim=1).reshape(shape))
            return put_rows
        orig_shape = tuple(x.shape)

        def put_together(parts):
            return torch.cat(parts, dim=1).reshape(orig_shape)
        return put_together

    def _ibcast(self, seg, root):
        if self.comm.is_multiprocess:
            return self.comm.ibcast(seg, root)
        return self._nbc.ibcast(seg, root)

    def _iallreduce(self, seg, op):
        if self.comm.is_multiprocess:
            return self.comm.iallreduce(seg, op)
        return self._nbc.iallreduce(seg, op)

    def ibcast_adapt(self, x, root: int = 0,
                     on_complete: Optional[Callable] = None
                     ) -> AdaptRequest:
        x = self._operand(x)
        segs = self._segments(x)
        reqs = [self._ibcast(s, root) for s in segs]
        return AdaptRequest(reqs, self._assemble(x), on_complete)

    def ireduce_adapt(self, x, op: op_mod.Op = op_mod.SUM, root: int = 0,
                      on_complete: Optional[Callable] = None
                      ) -> AdaptRequest:
        """Reduce-to-root via segmented allreduce schedules; non-root
        rows carry the (discarded) allreduce value, as the stacked
        convention allows."""
        x = self._operand(x)
        segs = self._segments(x)
        reqs = [self._iallreduce(s, op) for s in segs]
        return AdaptRequest(reqs, self._assemble(x), on_complete)


class AdaptComponent(Component):
    """Provides the adapt entry points as extension slots (the reference
    component also implements only ibcast/ireduce)."""

    name = "adapt"

    def register_params(self) -> None:
        var.var_register("coll", "adapt", "priority", vtype="int",
                         default=28,
                         help="Selection priority of the event-driven "
                              "segmented component")
        var.var_register("coll", "adapt", "segsize", vtype="int",
                         default=1024,
                         help="Segment size in elements (per rank) for "
                              "adapt fragmentation")

    def comm_query(self, comm):
        prio = var.var_get("coll_adapt_priority", 28)
        if prio < 0:
            return None
        return (prio, AdaptModule(comm,
                                  var.var_get("coll_adapt_segsize", 1024)))


coll_framework.register(AdaptComponent())
