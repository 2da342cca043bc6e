"""coll/compressed — quantized collectives as a component.

The port of ``ompi_tpu/coll/compressed.py``: the MCA face of
``ompi_tpu_torch/compress``, a coll component above the device component
(priority 62 > torch's 40) claiming exactly the three collectives that
have a compressed schedule — allreduce, allgather, reduce_scatter_block.
Every call is gated by ``coll/decision.compress_eligible`` (the
``mpi_base_compress`` var, the per-rank floor, the dtypes f32/f64/bf16,
sum-only reductions); an ineligible call goes to the next-priority
provider, so with the var off every result is the uncompressed path's.
A failed compressed launch raises: nothing sends it to the plain path.

Device schedules (``_CompressedDevice``, a ``coll/torch`` module whose
memo holds only compressed schedules), on the stacked tensor:

- allreduce: the segmented ring with every hop quantized (dequant ->
  reduce -> requant in the reduce-scatter, lossless code forwarding in
  the allgather — ``_ring_allreduce_inner(codec=...)``). The reference
  takes the two-tier hier schedule (``_hier_allreduce_inner(codec=...)``,
  only the high-tier chunk quantized) on a multihost communicator; one
  controller drives every rank here, so the comm is never multihost.
- allgather: quantize each row once, gather codes and scales, dequantize
  per row.
- reduce_scatter_block: quantize per row, all-to-all the codes,
  dequantize and fold in fixed rank order (bitwise identical across
  ranks).

The byte pvars ``compress_bytes_in``/``_out`` count, per call, the wire
bytes each schedule's hops would move compressed and uncompressed (a
static model fixed when the schedule is built; no device sync).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np

from ompi_tpu_torch import compress
from ompi_tpu_torch.coll import decision
from ompi_tpu_torch.coll.framework import coll_framework
from ompi_tpu_torch.coll.torch_ import TorchCollModule
from ompi_tpu_torch.compress import codecs as _codecs
from ompi_tpu_torch.compress import stats as _stats
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.mca.base import Component

WRAPPED_FUNCS = ("allreduce", "allgather", "reduce_scatter_block")


def _account_fn(fn: Callable, bytes_in: int, bytes_out: int,
                dequants: int) -> Callable:
    def run(x):
        _stats.account(bytes_in, bytes_out)
        _stats.account_dequant(dequants)
        return fn(x)
    return run


class _CompressedDevice(TorchCollModule):
    """The compressed schedules, reached through the owning module's
    vtable slots and, for allreduce, through ``bind_allreduce``
    (persistent plans, ``Communicator.allreduce_bind``); each entry point
    is gated."""

    def __init__(self, comm, owner: "CompressedCollModule"):
        super().__init__(comm)
        self._owner = owner

    @staticmethod
    def _codec() -> Tuple[_codecs.Codec, int]:
        return (_codecs.get_codec(compress.codec_name()),
                compress.block_elems())

    def _memo(self, fk: Tuple, make: Callable[[], Callable]) -> Callable:
        """The accounted schedule for ``fk``, built once per var epoch."""
        ep = var.epoch()
        hit = self._fast.get(fk)
        if hit is None or hit[0] != ep:
            hit = self._fast[fk] = (ep, make())
        return hit[1]

    def bind_allreduce(self, example, op):
        x = self._to_dev(example)
        if self._owner._eligible("allreduce", x, op):
            fn = self._allreduce_fn(x, op)
            fn(x)                                  # warm
            return lambda buf: fn(self._to_dev(buf))
        mod = self._owner._flat_mod("allreduce")
        bind = getattr(mod, "bind_allreduce", None)
        if bind is not None:
            return bind(example, op)
        return lambda buf, _op=op: mod.allreduce(buf, _op)

    # -- compressed schedules ----------------------------------------------
    def _allreduce_fn(self, x, op) -> Callable:
        cobj, cblock = self._codec()
        fk = ("c_allreduce", x.shape, x.dtype, op.uid, cobj.name, cblock)

        def make():
            n = self.comm.size
            itemsize = x.element_size()
            shape = tuple(x.shape[1:])
            total = int(np.prod(shape))               # per-rank elems
            nseg = self._nseg(total * itemsize // max(n, 1))
            fn = self._built(
                ("c_allreduce", shape, op.uid, nseg, cobj.name, cblock),
                lambda: self._ring_segmented_allreduce_inner(
                    op, n, shape, nseg, (cobj, cblock)))
            # per-call wire model: every quantized hop of every chain
            seglen = -(-total // nseg)
            chunk = -(-seglen // n)
            hops = 2 * (n - 1) * nseg
            return _account_fn(fn, hops * chunk * itemsize,
                               hops * cobj.wire_bytes(chunk, cblock), hops)
        return self._memo(fk, make)

    def allreduce_compressed(self, x, op):
        x = self._to_dev(x)
        return self._allreduce_fn(x, op)(x)

    def allgather_compressed(self, x):
        x = self._to_dev(x)
        cobj, cblock = self._codec()
        fk = ("c_allgather", x.shape, x.dtype, cobj.name, cblock)

        def make():
            n = self.comm.size
            shape = tuple(x.shape[1:])
            total = int(np.prod(shape))

            def inner(b):                      # (N, *s) -> (N, N, *s)
                qc, qs = cobj.torch_quant_rows(b.reshape(n, -1), cblock)
                gc = qc.expand((n,) + qc.shape)    # every rank's codes
                gs = qs.expand((n,) + qs.shape)
                out = cobj.torch_dequant_rows(gc, gs, total, b.dtype,
                                              cblock)
                return out.reshape((n, n) + shape).contiguous()

            fn = self._built(("c_allgather", shape, cobj.name, cblock),
                             lambda: inner)
            hops = n - 1                       # rows received per rank
            return _account_fn(fn, hops * total * x.element_size(),
                               hops * cobj.wire_bytes(total, cblock), n)
        return self._memo(fk, make)(x)

    def reduce_scatter_block_compressed(self, x, op):
        x = self._to_dev(x)
        cobj, cblock = self._codec()
        fk = ("c_rsb", x.shape, x.dtype, op.uid, cobj.name, cblock)

        def make():
            n = self.comm.size
            shape = tuple(x.shape[2:])
            total = int(np.prod(shape))        # per-row elems

            def inner(b):                      # (N, N, *s) -> (N, *s)
                qc, qs = cobj.torch_quant_rows(b.reshape(n, n, -1), cblock)
                # all_to_all: rank j receives row [i, j] of every rank i
                dq = cobj.torch_dequant_rows(qc.transpose(0, 1),
                                             qs.transpose(0, 1), total,
                                             b.dtype, cblock)
                # fixed rank order: the fold is the same on every rank
                acc = dq[:, 0] if n > 1 else dq[:, 0].clone()
                for i in range(1, n):
                    acc = op.fn(acc, dq[:, i])
                return acc.reshape((n,) + shape)

            fn = self._built(("c_rsb", shape, op.uid, cobj.name, cblock),
                             lambda: inner)
            hops = n - 1                       # rows shipped per rank
            return _account_fn(fn, hops * total * x.element_size(),
                               hops * cobj.wire_bytes(total, cblock), n)
        return self._memo(fk, make)(x)


class CompressedCollModule:
    """The vtable face: claims allreduce, allgather and
    reduce_scatter_block and nothing else (the framework backfills the
    rest per function from the next providers)."""

    def __init__(self, comm):
        self.comm = comm
        self.device = _CompressedDevice(comm, self)
        self._flat_memo: Dict[str, Any] = {}

    # -- delegation (han's fallback-module idiom) --------------------------
    def _flat_mod(self, func: str):
        """The highest-priority provider of ``func`` after this one."""
        m = self._flat_memo.get(func)
        if m is None:
            for _prio, comp, module in getattr(self.comm, "_coll_selected",
                                               []):
                if comp.name == "compressed":
                    continue
                if getattr(module, func, None) is not None:
                    m = module
                    break
            if m is None:
                raise RuntimeError(f"no fallback provider for {func}")
            self._flat_memo[func] = m
        return m

    def _delegate_device(self, func: str, *args):
        return getattr(self._flat_mod(func), func)(*args)

    def _eligible(self, func: str, buf, op=None) -> bool:
        n = max(self.comm.size, 1)
        nbytes = int(getattr(buf, "nbytes", 0)) // n
        return decision.compress_eligible(func, nbytes,
                                          getattr(buf, "dtype", None), op)

    def selected(self, func: str, x=None, op=None, root=None) -> str:
        """What ``func`` runs for this input: ``compressed:<codec>``, or
        the delegate's own answer."""
        if func in WRAPPED_FUNCS and self._eligible(func, x, op):
            return f"compressed:{compress.codec_name()}"
        return self._flat_mod(func).selected(func, x, op, root)

    # -- vtable slots ------------------------------------------------------
    def allreduce(self, x, op):
        if not self._eligible("allreduce", x, op):
            return self._delegate_device("allreduce", x, op)
        return self.device.allreduce_compressed(x, op)

    def allgather(self, x):
        if not self._eligible("allgather", x):
            return self._delegate_device("allgather", x)
        return self.device.allgather_compressed(x)

    def reduce_scatter_block(self, x, op):
        if not self._eligible("reduce_scatter_block", x, op):
            return self._delegate_device("reduce_scatter_block", x, op)
        return self.device.reduce_scatter_block_compressed(x, op)

    # the derived-datatype allreduce stays uncompressed, as in the
    # reference: its packed image is index-sparse
    def allreduce_dtype(self, *args):
        return self._flat_mod("allreduce").allreduce_dtype(*args)

    def bind_allreduce(self, example, op):
        return self.device.bind_allreduce(example, op)


class CompressedCollComponent(Component):
    name = "compressed"

    def register_params(self):
        var.var_register(
            "coll", "compressed", "priority", vtype="int", default=62,
            help="Selection priority of the quantized-collectives "
                 "component (above torch, so eligible large payloads are "
                 "claimed; per-call gating delegates everything else — "
                 "mpi_base_compress off means byte-identical behavior)")
        compress._register_vars()

    def comm_query(self, comm):
        if comm is None or not compress.enabled():
            # a disabled component declines selection; comms built while
            # it was on still gate per call, so turning the var off later
            # is honored too
            return None
        prio = var.var_get("coll_compressed_priority", 62)
        if prio < 0:
            return None
        return (prio, CompressedCollModule(comm))


coll_framework.register(CompressedCollComponent())
