"""fcoll framework — collective IO algorithms (``ompi/mca/fcoll``; the
port of ``ompi_tpu/io/fcoll.py``).

Reference components: *individual* (no aggregation — every rank issues
its own requests), *dynamic* / *dynamic_gen2* / *vulcan* (two-phase IO:
ranks exchange data so a few aggregators issue large contiguous
filesystem requests; vulcan fixes the aggregator count and domain
assignment up front).

Single controller: the controller already holds every rank's stacked
buffer, so phase one (the data exchange) is a host-side merge of
per-rank (offset, data) interleavings, and phase two is the aggregated
write. What remains honest — and measurable — is the *aggregation
policy*: `individual` writes each rank's runs separately (many small
syscalls when the view interleaves ranks), the two-phase components
merge-sort all ranks' element offsets, coalesce adjacent runs across
ranks, and split the result into aggregator domains issuing one vectored
request each. Selection via MCA var ``io_fcoll`` (dynamic default),
mirroring ``--mca fcoll vulcan``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ompi_tpu_torch.mca import var
from ompi_tpu_torch.io.fbtl import PosixFbtl, elem_runs_to_bytes


def _coalesce(offs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    from ompi_tpu_torch.core.datatype import coalesce_runs
    return coalesce_runs(offs)


class IndividualFcoll:
    """No aggregation: one request stream per rank
    (``fcoll/individual``)."""

    name = "individual"

    def __init__(self, fbtl: PosixFbtl):
        self.fbtl = fbtl

    def write(self, fd: int, per_rank: List[Tuple[np.ndarray, np.ndarray]],
              ebytes: int) -> int:
        written = 0
        for offs, data in per_rank:
            starts, lens = _coalesce(offs)
            runs = elem_runs_to_bytes(starts, lens, ebytes)
            written += self.fbtl.pwritev_runs(fd, runs, data.tobytes())
        return written // ebytes

    def read(self, fd: int, per_rank_offs: List[np.ndarray],
             dtype: np.dtype) -> List[np.ndarray]:
        out = []
        for offs in per_rank_offs:
            starts, lens = _coalesce(offs)
            runs = elem_runs_to_bytes(starts, lens, dtype.itemsize)
            raw = self.fbtl.preadv_runs(fd, runs)
            out.append(np.frombuffer(raw, dtype, count=offs.size))
        return out


class TwoPhaseFcoll:
    """Two-phase aggregation (``fcoll/dynamic`` family): merge every
    rank's element offsets, coalesce across ranks, split into
    aggregator domains, one vectored request per domain."""

    name = "dynamic"

    def __init__(self, fbtl: PosixFbtl, n_aggregators: int = 1):
        self.fbtl = fbtl
        self.n_agg = max(1, n_aggregators)

    def _merge(self, per_rank: List[Tuple[np.ndarray, np.ndarray]]
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Phase one: the exchange. Produces (sorted element offsets,
        data reordered to match). Later ranks win offset collisions
        (MPI's unordered-conflict semantics made deterministic)."""
        offs = np.concatenate([o for o, _d in per_rank])
        data = np.concatenate([np.asarray(d).ravel()
                               for _o, d in per_rank])
        order = np.argsort(offs, kind="stable")
        return offs[order], data[order]

    def _domains(self, starts: np.ndarray, lens: np.ndarray
                 ) -> List[slice]:
        """Split coalesced runs into ~equal-bytes aggregator domains
        (vulcan's fixed assignment when n_agg is fixed)."""
        if len(starts) <= 1 or self.n_agg == 1:
            return [slice(0, len(starts))]
        csum = np.cumsum(lens)
        total = int(csum[-1])
        bounds = [0]
        for a in range(1, self.n_agg):
            target = total * a // self.n_agg
            bounds.append(int(np.searchsorted(csum, target)))
        bounds.append(len(starts))
        return [slice(bounds[i], bounds[i + 1])
                for i in range(len(bounds) - 1)
                if bounds[i] < bounds[i + 1]]

    def write(self, fd: int, per_rank: List[Tuple[np.ndarray, np.ndarray]],
              ebytes: int) -> int:
        offs, data = self._merge(per_rank)
        starts, lens = _coalesce(offs)
        payload = data.tobytes()
        written = 0
        pos = 0
        run_bytes = elem_runs_to_bytes(starts, lens, ebytes)
        for dom in self._domains(starts, lens):
            runs = run_bytes[dom]
            nbytes = sum(r[1] for r in runs)
            written += self.fbtl.pwritev_runs(
                fd, runs, payload[pos:pos + nbytes])
            pos += nbytes
        return written // ebytes

    def read(self, fd: int, per_rank_offs: List[np.ndarray],
             dtype: np.dtype) -> List[np.ndarray]:
        offs = np.concatenate(per_rank_offs)
        order = np.argsort(offs, kind="stable")
        starts, lens = _coalesce(offs[order])
        raw = bytearray()
        run_bytes = elem_runs_to_bytes(starts, lens, dtype.itemsize)
        for dom in self._domains(starts, lens):
            raw += self.fbtl.preadv_runs(fd, run_bytes[dom])
        merged = np.frombuffer(bytes(raw), dtype, count=offs.size)
        # scatter back to per-rank order (phase one, reversed)
        unsorted = np.empty_like(merged)
        unsorted[order] = merged
        out, pos = [], 0
        for o in per_rank_offs:
            out.append(unsorted[pos:pos + o.size])
            pos += o.size
        return out


class VulcanFcoll(TwoPhaseFcoll):
    """``fcoll/vulcan``: the two-phase engine with a fixed aggregator
    count (MCA var ``io_vulcan_aggregators``)."""

    name = "vulcan"

    def __init__(self, fbtl: PosixFbtl):
        super().__init__(fbtl, var.var_get("io_vulcan_aggregators", 4))


def register_vars() -> None:
    var.var_register("io", "base", "fcoll", vtype="str",
                     default="dynamic",
                     help="Collective IO algorithm: "
                          "individual | dynamic | vulcan")
    var.var_register("io", "vulcan", "aggregators", vtype="int",
                     default=4, help="Aggregator count for fcoll/vulcan")


register_vars()


def select_fcoll(fbtl: PosixFbtl):
    """Component selection for collective IO (``--mca fcoll X``)."""
    name = (var.var_get("io_base_fcoll", "dynamic") or "dynamic").strip()
    if name == "individual":
        return IndividualFcoll(fbtl)
    if name == "vulcan":
        return VulcanFcoll(fbtl)
    return TwoPhaseFcoll(fbtl)
