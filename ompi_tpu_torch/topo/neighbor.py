"""Neighbor collectives on the device — one gather over the stacked
tensor per call.

Behavioral spec: the neighborhood collectives of the base registry
(``ompi/mca/coll/base/coll_base_functions.h:185-320``) over the topo
framework (``ompi/mca/topo/``): each rank exchanges buffers with its
cart/graph neighbors; cart shifts are the halo-exchange workhorse.

The JAX package lowers an exchange to edge-colored ``ppermute`` waves
because an ICI collective-permute must be a permutation. Here every rank
is a row of one tensor on one device, so an exchange needs no waves: rank
r's k-th received buffer is a row of the input, and the whole exchange is
ONE ``index_select`` over the rank dim (allgather) or over the flattened
(rank, out-slot) dims (alltoall) — the result rows of every rank back to
back, split into per-rank views. The index tensors are built from the
plan on the host, copied to the device once and cached on the plan, so a
topology change drops them together with the plan, and no call copies an
index from the host.

``NeighborPlan`` keeps the reference's semantics: the FIFO pairing of
duplicate edges (periodic dims of size <= 2, multigraph dist-graphs),
``valid_slots``, ``slot_valid`` and ``has_chunk``. It also keeps the wave
coloring (``waves``, ``n_waves``) as plan data: it is the reference's
schedule, and the tests hold it against the reference's plan.
"""
from __future__ import annotations

from collections import defaultdict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ompi_tpu_torch.core.errhandler import ERR_BUFFER, ERR_COUNT, MPIError


class NeighborPlan:
    """Edge pairing, wave coloring and device index maps for one
    (comm, topo)."""

    def __init__(self, comm):
        topo = comm.topo
        n = comm.size
        in_nb = topo.neighbors
        out_nb = getattr(topo, "out_neighbors", topo.neighbors)
        self.n = n
        self.in_lists = [list(in_nb(r)) for r in range(n)]
        self.out_lists = [list(out_nb(r)) for r in range(n)]
        self.max_in = max((len(l) for l in self.in_lists), default=0)
        self.max_out = max((len(l) for l in self.out_lists), default=0)
        # valid in-slot index lists (the API compresses invalid slots)
        self.valid_slots = [
            [i for i, s in enumerate(l) if 0 <= s < n]
            for l in self.in_lists]
        self.slot_valid = np.zeros((n, max(self.max_in, 1)), bool)
        for r, l in enumerate(self.in_lists):
            for i, s in enumerate(l):
                self.slot_valid[r, i] = 0 <= s < n

        # FIFO multiplicity pairing of (src,dst) out-slots with in-slots
        # (duplicate edges from periodic dims of size <= 2 / multigraphs)
        out_q: Dict[Tuple[int, int], deque] = defaultdict(deque)
        for s in range(n):
            for j, d in enumerate(self.out_lists[s]):
                if 0 <= d < n:
                    out_q[(s, d)].append(j)
        # edge = (src, dst, out_slot or None, in_slot)
        edges: List[Tuple[int, int, Optional[int], int]] = []
        for d in range(n):
            for i, s in enumerate(self.in_lists[d]):
                if not (0 <= s < n):
                    continue
                q = out_q.get((s, d))
                j = q.popleft() if q else None
                edges.append((s, d, j, i))

        # The reference's greedy edge coloring: a wave uses each rank at
        # most once as source and once as destination.
        waves: List[dict] = []
        self.wmap = np.zeros((n, max(self.max_in, 1)), np.int32)
        self.has_chunk = np.zeros((n, max(self.max_in, 1)), bool)
        for (s, d, j, i) in edges:
            for wi, w in enumerate(waves):
                if s not in w["srcs"] and d not in w["dsts"]:
                    break
            else:
                wi = len(waves)
                w = {"perm": [], "jsel": np.zeros(n, np.int32),
                     "srcs": set(), "dsts": set()}
                waves.append(w)
            w["perm"].append((s, d))
            w["jsel"][s] = j if j is not None else 0
            w["srcs"].add(s)
            w["dsts"].add(d)
            self.wmap[d, i] = wi
            self.has_chunk[d, i] = j is not None
        self.waves = waves
        self.n_waves = len(waves)
        self.edges = edges              # (src, dst, out_slot, in_slot)
        # (dst, in_slot) -> (src, out_slot or None)
        self.slot_src = {(d, i): (s, j) for (s, d, j, i) in edges}
        # (kind, ..., device) -> index tensors on that device
        self._dev: Dict[tuple, Any] = {}

    def device_index(self, key: tuple, build: Callable[[], Any]):
        """``build()``'s index tensors for ``key``, built once (a bounded
        cache: the ragged forms key on their counts)."""
        got = self._dev.get(key)
        if got is None:
            got = build()
            if len(self._dev) < 64:
                self._dev[key] = got
        return got


def _plan(comm) -> NeighborPlan:
    cache = getattr(comm, "_nbr_plan", None)
    if cache is None or cache[0] is not comm.topo:
        cache = (comm.topo, NeighborPlan(comm))
        comm._nbr_plan = cache
    return cache[1]


def _on_device(comm, tensors: Sequence[torch.Tensor]) -> None:
    for t in tensors:
        if t.device != comm.device:
            raise MPIError(ERR_BUFFER,
                           f"buffer on {t.device}; the communicator's "
                           f"device is {comm.device}")


def _idx(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64).reshape(-1),
                           device=device)


def device_neighbor_allgather(comm, x: torch.Tensor) -> List[torch.Tensor]:
    """x: stacked (N, *s) tensor; returns per-rank (deg_r, *s) views —
    each rank's neighbors' rows in neighbor order — of one gather."""
    _on_device(comm, [x])
    plan = _plan(comm)

    def build():
        rows = [plan.in_lists[r][i] for r in range(plan.n)
                for i in plan.valid_slots[r]]
        return _idx(rows, x.device)
    idx = plan.device_index(("ag", x.device), build)
    sizes = [len(v) for v in plan.valid_slots]
    return list(torch.split(x.index_select(0, idx), sizes))


def device_neighbor_alltoall(comm, x: torch.Tensor) -> List[torch.Tensor]:
    """x: stacked (N, D_out, *s); rank r's j-th chunk goes to its j-th
    out-neighbor; returns per-rank (deg_in_r, *s) views of one gather. An
    in-slot whose sender has no paired out-slot receives zeros."""
    _on_device(comm, [x])
    plan = _plan(comm)
    d_out = x.shape[1]
    if d_out < plan.max_out:
        raise MPIError(ERR_COUNT, f"neighbor_alltoall needs {plan.max_out} "
                                  f"chunks per rank, got {d_out}")

    def build():
        flat, keep = [], []
        for r in range(plan.n):
            for i in plan.valid_slots[r]:
                s, j = plan.slot_src[(r, i)]
                flat.append(s * d_out + (j or 0))
                keep.append(j is not None)
        idx = _idx(flat, x.device)
        if all(keep):
            return idx, None
        return idx, torch.as_tensor(~np.asarray(keep), device=x.device)
    idx, nochunk = plan.device_index(("a2a", d_out, x.device), build)
    res = x.reshape((-1,) + tuple(x.shape[2:])).index_select(0, idx)
    if nochunk is not None:
        res.masked_fill_(nochunk.view((-1,) + (1,) * (res.ndim - 1)), 0)
    sizes = [len(v) for v in plan.valid_slots]
    return list(torch.split(res, sizes))


def device_neighbor_allgatherv(comm, arrs: Sequence[torch.Tensor]
                               ) -> List[torch.Tensor]:
    """Ragged flat per-rank tensors; rank r receives the concatenation of
    its neighbors' tensors in neighbor order: one concatenation of the
    inputs and one gather, split into per-rank views."""
    _on_device(comm, arrs)
    plan = _plan(comm)
    counts = tuple(int(a.shape[0]) for a in arrs)
    offs = np.concatenate([[0], np.cumsum(counts)])

    def build():
        parts = [offs[n] + np.arange(counts[n]) for r in range(plan.n)
                 for n in plan.in_lists[r] if 0 <= n < plan.n]
        idx = np.concatenate(parts) if parts else np.empty(0, np.int64)
        return _idx(idx, comm.device)
    idx = plan.device_index(("agv", counts, comm.device), build)
    sizes = [sum(counts[n] for n in plan.in_lists[r] if 0 <= n < plan.n)
             for r in range(plan.n)]
    return list(torch.split(torch.cat(list(arrs)).index_select(0, idx),
                            sizes))


def device_neighbor_alltoallv(comm, rows: Sequence[Sequence[torch.Tensor]]
                              ) -> List[List[torch.Tensor]]:
    """``rows[r][j]`` is rank r's flat chunk for its j-th out-neighbor;
    rank r receives one chunk per in-slot (an empty one where the slot is
    invalid or its sender sent nothing), as views of one gather over the
    concatenated chunks."""
    chunks = [c for row in rows for c in row]
    _on_device(comm, chunks)
    plan = _plan(comm)
    counts = tuple(tuple(int(c.shape[0]) for c in row) for row in rows)
    flat_counts = [c for row in counts for c in row]
    offs = np.concatenate([[0], np.cumsum(flat_counts)])
    start = np.concatenate([[0], np.cumsum([len(row) for row in counts])])
    lengths = []
    for r in range(plan.n):
        for i in range(len(plan.in_lists[r])):
            s, j = plan.slot_src.get((r, i), (None, None))
            ok = j is not None and j < len(counts[s])
            lengths.append((s, j, counts[s][j] if ok else 0))

    def build():
        parts = [offs[start[s] + j] + np.arange(c) for s, j, c in lengths
                 if c]
        idx = np.concatenate(parts) if parts else np.empty(0, np.int64)
        return _idx(idx, comm.device)
    idx = plan.device_index(("a2av", counts, comm.device), build)
    res = torch.split(torch.cat(chunks).index_select(0, idx),
                      [c for _s, _j, c in lengths])
    out: List[List[torch.Tensor]] = []
    k = 0
    for r in range(plan.n):
        m = len(plan.in_lists[r])
        out.append(list(res[k:k + m]))
        k += m
    return out
