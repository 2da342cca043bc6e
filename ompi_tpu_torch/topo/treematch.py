"""topo/treematch — communication-aware rank reordering.

Behavioral spec: ``ompi/mca/topo/treematch`` (embedding the TreeMatch
library), as the JAX package's ``topo/treematch.py`` ports it: given the
application's communication graph (``MPI_Graph_create`` with
``reorder=1``) and a hardware distance between device slots, permute
ranks so heavily communicating pairs land on close hardware. The
distance is the Manhattan distance between devices' physical ``coords``
where a device exposes them, ``|i - j|`` where it does not, plus a
penalty across host processes (``accelerator.device_locality``). A torch
device exposes neither, so the port takes the linear fallback — the one
the JAX package takes on its virtual CPU devices. The placement is
TreeMatch's constructive core: seed with the heaviest-communicating
rank, then repeatedly place the rank with the largest traffic to placed
ranks onto the free slot minimizing its weighted hop count.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def hardware_distance(devices) -> np.ndarray:
    """Pairwise hop counts between device slots. Manhattan distance on
    physical coords when exposed; |i-j| as the linear fallback; +8
    penalty per process boundary."""
    from ompi_tpu_torch.accelerator.framework import device_locality
    n = len(devices)
    locs = [device_locality(d) for d in devices]
    coords = [c if c else (i,) for i, (_p, c) in enumerate(locs)]
    width = max(len(c) for c in coords)
    coords = [c + (0,) * (width - len(c)) for c in coords]
    arr = np.asarray(coords, dtype=np.int64)
    dist = np.abs(arr[:, None, :] - arr[None, :, :]).sum(axis=2)
    procs = np.asarray([p for p, _c in locs])
    dist = dist + 8 * (procs[:, None] != procs[None, :])
    return dist.astype(np.float64)


def comm_matrix_from_graph(index: Sequence[int], edges: Sequence[int]
                           ) -> np.ndarray:
    """Symmetric traffic matrix from an MPI_Graph_create (index, edges)
    adjacency (unit weight per edge — the information the API carries)."""
    n = len(index)
    m = np.zeros((n, n))
    prev = 0
    for r, end in enumerate(index):
        for e in edges[prev:end]:
            m[r, e] += 1.0
            m[e, r] += 1.0
        prev = end
    return m


def treematch_permutation(comm_matrix: np.ndarray,
                          hw_dist: np.ndarray) -> List[int]:
    """Constructive placement: returns ``perm`` with ``perm[rank] =
    hardware slot``. Greedy TreeMatch core: heaviest-traffic rank
    first, then max-attached rank onto the cost-minimizing free slot."""
    n = comm_matrix.shape[0]
    if n == 0:
        return []
    cm = np.asarray(comm_matrix, np.float64)
    placed_ranks: List[int] = []
    placed_slots: List[int] = []
    free_mask = np.ones(n, bool)          # free hardware slots
    unplaced_mask = np.ones(n, bool)      # unplaced ranks
    order_seed = int(np.argmax(cm.sum(axis=1)))
    # seed on the most central slot (min total hw distance)
    seed_slot = int(np.argmin(hw_dist.sum(axis=1)))
    placed_ranks.append(order_seed)
    placed_slots.append(seed_slot)
    free_mask[seed_slot] = False
    unplaced_mask[order_seed] = False
    # traffic of every rank to the placed set, updated incrementally
    attach = cm[:, order_seed].copy()
    for _ in range(n - 1):
        # rank with max traffic to the placed set (ties: lowest rank,
        # keeping the permutation deterministic across controllers)
        cand = np.where(unplaced_mask)[0]
        best_rank = int(cand[np.argmax(attach[cand])])
        # slot minimizing weighted distance to placed peers (one
        # matvec: costs[slot] = sum_p cm[rank,p] * hw[slot, slot_of_p])
        w = cm[best_rank, placed_ranks]
        costs = hw_dist[:, placed_slots] @ w
        free = np.where(free_mask)[0]
        best_slot = int(free[np.argmin(costs[free])])
        placed_ranks.append(best_rank)
        placed_slots.append(best_slot)
        free_mask[best_slot] = False
        unplaced_mask[best_rank] = False
        attach += cm[:, best_rank]
    perm = np.empty(n, np.int64)
    perm[placed_ranks] = placed_slots
    return perm.tolist()


def placement_cost(comm_matrix: np.ndarray, hw_dist: np.ndarray,
                   perm: Optional[Sequence[int]] = None) -> float:
    """Total weighted hop count of a placement (identity when perm is
    None) — the objective treematch minimizes; exposed so tools can
    report the before/after gain."""
    n = comm_matrix.shape[0]
    if perm is None:
        perm = list(range(n))
    p = np.asarray(perm)
    return float((comm_matrix * hw_dist[np.ix_(p, p)]).sum() / 2.0)
