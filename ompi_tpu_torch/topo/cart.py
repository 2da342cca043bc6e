"""Cartesian, graph and distributed-graph topologies — mirrors
``ompi/mca/topo`` (base + basic), as the JAX package's ``topo/cart.py``
ports it: pure rank arithmetic, the same on every device. A cartesian
topology is a logical mesh over the communicator's ranks; ``cart_shift``
gives the halo partners and ``neighbors`` the MPI neighborhood order the
neighbor collectives (``topo/neighbor``) follow.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from ompi_tpu_torch.core.errhandler import ERR_ARG, ERR_TOPOLOGY, MPIError


def dims_create(nnodes: int, ndims: int,
                dims: Optional[Sequence[int]] = None) -> List[int]:
    """MPI_Dims_create: balanced factorization of nnodes over ndims,
    honoring fixed (nonzero) entries."""
    out = list(dims) if dims is not None else [0] * ndims
    fixed = 1
    for d in out:
        if d:
            fixed *= d
    if fixed <= 0 or nnodes % fixed:
        raise MPIError(ERR_ARG, f"cannot factor {nnodes} over fixed {out}")
    rem = nnodes // fixed
    free = [i for i, d in enumerate(out) if d == 0]
    # Greedy: repeatedly assign the largest prime factor to the smallest
    # current dimension (matches the reference's balanced split).
    factors: List[int] = []
    n = rem
    p = 2
    while p * p <= n:
        while n % p == 0:
            factors.append(p)
            n //= p
        p += 1
    if n > 1:
        factors.append(n)
    if factors and not free:
        # every slot fixed but nnodes has leftover factors: silently
        # returning dims whose product != nnodes would size a cart
        # over a subset of the processes (MPI mandates an error)
        raise MPIError(ERR_ARG,
                       f"MPI_Dims_create: {nnodes} nodes are not "
                       f"consistent with fully-fixed dims {out}")
    vals = {i: 1 for i in free}
    for f in sorted(factors, reverse=True):
        i = min(free, key=lambda j: vals[j])
        vals[i] *= f
    # MPI mandates the computed dimensions appear in non-increasing
    # order across the free slots.
    for i, v in zip(free, sorted(vals.values(), reverse=True)):
        out[i] = v
    return out


class CartTopology:
    def __init__(self, dims: Sequence[int], periods: Sequence[bool]):
        self.dims = tuple(int(d) for d in dims)
        self.periods = tuple(bool(p) for p in periods)
        self.ndims = len(self.dims)
        self.size = math.prod(self.dims)

    def rank(self, coords: Sequence[int]) -> int:
        """MPI_Cart_rank (row-major, periodic wrap where allowed)."""
        r = 0
        for d, (c, n, per) in enumerate(zip(coords, self.dims,
                                            self.periods)):
            if per:
                c = c % n
            elif not (0 <= c < n):
                raise MPIError(ERR_TOPOLOGY,
                               f"coord {c} out of range in dim {d}")
            r = r * n + c
        return r

    def coords(self, rank: int) -> Tuple[int, ...]:
        out = []
        for n in reversed(self.dims):
            out.append(rank % n)
            rank //= n
        return tuple(reversed(out))

    def shift(self, rank: int, direction: int,
              disp: int) -> Tuple[int, int]:
        """MPI_Cart_shift: (source, dest) for a shift along a dim;
        -2 (MPI_PROC_NULL) at non-periodic boundaries."""
        c = list(self.coords(rank))

        def move(delta):
            cc = list(c)
            cc[direction] += delta
            n = self.dims[direction]
            if self.periods[direction]:
                cc[direction] %= n
            elif not (0 <= cc[direction] < n):
                return -2
            return self.rank(cc)
        return move(-disp), move(disp)

    def neighbors(self, rank: int) -> List[int]:
        """Cart neighborhood order per MPI: for each dim, -1 then +1."""
        out = []
        for d in range(self.ndims):
            src, dst = self.shift(rank, d, 1)
            out.extend([src, dst])
        return out

    def sub_keep(self, remain: Sequence[bool]):
        """MPI_Cart_sub helper: returns (colors, new_topology) — ranks
        sharing dropped-dim coords share a color."""
        colors = []
        for r in range(self.size):
            c = self.coords(r)
            colors.append(tuple(ci for ci, keep in zip(c, remain)
                                if not keep))
        palette = {v: i for i, v in enumerate(sorted(set(colors)))}
        new = CartTopology(
            [n for n, keep in zip(self.dims, remain) if keep],
            [p for p, keep in zip(self.periods, remain) if keep])
        return [palette[c] for c in colors], new


class GraphTopology:
    """MPI_Graph_create: index/edges CSR adjacency."""

    def __init__(self, index: Sequence[int], edges: Sequence[int]):
        self.index = tuple(index)
        self.edges = tuple(edges)
        self.size = len(self.index)

    def neighbors(self, rank: int) -> List[int]:
        lo = self.index[rank - 1] if rank > 0 else 0
        return list(self.edges[lo:self.index[rank]])

    def neighbors_count(self, rank: int) -> int:
        return len(self.neighbors(rank))


class DistGraphTopology:
    """MPI_Dist_graph_create_adjacent: explicit per-rank in/out lists."""

    def __init__(self, sources: Sequence[Sequence[int]],
                 destinations: Sequence[Sequence[int]]):
        self.sources = [list(s) for s in sources]
        self.destinations = [list(d) for d in destinations]
        self.size = len(self.sources)

    def neighbors(self, rank: int) -> List[int]:
        return self.sources[rank]

    def out_neighbors(self, rank: int) -> List[int]:
        return self.destinations[rank]
