"""Process groups — mirrors ``ompi/group`` (dense storage variant).

A Group is an ordered tuple of world ranks. All MPI-3 group set algebra is
provided; comparison constants follow MPI semantics.
"""
from __future__ import annotations

from typing import Sequence, Tuple

IDENT = 0
CONGRUENT = 1
SIMILAR = 2
UNEQUAL = 3
UNDEFINED = -32766


class Group:
    def __init__(self, world_ranks: Sequence[int]):
        self.world_ranks: Tuple[int, ...] = tuple(int(r) for r in world_ranks)

    @property
    def size(self) -> int:
        return len(self.world_ranks)

    def rank_of(self, world_rank: int) -> int:
        """Local rank of a world rank, or UNDEFINED."""
        try:
            return self.world_ranks.index(world_rank)
        except ValueError:
            return UNDEFINED

    def translate_ranks(self, ranks: Sequence[int],
                        other: "Group") -> Tuple[int, ...]:
        return tuple(other.rank_of(self.world_ranks[r]) for r in ranks)

    def compare(self, other: "Group") -> int:
        if self.world_ranks == other.world_ranks:
            return IDENT
        if set(self.world_ranks) == set(other.world_ranks):
            return SIMILAR
        return UNEQUAL

    def incl(self, ranks: Sequence[int]) -> "Group":
        return Group([self.world_ranks[r] for r in ranks])

    def excl(self, ranks: Sequence[int]) -> "Group":
        drop = set(ranks)
        return Group([wr for i, wr in enumerate(self.world_ranks)
                      if i not in drop])

    def range_incl(self, ranges: Sequence[Tuple[int, int, int]]) -> "Group":
        ranks = []
        for first, last, stride in ranges:
            stop = last + (1 if stride > 0 else -1)
            ranks.extend(range(first, stop, stride))
        return self.incl(ranks)

    def range_excl(self, ranges: Sequence[Tuple[int, int, int]]) -> "Group":
        drop = []
        for first, last, stride in ranges:
            stop = last + (1 if stride > 0 else -1)
            drop.extend(range(first, stop, stride))
        return self.excl(drop)

    def union(self, other: "Group") -> "Group":
        seen = list(self.world_ranks)
        have = set(seen)
        for wr in other.world_ranks:
            if wr not in have:
                seen.append(wr)
                have.add(wr)
        return Group(seen)

    def intersection(self, other: "Group") -> "Group":
        have = set(other.world_ranks)
        return Group([wr for wr in self.world_ranks if wr in have])

    def difference(self, other: "Group") -> "Group":
        have = set(other.world_ranks)
        return Group([wr for wr in self.world_ranks if wr not in have])

    def __repr__(self):
        return f"Group(size={self.size})"
