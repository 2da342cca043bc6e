"""The one traffic generator: it turns a mix's parameters and a seed into
the run's inputs and its sequence of calls or steps. The same seed gives
the same sequence; every seed gives the same sizes, the same calls and
the same roots, and changes only values.

A closed loop has one caller and no arrival times: call ``i`` of a
``collectives`` mix is ``calls[i % len(calls)]`` with root
``(i // len(calls)) % ranks`` (the root cycles over the ranks, one root
per round); step ``i`` of a ``grad_sync`` mix hands in the gradients
once. Before call or step ``i`` the benchmark writes ``mark(i)`` into a
few elements of each input, so consecutive calls see different data."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

MARKS = 1 << 16          # distinct mark values, reused cyclically


class Schedule:
    """Call ``i``'s collective, root and mark value for one mix and
    seed."""

    def __init__(self, mix: Dict[str, Any], ranks: int, seed: int):
        self.calls = tuple(mix.get("calls", ("step",)))
        self.ranks = int(ranks)
        self.rooted = mix.get("root") == "cycle"
        rng = np.random.default_rng(np.random.SeedSequence(int(seed)))
        # marks in [-1, 1): the inputs are standard normal
        self._marks = rng.uniform(-1.0, 1.0, MARKS).tolist()

    def call(self, i: int) -> Tuple[str, int]:
        c = len(self.calls)
        root = (i // c) % self.ranks if self.rooted else 0
        return self.calls[i % c], root

    def mark(self, i: int) -> float:
        return self._marks[i % MARKS]


def torch_seed(seed: int) -> int:
    """A seed for ``torch.Generator.manual_seed`` (which takes 64 bits)
    from any whole number the harness is given."""
    state = np.random.SeedSequence(int(seed)).generate_state(1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)
