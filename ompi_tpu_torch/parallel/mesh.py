"""The rank mesh — the single-controller counterpart of
``jax.sharding.Mesh``, ``PartitionSpec``, ``NamedSharding`` placement and
``shard_map``'s in/out specs.

The JAX package runs a per-rank body once per device under ``shard_map``.
The port runs it once, on tensors that carry one leading rank dim of size
``R = prod(mesh.shape)``: row ``r`` is rank ``r``'s local value, ranks in
row-major mesh order (the order ``Mesh(devs.reshape(shape), names)``
gives them). Every rank sits on the mesh's one device — ``cuda:0`` on the
card, ``cpu`` in the tests — as in the port's ``Communicator``.

- ``P``: a partition spec, one entry per leading dim of a global array:
  ``None`` (not split), an axis name, or a tuple of axis names (split
  over their product, major first).
- ``Mesh.shard(tree, specs)``: global leaves become stacked
  ``(R, *local)`` leaves (``jax.device_put(x, NamedSharding(mesh, s))``
  followed by ``shard_map``'s ``in_specs``).
- ``Mesh.unshard(tree, specs)``: the inverse (``out_specs``). An axis a
  spec does not name holds replicated copies; they must agree, and the
  value is rank 0's along that axis.
- ``tree_map`` / ``tree_leaves``: the pytree helpers the port needs, over
  dicts, lists and tuples.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

# Replicated copies agree when they differ by at most this much, relative
# to the larger of 1 and the leaf's largest magnitude: ranks that compute
# the same value in separate rows of a batched op may round differently.
REPLICA_RTOL = 1e-6


class P(tuple):
    """A partition spec: ``P("pp", None, "tp")``; ``P()`` is replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``); dicts, lists and tuples are nodes, anything else a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


class Mesh:
    """``shape`` ranks along ``axis_names``, all on ``device``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device):
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(
                axis_names):
            raise ValueError(f"Mesh: {tuple(shape)} does not match the "
                             f"distinct axis names {tuple(axis_names)}")
        if any(int(n) < 1 for n in shape):
            raise ValueError(f"Mesh: axis sizes must be >= 1, got "
                             f"{tuple(shape)}")
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        self.size = math.prod(self.shape)
        self.device = torch.device(device)

    def __repr__(self):
        axes = ", ".join(f"{a}={n}" for a, n in zip(self.axis_names,
                                                    self.shape))
        return f"Mesh({axes}; {self.device})"

    def axis_dim(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"{name!r} is not an axis of {self!r}")
        return self.axis_names.index(name)

    def _entries(self, spec: P, ndim: int) -> List[Tuple[str, ...]]:
        """The axes each dim is split over, checked against the mesh."""
        if len(spec) > ndim:
            raise ValueError(f"spec {spec!r} has more entries than the "
                             f"array has dims ({ndim})")
        entries = [() if e is None else (e,) if isinstance(e, str)
                   else tuple(e) for e in spec]
        entries += [()] * (ndim - len(entries))
        used = [a for e in entries for a in e]
        for a in used:
            self.axis_dim(a)
        if len(set(used)) != len(used):
            raise ValueError(f"spec {spec!r} names an axis twice")
        return entries

    def _shard_leaf(self, x, spec: P) -> torch.Tensor:
        x = (x.to(self.device) if isinstance(x, torch.Tensor)
             else torch.tensor(np.asarray(x), device=self.device))
        entries = self._entries(spec, x.ndim)
        split, pos, local = [], {}, []
        for dim, axes in zip(x.shape, entries):
            ways = math.prod(self.shape[self.axis_dim(a)] for a in axes)
            if dim % ways:
                raise ValueError(f"dim {dim} does not split {ways} ways "
                                 f"(spec {spec!r}, shape {tuple(x.shape)})")
            for a in axes:
                pos[a] = len(split)
                split.append(self.shape[self.axis_dim(a)])
            local.append(len(split))
            split.append(dim // ways)
        g = x.reshape(split)
        for a in self.axis_names:                 # replicated: new dims
            if a not in pos:
                pos[a] = g.ndim
                g = g.unsqueeze(-1)
        g = g.permute([pos[a] for a in self.axis_names] + local)
        g = g.expand(*self.shape, *g.shape[len(self.shape):])
        return g.reshape(self.size, *g.shape[len(self.shape):]).contiguous()

    def _replicas(self, y: torch.Tensor, spec: P):
        """(grid view of ``y``, its dims' axes, and for each mesh axis the
        spec does not name: (mesh dim, largest difference from rank 0's
        copy along it, largest magnitude))."""
        if y.shape[0] != self.size:
            raise ValueError(f"stacked leaf has {y.shape[0]} rows, the mesh "
                             f"{self.size} ranks")
        entries = self._entries(spec, y.ndim - 1)
        g = y.reshape(*self.shape, *y.shape[1:])
        named = {a for e in entries for a in e}
        reps = []
        for d, a in enumerate(self.axis_names):
            if a not in named and g.numel():
                first = g.narrow(d, 0, 1)
                reps.append((d, (g - first).abs().max().item(),
                             first.abs().max().item()))
        return g, entries, reps

    def _unshard_leaf(self, y: torch.Tensor, spec: P) -> torch.Tensor:
        g, entries, reps = self._replicas(y, spec)
        for d, dev, mag in reps:
            if dev > REPLICA_RTOL * max(1.0, mag):
                raise ValueError(f"replicated copies along "
                                 f"{self.axis_names[d]!r} differ by "
                                 f"{dev:.3g} (spec {spec!r})")
        named = [a for e in entries for a in e]
        g = g[tuple(slice(None) if a in named else 0
                    for a in self.axis_names)]
        kept = [a for a in self.axis_names if a in named]
        order, shape = [], []
        for i, axes in enumerate(entries):
            order += [kept.index(a) for a in axes] + [len(kept) + i]
            shape.append(g.shape[len(kept) + i] * math.prod(
                self.shape[self.axis_dim(a)] for a in axes))
        return g.permute(order).reshape(shape)

    def shard(self, tree: Any, specs: Any) -> Any:
        """Global leaves (tensors or arrays) -> stacked ``(R, *local)``
        tensors on the mesh's device."""
        return tree_map(lambda s, x: self._shard_leaf(x, s), specs, tree)

    def unshard(self, tree: Any, specs: Any) -> Any:
        """Stacked leaves -> global tensors; raises ``ValueError`` where
        replicated copies disagree."""
        return tree_map(lambda s, y: self._unshard_leaf(y, s), specs, tree)

    def divergence(self, tree: Any, specs: Any) -> float:
        """The largest difference between replicated copies of any leaf,
        along every mesh axis its spec does not name."""
        devs = []
        tree_map(lambda s, y: devs.extend(d for _, d, _ in
                                          self._replicas(y, s)[2]),
                 specs, tree)
        return max(devs, default=0.0)
