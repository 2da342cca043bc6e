"""In-graph communicators: MPI collective semantics over one axis of a
rank mesh, inside the model's own computation.

The port of ``ompi_tpu/parallel/ingraph.py``. There, an ``InGraphComm``
is used inside ``shard_map`` bodies and its collectives are ``lax``
collective ops. Here the body runs once on stacked tensors whose leading
dim holds every rank of a ``Mesh`` (``parallel/mesh.py``): a collective
views that dim as the mesh's shape and acts on its own axis's dim, so it
is a plain tensor op — sum, expand, roll, transpose — that autograd
differentiates as the JAX package's AD transposes its collective.

- ``psum``/``pmax``/``pmin`` reduce along the axis, then broadcast back;
  other ops fold with the op's ``reduce_tree`` (rank order kept).
- ``allgather`` expands; tiled ``alltoall`` gives rank r chunk r of every
  rank, concatenated in rank order; ``ppermute``/``ring_shift`` move rank
  r's data to r + shift (``torch.roll`` on the axis's dim).
- ``rank()`` is an int tensor of shape ``(R,)``: each rank's coordinate on
  the axis. Per-rank values in the callers are tensors of this kind.
- The Megatron f/g pair are ``torch.autograd.Function``s: f (``copy_in``)
  is identity forward, psum backward; g (``reduce_out``) is psum forward,
  identity backward. Everything else differentiates with plain autograd:
  per-rank SPMD AD equals autograd of the sum of the per-rank results
  over the stacked ranks, once f and g carry their own backwards.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ompi_tpu_torch.core import op as op_mod
from ompi_tpu_torch.parallel.mesh import Mesh


class _MegatronF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ctx.comm._psum(ct), None


class _MegatronG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm._psum(x)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class InGraphComm:
    """MPI-style collectives over axis ``axis_name`` (of size
    ``axis_size``) of ``mesh``, on stacked ``(mesh.size, *local)``
    tensors."""

    def __init__(self, axis_name: str, axis_size: int, mesh: Mesh):
        self.axis = axis_name
        self.mesh = mesh
        self._dim = mesh.axis_dim(axis_name)
        if mesh.shape[self._dim] != axis_size:
            raise ValueError(f"axis {axis_name!r} has size "
                             f"{mesh.shape[self._dim]} in {mesh!r}, not "
                             f"{axis_size}")
        self._size = axis_size

    def __repr__(self):
        return f"InGraphComm({self.axis!r}, {self._size}, {self.mesh!r})"

    # -- the stacked layout --------------------------------------------
    def _grid(self, x: torch.Tensor) -> torch.Tensor:
        """(R, *local) -> (*mesh.shape, *local)."""
        if x.ndim == 0 or x.shape[0] != self.mesh.size:
            raise ValueError(f"{self!r}: want a stacked tensor with "
                             f"{self.mesh.size} rows, got "
                             f"{tuple(x.shape)}")
        return x.reshape(*self.mesh.shape, *x.shape[1:])

    def _flat(self, g: torch.Tensor) -> torch.Tensor:
        return g.reshape(self.mesh.size, *g.shape[len(self.mesh.shape):])

    def _local(self, axis: int) -> int:
        """Grid dim of local axis ``axis``."""
        return len(self.mesh.shape) + axis

    def _spread(self, red: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """A value reduced over the axis's dim, back on every rank."""
        return self._flat(red.unsqueeze(self._dim).expand_as(like))

    def _psum(self, x: torch.Tensor) -> torch.Tensor:
        g = self._grid(x)
        return self._spread(op_mod.SUM.reduce_tree(g, self._dim), g)

    # -- identity ------------------------------------------------------
    def size(self) -> int:
        return self._size

    def rank(self) -> torch.Tensor:
        shape = [1] * len(self.mesh.shape)
        shape[self._dim] = self._size
        r = torch.arange(self._size, device=self.mesh.device).view(shape)
        return r.expand(self.mesh.shape).reshape(self.mesh.size)

    # -- collectives ---------------------------------------------------
    def allreduce(self, x, op: op_mod.Op = op_mod.SUM):
        """sum/max/min as one torch reduction over the axis; other ops
        fold in rank order (``Op.reduce_tree``), as the JAX package folds
        its all_gather."""
        g = self._grid(x)
        return self._spread(op.reduce_tree(g, self._dim), g)

    def pmean(self, x):
        return self._psum(x) / self._size

    def reduce(self, x, op: op_mod.Op = op_mod.SUM, root: int = 0):
        return self.allreduce(x, op)       # symmetric design, as in JAX

    def bcast(self, x, root: int = 0):
        g = self._grid(x)
        return self._spread(g.select(self._dim, root), g)

    def allgather(self, x, *, axis: int = 0, tiled: bool = False):
        """Every rank gets the axis's values stacked at local ``axis``
        (a new dim; ``tiled`` concatenates along it instead)."""
        g = self._grid(x)
        y = g.movedim(self._dim, self._local(axis) - 1)
        y = y.unsqueeze(self._dim).expand(
            *self.mesh.shape, *y.shape[len(self.mesh.shape) - 1:])
        y = self._flat(y)
        if tiled:
            y = y.flatten(1 + axis, 2 + axis)
        return y

    def reduce_scatter(self, x, op: op_mod.Op = op_mod.SUM, *,
                       scatter_axis: int = 0):
        """Rank r gets chunk r (along ``scatter_axis``) of the reduction.
        sum is one torch reduction; other ops fold the ranks' chunks left
        to right with ``op.fn``, as the JAX package folds its alltoall."""
        g = self._grid(x)
        if op.xla_prim == "sum":
            red = op.reduce_tree(g, self._dim)
        else:
            parts = g.unbind(self._dim)
            red = parts[0]
            for p in parts[1:]:
                red = op.fn(red, p)
        ax = self._local(scatter_axis) - 1
        n, L = self._size, red.shape[ax]
        if L % n:
            raise ValueError(f"reduce_scatter: dim {L} does not split "
                             f"over {n} ranks")
        red = red.unflatten(ax, (n, L // n)).movedim(ax, self._dim)
        return self._flat(red)

    def alltoall(self, x, *, split_axis: int = 0, concat_axis: int = 0):
        """Tiled all-to-all: rank r receives chunk r (along
        ``split_axis``) of every rank, concatenated along ``concat_axis``
        in source-rank order."""
        g = self._grid(x)
        n, s, c = self._size, self._local(split_axis), self._local(
            concat_axis)
        if g.shape[s] % n:
            raise ValueError(f"alltoall: dim {g.shape[s]} does not split "
                             f"over {n} ranks")
        # chunk index -> the axis's dim (destination); source rank -> a
        # local dim just before the concat dim
        g = g.unflatten(s, (n, g.shape[s] // n)).transpose(self._dim, s)
        g = g.movedim(s, c).flatten(c, c + 1)
        return self._flat(g)

    # -- point-to-point patterns -----------------------------------------
    def ppermute(self, x, perm: Sequence[Tuple[int, int]]):
        """Rank ``src``'s data goes to ``dst`` for each pair; a rank that
        receives nothing gets zeros."""
        n = self._size
        src = [-1] * n
        for s, d in perm:
            if not (0 <= s < n and 0 <= d < n) or src[d] != -1:
                raise ValueError(f"ppermute: bad permutation {perm!r}")
            src[d] = s
        g = self._grid(x)
        idx = torch.tensor([max(s, 0) for s in src], device=g.device)
        got = g.index_select(self._dim, idx)
        keep = torch.tensor([s >= 0 for s in src], device=g.device)
        shape = [1] * g.ndim
        shape[self._dim] = n
        return self._flat(torch.where(keep.view(shape), got,
                                      torch.zeros((), dtype=g.dtype,
                                                  device=g.device)))

    def ring_shift(self, x, shift: int = 1):
        """Rank r's data goes to rank (r + shift) mod n — the primitive
        under ring attention and the pipeline's activation handoff."""
        return self._flat(torch.roll(self._grid(x), shift, self._dim))

    def sendrecv(self, x, dest: int, source: int):
        """Route rank ``source``'s shard to rank ``dest``; every other
        rank receives zeros."""
        return self.ppermute(x, [(source, dest)])

    # -- tensor-parallel autograd operators ------------------------------
    def copy_in(self, x):
        """Identity forward, psum backward (Megatron 'f'): where a
        replicated activation feeds a tp-sharded computation."""
        return _MegatronF.apply(x, self)

    def reduce_out(self, x):
        """psum forward, identity backward (Megatron 'g'): on
        row-parallel partial outputs."""
        return _MegatronG.apply(x, self)

    # -- prefix ops ----------------------------------------------------
    def scan(self, x, op: op_mod.Op = op_mod.SUM):
        """Inclusive prefix over the axis's ranks, in rank order."""
        g = self._grid(x)
        if op.name == "sum":
            return self._flat(torch.cumsum(g, self._dim, dtype=g.dtype))
        parts = list(g.unbind(self._dim))
        for i in range(1, len(parts)):
            parts[i] = op.fn(parts[i - 1], parts[i])
        return self._flat(torch.stack(parts, self._dim))
