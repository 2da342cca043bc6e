"""MPI's collectives on a stacked buffer, in plain torch: row ``r`` of the
input is rank ``r``'s send buffer, row ``r`` of the output its receive
buffer, as the stacked world lays them out.

``dtype`` is the precision of a reduction (float64 for the reference,
bfloat16 for the control); data movement copies the input's own values,
except that the control rounds them to ``dtype`` too. ``significant``
says which rows of an output MPI defines: the root's alone for
``reduce`` and ``gather``, every row otherwise."""
from __future__ import annotations

from typing import Optional

import torch

REDUCTIONS = ("allreduce", "reduce", "reduce_scatter_block")


def collective(func: str, x: torch.Tensor, root: int,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The full stacked output ``func`` gives for input ``x``.
    Reductions sum in ``dtype`` (float64 when None); data movement keeps
    the values, rounded to ``dtype`` when one is given."""
    n = x.shape[0]
    red = torch.float64 if dtype is None else dtype
    if func in REDUCTIONS:
        if func == "reduce_scatter_block":
            # out[r] = sum_i x[i, r]
            return x.to(red).sum(0)
        s = x.to(red).sum(0)
        return s.unsqueeze(0).expand(n, *s.shape)
    v = x if dtype is None else x.to(dtype)
    if func == "allgather":
        return v.unsqueeze(0).expand(n, *v.shape)
    if func == "alltoall":
        return v.transpose(0, 1)
    if func == "bcast":
        return v[root].unsqueeze(0).expand(n, *v.shape[1:])
    if func == "gather":
        return v.unsqueeze(0).expand(n, *v.shape)
    if func == "scatter":
        return v[root]
    raise KeyError(f"no reference for {func!r}")


def significant(func: str, root: int, n: int) -> slice:
    """The output rows MPI defines."""
    if func in ("reduce", "gather"):
        return slice(root, root + 1)
    return slice(0, n)
