"""Data-parallel gradient averaging in plain torch: every rank's result is
the mean over the ranks of their gradients (row ``r`` of a stacked leaf
is rank ``r``'s gradient)."""
from __future__ import annotations

from typing import Optional

import torch


def mean(g: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The mean over the ranks, summed in ``dtype`` (float64 when None),
    laid out as the program returns it: one row per rank."""
    n = g.shape[0]
    m = g.to(torch.float64 if dtype is None else dtype).sum(0) / n
    return m.unsqueeze(0).expand(n, *m.shape)
