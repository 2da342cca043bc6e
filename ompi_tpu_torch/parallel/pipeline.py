"""Pipeline parallelism — GPipe-style microbatch pipelining over a mesh
axis, built on ``InGraphComm.ring_shift``.

The port of ``ompi_tpu/parallel/pipeline.py``. Each ``pp`` rank owns one
stage; at tick t, rank r works on microbatch ``t - r``, a per-rank
tensor. All ranks compute at every tick (bubble ticks on garbage, as in
the JAX package's SPMD scan); only valid ticks of the last stage write
the output, out of place, so autograd carries each stage's gradients
back through the shifts.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ompi_tpu_torch.parallel.ingraph import InGraphComm


def pipeline_apply(stage_fn: Callable, stage_params: Any, x_micro,
                   pp: InGraphComm):
    """Run ``n_micro`` microbatches through an ``n``-stage pipeline.

    Args:
      stage_fn: ``(stage_params, activation) -> activation`` on stacked
        activations ``(R, *act)``; shapes are uniform across stages.
      stage_params: each pp rank's stage parameters, stacked.
      x_micro: ``(R, n_micro, *act)`` input microbatches. Only stage 0's
        rows are read.
      pp: the pipeline in-graph communicator.

    Returns ``(R, n_micro, *act)``: valid on the LAST stage's rows (the
    other rows hold zeros).
    """
    n = pp.size()
    r = pp.rank()
    n_micro = x_micro.shape[1]
    ones = (1,) * (x_micro.ndim - 2)
    first = (r == 0).view(-1, *ones)                       # (R, 1, ...)
    last = (r == n - 1)[:, None]
    micro = torch.arange(n_micro, device=x_micro.device)
    outputs = torch.zeros_like(x_micro)
    a_out = torch.zeros_like(x_micro[:, 0])
    for t in range(n_micro + n - 1):
        # activation handoff: stage r receives stage r-1's last output;
        # stage 0 injects microbatch t (clipped past the last one)
        recv = pp.ring_shift(a_out, 1)
        a_in = torch.where(first, x_micro[:, min(t, n_micro - 1)], recv)
        a_out = stage_fn(stage_params, a_in)
        # rank r's tick carries microbatch m = t - r; the last stage
        # writes it when 0 <= m < n_micro
        write = last & (micro[None] == (t - r)[:, None])  # (R, n_micro)
        outputs = torch.where(write.view(*write.shape, *ones),
                              a_out[:, None], outputs)
    return outputs
