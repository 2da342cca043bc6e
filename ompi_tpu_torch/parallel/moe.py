"""Expert parallelism — Mixture-of-Experts token dispatch over a mesh
axis, built on ``InGraphComm.alltoall``.

The port of ``ompi_tpu/parallel/moe.py``: Switch-style top-1 routing with
a fixed expert capacity. Each rank of the ``ep`` axis hosts one expert;
tokens are gathered into per-expert capacity slots, exchanged with one
``alltoall``, run through the local expert, and returned by a second
``alltoall``; the gate probability weights the combine. Tokens over
capacity are dropped (they come back as zeros).

Dispatch is written out of place (``index_put`` with accumulate on a
fresh tensor), so autograd differentiates it: a dropped token adds zeros
at ``(0, clip(slot))``, as the JAX package's ``.at[].add`` does.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ompi_tpu_torch.parallel.ingraph import InGraphComm


def moe_apply(x, params: Dict[str, Any], ep: InGraphComm, capacity: int):
    """Top-1 MoE layer over the ``ep`` axis (one expert per rank).

    Args:
      x: stacked local tokens ``(R, T, D)``.
      params: ``gate`` ``(R, D, E)`` (replicated over ``ep``); ``w1``
        ``(R, D, F)`` and ``w2`` ``(R, F, D)``: each rank's own expert.
      ep: the expert-parallel in-graph communicator (size E).
      capacity: slots per (source rank, expert).
    Returns the stacked combined expert outputs ``(R, T, D)``.
    """
    n = ep.size()
    R, T, D = x.shape
    rows = torch.arange(R, device=x.device)[:, None]
    gate_p = torch.softmax((x @ params["gate"]).float(), dim=-1)   # (R,T,E)
    expert = gate_p.argmax(dim=-1)                                 # (R,T)
    prob = gate_p.amax(dim=-1)

    # capacity slots: each token's position in its expert's queue
    onehot = F.one_hot(expert, n)                                  # (R,T,E)
    slot = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(-1)    # (R,T)
    keep = slot < capacity

    # dispatch[e, c] = the token routed to expert e at slot c
    scatter_e = torch.where(keep, expert, 0)
    scatter_c = slot.clamp(0, capacity - 1)
    dispatch = x.new_zeros((R, n, capacity, D)).index_put(
        (rows, scatter_e, scatter_c),
        torch.where(keep[..., None], x, 0), accumulate=True)

    # expert e receives its slots from every source rank
    recv = ep.alltoall(dispatch, split_axis=0, concat_axis=0)      # (R,n,C,D)
    h = F.gelu(recv @ params["w1"][:, None], approximate="tanh")
    y = h @ params["w2"][:, None]
    back = ep.alltoall(y, split_axis=0, concat_axis=0)             # (R,n,C,D)

    # combine: token t reads back[expert[t], slot[t]] * prob[t]
    out = torch.where(keep[..., None], back[rows, scatter_e, scatter_c], 0.0)
    return (out * prob[..., None].to(x.dtype)).to(x.dtype)


def init_moe_params(d_model: int, d_ff: int, n_experts: int,
                    generator: torch.Generator, device) -> Dict[str, Any]:
    """A replicated gate and one rank's expert weights, drawn from
    ``generator`` (a CPU generator) and moved to ``device``."""
    def normal(*shape, scale):
        return (torch.randn(shape, generator=generator, dtype=torch.float32)
                * scale).to(device)
    return {"gate": normal(d_model, n_experts, scale=0.02),
            "w1": normal(d_model, d_ff, scale=d_model ** -0.5),
            "w2": normal(d_ff, d_model, scale=d_ff ** -0.5)}
