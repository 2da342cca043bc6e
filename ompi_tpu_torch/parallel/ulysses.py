"""All-to-all sequence parallelism (the DeepSpeed-Ulysses schedule) —
the second of the two long-context strategies beside ring attention.

The port of ``ompi_tpu/parallel/ulysses.py``: two tiled ``alltoall``s
turn a sequence-sharded layout ``(S/P, H, D)`` into a head-sharded one
``(S, H/P, D)``; each rank runs plain full-sequence attention over its
head subset, and the mirror ``alltoall`` turns it back. Head-sharding
needs the head count divisible by the axis size.
"""
from __future__ import annotations

import torch

from ompi_tpu_torch.parallel.ingraph import InGraphComm

_NEG = -1e30


def ulysses_attention(q, k, v, sp: InGraphComm, *, causal: bool = True,
                      scale: float | None = None):
    """Exact full attention with the two-alltoall resharding schedule.

    Args:
      q, k, v: stacked local sequence blocks ``(R, B, S_local, H, D)``;
        the rank at position i of the ``sp`` axis holds global positions
        ``[i*S_local, (i+1)*S_local)``. H must divide by the axis size.
      sp: the sequence-parallel in-graph communicator.
      causal: apply the global causal mask.
    Returns the stacked local output blocks ``(R, B, S_local, H, D)``.
    """
    n = sp.size()
    R, B, S, H, D = q.shape
    if H % n:
        raise ValueError(f"head count {H} not divisible by the sequence "
                         f"axis size {n} (use ring attention)")
    if scale is None:
        scale = D ** -0.5

    def reshard_in(x):
        # (B, S/P, H, D) -> (B, S, H/P, D): scatter heads, gather seq
        return sp.alltoall(x, split_axis=2, concat_axis=1)

    qg = reshard_in(q).float() * scale                    # (R, B, S_g, h, D)
    kg = reshard_in(k).float()
    vg = reshard_in(v).float()
    s = torch.einsum("rbqhd,rbkhd->rbhqk", qg, kg)        # full sequence
    if causal:
        S_g = qg.shape[2]
        tri = torch.tril(torch.ones((S_g, S_g), dtype=torch.bool,
                                    device=q.device))
        s = torch.where(tri, s, _NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("rbhqk,rbkhd->rbqhd", p, vg)         # (R, B, S_g, h, D)
    # (B, S, H/P, D) -> (B, S/P, H, D): the mirror exchange
    return sp.alltoall(o, split_axis=1, concat_axis=2).to(q.dtype)
