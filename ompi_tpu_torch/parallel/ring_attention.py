"""Ring attention — sequence/context parallelism over a mesh axis.

The port of ``ompi_tpu/parallel/ring_attention.py``. Each sequence-
parallel rank holds one block of Q/K/V; K/V blocks circulate around the
ring (one ``ring_shift`` per step) while a flash-style online softmax
(running max and denominator) accumulates exact results blockwise.

Causality is handled per step from the circulating block's origin
``src``, a per-rank tensor: blocks from later positions are fully masked,
the diagonal block gets the triangular mask, earlier blocks attend fully.
The diagonal block comes first, then n - 1 rotate-then-fold steps.

The fold is the JAX ring's own, written out here, not
``flash_block_update``: the training path needs autograd, and the CUDA
kernel has no backward (in either package). The ring therefore launches
no kernel.
"""
from __future__ import annotations

import torch

from ompi_tpu_torch.parallel.ingraph import InGraphComm

_NEG = -1e30


def ring_attention(q, k, v, sp: InGraphComm, *, causal: bool = True,
                   scale: float | None = None):
    """Blockwise-exact attention with K/V ring rotation.

    Args:
      q, k, v: stacked local blocks ``(R, B, S_local, H, D)``; the rank
        at position i of the ``sp`` axis holds global positions
        ``[i*S_local, (i+1)*S_local)``.
      sp: the sequence-parallel in-graph communicator.
      causal: apply the global causal mask.
    Returns the stacked local output blocks ``(R, B, S_local, H, D)``.
    """
    n = sp.size()
    R, B, S, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    r = sp.rank()
    q32 = q.float() * scale
    tri = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))

    def block(acc, k_cur, v_cur, src):
        """One online-softmax update of the accumulators against the K/V
        blocks whose global origins are ``src`` (one per rank)."""
        o, m, l = acc
        s = torch.einsum("rbqhd,rbkhd->rbhqk", q32, k_cur.float())
        if causal:
            earlier = (src < r)[:, None, None]
            allow = earlier | ((src == r)[:, None, None] & tri)   # (R,S,S)
            s = torch.where(allow[:, None, None], s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))                  # (R,B,H,S)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        o_new = (o * corr[..., None]
                 + torch.einsum("rbhqk,rbkhd->rbhqd", p, v_cur.float()))
        return o_new, m_new, l_new

    acc = block((q32.new_zeros((R, B, H, S, D)),
                 q32.new_full((R, B, H, S), _NEG),
                 q32.new_zeros((R, B, H, S))), k, v, r)
    for t in range(n - 1):
        k = sp.ring_shift(k, 1)
        v = sp.ring_shift(v, 1)
        acc = block(acc, k, v, torch.remainder(r - t - 1, n))
    o, _, l = acc
    l = torch.where(l == 0.0, 1.0, l)        # fully-masked rows (none in
    o = o / l[..., None]                     # a causal ring, but safe)
    return o.transpose(2, 3).to(q.dtype)
