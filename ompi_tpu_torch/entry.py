"""Driver entry point: the flagship forward on the card.

``entry()`` mirrors the JAX package's ``__graft_entry__.entry()``: the
flagship transformer at its full width (vocab 256, d_model 128, 8 heads,
2 layers, d_ff 512, seq 64, bfloat16 activations, flash attention),
random params from seed 0 and a (2, 64) batch of token 0. It returns
``(fn, (params, tokens))``; ``fn(params, tokens)`` gives the logits. Run
it under ``torch.no_grad()`` and attention goes through the CUDA flash
fold kernel.
"""
from __future__ import annotations

import torch

from ompi_tpu_torch.models import transformer as T

CONFIG = T.Config(vocab=256, d_model=128, n_heads=8, n_layers=2,
                  d_ff=512, seq=64, use_flash=True)


def entry(device=None):
    """``device`` defaults to the first CUDA device; pass ``"cpu"`` to run
    on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("entry(): no CUDA device is visible; pass "
                               "device='cpu' to run on the CPU")
        device = torch.device("cuda", 0)
    cfg = CONFIG
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device)
    tokens = torch.zeros((2, cfg.seq), dtype=torch.int64, device=device)

    def fn(params, tokens):
        return T.forward(params, tokens, cfg)

    return fn, (params, tokens)
