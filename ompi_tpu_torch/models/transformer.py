"""The flagship causal transformer LM — the single-device forward.

The port of ``ompi_tpu/models/transformer.py``'s forward: embedding,
``n_layers`` blocks of (rmsnorm, attention, residual, rmsnorm, dense
GELU MLP, residual), final rmsnorm and logits against the tied embedding.
Activations are ``cfg.dtype`` (bfloat16 by default), params float32.

Attention with ``cfg.use_flash`` goes through ``ops/flash_attention``: one
fold with mode 1 (the causal diagonal). With autograd off (inference, as
in ``entry()``) that is the hand-written CUDA kernel on the card; with
autograd on (training) it is the plain torch fold, as the JAX package
trains through its jnp fold. The function computed is the same either
way.

Numerics follow the JAX package: GELU is the tanh approximation
(``jax.nn.gelu``'s default), rmsnorm runs in float32 with eps 1e-6 inside
the rsqrt, and logits are a float32 product against ``emb``.

The parameter tree keeps the JAX layout —
``{"rep": {"emb", "ln_f", "layers": [{"ln1", "ln2"}]},
"tp": {"layers": [{"wqkv", "wo", "w1", "w2"}]}}`` — so JAX params convert
with one tree map (``params_from_jax``). MoE, the tp/sp/ep comms, the
loss and the train steps wait for a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ompi_tpu_torch.ops.flash_attention import _fold_torch, flash_block_update


@dataclass(frozen=True)
class Config:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 512
    seq: int = 64
    dtype: torch.dtype = torch.bfloat16
    use_flash: bool = False      # local attention via ops/flash

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


def init_params(cfg: Config, generator: torch.Generator,
                device) -> Dict:
    """Random params in the JAX layout: normal draws from ``generator``
    (a CPU generator, so a seed gives the same params on every device),
    scaled as the JAX package scales them, then moved to ``device``."""
    d, dh, h = cfg.d_model, cfg.d_head, cfg.n_heads

    def normal(*shape, scale):
        return (torch.randn(shape, generator=generator, dtype=torch.float32)
                * scale).to(device)

    ones = lambda: torch.ones(d, dtype=torch.float32, device=device)  # noqa: E731
    rep = {"emb": normal(cfg.vocab, d, scale=0.02), "ln_f": ones(),
           "layers": [{"ln1": ones(), "ln2": ones()}
                      for _ in range(cfg.n_layers)]}
    tp_layers = [{"wqkv": normal(d, 3, h, dh, scale=d ** -0.5),
                  "wo": normal(h, dh, d, scale=(h * dh) ** -0.5),
                  "w1": normal(d, cfg.d_ff, scale=d ** -0.5),
                  "w2": normal(cfg.d_ff, d, scale=cfg.d_ff ** -0.5)}
                 for _ in range(cfg.n_layers)]
    return {"rep": rep, "tp": {"layers": tp_layers}}


def params_from_jax(tree: Any, device="cpu") -> Any:
    """Convert a JAX-layout param tree whose leaves are numpy arrays (or
    anything ``np.asarray`` takes) into the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return torch.tensor(np.asarray(tree), device=device)


def _rmsnorm(x, g):
    x32 = x.float()
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + 1e-6)
    return (x32 * r * g).to(x.dtype)


def _flash_causal(q, k, v, cfg: Config):
    """Single-block causal attention through the flash fold: mode 1 is
    exactly the causal diagonal block."""
    B, S, H, D = q.shape
    scale = torch.tensor(cfg.d_head, dtype=torch.float32) ** -0.5

    def heads(t):
        return t.permute(0, 2, 1, 3).reshape(B * H, S, D).float()

    qf = heads(q) * scale.to(q.device)
    kf, vf = heads(k), heads(v)
    o = torch.zeros_like(qf)
    m = torch.full((B * H, S), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B * H, S), dtype=torch.float32, device=q.device)
    # the TRAINING path needs autograd: the plain fold is the same math,
    # differentiable; the kernel (no backward yet) serves forward-only use
    fold = _fold_torch if torch.is_grad_enabled() else flash_block_update
    o, m, l = fold(qf, kf, vf, o, m, l, 1)
    o = o / torch.where(l == 0.0, 1.0, l)[..., None]
    return o.reshape(B, H, S, D).permute(0, 2, 1, 3).to(q.dtype)


def _attend(q, k, v, causal, cfg: Config):
    """Flash fold or dense softmax, locally."""
    if cfg.use_flash:
        return _flash_causal(q, k, v, cfg)
    att = torch.einsum("bshk,bthk->bhst", q, k) / torch.sqrt(
        torch.tensor(cfg.d_head, dtype=cfg.dtype, device=q.device))
    att = torch.where(causal[None, None], att, -1e9)
    att = torch.softmax(att.float(), dim=-1).to(cfg.dtype)
    return torch.einsum("bhst,bthk->bshk", att, v)


def _mlp(x, lt: Dict, cfg: Config):
    """The dense feed-forward pair; ``x`` is the ln2-normalized input."""
    m = F.gelu(torch.einsum("bsd,df->bsf", x, lt["w1"].to(cfg.dtype)),
               approximate="tanh")
    return torch.einsum("bsf,fd->bsd", m, lt["w2"].to(cfg.dtype))


def _layer(x, lr: Dict, lt: Dict, causal, cfg: Config):
    """One transformer block (attention + MLP with residuals)."""
    h = _rmsnorm(x, lr["ln1"])
    qkv = torch.einsum("bsd,dchk->bcshk", h,
                       lt["wqkv"].to(cfg.dtype))          # (B,3,S,H,dh)
    o = _attend(qkv[:, 0], qkv[:, 1], qkv[:, 2], causal, cfg)
    o = torch.einsum("bshk,hkd->bsd", o, lt["wo"].to(cfg.dtype))
    x = x + o
    h = _rmsnorm(x, lr["ln2"])
    return x + _mlp(h, lt, cfg)


def forward(params: Dict, tokens: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Causal LM forward: tokens (B, S) int -> float32 logits
    (B, S, vocab)."""
    rep, tpp = params["rep"], params["tp"]
    x = rep["emb"][tokens].to(cfg.dtype)                  # (B, S, D)
    S = x.shape[1]
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                   device=x.device))
    for li in range(cfg.n_layers):
        x = _layer(x, rep["layers"][li], tpp["layers"][li], causal, cfg)
    x = _rmsnorm(x, rep["ln_f"])
    return torch.einsum("bsd,vd->bsv", x.float(), rep["emb"])


class Transformer(nn.Module):
    """``forward`` as an ``nn.Module``: the param tree's leaves become
    registered parameters (``parameters()``, ``.to()``, ``state_dict()``
    work), and ``self(tokens)`` runs the functional forward on them."""

    def __init__(self, cfg: Config, params: Dict):
        super().__init__()
        self.cfg = cfg
        P = nn.Parameter
        rep, tpl = params["rep"], params["tp"]["layers"]
        self.emb = P(rep["emb"])
        self.ln_f = P(rep["ln_f"])
        self.layers = nn.ModuleList()
        for lr, lt in zip(rep["layers"], tpl):
            blk = nn.Module()
            for name, t in {**lr, **lt}.items():
                blk.register_parameter(name, P(t))
            self.layers.append(blk)

    def params(self) -> Dict:
        """The parameters as a JAX-layout tree (the live tensors)."""
        rep = {"emb": self.emb, "ln_f": self.ln_f,
               "layers": [{"ln1": b.ln1, "ln2": b.ln2} for b in self.layers]}
        tp = {"layers": [{"wqkv": b.wqkv, "wo": b.wo, "w1": b.w1,
                          "w2": b.w2} for b in self.layers]}
        return {"rep": rep, "tp": tp}

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.params(), tokens, self.cfg)
