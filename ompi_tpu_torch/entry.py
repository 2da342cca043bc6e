"""Driver entry points, on the card unless the caller asks for the CPU.

``entry()``               — the flagship forward, as the JAX package's
                            ``__graft_entry__.entry()``: the flagship at
                            its full width (vocab 256, d_model 128, 8
                            heads, 2 layers, d_ff 512, seq 64, bfloat16
                            activations, flash attention), random params
                            from seed 0 and a (2, 64) batch of token 0.
                            It returns ``(fn, (params, tokens))``; under
                            ``torch.no_grad()`` attention goes through
                            the CUDA flash-fold kernel.
``dryrun_multichip(n)``   — ONE combined train step of the flagship over
                            a (pp, dp, tp, sp) rank mesh of n ranks on
                            one device: GPipe microbatch pipelining,
                            Megatron tp, ring attention over sp, Switch
                            MoE with experts on tp, gradients synced over
                            dp — then the dp=2 factorization on the same
                            batch, which must match, and a Ulysses check.

Both take ``device``: the first CUDA device by default (they raise
without one); ``"cpu"`` runs them on the CPU.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ompi_tpu_torch.models import transformer as T
from ompi_tpu_torch.parallel import InGraphComm, Mesh, P
from ompi_tpu_torch.parallel.mesh import tree_map
from ompi_tpu_torch.parallel.ulysses import ulysses_attention

CONFIG = T.Config(vocab=256, d_model=128, n_heads=8, n_layers=2,
                  d_ff=512, seq=64, use_flash=True)
# the JAX dryrun's model; moe_experts follows the tp axis
DRYRUN_CONFIG = T.Config(vocab=64, d_model=32, n_heads=4, n_layers=2,
                         d_ff=64, seq=16, dtype=torch.float32, moe=True,
                         use_flash=True)


def _device(device, who: str) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}: no CUDA device is visible; pass "
                               f"device='cpu' to run on the CPU")
        return torch.device("cuda", 0)
    return torch.device(device)


def entry(device=None):
    device = _device(device, "entry()")
    cfg = CONFIG
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device)
    tokens = torch.zeros((2, cfg.seq), dtype=torch.int64, device=device)

    def fn(params, tokens):
        return T.forward(params, tokens, cfg)

    return fn, (params, tokens)


def _param_specs(params):
    """Specs for the non-pipelined layout (``sgd_train_step``):
    replicated leaves ``P()``; tp leaves split on their head/hidden axis
    over the 'tp' mesh axis."""
    tp_layer_spec = {"wqkv": P(None, None, "tp", None),
                     "wo": P("tp", None, None),
                     "w1": P(None, "tp"),
                     "w2": P("tp", None)}
    return {"rep": tree_map(lambda _: P(), params["rep"]),
            "tp": {"layers": [dict(tp_layer_spec)
                              for _ in params["tp"]["layers"]]}}


def _stage_specs(params, cfg: T.Config):
    """Specs for the flagship layout: rep replicated; stage leaves lead
    with 'pp' and split on their head/hidden (or expert) axis over
    'tp'."""
    per_leaf = {"ln1": P("pp"), "ln2": P("pp"),
                "wqkv": P("pp", None, None, "tp", None),
                "wo": P("pp", "tp", None, None)}
    if cfg.moe:
        per_leaf.update({"gate": P("pp"),              # replicated experts
                         "w1": P("pp", "tp", None, None),  # one per tp rank
                         "w2": P("pp", "tp", None, None)})
    else:
        per_leaf.update({"w1": P("pp", None, "tp"), "w2": P("pp", "tp", None)})
    return {"rep": tree_map(lambda _: P(), params["rep"]),
            "stage": [dict(per_leaf) for _ in params["stage"]]}


def flagship_step(pp: int, dp: int, tp: int, sp: int, tokens_np, *,
                  cfg: T.Config | None = None, params=None, device=None):
    """The combined train step on a (pp, dp, tp, sp) mesh, set up:
    ``(mesh, specs, stacked params, step)``, where ``step(params)``
    returns ``(params, stacked loss)``. ``params`` (global, in the
    ``init_pp_params`` layout, tensors or numpy) default to
    ``init_pp_params`` from seed 0; ``cfg`` to the JAX dryrun's model
    with ``moe_experts = tp``."""
    device = _device(device, "flagship_step()")
    cfg = cfg or dataclasses.replace(DRYRUN_CONFIG, moe_experts=tp)
    mesh = Mesh((pp, dp, tp, sp), ("pp", "dp", "tp", "sp"), device)
    if params is None:
        params = T.init_pp_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu", pp)
    specs = _stage_specs(params, cfg)
    tokens = torch.as_tensor(np.asarray(tokens_np, np.int64))
    seq = P("dp", "sp")
    batch = (mesh.shard(tokens[:, :-1], seq), mesh.shard(tokens[:, 1:], seq))
    pp_c, dp_c, tp_c = (InGraphComm(a, n, mesh) for a, n in
                        (("pp", pp), ("dp", dp), ("tp", tp)))
    sp_c = InGraphComm("sp", sp, mesh) if sp > 1 else None

    def step(p):
        return T.pp_train_step(p, batch, cfg, 1e-2, pp_comm=pp_c, n_micro=2,
                               dp_comm=dp_c, tp_comm=tp_c, sp_comm=sp_c,
                               ep_comm=tp_c)

    return mesh, specs, mesh.shard(params, specs), step


def _run_flagship(pp: int, dp: int, tp: int, sp: int, tokens_np, *,
                  cfg: T.Config | None = None, params=None,
                  device=None) -> tuple:
    """Two combined train steps (``flagship_step``); returns (loss_step1,
    loss_step2) as floats, comparable across factorizations that share
    ``tokens_np``. Raises where replicated params or losses disagree
    across ranks, or a loss is not finite."""
    mesh, specs, p, step = flagship_step(pp, dp, tp, sp, tokens_np, cfg=cfg,
                                         params=params, device=device)
    p, loss1 = step(p)
    p, loss2 = step(p)
    mesh.unshard(p, specs)
    l1, l2 = (float(mesh.unshard(x, P())) for x in (loss1, loss2))
    if not (math.isfinite(l1) and math.isfinite(l2)):
        raise RuntimeError(f"flagship losses not finite: {l1}, {l2}")
    return l1, l2


def dryrun_multichip(n_devices: int = 8, device=None) -> dict:
    """The JAX dryrun's factorization and checks on ``n_devices`` ranks
    of one device. Returns the losses (``dp1``, and ``dp2`` at 8 ranks or
    more) and the Ulysses max abs error (``ulysses_err``)."""
    device = _device(device, "dryrun_multichip()")
    # pipeline and tensor axes first, then the sequence ring, then data
    # parallel with whatever remains
    pp = 2 if n_devices % 2 == 0 else 1
    tp = 2 if (n_devices // pp) % 2 == 0 else 1
    sp = 2 if (n_devices // (pp * tp)) % 2 == 0 else 1
    dp = n_devices // (pp * tp * sp)
    # one batch for every factorization below: it splits over dp replicas
    # x 2 microbatches for each run (and the dp=2 comparison)
    batch = 2 * math.lcm(2 * dp, 4)
    cfg = DRYRUN_CONFIG
    tokens_np = np.random.default_rng(0).integers(0, cfg.vocab,
                                                  (batch, cfg.seq + 1))
    out = {"dp1": _run_flagship(pp, dp, tp, sp, tokens_np, device=device)}
    l1a, l2a = out["dp1"]
    print(f"dryrun_multichip ok: ONE combined train step on mesh pp={pp} x "
          f"dp={dp} x tp={tp} x sp={sp} on {device} — GPipe microbatch "
          f"pipeline + Megatron tp + "
          f"{'ring attention' if sp > 1 else 'flash attention'} + Switch "
          f"MoE (experts on tp), 2 steps, loss={l2a:.4f}", flush=True)
    if n_devices >= 8:
        # a REAL data-parallel axis on the same total batch must match
        l1b, l2b = out["dp2"] = _run_flagship(2, 2, 2, 1, tokens_np,
                                              device=device)
        if not np.allclose(l1a, l1b, rtol=1e-4, atol=1e-5):
            raise RuntimeError(f"dp=2 step-1 loss {l1b} != dp=1 {l1a}")
        if not np.allclose(l2a, l2b, rtol=2e-3, atol=1e-4):
            raise RuntimeError(f"dp=2 step-2 loss {l2b} != dp=1 {l2a}")
        print(f"dryrun dp=2 ok: pp=2 x dp=2 x tp=2 x sp=1 on the same total "
              f"batch matches dp=1 (step1 {l1b:.5f}~{l1a:.5f}, step2 "
              f"{l2b:.5f}~{l2a:.5f})", flush=True)
    out["ulysses_err"] = _dryrun_ulysses(n_devices, device)
    return out


def _dense_causal(q, k, v):
    """Plain causal softmax attention on global (B, S, H, D) tensors."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    S = q.shape[1]
    s = torch.where(torch.tril(torch.ones((S, S), dtype=torch.bool,
                                          device=q.device)), s, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def _dryrun_ulysses(n_devices: int, device) -> float:
    """The alternative sequence-parallel mode (all-to-all head
    resharding) beside the flagship's ring attention, held against dense
    causal attention (rtol 2e-4, atol 2e-5); returns the max abs error."""
    sp_n = min(4, n_devices)
    mesh = Mesh((sp_n,), ("sp",), device)
    spc = InGraphComm("sp", sp_n, mesh)
    B, S, H, D = 2, 4 * sp_n, sp_n, 8
    qkv = [torch.from_numpy(np.random.default_rng(3 + i).standard_normal(
        (B, S, H, D)).astype(np.float32)).to(device) for i in range(3)]
    spec = P(None, "sp")
    out = mesh.unshard(ulysses_attention(
        *(mesh.shard(x, spec) for x in qkv), spc), spec)
    want = _dense_causal(*qkv)
    err = (out - want).abs().max().item()
    if out.shape != (B, S, H, D) or not torch.allclose(
            out, want, rtol=2e-4, atol=2e-5):
        raise RuntimeError(f"ulysses sp={sp_n}: {tuple(out.shape)}, max abs "
                           f"err {err:.3g} against dense attention")
    print(f"dryrun sp={sp_n} ulysses a2a-attention ok (max abs err "
          f"{err:.3g} against dense causal attention)", flush=True)
    return err
