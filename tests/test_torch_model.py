"""Parity of the port's flagship forward with the JAX package's.

The JAX package's ``init_params`` makes the params; ``params_from_jax``
carries them (through numpy) into the port, so both forwards see the same
weights and the same token batch (numpy, from a seed). Tolerances: atol
1e-4 on float32 logits (summation order), 2e-2 on the bfloat16 flagship
(bf16 rounds at other places in the two frameworks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ompi_tpu.models import transformer as JT
from ompi_tpu_torch.entry import CONFIG, entry
from ompi_tpu_torch.models import transformer as TT
from ompi_tpu_torch.ops import flash_attention as tfa

SMALL = dict(vocab=32, d_model=32, n_heads=4, n_layers=2, d_ff=64, seq=16)
FLAGSHIP = dict(vocab=256, d_model=128, n_heads=8, n_layers=2, d_ff=512,
                seq=64)


def _both(kw, jdtype, tdtype, use_flash, batch, seed):
    jcfg = JT.Config(**kw, dtype=jdtype, use_flash=use_flash)
    tcfg = TT.Config(**kw, dtype=tdtype, use_flash=use_flash)
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = TT.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    tokens = np.random.default_rng(seed).integers(0, kw["vocab"],
                                                  (batch, kw["seq"]))
    want = np.asarray(JT.forward(jparams, jnp.asarray(tokens, jnp.int32),
                                 jcfg))
    return tcfg, tparams, torch.from_numpy(tokens), want


@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_f32_matches_jax(use_flash):
    cfg, params, tokens, want = _both(SMALL, jnp.float32, torch.float32,
                                      use_flash, batch=2, seed=0)
    with torch.no_grad():
        got = TT.forward(params, tokens, cfg).numpy()
    assert got.shape == want.shape == (2, SMALL["seq"], SMALL["vocab"])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_forward_f32_training_path_matches_jax():
    """With autograd on, flash attention takes the plain fold (the
    training path) — the same function, and gradients flow."""
    cfg, params, tokens, want = _both(SMALL, jnp.float32, torch.float32,
                                      True, batch=2, seed=1)
    model = TT.Transformer(cfg, params)
    got = model(tokens)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=0)
    got.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())


def test_forward_bf16_flagship_matches_jax():
    cfg, params, tokens, want = _both(FLAGSHIP, jnp.bfloat16, torch.bfloat16,
                                      True, batch=2, seed=2)
    with torch.no_grad():
        got = TT.forward(params, tokens, cfg).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_entry_on_cpu_runs_the_flagship():
    fn, (params, tokens) = entry(device="cpu")
    assert tokens.shape == (2, CONFIG.seq) and CONFIG.use_flash
    before = tfa.launches
    with torch.no_grad():
        logits = fn(params, tokens)
    assert logits.shape == (2, CONFIG.seq, CONFIG.vocab)
    assert torch.isfinite(logits).all()
    assert tfa.launches == before      # CPU tensors: the plain fold
