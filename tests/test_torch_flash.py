"""Parity of the port's flash-attention fold with the JAX package's.

The same inputs, made with numpy from a seed, go through
``ompi_tpu.ops.flash_attention`` (the Pallas kernel in interpret mode on
the CPU, or the jnp fold) and through ``ompi_tpu_torch.ops
.flash_attention`` on CPU tensors (its plain torch fold — the CUDA
kernel runs only on the card, where ``chip_smoke.py`` holds it against
the same fold).

Tolerance: atol = rtol = 1e-5 on o, m and l — both sides compute in
float32, in different summation orders.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ompi_tpu.ops import flash_attention as jfa
from ompi_tpu_torch.ops import flash_attention as tfa

TOL = dict(atol=1e-5, rtol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(BH, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((BH, Sq, D)) * D ** -0.5).astype(np.float32)
    k = rng.standard_normal((BH, Sk, D)).astype(np.float32)
    v = rng.standard_normal((BH, Sk, D)).astype(np.float32)
    o = np.zeros((BH, Sq, D), np.float32)
    m = np.full((BH, Sq), -1e30, np.float32)
    l = np.zeros((BH, Sq), np.float32)
    return q, k, v, o, m, l


def _port(args, mode):
    out = tfa.flash_block_update(*(torch.tensor(a) for a in args), mode)
    return [t.numpy() for t in out]


def _jax_pallas(args, mode):
    out = jfa.flash_block_update(*args, mode, use_pallas=True)
    return [np.asarray(t) for t in out]


def _assert_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("shape", [(4, 64, 64, 16), (2, 128, 256, 64)])
@pytest.mark.parametrize("mode", [0, 1, "2_after_1"])
def test_fold_matches_pallas_interpret(shape, mode):
    assert jfa.pallas_available()      # the JAX side really is the kernel
    args = _inputs(*shape, seed=sum(shape))
    if mode == "2_after_1":
        acc = _jax_pallas(args, 1)
        args = args[:3] + tuple(acc)
        mode = 2
    _assert_close(_port(args, mode), _jax_pallas(args, mode))


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_fold_matches_jnp_ragged(mode):
    args = _inputs(3, 100, 260, 40, seed=7)
    want = [np.asarray(t) for t in jfa._fold_jnp(*args, mode)]
    _assert_close(_port(args, mode), want)


def test_mode2_fresh_accumulators_give_sk():
    """Mode 2 on fresh accumulators is not the identity: every masked
    column adds exp(-1e30 - (-1e30)) = 1 to l, in both packages."""
    args = _inputs(4, 64, 64, 16, seed=3)
    _, _, l_port = _port(args, 2)
    _, _, l_jax = _jax_pallas(args, 2)
    assert np.all(l_port == 64.0)
    assert np.all(l_jax == 64.0)


def test_cpu_tensors_take_the_plain_fold_without_a_launch():
    args = [torch.from_numpy(a) for a in _inputs(2, 16, 16, 8, seed=1)]
    before = tfa.launches
    got = tfa.flash_block_update(*args, 1)
    want = tfa._fold_torch(*args, 1)
    assert tfa.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_import_needs_no_nvcc_and_no_jax():
    """The port imports (and its CPU fold runs) with jax made
    unimportable and no CUDA toolkit on PATH: kernels build only when
    launched."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['ompi_tpu'] = None\n"
        "import torch, ompi_tpu_torch\n"
        "from ompi_tpu_torch.ops import flash_attention as F, _build\n"
        "x = torch.zeros(1, 4, 8)\n"
        "F.flash_block_update(x, x, x, x, torch.zeros(1, 4), "
        "torch.zeros(1, 4), 0)\n"
        "try:\n"
        "    _build.nvcc(); sys.exit('nvcc is reachable')\n"
        "except RuntimeError:\n"
        "    pass\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules "
        "if sys.modules[m] is not None]\n"
        "print('ok')\n")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME=os.path.join(REPO, "no-cuda-here"))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
