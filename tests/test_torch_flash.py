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
    """The port imports (and its CPU fold, a CPU train step and the fp8
    codec run) with jax, ompi_tpu and ml_dtypes made unimportable and no
    CUDA toolkit on PATH: kernels build only when launched."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['ompi_tpu'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch, ompi_tpu_torch, ompi_tpu_torch.parallel\n"
        "import ompi_tpu_torch.compress, ompi_tpu_torch.coll.compressed\n"
        "import ompi_tpu_torch.pml.stacked, ompi_tpu_torch.pml.partitioned\n"
        "import ompi_tpu_torch.core.convertor, ompi_tpu_torch.topo.cart\n"
        "import ompi_tpu_torch.topo.neighbor, ompi_tpu_torch.topo.treematch\n"
        "from ompi_tpu_torch.compress import codecs\n"
        "c = codecs.get_codec('fp8_block')\n"
        "assert c.name == 'fp8_block'\n"
        "q, s = c.encode(torch.ones(300).numpy(), 64)\n"
        "assert (c.decode(q, s, (300,), 'float32', 64) == 1).all()\n"
        "from ompi_tpu_torch import entry\n"
        "from ompi_tpu_torch.models import transformer as T\n"
        "from ompi_tpu_torch.ops import flash_attention as F, _build\n"
        "x = torch.zeros(1, 4, 8)\n"
        "F.flash_block_update(x, x, x, x, torch.zeros(1, 4), "
        "torch.zeros(1, 4), 0)\n"
        "cfg = T.Config(vocab=16, d_model=8, n_heads=2, n_layers=1, d_ff=16,"
        " seq=4, dtype=torch.float32, use_flash=True)\n"
        "p = T.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "tok = torch.randint(0, 16, (2, 5))\n"
        "_, loss = T.sgd_train_step(p, (tok[:, :-1], tok[:, 1:]), cfg, 1e-2)\n"
        "assert torch.isfinite(loss) and F.launches == 0\n"
        "try:\n"
        "    _build.nvcc(); sys.exit('nvcc is reachable')\n"
        "except RuntimeError:\n"
        "    pass\n"
        "assert not {'jax', 'ml_dtypes', 'ompi_tpu'} & {m.split('.')[0] "
        "for m in sys.modules if sys.modules[m] is not None}\n"
        "print('ok')\n")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME=os.path.join(REPO, "no-cuda-here"))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


# -- the exactness claims the CUDA kernel relies on ----------------------
# The kernel's tiles (csrc/flash_fold.cu): 64-row q tiles of four 16-row
# warps, 32-row K/V tiles.
BQ, BW, BK = 64, 16, 32
NEG = -1e30
SKIP_SHAPES = [(3, 100, 260, 40), (2, 128, 256, 64)]


def _jnp(args, mode):
    return [np.asarray(t) for t in jfa._fold_jnp(*args, mode)]


def _rows_fold(q, k, v, o, m, l, row0):
    """The mode-1 fold of a slice of q rows that starts at row ``row0``:
    the causal mask in the rows' own (global) indices."""
    s = torch.einsum("bqd,bkd->bqk", q, k)
    row = row0 + torch.arange(q.shape[1])[:, None]
    col = torch.arange(k.shape[1])[None, :]
    s = torch.where((row >= col)[None], s, NEG)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    return (o * corr[..., None] + torch.einsum("bqk,bkd->bqd", p, v),
            m_new, l * corr + p.sum(-1))


def _mode2_closed_form(v, o, m, l):
    """Mode 2 without q·kᵀ: m' = max(m, -1e30), p = exp(-1e30 - m'),
    l' = l·corr + Sk·p, o' = o·corr + p·Σₖ v[k]."""
    mp = torch.clamp(m, min=NEG)
    p, corr = torch.exp(NEG - mp), torch.exp(m - mp)
    return (o * corr[..., None] + p[..., None] * v.sum(1)[:, None, :], mp,
            l * corr + v.shape[1] * p)


def _kernel_schedule(q, k, v, o, m, l, mode):
    """A plain torch model of the kernel's schedule: per 64-row q tile and
    16-row warp, 32-row K tiles folded online, in mode 1 only up to the
    warp's last live row; each tile's p·v summed from zero and added to
    o; o rescaled where a row's max moved; mode 2 in closed form."""
    if mode == 2:
        return _mode2_closed_form(v, o, m, l)
    Sq, Sk = q.shape[1], k.shape[1]
    o, m, l = o.clone(), m.clone(), l.clone()
    for r0 in range(0, Sq, BW):          # a warp's rows; tiles hold four
        r1 = min(r0 + BW, Sq)
        rows = torch.arange(r0, r1)[:, None]
        kend = min(Sk, r1) if mode == 1 else Sk
        ot, mt, lt = o[:, r0:r1], m[:, r0:r1], l[:, r0:r1]
        for k0 in range(0, kend, BK):
            k1 = min(k0 + BK, Sk)
            s = torch.einsum("bqd,bkd->bqk", q[:, r0:r1], k[:, k0:k1])
            if mode == 1:
                s = torch.where(torch.arange(k0, k1)[None] > rows, NEG, s)
            m_new = torch.maximum(mt, s.amax(-1))
            corr = torch.exp(mt - m_new)
            p = torch.exp(s - m_new[..., None])
            lt = lt * corr + p.sum(-1)
            pv = torch.einsum("bqk,bkd->bqd", p, v[:, k0:k1])
            ot = torch.where((m_new != mt)[..., None], ot * corr[..., None],
                             ot) + pv
            mt = m_new
        o[:, r0:r1], m[:, r0:r1], l[:, r0:r1] = ot, mt, lt
    return o, m, l


@pytest.mark.parametrize("shape", SKIP_SHAPES)
def test_mode1_tile_skip_gives_the_full_fold(shape):
    """Each 64-row q tile folded over only the K columns up to its last
    row gives that tile's rows of the full mode-1 fold."""
    args = _inputs(*shape, seed=sum(shape))
    want = _jnp(args, 1)
    t = [torch.from_numpy(a) for a in args]
    Sq, Sk = shape[1], shape[2]
    for q0 in range(0, Sq, BQ):
        q1 = min(q0 + BQ, Sq)
        kend = min(Sk, q1)
        got = _rows_fold(t[0][:, q0:q1], t[1][:, :kend], t[2][:, :kend],
                         t[3][:, q0:q1], t[4][:, q0:q1], t[5][:, q0:q1], q0)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w[:, q0:q1], **TOL)


@pytest.mark.parametrize("shape", [(4, 64, 64, 16), (3, 100, 260, 40)])
@pytest.mark.parametrize("acc", ["fresh", "after_mode1"])
def test_mode2_closed_form_is_the_fold(shape, acc):
    """On fresh accumulators the closed form gives l == Sk exactly; after
    a mode-1 fold it is the identity, exactly."""
    args = _inputs(*shape, seed=sum(shape) + 1)
    if acc == "after_mode1":
        args = args[:3] + tuple(_jnp(args, 1))
    want = _jnp(args, 2)
    got = [t.numpy() for t in _mode2_closed_form(
        *(torch.tensor(a) for a in args[2:]))]
    _assert_close(got, want)
    if acc == "fresh":
        assert np.all(got[2] == shape[2]) and np.all(want[2] == shape[2])
    else:
        for g, a in zip(got, args[3:]):
            assert np.array_equal(g, a)


@pytest.mark.parametrize("shape", SKIP_SHAPES)
@pytest.mark.parametrize("mode", [0, 1, "0_after_1", "2_after_1"])
def test_kernel_schedule_matches_the_fold(shape, mode):
    args = _inputs(*shape, seed=sum(shape) + 2)
    if isinstance(mode, str):
        args = args[:3] + tuple(_jnp(args, 1))
        mode = int(mode[0])
    got = _kernel_schedule(*(torch.tensor(a) for a in args), mode)
    _assert_close([t.numpy() for t in got], _jnp(args, mode))


@pytest.mark.parametrize("shape", [(3, 100, 260, 40), (2, 128, 256, 64),
                                   (2, 300, 20, 8)])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_fold_work_counts_what_the_mask_allows(shape, mode):
    """fold_work's flops and bytes against the mask's own count of allowed
    scores and of k/v rows some row can attend; in mode 2, v of the heads
    with a fresh row only."""
    BH, Sq, Sk, D = shape
    row, col = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    allow = {0: np.ones((Sq, Sk), bool), 1: row >= col,
             2: np.zeros((Sq, Sk), bool)}[mode]
    m = np.random.default_rng(0).standard_normal((BH, Sq))
    m[0, Sq // 2] = NEG                 # one head holds a fresh row
    fresh = int((m == NEG).any(axis=1).sum())
    flops, nbytes = tfa.fold_work(BH, Sq, Sk, D, mode, fresh_heads=fresh)
    assert flops == 4 * D * BH * int(allow.sum())
    want = BH * (2 * Sq * D + 4 * Sq)   # o, m, l in and out
    if mode == 2:
        want += fresh * Sk * D          # v's column sum
    else:
        want += BH * (Sq * D + 2 * int(allow.any(axis=0).sum()) * D)
    assert nbytes == 4 * want
