"""Parity of the port's in-graph tier (``ompi_tpu_torch.parallel``) with
the JAX package's ``ompi_tpu.parallel``.

The same numpy inputs, made from a seed, go through a ``shard_map`` body
on the conftest's 8 CPU devices and through the port's stacked form on
the CPU: one tensor whose leading dim holds every rank of a ``Mesh``, in
the mesh's row-major order (the order of the JAX mesh's devices). JAX's
per-rank outputs, concatenated over the mesh, are reshaped to the same
``(R, *local)`` layout. Gradients: JAX's per-rank ``jax.grad`` against
torch autograd of the sum of the per-rank losses.

Tolerances: rtol = atol = 1e-6 for the collectives (float32 sums over at
most 8 ranks, in other orders); rtol 2e-4 / atol 2e-5 for attention, as
``tests/test_parallel.py`` holds the JAX ring; 1e-5 for the pipeline and
MoE outputs and gradients.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as JP

from ompi_tpu.core import op as jop
from ompi_tpu.parallel import InGraphComm as JComm
from ompi_tpu.parallel.moe import init_moe_params as j_init_moe
from ompi_tpu.parallel.moe import moe_apply as j_moe
from ompi_tpu.parallel.pipeline import pipeline_apply as j_pipeline
from ompi_tpu.parallel.ring_attention import ring_attention as j_ring
from ompi_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from ompi_tpu_torch.core import op as top
from ompi_tpu_torch.parallel import InGraphComm, Mesh, P
from ompi_tpu_torch.parallel.moe import init_moe_params, moe_apply
from ompi_tpu_torch.parallel.pipeline import pipeline_apply
from ompi_tpu_torch.parallel.ring_attention import ring_attention
from ompi_tpu_torch.parallel.ulysses import ulysses_attention

COLL_TOL = dict(rtol=1e-6, atol=1e-6)
ATT_TOL = dict(rtol=2e-4, atol=2e-5)
TOL = dict(rtol=1e-5, atol=1e-5)


def _smap(fn, mesh, in_specs, out_specs):
    try:
        return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)
    except TypeError:                                   # older shard_map kw
        return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_rep=False)


def _meshes(shape, names, device="cpu"):
    n = int(np.prod(shape))
    jm = JMesh(np.array(jax.devices()[:n]).reshape(shape), names)
    return jm, Mesh(shape, names, device)


def _stacked_jax(fn, jmesh, *stacked, n_out=1):
    """Run ``fn`` per rank on the rows of ``stacked`` (numpy (R, ...)
    arrays); returns its output (or ``n_out`` outputs) as (R, *local)
    numpy arrays."""
    axes = JP(tuple(jmesh.axis_names))
    R = stacked[0].shape[0]

    def body(*xs):
        out = fn(*(x[0] for x in xs))
        return jax.tree_util.tree_map(lambda y: jnp.asarray(y)[None], out)

    out_specs = axes if n_out == 1 else (axes,) * n_out
    res = jax.jit(_smap(body, jmesh, (axes,) * len(stacked), out_specs))(
        *stacked)
    return jax.tree_util.tree_map(
        lambda y: np.asarray(y).reshape(R, *np.shape(y)[1:]), res)


# -- the mesh: shard/unshard against NamedSharding + shard_map ----------------
SPECS = [(), (("a", "c"), None, "b"), ("b", None, "a"), (None, "c")]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_shard_matches_shard_map_and_unshard_inverts_it(spec):
    jm, mesh = _meshes((2, 2, 2), ("a", "b", "c"))
    x = np.random.default_rng(0).standard_normal((8, 6, 4)).astype(
        np.float32)
    axes = JP(("a", "b", "c"))
    want = jax.jit(_smap(lambda a: a[None], jm, JP(*spec), axes))(x)
    got = mesh.shard(x, P(*spec))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(want).reshape(got.shape))
    np.testing.assert_array_equal(mesh.unshard(got, P(*spec)).numpy(), x)


def test_unshard_raises_where_replicas_disagree():
    mesh = Mesh((2, 2), ("dp", "tp"), "cpu")
    tree = {"w": np.arange(12.0, dtype=np.float32).reshape(4, 3),
            "b": np.ones(3, np.float32)}
    specs = {"w": P("tp"), "b": P()}
    st = mesh.shard(tree, specs)
    assert st["w"].shape == (4, 2, 3) and st["b"].shape == (4, 3)
    assert mesh.divergence(st, specs) == 0.0
    back = mesh.unshard(st, specs)
    np.testing.assert_array_equal(back["w"].numpy(), tree["w"])
    st["b"] = st["b"].clone()
    st["b"][3, 0] += 1e-3                     # rank (1, 1) drifts
    assert mesh.divergence(st, specs) == pytest.approx(1e-3, rel=1e-3)
    with pytest.raises(ValueError, match="replicated copies"):
        mesh.unshard(st, specs)
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard(np.zeros((3, 2)), P("tp"))


# -- every InGraphComm method -------------------------------------------------
# (name, body(comm, x, n) for both packages, with the package's op module)
def _methods(ops):
    perm = lambda n: [(i, (3 * i + 1) % n) for i in range(1, n)]  # noqa: E731
    return {
        "rank": lambda c, x, n: c.rank(),
        "allreduce_sum": lambda c, x, n: c.allreduce(x, ops.SUM),
        "allreduce_max": lambda c, x, n: c.allreduce(x, ops.MAX),
        "allreduce_min": lambda c, x, n: c.allreduce(x, ops.MIN),
        "allreduce_prod": lambda c, x, n: c.allreduce(x, ops.PROD),
        "pmean": lambda c, x, n: c.pmean(x),
        "reduce": lambda c, x, n: c.reduce(x, ops.SUM, root=1),
        "bcast": lambda c, x, n: c.bcast(x, root=1),
        "allgather": lambda c, x, n: c.allgather(x),
        "allgather_tiled_1": lambda c, x, n: c.allgather(x, axis=1,
                                                         tiled=True),
        "reduce_scatter_sum": lambda c, x, n: c.reduce_scatter(x, ops.SUM),
        "reduce_scatter_max_1": lambda c, x, n: c.reduce_scatter(
            x, ops.MAX, scatter_axis=1),
        "alltoall": lambda c, x, n: c.alltoall(x),
        "alltoall_1_0": lambda c, x, n: c.alltoall(x, split_axis=1,
                                                   concat_axis=0),
        "alltoall_0_1": lambda c, x, n: c.alltoall(x, split_axis=0,
                                                   concat_axis=1),
        "ppermute": lambda c, x, n: c.ppermute(x, perm(n)),
        "ring_shift": lambda c, x, n: c.ring_shift(x, 1),
        "ring_shift_3": lambda c, x, n: c.ring_shift(x, 3),
        "sendrecv": lambda c, x, n: c.sendrecv(x, dest=1, source=0),
        "copy_in": lambda c, x, n: c.copy_in(x),
        "reduce_out": lambda c, x, n: c.reduce_out(x),
        "scan_sum": lambda c, x, n: c.scan(x, ops.SUM),
        "scan_max": lambda c, x, n: c.scan(x, ops.MAX),
    }


MESHES = {"1d": ((8,), ("x",), "x"), "2x2x2": ((2, 2, 2), ("a", "b", "c"),
                                               "b")}


@pytest.mark.parametrize("method", list(_methods(top)))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_ingraph_method_matches_jax(mesh_name, method):
    shape, names, axis = MESHES[mesh_name]
    jm, mesh = _meshes(shape, names)
    n = shape[names.index(axis)]
    R = mesh.size
    seed = zlib.crc32(f"{mesh_name}|{method}".encode())
    x = np.random.default_rng(seed).uniform(0.5, 1.5, (R, 8, 16)).astype(
        np.float32)
    jc, tc = JComm(axis, n), InGraphComm(axis, n, mesh)
    jfn, tfn = _methods(jop)[method], _methods(top)[method]
    want = _stacked_jax(lambda a: jfn(jc, a, n), jm, x)
    got = tfn(tc, torch.from_numpy(x), n).numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype or method == "rank"
    np.testing.assert_allclose(got, want, **COLL_TOL)


def test_size_and_mesh_checks():
    mesh = Mesh((2, 4), ("dp", "tp"), "cpu")
    assert InGraphComm("tp", 4, mesh).size() == 4
    with pytest.raises(ValueError, match="size 4"):
        InGraphComm("tp", 2, mesh)
    with pytest.raises(ValueError, match="not an axis"):
        InGraphComm("sp", 2, mesh)
    with pytest.raises(ValueError, match="8 rows"):
        InGraphComm("tp", 4, mesh).allreduce(torch.zeros(4, 3))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_megatron_f_g_gradients_match_jax(mesh_name):
    """copy_in (f) -> ring_shift -> tiled alltoall -> where(rank == n-1)
    -> reduce_out (g): JAX's per-rank grads against torch autograd of
    the stacked sum."""
    shape, names, axis = MESHES[mesh_name]
    jm, mesh = _meshes(shape, names)
    n = shape[names.index(axis)]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((mesh.size, 4, 8)).astype(np.float32)
    w = rng.standard_normal((mesh.size, 4, 8)).astype(np.float32)

    def chain(c, xx, ww, where, tanh):
        h = c.ring_shift(c.copy_in(xx) * ww, 1)
        h = c.alltoall(h, split_axis=1, concat_axis=1)
        r = c.rank() if where is jnp.where else c.rank().view(-1, 1, 1)
        h = where(r == n - 1, h * 2.0, tanh(h))
        return c.reduce_out(h)

    jc = JComm(axis, n)

    def jloss(xx, ww):
        return jnp.sum(chain(jc, xx, ww, jnp.where, jnp.tanh) ** 2)

    want = _stacked_jax(lambda a, b: (jloss(a, b),) + jax.grad(
        jloss, argnums=(0, 1))(a, b), jm, x, w, n_out=3)
    tc = InGraphComm(axis, n, mesh)
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    loss = (chain(tc, tx, tw, torch.where, torch.tanh) ** 2).sum(dim=(1, 2))
    loss.sum().backward()
    for got, w_ in zip((loss.detach(), tx.grad, tw.grad), want):
        np.testing.assert_allclose(got.numpy(), w_, **TOL)


# -- attention ----------------------------------------------------------------
def _qkv(B, S, H, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(3)]


def _dense(q, k, v, causal=True):
    q, k, v = (torch.from_numpy(a).double() for a in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    if causal:
        S = q.shape[1]
        s = torch.where(torch.tril(torch.ones(S, S, dtype=torch.bool)), s,
                        -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def _sp_run(jfn, tfn, qkv, n, **kw):
    """(JAX, port) outputs of one sequence-parallel attention on global
    (B, S, H, D) inputs over an sp axis of n ranks."""
    jm, mesh = _meshes((n,), ("sp",))
    spec = JP(None, "sp")
    want = jax.jit(_smap(lambda a, b, d: jfn(a, b, d, JComm("sp", n), **kw),
                         jm, (spec,) * 3, spec))(*qkv)
    tc = InGraphComm("sp", n, mesh)
    got = mesh.unshard(tfn(*(mesh.shard(a, P(None, "sp")) for a in qkv),
                           tc, **kw), P(None, "sp"))
    return np.asarray(want), got


def test_ring_attention_matches_jax_full_attention_and_its_gradient():
    B, S, H, D, n = 2, 16, 2, 8, 4
    qkv = _qkv(B, S, H, D, seed=11)
    want, got = _sp_run(j_ring, ring_attention, qkv, n)
    np.testing.assert_allclose(got.numpy(), want, **ATT_TOL)
    np.testing.assert_allclose(got.numpy(), _dense(*qkv).numpy(), **ATT_TOL)
    # the training path: gradients through the ring's shifts and masks
    mesh = Mesh((n,), ("sp",), "cpu")
    ts = [mesh.shard(a, P(None, "sp")).requires_grad_(True) for a in qkv]
    out = ring_attention(*ts, InGraphComm("sp", n, mesh))
    out.pow(2).sum().backward()
    ds = [torch.from_numpy(a).double().requires_grad_(True) for a in qkv]
    q, k, v = ds
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / D ** 0.5
    s = torch.where(torch.tril(torch.ones(S, S, dtype=torch.bool)), s, -1e30)
    torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v).pow(
        2).sum().backward()
    for t, d in zip(ts, ds):
        np.testing.assert_allclose(mesh.unshard(t.grad, P(None, "sp")),
                                   d.grad.numpy(), **ATT_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_jax_and_full_attention(causal):
    B, S, H, D, n = 2, 16, 4, 8, 4
    qkv = _qkv(B, S, H, D, seed=12)
    want, got = _sp_run(j_ulysses, ulysses_attention, qkv, n, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **ATT_TOL)
    np.testing.assert_allclose(got.numpy(), _dense(*qkv, causal).numpy(),
                               **ATT_TOL)


def test_ulysses_head_guard():
    mesh = Mesh((4,), ("sp",), "cpu")
    z = torch.zeros(4, 1, 2, 3, 4)                 # H=3 over 4 ranks
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(z, z, z, InGraphComm("sp", 4, mesh))


# -- GPipe --------------------------------------------------------------------
def test_pipeline_pp4_matches_jax_outputs_and_gradients():
    n, n_micro, Bm, D = 4, 3, 2, 8
    rng = np.random.default_rng(7)
    W = (rng.standard_normal((n, D, D)) * D ** -0.5).astype(np.float32)
    b = rng.standard_normal((n, D)).astype(np.float32)
    x = rng.standard_normal((n_micro, Bm, D)).astype(np.float32)
    jm, mesh = _meshes((n,), ("pp",))
    jc = JComm("pp", n)

    def jloss(W_, b_, x_):
        out = j_pipeline(lambda p, a: jnp.tanh(a @ p[0][0] + p[1][0]),
                         (W_, b_), x_, jc)
        return out, jnp.sum(out ** 2)

    def jbody(W_, b_, x_):
        out, _ = jloss(W_, b_, x_)
        gW, gb = jax.grad(lambda w, bb: jloss(w, bb, x_)[1],
                          argnums=(0, 1))(W_, b_)
        return out[None], gW, gb

    spec = JP("pp")
    want = jax.jit(_smap(jbody, jm, (spec, spec, JP()), (spec,) * 3))(W, b, x)
    want = [np.asarray(a).reshape(n, *np.shape(a)[1:]) for a in want]

    tW = mesh.shard(W, P("pp")).requires_grad_(True)      # (R, 1, D, D)
    tb = mesh.shard(b, P("pp")).requires_grad_(True)
    out = pipeline_apply(
        lambda p, a: torch.tanh(a @ p[0][:, 0] + p[1][:, 0, None]),
        (tW, tb), mesh.shard(x, P()), InGraphComm("pp", n, mesh))
    out.pow(2).sum(dim=(1, 2, 3)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want[0], **TOL)
    assert not out[:-1].any()                 # only the last stage writes
    for got, w_ in zip((tW.grad, tb.grad), want[1:]):     # (R, 1, ...)
        np.testing.assert_allclose(got.numpy().reshape(w_.shape), w_, **TOL)


# -- Switch MoE ---------------------------------------------------------------
def test_moe_matches_jax_with_a_capacity_drop():
    E, T, D, F, cap = 4, 16, 8, 16, 2
    rng = np.random.default_rng(9)
    x = rng.standard_normal((E, T, D)).astype(np.float32)
    gate = rng.standard_normal((D, E)).astype(np.float32)
    w1 = (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32)
    w2 = (rng.standard_normal((E, F, D)) * F ** -0.5).astype(np.float32)
    # top-1 routing must not sit on a near-tie: a flip between the two
    # packages would fail far beyond any tolerance
    logits = x @ gate
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top2 = np.sort(p, -1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-5
    counts = np.stack([np.bincount(e, minlength=E) for e in p.argmax(-1)])
    assert counts.max() > cap                 # some tokens are dropped

    jm, mesh = _meshes((E,), ("ep",))
    jc = JComm("ep", E)

    def jloss(xx, g, a, b):
        out = j_moe(xx, {"gate": g, "w1": a, "w2": b}, jc, capacity=cap)
        return out, jnp.sum(out ** 2)

    def jbody(xx, g, a, b):
        out, _ = jloss(xx[0], g, a[0], b[0])
        grads = jax.grad(lambda *v: jloss(*v)[1], argnums=(0, 1, 2))(
            xx[0], g, a[0], b[0])
        return (out[None],) + tuple(gg[None] for gg in grads)

    s = JP("ep")
    want = jax.jit(_smap(jbody, jm, (s, JP(), s, s), (s,) * 4))(
        x, gate, w1, w2)
    want = [np.asarray(a) for a in want]

    tx = torch.from_numpy(x).requires_grad_(True)
    tg = mesh.shard(gate, P()).requires_grad_(True)
    ta, tb = (torch.from_numpy(a).requires_grad_(True) for a in (w1, w2))
    out = moe_apply(tx, {"gate": tg, "w1": ta, "w2": tb},
                    InGraphComm("ep", E, mesh), capacity=cap)
    out.pow(2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want[0], **TOL)
    assert (out.detach().abs().sum(-1) == 0).any()     # dropped tokens
    for got, w_ in zip((tx.grad, tg.grad, ta.grad), want[1:]):
        np.testing.assert_allclose(got.numpy(), w_, **TOL)


def test_init_moe_params_shapes_match_jax():
    got = init_moe_params(8, 16, 4, torch.Generator().manual_seed(0), "cpu")
    want = j_init_moe(jax.random.PRNGKey(0), 8, 16, 4)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert float(got["gate"].std()) == pytest.approx(0.02, rel=0.5)
