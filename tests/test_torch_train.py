"""Parity of the port's training path with the JAX package's.

The JAX package's ``init_params``/``init_pp_params`` make the params;
``Mesh.shard`` lays them out over the port's rank mesh, as
``NamedSharding`` + ``shard_map`` lay them out over the conftest's 8 CPU
devices, so both packages run the same step on the same numbers and the
same token batch (numpy, from a seed). Float32 throughout.

Tolerances are the JAX package's own (``tests/test_parallel.py``): loss
rtol 1e-5, params rtol 2e-4 / atol 2e-6 after one step; the dryrun's
step-1 / step-2 losses rtol 1e-4 / 2e-3 (``__graft_entry__.py:143-146``).
Replicated leaves must agree across ranks within 1e-9.

bf16 (``Config.dtype``'s default in both packages) is held on the dp=1
step and the dp=2 stacked step at the same widths, against the JAX
package run op by op (eager; for dp=2 each rank's ``value_and_grad`` on
its half of the batch, averaged as the step's pmean averages them): each
op then rounds its output to bf16, where ``jit`` lets XLA keep float32
between fused ops at its own choice of places. The forward rounds the
same values at the same ops in both packages (GELU included: the port's
``moe.gelu`` rounds every step, as ``jax.nn.gelu`` does), so the loss
differs only by float32 reduction order: rtol 2^-21. The backward
does not round at the same points: a torch autograd kernel in bf16
computes a derivative (tanh's, say) in float32 and rounds once, where
JAX's VJP rounds each op the derivative is made of. So each element of
the step's update (new - old) is held within 4 bf16 ulps of the sum of
its own size and its leaf's largest update, 4 * 2^-8 * (|u| + max|u|).
A control holds the port's float32 step against the same bf16
reference and asserts that it misses both limits, so the limits tell a
bf16 step from a float32 one. The test prints its gaps (``-s``).

The DDP step (``sgd_train_step(grad_sync=BucketedGradSync(...))``) on a
dp=8 rank mesh is held against a reference built from JAX functions:
each rank's ``jax.value_and_grad(loss_fn)`` on its batch shard, the
gradients averaged through JAX's ``BucketedGradSync`` on the conftest's
8-device world, then SGD.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

import __graft_entry__ as G
import ompi_tpu_torch as T
from ompi_tpu.coll import persistent as jpersistent
from ompi_tpu.mca import var as jvar
from ompi_tpu.models import transformer as JT
from ompi_tpu.parallel import InGraphComm as JComm
from ompi_tpu_torch import entry as E
from ompi_tpu_torch.coll import persistent
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.models import transformer as TT
from ompi_tpu_torch.parallel import InGraphComm, Mesh, P, moe
from ompi_tpu_torch.parallel.mesh import tree_leaves, tree_map

SMALL = dict(vocab=32, d_model=16, n_heads=4, n_layers=2, d_ff=32, seq=8)
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=2e-4, atol=2e-6)


def _smap(fn, mesh, in_specs, out_specs):
    try:
        return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)
    except TypeError:                                   # older shard_map kw
        return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_rep=False)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_trees(got, want, **tol):
    """Leaf by leaf, paired by key and index (JAX flattens dicts in
    sorted-key order)."""
    assert len(tree_leaves(got)) == len(jax.tree_util.tree_leaves(want))
    tree_map(lambda a, b: np.testing.assert_allclose(
        a.detach().numpy(), np.asarray(b), **tol), got, want)


def _dense(seed, batch, use_flash=False, **kw):
    """JAX params (numpy), the port's config and a pre-shifted batch."""
    jcfg = JT.Config(**{**SMALL, **kw}, dtype=jnp.float32,
                     use_flash=use_flash)
    tcfg = TT.Config(**{**SMALL, **kw}, dtype=torch.float32,
                     use_flash=use_flash)
    params = _np(JT.init_params(jax.random.PRNGKey(seed), jcfg))
    tok = np.random.default_rng(seed).integers(0, SMALL["vocab"],
                                               (batch, SMALL["seq"] + 1))
    return jcfg, tcfg, params, (tok[:, :-1], tok[:, 1:])


def _t(batch):
    return tuple(torch.from_numpy(b) for b in batch)


@pytest.mark.parametrize("use_flash", [False, True])
def test_loss_and_single_device_step_match_jax(use_flash):
    jcfg, tcfg, params, batch = _dense(3, 4, use_flash)
    jb = tuple(jnp.asarray(b, jnp.int32) for b in batch)
    want_loss = float(JT.loss_fn(params, *jb, jcfg))
    want_p, want_step_loss = JT.sgd_train_step(params, jb, jcfg, 1e-2)
    tp = TT.params_from_jax(params, device="cpu")
    np.testing.assert_allclose(float(TT.loss_fn(tp, *_t(batch), tcfg)),
                               want_loss, **LOSS_TOL)
    got_p, got_loss = TT.sgd_train_step(tp, _t(batch), tcfg, 1e-2)
    np.testing.assert_allclose(float(got_loss), float(want_step_loss),
                               **LOSS_TOL)
    _close_trees(got_p, want_p, **PARAM_TOL)


# the two sharded layouts of tests/test_parallel.py: dp=2 x tp=2 with the
# batch split over dp, and sp=2 with the sequence split over sp
LAYOUTS = {
    "dp2_tp2": dict(shape=(2, 2), names=("dp", "tp"), seed=3, batch=4,
                    bspec=("dp",)),
    "sp2": dict(shape=(2,), names=("sp",), seed=5, batch=2,
                bspec=(None, "sp")),
}


@pytest.fixture(scope="module")
def jax_sharded_steps():
    """JAX's sharded step per layout (and its single-device step)."""
    out = {}
    for name, lay in LAYOUTS.items():
        jcfg, _, params, batch = _dense(lay["seed"], lay["batch"])
        jb = tuple(jnp.asarray(b, jnp.int32) for b in batch)
        ref = JT.sgd_train_step(params, jb, jcfg, 1e-2)
        n = int(np.prod(lay["shape"]))
        mesh = JMesh(np.array(jax.devices()[:n]).reshape(lay["shape"]),
                     lay["names"])
        specs = (G._param_specs(params, JP) if "tp" in lay["names"] else
                 jax.tree_util.tree_map(lambda _: JP(), params))
        sp = jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
            specs)
        bs = JP(*lay["bspec"])
        sb = tuple(jax.device_put(b, NamedSharding(mesh, bs)) for b in jb)
        comms = {a: JComm(a, 2) for a in lay["names"]}
        step = _smap(lambda p, b: JT.sgd_train_step(
            p, b, jcfg, 1e-2, comms.get("dp"), comms.get("tp"),
            comms.get("sp")), mesh, (specs, (bs, bs)), (specs, JP()))
        out[name] = (ref, jax.jit(step)(sp, sb))
    return out


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_sharded_step_matches_jax_and_single_device(name, jax_sharded_steps):
    lay = LAYOUTS[name]
    (ref_p, ref_loss), (jax_p, jax_loss) = jax_sharded_steps[name]
    _, tcfg, params, batch = _dense(lay["seed"], lay["batch"])
    mesh = Mesh(lay["shape"], lay["names"], "cpu")
    specs = (E._param_specs(params) if "tp" in lay["names"] else
             tree_map(lambda _: P(), params))
    comms = {a: InGraphComm(a, 2, mesh) for a in lay["names"]}
    bs = P(*lay["bspec"])
    new_p, loss = TT.sgd_train_step(
        mesh.shard(params, specs), mesh.shard(_t(batch), (bs, bs)), tcfg,
        1e-2, comms.get("dp"), comms.get("tp"), comms.get("sp"))
    loss = float(mesh.unshard(loss, P()))
    new_p = mesh.unshard(new_p, specs)
    for want_p, want_loss in ((jax_p, jax_loss), (ref_p, ref_loss)):
        np.testing.assert_allclose(loss, float(want_loss), **LOSS_TOL)
        _close_trees(new_p, want_p, **PARAM_TOL)


def test_pp2_train_step_matches_jax():
    jcfg = JT.Config(vocab=32, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                     seq=8, dtype=jnp.float32)
    tcfg = TT.Config(vocab=32, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                     seq=8, dtype=torch.float32)
    params = _np(JT.init_pp_params(jax.random.PRNGKey(0), jcfg, pp=2))
    tok = np.random.default_rng(1).integers(0, 32, (4, 9))
    batch = (tok[:, :-1], tok[:, 1:])
    jm = JMesh(np.array(jax.devices()[:2]), ("pp",))
    jspec = {"rep": jax.tree_util.tree_map(lambda _: JP(), params["rep"]),
             "stage": [{k: JP("pp") for k in slot}
                       for slot in params["stage"]]}
    jc = JComm("pp", 2)
    step = _smap(lambda p, i, t: JT.pp_train_step(
        p, (i, t), jcfg, 1e-2, pp_comm=jc, n_micro=2), jm,
        (jspec, JP(), JP()), (jspec, JP()))
    want_p, want_loss = jax.jit(step)(
        jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(jm, s)), params,
            jspec), *(jnp.asarray(b, jnp.int32) for b in batch))

    mesh = Mesh((2,), ("pp",), "cpu")
    spec = {"rep": tree_map(lambda _: P(), params["rep"]),
            "stage": [{k: P("pp") for k in slot} for slot in params["stage"]]}
    got_p, got_loss = TT.pp_train_step(
        mesh.shard(params, spec), mesh.shard(_t(batch), (P(), P())), tcfg,
        1e-2, pp_comm=InGraphComm("pp", 2, mesh), n_micro=2)
    np.testing.assert_allclose(float(mesh.unshard(got_loss, P())),
                               float(want_loss), **LOSS_TOL)
    _close_trees(mesh.unshard(got_p, spec), want_p, **PARAM_TOL)


BF16_LOSS_RTOL = 2.0 ** -21
BF16_UPDATE_ULPS = 4.0


def _bf16_gaps(got_p, got_loss, want_p, want_loss, before):
    """(the loss's relative gap, the largest gap of an update element in
    units of 2^-8 * (|u| + max|u|) over its leaf) between a port step
    and the JAX package's; the module docstring gives their limits."""
    assert len(tree_leaves(got_p)) == len(jax.tree_util.tree_leaves(want_p))
    ulps = []

    def one(a, b, p0):
        p0 = np.asarray(p0, np.float32)
        u_got = a.detach().float().numpy() - p0
        u = np.asarray(b, np.float32) - p0
        ulp = 2.0 ** -8 * (np.abs(u) + np.abs(u).max())
        ulps.append(float(np.max(np.abs(u_got - u) / ulp)))
    tree_map(one, got_p, want_p, before)
    loss = abs(float(got_loss) - float(want_loss)) / abs(float(want_loss))
    return loss, max(ulps)


def test_gelu_rounds_as_jax():
    """``parallel/moe.gelu`` equals ``jax.nn.gelu`` bit for bit in bf16
    and to float32 rounding in float32; ``F.gelu``, which rounds once,
    is the control that parts from it in bf16 (the count is printed)."""
    x = (np.random.default_rng(7).standard_normal(1024) * 2).astype(
        np.float32)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        want = np.asarray(jax.nn.gelu(jnp.asarray(x, jdt)), np.float32)
        xt = torch.from_numpy(x).to(tdt)
        got = moe.gelu(xt).float().numpy()
        once = torch.nn.functional.gelu(xt, approximate="tanh").float()
        if tdt is torch.bfloat16:
            np.testing.assert_array_equal(got, want)
            parted = int((once.numpy() != want).sum())
            print(f"bf16: F.gelu parts from jax.nn.gelu in {parted} of "
                  f"{x.size} elements; moe.gelu in 0")
            assert parted > 0
        else:
            # tanh's float32 implementations differ by an ulp or two:
            # 1e-6 is two ulps of the largest output here (about 6)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dp", [1, 2])
def test_bf16_train_step_matches_jax(dp):
    """The dp=1 step and the dp=2 stacked step in bf16, against the JAX
    package's op-by-op step; the port's float32 step is the control that
    must miss both limits (the module docstring gives them; the gaps are
    printed)."""
    jcfg = JT.Config(**SMALL, dtype=jnp.bfloat16)
    params = _np(JT.init_params(jax.random.PRNGKey(3), jcfg))
    tok = np.random.default_rng(3).integers(0, SMALL["vocab"],
                                            (4, SMALL["seq"] + 1))
    batch = (tok[:, :-1], tok[:, 1:])
    jb = tuple(jnp.asarray(b, jnp.int32) for b in batch)
    if dp == 1:
        want_p, want_loss = JT.sgd_train_step(params, jb, jcfg, 1e-2)

        def port(dtype):
            return TT.sgd_train_step(
                TT.params_from_jax(params, device="cpu"), _t(batch),
                TT.Config(**SMALL, dtype=dtype), 1e-2)
    else:
        # the JAX package's dp step per rank, op by op: value_and_grad on
        # the rank's half of the batch, the pmean of the losses and of
        # the gradients (psum / 2), then SGD
        vg = [jax.value_and_grad(JT.loss_fn)(
            params, *(b[2 * r:2 * r + 2] for b in jb), jcfg)
            for r in range(2)]
        want_loss = (vg[0][0] + vg[1][0]) / 2
        want_p = jax.tree_util.tree_map(
            lambda p, g0, g1: p - 1e-2 * ((g0 + g1) / 2), params,
            vg[0][1], vg[1][1])
        mesh = Mesh((2,), ("dp",), "cpu")
        tspecs = tree_map(lambda _: P(), params)

        def port(dtype):
            new_p, loss = TT.sgd_train_step(
                mesh.shard(params, tspecs),
                mesh.shard(_t(batch), (P("dp"), P("dp"))),
                TT.Config(**SMALL, dtype=dtype), 1e-2,
                InGraphComm("dp", 2, mesh))
            return mesh.unshard(new_p, tspecs), mesh.unshard(loss, P())
    bf = _bf16_gaps(*port(torch.bfloat16), want_p, want_loss, params)
    f32 = _bf16_gaps(*port(torch.float32), want_p, want_loss, params)
    print(f"dp={dp}: bf16 loss {bf[0]:.3g}, update {bf[1]:.3g} ulps; "
          f"float32 control loss {f32[0]:.3g}, update {f32[1]:.3g} ulps")
    assert bf[0] <= BF16_LOSS_RTOL and bf[1] <= BF16_UPDATE_ULPS, bf
    assert f32[0] > BF16_LOSS_RTOL and f32[1] > BF16_UPDATE_ULPS, f32


def _replicated_grad_divergence(mesh, params, specs, loss):
    """The largest difference across ranks of the gradient of any
    replicated leaf but the MoE gate (before any gradient sync). The
    gate's pieces differ by design: each expert rank routed its own token
    shard, and the step sums them over ep."""
    _, grads = TT._value_and_grad(loss, params)

    def strip(tree):
        if isinstance(tree, dict):
            return {k: strip(v) for k, v in tree.items() if k != "gate"}
        if isinstance(tree, list):
            return [strip(v) for v in tree]
        return tree

    return mesh.divergence(strip(grads), strip(specs))


def test_moe_grads_keep_replicated_params_replicated():
    """The Megatron f operator on the MoE path (the port's counterparts of
    tests/test_parallel.py:327 and :445): gradients of replicated leaves
    are identical across the expert ranks, with experts on tp (pp=1) and
    on a dedicated ep axis."""
    cfg = TT.Config(vocab=32, d_model=16, n_heads=4, n_layers=2, d_ff=32,
                    seq=8, dtype=torch.float32, moe=True, moe_experts=2)
    gen = torch.Generator().manual_seed(0)
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, 32, (4, 9)))

    # experts on tp, through the pipelined step's layers
    mesh = Mesh((1, 2), ("pp", "tp"), "cpu")
    pp, tp = InGraphComm("pp", 1, mesh), InGraphComm("tp", 2, mesh)
    params = TT.init_pp_params(cfg, gen, "cpu", pp=1)
    specs = E._stage_specs(params, cfg)
    inputs, targets = mesh.shard((tok[:, :-1], tok[:, 1:]), (P(), P()))

    def stage_loss(p):
        x = TT._embed(p["rep"]["emb"], inputs)
        causal = torch.tril(torch.ones(8, 8, dtype=torch.bool))
        for lay in p["stage"]:
            x = TT._layer(x, {k: lay[k][:, 0] for k in ("ln1", "ln2")},
                          {k: v[:, 0] for k, v in lay.items()
                           if k not in ("ln1", "ln2")}, causal, cfg, tp,
                          None, tp)
        h = TT._rmsnorm(x, p["rep"]["ln_f"])
        return TT._nll(TT._logits(h, p["rep"]["emb"]), targets)

    sharded = mesh.shard(params, specs)
    div = _replicated_grad_divergence(mesh, sharded, specs, stage_loss)
    assert div < 1e-9, div
    # ... and after a whole step (with its gradient sync), every
    # replicated leaf is still replicated
    new_p, _ = TT.pp_train_step(sharded, (inputs, targets), cfg, 1e-2,
                                pp_comm=pp, n_micro=2, tp_comm=tp,
                                ep_comm=tp)
    assert mesh.divergence(new_p, specs) < 1e-9

    # experts on a dedicated ep axis, no tp
    cfg1 = TT.Config(**{**cfg.__dict__, "n_layers": 1})
    params = TT.init_params(cfg1, gen, "cpu", tp=2)
    mesh = Mesh((2,), ("ep",), "cpu")
    ep = InGraphComm("ep", 2, mesh)
    specs = {"rep": tree_map(lambda _: P(), params["rep"]),
             "tp": {"layers": [{"wqkv": P(), "wo": P(), "gate": P(),
                                "w1": P("ep"), "w2": P("ep")}]}}
    inputs, targets = mesh.shard((tok[:2, :-1], tok[:2, 1:]), (P(), P()))
    div = _replicated_grad_divergence(
        mesh, mesh.shard(params, specs), specs,
        lambda p: TT._nll(TT.forward(p, inputs, cfg1, ep_comm=ep), targets))
    assert div < 1e-9, div


@pytest.mark.parametrize("use_flash", [False, True])
def test_stacked_forward_with_size_one_axes_equals_forward(use_flash):
    """The stacked code on a mesh whose every axis has size 1 (comms
    given: tp's Megatron pair, sp's ring attention) is ``forward``."""
    _, tcfg, params, batch = _dense(7, 2, use_flash)
    tp = TT.params_from_jax(params, device="cpu")
    tokens = torch.from_numpy(batch[0])
    want = TT.forward(tp, tokens, tcfg)
    mesh = Mesh((1, 1, 1, 1), ("pp", "dp", "tp", "sp"), "cpu")
    specs = tree_map(lambda _: P(), params)
    comms = {a: InGraphComm(a, 1, mesh) for a in ("tp", "sp")}
    got = TT.forward(mesh.shard(params, specs), mesh.shard(tokens, P()),
                     tcfg, tp_comm=comms["tp"], sp_comm=comms["sp"])
    assert got.shape == (1,) + tuple(want.shape)
    np.testing.assert_allclose(got[0].detach().numpy(),
                               want.detach().numpy(), atol=1e-5, rtol=0)


# -- the slice as a whole: _run_flagship at both dryrun factorizations -------
FACTORIZATIONS = [(2, 1, 2, 2), (2, 2, 2, 1)]
TOKENS = np.random.default_rng(0).integers(0, 64, (8, 17))


@pytest.fixture(scope="module")
def jax_flagship():
    return {f: G._run_flagship(jax.devices(), *f, TOKENS)
            for f in FACTORIZATIONS}


@pytest.mark.parametrize("fac", FACTORIZATIONS, ids=str)
def test_run_flagship_matches_jax(fac, jax_flagship, monkeypatch):
    """The port's _run_flagship on JAX's init_pp_params(PRNGKey(0)) gives
    JAX's step-1 and step-2 losses, with no top-1 routing decision near
    a tie (a flip would differ far beyond the tolerances)."""
    jcfg = JT.Config(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                     seq=16, dtype=jnp.float32, moe=True, moe_experts=fac[2],
                     use_flash=True)
    params = _np(JT.init_pp_params(jax.random.PRNGKey(0), jcfg, fac[0]))
    margins = []
    apply = moe.moe_apply

    def spy(x, p, ep, capacity):
        # real tokens only: pipeline bubble ticks route all-zero rows,
        # an exact tie both packages break to expert 0
        with torch.no_grad():
            top2 = torch.softmax((x @ p["gate"]).float(), -1).topk(2).values
            live = x.abs().amax(-1) > 0
            margins.append(float((top2[..., 0] - top2[..., 1])[live].min()))
        return apply(x, p, ep, capacity)

    monkeypatch.setattr(moe, "moe_apply", spy)
    got = E._run_flagship(*fac, TOKENS, params=params, device="cpu")
    assert len(margins) > 0 and min(margins) > 1e-5, min(margins)
    want = jax_flagship[fac]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=2e-3)


def test_dryrun_multichip_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.dryrun_multichip()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.flagship_step(2, 1, 2, 2, TOKENS)
    out = E.dryrun_multichip(8, device="cpu")
    assert set(out) == {"dp1", "dp2", "ulysses_err"}
    np.testing.assert_allclose(out["dp2"], out["dp1"], rtol=1e-4)
    assert out["ulysses_err"] < 2e-5


# -- DDP: BucketedGradSync and sgd_train_step(grad_sync=...) -----------------
@pytest.fixture()
def buckets():
    """Set both packages' ``mpi_base_bucket*`` vars; the JAX ones are
    restored afterwards (the port's go with its reset)."""
    T._reset_for_tests()
    T.Init(devices=["cpu"] * 8)

    def set_(on, nbytes=persistent.DEFAULT_BUCKET_BYTES):
        for v in (var, jvar):
            v.var_set("mpi_base_bucket", on)
            v.var_set("mpi_base_bucket_bytes", nbytes)
    try:
        yield set_
    finally:
        jpersistent.flush_all("explicit")
        jvar.var_set("mpi_base_bucket_bytes", jpersistent.DEFAULT_BUCKET_BYTES)
        jvar.var_set("mpi_base_bucket", False)
        T._reset_for_tests()


def _counted(counters):
    return {k: v for k, v in counters().items()
            if k.startswith("coll_")}


@pytest.mark.parametrize("bucket", [True, False])
def test_bucketed_grad_sync_matches_jax(world, buckets, bucket):
    """The port's sync on a stacked tree against JAX's on the same tree
    (keys in sorted order, so both packages walk the leaves alike): the
    same means, the same flush counts, and the loss mean."""
    rng = np.random.default_rng(7)
    # per rank: b 800 B + w 640 B pass the 1 KiB threshold together
    # (one "bytes" flush); c, float64, is a bucket of its own
    tree = {"b": rng.integers(-4, 4, size=(8, 200)).astype(np.float32),
            "c": rng.standard_normal((8, 3)).astype(np.float64),
            "w": rng.integers(-4, 4, size=(8, 8, 20)).astype(np.float32)}
    buckets(bucket, 1 << 10)
    comm = T.get_comm_world()
    before = _counted(persistent.counters)
    out = TT.BucketedGradSync(comm, tree_map(comm.put, tree))(
        tree_map(comm.put, tree))
    ours = {k: v - before[k] for k, v in _counted(persistent.counters).items()}
    jbefore = _counted(jpersistent.counters)
    jtree = {k: world.stack(list(v)) for k, v in tree.items()}
    want = JT.BucketedGradSync(world, jtree)(jtree)
    theirs = {k: v - jbefore[k]
              for k, v in _counted(jpersistent.counters).items()}
    for k in tree:
        assert out[k].device == comm.device and out[k].dtype == \
            torch.from_numpy(tree[k]).dtype
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)
    # the bucket fold is the port's own: both flushes take it here
    folds = {k: ours.pop(k) for k in ("coll_bucket_folds",
                                      "coll_bucket_fold_tables")}
    assert folds == dict.fromkeys(folds, 2 if bucket else 0)
    assert ours == theirs
    assert ours["coll_bucket_flushes"] == (2 if bucket else 0)
    sync = TT.BucketedGradSync(comm, tree_map(comm.put, tree))
    loss = sync.mean_scalar(torch.arange(8, dtype=torch.float32))
    assert loss.dtype == torch.float64 and torch.all(loss == 3.5)
    assert torch.all(sync.mean_scalar(2.5) == 2.5)


DDP = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, seq=16)
DDP_TOKENS = np.random.default_rng(0).integers(0, 64, (16, 17))


@pytest.fixture(scope="module")
def jax_ddp_grads():
    """JAX's params and, per dp rank (2 sequences each), its loss and
    gradients from ``jax.value_and_grad(loss_fn)``."""
    jcfg = JT.Config(**DDP, dtype=jnp.float32)
    params = _np(JT.init_params(jax.random.PRNGKey(4), jcfg))
    vg = jax.jit(jax.value_and_grad(JT.loss_fn), static_argnums=(3,))
    per = [vg(params, jnp.asarray(DDP_TOKENS[2 * r:2 * r + 2, :-1]),
              jnp.asarray(DDP_TOKENS[2 * r:2 * r + 2, 1:]), jcfg)
           for r in range(8)]
    return params, [float(l) for l, _ in per], [g for _, g in per]


@pytest.mark.parametrize("bucket", [True, False])
def test_ddp_step_matches_jax(world, buckets, jax_ddp_grads, bucket):
    """One DDP step at the dryrun widths on dp=8: the port's gradients
    go through ``BucketedGradSync`` on its 8-rank world, JAX's per-rank
    gradients through JAX's on the JAX world."""
    params, losses, grads = jax_ddp_grads
    buckets(bucket)
    stacked = jax.tree_util.tree_map(
        lambda *g: world.stack([np.asarray(x) for x in g]), *grads)
    mean = JT.BucketedGradSync(world, stacked)(stacked)
    want_p = jax.tree_util.tree_map(
        lambda p, g: np.asarray(p) - 1e-2 * np.asarray(g)[0], params, mean)

    tcfg = TT.Config(**DDP, dtype=torch.float32)
    mesh = Mesh((8,), ("dp",), "cpu")
    specs = tree_map(lambda _: P(), params)
    sp = mesh.shard(params, specs)
    batch = mesh.shard(_t((DDP_TOKENS[:, :-1], DDP_TOKENS[:, 1:])),
                       (P("dp"), P("dp")))
    comm = T.get_comm_world()
    sync = TT.BucketedGradSync(comm, sp)
    before = persistent.counters()["coll_bucket_flushes"]
    new_p, loss = TT.sgd_train_step(sp, batch, tcfg, 1e-2,
                                    InGraphComm("dp", 8, mesh),
                                    grad_sync=sync)
    flushes = persistent.counters()["coll_bucket_flushes"] - before
    assert flushes == (2 if bucket else 0)     # the grads, then the loss
    np.testing.assert_allclose(loss.numpy(), np.mean(losses), **LOSS_TOL)
    assert mesh.divergence(new_p, specs) <= 1e-6
    _close_trees(mesh.unshard(new_p, specs), want_p, **PARAM_TOL)
    # the in-graph dp pmean step gives the same params
    ref_p, ref_loss = TT.sgd_train_step(sp, batch, tcfg, 1e-2,
                                        InGraphComm("dp", 8, mesh))
    np.testing.assert_allclose(loss.numpy(), ref_loss.numpy(), **LOSS_TOL)
    for a, b in zip(tree_leaves(new_p), tree_leaves(ref_p)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **PARAM_TOL)


def test_bucketed_grad_sync_needs_stacked_leaves(buckets):
    comm = T.get_comm_world()
    with pytest.raises(ValueError, match="stacked"):
        TT.BucketedGradSync(comm, {"w": torch.zeros(4, 3)})
