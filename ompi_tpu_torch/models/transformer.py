"""The flagship causal transformer LM — the forward and the train steps,
with every parallel strategy of the JAX package in one model.

The port of ``ompi_tpu/models/transformer.py``: embedding, ``n_layers``
blocks of (rmsnorm, attention, residual, rmsnorm, MLP or Switch MoE,
residual), final rmsnorm and logits against the tied embedding;
``loss_fn``, ``sgd_train_step`` (dp x tp x sp, optionally with a
``BucketedGradSync``) and the flagship
``pp_train_step`` (GPipe over pp, Megatron over tp, ring attention over
sp, Switch MoE with experts on ep, gradient sync over dp).

One code path: every internal function works on stacked tensors with a
leading rank dim over a ``parallel.Mesh`` (``Mesh.shard`` lays params and
tokens out so). Called with comms, the public functions take and return
stacked values; called without, they take one device's values and run
them as a mesh of one rank. Per-rank values (``comm.rank()``) are
tensors, and every write is out of place, so autograd differentiates
the whole step.

Attention with ``cfg.use_flash`` and no sp comm goes through
``ops/flash_attention``: one fold with mode 1 (the causal diagonal). With
autograd off (inference, as in ``entry()``) that is the hand-written CUDA
kernel on the card; with autograd on (training) it is the plain torch
fold, as the JAX package trains through its jnp fold. Ring attention
(sp) folds with its own einsums. The train steps thus launch no kernel.

Numerics follow the JAX package: GELU is the tanh approximation
(``jax.nn.gelu``'s default) computed op by op in the activation dtype,
as ``jax.nn.gelu`` rounds it (``parallel/moe.gelu``), rmsnorm runs in
float32 with eps 1e-6 inside the rsqrt, logits are a float32 product
against ``emb``, and the loss is ``log_softmax`` gathered at the
targets.

``BucketedGradSync`` is the DDP path: ``sgd_train_step(grad_sync=…)``
averages the dp gradients through bucketed persistent allreduces on a
``Communicator`` instead of the in-graph pmean.

The parameter tree keeps the JAX layout —
``{"rep": {"emb", "ln_f", "layers": [{"ln1", "ln2"}]},
"tp": {"layers": [{"wqkv", "wo", "w1", "w2"(, "gate")}]}}``, and
``{"rep": {"emb", "ln_f"}, "stage": [...]}`` for the pipeline — so JAX
params convert with one tree map (``params_from_jax``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ompi_tpu_torch.core import op as _op
from ompi_tpu_torch.core.request import startall
from ompi_tpu_torch.ops.flash_attention import _fold_torch, flash_block_update
from ompi_tpu_torch.parallel import InGraphComm
from ompi_tpu_torch.parallel import moe as _moe
from ompi_tpu_torch.parallel.mesh import tree_leaves, tree_map
from ompi_tpu_torch.parallel.pipeline import pipeline_apply
from ompi_tpu_torch.parallel.ring_attention import ring_attention


@dataclass(frozen=True)
class Config:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 512
    seq: int = 64
    dtype: torch.dtype = torch.bfloat16
    moe: bool = False            # MLPs become Switch MoE blocks
    moe_experts: int = 0         # expert count (0: the tp arg/axis)
    moe_capacity: int = 0        # per-(src, expert) slots; 0 = auto
    use_flash: bool = False      # local attention via ops/flash

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


def init_params(cfg: Config, generator: torch.Generator, device,
                tp: int = 1) -> Dict:
    """Random params in the JAX layout: normal draws from ``generator``
    (a CPU generator, so a seed gives the same params on every device),
    scaled as the JAX package scales them, then moved to ``device``.
    ``tp`` > 1 gives one tp rank's shard (heads and d_ff divided by tp);
    with ``cfg.moe``, w1/w2 hold every expert on a leading axis."""
    if cfg.n_heads % tp or cfg.d_ff % tp:
        raise ValueError(f"init_params: tp={tp} must divide n_heads "
                         f"{cfg.n_heads} and d_ff {cfg.d_ff}")
    d, dh, h = cfg.d_model, cfg.d_head, cfg.n_heads
    hl, fl = h // tp, cfg.d_ff // tp

    def normal(*shape, scale):
        return (torch.randn(shape, generator=generator, dtype=torch.float32)
                * scale).to(device)

    ones = lambda: torch.ones(d, dtype=torch.float32, device=device)  # noqa: E731
    rep = {"emb": normal(cfg.vocab, d, scale=0.02), "ln_f": ones(),
           "layers": [{"ln1": ones(), "ln2": ones()}
                      for _ in range(cfg.n_layers)]}
    tp_layers = []
    for _ in range(cfg.n_layers):
        lay = {"wqkv": normal(d, 3, hl, dh, scale=d ** -0.5),
               "wo": normal(hl, dh, d, scale=(h * dh) ** -0.5)}
        if cfg.moe:
            # Switch MoE: a replicated gate; w1/w2 hold ALL experts on a
            # leading expert axis, sharded over the expert-axis ranks
            n_exp = cfg.moe_experts or max(tp, 1)
            lay["w1"] = normal(n_exp, d, cfg.d_ff, scale=d ** -0.5)
            lay["w2"] = normal(n_exp, cfg.d_ff, d, scale=cfg.d_ff ** -0.5)
            lay["gate"] = normal(d, n_exp, scale=0.02)
        else:
            lay["w1"] = normal(d, fl, scale=d ** -0.5)
            lay["w2"] = normal(fl, d, scale=cfg.d_ff ** -0.5)
        tp_layers.append(lay)
    return {"rep": rep, "tp": {"layers": tp_layers}}


def params_from_jax(tree: Any, device=None) -> Any:
    """Convert a JAX-layout param tree whose leaves are numpy arrays (or
    anything ``np.asarray`` takes) into the same tree of tensors.
    ``device`` defaults to the first CUDA device; pass ``"cpu"`` to keep
    the tensors on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("params_from_jax(): no CUDA device is "
                               "visible; pass device='cpu' to convert onto "
                               "the CPU")
        device = torch.device("cuda", 0)
    return tree_map(lambda x: torch.tensor(np.asarray(x), device=device),
                    tree)


# -- the stacked model: every tensor leads with the rank dim ---------------
def _rmsnorm(x, g):
    """x: (R, ..., D); g: (R, D)."""
    x32 = x.float()
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + 1e-6)
    g = g.view(g.shape[0], *[1] * (x.ndim - 2), g.shape[-1])
    return (x32 * r * g).to(x.dtype)


def _flash_causal(q, k, v, cfg: Config):
    """Single-block causal attention through the flash fold: mode 1 is
    exactly the causal diagonal block. q, k, v: (..., S, H, D)."""
    *lead, S, H, D = q.shape
    scale = torch.tensor(cfg.d_head, dtype=torch.float32) ** -0.5

    def heads(t):
        return t.transpose(-3, -2).reshape(-1, S, D).float()

    qf = heads(q) * scale.to(q.device)
    kf, vf = heads(k), heads(v)
    o = torch.zeros_like(qf)
    m = torch.full(qf.shape[:2], -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros(qf.shape[:2], dtype=torch.float32, device=q.device)
    # the TRAINING path needs autograd: the plain fold is the same math,
    # differentiable; the kernel (no backward yet) serves forward-only use
    fold = _fold_torch if torch.is_grad_enabled() else flash_block_update
    o, m, l = fold(qf, kf, vf, o, m, l, 1)
    o = o / torch.where(l == 0.0, 1.0, l)[..., None]
    return o.reshape(*lead, H, S, D).transpose(-3, -2).to(q.dtype)


def _attend(q, k, v, causal, cfg: Config,
            sp_comm: Optional[InGraphComm]):
    """Ring attention over sp when sequence-parallel; the flash fold or
    dense softmax locally otherwise. q, k, v: (R, B, S, H, dh)."""
    if sp_comm is not None:
        return ring_attention(q, k, v, sp_comm, causal=True)
    if cfg.use_flash:
        return _flash_causal(q, k, v, cfg)
    att = torch.einsum("rbshk,rbthk->rbhst", q, k) / torch.sqrt(
        torch.tensor(cfg.d_head, dtype=cfg.dtype, device=q.device))
    att = torch.where(causal, att, -1e9)
    att = torch.softmax(att.float(), dim=-1).to(cfg.dtype)
    return torch.einsum("rbhst,rbthk->rbshk", att, v)


def _mlp(x, lt: Dict, cfg: Config, tp_comm: Optional[InGraphComm],
         ep_comm: Optional[InGraphComm]):
    """Switch MoE over the expert axis when configured, the Megatron
    column/row pair otherwise. ``x`` is the ln2-normalized input (already
    copy_in'd for dense tp)."""
    if cfg.moe and ep_comm is not None:
        # the Megatron f operator over the EXPERT axis: each expert rank
        # consumes only its token shard, so without the backward psum
        # every upstream cotangent would be a per-rank partial and the
        # replicated params would diverge
        x = ep_comm.copy_in(x)
        R, B, S, D = x.shape
        E = ep_comm.size()
        if cfg.moe_experts not in (0, E):
            raise ValueError(f"moe_experts={cfg.moe_experts} != expert "
                             f"axis size {E}: extra experts would be dead "
                             f"weights")
        T = B * S
        if T % E:
            raise ValueError(f"{T} tokens do not divide the expert axis "
                             f"({E})")
        Tl = T // E
        r = ep_comm.rank()
        # activations are replicated over the expert axis: each expert
        # rank takes its own token shard (rows r*Tl .. r*Tl + Tl), runs
        # the dispatch/combine, and one psum reassembles the shards
        shard = x.reshape(R, E, Tl, D)[torch.arange(R, device=x.device), r]
        w1, w2 = lt["w1"], lt["w2"]
        if w1.ndim == 4:                     # (R, 1, D, F): one expert
            w1, w2 = w1[:, 0], w2[:, 0]
        cap = cfg.moe_capacity or max(1, 2 * Tl // E)
        out_shard = _moe.moe_apply(
            shard, {"gate": lt["gate"].to(x.dtype), "w1": w1.to(x.dtype),
                    "w2": w2.to(x.dtype)}, ep_comm, capacity=cap)
        mine = F.one_hot(r, E).bool()[:, :, None, None]       # (R,E,1,1)
        full = torch.where(mine, out_shard[:, None], 0).reshape(R, T, D)
        return ep_comm.reduce_out(full).reshape(R, B, S, D)
    m = _moe.gelu(torch.einsum("rbsd,rdf->rbsf", x, lt["w1"].to(cfg.dtype)))
    m = torch.einsum("rbsf,rfd->rbsd", m, lt["w2"].to(cfg.dtype))
    if tp_comm is not None:
        m = tp_comm.reduce_out(m)                      # row-parallel sum
    return m


def _layer(x, lr: Dict, lt: Dict, causal, cfg: Config,
           tp_comm: Optional[InGraphComm],
           sp_comm: Optional[InGraphComm],
           ep_comm: Optional[InGraphComm] = None):
    """One transformer block (attention + MLP/MoE with residuals)."""
    h = _rmsnorm(x, lr["ln1"])
    if tp_comm is not None:
        h = tp_comm.copy_in(h)
    qkv = torch.einsum("rbsd,rdchk->rbcshk", h,
                       lt["wqkv"].to(cfg.dtype))        # (R,B,3,S,hl,dh)
    o = _attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal, cfg,
                sp_comm)
    o = torch.einsum("rbshk,rhkd->rbsd", o, lt["wo"].to(cfg.dtype))
    if tp_comm is not None:
        o = tp_comm.reduce_out(o)                      # row-parallel sum
    x = x + o
    h = _rmsnorm(x, lr["ln2"])
    if tp_comm is not None and not (cfg.moe and ep_comm is not None):
        # dense Megatron pair: f here, g (reduce_out) in _mlp. The MoE
        # branch applies its own f over the EP axis instead: both on the
        # same axis would double the backward psum
        h = tp_comm.copy_in(h)
    return x + _mlp(h, lt, cfg, tp_comm, ep_comm)


def _embed(emb, tokens):
    """emb: (R, V, D); tokens: (R, ...) -> (R, ..., D), each rank's rows
    from its own table."""
    R, V, D = emb.shape
    offs = (torch.arange(R, device=tokens.device) * V).view(
        R, *[1] * (tokens.ndim - 1))
    return F.embedding(tokens + offs, emb.reshape(R * V, D))


def _logits(x, emb):
    return torch.einsum("rbsd,rvd->rbsv", x.float(), emb)


def _nll(logits, targets):
    """Mean next-token cross-entropy per rank: (R,)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None]).squeeze(-1).mean(dim=(1, 2))


def _forward(params, tokens, cfg, tp_comm=None, sp_comm=None, ep_comm=None):
    rep, tpp = params["rep"], params["tp"]
    x = _embed(rep["emb"], tokens).to(cfg.dtype)      # (R, B, S, D)
    S = x.shape[2]
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                   device=x.device))
    for li in range(cfg.n_layers):
        x = _layer(x, rep["layers"][li], tpp["layers"][li], causal, cfg,
                   tp_comm, sp_comm, ep_comm)
    return _logits(_rmsnorm(x, rep["ln_f"]), rep["emb"])


def _one_rank(params, *tensors):
    """One device's values as a mesh of one rank."""
    return (tree_map(lambda t: t.unsqueeze(0), params),
            *(t.unsqueeze(0) for t in tensors))


def _value_and_grad(fn: Callable, params) -> Tuple[torch.Tensor, Any]:
    """(fn(params), d sum(fn(params)) / d params), detached. Summing the
    per-rank values over the stacked ranks gives each rank's leaves the
    gradient per-rank SPMD AD gives them."""
    leaves = []

    def lift(t):
        leaves.append(t.detach().requires_grad_(True))
        return leaves[-1]

    with torch.enable_grad():
        val = fn(tree_map(lift, params))
        grads = iter(torch.autograd.grad(val.sum(), leaves))
    return val.detach(), tree_map(lambda _: next(grads), params)


def _sgd(params, grads, lr: float):
    with torch.no_grad():
        return tree_map(lambda p, g: p - lr * g, params, grads)


def forward(params: Dict, tokens: torch.Tensor, cfg: Config,
            tp_comm: Optional[InGraphComm] = None,
            sp_comm: Optional[InGraphComm] = None,
            ep_comm: Optional[InGraphComm] = None) -> torch.Tensor:
    """Causal LM forward: tokens (B, S) int -> float32 logits
    (B, S, vocab).

    With a comm, ``params`` and ``tokens`` are stacked over its mesh and
    so are the logits: ``tp_comm`` => heads/d_ff leaves are tp shards and
    row-parallel outputs are psum'ed; ``sp_comm`` => ``tokens`` are each
    rank's sequence block and attention is ring attention; ``ep_comm``
    (with ``cfg.moe``) => MLPs are Switch MoE blocks, one expert per
    expert-axis rank."""
    if tp_comm is None and sp_comm is None and ep_comm is None:
        return _forward(*_one_rank(params, tokens), cfg)[0]
    return _forward(params, tokens, cfg, tp_comm, sp_comm, ep_comm)


def loss_fn(params, inputs, targets, cfg: Config,
            tp_comm: Optional[InGraphComm] = None,
            sp_comm: Optional[InGraphComm] = None):
    """Next-token cross-entropy, the mean over the local batch/sequence
    shard (per rank, when stacked). Callers pre-shift: inputs =
    tokens[:, :-1], targets = tokens[:, 1:], so each sp rank's targets
    are its own block of the shifted stream."""
    if tp_comm is None and sp_comm is None:
        params, inputs, targets = _one_rank(params, inputs, targets)
        return _nll(_forward(params, inputs, cfg), targets)[0]
    return _nll(_forward(params, inputs, cfg, tp_comm, sp_comm), targets)


def sgd_train_step(params, batch, cfg: Config, lr: float,
                   dp_comm: Optional[InGraphComm] = None,
                   tp_comm: Optional[InGraphComm] = None,
                   sp_comm: Optional[InGraphComm] = None,
                   grad_sync: Optional["BucketedGradSync"] = None):
    """One dp x tp x sp training step; returns (params, loss). Grads and
    the loss are averaged over sp (each sp rank saw 1/n of the sequence)
    and over dp; tp correctness comes from the Megatron f/g operators
    inside ``forward``. ``batch`` = (inputs, targets), pre-shifted; with
    comms everything is stacked over their mesh.

    ``grad_sync`` replaces the in-graph dp pmean with DDP-style bucketed
    persistent allreduces over a ``Communicator`` (one fused collective
    per gradient bucket instead of one per tensor); ``dp_comm`` still
    names the data-parallel mesh axis the stacked values run on."""
    inputs, targets = batch
    one = dp_comm is None and tp_comm is None and sp_comm is None
    if one:
        params, inputs, targets = _one_rank(params, inputs, targets)
    loss, grads = _value_and_grad(
        lambda p: _nll(_forward(p, inputs, cfg, tp_comm, sp_comm), targets),
        params)
    for comm in (sp_comm, dp_comm if grad_sync is None else None):
        if comm is not None:
            grads = tree_map(comm.pmean, grads)
            loss = comm.pmean(loss)
    if grad_sync is not None:
        grads = grad_sync(grads)
        loss = grad_sync.mean_scalar(loss)
    params = _sgd(params, grads, lr)
    if one:
        return tree_map(lambda t: t[0], params), loss[0]
    return params, loss


class BucketedGradSync:
    """DDP-style gradient synchronization over bucketed persistent
    allreduces (``coll/persistent``).

    Built once per (comm, gradient tree shape): each leaf gets a staging
    tensor on the communicator's device and a persistent allreduce plan
    (``comm.allreduce_init``), so every step is copy-in -> one
    ``Startall`` (buckets fuse into ceil(total/bucket_bytes) collectives
    when ``mpi_base_bucket`` is on; per-leaf collectives when off) ->
    mean. On the single-controller comm leaves are stacked
    ``(comm.size, ...)``: on the rank mesh, a ``Mesh((dp,), ("dp",),
    device)``'s gradients. On a per-rank comm each leaf is this rank's
    local gradient: a numpy leaf stages in a host buffer (the JAX
    package's way), a tensor leaf on the rank's device. The JAX package
    stages every leaf through host numpy buffers; on the card that would
    be a D2H and an H2D copy per leaf per step, so the port stages tensors
    on the device and returns tensors on the comm's device."""

    def __init__(self, comm, grads_example):
        leaves = tree_leaves(grads_example)
        per_rank = getattr(comm, "is_per_rank", False)
        if not per_rank and any(g.ndim < 1 or g.shape[0] != comm.size
                                for g in leaves):
            raise ValueError(f"BucketedGradSync: every gradient leaf must "
                             f"be stacked over the comm's {comm.size} "
                             f"ranks")
        # each leaf's per-rank shape and dtype (a numpy dtype for a host
        # leaf): what carries over a shrink
        self._local = [(tuple(g.shape[0 if per_rank else 1:]),
                        g.dtype if isinstance(g, np.ndarray)
                        else torch.as_tensor(g).dtype) for g in leaves]
        self._bind(comm)

    def _bind(self, comm) -> None:
        """Stage and plan every leaf on ``comm`` (plans are comm-bound)."""
        self.comm = comm
        self.n = comm.size
        self._stages = [self._zeros(shape, dtype)
                        for shape, dtype in self._local]
        self._reqs = [comm.allreduce_init(s, _op.SUM) for s in self._stages]
        self._scalar_req = None          # lazily rebuilt on the comm

    def _zeros(self, shape, dtype):
        """A staging buffer of one rank's ``shape``: stacked over the
        ranks on the single-controller comm; this rank's own on a
        per-rank comm, in host memory for a numpy leaf."""
        if isinstance(dtype, np.dtype):
            return np.zeros(shape, dtype)
        if getattr(self.comm, "is_per_rank", False):
            return torch.zeros(shape, dtype=dtype, device=self.comm.device)
        return self.comm.alloc(shape, dtype)

    def __call__(self, grads):
        leaves = tree_leaves(grads)
        with torch.no_grad():
            for stage, g in zip(self._stages, leaves):
                if isinstance(stage, np.ndarray):
                    np.copyto(stage, np.asarray(g))
                else:
                    stage.copy_(torch.as_tensor(g))
        startall(self._reqs)
        out = iter([r.get() / self.n for r in self._reqs])
        return tree_map(lambda _: next(out), grads)

    def shrink(self, comm=None) -> "BucketedGradSync":
        """Elastic continuation: after a data-parallel peer dies
        mid-training, rebind this synchronizer to the survivor
        communicator and keep stepping. ``comm`` is the already-shrunk
        comm (``MPIX_Comm_shrink``'s result); None shrinks ``self.comm``
        here. The tree layout carries over; the staging tensors and
        persistent plans rebuild on the new comm (on the single
        controller they hold one row per survivor), and the mean divisor
        rescales to the survivor count, so the survivors' gradients still
        average to an unbiased estimate (a smaller effective batch, not a
        corrupted one). Returns self."""
        self._bind(self.comm.shrink() if comm is None else comm)
        return self

    def mean_scalar(self, value):
        """Mean one scalar per rank (the loss: a stacked ``(n,)`` tensor,
        or one value every rank holds) over the comm — through the same
        persistent machinery, a lazily-built float64 one-element plan."""
        if self._scalar_req is None:
            self._scalar_stage = self._zeros((), torch.float64)
            self._scalar_req = self.comm.allreduce_init(self._scalar_stage,
                                                        _op.SUM)
        with torch.no_grad():
            self._scalar_stage.copy_(torch.as_tensor(value,
                                                     dtype=torch.float64))
        self._scalar_req.start()
        return self._scalar_req.get() / self.n


def init_pp_params(cfg: Config, generator: torch.Generator, device,
                   pp: int) -> Dict:
    """The flagship (pipelined) layout: ``rep`` = {emb, ln_f},
    replicated; ``stage`` = a list of layers-per-stage slots, each leaf
    stacked on a LEADING pp axis (slot j's row s is global layer
    s*(L/pp)+j). Leaves are global (all heads, d_ff, experts)."""
    if cfg.n_layers % pp:
        raise ValueError(f"init_pp_params: pp={pp} must divide n_layers "
                         f"{cfg.n_layers}")
    per = cfg.n_layers // pp
    base = init_params(cfg, generator, device, tp=1)
    rep, tpl = base["rep"], base["tp"]["layers"]
    stage = []
    for j in range(per):
        rows = [dict(tpl[s * per + j], ln1=rep["layers"][s * per + j]["ln1"],
                     ln2=rep["layers"][s * per + j]["ln2"])
                for s in range(pp)]
        stage.append({k: torch.stack([r[k] for r in rows])
                      for k in rows[0]})
    return {"rep": {"emb": rep["emb"], "ln_f": rep["ln_f"]},
            "stage": stage}


def pp_train_step(params, batch, cfg: Config, lr: float, *,
                  pp_comm: InGraphComm, n_micro: int,
                  dp_comm: Optional[InGraphComm] = None,
                  tp_comm: Optional[InGraphComm] = None,
                  sp_comm: Optional[InGraphComm] = None,
                  ep_comm: Optional[InGraphComm] = None):
    """ONE combined dp x tp x sp x pp (x ep) training step — the
    flagship program — on stacked params and batch; returns (params,
    loss), the loss stacked (equal on every rank).

    The batch is microbatched and pipelined (``pipeline_apply``): each
    pp rank's stage leaves arrive as (R, 1, ...). Gradient sync, in the
    JAX package's order: grads and loss pmean over sp, then dp; ``rep``
    grads summed over pp (each stage contributes a different piece: stage
    0 the input embedding, the last stage ln_f and the logits), then
    pmean'ed over tp (a no-op that keeps them tied); the MoE gate grads
    summed over ep (each expert rank routed a different token shard)."""
    inputs, targets = batch
    n_pp = pp_comm.size()
    r_pp = pp_comm.rank()
    R, B, S = inputs.shape
    if B % n_micro:
        raise ValueError(f"pp_train_step: n_micro={n_micro} must divide "
                         f"the local batch {B}")
    Bm = B // n_micro
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                   device=inputs.device))

    def stage_fn(stage_params, a):
        for lay in stage_params:
            lr_ = {"ln1": lay["ln1"][:, 0], "ln2": lay["ln2"][:, 0]}
            lt_ = {k: v[:, 0] for k, v in lay.items()
                   if k not in ("ln1", "ln2")}
            a = _layer(a, lr_, lt_, causal, cfg, tp_comm, sp_comm, ep_comm)
        return a

    def compute_loss(p):
        x = _embed(p["rep"]["emb"], inputs).to(cfg.dtype)   # (R, B, S, D)
        micro = x.reshape(R, n_micro, Bm, S, -1)
        y = pipeline_apply(stage_fn, p["stage"], micro, pp_comm)
        h = _rmsnorm(y.reshape(R, B, S, -1), p["rep"]["ln_f"])
        local = _nll(_logits(h, p["rep"]["emb"]), targets)
        # only the LAST stage's outputs are real: its loss is the job's
        # loss; psum the masked value so every pp rank agrees
        return pp_comm.reduce_out(torch.where(r_pp == n_pp - 1, local, 0.0))

    loss, grads = _value_and_grad(compute_loss, params)
    for comm in (sp_comm, dp_comm):
        if comm is not None:
            grads = tree_map(comm.pmean, grads)
            loss = comm.pmean(loss)
    grads["rep"] = tree_map(pp_comm.allreduce, grads["rep"])
    if tp_comm is not None:
        grads["rep"] = tree_map(tp_comm.pmean, grads["rep"])
    if cfg.moe and ep_comm is not None:
        for lay in grads["stage"]:
            lay["gate"] = ep_comm.allreduce(lay["gate"])
    return _sgd(params, grads, lr), loss


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
