"""coll/torch — the device collective component.

The counterpart of the JAX package's ``coll/xla``: a collective on a
stacked ``(N, *local)`` tensor lowers to tensor operations over dim 0 on
the communicator's device, with the same shape contract:

- allreduce           (N, *s) -> (N, *s), every row the reduction.
- reduce              (N, *s) -> (N, *s), root's row significant.
- bcast               (N, *s) -> (N, *s): root's row to every row.
- allgather / gather  (N, *s) -> (N, N, *s): out[r, j] = in[j] (gather:
  root's row significant).
- scatter             (N, N, *s) -> (N, *s): out[r] = in[root, r].
- alltoall            (N, N, *s) -> (N, N, *s): out[j, i] = in[i, j].
- reduce_scatter_block (N, N, *s) -> (N, *s): out[r] = reduce_i in[i, r].
- scan / exscan       inclusive / exclusive prefix over dim 0 (rank 0's
  exscan row keeps the prefix's row 0, as ``coll/xla`` does).
- barrier             a token collective, then the device drains.

**Algorithm selection** ports ``coll/xla.py:184-232,1199-1658``: per
call, the ``coll_torch_<func>_algorithm`` var wins; ``auto`` asks
``coll/decision`` (rows keyed by :func:`decision.platform_key` of the
communicator's device) and the tuned dynamic-rules file; structural
rules demote to ``direct`` (``REORDERING`` for non-commutative ops,
``POW2_ONLY``, ``EVEN_ONLY``), and each collective's dispatch adds its
own (rabenseifner and hier reduce_scatter_block only for sums,
scatter_allgather only for arithmetic dtypes, ...). An unknown name
runs the direct lowering. The decision for a (func, shape, dtype, op,
root) is memoized against the var epoch (``_fast``); :meth:`selected`
reports what ran.

**The schedules** port ``coll/xla.py:234-1196``. The reference's
``shard_map`` body sees one rank's block; here every rank is a row of
one tensor, so:

- ``axis_index`` is a column of ranks; a per-rank condition becomes the
  set of rows it holds for, computed on the host when the schedule is
  built (the rank count and the root are static there too).
- ``ppermute`` is a gather over the rank dim: a full cyclic shift is
  ``roll``; a partial permute copies only the rows that receive, which
  are the rows the reference's ``where`` keeps (its zero-filled rows are
  never read).
- a local axis moves one place right (chunk axis = dim 1).
- ``psum`` / ``psum_scatter`` are sums over the rank dim (within a
  group: over a view of contiguous rank blocks); ``all_gather`` is a
  materialized expand; ``all_to_all`` a transpose.
- combines that the reference makes with ``op.fn`` are made with
  ``op.fn`` on the same operands in the same order (ring,
  ring_segmented, recursive_doubling, in_order_binary, knomial reduce,
  recursive_halving, butterfly, rd scan), so their results equal the
  reference's bit for bit; where the reference leaves the order to XLA
  (``psum``: rabenseifner, rabenseifner_root, hier, direct) the port
  sums with ``torch.sum``.

Each built schedule (a closure over its index tensors on the device) is
held in a bounded LRU (``coll_torch_cache_max_entries``). A schedule
writes only into buffers it allocated: a result never aliases an input
or another rank's row.

**Across controllers** (``core/multictl``; the reference's multi-process
mesh): on a communicator whose rows sit in several controller processes,
a buffer is this controller's rows (``multictl.Rows``). The explicit
schedules run there as on one controller, written once over the rank
axis (:class:`_Axis`): a step that takes other ranks' rows (a ``roll``,
an index, a tree round) is a ``multictl.Take``, which reads the rows
held here and takes the others in one round of the hidden controller
tier (``RankCommunicator``'s device slots: CUDA IPC on the card, shared
memory on the CPU); a step whose sources all sit with their
destinations makes no round, and a controller ships only what another
asks for. So a forced schedule runs and is what ``selected`` reports,
after the same demotions as on one controller, and gives the bits the
stacked schedule gives. ``direct`` and ``hier`` are one exchange:
reductions fold locally before they cross, so a controller ships one
partial, never all its rows (allreduce, reduce, reduce_scatter_block,
scan), and after the local stage a controller holds what the hier
schedule's scattered chunks would carry over the slow tier, so
``selected`` reports ``hier`` where the multihost rows pick it and the
one body runs. ``_groups`` are the controllers' rank sets (``low``) and
one rank per controller (``high``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import profiler as _prof

from ompi_tpu_torch.coll import decision, tuned
from ompi_tpu_torch.coll.framework import coll_framework
from ompi_tpu_torch.core import convertor, multictl
from ompi_tpu_torch.core import op as op_mod
from ompi_tpu_torch.core.multictl import Rows
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.mca.base import Component
from ompi_tpu_torch.ops import bucket_fold
from ompi_tpu_torch.trace import core as _trace

# The reference's enumerators (coll/xla.py:1664-1759), per collective:
# "auto", then the symmetric lowering ("direct", or reduce's and gather's
# aliases), then the explicit schedules.
ALGORITHMS: Dict[str, Tuple[str, ...]] = {
    "allreduce": ("auto", "direct", "ring", "ring_segmented", "hier",
                  "recursive_doubling", "rabenseifner"),
    "allgather": ("auto", "direct", "ring", "bruck", "sparbit", "hier",
                  "neighborexchange", "two_procs"),
    "bcast": ("auto", "direct", "binomial", "knomial", "chain", "pipeline",
              "scatter_allgather", "hier"),
    "alltoall": ("auto", "direct", "pairwise", "bruck"),
    "reduce": ("auto", "alias", "rabenseifner_root", "knomial",
               "in_order_binary"),
    "gather": ("auto", "allgather", "binomial"),
    "scatter": ("auto", "direct", "binomial"),
    "reduce_scatter_block": ("auto", "direct", "ring", "recursive_halving",
                             "butterfly", "hier"),
    "scan": ("auto", "direct", "recursive_doubling"),
    "barrier": ("auto", "direct", "dissemination", "tree", "hier"),
}

_HELP = {
    "allreduce": "direct one-shot reduction, explicit ring (whole-chunk "
                 "or segmented), two-level hier, recursive-doubling "
                 "butterfly, or Rabenseifner redscat+allgather (sums)",
    "allgather": "direct expand, neighbor-shift ring, Bruck doubling, "
                 "sparbit, two-level hier, neighbor exchange (even "
                 "sizes) or the two-rank exchange",
    "bcast": "direct row copy, binomial or 4-nomial tree, chain or "
             "segmented pipeline, scatter+allgather (arithmetic dtypes) "
             "or two-level hier",
    "alltoall": "direct transpose, pairwise exchange rounds or Bruck",
    "reduce": "allreduce alias, root-targeted redscat+binomial collect "
              "(sums), 4-nomial tree (commutative ops) or the in-order "
              "binary tree (rank-ordered combines)",
    "gather": "allgather alias or root-targeted binomial tree",
    "scatter": "direct row copy or root-targeted binomial fan-out",
    "reduce_scatter_block": "direct reduction, accumulating ring, "
                            "recursive halving (power-of-two sizes), "
                            "butterfly (any size) or two-level hier (sums)",
    "scan": "direct prefix or recursive-doubling partial exchange (also "
            "exscan)",
    "barrier": "direct token sum, dissemination, tree or two-level hier",
}


def _reduce0(x: torch.Tensor, op) -> torch.Tensor:
    """Reduce dim 0 with ``op``: the one-shot reduction where the op has
    one, else the ordered fold."""
    if op.xla_prim == "sum":
        return torch.sum(x, dim=0, dtype=x.dtype)
    if op.xla_prim == "max":
        return torch.amax(x, dim=0)
    if op.xla_prim == "min":
        return torch.amin(x, dim=0)
    return op.reduce_tree(x, axis=0)


def _prefix(x: torch.Tensor, op) -> torch.Tensor:
    """Inclusive prefix over dim 0. Fused prefix ops only for the
    *predefined* ops: a user op may reuse a predefined name but carry any
    combiner; it takes the ordered left fold."""
    if op.predefined:
        if op.name == "sum":
            return torch.cumsum(x, dim=0, dtype=x.dtype)
        if op.name == "prod":
            return torch.cumprod(x, dim=0, dtype=x.dtype)
        if op.name == "max":
            return torch.cummax(x, dim=0).values
        if op.name == "min":
            return torch.cummin(x, dim=0).values
    rows = [x[0]]
    for i in range(1, x.shape[0]):
        rows.append(op.fn(rows[-1], x[i]))
    return torch.stack(rows)


def _chunks(b: torch.Tensor, n: int, chunk: int) -> torch.Tensor:
    """(N, *s) -> (N, n, chunk): each row flattened and zero-padded to
    ``n`` chunks. A view of ``b`` when no padding is needed, so the
    schedules only read it."""
    flat = b.reshape(b.shape[0], -1)
    pad = n * chunk - flat.shape[1]
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(b.shape[0], n, chunk)


def _to_all(flat: torch.Tensor, shape) -> torch.Tensor:
    """One rank's result, flat, materialized in every row of ``shape``
    (an all_gather of identical rows)."""
    total = int(np.prod(shape[1:]))
    return (flat[:total].reshape(1, total).expand(shape[0], total)
            .contiguous().view(shape))


def _meta(x) -> torch.Tensor:
    """A shape-and-dtype carrier of ``x``'s global stack, for planning."""
    dt = x.dtype if isinstance(x.dtype, torch.dtype) else \
        torch.from_numpy(np.empty(0, x.dtype)).dtype
    return torch.empty(tuple(x.shape), dtype=dt, device="meta")


def _npad2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class _LruCache(OrderedDict):
    """Bounded schedule cache; the cap is ``coll_torch_cache_max_entries``,
    read at insertion so a running job can be re-bounded."""

    def __getitem__(self, key):
        val = super().__getitem__(key)
        self.move_to_end(key)
        return val

    def get(self, key, default=None):
        if key not in self:
            return default
        return self[key]

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.move_to_end(key)
        cap = max(1, int(var.var_get("coll_torch_cache_max_entries", 256)))
        while len(self) > cap:
            # __delitem__, not popitem: popitem re-enters the overridden
            # __getitem__ mid-unlink
            del self[next(iter(self))]


class _Axis:
    """The rank axis a schedule steps along: every rank's row of a
    single-controller comm, or this controller's rows of a comm spanning
    controllers. The schedules are written once over it: its steps take
    rows from other ranks (the reference's ``ppermute``), gather every
    row (``all_gather``) or every rank's column for its own rank
    (``all_to_all``).

    On one controller each step is the stacked tensor's own index or
    roll, the op the schedule ran before it was written over the axis.
    Across controllers a step is a planned ``multictl.Take``: rows held
    here are an ``index_select``, the others come in one tier round, and
    a step whose sources all sit with their destinations makes none.
    ``mine`` are the comm ranks of the rows held here (ascending), and
    per-rank index arrays of the schedules are cut to them (``col``,
    ``rows_of``)."""

    def __init__(self, mod: "TorchCollModule"):
        self._mod = mod
        self.n = mod.comm.size
        self.multi = mod._mc
        self.mine = (np.asarray(mod.comm.layout.mine, np.int64)
                     if self.multi else np.arange(self.n))
        self.lr = (mod._idx(np.arange(len(self.mine))) if self.multi
                   else mod._rows())

    def col(self, a) -> torch.Tensor:
        """A per-rank index array (ranks on its last axis), at the ranks
        held here, on the device."""
        return self._mod._idx(np.asarray(a)[..., self.mine])

    def rows_of(self, a) -> torch.Tensor:
        """A per-rank array (ranks on its first axis) at the ranks held
        here, on the device."""
        return self._mod._idx(np.asarray(a)[self.mine])

    def below(self, k: int) -> int:
        """How many of the rows held here belong to ranks below ``k``."""
        return int(np.count_nonzero(self.mine < k))

    def loc(self, rank: int) -> Optional[int]:
        """Rank ``rank``'s row position here (None: not held here)."""
        if not self.multi:
            return rank
        hit = np.nonzero(self.mine == rank)[0]
        return int(hit[0]) if len(hit) else None

    def _take(self, dst, src, pos=None) -> multictl.Take:
        comm = self._mod.comm
        return multictl.Take(comm.layout, self.n, dst, src, pos,
                             comm.device)

    def shift(self, k: int) -> Callable:
        """Row r takes row r - k (mod n): ``roll(k, 0)``. Called with
        several tensors of the same rows, they move together (one tier
        round)."""
        if not self.multi:
            def roll(*xs):
                if len(xs) == 1:
                    return xs[0].roll(k, 0)
                return tuple(x.roll(k, 0) for x in xs)
            return roll
        r = np.arange(self.n)
        return self._take(r, (r - k) % self.n)

    def get(self, src, dst=None, pos=None,
            single: Optional[Callable] = None) -> Callable:
        """Item k takes rank ``src[k]``'s row (its slice ``pos[k]`` along
        the row's first axis, where given); ``dst`` defaults to every
        rank in order, so the result's rows are the rows held here. On
        one controller ``single`` (the stacked form) runs where given,
        else ``x[src]`` (``x[src, pos]``)."""
        if not self.multi:
            if single is not None:
                return single
            S = self._mod._idx(src)
            if pos is None:
                return lambda x: x[S]
            P = self._mod._idx(pos)
            return lambda x: x[S, P]
        return self._take(np.arange(self.n) if dst is None else dst, src,
                          pos)

    def get_many(self, srcs, dst=None, pos=None) -> Callable:
        """``get`` of several source arrays over the same ``dst`` (and
        ``pos``), in one tier round; returns one tensor per array."""
        if not self.multi:
            gets = [self.get(s, pos=pos) for s in srcs]
            return lambda x: [g(x) for g in gets]
        d = np.arange(self.n) if dst is None else np.asarray(dst)
        k = len(srcs)
        take = self._take(np.tile(d, k), np.concatenate(srcs),
                          None if pos is None else np.concatenate(
                              [np.asarray(pos)] * k))

        def run(x):
            return list(take(x).chunk(k))
        return run

    def pull(self, dst, src, pos=None, single=None) -> Callable:
        """An in-place step ``buf[dst] = buf[src]`` (at ``pos`` where
        given: a vector takes one slice per item, a matrix ``(m, d)`` d
        slices), or ``buf[dst] = fn(buf[dst], buf[src])`` when called as
        ``step(buf, fn)``. ``single`` overrides the stacked form's
        (dst index, src index) pair."""
        mod = self._mod
        if not self.multi:
            if single is not None:
                D, S = single
            else:
                D, S = (mod._idx(dst),), (mod._idx(src),)
                if pos is not None:
                    P = mod._idx(pos)
                    if P.dim() == 2:
                        D, S = (D[0][:, None],), (S[0][:, None],)
                    D, S = D + (P,), S + (P,)

            def step(buf, fn=None):
                v = buf[S]
                buf[D] = v if fn is None else fn(buf[D], v)
            return step
        dst = np.asarray(dst, np.int64).reshape(-1)
        take = self._take(dst, src, pos)
        held = np.isin(dst, self.mine)
        at = np.searchsorted(self.mine, dst[held])
        D = (mod._idx(at),)
        if pos is not None:
            P = np.asarray(pos, np.int64)[held]
            D = ((D[0][:, None], mod._idx(P)) if P.ndim == 2
                 else D + (mod._idx(P),))
        some = bool(held.any())

        def step(buf, fn=None):
            v = take(buf)
            if some:
                buf[D] = v if fn is None else fn(buf[D], v)
        return step

    def all_rows(self) -> Callable:
        """Every rank's row in rank order (an ``all_gather``): each
        controller ships its rows once."""
        if not self.multi:
            return lambda x: x
        return self._mod._mc_gather_rows

    def reduce_cols(self, red: Callable, cols=None) -> Callable:
        """For each rank r held here, ``red`` over every rank's column
        ``cols[r]`` (default r) of an ``(L, n, *s)`` tensor (a
        ``psum_scatter``): on one controller ``red(x)[cols]``. Across
        controllers the columns cross in one all-to-all round, and ``red``
        runs on an ``(n, n, *s)`` tensor holding them at the columns they
        hold on one controller (zeros elsewhere): a reduction's order may
        depend on where an element sits in its tensor (vectorized body or
        tail), so this gives one controller's bits."""
        mod = self._mod
        C = None if cols is None else mod._idx(cols)
        if not self.multi:
            if C is None:
                return red
            return lambda x: red(x)[C]
        at = mod._idx((np.arange(self.n) if cols is None
                       else np.asarray(cols))[self.mine])

        def run(x):
            if C is not None:
                x = x[:, C]
            y = mod._mc_alltoall(x).transpose(0, 1)     # (n, L, *s)
            full = y.new_zeros((self.n, self.n) + tuple(y.shape[2:]))
            full[:, at] = y
            return red(full)[at]
        return run


class TorchCollModule:
    def __init__(self, comm):
        self.comm = comm
        self._cache: Dict[Tuple, Callable] = _LruCache()
        self._fast: Dict[Tuple, Tuple] = _LruCache()
        self._builds = 0                 # _entry's memo misses
        self._barrier_tokens: Dict[str, Tuple] = {}
        self._rows_t: Optional[torch.Tensor] = None
        # the comm's rows are fixed when it is built: a multiprocess
        # comm takes the cross-controller schedules
        self._mc = bool(getattr(comm, "is_multiprocess", False))
        self._ax: Optional[_Axis] = None

    # -- helpers ---------------------------------------------------------
    def _to_dev(self, x) -> torch.Tensor:
        dev = self.comm.device
        if isinstance(x, torch.Tensor):
            return x if x.device == dev else x.to(dev)
        return torch.tensor(np.asarray(x), device=dev)

    def _idx(self, a) -> torch.Tensor:
        """A host index array as an int64 tensor on the device (built
        once per schedule, never per call)."""
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64),
                               device=self.comm.device)

    def _rows(self) -> torch.Tensor:
        if self._rows_t is None:
            self._rows_t = self._idx(np.arange(self.comm.size))
        return self._rows_t

    # -- selection (coll/xla.py:184-232,536-540) --------------------------
    def _algorithm(self, func: str = "allreduce", nbytes: int = 0,
                   commute: bool = True) -> str:
        """The explicit MCA var wins; ``auto`` consults the decision
        tables plus the tuned dynamic-rules file. Structural constraints
        demote to ``direct``, as the reference's decision functions fall
        back to basic_linear."""
        alg = var.var_get(f"coll_torch_{func}_algorithm", "auto")
        if alg == "auto":
            dyn = tuned._load_rules(
                var.var_get("coll_tuned_dynamic_rules", ""))
            alg = decision.decide(
                func, self.comm.size, nbytes, self._multihost(), dyn,
                platform=decision.platform_key(self.comm.device))
        if (alg in decision.REORDERING and not commute
                and (func, alg) not in decision.ORDER_PRESERVING):
            return "direct"
        n = self.comm.size
        if (alg in decision.POW2_ONLY and (n & (n - 1)) != 0
                and (func, alg) not in decision.POW2_EXEMPT):
            return "direct"
        if alg in decision.EVEN_ONLY and n % 2 != 0:
            return "direct"
        return alg

    def _multihost(self) -> bool:
        """The communicator's rows sit on more than one controller."""
        return bool(getattr(self.comm, "spans_processes", False))

    def _groups(self):
        """(low, high) tiers for the hier schedules (coll/xla.py:200-229):
        ``low`` the ranks of each controller process (the fast tier),
        ``high`` one rank per controller (the slow tier). Within one
        controller, the balanced factorization: ``low`` contiguous rank
        blocks of the largest divisor <= sqrt(n). Controllers holding
        unequal row counts give (None, None): hier does not apply, and
        the schedules run direct."""
        n = self.comm.size
        if self._multihost():
            by: Dict[int, List[int]] = {}
            for r in range(n):
                by.setdefault(self.comm.controller_of(r), []).append(r)
            low = list(by.values())
        else:
            g = next(f for f in range(int(n ** 0.5), 0, -1) if n % f == 0)
            low = [list(range(i, i + g)) for i in range(0, n, g)]
        size = len(low[0])
        if any(len(gr) != size for gr in low):
            return None, None
        high = [[gr[i] for gr in low] for i in range(size)]
        return low, high

    def _nseg(self, chunk_bytes: int) -> int:
        """Segment count from ``coll_torch_segsize``; at most 8."""
        segsize = max(1, int(var.var_get("coll_torch_segsize", 1 << 20)))
        return max(1, min(8, -(-chunk_bytes // segsize)))

    def _entry(self, func: str, x: torch.Tensor, op=None,
               root: Optional[int] = None, plan: str = "_plan_") -> Tuple:
        """(epoch, fn, algorithm) for this call's (func, shape, dtype, op,
        root): one dict probe when warm. The epoch is read before the
        decision, so a rules-file reload during it re-decides once. A
        predefined op on uint16/32/64 plans the schedule for the signed
        twin and runs it between the twin's ``into`` and ``back`` maps
        (``op.unsigned_route``): every schedule below sees only types
        torch reduces. A memo miss counts in ``_builds``."""
        fk = (plan, func, x.shape, x.dtype,
              None if op is None else op.uid, root)
        ep = var.epoch()
        hit = self._fast.get(fk)
        if hit is None or hit[0] != ep:
            self._builds += 1
            route = op_mod.unsigned_route(x.dtype, op)
            if route is None:
                alg, fn = getattr(self, plan + func)(x, op, root)
            else:
                twin, into, back = route
                alg, inner = getattr(self, plan + func)(
                    x.view(twin), op, root)

                def fn(b, inner=inner, into=into, back=back):
                    return back(inner(into(b)))
            hit = self._fast[fk] = (ep, fn, alg)
        return hit

    def _built(self, key: Tuple, build: Callable[[], Callable]) -> Callable:
        fn = self._cache.get(key)
        if fn is None:
            fn = self._cache[key] = build()
        return fn

    def selected(self, func: str, x=None, op=None,
                 root: Optional[int] = None) -> str:
        """The algorithm ``func`` runs for this input: the var, the
        decision tables and every demotion applied. ``alias`` (reduce)
        and ``allgather`` (gather) mean the call delegates to allreduce /
        allgather, which select their own."""
        if func == "barrier":
            return self._barrier_alg()
        x = _meta(x) if self._mc else self._to_dev(x)
        return self._entry(func, x, op, root)[2]

    # -- allreduce schedules ----------------------------------------------
    def _ring_allreduce_inner(self, op, n, shape, codec=None):
        """Explicit ring (coll/xla.py:234-318): n-1 reduce-scatter steps
        then n-1 allgather steps over the flattened rows padded to n
        chunks; any op (the chunk combine is ``op.fn``). A rank's partial
        of step t is what it sends in step t+1, so the reduce-scatter
        carries it instead of a whole buffer. Across controllers a step
        ships one chunk per controller boundary.

        ``codec`` (a ``(Codec, block)`` pair, from ``coll/compressed``)
        quantizes every hop: in the reduce-scatter each rank's outgoing
        partial is quantized per rank row, the codes and scales move, and
        the receiver dequantizes before ``op.fn(cur, recvd)``; the
        finished chunk is quantized once, its owner's row is its own
        dequantized image, and the codes are forwarded losslessly through
        the allgather steps, so every rank ends bitwise identical. Blocks
        are padded per chunk row, as ``jnp_quant`` pads each chunk."""
        ax = self._axis()
        total = int(np.prod(shape))
        chunk = -(-total // n)
        r = np.arange(n)
        t = np.arange(n - 1)[:, None]
        rows = ax.lr
        mine = ax.col(r)
        tgt = ax.col((r - t - 1) % n)            # step t combines here
        own = ax.col((r + 1) % n)                # fully reduced chunk
        ag = ax.col((r - t) % n)                 # allgather slot, step t
        step = ax.shift(1)
        if codec is not None:
            cobj, cblock = codec

        def inner(b):
            buf = _chunks(b, n, chunk)
            acc = buf[rows, mine]                # chunk r goes first
            for s in range(n - 1):
                if codec is None:
                    recvd = step(acc)
                else:
                    qc, qs = step(*cobj.torch_quant_rows(acc, cblock))
                    recvd = cobj.torch_dequant_rows(qc, qs, chunk,
                                                    acc.dtype, cblock)
                acc = op.fn(buf[rows, tgt[s]], recvd)
            out = buf.new_empty(buf.shape)
            if codec is None:
                out[rows, own] = acc
                for s in range(n - 1):
                    acc = step(acc)
                    out[rows, ag[s]] = acc
            else:
                qc, qs = cobj.torch_quant_rows(acc, cblock)
                out[rows, own] = cobj.torch_dequant_rows(qc, qs, chunk,
                                                         acc.dtype, cblock)
                for s in range(n - 1):
                    qc, qs = step(qc, qs)
                    out[rows, ag[s]] = cobj.torch_dequant_rows(
                        qc, qs, chunk, acc.dtype, cblock)
            return out.reshape(b.shape[0], -1)[:, :total].reshape(b.shape)
        return inner

    def _ring_segmented_allreduce_inner(self, op, n, shape, nseg,
                                        codec=None):
        """Segmented ring (coll/xla.py:504-535): ``nseg`` independent
        ring chains, one per segment of the flattened rows; ``codec``
        quantizes every hop of every chain."""
        total = int(np.prod(shape))
        seglen = -(-total // nseg)
        ring = self._ring_allreduce_inner(op, n, (seglen,), codec)

        def inner(b):
            x = b.reshape(b.shape[0], -1)
            if nseg * seglen != total:
                x = F.pad(x, (0, nseg * seglen - total))
            outs = [ring(x[:, s * seglen:(s + 1) * seglen])
                    for s in range(nseg)]
            return torch.cat(outs, 1)[:, :total].reshape(b.shape)
        return inner

    def _rd_allreduce_inner(self, op, n):
        """Recursive doubling (coll/xla.py:542-560): log2(n) exchanges
        with partner r ^ d, each pair combining (lower rank, higher
        rank), so every rank holds the same bits. Power-of-two sizes."""
        ax = self._axis()
        rounds = []
        r = np.arange(n)
        d = 1
        while d < n:
            rounds.append(ax.get_many([np.minimum(r, r ^ d),
                                       np.maximum(r, r ^ d)]))
            d *= 2

        def inner(b):
            x = b
            for pair in rounds:
                x = op.fn(*pair(x))
            return b.clone() if x is b else x
        return inner

    def _rabenseifner_inner(self, op, n, shape):
        """Rabenseifner's redscat+allgather (coll/xla.py:562-580): each
        rank reduces 1/n of the buffer, then the chunks are gathered.
        Sums only (selection demotes others)."""
        ax = self._axis()
        chunk = -(-int(np.prod(shape)) // n)
        scatter = ax.reduce_cols(lambda y: _reduce0(y, op))
        gather = ax.all_rows()

        def inner(b):
            part = scatter(_chunks(b, n, chunk))        # part[r]: rank r's
            return _to_all(gather(part).reshape(-1), b.shape)
        return inner
    def _hier_allreduce_inner(self, op, low, high, codec=None):
        """Two-level (coll/xla.py:319-398): reduce-scatter within each low
        group, a reduce-scatter + allgather of the scattered chunk over
        the high groups, an allgather within the low group. Sums go
        through the psum tiers; other ops gather and fold each tier.

        ``codec`` (sums only; ``coll/compressed`` gates) is the
        reference's ``inner_q``: the low tiers stay full width, and only
        the scattered chunk that crosses the high tier is quantized; each
        position class gathers the codes of its high group and folds the
        dequantized contributions in fixed group order, so its members
        end bitwise identical."""
        glen, H = len(low[0]), len(low)
        if codec is not None:
            cobj, cblock = codec

            def inner_q(b):
                total = b[0].numel()
                chunk = -(-total // glen)
                dt = b.dtype
                flat = _chunks(b, glen, chunk)          # (N, glen, chunk)
                # rank (g, k) holds group g's sum of chunk k
                part = flat.reshape(H, glen, glen, chunk).sum(1, dtype=dt)
                qc, qs = cobj.torch_quant_rows(part, cblock)
                # position class k folds groups 0..H-1 in order
                acc = cobj.torch_dequant_rows(qc[0], qs[0], chunk, dt,
                                              cblock)
                for h in range(1, H):
                    acc = op.fn(acc, cobj.torch_dequant_rows(
                        qc[h], qs[h], chunk, dt, cblock))
                # allgather within the low group: chunk k from position k
                return _to_all(acc.reshape(-1), b.shape)
            return inner_q

        def inner(b):
            total = b[0].numel()
            chunk = -(-total // glen)
            flat = _chunks(b, glen, chunk)              # (N, glen, chunk)
            if op.xla_prim == "sum":
                dt = b.dtype
                # rank (g, k) holds group g's sum of chunk k
                part = flat.reshape(H, glen, glen, chunk).sum(1, dtype=dt)
                sub = -(-chunk // H)
                p_hi = F.pad(part, (0, H * sub - chunk)).reshape(
                    H, glen, H, sub)
                # rank (g, k) holds the sum over groups of sub-chunk g
                p2 = p_hi.sum(0, dtype=dt)              # [k, g]
                # allgather over the high group, then over the low group
                part = p2.reshape(glen, H * sub)[:, :chunk]
                out = part.reshape(-1)
            else:
                red = op.reduce_tree(flat.reshape(H, glen, glen * chunk),
                                     axis=1)
                out = op.reduce_tree(red, axis=0)
            return _to_all(out, b.shape)
        return inner

    def _plan_allreduce(self, x, op, root):
        n = self.comm.size
        alg = self._algorithm("allreduce", x.nbytes // n, op.commute)
        if alg == "rabenseifner" and op.xla_prim != "sum":
            alg = "direct"
        if alg not in ALGORITHMS["allreduce"][2:] or (
                alg == "hier" and self._groups()[0] is None):
            alg = "direct"
        if self._mc and alg in ("direct", "hier"):
            return alg, self._mc_allreduce_body(op)
        # nseg is part of the schedule's identity: a segsize change
        # builds a new one
        nseg = (self._nseg(x.nbytes // (n * n))
                if alg == "ring_segmented" else 0)
        shape = tuple(x.shape[1:])

        def build():
            if alg == "ring":
                return self._ring_allreduce_inner(op, n, shape)
            if alg == "ring_segmented":
                return self._ring_segmented_allreduce_inner(op, n, shape,
                                                            nseg)
            if alg == "hier":
                return self._hier_allreduce_inner(op, *self._groups())
            if alg == "recursive_doubling":
                return self._rd_allreduce_inner(op, n)
            if alg == "rabenseifner":
                return self._rabenseifner_inner(op, n, shape)
            return lambda b: _reduce0(b, op).expand(b.shape).contiguous()
        return alg, self._built(("allreduce", alg, shape, op.uid, nseg),
                                build)

    # -- reduce schedules -------------------------------------------------
    def _tree_reduce(self, op, rounds, root):
        """Apply ``rounds`` of (dst rows, src rows) ``acc[dst] =
        op.fn(acc[dst], acc[src])``; then root's row takes rank 0's
        accumulator when ``root`` is given. Every row keeps its partial,
        as in the reference."""
        ax = self._axis()
        steps = [ax.pull(d, s) for d, s in rounds]
        last = (ax.pull([root], [0], single=((root,), (0,))) if root
                else None)

        def inner(b):
            acc = b.clone()
            for step in steps:
                step(acc, op.fn)
            if last is not None:
                last(acc)
            return acc
        return inner

    def _in_order_binary_reduce_inner(self, op, n, root):
        """In-order binary tree (coll/xla.py:624-648): at distance d, rank
        r with r % 2d == 0 folds rank r+d's accumulator on its RIGHT, so
        the combine order is rank order (non-commutative ops). The
        result lands on rank 0 and moves to root."""
        rounds = []
        d = 1
        while d < n:
            dst = np.array([r for r in range(n)
                            if r % (2 * d) == 0 and r + d < n])
            rounds.append((dst, dst + d))
            d *= 2
        return self._tree_reduce(op, rounds, root)

    def _knomial_reduce_inner(self, op, n, root, radix=4):
        """K-nomial reduce (coll/xla.py:751-774): at level ``step``,
        virtual rank vr = j*step (mod radix*step) ships its subtree's
        accumulation to vr - j*step. Commutative ops only."""
        vr_rank = (np.arange(n) + root) % n          # rank of virtual rank
        rounds = []
        step = 1
        while step < n:
            for j in range(1, radix):
                if j * step >= n:
                    break
                v = np.array([v for v in range(n)
                              if v % (radix * step) == 0
                              and v + j * step < n])
                rounds.append((vr_rank[v], vr_rank[v + j * step]))
            step *= radix
        return self._tree_reduce(op, rounds, None)

    def _collect_rounds(self, n, root):
        """Binomial collect toward root (the gather side of
        coll/xla.py:1093-1164): per round, the step ``buf[dst, pos] =
        buf[src, pos]`` — at distance d, virtual rank vs = d (mod 2d)
        hands its d positions [vs, vs+d) to vs-d."""
        ax = self._axis()
        npad = _npad2(n)
        rounds = []
        d = 1
        while d < npad:
            vs = np.arange(d, n, 2 * d)
            if len(vs):
                pos = vs[:, None] + np.arange(d)[None, :]
                rounds.append(ax.pull((vs - d + root) % n,
                                      (vs + root) % n, pos))
            d *= 2
        return rounds

    def _rabenseifner_root_reduce_inner(self, n, root, shape):
        """Root-targeted redscat + binomial collect (coll/xla.py:
        1093-1131): each rank reduces the chunk of its virtual rank
        v = (r - root) mod n, then the chunks collect into root along a
        binomial tree. Sums only; root's row significant, the others
        zero."""
        ax = self._axis()
        total = int(np.prod(shape))
        chunk = -(-total // n)
        npad = _npad2(n)
        vr = (np.arange(n) - root) % n
        v = ax.col(vr)
        rows = ax.lr
        rounds = self._collect_rounds(n, root)
        at = ax.loc(root)
        # rank r's part: chunk v_r summed over every rank
        scatter = ax.reduce_cols(
            lambda y: torch.sum(y, dim=0, dtype=y.dtype), vr)

        def inner(b):
            part = scatter(_chunks(b, n, chunk))
            buf = b.new_empty((b.shape[0], npad, chunk))
            buf[rows, v] = part                    # rank r holds chunk v_r
            for step in rounds:
                step(buf)
            out = torch.zeros_like(b)
            if at is not None:
                out[at] = buf[at, :n].reshape(-1)[:total].view(shape)
            return out
        return inner

    def _plan_reduce(self, x, op, root):
        n = self.comm.size
        alg = self._algorithm("reduce", x.nbytes // n, op.commute)
        shape = tuple(x.shape[1:])
        if alg == "knomial" and n > 1:
            def build():
                return self._knomial_reduce_inner(op, n, root)
        elif alg == "in_order_binary" and n > 1:
            def build():
                return self._in_order_binary_reduce_inner(op, n, root)
        elif alg == "rabenseifner_root" and op.xla_prim == "sum" and n > 1:
            def build():
                return self._rabenseifner_root_reduce_inner(n, root, shape)
        else:
            # the alias, a demotion, or an unknown name: allreduce's
            # schedule, bound here (every row gets the reduction, root's
            # among them)
            return "alias", self._entry("allreduce", x, op)[1]
        return alg, self._built(("reduce", alg, shape, op.uid, root), build)

    # -- bcast schedules --------------------------------------------------
    def _tree_bcast(self, root, rounds):
        """Root's row, then ``rounds`` of (dst rows, src rows) row
        copies; every other row is written exactly once."""
        ax = self._axis()
        steps = [ax.pull(d, s) for d, s in rounds]
        at = ax.loc(root)

        def inner(b):
            out = torch.empty_like(b)
            if at is not None:
                out[at] = b[at]
            for step in steps:
                step(out)
            return out
        return inner

    def _binomial_bcast_inner(self, n, root):
        """Binomial tree (coll/xla.py:676-693): in round d, virtual ranks
        in [d, 2d) take the value from virtual rank - d."""
        rounds = []
        d = 1
        while d < n:
            v = np.arange(d, min(2 * d, n))
            rounds.append(((v + root) % n, (v - d + root) % n))
            d *= 2
        return self._tree_bcast(root, rounds)

    def _knomial_bcast_inner(self, n, root, radix=4):
        """K-nomial tree (coll/xla.py:694-721): top-down levels; at level
        ``step``, virtual rank vr = j*step (mod radix*step) takes the
        value from vr - j*step."""
        top = 1
        while top * radix < n:
            top *= radix
        rounds = []
        step = top
        while step >= 1:
            for j in range(1, radix):
                if j * step >= n:
                    break
                v = np.array([v for v in range(n)
                              if v % (radix * step) == j * step])
                rounds.append(((v + root) % n, (v - j * step + root) % n))
            step //= radix
        return self._tree_bcast(root, rounds)

    def _pipeline_bcast_inner(self, n, root, shape, nseg):
        """Chain/pipeline (coll/xla.py:722-750): the flattened row flows
        down the rank chain in ``nseg`` segments; at round t, virtual rank
        vr >= 1 takes segment t - vr + 1 from its predecessor. nseg == 1
        is the chain."""
        ax = self._axis()
        total = int(np.prod(shape))
        seg = -(-total // nseg)
        rounds = []
        for t in range(n - 2 + nseg):
            v = np.array([v for v in range(1, n) if 0 <= t - v + 1 < nseg])
            if len(v):
                rounds.append(ax.pull((v + root) % n, (v - 1 + root) % n,
                                      t - v + 1))
        at = ax.loc(root)

        def inner(b):
            buf = b.new_empty((b.shape[0], nseg * seg))
            if at is not None:
                buf[at, :total] = b[at].reshape(-1)
                buf[at, total:] = 0
            segs = buf.view(b.shape[0], nseg, seg)
            for step in rounds:
                step(segs)
            return buf[:, :total].reshape(b.shape)
        return inner

    def _scatter_allgather_bcast_inner(self, n, root, shape):
        """Scatter + allgather (coll/xla.py:860-879): rank r takes chunk r
        of root's row, then the chunks are gathered in every row. The
        reference scatters with a psum over a root-masked stack; its
        added zeros change no value but -0.0, and the port moves the
        chunks."""
        ax = self._axis()
        chunk = -(-int(np.prod(shape)) // n)
        r = np.arange(n)
        scatter = ax.get(np.full(n, root), pos=r, single=lambda b: _chunks(
            b[root:root + 1], n, chunk)[0])               # (n, chunk)
        gather = ax.all_rows()
        pre = (lambda b: _chunks(b, n, chunk)) if ax.multi else \
            (lambda b: b)

        def inner(b):
            part = gather(scatter(pre(b)))
            return _to_all(part.reshape(-1), b.shape)
        return inner

    def _hier_bcast_inner(self, root, low, high):
        """Two-tier bcast (coll/xla.py:399-437): root's value reaches the
        member of every low group at root's position along a binomial
        tree over those representatives, then each group copies its
        representative's row."""
        n = self.comm.size
        g_root = next(g for g, gr in enumerate(low) if root in gr)
        pos_root = low[g_root].index(root)
        reps = [gr[pos_root] for gr in low]
        ri = reps.index(root)
        order = reps[ri:] + reps[:ri]             # root first
        rounds = []
        k = 1
        while k < len(order):
            pairs = [(order[i + k], order[i]) for i in range(k)
                     if i + k < len(order)]
            rounds.append(([d for d, _ in pairs], [s for _, s in pairs]))
            k <<= 1
        rep_of = self._idx([low[r // len(low[0])][pos_root]
                            for r in range(n)])
        tree = self._tree_bcast(root, rounds)
        return lambda b: tree(b)[rep_of]

    def _plan_bcast(self, x, op, root):
        n = self.comm.size
        alg = self._algorithm("bcast", x.nbytes // n)
        if alg == "scatter_allgather" and x.dtype == torch.bool:
            alg = "direct"                 # arithmetic dtypes only
        if alg in ("chain", "pipeline") and n == 1:
            alg = "direct"
        if alg not in ALGORITHMS["bcast"][2:] or (
                alg == "hier" and self._groups()[0] is None):
            alg = "direct"
        if self._mc and alg in ("direct", "hier"):
            return alg, self._mc_bcast_body(root)
        nseg = (1 if alg == "chain"
                else self._nseg(x.nbytes // n) if alg == "pipeline" else 0)
        shape = tuple(x.shape[1:])

        def build():
            if alg == "hier":
                return self._hier_bcast_inner(root, *self._groups())
            if alg == "binomial":
                return self._binomial_bcast_inner(n, root)
            if alg == "knomial":
                return self._knomial_bcast_inner(n, root)
            if alg in ("chain", "pipeline"):
                return self._pipeline_bcast_inner(n, root, shape, nseg)
            if alg == "scatter_allgather":
                return self._scatter_allgather_bcast_inner(n, root, shape)
            return lambda b: b[root].expand(b.shape).contiguous()
        return alg, self._built(("bcast", alg, shape, None, root, nseg),
                                build)

    # -- allgather schedules ----------------------------------------------
    def _ring_allgather_inner(self, n):
        """Ring (coll/xla.py:582-604): n-1 neighbor shifts, each rank
        forwarding the block it received the step before."""
        ax = self._axis()
        r = np.arange(n)
        slot = ax.col((r - np.arange(n - 1)[:, None] - 1) % n)
        rows = ax.lr
        mine = ax.col(r)
        step = ax.shift(1)

        def inner(b):
            out = b.new_empty((b.shape[0], n) + b.shape[1:])
            out[rows, mine] = b
            cur = b
            for s in range(n - 1):
                cur = step(cur)
                out[rows, slot[s]] = cur
            return out
        return inner

    def _bruck_allgather_inner(self, n):
        """Bruck (coll/xla.py:605-623): ceil(log2 n) rounds doubling the
        forwarded block count (a partial last round for any n), then a
        rotation from relative to absolute rank order."""
        ax = self._axis()
        r = np.arange(n)
        rounds = []
        have = 1
        while have < n:
            rounds.append((ax.get((r + have) % n), min(have, n - have)))
            have += min(have, n - have)
        rows = ax.lr
        final = ax.rows_of((r[None, :] - r[:, None]) % n)

        def inner(b):
            buf = b.unsqueeze(1)           # blocks ordered r, r+1, ...
            for step, take in rounds:
                buf = torch.cat([buf, step(buf[:, :take])], 1)
            return buf[rows[:, None], final]
        return inner

    def _sparbit_allgather_inner(self, n):
        """Sparbit (coll/xla.py:649-675): distance-doubling exchange that
        writes each received block straight into its absolute slot,
        guided by the bitmap of held blocks (simulated here when the
        schedule is built, since it depends on n alone)."""
        ax = self._axis()
        have = np.eye(n, dtype=bool)
        rounds = []
        dist = 1
        while dist < n:
            rhave = np.roll(have, -dist, axis=0)    # rhave[j] = have[j+d]
            dst, col = np.nonzero(rhave & ~have)
            rounds.append(ax.pull(dst, (dst + dist) % n, col))
            have |= rhave
            dist *= 2
        rows = ax.lr
        mine = ax.col(np.arange(n))

        def inner(b):
            out = b.new_empty((b.shape[0], n) + b.shape[1:])
            out[rows, mine] = b
            for step in rounds:            # the bitmap fills every slot
                step(out)
            return out
        return inner

    def _neighborexchange_allgather_inner(self, n):
        """Neighbor exchange (coll/xla.py:775-820; even n): round 0 pairs
        exchange their block, each later round ships the two blocks
        learned last round to the alternating other neighbor."""
        ax = self._axis()
        owned = [[r] for r in range(n)]
        rounds = []
        for t in range(n // 2):
            if t == 0:
                peer = [r + 1 if r % 2 == 0 else r - 1 for r in range(n)]
                sendsets = [[r] for r in range(n)]
            else:
                if t % 2 == 1:
                    peer = [(r - 1) % n if r % 2 == 0 else (r + 1) % n
                            for r in range(n)]
                else:
                    peer = [(r + 1) % n if r % 2 == 0 else (r - 1) % n
                            for r in range(n)]
                sendsets = [owned[r][-2:] for r in range(n)]
            ridx = [sendsets[peer[r]] for r in range(n)]
            rounds.append(ax.pull(np.arange(n), peer, np.asarray(ridx)))
            owned = [owned[r] + [c for c in ridx[r] if c not in owned[r]]
                     for r in range(n)]
        rows = ax.lr
        mine = ax.col(np.arange(n))

        def inner(b):
            out = b.new_empty((b.shape[0], n) + b.shape[1:])
            out[rows, mine] = b
            for step in rounds:
                step(out)
            return out
        return inner

    def _two_procs_allgather_inner(self):
        """two_procs (coll/xla.py:821-834): one exchange; rank 0 stacks
        [me, peer], rank 1 [peer, me]."""
        ax = self._axis()
        swap = ax.get([1, 0], single=lambda b: b.flip(0))
        first = ax.below(1)                # rows of rank 0 held here

        def inner(b):
            other = swap(b)
            mine = torch.stack([b, other], 1)
            swapped = torch.stack([other, b], 1)
            return torch.cat([mine[:first], swapped[first:]])
        return inner

    def _hier_allgather_inner(self, low, high):
        """Two-tier allgather (coll/xla.py:464-488): gather position peers
        over the high tier, then the bundles within the low group, and
        reassemble rank order with a static index map."""
        glen, H = len(low[0]), len(low)
        n = glen * H
        pos_of = np.zeros(n, np.int64)
        grp_of = np.zeros(n, np.int64)
        for g, gr in enumerate(low):
            for k, r in enumerate(gr):
                pos_of[r], grp_of[r] = k, g
        pos_of, grp_of = self._idx(pos_of), self._idx(grp_of)

        def inner(b):
            s = b.shape[1:]
            g2 = b.reshape((H, glen) + s).transpose(0, 1)   # [k][g]
            one = g2[pos_of, grp_of]                        # (n, *s)
            return one.unsqueeze(0).expand((b.shape[0],) + one.shape) \
                .contiguous()
        return inner

    def _plan_allgather(self, x, op, root):
        n = self.comm.size
        alg = self._algorithm("allgather", x.nbytes // n)
        if ((alg == "sparbit" and n == 1)
                or (alg == "two_procs" and n != 2)
                or alg not in ALGORITHMS["allgather"][2:]
                or (alg == "hier" and self._groups()[0] is None)):
            alg = "direct"
        if self._mc and alg in ("direct", "hier"):
            return alg, self._mc_allgather_body

        def build():
            if alg == "hier":
                return self._hier_allgather_inner(*self._groups())
            if alg == "ring":
                return self._ring_allgather_inner(n)
            if alg == "bruck":
                return self._bruck_allgather_inner(n)
            if alg == "sparbit":
                return self._sparbit_allgather_inner(n)
            if alg == "neighborexchange":
                return self._neighborexchange_allgather_inner(n)
            if alg == "two_procs":
                return self._two_procs_allgather_inner()
            return lambda b: b.expand((n,) + b.shape).contiguous()
        return alg, self._built(("allgather", alg, tuple(x.shape[1:])),
                                build)

    # -- gather / scatter (root-targeted) ---------------------------------
    def _binomial_gather_inner(self, n, root):
        """Binomial gather (coll/xla.py:1132-1164): log2(n) rounds of
        block-doubling copies toward root. Root's row significant, the
        others zero."""
        ax = self._axis()
        npad = _npad2(n)
        v = ax.col((np.arange(n) - root) % n)
        idx = self._idx((np.arange(n) - root) % n)   # vrank -> rank rows
        rows = ax.lr
        rounds = self._collect_rounds(n, root)
        at = ax.loc(root)

        def inner(b):
            s = b.shape[1:]
            buf = b.new_empty((b.shape[0], npad) + s)
            buf[rows, v] = b
            for step in rounds:
                step(buf)
            out = b.new_zeros((b.shape[0], n) + s)
            if at is not None:
                out[at] = buf[at, idx]
            return out
        return inner

    def _binomial_scatter_inner(self, n, root):
        """Binomial scatter (coll/xla.py:1165-1197): root's n blocks fan
        out in log2(n) block-halving rounds; at distance d, virtual rank
        vs = 0 (mod 2d) hands positions [vs+d, vs+2d) to vs+d."""
        ax = self._axis()
        npad = _npad2(n)
        v = ax.col((np.arange(n) - root) % n)
        order = self._idx((np.arange(npad) + root) % n)  # rank -> vrank
        rows = ax.lr
        rounds = []
        d = npad // 2
        while d >= 1:
            vs = np.array([u for u in range(0, n, 2 * d) if u + d < n])
            if len(vs):
                pos = vs[:, None] + d + np.arange(d)[None, :]
                rounds.append(ax.pull((vs + d + root) % n, (vs + root) % n,
                                      pos))
            d //= 2
        at = ax.loc(root)

        def inner(b):
            buf = b.new_empty((b.shape[0], npad) + b.shape[2:])
            if at is not None:
                buf[at] = b[at, order]
            for step in rounds:
                step(buf)
            return buf[rows, v]
        return inner

    def _plan_gather(self, x, op, root):
        n = self.comm.size
        alg = self._algorithm("gather", x.nbytes // n)
        if alg != "binomial" or n == 1:
            # alias (and unknown names): allgather's schedule, bound here
            return "allgather", self._entry("allgather", x)[1]
        return alg, self._built(
            ("gather", alg, tuple(x.shape[1:]), None, root),
            lambda: self._binomial_gather_inner(n, root))

    def _plan_scatter(self, x, op, root):
        n = self.comm.size
        alg = self._algorithm("scatter", x.nbytes // n)
        if alg != "binomial" or n == 1:
            if self._mc:
                return "direct", self._mc_scatter_body(root)
            return "direct", lambda b: b[root].clone()
        return alg, self._built(
            ("scatter", alg, tuple(x.shape[1:]), None, root),
            lambda: self._binomial_scatter_inner(n, root))

    # -- alltoall schedules -----------------------------------------------
    def _pairwise_alltoall_inner(self, n):
        """Pairwise exchange (coll/xla.py:880-900): in round t, rank r
        sends its block for r+t and receives from r-t."""
        ax = self._axis()
        r = np.arange(n)
        rows = ax.lr
        mine = ax.col(r)
        rounds = [(ax.shift(t), ax.col((r + t) % n), ax.col((r - t) % n))
                  for t in range(1, n)]

        def inner(b):
            out = torch.empty_like(b)
            out[rows, mine] = b[rows, mine]
            for step, send, slot in rounds:
                out[rows, slot] = step(b[rows, send])
            return out
        return inner

    def _bruck_alltoall_inner(self, n):
        """Bruck (coll/xla.py:1014-1038): rotate each row's blocks by the
        rank, in round k ship every block whose index has bit k set to
        rank r+k, then un-rotate and reverse into source order."""
        ax = self._axis()
        r = np.arange(n)
        rows = ax.lr
        first = ax.rows_of((r[:, None] + r[None, :]) % n)
        last = ax.rows_of((r[:, None] - r[None, :]) % n)
        rounds = []
        k = 1
        while k < n:
            cols = np.array([i for i in range(n) if i & k])
            src = (r - k) % n
            rounds.append(ax.pull(
                r, src, np.tile(cols, (n, 1)),
                single=((slice(None), self._idx(cols)),
                        (self._idx(src)[:, None], self._idx(cols)))))
            k <<= 1

        def inner(b):
            y = b[rows[:, None], first]        # y[r, i]: data for r+i
            for step in rounds:
                step(y)
            return y[rows[:, None], last]
        return inner

    def _plan_alltoall(self, x, op, root):
        n = self.comm.size
        alg = self._algorithm("alltoall", x.nbytes // n)
        if (alg == "bruck" and n == 1) or \
                alg not in ALGORITHMS["alltoall"][2:]:
            alg = "direct"
        if self._mc and alg == "direct":
            return alg, self._mc_alltoall

        def build():
            if alg == "pairwise":
                return self._pairwise_alltoall_inner(n)
            if alg == "bruck":
                return self._bruck_alltoall_inner(n)
            return lambda b: b.transpose(0, 1).contiguous()
        return alg, self._built(("alltoall", alg, tuple(x.shape[1:])),
                                build)

    # -- reduce_scatter_block schedules -----------------------------------
    def _ring_reduce_scatter_inner(self, op, n):
        """Ring (coll/xla.py:901-929): n-1 accumulating shifts; rank r
        ends owning reduced chunk r. The partial a rank combines in step
        t is what it sends in step t+1."""
        ax = self._axis()
        r = np.arange(n)
        rows = ax.lr
        first = ax.col((r - 1) % n)
        tgt = ax.col((r - np.arange(n - 1)[:, None] - 2) % n)
        step = ax.shift(1)

        def inner(b):
            acc = b[rows, first]
            for s in range(n - 1):
                acc = op.fn(b[rows, tgt[s]], step(acc))
            return acc
        return inner

    def _halving_rounds(self, n):
        """Per round of vector halving over ranks 0..n-1 (n a power of
        two): the step that takes (lower rank's, upper rank's) half of
        the pair, the half the rank keeps (its block's half)."""
        ax = self._axis()
        r = np.arange(n)
        rounds = []
        d = n // 2
        while d >= 1:
            rounds.append(ax.get_many([np.minimum(r, r ^ d),
                                       np.maximum(r, r ^ d)], r,
                                      ((r & d) != 0).astype(np.int64)))
            d //= 2
        return rounds

    @staticmethod
    def _halve(op, x, rounds):
        """Vector halving: each pair folds (lower rank's half, upper
        rank's half) of the half the rank keeps (its block's half)."""
        for pair in rounds:
            xs = x.reshape((x.shape[0], 2, x.shape[1] // 2) + x.shape[2:])
            x = op.fn(*pair(xs))
        return x

    def _rhalving_rsb_inner(self, op, n):
        """Recursive halving (coll/xla.py:930-958): log2(n) rounds
        swapping the half not holding the rank's own block with partner
        r ^ d. Power-of-two sizes."""
        rounds = self._halving_rounds(n)
        return lambda b: self._halve(op, b, rounds)[:, 0]

    def _butterfly_rsb_inner(self, op, n):
        """Butterfly (coll/xla.py:959-1013): halving for any n. Ranks
        beyond the largest power of two n2 fold their vector into a
        proxy (rank - n2), the core halves a zero-padded 2*n2-block
        vector, and core rank q ships blocks 2q and 2q+1 to their
        owners."""
        ax = self._axis()
        n2 = 1
        while n2 * 2 <= n:
            n2 *= 2
        rem = n - n2
        rounds = self._halving_rounds(n2)
        if rem:
            fold = ax.pull(np.arange(rem), np.arange(n2, n),
                           single=((slice(None, rem),), (slice(n2, n),)))
            core = ax.below(n2)                # core rows held here
            j = np.arange(n)
            home = ax.get(j // 2, pos=j % 2, single=lambda x: x.reshape(
                (2 * n2,) + x.shape[2:])[:n])

        def inner(b):
            if not rem:
                return self._halve(op, b, rounds)[:, 0]
            x = b.new_zeros((b.shape[0], 2 * n2) + b.shape[2:])
            x[:, :n] = b
            fold(x, op.fn)
            x = self._halve(op, x[:core], rounds)      # (n2, 2, *s)
            return home(x)
        return inner

    def _hier_rsb_inner(self, low, high):
        """Two-tier (coll/xla.py:438-463; sums): blocks pre-permuted so
        that member k's block holds the chunks of every group's position-k
        rank; a sum within the low group, then across the high group,
        leaves each rank its own chunk."""
        glen, H = len(low[0]), len(low)
        perm = self._idx([low[p][k] for k in range(glen) for p in range(H)])

        def inner(b):
            s = b.shape[2:]
            blocks = b[:, perm].reshape((H, glen, glen, H) + s)  # g,m,k,p
            part = blocks.sum(1, dtype=b.dtype)                  # g,k,p
            out = part.sum(0, dtype=b.dtype)                     # k,g
            return out.transpose(0, 1).reshape((b.shape[0],) + s)
        return inner

    def _plan_reduce_scatter_block(self, x, op, root):
        n = self.comm.size
        alg = self._algorithm("reduce_scatter_block", x.nbytes // n,
                              op.commute)
        if ((alg == "hier" and (op.xla_prim != "sum"
                                or self._groups()[0] is None))
                or (alg in ("recursive_halving", "butterfly") and n == 1)
                or alg not in ALGORITHMS["reduce_scatter_block"][2:]):
            alg = "direct"
        if self._mc and alg in ("direct", "hier"):
            return alg, self._mc_rsb_body(op)

        def build():
            if alg == "hier":
                return self._hier_rsb_inner(*self._groups())
            if alg == "ring":
                return self._ring_reduce_scatter_inner(op, n)
            if alg == "recursive_halving":
                return self._rhalving_rsb_inner(op, n)
            if alg == "butterfly":
                return self._butterfly_rsb_inner(op, n)
            return lambda b: _reduce0(b, op).contiguous()
        return alg, self._built(
            ("reduce_scatter_block", alg, tuple(x.shape[1:]), op.uid), build)

    # -- scan / exscan ----------------------------------------------------
    def _rd_scan_inner(self, op, n, exclusive: bool):
        """Recursive-doubling prefix (coll/xla.py:1039-1064): in round d
        ranks >= d fold the running value of rank r-d in front of their
        own (order-preserving, any n). The exclusive form shifts it up
        one rank; rank 0 keeps its own value, as the direct lowering."""
        ax = self._axis()
        rounds = []
        d = 1
        while d < n:
            r = np.arange(d, n)
            rounds.append((ax.get(r - d, r, single=(
                lambda a, d=d: a[:n - d])), ax.below(d)))
            d *= 2
        shift = ax.get(np.maximum(np.arange(n) - 1, 0), single=(
            lambda a: torch.cat([a[:1], a[:-1]])))

        def inner(b):
            acc = b
            for prev, k in rounds:
                acc = torch.cat([acc[:k], op.fn(prev(acc), acc[k:])])
            if exclusive:
                return shift(acc)
            return acc
        return inner

    def _plan_scan(self, x, op, root, exclusive=False):
        n = self.comm.size
        alg = self._algorithm("scan", x.nbytes // n, op.commute)
        if alg != "recursive_doubling" or n == 1:
            alg = "direct"
        if self._mc and alg == "direct":
            return alg, lambda X: self._mc_prefix(X, op, exclusive)

        def build():
            if alg == "recursive_doubling":
                return self._rd_scan_inner(op, n, exclusive)
            if exclusive:
                def inner(b):
                    pre = _prefix(b, op)
                    return torch.cat([pre[:1], pre[:-1]])
                return inner
            return lambda b: _prefix(b, op).contiguous()
        func = "exscan" if exclusive else "scan"
        return alg, self._built((func, alg, tuple(x.shape[1:]), op.uid),
                                build)

    def _plan_exscan(self, x, op, root):
        return self._plan_scan(x, op, root, exclusive=True)

    # -- barrier ----------------------------------------------------------
    def _tree_barrier_inner(self, n):
        """Tree (coll/xla.py:835-859): binomial fan-in of token sums to
        rank 0, then binomial fan-out of the release."""
        ax = self._axis()
        fan_in, fan_out = [], []
        d = 1
        while d < n:
            dst = np.array([r for r in range(n)
                            if r % (2 * d) == 0 and r + d < n])
            fan_in.append(ax.pull(dst, dst + d))
            d *= 2
        d >>= 1
        while d >= 1:
            dst = np.array([r for r in range(n) if r % (2 * d) == d])
            fan_out.append(ax.pull(dst, dst - d))
            d >>= 1

        def add(a, b):
            return a + b

        def inner(t):
            t = t.clone()
            for step in fan_in:
                step(t, add)
            for step in fan_out:
                step(t)
            return t
        return inner

    def _dissemination_barrier_inner(self, n):
        """Dissemination (coll/xla.py:1065-1078): in round k each rank
        signals rank r + 2^k; token sums make every arrival a data
        dependency."""
        ax = self._axis()
        steps = []
        d = 1
        while d < n:
            steps.append(ax.shift(d))
            d *= 2

        def inner(t):
            for step in steps:
                t = t + step(t)
            return t
        return inner

    def _hier_barrier_inner(self, low, high):
        """Two-tier (coll/xla.py:489-503): sync within the group, across
        the position classes, then within the group again."""
        glen, H = len(low[0]), len(low)

        def inner(t):
            t = t.reshape(H, glen)
            t = t.sum(1, keepdim=True, dtype=t.dtype).expand(H, glen)
            t = t.sum(0, keepdim=True, dtype=t.dtype).expand(H, glen)
            t = t.sum(1, keepdim=True, dtype=t.dtype).expand(H, glen)
            return t.reshape(-1).contiguous()
        return inner

    def _barrier_alg(self) -> str:
        alg = self._algorithm("barrier", 4)
        if (alg == "tree" and self.comm.size == 1) or \
                alg not in ALGORITHMS["barrier"][2:] or (
                    alg == "hier" and self._groups()[0] is None):
            alg = "direct"
        return alg

    def _barrier_arrays(self):
        """The barrier's token collective, staged once per algorithm (the
        token and the schedule), so a call is its launches alone. Across
        controllers the token schedules step over this controller's rows
        and cross the controller tier; direct and hier are the tier's own
        barrier."""
        alg = self._barrier_alg()
        if self._mc and alg in ("direct", "hier"):
            self._mc_barrier()
            return [torch.ones(1, dtype=torch.int32, device=self.comm.device)]
        st = self._barrier_tokens.get(alg)
        if st is None:
            n = self.comm.size
            if alg == "hier":
                fn = self._hier_barrier_inner(*self._groups())
            elif alg == "tree":
                fn = self._tree_barrier_inner(n)
            elif alg == "dissemination":
                fn = self._dissemination_barrier_inner(n)
            else:
                def fn(t):
                    return t.sum(dtype=t.dtype).expand(n).contiguous()
            token = torch.ones(len(self._axis().mine), dtype=torch.int32,
                               device=self.comm.device)
            if not self._mc:
                fn(token)                      # warm
            st = self._barrier_tokens[alg] = (token, fn)
        token, fn = st
        if self._mc and self.comm.device.type == "cuda":
            # no controller leaves before its earlier work is done
            torch.cuda.synchronize(self.comm.device)
        return [fn(token)]

    # -- across controllers (core/multictl) --------------------------------
    # On a comm spanning controllers every plan maps this controller's
    # rows (``Rows.local``) to its rows of the result, and every
    # controller holding rows builds the same plan from the global shapes
    # (SPMD). The explicit schedules above step over the rank axis
    # (``_axis``); the bodies below are direct and hier, which are one
    # exchange: the local stage leaves one partial (or this controller's
    # rows) per controller, which is all that the hier schedule's
    # scattered chunks would carry over the slow tier.
    def _axis(self) -> _Axis:
        if self._ax is None:
            self._ax = _Axis(self)
        return self._ax

    def _mc_run(self, body: str, *args):
        """``body`` of the controller tier's device slots
        (``multictl.run``)."""
        return multictl.run(self.comm.layout, body, *args)

    def _mc_exchange(self, flat: torch.Tensor, cap: int, want, give):
        """One ragged round over the controller tier: write ``flat``,
        read ``want[g]`` of controller g's payload; controller g reads
        ``give[g]`` of ``flat`` (what a tier across hosts ships it)."""
        return self._mc_run("_device_exchange", flat, cap, want, give)

    def _mc_allreduce(self, part: torch.Tensor, op) -> torch.Tensor:
        """The controllers' partials folded in controller order."""
        return self._mc_run("_device_allreduce", part, op)

    def _mc_call(self, func: str, x, op=None, root=None):
        rows = self.comm._rows_of(x)
        if not self.comm._local:
            # no row here: this controller takes no part
            shape = tuple(rows.local.shape)
            if func in ("allgather", "gather"):
                shape = (0, self.comm.size) + shape[1:]
            elif func in ("scatter", "reduce_scatter_block"):
                shape = (0,) + shape[2:]
            return rows.like(rows.local.new_empty(shape))
        fn = self._entry(func, _meta(rows), op, root)[1]
        return rows.like(fn(rows.local))

    def mc_full(self, rows: Rows) -> torch.Tensor:
        """Every rank's row of a multi-controller buffer, in rank order,
        on this controller's device (the staged host path's readback)."""
        return self._mc_gather_rows(rows.local)

    def _mc_gather_rows(self, X: torch.Tensor) -> torch.Tensor:
        """(L, *s) local rows -> (N, *s) every rank's row in rank order:
        each controller ships its rows once."""
        lay = self.comm.layout
        per = int(np.prod(X.shape[1:], dtype=np.int64))
        esz = X.element_size()
        want = [(0, 0) if g == lay.h else (0, lay.sizes[g] * per)
                for g in range(len(lay.parts))]
        give = [(0, 0) if g == lay.h else (0, lay.sizes[lay.h] * per)
                for g in range(len(lay.parts))]
        got = self._mc_exchange(X.reshape(-1), max(lay.sizes) * per * esz,
                                want, give)
        blocks = [X if g == lay.h
                  else got[g].view((lay.sizes[g],) + tuple(X.shape[1:]))
                  for g in range(len(lay.parts))]
        full = torch.cat(blocks)
        if lay.ordered:
            return full
        return full[self._idx(lay.perm)]

    def _mc_concat(self, y: torch.Tensor) -> torch.Tensor:
        """``y``'s rank axis (dim 0) reordered into controller order (each
        controller's ranks contiguous)."""
        lay = self.comm.layout
        if lay.ordered:
            return y
        order = np.concatenate([list(p) for p in lay.parts])
        return y.index_select(0, self._idx(order))

    def _mc_expand(self, one: torch.Tensor, L: int) -> torch.Tensor:
        return one.unsqueeze(0).expand((L,) + tuple(one.shape)).contiguous()

    def _mc_fallback(self, op) -> bool:
        """A fold in controller order is not one in rank order: gather
        the rows and fold them in rank order instead."""
        return not op.commute and not self.comm.layout.ordered

    def _mc_allreduce_body(self, op):
        def inner(X):
            L = X.shape[0]
            if self._mc_fallback(op):
                return self._mc_expand(_reduce0(self._mc_gather_rows(X), op),
                                       L)
            # the local fold, then one partial per controller crosses
            return self._mc_expand(self._mc_allreduce(_reduce0(X, op), op),
                                   L)
        return inner

    def _mc_bcast_body(self, root):
        lay = self.comm.layout
        g_root = next(g for g, p in enumerate(lay.parts) if root in p)

        def inner(X):
            if lay.h == g_root:
                row = X[lay.mine.index(root)]
            else:
                row = X.new_empty(X.shape[1:])
            # root's controller writes the row once; the others read it,
            # then every local row takes it
            return self._mc_expand(self._mc_run("_device_bcast", row,
                                                g_root), X.shape[0])
        return inner

    def _mc_allgather_body(self, X):
        return self._mc_expand(self._mc_gather_rows(X), X.shape[0])

    def _mc_scatter_body(self, root):
        lay = self.comm.layout
        g_root = next(g for g, p in enumerate(lay.parts) if root in p)
        n = self.comm.size

        def inner(X):                          # (L, N, *s) -> (L, *s)
            s = tuple(X.shape[2:])
            if lay.h == g_root:
                R = X[lay.mine.index(root)]
                flat = self._mc_concat(R).reshape(-1)
            else:
                flat = X.new_empty((0,))
            per = int(np.prod(s, dtype=np.int64))
            want = [(0, 0)] * len(lay.parts)
            give = [(0, 0)] * len(lay.parts)
            if lay.h != g_root:
                want[g_root] = (int(lay.offs[lay.h]) * per,
                                int(lay.offs[lay.h + 1]) * per)
            else:
                give = [(0, 0) if g == g_root else
                        (int(lay.offs[g]) * per, int(lay.offs[g + 1]) * per)
                        for g in range(len(lay.parts))]
            got = self._mc_exchange(flat, n * per * X.element_size(), want,
                                    give)
            if lay.h == g_root:
                return R[self._idx(list(lay.mine))].clone()
            return got[g_root].view((X.shape[0],) + s)
        return inner

    def _mc_alltoall(self, X: torch.Tensor) -> torch.Tensor:
        """(L, N, *s) -> (L, N, *s): out[a, i] = rank i's chunk for my
        a-th rank. Each controller ships each other one block: its rows'
        chunks for that controller's ranks."""
        lay = self.comm.layout
        n = self.comm.size
        L, s = X.shape[0], tuple(X.shape[2:])
        per = int(np.prod(s, dtype=np.int64))
        G = len(lay.parts)
        others = [g for g in range(G) if g != lay.h]
        # block g: my rows' chunks for controller g's ranks
        send = torch.cat([X[:, self._idx(list(lay.parts[g]))].reshape(-1)
                          for g in others]) if others else X.new_empty(0)
        want, give = [], []
        for g in range(G):
            # controller g's block for me follows its blocks for the
            # controllers before me; my block for g, my blocks for the
            # others before g
            before = sum(lay.sizes[d] for d in range(G)
                         if d != g and d < lay.h)
            a = lay.sizes[g] * before * per
            want.append((0, 0) if g == lay.h
                        else (a, a + lay.sizes[g] * L * per))
            at = L * per * sum(lay.sizes[d] for d in others if d < g)
            give.append((0, 0) if g == lay.h
                        else (at, at + L * lay.sizes[g] * per))
        cap = max(lg * (n - lg) for lg in lay.sizes) * per * \
            X.element_size()
        got = self._mc_exchange(send, cap, want, give)
        # my rows' chunks for my own ranks, as the receivers see them
        mine = X[:, self._idx(list(lay.mine))].transpose(0, 1)
        blocks = [mine if g == lay.h else
                  got[g].view((lay.sizes[g], L) + s).transpose(0, 1)
                  for g in range(G)]
        out = torch.cat(blocks, 1)         # source ranks, in parts
        if not lay.ordered:
            out = out[:, self._idx(lay.perm)]
        return out.contiguous()

    def _mc_rsb_body(self, op):
        n = self.comm.size
        lay = self.comm.layout

        def inner(X):                          # (L, N, *s) -> (L, *s)
            mine = self._idx(list(lay.mine))
            if self._mc_fallback(op):
                return _reduce0(self._mc_gather_rows(X), op)[mine]
            s = tuple(X.shape[2:])
            per = int(np.prod(s, dtype=np.int64))
            P = _reduce0(X, op)                # (N, *s): the local fold
            want = [(0, 0) if g == lay.h else
                    (int(lay.offs[lay.h]) * per,
                     int(lay.offs[lay.h + 1]) * per)
                    for g in range(len(lay.parts))]
            give = [(0, 0) if g == lay.h else
                    (int(lay.offs[g]) * per, int(lay.offs[g + 1]) * per)
                    for g in range(len(lay.parts))]
            got = self._mc_exchange(self._mc_concat(P).reshape(-1),
                                    n * per * X.element_size(), want, give)
            parts = torch.stack([P[mine] if g == lay.h
                                 else got[g].view((len(lay.mine),) + s)
                                 for g in range(len(lay.parts))])
            return op.reduce_tree(parts, 0)    # controller (= rank) order
        return inner

    def _mc_prefix(self, X, op, exclusive: bool):
        """Scan across controllers: the local prefix, the controllers'
        totals cross, and each folds the totals before it in front."""
        lay = self.comm.layout
        if not lay.ordered:
            full = self._mc_gather_rows(X)
            pre = _prefix(full, op)
            if exclusive:
                pre = torch.cat([pre[:1], pre[:-1]])
            return pre[self._idx(list(lay.mine))]
        pre = _prefix(X, op)
        per = int(np.prod(X.shape[1:], dtype=np.int64))
        want = [(0, per) if g < lay.h else (0, 0)
                for g in range(len(lay.parts))]
        give = [(0, per) if g > lay.h else (0, 0)
                for g in range(len(lay.parts))]
        got = self._mc_exchange(pre[-1].reshape(-1),
                                per * X.element_size(), want, give)
        incl = pre
        if lay.h > 0:
            before = got[0].view(X.shape[1:])
            for g in range(1, lay.h):
                before = op.fn(before, got[g].view(X.shape[1:]))
            incl = op.fn(before.unsqueeze(0).expand_as(pre), pre)
        if not exclusive:
            return incl.contiguous()
        first = incl[:1] if lay.h == 0 else before.unsqueeze(0)
        return torch.cat([first, incl[:-1]])

    def _mc_barrier(self) -> None:
        """Drain this controller's device, then the tier's dissemination
        barrier: no controller leaves before every one's earlier work is
        done."""
        if self.comm.device.type == "cuda":
            torch.cuda.synchronize(self.comm.device)
        if self.comm._local:
            multictl.release()           # a held bucket drain goes first
            t = multictl.tier(self.comm.layout)
            t._check()
            t._coll_serial(lambda: t._dissemination(t._tag()))

    # -- collectives ------------------------------------------------------
    def _call(self, func: str, x, op=None, root: Optional[int] = None):
        """Select ``func``'s schedule for ``x`` and run it; traced, the
        run is a ``coll.body`` span (the launches of the schedule), with
        ``built=True`` where the selection built a schedule."""
        if self._mc:
            return self._mc_call(func, x, op, root)
        x = self._to_dev(x)
        if not (_trace.active or _prof._is_profiler_enabled):
            return self._entry(func, x, op, root)[1](x)
        builds = self._builds
        hit = self._entry(func, x, op, root)
        args = {"func": func, "algorithm": hit[2], "root": root,
                "bytes": x.numel() * x.element_size()}
        if self._builds != builds:
            args["built"] = True
        tok = _trace.begin("coll.body", **args)
        try:
            return hit[1](x)
        finally:
            _trace.end(tok)

    def allreduce(self, x, op):
        return self._call("allreduce", x, op)

    def folds(self, n: int, total: int, dtype, op) -> bool:
        """Whether ``allreduce_members`` computes the allreduce of an
        ``(n, total)`` bucket of ``dtype`` under ``op``: this process
        holds every row, the allreduce selected at that size is
        ``direct``, and the fold takes the op and dtype
        (``bucket_fold.takes``)."""
        if self._mc or not bucket_fold.takes(dtype, op):
            return False
        x = torch.empty((n, total), dtype=dtype, device="meta")
        return self._entry("allreduce", x, op)[2] == "direct"

    def allreduce_members(self, parts, table, out):
        """The direct allreduce of a bucket's members in one pass
        (``bucket_fold.fold``, under the op ``table`` was built for): each
        ``(n, w_i)`` part read in place, its reduction written into every
        rank's row of its block of ``out`` (``table.views``). The caller
        has asked ``folds``. Traced, one ``coll.body`` span, as ``_call``
        records."""
        if not (_trace.active or _prof._is_profiler_enabled):
            return bucket_fold.fold(parts, table, out)
        tok = _trace.begin("coll.body", func="allreduce", algorithm="direct",
                           root=None,
                           bytes=out.numel() * out.element_size())
        try:
            return bucket_fold.fold(parts, table, out)
        finally:
            _trace.end(tok)

    def allreduce_dtype(self, x, op, dt, count: int, preserve_gaps: bool):
        """Derived-datatype allreduce (``coll/xla.py:1266-1310``): gather
        the significant elements (``index_select``), reduce them through
        the selected allreduce schedule, and scatter the result
        (``index_copy_``) into ``x`` itself (``preserve_gaps``: the
        IN_PLACE recvbuf, whose holes stay as they were) or into zeros.
        The index tensors are the datatype's, copied to the device once;
        the schedule is resolved once per key, memoized against the var
        epoch like every other entry of ``_fast``."""
        x = self._to_dev(x)
        fk = ("allreduce_dt", x.shape, x.dtype, op.uid, dt.uid, count,
              preserve_gaps)
        ep = var.epoch()
        hit = self._fast.get(fk)
        if hit is None or hit[0] != ep:
            # the schedule the packed (N, ..., k) tensor selects; a meta
            # tensor carries its shape and dtype without memory
            red = self._entry("allreduce", torch.empty(
                x.shape[:-1] + (count * dt.count,), dtype=x.dtype,
                device="meta"), op)[1]

            def fn(b):
                r = red(convertor.pack(b, dt, count))
                base = b if preserve_gaps else torch.zeros_like(b)
                return convertor.unpack(base, r, dt, count)
            hit = self._fast[fk] = (ep, fn)
        return hit[1](x)

    def bind_allreduce(self, example, op):
        """Pre-bound hot-path handle (``MPI_Allreduce_init``'s point):
        the selection runs and the schedule is built and warmed on
        ``example`` once, here; the returned callable is the selected
        schedule alone."""
        if self._mc:
            self.allreduce(example, op)        # warm
            return lambda buf: self.allreduce(buf, op)
        x = self._to_dev(example)
        fn = self._entry("allreduce", x, op)[1]
        fn(x)                                  # warm
        return lambda buf: fn(self._to_dev(buf))

    def reduce(self, x, op, root: int):
        return self._call("reduce", x, op, root)

    def bcast(self, x, root: int):
        return self._call("bcast", x, None, root)

    def allgather(self, x):
        return self._call("allgather", x)

    def gather(self, x, root: int):
        return self._call("gather", x, None, root)

    def scatter(self, x, root: int):
        return self._call("scatter", x, None, root)

    def alltoall(self, x):
        return self._call("alltoall", x)

    def reduce_scatter_block(self, x, op):
        return self._call("reduce_scatter_block", x, op)

    def scan(self, x, op):
        return self._call("scan", x, op)

    def exscan(self, x, op):
        return self._call("exscan", x, op)

    def barrier(self) -> None:
        self._barrier_arrays()
        if self.comm.device.type == "cuda":
            torch.cuda.synchronize(self.comm.device)

    def _ibarrier_arrays(self):
        """The tensors backing an async barrier: the selected barrier's
        token. The event a request records after it marks every rank's
        work queued before it on the stream (the coll/nbc component owns
        the schedule-based MPI_Ibarrier slot). Across controllers the
        barrier completes on the controller tier before it returns."""
        return self._barrier_arrays()


class TorchCollComponent(Component):
    name = "torch"

    def register_params(self):
        var.var_register("coll", "torch", "priority", vtype="int", default=40,
                         help="Selection priority of the torch device "
                              "collective component")
        var.var_register(
            "coll", "torch", "cache_max_entries", vtype="int", default=256,
            help="Per-module cap on built schedules (each of the two "
                 "caches); least-recently-used entries evict beyond it")
        var.var_register(
            "coll", "torch", "segsize", vtype="int", default=1 << 20,
            help="Segment size in bytes for the segmented schedules "
                 "(ring_segmented allreduce, pipeline bcast): up to 8 "
                 "segments")
        # one literal registration per collective, so mpilint indexes
        # every coll_torch_<func>_algorithm name
        def alg(func):
            return {"enumerator": list(ALGORITHMS[func]),
                    "help": f"{func} lowering: {_HELP[func]} (auto: the "
                            f"decision tables)"}
        var.var_register("coll", "torch", "allreduce_algorithm", vtype="str",
                         default="auto", **alg("allreduce"))
        var.var_register("coll", "torch", "allgather_algorithm", vtype="str",
                         default="auto", **alg("allgather"))
        var.var_register("coll", "torch", "bcast_algorithm", vtype="str",
                         default="auto", **alg("bcast"))
        var.var_register("coll", "torch", "alltoall_algorithm", vtype="str",
                         default="auto", **alg("alltoall"))
        var.var_register("coll", "torch", "reduce_algorithm", vtype="str",
                         default="auto", **alg("reduce"))
        var.var_register("coll", "torch", "gather_algorithm", vtype="str",
                         default="auto", **alg("gather"))
        var.var_register("coll", "torch", "scatter_algorithm", vtype="str",
                         default="auto", **alg("scatter"))
        var.var_register("coll", "torch", "reduce_scatter_block_algorithm",
                         vtype="str", default="auto",
                         **alg("reduce_scatter_block"))
        var.var_register("coll", "torch", "scan_algorithm", vtype="str",
                         default="auto", **alg("scan"))
        var.var_register("coll", "torch", "barrier_algorithm", vtype="str",
                         default="auto", **alg("barrier"))

    def comm_query(self, comm):
        if comm is None:
            return None
        return (var.var_get("coll_torch_priority", 40), TorchCollModule(comm))


coll_framework.register(TorchCollComponent())
