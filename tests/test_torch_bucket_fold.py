"""The bucket fold (``ops/bucket_fold``) and the bucket flushes that take
it (``coll/persistent.BucketFuser``), on the CPU.

The plain fold is held bit for bit against a rank-order loop written
here in numpy (the same adds, in the same order and accumulation type)
and within a dtype's rounding of the float64 reduction. On an 8-rank
CPU world the fuser's flushes take the fold wherever the fused
allreduce would run ``direct`` on a predefined SUM, MAX or MIN of a float
dtype; every other flush keeps the pack / allreduce / unpack path, and
``coll_bucket_folds`` does not move. The CUDA kernel is held against
the plain fold on the card (``test_torch_bucket_fold_cuda.py``,
``chip_smoke.py --bucketfold``).
"""
import numpy as np
import pytest
import torch

import ompi_tpu_torch as P
from ompi_tpu_torch.coll import persistent
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.models import transformer as T
from ompi_tpu_torch.ops import bucket_fold as BF
from test_torch_perrank import run_job, write_prog

N = 8
FOLDS = ("coll_bucket_flushes", "coll_bucket_folds",
         "coll_bucket_fold_tables")
NP_OPS = {"sum": np.add, "max": np.maximum, "min": np.minimum}


@pytest.fixture()
def pworld():
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    var.var_set("mpi_base_bucket", True)
    var.var_set("mpi_base_bucket_bytes", 1 << 20)
    yield P.get_comm_world()
    P._reset_for_tests()


def _parts(n, widths, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((n, w), generator=g).to(dtype) for w in widths]


def _rank_order(p: torch.Tensor, op: str, dtype) -> np.ndarray:
    """Row 0, then each next row combined in, in numpy's float32
    (float64 for float64); rounded once to ``dtype`` by torch."""
    acc_np = np.float64 if dtype == torch.float64 else np.float32
    rows = p.to(torch.float64).numpy().astype(acc_np)
    acc = rows[0].copy()
    for r in range(1, rows.shape[0]):
        acc = NP_OPS[op](acc, rows[r])
    return torch.from_numpy(acc).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("widths", [(4, 1024, 12), (5, 3, 1027)],
                         ids=["mult4", "ragged"])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_plain_fold_is_the_rank_order_reduction(n, widths, op, dtype):
    parts = _parts(n, widths, dtype, seed=n + len(op))
    table = BF.Table(parts, op)
    out = torch.full((n * table.total,), float("nan"), dtype=dtype)
    assert BF.fold(parts, table, out) is out
    assert table.offsets == [0, widths[0], widths[0] + widths[1]]
    for p, block, w in zip(parts, table.views(out), widths):
        want = _rank_order(p, op, dtype)
        assert block.shape == (n * w,) and block.is_contiguous()
        view = block.view(n, w)
        for r in range(n):              # every rank's row, bit for bit
            assert torch.equal(view[r], want), (r, w)
        ref = NP_OPS[op].reduce(p.to(torch.float64).numpy(), axis=0)
        tol = {torch.float32: 1e-6, torch.float64: 1e-15,
               torch.bfloat16: 8e-3}[dtype] * n
        np.testing.assert_allclose(view[0].to(torch.float64).numpy(), ref,
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("op", ["max", "min"])
def test_plain_fold_max_min_propagate_nan(op):
    parts = _parts(4, (6,), torch.float32, seed=3)
    parts[0][2, 1] = float("nan")
    table = BF.Table(parts, op)
    out = BF.fold(parts, table, torch.empty(4 * 6))
    got = table.views(out)[0].view(4, 6)
    assert torch.isnan(got[:, 1]).all() and not torch.isnan(got[:, 0]).any()


def test_fold_bytes_and_what_the_fold_takes():
    assert BF.fold_bytes(8, 6_553_600, 4) == 2 * 8 * 6_553_600 * 4
    assert BF.takes(torch.float32, P.SUM) and BF.takes(torch.float16, P.MIN)
    assert not BF.takes(torch.int32, P.SUM)
    assert not BF.takes(torch.float32, P.PROD)
    assert not BF.takes(torch.float32, P.MINLOC)
    user = P.op_create(lambda a, b: a + b, True)
    assert not BF.takes(torch.float32, user)
    launched = BF.launches
    parts = _parts(2, (3,), torch.float32, seed=0)
    BF.fold(parts, BF.Table(parts, "sum"), torch.empty(6))
    assert BF.launches == launched      # the CPU takes the plain fold


def _ints(shape, seed, dtype=np.float32):
    """Integer-valued: every combine order is exact."""
    return np.random.default_rng(seed).integers(-8, 8, shape).astype(dtype)


def test_member_results_are_contiguous_views_of_one_output(pworld):
    xs = [_ints((N, 3, 5), 1), _ints((N, 7), 2), _ints((N, 4, 4), 3)]
    reqs = [pworld.allreduce_init(pworld.put(x), P.SUM) for x in xs]
    P.Startall(reqs)
    outs = [r.get() for r in reqs]
    c = persistent.counters()
    assert (c["coll_bucket_flushes"], c["coll_bucket_folds"]) == (1, 1)
    base = outs[0].untyped_storage().data_ptr()
    for x, o in zip(xs, outs):
        assert o.shape == x.shape and o.is_contiguous()
        assert o.untyped_storage().data_ptr() == base   # one flush output
        assert np.array_equal(o.numpy(), np.broadcast_to(x.sum(0), x.shape))
    keep = [o.clone() for o in outs]
    outs[1].fill_(-1.0)
    assert torch.equal(outs[0], keep[0]) and torch.equal(outs[2], keep[2])


def _unfused(comm, x, op):
    return comm.allreduce(comm.put(x), op).numpy()


@pytest.mark.parametrize("case", ["ring", "minloc", "int32", "prod"])
def test_flushes_outside_the_fold_keep_pack_allreduce_unpack(pworld, case):
    """A pinned ring, a pair op (never bucketed), an int32 bucket and
    PROD: results as the unfused calls', and no fold."""
    op = {"minloc": P.MINLOC, "prod": P.PROD}.get(case, P.SUM)
    if case == "minloc":
        xs = [np.stack([_ints((N, 6), 10 + k),
                        np.tile(np.arange(N, dtype=np.float32)[:, None],
                                (1, 6))], axis=-1) for k in range(3)]
    else:
        dt = np.int32 if case == "int32" else np.float32
        xs = [_ints((N, 6 + k), 10 + k, dt) for k in range(3)]
    if case == "ring":
        var.var_set("coll_torch_allreduce_algorithm", "ring")
    refs = [_unfused(pworld, x, op) for x in xs]
    c0 = persistent.counters()
    reqs = [pworld.allreduce_init(pworld.put(x), op) for x in xs]
    P.Startall(reqs)
    got = [r.get().numpy() for r in reqs]
    c = {k: persistent.counters()[k] - c0[k] for k in FOLDS}
    assert all(np.array_equal(a, b) for a, b in zip(got, refs))
    assert c == {"coll_bucket_flushes": 0 if case == "minloc" else 1,
                 "coll_bucket_folds": 0, "coll_bucket_fold_tables": 0}


def test_oneshot_iallreduce_takes_the_fold(pworld):
    xs = [_ints((N, 9), 20), _ints((N, 2, 3), 21)]
    refs = [_unfused(pworld, x, P.MAX) for x in xs]
    reqs = [pworld.iallreduce(pworld.put(x), P.MAX) for x in xs]
    got = [r.get() for r in reqs]
    assert all(np.array_equal(g.numpy(), e) for g, e in zip(got, refs))
    assert got[0].untyped_storage().data_ptr() == \
        got[1].untyped_storage().data_ptr()
    c = persistent.counters()
    assert c["coll_bucket_folds"] == c["coll_bucket_flushes"] >= 1


def test_grad_sync_steps_fold_every_flush_and_keep_their_tables(pworld):
    """Two BucketedGradSync steps: every flush folds; the first builds
    one table per bucket, the second none."""
    var.var_set("mpi_base_bucket_bytes", 1 << 10)
    rng = np.random.default_rng(5)
    tree = {k: rng.standard_normal((N,) + s).astype(np.float32)
            for k, s in (("a", (100,)), ("b", (8, 20)), ("c", (300,)),
                         ("d", (7,)), ("e", (64,)))}
    grads = {k: pworld.put(v) for k, v in tree.items()}
    sync = T.BucketedGradSync(pworld, grads)
    seen = []
    for _ in range(2):
        c0 = persistent.counters()
        out = sync(grads)
        seen.append({k: persistent.counters()[k] - c0[k] for k in FOLDS})
        for k, v in tree.items():
            want = np.broadcast_to(v.astype(np.float64).mean(0), v.shape)
            np.testing.assert_allclose(out[k].numpy(), want, rtol=1e-6,
                                       atol=1e-6)
    flushes = seen[0]["coll_bucket_flushes"]
    assert flushes >= 2
    assert seen[0] == {"coll_bucket_flushes": flushes,
                       "coll_bucket_folds": flushes,
                       "coll_bucket_fold_tables": flushes}
    assert seen[1] == {"coll_bucket_flushes": flushes,
                       "coll_bucket_folds": flushes,
                       "coll_bucket_fold_tables": 0}


def test_a_pinned_schedule_after_folded_flushes_takes_it(pworld):
    """The fold is chosen again once a var changes: a ring pinned after
    a folded flush runs the ring on the same members, and the kept table
    folds again once the pin is lifted, without a new build."""
    xs = [_ints((N, 5), 30), _ints((N, 11), 31)]
    bufs = [pworld.put(x) for x in xs]
    refs = [_unfused(pworld, x, P.SUM) for x in xs]
    reqs = [pworld.allreduce_init(b, P.SUM) for b in bufs]
    seen = []
    for alg in ("auto", "ring", "auto"):
        var.var_set("coll_torch_allreduce_algorithm", alg)
        c0 = persistent.counters()
        P.Startall(reqs)
        got = [r.get().numpy() for r in reqs]
        assert all(np.array_equal(g, e) for g, e in zip(got, refs))
        seen.append(tuple(persistent.counters()[k] - c0[k] for k in FOLDS))
    assert seen == [(1, 1, 1), (1, 0, 0), (1, 1, 0)]


def test_fold_tables_kept_are_bounded(pworld):
    """One-shot iallreduces of fresh tensors build a table each; the
    fuser keeps the newest ``FOLD_TABLES_MAX``."""
    held, extra = [], 6
    c0 = persistent.counters()["coll_bucket_fold_tables"]
    for k in range(persistent.FOLD_TABLES_MAX + extra):
        x = _ints((N, 3 + k % 5), 100 + k)
        held.append(pworld.put(x))          # alive: a new address each
        got = pworld.iallreduce(held[-1], P.SUM).get()
        assert np.array_equal(got.numpy(), np.broadcast_to(x.sum(0),
                                                           x.shape))
    built = persistent.counters()["coll_bucket_fold_tables"] - c0
    assert built == persistent.FOLD_TABLES_MAX + extra
    assert len(persistent.fuser_of(pworld)._tables) == \
        persistent.FOLD_TABLES_MAX


PERRANK = """
from ompi_tpu_torch.mca import pvar, var
MPI.Init()
w = MPI.get_comm_world()
r = w.rank()
bufs = [np.full(4 + i, float(i + r + 1), np.float32) for i in range(3)]
refs = [np.asarray(w.allreduce(b, MPI.SUM)) for b in bufs]
var.var_set("mpi_base_bucket", True)
f0, k0 = (pvar.pvar_read(f"coll_bucket_{c}") for c in ("flushes", "folds"))
reqs = [w.allreduce_init(b, MPI.SUM) for b in bufs]
MPI.Startall(reqs)
for q, e in zip(reqs, refs):
    q.wait()
    assert np.array_equal(q.get(), e)
assert pvar.pvar_read("coll_bucket_flushes") - f0 == 1
assert pvar.pvar_read("coll_bucket_folds") - k0 == 0
MPI.Finalize()
print(f"OK bucket_perrank rank={r}", flush=True)
"""


def test_perrank_flush_keeps_its_own_path(tmp_path):
    rc, out, err = run_job(write_prog(tmp_path, "bucket_perrank", PERRANK),
                           2)
    assert rc == 0, f"rc={rc}\n--- out\n{out}\n--- err\n{err[-4000:]}"
    assert out.count("OK bucket_perrank") == 2, out
