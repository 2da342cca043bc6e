"""Parity of the port's algorithm schedules and decision layer with the
JAX package's (``coll/xla`` schedules, ``coll/decision``, the tuned
dynamic-rules file).

Every schedule is forced through its var in both packages
(``coll_xla_<func>_algorithm`` and ``coll_torch_<func>_algorithm``) and
fed the same numpy input from a seed, on the 8-rank worlds (the port's
on the CPU, the conftest's JAX world). Tolerances:

- bit for bit where the reference combines with ``op.fn`` alone (ring,
  ring_segmented, recursive_doubling, in_order_binary, knomial reduce,
  recursive_halving, butterfly, recursive-doubling scan), and for data
  movement, MAX/MIN and int32;
- rtol 1e-5 / atol 1e-5 for float32 SUM and PROD where XLA orders the
  reduction (direct, rabenseifner, hier);
- PROD on int32 compares values, and the port's dtype against the input:
  the reference's direct PROD widens to int64 under the conftest's x64.

The root-targeted schedules (rabenseifner_root, binomial gather and
scatter) raise in the reference under x64, so they are held against
numpy at every root. The demotions, two_procs, the butterfly at
non-power-of-two sizes and the partial rounds of bruck and sparbit run
on split sub-communicators of sizes 2, 3, 5 and 6 against numpy. The
decision layer (``decide``, ``effective_rules``, ``decision_table``,
the dynamic-rules file) is compared with the reference's over a grid.

Each test starts the port from a fresh state and restores every JAX
var it sets.
"""
import json
import os
import zlib

import numpy as np
import pytest
import torch

import ompi_tpu_torch as P
from ompi_tpu.coll import decision as jdecision
from ompi_tpu.mca import var as jvar
from ompi_tpu_torch.coll import decision, tuned
from ompi_tpu_torch.coll.torch_ import ALGORITHMS
from ompi_tpu_torch.mca import var as pvar

N = 8
ROOT = 5
LEN = 37          # elements per rank: no algorithm's chunking divides it
BITWISE = {"ring", "ring_segmented", "recursive_doubling", "in_order_binary",
           "knomial", "recursive_halving", "butterfly"}


def _seed(*parts) -> int:
    return zlib.crc32("|".join(map(str, parts)).encode())


@pytest.fixture()
def pworld():
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    yield P.get_comm_world()
    P._reset_for_tests()


@pytest.fixture()
def force(request):
    """force(func, name): pin the algorithm in both packages for the
    test (the JAX var is restored after it)."""
    def _set(func, name):
        key = f"coll_xla_{func}_algorithm"
        jvar.var_set(key, name)
        request.addfinalizer(lambda: jvar.var_set(key, "auto"))
        pvar.var_set(f"coll_torch_{func}_algorithm", name)
    return _set


@pytest.fixture()
def segsize(request):
    """Small segments in both packages, so the segmented schedules run
    several segments at LEN elements."""
    jvar.var_set("coll_xla_segsize", 8)
    request.addfinalizer(lambda: jvar.var_set("coll_xla_segsize", 1 << 20))
    pvar.var_set("coll_torch_segsize", 8)


def _data(dtype, op, lead, seed):
    rng = np.random.default_rng(seed)
    shape = lead + (LEN,)
    if np.dtype(dtype).kind == "i":
        lo, hi = (-3, 4) if op == "PROD" else (-1000, 1000)
        return rng.integers(lo, hi, size=shape).astype(dtype)
    x = rng.standard_normal(shape).astype(dtype)
    return (1 + 0.05 * x).astype(dtype) if op == "PROD" else x


def _run(pw, world, mpi, func, x, op=None, root=None):
    """(port result, JAX result) of ``func`` on the stacked numpy ``x``."""
    pargs = [pw.put(x)] + ([getattr(P, op)] if op else []) \
        + ([root] if root is not None else [])
    jargs = [world.put(x)] + ([getattr(mpi, op)] if op else []) \
        + ([root] if root is not None else [])
    return (getattr(pw, func)(*pargs).numpy(),
            np.asarray(getattr(world, func)(*jargs)))


def _held(got, want, exact, dtype):
    """Bitwise (float bits, int values) or rtol/atol 1e-5; an int32
    result keeps the input's dtype, and is compared by value."""
    if np.dtype(dtype).kind == "i":
        assert got.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    elif exact:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _exact(alg, op):
    return alg in BITWISE or op in (None, "MAX", "MIN")


# -- against the reference, 8-rank world ----------------------------------
AR_CASES = [("float32", "SUM"), ("float32", "PROD"), ("float32", "MAX"),
            ("int32", "PROD")]


@pytest.mark.parametrize("dtype,op", AR_CASES)
@pytest.mark.parametrize("alg", ALGORITHMS["allreduce"][1:])
def test_allreduce_matches_reference(pworld, world, mpi, force, segsize,
                                     alg, dtype, op):
    force("allreduce", alg)
    x = _data(dtype, op, (N,), _seed("ar", alg, dtype, op))
    got, want = _run(pworld, world, mpi, "allreduce", x, op)
    _held(got, want, _exact(alg, op), dtype)
    if alg == "recursive_doubling":      # every rank holds the same bits
        assert all(np.array_equal(got[0], got[r]) for r in range(N))
    ran = pworld._coll("allreduce").selected("allreduce", pworld.put(x),
                                             getattr(P, op))
    assert ran == ("direct" if alg == "rabenseifner" and op != "SUM"
                   else alg)


@pytest.mark.parametrize("root", [0, ROOT])
@pytest.mark.parametrize("op", ["SUM", "MAX"])
@pytest.mark.parametrize("alg", ["alias", "knomial", "in_order_binary"])
def test_reduce_matches_reference(pworld, world, mpi, force, alg, op,
                                  root):
    force("reduce", alg)
    x = _data("float32", op, (N,), _seed("reduce", alg, op, root))
    got, want = _run(pworld, world, mpi, "reduce", x, op, root)
    if alg == "alias":                   # root's row only is significant
        got, want = got[root], want[root]
    _held(got, want, _exact(alg, op), "float32")


@pytest.mark.parametrize("alg", ALGORITHMS["bcast"][1:])
def test_bcast_matches_reference(pworld, world, mpi, force, segsize, alg):
    force("bcast", alg)
    x = _data("float32", None, (N,), _seed("bcast", alg))
    got, want = _run(pworld, world, mpi, "bcast", x, root=ROOT)
    _held(got, want, True, "float32")
    np.testing.assert_array_equal(got, np.broadcast_to(x[ROOT], x.shape))


@pytest.mark.parametrize("alg", ALGORITHMS["allgather"][1:])
def test_allgather_matches_reference(pworld, world, mpi, force, alg):
    force("allgather", alg)
    x = _data("int32", None, (N,), _seed("allgather", alg))
    got, want = _run(pworld, world, mpi, "allgather", x)
    _held(got, want, True, "int32")
    ran = pworld._coll("allgather").selected("allgather", pworld.put(x))
    assert ran == ("direct" if alg == "two_procs" else alg)


@pytest.mark.parametrize("alg", ALGORITHMS["alltoall"][1:])
def test_alltoall_matches_reference(pworld, world, mpi, force, alg):
    force("alltoall", alg)
    x = _data("float32", None, (N, N), _seed("alltoall", alg))
    got, want = _run(pworld, world, mpi, "alltoall", x)
    _held(got, want, True, "float32")


@pytest.mark.parametrize("op", ["SUM", "MAX"])
@pytest.mark.parametrize("alg", ALGORITHMS["reduce_scatter_block"][1:])
def test_reduce_scatter_block_matches_reference(pworld, world, mpi, force,
                                                alg, op):
    force("reduce_scatter_block", alg)
    x = _data("float32", op, (N, N), _seed("rsb", alg, op))
    got, want = _run(pworld, world, mpi, "reduce_scatter_block", x, op)
    _held(got, want, _exact(alg, op), "float32")


@pytest.mark.parametrize("func", ["scan", "exscan"])
@pytest.mark.parametrize("op", ["SUM", "MAX"])
@pytest.mark.parametrize("alg", ALGORITHMS["scan"][1:])
def test_scan_matches_reference(pworld, world, mpi, force, alg, op, func):
    force("scan", alg)
    x = _data("float32", op, (N,), _seed(func, alg, op))
    got, want = _run(pworld, world, mpi, func, x, op)
    _held(got, want, alg == "recursive_doubling" or op == "MAX", "float32")


@pytest.mark.parametrize("alg", ALGORITHMS["barrier"][1:])
def test_barrier_token_matches_reference(pworld, world, force, alg):
    force("barrier", alg)
    pworld.barrier()
    world.barrier()
    got = pworld._coll("barrier")._ibarrier_arrays()[0].numpy()
    want = np.asarray(world.c_coll["barrier"].device._ibarrier_arrays()[0])
    np.testing.assert_array_equal(got, want)


def test_non_commutative_demotes_like_the_reference(pworld, world, mpi,
                                                    force):
    """REORDERING with a non-commutative op runs direct (allreduce) or
    the alias (reduce) in both; in_order_binary and rd scan keep their
    schedule and fold in rank order."""
    x = _data("float32", None, (N,), _seed("noncomm"))
    pf = P.op_create(lambda a, b: b, commute=False)       # right-take
    jf = mpi.op_create(lambda a, b: b, commute=False)
    for func, alg, root, ran in [
            ("allreduce", "ring", None, "direct"),
            ("allreduce", "recursive_doubling", None, "direct"),
            ("reduce", "knomial", 0, "alias"),
            ("reduce", "in_order_binary", 0, "in_order_binary"),
            ("scan", "recursive_doubling", None, "recursive_doubling")]:
        force(func, alg)
        pargs = [pworld.put(x), pf] + ([root] if root is not None else [])
        jargs = [world.put(x), jf] + ([root] if root is not None else [])
        got = getattr(pworld, func)(*pargs).numpy()
        want = np.asarray(getattr(world, func)(*jargs))
        if func == "reduce":
            got, want = got[root], want[root]
        _held(got, want, True, "float32")
        assert pworld._coll(func).selected(func, pargs[0], pf, root) == ran


# -- root-targeted schedules against numpy, every root -------------------
@pytest.mark.parametrize("n", [N, 6])
def test_root_targeted_against_numpy(pworld, n):
    comm = pworld if n == N else pworld.split([0] * n + [P.UNDEFINED]
                                              * (N - n))[0]
    rng = np.random.default_rng(_seed("root", n))
    for func in ("reduce", "gather", "scatter"):
        pvar.var_set(f"coll_torch_{func}_algorithm",
                     "rabenseifner_root" if func == "reduce"
                     else "binomial")
    x = rng.standard_normal((n, LEN)).astype(np.float32)
    chunks = rng.standard_normal((n, n, 4)).astype(np.float32)
    for root in range(n):
        y = comm.reduce(comm.put(x), P.SUM, root).numpy()
        np.testing.assert_allclose(y[root], x.sum(0), rtol=1e-5, atol=1e-5)
        assert not np.any(np.delete(y, root, axis=0))
        g = comm.gather(comm.put(x), root).numpy()
        np.testing.assert_array_equal(g[root], x)
        s = comm.scatter(comm.put(chunks), root).numpy()
        np.testing.assert_array_equal(s, chunks[root])
        assert comm._coll("reduce").selected(
            "reduce", comm.put(x), P.SUM, root) == "rabenseifner_root"
        assert comm._coll("scatter").selected(
            "scatter", comm.put(chunks), None, root) == "binomial"


# -- port only, split sub-communicators against numpy ---------------------
def _numpy(func, x, root):
    n = x.shape[0]
    return {
        "allreduce": lambda: np.broadcast_to(x.sum(0), x.shape),
        "reduce": lambda: x.sum(0),
        "bcast": lambda: np.broadcast_to(x[root], x.shape),
        "allgather": lambda: np.broadcast_to(x, (n,) + x.shape),
        "gather": lambda: x,
        "scatter": lambda: x[root],
        "alltoall": lambda: np.swapaxes(x, 0, 1),
        "reduce_scatter_block": lambda: x.sum(0),
        "scan": lambda: np.cumsum(x, 0),
        "exscan": lambda: np.concatenate([x[:1], np.cumsum(x, 0)[:-1]]),
    }[func]()


def _expected_alg(func, alg, n):
    """What runs for ``alg`` forced at size ``n`` with SUM: the
    reference's structural demotions (POW2_ONLY, EVEN_ONLY) and the
    two-rank exchange's n == 2. exscan selects under scan's name."""
    func = "scan" if func == "exscan" else func
    if (alg in jdecision.POW2_ONLY and n & (n - 1)
            and (func, alg) not in jdecision.POW2_EXEMPT):
        return "direct"
    if alg in jdecision.EVEN_ONLY and n % 2:
        return "direct"
    if alg == "two_procs" and n != 2:
        return "direct"
    return alg


SUB_CASES = [(func, alg) for func in ALGORITHMS if func != "barrier"
             for alg in ALGORITHMS[func][1:]] + [
    ("exscan", alg) for alg in ALGORITHMS["scan"][1:]]


@pytest.mark.parametrize("n", [2, 3, 5, 6])
@pytest.mark.parametrize("func,alg", SUB_CASES)
def test_subcomm_schedule_against_numpy(pworld, func, alg, n):
    comm = pworld.split([0] * n + [P.UNDEFINED] * (N - n))[0]
    pvar.var_set(f"coll_torch_{'scan' if func == 'exscan' else func}"
                 f"_algorithm", alg)
    lead = (n, n) if func in ("scatter", "alltoall",
                              "reduce_scatter_block") else (n,)
    x = _data("float32", "SUM", lead, _seed("sub", func, alg, n))
    reducing = func in ("allreduce", "reduce", "reduce_scatter_block",
                        "scan", "exscan")
    for root in ([0, n - 1] if func in ("reduce", "bcast", "gather",
                                        "scatter") else [None]):
        args = [comm.put(x)] + ([P.SUM] if reducing else []) \
            + ([root] if root is not None else [])
        y = getattr(comm, func)(*args).numpy()
        if func in ("reduce", "gather"):
            y = y[root]
        want = _numpy(func, x, root)
        assert y.shape == want.shape
        np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)
        ran = comm._coll(func).selected(func, args[0],
                                        P.SUM if reducing else None, root)
        assert ran == _expected_alg(func, alg, n), (func, alg, n, ran)


@pytest.mark.parametrize("n", [2, 3, 5, 6])
@pytest.mark.parametrize("alg", ALGORITHMS["barrier"][1:])
def test_subcomm_barrier(pworld, alg, n):
    comm = pworld.split([0] * n + [P.UNDEFINED] * (N - n))[0]
    pvar.var_set("coll_torch_barrier_algorithm", alg)
    comm.barrier()
    tok = comm._coll("barrier")._ibarrier_arrays()[0]
    assert tok.shape == (n,) and bool((tok == tok[0]).all())
    assert bool((tok >= n).all())        # every rank's token reached it
    assert comm._coll("barrier").selected("barrier") == alg


def test_non_commutative_on_odd_subcomm(pworld):
    """n = 5: a non-commutative op demotes the reordering schedules and
    keeps the order-preserving ones, each folding in rank order."""
    comm = pworld.split([0] * 5 + [P.UNDEFINED] * 3)[0]
    x = _data("float32", None, (5,), _seed("noncomm5"))
    f = P.op_create(lambda a, b: b, commute=False)            # right-take
    for func, alg, ran in [("allreduce", "ring", "direct"),
                           ("reduce_scatter_block", "butterfly", "direct"),
                           ("reduce", "in_order_binary", "in_order_binary"),
                           ("scan", "recursive_doubling",
                            "recursive_doubling")]:
        pvar.var_set(f"coll_torch_{func}_algorithm", alg)
        xx = np.stack([x] * 5, 1) if func == "reduce_scatter_block" else x
        args = [comm.put(xx), f] + ([2] if func == "reduce" else [])
        y = getattr(comm, func)(*args).numpy()
        if func == "scan":
            np.testing.assert_array_equal(y, x)
        elif func == "reduce":
            np.testing.assert_array_equal(y[2], x[4])
        else:
            np.testing.assert_array_equal(y, np.broadcast_to(x[4], y.shape))
        assert comm._coll(func).selected(func, args[0], f,
                                         args[2] if func == "reduce"
                                         else None) == ran


def test_unknown_name_runs_direct(pworld):
    """A name outside the enumerator, set by var_set (unchecked, as in
    the reference), falls to the direct lowering."""
    pvar.var_set("coll_torch_allreduce_algorithm", "no_such_schedule")
    x = pworld.put(_data("float32", None, (N,), 1))
    y = pworld.allreduce(x, P.MAX)
    assert torch.equal(y, x.amax(0).expand(x.shape))
    assert pworld._coll("allreduce").selected("allreduce", x,
                                              P.MAX) == "direct"


def test_var_store_change_redecides(pworld):
    """The (func, shape, dtype, op) memo follows the var epoch."""
    mod = pworld._coll("allreduce")
    x = pworld.put(_data("float32", None, (N,), 2))
    assert mod.selected("allreduce", x, P.SUM) == "direct"
    pvar.var_set("coll_torch_allreduce_algorithm", "ring")
    assert mod.selected("allreduce", x, P.SUM) == "ring"
    pvar.var_set("coll_torch_cache_max_entries", 1)
    for alg in ("recursive_doubling", "hier", "ring"):
        pvar.var_set("coll_torch_allreduce_algorithm", alg)
        pworld.allreduce(x, P.SUM)
        assert len(mod._cache) == 1 and len(mod._fast) <= 1


# -- persistent plans record (and run) the selected algorithm -------------
@pytest.mark.parametrize("elems", [LEN * N, 1 << 18])  # 1 MiB per rank
@pytest.mark.parametrize("func", ["allreduce", "bcast", "allgather",
                                  "reduce_scatter_block", "barrier"])
def test_plan_algorithm_matches_reference(pworld, world, mpi, func, elems):
    x = np.ones((N, elems), np.float32)
    if func == "reduce_scatter_block":
        x = x.reshape(N, N, -1)
    args = {"allreduce": (P.SUM,), "bcast": (2,), "allgather": (),
            "reduce_scatter_block": (P.SUM,), "barrier": ()}[func]
    jargs = tuple(getattr(mpi, "SUM") if a is P.SUM else a for a in args)
    bufs = () if func == "barrier" else (pworld.put(x),)
    jbufs = () if func == "barrier" else (world.put(x),)
    plan = getattr(pworld, f"{func}_init")(*bufs, *args).plan
    jplan = getattr(world, f"{func}_init")(*jbufs, *jargs).plan
    assert plan.algorithm == jplan.algorithm
    if func == "allreduce":        # the plan runs the selected schedule
        mod = pworld._coll("allreduce")
        assert mod.selected("allreduce", bufs[0], P.SUM) == plan.algorithm
        assert plan.algorithm == ("direct" if elems == LEN * N
                                  else "rabenseifner")
        assert torch.equal(plan.fn(bufs[0]), pworld.allreduce(bufs[0]))


# -- the decision layer ---------------------------------------------------
GRID = [(func, size, nbytes, multihost, platform)
        for func in sorted(set(jdecision.FIXED_RULES) | {"scan"})
        for size in (2, 3, 8)
        for nbytes in (0, 4096, 64 << 10, 1 << 20, 64 << 20, 1 << 30)
        for multihost in (False, True)
        for platform in ("cpu", "gpu", "tpu", "")]

DYN = {"allreduce": {"algorithm_rules": [["0", "0", "ring"],   # malformed
                                         [0, 0, "recursive_doubling"],
                                         [4, 1 << 20, "ring_segmented"]]},
       "allgather": {"algorithm_rules": [[0, 0, "ring"],
                                         [4, 1024, "bruck"]]},
       "bcast": {"algorithm_rules": []},                 # empty: fixed rows
       "reduce": {"algorithm_rules": [[0, 0, "knomial"]]}}


@pytest.mark.parametrize("dynamic", [None, DYN])
def test_decide_matches_reference(dynamic):
    for func, size, nbytes, mh, plat in GRID:
        want = jdecision.decide(func, size, nbytes, mh, dynamic, plat)
        assert decision.decide(func, size, nbytes, mh, dynamic,
                               plat) == want
        assert decision.effective_rules(func, mh, dynamic, plat) == \
            jdecision.effective_rules(func, mh, dynamic, plat)


@pytest.mark.parametrize("dynamic", [None, DYN])
def test_decision_table_matches_reference(pworld, dynamic):
    """Equal to the reference's table, segment-pipeline and
    shared-segment fold rows included, but for the compression rows
    (compression is off here and its rows are checked in
    test_torch_compress_coll.py)."""
    for mh in (False, True):
        for plat in ("cpu", "gpu"):
            want = {f: [r for r in rows
                        if not str(r[2]).startswith("compressed:")]
                    for f, rows in jdecision.decision_table(
                        8, mh, dynamic, plat).items()}
            assert decision.decision_table(8, mh, dynamic, plat) == want
    pvar.var_set("coll_torch_bcast_algorithm", "knomial")
    assert decision.decision_table()["bcast"] == [
        [0, 0, "knomial"], [2, 4 << 20, "pipelined_chain"]]


def test_platform_key():
    assert decision.platform_key("cpu") == "cpu"
    assert decision.platform_key(torch.device("cuda", 0)) == "gpu"


def _module_algs(pmod, jmod):
    return [(pmod._algorithm(func, nbytes, commute),
             jmod._algorithm(func, nbytes, commute))
            for func in sorted(jdecision.FIXED_RULES)
            for nbytes in (0, 100 << 10, 2 << 20, 100 << 20)
            for commute in (True, False)]


def test_auto_and_dynamic_rules_file_match_reference(pworld, world,
                                                     tmp_path, request):
    """``auto`` in the port's module chooses what the reference's module
    chooses, without and with a dynamic-rules file (a malformed row is
    skipped); a rewrite of the file makes a warm memo decide again."""
    pmod = pworld._coll("allreduce")
    jmod = world.c_coll["allreduce"].device
    for pair in _module_algs(pmod, jmod):
        assert pair[0] == pair[1]
    path = tmp_path / "rules.json"
    path.write_text(json.dumps(DYN))
    jvar.var_set("coll_tuned_dynamic_rules", str(path))
    request.addfinalizer(
        lambda: jvar.var_set("coll_tuned_dynamic_rules", ""))
    pvar.var_set("coll_tuned_dynamic_rules", str(path))
    for pair in _module_algs(pmod, jmod):
        assert pair[0] == pair[1]
    x = pworld.put(_data("float32", None, (N,), 3))
    assert pmod.selected("allreduce", x, P.SUM) == "recursive_doubling"
    y0 = pworld.allreduce(x, P.SUM)
    path.write_text(json.dumps(
        {"allreduce": {"algorithm_rules": [[0, 0, "ring"]]}}))
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    assert pmod.selected("allreduce", x, P.SUM) == "recursive_doubling"
    pworld.allreduce(pworld.put(np.ones((N, 3), np.float32)), P.SUM)
    assert pmod.selected("allreduce", x, P.SUM) == "ring"   # reloaded
    np.testing.assert_allclose(pworld.allreduce(x, P.SUM).numpy(),
                               y0.numpy(), rtol=1e-5, atol=1e-5)
    assert tuned._load_rules(str(path)) == {
        "allreduce": {"algorithm_rules": [[0, 0, "ring"]]}}


def test_env_value_outside_enumerator_resolves_to_default(world,
                                                          monkeypatch):
    monkeypatch.setenv("OMPI_TPU_TORCH_MCA_coll_torch_bcast_algorithm",
                       "no_such_schedule")
    monkeypatch.setenv("OMPI_TPU_TORCH_MCA_coll_torch_scan_algorithm",
                       "recursive_doubling")
    P._reset_for_tests()
    try:
        P.Init(devices=["cpu"] * N)
        assert pvar.var_get("coll_torch_bcast_algorithm") == "auto"
        assert pvar.var_source("coll_torch_bcast_algorithm") == "default"
        assert pvar.var_get("coll_torch_scan_algorithm") == \
            "recursive_doubling"
        dump = {v["name"]: v for v in pvar.var_dump()}
        assert dump["coll_torch_scan_algorithm"]["enumerator"] == \
            list(ALGORITHMS["scan"])
        for func, names in ALGORITHMS.items():
            jnames = jvar._registry[f"coll_xla_{func}_algorithm"].enumerator
            assert list(names) == list(jnames), func
    finally:
        P._reset_for_tests()
