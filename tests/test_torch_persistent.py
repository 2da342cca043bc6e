"""Parity of the port's persistent collectives and bucket fusion with the
JAX package's (``coll/persistent``).

An 8-rank port world on the CPU against the conftest's 8-device JAX
world, on the same integer-valued float32 stacked inputs from a seed:
any combine order is exact there, so plan results are held
byte-identical to the blocking call and to the JAX plan's. The bucket
fuser's flush counts (``counters()`` deltas) must equal the JAX fuser's
on the same leaves, order and threshold. Each test sets both packages'
``mpi_base_bucket*`` vars itself and restores the JAX ones, and starts
the port from a fresh state.
"""
import gc
import math
import weakref

import numpy as np
import pytest
import torch

import ompi_tpu_torch as P
from ompi_tpu.coll import persistent as jpersistent
from ompi_tpu.core.errhandler import ERR_REQUEST as J_ERR_REQUEST
from ompi_tpu.mca import var as jvar
from ompi_tpu_torch.coll import persistent
from ompi_tpu_torch.core.errhandler import ERR_REQUEST
from ompi_tpu_torch.mca import pvar, var
from ompi_tpu_torch.runtime import progress as prog

N = 8
COUNTED = ("coll_persistent_starts", "coll_bucket_flushes",
           "coll_bucket_fused_members", "coll_bucket_flush_bytes",
           "coll_bucket_flush_startall", "coll_bucket_flush_idle",
           "coll_bucket_flush_explicit")


@pytest.fixture()
def pworld():
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    yield P.get_comm_world()
    P._reset_for_tests()


@pytest.fixture()
def buckets(pworld, world):
    """Set both packages' bucket vars: ``set(on, nbytes)``; the JAX ones
    are restored (and its world's buckets drained) afterwards."""
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


def _ints(shape, seed):
    """Integer-valued float32: every combine order is exact."""
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 8, size=shape).astype(np.float32)


def _bytes(y):
    return np.ascontiguousarray(np.asarray(y)).tobytes()


def _delta(before, after):
    return {k: after[k] - before[k] for k in COUNTED}


# -- each *_init against its blocking call and the JAX plan ----------------
INITS = {
    "allreduce": ((N, 32), lambda c, b, m: c.allreduce_init(b, m.SUM),
                  lambda c, b, m: c.allreduce(b, m.SUM)),
    "bcast": ((N, 16), lambda c, b, m: c.bcast_init(b, 2),
              lambda c, b, m: c.bcast(b, 2)),
    "allgather": ((N, 8), lambda c, b, m: c.allgather_init(b),
                  lambda c, b, m: c.allgather(b)),
    "reduce_scatter_block": (
        (N, N, 4), lambda c, b, m: c.reduce_scatter_block_init(b, m.SUM),
        lambda c, b, m: c.reduce_scatter_block(b, m.SUM)),
}


@pytest.mark.parametrize("func", list(INITS))
def test_persistent_init_matches_blocking_and_jax(pworld, world, mpi, func):
    shape, init, blocking = INITS[func]
    x = _ints(shape, seed=len(func))
    req = init(pworld, pworld.put(x), P)
    for _ in range(3):                   # re-armable: start/wait cycles
        P.Start(req)
        P.Wait(req)
    got = req.get()
    assert isinstance(got, torch.Tensor)
    assert _bytes(got) == _bytes(blocking(pworld, pworld.put(x), P))
    jreq = init(world, world.put(x), mpi)
    jreq.start()
    assert _bytes(got) == _bytes(jreq.get())


def test_persistent_barrier(pworld, world):
    req = pworld.barrier_init()
    for _ in range(2):
        req.start()
        assert req.wait() is not None
    assert req.test()[0]
    assert req.plan.func == world.barrier_init().plan.func == "barrier"


def test_start_reads_the_buffer_contents_at_start(pworld):
    """An in-place change of the send buffer between starts shows in the
    next result (a plan binds the buffer, not its values at init)."""
    x = pworld.put(_ints((N, 6), seed=1))
    y = pworld.put(_ints((N, N, 3), seed=2))
    reqs = {"allreduce": (pworld.allreduce_init(x, P.SUM),
                          lambda: pworld.allreduce(x, P.SUM)),
            "bcast": (pworld.bcast_init(x, 5), lambda: pworld.bcast(x, 5)),
            "allgather": (pworld.allgather_init(x),
                          lambda: pworld.allgather(x)),
            "reduce_scatter_block": (
                pworld.reduce_scatter_block_init(y, P.MAX),
                lambda: pworld.reduce_scatter_block(y, P.MAX))}
    for step in range(3):
        x.mul_(2).add_(step)
        y.sub_(3)
        for name, (req, ref) in reqs.items():
            req.start()
            assert torch.equal(req.get(), ref()), (name, step)


def test_dropped_plan_frees_its_buffers_at_once(pworld):
    """No reference cycle through a plan: dropping the request frees its
    send buffer and result without the cycle collector."""
    buf = pworld.put(_ints((N, 64), seed=7))
    req = pworld.allreduce_init(buf, P.SUM)
    req.start()
    refs = [weakref.ref(buf), weakref.ref(req.get())]
    gc.disable()
    try:
        del buf, req
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_allreduce_bind_is_the_bound_lowering(pworld):
    x = pworld.put(_ints((N, 5), seed=3))
    fn = pworld.allreduce_bind(x, P.MAX)
    assert torch.equal(fn(x), pworld.allreduce(x, P.MAX))
    x.add_(1)
    assert torch.equal(fn(x), pworld.allreduce(x, P.MAX))


def test_start_counts_the_pvar(pworld):
    req = pworld.allreduce_init(pworld.put(_ints((N, 4), seed=4)), P.SUM)
    before = pvar.pvar_read("coll_persistent_starts")
    for _ in range(5):
        req.start()
        req.wait()
    assert pvar.pvar_read("coll_persistent_starts") - before == 5


def test_plan_metadata_matches_jax(pworld, world, mpi):
    x = _ints((N, 64), seed=5)
    plan = pworld.allreduce_init(pworld.put(x), P.SUM).plan
    jplan = world.allreduce_init(world.put(x), mpi.SUM).plan
    assert plan.func == jplan.func == "allreduce"
    assert plan.algorithm == jplan.algorithm
    assert plan.codec is None and jplan.codec is None
    assert plan.nbytes == jplan.nbytes == 64 * 4
    assert plan.bucket_key[0] == "sum" and plan.bucket_key[1] == str(
        torch.float32)


# -- the request state machine (MPI_Start / MPI_Request_free) --------------
def _active_persistent(mod):
    """A persistent request whose inner op completes only on demand."""
    g = mod.Grequest()
    return mod.Request(persistent_start=lambda: g), g


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_start_on_nonpersistent_or_active_raises_err_request(pkg, mpi):
    mod, err = (P, ERR_REQUEST) if pkg == "port" else (mpi, J_ERR_REQUEST)
    with pytest.raises(mod.MPIError) as ei:
        mod.Request.completed("x").start()
    assert ei.value.error_class == err
    req, g = _active_persistent(mod)
    req.start()
    with pytest.raises(mod.MPIError) as ei:
        req.start()
    assert ei.value.error_class == err
    g.complete(1)
    req.wait()
    req.start()                          # inactive again: re-armable
    req.wait()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_request_free_on_active_is_deferred(pkg, mpi):
    mod = P if pkg == "port" else mpi
    req, g = _active_persistent(mod)
    req.start()
    req.free()
    assert req._free_pending and not req._freed
    with pytest.raises(mod.MPIError):    # unusable from the free on
        req.start()
    g.complete(2)
    req.wait()                           # completion finishes the free
    assert req._freed and not req._free_pending
    idle, _g = _active_persistent(mod)
    idle.free()                          # inactive: immediate
    assert idle._freed
    with pytest.raises(mod.MPIError):
        idle.start()


def test_persistent_coll_start_on_active_raises(pworld):
    req = pworld.allreduce_init(pworld.put(_ints((N, 4), seed=6)), P.SUM)
    req.start()
    req._complete = False                # force the active window
    req._inner_req = P.Grequest()
    with pytest.raises(P.MPIError) as ei:
        req.start()
    assert ei.value.error_class == ERR_REQUEST
    req._inner_req.complete(None)
    req.wait()
    req.start()
    req.wait()


# -- bucket fusion -----------------------------------------------------------
def _leaves(k, elems, seed):
    return [_ints((N, elems), seed + i) for i in range(k)]


def _startall(comm, mod, xs, counters):
    """Startall over one allreduce plan per leaf; (results as bytes,
    counter deltas)."""
    reqs = [comm.allreduce_init(comm.put(x), mod.SUM) for x in xs]
    before = counters()
    mod.Startall(reqs)
    outs = [_bytes(r.get()) for r in reqs]
    return outs, _delta(before, counters())


def test_bucketed_allreduce_matches_unfused(pworld, world, mpi, buckets):
    xs = _leaves(6, 256, seed=10)
    buckets(False, 1 << 20)
    off, d_off = _startall(pworld, P, xs, persistent.counters)
    assert d_off["coll_bucket_flushes"] == 0
    buckets(True, 1 << 20)
    on, d_on = _startall(pworld, P, xs, persistent.counters)
    jon, jd = _startall(world, mpi, xs, jpersistent.counters)
    assert on == off == jon
    assert d_on == jd
    assert d_on["coll_bucket_flushes"] == 1                  # one bucket
    assert d_on["coll_bucket_fused_members"] == 6


def test_startall_flush_budget_matches_jax(pworld, world, mpi, buckets):
    k, elems = 8, 1024                   # 4 KiB per rank per member
    buckets(True, 1 << 14)               # 4 members per bucket
    xs = _leaves(k, elems, seed=20)
    on, d = _startall(pworld, P, xs, persistent.counters)
    jon, jd = _startall(world, mpi, xs, jpersistent.counters)
    assert on == jon and d == jd
    assert d["coll_bucket_flushes"] <= math.ceil(k * elems * 4 / (1 << 14))
    assert d["coll_bucket_fused_members"] == k
    assert d["coll_bucket_flush_bytes"] >= 1
    assert d["coll_persistent_starts"] == k


@pytest.mark.parametrize("threshold", [1 << 10, 1 << 12, 1 << 20])
def test_flush_counts_equal_the_jax_fuser_on_gradient_leaves(
        pworld, world, mpi, buckets, threshold):
    """Leaves of mixed sizes (some above the threshold, which never
    bucket) and two dtypes: every counter moves as the JAX fuser's."""
    sizes = [300, 8, 8, 1200, 64, 5, 260, 33, 2]
    xs = [_ints((N, s), seed=30 + i) for i, s in enumerate(sizes)]
    xs[4] = xs[4].astype(np.int32)
    xs[6] = xs[6].astype(np.int32)
    buckets(True, threshold)
    on, d = _startall(pworld, P, xs, persistent.counters)
    jon, jd = _startall(world, mpi, xs, jpersistent.counters)
    assert on == jon and d == jd
    buckets(False, threshold)
    off, _ = _startall(pworld, P, xs, persistent.counters)
    assert on == off


def test_oneshot_iallreduce_fuses_as_jax(pworld, world, mpi, buckets):
    xs = _leaves(3, 64, seed=40)
    buckets(False)
    refs = [_bytes(pworld.allreduce(pworld.put(x), P.SUM)) for x in xs]
    buckets(True, 1 << 20)
    deltas = []
    for comm, mod, counters in ((pworld, P, persistent.counters),
                                (world, mpi, jpersistent.counters)):
        before = counters()
        reqs = [comm.iallreduce(comm.put(x), mod.SUM) for x in xs]
        outs = [_bytes(r.get()) for r in reqs]
        assert outs == refs
        deltas.append(_delta(before, counters()))
    assert deltas[0] == deltas[1]
    assert deltas[0]["coll_bucket_flushes"] <= 2


def test_bucket_occupancy_level_pvar(pworld, buckets):
    buckets(True, 1 << 20)
    buf = pworld.put(_ints((N, 64), seed=50))
    req = pworld.allreduce_init(buf, P.SUM)
    req.start()
    assert pvar.pvar_read("coll_bucket_occupancy") == 64 * 4
    assert pvar.pvar_info("coll_bucket_occupancy")["class"] == "level"
    req.wait()
    assert pvar.pvar_read("coll_bucket_occupancy") == 0


def test_bucket_member_completes_by_the_idle_sweep(pworld, buckets):
    """A started member below the threshold: test() spins the progress
    engine, whose low-priority sweep flushes the idle bucket."""
    buckets(True, 1 << 20)
    x = _ints((N, 16), seed=60)
    req = pworld.allreduce_init(pworld.put(x), P.SUM)
    req.start()
    spins = 0
    while not req.test()[0]:
        spins += 1
        assert spins <= prog._LOW_EVERY
    assert persistent.counters()["coll_bucket_flush_idle"] == 1
    assert _bytes(req.get()) == _bytes(pworld.allreduce(pworld.put(x)))
    prog.progress()                      # the swept fuser deregisters
    assert prog.callback_count() == 0


def test_fused_results_never_alias_each_other(pworld, buckets):
    buckets(True, 1 << 20)
    xs = _leaves(3, 5, seed=70)
    reqs = [pworld.allreduce_init(pworld.put(x), P.SUM) for x in xs]
    P.Startall(reqs)
    outs = [r.get() for r in reqs]
    keep = [o.clone() for o in outs]
    outs[0].fill_(-1.0)
    assert all(torch.equal(o, k) for o, k in zip(outs[1:], keep[1:]))
    for r in reqs:                       # restart: new tensors
        r.start()
    assert torch.equal(reqs[1].get(), keep[1])
    assert reqs[0].get().data_ptr() != outs[0].data_ptr()


def test_startall_window_and_flush_all(pworld, buckets):
    buckets(True, 1 << 20)
    reqs = [pworld.allreduce_init(pworld.put(x), P.SUM)
            for x in _leaves(2, 4, seed=80)]
    with persistent.startall_window():
        for r in reqs:
            r.start()
        assert persistent.counters()["coll_bucket_flushes"] == 0
    c = persistent.counters()
    assert c["coll_bucket_flushes"] == c["coll_bucket_flush_startall"] == 1
    P.Waitall(reqs)
    reqs[0].start()
    assert persistent.flush_all() == 1
    assert persistent.counters()["coll_bucket_flush_explicit"] == 1
    assert reqs[0].test()[0]


def test_reset_zeroes_counters_and_drops_fusers(pworld, buckets):
    buckets(True, 1 << 20)
    req = pworld.allreduce_init(pworld.put(_ints((N, 4), seed=90)), P.SUM)
    req.start()
    assert persistent.counters()["coll_persistent_starts"] == 1
    assert prog.callback_count() == 1    # the fuser's idle sweep
    P._reset_for_tests()
    assert set(persistent.counters().values()) == {0}
    assert prog.callback_count() == 0
    assert pvar.pvar_read("coll_bucket_occupancy") == 0
    assert not persistent.bucket_enabled()


# -- the pvar registry ------------------------------------------------------
def test_pvar_registry():
    names = pvar.pvar_names()
    for name in COUNTED + ("coll_bucket_occupancy",):
        assert name in names
        assert pvar.pvar_info(name)["name"] == name
    listed = {e["name"]: e for e in pvar.pvar_list()}
    assert listed["coll_persistent_starts"]["class"] == "counter"
    with pytest.raises(PermissionError):
        pvar.pvar_write("coll_bucket_flushes", 0)
    with pytest.raises(KeyError):
        pvar.pvar_read("no_such_pvar")
    with pytest.raises(ValueError):      # another site claims the name
        pvar.pvar_register("coll_bucket_flushes", lambda: 0)
