"""The port's tools planes against the JAX package's: ``utils/{output,
show_help,memchecker}``, ``api/tool`` (MPI_T), the mpiext modules
(accel, affinity, shortfloat) and the two repairs that waited for them
(the fatal handler's help text, the partitioned send's memchecker).

Mirrored: ``tests/test_output_showhelp.py`` (5),
``test_memchecker_protocol.py`` (8), the three mpiext tests of
``test_mpiext_debuggers.py``, ``test_aux.py::test_mpi_t_cvars_pvars``,
``test_api_surface.py::test_mpi_t_events``,
``test_trace_satellites.py::test_event_handle_dropped_increments_per_handle``,
and the decision-table tests of ``test_compress_coll.py`` and
``test_persistent_bucket.py``. Each body runs through both packages on
the same seeded inputs; where the packages differ by design the test
asserts both behaviours and names the difference:

- accel: the port's device plane is CUDA, so ``Query_cuda_support`` is
  the query that can answer True and ``Query_tpu_support`` is False;
  the inventory lists CUDA devices (or the CPU), not the world's ranks;
- affinity: the port names ``type:index`` of the torch device (ranks on
  one card each name ``cuda:0``; here ``cpu:0``);
- memchecker: the port tracks tensors too (a CPU tensor by crc32, a
  CUDA tensor by a device clone), where the reference skips every
  non-numpy buffer;
- stacked pt2pt: one device holds every rank of the port's CPU world,
  so the rendezvous tier has nothing to move and clones in place.
"""
from __future__ import annotations

import io
import threading

import numpy as np
import pytest
import torch

import ompi_tpu as R
import ompi_tpu_torch as P
from ompi_tpu.api import tool as r_tool
from ompi_tpu.mca import var as r_var
from ompi_tpu.mpiext import accel as r_accel
from ompi_tpu.mpiext import affinity as r_affinity
from ompi_tpu.mpiext import shortfloat as r_shortfloat
from ompi_tpu.utils import hooks as r_hooks
from ompi_tpu.utils import memchecker as r_mc
from ompi_tpu.utils import output as r_output
from ompi_tpu.utils import show_help as r_show_help
from ompi_tpu_torch.api import tool as p_tool
from ompi_tpu_torch.mca import var as p_var
from ompi_tpu_torch.mpiext import accel as p_accel
from ompi_tpu_torch.mpiext import affinity as p_affinity
from ompi_tpu_torch.mpiext import shortfloat as p_shortfloat
from ompi_tpu_torch.utils import hooks as p_hooks
from ompi_tpu_torch.utils import memchecker as p_mc
from ompi_tpu_torch.utils import output as p_output
from ompi_tpu_torch.utils import show_help as p_show_help

N = 8


@pytest.fixture()
def pworld():
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    yield P.get_comm_world()
    P._reset_for_tests()


def _both(fn):
    """``fn(side)`` for the port and the reference; the two results."""
    port = fn({"pkg": P, "var": p_var, "output": p_output,
               "show_help": p_show_help, "mc": p_mc, "tool": p_tool,
               "hooks": p_hooks})
    ref = fn({"pkg": R, "var": r_var, "output": r_output,
              "show_help": r_show_help, "mc": r_mc, "tool": r_tool,
              "hooks": r_hooks})
    return port, ref


# -- tests/test_output_showhelp.py -------------------------------------------
def test_output_stream_basic():
    def run(s):
        s["output"]._reset_for_tests()
        buf = io.StringIO()
        sid = s["output"].open_stream(prefix="coll", file=buf)
        s["output"].output(sid, "hello")
        first = buf.getvalue()
        s["output"].close_stream(sid)
        s["output"].output(sid, "after close")    # dropped, no crash
        return sid, first, buf.getvalue()
    port, ref = _both(run)
    assert port == ref == (1, "[coll] hello\n", "[coll] hello\n")


def test_output_verbose_gated_by_mca_var(pworld):
    def run(s):
        s["output"]._reset_for_tests()
        buf = io.StringIO()
        sid = s["output"].open_stream(framework="coll", file=buf)
        old = s["var"].var_get("coll_base_verbose", 0)
        try:
            s["var"].var_set("coll_base_verbose", 0)
            s["output"].output_verbose(5, sid, "quiet")
            quiet = buf.getvalue()
            s["var"].var_set("coll_base_verbose", 10)   # live re-read
            s["output"].output_verbose(5, sid, "loud")
            return quiet, buf.getvalue()
        finally:
            s["var"].var_set("coll_base_verbose", old)
    port, ref = _both(run)
    assert port == ref == ("", "loud\n")


def test_output_verbose_reads_the_port_env_prefix(monkeypatch):
    """The var names are the reference's; the environment prefix is the
    port's own (``OMPI_TPU_TORCH_MCA_``)."""
    monkeypatch.setenv("OMPI_TPU_TORCH_MCA_io_base_verbose", "7")
    monkeypatch.setenv("OMPI_TPU_MCA_io_base_verbose", "1")
    P._reset_for_tests()
    try:
        buf = io.StringIO()
        sid = p_output.open_stream(prefix="io", framework="io", file=buf)
        p_output.output_verbose(7, sid, "seen")
        p_output.output_verbose(8, sid, "not seen")
        assert buf.getvalue() == "[io] seen\n"
    finally:
        P._reset_for_tests()


def test_show_help_renders_catalog():
    def run(s):
        s["show_help"]._reset_for_tests()
        a = s["show_help"].render("help-mpi-errors.txt", "comm:revoked",
                                  "comm#5")
        b = s["show_help"].render("help-mpi-errors.txt", "comm:proc-failed",
                                  "[1, 3]", "MPI_COMM_WORLD")
        c = s["show_help"].render("help-mpi-errors.txt",
                                  "spawn:oversubscribe", "9", "8")
        d = s["show_help"].render("help-mpi-errors.txt",
                                  "io:fcoll-unknown", "bogus")
        assert "comm#5" in a and "revoked" in a
        assert "[1, 3]" in b and "MPI_COMM_WORLD" in b
        return a, b, c, d
    port, ref = _both(run)
    assert port == ref


def test_show_help_missing_topic_fallback():
    def run(s):
        s["show_help"]._reset_for_tests()
        a = s["show_help"].render("help-mpi-errors.txt", "no:such:topic")
        b = s["show_help"].render("help-nope.txt", "x")
        assert "unavailable" in a and "unavailable" in b
        return a, b
    port, ref = _both(run)
    assert port == ref


def test_show_help_dedup_and_flush():
    def run(s):
        s["show_help"]._reset_for_tests()
        buf = io.StringIO()
        for _ in range(4):
            s["show_help"].show_help("help-mpi-errors.txt", "comm:revoked",
                                     "c", file=buf)
        printed = buf.getvalue()
        assert printed.count("revoked") == 1     # only the first emission
        summary = s["show_help"].flush(file=buf)
        assert summary and "3 more occurrence(s)" in summary[0]
        assert s["show_help"].flush(file=buf) == []   # counts reset
        s["show_help"].show_help("help-mpi-errors.txt", "comm:revoked",
                                 "c", want_error_header=False, file=buf)
        return printed, summary, buf.getvalue()
    port, ref = _both(run)
    assert port == ref


def test_help_catalog_is_the_ports_own_copy():
    import os
    from ompi_tpu_torch.utils import show_help
    assert show_help._HELP_DIR.endswith(os.path.join("ompi_tpu_torch",
                                                     "help"))
    with open(os.path.join(show_help._HELP_DIR, "help-mpi-errors.txt")) as f:
        mine = f.read()
    with open(os.path.join(r_show_help._HELP_DIR,
                           "help-mpi-errors.txt")) as f:
        assert f.read() == mine


# -- tests/test_memchecker_protocol.py ---------------------------------------
@pytest.fixture
def memcheck(pworld, world):
    for v, mc in ((p_var, p_mc), (r_var, r_mc)):
        v.var_set("mpi_memchecker_enable", True)
        mc._reset_for_tests()
    yield
    for v, mc in ((p_var, p_mc), (r_var, r_mc)):
        v.var_set("mpi_memchecker_enable", False)
        mc._reset_for_tests()


def test_memchecker_detects_inflight_mutation(memcheck):
    def run(s):
        mc = s["mc"]
        buf = np.arange(8, dtype=np.float32)
        mc.inflight(buf, "pending op")
        buf[3] = 99.0                    # the race valgrind would flag
        with pytest.raises(mc.MemcheckError) as ei:
            mc.verify(buf)
        return str(ei.value), mc.violations()
    port, ref = _both(run)
    assert port == ref and port[1] == 1


def test_memchecker_clean_buffer_passes(memcheck):
    def run(s):
        mc = s["mc"]
        buf = np.arange(8, dtype=np.float32)
        mc.inflight(buf)
        mc.verify(buf)                   # untouched: fine
        mc.verify(buf)                   # already released: no-op
        return mc.violations()
    assert _both(run) == (0, 0)


def test_memchecker_undefined_read(memcheck):
    def run(s):
        mc = s["mc"]
        buf = np.zeros(4, np.float32)
        mc.undefined(buf, "posted receive")
        with pytest.raises(mc.MemcheckError) as ei:
            mc.check_readable(buf)
        mc.defined(buf)
        mc.check_readable(buf)           # defined again: fine
        return str(ei.value)
    port, ref = _both(run)
    assert port == ref


def test_memchecker_disabled_is_noop(pworld):
    def run(s):
        mc = s["mc"]
        mc._reset_for_tests()
        buf = np.zeros(4, np.float32)
        mc.inflight(buf)
        buf[0] = 1.0
        mc.verify(buf)                   # disabled: silent
        return mc.violations()
    assert _both(run) == (0, 0)
    t = torch.zeros(4)
    p_mc.inflight(t)
    t[0] = 1.0
    p_mc.verify(t)
    assert len(p_mc._tracked) == 0           # nothing was even recorded


def test_memchecker_tracks_tensors(memcheck):
    """The difference by design: the port tracks tensors (CPU tensors by
    crc32 of their bytes, bf16 and views included); the reference
    ignores every non-numpy buffer."""
    for make in (lambda: torch.arange(8, dtype=torch.float32),
                 lambda: torch.arange(8, dtype=torch.float32).bfloat16(),
                 lambda: torch.arange(16, dtype=torch.int64).view(4, 4)[:, 1],
                 lambda: torch.zeros(3, dtype=torch.complex64)):
        t = make()
        p_mc.inflight(t, "partition")
        p_mc.verify(t)                   # clean
        p_mc.inflight(t, "partition")
        t[1] = 42
        with pytest.raises(p_mc.MemcheckError):
            p_mc.verify(t)
    assert p_mc.violations() == 4 and len(p_mc._tracked) == 0
    t = torch.full((4,), float("nan"))   # NaN bits compare equal to
    p_mc.inflight(t)                     # themselves: no false alarm
    p_mc.verify(t)
    t = torch.zeros(4)
    p_mc.undefined(t)
    with pytest.raises(p_mc.MemcheckError):
        p_mc.check_readable(t)
    p_mc.defined(t)
    p_mc.check_readable(t)
    r = torch.zeros(4)                   # the reference skips tensors
    r_mc.inflight(r)
    r[0] = 1.0
    r_mc.verify(r)
    assert r_mc.violations() == 0


def test_memchecker_partitioned_send_discipline(memcheck, world, pworld):
    """MPI-4: partition i is library-owned from pready(i) to operation
    completion — writing it after pready is non-portable even though
    the engine copies at send; the memchecker flags it at completion.
    Fails on the port before the partitioned send called the
    memchecker."""
    def run(s, comm, parts):
        req = comm.psend_init(parts, dest=1, tag=5)
        rreq = comm.precv_init(0, tag=5, partitions=3, dst=1)
        rreq.start()
        req.start()
        req.pready(0)
        parts[0][0] = 777.0            # violates the pready contract
        req.pready(1)
        with pytest.raises(s["mc"].MemcheckError) as ei:
            req.pready(2)              # completion verifies all parts
        rreq.wait()
        got = [np.asarray(x) for x in rreq.get()]
        return str(ei.value), req.test()[0], got, s["mc"].violations()

    port = run({"mc": p_mc}, pworld, [np.full(4, float(i))
                                     for i in range(3)])
    ref = run({"mc": r_mc}, world, [np.full(4, float(i)) for i in range(3)])
    assert port[0] == ref[0] and "partition 0" in port[0]
    assert port[1] is ref[1] is True   # the transfer itself happened
    for a, b in zip(port[2], ref[2]):
        np.testing.assert_array_equal(a, b)
    assert port[2][0][0] == 0.0        # sent before the write
    assert port[3] == ref[3] == 1
    assert len(p_mc._tracked) == 0         # every entry released


def test_memchecker_partitioned_tensor_parts_and_clean_run(memcheck,
                                                           pworld):
    """Tensor partitions: a clean run completes silently, a write after
    pready raises, and every tracked entry is released either way."""
    parts = [torch.full((4,), float(i)) for i in range(3)]
    for dirty in (False, True):
        req = pworld.psend_init(parts, dest=2, tag=9)
        rreq = pworld.precv_init(0, tag=9, partitions=3, dst=2)
        rreq.start()
        req.start()
        req.pready_range(0, 1)
        if dirty:
            parts[1][2] = -1.0
            with pytest.raises(p_mc.MemcheckError, match="partition 1"):
                req.pready(2)
        else:
            req.pready(2)
        req.wait()
        rreq.wait()
        assert len(p_mc._tracked) == 0
    assert p_mc.violations() == 1


def test_protocol_switch_rendezvous_moves_bytes(world, pworld):
    """Payloads above the eager limit take the rendezvous tier, which
    moves them to the destination rank's device at send time. The
    reference's 8 devices are distinct, so its big payload lands on
    device 3. Every rank of the port's CPU world shares one device, so
    its rendezvous has nothing to move: both payloads are clones where
    they were (SPC ``pml_eager``), never the sender's buffer."""
    import jax
    from ompi_tpu_torch.runtime import spc as p_spc
    r_var.var_set("pml_stacked_eager_limit", 1 << 10)
    try:
        big = jax.device_put(np.ones(4096, np.float32), world.devices[0])
        world.send(big, 0, 3, tag=11)
        data, _ = world.recv(0, tag=11, dst=3)
        assert list(data.devices()) == [world.devices[3]]
        small = jax.device_put(np.ones(16, np.float32), world.devices[0])
        world.send(small, 0, 3, tag=12)
        data2, _ = world.recv(0, tag=12, dst=3)
        assert list(data2.devices()) == [world.devices[0]]
    finally:
        r_var.var_set("pml_stacked_eager_limit", 1 << 16)
    p_var.var_set("pml_stacked_eager_limit", 1 << 10)
    eager0, rndv0 = p_spc.read("pml_eager"), p_spc.read("pml_rndv")
    big = torch.ones(4096)                           # 16 KB > 1 KB
    pworld.send(big, 0, 3, tag=11)
    big[0] = 5.0                                     # after send returns
    pdata, _ = pworld.recv(0, tag=11, dst=3)
    small = torch.ones(16)
    pworld.send(small, 0, 3, tag=12)
    pdata2, _ = pworld.recv(0, tag=12, dst=3)
    np.testing.assert_array_equal(pdata.numpy(), np.asarray(data))
    np.testing.assert_array_equal(pdata2.numpy(), np.asarray(data2))
    assert pdata.device == pworld.devices[3] and pdata.data_ptr() != \
        big.data_ptr()
    assert p_spc.read("pml_eager") - eager0 == 2
    assert p_spc.read("pml_rndv") == rndv0


def test_perrank_engine_thread_stress():
    """The per-rank matching engine under concurrent senders/receivers
    (loopback router): no lost or duplicated messages, FIFO per tag
    stream, in both packages."""
    from ompi_tpu.pml import perrank as r_pr
    from ompi_tpu_torch.pml import perrank as p_pr

    class _C:
        cid = "stress"
        size = 1

        def rank(self):
            return 0

        def world_rank_of(self, r):
            return 0

    for mod in (p_pr, r_pr):
        kv = {}
        router = mod.Router(0, 1, kv.__setitem__, kv.__getitem__)
        eng = mod.PerRankEngine(_C(), router)
        NT, NMSG = 4, 200
        errors = []

        def sender(t):
            for i in range(NMSG):
                eng.send(np.array([t, i]), 0, tag=t)

        def receiver(t):
            try:
                for i in range(NMSG):
                    data, st = eng.recv(source=0, tag=t, timeout=60)
                    assert data[0] == t and data[1] == i, (t, i, data)
            except Exception as e:          # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=f, args=(t,))
                   for t in range(NT) for f in (sender, receiver)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        alive = [th for th in threads if th.is_alive()]
        router.close()
        assert not alive and not errors, (mod.__name__, errors[:3])


def test_stacked_engine_thread_stress(world, pworld):
    """The single-controller matching engine (native C++ core when it
    loaded) under threads: per-thread tag streams stay FIFO and nothing
    is lost, in both packages. The reference's world takes one message
    first: its engine is made on a comm's first pt2pt call without a
    lock, so threads racing to that call can make two engines and lose
    messages (ROADMAP queue C). The
    port's engine is made under a lock, so its threads start on a fresh
    ``dup()``."""
    world.send(np.zeros(1), 0, 1, tag=99)
    world.recv(0, tag=99, dst=1)
    for comm in (pworld.dup(), world):
        NT, NMSG = 4, 100
        errors = []

        def worker(t):
            try:
                for i in range(NMSG):
                    comm.send(np.array([t, i]), 0, 1, tag=100 + t)
                for i in range(NMSG):
                    data, _ = comm.recv(0, tag=100 + t, dst=1)
                    assert data[1] == i, (t, i, data)
            except Exception as e:          # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(NT)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        assert not errors, errors[:3]


def test_stacked_engine_made_once_under_threads(pworld, monkeypatch):
    """Threads racing to a fresh comm's first pt2pt call share one
    matching engine. An engine that is slow to build (10 ms here) widens
    the window in which, without the lock, each thread would make its
    own and receive from an empty one."""
    from ompi_tpu_torch.pml import stacked
    made = []
    real = stacked.MatchingEngine.__init__

    def slow_init(self, comm):
        made.append(self)
        import time
        time.sleep(0.01)
        real(self, comm)
    monkeypatch.setattr(stacked.MatchingEngine, "__init__", slow_init)
    comm = pworld.dup()
    errors = []
    start = threading.Barrier(4)

    def worker(t):
        try:
            start.wait(timeout=30)
            comm.send(np.array([t]), t, 4 + t, tag=7)
            data, _ = comm.recv(t, tag=7, dst=4 + t)
            assert int(data[0]) == t
        except Exception as e:          # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert not errors and len(made) == 1, (errors[:2], len(made))


# -- the mpiext tests of tests/test_mpiext_debuggers.py -----------------------
def test_accel_queries(world, pworld):
    """The meaning is the reference's (does the device plane carry
    device buffers natively?); the answers are swapped by design."""
    assert r_accel.Query_tpu_support() is True
    assert r_accel.Query_cuda_support() is False
    assert p_accel.Query_tpu_support() is False
    assert p_accel.Query_cuda_support() is torch.cuda.is_available()
    assert p_accel.Query_rocm_support() is r_accel.Query_rocm_support() \
        is False
    rinv, pinv = r_accel.Device_inventory(), p_accel.Device_inventory()
    assert len(rinv) >= world.size
    assert len(pinv) == max(1, torch.cuda.device_count())
    want = {"id", "platform", "process_index"}
    assert want <= set(rinv[0]) and want <= set(pinv[0])
    assert pinv[0]["platform"] == ("gpu" if torch.cuda.is_available()
                                   else "cpu")


@pytest.mark.parametrize("dt", ["float16", "bfloat16"])
def test_shortfloat_alias_reduces(world, pworld, rng, dt):
    assert r_shortfloat.SHORT_FLOAT is R.FLOAT16
    assert r_shortfloat.C_BF16 is R.BFLOAT16
    assert p_shortfloat.SHORT_FLOAT is P.FLOAT16
    assert p_shortfloat.C_SHORT_FLOAT is P.FLOAT16
    assert p_shortfloat.C_BF16 is P.BFLOAT16
    x = rng.standard_normal((world.size, 8)).astype(np.float32)
    if dt == "float16":
        rbuf = world.stack([r.astype(np.float16) for r in x])
    else:
        import jax.numpy as jnp
        rbuf = world.stack([jnp.asarray(r, jnp.bfloat16) for r in x])
    pbuf = pworld.stack([torch.from_numpy(r).to(getattr(torch, dt))
                         for r in x])
    assert pbuf.dtype is p_shortfloat.C_BF16.base if dt == "bfloat16" \
        else pbuf.dtype is p_shortfloat.SHORT_FLOAT.base
    rout = np.asarray(world.allreduce(rbuf, R.SUM)).astype(np.float32)
    pout = pworld.allreduce(pbuf, P.SUM).float().numpy()
    want = x.astype(np.float64).sum(0)
    np.testing.assert_allclose(rout[0], want, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(pout[0], want, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(pout, rout, rtol=2e-2, atol=2e-2)


def test_affinity_strings(world, pworld):
    for mod, comm in ((p_affinity, pworld), (r_affinity, world)):
        req, actual, full = mod.Affinity_str(comm, rank=2)
        assert req == actual and "rank 2" in actual
        amap = mod.Affinity_map(comm)
        assert len(amap) == comm.size
        assert all(f"rank {r}" in amap[r] for r in range(comm.size))
        assert full == "; ".join(amap)
    # the device names: type:index here, platform:id in the reference
    assert all(" bound to cpu:0 " in s for s in p_affinity.Affinity_map(
        pworld))
    assert " bound to cpu:2 " in r_affinity.Affinity_str(world, 2)[1]


# -- MPI_T (test_aux.py, test_api_surface.py, test_trace_satellites.py) -------
def test_mpi_t_cvars_pvars(world, pworld):
    def run(s, comm, prio):
        tool = s["tool"]
        tool.init_thread()
        assert tool.cvar_get_num() > 5
        got = tool.cvar_read(prio)
        comm.barrier()
        names = [p["name"] for p in tool.pvar_list()]
        assert "spc_coll_barrier" in names
        assert tool.pvar_read("spc_coll_barrier") >= 1
        assert tool.pvar_get_num() == len(names)
        info = tool.cvar_get_info(tool.cvar_names().index(prio))
        tool.finalize()
        return got, info["name"], info["type"], info["default"]
    port = run({"tool": p_tool}, pworld, "coll_torch_priority")
    ref = run({"tool": r_tool}, world, "coll_xla_priority")
    assert port[0] == ref[0] == 40 and port[2:] == ref[2:]
    # a cvar write is read back, through the var store too
    p_tool.cvar_write("coll_base_verbose", 3)
    assert p_tool.cvar_read("coll_base_verbose") == 3 == \
        p_var.var_get("coll_base_verbose")
    assert [v["name"] for v in p_tool.cvar_list()] == p_tool.cvar_names()


def test_mpi_t_events(world, pworld):
    def run(s, comm):
        tool = s["tool"]
        assert tool.event_get_num() > 0
        assert "coll_allreduce" in tool.event_list()
        seen = []
        h = tool.event_handle_alloc(
            "coll_allreduce", lambda ev, c, info: seen.append(ev))
        x = comm.alloc((2,), np.float32, fill=1.0)
        comm.allreduce(x, s["pkg"].SUM)
        tool.event_handle_free(h)
        comm.allreduce(x, s["pkg"].SUM)
        info = tool.event_get_info(tool.event_list().index(
            "coll_allreduce"))
        h2 = tool.event_handle_alloc("tools_plane_new_event",
                                     lambda *a: None)
        learned = "tools_plane_new_event" in tool.event_list()
        h2.free()
        return seen, info, learned
    port = run({"tool": p_tool, "pkg": P}, pworld)
    ref = run({"tool": r_tool, "pkg": R}, world)
    assert port == ref
    assert port[0] == ["coll_allreduce"] and port[2] is True


def test_event_handle_dropped_increments_per_handle(capsys):
    def run(s):
        hooks, tool = s["hooks"], s["tool"]
        hooks._reset_drops_for_tests()

        def bad_cb(event, comm, info):
            raise RuntimeError("handler bug")

        ok_events = []
        h_bad = tool.event_handle_alloc("coll_reduce", bad_cb)
        h_ok = tool.event_handle_alloc(
            "coll_reduce", lambda e, c, i: ok_events.append(e))
        try:
            hooks.fire("coll_reduce", None, {})
            hooks.fire("coll_reduce", None, {})
            hooks.fire("coll_scatter", None, {})   # filtered: no drop
            return h_bad.dropped, h_ok.dropped, ok_events, hooks.dropped()
        finally:
            tool.event_handle_free(h_bad)
            tool.event_handle_free(h_ok)
            hooks._reset_drops_for_tests()
    port, ref = _both(run)
    assert port == ref == (2, 0, ["coll_reduce"] * 2, 2)
    capsys.readouterr()                          # swallow the logs


def test_decision_table_compression_rows_follow_the_var(world, pworld):
    def run(s):
        tool, v = s["tool"], s["var"]
        t_off = tool.decision_table(comm_size=N, platform="cpu")
        assert not any("compressed" in str(rule[2])
                       for rules in t_off.values() for rule in rules)
        q_off = tool.decision_query("allreduce", N, 8 << 20,
                                    platform="cpu", op=s["pkg"].SUM)
        assert q_off["compressed"] is False and q_off["algorithm"]
        v.var_set("mpi_base_compress", True)
        try:
            t_on = tool.decision_table(comm_size=N, platform="cpu")
            q_on = tool.decision_query("allreduce", N, 8 << 20,
                                       platform="cpu", dtype="float32",
                                       op=s["pkg"].SUM)
            q_max = tool.decision_query("allreduce", N, 8 << 20,
                                        platform="cpu", op=s["pkg"].MAX)
            q_int = tool.decision_query("allreduce", N, 8 << 20,
                                        platform="cpu", dtype="int32",
                                        op=s["pkg"].SUM)
        finally:
            v.var_set("mpi_base_compress", False)
        assert q_on["compressed"] is True and q_on["codec"] == "int8_block"
        assert not q_max["compressed"] and not q_int["compressed"]
        return t_off, q_off, t_on, q_on
    port, ref = _both(run)
    assert port == ref


def test_decision_table_persistent_and_bucket_rows(world, pworld):
    def run(s):
        tool, v = s["tool"], s["var"]
        t_off = tool.decision_table(comm_size=N, platform="cpu")
        v.var_set("mpi_base_bucket", True)
        try:
            t_on = tool.decision_table(comm_size=N, platform="cpu")
        finally:
            v.var_set("mpi_base_bucket", False)
        rows = [r for r in t_on["allreduce"]
                if str(r[2]).startswith("bucket_fuse:")]
        assert rows
        return t_off, t_on
    port, ref = _both(run)
    assert port == ref
    assert port[0]["allreduce_init"] == [[0, 0, "persistent_prebound"]]


def test_decision_table_reads_the_worlds_platform(world, pworld):
    """Without ``platform`` the port reads the running world's rows
    (``"cpu"`` here, ``"gpu"`` on a CUDA world); the reference reads its
    platform-free rows. Both answer alike for an explicit platform."""
    assert p_tool.decision_table(N) == p_tool.decision_table(
        N, platform="cpu")
    assert r_tool.decision_table(N) == r_tool.decision_table(
        N, platform="")
    for plat in ("cpu", "gpu"):
        assert p_tool.decision_table(N, platform=plat) == \
            r_tool.decision_table(N, platform=plat)
    assert r_tool.decision_table(N, platform="gpu") == \
        r_tool.decision_table(N, platform="")
    assert p_tool.decision_query("reduce", N, 64)["algorithm"] == "alias"


def test_flightrec_payload_carries_the_decision_table(pworld):
    from ompi_tpu_torch.telemetry import flightrec
    payload = flightrec.snapshot("tools_plane_probe", rank=0)
    assert payload["decision"] == p_tool.decision_table()
    assert payload["decision"]["allreduce_init"] == [
        [0, 0, "persistent_prebound"]]


# -- repair: the fatal handler renders the reference's help topics -----------
@pytest.mark.parametrize("err", ["ERR_REVOKED", "ERR_PROC_FAILED"])
def test_fatal_handler_renders_help_like_the_reference(world, pworld,
                                                       capsys, err):
    """The same fatal error on the same-named communicator, raised in
    each package, puts the same text on stderr and exits with the error
    class. Fails on the port before ``_fatal`` rendered the catalog."""
    def run(pkg, comm, sh):
        sh._reset_for_tests()
        d = comm.dup()
        d.name = "comm#fatal"
        d.set_errhandler(pkg.ERRORS_ARE_FATAL)
        if err == "ERR_REVOKED":
            d.revoke()
        capsys.readouterr()
        with pytest.raises(SystemExit) as ei:
            d._err(getattr(pkg, err), "communicator has been revoked"
                   if err == "ERR_REVOKED" else "peer 3 failed")
        out = capsys.readouterr().err
        sh._reset_for_tests()
        return ei.value.code, out
    port = run(P, pworld, p_show_help)
    ref = run(R, world, r_show_help)
    assert port == ref
    topic = "revoked" if err == "ERR_REVOKED" else "process failure"
    assert topic in port[1] and "comm#fatal" in port[1]
    assert port[1].endswith("*** MPI_ERRORS_ARE_FATAL (job will abort)\n")
    assert port[0] == getattr(P, err)
