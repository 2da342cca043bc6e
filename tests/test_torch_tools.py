"""The port's reader and probe tools against the reference's.

Mirrors, through both packages on the same inputs:
``tests/test_tools_profile.py`` (comm_method, mpisync, profile), the six
MPIR/PERUSE tests of ``tests/test_mpiext_debuggers.py``,
``tests/test_aux.py::test_info_tool`` (compared by keys and meaning),
and ``tests/test_trace_export.py::test_tracedump_cli_merges_dumps`` and
``::test_bench_trace_summary_roundtrips_json``. The port runs on its
8-rank CPU world (``Init(devices=["cpu"] * 8)``), the reference on the
conftest's 8-device world. Differences by design: the port names its
devices ``type:index`` (``cpu:0``), its data plane ``torch/host`` (the
reference's is ``xla/host``), and its device component ``torch`` (the
reference's ``xla``).
"""
import importlib
import itertools
import json
import time

import numpy as np
import pytest

import ompi_tpu_torch as P

N = 8
PKGS = ["ompi_tpu", "ompi_tpu_torch"]


@pytest.fixture()
def pworld():
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    yield P.get_comm_world()
    P._reset_for_tests()


@pytest.fixture()
def both(pworld, world, mpi):
    """(package name, its MPI module, its world) for each package."""
    return [("ompi_tpu", mpi, world), ("ompi_tpu_torch", P, pworld)]


def _tool(pkg, name):
    return importlib.import_module(f"{pkg}.tools.{name}")


def _var(pkg):
    return importlib.import_module(f"{pkg}.mca.var")


# -- comm_method --------------------------------------------------------
def test_comm_method_table(both):
    tables = {}
    for pkg, _mpi, w in both:
        cm = _tool(pkg, "comm_method")
        t = cm.table(w)
        assert t["size"] == w.size == N
        assert t["coll"] == w._coll_winners
        assert t["coll"]["barrier"]
        names = [n for n, _p in t["priorities"]]
        assert "basic" in names
        text = cm.format_table(w)
        assert "coll selection" in text and "allreduce" in text
        tables[pkg] = t
    ref, port = tables["ompi_tpu"], tables["ompi_tpu_torch"]
    assert ref["coll"]["allreduce"] in ("tuned", "xla")
    assert port["coll"]["allreduce"] in ("tuned", "torch")
    assert set(ref["coll"]) == set(port["coll"])
    assert ref["platform"] == port["platform"] == "cpu"
    assert (ref["data_plane"], port["data_plane"]) == ("xla/host",
                                                       "torch/host")
    assert port["devices"] == ["cpu:0"] * N
    assert ref["hosts"] == port["hosts"] == 1


def test_comm_method_display_var(both, capsys):
    for pkg, _mpi, w in both:
        var = _var(pkg)
        var.var_set("hook_comm_method_display", True)
        try:
            c = w.dup()
            out = capsys.readouterr().out
            assert "coll selection" in out, pkg
            c.free()
        finally:
            var.var_set("hook_comm_method_display", False)
        d = w.dup()
        assert "coll selection" not in capsys.readouterr().out
        d.free()


# -- mpisync ------------------------------------------------------------
@pytest.mark.parametrize("pkg", PKGS)
def test_mpisync_offset_estimator(pkg):
    base = itertools.count()

    def local_now():
        return next(base) * 1e-4            # 100 us per local sample

    def remote_now():
        return next(base) * 1e-4 + 5.0

    off, rtt = _tool(pkg, "mpisync").measure_offset(
        remote_now, rounds=8, local_now=local_now)
    assert abs(off - 5.0) < 1e-3
    assert rtt == pytest.approx(2e-4)


def test_mpisync_report_controller_clock(both):
    rows = {}
    for pkg, _mpi, w in both:
        rows[pkg] = _tool(pkg, "mpisync").sync_report(w, rounds=2)
        assert len(rows[pkg]) == w.size
        for row in rows[pkg]:
            assert row["offset_s"] == 0.0   # one controller, one clock
            assert row["clock"] == "controller"
    assert rows["ompi_tpu"] == rows["ompi_tpu_torch"]


@pytest.mark.parametrize("pkg", PKGS)
def test_mpisync_remote_probe_and_unprobed(pkg):
    class Dev:
        def __init__(self, pi):
            self.process_index = pi

    class FakeComm:
        size = 3
        devices = [Dev(0), Dev(1), Dev(2)]

    probes = {1: lambda: time.perf_counter() + 2.0}
    rows = _tool(pkg, "mpisync").sync_report(FakeComm(), rounds=4,
                                             remote_clocks=probes)
    assert rows[0]["offset_s"] == 0.0
    assert abs(rows[1]["offset_s"] - 2.0) < 0.1   # probed remote clock
    assert rows[2]["offset_s"] is None            # unprobed
    assert "unprobed" in rows[2]["clock"]


# -- profile ------------------------------------------------------------
def test_profile_pt2pt_matrix(both):
    mats = {}
    for pkg, _mpi, w in both:
        profile = _tool(pkg, "profile")
        comm = w.dup()
        comm.send(np.float32([1, 2, 3]), src=1, dest=0, tag=1)
        comm.recv(source=1, tag=1, dst=0)
        comm.send(np.float32([4]), src=1, dest=2, tag=2)
        comm.recv(source=1, tag=2, dst=2)
        m = profile.pt2pt_matrix(comm, "messages")
        assert m[1, 0] == 1 and m[1, 2] == 1 and m.sum() == 2
        b = profile.pt2pt_matrix(comm, "bytes")
        assert b[1, 0] == 12 and b[1, 2] == 4
        assert len(profile.to_csv(m).splitlines()) == w.size
        assert "pt2pt bytes" in profile.report(comm)
        mats[pkg] = (m, b)
        comm.free()
    for a, b in zip(mats["ompi_tpu"], mats["ompi_tpu_torch"]):
        np.testing.assert_array_equal(a, b)


def test_profile_coll_table(both):
    calls = {}
    for pkg, mpi, w in both:
        var, profile = _var(pkg), _tool(pkg, "profile")
        var.var_set("coll_monitoring_enable", True)
        try:
            comm = w.dup()
            x = comm.stack([np.float32([r]) for r in range(comm.size)])
            comm.allreduce(x, mpi.SUM)
            comm.allreduce(x, mpi.SUM)
            table = profile.coll_table()
            mine = {f: v for (cid, f), v in table.items()
                    if str(cid) == str(comm.cid)}
            assert "allreduce" in mine, table
            assert "collectives:" in profile.report(comm)
            calls[pkg] = mine["allreduce"]
            comm.free()
        finally:
            var.var_set("coll_monitoring_enable", False)
    assert calls["ompi_tpu"] == calls["ompi_tpu_torch"]
    assert calls["ompi_tpu_torch"][0] == 2


# -- MPIR and PERUSE ----------------------------------------------------
def test_mpir_proctable(both):
    tables = {}
    for pkg, _mpi, w in both:
        pt = _tool(pkg, "debuggers").proctable(w)
        assert len(pt) == w.size
        assert pt[3]["rank"] == 3
        assert pt[0]["pid"] > 0 and pt[0]["host_name"]
        assert ":" in pt[0]["device"]
        tables[pkg] = pt
    strip = [{k: v for k, v in e.items() if k != "device"}
             for e in tables["ompi_tpu_torch"]]
    assert strip == [{k: v for k, v in e.items() if k != "device"}
                     for e in tables["ompi_tpu"]]
    assert [e["device"] for e in tables["ompi_tpu_torch"]] == \
        ["cpu:0"] * N                       # ranks are slots of one device
    assert [e["device"] for e in tables["ompi_tpu"]] == \
        [f"cpu:{i}" for i in range(N)]


@pytest.mark.parametrize("pkg", PKGS)
def test_mpir_breakpoint_and_flag(pkg):
    dbg = _tool(pkg, "debuggers")
    fired = []
    dbg.on_breakpoint(lambda: fired.append(1))
    try:
        dbg.set_being_debugged(True)
        assert dbg.MPIR_being_debugged
        dbg.MPIR_Breakpoint()
        assert fired == [1]
    finally:
        dbg.set_being_debugged(False)
        dbg._breakpoint_hooks.clear()


@pytest.mark.parametrize("native", ["1", "0"])
def test_message_queue_dump(both, monkeypatch, native):
    """Both matching engines of the port: the native queues and the
    Python ones (``OMPI_TPU_TORCH_DISABLE_NATIVE_MATCH``)."""
    monkeypatch.setenv("OMPI_TPU_TORCH_DISABLE_NATIVE_MATCH",
                       "" if native == "1" else "1")
    seen = {}
    for pkg, _mpi, w in both:
        c = w.dup()
        c.isend(np.ones(3, np.float32), src=0, dest=1, tag=42)
        req = c.irecv(source=2, tag=7, dst=3)
        q = _tool(pkg, "debuggers").message_queues(c)
        assert any(u["tag"] == 42 for u in q["unexpected"])
        assert any(p["tag"] == 7 for p in q["posted"])
        only = _tool(pkg, "debuggers").message_queues(c, dst=3)
        assert not only["unexpected"] and len(only["posted"]) == 1
        seen[pkg] = sorted(p["tag"] for p in q["posted"]), \
            sorted(u["tag"] for u in q["unexpected"])
        c.recv(source=0, tag=42, dst=1)
        c.send(np.ones(1, np.float32), src=2, dest=3, tag=7)
        req.wait()
        c.free()
    assert seen["ompi_tpu"] == seen["ompi_tpu_torch"]


@pytest.mark.parametrize("pkg", PKGS)
def test_peruse_lifecycle(pkg):
    peruse = _tool(pkg, "peruse")
    assert peruse.Init() == peruse.PERUSE_SUCCESS
    assert "PERUSE_COMM_REQ_ACTIVATE" in peruse.Query_supported_events()
    assert peruse.Query_event("PERUSE_COMM_COLL_BEGIN")
    assert not peruse.Query_event("PERUSE_NOT_A_THING")
    assert peruse.Event_comm_register("PERUSE_NOT_A_THING", None,
                                      lambda *a: None) is None


def test_peruse_supported_events_match(both):
    assert _tool("ompi_tpu", "peruse").Query_supported_events() == \
        _tool("ompi_tpu_torch", "peruse").Query_supported_events()


def test_peruse_events_fire_per_comm(both):
    fired = {}
    for pkg, mpi, w in both:
        peruse = _tool(pkg, "peruse")
        c, other = w.dup(), w.dup()
        seen = []
        h = peruse.Event_comm_register(
            "PERUSE_COMM_COLL_BEGIN", c,
            lambda ev, comm, info: seen.append(ev))
        h.start()
        x = c.stack([np.ones(4, np.float32)] * c.size)
        c.allreduce(x, mpi.SUM)
        other.allreduce(other.stack([np.ones(2, np.float32)] * other.size),
                        mpi.SUM)            # another comm: not counted
        assert h.fired == 1 and seen == ["PERUSE_COMM_COLL_BEGIN"]
        h.stop()
        c.allreduce(x, mpi.SUM)
        assert h.fired == 1                 # stopped: no events
        h.start()
        c.barrier()
        assert h.fired == 2
        h.free()
        c.barrier()
        fired[pkg] = h.fired
        c.free()
        other.free()
    assert fired == {"ompi_tpu": 2, "ompi_tpu_torch": 2}


def test_peruse_pt2pt_events(both):
    for pkg, _mpi, w in both:
        c = w.dup()
        seen = []
        h = _tool(pkg, "peruse").Event_comm_register(
            "PERUSE_COMM_REQ_ACTIVATE", c,
            lambda ev, comm, info: seen.append(ev))
        h.start()
        c.send(np.ones(2, np.float32), src=0, dest=1, tag=1)
        c.recv(source=0, tag=1, dst=1)
        assert h.fired == 2, pkg            # send + recv activations
        h.free()
        c.free()


# -- info ---------------------------------------------------------------
def test_info_tool(both):
    ref = _tool("ompi_tpu", "info").collect(all_vars=True)
    port = _tool("ompi_tpu_torch", "info").collect(all_vars=True)
    assert "xla" in ref["frameworks"]["coll"]
    assert "tuned" in ref["frameworks"]["coll"]
    assert any(v["name"] == "coll_xla_priority" for v in ref["mca_vars"])
    # the port: the same keys, its own components and vars
    assert set(ref) <= set(port)
    assert "torch" in port["frameworks"]["coll"]
    assert "tuned" in port["frameworks"]["coll"]
    assert any(v["name"] == "coll_torch_priority"
               for v in port["mca_vars"])
    assert set(ref["frameworks"]) <= set(port["frameworks"])
    shared = set(ref["frameworks"]["coll"]) - {"xla"}
    assert shared <= set(port["frameworks"]["coll"])
    assert port["frameworks"]["topo"] == sorted(ref["frameworks"]["topo"])
    assert "stacked" in port["frameworks"]["pml"]
    assert "xla_window" not in port["frameworks"]["osc"]
    assert port["platform"] == ["cpu:0"]    # no CUDA device here
    assert port["native_convertor"] == P.native.native_available()
    assert ref["mpi_standard"] == port["mpi_standard"]
    assert isinstance(port["pvars"], list) and port["pvars"]


# -- tracedump ----------------------------------------------------------
BASE = 1000.0
OFFSETS = {0: 0.0, 1: 0.25, 2: -0.125, 3: 0.5}
LATE_RANK, LATE_BY = 2, 0.050


def _skewed_barrier_spans(pkg, seq=0):
    """coll_barrier on comm 'w': every rank arrives at BASE (+50 ms for
    the late rank) in true time and records on its own skewed clock."""
    Span = importlib.import_module(f"{pkg}.trace.ring").Span
    spans = []
    for rank, off in OFFSETS.items():
        t_arr = BASE + (LATE_BY if rank == LATE_RANK else 0.0)
        t_end = BASE + LATE_BY + 0.010
        spans.append(Span("coll_barrier", t_arr + off, t_end - t_arr,
                          tid=100 + rank, rank=rank, cid="w", seq=seq))
    return spans


@pytest.mark.parametrize("pkg", PKGS)
def test_tracedump_cli_merges_dumps(tmp_path, pkg):
    tracedump = _tool(pkg, "tracedump")
    files = []
    for rank, off in OFFSETS.items():
        mine = [s.to_dict() for s in _skewed_barrier_spans(pkg)
                if s.rank == rank]
        p = tmp_path / f"trace_r{rank}.json"
        p.write_text(json.dumps({"rank": rank, "offset_s": off,
                                 "spans": mine}))
        files.append(str(p))
    out = tmp_path / "perfetto.json"
    assert tracedump.main(files + ["-o", str(out)]) == 0
    evs = json.loads(out.read_text())["traceEvents"]
    assert {e["pid"] for e in evs} == set(OFFSETS)
    rep = tmp_path / "report.json"
    assert tracedump.main(files + ["--format", "report", "-o",
                                   str(rep)]) == 0
    report = json.loads(rep.read_text())
    assert report["late_arrival"][0]["critical_rank"] == LATE_RANK
    summ = tmp_path / "summary.json"
    assert tracedump.main(files + ["--format", "summary", "-o",
                                   str(summ)]) == 0
    (tmp_path / f"{pkg}.summary").write_text(summ.read_text())


def test_tracedump_outputs_agree(tmp_path):
    """The same dumps through both tools give the same Perfetto events
    and the same summary."""
    outs = {}
    for pkg in PKGS:
        files = []
        for rank, off in OFFSETS.items():
            p = tmp_path / f"{pkg}_r{rank}.json"
            p.write_text(json.dumps({
                "rank": rank, "offset_s": off,
                "spans": [s.to_dict() for s in _skewed_barrier_spans(pkg)
                          if s.rank == rank]}))
            files.append(str(p))
        got = []
        for fmt in ("perfetto", "summary", "report"):
            o = tmp_path / f"{pkg}.{fmt}"
            assert _tool(pkg, "tracedump").main(
                files + ["--format", fmt, "-o", str(o)]) == 0
            got.append(json.loads(o.read_text()))
        outs[pkg] = got
    ref, port = outs["ompi_tpu"], outs["ompi_tpu_torch"]
    assert ref[0] == port[0]
    assert ref[1] == port[1]
    assert ref[2]["late_arrival"] == port[2]["late_arrival"]


@pytest.mark.parametrize("pkg", PKGS)
def test_bench_trace_summary_roundtrips_json(pkg):
    """The record contract: the attached trace summary is machine
    readable, a JSON round trip is identical. (The reference also checks
    its ``bench._trace_summary``; the port has no bench yet.)"""
    core = importlib.import_module(f"{pkg}.trace.core")
    attribution = importlib.import_module(f"{pkg}.trace.attribution")
    core.disable()
    core.reset()
    attribution.reset_watermarks()
    try:
        core.enable(capacity=32)
        for s in _skewed_barrier_spans(pkg):
            s.ts -= OFFSETS[s.rank]         # one process, one timebase
            core._ring.push(s)
        summary = attribution.summarize(core.spans(), core.stats())
        assert json.loads(json.dumps(summary)) == summary
        assert summary["spans"] == 4
        assert summary["by_name"]["coll_barrier"]["count"] == 4
        assert summary["late_arrival_top"][0]["critical_rank"] == LATE_RANK
    finally:
        core.disable()
        core.reset()
        attribution.reset_watermarks()


# -- p22's mpisync and comm_method halves, and p29's stage_probe row ------
P22_TOOLS = """
    from ompi_tpu_torch.tools import comm_method, mpisync
    MPI.Init()
    w = MPI.get_comm_world()
    r, n = w.rank(), w.size
    rows = mpisync.sync_report_perrank(w, rounds=6)
    assert len(rows) == n and rows[0]["offset_s"] == 0.0
    for row in rows[1:]:
        # one host, one clock source: the offset is bounded by the
        # measured round trip (mpigclock's own invariant)
        assert abs(row["offset_s"]) <= max(row["rtt_s"], 1e-3), row
        assert row["rtt_s"] > 0
    w.send(np.arange(4.0), (r + 1) % n, tag=3)
    w.recv((r - 1) % n, tag=3)
    w.barrier()
    t = comm_method.table(w)
    assert t["coll"] == {"*": "rankcomm-builtin"}, t
    assert t["platform"] == "cpu" and t["devices"] == ["cpu:0"], t
    assert t["data_plane"] == "torch/host"
    assert t["pt2pt_transports"]["tcp"] + t["pt2pt_transports"]["sm"] > 0
    assert t["btl_sm"] in (True, False)
    assert t["stage_probe"].get("staged_per_mb_ms") is not None, t
    MPI.Finalize()
    print(f"OK p22_tools rank={r}/{n}", flush=True)
    """


def test_p22_mpisync_and_comm_method_halves(tmp_path):
    from test_torch_perrank import run_job, write_prog
    rc, out, err = run_job(write_prog(tmp_path, "p22_tools", P22_TOOLS), 3)
    assert rc == 0, f"rc={rc}\n--- out\n{out}\n--- err\n{err[-4000:]}"
    assert out.count("OK p22_tools") == 3, out
