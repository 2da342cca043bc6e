"""The port's tracing plane against the reference's: the span ring and its
gate (``tests/test_trace_ring.py``), the Perfetto export and late-arrival
attribution (``tests/test_trace_export.py``, less the two tests that wait
for ``tools/tracedump``), the hooks, SPC and monitoring satellites
(``tests/test_trace_satellites.py``), profiling hooks and the monitoring
component (``tests/test_aux.py``) and coll/sync
(``tests/test_sync_adapt.py``).

Every test that feeds data gives both packages the same: the same pushes,
begin/end calls, hook chains and counter records go through both modules
and the observations (acceptance, counts, names, sequences, args, pvars,
stderr lines) must be identical; the same synthetic spans go through both
exporters and both attribution layers and must give identical output;
live collectives run on the port's 8-rank CPU world and the reference's
8-device world with the same seeded inputs, and their spans, counters,
hook events and results must agree (exact for data movement, counts and
integer sums, rtol 1e-6 for float32 sums). Only host times, thread ids
and file paths differ between the two runs and are not compared.
"""
import contextlib
import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ompi_tpu as R
import ompi_tpu_torch as P
from ompi_tpu.mca import pvar as r_pvar
from ompi_tpu.mca import var as r_var
from ompi_tpu.runtime import spc as r_spc
from ompi_tpu.trace import attribution as r_attr
from ompi_tpu.trace import core as r_core
from ompi_tpu.trace import perfetto as r_perfetto
from ompi_tpu.trace.ring import Span as RSpan
from ompi_tpu.trace.ring import SpanRing as RSpanRing
from ompi_tpu.utils import hooks as r_hooks
from ompi_tpu_torch.mca import pvar, var
from ompi_tpu_torch.runtime import spc
from ompi_tpu_torch.trace import attribution, perfetto
from ompi_tpu_torch.trace import core as trace_core
from ompi_tpu_torch.trace.ring import Span, SpanRing
from ompi_tpu_torch.utils import hooks

N = 8

PORT = SimpleNamespace(name="port", core=trace_core, pvar=pvar, var=var,
                       spc=spc, hooks=hooks, Span=Span, SpanRing=SpanRing,
                       attribution=attribution, perfetto=perfetto)
REF = SimpleNamespace(name="ref", core=r_core, pvar=r_pvar, var=r_var,
                      spc=r_spc, hooks=r_hooks, Span=RSpan,
                      SpanRing=RSpanRing, attribution=r_attr,
                      perfetto=r_perfetto)
BOTH = (PORT, REF)


@pytest.fixture(autouse=True)
def _clean():
    P._reset_for_tests()
    r_core.disable()
    r_core.reset()
    yield
    P._reset_for_tests()
    r_core.disable()
    r_core.reset()


@pytest.fixture()
def pworld():
    P.Init(devices=["cpu"] * N)
    return P.get_comm_world()


@contextlib.contextmanager
def _tracing(pkg, capacity=16):
    """A fresh ring of ``capacity`` in ``pkg``'s tracer, disabled and
    emptied again on the way out."""
    pkg.core.disable()
    pkg.core.reset()
    pkg.core.enable(capacity=capacity)
    try:
        yield pkg.core
    finally:
        pkg.core.disable()
        pkg.core.reset()


def _both(fn):
    """Run ``fn(pkg)`` on the port and on the reference and return the
    port's observation after asserting the two are identical."""
    port, ref = fn(PORT), fn(REF)
    assert port == ref, (port, ref)
    return port


def _span(cls, name="coll_allreduce", ts=0.0, dur=1e-6, rank=0):
    return cls(name, ts, dur, tid=1, rank=rank)


def _spans_of(core):
    return [(s.name, s.kind, s.cid, s.seq, s.args) for s in core.spans()]


# -- the ring and its gate (tests/test_trace_ring.py) ---------------------
def test_ring_never_grows_past_capacity_and_counts_drops():
    def run(pkg):
        ring = pkg.SpanRing(4)
        accepted = [ring.push(_span(pkg.Span, ts=float(i))) for i in range(7)]
        return (accepted, len(ring), ring.pushed, ring.dropped,
                [s.ts for s in ring.snapshot()])

    accepted, n, pushed, dropped, kept = _both(run)
    assert accepted == [True] * 4 + [False] * 3
    assert n == 4 and pushed == 4 and dropped == 3
    # drop-newest: a runaway trace truncates, it never evicts the window
    assert kept == [0.0, 1.0, 2.0, 3.0]


def test_overflow_surfaces_through_trace_dropped_pvar():
    def run(pkg):
        with _tracing(pkg, capacity=2) as core:
            for _ in range(5):
                core.end(core.begin("coll_barrier", cid="w"))
            return (pkg.pvar.pvar_read("trace_spans"),
                    pkg.pvar.pvar_read("trace_dropped"), _spans_of(core))

    n_spans, n_dropped, kept = _both(run)
    assert n_spans == 2 and n_dropped == 3
    assert kept == [("coll_barrier", "span", "w", 0, None),
                    ("coll_barrier", "span", "w", 1, None)]


def test_begin_end_records_duration_tid_and_args():
    def run(pkg):
        with _tracing(pkg) as core:
            tok = core.begin("pml_send", dest=3, tag=7)
            core.end(tok, nbytes=8)
            (s,) = core.spans()
            return (s.name, s.kind, s.dur >= 0.0,
                    s.tid == threading.get_ident(), s.args)

    assert _both(run) == ("pml_send", "span", True, True,
                          {"dest": 3, "tag": 7, "nbytes": 8})


def test_sequence_counters_are_per_comm_per_event():
    def run(pkg):
        with _tracing(pkg) as core:
            toks = [core.begin("coll_allreduce", cid="w"),
                    core.begin("coll_allreduce", cid="w"),
                    core.begin("coll_barrier", cid="w"),
                    core.begin("coll_allreduce", cid="other")]
            for t in toks:
                core.end(t)
            return [(s.name, s.cid, s.seq) for s in core.spans()]

    assert _both(run) == [("coll_allreduce", "w", 0),
                          ("coll_allreduce", "w", 1),
                          ("coll_barrier", "w", 0),
                          ("coll_allreduce", "other", 0)]


def test_instants_record_zero_duration():
    def run(pkg):
        with _tracing(pkg) as core:
            core.instant("pml_wakeup_flush", wakeups=3)
            (s,) = core.spans()
            return s.name, s.kind, s.dur, s.args

    assert _both(run) == ("pml_wakeup_flush", "instant", 0.0, {"wakeups": 3})


def test_disabled_hot_path_allocates_no_spans(monkeypatch, pworld, world):
    """Tracing off (the default): the collective and pt2pt gates are one
    attribute read; begin and instant never run, in either package, and
    both deliver the same values."""
    def boom(*a, **kw):
        raise AssertionError("tracer touched while disabled")
    for core in (trace_core, r_core):
        monkeypatch.setattr(core, "begin", boom)
        monkeypatch.setattr(core, "instant", boom)
        assert core.active is False

    from ompi_tpu.pml import perrank as r_perrank
    from ompi_tpu_torch.pml import perrank as p_perrank

    class _C:
        cid = "trace-off"
        size = 2

        def rank(self):
            return 0

        def world_rank_of(self, r):
            return 0

    def engine_run(mod, *device):
        kv = {}
        router = mod.Router(0, 1, kv.__setitem__, kv.__getitem__, *device)
        eng = mod.PerRankEngine(_C(), router)
        try:
            eng.send(np.float32(1.0), dest=1, tag=5)
            a = eng.recv(source=0, tag=5, timeout=10)
            eng.send_small(np.float32(2.0), [1], tag=6)
            b = eng.recv(source=0, tag=6, timeout=10)
        finally:
            router.close()
        return [float(np.asarray(v[0]).reshape(())) for v in (a, b)]

    p_sum = pworld.allreduce(pworld.alloc((2,), fill=1.0))
    pworld.send(np.float32(1.0), 0, 1, 5)
    p_got, p_st = pworld.recv(0, 5, dst=1)
    p_vals = engine_run(p_perrank, "cpu")

    r_sum = world.allreduce(world.alloc((2,), np.float32, fill=1.0))
    world.send(np.float32(1.0), 0, 1, 5)
    r_got, r_st = world.recv(0, 5, dst=1)
    r_vals = engine_run(r_perrank)

    np.testing.assert_array_equal(p_sum.numpy(), np.asarray(r_sum))
    assert float(np.asarray(p_got)) == float(np.asarray(r_got)) == 1.0
    assert (p_st.source, p_st.tag) == (r_st.source, r_st.tag) == (0, 5)
    assert p_vals == r_vals == [1.0, 2.0]
    assert trace_core.stats()["spans"] == 0
    assert r_core.stats()["spans"] == 0


def test_stacked_vtable_unwrapped_when_disabled(pworld, world):
    from ompi_tpu.trace.core import _TracedSlot as RTracedSlot
    from ompi_tpu_torch.coll.monitoring import MonitoringCollModule
    from ompi_tpu_torch.trace.core import _TracedSlot
    for func, mod in pworld.c_coll.items():
        assert not isinstance(mod, (_TracedSlot, MonitoringCollModule)), func
    for func, mod in world.c_coll.items():
        assert not isinstance(mod, RTracedSlot), func
    # each slot is its winner's own module: nothing rides between
    modules = {comp.name: m for _p, comp, m in pworld._coll_selected}
    for func, mod in pworld.c_coll.items():
        assert mod is modules[pworld._coll_winners[func]], func


def test_enable_is_idempotent_and_disable_keeps_ring_readable():
    def run(pkg):
        with _tracing(pkg, capacity=8) as core:
            core.end(core.begin("coll_bcast", cid="w"))
            core.enable()                # no-op: the ring survives
            kept = len(core.spans())
            core.disable()
            # readable post-mortem
            return kept, core.active, _spans_of(core), core.stats()

    kept, active, spans, stats = _both(run)
    assert kept == 1 and active is False
    assert spans == [("coll_bcast", "span", "w", 0, None)]
    assert stats == {"spans": 1, "dropped": 0, "capacity": 8, "stored": 1}


# -- export and attribution (tests/test_trace_export.py) ------------------
BASE = 1000.0
OFFSETS = {0: 0.0, 1: 0.25, 2: -0.125, 3: 0.5}
LATE_RANK, LATE_BY = 2, 0.050


def _skewed_barrier_spans(cls, seq=0):
    spans = []
    for rank, off in OFFSETS.items():
        t_arr = BASE + (LATE_BY if rank == LATE_RANK else 0.0)
        t_end = BASE + LATE_BY + 0.010
        spans.append(cls("coll_barrier", t_arr + off, t_end - t_arr,
                         tid=100 + rank, rank=rank, cid="w", seq=seq))
    return spans


def test_perfetto_export_schema_and_matches_reference():
    spans = _skewed_barrier_spans(Span)
    spans.append(Span("pml_wakeup_flush", BASE + 0.02, 0.0, tid=101,
                      rank=1, kind="instant"))
    obj = perfetto.export(spans, rank_offsets=OFFSETS)
    parsed = json.loads(json.dumps(obj))  # Perfetto-loadable JSON
    evs = parsed["traceEvents"]
    assert parsed["displayTimeUnit"] == "ms"
    for ev in evs:
        assert {"name", "ph", "pid", "tid", "ts"} <= set(ev)
    names = {ev["pid"]: ev["args"]["name"] for ev in evs
             if ev["ph"] == "M" and ev["name"] == "process_name"}
    assert names == {r: f"rank {r}" for r in OFFSETS}
    assert all("dur" in ev for ev in evs if ev["ph"] == "X")
    assert any(ev["ph"] == "i" and ev["s"] == "t" for ev in evs)
    tl = [ev["ts"] for ev in evs if ev["ph"] != "M"]
    assert tl == sorted(tl)
    # the same spans through the reference's exporter: the same JSON
    rspans = [RSpan.from_dict(s.to_dict()) for s in spans]
    assert obj == json.loads(json.dumps(
        r_perfetto.export(rspans, rank_offsets=OFFSETS)))


def test_offset_alignment_puts_ranks_on_one_timebase():
    def run(pkg):
        spans = _skewed_barrier_spans(pkg.Span)
        aligned = [e for e in pkg.perfetto.to_events(spans,
                                                     rank_offsets=OFFSETS)
                   if e["ph"] == "X"]
        raw = {e["pid"]: e["ts"] for e in pkg.perfetto.to_events(spans)
               if e["ph"] == "X"}
        return aligned, raw

    aligned, raw = _both(run)
    for e in aligned:
        expect = BASE * 1e6 + (LATE_BY * 1e6 if e["pid"] == LATE_RANK
                               else 0)
        assert e["ts"] == pytest.approx(expect, abs=1.0), e["pid"]
    assert raw[3] - raw[0] > 0.4e6


def test_late_arrival_attribution_names_the_late_rank():
    r_attr.reset_watermarks()
    reports = attribution.late_arrival(_skewed_barrier_spans(Span),
                                       rank_offsets=OFFSETS)
    assert len(reports) == 1
    r = reports[0]
    assert r["name"] == "coll_barrier" and r["cid"] == "w"
    assert r["critical_rank"] == LATE_RANK
    assert r["skew_s"] == pytest.approx(LATE_BY, rel=1e-6)
    by_rank = {row["rank"]: row for row in r["ranks"]}
    assert by_rank[0]["blocked_s"] == pytest.approx(LATE_BY, rel=1e-6)
    assert by_rank[0]["in_op_s"] == pytest.approx(0.010, rel=1e-4)
    assert by_rank[LATE_RANK]["blocked_s"] == pytest.approx(0.0, abs=1e-9)
    assert pvar.pvar_read("trace_skew_watermarks")["w"] == \
        pytest.approx(LATE_BY, rel=1e-6)
    assert pvar.pvar_read("trace_skew_cw") == pytest.approx(LATE_BY,
                                                             rel=1e-6)
    assert reports == r_attr.late_arrival(_skewed_barrier_spans(RSpan),
                                          rank_offsets=OFFSETS)
    r_attr.reset_watermarks()


def test_attribution_ignores_pt2pt_and_instants():
    def run(pkg):
        pkg.attribution.reset_watermarks()
        S = pkg.Span
        spans = _skewed_barrier_spans(S)
        spans.append(S("pml_send", BASE, 1e-6, tid=1, rank=0))
        spans.append(S("pml_send", BASE + 1, 1e-6, tid=1, rank=1))
        spans.append(S("pml_wakeup_flush", BASE, 0.0, tid=1, rank=0,
                       kind="instant"))
        reports = pkg.attribution.late_arrival(spans, rank_offsets=OFFSETS)
        pkg.attribution.reset_watermarks()
        return reports

    reports = _both(run)
    assert [r["name"] for r in reports] == ["coll_barrier"]
    assert reports[0]["critical_rank"] == LATE_RANK


def test_live_stacked_collectives_are_traced(pworld, world):
    """Through the real composer: tracing on before a communicator is
    built wraps its vtable; each collective then records one
    ``coll_<func>`` span with the comm's cid and a per-function sequence,
    as the reference's does, and results are the untraced ones."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((N, 6)).astype(np.float32)
    plain = pworld.dup()
    untraced = plain.allreduce(torch.from_numpy(x.copy()))
    trace_core.enable(capacity=1024)
    comm = pworld.dup()
    try:
        outs = [comm.allreduce(torch.from_numpy(x.copy())),
                comm.allreduce(torch.from_numpy(x.copy()))]
        comm.barrier()
        spans = trace_core.spans()
        names = [s.name for s in spans]
        assert names.count("coll_allreduce") == 2
        assert "coll_barrier" in names
        ars = [s for s in spans if s.name == "coll_allreduce"]
        assert [s.seq for s in ars] == [0, 1]
        assert all(s.cid == str(comm.cid) for s in ars)
        assert all(s.dur > 0 for s in ars)
        for o in outs:
            assert torch.equal(o, untraced)
        json.dumps(perfetto.export(spans))
    finally:
        comm.free()
        plain.free()
    # the reference's composer records the same sequence on its world
    r_core.enable(capacity=1024)
    try:
        r_core.reset()
        rc = world.dup()
        for _ in range(2):
            np.testing.assert_allclose(
                np.asarray(rc.allreduce(x)), untraced.numpy(), rtol=1e-6)
        rc.barrier()
        # xla_compile spans time the reference's per-collective XLA
        # compile, which the port has no counterpart of; the port's
        # coll.body spans inside coll/torch_ have none in the reference
        rnames = [(s.name, s.seq) for s in r_core.spans()
                  if s.name != "xla_compile"]
        assert [(s.name, s.seq) for s in spans
                if s.name != "coll.body"] == rnames
        rc.free()
    finally:
        r_core.disable()
        r_core.reset()


def test_live_perrank_interpose_traces_collectives():
    """The per-rank tier: interpose() rebinds the collectives with the span
    shim when tracing is on at construction; composition stays one span
    (outermost frame only). The reference's RankCommunicator on the same
    one-rank loopback records the same spans and result."""
    from ompi_tpu.core.group import Group as RGroup
    from ompi_tpu.core.rankcomm import RankCommunicator as RRankComm
    from ompi_tpu.pml.perrank import Router as RRouter
    from ompi_tpu_torch.core.group import Group
    from ompi_tpu_torch.core.rankcomm import RankCommunicator
    from ompi_tpu_torch.pml.perrank import Router

    def run(pkg):
        kv = {}
        with _tracing(pkg, capacity=256) as core:
            if pkg is PORT:
                router = Router(0, 1, kv.__setitem__, kv.__getitem__, "cpu")
                comm = RankCommunicator(Group([0]), 0, router, "cpu",
                                        cid="tr-live")
            else:
                router = RRouter(0, 1, kv.__setitem__, kv.__getitem__)
                comm = RRankComm(RGroup([0]), 0, router, cid="tr-live")
            try:
                interposed = "trace" in comm._coll_interposers
                got = float(np.asarray(comm.allreduce(np.float64(2.0))))
                colls = [(n, c, q) for n, _k, c, q, _a in _spans_of(core)
                         if n.startswith("coll_")]
            finally:
                router.close()
        return interposed, got, colls

    assert _both(run) == (True, 2.0, [("coll_allreduce", "tr-live", 0)])


def test_trace_dump_and_load_roundtrip(tmp_path):
    def run(pkg):
        with _tracing(pkg, capacity=8) as core:
            core.end(core.begin("coll_allreduce", cid="w"))
            path = core.dump(str(tmp_path / f"{pkg.name}.json"),
                             offset_s=0.125)
            d = core.load_dump(path)
            # each package reads the other's dump as its own
            other = REF if pkg is PORT else PORT
            assert other.core.load_dump(path) == d
            with pytest.raises(ValueError):
                (tmp_path / "bad.json").write_text("[]")
                core.load_dump(str(tmp_path / "bad.json"))
        return (d["rank"], d["offset_s"], d["stats"],
                [(s["name"], s["cid"], s["seq"], s["kind"], s.get("args"))
                 for s in d["spans"]], sorted(d["spans"][0]))

    rank, offset, stats, spans, keys = _both(run)
    assert offset == 0.125 and stats["spans"] == 1
    assert spans == [("coll_allreduce", "w", 0, "span", None)]


# -- satellites (tests/test_trace_satellites.py) --------------------------
def test_fire_counts_drops_and_logs_first_traceback_once(capsys):
    def run(pkg):
        def bad(event, comm, info):
            raise RuntimeError("tool bug")

        pkg.hooks.register_profiler(bad)
        try:
            before = pkg.hooks.dropped()
            pkg.hooks.fire("coll_allreduce", None, {})
            pkg.hooks.fire("coll_allreduce", None, {})
            pkg.hooks.fire("coll_bcast", None, {})
            delta = pkg.hooks.dropped() - before
            pv = pkg.pvar.pvar_read("hooks_dropped") == pkg.hooks.dropped()
            err = capsys.readouterr().err
        finally:
            pkg.hooks.unregister_profiler(bad)
        return (delta, pv, err.count("RuntimeError: tool bug"),
                "hooks_dropped" in err)

    assert _both(run) == (3, True, 1, True)


def test_fire_drop_does_not_break_later_hooks():
    def run(pkg):
        seen = []

        def bad(event, comm, info):
            raise ValueError("boom")

        def good(event, comm, info):
            seen.append(event)

        pkg.hooks.register_profiler(bad)
        pkg.hooks.register_profiler(good)
        try:
            before = pkg.hooks.dropped()
            pkg.hooks.fire("pml_send", None, {})
            return seen, pkg.hooks.dropped() - before
        finally:
            pkg.hooks.unregister_profiler(bad)
            pkg.hooks.unregister_profiler(good)

    assert _both(run) == (["pml_send"], 1)


def test_drops_count_per_failing_hook_and_events_are_learned(capsys):
    """The per-handle accounting of MPI_T event handles (api/tool waits for
    ROADMAP item 8) seen through the hook chain: each failing hook counts
    once per event it raised on, a good hook still sees every event, and
    an event name fired once joins the known events, in both packages."""
    ok_events = []
    for mod in (hooks, r_hooks):
        mod._reset_drops_for_tests()

        def bad(e, c, i):
            raise RuntimeError("handler bug")
        mod.register_profiler(bad)
        mod.register_profiler(lambda e, c, i: ok_events.append(e))
        try:
            mod.fire("coll_reduce", None, {})
            mod.fire("coll_reduce", None, {})
            mod.fire("trace_test_probe_event", None, {})
            assert mod.dropped() == 3
            assert "trace_test_probe_event" in mod.known_events()
        finally:
            for h in list(mod._hooks):
                mod.unregister_profiler(h)
            mod._reset_drops_for_tests()
    assert ok_events == ["coll_reduce", "coll_reduce",
                         "trace_test_probe_event"] * 2
    assert hooks.known_events()[:13] == r_hooks.known_events()[:13]
    capsys.readouterr()


def test_concurrent_refresh_registers_each_spc_pvar_once():
    def run(pkg):
        key = "race_probe_counter"
        pkg.spc.write(key, 0)
        pkg.spc.record(key, 7)
        errs = []

        def spin():
            try:
                for _ in range(50):
                    pkg.pvar.refresh()
            except Exception as e:       # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=spin) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        seen = pkg.pvar.pvar_read("spc_" + key)
        pkg.pvar.pvar_write("spc_" + key, 0)
        return errs, seen, pkg.pvar.pvar_read("spc_" + key)

    assert _both(run) == ([], 7, 0)


def test_spc_sharded_increments_merge_across_threads():
    def run(pkg):
        key = "shard_merge_probe"
        pkg.spc.write(key, 0)
        nthreads, per = 8, 500

        def work():
            for _ in range(per):
                pkg.spc.record(key, 1)

        threads = [threading.Thread(target=work) for _ in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return pkg.spc.read(key), pkg.spc.snapshot()[key]

    assert _both(run) == (8 * 500, 8 * 500)


def test_spc_write_sets_absolute_value_and_record_resumes():
    def run(pkg):
        key = "shard_write_probe"
        pkg.spc.write(key, 0)
        pkg.spc.record(key, 10)
        pkg.spc.write(key, 3)
        after_write = pkg.spc.read(key)
        pkg.spc.record(key, 2)
        return after_write, pkg.spc.read(key)

    assert _both(run) == (3, 5)


def test_spc_record_takes_no_global_lock(monkeypatch):
    class Forbidden:
        def __enter__(self):
            raise AssertionError("record() took the global lock")

        def __exit__(self, *a):
            return False

        def acquire(self, *a, **kw):
            raise AssertionError("record() took the global lock")

        def release(self):
            pass

    for mod in (spc, r_spc):
        mod.record("lock_probe", 1)      # warm this thread's shard
        monkeypatch.setattr(mod, "_lock", Forbidden())
        mod.record("lock_probe", 1)
    monkeypatch.undo()
    assert spc.read("lock_probe") >= 2 and r_spc.read("lock_probe") >= 2


def test_monitoring_counts_barrier_and_ibarrier_distinctly(pworld, world):
    from ompi_tpu.coll import monitoring as r_mon
    from ompi_tpu_torch.coll import monitoring

    def run(comm_world, mon, v):
        v.var_register("coll", "monitoring", "enable", vtype="bool",
                       default=False)
        v.var_set("coll_monitoring_enable", True)
        mon.reset()
        comm = comm_world.dup()
        try:
            comm.barrier()
            comm.barrier()
            comm.ibarrier().wait()
            snap = mon.snapshot()
            return snap[(comm.cid, "barrier")], snap[(comm.cid, "ibarrier")]
        finally:
            v.var_set("coll_monitoring_enable", False)
            comm.free()
            mon.reset()

    got = run(pworld, monitoring, var)
    assert got == run(world, r_mon, r_var)
    (n_barrier, _), (n_ibarrier, _) = got
    assert n_barrier == 2 and n_ibarrier == 1


def test_compress_spans_aggregate_per_rank_in_summary():
    spans = [
        {"name": "compress.quant", "ts": 0.0, "dur": 0.002, "rank": 0,
         "kind": "span"},
        {"name": "compress.quant", "ts": 0.1, "dur": 0.001, "rank": 1,
         "kind": "span"},
        {"name": "compress.dequant", "ts": 0.2, "dur": 0.0005, "rank": 1,
         "kind": "span"},
        {"name": "coll_allreduce", "ts": 0.3, "dur": 0.01, "rank": 0,
         "kind": "span"},
    ]
    agg = attribution.compress_by_rank(spans)
    assert agg["0"] == {"quant_us": 2000.0, "quant_n": 1,
                        "dequant_us": 0.0, "dequant_n": 0}
    assert agg["1"]["quant_n"] == 1 and agg["1"]["dequant_n"] == 1
    assert agg["1"]["dequant_us"] == 500.0
    summary = attribution.summarize(spans)
    assert summary["compress"] == agg
    assert json.loads(json.dumps(summary)) == summary
    assert "compress" not in attribution.summarize(spans[3:])
    r_attr.reset_watermarks()
    assert summary == r_attr.summarize(spans)


def test_compress_span_recording_through_the_tracer(pworld):
    """Live path: both tracers see their wire codec's spans under the
    hooks-namespace names, with the same counts for the same array."""
    import ompi_tpu.compress as r_compress
    from ompi_tpu.compress import wire as r_wire
    from ompi_tpu_torch.compress import wire
    x = np.random.default_rng(0).normal(size=4096).astype(np.float32)
    r_compress._register_vars()

    def run(pkg):
        codec = wire if pkg is PORT else r_wire
        assert "compress.quant" in pkg.hooks.known_events()
        assert "compress.dequant" in pkg.hooks.known_events()
        with _tracing(pkg, capacity=64) as core:
            pkg.var.var_set("mpi_base_compress", True)
            pkg.var.var_set("mpi_base_compress_min_bytes", 1 << 10)
            try:
                y = codec.decode(codec.encode(x.copy()))
                agg = pkg.attribution.compress_by_rank(core.span_dicts())
            finally:
                pkg.var.var_set("mpi_base_compress_min_bytes", 4 << 20)
                pkg.var.var_set("mpi_base_compress", False)
        (counts,) = [(a["quant_n"], a["dequant_n"]) for a in agg.values()]
        return counts, np.asarray(y)

    counts, y = run(PORT)
    r_counts, ry = run(REF)
    assert counts == r_counts and counts[0] >= 1 and counts[1] >= 1
    np.testing.assert_array_equal(y, ry)


# -- tests/test_aux.py: profiling hooks, the monitoring component ----------
def test_profiling_hooks(pworld, world):
    def spc_barrier(pkg):
        pkg.pvar.refresh()
        try:
            return pkg.pvar.pvar_read("spc_coll_barrier")
        except KeyError:
            return 0

    def run(pkg, comm, op, *dtype):
        events = []
        barrier0 = spc_barrier(pkg)
        h = pkg.hooks.register_profiler(
            lambda ev, c, info: events.append(ev))
        try:
            comm.barrier()
            comm.allreduce(comm.alloc((2,), *dtype), op)
            comm.send(np.int32([1]), 0, 1, 3)
            got, st = comm.recv(0, 3, dst=1)
        finally:
            pkg.hooks.unregister_profiler(h)
        comm.barrier()                    # unregistered: not seen
        return (list(events), np.asarray(got).tolist(), st.source,
                spc_barrier(pkg) - barrier0)

    got = run(PORT, pworld, P.SUM)
    assert got == run(REF, world, R.SUM, np.float32)
    events, value, source, barriers = got
    assert events == ["coll_barrier", "coll_allreduce", "pml_send",
                      "pml_recv"]
    assert value == [1] and source == 0 and barriers == 2


def test_monitoring_component(pworld, world):
    from ompi_tpu.coll import monitoring as r_mon
    from ompi_tpu_torch.coll import monitoring
    from ompi_tpu_torch.coll.tuned import TunedCollModule
    x = np.random.default_rng(2).standard_normal((N, 8)).astype(np.float32)
    var.var_set("coll_monitoring_enable", True)
    r_var.var_register("coll", "monitoring", "enable", vtype="bool",
                       default=False)
    r_var.var_set("coll_monitoring_enable", True)
    try:
        r_mon.reset()
        d, rd = pworld.dup(), world.dup()
        assert isinstance(d.c_coll["allreduce"],
                          monitoring.MonitoringCollModule)
        for _ in range(2):
            y = d.allreduce(torch.from_numpy(x.copy()), P.SUM)
            ry = rd.allreduce(x, R.SUM)
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-6)
        calls, nbytes = monitoring.snapshot()[(d.cid, "allreduce")]
        assert calls == 2 and nbytes == 2 * x.nbytes
        assert (calls, nbytes) == r_mon.snapshot()[(rd.cid, "allreduce")]
        # interposes over whatever selection would otherwise pick
        assert isinstance(d.c_coll["allreduce"].vtable["allreduce"],
                          TunedCollModule)
        d.free()
        rd.free()
    finally:
        var.var_set("coll_monitoring_enable", False)
        r_var.var_set("coll_monitoring_enable", False)
        r_mon.reset()


# -- tests/test_sync_adapt.py: coll/sync ----------------------------------
def test_sync_disabled_by_default(pworld, world):
    assert pworld._coll_winners["allreduce"] != "sync"
    assert world._coll_winners["allreduce"] != "sync"
    assert var.var_get("coll_sync_barrier_before") == \
        r_var.var_get("coll_sync_barrier_before")


def test_sync_interposes_and_counts(pworld, world):
    """The same seeded stack through a sync-interposed dup in each
    package: every call counted, injected barriers change no result, and
    the two packages agree."""
    x = np.random.default_rng(4).standard_normal((N, 4)).astype(np.float32)
    ref = pworld.allreduce(torch.from_numpy(x.copy()))
    saved = r_var.var_get("coll_sync_barrier_before")

    def run(comm_world, v, wrap, op):
        v.var_set("coll_sync_barrier_before", 3)
        try:
            c = comm_world.dup()
        finally:
            v.var_set("coll_sync_barrier_before", saved)
        try:
            winner = c._coll_winners["allreduce"]
            shim = c.c_coll["allreduce"]
            outs = [np.asarray(c.allreduce(wrap(x.copy()), op))
                    for _ in range(7)]
            inner = shim._module._inner["allreduce"].__class__.__name__
            return winner, shim._module.count, inner, outs
        finally:
            c.free()

    winner, count, inner, outs = run(pworld, var, torch.from_numpy, P.SUM)
    r_winner, r_count, r_inner, r_outs = run(world, r_var, lambda a: a,
                                             R.SUM)
    assert (winner, count) == (r_winner, r_count) == ("sync", 7)
    assert inner != "SyncCollModule" and r_inner != "SyncCollModule"
    for out, r_out in zip(outs, r_outs):
        # injected barriers change nothing
        np.testing.assert_array_equal(out, ref.numpy())
        np.testing.assert_allclose(out, r_out, rtol=1e-6)
