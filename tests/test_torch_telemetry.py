"""The port's telemetry plane against the reference's
(``tests/test_telemetry.py``, all 24 cases, and the comm-free retirement
repair).

Every case feeds both packages the same inputs: the same samples go into
both ``Histogram`` types, the same synthetic waits and clocks into both
health monitors, the same payloads into both flight-recorder merges, the
same rows into both Prometheus renderers, and the outputs must be
identical. The ``tools/tracedump`` and ``tools/mpitop`` cases read the
files each package wrote (trace dumps, flight-recorder snapshots,
telemetry dumps) with that package's tool and, beside it, with the
reference's tool: all four reports must agree — the port's dump formats
are the reference's. Live collectives run on the port's
8-rank CPU world and on a dup of the reference's world.

The repair: a freed (or shrunk) communicator's per-comm instruments —
histograms, their pvars and ``trace_skew_c<cid>`` — retire with it in
both packages, on the single-controller world and in a 3-rank per-rank
job of each package.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import ompi_tpu_torch as P
from ompi_tpu import telemetry as r_tele
from ompi_tpu.mca import pvar as r_pvar
from ompi_tpu.osc import base as r_osc
from ompi_tpu.mca import var as r_var
from ompi_tpu.telemetry import flightrec as r_flightrec
from ompi_tpu.telemetry import health as r_health
from ompi_tpu.telemetry import hist as r_hist
from ompi_tpu.telemetry import prom as r_prom
from ompi_tpu.tools import mpitop as r_mpitop
from ompi_tpu.tools import tracedump as r_tracedump
from ompi_tpu.trace import attribution as r_attr
from ompi_tpu.trace import core as r_trace
from ompi_tpu.utils import hooks as r_hooks
from ompi_tpu_torch import telemetry as p_tele
from ompi_tpu_torch.mca import pvar as p_pvar
from ompi_tpu_torch.osc import base as p_osc
from ompi_tpu_torch.mca import var as p_var
from ompi_tpu_torch.telemetry import flightrec as p_flightrec
from ompi_tpu_torch.telemetry import health as p_health
from ompi_tpu_torch.telemetry import hist as p_hist
from ompi_tpu_torch.telemetry import prom as p_prom
from ompi_tpu_torch.tools import mpitop as p_mpitop
from ompi_tpu_torch.tools import tracedump as p_tracedump
from ompi_tpu_torch.trace import attribution as p_attr
from ompi_tpu_torch.trace import core as p_trace
from ompi_tpu_torch.utils import hooks as p_hooks

PORT = SimpleNamespace(name="port", tele=p_tele, pvar=p_pvar, var=p_var,
                       flightrec=p_flightrec, health=p_health, hist=p_hist,
                       prom=p_prom, attr=p_attr, trace=p_trace,
                       hooks=p_hooks, osc=p_osc, mpitop=p_mpitop,
                       tracedump=p_tracedump)
REF = SimpleNamespace(name="ref", tele=r_tele, pvar=r_pvar, var=r_var,
                      flightrec=r_flightrec, health=r_health, hist=r_hist,
                      prom=r_prom, attr=r_attr, trace=r_trace,
                      hooks=r_hooks, osc=r_osc, mpitop=r_mpitop,
                      tracedump=r_tracedump)
BOTH = (PORT, REF)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MPIRUN = os.path.join(_REPO, "ompi_tpu_torch", "tools", "mpirun.py")
REF_MPIRUN = os.path.join(_REPO, "ompi_tpu", "tools", "mpirun.py")
JOB_LIMIT = 55                   # each job's own limit, in seconds


def _both(fn):
    """``fn(pkg)`` on the port and on the reference; the two
    observations must be identical. Returns the port's."""
    port, ref = fn(PORT), fn(REF)
    assert port == ref, (port, ref)
    return port


def _own_and_ref_tool(run, tool):
    """``run(pkg, t)`` over ``pkg``'s files with ``pkg``'s own ``tool``
    and with the reference's beside it; the two must agree."""
    def fn(pkg):
        own = run(pkg, getattr(pkg, tool))
        ref = run(pkg, getattr(REF, tool))
        assert own == ref, (pkg.name, own, ref)
        return own
    return fn


def _teardown(pkg):
    for h in pkg.tele.histograms():
        if h.registered:
            pkg.pvar.pvar_unregister(h.name)
    pkg.tele.disable()
    pkg.tele._reset_for_tests()
    pkg.flightrec._reset_for_tests()


@pytest.fixture(autouse=True)
def _clean():
    P._reset_for_tests()
    for pkg in BOTH:
        _teardown(pkg)
    yield
    for pkg in BOTH:
        _teardown(pkg)
    P._reset_for_tests()


@pytest.fixture()
def tele():
    """Both planes armed for one test, fully torn down after (the
    session default stays off: other tests assert byte-identity)."""
    for pkg in BOTH:
        pkg.tele.enable()
    yield BOTH


@pytest.fixture()
def pworld():
    P.Init(devices=["cpu"] * 8)
    return P.get_comm_world()


def _standalone(pkg, name, values=(), labels=None):
    """A histogram outside the registry: ``registered`` pre-set so
    recording never touches the pvar surface."""
    h = pkg.hist.Histogram(name, labels=labels)
    h.registered = True
    for v in values:
        h.record(v)
    return h


def _hist_row(pkg, name, values, labels=None):
    h = _standalone(pkg, name, values, labels)
    return {"name": name, "unit": "us", "comm": None,
            "labels": dict(labels or {}), "snap": h.snapshot()}


# -- the off gate: byte-identical, zero-touch --------------------------------
def test_telemetry_off_hot_paths_untouched(monkeypatch, pworld, world):
    """Telemetry off (the default): no histogram may be started or
    recorded by the stacked collectives or the per-rank pml, in either
    package; the two vtables hold no histogram shim."""
    def boom(*a, **kw):
        raise AssertionError("histogram touched while disabled")

    from ompi_tpu.pml.perrank import PerRankEngine as RE
    from ompi_tpu.pml.perrank import Router as RR
    from ompi_tpu_torch.pml.perrank import PerRankEngine as PE
    from ompi_tpu_torch.pml.perrank import Router as PR

    class _C:
        cid = "tele-off"
        size = 2

        def rank(self):
            return 0

        def world_rank_of(self, r):
            return 0

    def run(pkg):
        monkeypatch.setattr(pkg.hist.Histogram, "record", boom)
        monkeypatch.setattr(pkg.hist.Histogram, "start", boom)
        assert pkg.tele.active is False
        assert pkg.tele.telemetry_enabled() is False
        w = pworld if pkg is PORT else world
        slot_type = pkg.tele._HistSlot
        shims = [f for f, m in w.c_coll.items()
                 if isinstance(m, slot_type)]
        y = w.allreduce(w.alloc((2,), fill=1.0) if pkg is PORT
                        else w.alloc((2,), np.float32, fill=1.0))
        kv = {}
        router = (PR if pkg is PORT else RR)(
            0, 1, kv.__setitem__, kv.__getitem__)
        eng = (PE if pkg is PORT else RE)(_C(), router)
        try:
            eng.send(np.float32(1.0), dest=1, tag=5)
            a, _ = eng.recv(source=0, tag=5, timeout=10)
            eng.send_small(np.float32(2.0), [1], tag=6)
            b, _ = eng.recv(source=0, tag=6, timeout=10)
        finally:
            router.close()
        return (shims, float(np.asarray(y)[0, 0]),
                float(np.asarray(a).reshape(-1)[0]),
                float(np.asarray(b).reshape(-1)[0]))

    assert _both(run) == ([], 8.0, 1.0, 2.0)


def test_enable_arms_core_hists_and_disable_keeps_them_readable():
    def run(pkg):
        pkg.tele._reset_for_tests()
        before = pkg.tele.PML_SEND
        try:
            pkg.tele.enable()
            armed = [type(h).__name__ for h in (
                pkg.tele.PML_SEND, pkg.tele.PML_RECV, pkg.tele.SEGMENT,
                pkg.tele.FLUSH, pkg.tele.RAIL, pkg.tele.SHMSEG,
                pkg.tele.HB_GAP, pkg.tele.HB_RTT)]
            names = [h.name for h in pkg.tele.histograms()]
            pkg.tele.PML_SEND.record(123.0)
            pkg.tele.disable()
            # readable post-mortem, like the trace ring
            return (before, pkg.tele.active, armed, names,
                    pkg.tele.PML_SEND.snapshot())
        finally:
            pkg.pvar.pvar_unregister("tele_pml_send_us")
            pkg.tele._reset_for_tests()

    before, active, armed, names, snap = _both(run)
    assert before is None and active is False
    assert armed == ["Histogram"] * 8
    assert snap["count"] == 1 and len(names) == 8


# -- histogram math ----------------------------------------------------------
def test_histogram_buckets_percentiles_and_bounds():
    def run(pkg):
        h = _standalone(pkg, "t", [0, 1, 10, 100, 1000, -5])
        m = h.merged()
        dense = m["buckets"]
        sparse = {str(i): n for i, n in enumerate(dense) if n}
        return (m, h.snapshot(),
                [pkg.hist.bucket_bounds(i) for i in range(0, 12)],
                pkg.hist.bucket_bounds(pkg.hist.NBUCKETS - 1),
                [(pkg.hist.percentile_from_buckets(dense, m["count"], p),
                  pkg.hist.percentile_from_buckets(sparse, m["count"], p))
                 for p in (50, 90, 99)],
                pkg.hist.percentile_from_buckets([], 0, 99))

    m, snap, bounds, top, pcts, empty = _both(run)
    assert m["count"] == 6 and m["buckets"][0] == 2 and m["buckets"][1] == 1
    assert snap["p50"] <= snap["p90"] <= snap["p99"] <= top[1]
    assert snap["max"] == 1000.0
    assert bounds[0] == (0.0, 1.0)
    assert all(hi == 2 * lo for lo, hi in bounds[1:])
    assert all(d == s for d, s in pcts) and empty == 0.0


def test_histogram_observe_token_and_none_noop():
    def run(pkg):
        h = _standalone(pkg, "t2")
        h.observe(None)                  # the gated idiom's off branch
        none_count = h.merged()["count"]
        h.observe(h.start())
        m = h.merged()
        return none_count, m["count"], m["sum"] >= 0.0

    assert _both(run) == (0, 1, True)


def test_histogram_concurrent_writers_merge():
    """The shard contract: 4 writer threads, no lock on the record path,
    and the merged read sees every sample exactly once."""
    per = 1000

    def run(pkg):
        h = _standalone(pkg, "conc")

        def w(k):
            for i in range(per):
                h.record(k * 1000 + i)

        ts = [threading.Thread(target=w, args=(k,)) for k in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        m = h.merged()
        shards = len(h._shards)
        h.reset()
        return m, shards, h.merged()["count"], len(h._shards)

    m, shards, after, kept = _both(run)
    assert m["count"] == 4 * per and sum(m["buckets"]) == 4 * per
    assert m["max"] == 3999.0 and shards == 4
    assert after == 0 and kept == 4      # shards survive the window


def test_merge_snapshots_cross_rank():
    def run(pkg):
        a = _standalone(pkg, "a", [10] * 99 + [5000])
        b = _standalone(pkg, "b", [10] * 100)
        return pkg.hist.merge_snapshots([a.snapshot(), b.snapshot(), {}])

    m = _both(run)
    assert m["count"] == 200 and m["max"] == 5000.0
    assert m["p50"] <= 16.0 and m["p99"] >= m["p50"]
    assert sum(int(n) for n in m["buckets"].values()) == 200


def test_size_class_and_cid_token():
    def run(pkg):
        return ([pkg.tele.size_class(n) for n in
                 (0, 1024, 1025, 65536, 65537, 1 << 20, (1 << 20) + 1)],
                pkg.tele._cid_token("world"),
                pkg.tele._cid_token(("split", 3)),
                pkg.tele._cid_token(""))

    classes, world_tok, tuple_tok, empty = _both(run)
    assert classes == [0, 0, 1, 1, 2, 2, 3]
    assert world_tok == "world" and tuple_tok != "" and empty == "none"


# -- straggler hysteresis ----------------------------------------------------
class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_straggler_hysteresis_declare_and_recover():
    """A score over the threshold must persist ``miss`` consecutive
    samples before telemetry.straggler fires; a recovered peer (score
    under half the threshold) is cleared and may be re-declared. Both
    monitors see the same waits on the same synthetic clock."""
    def run(pkg):
        events = []
        handle = pkg.hooks.register_profiler(
            lambda ev, comm, info: events.append((ev, info["rank"]))
            if ev.startswith("telemetry.") else None)
        clock = _Clock()
        mon = pkg.health.HealthMonitor(0, 4, sample_s=1e9, window_s=10.0,
                                       threshold=0.05, miss=3, clock=clock)
        trail = []
        try:
            clock.t = 1.0
            for peer in (2, 3):          # the cross-peer median floor
                mon.note_wait(peer, 0.001)
            mon.note_wait(1, 0.8)        # 0.8 s outlier -> score ~0.08
            for t in (1.1, 1.2, 1.3, 1.4):
                clock.t = t
                scores = mon.sample()
                trail.append((scores[1], mon.declared(),
                              dict(mon.stats)))
            clock.t = 20.0               # the window empties: score 0
            scores = mon.sample()
            trail.append((scores[1], mon.declared(), dict(mon.stats)))
            for peer in (2, 3):
                mon.note_wait(peer, 0.001)
            mon.note_wait(1, 0.9)
            for i in range(3):
                clock.t = 20.1 + i * 0.1
                mon.sample()
            trail.append((mon.declared(), dict(mon.stats)))
        finally:
            pkg.hooks.unregister_profiler(handle)
        return trail, events

    trail, events = _both(run)
    assert trail[0][0] >= 0.05 and trail[0][1] == []     # miss 1 of 3
    assert trail[1][1] == []                             # miss 2 of 3
    assert trail[2][1] == [1] and trail[2][2]["stragglers"] == 1
    assert trail[3][2]["stragglers"] == 1                # no re-fire
    assert trail[4][0] == 0.0 and trail[4][1] == []
    assert trail[4][2]["recovered"] == 1
    assert trail[5][0] == [1] and trail[5][1]["stragglers"] == 2
    assert ("telemetry.straggler", 1) in events
    assert ("telemetry.recovered", 1) in events


def test_straggler_needs_two_peers_for_median():
    """A uniformly slow phase (every peer equally slow) scores nobody
    above the self-cancelling median."""
    def run(pkg):
        clock = _Clock()
        mon = pkg.health.HealthMonitor(0, 4, sample_s=1e9, window_s=10.0,
                                       threshold=0.05, miss=1, clock=clock)
        clock.t = 1.0
        for peer in (1, 2, 3):
            mon.note_wait(peer, 0.7)
        clock.t = 1.1
        return mon.sample(), mon.declared()

    scores, declared = _both(run)
    assert all(s < 0.05 for s in scores.values()) and declared == []


def test_degraded_episode_latches(tele):
    def run(pkg):
        pkg.var.var_set("mpi_base_telemetry_degraded_ms", 1.0)
        try:
            mon = pkg.health.HealthMonitor(0, 2, sample_s=1e9,
                                           window_s=10.0, threshold=0.05,
                                           miss=3, clock=_Clock())
            seen = []
            pkg.tele.PML_SEND.record(50_000.0)   # own p99 50 ms >> 1 ms
            mon.sample(1.0)
            seen.append(mon.stats["degraded"])
            mon.sample(1.1)              # the episode latch: no re-count
            seen.append(mon.stats["degraded"])
            pkg.tele.PML_SEND.reset()    # p99 back under the limit
            mon.sample(1.2)
            pkg.tele.PML_SEND.record(50_000.0)   # a new episode counts
            mon.sample(1.3)
            seen.append(mon.stats["degraded"])
            return seen
        finally:
            pkg.var.var_set("mpi_base_telemetry_degraded_ms", 0.0)

    assert _both(run) == [1, 1, 2]


# -- per-comm retirement -----------------------------------------------------
def test_retire_comm_drops_hists_and_pvars(tele):
    def run(pkg):
        hists = pkg.tele.coll_hists("c77", "allreduce")
        for h in hists:
            h.record(10.0)               # the first record registers
        names = {h.name for h in hists}
        listed = names <= set(pkg.pvar.pvar_names())
        pkg.tele.get_hist("tele_unrelated_us").record(1.0)
        retired = pkg.tele.retire_comm("c77")
        live = {h.name for h in pkg.tele.histograms()}
        again = pkg.tele.retire_comm("c77")
        return (sorted(names), listed, sorted(retired),
                sorted(names & set(pkg.pvar.pvar_names())),
                sorted(names & live), "tele_unrelated_us" in live,
                sorted(names & set(again)))

    names, listed, retired, left, live, kept, again = _both(run)
    assert len(names) == len(p_tele.SIZE_CLASS_NAMES) and listed
    assert set(names) <= set(retired)
    assert left == [] and live == [] and kept and again == []


def test_retire_comm_drops_trace_skew_pvar():
    def run(pkg):
        pkg.attr._note_skew("88", 0.25)
        before = ("trace_skew_c88" in pkg.pvar.pvar_names(),
                  "88" in pkg.attr.skew_watermarks())
        retired = pkg.tele.retire_comm("88")
        return (before, "trace_skew_c88" in retired,
                "trace_skew_c88" in pkg.pvar.pvar_names(),
                "88" in pkg.attr.skew_watermarks())

    assert _both(run) == ((True, True), True, False, False)


def test_pvar_retire_comm_drops_exactly_the_tagged_names():
    """The repair's primitive: only the names tagged with that cid go."""
    def run(pkg):
        for name, comm in (("t_a", "5"), ("t_b", 5), ("t_c", "6"),
                           ("t_d", None)):
            pkg.pvar.pvar_register(name, lambda: 1, comm=comm)
        try:
            retired = pkg.pvar.pvar_retire_comm(5)
            return retired, sorted(n for n in ("t_a", "t_b", "t_c", "t_d")
                                   if n in pkg.pvar.pvar_names())
        finally:
            for n in ("t_a", "t_b", "t_c", "t_d"):
                pkg.pvar.pvar_unregister(n)

    assert _both(run) == (["t_a", "t_b"], ["t_c", "t_d"])


def _skew_spans(cid, late=2):
    """Synthetic spans of one allreduce on ``cid``: rank ``late``
    arrives 0.3 s after the rest."""
    return [{"kind": "span", "name": "coll_allreduce", "cid": cid,
             "seq": 1, "rank": r, "ts": 10.0 + (0.3 if r == late else 0.0),
             "dur": 0.01} for r in range(4)]


def test_freed_dup_loses_its_trace_skew_pvar(pworld, world):
    """The repair on the single-controller worlds: a dup whose skew
    watermark was recorded through attribution (the same synthetic
    spans in both packages) loses ``trace_skew_c<cid>`` and its
    histogram pvars on ``free()``; so does a shrunk comm's parent."""
    def run(pkg):
        w = pworld if pkg is PORT else world
        pkg.tele.enable()
        d = w.dup()
        x = (d.alloc((2,), fill=1.0) if pkg is PORT
             else d.alloc((2,), np.float32, fill=1.0))
        d.allreduce(x)                   # one histogram pvar per slot
        name = f"trace_skew_c{d.cid}"
        reps = pkg.attr.late_arrival(_skew_spans(d.cid))
        hists = [n for n in pkg.pvar.pvar_names()
                 if n.startswith("tele_coll_") and f"_c{d.cid}_" in n]
        before = (name in pkg.pvar.pvar_names(), len(hists),
                  reps[0]["critical_rank"])
        d.free()
        names = set(pkg.pvar.pvar_names())
        after = (name in names, [n for n in hists if n in names])
        d2 = w.dup()
        pkg.attr.late_arrival(_skew_spans(d2.cid))
        s = d2.shrink()
        after_shrink = f"trace_skew_c{d2.cid}" in pkg.pvar.pvar_names()
        s.free()
        d2.free()
        pkg.tele.disable()
        return before, after, after_shrink

    before, after, after_shrink = _both(run)
    assert before == (True, 1, 2)
    assert after == (False, []) and after_shrink is False


def _run_job(launcher, body, n, tmp_path, tag, mca=(), recovery=False):
    """Launch ``body`` on ``n`` ranks of ``launcher``; returns (rc, out,
    err). Every process of the job is killed at the end."""
    prog = tmp_path / f"{tag}.py"
    prog.write_text(textwrap.dedent(body))
    cmd = [sys.executable, launcher, "--per-rank", "-n", str(n),
           "--timeout", str(JOB_LIMIT - 5)]
    if launcher == PORT_MPIRUN:
        cmd += ["--mca", "mpi_base_device", "cpu"]
        if recovery:
            cmd.append("--enable-recovery")
    for k, v in mca:
        cmd += ["--mca", k, str(v)]
    cmd += [str(prog), str(tmp_path)]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "OMPI_TPU_"))}
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=_REPO,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=JOB_LIMIT)
    except subprocess.TimeoutExpired:
        out, err = "", "killed at the test's limit"
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    return proc.returncode, out, err


_FREE_BODY = """
    d = w.dup()
    name = "trace_skew_c" + str(d.cid)
    spans = [{"kind": "span", "name": "coll_allreduce", "cid": d.cid,
              "seq": 1, "rank": q, "ts": 10.0 + (0.3 if q == 2 else 0.0),
              "dur": 0.01} for q in range(3)]
    rep = attribution.late_arrival(spans)
    assert rep[0]["critical_rank"] == 2, rep
    assert name in pvar.pvar_names()
    d.free()
    assert name not in pvar.pvar_names(), name
    MPI.Finalize()
    print("OK free", w.rank(), flush=True)
"""


def test_perrank_freed_dup_loses_its_trace_skew_pvar(tmp_path):
    """The repair on the per-rank tier: in a 3-rank job of each package,
    a dup's ``trace_skew_c<cid>`` (recorded through attribution on the
    same synthetic spans) is gone after ``free()``."""
    port = ("import ompi_tpu_torch as MPI\n"
            "from ompi_tpu_torch.mca import pvar\n"
            "from ompi_tpu_torch.trace import attribution\n"
            "MPI.Init()\nw = MPI.get_comm_world()\n")
    ref = ("import os\nos.environ['JAX_PLATFORMS'] = 'cpu'\nimport jax\n"
           "jax.config.update('jax_platforms', 'cpu')\n"
           "import ompi_tpu as MPI\nfrom ompi_tpu.mca import pvar\n"
           "from ompi_tpu.trace import attribution\n"
           "MPI.Init()\nw = MPI.get_comm_world()\n")
    for launcher, head, tag in ((PORT_MPIRUN, port, "port"),
                                (REF_MPIRUN, ref, "ref")):
        rc, out, err = _run_job(launcher, head + textwrap.dedent(_FREE_BODY),
                                3, tmp_path, tag)
        assert rc == 0 and out.count("OK free") == 3, \
            (tag, rc, out, err[-3000:])


# -- flight recorder ---------------------------------------------------------
def test_flightrec_inactive_refuses():
    def run(pkg):
        pkg.flightrec._reset_for_tests()
        return pkg.tele.active, pkg.flightrec.record("straggler",
                                                     {"rank": 1})

    assert _both(run) == (False, None)


def test_flightrec_record_rate_limit_and_siblings(tele, tmp_path):
    def run(pkg):
        out = tmp_path / pkg.name
        out.mkdir()
        pkg.var.var_set("mpi_base_telemetry_flightrec_dir", str(out))
        try:
            pkg.flightrec.arm(7)
            p1 = pkg.flightrec.record("straggler", {"rank": 3})
            d = json.loads(open(p1).read())
            head = (d["flightrec"], d["rank"], d["trigger"], d["detail"],
                    all(k in d for k in ("spans", "pvars", "ft_events",
                                         "health", "wall_time",
                                         "osc_epochs")))
            again = pkg.flightrec.record("straggler", {"rank": 3})
            p2 = pkg.flightrec.record("revoke", {"rank": 7})
            files = sorted(os.listdir(out))
            return (os.path.basename(p1), head, again,
                    os.path.basename(p2), files)
        finally:
            pkg.var.var_set("mpi_base_telemetry_flightrec_dir", "")

    name1, head, again, name2, files = _both(run)
    assert name1 == "flightrec_7.json"
    assert head == (1, 7, "straggler", {"rank": 3}, True)
    assert again is None                 # the same (trigger, subject)
    assert name2 != name1 and files == sorted([name1, name2])


_MERGE_PAYLOADS = [
    {"flightrec": 1, "rank": 0, "trigger": "proc_failed",
     "detail": {"rank": 2}, "wall_time": 2.0,
     "spans": [{"rank": 2, "name": "coll_allreduce"}], "health": {}},
    {"flightrec": 1, "rank": 1, "trigger": "proc_failed",
     "detail": {"rank": 2}, "wall_time": 1.0, "spans": [], "health": {}},
    {"flightrec": 1, "rank": 0, "trigger": "revoke",
     "detail": {"rank": 0}, "wall_time": 3.0},
]


def test_flightrec_merge_elects_critical_and_absent():
    rep = _both(lambda pkg: pkg.flightrec.merge(
        json.loads(json.dumps(_MERGE_PAYLOADS))))
    assert rep["critical_rank"] == 2 and rep.get("critical_absent") is True
    assert rep["accusations"] == {"2": 2}
    times = [t["wall_time"] for t in rep["triggers"]]
    assert times == sorted(times)
    assert rep["critical_spans"] == [{"rank": 2, "name": "coll_allreduce"}]


def test_flightrec_merge_fallback_worst_p99():
    pays = [
        {"flightrec": 1, "rank": 0, "trigger": "revoke", "detail": {},
         "pvars": {"tele_pml_send_us": {"p99": 10.0, "count": 5}},
         "spans": [], "health": {}},
        {"flightrec": 1, "rank": 1, "trigger": "revoke", "detail": {},
         "pvars": {"tele_pml_send_us": {"p99": 9000.0, "count": 5}},
         "spans": [{"rank": 1, "name": "pml_send"}], "health": {}},
    ]
    rep = _both(lambda pkg: pkg.flightrec.merge(json.loads(json.dumps(pays))))
    assert rep["accusations"] == {} and rep["critical_rank"] == 1
    assert rep["critical_spans"] == [{"rank": 1, "name": "pml_send"}]
    assert "critical_absent" not in rep


# -- each package's tracedump, and the reference's, over its files ------------
def test_tracedump_skips_truncated_and_strict(tmp_path, capsys):
    """A trace dump the port wrote reads in the port's tracedump and in
    the reference's as the reference's own does: a truncated sibling is
    skipped (rc 0), and ``--strict`` turns the skip into rc 1."""
    def run(pkg, tracedump):
        d = tmp_path / pkg.name
        d.mkdir(exist_ok=True)
        pkg.trace.set_process_rank(0)
        pkg.trace.enable(capacity=16)
        try:
            pkg.trace.end(pkg.trace.begin("coll_allreduce", cid="w"))
            good = pkg.trace.dump(str(d / "trace_0.json"))
        finally:
            pkg.trace.disable()
            pkg.trace.reset()
            pkg.trace.set_process_rank(-1)
        bad = d / "trace_1.json"
        bad.write_text('{"rank": 1, "spans": [')   # truncated mid-write
        out = d / "sum.json"
        rc = tracedump.main(["--format", "summary", "-o", str(out),
                             good, str(bad)])
        err = capsys.readouterr().err
        rep = json.loads(out.read_text())
        rc_strict = tracedump.main(["--format", "summary", "-o", str(out),
                                    "--strict", good, str(bad)])
        rc_clean = tracedump.main(["--format", "summary", "-o", str(out),
                                   "--strict", good])
        capsys.readouterr()
        return (rc, "skipped" in err and "trace_1.json" in err,
                rep["skipped"], os.path.basename(
                    rep["skipped_files"][0]["file"]), rc_strict, rc_clean)

    assert _both(_own_and_ref_tool(run, "tracedump")) == \
        (0, True, 1, "trace_1.json", 1, 0)


def test_tracedump_flightrec_format(tmp_path, tele):
    """Flight-recorder snapshots the port wrote merge in the port's and
    the reference's ``tracedump --format flightrec`` into the same
    incident report as the reference's own snapshots."""
    def run(pkg, tracedump):
        d = tmp_path / pkg.name
        d.mkdir(exist_ok=True)
        pkg.var.var_set("mpi_base_telemetry_flightrec_dir", str(d))
        files = []
        try:
            for rank in (0, 1):
                pkg.flightrec._reset_for_tests()
                pkg.flightrec.arm(rank)
                files.append(pkg.flightrec.record("proc_failed",
                                                  {"rank": 3}))
        finally:
            pkg.var.var_set("mpi_base_telemetry_flightrec_dir", "")
        out = d / "incident.json"
        rc = tracedump.main(["--format", "flightrec", "-o", str(out)]
                            + files)
        rep = json.loads(out.read_text())
        return rc, rep["incident"], rep["critical_rank"], \
            rep["accusations"], rep["ranks"]

    assert _both(_own_and_ref_tool(run, "tracedump")) == \
        (0, 1, 3, {"3": 2}, [0, 1])


# -- each package's mpitop, and the reference's, over its telemetry dumps ----
def _dump_of(pkg, path, rank, rows, health_snap=None):
    """A telemetry dump written by ``pkg.tele.dump``: each row's values
    recorded into a registry histogram, the health section patched in.
    The one-sided counters (process-wide, left by any RMA test this
    process ran before) read zero while the dump is written, so the dump
    carries no ``osc`` section."""
    pkg.tele._reset_for_tests()
    pkg.tele.enable()
    for name, values, labels in rows:
        h = pkg.tele.get_hist(name, labels=labels)
        for v in values:
            h.record(v)
    osc = dict(pkg.osc.stats)
    pkg.osc.stats.update(dict.fromkeys(osc, 0))
    try:
        pkg.tele.dump(str(path), rank=rank)
    finally:
        pkg.osc.stats.update(osc)
    d = json.loads(path.read_text())
    d["health"] = health_snap or {}
    d["time"] = 100.0
    path.write_text(json.dumps(d))
    for h in pkg.tele.histograms():
        pkg.pvar.pvar_unregister(h.name)
    pkg.tele.disable()
    pkg.tele._reset_for_tests()
    return str(path)


def test_mpitop_summarize_elects_declared_straggler(tmp_path):
    coll = {"comm": "w", "func": "allreduce", "sclass": "small"}

    def run(pkg, mpitop):
        d = tmp_path / pkg.name
        d.mkdir(exist_ok=True)
        files = [
            _dump_of(pkg, d / "telemetry_0.json", 0,
                     [("tele_coll_allreduce_cw_small", [100] * 10, coll),
                      ("tele_pml_send_us", [50] * 10, None)],
                     {"scores": {"1": 0.3}, "declared": [1]}),
            _dump_of(pkg, d / "telemetry_1.json", 1,
                     [("tele_coll_allreduce_cw_small", [200_000] * 10,
                       coll),
                      ("tele_pml_send_us", [200_000] * 10, None)]),
        ]
        snaps, skipped = mpitop.load_snapshots(files)
        s = mpitop.summarize(snaps)
        per = mpitop.summarize(snaps, per_comm=True)
        return (skipped, s, mpitop.render_table(s),
                any(r.get("comm") == "w" for r in per["rows"]))

    skipped, s, table, per_comm = _both(_own_and_ref_tool(run, "mpitop"))
    assert skipped == [] and s["slow_rank"] == 1
    assert s["declared"] == {"1": 1} and s["accusations"]["1"] == 0.3
    rows = {r["rank"]: r for r in s["rows"]}
    assert rows[0]["coll_ops"] == 10 and rows[1]["send_p99_us"] >= 131072
    assert "STRAGGLER(x1)" in table and "SLOW" in table
    assert table.splitlines()[-1] == "slow_rank: 1" and per_comm


def test_mpitop_slow_rank_fallback_excludes_recv_waits(tmp_path):
    """With no accusations the election is own latency only: the rank
    stuck waiting (big recv p99) is not blamed for its peer."""
    def run(pkg, mpitop):
        d = tmp_path / pkg.name
        d.mkdir(exist_ok=True)
        files = [
            _dump_of(pkg, d / "telemetry_0.json", 0,
                     [("tele_pml_recv_us", [500_000] * 5, None),
                      ("tele_pml_send_us", [50] * 5, None)]),
            _dump_of(pkg, d / "telemetry_1.json", 1,
                     [("tele_pml_send_us", [200_000] * 5, None)]),
        ]
        s = mpitop.summarize(mpitop.load_snapshots(files)[0])
        return s["declared"], s["accusations"], s["slow_rank"]

    assert _both(_own_and_ref_tool(run, "mpitop")) == ({}, {}, 1)


def test_mpitop_load_snapshots_skips_garbage(tmp_path, capsys):
    def run(pkg, mpitop):
        d = tmp_path / pkg.name
        d.mkdir(exist_ok=True)
        good = _dump_of(pkg, d / "telemetry_0.json", 0, [])
        bad = d / "telemetry_1.json"
        bad.write_text("{not json")
        snaps, skipped = mpitop.load_snapshots([good, str(bad)])
        err = capsys.readouterr().err
        return ([s["rank"] for s in snaps],
                [os.path.basename(s["file"]) for s in skipped],
                "telemetry_1.json" in err)

    assert _both(_own_and_ref_tool(run, "mpitop")) == \
        ([0], ["telemetry_1.json"], True)


# -- Prometheus exporter -----------------------------------------------------
def test_prom_render_histogram_cumulative_and_gauge(tele, tmp_path):
    """The same registry contents render to the same exposition text
    (metric families keep the reference's ``ompi_tpu_`` prefix)."""
    def run(pkg):
        h = pkg.tele.get_hist("tele_demo_us", labels={"func": "demo"})
        for v in (1, 10, 100, 1000):
            h.record(v)
        pkg.pvar.pvar_register("tele_demo_gauge", lambda: 7,
                               help="prom exporter test gauge")
        try:
            names = set(pkg.pvar.pvar_names())
            text = pkg.prom.render(
                rank=3, pvars=[e for e in pkg.pvar.pvar_list()
                               if e["name"] in ("tele_demo_us",
                                                "tele_demo_gauge")])
            out = tmp_path / f"{pkg.name}.prom"
            pkg.prom.write_textfile(str(out), text)
            return (text, out.read_text() == text,
                    [f for f in os.listdir(tmp_path) if ".tmp." in f],
                    "tele_demo_us" in names)
        finally:
            pkg.pvar.pvar_unregister("tele_demo_gauge")

    text, same, tmp, listed = _both(run)
    assert "# TYPE ompi_tpu_tele_demo_us histogram" in text
    assert ('ompi_tpu_tele_demo_us_bucket{func="demo",le="+Inf",'
            'rank="3"} 4') in text
    assert 'ompi_tpu_tele_demo_us_count{func="demo",rank="3"} 4' in text
    assert 'ompi_tpu_tele_demo_us_sum{func="demo",rank="3"} 1111' in text
    cums = [int(line.rsplit(" ", 1)[1]) for line in text.splitlines()
            if line.startswith("ompi_tpu_tele_demo_us_bucket")]
    assert cums == sorted(cums) and cums[-1] == 4
    assert 'ompi_tpu_tele_demo_gauge{rank="3"} 7' in text
    assert text.count("# TYPE ompi_tpu_tele_demo_us ") == 1
    assert same and tmp == [] and listed


def test_prom_merged_rows_collapse_per_comm_families():
    labels = {"comm": "w", "func": "allreduce", "sclass": "small"}

    def run(pkg):
        row = dict(_hist_row(pkg, "tele_coll_allreduce_cw_small", [5, 9],
                             labels), rank=2)
        return pkg.prom.render(rank=-1, pvars=[], hist_rows=[row])

    text = _both(run)
    assert "# TYPE ompi_tpu_tele_coll_allreduce histogram" in text
    assert "tele_coll_allreduce_cw_small" not in text
    assert ('ompi_tpu_tele_coll_allreduce_count{comm="w",'
            'func="allreduce",rank="2",sclass="small"} 2') in text


def test_prom_dict_valued_pvar_one_sample_per_key():
    text = _both(lambda pkg: pkg.prom.render(rank=0, pvars=[
        {"name": "tele_straggler_scores", "class": "level",
         "value": {"1": 0.25, "3": 0.0}}], hist_rows=[]))
    assert 'ompi_tpu_tele_straggler_scores{key="1",rank="0"} 0.25' in text
    assert 'ompi_tpu_tele_straggler_scores{key="3",rank="0"} 0' in text


# -- the coll vtable shim: the same histograms on both worlds ----------------
def test_coll_histograms_match_the_reference(pworld, world):
    """With telemetry on before the comm is built, each selected slot is
    wrapped once and the same calls land in the same (func, size class)
    histograms of both packages; after ``free()`` they are gone."""
    def run(pkg):
        w = pworld if pkg is PORT else world
        pkg.tele.enable()
        d = w.dup()
        try:
            shims = sorted(f for f, m in d.c_coll.items()
                           if isinstance(m, pkg.tele._HistSlot))
            rng = np.random.default_rng(7)
            for n in (4, 1024, 100_000):
                x = rng.standard_normal((d.size, n)).astype(np.float32)
                d.allreduce(d.put(x))
            d.barrier()
            counts = {h.labels["sclass"]: h.merged()["count"]
                      for h in pkg.tele.histograms()
                      if h.comm == str(d.cid)
                      and h.labels.get("func") == "allreduce"}
            bar = sum(h.merged()["count"] for h in pkg.tele.histograms()
                      if h.comm == str(d.cid)
                      and h.labels.get("func") == "barrier")
        finally:
            d.free()
            pkg.tele.disable()
        gone = [h.name for h in pkg.tele.histograms()
                if h.comm == str(d.cid)]
        return shims, counts, bar, gone

    shims, counts, bar, gone = _both(run)
    assert "allreduce" in shims and "agree" in shims
    # stacked bytes 128, 32 KiB and 3.2 MB: small, medium, huge
    assert counts == {"small": 1, "medium": 1, "large": 0, "huge": 1}
    assert bar == 1 and gone == []
