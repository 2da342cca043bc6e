"""The port's resilience plane against the reference's
(``tests/test_ft.py``): the injection gate's zero-cost contract, spec
parsing and match filtering, the failure registry's epoch order and
dedup, the heartbeat detector's hysteresis on synthetic clocks,
request-level FT, the api-layer errhandler guard, the ``ft.*`` trace
aggregation and the persistent counters.

Every case drives both packages with the same var settings, the same
frames, the same clocks and the same spans, and the observations must
be identical. The one timing case (detection latency against a real
clock) holds each package to the reference's own bounds. The
reference's ``test_ft_checkparity_recovery_rule`` audits
``tools/checkparity``, which has no port yet (ROADMAP 17e);
it has no mirror here.
"""
import time
from types import SimpleNamespace

import pytest

from ompi_tpu.api import mpi as r_api
from ompi_tpu.core import errhandler as r_errh
from ompi_tpu.core.request import Request as RRequest
from ompi_tpu.ft import detector as r_det
from ompi_tpu.ft import inject as r_inject
from ompi_tpu.mca import var as r_var
from ompi_tpu.runtime import ft as r_ft
from ompi_tpu.trace import attribution as r_attr
from ompi_tpu_torch.api import mpi as p_api
from ompi_tpu_torch.core import errhandler as p_errh
from ompi_tpu_torch.core.request import Request as PRequest
from ompi_tpu_torch.ft import detector as p_det
from ompi_tpu_torch.ft import inject as p_inject
from ompi_tpu_torch.mca import var as p_var
from ompi_tpu_torch.runtime import ft as p_ft
from ompi_tpu_torch.trace import attribution as p_attr

PORT = SimpleNamespace(name="port", inject=p_inject, var=p_var, ft=p_ft,
                       det=p_det, errh=p_errh, Request=PRequest, api=p_api,
                       attr=p_attr)
REF = SimpleNamespace(name="ref", inject=r_inject, var=r_var, ft=r_ft,
                      det=r_det, errh=r_errh, Request=RRequest, api=r_api,
                      attr=r_attr)
BOTH = (PORT, REF)


def _both(fn):
    """``fn(pkg)`` on the port and on the reference; the two
    observations must be identical. Returns the port's."""
    port, ref = fn(PORT), fn(REF)
    assert port == ref, (port, ref)
    return port


@pytest.fixture
def inj():
    """Both injection planes, left exactly as they ship — off."""
    for pkg in BOTH:
        pkg.inject.register_params()
    yield BOTH
    for pkg in BOTH:
        pkg.var.var_set("mpi_base_ft_inject", False)
        for cls in pkg.inject.FAULT_CLASSES:
            pkg.var.var_set(f"mpi_base_ft_inject_{cls}", "")
        pkg.inject.refresh()
        assert not pkg.inject.active


# -- injection gate ------------------------------------------------------
def test_ft_inject_gate_cold_by_default(inj):
    def run(pkg):
        pkg.inject.refresh()
        return (pkg.inject.active, dict(pkg.inject.stats),
                pkg.inject.frame_fault("pml", 1),
                pkg.inject.should_corrupt(1), pkg.inject.should_sever(1))

    active, stats, fault, corrupt, sever = _both(run)
    assert active is False and all(v == 0 for v in stats.values())
    assert fault is None and not corrupt and not sever


def test_ft_inject_gate_needs_switch_AND_spec(inj):
    def run(pkg):
        seen = []
        pkg.var.var_set("mpi_base_ft_inject_drop", "plane=pml")
        pkg.inject.refresh()
        seen.append(pkg.inject.active)   # a spec without the switch
        pkg.var.var_set("mpi_base_ft_inject", True)
        pkg.inject.refresh()
        seen.append(pkg.inject.active)
        pkg.var.var_set("mpi_base_ft_inject_drop", "")
        pkg.inject.refresh()
        seen.append(pkg.inject.active)   # the switch without a spec
        return seen

    assert _both(run) == [False, True, False]


def test_ft_inject_spec_parsing():
    specs = ("", "   ", "rank=2,point=coll.allreduce,hit=2",
             "plane=tcp,ms=37.5,count=-1,junk,also=ok")
    parsed = _both(lambda pkg: [pkg.inject._parse(s) for s in specs])
    assert parsed[0] is None and parsed[1] is None
    assert parsed[2]["rank"] == 2 and parsed[2]["hit"] == 2
    assert parsed[2]["point"] == "coll.allreduce"
    assert parsed[2]["nth"] == 1 and parsed[2]["count"] == 1
    assert parsed[3]["ms"] == 37.5 and parsed[3]["count"] == -1
    assert parsed[3]["plane"] == "tcp" and parsed[3]["also"] == "ok"


def test_ft_inject_match_filters_rank_plane_peer_nth_count(inj):
    def run(pkg):
        pkg.var.var_set("mpi_base_ft_inject", True)
        pkg.var.var_set("mpi_base_ft_inject_drop",
                        "rank=1,plane=pml,peer=2,nth=2,count=1")
        pkg.inject.refresh(rank=1)
        seen = [pkg.inject.active]
        seen += [pkg.inject.frame_fault(p, d) for p, d in
                 (("tcp", 2), ("pml", 3), ("pml", 2), ("pml", 2),
                  ("pml", 2))]
        seen.append(pkg.inject.stats["drop"])
        pkg.inject.refresh(rank=0)       # the wrong rank: inert
        seen += [pkg.inject.frame_fault("pml", 2) for _ in range(3)]
        seen.append(pkg.inject.stats["drop"])
        return seen

    assert _both(run) == [True, None, None, None, ("drop", 0.0), None, 1,
                          None, None, None, 0]


def test_ft_inject_delay_seconds_and_kill_point_counting(inj):
    def run(pkg):
        pkg.var.var_set("mpi_base_ft_inject", True)
        pkg.var.var_set("mpi_base_ft_inject_delay", "ms=120,count=2")
        pkg.var.var_set("mpi_base_ft_inject_kill", "rank=0,point=x,hit=3")
        pkg.inject.refresh(rank=0)
        fault = pkg.inject.frame_fault("tcp", 5)
        pkg.inject.point("y")            # the wrong point: no-op
        pkg.inject.point("x")            # hits 1..2 stay below hit=3;
        pkg.inject.point("x")            # still alive proves no _exit
        kills = [pkg.inject.stats["kill"]]
        pkg.inject.refresh(rank=2)       # the wrong rank: inert point
        for _ in range(5):
            pkg.inject.point("x")
        kills.append(pkg.inject.stats["kill"])
        return fault, kills

    fault, kills = _both(run)
    assert fault == ("delay", pytest.approx(0.12)) and kills == [0, 0]


# -- failure registry ----------------------------------------------------
def test_ft_registry_dedup_epochs_listeners():
    def run(pkg):
        reg = pkg.ft.Registry()
        calls = []
        reg.add_listener(lambda rk, reason: calls.append((rk, reason)))
        before = reg.any_failed()
        reg.fail_rank(2, "first")
        reg.fail_rank(2, "duplicate ingress")     # dedup: no new event
        reg.fail_rank(5, "second")
        evs = reg.events()
        return (before, [(e.rank, e.reason, e.epoch) for e in evs],
                reg.failed_ranks(), reg.any_failed(), calls,
                reg.failure_reason(2), reg.epoch())

    before, evs, failed, anyf, calls, why, epoch = _both(run)
    assert before is False and anyf
    assert [e[0] for e in evs] == [2, 5] and evs[0][1] == "first"
    assert evs[0][2] < evs[1][2] and epoch == 2
    assert failed == frozenset({2, 5}) and why == "first"
    assert calls == [(2, "first"), (5, "second")]


def test_ft_registry_remove_listener():
    def run(pkg):
        reg = pkg.ft.Registry()
        calls = []

        def cb(rk, reason):
            calls.append(rk)

        reg.add_listener(cb)
        reg.fail_rank(1, "x")
        reg.remove_listener(cb)
        reg.fail_rank(3, "y")
        return calls

    assert _both(run) == [1]


# -- heartbeat detector (synthetic clocks) -------------------------------
def _det(pkg, reg, rank=1, nprocs=2, **kw):
    hbs = []
    kw.setdefault("period", 0.1)
    kw.setdefault("timeout", 0.8)
    kw.setdefault("miss", 3)
    return pkg.det.Detector(rank, nprocs, hbs.append, reg, **kw), hbs


def test_ft_detector_declares_only_past_miss_hysteresis():
    def run(pkg):
        reg = pkg.ft.Registry()
        det, hbs = _det(pkg, reg)
        t0 = 1000.0
        trail = [det.check_once(now=t0), det.predecessor()]
        # silence just under the timeout: never even a suspect
        trail += [det.check_once(now=t0 + 0.79), det.stats["suspects"]]
        # past the timeout: a suspect, declared only on the 3rd miss
        trail += [det.check_once(now=t0 + 0.9), det.stats["suspects"]]
        trail += [det.check_once(now=t0 + 1.0),
                  det.check_once(now=t0 + 1.1)]
        return (trail, reg.failed_ranks(), dict(det.stats), hbs)

    trail, failed, stats, hbs = _both(run)
    assert trail == [None, 0, None, 0, None, 1, None, 0]
    assert failed == frozenset({0})
    assert stats["declared"] == 1 and stats["suspects"] == 0
    assert hbs and all(p == 0 for p in hbs)    # beats to the successor


def test_ft_detector_suspect_clears_on_late_heartbeat():
    def run(pkg):
        reg = pkg.ft.Registry()
        det, _ = _det(pkg, reg)
        t0 = time.monotonic()
        det.check_once(now=t0)
        det.check_once(now=t0 + 0.9)    # miss 1: a suspect
        seen = [det.stats["suspects"]]
        det.on_heartbeat(0)              # the beat lands
        seen.append(det.stats["suspects"])
        seen.append(det.check_once(now=time.monotonic() + 0.5))
        return seen, det.stats["declared"], reg.any_failed()

    assert _both(run) == ([1, 0, None], 0, False)


def test_ft_detector_disabled_and_trivial_worlds():
    def run(pkg):
        reg = pkg.ft.Registry()
        det, _ = _det(pkg, reg, period=0.0)
        det1, _ = _det(pkg, reg, rank=0, nprocs=1, period=0.1)
        return det.start(), det1.start()

    assert _both(run) == (False, False)


def test_ft_detector_ring_skips_failed_and_departed():
    def run(pkg):
        reg = pkg.ft.Registry()
        det, _ = _det(pkg, reg, rank=0, nprocs=4)
        seen = [det.successor(), det.predecessor()]
        reg.fail_rank(3, "x")
        seen.append(det.predecessor())  # the ring repaired
        det.departed = lambda r: r == 1  # a graceful 'bye'
        seen.append(det.successor())
        return seen

    assert _both(run) == [1, 3, 2, 2]


def test_ft_detector_latency_accounting():
    """Detection latency is the silence since the victim was last seen,
    less one period — each package within the reference's bounds."""
    for pkg in BOTH:
        reg = pkg.ft.Registry()
        det, _ = _det(pkg, reg, period=0.1)
        det._last_seen[2] = time.monotonic() - 0.5
        det.record_latency(2, "eof monitor")
        lat = det.stats["detect_latency_us"]
        assert 0.3e6 < lat < 0.55e6, (pkg.name, lat)
        assert reg.detect_latency_us == lat


# -- request-level FT ----------------------------------------------------
def test_ft_request_fail_completes_in_error():
    def run(pkg):
        rq = pkg.Request()
        rq.fail(pkg.errh.MPIError(pkg.errh.ERR_PROC_FAILED,
                                  "peer world rank 2 failed"))
        raised = []
        for call in (rq.test, rq.wait):
            try:
                call()
            except pkg.errh.MPIError as e:
                raised.append(e.error_class)
        return rq.status.error, raised

    assert _both(run) == (75, [75, 75])


# -- api-layer errhandler guard ------------------------------------------
def test_ft_api_guard_routes_through_errhandler():
    def run(pkg):
        class DummyComm:
            pass

        def boom():
            raise pkg.errh.MPIError(pkg.errh.ERR_PROC_FAILED, "drill")

        c = DummyComm()
        c.errhandler = pkg.errh.ERRORS_RETURN
        try:
            pkg.api._guard(c, boom)
            returned = None
        except pkg.errh.MPIError as e:
            returned = e.error_class
        handled = []
        c.errhandler = pkg.errh.Errhandler(
            lambda comm, ec, msg: handled.append(ec) or ("handled", ec))
        return returned, pkg.api._guard(c, boom), handled

    assert _both(run) == (75, ("handled", 75), [75])


# -- observability -------------------------------------------------------
def test_ft_trace_aggregation_by_observing_rank():
    spans = [
        {"kind": "span", "name": "ft.suspect", "rank": 1, "dur": 0.002,
         "args": {"by": 1, "rank": 0, "declared": False}},
        {"kind": "span", "name": "ft.suspect", "rank": 1, "dur": 0.005,
         "args": {"by": 1, "rank": 0, "declared": True}},
        {"kind": "instant", "name": "ft.declare", "rank": 1,
         "args": {"by": 1, "rank": 0}},
        {"kind": "span", "name": "coll_allreduce", "rank": 1, "dur": 0.1},
    ]

    def run(pkg):
        return (pkg.attr.ft_by_rank(spans),
                "ft" in pkg.attr.summarize(spans),
                "ft" in pkg.attr.summarize(
                    [{"kind": "span", "name": "coll_allreduce",
                      "dur": 0.1}]))

    agg, with_ft, without = _both(run)
    e = agg["1"]
    assert set(agg) == {"1"} and e["suspects"] == 2 and e["cleared"] == 1
    assert e["declared"] == 1 and e["suspect_us"] == pytest.approx(7000.0)
    assert with_ft and not without


def test_ft_persistent_counters_snapshot():
    from ompi_tpu.coll import persistent as r_persistent
    from ompi_tpu_torch.coll import persistent as p_persistent
    for mod in (p_persistent, r_persistent):
        assert isinstance(mod.counters(), dict)


def test_ft_probe_devices_marks_a_failing_device():
    """The port's probe really touches each rank's device: a device whose
    op raises marks its rank failed as ``device probe: <type>`` and does
    not carry on elsewhere; a healthy CPU rank stays alive."""
    import torch
    reg = p_ft.Registry()
    bad = torch.device("meta")           # a device that holds no data
    assert reg.probe_devices([torch.device("cpu"), bad, "cpu"]) == [1]
    assert reg.failure_reason(1).startswith("device probe: ")
    assert reg.failed_ranks() == frozenset({1})
