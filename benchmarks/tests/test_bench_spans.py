"""The readers of the program's spans (``wait_ms_per_step.ddp``,
``fuse_ms_per_step.ddp``, ``entry_self_ms_per_step.ddp``,
``body_host_us_per_call.coll``) against the same numbers computed by
hand from the span ring, on a tiny run of each cell on the CPU.

On the CPU ``benchlib.profile.trace`` runs the work once, without a
profiler; here it runs it twice under a CPU profiler, as the card's two
passes, and keeps the first pass's bounds on the host clock, so the hand
count takes that pass's spans by their times. A start's completion event
is None on the CPU; the DDP run gives each start one the device "has not
reached" until it is synchronized, so its waits block."""
import statistics
import time

import pytest
from torch.profiler import ProfilerActivity, profile

from benchlib import profile as prof_mod
from benchlib import spec
from conftest import tiny

DDP = ("wait_ms_per_step.ddp", "fuse_ms_per_step.ddp",
       "entry_self_ms_per_step.ddp")
COLL = ("body_host_us_per_call.coll",)
SEED = 2**31 + 11


class _Pending:
    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


@pytest.fixture(autouse=True)
def _no_ring(monkeypatch):
    """No ring left by an earlier ``enable(capacity=...)``: the first
    span makes one at the var's capacity, as in a fresh process."""
    from ompi_tpu_torch.trace import core
    monkeypatch.setattr(core, "_ring", None)


@pytest.fixture
def passes(monkeypatch):
    """The two profiled passes on the CPU; yields the list their host
    clock bounds are appended to."""
    bounds = []

    def trace(work):
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CPU]):
                t0 = time.perf_counter()
                work()
                bounds.append((t0, time.perf_counter()))
        return {"busy_s": None, "window_s": None, "device_ops": [],
                "idle_gaps": []}
    monkeypatch.setattr(prof_mod, "trace", trace)
    return bounds


def _first_pass(bounds, name):
    from ompi_tpu_torch import trace
    a, b = bounds[0]
    return [s for s in trace.spans()
            if s.name == name and a <= s.ts and s.ts + s.dur <= b]


def _ddp_run(monkeypatch, steps=3):
    from ompi_tpu_torch.coll import persistent
    monkeypatch.setattr(persistent, "event_after", lambda _t: _Pending())
    cfg, mix = tiny("ddp_gpt2m_bucket25")
    mix["profile_steps"] = steps
    return spec.driver("grad_sync").run(cfg, mix, SEED, 0.05, 1, "cpu",
                                        0.0)


@pytest.mark.parametrize("name", DDP + COLL)
def test_reader_finds_nothing_in_an_empty_record(name):
    assert spec.reader(name).read({}) is None


@pytest.mark.parametrize("name", DDP + COLL)
def test_reader_finds_nothing_in_an_untraced_run(fresh_world, name):
    kind = "grad_sync" if name in DDP else "collectives"
    workload = "ddp_gpt2m_bucket25" if name in DDP else "w8_coll_32MiB"
    cfg, mix = tiny(workload)
    rec = spec.driver(kind).run(cfg, mix, SEED, 0.05, 0, "cpu", 0.0)
    assert rec["kind"] == kind
    assert spec.reader(name).read(rec) is None


def test_ddp_readers_read_the_first_pass(fresh_world, monkeypatch,
                                         passes):
    rec = _ddp_run(monkeypatch)
    k = rec["profile_steps"]
    steps = _first_pass(passes, "ddp.sync")
    waits = _first_pass(passes, "coll.request_wait")
    flushes = _first_pass(passes, "coll.bucket_flush")
    assert len(steps) == k and waits and flushes
    # the second pass recorded as many steps, which the readers leave out
    a2, _b2 = passes[1]
    assert len([s for s in _first_pass([passes[1]], "ddp.sync")]) == k
    assert all(s.ts < a2 for s in steps)
    # a step's flushes (in its Startall) and waits (in its means) never
    # overlap, so its self time is what both leave of it
    wait = sum(s.dur for s in waits) / k * 1e3
    fuse = sum(s.dur for s in flushes) / k * 1e3
    self_ = sum(s.dur for s in steps) / k * 1e3 - wait - fuse
    got = {m: spec.reader(m).read(rec) for m in DDP}
    assert got == {"wait_ms_per_step.ddp": pytest.approx(wait),
                   "fuse_ms_per_step.ddp": pytest.approx(fuse),
                   "entry_self_ms_per_step.ddp": pytest.approx(self_)}
    assert all(v > 0 for v in got.values())
    assert spec.reader(COLL[0]).read(rec) is None


def test_coll_reader_reads_the_first_pass(fresh_world, passes):
    cfg, mix = tiny("w8_coll_32MiB")
    rec = spec.driver("collectives").run(cfg, mix, SEED, 0.05, 1, "cpu",
                                         0.0)
    bodies = _first_pass(passes, "coll.body")
    assert len(bodies) == mix["profile_rounds"] * len(mix["calls"])
    assert {s.args["func"] for s in bodies} == set(mix["calls"])
    got = spec.reader(COLL[0]).read(rec)
    assert got == pytest.approx(statistics.median(s.dur for s in bodies)
                                * 1e6)
    assert all(spec.reader(m).read(rec) is None for m in DDP)


@pytest.mark.parametrize("name", DDP + COLL)
def test_reader_refuses_a_ring_that_dropped(fresh_world, monkeypatch,
                                            passes, name):
    from ompi_tpu_torch import trace
    if name in DDP:
        rec = _ddp_run(monkeypatch, steps=1)
    else:
        cfg, mix = tiny("w8_coll_32MiB")
        rec = spec.driver("collectives").run(cfg, mix, SEED, 0.05, 1,
                                             "cpu", 0.0)
    assert spec.reader(name).read(rec) is not None
    stats = trace.stats()
    monkeypatch.setattr(trace, "stats", lambda: dict(stats, dropped=1))
    assert spec.reader(name).read(rec) is None
