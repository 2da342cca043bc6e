"""The port's tracer armed by a recording ``torch.profiler`` session: the
spans inside the data-parallel sync (``models/transformer``'s
``BucketedGradSync``, ``coll/persistent``) and inside the device
collectives (``coll/torch_``), recorded in the span ring with their
nesting and mirrored as profiler ranges of the same names; and nothing
recorded, and no range opened, when neither the MCA var nor a profiler
arms the tracer. Port only: the JAX package has no profiler to arm it.

On the CPU a start's completion event is None (the CPU ran the work in
the call), so the tests that need a wait to block give the starts an
event the device "has not reached" until it is synchronized.
"""
import json
import time

import pytest
import torch
from torch.autograd import profiler as torch_prof
from torch.profiler import ProfilerActivity, profile

import ompi_tpu_torch as P
from ompi_tpu_torch.coll import persistent
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.models.transformer import BucketedGradSync
from ompi_tpu_torch.trace import core as trace_core

N = 8
# per-rank float32 elements of each gradient leaf; with a 64-byte bucket
# the first two (24 + 48 B) flush on the bytes threshold, the fourth
# (20 B) at the Startall, and the third (256 B) is a direct plan
LEAF_ELEMS = (6, 12, 64, 5)
BUCKET_BYTES = 64
PROGRAM_SPANS = ("ddp.sync", "ddp.copy_in", "coll.startall",
                 "coll.bucket_flush", "coll.bucket_pack",
                 "coll.fused_allreduce", "coll.bucket_unpack",
                 "coll.body", "coll.request_wait",
                 "ddp.finish")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    P._reset_for_tests()
    # no ring left by an earlier ``enable(capacity=...)``: the first span
    # makes one at the var's capacity
    monkeypatch.setattr(trace_core, "_ring", None)
    yield
    P._reset_for_tests()


@pytest.fixture()
def pworld():
    P.Init(devices=["cpu"] * N)
    return P.get_comm_world()


class _Pending:
    """A completion event not reached until ``synchronize``."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


class _Unqueried(_Pending):
    """A pending event that may be synchronized but never polled."""

    def query(self):
        raise AssertionError("event polled with the tracer disarmed")


def _leaves(seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(N, k, generator=g) for k in LEAF_ELEMS]


def _sync(pworld, monkeypatch, event=_Pending):
    var.var_set("mpi_base_bucket", True)
    var.var_set("mpi_base_bucket_bytes", BUCKET_BYTES)
    leaves = _leaves()
    sync = BucketedGradSync(pworld, leaves)
    monkeypatch.setattr(persistent, "event_after", lambda _tree: event())
    return sync, leaves


def _inside(s, outer):
    return outer.ts <= s.ts and s.ts + s.dur <= outer.ts + outer.dur


def _named(spans, name, within=None):
    return [s for s in spans if s.name == name
            and (within is None or _inside(s, within))]


def _check_means(out, leaves):
    for got, g in zip(out, leaves):
        want = (g.double().sum(0, keepdim=True) / N).expand_as(g)
        torch.testing.assert_close(got.double(), want, rtol=1e-6,
                                   atol=1e-6)


def test_ddp_step_spans_nest_under_a_recording_profiler(
        pworld, monkeypatch, tmp_path):
    sync, leaves = _sync(pworld, monkeypatch)
    assert not trace_core.active
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = sync(leaves)
    t1 = time.perf_counter()
    _check_means(out, leaves)
    spans = sorted(trace_core.spans(), key=lambda s: s.ts)
    assert trace_core.stats()["dropped"] == 0
    # the ring keeps its own perf_counter stamps
    assert all(t0 <= s.ts and s.ts + s.dur <= t1 for s in spans)

    (step,) = _named(spans, "ddp.sync")
    assert step.args == {"leaves": 4, "bytes": 4 * N * sum(LEAF_ELEMS)}
    (copy_in,) = _named(spans, "ddp.copy_in", step)
    (start,) = _named(spans, "coll.startall", step)
    (finish,) = _named(spans, "ddp.finish", step)
    assert copy_in.ts + copy_in.dur <= start.ts
    assert start.ts + start.dur <= finish.ts

    flushes = _named(spans, "coll.bucket_flush")
    assert [f.args["members"] for f in flushes] == [2, 1]
    assert all(_inside(f, start) for f in flushes)
    for f in flushes:
        (pack,) = _named(spans, "coll.bucket_pack", f)
        (red,) = _named(spans, "coll.fused_allreduce", f)
        (unpack,) = _named(spans, "coll.bucket_unpack", f)
        assert pack.ts + pack.dur <= red.ts
        assert red.ts + red.dur <= unpack.ts
        (body,) = _named(spans, "coll.body", red)
        assert body.args["func"] == "allreduce"
        assert body.args["root"] is None
        assert body.args["algorithm"] == pworld._coll(
            "allreduce").selected("allreduce", torch.zeros(
                N, f.args["nbytes"] // 4), P.SUM)

    # one wait per event that blocks: each bucket's members share one,
    # and the direct plan has its own
    waits = _named(spans, "coll.request_wait")
    assert len(waits) == 3
    assert all(_inside(w, finish) for w in waits)
    assert len(spans) == len([s for s in spans if _inside(s, step)])

    ranges = {e.name for e in prof.events()}
    assert set(PROGRAM_SPANS) <= ranges
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    exported = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert set(PROGRAM_SPANS) <= exported


@pytest.mark.parametrize("func", ["allreduce", "gather"])
def test_collective_body_spans(pworld, func):
    x = torch.randn(N, 16, generator=torch.Generator().manual_seed(3))
    root = None if func == "allreduce" else 3

    def call():
        return (pworld.allreduce(x, P.SUM) if func == "allreduce"
                else pworld.gather(x, root))

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        first, second = call(), call()
    assert torch.equal(first, second)
    spans = sorted(trace_core.spans(), key=lambda s: s.ts)
    # one body per call, gather's delegating plan (``allgather``, bound
    # at plan time) included; the first call's selection built the
    # schedule, the second's was one probe
    bodies = _named(spans, "coll.body")
    assert [s.name for s in spans] == ["coll.body"] * 2
    alg = pworld._coll(func).selected(func, x, P.SUM if root is None
                                      else None, root)
    want = {"func": func, "algorithm": alg, "root": root,
            "bytes": x.numel() * 4}
    assert [b.args for b in bodies] == [{**want, "built": True}, want]
    assert "coll.body" in {e.name for e in prof.events()}


def test_disarmed_tracer_records_nothing_and_opens_no_range(
        pworld, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("profiler range opened with the tracer off")
    monkeypatch.setattr(trace_core, "_Range", boom)
    assert not trace_core.active and not torch_prof._is_profiler_enabled
    sync, leaves = _sync(pworld, monkeypatch, event=_Unqueried)
    _check_means(sync(leaves), leaves)
    x = torch.randn(N, 16)
    pworld.allreduce(x, P.SUM)
    pworld.gather(x, 3)
    assert trace_core.stats()["spans"] == 0
    assert trace_core.spans() == []


def test_nothing_records_after_the_profiler_exits(pworld, monkeypatch):
    sync, leaves = _sync(pworld, monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]):
        sync(leaves)
    recorded = trace_core.stats()["spans"]
    assert recorded > 0 and not torch_prof._is_profiler_enabled
    monkeypatch.setattr(trace_core, "_Range", None)
    _check_means(sync(leaves), leaves)
    pworld.allreduce(torch.randn(N, 16), P.SUM)
    assert trace_core.stats()["spans"] == recorded


def test_enabled_tracer_records_the_spans_without_ranges(pworld,
                                                         monkeypatch):
    """Armed by ``enable()`` alone, the same spans land in the ring and
    no profiler range is opened."""
    sync, leaves = _sync(pworld, monkeypatch)
    monkeypatch.setattr(trace_core, "_Range", None)
    trace_core.enable()
    _check_means(sync(leaves), leaves)
    names = {s.name for s in trace_core.spans()}
    assert set(PROGRAM_SPANS) <= names
