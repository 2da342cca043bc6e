"""Parity of the port's nonblocking collectives and requests with the JAX
package's.

An 8-rank port world on the CPU (``Init(devices=["cpu"] * 8)``) against
the conftest's 8-device JAX world: the same stacked inputs, made with
numpy from a seed, go through every ``i*`` entry of both packages —
the ``coll/nbc`` ring/binomial schedules (37 elements per rank, not a
multiple of 8) and their one-round fused path (64 KiB of stacked
buffer), and the async-dispatch entries. Tolerances: rtol 1e-5 for float
SUM/PROD (another summation order), exact for MAX/MIN, integers and data
movement.

On the CPU a request is born complete or completes when its schedule's
last round has run; on the card it completes on a CUDA event. The
event protocol is checked here with a stand-in event (the card run is
``chip_smoke.py`` phase 7). Each test starts the port from a fresh state.
"""
import math
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ompi_tpu_torch as P
from ompi_tpu.core.request import UNDEFINED as J_UNDEFINED
from ompi_tpu_torch.coll import nbc
from ompi_tpu_torch.coll.nbc import ScheduleRequest
from ompi_tpu_torch.core import request as req_mod
from ompi_tpu_torch.runtime import progress as prog

N = 8
ROOT = 3
SCHEDULED = ["iallreduce", "ibcast", "iallgather"]
DISPATCHED = ["ireduce", "igather", "iscatter", "ialltoall",
              "ireduce_scatter_block", "iscan", "iexscan"]
# elements per rank: the ring/binomial schedules (37 % 8 != 0) and the
# one-round fused path (8 x 2048 x 4 B = 64 KiB, the switch point)
SIZES = {"schedule": 37, "fused": 2048}


def _seed(*parts) -> int:
    return zlib.crc32("|".join(map(str, parts)).encode())


@pytest.fixture()
def pworld():
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    yield P.get_comm_world()
    P._reset_for_tests()


def _data(dtype, lead, elems, seed):
    rng = np.random.default_rng(seed)
    shape = lead + (elems,)
    if dtype == "int32":
        return rng.integers(-1000, 1000, size=shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _call(comm, func, x, op):
    """``func`` (an i-entry or its blocking counterpart) with the
    arguments its signature takes."""
    base = func[1:] if func.startswith("i") else func
    if base in ("allreduce", "reduce_scatter_block", "scan", "exscan"):
        return getattr(comm, func)(x, op)
    if base == "reduce":
        return getattr(comm, func)(x, op, ROOT)
    if base in ("bcast", "gather", "scatter"):
        return getattr(comm, func)(x, ROOT)
    return getattr(comm, func)(x)


def _match(got, want, dtype, reducing):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if dtype == "float32" and reducing:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def _significant(func, y):
    """Root's row for rooted reductions and gathers (the JAX side may
    run a root-targeted schedule)."""
    y = np.asarray(y)
    return y[ROOT] if func in ("ireduce", "igather") else y


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("func", SCHEDULED + DISPATCHED)
def test_i_entry_matches_jax_and_blocking(pworld, world, mpi, func, dtype,
                                          size):
    lead = (N, N) if func in ("iscatter", "ialltoall",
                              "ireduce_scatter_block") else (N,)
    elems = SIZES[size] // (N if len(lead) == 2 else 1)
    x = _data(dtype, lead, elems, _seed(func, dtype, size))
    req = _call(pworld, func, pworld.put(x), P.SUM)
    got = req.get()
    assert isinstance(got, torch.Tensor) and got.numpy().dtype == x.dtype
    assert req.test()[0]
    want = _call(world, func, world.put(x), mpi.SUM).get()
    blocking = _call(pworld, func[1:], pworld.put(x), P.SUM)
    reducing = func in ("iallreduce", "ireduce", "ireduce_scatter_block",
                        "iscan", "iexscan")
    _match(_significant(func, got), _significant(func, want), dtype,
           reducing)
    _match(_significant(func, got), _significant(func, blocking), dtype,
           reducing)
    assert isinstance(req, ScheduleRequest) == (func in SCHEDULED)


def test_nbc_wins_the_schedule_slots_in_both_packages(pworld, world):
    for slot in ("iallreduce", "ibcast", "iallgather", "ibarrier"):
        assert pworld._coll_winners[slot] == "nbc"
        assert world._coll_winners[slot] == "nbc"


@pytest.mark.parametrize("func,rounds", [
    ("iallreduce", 2 * (N - 1)), ("ibcast", math.ceil(math.log2(N))),
    ("iallgather", N - 1), ("ibarrier", math.ceil(math.log2(N)))])
def test_schedule_round_counts_match_jax(pworld, world, mpi, func, rounds):
    x = _data("float32", (N,), 37, _seed("rounds", func))
    args = {"iallreduce": lambda c, m: c.iallreduce(c.put(x), m.SUM),
            "ibcast": lambda c, m: c.ibcast(c.put(x), ROOT),
            "iallgather": lambda c, m: c.iallgather(c.put(x)),
            "ibarrier": lambda c, m: c.ibarrier()}[func]
    ours, theirs = args(pworld, P), args(world, mpi)
    assert ours.rounds_left == theirs.rounds_left == rounds
    spins = 0
    while not ours.test()[0]:            # one round per spin, then done
        spins += 1
        assert spins < 1000
    assert spins == rounds
    theirs.wait()


@pytest.mark.parametrize("op", ["MAX", "MIN", "PROD", "user"])
def test_ring_iallreduce_ops_match_jax(pworld, world, mpi, op):
    x = _data("float32", (N,), 37, _seed("ops", op))
    if op == "PROD":
        x = (1 + 0.1 * x).astype(np.float32)
    if op == "user":
        ours = P.op_create(lambda a, b: torch.maximum(a.abs(), b.abs()))
        theirs = mpi.op_create(lambda a, b: jnp.maximum(jnp.abs(a),
                                                        jnp.abs(b)))
    else:
        ours, theirs = getattr(P, op), getattr(mpi, op)
    req = pworld.iallreduce(pworld.put(x), ours)
    assert isinstance(req, ScheduleRequest)
    got = req.get().numpy()
    want = np.asarray(world.iallreduce(world.put(x), theirs).get())
    if op == "PROD":
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)
    ref = {"MAX": x.max(0), "MIN": x.min(0), "PROD": x.prod(0),
           "user": np.abs(x).max(0)}[op]
    np.testing.assert_allclose(got[5], ref, rtol=1e-5)


def test_concurrent_schedules(pworld):
    a = _data("float32", (N,), 12, 1)
    b = _data("float32", (N,), 12, 2)
    c = _data("int32", (N,), 5, 3)
    reqs = [pworld.iallreduce(pworld.put(a), P.SUM),
            pworld.iallgather(pworld.put(b)),
            pworld.ibcast(pworld.put(c), ROOT),
            pworld.ibarrier()]
    assert sum(isinstance(r, ScheduleRequest) for r in reqs) == 4
    assert len(P.Waitall(reqs)) == 4
    np.testing.assert_allclose(reqs[0].get().numpy()[0], a.sum(0),
                               rtol=1e-5)
    np.testing.assert_array_equal(reqs[1].get().numpy()[N - 1], b)
    np.testing.assert_array_equal(reqs[2].get().numpy(),
                                  np.broadcast_to(c[ROOT], c.shape))


def test_results_never_alias_the_input_or_each_other(pworld):
    x = pworld.put(_data("float32", (N,), 40, 4))      # 40 % 8 == 0
    keep = x.clone()
    y = pworld.iallreduce(x, P.SUM).get()
    z = pworld.ibcast(x, 0).get()
    x.fill_(0.0)
    np.testing.assert_allclose(y.numpy()[0], keep.numpy().sum(0),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(z[1], keep[0])
    s = P.get_comm_self()
    one = s.alloc((3,), fill=2.0)
    for r in (s.iallreduce(one), s.ibcast(one, 0)):
        out = r.get()
        assert torch.equal(out, one) and out.data_ptr() != one.data_ptr()


def test_wait_and_test_families_on_mixed_and_empty_lists(pworld, world,
                                                        mpi):
    x = pworld.put(_data("float32", (N,), 8, 5))
    done = P.Grequest()
    done.complete("host")
    mixed = [pworld.iallreduce(x), pworld.ireduce(x, P.SUM, 0),
             pworld.ibarrier(), done]
    i, st = P.Waitany(mixed)
    assert 0 <= i < 4 and st is not None
    idx, sts = P.Waitsome(mixed)
    assert idx and len(idx) == len(sts)
    assert len(P.Waitall(mixed)) == 4
    ok, sts = P.Testall(mixed)
    assert ok and len(sts) == 4
    idx, sts = P.Testsome(mixed)
    assert idx == [0, 1, 2, 3]
    ok, i, st = P.Testany(mixed)
    assert ok and i == 0
    pending = P.Grequest()
    assert P.Testall([done, pending]) == (False, None)
    assert P.Testany([pending]) == (False, -1, None)
    assert P.Testsome([pending, done])[0] == [1]
    # empty lists return at once, as in the JAX package
    assert P.Waitany([]) == mpi.Waitany([]) == (J_UNDEFINED, None)
    assert P.Waitsome([]) == mpi.Waitsome([]) == ([], [])
    assert P.Testany([]) == mpi.Testany([]) == (True, J_UNDEFINED, None)
    assert P.Waitall([]) == mpi.Waitall([]) == []
    assert P.Testall([])[0] and mpi.Testall([])[0]
    assert P.Testsome([]) == mpi.Testsome([]) == ([], [])
    assert req_mod.UNDEFINED == P.UNDEFINED == J_UNDEFINED


def test_grequest_and_completed_request():
    g = P.Grequest()
    assert g.test() == (False, None)
    g.complete(123)
    ok, _ = g.test()
    assert ok and g.get() == 123
    r = P.Request.completed("value")
    assert r.test()[0] and r.get() == "value"


def test_dispatched_entries_keep_plain_requests(pworld):
    x = pworld.put(_data("float32", (N,), 10, 6))
    req = pworld.ireduce(x, P.SUM, 0)
    assert type(req) is P.Request
    np.testing.assert_allclose(req.get().numpy()[0], x.numpy().sum(0),
                               rtol=1e-5)


def test_progress_engine_unit():
    prog._reset_for_tests()
    hits = {"hi": 0, "lo": 0}

    def hi():
        hits["hi"] += 1
        return 1

    def lo():
        hits["lo"] += 1
        return 0

    prog.register(hi)
    prog.register(lo, low_priority=True)
    for _ in range(prog._LOW_EVERY):
        assert prog.progress() == 1
    assert hits == {"hi": prog._LOW_EVERY, "lo": 1}    # low cadence
    prog.unregister(hi)
    prog.unregister(lo)
    assert prog.callback_count() == 0


def test_progress_cb_unregisters_when_idle(pworld):
    assert prog.callback_count() == 0
    req = pworld.iallreduce(pworld.put(_data("float32", (N,), 4, 7)))
    assert prog.callback_count() == 1
    req.wait()
    prog.progress()                  # the idle spin lets nbc deregister
    assert prog.callback_count() == 0


def test_reset_empties_the_progress_engine(pworld):
    pworld.iallreduce(pworld.put(_data("float32", (N,), 4, 8)))
    assert prog.callback_count() == 1
    P._reset_for_tests()
    assert prog.callback_count() == 0


class _StubEvent:
    """Stands in for a CUDA event: ``query`` turns True after ``busy``
    polls; ``synchronize`` records that it was the one waited on."""

    def __init__(self, busy):
        self.busy, self.queries, self.synced = busy, 0, False

    def query(self):
        self.queries += 1
        return self.synced or self.queries > self.busy

    def synchronize(self):
        self.synced = True


def test_request_polls_its_event_and_waits_on_it():
    ev = _StubEvent(busy=2)
    r = P.Request(result="y", event=ev)
    assert r.test() == (False, None) and r.test() == (False, None)
    assert r.test()[0] and ev.queries == 3 and not ev.synced
    ev = _StubEvent(busy=10 ** 9)
    r = P.Request(result="y", event=ev)
    assert not r.test()[0]
    assert r.get() == "y" and ev.synced


def test_schedule_completes_on_its_event(pworld, monkeypatch):
    """The last round seals the schedule with an event on its stream;
    the request is not complete until that event says so."""
    events = []

    def fake_event_on(stream):
        events.append(_StubEvent(busy=3))
        return events[-1]

    monkeypatch.setattr(nbc, "event_on", fake_event_on)
    x = _data("float32", (N,), 37, 9)
    req = pworld.iallreduce(pworld.put(x), P.SUM)
    for _ in range(2 * (N - 1)):
        assert not req.test()[0]     # one round per spin
    assert req.rounds_left == 0 and len(events) == 1
    spins = 0
    while not req.test()[0]:
        spins += 1
    assert spins == 3                # the event's busy polls
    np.testing.assert_allclose(req.get().numpy()[0], x.sum(0), rtol=1e-5)
    req2 = pworld.ibarrier()
    req2.wait()
    assert events[-1].synced         # wait synchronizes on the event


def test_event_after_marks_only_cuda_work():
    assert req_mod.event_after([torch.zeros(2), {"a": np.zeros(2)}]) is None
    assert req_mod.stream_of("cpu") is None
    assert req_mod.event_on(None) is None
