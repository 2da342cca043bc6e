"""Mirror of ``tests/test_small_fastpath.py`` through both packages.

Scalar folds keep the operand's dtype, the small-message multicast
reuses its marshalled headers, a full sm ring never stalls a
reader-originated push, a raising TLS propagator cannot wedge a comm's
collective worker (the port's ``register_tls_propagator`` is new), a
raising job leaves the worker draining, and the staging probe confirms
its crossover. Each case runs on the reference and on the port with the
same inputs; the port's ``RankCommunicator`` takes ``device="cpu"``.
"""
import importlib
import time

import numpy as np
import pytest

PKGS = ["ompi_tpu", "ompi_tpu_torch"]


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.mark.parametrize("pkg", PKGS)
def test_apply_scalar_fast_path_preserves_float64(pkg):
    op = _m(pkg, "core.op")
    _apply = _m(pkg, "core.rankcomm")._apply
    a = np.float64(1.0 + 2**-40)             # lost in float32
    b = np.float64(2.0 + 2**-40)
    out = _apply(op.SUM, a, b)
    assert isinstance(out, float)
    assert out == float(a) + float(b)        # exact in float64
    assert out != float(np.float32(a) + np.float32(b))


@pytest.mark.parametrize("pkg", PKGS)
def test_apply_scalar_fast_path_other_ops(pkg):
    op = _m(pkg, "core.op")
    _apply = _m(pkg, "core.rankcomm")._apply
    assert _apply(op.MAX, np.float64(1.5), np.float64(2.5)) == 2.5
    assert _apply(op.PROD, np.int64(3), np.int64(4)) == 12
    assert _apply(op.BXOR, np.int32(0b101), np.int32(0b011)) == 0b110


@pytest.mark.parametrize("pkg", PKGS)
def test_apply_ndarray_unchanged(pkg):
    op = _m(pkg, "core.op")
    out = _m(pkg, "core.rankcomm")._apply(op.SUM, np.full(4, 1.5),
                                          np.full(4, 2.0))
    assert isinstance(out, np.ndarray)
    np.testing.assert_allclose(out, 3.5)


def _loopback_engine(pkg, cid, size=2):
    pr = _m(pkg, "pml.perrank")
    kv = {}
    router = pr.Router(0, 1, kv.__setitem__, kv.__getitem__)

    class _C:
        def __init__(self):
            self.cid = cid
            self.size = size

        def rank(self):
            return 0

        def world_rank_of(self, r):
            return 0                         # loopback: every dest is me
    return pr.PerRankEngine(_C(), router), router


@pytest.mark.parametrize("pkg", PKGS)
def test_send_small_multicast_and_descriptor_cache(pkg):
    eng, router = _loopback_engine(pkg, "smallsend")
    try:
        payload = np.full(2, 1.5, np.float32)
        eng.send_small(payload, [1], tag=3)
        eng.send_small(payload, [1], tag=4)
        assert len(eng._small_desc) == 1, eng._small_desc
        d1, _ = eng.recv(source=0, tag=3, timeout=10)
        d2, _ = eng.recv(source=0, tag=4, timeout=10)
        np.testing.assert_array_equal(d1, payload)
        np.testing.assert_array_equal(d2, payload)
        eng.send_small(np.float64(2.5), [1], tag=5)
        d3, _ = eng.recv(source=0, tag=5, timeout=10)
        assert d3 == np.float64(2.5) and d3.dtype == np.float64
        assert len(eng._small_desc) == 2
        eng.send_small(np.zeros(4, np.float32), [1], tag=6)
        eng.recv(source=0, tag=6, timeout=10)
        assert len(eng._small_desc) == 3
    finally:
        router.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_ring_zero_timeout_push_returns_immediately(pkg):
    ring = _m(pkg, "btl.sm").Ring(None, capacity=1 << 12, create=True)
    try:
        while ring.push(b"x" * 512, timeout=0):
            pass                             # fill it
        t0 = time.monotonic()
        assert not ring.push(b"x" * 512, timeout=0)
        assert time.monotonic() - t0 < 0.5, "zero-timeout push waited"
    finally:
        ring.close()


def _world_comm(pkg):
    """A size-1 per-rank communicator over a loopback router."""
    Group = _m(pkg, "core.group").Group
    RankCommunicator = _m(pkg, "core.rankcomm").RankCommunicator
    kv = {}
    router = _m(pkg, "pml.perrank").Router(0, 1, kv.__setitem__,
                                           kv.__getitem__)
    kw = {"device": "cpu"} if pkg == "ompi_tpu_torch" else {}
    return RankCommunicator(Group([0]), 0, router, cid="fp-test",
                            **kw), router


@pytest.mark.parametrize("pkg", PKGS)
def test_raising_propagator_cannot_wedge_the_worker(pkg):
    rc = _m(pkg, "core.rankcomm")
    comm, router = _world_comm(pkg)
    boom = RuntimeError("propagator exploded")

    def capture():
        def apply():
            raise boom

        def reset():
            pass
        return (apply, reset)

    rc.register_tls_propagator(capture)
    try:
        comm._coll_submit(lambda: time.sleep(0.4))   # busy: funnels
        with pytest.raises(RuntimeError, match="propagator exploded"):
            comm.barrier()
    finally:
        rc._TLS_PROPAGATORS.remove(capture)
    comm._coll_submit(lambda: time.sleep(0.2))
    comm.barrier()                           # funneled while it drains
    comm.barrier()                           # inline once idle
    comm.free()
    router.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_propagator_context_travels_with_the_funneled_body(pkg):
    """The captured context is applied on the worker around the body and
    reset after it, in both packages."""
    import threading
    rc = _m(pkg, "core.rankcomm")
    comm, router = _world_comm(pkg)
    tls = threading.local()
    seen = []
    tls.ctx = "caller"

    def capture():
        v = getattr(tls, "ctx", None)

        def apply():
            tls.ctx = v

        def reset():
            tls.ctx = None
        return (apply, reset)

    rc.register_tls_propagator(capture)
    try:
        comm._coll_submit(lambda: time.sleep(0.3))
        comm._coll_serial(lambda: seen.append(
            (threading.current_thread() is comm._cworker,
             getattr(tls, "ctx", None))))
        comm._coll_submit(lambda: seen.append(getattr(tls, "ctx", None)))
        comm.barrier()
    finally:
        rc._TLS_PROPAGATORS.remove(capture)
    assert seen == [(True, "caller"), None]
    comm.free()
    router.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_raising_runner_does_not_stall_task_done(pkg):
    comm, router = _world_comm(pkg)
    comm._coll_submit(lambda: (_ for _ in ()).throw(ValueError("x")))
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        with comm._lock:
            q = comm._cq
        if q is not None and q.unfinished_tasks == 0:
            break
        time.sleep(0.01)
    else:
        raise AssertionError("raising runner wedged unfinished_tasks")
    comm.barrier()                           # worker alive and draining
    comm.free()
    router.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_staging_probe_confirms_at_crossover(pkg):
    tuned = _m(pkg, "coll.tuned")
    cross, basis = tuned.staging_probe(transport_bps=1e6, nranks=2)
    assert basis.get("confirm_bytes"), basis
    assert basis.get("confirm_staged_ms") is not None
    assert basis.get("confirm_host_ms") is not None
    if cross < tuned._NEVER_STAGE:
        assert basis.get("hysteresis") == 1.5
        assert basis["stage_min_bytes"] == cross
    else:
        assert basis.get("confirm_rejected_staging") is True
        assert basis["stage_min_bytes"] == -1
