"""Parity of the port's point-to-point with the JAX package's: the stacked
matching engine (``pml/stacked``), the communicator's send/recv/probe
family and partitioned pt2pt (``pml/partitioned``).

Each scenario runs the same numpy inputs, made from a seed, through the
reference on a ``dup()`` of its 8-device world (freed afterwards, every
message drained, so the session world's engine never sees this file's
traffic) and through the port's 8-rank CPU world, with numpy payloads and
with tensor payloads. Received data, ``Status.source``, ``Status.tag``,
``Status.count``, probe flags and errors must be identical.
"""
import numpy as np
import pytest
import torch

import ompi_tpu as R
import ompi_tpu_torch as P
from ompi_tpu_torch.core.errhandler import ERR_BUFFER, ERR_PENDING
from ompi_tpu_torch.mca import var as pvar

N = 8


@pytest.fixture()
def pworld():
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    yield P.get_comm_world()
    P._reset_for_tests()


@pytest.fixture()
def rworld(world):
    d = world.dup()
    yield d
    d.free()


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _norm(v):
    """Results in a comparable form: arrays to numpy, Status to its
    (source, tag, count), errors to their class."""
    if isinstance(v, (list, tuple)):
        return [_norm(a) for a in v]
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if hasattr(v, "source") and hasattr(v, "count"):
        return ("status", v.source, v.tag, v.count)
    return _host(v)


def _same(a, b):
    a, b = _norm(a), _norm(b)
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (a, b)
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (a, b)


def _both(scenario, rworld, pworld, seed=0):
    """The scenario on the reference (numpy payloads), on the port with
    numpy payloads and with tensor payloads; all three results equal."""
    want = scenario(R, rworld, lambda a: a, np.random.default_rng(seed))
    for wrap in (lambda a: a, lambda a: torch.from_numpy(np.asarray(a))):
        got = scenario(P, pworld, wrap, np.random.default_rng(seed))
        _same(got, want)
    return _norm(want)


def _raises(fn):
    try:
        fn()
    except Exception as e:               # the error class is the result
        return ("raised", type(e).__name__,
                getattr(e, "error_class", None))
    return ("returned",)


# -- mirrors of tests/test_ptp_topo.py (pt2pt) -------------------------------
def test_send_recv_basic(rworld, pworld):
    def sc(M, w, wrap, rng):
        data = rng.standard_normal(4).astype(np.float32)
        w.send(wrap(data), src=0, dest=3, tag=7)
        return list(w.recv(source=0, tag=7, dst=3))
    _both(sc, rworld, pworld)


def test_matching_any_source_any_tag(rworld, pworld):
    def sc(M, w, wrap, rng):
        w.send(wrap(np.float32(1.0)), src=2, dest=0, tag=5)
        w.send(wrap(np.float32(2.0)), src=1, dest=0, tag=9)
        a = w.recv(source=M.ANY_SOURCE, tag=9)
        b = w.recv(source=M.ANY_SOURCE, tag=M.ANY_TAG)
        return [list(a), list(b)]
    want = _both(sc, rworld, pworld)
    assert want[0][1][1] == 1 and want[1][1][1:3] == (2, 5)


def test_non_overtaking_order(rworld, pworld):
    def sc(M, w, wrap, rng):
        for i in range(3):
            w.send(wrap(np.int32(i)), src=4, dest=0, tag=1)
        return [list(w.recv(source=4, tag=1)) for _ in range(3)]
    want = _both(sc, rworld, pworld)
    assert [int(r[0]) for r in want] == [0, 1, 2]


def test_irecv_then_send(rworld, pworld):
    def sc(M, w, wrap, rng):
        req = w.irecv(source=5, tag=3)
        before = req.test()
        w.send(wrap(np.float32(42.0)), src=5, dest=0, tag=3)
        ok, st = req.test()
        return [list(before), ok, st, req.get()]
    _both(sc, rworld, pworld)


def test_recv_deadlock_detected(rworld, pworld):
    def sc(M, w, wrap, rng):
        return _raises(lambda: w.recv(source=6, tag=123))
    assert _both(sc, rworld, pworld)[2] == ERR_PENDING


def test_probe_iprobe_mprobe(rworld, pworld):
    def sc(M, w, wrap, rng):
        out = [list(w.iprobe(source=1, tag=2))]
        w.send(wrap(np.arange(3)), src=1, dest=0, tag=2)
        out.append(list(w.iprobe(source=1, tag=2)))
        out.append(w.probe(source=1, tag=2))
        msg = w.mprobe(source=1, tag=2)
        out.append(list(w.iprobe(source=1, tag=2)))     # removed
        out.append(list(w.mrecv(msg)))
        out.append(_raises(lambda: w.probe(source=1, tag=2)))
        return out
    want = _both(sc, rworld, pworld)
    assert want[1][1][3] == 3


def test_sendrecv_and_proc_null(rworld, pworld):
    def sc(M, w, wrap, rng):
        got = w.sendrecv(wrap(np.float32(5.0)), src=0, dest=0,
                         recvsource=0, sendtag=4, recvtag=4)
        w.send(wrap(np.float32(1.0)), src=0, dest=M.PROC_NULL)  # no-op
        req = w.irecv(source=M.PROC_NULL)
        return [list(got), req.test()[0], req.get() is None, req.status]
    _both(sc, rworld, pworld)


def test_device_row_transfer(rworld, pworld):
    def sc(M, w, wrap, rng):
        buf = w.alloc((4,), np.float32, fill=3.0)
        w.send(buf[2], src=2, dest=0, tag=11)
        return list(w.recv(source=2, tag=11))
    _both(sc, rworld, pworld)


def test_partitioned_ptp(rworld, pworld):
    def sc(M, w, wrap, rng):
        parts = [wrap(np.full(2, i, np.float32)) for i in range(3)]
        sreq = w.psend_init(parts, dest=1, tag=6)
        rreq = w.precv_init(source=0, tag=6, partitions=3, dst=1)
        sreq.start()
        rreq.start()
        out = [list(rreq.test())]
        sreq.pready(0)
        out.append([rreq.parrived(0), rreq.parrived(1), sreq.test()[0]])
        sreq.pready_range(1, 2)
        out.append([sreq.test()[0], rreq.parrived(2), rreq.test()[0]])
        out.append(rreq.get())
        return out
    _both(sc, rworld, pworld)


def test_matching_isolated_by_destination(rworld, pworld):
    def sc(M, w, wrap, rng):
        w.send(wrap(np.float32(10.0)), src=0, dest=1, tag=0)
        w.send(wrap(np.float32(20.0)), src=0, dest=2, tag=0)
        return [list(w.recv(source=0, tag=0, dst=2)),
                list(w.recv(source=0, tag=0, dst=1))]
    _both(sc, rworld, pworld)


def test_ssend_semantics(rworld, pworld):
    def sc(M, w, wrap, rng):
        err = _raises(lambda: w.ssend(wrap(np.float32(1.0)), src=0,
                                      dest=1, tag=2))
        req = w.irecv(source=0, tag=2, dst=1)
        w.ssend(wrap(np.float32(5.0)), src=0, dest=1, tag=2)
        return [err, req.test()[0], req.get(),
                list(w.iprobe(source=0, tag=2, dst=1))]
    assert _both(sc, rworld, pworld)[0][2] == ERR_PENDING


def test_partitioned_no_collision_with_user_tags(rworld, pworld):
    def sc(M, w, wrap, rng):
        sreq = w.psend_init([wrap(np.float32(1.0))], dest=1, tag=0)
        rreq = w.precv_init(source=0, tag=0, partitions=1, dst=1)
        rreq.start()
        w.send(wrap(np.float32(99.0)), src=0, dest=1, tag=0)
        out = [list(rreq.test())]
        sreq.start()
        sreq.pready(0)
        out += [rreq.test()[0], rreq.get(),
                list(w.recv(source=0, tag=M.ANY_TAG, dst=1))]
        return out
    _both(sc, rworld, pworld)


def test_send_buffer_reusable_after_send(rworld, pworld):
    def sc(M, w, wrap, rng):
        a = np.arange(4, dtype=np.float32)
        w.send(a, src=0, dest=1, tag=33)
        a[:] = -1.0
        return list(w.recv(source=0, tag=33, dst=1))
    _both(sc, rworld, pworld)


# -- the rest of the communicator's pt2pt surface ---------------------------
def test_isend_bsend_improbe_persistent(rworld, pworld):
    def sc(M, w, wrap, rng):
        x = rng.standard_normal((2, 3)).astype(np.float32)
        out = [w.isend(wrap(x), src=3, dest=4, tag=8).test()[0]]
        w.bsend(wrap(2 * x), src=5, dest=4, tag=8)
        out.append(list(w.improbe(source=M.ANY_SOURCE, tag=7, dst=4)))
        flag, msg, st = w.improbe(source=M.ANY_SOURCE, tag=8, dst=4)
        out += [flag, st, list(w.mrecv(msg))]
        out.append(list(w.recv(source=5, tag=8, dst=4)))
        sreq = w.send_init(wrap(3 * x), src=6, dest=7, tag=1)
        rreq = w.recv_init(source=6, tag=1, dst=7)
        for _ in range(2):
            rreq.start()
            out.append(rreq.test()[0])
            sreq.start()
            sreq.wait()
            out += [rreq.test()[0], rreq.get(), rreq.status]
        return out
    _both(sc, rworld, pworld, seed=3)


@pytest.mark.parametrize("shape", [(5,), (2, 3), (4, 1, 2)])
def test_status_count_is_elements(rworld, pworld, shape):
    """``Status.count`` is a payload's element count: ``numel()`` of a
    tensor (``Tensor.size`` is a method), ``size`` of an array."""
    def sc(M, w, wrap, rng):
        x = rng.integers(-9, 9, shape).astype(np.int32)
        w.send(wrap(x), src=1, dest=6, tag=4)
        st = w.probe(source=1, tag=4, dst=6)
        return [st, list(w.recv(source=1, tag=4, dst=6))]
    want = _both(sc, rworld, pworld, seed=len(shape))
    assert want[0][3] == int(np.prod(shape))


# -- port-only: tensors are mutable -----------------------------------------
@pytest.mark.parametrize("limit", [1 << 16, 0])
def test_tensor_overwritten_after_send_is_received_unchanged(pworld, limit):
    """A view into a stacked tensor, sent and then written over in place,
    arrives as it was at send: the engine clones every tensor payload, on
    both sides of the eager limit."""
    pvar.var_set("pml_stacked_eager_limit", limit)
    rng = np.random.default_rng(7)
    host = rng.standard_normal((N, 6)).astype(np.float32)
    buf = pworld.stack(list(host))
    pworld.send(buf[2], src=2, dest=0, tag=11)
    req = pworld.irecv(source=2, tag=12, dst=5)
    pworld.send(buf[3], src=2, dest=5, tag=12)
    buf.fill_(-1.0)
    got, st = pworld.recv(source=2, tag=11)
    np.testing.assert_array_equal(got.numpy(), host[2])
    np.testing.assert_array_equal(req.get().numpy(), host[3])
    assert st.count == 6 and req.status.count == 6
    assert got.data_ptr() != buf[2].data_ptr()


def test_tensor_on_another_device_raises(pworld):
    with pytest.raises(P.MPIError) as e:
        pworld.send(torch.empty(3, device="meta"), src=0, dest=1, tag=0)
    assert e.value.error_class == ERR_BUFFER
    assert pworld.iprobe(source=0, tag=0, dst=1) == (False, None)


def test_traffic_table_counts_user_messages(pworld):
    pworld.send(torch.zeros(4), src=0, dest=1, tag=0)
    pworld.send(np.zeros(3, np.float64), src=0, dest=1, tag=1)
    s = pworld.psend_init([torch.zeros(2)], dest=1, tag=2)
    s.start()
    s.pready(0)
    assert pworld._pml.traffic == {(0, 1): [2, 16 + 24]}
