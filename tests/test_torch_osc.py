"""The port's one-sided plane (``ompi_tpu_torch/osc``) against the JAX
package's (``tests/test_osc.py`` and the in-process part of
``tests/test_osc_framework.py``).

Two halves, each feeding both packages the same seeded numpy inputs:

- the stacked single-controller ``Win``: the port's 8-rank CPU world
  against the reference's 8-device world, for every accumulate op and
  its get/fetch variants, the request-based calls, PSCW, lock/unlock,
  dynamic windows and the unsigned accumulates (exact against numpy:
  uint16/32/64 take the signed twin through ``Op.__call__``). The
  port's ``Win.create`` aliases the caller's buffer (MPI's semantics);
  the reference's device window leaves its immutable array alone.
- the per-rank framework (``RmaWindow`` on osc/shm and osc/pt2pt) over
  a loopback harness: every fake rank owns a ``FakeRouter`` whose
  endpoint delivers frames synchronously to the destination's window
  handler and whose KV is a shared dict, so osc/shm maps real /dev/shm
  segments and osc/pt2pt runs its real encode/decode RPC path. One
  harness serves both packages (their ack planes differ only in how a
  reply reaches its waiter). The mpitop case hands the port's
  telemetry dump to the reference's ``tools/mpitop``.
"""
from __future__ import annotations

import glob
import os
import threading
import time

import numpy as np
import pytest
import torch

import ompi_tpu as R
import ompi_tpu_torch as P
from ompi_tpu.btl import tcp as r_tcp
from ompi_tpu.osc import base as r_base
from ompi_tpu.osc import shm as r_shm
from ompi_tpu.osc import window as r_window
from ompi_tpu.runtime import ft as r_ft
from ompi_tpu_torch.accelerator import SHM_DIR
from ompi_tpu_torch.btl import tcp as p_tcp
from ompi_tpu_torch.core.errhandler import (ERR_INTERN, ERR_PROC_FAILED,
                                            ERR_RMA_SYNC, ERR_WIN, MPIError)
from ompi_tpu_torch.mca import pvar as p_pvar
from ompi_tpu_torch.mca import var as p_var
from ompi_tpu_torch.osc import base as p_base
from ompi_tpu_torch.osc import decision as p_decision
from ompi_tpu_torch.osc import window as p_window
from ompi_tpu_torch.osc.perrank import LOCK_EXCLUSIVE
from ompi_tpu_torch.osc.shm import WIN_PREFIX
from ompi_tpu_torch.runtime import ft as p_ft

N = 8


@pytest.fixture()
def pworld():
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    yield P.get_comm_world()
    P._reset_for_tests()


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b):
    a, b = _host(a), _host(b)
    assert a.shape == b.shape, (a, b)
    np.testing.assert_array_equal(a, b.astype(a.dtype))


# -- the stacked Win (tests/test_osc.py) --------------------------------------
def test_win_put_get_fence(world, pworld):
    def run(pkg, comm):
        win = pkg.Win.allocate(comm, 8, np.float32)
        win.put(np.arange(4, dtype=np.float32), target_rank=2,
                target_disp=1)
        win.fence()
        out = [win.get(2, 1, 4), win.get(2, 0, 1), win.get(0, 0, 8)]
        win.free()
        return out
    for a, b in zip(run(P, pworld), run(R, world)):
        _same(a, b)
    got = run(P, pworld)
    np.testing.assert_array_equal(got[0], np.arange(4))
    assert got[1][0] == 0.0 and got[2].sum() == 0.0


def test_win_accumulate_ops(world, pworld):
    def run(pkg, comm):
        win = pkg.Win.allocate(comm, 4, np.float32)
        win.accumulate(np.ones(4, np.float32), 1, pkg.SUM)
        win.accumulate(2 * np.ones(4, np.float32), 1, pkg.SUM)
        win.fence()
        out = [win.get(1)]
        win.accumulate(9 * np.ones(4, np.float32), 1, pkg.REPLACE)
        out.append(win.get(1))
        win.accumulate(5 * np.ones(4, np.float32), 1, pkg.NO_OP)
        out.append(win.get(1))
        return out
    got, want = run(P, pworld), run(R, world)
    for a, b in zip(got, want):
        _same(a, b)
    np.testing.assert_array_equal(got[0], 3.0)
    np.testing.assert_array_equal(got[2], 9.0)


def test_win_get_accumulate_and_cas(world, pworld):
    def run(pkg, comm):
        win = pkg.Win.allocate(comm, 2, np.float32)
        out = [win.get_accumulate(np.asarray([7.0, 7.0], np.float32), 0,
                                  pkg.SUM), win.get(0)]
        out.append(np.asarray([win.fetch_and_op(3.0, 0, pkg.SUM,
                                                target_disp=0)]))
        out.append(win.get(0, 0, 1))
        out.append(np.asarray([win.compare_and_swap(42.0, compare=10.0,
                                                    target_rank=0)]))
        out.append(win.get(0, 0, 1))
        out.append(np.asarray([win.compare_and_swap(0.0, compare=999.0,
                                                    target_rank=0)]))
        out.append(win.get(0, 0, 1))
        return out
    got, want = run(P, pworld), run(R, world)
    for a, b in zip(got, want):
        _same(a, b)
    assert [float(x[0]) for x in got[2:]] == [7.0, 10.0, 10.0, 42.0, 42.0,
                                              42.0]


def test_win_create_from_buffer_and_bounds(world, pworld):
    def run(pkg, comm):
        buf = comm.alloc((4,), np.float32, fill=1.0)
        win = pkg.Win.create(comm, buf)
        win.lock(0)
        win.put(np.asarray([5.0], np.float32), 0, 3)
        win.unlock(0)
        errs = []
        comm.set_errhandler(pkg.ERRORS_RETURN)
        try:
            for args in ((np.ones(3, np.float32), 0, 2),
                         (np.ones(1, np.float32), comm.size + 1, 0)):
                with pytest.raises(pkg.MPIError) as ei:
                    win.put(*args)
                errs.append(ei.value.error_class)
        finally:
            comm.set_errhandler(pkg.ERRORS_ARE_FATAL)
        return win.get(0), errs, buf, win
    got, perr, pbuf, pwin = run(P, pworld)
    want, rerr, rbuf, _ = run(R, world)
    _same(got, want)
    np.testing.assert_array_equal(got, [1, 1, 1, 5])
    assert perr == rerr
    # aliasing: the port's window IS the caller's tensor (MPI's
    # semantics); the reference's device window rebinds a new array and
    # leaves the caller's immutable one as it was
    assert pwin.buffer is pbuf
    np.testing.assert_array_equal(pbuf[0].numpy(), [1, 1, 1, 5])
    np.testing.assert_array_equal(np.asarray(rbuf)[0], [1, 1, 1, 1])


def test_win_rput_request(world, pworld):
    def run(pkg, comm):
        win = pkg.Win.allocate(comm, 2, np.float32)
        req = win.rput(np.asarray([1.0, 2.0], np.float32), 1)
        req.wait()
        r2 = win.raccumulate(np.asarray([0.5, 0.5], np.float32), 1,
                             pkg.SUM)
        r2.wait()
        g = win.rget(1)
        ga = win.rget_accumulate(np.asarray([1.0, 1.0], np.float32), 1,
                                 pkg.MAX)
        return [win.get(1), g.get(), ga.get(), win.get(1)]
    for a, b in zip(run(P, pworld), run(R, world)):
        _same(a, b)


# every predefined op through accumulate / get_accumulate / fetch_and_op
_FLOAT_OPS = ("SUM", "PROD", "MAX", "MIN", "LAND", "LOR", "LXOR",
              "REPLACE", "NO_OP")
_INT_OPS = _FLOAT_OPS + ("BAND", "BOR", "BXOR")


@pytest.mark.parametrize("opname,dtype", [(o, np.float32)
                                          for o in _FLOAT_OPS]
                         + [(o, np.int32) for o in _INT_OPS])
def test_win_every_op_matches_reference(world, pworld, opname, dtype):
    rng = np.random.default_rng(7)
    size = 6
    if dtype == np.float32:
        base = rng.standard_normal((N, size)).astype(dtype)
        inc = [rng.standard_normal(size).astype(dtype) for _ in range(3)]
        inc[1][2] = 0.0                  # the logical ops see a zero
    else:
        base = rng.integers(-9, 9, (N, size)).astype(dtype)
        inc = [rng.integers(-9, 9, size).astype(dtype) for _ in range(3)]

    def run(pkg, comm):
        op = getattr(pkg, opname)
        win = pkg.Win.create(comm, comm.stack(list(base)))
        win.accumulate(inc[0], 3, op)
        prior = win.get_accumulate(inc[1], 5, op, target_disp=0)
        fetched = win.fetch_and_op(inc[2][0], 6, op, target_disp=4)
        win.fence()
        return [np.stack([win.get(r) for r in range(N)]), prior,
                np.asarray([fetched])]
    for a, b in zip(run(P, pworld), run(R, world)):
        _same(a, b)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.uint64])
def test_win_unsigned_accumulate_exact(pworld, dtype):
    """uint16/32/64 accumulates combine through Op.__call__ (the signed
    twin) and keep numpy's bits, wraparound included."""
    info = np.iinfo(dtype)
    rng = np.random.default_rng(11)
    a = rng.integers(0, info.max, 5, dtype=dtype, endpoint=True)
    b = rng.integers(0, info.max, 5, dtype=dtype, endpoint=True)
    a[0], b[0] = info.max, 2            # SUM and PROD wrap
    for opname, ref in (("SUM", np.add), ("PROD", np.multiply),
                        ("MAX", np.maximum), ("MIN", np.minimum),
                        ("BAND", np.bitwise_and), ("BXOR", np.bitwise_xor)):
        win = P.Win.allocate(pworld, 5, dtype)
        assert win.buffer.dtype == getattr(torch, np.dtype(dtype).name)
        win.put(a, 2)
        prior = win.get_accumulate(torch.from_numpy(b), 2,
                                   getattr(P, opname))
        np.testing.assert_array_equal(prior, a)
        got = win.get(2)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, ref(a, b), err_msg=opname)


def test_win_host_buffer_matches_reference(world, pworld):
    """A numpy stacked buffer is a host window in both packages,
    updated in place."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal((N, 5)).astype(np.float32)
    inc = rng.standard_normal(5).astype(np.float32)

    def run(pkg, comm):
        buf = base.copy()
        win = pkg.Win.create(comm, buf)
        win.put(inc[:2], 1, 3)
        win.accumulate(inc, 4, pkg.MAX)
        win.accumulate(inc, 6, pkg.SUM)
        return buf, win.get(6)
    (pb, pg), (rb, rg) = run(P, pworld), run(R, world)
    _same(pb, rb)
    _same(pg, rg)


def test_win_pscw_dynamic_group_and_free(world, pworld):
    def run(pkg, comm):
        win = pkg.Win.create_dynamic(comm, np.float32)
        base0 = win.attach(4)
        win.put(np.arange(4, dtype=np.float32), 2, base0)
        base1 = win.attach(3)
        win.put(np.full(3, 7.0, np.float32), 5, base1)
        win.detach(base0)
        grp = win.get_group()
        win.post(grp)
        win.start(grp)
        win.accumulate(np.ones(7, np.float32), 2, pkg.SUM)
        win.complete()
        done = win.test()
        with pytest.raises(pkg.MPIError):
            win.complete()               # no access epoch open
        out = [np.asarray([base0, base1, win.size, grp.size, int(done)]),
               win.get(2), win.get(5)]
        win.free()
        assert win.buffer is None
        return out
    for a, b in zip(run(P, pworld), run(R, world)):
        _same(a, b)


def test_win_refused_on_a_multiprocess_comm(pworld):
    class PerRank:
        router = object()
        size = 2
    with pytest.raises(MPIError) as ei:
        P.Win(PerRank(), 4)
    assert ei.value.error_class == ERR_INTERN
    with pytest.raises(MPIError) as ei:
        p_window.win_allocate(pworld, 4)  # no router: the stacked world
    assert ei.value.error_class == ERR_WIN


def test_win_tensor_origin_never_leaves_the_device(pworld):
    """A tensor origin is copied into the row where the window lives;
    rows stay tensors of the window's device and dtype."""
    win = P.Win.allocate(pworld, 6, torch.float32)
    t = torch.arange(6, dtype=torch.float64)
    win.put(t, 4)
    win.accumulate(t, 4, P.SUM)
    assert isinstance(win.buffer, torch.Tensor)
    assert win.buffer.device == pworld.device
    assert win.buffer.dtype == torch.float32
    np.testing.assert_array_equal(win.buffer[4].numpy(), 2 * np.arange(6))


# -- the loopback harness (tests/test_osc_framework.py) -----------------------
class FakeEndpoint:
    def __init__(self, net, rank):
        self._net = net
        self.rank = rank

    def _is_same_host(self, peer: int) -> bool:
        return True

    def send_frame(self, wdest: int, header: dict, raw: bytes) -> None:
        self._net[wdest]._deliver(dict(header), bytes(raw))


class FakeRouter:
    """The Router surface RankWindow/ShmWindow need, synchronous. The
    reference's ``new_ack`` hands back an ``[Event, reply]`` entry; the
    port's an Event, with the reply taken by ``take_ack_reply``."""

    def __init__(self, net, kv, rank, tcp):
        self.rank = rank
        self._kv = kv
        self._tcp = tcp
        self._rma = {}
        self._acks = {}
        self._replies = {}
        self._aid = 0
        self.endpoint = FakeEndpoint(net, rank)
        net[rank] = self

    def kv_set(self, key, val):
        self._kv[key] = val

    def kv_get(self, key):
        return self._kv.get(key)

    def new_ack(self):
        self._aid += 1
        ent = [threading.Event(), None]
        self._acks[self._aid] = ent
        return self._aid, (ent if self._tcp is r_tcp else ent[0])

    def take_ack_reply(self, aid):
        return self._replies.pop(aid, None)

    def cancel_ack(self, aid):
        self._acks.pop(aid, None)

    def register_rma(self, wid, handler):
        self._rma[wid] = handler

    def unregister_rma(self, wid):
        self._rma.pop(wid, None)

    def send_ack(self, world_rank, ack_id, reply=None):
        header = {"ctl": "ack", "ack_id": ack_id}
        raw = b""
        if reply is not None:
            header["desc"], raw = self._tcp.encode_payload(reply)
        self.endpoint.send_frame(world_rank, header, raw)

    def _deliver(self, header, raw):
        if header.get("ctl") == "ack":
            ent = self._acks.pop(header["ack_id"], None)
            if ent is not None:
                if "desc" in header:
                    ent[1] = self._tcp.decode_payload(header["desc"], raw)
                    self._replies[header["ack_id"]] = ent[1]
                ent[0].set()
            return
        if "rma" in header:
            h = self._rma.get(header["wid"])
            if h is not None:
                h(header, raw)


class FakeComm:
    """One fake rank's communicator: collectives degenerate because the
    harness is single-threaded and window sizes are uniform."""

    def __init__(self, rank, size, net, kv, cid, tcp):
        self.cid = cid
        self.size = size
        self._rank = rank
        self.router = FakeRouter(net, kv, rank, tcp)

    def rank(self):
        return self._rank

    def world_rank_of(self, r):
        return r

    def allgather(self, value):
        return [value] * self.size

    def barrier(self):
        pass


_CID = [0]
PKGS = {"port": (p_window, p_tcp), "ref": (r_window, r_tcp)}


def _comms(n, pkg="port"):
    _CID[0] += 1
    net, kv = {}, {}
    tcp = PKGS[pkg][1]
    return [FakeComm(r, n, net, kv, f"fake{_CID[0]}", tcp)
            for r in range(n)]


def _world(n, size, comp, dtype=np.float32, pkg="port"):
    """n fake ranks, one window each on component ``comp``."""
    comms = _comms(n, pkg)
    return comms, [PKGS[pkg][0].win_allocate(c, size, dtype, force=comp)
                   for c in comms]


def _free_all(wins):
    for w in wins:
        w.free()


def _run_put_pattern(comp, pkg, origin=np.asarray):
    """Every rank puts its ramp into its right neighbor at disp=rank."""
    n, size = 3, 16
    _comms_, wins = _world(n, size, comp, pkg=pkg)
    try:
        for w in wins:
            w.fence()
        for r, w in enumerate(wins):
            w.put(origin(np.arange(4, dtype=np.float32) + 10 * r),
                  (r + 1) % n, disp=r)
        for w in wins:
            w.fence()
        return [np.array(w.local, copy=True) for w in wins]
    finally:
        _free_all(wins)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_osc_put_matches_pt2pt(pkg):
    ref = [np.zeros(16, np.float32) for _ in range(3)]
    for r in range(3):                   # the two-sided reference
        ref[(r + 1) % 3][r:r + 4] = np.arange(4, dtype=np.float32) + 10 * r
    shm = _run_put_pattern("shm", pkg)
    pt2pt = _run_put_pattern("pt2pt", pkg)
    for a, b, c in zip(shm, pt2pt, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    if pkg == "port":                    # tensor origins: the same bytes
        for comp in ("shm", "pt2pt"):
            got = _run_put_pattern(comp, pkg, torch.from_numpy)
            for a, c in zip(got, ref):
                np.testing.assert_array_equal(a, c)


def _run_get_pattern(comp, pkg):
    n, size = 3, 8
    _comms_, wins = _world(n, size, comp, pkg=pkg)
    try:
        for r, w in enumerate(wins):
            w.local[:] = np.arange(size, dtype=np.float32) * (r + 1)
        for w in wins:
            w.fence()
        out = [np.array(w.get((r + 1) % n, disp=2, count=4), copy=True)
               for r, w in enumerate(wins)]
        for w in wins:
            w.fence()
        return out
    finally:
        _free_all(wins)


def test_osc_get_matches_pt2pt():
    ref = [np.arange(8, dtype=np.float32)[2:6] * (((r + 1) % 3) + 1)
           for r in range(3)]
    runs = [_run_get_pattern(c, pkg) for pkg in ("port", "ref")
            for c in ("shm", "pt2pt")]
    for run in runs:
        for a, c in zip(run, ref):
            np.testing.assert_array_equal(a, c)


def _run_acc_pattern(comp, op, pkg, dtype=np.float32):
    """Fan-in: every rank accumulates its ramp into rank 0."""
    n, size = 3, 6
    _comms_, wins = _world(n, size, comp, dtype=dtype, pkg=pkg)
    try:
        for w in wins:
            w.local[:] = 1
        for w in wins:
            w.fence()
        for r, w in enumerate(wins):
            w.accumulate(np.arange(size, dtype=dtype) - 2 + r, 0, disp=0,
                         op=op)
        for w in wins:
            w.fence()
        return np.array(wins[0].local, copy=True)
    finally:
        _free_all(wins)


@pytest.mark.parametrize("op,dtype", [
    ("sum", np.float32), ("max", np.float32), ("min", np.float32),
    ("replace", np.float32), ("prod", np.float64), ("band", np.int32),
    ("bxor", np.int64), ("lor", np.int32), ("sum", np.uint32)])
def test_osc_accumulate_matches_pt2pt(op, dtype):
    fold = {"sum": np.add, "max": np.maximum, "min": np.minimum,
            "replace": lambda a, b: b, "prod": np.multiply,
            "band": np.bitwise_and, "bxor": np.bitwise_xor,
            "lor": lambda a, b: np.logical_or(a, b).astype(dtype)}[op]
    ref = np.ones(6, dtype)
    for r in range(3):
        ref = fold(ref, np.arange(6, dtype=dtype) - 2 + r)
    for pkg in ("port", "ref"):
        shm = _run_acc_pattern("shm", op, pkg, dtype)
        pt2pt = _run_acc_pattern("pt2pt", op, pkg, dtype)
        np.testing.assert_array_equal(shm, pt2pt)
        np.testing.assert_array_equal(shm, ref)


@pytest.mark.parametrize("comp", ["shm", "pt2pt"])
def test_osc_get_accumulate_and_cas_parity(comp):
    out = {}
    for pkg in ("port", "ref"):
        _comms_, wins = _world(2, 4, comp, pkg=pkg)
        try:
            for w in wins:
                w.local[:] = 5.0
                w.fence()
            prior = wins[0].get_accumulate(np.full(4, 2.0, np.float32), 1,
                                           disp=0, op="sum")
            after = np.array(wins[1].local, copy=True)
            old = wins[0].compare_and_swap(7.0, 9.0, 1, disp=2)
            fetched = wins[0].fetch_and_op(1.0, 1, disp=0)
            noop = wins[0].get_accumulate(np.full(2, 3.0, np.float32), 1,
                                          disp=1, op="no_op")
            out[pkg] = [prior, after, np.asarray([old, fetched]), noop,
                        np.array(wins[1].local, copy=True)]
            for w in wins:
                w.fence()
        finally:
            _free_all(wins)
    for a, b in zip(out["port"], out["ref"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out["port"][4], [8.0, 7.0, 9.0, 7.0])


@pytest.mark.parametrize("comp", ["shm", "pt2pt"])
def test_osc_typed_accumulates_on_a_byte_window(comp):
    """The typed entry points against a byte window, both packages."""
    out = {}
    for pkg in ("port", "ref"):
        _comms_, wins = _world(2, 32, comp, dtype=np.uint8, pkg=pkg)
        try:
            for w in wins:
                w.fence()
            wins[0].accumulate_typed(np.arange(4, dtype=np.int32), 1, 8,
                                     "sum")
            wins[0].accumulate_typed(np.full(4, 3, np.int32), 1, 8, "max")
            prior = wins[0].get_accumulate_typed(
                np.full(2, 1.5, np.float32), 1, 0, "sum")
            old = wins[0].compare_and_swap_typed(np.int32(3), np.int32(40),
                                                 1, 8)
            out[pkg] = [prior, np.asarray([old]),
                        np.array(wins[1].local, copy=True)]
        finally:
            _free_all(wins)
    for a, b in zip(out["port"], out["ref"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        out["port"][2][8:24].view(np.int32), [40, 3, 3, 3])


# -- epoch state machine -------------------------------------------------------
@pytest.mark.parametrize("comp", ["shm", "pt2pt"])
def test_osc_epoch_put_before_any_sync_raises(comp):
    _comms_, wins = _world(2, 4, comp)
    try:
        before = p_base.stats["epoch_errors"]
        with pytest.raises(MPIError) as ei:
            wins[0].put(np.zeros(2, np.float32), 1)
        assert ei.value.error_class == ERR_RMA_SYNC
        assert p_base.stats["epoch_errors"] == before + 1
    finally:
        _free_all(wins)


def test_osc_epoch_unlock_flush_fence_misuse_raises():
    for pkg in ("port", "ref"):
        _comms_, wins = _world(2, 4, "pt2pt", pkg=pkg)
        try:
            classes = []
            for bad in (lambda: wins[0].unlock(1),
                        lambda: (wins[0].fence(), wins[0].flush(1)),
                        lambda: (wins[0].lock(1, LOCK_EXCLUSIVE),
                                 wins[0].fence())):
                try:
                    bad()
                except Exception as e:   # noqa: BLE001 — either package
                    classes.append(e.error_class)
            wins[0].unlock(1)
            assert classes == [ERR_RMA_SYNC] * 3, (pkg, classes)
        finally:
            _free_all(wins)


def test_osc_epoch_check_can_be_disabled():
    p_base.register_params()
    p_var.var_set("mpi_base_osc_epoch_check", False)
    try:
        _comms_, wins = _world(2, 4, "pt2pt")
        try:
            wins[0].put(np.ones(2, np.float32), 1)  # no epoch: allowed
            np.testing.assert_array_equal(wins[1].local[:2],
                                          np.ones(2, np.float32))
        finally:
            _free_all(wins)
    finally:
        p_var.var_set("mpi_base_osc_epoch_check", True)


# -- passive target --------------------------------------------------------------
@pytest.mark.parametrize("comp", ["shm", "pt2pt"])
def test_osc_passive_lock_put_flush_unlock(comp):
    _comms_, wins = _world(3, 4, comp)
    try:
        w = wins[1]
        w.lock(0, LOCK_EXCLUSIVE)
        w.put(torch.full((4,), 3.5), 0)
        w.flush(0)
        np.testing.assert_array_equal(wins[0].local,
                                      np.full(4, 3.5, np.float32))
        w.unlock(0)
        w.lock_all()
        w.put(np.full(4, 4.5, np.float32), 2)
        w.flush_all()
        w.unlock_all()
        np.testing.assert_array_equal(wins[2].local,
                                      np.full(4, 4.5, np.float32))
    finally:
        _free_all(wins)


# -- selection ---------------------------------------------------------------------
def test_osc_selection_auto_forced_and_table():
    _comms_, wins = _world(2, 4, None)    # force=None -> auto
    try:
        assert all(w.component == "shm" for w in wins)
    finally:
        _free_all(wins)
    _comms_, wins = _world(2, 4, "pt2pt")
    try:
        assert all(w.component == "pt2pt" for w in wins)
        table = p_decision.selection_table()
        assert table["var"] == "auto" and table["windows_pt2pt"] >= 2
    finally:
        _free_all(wins)


def test_osc_selection_storage_pins_pt2pt_and_aliases():
    comms = _comms(2)
    stores = [np.zeros(4, np.float32), torch.zeros(4)]
    wins = [p_window.win_create(c, s) for c, s in zip(comms, stores)]
    try:
        assert all(w.component == "pt2pt" for w in wins)
        for w in wins:
            w.fence()
        wins[0].put(np.full(4, 2.0, np.float32), 1)
        wins[1].put(np.full(4, 3.0, np.float32), 0)
        np.testing.assert_array_equal(stores[1].numpy(), np.full(4, 2.0))
        np.testing.assert_array_equal(stores[0], np.full(4, 3.0))
    finally:
        _free_all(wins)


def test_osc_selection_refusals():
    class Stacked:
        pass
    with pytest.raises(MPIError) as ei:
        p_window.win_allocate(Stacked(), 4)
    assert ei.value.error_class == ERR_WIN
    with pytest.raises(MPIError) as ei:
        p_decision.select(Stacked(), force="shm")
    assert ei.value.error_class == ERR_WIN
    with pytest.raises(MPIError) as ei:
        p_decision.select(Stacked(), storage=np.zeros(2), force="shm")
    assert ei.value.error_class == ERR_WIN
    meta = torch.empty(4, device="meta")   # device memory stands in
    with pytest.raises(MPIError) as ei:
        p_window.win_create(_comms(1)[0], meta)
    assert ei.value.error_class == ERR_WIN


# -- fault tolerance ---------------------------------------------------------------
def test_osc_ft_dead_peer_fails_epoch():
    _comms_, wins = _world(3, 4, "shm")
    try:
        for w in wins:
            w.fence()
        before = p_base.stats["ft_failed_epochs"]
        p_ft.default_registry().fail_rank(2, "test kill")
        with pytest.raises(MPIError) as ei:
            wins[0].put(np.ones(2, np.float32), 2)
        assert ei.value.error_class == ERR_PROC_FAILED
        with pytest.raises(MPIError) as ei:
            wins[0].fence()
        assert ei.value.error_class == ERR_PROC_FAILED
        assert p_base.stats["ft_failed_epochs"] >= before + 3
        wins[0].lock(1, LOCK_EXCLUSIVE)
        wins[0].put(np.full(2, 6.0, np.float32), 1)
        wins[0].unlock(1)
        np.testing.assert_array_equal(wins[1].local[:2],
                                      np.full(2, 6.0, np.float32))
    finally:
        _free_all(wins)
        p_ft._reset_for_tests()


def test_osc_ft_dead_peer_seen_before_its_listener_ran():
    """The registry records a failure before it calls its listeners: a
    window whose listener has not run yet still refuses RMA to the dead
    peer, and the late listener counts the torn epoch no second time."""
    _comms_, wins = _world(3, 4, "shm")
    try:
        for w in wins:
            w.fence()
        p_ft.remove_listener(wins[0]._ft_cb)     # its listener is late
        before = p_base.stats["ft_failed_epochs"]
        p_ft.default_registry().fail_rank(2, "test kill")
        assert p_base.stats["ft_failed_epochs"] == before + 2
        with pytest.raises(MPIError) as ei:
            wins[0].put(np.ones(2, np.float32), 2)
        assert ei.value.error_class == ERR_PROC_FAILED
        wins[0]._ft_cb(2, "test kill")
        assert p_base.stats["ft_failed_epochs"] == before + 3
    finally:
        _free_all(wins)
        p_ft._reset_for_tests()


def test_osc_ft_torn_epoch_counted_before_the_dead_peer_shows():
    """A listener still reclaiming a dead peer (``peer_failed``) has
    already counted the torn epoch: a caller that finds the peer dead
    and gets ``ERR_PROC_FAILED`` reads the count, as chip_smoke's p44
    does right after its fence and put fail."""
    _comms_, wins = _world(3, 4, "shm")
    try:
        for w in wins:
            w.fence()
        release = threading.Event()
        reclaim = wins[0]._w.peer_failed
        wins[0]._w.peer_failed = lambda wr: (release.wait(10), reclaim(wr))
        before = p_base.stats["ft_failed_epochs"]
        t = threading.Thread(target=wins[0]._peer_dead,
                             args=(2, "test kill"))
        t.start()
        deadline = time.monotonic() + 10
        while 2 not in wins[0]._dead:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        with pytest.raises(MPIError) as ei:
            wins[0].put(np.ones(2, np.float32), 2)
        assert ei.value.error_class == ERR_PROC_FAILED
        assert p_base.stats["ft_failed_epochs"] == before + 1
        release.set()
        t.join(10)
        assert p_base.stats["ft_failed_epochs"] == before + 1
    finally:
        _free_all(wins)
        p_ft._reset_for_tests()


def test_osc_ft_dead_holder_releases_lock():
    _comms_, wins = _world(3, 4, "pt2pt")
    try:
        wins[1].lock(0, LOCK_EXCLUSIVE)
        p_ft.default_registry().fail_rank(1, "test kill")
        wins[2].lock(0, LOCK_EXCLUSIVE)
        wins[2].put(np.full(2, 8.0, np.float32), 0)
        wins[2].unlock(0)
        np.testing.assert_array_equal(wins[0].local[:2],
                                      np.full(2, 8.0, np.float32))
    finally:
        _free_all(wins)
        p_ft._reset_for_tests()


# -- observability -----------------------------------------------------------------
def test_osc_pvars_count_ops_and_bytes():
    p0, b0 = p_base.stats["puts"], p_base.stats["put_bytes"]
    _comms_, wins = _world(2, 8, "shm")
    try:
        for w in wins:
            w.fence()
        wins[0].put(np.ones(8, np.float32), 1)
        assert p_pvar.pvar_read("osc_puts") == p0 + 1
        assert p_pvar.pvar_read("osc_put_bytes") == b0 + 32
        name = wins[0]._pvar_name
        assert p_pvar.pvar_read(name) == 32
        assert p_base.stats["notes"] >= 1   # the target-side note landed
    finally:
        _free_all(wins)
    with pytest.raises(KeyError):
        p_pvar.pvar_read(name)


def test_osc_shm_get_is_zero_copy_adoption():
    _comms_, wins = _world(2, 4, "shm")
    try:
        for w in wins:
            w.fence()
        view = wins[0].get(1, disp=0, count=4)
        assert not view.flags.owndata
        wins[1].local[0] = 42.0          # the target's own store ...
        assert float(view[0]) == 42.0    # ... visible through the view
    finally:
        _free_all(wins)


def test_osc_shm_segments_port_prefix_unlinked_on_free():
    assert WIN_PREFIX == "otptwin" != r_shm.WIN_PREFIX
    pat = os.path.join(SHM_DIR, f"{WIN_PREFIX}_{os.getpid():x}_*")
    _comms_, wins = _world(2, 16, "shm")
    assert len(glob.glob(pat)) == 2
    _free_all(wins)
    assert glob.glob(pat) == []


def test_osc_flightrec_snapshots_open_epochs():
    _comms_, wins = _world(2, 4, "shm")
    try:
        wins[0].fence()
        state = p_base.open_epoch_state()
        mine = [s for s in state if s["win"] == wins[0].name]
        assert mine and mine[0]["fenced"] and mine[0]["component"] == "shm"
        from ompi_tpu_torch.telemetry import flightrec as p_fr
        payload = p_fr.snapshot("test", {})
        assert any(s.get("win") == wins[0].name
                   for s in payload.get("osc_epochs", []))
    finally:
        _free_all(wins)


def test_osc_mpitop_section_and_trace_summary(tmp_path):
    """The port's telemetry dump carries the osc counter block, each
    package's mpitop renders the osc section from its package's dump (the
    reference's mpitop beside it, with the same summary), and both trace
    summaries aggregate osc.* spans."""
    from ompi_tpu import telemetry as r_tele
    from ompi_tpu.tools import mpitop as r_mpitop
    from ompi_tpu.trace import attribution as r_attr
    from ompi_tpu_torch import telemetry as p_tele
    from ompi_tpu_torch.tools import mpitop as p_mpitop
    from ompi_tpu_torch.trace import attribution as p_attr
    rows = {}
    for pkg, tele, mpitop in (("port", p_tele, p_mpitop),
                              ("ref", r_tele, r_mpitop)):
        _comms_, wins = _world(2, 8, "pt2pt", pkg=pkg)
        try:
            for w in wins:
                w.fence()
            wins[0].put(np.ones(8, np.float32), 1)
            _ = np.asarray(wins[0].get(1, 0, 8))
        finally:
            _free_all(wins)
        path = str(tmp_path / f"telemetry_{pkg}.json")
        tele.dump(path, rank=0)
        snaps, skipped = mpitop.load_snapshots([path])
        assert snaps and not skipped
        summary = mpitop.summarize(snaps)
        assert summary == r_mpitop.summarize(snaps)
        assert summary["osc"], f"{pkg}: osc section missing"
        rows[pkg] = summary["osc"][0]
        assert "osc (one-sided):" in mpitop.render_table(summary)
    assert rows["port"]["puts"] >= 1 and rows["port"]["bytes"] >= 32
    assert set(rows["port"]) == set(rows["ref"])
    spans = [
        {"name": "osc.put", "rank": 0, "dur": 1e-4,
         "args": {"bytes": 64, "target": 1}},
        {"name": "osc.acc", "rank": 0, "dur": 2e-4,
         "args": {"bytes": 32, "target": 1}},
        {"name": "osc.epoch", "rank": 1, "dur": 5e-5,
         "args": {"phase": "fence"}},
    ]
    agg = p_attr.osc_by_rank(spans)
    assert agg == r_attr.osc_by_rank(spans)
    assert agg["0"]["puts"] == 1 and agg["0"]["accs"] == 1
    assert p_attr.summarize(spans)["osc"] == agg


def test_osc_spans_and_histograms_when_traced():
    """With tracing and telemetry on, every data op leaves an osc.<kind>
    span and a tele_osc_<kind>_us sample; epochs leave osc.epoch."""
    from ompi_tpu_torch import telemetry as p_tele
    from ompi_tpu_torch.trace import core as p_trace
    p_trace.enable()
    p_tele.enable()
    try:
        p_trace.reset()
        _comms_, wins = _world(2, 4, "shm")
        try:
            for w in wins:
                w.fence()
            wins[0].put(np.ones(4, np.float32), 1)
            wins[0].get(1, 0, 4)
            wins[0].accumulate(np.ones(4, np.float32), 1)
        finally:
            _free_all(wins)
        names = [s.name for s in p_trace.spans()]
        for kind in ("put", "get", "acc"):
            assert f"osc.{kind}" in names
            assert p_base.op_hist(kind).snapshot()["count"] >= 1
        assert names.count("osc.epoch") >= 4   # 2 fences, 2 frees
    finally:
        p_tele.disable()
        p_trace.disable()


def test_osc_reference_stats_untouched_by_the_port():
    """The two packages keep separate counters: a port window moves the
    port's pvars only."""
    before = dict(r_base.stats)
    _comms_, wins = _world(2, 4, "shm")
    try:
        for w in wins:
            w.fence()
        wins[0].put(np.ones(4, np.float32), 1)
    finally:
        _free_all(wins)
    assert r_base.stats == before
    assert r_ft.default_registry() is not p_ft.default_registry()
