"""The port's pessimist message logging (``pml/vprotocol``) against the
reference's.

The nine scenarios of ``tests/test_vprotocol.py``, each run on the
reference's engine over a ``dup()`` of its 8-device world and on the
port's over its 8-rank CPU world, with the same seeded numpy payloads
(and, on the port, the same payloads as tensors). Delivered data,
statuses and the determinant logs must be identical; payloads are
compared exactly. Then the port's own contract for mutable payloads: the
sender-based log holds its own copy of a tensor, and a JSON snapshot
keeps every bit of a tensor payload (bf16 included).
"""
import json

import numpy as np
import pytest
import torch

import ompi_tpu_torch as P
from ompi_tpu.mca import var as rvar
from ompi_tpu.pml import vprotocol as rvp
from ompi_tpu_torch.mca import var as pvar
from ompi_tpu_torch.pml import vprotocol as pvp
from ompi_tpu_torch.pml.stacked import ANY_SOURCE, ANY_TAG

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


def _as(kind, a):
    """A payload as the side under test takes it."""
    return torch.from_numpy(np.array(a)) if kind == "tensor" else np.array(a)


def _h(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _log(eng):
    return [(e.kind, e.src, e.dest, e.tag, e.posted_src, e.posted_tag)
            for e in eng.log]


SIDES = [("ref", "numpy"), ("port", "numpy"), ("port", "tensor")]


def _engine(side, rworld, pworld, replay_log=None):
    if side == "ref":
        return rvp.PessimistEngine(rworld, replay_log=replay_log)
    return pvp.PessimistEngine(pworld, replay_log=replay_log)


def test_engine_selected_by_mca_var(pworld, rworld):
    for var_mod, world, cls in ((pvar, pworld, pvp.PessimistEngine),
                                (rvar, rworld, rvp.PessimistEngine)):
        var_mod.var_set("pml_v_protocol", "pessimist")
        try:
            c = world.dup()
            assert isinstance(c._pml, cls)
            c.free()
        finally:
            var_mod.var_set("pml_v_protocol", "none")
        c = world.dup()
        assert not isinstance(c._pml, cls)
        c.free()


def test_send_and_determinants_logged(pworld, rworld):
    logs = []
    for side, kind in SIDES:
        world = rworld if side == "ref" else pworld
        c = world.dup()
        if side == "ref":
            rvar.var_set("pml_v_protocol", "pessimist")
        else:
            pvar.var_set("pml_v_protocol", "pessimist")
        try:
            c.send(_as(kind, np.float32([1, 2])), src=1, dest=0, tag=7)
            data, st = c._pml.recv(0, 1, 7)
            np.testing.assert_array_equal(_h(data), [1, 2])
            logs.append(_log(c._pml))
            np.testing.assert_array_equal(_h(c._pml.log[0].payload), [1, 2])
        finally:
            rvar.var_set("pml_v_protocol", "none")
            pvar.var_set("pml_v_protocol", "none")
            c.free()
    assert logs[0] == logs[1] == logs[2]
    assert [e[0] for e in logs[0]] == ["send", "match"]


def _wildcard_scenario(eng, kind, order):
    for v, s in order:
        eng.send(_as(kind, np.int32([v])), s, 0, 5)
    out = []
    for _ in order:
        d, st = eng.recv(0, ANY_SOURCE, ANY_TAG)
        out.append((int(_h(d)[0]), st.source))
    return out


def test_wildcard_determinant_and_replay_forces_order(pworld, rworld):
    for side, kind in SIDES:
        rec = _engine(side, rworld, pworld)
        assert _wildcard_scenario(rec, kind, [(10, 1), (20, 2)]) == \
            [(10, 1), (20, 2)]
        rep = _engine(side, rworld, pworld, replay_log=rec.log)
        # sends arrive in the OPPOSITE order: the determinants force the
        # original delivery order
        assert _wildcard_scenario(rep, kind, [(20, 2), (10, 1)]) == \
            [(10, 1), (20, 2)], (side, kind)


def test_replay_mixed_named_and_wildcard_receives(pworld, rworld):
    results = []
    for side, kind in SIDES:
        rec = _engine(side, rworld, pworld)
        rec.send(_as(kind, np.int32([10])), 1, 0, 5)
        rec.send(_as(kind, np.int32([20])), 2, 0, 6)
        rec.recv(0, 1, 5)
        rec.recv(0, ANY_SOURCE, ANY_TAG)
        rep = _engine(side, rworld, pworld, replay_log=rec.log)
        rep.send(_as(kind, np.int32([10])), 1, 0, 5)
        rep.send(_as(kind, np.int32([20])), 2, 0, 6)
        r1, st1 = rep.recv(0, 1, 5)
        r2, st2 = rep.recv(0, ANY_SOURCE, ANY_TAG)
        results.append((int(_h(r1)[0]), st1.source, int(_h(r2)[0]),
                        st2.source, _log(rep)))
    assert results[0] == results[1] == results[2]
    assert results[0][:4] == (10, 1, 20, 2)


def test_replay_determinant_exhaustion_raises(pworld, rworld):
    msgs = []
    for side, kind in SIDES:
        rep = _engine(side, rworld, pworld, replay_log=[])
        rep.send(_as(kind, np.int32([1])), 1, 0, 3)
        with pytest.raises(Exception) as ei:
            rep.recv(0, ANY_SOURCE, 3)
        msgs.append(str(ei.value))
        assert "determinant" in msgs[-1]
    assert msgs[1] == msgs[2]


def test_deferred_match_logs_determinant(pworld, rworld):
    logs = []
    for side, kind in SIDES:
        eng = _engine(side, rworld, pworld)
        req = eng.irecv(0, ANY_SOURCE, ANY_TAG)
        assert all(ev.kind == "send" for ev in eng.log)
        eng.send(_as(kind, np.int32([9])), 3, 0, 11)
        ok, st = req.test()
        assert ok and st.source == 3 and st.tag == 11
        logs.append(_log(eng))
    assert logs[0] == logs[1] == logs[2]
    assert [e for e in logs[0] if e[0] == "match"] == \
        [("match", 3, 0, 11, ANY_SOURCE, ANY_TAG)]


def test_orphan_redelivery_from_payload_log(pworld, rworld):
    for side, kind in SIDES:
        rec = _engine(side, rworld, pworld)
        rec.send(_as(kind, np.float64([1.5])), 1, 0, 2)
        rec.send(_as(kind, np.float64([2.5])), 2, 0, 2)
        rec.recv(0, ANY_SOURCE, 2)
        rec.recv(0, ANY_SOURCE, 2)
        fresh = _engine(side, rworld, pworld, replay_log=rec.log)
        fresh.log = list(rec.log)        # restored escrow
        assert fresh.redeliver(0) == 2
        a, _ = fresh.recv(0, ANY_SOURCE, 2)
        b, _ = fresh.recv(0, ANY_SOURCE, 2)
        assert (float(_h(a)[0]), float(_h(b)[0])) == (1.5, 2.5)


def test_log_snapshot_roundtrip(pworld, rworld):
    snaps = []
    for side, kind in SIDES:
        eng = _engine(side, rworld, pworld)
        eng.send(_as(kind, np.int16([3, 4])), 0, 1, 1)
        eng.recv(1, ANY_SOURCE, ANY_TAG)
        dicts = json.loads(json.dumps(eng.snapshot()))   # JSON-safe
        mod = rvp if side == "ref" else pvp
        log = mod.PessimistEngine.restore_log(dicts)
        assert [ev.kind for ev in log] == ["send", "match"]
        p = log[0].payload
        assert (p.dtype == np.int16 if kind == "numpy"
                else p.dtype == torch.int16)
        np.testing.assert_array_equal(_h(p), [3, 4])
        rep = _engine(side, rworld, pworld, replay_log=log)
        rep.send(_as(kind, np.int16([3, 4])), 0, 1, 1)
        d, st = rep.recv(1, ANY_SOURCE, ANY_TAG)
        assert st.source == 0
        np.testing.assert_array_equal(_h(d), [3, 4])
        snaps.append([{k: v for k, v in d_.items() if k != "payload_dtype"
                       and not k.startswith("payload")} for d_ in dicts])
    assert snaps[0] == snaps[1] == snaps[2]


def test_mprobe_logs_determinant(pworld, rworld):
    for side, kind in SIDES:
        eng = _engine(side, rworld, pworld)
        eng.send(_as(kind, np.int32([7])), 2, 0, 4)
        msg = eng.mprobe(0, ANY_SOURCE, ANY_TAG)
        data, st = eng.mrecv(msg)
        assert st.source == 2 and int(_h(data)[0]) == 7
        dets = [ev for ev in eng.log if ev.kind == "match"]
        assert len(dets) == 1 and dets[0].src == 2


def test_parity_script_same_log_and_values(pworld, rworld):
    """One seeded send/recv script with named and wildcard receives: both
    packages log the same determinants and deliver the same values."""
    rng = np.random.default_rng(21)
    script = []
    for i in range(24):
        src, dest = (int(v) for v in rng.choice(N, size=2, replace=False))
        script.append((src, dest, int(rng.integers(0, 3)),
                       rng.standard_normal(int(rng.integers(1, 5)))
                       .astype(np.float32)))
    outs = []
    for side, kind in SIDES:
        eng = _engine(side, rworld, pworld)
        got = []
        for i, (src, dest, tag, x) in enumerate(script):
            eng.send(_as(kind, x), src, dest, tag)
            if i % 3 == 2:               # drain every rank, wildcards first
                for d in range(N):
                    while eng.iprobe(d, ANY_SOURCE, ANY_TAG)[0]:
                        data, st = eng.recv(d, ANY_SOURCE, ANY_TAG)
                        got.append((d, st.source, st.tag,
                                    _h(data).tobytes()))
        for d in range(N):
            while eng.iprobe(d, ANY_SOURCE, ANY_TAG)[0]:
                data, st = eng.recv(d, ANY_SOURCE, ANY_TAG)
                got.append((d, st.source, st.tag, _h(data).tobytes()))
        outs.append((got, _log(eng)))
    assert outs[0] == outs[1] == outs[2]
    assert len(outs[0][0]) == len(script)


def test_log_holds_its_own_copy_of_a_tensor(pworld):
    """The sender overwriting its buffer, and the receiver writing into
    the delivered tensor, leave the escrow unchanged; redelivery gives
    the logged bits on the destination rank's device."""
    eng = pvp.PessimistEngine(pworld)
    buf = torch.arange(6, dtype=torch.float32)
    eng.send(buf, 1, 0, 3)
    buf.fill_(-1.0)                      # sender reuses its buffer
    data, _ = eng.recv(0, ANY_SOURCE, 3)
    np.testing.assert_array_equal(data.numpy(), np.arange(6))
    data.fill_(7.0)                      # receiver writes into its copy
    np.testing.assert_array_equal(eng.log[0].payload.numpy(), np.arange(6))
    assert eng.redeliver(0) == 1
    again, _ = eng.recv(0, ANY_SOURCE, 3)
    assert again.device == pworld.devices[0]
    np.testing.assert_array_equal(again.numpy(), np.arange(6))


def test_snapshot_keeps_bf16_and_every_bit(pworld):
    eng = pvp.PessimistEngine(pworld)
    x = torch.tensor([1.5, -0.0, float("nan"), 3e38], dtype=torch.bfloat16)
    bits = np.frombuffer(bytes(np.random.default_rng(0).integers(
        0, 256, size=24, dtype=np.uint8)), dtype=np.float32).copy()
    eng.send(x, 2, 0, 1)
    eng.send(torch.from_numpy(bits).reshape(2, 3), 3, 0, 1)
    eng.send({"obj": 1}, 4, 0, 1)
    log = pvp.PessimistEngine.restore_log(json.loads(json.dumps(
        eng.snapshot())))
    assert log[0].payload.dtype == torch.bfloat16
    assert torch.equal(log[0].payload.view(torch.int16), x.view(torch.int16))
    assert log[1].payload.shape == (2, 3)
    assert log[1].payload.numpy().tobytes() == bits.tobytes()
    assert log[2].payload == {"obj": 1}
