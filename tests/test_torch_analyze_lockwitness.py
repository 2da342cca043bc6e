"""Mirror of ``tests/test_analyze_lockwitness.py`` through both packages.

The runtime lock-order witness: a synthetic AB/BA inversion reported
with both stacks, the gate off leaving ``threading.Lock`` untouched,
RLock/Condition compatibility, the ``lockwitness_max_hold_us`` watermark
pvar, and dump/merge. Each case runs on the reference's witness and on
the port's with the same lock pattern; ``install()`` rebinds
``threading.Lock`` process-wide, so every case uninstalls it again. The
port's own case: ``Init`` with ``mpi_base_lockwitness`` arms it before
transport bring-up, and ``_reset_for_tests`` disarms it.
"""
import importlib
import json
import threading
import time

import pytest

import ompi_tpu_torch as P
from ompi_tpu.analyze import lockwitness as r_lw
from ompi_tpu_torch.analyze import lockwitness as p_lw

PKGS = ["ompi_tpu", "ompi_tpu_torch"]
LW = {"ompi_tpu": r_lw, "ompi_tpu_torch": p_lw}


@pytest.fixture(params=PKGS)
def witness(request):
    """One package's witness installed for one test; the interpreter's
    factories are always restored afterwards."""
    lw = LW[request.param]
    lw.register_params()
    lw.reset()
    lw.install()
    try:
        yield request.param, lw
    finally:
        lw.uninstall()
        lw.reset()


def _pvar(pkg):
    return importlib.import_module(f"{pkg}.mca.pvar")


@pytest.mark.parametrize("pkg", PKGS)
def test_lockwitness_gate_off_byte_identical(pkg):
    lw = LW[pkg]
    assert not lw.installed
    lw.maybe_install_from_var()
    assert not lw.installed
    assert threading.Lock is lw._ORIG_LOCK
    assert threading.RLock is lw._ORIG_RLOCK


def test_ab_ba_inversion_reported_with_both_stacks(witness):
    pkg, lw = witness
    lock_a = threading.Lock()
    lock_b = threading.Lock()
    assert isinstance(lock_a, lw.WitnessLock)

    def ab():
        with lock_a:
            with lock_b:
                pass

    def ba():
        with lock_b:
            with lock_a:
                pass

    for fn in (ab, ba):
        t = threading.Thread(target=fn)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    rep = lw.report()
    cycles = [c for c in rep["cycles"]
              if {lock_a._site, lock_b._site} == set(c["sites"])]
    assert cycles, (rep["edges"], rep["cycles"])
    assert len(cycles[0]["edges"]) == 2
    for edge in cycles[0]["edges"]:
        assert edge["stack"], edge
        assert any("test_torch_analyze_lockwitness" in ln
                   for ln in edge["stack"])
    assert _pvar(pkg).pvar_read("lockwitness_edges") >= 2


def test_consistent_order_is_acyclic(witness):
    _pkg, lw = witness
    lock_a = threading.Lock()
    lock_b = threading.Lock()

    def ab():
        with lock_a:
            with lock_b:
                pass

    for _ in range(2):
        t = threading.Thread(target=ab)
        t.start()
        t.join(timeout=10)
    involved = [c for c in lw.report()["cycles"]
                if lock_a._site in c["sites"] or lock_b._site
                in c["sites"]]
    assert involved == [], involved


def test_rlock_reentrancy_records_no_self_edge(witness):
    _pkg, lw = witness
    rl = threading.RLock()
    assert isinstance(rl, lw.WitnessRLock)
    with rl:
        with rl:
            pass
    assert not any(e["a"] == e["b"] == rl._site
                   for e in lw.report()["edges"])
    cond = threading.Condition()             # wraps a witness RLock
    assert isinstance(cond._lock, lw.WitnessRLock)
    woke = []

    def waiter():
        with cond:
            woke.append(cond.wait(timeout=10))

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        cond.notify_all()
    t.join(timeout=10)
    assert not t.is_alive()
    assert woke == [True]


def test_hold_time_watermark_pvar(witness):
    pkg, lw = witness
    lk = threading.Lock()
    with lk:
        time.sleep(0.02)                     # 20000 us >> 5000 us
    rep = lw.report()
    assert rep["max_hold_us"] >= 5000.0
    assert any(h["site"] == lk._site and h["us"] >= 5000.0
               for h in rep["long_holds"]), rep["long_holds"]
    assert _pvar(pkg).pvar_read("lockwitness_max_hold_us") \
        >= rep["max_hold_us"]


def test_dump_and_merge_round_trip(witness, tmp_path):
    _pkg, lw = witness
    lock_a = threading.Lock()
    lock_b = threading.Lock()
    with lock_a:
        with lock_b:
            pass
    p0 = tmp_path / "lw_r0.json"
    lw.dump(str(p0), rank=0)
    merged = lw.merge_reports([json.loads(p0.read_text())] * 2)
    assert merged["ranks"] == 2
    key = (lock_a._site, lock_b._site)
    doubled = [e for e in merged["edges"] if (e["a"], e["b"]) == key]
    assert doubled and doubled[0]["count"] == 2 * [
        e for e in lw.report()["edges"]
        if (e["a"], e["b"]) == key][0]["count"]
    assert merged["cycles"] == []


def test_uninstall_restores_factories(witness):
    _pkg, lw = witness
    lw.uninstall()
    assert threading.Lock is lw._ORIG_LOCK
    assert threading.RLock is lw._ORIG_RLOCK
    lk = lw.WitnessLock()                    # still works afterwards
    with lk:
        assert lk.locked()


def test_merge_and_cycles_agree_across_packages():
    """The same synthetic per-rank reports merge to the same graph and
    the same cycles in both packages."""
    reports = [
        {"rank": 0, "lockwitness": {
            "edges": [{"a": "x.py:1", "b": "y.py:2", "count": 3,
                       "stack": ["s0"]}],
            "sites": {"x.py:1": 1, "y.py:2": 1}, "max_hold_us": 12.5,
            "long_holds": [], "cycles": []}},
        {"rank": 1, "lockwitness": {
            "edges": [{"a": "y.py:2", "b": "x.py:1", "count": 1,
                       "stack": None},
                      {"a": "y.py:2", "b": "z.py:3", "count": 2,
                       "stack": ["s1"]}],
            "sites": {"y.py:2": 2, "z.py:3": 1}, "max_hold_us": 40.0,
            "long_holds": [{"site": "z.py:3", "us": 40.0}],
            "cycles": []}},
    ]
    ref = r_lw.merge_reports(json.loads(json.dumps(reports)))
    port = p_lw.merge_reports(json.loads(json.dumps(reports)))
    assert ref == port
    assert [c["sites"] for c in port["cycles"]] == [["x.py:1", "y.py:2"]]


def test_init_arms_the_witness_from_the_var(monkeypatch):
    """``Init`` with ``mpi_base_lockwitness`` set installs the witness
    before transport bring-up; the port's reset uninstalls it."""
    monkeypatch.setenv("OMPI_TPU_TORCH_MCA_mpi_base_lockwitness", "1")
    P._reset_for_tests()
    try:
        P.Init(devices=["cpu"] * 2)
        assert p_lw.installed
        assert threading.Lock is p_lw.WitnessLock
        w = P.get_comm_world()
        assert w.allreduce(w.alloc((3,), fill=1.0)).sum() == 12
    finally:
        P._reset_for_tests()
    assert not p_lw.installed
    assert threading.Lock is p_lw._ORIG_LOCK
    assert threading.RLock is p_lw._ORIG_RLOCK
