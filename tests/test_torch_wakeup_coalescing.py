"""Mirror of ``tests/test_wakeup_coalescing.py`` through both packages.

One reader-thread wake serves every match completed in a drain batch
(``runtime/progress`` wake batches, the bml's ordered drain and the
combining collectives), and the counters ride MPI_T. Each case runs on
the reference and on the port with the same events and frames. The last
case is the port's C4 repair: its ``Router`` publishes the tcp ctl
flush-window counters as the pvars ``btl_ctl_frames``,
``btl_ctl_batches`` and ``btl_ctl_poke_dedup``.
"""
import importlib
import threading

import numpy as np
import pytest

PKGS = ["ompi_tpu", "ompi_tpu_torch"]


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class _C:
    cid = "wake-test"
    size = 4

    def rank(self):
        return 0

    def world_rank_of(self, r):
        return 0


@pytest.mark.parametrize("pkg", PKGS)
def test_batch_defers_and_dedupes_wakes(pkg):
    progress = _m(pkg, "runtime.progress")
    s0 = progress.wake_stats()
    e1, e2 = threading.Event(), threading.Event()
    progress.wake_begin()
    try:
        progress.wake(e1)
        progress.wake(e1)                    # duplicate: same Event
        progress.wake(e2)
        progress.wake_note_frame(4)
        assert not e1.is_set() and not e2.is_set(), \
            "wakes must defer to batch end"
    finally:
        progress.wake_end()
    assert e1.is_set() and e2.is_set()
    s1 = progress.wake_stats()
    assert s1["wakeups"] - s0["wakeups"] == 2        # deduped
    assert s1["completions"] - s0["completions"] == 3
    assert s1["frames"] - s0["frames"] == 4
    assert s1["batches"] - s0["batches"] == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_nested_batches_flush_once_at_outermost(pkg):
    progress = _m(pkg, "runtime.progress")
    e = threading.Event()
    progress.wake_begin()
    progress.wake_begin()                    # the sm drain nests so
    progress.wake(e)
    progress.wake_end()
    assert not e.is_set(), "inner end must not flush"
    progress.wake_end()
    assert e.is_set()


@pytest.mark.parametrize("pkg", PKGS)
def test_wake_outside_batch_is_immediate(pkg):
    progress = _m(pkg, "runtime.progress")
    s0 = progress.wake_stats()
    e = threading.Event()
    progress.wake(e)
    assert e.is_set()
    assert progress.wake_stats()["wakeups"] - s0["wakeups"] == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_counters_ride_the_pvar_plumbing(pkg):
    _m(pkg, "runtime.progress")
    pvar = _m(pkg, "mca.pvar")
    for name in ("pml_wakeups", "pml_completions",
                 "pml_frames_delivered", "pml_frames_per_wakeup"):
        assert isinstance(pvar.pvar_read(name), (int, float)), name
    assert pvar.pvar_info("pml_frames_per_wakeup")["unit"] == "ratio"


@pytest.mark.parametrize("pkg", PKGS)
def test_combine_slot_one_wake_many_frames(pkg):
    progress = _m(pkg, "runtime.progress")
    pr = _m(pkg, "pml.perrank")
    encode_payload = _m(pkg, "btl.tcp").encode_payload
    kv = {}
    router = pr.Router(0, 1, kv.__setitem__, kv.__getitem__)
    eng = pr.PerRankEngine(_C(), router)
    try:
        slot = eng.post_combine(
            9, 4, 3, lambda vals: sum(float(v[0]) for v in vals),
            own=(0, np.array([1.0])))
        s0 = progress.wake_stats()
        progress.wake_begin()                # the bml drain's batch
        try:
            for src in (1, 2, 3):
                desc, raw = encode_payload(np.array([float(src)]))
                eng._incoming({"cid": "wake-test", "src": src,
                               "tag": 9, "desc": desc}, raw)
                progress.wake_note_frame()
        finally:
            progress.wake_end()
        assert slot.wait(5) == 1.0 + 1.0 + 2.0 + 3.0
        s1 = progress.wake_stats()
        assert s1["wakeups"] - s0["wakeups"] == 1, \
            "3 frames completing one slot must flush one wake"
        assert s1["frames"] - s0["frames"] == 3
        eng.end_combine(9)
    finally:
        router.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_ctl_stats_ride_the_pvar_plumbing(pkg):
    pvar = _m(pkg, "mca.pvar")
    kv = {}
    router = _m(pkg, "pml.perrank").Router(0, 1, kv.__setitem__,
                                           kv.__getitem__)
    try:
        for name in ("btl_ctl_frames", "btl_ctl_batches",
                     "btl_ctl_poke_dedup"):
            assert pvar.pvar_read(name) == 0, name
        router.endpoint.tcp.ctl_stats["frames"] += 7
        assert pvar.pvar_read("btl_ctl_frames") == 7
        router.endpoint.tcp.ctl_stats["poke_dedup"] += 2
        assert pvar.pvar_read("btl_ctl_poke_dedup") == 2
    finally:
        router.close()
