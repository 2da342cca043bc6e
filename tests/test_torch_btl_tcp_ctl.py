"""Mirror of ``tests/test_btl_tcp_ctl.py`` through both packages.

The reader-originated ctl path of ``btl/tcp``: every case runs on the
reference's ``TcpEndpoint`` and on the port's with the same frames, and
both must observe the same thing. The port's repairs show here: its
``ctl_stats`` counters (frames, batches, deduped pokes), a full ctl
queue failing its link exactly once, and ``close`` never blocking on a
full queue. ``test_sim_gbps_paces_frame_sends`` mirrors the reference's
test of the paced-wire floor (``btl_tcp_sim_gbps``) through both.
"""
import importlib
import queue
import threading
import time

import pytest

PKGS = ["ompi_tpu", "ompi_tpu_torch"]


def _tcp(pkg):
    return importlib.import_module(f"{pkg}.btl.tcp")


def _pair(pkg, kv, rank, sink, on_peer_lost=None):
    return _tcp(pkg).TcpEndpoint(rank, 2, kv.__setitem__, kv.__getitem__,
                                 sink, on_peer_lost=on_peer_lost)


@pytest.mark.parametrize("pkg", PKGS)
def test_reader_originated_send_diverts_and_delivers(pkg):
    kv = {}
    got_pong = threading.Event()
    reply_thread = {}

    def sink_a(header, payload):
        if header.get("kind") == "pong":
            got_pong.set()

    a = _pair(pkg, kv, 0, sink_a)

    def sink_b(header, payload):
        if header.get("kind") == "ping":
            reply_thread["name"] = threading.current_thread().name
            b.send_frame(0, {"kind": "pong"})   # from the reader
    b = _pair(pkg, kv, 1, sink_b)
    try:
        a.send_frame(1, {"kind": "ping"})
        assert got_pong.wait(10), "reply never arrived"
        assert "btl-tcp-read" in reply_thread["name"]
        assert 0 in b._ctl_qs, "reader send did not divert to ctl"
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_ctl_queue_overflow_fails_link_once(pkg):
    kv = {}
    lost = []
    a = _pair(pkg, kv, 0, lambda h, p: None, on_peer_lost=lost.append)
    try:
        q = queue.Queue(maxsize=2)           # a wedged sender's queue
        q.put(("x", b""))
        q.put(("y", b""))
        with a._lock:
            a._ctl_qs[1] = q
        t0 = time.monotonic()
        a._ctl_submit(1, {"k": 1}, b"")      # overflow -> link down
        assert time.monotonic() - t0 < 1.0, "submit blocked"
        assert lost == [1]
        assert q.empty(), "queued frames must be discarded"
        a._ctl_submit(1, {"k": 2}, b"")      # dropped, no re-report
        assert lost == [1]
    finally:
        a.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_persistent_send_failure_reports_once(pkg):
    lost = []
    kv = {}
    a = _pair(pkg, kv, 0, lambda h, p: None, on_peer_lost=lost.append)
    try:
        a._reader_tls.active = True          # an unresolvable peer
        a.send_frame(1, {"k": 1})
        assert 1 in a._ctl_qs, "reader send did not divert"
        deadline = time.monotonic() + 10
        while not lost and time.monotonic() < deadline:
            time.sleep(0.05)
        assert lost == [1]
        a.send_frame(1, {"k": 2})            # link already failed
        time.sleep(0.3)
        assert lost == [1], "failure must be reported exactly once"
    finally:
        a._reader_tls.active = False
        a.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_close_never_blocks_on_full_ctl_queue(pkg):
    a = _pair(pkg, {}, 0, lambda h, p: None)
    q = queue.Queue(maxsize=1)
    q.put(("wedged", b""))
    with a._lock:
        a._ctl_qs[1] = q
    t0 = time.monotonic()
    a.close()
    assert time.monotonic() - t0 < 1.0, "close blocked on full queue"


@pytest.mark.parametrize("pkg", PKGS)
def test_ctl_flood_no_false_peer_down(pkg):
    kv = {}
    lost = []
    got = []
    done = threading.Event()
    n = 2000

    def sink_b(header, payload):
        got.append(header["i"])
        if len(got) == n:
            done.set()

    a = _pair(pkg, kv, 0, lambda h, p: None, on_peer_lost=lost.append)
    b = _pair(pkg, kv, 1, sink_b)
    try:
        a._reader_tls.active = True          # reader-originated: ctl path
        for i in range(n):
            a.send_frame(1, {"i": i})
        assert done.wait(30), f"only {len(got)}/{n} frames arrived"
        assert lost == [], "a live peer's ctl flood reported it down"
        assert got == list(range(n)), "ctl batching broke ordering"
        st = a.ctl_stats                     # the window coalesced
        # the sender counts a batch after its sendall returns, which the
        # receiver may beat: wait for the counter the assertion reads
        deadline = time.monotonic() + 10
        while st["frames"] < n and time.monotonic() < deadline:
            time.sleep(0.01)
        assert st["frames"] == n, st
        assert 0 < st["batches"] < n, st
    finally:
        a._reader_tls.active = False
        a.close()
        b.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_ctl_batch_flush_window_dedupes_pokes(pkg):
    kv = {}
    got = []
    done = threading.Event()

    def sink_b(header, payload):
        got.append(header)
        if len(got) == 3:
            done.set()

    a = _pair(pkg, kv, 0, lambda h, p: None)
    b = _pair(pkg, kv, 1, sink_b)
    try:
        q = queue.Queue()
        q.put(({"ctl": "_smpoke", "peer": 0}, b""))
        q.put(({"ctl": "_smpoke", "peer": 0}, b""))
        q.put(({"k": 1}, b""))
        q.put(({"ctl": "_smpoke", "peer": 0}, b""))
        q.put(({"k": 2}, b""))
        t = threading.Thread(target=a._ctl_send_loop, args=(q, 1),
                             daemon=True)
        t.start()
        assert done.wait(10), f"got {len(got)} frames"
        time.sleep(0.2)                      # no extra frames trail in
        assert [h.get("ctl") or h.get("k") for h in got] == \
            ["_smpoke", 1, 2], got
        assert a.ctl_stats["poke_dedup"] == 2, a.ctl_stats
        assert a.ctl_stats["batches"] == 1, a.ctl_stats
        q.put(None)                          # retire the sender
        t.join(5)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_sim_gbps_paces_frame_sends(pkg):
    """btl_tcp_sim_gbps floors a frame's send wall time at nbytes / rate;
    0 (the default) adds nothing: the reference's test, through both."""
    var = importlib.import_module(f"{pkg}.mca.var")
    kv = {}
    got = threading.Event()
    payload = b"x" * (1 << 20)                 # 1 MB

    var.var_register("btl", "tcp", "sim_gbps", vtype="float",
                     default=0.0)
    var.var_set("btl_tcp_sim_gbps", 0.1)       # 100 MB/s -> >= 10 ms
    try:
        a = _pair(pkg, kv, 0, lambda h, p: None)
        b = _pair(pkg, kv, 1, lambda h, p: got.set())
        try:
            assert a._sim_bps == 0.1e9
            t0 = time.perf_counter()
            a.send_frame(1, {"kind": "bulk"}, payload)
            sent_s = time.perf_counter() - t0
            assert got.wait(10)
            assert sent_s >= len(payload) / 0.1e9 * 0.9, sent_s
        finally:
            a.close()
            b.close()
    finally:
        var.var_set("btl_tcp_sim_gbps", 0.0)
    # default-off endpoints carry no pacing state
    c = _pair(pkg, {}, 0, lambda h, p: None)
    try:
        assert c._sim_bps == 0.0
    finally:
        c.close()
