"""The multi-controller world across hosts: a controller tier whose
members share no memory crosses through host memory over its tcp plane.

Controllers on other hosts cannot map each other's device slots (CUDA
IPC, or shared-memory segments on the CPU), so a communicator's tier
uses its slots only when every member sits on one host
(``RankCommunicator._slots_ok``, from the host identities of the bml's
modex), and otherwise runs the same bodies staged: each payload copied
off the device once, the bytes each member owes shipped raw over the
hidden channel, the allreduce folding the same chunks in the same rank
order as the slots do. A job emulates a second host on this machine:
the controller on "host B" gives itself another host identity
(``btl/bml._host_identity``) and its own shared-memory directory
(``accelerator.framework.SHM_DIR``) before ``Init``, so it really cannot
open host A's segments, nor host A its.

Jobs, each run once per test run and shared by the xdist workers through
a lock file, each under its own 60 s limit:

- the port's 2 + 1 controllers (hosts {0, 1} and {2}; rows 2, 1, 2): the
  5-rank world spans hosts (staged), the split over controllers 0 and 1
  spans controllers on one host (slots);
- the port's 1 + 1 controllers on two hosts (rows 2, 2);
- the reference's two-controller job (rows 3, 2) on the same seeded
  inputs: its world of 5 and its sub-communicators of ranks 0-2 and 0-3.

Held here: each collective (allreduce SUM f32, MAX f32, SUM i32 and
MINLOC; bcast, allgather, alltoall; forced ring allreduce and Bruck
allgather; the nbc iallreduce; a bucketed pair) against an n-row
single-controller comm made in the controller process, bit for bit
where the association is the same (the direct float sum folds each
controller's rows and then the controllers' partials, so it and the
bucket's fused sum are held within the collectives row's tolerance
there, and the bucket bit for bit against its unfused calls), and
against the reference's job within the collectives row's tolerance; the
gate's symmetry; ``ship_rows``'s bytes against ``counts``; no host
staging across hosts; the tier's address. In process, three members of
one tier run every staged body against its slot body on the same
inputs, bit for bit, and a staged read of a failed member raises
``ERR_PROC_FAILED``. The tcp endpoint's address choice is unit-tested.
"""
import fcntl
import json
import os
import socket
import struct
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_multictl import run_controllers
from test_torch_multictl_planes import run_reference
from test_torch_multictl_sched import REF_HEADER

JOB_LIMIT = 60                   # seconds a job may take, kill included

# the seeded inputs and the calls, alike in the tests and both packages
DATA_SRC = '''
import zlib
CASES = ("allreduce|f32_sum", "allreduce|f32_max", "allreduce|i32_sum",
         "allreduce|minloc", "bcast|f32", "allgather|f32", "alltoall|f32",
         "allreduce|ring", "allgather|bruck", "iallreduce|nbc")
FORCED = {"allreduce|ring": ("allreduce", "ring"),
          "allgather|bruck": ("allgather", "bruck")}


def case_data(case, m):
    rng = np.random.default_rng(zlib.crc32(f"multihost|{case}|{m}".encode()))
    if case == "allreduce|minloc":
        # (value, index) records, with ties for the index to break
        val = rng.integers(0, 4, (m, 5)).astype(np.float32)
        idx = np.broadcast_to(np.arange(m, dtype=np.float32)[:, None],
                              (m, 5))
        return np.ascontiguousarray(np.stack([val, idx], -1))
    shape = (m, m, 7) if case.startswith("alltoall") else (m, 7)
    if "i32" in case:
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def bucket_data(k, m):
    rng = np.random.default_rng(zlib.crc32(f"multihost|bucket|{k}|{m}"
                                           .encode()))
    return rng.standard_normal((m, 5 + k)).astype(np.float32)


def call_case(comm, case):
    m = comm.size
    x = comm.put(case_data(case, m))
    func, what = case.split("|")
    if case in FORCED:
        var.var_set(PREFIX + func + "_algorithm", FORCED[case][1])
        try:
            return getattr(comm, func)(
                *((x, MPI.SUM) if func == "allreduce" else (x,)))
        finally:
            var.var_set(PREFIX + func + "_algorithm", "auto")
    if func == "iallreduce":
        req = comm.iallreduce(x, MPI.SUM)
        req.wait()
        return req.get()
    if func == "allreduce":
        op = {"f32_sum": MPI.SUM, "i32_sum": MPI.SUM, "f32_max": MPI.MAX,
              "minloc": MPI.MINLOC}[what]
        return comm.allreduce(x, op)
    if func == "bcast":
        return comm.bcast(x, m - 1)
    return getattr(comm, func)(x)


def bucketed(comm):
    """Two iallreduces fused by the bucket, then the same calls unfused."""
    m = comm.size
    xs = [comm.put(bucket_data(k, m)) for k in range(2)]
    var.var_set("mpi_base_bucket", True)
    try:
        reqs = [comm.iallreduce(x, MPI.SUM) for x in xs]
        MPI.Waitall(reqs)
        fused = [r.get() for r in reqs]
    finally:
        var.var_set("mpi_base_bucket", False)
    return fused, [comm.allreduce(x, MPI.SUM) for x in xs]
'''
_NS = {"np": np}
exec(DATA_SRC, _NS)
CASES, case_data = _NS["CASES"], _NS["case_data"]
# the direct float sum folds each controller's rows, then the partials:
# not the single-controller comm's association
ASSOCIATION = ("allreduce|f32_sum",)

PORT_HEADER = """\
import json
import os
import sys
import numpy as np
import torch
import ompi_tpu_torch as MPI
from ompi_tpu_torch.accelerator import framework
from ompi_tpu_torch.btl import bml
from ompi_tpu_torch.coll.tuned import stage_min_for
from ompi_tpu_torch.core import multictl, rankcomm
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.runtime import init as _init
OUT = sys.argv[1]
TAG = "port"
PREFIX = "coll_torch_"
ME = int(os.environ["OMPI_TPU_TORCH_MCA_mpi_base_process_id"])
ROWS = int(os.environ["OMPI_TPU_TORCH_MCA_mpi_base_num_ranks"])
if HOSTS[ME]:
    # another host: its own identity and shared-memory directory, so it
    # cannot open the other host's segments, nor they its
    _ident = f"{bml._host_identity()}/host{HOSTS[ME]}"
    bml._host_identity = lambda: _ident
    framework.SHM_DIR = os.path.join(OUT, f"shm_host{HOSTS[ME]}")
    os.makedirs(framework.SHM_DIR, exist_ok=True)
MPI.Init(devices=["cpu"] * ROWS)


def mine(comm):
    return list(comm._local)
"""

BODY = """
w = MPI.get_comm_world()
n = w.size
res, meta = {}, {"ran": {}, "n": n, "mine": {"w": mine(w)}}


def keep(key, comm, y):
    for r in mine(comm):
        res[f"{key}|{r}"] = np.asarray(comm.shard(y, r))


def run_all(comm, tag):
    for case in CASES:
        try:
            keep(tag + case, comm, call_case(comm, case))
            meta["ran"][tag + case] = "ok"
        except Exception as e:    # noqa: BLE001 - recorded, asserted
            meta["ran"][tag + case] = f"{type(e).__name__}: {e}"
    try:
        fused, plain = bucketed(comm)
        for k in range(2):
            keep(f"{tag}bucket|{k}", comm, fused[k])
            keep(f"{tag}unfused|{k}", comm, plain[k])
        meta["ran"][tag + "bucket"] = "ok"
    except Exception as e:        # noqa: BLE001 - recorded, asserted
        meta["ran"][tag + "bucket"] = f"{type(e).__name__}: {e}"
"""

PORT_BODY = """
colors = [HOSTS[w.controller_of(r)] for r in range(n)]
s = w.split(colors)[mine(w)[0]]
comms = [("w", w)] + ([("s", s)] if s.spans_processes else [])
for tag, c in comms:
    meta["mine"][tag] = mine(c)
    meta["n_" + tag] = c.size
    run_all(c, tag + "|")
    bad = {k: v for k, v in meta["ran"].items() if v != "ok"}
    if bad:
        print(f"failed calls: {bad}", file=sys.stderr, flush=True)
    t = multictl.tier(c.layout)
    meta["gate_" + tag] = t._slots_ok()
    meta["stage_" + tag] = t._stageable(np.zeros(1 << 20, np.float32),
                                        MPI.SUM)
    meta["slots_" + tag] = t._slots is not None
    # the oracle: an m-row single-controller comm in this process, made
    # with the controller table set aside
    saved = multictl._state["ctl"]
    multictl._state["ctl"] = None
    try:
        o = MPI.Communicator(MPI.Group(range(c.size)),
                             [torch.device("cpu")] * c.size, name="oracle")
    finally:
        multictl._state["ctl"] = saved
    rows = mine(c)
    for case in CASES:
        res[f"o|{tag}|{case}"] = np.asarray(call_case(o, case))[rows]
    fused, plain = bucketed(o)
    for k in range(2):
        res[f"o|{tag}|bucket|{k}"] = np.asarray(fused[k])[rows]
    o.free()
from ompi_tpu_torch.btl.tcp import coordinator_facing
meta["stage_min"] = stage_min_for("allreduce")
meta["published"] = _init._state["kv"].get(f"ompi_tpu_torch/btl/{ME}")
meta["facing"] = coordinator_facing(var.var_get("mpi_base_coordinator"))
meta["listen"] = list(
    _init._state["router"].endpoint.tcp._listener.getsockname())
# ship_rows: each controller sends each other one its block of counts
H = len(w.layout.parts)
counts = [[0 if g == d else (g + 2 * d) % 3 + 1 for d in range(H)]
          for g in range(H)]
h = w.layout.h
out = torch.tensor([[h * 1000 + k] * 3 for k in range(sum(counts[h]))],
                   dtype=torch.float32)
b0 = dict(rankcomm.tier_bytes)
got = multictl.ship_rows(w.layout, counts, out)
meta["ship"] = {"counts": counts, "h": h, "row_bytes": 12,
                "out": rankcomm.tier_bytes["out"] - b0["out"],
                "in": rankcomm.tier_bytes["in"] - b0["in"]}
for g, t in enumerate(got):
    if t is not None:
        res[f"ship|{g}"] = t.numpy()
meta["counters"] = dict(rankcomm.counters)
"""

REF_BODY = """
run_all(w, "w|")
for tag, m in (("s3", 3), ("s4", 4)):
    c = w.split([0 if r < m else 1 for r in range(n)])[0]
    meta["mine"][tag] = mine(c)
    if mine(c):
        run_all(c, tag + "|")
"""

FOOTER = """
np.savez(os.path.join(OUT, f"{TAG}{ME}.npz"), **res)
with open(os.path.join(OUT, f"{TAG}{ME}.json"), "w") as f:
    json.dump(meta, f)
MPI.Finalize()
print(f"MULTIHOST-OK controller={ME}", flush=True)
"""

# name -> (package, rows per controller, host of each controller)
JOBS = {"2p1": ("port", (2, 1, 2), (0, 0, 1)),
        "1p1": ("port", (2, 2), (0, 1)),
        "ref": ("ref", (3, 2), None)}
# the reference's comm of the same size and inputs as each port comm
REF_TAG = {("2p1", "w"): "w", ("2p1", "s"): "s3", ("1p1", "w"): "s4"}
PORT_COMMS = [("2p1", "w"), ("2p1", "s"), ("1p1", "w")]


@pytest.fixture(scope="module")
def job_root(tmp_path_factory):
    """Where the jobs' results live, shared by every worker of the run."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    d = base / "torch_multihost_jobs"
    d.mkdir(exist_ok=True)
    return d


def _write_prog(d, pkg, hosts):
    path = d / "prog.py"
    if pkg == "ref":
        text = (REF_HEADER + "exec(%r)\n" % DATA_SRC
                + textwrap.dedent(BODY) + textwrap.dedent(REF_BODY))
    else:
        text = (f"HOSTS = {list(hosts)!r}\n" + PORT_HEADER
                + "exec(%r)\n" % DATA_SRC + textwrap.dedent(BODY)
                + textwrap.dedent(PORT_BODY))
    path.write_text(text + textwrap.dedent(FOOTER))
    return path


def _run(d, pkg, rows, hosts):
    path = _write_prog(d, pkg, hosts)
    t0 = time.monotonic()
    if pkg == "ref":
        res, left = run_reference(path, rows, d, limit=JOB_LIMIT), []
    else:
        _port, res, left = run_controllers(path, rows, d, limit=JOB_LIMIT)
    (d / "results.json").write_text(json.dumps({
        "results": res, "left": left, "seconds": time.monotonic() - t0}))


def job(job_root, name):
    """Every job runs once per test run, all three at once, started by
    the first worker to take the lock; returns job ``name``'s (arrays,
    meta) per controller and its record."""
    with open(job_root / "jobs.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = []
        for other, (pkg, rows, hosts) in JOBS.items():
            d = job_root / other
            d.mkdir(exist_ok=True)
            if not (d / "results.json").exists():
                todo.append(threading.Thread(target=_run,
                                             args=(d, pkg, rows, hosts)))
        for t in todo:
            t.start()
        for t in todo:
            t.join()
    pkg, rows, _hosts = JOBS[name]
    d = job_root / name
    data = json.loads((d / "results.json").read_text())
    for h, (rc, out, err) in enumerate(data["results"]):
        assert rc == 0 and f"MULTIHOST-OK controller={h}" in out, (
            f"{name}: controller {h} rc={rc}\n--- out\n{out[-2000:]}\n"
            f"--- err\n{err[-3000:]}")
    return [(dict(np.load(d / f"{pkg}{h}.npz")),
             json.loads((d / f"{pkg}{h}.json").read_text()))
            for h in range(len(rows))], data


def _rows(res, key, ranks):
    return np.stack([res[f"{key}|{r}"] for r in ranks])


def _close(got, want, case, what):
    """The collectives row of PERF.md: float SUM within rtol 1e-5 (atol
    1e-5), the rest exact."""
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if ("sum" in case or case.startswith(("iallreduce", "bucket"))
            or case == "allreduce|ring") and got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a).view(np.uint8),
        np.ascontiguousarray(b).view(np.uint8))


def _numpy(case, m):
    x = case_data(case, m)
    if x.dtype == np.float32 and case != "allreduce|minloc":
        x = x.astype(np.float64)
    if case == "allreduce|minloc":
        v = x[..., 0]
        r = np.argmin(v, 0)                   # the lowest rank on a tie
        one = np.stack([v.min(0), r.astype(x.dtype)], -1)
        return np.broadcast_to(one, x.shape)
    if case in ("allreduce|f32_sum", "allreduce|i32_sum", "allreduce|ring",
                "iallreduce|nbc"):
        s = x.sum(0, dtype=x.dtype)
        return np.broadcast_to(s, x.shape)
    if case == "allreduce|f32_max":
        return np.broadcast_to(x.max(0), x.shape)
    if case == "bcast|f32":
        return np.broadcast_to(x[m - 1], x.shape)
    if case.startswith("allgather"):
        return np.broadcast_to(x, (m,) + x.shape)
    return np.swapaxes(x, 0, 1)               # alltoall


# -- the jobs ------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES) + ["bucket|0", "bucket|1"])
@pytest.mark.parametrize("layout,comm", PORT_COMMS)
def test_collective_matches_reference(job_root, layout, comm, case):
    """Each controller's rows against the reference's job, whose comm of
    the same size took the same seeded inputs, within the collectives
    row's tolerance."""
    ctl, _ = job(job_root, layout)
    ref, _ = job(job_root, "ref")
    rtag = REF_TAG[(layout, comm)]
    want = {}
    for res, meta in ref:
        base = case.split("|")[0] if case.startswith("bucket") else case
        if not meta["mine"].get(rtag):
            continue
        assert meta["ran"][f"{rtag}|{base}"] == "ok", meta["ran"]
        for r in meta["mine"][rtag]:
            want[r] = res[f"{rtag}|{case}|{r}"]
    for res, meta in ctl:
        if comm not in meta["mine"]:
            continue
        for r in meta["mine"][comm]:
            got = res[f"{comm}|{case}|{r}"]
            _close(got, want[r].astype(got.dtype), case,
                   f"{layout} {comm} {case} rank {r}")


@pytest.mark.parametrize("case", list(CASES) + ["bucket|0", "bucket|1"])
@pytest.mark.parametrize("layout,comm", PORT_COMMS)
def test_collective_matches_single_controller(job_root, layout, comm,
                                              case):
    """Each controller's rows against the same call on an m-row
    single-controller comm in its process: bit for bit, but for the
    direct float sums (the same association only per controller), which
    are held to the collectives row; and against numpy."""
    ctl, _ = job(job_root, layout)
    for res, meta in ctl:
        if comm not in meta["mine"]:
            continue                      # host B holds no row of it
        ranks = meta["mine"][comm]
        m = meta["n_" + comm]
        base = case.split("|")[0] if case.startswith("bucket") else case
        assert meta["ran"][f"{comm}|{base}"] == "ok", meta["ran"]
        got = _rows(res, f"{comm}|{case}", ranks)
        want = res[f"o|{comm}|{case}"]
        if case in ASSOCIATION or case.startswith("bucket"):
            _close(got, want, case, f"{layout} {comm} {case}")
        else:
            assert _bits(got, want), (layout, comm, case)
        if not case.startswith("bucket"):
            _close(got, np.asarray(_numpy(case, m))[ranks].astype(got.dtype),
                   case, "numpy")


@pytest.mark.parametrize("layout,comm", PORT_COMMS)
def test_bucket_equals_unfused(job_root, layout, comm):
    """The bucket fuses the pair into one flush whose members equal the
    unfused allreduces bit for bit."""
    ctl, _ = job(job_root, layout)
    for res, meta in ctl:
        if comm not in meta["mine"]:
            continue
        ranks = meta["mine"][comm]
        for k in range(2):
            assert _bits(_rows(res, f"{comm}|bucket|{k}", ranks),
                         _rows(res, f"{comm}|unfused|{k}", ranks))


@pytest.mark.parametrize("layout", ["2p1", "1p1"])
def test_gate_is_symmetric(job_root, layout):
    """Every controller of a comm decides its tier alike: staged where
    the comm spans hosts (no slot made), slots where its controllers
    share a host; the staged bodies ran and crossed bytes."""
    ctl, _ = job(job_root, layout)
    assert {meta["gate_w"] for _res, meta in ctl} == {False}
    assert not any(meta["slots_w"] for _res, meta in ctl)
    assert all(meta["counters"]["coll_device_wire"] > 0 for _r, meta in ctl)
    split = [meta for _res, meta in ctl if "s" in meta["mine"]]
    if layout == "2p1":
        assert len(split) == 2
        assert {m["gate_s"] for m in split} == {True}
        assert all(m["slots_s"] and m["counters"]["coll_device"] > 0
                   for m in split)
    else:
        assert not split


@pytest.mark.parametrize("layout", ["2p1", "1p1"])
def test_no_host_staging_across_hosts(job_root, layout):
    """A 4 MiB numpy buffer is staged onto the tier of the same-host
    split (when it reaches the staging floor), never onto the world's
    across hosts."""
    ctl, _ = job(job_root, layout)
    for _res, meta in ctl:
        assert meta["stage_w"] is False
        if "s" in meta["mine"]:
            assert meta["stage_s"] is ((1 << 22) >= meta["stage_min"])


@pytest.mark.parametrize("layout", ["2p1", "1p1"])
def test_ship_rows_ships_what_counts_owes(job_root, layout):
    """``ship_rows`` on the staged world: each controller ships each
    other exactly ``counts[h][d]`` rows and takes ``counts[g][h]``, with
    the rows' contents."""
    ctl, _ = job(job_root, layout)
    for res, meta in ctl:
        sh = meta["ship"]
        counts, h, rb = sh["counts"], sh["h"], sh["row_bytes"]
        H = len(counts)
        assert sh["out"] == rb * sum(counts[h][d] for d in range(H) if d != h)
        assert sh["in"] == rb * sum(counts[g][h] for g in range(H) if g != h)
        for g in range(H):
            if g == h:
                continue
            a = sum(counts[g][:h])
            want = np.repeat(np.arange(a, a + counts[g][h], dtype=np.float32)
                             [:, None] + g * 1000, 3, 1)
            assert np.array_equal(res[f"ship|{g}"], want), (g, h)


@pytest.mark.parametrize("layout", ["2p1", "1p1"])
def test_tier_listens_on_the_coordinator_facing_address(job_root, layout):
    """Each controller's tier listens on, and publishes, the interface
    that faces the coordinator (loopback for these jobs), and the job's
    files are all swept."""
    ctl, data = job(job_root, layout)
    for _res, meta in ctl:
        host, _port = meta["published"].rsplit(":", 1)
        assert host == meta["facing"] == meta["listen"][0]
        assert int(_port) == meta["listen"][1]
    assert data["left"] == []


# -- the address choice -----------------------------------------------------
def _local_ipv4():
    """This host's IPv4 interface addresses (a read-only ioctl each)."""
    out = []
    for _i, name in socket.if_nameindex():
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            try:
                raw = fcntl.ioctl(s.fileno(), 0x8915,      # SIOCGIFADDR
                                   struct.pack("256s", name[:15].encode()))
            except OSError:
                continue
            out.append(socket.inet_ntoa(raw[20:24]))
    return out


@pytest.mark.parametrize("addr", sorted(set(_local_ipv4()) | {"127.0.0.1"}))
def test_coordinator_facing_address(addr):
    """The interface toward a coordinator at one of this host's own
    addresses is that address; a name resolves first."""
    from ompi_tpu_torch.btl.tcp import coordinator_facing
    assert coordinator_facing(f"{addr}:29500") == addr
    if addr == "127.0.0.1":
        assert coordinator_facing("localhost:29500") == addr


@pytest.mark.parametrize("bind", [None] + sorted(set(_local_ipv4())))
def test_tcp_endpoint_binds_and_publishes(bind):
    """The endpoint listens on ``bind`` (loopback by default, the
    per-rank tier's) and publishes it; a peer reaches it there."""
    from ompi_tpu_torch.btl.tcp import TcpEndpoint
    kv = {}
    got = []
    kw = {} if bind is None else {"bind": bind}
    ep = TcpEndpoint(0, 2, kv.__setitem__, kv.__getitem__,
                     lambda h, p: got.append((h, bytes(p))), **kw)
    try:
        host, port = kv["ompi_tpu_torch/btl/0"].rsplit(":", 1)
        assert host == (bind or "127.0.0.1")
        assert ep._listener.getsockname() == (host, int(port))
        peer = TcpEndpoint(1, 2, kv.__setitem__, kv.__getitem__,
                           lambda h, p: None)
        try:
            peer.send_frame(0, {"tag": 1}, b"abc")
            deadline = time.monotonic() + 5
            while not got and time.monotonic() < deadline:
                time.sleep(0.01)
            assert got and got[0][1] == b"abc"
        finally:
            peer.close()
    finally:
        ep.close()


# -- the staged bodies in process ------------------------------------------
class _KV:
    """A blocking in-process KV (the store's role)."""

    def __init__(self):
        self.d = {}
        self.cv = threading.Condition()

    def set(self, k, v):
        with self.cv:
            self.d[k] = v
            self.cv.notify_all()

    def get(self, k):
        with self.cv:
            assert self.cv.wait_for(lambda: k in self.d, timeout=10), k
            return self.d[k]


def _members(n):
    """n members of one tier in this process: their routers (real tcp and
    sm planes) and ``RankCommunicator`` s, and a closer."""
    from ompi_tpu_torch import accelerator
    from ompi_tpu_torch.core.group import Group
    from ompi_tpu_torch.core.rankcomm import RankCommunicator
    from ompi_tpu_torch.mca import var
    from ompi_tpu_torch.pml import perrank
    from ompi_tpu_torch.runtime import ft
    ft._reset_for_tests()
    var._reset_for_tests()
    accelerator.select_for_devices([torch.device("cpu")])
    kv = _KV()
    routers = [None] * n

    def make(r):
        routers[r] = perrank.Router(r, n, kv.set, kv.get, "cpu")
    _par(n, make)
    comms = [RankCommunicator(Group(range(n)), r, routers[r], "cpu",
                              cid=("mh", n)) for r in range(n)]

    def close():
        for c in comms:
            if c._slots is not None:
                c._slots.close()
        for rt in routers:
            rt.close()
        ft._reset_for_tests()
        accelerator.framework._reset_for_tests()
        var._reset_for_tests()
    return comms, close


def _par(n, fn):
    out, errs = [None] * n, []

    def run(r):
        try:
            out[r] = fn(r)
        except BaseException as e:     # noqa: BLE001 - re-raised below
            errs.append(e)
    ts = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    if errs:
        raise errs[0]
    return out


@pytest.fixture(scope="module")
def trio():
    comms, close = _members(3)
    yield comms
    close()


def _inputs(body, r, n):
    rng = np.random.default_rng(100 * r + len(body))
    if body == "minloc":
        v = rng.integers(0, 3, (6,)).astype(np.float32)
        return torch.from_numpy(np.stack([v, np.full(6, r, np.float32)], -1))
    if body == "i32_sum":
        return torch.from_numpy(rng.integers(-99, 99, (29,)).astype(np.int32))
    if body == "alltoall":
        return [torch.from_numpy(rng.standard_normal(4).astype(np.float32))
                for _ in range(n)]
    return torch.from_numpy(rng.standard_normal(1001).astype(np.float32))


def _body(c, body, x):
    from ompi_tpu_torch.core import op as op_mod
    if body in ("f32_sum", "f32_max", "i32_sum", "minloc"):
        op = {"f32_sum": op_mod.SUM, "f32_max": op_mod.MAX,
              "i32_sum": op_mod.SUM, "minloc": op_mod.MINLOC}[body]
        return [c._device_allreduce(x, op)]
    if body == "bcast":
        return [c._device_bcast(x, 1)]
    if body == "allgather":
        return c._device_allgather(x)
    if body == "alltoall":
        return c._device_alltoall(x)
    # a ragged exchange: member r reads r + j elements from member j's
    # payload, starting at j
    n, r = c.size, c.rank()
    want = [(j, j + r + j) for j in range(n)]
    give = [(r, r + j + r) for j in range(n)]
    return c._device_exchange(x, x.numel() * 4, want, give)


BODIES = ("f32_sum", "f32_max", "i32_sum", "minloc", "bcast", "allgather",
          "alltoall", "exchange")


@pytest.mark.parametrize("body", BODIES)
def test_staged_body_equals_slot_body(trio, body):
    """Three members on one host run a body on their slots, then the same
    inputs staged (the gate forced to "another host"): the same bits,
    and the staged allreduce's tier bytes are what it ships and takes."""
    from ompi_tpu_torch.core import rankcomm
    n = len(trio)
    xs = [_inputs(body, r, n) for r in range(n)]
    for c in trio:
        c._one_host = None
    slots = _par(n, lambda r: _body(trio[r], body, xs[r]))
    assert all(c._slots_ok() for c in trio)
    for c in trio:
        c._one_host = False
    w0 = rankcomm.counters["coll_device_wire"]
    staged = _par(n, lambda r: _body(trio[r], body, xs[r]))
    assert rankcomm.counters["coll_device_wire"] > w0
    for r in range(n):
        assert len(slots[r]) == len(staged[r])
        for a, b in zip(slots[r], staged[r]):
            if a is None:
                assert b is None
                continue
            assert a.dtype == b.dtype and a.shape == b.shape
            assert _bits(a.numpy(), b.numpy()), (body, r)
    for c in trio:
        c._one_host = None


def test_staged_allreduce_tier_bytes(trio):
    """Staged, a member ships every chunk but its own and its folded
    chunk to each other member, and takes the same: with 1001 f32 on 3
    members, chunks of 333, 333 and 335 elements."""
    from ompi_tpu_torch.core import op as op_mod
    from ompi_tpu_torch.core import rankcomm
    from ompi_tpu_torch.core.rankcomm import chunk_bounds
    n = len(trio)
    for c in trio:
        c._one_host = False
    before = dict(rankcomm.tier_bytes)
    x = torch.ones(1001)
    _par(n, lambda r: trio[r]._device_allreduce(x, op_mod.SUM))
    b = chunk_bounds(1001, n)
    own = [4 * (b[r + 1] - b[r]) for r in range(n)]
    # the three members share one process's counter
    want = sum((4004 - own[r]) + (n - 1) * own[r] for r in range(n))
    assert rankcomm.tier_bytes["out"] - before["out"] == want
    assert rankcomm.tier_bytes["in"] - before["in"] == want
    for c in trio:
        c._one_host = None


def test_staged_read_of_failed_member_raises():
    """Once a member is in the failure registry, a staged body raises
    ``ERR_PROC_FAILED`` before it waits for that member's bytes, as a
    slot read does."""
    from ompi_tpu_torch.core import op as op_mod
    from ompi_tpu_torch.core.errhandler import ERR_PROC_FAILED, MPIError
    from ompi_tpu_torch.runtime import ft
    comms, close = _members(2)
    try:
        comms[0]._one_host = False
        ft.fail_rank(1, "test")
        t0 = time.monotonic()
        with pytest.raises(MPIError) as e:
            comms[0]._device_allreduce(torch.ones(64), op_mod.SUM)
        assert e.value.error_class == ERR_PROC_FAILED
        assert time.monotonic() - t0 < 5
        with pytest.raises(MPIError) as e:
            comms[0]._device_bcast(torch.ones(64), 1)
        assert e.value.error_class == ERR_PROC_FAILED
    finally:
        close()
