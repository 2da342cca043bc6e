"""The port's multi-controller world on the CPU: one COMM_WORLD over
several controller processes, launched as the reference's
``tests/test_multiproc.py`` launches it, through the port's ``mpirun
--coordinator host:port --num-hosts H --host-id I``.

Each controller binds its rows on the CPU (``Init(devices=["cpu"] *
L)``), so a 2 x 2 job is a 4-rank world whose collectives cross the
controller tier (the per-rank tier's device slots, shared-memory
segments on the CPU). Covered:

- (a) the launcher's environment, in process, as ``tests/test_aux.py``
  checks the reference's;
- (b) the mirror of ``tests/multiproc_child.py``: every assertion of the
  reference's child on a 2 x 2 world;
- (c) parity with the JAX package: the same seeded numpy inputs through
  the reference's single-controller ``Communicator`` (a sub-communicator
  of the conftest's CPU mesh) and through the port's multi-controller
  jobs of 2 x 2, 3 x 2 and ragged 2 + 1 controllers, for every Standard
  collective and every hier schedule, with SUM, MAX and int32; MAX and
  int32 and data movement exactly, float SUM and scan within rtol 1e-5
  (atol 1e-5); the ``_groups()`` tiers against the reference's for the
  same layouts, and ``auto``'s picks against the reference's multihost
  decision rows;
- (d) the bytes each controller writes into the controller tier
  (``rankcomm.tier_bytes``) on a 2 x 4 world: reductions fold locally
  before they cross, and an allgather ships exactly its own rows;
- (e) the compressed hier allreduce (int8) on 2 x 2 within the
  reference's envelope, bit for bit against the port's single-controller
  ``inner_q`` on the same tiers.

Every job runs once per test run, shared by the xdist workers (a lock
file under the run's temp root); each has its own 60 s limit, after
which the test kills every controller's process group.
"""
import fcntl
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time
import types
import zlib

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MPIRUN = os.path.join(_REPO, "ompi_tpu_torch", "tools", "mpirun.py")
JOB_LIMIT = 60                   # seconds a job may take, kill included

HEADER = """\
import json
import os
import sys
import zlib
import numpy as np
import torch
import ompi_tpu_torch as MPI
from ompi_tpu_torch.mca import var

ME = int(os.environ["OMPI_TPU_TORCH_MCA_mpi_base_process_id"])
ROWS = int(os.environ["OMPI_TPU_TORCH_MCA_mpi_base_num_ranks"])
OUT = sys.argv[1]
"""

# the seeded inputs, made alike by the test and the controllers
DATA_SRC = '''
VARIANTS = {"f32_sum": ("float32", "SUM"), "f32_max": ("float32", "MAX"),
            "i32_sum": ("int32", "SUM")}
WIDE = ("scatter", "alltoall", "reduce_scatter_block")


def nonzero(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 6, shape) * rng.choice([-1, 1], shape)).astype(
        np.float64)


def case_data(func, variant, n):
    dtype, _op = VARIANTS[variant]
    rng = np.random.default_rng(zlib.crc32(f"{func}|{variant}".encode()))
    shape = ((n, n) if func in WIDE else (n,)) + (7,)
    if dtype == "int32":
        return rng.integers(-1000, 1000, size=shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def compressed_data(n):
    return np.random.default_rng(15).standard_normal((n, 4096)).astype(
        np.float32)
'''
exec(DATA_SRC)

REDUCING = ("allreduce", "reduce", "reduce_scatter_block", "scan")
MOVING = ("bcast", "allgather", "gather", "scatter", "alltoall")
HIER = ("allreduce", "bcast", "allgather", "reduce_scatter_block")
STANDARD = REDUCING + MOVING + ("barrier",)


def _cases():
    out = []
    for func in REDUCING + MOVING:
        variants = (("f32_sum", "f32_max", "i32_sum") if func in REDUCING
                    else ("f32_sum", "i32_sum"))
        for v in variants:
            if func == "reduce_scatter_block" and v == "f32_max":
                algs = ("auto",)      # hier rsb is the sum's (demoted)
            else:
                algs = ("auto", "hier") if func in HIER else ("auto",)
            for alg in algs:
                out.append((func, v, alg))
    return out


CASES = _cases()

PARITY_PROG = DATA_SRC + """
CASES = json.loads(%r)
MPI.Init(devices=["cpu"] * ROWS)
w = MPI.get_comm_world()
n = w.size
root = n - 1
dev = w._coll("allreduce").device
# the same n ranks, ordered so that consecutive ranks alternate
# controllers: a fold in controller order is not one in rank order
pos = [sum(1 for q in range(r) if w.controller_of(q) == w.controller_of(r))
       for r in range(n)]
ilv = w.split([0] * n, [pos[r] * n + w.controller_of(r)
                        for r in range(n)])[0]
res = {"ranks": np.asarray(w._local), "ilv|ranks": np.asarray(ilv._local)}
ran = {}
for comm, tag in ((w, ""), (ilv, "ilv|")):
    for func, v, alg in CASES:
        op = getattr(MPI, VARIANTS[v][1])
        x = comm.put(case_data(func, v, n))
        var.var_set(f"coll_torch_{func}_algorithm", alg)
        if func in ("reduce", "bcast", "gather", "scatter"):
            args = (op, root) if func == "reduce" else (root,)
        elif func in ("allreduce", "reduce_scatter_block", "scan"):
            args = (op,)
        else:
            args = ()
        y = getattr(comm, func)(x, *args)
        assert y.local.device == comm.device and y.shape[0] == n
        key = f"{tag}{func}|{v}|{alg}"
        res[key] = y.local.numpy()
        ran[key] = comm._coll(func).selected(
            func, x, op if func in ("allreduce", "reduce",
                                    "reduce_scatter_block", "scan") else None,
            root if func in ("reduce", "bcast", "gather", "scatter") else None)
        var.var_set(f"coll_torch_{func}_algorithm", "auto")
# an elementwise non-commutative op: magnitude of the first operand,
# sign of the last, so a fold's result names its first and last rank
band = MPI.op_create(lambda a, b: torch.abs(a) * torch.sign(b),
                     commute=False)
for comm, tag in ((w, ""), (ilv, "ilv|")):
    x = comm.put(nonzero((n, 6), 3))
    res[f"{tag}noncommute|allreduce"] = comm.allreduce(x, band).local.numpy()
    res[f"{tag}noncommute|scan"] = comm.scan(x, band).local.numpy()
    xw = comm.put(nonzero((n, n, 6), 4))
    res[f"{tag}noncommute|rsb"] = comm.reduce_scatter_block(
        xw, band).local.numpy()
for alg in ("auto", "hier", "direct"):
    var.var_set("coll_torch_barrier_algorithm", alg)
    w.barrier()
    ran[f"barrier|-|{alg}"] = dev.selected("barrier")
var.var_set("coll_torch_barrier_algorithm", "auto")
# the compressed allreduce: hier across equal controllers, and on
# ragged ones each controller's partial crosses as one quantized row
var.var_set("mpi_base_compress", True)
var.var_set("mpi_base_compress_min_bytes", 1024)
cw = w.dup()
xc = cw.put(compressed_data(n))
ran["compressed|allreduce"] = cw._coll("allreduce").selected(
    "allreduce", xc, MPI.SUM)
res["compressed|allreduce"] = cw.allreduce(xc, MPI.SUM).local.numpy()
cw.free()
var.var_set("mpi_base_compress", False)
low, high = dev._groups()
ilv_low = ilv._coll("allreduce").device._groups()[0]
decide = {f"{f}|{b}": dev._algorithm(f, b)
          for f in ("allreduce", "bcast", "allgather", "alltoall", "reduce",
                    "gather", "scatter", "reduce_scatter_block", "scan",
                    "barrier")
          for b in (4, 4096, 1 << 20, 128 << 20)}
np.savez(os.path.join(OUT, f"c{ME}.npz"), **res)
with open(os.path.join(OUT, f"c{ME}.json"), "w") as f:
    json.dump({"ran": ran, "low": low, "high": high, "decide": decide,
               "ilv_low": ilv_low,
               "multihost": dev._multihost(), "n": n}, f)
MPI.Finalize()
print(f"PARITY-OK controller={ME}", flush=True)
""" % json.dumps(CASES)

# the mirror of tests/multiproc_child.py (2 controllers x 2 rows), then
# the compressed hier allreduce (e)
MIRROR_PROG = """
from ompi_tpu_torch.core.errhandler import MPIError
MPI.Init(devices=["cpu"] * ROWS)
world = MPI.get_comm_world()
pi = ME
assert world.size == 4, f"world size {world.size}"
assert world.is_multiprocess
procs = {world.controller_of(r) for r in range(world.size)}
assert procs == {0, 1}, procs
world.set_errhandler(MPI.ERRORS_RETURN)  # the error paths raise

# one allreduce crossing the process boundary
x = world.put(np.arange(4 * 3, dtype=np.float32).reshape(4, 3))
y = world.allreduce(x, MPI.SUM)
expect = np.arange(12, dtype=np.float32).reshape(4, 3).sum(axis=0)
for r in (2 * pi, 2 * pi + 1):          # this controller's ranks
    got = world.shard(y, r)
    assert np.allclose(got, expect), (r, got, expect)
# a plain tensor is the global stack every controller passes
yt = world.allreduce(torch.arange(12, dtype=torch.float32).reshape(4, 3),
                     MPI.SUM)
assert np.allclose(world.shard(yt, 2 * pi), expect)
try:                                     # a row the other controller holds
    world.shard(y, 2 * (1 - pi))
except MPIError as e:
    assert e.error_class == MPI.ERR_RANK, e
else:
    raise AssertionError("a remote row was read")

# the hier two-tier path with a genuine second controller
var.var_set("coll_torch_allreduce_algorithm", "hier")
xmod = world.c_coll["allreduce"].device
assert xmod._multihost(), "hier trigger requires multihost"
low, high = xmod._groups()
assert low == [[0, 1], [2, 3]], low     # per-controller groups
assert high == [[0, 2], [1, 3]], high   # cross-controller tier
y2 = world.allreduce(x, MPI.SUM)
assert xmod.selected("allreduce", x, MPI.SUM) == "hier"
var.var_set("coll_torch_allreduce_algorithm", "auto")
got = world.shard(y2, 2 * pi)
assert np.allclose(got, expect), (got, expect)

# hier bcast + reduce_scatter_block across the process boundary: the
# decision row selects hier because the world spans controllers
alg = world.c_coll["allreduce"].device._algorithm("bcast", 4096)
assert alg == "hier", alg
xb = world.put(np.arange(4 * 5, dtype=np.float32).reshape(4, 5))
yb = world.bcast(xb, root=1)
assert np.allclose(world.shard(yb, 2 * pi),
                   np.arange(5, dtype=np.float32) + 5)
xr = world.put(np.ones((4, 4, 3), np.float32))
yr = world.reduce_scatter_block(xr, MPI.SUM)
assert np.allclose(world.shard(yr, 2 * pi), 4.0)

# no silent wrong answers: stacked pt2pt, RMA and SHMEM raise the
# single-controller guard
for fn in (lambda: world.send(np.zeros(2), 0, 1),
           lambda: world.recv(0, dst=1),
           lambda: world.probe(0)):
    try:
        fn()
    except MPIError as e:
        assert "single-controller" in str(e), e
    else:
        raise AssertionError("stacked pt2pt did not guard")
try:
    from ompi_tpu_torch.osc.framework import Win
    Win(world, 8)
except MPIError as e:
    assert "single-controller" in str(e), e
else:
    raise AssertionError("OSC window did not guard")
try:
    from ompi_tpu_torch.shmem.api import ShmemCtx
    ShmemCtx(world, heap_size=16)
except MPIError as e:
    assert "single-controller" in str(e), e
else:
    raise AssertionError("SHMEM ctx did not guard")
for fn in (lambda: world.allgatherv([np.zeros(r + 1) for r in range(4)]),
           lambda: world.alltoallv([[np.zeros(1)] * 4] * 4)):
    try:
        fn()
    except MPIError as e:
        assert "single-controller" in str(e), e
    else:
        raise AssertionError("a v-collective did not guard")

# barrier across controllers + a sub-communicator that spans both
world.barrier()
subs = world.split([r % 2 for r in range(4)])     # {0,2} and {1,3}
sub = subs[2 * pi]                                 # contains a local rank
sx = sub.put(np.full((2, 2), 3.0, np.float32))
sy = sub.allreduce(sx, MPI.SUM)
mine = [r for r in range(sub.size) if sub.controller_of(r) == pi]
assert np.allclose(sub.shard(sy, mine[0]), 6.0)
assert sub.spans_processes
# SHARED and NUMA group ranks by controller: one comm per controller
for kind in (MPI.COMM_TYPE_SHARED, MPI.COMM_TYPE_NUMA):
    st = world.split_type(kind)
    assert st[2 * pi] is st[2 * pi + 1], kind
    assert st[2 * pi].size == 2 and not st[2 * pi].spans_processes, kind
    assert list(st[2 * pi].group.world_ranks) == [2 * pi, 2 * pi + 1], kind
try:                                     # a buffer of another comm's rows
    world.allreduce(sx, MPI.SUM)
except MPIError as e:
    assert e.error_class == MPI.ERR_ARG, e
else:
    raise AssertionError("another comm's buffer was accepted")

# i-collectives complete on the controller tier
req = world.iallreduce(x, MPI.MAX)
req.wait()
assert np.allclose(world.shard(req.get(), 2 * pi), [9, 10, 11])
world.ibarrier().wait()

# persistent plans bind what the one-shot call runs: the multihost row
plan = world.allreduce_init(x, MPI.SUM)
assert plan.plan.algorithm == "hier", plan.plan.algorithm
for _ in range(2):
    plan.start()
    plan.wait()
    assert np.allclose(world.shard(plan.get(), 2 * pi), expect)
bplan = world.bcast_init(xb, 1)
bplan.start()
bplan.wait()
assert np.allclose(world.shard(bplan.get(), 2 * pi),
                   np.arange(5, dtype=np.float32) + 5)

# (e) the compressed hier allreduce: only the chunk that crosses the
# controller tier is quantized
var.var_set("mpi_base_compress", True)
var.var_set("mpi_base_compress_min_bytes", 1024)
cw = world.dup()
xc = np.random.default_rng(13).standard_normal((4, 4096)).astype(
    np.float32)
assert cw._coll("allreduce").selected(
    "allreduce", cw.put(xc), MPI.SUM) == "compressed:int8_block"
yc = cw.allreduce(cw.put(xc), MPI.SUM)
np.save(os.path.join(OUT, f"compressed{ME}.npy"), yc.local.numpy())
xw = np.random.default_rng(14).standard_normal((4, 4, 1024)).astype(
    np.float32)
for func, arg in (("allgather", xc), ("reduce_scatter_block", xw)):
    assert cw._coll(func).selected(func, cw.put(arg), MPI.SUM) == \
        "compressed:int8_block"
    args = (MPI.SUM,) if func == "reduce_scatter_block" else ()
    y = getattr(cw, func)(cw.put(arg), *args)
    np.save(os.path.join(OUT, f"compressed_{func}{ME}.npy"), y.local.numpy())
cw.free()

MPI.Finalize()
print(f"MULTIPROC-OK process={pi}", flush=True)
"""

# (d): bytes each controller writes into the controller tier, 2 x 4
BYTES_PROG = """
from ompi_tpu_torch.core import rankcomm
MPI.Init(devices=["cpu"] * ROWS)
w = MPI.get_comm_world()
n, L = w.size, len(w._local)
S = 1 << 16                              # bytes per rank
rng = np.random.default_rng(5)
x = w.put(rng.standard_normal((n, S // 4)).astype(np.float32))
xw = w.put(rng.standard_normal((n, n, S // 4 // n)).astype(np.float32))


def sent(fn):
    fn()                                  # the slots are grown
    before = dict(rankcomm.tier_bytes)
    fn()
    return {k: rankcomm.tier_bytes[k] - before[k] for k in before}


out = {"S": S, "L": L, "n": n}
for alg in ("direct", "hier"):
    var.var_set("coll_torch_allreduce_algorithm", alg)
    out[f"allreduce_{alg}"] = sent(lambda: w.allreduce(x, MPI.SUM))
    var.var_set("coll_torch_reduce_scatter_block_algorithm", alg)
    out[f"rsb_{alg}"] = sent(lambda: w.reduce_scatter_block(xw, MPI.SUM))
var.var_set("coll_torch_allreduce_algorithm", "auto")
out["reduce"] = sent(lambda: w.reduce(x, MPI.SUM, 0))
out["scan"] = sent(lambda: w.scan(x, MPI.SUM))
out["allgather"] = sent(lambda: w.allgather(x))
out["bcast"] = sent(lambda: w.bcast(x, 5))
with open(os.path.join(OUT, f"bytes{ME}.json"), "w") as f:
    json.dump(out, f)
MPI.Finalize()
print(f"BYTES-OK controller={ME}", flush=True)
"""

JOBS = {
    "mirror_2x2": (MIRROR_PROG, (2, 2)),
    "bytes_2x4": (BYTES_PROG, (4, 4)),
    "parity_2x2": (PARITY_PROG, (2, 2)),
    "parity_3x2": (PARITY_PROG, (2, 2, 2)),
    "parity_2p1": (PARITY_PROG, (2, 1)),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_controllers(prog_path, rows, out_dir, limit=JOB_LIMIT):
    """One controller per entry of ``rows`` (its row count), each
    launched by its own ``mpirun --coordinator``; returns (port, [(rc,
    out, err)], the job's shared-memory files left behind). Every
    controller's process group is killed at the end and the job's files
    are swept, whatever happened (a controller that dies never reaches
    the sweep of ``Finalize``)."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("OMPI_TPU_TORCH_", "JAX_", "XLA_"))}
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for h, n in enumerate(rows):
        cmd = [sys.executable, MPIRUN, "--coordinator",
               f"127.0.0.1:{port}", "--num-hosts", str(len(rows)),
               "--host-id", str(h), "-n", str(n), str(prog_path),
               str(out_dir)]
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=_REPO, start_new_session=True))
    deadline = time.monotonic() + limit
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            out, err = "", f"killed at the job's {limit} s limit"
        outs.append([p, out, err])
    results = []
    for p, out, err in outs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()
        results.append((p.returncode, out, err))
    from ompi_tpu_torch.accelerator import SHM_DIR, tag_for
    from ompi_tpu_torch.tools.mpirun import sweep_shm
    tag = tag_for(f"127.0.0.1:{port}")
    left = sorted(f for f in os.listdir(SHM_DIR)
                  if f.startswith("otpt") and f"_{tag}_" in f)
    sweep_shm(f"127.0.0.1:{port}")
    return port, results, left


@pytest.fixture(scope="module")
def job_root(tmp_path_factory):
    """Where the jobs' results live, shared by every worker of the run."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    d = base / "torch_multictl_jobs"
    d.mkdir(exist_ok=True)
    return d


def job(job_root, name):
    """Run job ``name`` once per test run (the first worker to take its
    lock runs it) and return (directory, [(rc, out, err)] per
    controller)."""
    prog, rows = JOBS[name]
    d = job_root / name
    d.mkdir(exist_ok=True)
    with open(job_root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = d / "results.json"
        if not done.exists():
            path = d / "prog.py"
            path.write_text(HEADER + textwrap.dedent(prog))
            t0 = time.monotonic()
            port, res, left = run_controllers(path, rows, d)
            done.write_text(json.dumps({"results": res, "port": port,
                                        "left": left,
                                        "seconds": time.monotonic() - t0}))
        data = json.loads(done.read_text())
    return d, data["results"]


def job_leftovers(job_root, name) -> list:
    """The shared-memory files job ``name`` left behind (then swept)."""
    return json.loads((job_root / name / "results.json").read_text())["left"]


def _ok(results, marker):
    for h, (rc, out, err) in enumerate(results):
        assert rc == 0, (f"controller {h} rc={rc}\n--- out\n{out}\n"
                         f"--- err\n{err[-3000:]}")
        assert f"{marker}={h}" in out, out


# -- (a) the launcher --------------------------------------------------------
def test_mpirun_env_translation():
    """The mirror of tests/test_aux.py::test_mpirun_env_translation for
    the port's launcher."""
    sys.path.insert(0, os.path.dirname(MPIRUN))
    try:
        from ompi_tpu_torch.tools.mpirun import PREFIX, build_env, parse
    finally:
        sys.path.pop(0)
    args = parse(["-n", "4", "--mca", "coll_base_include", "torch,basic",
                  "--coordinator", "10.0.0.1:1234", "--num-hosts", "2",
                  "--host-id", "1", "prog.py"])
    env = build_env(args, {})
    assert PREFIX == "OMPI_TPU_TORCH_MCA_"
    assert env[PREFIX + "mpi_base_num_ranks"] == "4"
    assert env[PREFIX + "coll_base_include"] == "torch,basic"
    assert env[PREFIX + "mpi_base_distributed"] == "1"
    assert env[PREFIX + "mpi_base_coordinator"] == "10.0.0.1:1234"
    assert env[PREFIX + "mpi_base_num_processes"] == "2"
    assert env[PREFIX + "mpi_base_process_id"] == "1"
    assert args.program == ["prog.py"]
    plain = build_env(parse(["-n", "2", "prog.py"]), {})
    assert PREFIX + "mpi_base_distributed" not in plain


# -- (b) the mirror of tests/multiproc_child.py -----------------------------
def test_two_controller_world(job_root):
    d, results = job(job_root, "mirror_2x2")
    _ok(results, "MULTIPROC-OK process")
    assert job_leftovers(job_root, "mirror_2x2") == []


@pytest.mark.parametrize("kind", ["shared", "numa"])
def test_split_type_keys_by_controller(kind):
    """SHARED colors are the controllers; NUMA colors are the distinct
    (controller, NUMA node) pairs, so node 1 of controller 0 and node 0
    of controller 1 never share a comm."""
    import ompi_tpu_torch as P
    from ompi_tpu_torch.core.communicator import Communicator
    ctl = [0, 0, 1, 1, 1]
    nodes = [1, 0, 0, 1, 1]
    fake = types.SimpleNamespace(
        size=5, controller_of=lambda r: ctl[r],
        devices=[types.SimpleNamespace(type="cpu", index=None, numa_node=k)
                 for k in nodes],
        split=lambda colors, keys=None: list(colors))
    if kind == "shared":
        assert Communicator.split_type(fake, P.COMM_TYPE_SHARED) == ctl
        return
    colors = Communicator.split_type(fake, P.COMM_TYPE_NUMA)
    pairs = list(zip(ctl, nodes))
    for a in range(5):
        for b in range(5):
            assert (colors[a] == colors[b]) == (pairs[a] == pairs[b]), \
                (a, b, colors)


# -- (c) parity with the JAX package -----------------------------------------
LAYOUTS = {"parity_2x2": (2, 2), "parity_3x2": (2, 2, 2),
           "parity_2p1": (2, 1)}


_REF_COMMS = {}


def _ref_comm(world, n):
    """The reference's n-rank single-controller comm (first n devices of
    the conftest's mesh), made once per process."""
    from ompi_tpu.core.group import UNDEFINED
    if n not in _REF_COMMS:
        sub = world.split([0] * n + [UNDEFINED] * (world.size - n))[0]
        assert sub.size == n
        _REF_COMMS[n] = sub
    return _REF_COMMS[n]


def _controller_results(d, rows):
    out = []
    for h in range(len(rows)):
        res = np.load(d / f"c{h}.npz")
        meta = json.loads((d / f"c{h}.json").read_text())
        out.append((res, meta))
    return out


def _ref_run(mpi, comm, func, v, alg, root):
    from ompi_tpu.mca import var as jvar
    op = getattr(mpi, VARIANTS[v][1])
    x = case_data(func, v, comm.size)
    jvar.var_set(f"coll_xla_{func}_algorithm", alg)
    try:
        if func in ("reduce", "bcast", "gather", "scatter"):
            args = (op, root) if func == "reduce" else (root,)
        elif func in ("allreduce", "reduce_scatter_block", "scan"):
            args = (op,)
        else:
            args = ()
        return np.asarray(getattr(comm, func)(comm.put(x), *args))
    finally:
        jvar.var_set(f"coll_xla_{func}_algorithm", "auto")


def _close(got, want, v, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if v == "f32_sum":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=what)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("func", REDUCING + MOVING)
def test_collective_matches_jax(job_root, world, mpi, layout, func):
    """Every case of ``func`` on every controller's local rows against the
    reference's single-controller result for the same ranks."""
    rows = LAYOUTS[layout]
    d, results = job(job_root, layout)
    _ok(results, "PARITY-OK controller")
    n = sum(rows)
    root = n - 1
    ref = _ref_comm(world, n)
    for res, meta in _controller_results(d, rows):
        for tag in ("", "ilv|"):
            ranks = [int(r) for r in res[f"{tag}ranks"]]
            for f, v, alg in CASES:
                if f != func:
                    continue
                key = f"{tag}{f}|{v}|{alg}"
                got = res[key]
                want = _ref_run(mpi, ref, f, v, alg, root)
                if func in ("reduce", "gather"):
                    # root's row is the significant one
                    if root in ranks:
                        _close(got[ranks.index(root)], want[root], v, key)
                    continue
                _close(got, want[ranks], v, key)
                ran = meta["ran"][key]
                if alg == "hier":
                    ragged = len(set(rows)) > 1
                    hier_ok = not (f == "reduce_scatter_block"
                                   and v == "f32_max")
                    assert ran == ("hier" if hier_ok and not ragged
                                   else "direct"), (key, ran)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_noncommutative_folds_in_rank_order(job_root, layout):
    """A non-commutative elementwise op (|a| * sign(b): the fold of ranks
    i..j is |x_i| * sign(x_j)) folds in rank order on the world and on
    the interleaved comm, where controller order is not rank order (on
    2 + 1 the last rank of the controller-ordered concatenation is not
    the last rank); exact against numpy's ordered fold."""
    rows = LAYOUTS[layout]
    d, results = job(job_root, layout)
    _ok(results, "PARITY-OK controller")
    n = sum(rows)
    m, mw = nonzero((n, 6), 3), nonzero((n, n, 6), 4)

    def fold(first, last):
        return np.abs(first) * np.sign(last)
    for res, _meta in _controller_results(d, rows):
        for tag in ("", "ilv|"):
            ranks = [int(r) for r in res[f"{tag}ranks"]]
            for a, r in enumerate(ranks):
                np.testing.assert_array_equal(
                    res[f"{tag}noncommute|allreduce"][a], fold(m[0], m[-1]))
                np.testing.assert_array_equal(
                    res[f"{tag}noncommute|scan"][a], fold(m[0], m[r]))
                np.testing.assert_array_equal(
                    res[f"{tag}noncommute|rsb"][a],
                    fold(mw[0, r], mw[-1, r]))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_barrier_and_tiers_match_jax(job_root, layout):
    """The barrier's schedules ran; ``_groups()`` equals the reference's
    ``_groups()`` for the same controller layout; ``auto``'s picks are
    the reference's decision rows for a multihost comm."""
    from ompi_tpu.coll import decision as jdecision
    from ompi_tpu.coll.xla import XlaCollModule
    rows = LAYOUTS[layout]
    d, results = job(job_root, layout)
    _ok(results, "PARITY-OK controller")
    n = sum(rows)
    procs = [h for h, k in enumerate(rows) for _ in range(k)]
    fake = types.SimpleNamespace(comm=types.SimpleNamespace(
        size=n, devices=[types.SimpleNamespace(process_index=p)
                         for p in procs]))
    low, high = XlaCollModule._groups(fake)
    # the interleaved comm's tiers: its ranks alternate controllers
    order = sorted(range(n), key=lambda r: (
        sum(1 for q in range(r) if procs[q] == procs[r]), procs[r]))
    ilv_fake = types.SimpleNamespace(comm=types.SimpleNamespace(
        size=n, devices=[types.SimpleNamespace(process_index=procs[w])
                         for w in order]))
    ilv_low = XlaCollModule._groups(ilv_fake)[0]
    ragged = len(set(rows)) > 1
    assert (low is None) == ragged
    for _res, meta in _controller_results(d, rows):
        assert meta["multihost"] is True and meta["n"] == n
        assert (meta["low"], meta["high"]) == (low, high)
        assert meta["ilv_low"] == ilv_low, (meta["ilv_low"], ilv_low)
        assert meta["ran"]["barrier|-|hier"] == ("direct" if ragged
                                                else "hier")
        assert meta["ran"]["barrier|-|direct"] == "direct"
        assert meta["ran"]["barrier|-|auto"] == ("direct" if ragged
                                                else "hier")
        for key, got in meta["decide"].items():
            f, b = key.split("|")
            want = jdecision.decide(f, n, int(b), True, None,
                                    platform="cpu")
            assert got == want, (key, got, want)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_compressed_allreduce_matches_jax(job_root, world, mpi, layout):
    """The compressed (int8_block) allreduce on every layout, ragged 2 + 1
    among them, where each controller's partial crosses as one quantized
    row and the reference runs its compressed ring: within the
    reference's envelope (0.02 of the float64 sum's scale), as the
    reference's own compressed allreduce on the same ranks is, within
    twice that of the reference's result, and the same on every row of
    every controller."""
    from ompi_tpu import compress as jcompress
    from ompi_tpu.mca import var as jvar
    rows = LAYOUTS[layout]
    d, results = job(job_root, layout)
    _ok(results, "PARITY-OK controller")
    n = sum(rows)
    xc = compressed_data(n)
    ref = xc.sum(axis=0, dtype=np.float64)
    bound = 0.02 * np.abs(ref).max()
    jcompress._register_vars()
    saved = {k: jvar.var_get(k) for k in ("mpi_base_compress",
                                         "mpi_base_compress_min_bytes")}
    jvar.var_set("mpi_base_compress", True)
    jvar.var_set("mpi_base_compress_min_bytes", 1024)
    try:
        jc = _ref_comm(world, n).dup()
        want = np.asarray(jc.allreduce(jc.put(xc), mpi.SUM))
        jc.free()
    finally:
        for k, v in saved.items():
            jvar.var_set(k, v)
    assert np.abs(want[0] - ref).max() <= bound
    first = None
    for res, meta in _controller_results(d, rows):
        assert meta["ran"]["compressed|allreduce"] == "compressed:int8_block"
        got = res["compressed|allreduce"]
        assert got.shape == (len(res["ranks"]), 4096)
        first = got[0] if first is None else first
        for row in got:
            assert np.array_equal(row.view(np.uint32),
                                  first.view(np.uint32))
        assert np.abs(got[0] - ref).max() <= bound, layout
        assert np.abs(got[0] - want[0]).max() <= 2 * bound, layout


# -- (d) the bytes that cross ------------------------------------------------
def test_reductions_fold_before_they_cross(job_root):
    """Per controller of a 2 x 4 world, the bytes written into the
    controller tier for one call: an allreduce of S bytes per rank,
    direct and hier, writes its one partial and its reduced half (1.5 S,
    at most 2 S; its four rows would be 4 S); reduce_scatter_block, reduce
    and scan likewise write one partial; an allgather writes exactly its
    own rows (4 S); a bcast only from the root's controller."""
    d, results = job(job_root, "bytes_2x4")
    _ok(results, "BYTES-OK controller")
    for h in range(2):
        b = json.loads((d / f"bytes{h}.json").read_text())
        S, L = b["S"], b["L"]
        assert L == 4
        for alg in ("direct", "hier"):
            assert b[f"allreduce_{alg}"]["out"] == S + S // 2, (alg, b)
            assert b[f"allreduce_{alg}"]["out"] <= 2 * S < L * S
            assert b[f"rsb_{alg}"]["out"] == S, (alg, b)
        assert b["reduce"]["out"] == S + S // 2
        assert b["scan"]["out"] == S
        assert b["allgather"]["out"] == L * S
        assert b["allgather"]["in"] == L * S
        assert b["bcast"]["out"] == (S if h == 1 else 0)
        assert b["bcast"]["in"] == (0 if h == 1 else S)


# -- (e) the compressed hier allreduce ---------------------------------------
def test_compressed_hier_allreduce_matches_single_controller(job_root):
    """Within the reference's envelope (0.02 of the result's scale), the
    same on every row, and bit for bit against the port's single-
    controller ``inner_q`` on the same tiers (2-row group sums are
    order-free)."""
    import ompi_tpu_torch as P
    from ompi_tpu_torch.compress import codecs
    d, results = job(job_root, "mirror_2x2")
    _ok(results, "MULTIPROC-OK process")
    xc = np.random.default_rng(13).standard_normal((4, 4096)).astype(
        np.float32)
    ref = xc.sum(axis=0, dtype=np.float64)
    xw = np.random.default_rng(14).standard_normal((4, 4, 1024)).astype(
        np.float32)
    P._reset_for_tests()
    try:
        P.Init(devices=["cpu"] * 4)
        w = P.get_comm_world()
        dev = w.c_coll["allreduce"].device
        low, high = [[0, 1], [2, 3]], [[0, 2], [1, 3]]
        inner = dev._hier_allreduce_inner(
            P.SUM, low, high, (codecs.get_codec("int8_block"), 256))
        single = inner(w.put(xc)).numpy()
        # the single-controller compressed allgather and rsb
        from ompi_tpu_torch.mca import var as pv
        pv.var_set("mpi_base_compress", True)
        pv.var_set("mpi_base_compress_min_bytes", 1024)
        cw = w.dup()
        others = {"allgather": cw.allgather(cw.put(xc)).numpy(),
                  "reduce_scatter_block": cw.reduce_scatter_block(
                      cw.put(xw), P.SUM).numpy()}
    finally:
        P._reset_for_tests()
    for h in range(2):
        got = np.load(d / f"compressed{h}.npy")
        assert got.shape == (2, 4096)
        assert np.abs(got[0] - ref).max() <= 0.02 * np.abs(ref).max()
        assert np.array_equal(got[0], got[1])
        assert np.array_equal(got.view(np.uint32),
                              single[2 * h:2 * h + 2].view(np.uint32))
        # the compressed allgather and reduce_scatter_block carry codes
        # over the tier: the same bits as on one controller
        for func, want in others.items():
            got = np.load(d / f"compressed_{func}{h}.npy")
            assert np.array_equal(got.view(np.uint32),
                                  want[2 * h:2 * h + 2].view(np.uint32)), func
        scale = np.abs(xc).max()
        assert np.abs(others["allgather"][0] - xc).max() <= 0.02 * scale
