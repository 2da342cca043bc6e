"""Collectives of different communicators across controllers stay apart.

MPI orders collectives per communicator, not across communicators. Two
dups ``A`` and ``B`` of a world whose rows sit in two controller
processes, with controller 0 calling in one order and the other
controllers in the other:

- (a) controller 0 calls ``B.i<func>(2x)`` and then the blocking
  ``A.<func>(x)``; the others call ``A.<func>(x)`` and then
  ``B.i<func>(2x)``;
- (b) controller 0 starts ``A.i<func>(x)`` and then ``B.i<func>(2x)`` and
  waits in that order; the others start and wait in the opposite order.

for allreduce SUM, bcast from the last rank and allgather. Every result
is held equal to the same comm's blocking call of the same input (made
before, in the same order on every controller), never to a fixed value.
Also on the port: a bucketed pair (``mpi_base_bucket`` on) and a
persistent pair (``allreduce_init``, then ``Start`` in opposite orders),
run as (b); a dup freed with a bucketed and an nbc iallreduce pending;
the cid-divergence case (controller 0 alone dups its own
``split_type(COMM_TYPE_SHARED)`` comm, so the next world dups get other
cids there than on controller 1, and (b) runs on them); and the tiers'
lifetime (32 spanning dups made, used once by a nonblocking allreduce and
freed leave no tier, worker thread, slot or shared-memory file).

Jobs: the port's on 2 x 2 and ragged 2 + 1 controllers (CPU rows,
``tests/test_torch_multictl.py::run_controllers``) and the reference's on
2 + 2 devices (``tests/test_torch_multictl_planes.py::run_reference``),
each run once per test run and shared by the xdist workers through a
lock file, each under its own 60 s limit. The reference is held right in
(a); in (b) its nbc mixes the two comms' rounds, so its (b) is run and
recorded, not asserted.
"""
import fcntl
import json
import os
import textwrap
import time

import numpy as np
import pytest

from test_torch_multictl import run_controllers
from test_torch_multictl_planes import run_reference
from test_torch_multictl_sched import REF_HEADER

JOB_LIMIT = 60                   # seconds a job may take, kill included
FUNCS = ("allreduce", "bcast", "allgather")
MODES = ("a", "b")
PORT_CASES = [(m, f) for m in MODES for f in FUNCS]
# the reference's (a) with allgather never returns on controller 1 (its
# iallgather waits on rounds that controller 0's blocking allgather took),
# which would cost the whole job its limit: its job runs the rest
REF_CASES = [c for c in PORT_CASES if c != ("a", "allgather")]
N_DUPS = 32                      # spanning dups of the lifetime check
WAITED = {"one": ["A1", "A2"], "two": ["A1", "B1", "B2"]}   # ORDERS' waits

PORT_HEADER = """\
import json
import os
import sys
import threading
import numpy as np
import ompi_tpu_torch as MPI
from ompi_tpu_torch.accelerator import SHM_DIR
from ompi_tpu_torch.coll import persistent
from ompi_tpu_torch.core import multictl, rankcomm
from ompi_tpu_torch.mca import var
OUT = sys.argv[1]
TAG = "port"
ME = int(os.environ["OMPI_TPU_TORCH_MCA_mpi_base_process_id"])
ROWS = int(os.environ["OMPI_TPU_TORCH_MCA_mpi_base_num_ranks"])
MPI.Init(devices=["cpu"] * ROWS)


def mine(comm):
    return list(comm._local)
"""

# both packages: (a) and (b) on fresh world dups, for each collective
BODY = """
w = MPI.get_comm_world()
n = w.size
res, meta = {}, {"mine": mine(w), "n": n, "ran": {}, "keys": {}}
X = np.arange(n * 7, dtype=np.float32).reshape(n, 7)
FIRST = ME == 0


def call(comm, func, buf, nb):
    f = ("i" if nb else "") + func
    if func == "bcast":
        return getattr(comm, f)(buf, n - 1)
    if func == "allreduce":
        return getattr(comm, f)(buf, MPI.SUM)
    return getattr(comm, f)(buf)


def keep(key, comm, y):
    for r in mine(comm):
        res[f"{key}|{r}"] = np.asarray(comm.shard(y, r))


def pair(tag, A, B, func, mode):
    xa, xb = A.put(X), B.put(2 * X)
    keep(f"{tag}|A|blk", A, call(A, func, xa, False))
    keep(f"{tag}|B|blk", B, call(B, func, xb, False))
    if mode == "a":
        if FIRST:
            rb = call(B, func, xb, True)
            ya = call(A, func, xa, False)
        else:
            ya = call(A, func, xa, False)
            rb = call(B, func, xb, True)
        yb = rb.get()
    elif FIRST:
        ra = call(A, func, xa, True)
        rb = call(B, func, xb, True)
        ya, yb = ra.get(), rb.get()
    else:
        rb = call(B, func, xb, True)
        ra = call(A, func, xa, True)
        yb, ya = rb.get(), ra.get()
    keep(f"{tag}|A|got", A, ya)
    keep(f"{tag}|B|got", B, yb)


def guarded(tag, fn):
    try:
        fn()
        meta["ran"][tag] = "ok"
    except Exception as e:        # noqa: BLE001 - recorded, asserted
        meta["ran"][tag] = f"{type(e).__name__}: {e}"


for mode, func in CASES:
    A, B = w.dup(), w.dup()
    tag = f"{mode}|{func}"
    meta["keys"][tag] = [getattr(c, "_tier_key", None) for c in (A, B)]
    guarded(tag, lambda: pair(tag, A, B, func, mode))
"""

PORT_ONLY = """

def bucketed():
    var.var_set("mpi_base_bucket", True)
    A, B = w.dup(), w.dup()
    meta["keys"]["bucket"] = [getattr(c, "_tier_key", None) for c in (A, B)]
    xa, xb = A.put(X), B.put(2 * X)
    f0 = persistent.counters()["coll_bucket_flushes"]
    order = [("A", A, xa), ("B", B, xb)]
    if not FIRST:
        order.reverse()
    reqs = [(name, c, c.iallreduce(buf, MPI.SUM)) for name, c, buf in order]
    meta["bucket|types"] = [type(r).__name__ for _n, _c, r in reqs]
    for name, c, r in reqs:
        keep(f"bucket|{name}|got", c, r.get())
    meta["bucket|flushes"] = (persistent.counters()["coll_bucket_flushes"]
                              - f0)
    var.var_set("mpi_base_bucket", False)
    keep("bucket|A|blk", A, A.allreduce(xa, MPI.SUM))
    keep("bucket|B|blk", B, B.allreduce(xb, MPI.SUM))


# bucketed iallreduces whose waits sit at other points of the call order
# on controller 0 than on the others (i: start, w: wait): on one comm, and
# on two comms where a wait on A falls between B's starts on controller 0
# only; the members differ in width, so buckets that do not agree on
# their members meet with other sizes
ORDERS = {
    "one": ([("i", "A1"), ("w", "A1"), ("i", "A2"), ("w", "A2")],
            [("i", "A1"), ("i", "A2"), ("w", "A1"), ("w", "A2")]),
    "two": ([("i", "B1"), ("i", "A1"), ("w", "A1"), ("i", "B2"),
             ("w", "B1"), ("w", "B2")],
            [("i", "B1"), ("i", "A1"), ("i", "B2"), ("w", "A1"),
             ("w", "B1"), ("w", "B2")]),
}
DATA = {"A1": X, "A2": 3 * X[:, :5], "B1": 2 * X, "B2": 5 * X[:, :4]}


def bucket_order(tag):
    A, B = w.dup(), w.dup()
    comms = {"A": A, "B": B}
    bufs = {k: comms[k[0]].put(np.ascontiguousarray(v))
            for k, v in DATA.items()}
    reqs, got = {}, {}
    var.var_set("mpi_base_bucket", True)
    try:
        for act, k in ORDERS[tag][0 if FIRST else 1]:
            if act == "i":
                reqs[k] = comms[k[0]].iallreduce(bufs[k], MPI.SUM)
            else:
                got[k] = reqs[k].get()
    finally:
        var.var_set("mpi_base_bucket", False)
    meta[f"order|{tag}|types"] = sorted({type(r).__name__
                                         for r in reqs.values()})
    for k in sorted(got):
        c = comms[k[0]]
        keep(f"order|{tag}|{k}|got", c, got[k])
        keep(f"order|{tag}|{k}|blk", c, c.allreduce(bufs[k], MPI.SUM))


def persistent_pair():
    A, B = w.dup(), w.dup()
    meta["keys"]["persist"] = [getattr(c, "_tier_key", None) for c in (A, B)]
    xa, xb = A.put(X), B.put(2 * X)
    plans = {"A": A.allreduce_init(xa, MPI.SUM),
             "B": B.allreduce_init(xb, MPI.SUM)}
    order = ["A", "B"] if FIRST else ["B", "A"]
    for it in range(2):
        for name in order:
            plans[name].start()
        for name in order:
            plans[name].wait()
        keep(f"persist{it}|A|got", A, plans["A"].get())
        keep(f"persist{it}|B|got", B, plans["B"].get())
    keep("persist|A|blk", A, A.allreduce(xa, MPI.SUM))
    keep("persist|B|blk", B, B.allreduce(xb, MPI.SUM))


def cid_divergence():
    shared = w.split_type(MPI.COMM_TYPE_SHARED)[mine(w)[0]]
    if FIRST:
        own = shared.dup()            # controller 0 alone
        own.allreduce(own.put(np.ones((own.size, 3), np.float32)))
    A, B = w.dup(), w.dup()
    meta["cid|cids"] = [A.cid, B.cid]
    meta["keys"]["cid"] = [getattr(c, "_tier_key", None) for c in (A, B)]
    pair("cid", A, B, "allreduce", "b")


def free_pending():
    var.var_set("mpi_base_bucket", True)
    C = w.dup()
    rb = C.iallreduce(C.put(X), MPI.SUM)          # a bucket member
    var.var_set("mpi_base_bucket", False)
    rn = C.iallreduce(C.put(2 * X), MPI.SUM)      # nbc rounds on the tier
    C.free()
    keep("free|bucket", C, rb.get())
    keep("free|nbc", C, rn.get())


def shm_files():
    return sorted(f for f in os.listdir(SHM_DIR) if f.startswith("otpt")
                  and f"_{os.getpid()}_" in f)


def slots_mapped():
    return sum(1 for s in list(rankcomm._live_slots) if s.buf is not None)


def tier_threads(keys):
    return sorted(t.name for t in threading.enumerate()
                  if any(k in t.name for k in keys))


def lifetime():
    life = {"before": multictl.live(), "files_before": shm_files(),
            "slots_before": slots_mapped()}
    dups = [w.dup() for _ in range(N_DUPS)]
    keys = [getattr(d, "_tier_key", None) or str(d.cid) for d in dups]
    for k, d in enumerate(dups):
        keep(f"life|{k}", d, d.iallreduce(d.put(X + k), MPI.SUM).get())
    life["during"] = multictl.live()
    life["threads_during"] = tier_threads(keys)
    life["slots_during"] = slots_mapped()
    for d in dups:
        d.free()
    life["after"] = multictl.live()
    life["threads_after"] = tier_threads(keys)
    life["files_after"] = shm_files()
    life["slots_after"] = slots_mapped()
    life["distinct_keys"] = len(set(keys))
    meta["life"] = life


N_DUPS = %d
guarded("bucket", bucketed)
guarded("order|one", lambda: bucket_order("one"))
guarded("order|two", lambda: bucket_order("two"))
guarded("persist", persistent_pair)
guarded("cid", cid_divergence)
guarded("free", free_pending)
guarded("life", lifetime)
"""

FOOTER = """
np.savez(os.path.join(OUT, f"{TAG}{ME}.npz"), **res)
with open(os.path.join(OUT, f"{TAG}{ME}.json"), "w") as f:
    json.dump(meta, f)
MPI.Finalize()
print(f"C9-OK controller={ME}", flush=True)
"""

PORT_LAYOUTS = {"2x2": (2, 2), "2p1": (2, 1)}
REF_LAYOUTS = {"2x2": (2, 2)}


@pytest.fixture(scope="module")
def job_root(tmp_path_factory):
    """Where the jobs' results live, shared by every worker of the run."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    d = base / "torch_multictl_c9_jobs"
    d.mkdir(exist_ok=True)
    return d


def job(job_root, pkg, layout):
    """Run ``pkg``'s job on ``layout`` once per test run (the first
    worker to take its lock runs it); returns each controller's (arrays,
    meta)."""
    name = f"{pkg}_{layout}"
    rows = (REF_LAYOUTS if pkg == "ref" else PORT_LAYOUTS)[layout]
    d = job_root / name
    d.mkdir(exist_ok=True)
    with open(job_root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = d / "results.json"
        if not done.exists():
            path = d / "prog.py"
            if pkg == "ref":
                prog = (REF_HEADER + f"CASES = {REF_CASES!r}\n"
                        + textwrap.dedent(BODY))
            else:
                prog = (PORT_HEADER + f"CASES = {PORT_CASES!r}\n"
                        + textwrap.dedent(BODY)
                        + textwrap.dedent(PORT_ONLY) % N_DUPS)
            path.write_text(prog + textwrap.dedent(FOOTER))
            t0 = time.monotonic()
            if pkg == "ref":
                res, left = run_reference(path, rows, d, limit=JOB_LIMIT), []
            else:
                _port, res, left = run_controllers(path, rows, d,
                                                   limit=JOB_LIMIT)
            done.write_text(json.dumps({
                "results": res, "left": left,
                "seconds": time.monotonic() - t0}))
        data = json.loads(done.read_text())
    for h, (rc, out, err) in enumerate(data["results"]):
        assert rc == 0 and f"C9-OK controller={h}" in out, (
            f"{name}: controller {h} rc={rc}\n--- out\n{out[-2000:]}\n"
            f"--- err\n{err[-3000:]}")
    return [(dict(np.load(d / f"{pkg}{h}.npz")),
             json.loads((d / f"{pkg}{h}.json").read_text()))
            for h in range(len(rows))], data["left"]


def _expected(func, x, n):
    """numpy's result of ``func`` on the global ``x`` (exact: integer
    values in float32)."""
    if func == "allreduce":
        return np.broadcast_to(x.sum(0), x.shape)
    if func == "bcast":
        return np.broadcast_to(x[n - 1], x.shape)
    return np.broadcast_to(x, (n,) + x.shape)


def _rows(res, key, ranks):
    return np.stack([res[f"{key}|{r}"] for r in ranks])


def _held(per, tag, funcs=None):
    """On every controller, each comm's result of case ``tag`` equals
    the same comm's blocking call; the blocking calls equal numpy."""
    for res, meta in per:
        n, ranks = meta["n"], meta["mine"]
        x = np.arange(n * 7, dtype=np.float32).reshape(n, 7)
        for comm, scale in (("A", 1), ("B", 2)):
            blk = _rows(res, f"{tag}|{comm}|blk", ranks)
            if funcs is not None:
                want = np.asarray(_expected(funcs, scale * x, n))[ranks]
                np.testing.assert_array_equal(blk, want)
            np.testing.assert_array_equal(
                _rows(res, f"{tag}|{comm}|got", ranks), blk,
                err_msg=f"{tag}: comm {comm} differs from its blocking "
                        f"call on the ranks {ranks}")


def _keys_agree(per, tag):
    keys = [meta["keys"][tag] for _res, meta in per]
    assert all(k == keys[0] for k in keys), keys
    assert keys[0][0] != keys[0][1] and None not in keys[0]


# -- the port -----------------------------------------------------------------
@pytest.mark.parametrize("func", FUNCS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", sorted(PORT_LAYOUTS))
def test_port_pair_equals_blocking(job_root, layout, mode, func):
    """(a) and (b): each comm's result is its own blocking call's, and
    the comms' tier keys agree on every controller and differ."""
    per, _left = job(job_root, "port", layout)
    tag = f"{mode}|{func}"
    for _res, meta in per:
        assert meta["ran"][tag] == "ok", meta["ran"][tag]
    _held(per, tag, func)
    _keys_agree(per, tag)


@pytest.mark.parametrize("layout", sorted(PORT_LAYOUTS))
def test_port_bucketed_pair(job_root, layout):
    """Bucketed iallreduces on two comms, started and waited in
    opposite orders: each fused bucket is its own comm's blocking
    allreduce."""
    per, _left = job(job_root, "port", layout)
    for _res, meta in per:
        assert meta["ran"]["bucket"] == "ok", meta["ran"]["bucket"]
        assert meta["bucket|flushes"] == 2
        assert all(t == "_BucketMemberReq" for t in meta["bucket|types"])
    _held(per, "bucket", "allreduce")
    _keys_agree(per, "bucket")


@pytest.mark.parametrize("tag", ["one", "two"])
@pytest.mark.parametrize("layout", sorted(PORT_LAYOUTS))
def test_port_bucket_wait_points(job_root, layout, tag):
    """Bucketed iallreduces whose waits fall at other points of the
    call order on each controller, on one comm and across two: the
    controllers agree on every bucket's members, so each member is its
    own blocking allreduce, and the blocking ones are numpy's."""
    per, _left = job(job_root, "port", layout)
    for res, meta in per:
        assert meta["ran"][f"order|{tag}"] == "ok", meta["ran"][f"order|{tag}"]
        assert meta[f"order|{tag}|types"] == ["_BucketMemberReq"]
        n, ranks = meta["n"], meta["mine"]
        x = np.arange(n * 7, dtype=np.float32).reshape(n, 7)
        data = {"A1": x, "A2": 3 * x[:, :5], "B1": 2 * x, "B2": 5 * x[:, :4]}
        for k in WAITED[tag]:
            blk = _rows(res, f"order|{tag}|{k}|blk", ranks)
            np.testing.assert_array_equal(
                blk, np.broadcast_to(data[k].sum(0), data[k].shape)[ranks])
            np.testing.assert_array_equal(
                _rows(res, f"order|{tag}|{k}|got", ranks), blk,
                err_msg=f"{tag}: member {k} differs from its blocking call")


@pytest.mark.parametrize("layout", sorted(PORT_LAYOUTS))
def test_port_persistent_pair(job_root, layout):
    """Two comms' allreduce plans started in opposite orders, twice:
    every Start gives its own comm's blocking allreduce."""
    per, _left = job(job_root, "port", layout)
    for _res, meta in per:
        assert meta["ran"]["persist"] == "ok", meta["ran"]["persist"]
    for res, meta in per:
        for it in range(2):
            for comm in ("A", "B"):
                np.testing.assert_array_equal(
                    _rows(res, f"persist{it}|{comm}|got", meta["mine"]),
                    _rows(res, f"persist|{comm}|blk", meta["mine"]))
    _keys_agree(per, "persist")


@pytest.mark.parametrize("layout", sorted(PORT_LAYOUTS))
def test_port_cid_divergence(job_root, layout):
    """Controller 0 alone dups its own shared comm, so the next world
    dups' cids differ between controllers (controller 0's ``A`` has
    controller 1's ``B``'s cid: a tier keyed by cid would pair them);
    the tier keys still agree and (b) gives each comm its own result."""
    per, _left = job(job_root, "port", layout)
    for _res, meta in per:
        assert meta["ran"]["cid"] == "ok", meta["ran"]["cid"]
    cids = [meta["cid|cids"] for _res, meta in per]
    assert cids[0][0] == cids[1][1] and cids[0] != cids[1], cids
    _held(per, "cid", "allreduce")
    _keys_agree(per, "cid")


@pytest.mark.parametrize("layout", sorted(PORT_LAYOUTS))
def test_port_free_completes_pending(job_root, layout):
    """A spanning dup freed with a bucketed iallreduce and an nbc one
    pending: both complete with the right sums (MPI_Comm_free lets
    pending operations finish)."""
    per, _left = job(job_root, "port", layout)
    for res, meta in per:
        assert meta["ran"]["free"] == "ok", meta["ran"]["free"]
        n, ranks = meta["n"], meta["mine"]
        x = np.arange(n * 7, dtype=np.float32).reshape(n, 7)
        for key, scale in (("free|bucket", 1), ("free|nbc", 2)):
            np.testing.assert_array_equal(
                _rows(res, key, ranks),
                np.broadcast_to((scale * x).sum(0), x.shape)[ranks])


@pytest.mark.parametrize("layout", sorted(PORT_LAYOUTS))
def test_port_tiers_freed_with_their_comms(job_root, layout):
    """32 spanning dups, each used once by a nonblocking allreduce, hold
    32 tiers with their workers and slots; after their ``free`` no tier,
    worker thread, mapped slot or shared-memory file of theirs is left,
    and the job leaves no ``otpt*`` file."""
    per, left = job(job_root, "port", layout)
    for res, meta in per:
        assert meta["ran"]["life"] == "ok", meta["ran"]["life"]
        life = meta["life"]
        n, ranks = meta["n"], meta["mine"]
        x = np.arange(n * 7, dtype=np.float32).reshape(n, 7)
        for k in range(N_DUPS):
            np.testing.assert_array_equal(
                _rows(res, f"life|{k}", ranks),
                np.broadcast_to((x + k).sum(0), x.shape)[ranks])
        assert life["distinct_keys"] == N_DUPS
        before, during, after = life["before"], life["during"], life["after"]
        assert during["tiers"] == before["tiers"] + N_DUPS, life
        assert during["workers"] >= before["workers"] + N_DUPS, life
        assert len(life["threads_during"]) == N_DUPS, life
        assert life["slots_during"] >= life["slots_before"] + N_DUPS, life
        assert after == before, life
        assert life["threads_after"] == [], life
        assert life["slots_after"] == life["slots_before"], life
        assert life["files_after"] == life["files_before"], life
    assert left == []


# -- the reference ------------------------------------------------------------
@pytest.mark.parametrize("func", [f for m, f in REF_CASES if m == "a"])
def test_reference_right_in_a(job_root, func):
    """The reference dispatches its nbc rounds at wait, so in (a) the
    blocking call on ``A`` runs first on both controllers: right (its
    allgather does not return there, so its job leaves that case out)."""
    per, _left = job(job_root, "ref", "2x2")
    tag = f"a|{func}"
    for _res, meta in per:
        assert meta["ran"][tag] == "ok", meta["ran"][tag]
    _held(per, tag, func)


@pytest.mark.parametrize("func", FUNCS)
def test_reference_runs_b(job_root, func):
    """The reference's (b) runs to its end with results of the right
    shape on every row; its values mix the two comms' rounds (its nbc
    keys rounds by arrival), so they are recorded, not asserted."""
    per, _left = job(job_root, "ref", "2x2")
    tag = f"b|{func}"
    for res, meta in per:
        assert meta["ran"][tag] == "ok", meta["ran"][tag]
        for comm in ("A", "B"):
            got = _rows(res, f"{tag}|{comm}|got", meta["mine"])
            blk = _rows(res, f"{tag}|{comm}|blk", meta["mine"])
            assert got.shape == blk.shape and np.isfinite(got).all()
