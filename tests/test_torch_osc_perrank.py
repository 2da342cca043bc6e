"""The port's one-sided plane across real rank processes: the mirrors of
``tests/perrank_programs/p13_rma.py`` (3 ranks), ``p43_osc.py`` (4
ranks, on osc/shm and on osc/pt2pt) and ``p44_oscft.py`` (the SIGKILL
exposure-epoch drill, 4 ranks) under the port's ``mpirun --per-rank`` on
CPU ranks.

Each program is the reference program's body on the port's API, with
the same ranks, inputs and asserted values; where the reference hands a
numpy origin to a put, the port's programs hand a tensor too (a CPU
tensor here; ``chip_smoke.py`` phase 16 runs the same drills with CUDA
origins on the card). Every job has its own limit (the launcher's
``--timeout`` and a kill of the whole process group).

The kill drill runs the launcher with ``--enable-recovery``, so the
survivors outlive the victim. The job's exit code is the victim's, as
the port's launcher reports a death by signal: ``SystemExit(-9)``, so
the shell sees 256 - 9 = 247, as the reference's launcher does for
``p44``. No ``otptwin`` file of the job may be left in /dev/shm.
"""
import glob
import os
import signal
import subprocess
import sys
import textwrap

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MPIRUN = os.path.join(_REPO, "ompi_tpu_torch", "tools", "mpirun.py")
JOB_LIMIT = 55                   # each job's own limit, in seconds

HEADER = """\
import os
import sys
import time
{env}
import numpy as np
import torch
import ompi_tpu_torch as MPI
from ompi_tpu_torch.accelerator import job_tag
from ompi_tpu_torch.api import mpi as api
from ompi_tpu_torch.mca import pvar
from ompi_tpu_torch.osc.perrank import LOCK_EXCLUSIVE, RankWindow
"""


def run_job(tmp_path, name, body, n, env=None, recovery=False):
    """Launch ``body`` on ``n`` CPU ranks; returns (rc, stdout, stderr).
    Every process of the job is killed at the end, whatever happened."""
    prog = tmp_path / f"{name}.py"
    lines = "\n".join(f"os.environ.setdefault({k!r}, {str(v)!r})"
                      for k, v in (env or {}).items())
    prog.write_text(HEADER.format(env=lines) + textwrap.dedent(body))
    cmd = [sys.executable, MPIRUN, "--per-rank", "-n", str(n),
           "--timeout", str(JOB_LIMIT - 5), "--mca", "mpi_base_device",
           "cpu"]
    if recovery:
        cmd.append("--enable-recovery")
    cmd.append(str(prog))
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("JAX_", "XLA_", "OMPI_TPU_"))}
    proc = subprocess.Popen(cmd, env=base, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=_REPO,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=JOB_LIMIT)
    except subprocess.TimeoutExpired:
        out, err = "", "killed at the test's limit"
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    return proc.returncode, out, err


def _assert_ok(res, marker, want, rc=0):
    code, out, err = res
    assert code == rc, f"rc={code} (want {rc})\n{out}\n{err[-4000:]}"
    assert out.count(marker) == want, f"{out}\n{err[-4000:]}"


def _no_window_files(out):
    from ompi_tpu_torch.accelerator import SHM_DIR
    from ompi_tpu_torch.osc.shm import WIN_PREFIX
    tags = {line.split()[1] for line in out.splitlines()
            if line.startswith("TAG ") and len(line.split()) == 2}
    assert len(tags) == 1, out
    left = glob.glob(os.path.join(SHM_DIR, f"{WIN_PREFIX}_{tags.pop()}_*"))
    assert not left, left


P13 = """
    MPI.Init()
    world = MPI.get_comm_world()
    r, n = world.rank(), world.size
    if r == 0:
        print("TAG", job_tag(), flush=True)
    win = RankWindow(world, 16, np.float32)

    # active-target epoch: everyone puts its rank into slot r of rank 0
    win.fence()
    win.put(torch.tensor([float(r + 1)]), target=0, disp=r)
    win.fence()
    if r == 0:
        assert np.allclose(win.local[:n],
                           np.arange(1, n + 1, dtype=np.float32)), win.local

    # accumulate: everyone adds 1 into slot 8 of rank n-1
    win.fence()
    win.accumulate([1.0], target=n - 1, disp=8, op="sum")
    win.fence()
    if r == n - 1:
        assert win.local[8] == float(n), win.local[8]

    got = win.get(target=0, disp=0, count=n)
    assert np.allclose(got, np.arange(1, n + 1, dtype=np.float32)), got

    old = win.fetch_and_op(1.0, target=0, disp=12, op="sum")
    assert 0.0 <= old < n
    win.fence()
    if r == 0:
        assert win.local[12] == float(n)

    prev = win.compare_and_swap(0.0, float(r + 1), target=0, disp=15)
    wins = world.allreduce(1 if prev == 0.0 else 0, MPI.SUM)
    assert wins == 1, wins

    win.fence()
    for _ in range(3):
        win.lock(1, LOCK_EXCLUSIVE)
        cur = win.get(target=1, disp=3, count=1)[0]
        win.put([cur + 1.0], target=1, disp=3)
        win.unlock(1)
    world.barrier()
    if r == 1:
        assert win.local[3] == float(3 * n), win.local[3]
    win.free()

    # ranks with different window histories agree on the next window id
    sub = world.split(color=r % 2)
    if r % 2 == 0:
        wsub = RankWindow(sub, 4, np.float32)
        wsub.put([float(r + 50)], target=0, disp=0)
        wsub.fence()
        wsub.free()
    w2 = RankWindow(world, 4, np.float32)
    w2.put([float(r)], target=(r + 1) % n, disp=0)
    w2.fence()
    assert w2.local[0] == float((r - 1) % n), w2.local
    w2.free()
    sub.free()

    # asymmetric sizes: the origin checks the TARGET's exposure size, and
    # a target-side failure raises promptly without wedging the link
    w3 = RankWindow(world, 16 if r == 0 else 4, np.float32)
    assert w3.sizes[0] == 16 and all(s == 4 for s in w3.sizes[1:])
    if r == 1:
        w3.put([1.0] * 8, target=0, disp=2)
    try:
        w3.put([1.0], target=1, disp=10)
        raise SystemExit("no bounds error for remote window")
    except MPI.MPIError:
        pass
    w3.fence()
    w3.put([float(r)], target=0, disp=r)
    w3.fence()
    w3.free()
    print(f"OK p13b_asym rank={r}/{n}", flush=True)

    # request-based RMA: completion at remote completion; rget's payload
    # is the fetched array
    w4 = RankWindow(world, 4, np.float64)
    w4.local[:] = 0.0
    w4.fence()
    right = (r + 1) % n
    req = w4.rput(np.array([10.0 + r, 20.0 + r]), right, disp=1)
    req.wait()
    g = w4.rget(right, disp=1, count=2)
    g.wait()
    got = g.get()
    assert got[0] == 10.0 + r and got[1] == 20.0 + r, got
    ra = w4.raccumulate(np.array([0.25, 0.25]), right, disp=1, op="sum")
    ra.wait()
    g2 = w4.rget(right, disp=1, count=2)
    g2.wait()
    assert g2.get()[0] == 10.25 + r, g2.get()
    w4.fence()
    left = (r - 1) % n
    assert w4.local[1] == 10.25 + left, w4.local
    w4.free()
    print(f"OK p13c_request_rma rank={r}/{n}", flush=True)
    MPI.Finalize()
    print(f"OK p13_rma rank={r}/{n}", flush=True)
"""


def test_p13_rma(tmp_path):
    """Put/get/accumulate/fetch_op/CAS against remote windows, fence
    epochs, passive locks, per-comm window ids, asymmetric sizes and the
    request-based calls, 3 ranks."""
    res = run_job(tmp_path, "p13", P13, 3)
    _assert_ok(res, "OK p13_rma", 3)
    assert res[1].count("OK p13c_request_rma") == 3
    _no_window_files(res[1])


P43 = """
    COMP = os.environ["P43_OSC"]
    MPI.Init()
    world = MPI.get_comm_world()
    r, n = world.rank(), world.size
    assert n == 4, n
    if r == 0:
        print("TAG", job_tag(), flush=True)
    nxt, prv = (r + 1) % n, (r - 1) % n

    elems = 1 << 16                      # 256 KB f32 per window
    rng = np.random.default_rng(43)      # same stream on every rank
    full = rng.normal(size=(n, elems)).astype(np.float32)
    origin = torch.from_numpy(full)      # tensor origins: staged to host

    p0 = pvar.pvar_read("osc_puts")
    win = api.Win_allocate(world, elems, np.float32, name="p43",
                           force=COMP)
    assert win.component == COMP, win.component
    win.local[:] = 0.0

    win.fence()
    win.put(origin[r], nxt)
    win.fence()
    assert np.array_equal(win.local, full[prv]), "put ring wrong"

    win.fence()
    view = win.get((r + 2) % n, 0, elems)
    got = np.asarray(view).copy()
    win.fence()
    assert np.array_equal(got, full[(r + 1) % n]), "get ring wrong"
    if COMP == "shm":
        assert not np.asarray(view).flags.owndata, "shm get copied"
    del view

    win.fence()
    win.local[:] = 0.0
    win.fence()
    win.accumulate(full[r], 0, op="sum")
    win.accumulate(origin[r].abs(), 1, op="max")
    win.fence()
    if r == 0:
        ref = full.sum(axis=0, dtype=np.float32)
        assert np.allclose(win.local, ref, rtol=1e-4, atol=1e-4), \\
            "sum fan-in wrong"
    if r == 1:
        ref = np.abs(full).max(axis=0)
        assert np.array_equal(win.local, ref), "max fan-in wrong"
    # every check reads before the passive puts land (the reference's
    # program has no barrier here and races at larger windows)
    world.barrier()

    win.lock(nxt)
    win.put(full[r] * 2.0, nxt)
    win.flush(nxt)
    win.unlock(nxt)
    world.barrier()
    assert np.array_equal(win.local, full[prv] * 2.0), "passive put wrong"

    assert pvar.pvar_read("osc_puts") - p0 >= 2, "osc_puts never counted"
    assert pvar.pvar_read("osc_fences") >= 7, "fences never counted"
    if COMP == "shm":
        assert pvar.pvar_read("osc_windows_shm") >= 1
    else:
        assert pvar.pvar_read("osc_windows_pt2pt") >= 1
    world.barrier()
    win.free()
    print(f"P43 OK rank={r}/{n} comp={COMP}", flush=True)
    MPI.Finalize()
"""


def test_p43_osc_shm(tmp_path):
    """Win_allocate through selection on osc/shm: the fenced put ring,
    the zero-copy get ring, the sum/max fan-in and the passive drill."""
    res = run_job(tmp_path, "p43s", P43, 4, env={"P43_OSC": "shm"})
    _assert_ok(res, "P43 OK", 4)
    _no_window_files(res[1])


def test_p43_osc_pt2pt(tmp_path):
    """The same drill on osc/pt2pt (the acked active-message plane)."""
    _assert_ok(run_job(tmp_path, "p43p", P43, 4,
                       env={"P43_OSC": "pt2pt"}), "P43 OK", 4)


P44_ENV = {"OMPI_TPU_TORCH_MCA_mpi_base_ft_hb_period": 0.1,
           "OMPI_TPU_TORCH_MCA_mpi_base_ft_hb_timeout": 0.8,
           "OMPI_TPU_TORCH_MCA_mpi_base_ft_hb_miss": 3}

P44 = """
    import signal
    MPI.Init()
    world = MPI.get_comm_world()
    r, n = world.rank(), world.size
    assert n == 4, n
    if r == 0:
        print("TAG", job_tag(), flush=True)
    victim = 2
    nxt, prv = (r + 1) % n, (r - 1) % n
    api.Comm_set_errhandler(world, MPI.ERRORS_RETURN)
    world.barrier()

    elems = 1 << 14
    rng = np.random.default_rng(44)
    full = rng.normal(size=(n, elems)).astype(np.float32)

    win = api.Win_allocate(world, elems, np.float32, name="p44",
                           force="shm")
    win.local[:] = 0.0
    win.fence()
    win.put(full[r], nxt)
    win.fence()                          # the epoch stays open
    assert np.array_equal(win.local, full[prv]), "healthy ring wrong"

    if r == victim:
        os.kill(os.getpid(), signal.SIGKILL)   # no unlink, no goodbye

    deadline = time.monotonic() + 15
    while world.get_failed() != [victim]:
        assert time.monotonic() < deadline, world.get_failed()
        time.sleep(0.05)
    try:
        win.fence()
        raise SystemExit("Win_fence over a dead rank did not error")
    except MPI.MPIError as e:
        assert e.error_class == MPI.ERR_PROC_FAILED, e
    try:
        win.put(full[r], victim)
        raise SystemExit("put to a dead rank did not error")
    except MPI.MPIError as e:
        assert e.error_class == MPI.ERR_PROC_FAILED, e
    assert pvar.pvar_read("osc_ft_failed_epochs") >= 1, \\
        "torn epoch never counted"

    if r == 0:
        MPI.MPIX_Comm_revoke(world)
    deadline = time.monotonic() + 10
    while not MPI.MPIX_Comm_is_revoked(world):
        assert time.monotonic() < deadline, "revoke did not propagate"
        time.sleep(0.02)
    try:
        win.free()                       # the completion barrier errors
    except MPI.MPIError:
        pass                             # ... but the segments are gone

    shrunk = MPI.MPIX_Comm_shrink(world)
    n2, sr = shrunk.size, shrunk.rank()
    assert n2 == n - 1, n2
    assert sr == {0: 0, 1: 1, 3: 2}[r], (r, sr)
    full2 = rng.normal(size=(n2, elems)).astype(np.float32)
    win2 = api.Win_allocate(shrunk, elems, np.float32, name="p44b",
                            force="shm")
    win2.local[:] = 0.0
    win2.fence()
    win2.put(full2[sr], (sr + 1) % n2)
    win2.fence()
    assert np.array_equal(win2.local, full2[(sr - 1) % n2]), \\
        "post-shrink ring wrong"
    win2.free()
    shrunk.barrier()
    shrunk.free()
    MPI.Finalize()
    print(f"P44 OK rank={r}/{n}", flush=True)
"""


def test_p44_oscft_exposure_epoch_drill(tmp_path):
    """SIGKILL a rank holding an open exposure epoch: the survivors get
    MPI_ERR_PROC_FAILED from Win_fence and from a put to the dead rank
    (no hang), free reclaims their segments through the failed barrier,
    shrink + Win_allocate carries a verified fenced ring, and the
    launcher's sweep leaves no window segment of the job."""
    res = run_job(tmp_path, "p44", P44, 4, env=P44_ENV, recovery=True)
    _assert_ok(res, "P44 OK", 3, rc=256 - signal.SIGKILL)
    _no_window_files(res[1])
