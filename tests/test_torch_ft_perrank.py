"""The port's resilience and telemetry drills as per-rank CPU jobs: the
mirrors of ``tests/test_ft_multiproc.py`` (one ``test_ft_<class>_recovers``
per fault class, the kill drill with the zero-copy plane armed, the
detector's false-positive contract), ``tests/test_telemetry_multiproc.py``
(the straggler drill and the flight recorder under a kill) and the
programs ``p17`` and ``p34``–``p39`` and ``p41`` of
``tests/perrank_programs/``.

Each program is the reference program's body on the port's API, with the
same ranks, faults, inputs and asserted values; each job runs on CPU
ranks under its own limit (the launcher's ``--timeout`` and a kill of the
whole process group). The kill drills run the launcher with
``--enable-recovery``, so the survivors outlive the victim and the job's
exit code is the victim's, as the reference's launcher reports it. The
telemetry drills hand the port's dumps to the reference's ``mpitop`` and
``tracedump``, which must reach the verdicts they reach on the
reference's own dumps. ``p17`` also runs on the reference's launcher, and
the two jobs' survivors must print the same recovered sums.
"""
import glob
import json
import os
import signal
import subprocess
import sys
import textwrap

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MPIRUN = os.path.join(_REPO, "ompi_tpu_torch", "tools", "mpirun.py")
REF_MPIRUN = os.path.join(_REPO, "ompi_tpu", "tools", "mpirun.py")
JOB_LIMIT = 55                   # each job's own limit, in seconds

HEADER = """\
import os
import sys
import time
OUT = sys.argv[1]
{env}
import numpy as np
import ompi_tpu_torch as MPI
from ompi_tpu_torch.api import mpi as api
from ompi_tpu_torch.ft import inject
from ompi_tpu_torch.mca import pvar, var
"""


def _env_lines(env):
    return "\n".join(
        f"os.environ.setdefault('OMPI_TPU_TORCH_MCA_{k}', {str(v)!r})"
        for k, v in env.items())


def run_drill(tmp_path, name, body, n, env=None, recovery=False,
              launcher=PORT_MPIRUN, header=None):
    """Launch ``body`` on ``n`` CPU ranks with its MCA ``env``; returns
    (rc, stdout, stderr). Every process of the job is killed at the
    end, whatever happened."""
    prog = tmp_path / f"{name}.py"
    head = header if header is not None else \
        HEADER.format(env=_env_lines(env or {}))
    prog.write_text(head + textwrap.dedent(body))
    cmd = [sys.executable, launcher, "--per-rank", "-n", str(n),
           "--timeout", str(JOB_LIMIT - 5)]
    if launcher == PORT_MPIRUN:
        cmd += ["--mca", "mpi_base_device", "cpu"]
        if recovery:
            cmd.append("--enable-recovery")
    cmd += [str(prog), str(tmp_path)]
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


# -- the fault classes (p35-p39) ---------------------------------------------
P35_DROP = """
    MPI.Init()
    world = MPI.get_comm_world()
    r, n = world.rank(), world.size
    other = 1 - r
    world.barrier()                  # arm after wire-up traffic settled
    var.var_set("mpi_base_ft_inject", True)
    var.var_set("mpi_base_ft_inject_drop", f"plane=pml,peer={other},count=1")
    inject.refresh()
    assert inject.active
    world.send(np.full(1024, 1.0 + r), other, tag=1)  # swallowed
    time.sleep(0.3)
    world.send(np.full(1024, 2.0 + r), other, tag=2)  # must still arrive
    req = world.irecv(source=other, tag=2)
    req.wait(timeout=30)
    assert np.allclose(req.get(), 2.0 + other), req.get()
    assert inject.stats["drop"] == 1, inject.stats
    assert world.get_failed() == [], world.get_failed()
    world.send(np.full(8, 3.0), other, tag=3)   # no hole: still in order
    req = world.irecv(source=other, tag=3)
    req.wait(timeout=30)
    assert np.allclose(req.get(), 3.0)
    world.barrier()
    MPI.Finalize()
    print(f"OK p35_ftdrop rank={r}/{n}", flush=True)
"""


def test_ft_drop_recovers(tmp_path):
    """A dropped (pre-stamp) frame is lost without a reorder hole or a
    death report; the channel keeps sequencing."""
    _assert_ok(run_drill(tmp_path, "p35", P35_DROP, 2), "OK p35_ftdrop", 2)


P36_DELAY = """
    MPI.Init()
    world = MPI.get_comm_world()
    r, n = world.rank(), world.size
    world.barrier()
    if r == 0:
        var.var_set("mpi_base_ft_inject", True)
        var.var_set("mpi_base_ft_inject_delay",
                    "rank=0,plane=tcp,peer=1,ms=600,count=1")
        inject.refresh()
        t0 = time.monotonic()
        world.send(np.full(64, 7.0), 1, tag=7)     # held 0.6 s on its way
        req = world.irecv(source=1, tag=8)
        req.wait(timeout=30)
        rtt = time.monotonic() - t0
        assert np.allclose(req.get(), 8.0), req.get()
        assert rtt >= 0.6 * 0.66, rtt               # the delay held it
        assert inject.stats["delay"] == 1, inject.stats
    else:
        req = world.irecv(source=0, tag=7)
        req.wait(timeout=30)
        assert np.allclose(req.get(), 7.0), req.get()
        world.send(np.full(64, 8.0), 0, tag=8)
    assert world.get_failed() == [], world.get_failed()
    world.barrier()
    MPI.Finalize()
    print(f"OK p36_ftdelay rank={r}/{n}", flush=True)
"""


def test_ft_delay_recovers(tmp_path):
    """A delayed frame arrives late — nothing lost, nobody declared."""
    _assert_ok(run_drill(tmp_path, "p36", P36_DELAY, 2), "OK p36_ftdelay", 2)


P37_CORRUPT = """
    MPI.Init()
    world = MPI.get_comm_world()
    r, n = world.rank(), world.size
    world.barrier()
    if r == 0:
        var.var_set("mpi_base_ft_inject", True)
        var.var_set("mpi_base_ft_inject_corrupt", "rank=0,peer=1,count=1")
        inject.refresh()
        world.send(np.full(16, 3.0), 1, tag=3)
        world.send(np.full(16, 4.0), 1, tag=4)
        assert inject.stats["corrupt"] == 1, inject.stats
    else:
        for tag in (3, 4):           # nothing sequenced was lost
            req = world.irecv(source=0, tag=tag)
            req.wait(timeout=30)
            assert np.allclose(req.get(), float(tag)), req.get()
    assert world.get_failed() == [], world.get_failed()
    world.barrier()                  # both directions of the link work
    MPI.Finalize()
    print(f"OK p37_ftcorrupt rank={r}/{n}", flush=True)
"""


def test_ft_corrupt_recovers(tmp_path):
    """A corrupted stream costs one reconnect: the receiver drops the
    connection without a death report and no sequenced frame is lost."""
    _assert_ok(run_drill(tmp_path, "p37", P37_CORRUPT, 2),
               "OK p37_ftcorrupt", 2)


P38_SEVER = """
    MPI.Init()
    world = MPI.get_comm_world()
    r, n = world.rank(), world.size
    done = os.path.join(OUT, "p38_recovered")
    world.barrier()                  # identified connections first
    if r == 0:
        var.var_set("mpi_base_ft_inject", True)
        var.var_set("mpi_base_ft_inject_sever", "rank=0,peer=1,count=1")
        inject.refresh()
        world.send(np.full(8, 9.0), 1, tag=9)      # sever fires on this send
        assert inject.stats["sever"] == 1, inject.stats
        # stay alive through the survivor's whole recovery: the cut, not
        # an exit, is what rank 1 observed
        deadline = time.monotonic() + 30
        while not os.path.exists(done):
            assert time.monotonic() < deadline, "rank 1 never recovered"
            time.sleep(0.05)
        print(f"OK p38_ftsever rank={r}/{n}", flush=True)
        os._exit(0)                  # partitioned: no fini fence to join
    deadline = time.monotonic() + 10
    while world.get_failed() != [0]:
        assert time.monotonic() < deadline, world.get_failed()
        time.sleep(0.05)
    t0 = time.monotonic()
    req = world.irecv(source=0, tag=50)
    try:
        req.wait(timeout=30)
        raise SystemExit("receive from a partitioned peer did not error")
    except MPI.MPIError as e:
        assert e.error_class == MPI.ERR_PROC_FAILED, e
        assert time.monotonic() - t0 < 5           # fast-fail, no hang
    shrunk = world.shrink()
    assert shrunk.size == 1, shrunk.size
    total = shrunk.allreduce(np.array([1.0]))
    assert total[0] == 1.0, total
    shrunk.free()
    MPI.Finalize()
    print(f"OK p38_ftsever rank={r}/{n}", flush=True)
    open(done, "w").close()
"""


def test_ft_sever_recovers(tmp_path):
    """An injected RST reads exactly like a death at the survivor: the
    full ULFM path (ERR_PROC_FAILED, get_failed, shrink) runs against a
    peer that is still alive — a network partition drill."""
    _assert_ok(run_drill(tmp_path, "p38", P38_SEVER, 2), "OK p38_ftsever", 2)


P39_FALSEPOS = """
    MPI.Init()
    world = MPI.get_comm_world()
    r, n = world.rank(), world.size
    det = world.router.detector
    assert det is not None, "the heartbeat detector should be on"
    world.barrier()
    if r == 0:
        # stall the next tcp frame to rank 1 — with both ranks idle that
        # is a heartbeat, sent from the detector thread, so the whole
        # beat stream pauses 1.8 s
        var.var_set("mpi_base_ft_inject", True)
        var.var_set("mpi_base_ft_inject_delay",
                    "rank=0,plane=tcp,peer=1,ms=1800,count=1")
        inject.refresh()
        time.sleep(5)
    else:
        suspected = False
        end = time.monotonic() + 5
        while time.monotonic() < end:
            suspected = suspected or det.stats["suspects"] == 1
            time.sleep(0.02)
        assert suspected, "the delay never crossed the suspicion threshold"
        assert det.stats["suspects"] == 0, det.stats    # cleared
        assert det.stats["declared"] == 0, det.stats
        assert det.stats["heartbeats"] > 5, det.stats
    assert world.get_failed() == [], world.get_failed()
    world.send(np.full(8, float(r)), 1 - r, tag=6)
    req = world.irecv(source=1 - r, tag=6)
    req.wait(timeout=30)
    assert np.allclose(req.get(), float(1 - r)), req.get()
    world.barrier()
    MPI.Finalize()
    print(f"OK p39_ftfalsepos rank={r}/{n}", flush=True)
"""


def test_ft_detector_false_positive_under_timeout(tmp_path):
    """The hysteresis contract across processes: a heartbeat stream
    stalled past the timeout but inside the miss window raises a
    suspicion that clears — the delayed rank is never declared."""
    _assert_ok(run_drill(tmp_path, "p39", P39_FALSEPOS, 2, env={
        "mpi_base_ft_hb_period": 0.2, "mpi_base_ft_hb_timeout": 1.0,
        "mpi_base_ft_hb_miss": 8}), "OK p39_ftfalsepos", 2)


# -- the kill drill (p34) ------------------------------------------------------
P34_ENV = {"mpi_base_ft_hb_period": 0.1, "mpi_base_ft_hb_timeout": 0.8,
           "mpi_base_ft_hb_miss": 3, "mpi_base_ft_inject": 1,
           "mpi_base_ft_inject_kill": "rank=2,point=coll.allreduce,hit=2"}

P34_KILL = """
    from ompi_tpu_torch.models.transformer import BucketedGradSync
    _HB_TIMEOUT = 0.8
    MPI.Init()
    world = MPI.get_comm_world()
    r, n = world.rank(), world.size
    assert n == 4, n
    victim = 2
    from ompi_tpu_torch.accelerator import job_tag
    print("TAG", job_tag(), flush=True)
    api.Comm_set_errhandler(world, MPI.ERRORS_RETURN)
    world.barrier()                  # identified connections all around
    if var.var_get("mpi_base_shm_zerocopy", False):
        # every rank, the victim too, maps a zero-copy pool
        world.send(np.full(1 << 14, float(r)), (r + 1) % n, tag=40)
        got, _ = world.recv(source=(r - 1) % n, tag=40)
        assert np.allclose(got, float((r - 1) % n))
    # -- healthy phase: gradient sync and one full-world collective -----
    grads = {"w": np.full(4, float(r)), "b": np.full(2, float(r))}
    sync = BucketedGradSync(world, grads)
    g1 = sync(grads)                 # persistent path: no allreduce point
    assert np.allclose(g1["w"], 1.5), g1
    x1 = world.allreduce(np.arange(4.0))      # the victim's point, hit 1
    assert np.allclose(x1, np.arange(4.0) * n), x1
    # -- the fault: the victim exits entering its 2nd allreduce ---------
    t_in = time.monotonic()
    try:
        api.Allreduce(world, np.ones(4))      # the victim's point, hit 2
        raise SystemExit("allreduce over a dead rank did not error")
    except MPI.MPIError as e:
        assert e.error_class == MPI.ERR_PROC_FAILED, e
    err_s = time.monotonic() - t_in
    deadline = time.monotonic() + 10
    while world.get_failed() != [victim]:
        assert time.monotonic() < deadline, world.get_failed()
        time.sleep(0.05)
    # -- revoke propagates from one revoker to every survivor -----------
    # the revoker waits until every survivor has taken its error: a
    # revoke that overtook a slow survivor's allreduce would turn its
    # error into ERR_REVOKED
    if r == 0:
        for peer in range(1, n):
            if peer != victim:
                world.recv(source=peer, tag=77)
        MPI.MPIX_Comm_revoke(world)
    else:
        world.send(np.zeros(1), 0, tag=77)
    deadline = time.monotonic() + 10
    while not MPI.MPIX_Comm_is_revoked(world):
        assert time.monotonic() < deadline, "revoke did not propagate"
        time.sleep(0.02)
    try:
        world.barrier()
        raise SystemExit("a collective on a revoked comm did not error")
    except MPI.MPIError as e:
        assert e.error_class == MPI.ERR_REVOKED, e
    assert MPI.MPIX_Comm_agree(world, 0b11 if r else 0b10) == 0b10
    # -- shrink: survivors agree and rebuild through coll selection -----
    shrunk = MPI.MPIX_Comm_shrink(world)
    assert shrunk.size == n - 1, shrunk.size
    sr = shrunk.rank()
    assert sr == {0: 0, 1: 1, 3: 2}[r], (r, sr)
    y = shrunk.allreduce(np.full(3, float(r)))
    assert np.allclose(y, np.full(3, 4.0)), y   # 0 + 1 + 3
    # -- elastic continuation: the synchronizer rebinds and rescales ----
    sync.shrink(shrunk)
    g2 = sync(grads)
    assert np.allclose(g2["w"], 4.0 / 3.0), g2
    assert np.allclose(g2["b"], 4.0 / 3.0), g2
    # detection within 2x the heartbeat timeout: every survivor's error,
    # and the latency pvar of the victim's ring successor (rank 3), the
    # one survivor that heard its beats — the others' pvar counts from
    # their detector's start (ROADMAP queue C)
    lat = pvar.pvar_read("ft_detect_latency_us")
    assert err_s < 2 * _HB_TIMEOUT, err_s
    assert 0 <= lat and (r != 3 or lat < 2 * _HB_TIMEOUT * 1e6), lat
    shrunk.barrier()
    shrunk.free()
    MPI.Finalize()
    print(f"OK p34_ftdrill rank={r}/{n} detect_us={lat}", flush=True)
"""


def test_ft_kill_recovers(tmp_path):
    """Rank 2 exits (137) at its 2nd allreduce; the survivors get
    ERR_PROC_FAILED (no hang), revoke propagates from one revoker, agree
    and shrink give a 3-rank comm whose allreduce is the numpy sum,
    BucketedGradSync resumes on the survivors, and every survivor learns
    of the death within 2x the heartbeat timeout. The job's rc is the
    victim's."""
    _assert_ok(run_drill(tmp_path, "p34", P34_KILL, 4, env=P34_ENV,
                         recovery=True), "OK p34_ftdrill", 3, rc=137)


def test_ft_kill_no_shmseg_orphans(tmp_path):
    """The kill drill with the zero-copy segment plane armed: every rank,
    the victim included, maps a ``/dev/shm`` pool before the kill, and
    the launcher's sweep leaves none of the job's files behind."""
    env = dict(P34_ENV, mpi_base_shm_zerocopy=1,
               mpi_base_shm_seg_min_bytes=16)
    rc, out, err = run_drill(tmp_path, "p34z", P34_KILL, 4, env=env,
                             recovery=True)
    _assert_ok((rc, out, err), "OK p34_ftdrill", 3, rc=137)
    from ompi_tpu_torch.accelerator import SHM_DIR
    tags = {line.split()[1] for line in out.splitlines()
            if line.startswith("TAG ") and len(line.split()) == 2}
    assert len(tags) == 1, out
    tag = tags.pop()
    assert not glob.glob(os.path.join(SHM_DIR, f"otpt*_{tag}_*")), \
        "a killed rank leaked /dev/shm files past the sweep"


# -- p17: ULFM over a real process death, in both packages ---------------------
P17_BODY = """
    world = MPI.get_comm_world()
    r, n = world.rank(), world.size
    victim = n - 1
    world.barrier()
    if r == victim:
        os._exit(17)                 # no Finalize: the real failure mode
    req = world.irecv(source=victim, tag=99)
    try:
        req.wait(timeout=30)
        raise SystemExit("a pending receive from a dead peer did not error")
    except MPI.MPIError as e:
        assert "died" in str(e) or "failed" in str(e), e
    assert world.get_failed() == [victim], world.get_failed()
    t0 = time.monotonic()
    try:
        world.recv(source=victim, tag=5)
        raise SystemExit("a new receive from a dead peer did not error")
    except MPI.MPIError:
        assert time.monotonic() - t0 < 5
    shrunk = world.shrink()
    assert shrunk.size == n - 1 and shrunk.rank() == r
    total = shrunk.allreduce(np.array([1.0 + r]))
    shrunk.barrier()
    shrunk.free()
    MPI.Finalize()
    print(f"OK p17 rank={r}/{n} total={float(total[0])}", flush=True)
    if r == 0:
        # rank 0 hosts the reference's coordination service: it must
        # outlive the other survivor, whose client dies with it (p34)
        time.sleep(3)
    os._exit(0)
"""

REF_HEADER = """\
import os
import sys
import time
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import ompi_tpu as MPI
MPI.Init()
"""


def test_p17_ulfm_real_death_matches_the_reference(tmp_path):
    """The victim exits mid-run; the survivors' pending receive completes
    in error, a new one fails fast, and the shrunk comm's allreduce gives
    the same sum in both packages' jobs."""
    port = run_drill(tmp_path, "p17", "MPI.Init()\n" + textwrap.dedent(
        P17_BODY), 3, recovery=True)
    ref = run_drill(tmp_path, "p17ref", P17_BODY, 3, launcher=REF_MPIRUN,
                    header=REF_HEADER)
    for res in (port, ref):
        _assert_ok(res, "OK p17", 2, rc=17)

    def sums(out):
        return sorted(line.split()[-1] for line in out.splitlines()
                      if line.startswith("OK p17"))
    assert sums(port[1]) == sums(ref[1]) == ["total=3.0", "total=3.0"]


# -- the telemetry drills (p41, p34 with the flight recorder) ------------------
P41_STRAGGLER = """
    from ompi_tpu_torch import telemetry
    from ompi_tpu_torch.telemetry import health
    SLOW = 1
    MPI.Init()
    world = MPI.get_comm_world()
    r, n = world.rank(), world.size
    assert n == 4, n
    assert telemetry.active          # the env gate armed the plane
    world.barrier()
    for rnd in range(6):
        for peer in range(n):
            if peer != r:
                world.send(np.full(16, float(r)), peer, tag=100 + rnd)
        for peer in range(n):
            if peer != r:
                data, st = world.recv(source=peer, tag=100 + rnd)
                assert np.allclose(data, float(peer)), (peer, data)
        x = world.allreduce(np.full(8, 1.0))
        assert np.allclose(x, float(n)), x
    mon = health.monitor()
    assert mon is not None
    if r != SLOW:
        deadline = time.monotonic() + 20
        while SLOW not in mon.declared():
            assert time.monotonic() < deadline, (mon.scores(),
                                                 mon.declared())
            mon.sample()
            time.sleep(0.05)
    else:
        assert inject.stats["delay"] > 0, inject.stats
    telemetry.dump(os.path.join(OUT, f"telemetry_{r}.json"), rank=r)
    assert world.get_failed() == [], world.get_failed()   # slow != dead
    world.barrier()
    MPI.Finalize()
    print(f"OK p41_straggler rank={r}/{n}", flush=True)
"""


def _load(paths):
    return [json.loads(open(p).read()) for p in paths]


def test_telemetry_straggler_drill_names_rank1(tmp_path):
    """4 ranks, a 200 ms injected pml delay on every frame rank 1 sends:
    every healthy rank's monitor declares it, the port's mpitop (and the
    reference's beside it, with the same summary) elects it slow_rank from
    the port's dumps with a visible p99, and the flight-recorder merge
    names it the critical rank."""
    env = {"mpi_base_telemetry": 1, "mpi_base_telemetry_sample_s": 0.1,
           "mpi_base_telemetry_window_s": 10,
           "mpi_base_telemetry_straggler_score": 0.02,
           "mpi_base_telemetry_straggler_miss": 2,
           "mpi_base_telemetry_flightrec_dir": str(tmp_path),
           "mpi_base_ft_hb_period": 0.1, "mpi_base_ft_hb_timeout": 3.0,
           "mpi_base_ft_inject": 1,
           "mpi_base_ft_inject_delay": "rank=1,plane=pml,ms=200,count=-1"}
    _assert_ok(run_drill(tmp_path, "p41", P41_STRAGGLER, 4, env=env),
               "OK p41_straggler", 4)
    files = sorted(glob.glob(str(tmp_path / "telemetry_*.json")))
    assert len(files) == 4, files
    from ompi_tpu.tools import mpitop as r_mpitop
    from ompi_tpu_torch.tools import mpitop
    snaps, skipped = mpitop.load_snapshots(files)
    assert not skipped, skipped
    summary = mpitop.summarize(snaps)
    assert summary == r_mpitop.summarize(r_mpitop.load_snapshots(files)[0])
    assert summary["slow_rank"] == 1, summary
    assert summary["declared"].get("1", 0) >= 3, summary["declared"]
    row1 = [r for r in summary["rows"] if r["rank"] == 1][0]
    assert max(row1["send_p99_us"], row1["coll_p99_us"]) >= 5e4, row1
    table = mpitop.render_table(summary)
    assert "STRAGGLER" in table and "slow_rank: 1" in table, table
    from ompi_tpu_torch.telemetry import flightrec
    frecs = sorted(glob.glob(str(tmp_path / "flightrec_*.json")))
    assert frecs, list(tmp_path.iterdir())
    report = flightrec.merge(_load(frecs))
    assert report["critical_rank"] == 1, report
    assert report["accusations"].get("1", 0) >= 1, report
    assert any(t["trigger"] == "straggler" for t in report["triggers"])


def test_telemetry_flightrec_on_kill(tmp_path):
    """The kill drill with telemetry armed: the survivors' proc-failed
    triggers write parseable snapshots (atomic under the kill), and the
    port's ``tracedump --format flightrec`` (and the reference's beside
    it, with the same report) merges the port's files into an incident
    report naming rank 2 critical and absent."""
    env = dict(P34_ENV, mpi_base_telemetry=1,
               mpi_base_telemetry_flightrec_dir=str(tmp_path))
    _assert_ok(run_drill(tmp_path, "p34t", P34_KILL, 4, env=env,
                         recovery=True), "OK p34_ftdrill", 3, rc=137)
    frecs = sorted(glob.glob(str(tmp_path / "flightrec_*.json")))
    assert frecs, list(tmp_path.iterdir())
    payloads = _load(frecs)          # a json error here = a torn file
    assert all(p.get("flightrec") == 1 for p in payloads)
    assert 2 not in {p["rank"] for p in payloads}   # the victim never wrote
    assert any(p["trigger"] == "proc_failed" and
               p["detail"].get("rank") == 2 for p in payloads), payloads
    from ompi_tpu.tools import tracedump as r_tracedump
    from ompi_tpu_torch.tools import tracedump
    out = tmp_path / "incident.json"
    assert tracedump.main(["--format", "flightrec", "-o", str(out)]
                          + frecs) == 0
    report = json.loads(out.read_text())
    ref_out = tmp_path / "incident_ref.json"
    assert r_tracedump.main(["--format", "flightrec", "-o", str(ref_out)]
                            + frecs) == 0
    assert json.loads(ref_out.read_text()) == report
    assert report["incident"] == 1 and report["critical_rank"] == 2
    assert report.get("critical_absent") is True, report
    assert report["accusations"].get("2", 0) >= 1, report


@pytest.mark.parametrize("tier", ["host", "device"])
def test_revoke_flushes_pending_operations(tmp_path, tier):
    """A revoke from one rank completes every pending operation of the
    others with ERR_REVOKED — a named receive, a wildcard, and a blocked
    collective on the host tier or the device tier (CPU tensors)."""
    body = f"""
    import torch
    MPI.Init()
    w = MPI.get_comm_world()
    r, n = w.rank(), w.size
    w.barrier()
    if r == 0:
        time.sleep(0.5)              # the others are blocked by then
        w.revoke()
    else:
        req = w.irecv(source=0, tag=1)
        wild = w.irecv(tag=2)
        try:
            if {tier!r} == "device":
                w.allreduce(torch.ones(1 << 12))   # rank 0 never joins
            else:
                w.barrier()
            raise SystemExit("a blocked collective survived the revoke")
        except MPI.MPIError as e:
            assert e.error_class == MPI.ERR_REVOKED, e
        for q in (req, wild):
            try:
                q.wait(timeout=10)
                raise SystemExit("a pending receive survived the revoke")
            except MPI.MPIError as e:
                assert e.error_class == MPI.ERR_REVOKED, e
    assert w.is_revoked()
    s = w.shrink()                   # the recovery surface still works
    assert s.size == n and s.allreduce(np.ones(2))[0] == n
    s.free()
    MPI.Finalize()
    print(f"OK revoke rank={{r}}", flush=True)
    """
    _assert_ok(run_drill(tmp_path, f"rv_{tier}", body, 3), "OK revoke", 3)
