"""The port's OpenSHMEM and MPI-IO across real rank processes: the
mirrors of ``tests/perrank_programs/p14_shmem.py``, ``p20_shmem_ext.py``,
``p21_mpiio.py`` and ``p26_churn.py``, each a 3-rank job under the
port's ``mpirun --per-rank`` on CPU ranks.

Each program is the reference program's body on the port's API, with
the same offsets, inputs and asserted values. Where the reference hands
a numpy origin to a put or a write, the port's programs hand a tensor
in some of the calls, on ``world.device``: a CPU tensor here, a CUDA
tensor when ``chip_smoke.py`` phase 17 runs the same programs (p14, p20,
p21) on the card. Every job has its own
limit (the launcher's ``--timeout`` and a kill of the whole process
group), and no ``otpt*`` file of the job may be left in /dev/shm.
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
import numpy as np
import torch
import ompi_tpu_torch as MPI
from ompi_tpu_torch.accelerator import job_tag
"""


def run_job(tmp_path, name, body, n=3, args=()):
    """Launch ``body`` on ``n`` CPU ranks; returns (rc, stdout, stderr).
    Every process of the job is killed at the end, whatever happened."""
    prog = tmp_path / f"{name}.py"
    prog.write_text(HEADER + textwrap.dedent(body))
    cmd = [sys.executable, MPIRUN, "--per-rank", "-n", str(n),
           "--timeout", str(JOB_LIMIT - 5), "--mca", "mpi_base_device",
           "cpu", str(prog), *args]
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


def _assert_ok(res, marker, want=3):
    code, out, err = res
    assert code == 0, f"rc={code}\n{out}\n{err[-4000:]}"
    assert out.count(marker) == want, f"{out}\n{err[-4000:]}"
    from ompi_tpu_torch.accelerator import SHM_DIR
    tags = {line.split()[1] for line in out.splitlines()
            if line.startswith("TAG ") and len(line.split()) == 2}
    assert len(tags) == 1, out
    left = glob.glob(os.path.join(SHM_DIR, f"otpt*_{tags.pop()}_*"))
    assert not left, left


P14 = """
    from ompi_tpu_torch.shmem.api import CMP_EQ, CMP_GE
    from ompi_tpu_torch.shmem.perrank import ShmemRankCtx

    MPI.Init()
    world = MPI.get_comm_world()
    if world.rank() == 0:
        print("TAG", job_tag(), flush=True)
    with ShmemRankCtx(world, heap_size=64) as ctx:
        me, n = ctx.my_pe(), ctx.n_pes()
        assert me == world.rank() and n == world.size

        data = ctx.malloc(8)        # same offset on every PE (symmetry)
        flag = ctx.malloc(1)
        assert data == 0 and flag == 8

        # ring put (a tensor origin) + flag signal: the neighbour polls
        # its LOCAL heap
        right = (me + 1) % n
        ctx.put(data, torch.full((4,), float(me), device=world.device),
                right)
        ctx.fence()
        ctx.atomic_add(flag, 1.0, right)
        ctx.wait_until(flag, CMP_GE, 1.0)
        got = ctx.get(data, 4, me)          # self-get of what left wrote
        assert np.allclose(got, float((me - 1) % n)), got

        # atomics: shared counter at PE 0
        old = ctx.atomic_fetch_add(16, 1.0, 0)
        ctx.barrier_all()
        assert ctx.atomic_fetch(16, 0) == float(n)

        # collectives through scoll/mpi delegation
        ctx.p(24, float(me * 10), me)
        ctx.barrier_all()
        ctx.broadcast(24, 1, root_pe=1)
        assert ctx.g(24, me) == 10.0
        col = ctx.collect(24, 1)
        assert np.allclose(col, 10.0) and col.size == n
        tot = ctx.reduce(24, 1, MPI.SUM)
        assert tot[0] == 10.0 * n

    MPI.Finalize()
    print(f"OK p14_shmem rank={me}/{n}", flush=True)
"""


def test_p14_shmem(tmp_path):
    """Symmetric offsets, a ring put with a flag signal, a shared
    counter, broadcast, collect and reduce, 3 PEs."""
    _assert_ok(run_job(tmp_path, "p14", P14), "OK p14_shmem")


P20 = """
    from ompi_tpu_torch.shmem.api import CMP_EQ, CMP_NE
    from ompi_tpu_torch.shmem.perrank import ShmemRankCtx

    MPI.Init()
    world = MPI.get_comm_world()
    r, n = world.rank(), world.size
    assert n >= 3, "needs >= 3 PEs"
    if r == 0:
        print("TAG", job_tag(), flush=True)

    ctx = ShmemRankCtx(world, heap_size=256, dtype=np.int64)
    DATA = ctx.malloc(8)      # payload slots
    SIG = ctx.malloc(1)       # signal word
    LOCK = ctx.malloc(1)      # distributed lock word
    CNT = ctx.malloc(1)       # lock-protected counter on PE 0
    FLAGS = [ctx.malloc(1) for _ in range(n)]   # ivar set
    ctx.barrier_all()

    # put_signal: the payload is visible when the signal fires
    if r == 1:
        ctx.put_signal(DATA, torch.arange(8, dtype=torch.int64,
                                          device=world.device) + 100,
                       SIG, 7, pe=0, sig_op=0)
    if r == 0:
        got = ctx.signal_wait_until(SIG, CMP_EQ, 7, timeout=60)
        assert got == 7
        local = ctx.get(DATA, 8, pe=0)
        assert local[0] == 100 and local[7] == 107, local
    ctx.barrier_all()

    # distributed lock: every PE increments the shared counter under
    # mutual exclusion (read-modify-write made safe only by the lock)
    for _ in range(5):
        ctx.set_lock(LOCK, timeout=60)
        cur = int(ctx.g(CNT, pe=0))
        ctx.p(CNT, cur + 1, pe=0)
        ctx.clear_lock(LOCK)
    ctx.barrier_all()
    if r == 0:
        total = int(ctx.g(CNT, pe=0))
        assert total == 5 * n, total

    # ivars: PE 0 waits for ANY flag; the first writer is staggered
    if r == 0:
        winner = ctx.wait_until_any([FLAGS[i] for i in range(1, n)],
                                    CMP_NE, 0, timeout=60)
        assert 0 <= winner < n - 1
        ctx.wait_until_all([FLAGS[i] for i in range(1, n)], CMP_NE, 0,
                           timeout=60)
        some = ctx.test_some([FLAGS[i] for i in range(1, n)], CMP_NE, 0)
        assert some == list(range(n - 1)), some
    else:
        time.sleep(0.05 * r)             # staggered arrivals
        ctx.atomic_set(FLAGS[r], r + 1, pe=0)
    ctx.barrier_all()

    # bitwise atomics on PE 2's heap
    BITS = ctx.malloc(1)
    ctx.barrier_all()
    if r == 2:
        ctx.p(BITS, 0, pe=2)
    ctx.barrier_all()
    ctx.atomic_or(BITS, 1 << r, pe=2)
    ctx.barrier_all()
    if r == 2:
        v = int(ctx.g(BITS, pe=2))
        assert v == (1 << n) - 1, v
        old = int(ctx.atomic_fetch_xor(BITS, 0b1, pe=2))
        assert old == (1 << n) - 1
    ctx.barrier_all()

    assert ctx.pe_accessible(n - 1) and not ctx.pe_accessible(n)
    assert ctx.addr_accessible(BITS, 0)
    assert ctx.info_get_version() == (1, 5)

    ctx.finalize()
    MPI.Finalize()
    print(f"OK p20_shmem_ext rank={r}/{n}", flush=True)
"""


def test_p20_shmem_ext(tmp_path):
    """put_signal gating on asynchronous delivery, a lock that blocks
    across processes, ivars and bitwise atomics on the target's reader
    thread, 3 PEs."""
    _assert_ok(run_job(tmp_path, "p20", P20), "OK p20_shmem_ext")


P21 = """
    from ompi_tpu_torch.io.perrank import RankFile

    MPI.Init()
    world = MPI.get_comm_world()
    r, n = world.rank(), world.size
    if r == 0:
        print("TAG", job_tag(), flush=True)
    path = sys.argv[1]

    with RankFile(world, path, etype=np.float64) as f:
        # independent positioned IO: disjoint blocks of 4 (a tensor)
        f.write_at(r * 4, torch.arange(4, dtype=torch.float64,
                                       device=world.device) + 10 * r)
        f.sync()
        peer = (r + 1) % n
        got = f.read_at(peer * 4, 4)
        assert np.allclose(got, np.arange(4) + 10 * peer), got

        # collective two-phase write: INTERLEAVED singles (rank r owns
        # elements r, n+r, 2n+r ...) — the aggregator coalesces them
        base = 4 * n
        mine = np.array([100.0 * r + k for k in range(3)])
        for k in range(3):
            f.write_at_all(base + k * n + r, mine[k:k + 1])
        f.sync()
        whole = f.read_at(base, 3 * n)
        for k in range(3):
            for who in range(n):
                assert whole[k * n + who] == 100.0 * who + k, (k, who)

        # collective read: one span read at rank 0, scattered
        myrow = f.read_at_all(r * 4, 4)
        assert np.allclose(myrow, np.arange(4) + 10 * r)

        # shared file pointer: concurrent appends claim disjoint regions
        sp_base = base + 3 * n
        f.seek_shared(sp_base)
        start = f.write_shared(torch.full((2 + r,), 1000.0 + r,
                                          dtype=torch.float64,
                                          device=world.device))
        assert start >= sp_base
        f.sync()
        starts = world.allgather(np.int64(start))
        sizes = world.allgather(np.int64(2 + r))
        claimed = sorted((int(s), int(c)) for s, c in zip(starts, sizes))
        total = sum(c for _, c in claimed)
        assert claimed[0][0] == sp_base
        for (a, ca), (b, _cb) in zip(claimed, claimed[1:]):
            assert a + ca == b, claimed
        for s, c in zip(starts, sizes):
            seg = f.read_at(int(s), int(c))
            who = round(seg[0] - 1000.0)
            assert np.allclose(seg, 1000.0 + who) and c == 2 + who

        # ordered IO: rank-ordered regions
        f.seek_shared(sp_base + total)
        pos = f.write_ordered(np.full(r + 1, 7.0 * (r + 1)))
        before = sum(k + 1 for k in range(r))
        assert pos == sp_base + total + before, (pos, before)
        f.sync()
        if r == 0:
            flat = f.read_at(sp_base + total, sum(k + 1 for k in range(n)))
            want = np.concatenate([np.full(k + 1, 7.0 * (k + 1))
                                   for k in range(n)])
            assert np.allclose(flat, want), flat

        # nonblocking positioned IO
        req = f.iwrite_at(0, np.array([-1.0, -2.0]))
        req.wait()
        rreq = f.iread_at(0, 2)
        rreq.wait()
        assert np.allclose(rreq.get(), [-1.0, -2.0])

        assert f.get_size() > 0

    world.barrier()
    if r == 0:
        os.unlink(path)
    MPI.Finalize()
    print(f"OK p21_mpiio rank={r}/{n}", flush=True)
"""


def test_p21_mpiio(tmp_path):
    """Independent, two-phase collective, shared-pointer, ordered and
    nonblocking IO by 3 processes on one file, which rank 0 removes."""
    path = tmp_path / "p21.dat"
    _assert_ok(run_job(tmp_path, "p21", P21, args=(str(path),)),
               "OK p21_mpiio")
    assert not path.exists()


P26 = """
    from ompi_tpu_torch.io.perrank import RankFile
    from ompi_tpu_torch.osc.perrank import RankWindow
    from ompi_tpu_torch.pml import part_perrank as part

    MPI.Init()
    world = MPI.get_comm_world()
    r, n = world.rank(), world.size
    if r == 0:
        print("TAG", job_tag(), flush=True)
    path = sys.argv[1]


    def fd_count() -> int:
        return len(os.listdir("/proc/self/fd"))


    def reg_count() -> int:
        router = world.router
        with router._lock:
            return len(router._engines) + len(router._rma)


    def cycle(i: int) -> None:
        sub = world.dup()
        assert float(np.asarray(sub.allreduce(np.float64(1.0),
                                              MPI.SUM))) == n
        win = RankWindow(sub, 8, dtype=np.float64, name=f"churn{i}")
        win.put(np.array([float(i)]), (r + 1) % n, 0)
        win.fence()
        win.free()
        ps = part.psend_init(sub, [np.array([1.0])], (r + 1) % n,
                             tag=3).start()
        pr = part.precv_init(sub, 1, (r - 1) % n, tag=3).start()
        ps.pready(0)
        pr.wait(timeout=60)
        # one rank-invariant path: the one shared file MPI-IO is about
        f = RankFile(sub, path, etype=np.float64)
        f.write_at(r, np.array([float(r)]))
        f.close()
        f.delete()               # collective unlink w/ error broadcast
        sub.free()


    # warm one full cycle so lazily-created machinery exists before the
    # baseline
    cycle(0)
    world.barrier()
    fd0, reg0 = fd_count(), reg_count()
    for i in range(1, 16):
        cycle(i)
    world.barrier()
    fd1, reg1 = fd_count(), reg_count()
    # bounded: freeing must release engines/windows/files (small slack
    # for lazily-opened shared machinery)
    assert fd1 <= fd0 + 3, (fd0, fd1)
    assert reg1 <= reg0 + 2, (reg0, reg1)

    MPI.Finalize()
    print(f"OK p26_churn rank={r}/{n} fds {fd0}->{fd1} regs {reg0}->{reg1}",
          flush=True)
"""


def test_p26_churn(tmp_path):
    """16 cycles of dup, window, partitioned channel and file create and
    free on 3 ranks: file descriptors and router registrations stay
    bounded."""
    path = tmp_path / "churn.dat"
    _assert_ok(run_job(tmp_path, "p26", P26, args=(str(path),)),
               "OK p26_churn")
    assert not path.exists()
