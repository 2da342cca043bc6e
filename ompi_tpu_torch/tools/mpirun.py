"""``mpirun`` for the port — an argv-translating launcher.

Behavioral spec: the reference's mpirun finds prterun, translates argv and
execs it (``ompi/tools/mpirun/main.c:32-48, 157-180``); the runtime owns
process placement. The port of ``ompi_tpu/tools/mpirun.py``.

- Single-controller (default): ``mpirun -n N prog.py`` sets
  ``OMPI_TPU_TORCH_MCA_mpi_base_num_ranks=N`` and execs ``python prog.py``
  once; ``Init`` binds up to N visible CUDA devices as ranks.
- Per-rank: ``mpirun --per-rank -n N prog.py`` takes the PRRTE daemon's
  role itself: it hosts the job's ``torch.distributed.TCPStore`` (the PMIx
  coordination service; every rank opens a client on it), fork/execs N
  rank processes on this host, waits for all, and returns the first
  failure's exit code, stopping the other ranks at once. With
  ``--enable-recovery`` (PRRTE's option of that name, the ULFM run mode)
  a rank's death does not end the job: the survivors run on, and the
  launcher returns the first failure's exit code once every rank has
  exited. ``--timeout S`` stops the job after S seconds with exit code
  124. After the job, the launcher sweeps the job's ``/dev/shm`` files,
  a killed rank's included.

``--mca k v`` becomes ``OMPI_TPU_TORCH_MCA_<k>=v``, as the reference's
``--mca`` becomes ``OMPI_MCA_*``. Run a CPU job with ``--mca
mpi_base_device cpu``; without it every rank binds
``cuda:(rank % device_count)``.
"""
from __future__ import annotations

import argparse
import datetime
import glob
import os
import signal
import subprocess
import sys
import time

PREFIX = "OMPI_TPU_TORCH_MCA_"
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _with_pkg_path(env: dict) -> dict:
    """The launched program finds the package whatever its cwd (the
    reference's mpirun prepends its libdir the same way)."""
    env = dict(env)
    parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    if _PKG_ROOT not in parts:
        env["PYTHONPATH"] = os.pathsep.join([_PKG_ROOT] + parts)
    return env


def build_env(args, base_env) -> dict:
    env = _with_pkg_path(base_env)
    if args.n:
        env[PREFIX + "mpi_base_num_ranks"] = str(args.n)
    for k, v in args.mca or []:
        env[PREFIX + k] = v
    return env


def parse(argv):
    ap = argparse.ArgumentParser(prog="mpirun (ompi_tpu_torch)")
    ap.add_argument("-n", "-np", type=int, default=0,
                    help="number of ranks (0 = one per CUDA device, or 2 "
                         "with --per-rank)")
    ap.add_argument("--mca", nargs=2, action="append",
                    metavar=("VAR", "VALUE"),
                    help="set an MCA variable (e.g. mpi_base_device cpu)")
    ap.add_argument("--per-rank", action="store_true",
                    help="one OS process per MPI rank")
    ap.add_argument("--timeout", type=float, default=0,
                    help="per-rank mode: stop the job after this many "
                         "seconds (0 = no limit)")
    ap.add_argument("--enable-recovery", action="store_true",
                    help="per-rank mode: a rank's death does not end the "
                         "job; survivors run on (ULFM recovery)")
    ap.add_argument("program", nargs=argparse.REMAINDER,
                    help="program and its args")
    return ap.parse_args(argv)


def _rank_env(args, coord: str, n: int, r: int) -> dict:
    env = _with_pkg_path(os.environ)
    env[PREFIX + "mpi_base_per_rank"] = "1"
    env[PREFIX + "mpi_base_coordinator"] = coord
    env[PREFIX + "mpi_base_num_processes"] = str(n)
    env[PREFIX + "mpi_base_process_id"] = str(r)
    for k, v in args.mca or []:
        env[PREFIX + k] = v
    # IPC handles name whole cudaMalloc blocks of the caching allocator;
    # expandable segments would break that
    env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:False")
    # N ranks share the host's cores: N full-width intra-op thread pools
    # would spin against each other (torchrun pins the same variable)
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1)
                                              // n)))
    return env


def _reap(procs, timeout: float, recovery: bool = False) -> int:
    """Wait for every rank; the first nonzero exit (or the timeout, 124)
    ends the job. With ``recovery`` the survivors of a failure run on:
    the first nonzero exit is returned once every rank has exited."""
    deadline = time.monotonic() + timeout if timeout else None
    live = list(procs)
    first = 0
    while live:
        for p in list(live):
            rc = p.poll()
            if rc is None:
                continue
            live.remove(p)
            if rc != 0:
                if not recovery:
                    return rc
                first = first or rc
        if deadline is not None and time.monotonic() > deadline:
            return 124
        time.sleep(0.02)
    return first


def run_per_rank(args, prog) -> int:
    """Host the store, spawn N rank processes, reap them."""
    from torch.distributed import TCPStore
    n = args.n or 2
    store = TCPStore("127.0.0.1", 0, is_master=True,
                     wait_for_workers=False,
                     timeout=datetime.timedelta(seconds=300))
    coord = f"127.0.0.1:{store.port}"
    procs = [subprocess.Popen(prog, env=_rank_env(args, coord, n, r))
             for r in range(n)]
    try:
        return _reap(procs, args.timeout, args.enable_recovery)
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        _sweep_shm(coord)


def _sweep_shm(coord: str) -> None:
    """Remove the shared-memory files this job's ranks leaked (a killed
    rank never reaches its unlink): the sm rings, the cpu IPC segments,
    the shmseg pools and fold workspaces and the osc/shm window
    segments, named with the job's tag."""
    if _PKG_ROOT not in sys.path:
        sys.path.insert(0, _PKG_ROOT)
    from ompi_tpu_torch.accelerator import SEG_PREFIX, SHM_DIR, tag_for
    from ompi_tpu_torch.btl.shmseg import POOL_PREFIX
    from ompi_tpu_torch.btl.sm import RING_PREFIX
    from ompi_tpu_torch.osc.shm import WIN_PREFIX
    tag = tag_for(coord)
    for prefix in (RING_PREFIX, SEG_PREFIX, POOL_PREFIX, WIN_PREFIX):
        for path in glob.glob(os.path.join(SHM_DIR, f"{prefix}_{tag}_*")):
            try:
                os.unlink(path)
            except OSError:
                pass


def main(argv=None) -> None:
    args = parse(argv if argv is not None else sys.argv[1:])
    if not args.program:
        sys.stderr.write("mpirun: no program given\n")
        raise SystemExit(2)
    prog = args.program
    if prog[0].endswith(".py"):
        prog = [sys.executable] + prog
    if args.per_rank:
        raise SystemExit(run_per_rank(args, prog))
    env = build_env(args, os.environ)
    os.execvpe(prog[0], prog, env)      # exec shim, like mpirun->prterun


if __name__ == "__main__":
    main()
