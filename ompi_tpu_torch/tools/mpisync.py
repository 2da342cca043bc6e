"""mpisync — cross-participant clock-offset measurement (the port of
``ompi_tpu/tools/mpisync.py``).

Behavioral spec: ``ompi/tools/mpisync`` (``mpigclock.c``): measure the
clock offset of every rank against rank 0 by ping-pong round trips,
keeping the sample with the smallest RTT (the least contaminated by
network jitter), so traces from different hosts can be aligned.

Design: ranks on one controller share a clock (offset 0 by
construction): the port's single-controller world spans one process, so
every rank of it reads the controller's clock. In a multi-controller
world a rank's process is the controller holding its row
(``comm.controller_of``): the other controllers' ranks are probed
through the caller's ``remote_clocks[controller]``, or reported
unprobed. In the per-rank world each rank is a process:
``sync_report_perrank`` ping-pongs rank 0's clock over pt2pt. The
estimator is the same mpigclock algorithm generalized over any
remote-clock probe: ``measure_offset``
takes a callable returning the remote clock "now" and returns the
(offset, rtt) of the best of N round trips; ``sync_report`` applies it
to every participant of a communicator (remote controllers probed via
the coordination-service KV when distributed, the shared clock
otherwise).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple


def measure_offset(remote_now: Callable[[], float],
                   rounds: int = 10,
                   local_now: Callable[[], float] = time.perf_counter,
                   ) -> Tuple[float, float]:
    """mpigclock's kernel: ``rounds`` ping-pongs; for each, the remote
    clock is sampled between two local samples (t0, t1) and the offset
    estimate is ``remote - (t0 + t1)/2``. The sample with the smallest
    RTT wins. Returns (offset_seconds, best_rtt_seconds)."""
    best_rtt = float("inf")
    best_off = 0.0
    for _ in range(max(rounds, 1)):
        t0 = local_now()
        r = remote_now()
        t1 = local_now()
        rtt = t1 - t0
        if rtt < best_rtt:
            best_rtt = rtt
            best_off = r - (t0 + t1) / 2.0
    return best_off, best_rtt


def sync_report(comm, rounds: int = 10,
                remote_clocks: Dict[int, Callable[[], float]] | None
                = None) -> List[Dict]:
    """Offset of every rank's clock against rank 0 (the mpisync output
    table). Ranks sharing this controller share its clock: offset is 0
    by construction and reported with rtt 0. Remote controllers (ranks
    whose row another controller process holds) are probed through
    ``remote_clocks[controller]`` — a callable returning that
    controller's "now", e.g. a coordination-service KV timestamp
    exchange. Without a probe the rank is reported ``unprobed``
    (offset None) rather than a fabricated zero."""
    from ompi_tpu_torch.core import multictl
    rows: List[Dict] = []
    # a rank's process is the controller that holds its row (the
    # reference's process_index); one controller holds every row of a
    # single-controller world. A comm without a controller table names
    # each device's process_index, as the reference reads it.
    local_proc = multictl.me()
    ctl = getattr(comm, "controller_of", None)
    devices = list(getattr(comm, "devices", []) or [])
    for rank in range(comm.size):
        if ctl is not None:
            proc = ctl(rank)
        else:
            proc = (getattr(devices[rank], "process_index", 0)
                    if rank < len(devices) else 0)
        if proc == local_proc:
            rows.append({"rank": rank, "offset_s": 0.0, "rtt_s": 0.0,
                         "clock": "controller"})
            continue
        probe = (remote_clocks or {}).get(proc)
        if probe is None:
            rows.append({"rank": rank, "offset_s": None, "rtt_s": None,
                         "clock": f"process_{proc} (unprobed)"})
        else:
            off, rtt = measure_offset(probe, rounds)
            rows.append({"rank": rank, "offset_s": off, "rtt_s": rtt,
                         "clock": f"process_{proc}"})
    return rows


def sync_report_perrank(comm, rounds: int = 10):
    """The REAL mpisync in the per-rank world: every rank ping-pongs
    rank 0's clock over pt2pt (one client at a time, mpigclock's
    serialized measurement), keeping the smallest-RTT sample. Probe
    traffic rides a hidden matching channel (never matches user
    receives). Collective over ``comm``; every rank returns the full
    table."""
    import numpy as np

    from ompi_tpu_torch.core.rankcomm import hidden_engine
    eng = hidden_engine(comm, "sync")
    me, n = comm.rank(), comm.size
    mine = (0.0, 0.0) if me == 0 else None
    for r in range(1, n):
        if me == r:
            def remote_now() -> float:
                eng.send(np.float64(0.0), 0, 1)
                t, _ = eng.recv(0, 2)
                return float(np.asarray(t).ravel()[0])
            mine = measure_offset(remote_now, rounds)
        elif me == 0:
            for _ in range(max(rounds, 1)):
                eng.recv(r, 1)
                eng.send(np.float64(time.perf_counter()), r, 2)
        comm.barrier()                   # one client at a time
    rows = comm.allgather(mine)
    return [{"rank": r, "offset_s": float(off), "rtt_s": float(rtt),
             "clock": "rank0" if r == 0 else f"process_{r}"}
            for r, (off, rtt) in enumerate(rows)]


def main() -> None:
    import json

    import ompi_tpu_torch as MPI
    if not MPI.Initialized():
        MPI.Init()
    for row in sync_report(MPI.get_comm_world()):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
