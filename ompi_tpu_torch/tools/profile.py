"""Communication-profile postprocessing (monitoring_prof + profile2mat);
the port of ``ompi_tpu/tools/profile.py``.

Behavioral spec: the reference's monitoring stack ends in
``monitoring_prof.c`` (an LD_PRELOAD profiler dumping per-peer counts)
and ``profile2mat.pl`` (turning those dumps into a rank x rank matrix
for heat-map tools). Here the counters are already in-process: the
matching engine keeps a per-(src, dest) traffic table and
coll/monitoring keeps per-(comm, func) call/byte counts; this module
renders both as matrices / CSV. The matrices are numpy on the host, as
the reference's are: the counts are host integers whatever device the
payloads lived on.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def pt2pt_matrix(comm, what: str = "bytes") -> np.ndarray:
    """rank x rank matrix of pt2pt traffic on ``comm`` (row = sender,
    column = receiver). ``what`` is 'bytes' or 'messages'."""
    idx = 1 if what == "bytes" else 0
    n = comm.size
    m = np.zeros((n, n), dtype=np.int64)
    # stacked comms: the controller-local engine holds every rank's
    # rows; per-rank comms: THIS process's engine holds its own rows
    # (aggregate across ranks with comm.allgather of the matrix)
    eng = getattr(comm, "_pml_engine", None)
    if eng is None and getattr(comm, "is_per_rank", False):
        eng = comm._pml
    if eng is not None:
        for (src, dest), counts in eng.traffic.items():
            if 0 <= src < n and 0 <= dest < n:
                m[src, dest] += counts[idx]
    return m


def coll_table() -> Dict[Tuple[int, str], Tuple[int, int]]:
    """Per-(comm cid, collective) (calls, bytes) from coll/monitoring."""
    from ompi_tpu_torch.coll import monitoring
    return monitoring.snapshot()


def to_csv(matrix: np.ndarray) -> str:
    """profile2mat output shape: one CSV row per sender."""
    return "\n".join(",".join(str(int(v)) for v in row)
                     for row in np.asarray(matrix))


def report(comm) -> str:
    lines: List[str] = []
    msgs = pt2pt_matrix(comm, "messages")
    if msgs.any():
        lines.append("# pt2pt messages (row=sender)")
        lines.append(to_csv(msgs))
        lines.append("# pt2pt bytes (row=sender)")
        lines.append(to_csv(pt2pt_matrix(comm, "bytes")))
    table = coll_table()
    if table:
        lines.append("# collectives: cid,func,calls,bytes")
        for (cid, func), (calls, nbytes) in sorted(table.items()):
            lines.append(f"{cid},{func},{calls},{nbytes}")
    return "\n".join(lines) if lines else "# no traffic recorded"


def main() -> None:
    import ompi_tpu_torch as MPI
    if not MPI.Initialized():
        MPI.Init()
    print(report(MPI.get_comm_world()))


if __name__ == "__main__":
    main()
