"""MPMD dispatch shim for MPI_Comm_spawn_multiple (the port of
``ompi_tpu/tools/mpmd_exec.py``).

`mpirun --per-rank` launches one executable for every rank; the
reference's spawn_multiple builds a single child world out of
DIFFERENT binaries (dpm_dyn_init / comm_spawn_multiple.c.in). This
shim closes that gap: the spawn root writes a JSON spec
``[{command, argv, maxprocs}, ...]`` and launches ``python -m
ompi_tpu_torch.tools.mpmd_exec spec.json`` for the whole world; each
process looks up its rank (``OMPI_TPU_TORCH_MCA_mpi_base_process_id``,
set by the port's mpirun) and execs the entry owning that rank slice —
env intact, so the child's MPI_Init still dials the parent port
(OMPI_TPU_TORCH_PARENT_PORT) and the usual coordination plane.
"""
from __future__ import annotations

import json
import os
import sys
from typing import List, Optional, Tuple

RANK_VAR = "OMPI_TPU_TORCH_MCA_mpi_base_process_id"


def entry_for(spec: List[dict], rank: int) -> Optional[Tuple[str, list]]:
    """(command, argv) of the spec entry that owns ``rank``: entry i
    owns ranks [sum(maxprocs[:i]), sum(maxprocs[:i+1])). None past the
    spec's total."""
    for ent in spec:
        n = int(ent["maxprocs"])
        if rank < n:
            return ent["command"], list(ent.get("argv", []))
        rank -= n
    return None


def main() -> None:
    if len(sys.argv) != 2:
        sys.stderr.write("usage: mpmd_exec spec.json\n")
        sys.exit(2)
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    got = entry_for(spec, int(os.environ.get(RANK_VAR, "0")))
    if got is None:
        sys.stderr.write("mpmd_exec: rank beyond spec total\n")
        sys.exit(3)
    cmd, argv = got
    os.execv(cmd, [cmd] + argv)


if __name__ == "__main__":
    main()
