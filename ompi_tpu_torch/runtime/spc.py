"""SPC — software performance counters (the port of
``ompi_tpu/runtime/spc.py``).

Mirrors ``ompi/runtime/ompi_spc.h:47-159`` (~110 counters recorded via
SPC_RECORD macros in hot paths, surfaced as MPI_T pvars). Here: a flat
counter table keyed by name, recorded from the collective/pt2pt entry
points, surfaced through ``ompi_tpu_torch.mca.pvar`` (``spc_<name>``).

Sharding: a process-global lock on every hot-path increment would
serialize the btl reader threads against the app thread on the paths
the tracer also observes, so counters are sharded per thread —
each thread increments its own plain dict (no lock, GIL-atomic per
op); readers (``read``/``snapshot``) merge the base table with every
shard under the lock. ``write`` (MPI_T_pvar_write resets) adjusts the
BASE so the merged view equals the requested value without mutating
another thread's shard mid-increment.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List

from ompi_tpu_torch.mca import var

_lock = threading.Lock()
# merged-view base: written values and (on reset) the zero point
_base: Dict[str, int] = defaultdict(int)
# every live thread shard, for the readers to merge; threads register
# their shard once (bounded by thread count — reader/ctl threads are
# long-lived daemons, this does not accrete)
_shards: List[Dict[str, int]] = []
_tls = threading.local()
_enabled = None


def _on() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = bool(var.var_register(
            "mpi", "base", "spc_enable", vtype="bool", default=True,
            help="Enable software performance counters"))
    return _enabled


def record(name: str, value: int = 1) -> None:
    """Hot path: one TLS fetch + one dict increment, no lock."""
    if not _on():
        return
    d = getattr(_tls, "d", None)
    if d is None:
        d = _tls.d = defaultdict(int)
        with _lock:
            _shards.append(d)
    d[name] += value


def _merged(name: str) -> int:
    # caller holds _lock
    return _base.get(name, 0) + sum(s.get(name, 0) for s in _shards)


def read(name: str) -> int:
    with _lock:
        return _merged(name)


def write(name: str, value: int) -> None:
    """Set a counter outright (MPI_T_pvar_write backing; tools reset
    watermarks this way). Implemented as a base adjustment so no other
    thread's shard is mutated under its feet."""
    with _lock:
        _base[name] = int(value) - sum(s.get(name, 0) for s in _shards)


def snapshot() -> Dict[str, int]:
    with _lock:
        out: Dict[str, int] = dict(_base)
        for s in _shards:
            for k, v in list(s.items()):
                out[k] = out.get(k, 0) + v
        return out


def reset() -> None:
    global _enabled
    with _lock:
        _base.clear()
        for s in _shards:
            s.clear()
    _enabled = None
