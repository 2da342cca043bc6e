"""mpiext/affinity — locality strings (the port of
``ompi_tpu/mpiext/affinity.py``).

Behavioral spec: ``ompi/mpiext/affinity`` — ``OMPI_Affinity_str()``
returns three strings per calling rank describing requested binding,
actual binding, and the map of the whole job (hwloc-derived).

"Binding" is the rank -> device pinning of the communicator. The
locality string names the torch device as ``type:index`` (ranks that
share one card each name ``cuda:0``; the JAX package names
``platform:id``), its process and any physical coordinates.
"""
from __future__ import annotations

from typing import List, Tuple


def _one(rank: int, device) -> str:
    from ompi_tpu_torch.accelerator.framework import device_locality
    proc, coords = device_locality(device)
    where = f" coords={coords}" if coords else ""
    return (f"rank {rank} bound to {device.type}:{device.index or 0} "
            f"(process {proc}{where})")


def Affinity_str(comm, rank: int = 0) -> Tuple[str, str, str]:
    """(requested, actual, full-map) binding strings for ``rank`` —
    OMPI_Affinity_str shape. Requested == actual in this runtime: the
    communicator constructor is the binding."""
    actual = _one(rank, comm.devices[rank])
    full = "; ".join(_one(r, d) for r, d in enumerate(comm.devices))
    return actual, actual, full


def Affinity_map(comm) -> List[str]:
    return [_one(r, d) for r, d in enumerate(comm.devices)]
