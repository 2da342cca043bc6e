"""Host locality synthesis — the hwloc-depth role. The port of
``ompi_tpu/utils/locality.py``; it reads only the host.

Behavioral spec: the reference feeds NUMA/socket/L3 levels from hwloc to
its hierarchical components (``opal/mca/hwloc/base/``; xhc builds its
ladder from hwloc levels per ``ompi/mca/coll/xhc/README.md``). This
module reads the topology from the OS directly (the /sys cpu, cache and
node trees) and, where the hardware ladder is trivial (single-package
hosts, every row on one card), synthesizes a balanced factorization of
the rank count so hierarchical algorithms still run their multi-level
paths, with the basis labeled (every tuned default says where it came
from).

A rank is a row of a stacked tensor: the device-locality level groups
rows by CUDA device index (:func:`device_key`), so rows that all sit on
one card, or on the CPU, form one group and the ladder falls through to
the host topology.
"""
from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple


def device_key(d) -> int:
    """A row's shared-memory domain: its CUDA device index; a CPU row
    (or anything without an index) reads as 0."""
    if getattr(d, "type", None) == "cuda":
        return int(d.index or 0)
    return 0


def _read_int(path: str) -> Optional[int]:
    try:
        with open(path) as f:
            return int(f.read().strip().split("-")[0].split(",")[0])
    except (OSError, ValueError):
        return None


def host_topology() -> dict:
    """(packages, numa nodes, L3 domains, cpus) from /sys — the hwloc
    discovery collapsed to the levels the ladder builders consume."""
    cpus = sorted(glob.glob("/sys/devices/system/cpu/cpu[0-9]*"))
    ncpu = len(cpus) or (os.cpu_count() or 1)
    pkgs = set()
    l3s = set()
    for c in cpus:
        p = _read_int(os.path.join(c, "topology/physical_package_id"))
        if p is not None:
            pkgs.add(p)
        # L3 is index3 on every mainstream layout; shared_cpu_list
        # identifies the domain
        try:
            with open(os.path.join(c, "cache/index3",
                                   "shared_cpu_list")) as f:
                l3s.add(f.read().strip())
        except OSError:
            pass
    numa = len(glob.glob("/sys/devices/system/node/node[0-9]*"))
    return {"cpus": ncpu,
            "packages": len(pkgs) or 1,
            "numa": numa or 1,
            "l3_domains": len(l3s) or 1}


def _balanced_factor(n: int) -> Optional[int]:
    """Largest factor of n not above sqrt(n) (>= 2), for the synthetic
    two-level ladder."""
    best = None
    f = 2
    while f * f <= n:
        if n % f == 0:
            best = f
        f += 1
    return best


def ladder_sizes(nranks: int,
                 devices=None) -> Tuple[Optional[List[int]], str]:
    """(group sizes innermost-first, basis) for an n-rank hierarchical
    ladder. Preference order mirrors the reference's hwloc walk:

    1. device locality (rows per CUDA device);
    2. OS topology (cpus per L3, L3s per NUMA, NUMA per package —
       mapped proportionally onto the rank count);
    3. a synthesized balanced factorization when both are trivial,
       labeled so nobody mistakes it for measured hardware structure.
    """
    if nranks <= 3:
        return None, "trivial"
    if devices is not None:
        groups: dict = {}
        for d in devices:
            k = device_key(d)
            groups[k] = groups.get(k, 0) + 1
        if len(groups) > 1 and max(groups.values()) > 1:
            return [max(groups.values())], "device-locality"
    topo = host_topology()
    sizes: List[int] = []
    remaining = nranks
    # ranks per L3 domain, then L3 domains per NUMA, then NUMA count —
    # each level only materializes when it divides the ranks into >1
    # groups of >1
    for domains in (topo["l3_domains"] * topo["numa"], topo["numa"],
                    topo["packages"]):
        if domains > 1 and remaining % domains == 0 \
                and remaining // domains > 1:
            sizes.append(remaining // domains)
            remaining = domains
    if sizes:
        return sizes, "os-topology"
    f = _balanced_factor(nranks)
    if f is not None:
        return [f], "synthetic-mesh"
    return None, "trivial"
