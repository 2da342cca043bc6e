"""``ompi_info`` equivalent: dump version, devices, components, MCA vars,
pvars (the port of ``ompi_tpu/tools/info.py``). Run as ``python -m
ompi_tpu_torch.tools.info [-a]``.

The devices are the visible CUDA devices, named ``cuda:<index>`` (the
CPU's one ``cpu:0`` when none is visible), beside the native host
library's state. The frameworks come from the port's own registries:
every framework registered with ``mca/base``, the one-sided components
of ``osc/decision`` beside the stacked window, the matching engines and
the topology kinds.
"""
from __future__ import annotations

import argparse
import json
import re


def _devices() -> list:
    import torch
    if torch.cuda.is_available():
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return ["cpu:0"]


def collect(all_vars: bool = False) -> dict:
    import ompi_tpu_torch as MPI
    from ompi_tpu_torch.accelerator.framework import accel_framework
    from ompi_tpu_torch.api import tool
    from ompi_tpu_torch.coll.framework import (_ensure_components,
                                               coll_framework)
    from ompi_tpu_torch.io import fs  # noqa: F401  (registers "fs")
    from ompi_tpu_torch.mca.base import all_frameworks
    from ompi_tpu_torch.native import native_available
    from ompi_tpu_torch.osc.decision import COMPONENTS as OSC_COMPONENTS
    from ompi_tpu_torch.pml.perrank import PerRankEngine
    from ompi_tpu_torch.pml.stacked import MatchingEngine
    from ompi_tpu_torch.topo import cart

    _ensure_components()
    coll_framework.open()
    accel_framework.open()

    frameworks = {name: sorted(fw.components)
                  for name, fw in sorted(all_frameworks().items())}
    # the single-controller window ("stacked") beside the per-rank
    # components osc/decision selects from
    frameworks["osc"] = sorted(("stacked",) + tuple(OSC_COMPONENTS))
    frameworks["pml"] = sorted(
        m.__module__.rsplit(".", 1)[1]
        for m in (MatchingEngine, PerRankEngine))
    frameworks["topo"] = sorted(                  # DistGraphTopology ->
        re.sub(r"(?<!^)(?=[A-Z])", "_", t.__name__)  # dist_graph
        .lower().rsplit("_", 1)[0]
        for t in (cart.CartTopology, cart.GraphTopology,
                  cart.DistGraphTopology))
    out = {
        "library": MPI.Get_library_version(),
        "mpi_standard": ".".join(map(str, MPI.Get_version())),
        "platform": _devices(),
        "native_convertor": native_available(),
        "frameworks": frameworks,
    }
    if all_vars:
        out["mca_vars"] = tool.cvar_list()
        out["pvars"] = tool.pvar_list()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(prog="ompi_tpu_torch_info")
    ap.add_argument("-a", "--all", action="store_true",
                    help="include every MCA var and pvar")
    ap.add_argument("--json", action="store_true", help="JSON output")
    args = ap.parse_args()
    data = collect(all_vars=args.all)
    if args.json:
        print(json.dumps(data, indent=2, default=str))
        return
    print(data["library"])
    print(f"MPI standard: {data['mpi_standard']}")
    print(f"Devices: {', '.join(data['platform'])}")
    print(f"Native convertor: {data['native_convertor']}")
    for fw, comps in data["frameworks"].items():
        print(f"MCA {fw}: {', '.join(comps)}")
    if args.all:
        for v in data["mca_vars"]:
            print(f"  cvar {v['name']} = {v['value']!r} "
                  f"(source: {v['source']}) {v['help']}")
        for p in data["pvars"]:
            print(f"  pvar {p['name']} = {p['value']} [{p['class']}]")


if __name__ == "__main__":
    main()
