"""hook/comm_method — print the per-communicator selection table (the
port of ``ompi_tpu/tools/comm_method.py``).

Behavioral spec: the reference's ``ompi/mca/hook/comm_method`` (1,237
LoC) prints, at init/finalize, a rank x rank matrix of which transport
(pml/btl) serves each peer pair plus which coll components were
selected, so operators can confirm the fast path is actually in use.

Design: a single-controller communicator has one data plane (torch ops
over the stacked tensor on its device: ``torch/cuda`` on a card,
``torch/host`` on the CPU), so the peer-pair matrix degenerates into the
communicator -> device binding; the interesting selection surface is the
per-function coll vtable (which component won each collective) and the
device each rank's row lives on. The platform is ``coll/decision``'s
key (``"gpu"`` on a CUDA card, ``"cpu"``). A per-rank communicator adds
the bml's per-transport frame counts. ``table(comm)`` returns that; the
CLI prints it. Enable the print at communicator setup the way the
reference does, via the MCA var ``hook_comm_method_display`` (OMPI:
``hook_comm_method_verbose``).
"""
from __future__ import annotations

from typing import Dict

from ompi_tpu_torch.mca import var


def register_params() -> None:
    """Register the display var (idempotent; ``runtime/init`` runs it at
    Init, after a test reset empties the var store)."""
    var.var_register(
        "hook", "comm_method", "display", vtype="bool", default=False,
        help="Print the communicator selection table (coll component per "
             "function + device binding) when a communicator is set up")


register_params()


def table(comm) -> Dict:
    """The selection table for ``comm``: per-collective winning
    component, plus the mesh/transport summary."""
    per_func = getattr(comm, "_coll_winners", None)
    priorities = getattr(comm, "_coll_priorities", None)
    if per_func is None or priorities is None:
        if getattr(comm, "devices", None):
            # Not selected yet (or a bare mock): run the shared helper.
            from ompi_tpu_torch.coll.framework import select_winners
            winners, selected = select_winners(comm)
            per_func = {f: comp.name
                        for f, (comp, _m) in winners.items()}
            priorities = [(comp.name, prio)
                          for prio, comp, _m in selected]
        else:
            # per-rank communicator: collectives are the built-in
            # textbook/staged algorithms, not framework-selected modules
            per_func = {"*": "rankcomm-builtin"}
            priorities = []
    from ompi_tpu_torch.coll.decision import platform_key
    devices = list(getattr(comm, "devices", []) or [])
    if not devices and getattr(comm, "device", None) is not None:
        devices = [comm.device]          # a per-rank comm's own device
    platform = platform_key(devices[0]) if devices else "none"
    out = {
        "comm": getattr(comm, "name", None) or f"cid={comm.cid}",
        "size": comm.size,
        "platform": platform,
        "devices": [f"{d.type}:{d.index or 0}" for d in devices],
        # controller processes driving the rows (one outside a
        # multi-controller world)
        "hosts": (len({comm.controller_of(r) for r in range(comm.size)})
                  if hasattr(comm, "controller_of") else
                  1 if devices else 0),
        "data_plane": ("torch/cuda" if platform == "gpu"
                       else "torch/host"),
        "coll": dict(per_func),
        "priorities": list(priorities),
    }
    # per-rank worlds: the bml's per-transport frame counts — which
    # btl actually carried this rank's pt2pt traffic (the transport
    # matrix the reference's comm_method hook prints)
    router = getattr(comm, "router", None)
    ep = getattr(router, "endpoint", None)
    if ep is not None and hasattr(ep, "stats"):
        out["pt2pt_transports"] = dict(ep.stats)
        out["btl_sm"] = getattr(ep, "sm", None) is not None
        # the MEASURED basis for the bulk-routing decision (the init
        # micro-probe): operators see why sm carries bulk — or why it
        # was demoted — instead of trusting a hard-coded default
        basis = getattr(ep, "probe_basis", None)
        if basis:
            out["btl_probe"] = dict(basis)
    # the staged device tier's measured switch point (the decision
    # shows its data)
    from ompi_tpu_torch.coll.tuned import probed_stage_basis
    sb = probed_stage_basis()
    if sb.get("ran"):
        out["stage_probe"] = sb
    return out


def format_table(comm) -> str:
    t = table(comm)
    lines = [
        f"comm {t['comm']}: {t['size']} rank(s) on {t['platform']} "
        f"({t['hosts']} host(s)), data plane {t['data_plane']}",
        f"  devices: {', '.join(t['devices'])}",
        f"  component priorities: "
        f"{', '.join(f'{n}={p}' for n, p in t['priorities'])}",
        "  coll selection:",
    ]
    for func, comp in sorted(t["coll"].items()):
        lines.append(f"    {func:>22}: {comp}")
    return "\n".join(lines)


def maybe_display(comm) -> None:
    """Called from communicator setup when the display var is on (the
    reference hooks mpi_init/finalize the same way)."""
    if var.var_get("hook_comm_method_display", False):
        print(format_table(comm))


def main() -> None:
    import ompi_tpu_torch as MPI
    if not MPI.Initialized():
        MPI.Init()
    print(format_table(MPI.get_comm_world()))


if __name__ == "__main__":
    main()
