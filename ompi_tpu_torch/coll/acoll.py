"""coll/acoll — architecture-aware collective tuning hints. The port of
``ompi_tpu/coll/acoll.py``.

Behavioral spec: ``ompi/mca/coll/acoll`` — AMD "zen-aware" intra-node
collectives whose value is in encoding the chip topology (CCX/CCD cache
domains, NUMA fabric) into algorithm and segmentation choices
(``docs/tuning-apps/collectives/acoll.rst``).

This component detects the device kind a communicator runs on —
``torch.cuda.get_device_name`` on a CUDA communicator, ``"cpu"`` on a
CPU one — and installs that kind's defaults for ``coll_torch_segsize``
and the xhc ladder arity at DEFAULT precedence only: any user, env or
file setting wins, as the reference's per-arch tables defer to explicit
tuning.

The table holds only rows measured for a device the port runs on. The
``"cpu"`` row is the reference's own host measurement (its 32 MB sweep
on the 8-rank CPU mesh put ring_segmented at 4 MB segments ahead of 1 MB
segments and of the plain ring), kept so the two packages' CPU worlds
segment alike. No CUDA card has a row yet, so on one (for example
"NVIDIA H100 80GB HBM3") nothing matches, no hint is installed and
``coll_acoll_detected`` stays empty.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from ompi_tpu_torch.coll.framework import coll_framework
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.mca.base import Component

# device kind -> (segsize bytes, ladder arity). Keys match as substrings
# of the lower-cased kind. arity None = leave coll_xhc_levels alone.
GENERATION_HINTS: Dict[str, Tuple[int, Optional[int]]] = {
    # host backend: the reference's measured 4 MB segments; no ladder
    # hint, xhc keeps its locality fallback
    "cpu": (4 << 20, None),
}


def detect_generation(device_kind: str) -> Optional[str]:
    dk = device_kind.lower()
    for key in sorted(GENERATION_HINTS, key=len, reverse=True):
        if key in dk:
            return key
    return None


def _device_kind(comm) -> str:
    import torch
    dev = getattr(comm, "device", None)
    if dev is not None and torch.device(dev).type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


class AcollComponent(Component):
    """Hints provider, not a module provider: comm_query never wins; the
    component's whole effect is the defaults it installs at the first
    selection (deferring to any explicit setting)."""

    name = "acoll"

    _hints_done = False

    def register_params(self) -> None:
        var.var_register("coll", "acoll", "enable", vtype="bool",
                         default=True,
                         help="Install device-kind-aware default tuning "
                              "(segsize, ladder arity); explicit user/env/"
                              "file settings always win")
        var.var_register("coll", "acoll", "detected", vtype="str",
                         default="",
                         help="The table key the detector matched "
                              "(introspection; empty = no match)")

    def _ensure_hints(self, comm=None) -> None:
        """Lazy (first selection): every other component's vars are
        registered by then, so DEFAULT-precedence detection is
        well-defined."""
        if AcollComponent._hints_done:
            return
        AcollComponent._hints_done = True
        if not var.var_get("coll_acoll_enable", True):
            return
        gen = detect_generation(_device_kind(comm))
        if gen is None:
            return
        segsize, arity = GENERATION_HINTS[gen]
        var.var_set("coll_acoll_detected", gen)
        # DEFAULT-precedence install: applied only while each var still
        # sits at its registration default from every other source
        if var.var_source("coll_torch_segsize") == var.SOURCE_DEFAULT:
            var.var_set("coll_torch_segsize", segsize,
                        source=var.SOURCE_DEFAULT)
        if (arity is not None
                and var.var_source("coll_xhc_levels")
                == var.SOURCE_DEFAULT):
            var.var_set("coll_xhc_levels", str(arity),
                        source=var.SOURCE_DEFAULT)

    def comm_query(self, comm):
        self._ensure_hints(comm)
        return None                     # hints only; never a module


def _reset_for_tests() -> None:
    """Detect again at the next selection (the var store was reset)."""
    AcollComponent._hints_done = False


coll_framework.register(AcollComponent())
