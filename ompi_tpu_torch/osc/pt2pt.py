"""osc/pt2pt — window emulation over the acked active-message plane.

Behavioral spec: ``ompi/mca/osc/rdma`` running over the pml when no
RDMA-capable btl reaches the peer (``osc_rdma_component.c``'s
alternate path): every Put/Get/Accumulate is one framed request to the
target's window handler, applied on the target's reader thread and
acked — origin completion is remote completion, which is what makes
``fence`` a plain barrier and ``flush`` a no-op.

The engine is ``osc/perrank.RankWindow`` unchanged — this module is
the component's *selection identity*: ``osc/decision`` names it for
remote-host communicators, user-provided ``MPI_Win_create`` storage
(caller memory cannot be retroactively shm-backed), and any topology
``osc/shm`` refuses. It must therefore stay correct everywhere the
framework runs; ``osc/shm`` is the same-host fast path on top.
"""
from __future__ import annotations

from ompi_tpu_torch.osc.perrank import RankWindow


class Pt2ptWindow(RankWindow):
    """The pt2pt osc component — RankWindow under its framework name."""

    component = "pt2pt"
