"""osc/decision — the component-selection step at window creation.

Mirrors ``coll/decision`` for the one-sided framework: every osc
component advertises a priority-like eligibility check, and window
creation runs ONE selection (``ompi_osc_base_select`` /
``osc_sm_component_query``'s "every rank on one node" probe) whose
outcome must agree on every rank of the communicator — the inputs are
the MCA var (same config on all ranks), the storage kind (collective
call signature) and the all-pairs same-host predicate (symmetric by
construction), so no extra agreement round is needed.

Outcomes:

- ``"shm"``   — every rank of the communicator shares this host and
  the execution model is per-rank: the window is a /dev/shm segment
  peers map directly (osc/sm's load/store RMA).
- ``"pt2pt"`` — remote-host peers, user-provided storage
  (``MPI_Win_create`` memory cannot be retroactively shm-backed), or
  a stacked single-controller communicator: the window is emulated
  over the acked active-message plane (the osc/rdma-over-pml shape).
"""
from __future__ import annotations

from ompi_tpu_torch.core.errhandler import ERR_WIN, MPIError
from ompi_tpu_torch.mca import var

from ompi_tpu_torch.osc import base as _base

COMPONENTS = ("shm", "pt2pt")


def same_host(comm) -> bool:
    """True when every rank of ``comm`` shares this rank's host (the
    osc/sm eligibility probe). Symmetric across ranks: if any pair
    splits hosts, every rank sees a remote peer and answers False."""
    router = getattr(comm, "router", None)
    if router is None:
        return False
    ep = getattr(router, "endpoint", None)
    if ep is None:
        return False
    try:
        return all(ep._is_same_host(comm.world_rank_of(r))
                   for r in range(comm.size))
    except Exception:                    # noqa: BLE001 — unknown peer
        return False                     # topology: be conservative


def select(comm, storage=None, force=None) -> str:
    """One selection per window creation. ``force`` (tests, drills)
    overrides the MCA var; user ``storage`` pins pt2pt regardless —
    caller-owned memory cannot be exposed through a /dev/shm segment."""
    _base.register_params()
    choice = force or str(var.var_get("mpi_base_osc", "auto"))
    if choice not in ("auto",) + COMPONENTS:
        raise MPIError(ERR_WIN, f"unknown osc component {choice!r} "
                                f"(mpi_base_osc)")
    if storage is not None:
        if choice == "shm":
            raise MPIError(ERR_WIN,
                           "osc/shm cannot expose user-provided "
                           "window memory (MPI_Win_create storage "
                           "rides osc/pt2pt)")
        return "pt2pt"
    if choice == "shm":
        if not same_host(comm):
            raise MPIError(ERR_WIN,
                           "mpi_base_osc=shm forced but the "
                           "communicator spans hosts (or is not "
                           "per-rank)")
        return "shm"
    if choice == "pt2pt":
        return "pt2pt"
    return "shm" if same_host(comm) else "pt2pt"


def selection_table() -> dict:
    """Introspection for tools (mpitop / flightrec): the var, the
    component histogram so far, and the live open-epoch state."""
    _base.register_params()
    return {
        "var": str(var.var_get("mpi_base_osc", "auto")),
        "windows_shm": _base.stats["windows_shm"],
        "windows_pt2pt": _base.stats["windows_pt2pt"],
        "open_epochs": _base.open_epoch_state(),
    }
