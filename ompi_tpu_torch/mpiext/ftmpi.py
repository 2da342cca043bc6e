"""mpiext/ftmpi — the ULFM MPIX_* API surface (the port of
``ompi_tpu/mpiext/ftmpi.py``).

Behavioral spec: ``ompi/mpiext/ftmpi`` (the user-level ULFM interface
documented in ``docs/features/ulfm.rst:1-31``): revoke, shrink, agree,
failure acknowledgment, plus the MPI-5 FT additions (get_failed /
ack_failed). The heavy lifting lives in ``Communicator`` and
``RankCommunicator`` (state machines), ``coll/ftagree`` (agreement) and
``runtime/ft`` (the failure registry).
"""
from __future__ import annotations

from typing import Optional, Sequence

from ompi_tpu_torch.runtime import ft as _ft


def Comm_revoke(comm) -> None:
    comm.revoke()


def Comm_is_revoked(comm) -> bool:
    return comm.is_revoked()


def Comm_shrink(comm):
    return comm.shrink()


def Comm_ishrink(comm):
    return comm.ishrink()


def Comm_agree(comm, flags: Sequence[int]) -> int:
    return comm.agree(flags)


def Comm_iagree(comm, flags: Sequence[int]):
    return comm.iagree(flags)


def Comm_failure_ack(comm) -> None:
    comm.failure_ack()


def Comm_failure_get_acked(comm):
    return comm.failure_get_acked()


def Comm_get_failed(comm):
    return comm.get_failed()


def Comm_ack_failed(comm, num_to_ack: Optional[int] = None):
    return comm.ack_failed(num_to_ack)


# -- detector / injection surface (the PMIx-event-plane equivalent) -------
fail_rank = _ft.fail_rank
probe_devices = _ft.probe_devices
failed_ranks = _ft.failed_ranks
failure_epoch = _ft.epoch
failure_events = _ft.events
add_failure_listener = _ft.add_listener
remove_failure_listener = _ft.remove_listener

# the resilience plane's two halves, re-exported so FT tooling needs one
# import: deterministic fault injection (ft/inject, MCA-gated, zero-cost
# when off) and the ring heartbeat detector (ft/detector)
from ompi_tpu_torch.ft import detector, inject  # noqa: E402,F401
