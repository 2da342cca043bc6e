"""ompi_mpi_init / finalize — world bring-up.

Behavioral spec: ``ompi/runtime/ompi_mpi_init.c:397`` through
``ompi/instance/instance.c:361-720``: OPAL up -> wire-up -> COMM_WORLD/SELF
creation -> per-communicator coll selection.

Single-controller: wire-up is device enumeration. ``init()`` binds one
rank to each visible CUDA device; ``init(devices=[...])`` binds one rank
to each listed device, repeats allowed, so ``[torch.device("cuda:0")] *
8`` puts 8 ranks on one card and ``["cpu"] * 8`` puts them on the CPU
(the counterpart of the JAX package's 8 virtual CPU devices). Without a
CUDA device and without an explicit list, ``init`` raises: it never moves
to the CPU on its own. The per-rank tier (one process per rank over
``torch.distributed``) waits for a later slice.
"""
from __future__ import annotations

import os
import socket
import time
from typing import List, Optional

import torch

from ompi_tpu_torch import accelerator, compress
from ompi_tpu_torch.coll import persistent, tuned
from ompi_tpu_torch.core.communicator import Communicator
from ompi_tpu_torch.core.errhandler import ERR_OTHER, MPIError
from ompi_tpu_torch.core.group import Group
from ompi_tpu_torch.core.info import INFO_ENV
from ompi_tpu_torch.mca import base, var
from ompi_tpu_torch.pml import stacked
from ompi_tpu_torch.runtime import progress

THREAD_SINGLE = 0
THREAD_FUNNELED = 1
THREAD_SERIALIZED = 2
THREAD_MULTIPLE = 3

_state = {
    "initialized": False,
    "finalized": False,
    "world": None,
    "self": None,
    "thread_level": THREAD_SINGLE,
}


def init(requested: int = THREAD_SINGLE,
         devices: Optional[List] = None) -> int:
    """MPI_Init / MPI_Init_thread. Returns the provided thread level."""
    if _state["initialized"]:
        raise MPIError(ERR_OTHER, "MPI already initialized")
    if devices is None:
        if not torch.cuda.is_available():
            raise MPIError(ERR_OTHER,
                           "no CUDA device is visible; pass devices=[...] "
                           "(e.g. ['cpu'] * 8) to run ranks elsewhere")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise MPIError(ERR_OTHER, "Init needs at least one device")
    n = len(devices)
    accelerator.select_for_devices(devices)
    persistent.register_vars()
    tuned.register_vars()
    compress._register_vars()
    stacked._register_vars()

    world = Communicator(Group(range(n)), devices, name="MPI_COMM_WORLD")
    self_comm = Communicator(Group([0]), [devices[0]], name="MPI_COMM_SELF")

    INFO_ENV.set("command", os.environ.get("_", ""))
    INFO_ENV.set("maxprocs", str(n))
    INFO_ENV.set("soft", str(n))
    INFO_ENV.set("host", socket.gethostname())
    INFO_ENV.set("arch", devices[0].type)

    _state.update(initialized=True, finalized=False, world=world,
                  self=self_comm,
                  thread_level=min(requested, THREAD_MULTIPLE))
    return _state["thread_level"]


def finalize() -> None:
    if not _state["initialized"] or _state["finalized"]:
        raise MPIError(ERR_OTHER, "MPI not initialized or already finalized")
    # "all communication is complete at finalize": drain the device
    _state["world"].barrier()
    _state.update(finalized=True, world=None, self=None)


def initialized() -> bool:
    return _state["initialized"]


def finalized() -> bool:
    return _state["finalized"]


def comm_world() -> Communicator:
    if not _state["initialized"] or _state["finalized"]:
        raise MPIError(ERR_OTHER, "MPI is not active (call Init first)")
    return _state["world"]


def comm_self() -> Communicator:
    if not _state["initialized"] or _state["finalized"]:
        raise MPIError(ERR_OTHER, "MPI is not active (call Init first)")
    return _state["self"]


def wtime() -> float:
    return time.perf_counter()


def wtick() -> float:
    return 1e-9


def _reset_for_tests() -> None:
    """Forget the world, the var store and the framework opens, so the
    next ``init`` starts as a fresh process would (re-reading the
    environment); empty the progress engine's callback lists, zero the
    persistent-collective counters, drop the live bucket fusers, and zero
    the compression counters and error-feedback residuals."""
    _state.update(initialized=False, finalized=False, world=None, self=None)
    var._reset_for_tests()
    progress._reset_for_tests()
    persistent._reset_for_tests()
    compress._reset_for_tests()
    for fw in base.all_frameworks().values():
        fw.close()
    accelerator.framework._reset_for_tests()
