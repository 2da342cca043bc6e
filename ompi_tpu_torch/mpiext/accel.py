"""mpiext/accel — accelerator support queries (the port of
``ompi_tpu/mpiext/accel.py``).

Behavioral spec: ``ompi/mpiext/cuda`` / ``ompi/mpiext/rocm`` —
``MPIX_Query_cuda_support()`` / ``MPIX_Query_rocm_support()`` return
whether the library was built with, and is currently running against,
device-buffer support (``ompi/mpiext/cuda/c/mpiext_cuda.c``).

The question is the reference's: do device buffers ride the native
device path without host staging? Here the device plane is CUDA, so
``Query_cuda_support`` is the one that answers True (when a CUDA device
is visible) and ``Query_tpu_support`` is False — the JAX package's
answers swapped, by design. The extension also exposes the device
inventory the reference leaves to ``MPIX_Query_*`` callers to discover
themselves.
"""
from __future__ import annotations

from typing import Dict, List

import torch


def Query_cuda_support() -> bool:
    """True when CUDA tensors dispatch to the device collectives without
    host staging: a CUDA device is visible."""
    return torch.cuda.is_available()


def Query_tpu_support() -> bool:
    """Always False: this package's device plane is CUDA (provided so
    apps written against the JAX package can probe both)."""
    return False


def Query_rocm_support() -> bool:
    return False


def Device_inventory() -> List[Dict]:
    """One record per visible CUDA device (platform, id, process,
    coords, kind); the CPU's one record when none is visible."""
    from ompi_tpu_torch.accelerator.framework import device_attrs
    if torch.cuda.is_available():
        return [device_attrs(torch.device("cuda", i))
                for i in range(torch.cuda.device_count())]
    return [device_attrs(torch.device("cpu"))]
