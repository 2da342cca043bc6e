"""Accelerator framework — the device-memory abstraction.

Behavioral spec: ``opal/mca/accelerator/accelerator.h`` — ``check_addr``
:176 (is this buffer device memory?), async memcpy :280, streams/events
:189-258, device alloc :364. The reference's CUDA component detects device
pointers via ``cuPointerGetAttributes`` (``accelerator_cuda.c:304-360``).

Here a buffer is a ``torch.Tensor`` or a numpy array, so ``check_addr`` is
a type/placement test. Components:

- ``cuda`` — the device is a CUDA card: a CUDA tensor is device memory,
  a numpy array or a CPU tensor is host memory. Streams and events are
  ``torch.cuda.Stream``/``torch.cuda.Event``.
- ``cpu`` — selected only when the caller binds the world to CPU devices
  (the tests' 8-rank world): the CPU plays the device, so a tensor is
  device memory and a numpy array host memory; streams and events are
  trivially complete.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ompi_tpu_torch.mca.base import Component, register_framework

LOCUS_DEVICE = "device"
LOCUS_HOST = "host"

accel_framework = register_framework("accelerator")


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy of a tensor. numpy has no bfloat16: such tensors come
    back as float32 (exact, bf16 is a prefix of f32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def device_locality(device) -> Tuple[int, Tuple[int, ...]]:
    """(process_index, physical coords) of a device — what topology
    placement reads. A ``torch.device`` carries neither, so it reads as
    (0, ()): every rank in one process, no coordinates."""
    proc = int(getattr(device, "process_index", 0) or 0)
    coords = tuple(getattr(device, "coords", ()) or ())
    return proc, coords


class Stream:
    """An ordered work queue (``accelerator.h:189-226`` streams) over
    ``torch.cuda.Stream``; ``None`` device = the trivially ordered CPU."""

    def __init__(self, device: Optional[torch.device] = None):
        self.stream = (torch.cuda.Stream(device) if device is not None
                       else None)

    def sync(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()


class Event:
    """Completion marker (``accelerator.h:227-258``) over
    ``torch.cuda.Event``: ``record`` marks the stream's position,
    ``query`` polls, ``synchronize`` blocks."""

    def __init__(self, cuda: bool = True):
        self.event = torch.cuda.Event() if cuda else None

    def record(self, stream=None) -> None:
        """Mark ``stream`` (a ``Stream`` or a ``torch.cuda.Stream``;
        None = the current stream of the current device)."""
        if self.event is not None:
            self.event.record(getattr(stream, "stream", stream))

    def query(self) -> bool:
        return True if self.event is None else self.event.query()

    def synchronize(self) -> None:
        if self.event is not None:
            self.event.synchronize()


class CudaAccelComponent(Component):
    """CUDA device memory (peer of accelerator/cuda)."""

    name = "cuda"

    def comm_query(self, comm):
        return (50, self)

    def check_addr(self, buf: Any) -> Optional[str]:
        if isinstance(buf, torch.Tensor):
            return LOCUS_DEVICE if buf.is_cuda else LOCUS_HOST
        if isinstance(buf, (np.ndarray, np.generic)):
            return LOCUS_HOST
        return None

    def mem_copy_h2d(self, host_buf, device=None) -> torch.Tensor:
        if isinstance(host_buf, torch.Tensor):
            return host_buf.to(device or "cuda")
        return torch.tensor(np.asarray(host_buf), device=device or "cuda")

    def mem_copy_d2h(self, dev_buf) -> np.ndarray:
        if isinstance(dev_buf, torch.Tensor):
            return to_numpy(dev_buf)
        return np.asarray(dev_buf)

    def create_stream(self, device=None) -> Stream:
        return Stream(torch.device(device or "cuda"))

    def create_event(self) -> Event:
        return Event(cuda=True)


class CpuAccelComponent(CudaAccelComponent):
    """The CPU standing in for the device (the counterpart of the JAX
    package's virtual CPU devices). Every tensor is device memory."""

    name = "cpu"

    def comm_query(self, comm):
        return (0, self)

    def check_addr(self, buf: Any) -> Optional[str]:
        if isinstance(buf, torch.Tensor):
            return LOCUS_DEVICE
        if isinstance(buf, (np.ndarray, np.generic)):
            return LOCUS_HOST
        return None

    def mem_copy_h2d(self, host_buf, device=None) -> torch.Tensor:
        if isinstance(host_buf, torch.Tensor):
            return host_buf.to(device or "cpu")
        return torch.tensor(np.asarray(host_buf), device=device or "cpu")

    def create_stream(self, device=None) -> Stream:
        return Stream(None)

    def create_event(self) -> Event:
        return Event(cuda=False)


_CUDA = accel_framework.register(CudaAccelComponent())
_CPU = accel_framework.register(CpuAccelComponent())

_module: Optional[Component] = None


def _mod() -> Component:
    global _module
    if _module is None:
        sel = accel_framework.comm_select(None)
        _module = sel[0][2]
    return _module


def select_for_devices(devices: Sequence[torch.device]) -> Component:
    """Bind the accelerator module to the world's devices: ``cpu`` when
    every device is the CPU, else ``cuda``. Called by ``init``."""
    global _module
    accel_framework.open()
    _module = (_CPU if all(torch.device(d).type == "cpu" for d in devices)
               else _CUDA)
    return _module


def current_module() -> Component:
    """The selected accelerator module."""
    return _mod()


def check_addr(buf: Any) -> Optional[str]:
    """Locus of a buffer: LOCUS_DEVICE, LOCUS_HOST, or None (not a
    buffer). The re-designed ``accelerator.check_addr`` (:176)."""
    return _mod().check_addr(buf)


def to_device(buf: Any, device=None) -> torch.Tensor:
    return _mod().mem_copy_h2d(buf, device)


def to_host(buf: Any) -> np.ndarray:
    return _mod().mem_copy_d2h(buf)


def _reset_for_tests():
    global _module
    _module = None
