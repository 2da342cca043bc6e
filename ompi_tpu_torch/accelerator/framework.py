"""Accelerator framework — the device-memory abstraction.

Behavioral spec: ``opal/mca/accelerator/accelerator.h`` — ``check_addr``
:176 (is this buffer device memory?), async memcpy :280, streams/events
:189-258, device alloc :364, host registration :574. The reference's
CUDA component detects device pointers via ``cuPointerGetAttributes``
(``accelerator_cuda.c:304-360``).

Here a buffer is a ``torch.Tensor`` or a numpy array, so ``check_addr`` is
a type/placement test. Components:

- ``cuda`` — the device is a CUDA card: a CUDA tensor is device memory,
  a numpy array or a CPU tensor is host memory. Streams and events are
  ``torch.cuda.Stream``/``torch.cuda.Event``.
- ``cpu`` — selected only when the caller binds the world to CPU devices
  (the tests' 8-rank world): the CPU plays the device, so a tensor is
  device memory and a numpy array host memory; streams and events are
  trivially complete.

IPC handles (``accelerator.h:460-561``) let another rank process map a
device allocation: on ``cuda`` they are real CUDA IPC handles (the
storage's ``_share_cuda_`` through ``torch.multiprocessing``'s tensor
reduction) with an interprocess ``torch.cuda.Event`` that orders the
owner's writes before a peer's reads; on ``cpu`` they are files in
``/dev/shm`` mapped by every peer. ``get_ipc_handle(buf)`` exports an
existing tensor within this process (the reference's opaque registry
handle, for another subsystem or a spawned child world). Every handle
is a record tagged by its kind — ``"cuda"``, ``"shm"`` or ``"local"`` —
and ``open_ipc_handle`` maps any of them to an ``IpcMapping`` whose
``tensor`` views the allocation. A failed export or open raises
``MPIError``: nothing falls back to host bytes.

The rest of the surface: ``mem_alloc`` (:364), ``event_synchronize``,
and the device queries ``get_device_info``, ``get_device_attributes``
(``torch.cuda.get_device_properties`` and ``memory_stats``) and
``device_can_access_peer`` (:598-657).
"""
from __future__ import annotations

import itertools
import mmap
import os
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ompi_tpu_torch.core.errhandler import ERR_OTHER, MPIError
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


def device_attrs(device) -> dict:
    """Position record of a device (the ``get_device_pci_attr`` role):
    what ``Get_processor_name`` and the per-rank binding report."""
    d = torch.device(device)
    proc, coords = device_locality(d)
    cuda = d.type == "cuda"
    return {"id": int(d.index or 0) if cuda else 0,
            "platform": "gpu" if cuda else "cpu",
            "process_index": proc, "coords": coords,
            "kind": torch.cuda.get_device_name(d) if cuda else "cpu"}


# -- shared-memory segments: the cpu handle kind, and btl/sm's rings ----
SHM_DIR = "/dev/shm" if os.path.isdir("/dev/shm") else \
    os.environ.get("TMPDIR", "/tmp")
SEG_PREFIX = "otptseg"
_seg_ids = itertools.count()

# in-process IPC registry: handle number -> the exported tensor
_local_ipc: dict = {}
_local_ids = itertools.count(1)


def tag_for(coord: str) -> str:
    """Deterministic job token from the job's store address. Shared with
    the launcher's post-job sweep (``tools/mpirun.py``), so segment names
    and the sweep's glob never diverge."""
    import hashlib
    return hashlib.md5(coord.encode()).hexdigest()[:10]


def job_tag() -> str:
    """This process's job token (empty outside a launched job)."""
    coord = os.environ.get("OMPI_TPU_TORCH_MCA_mpi_base_coordinator", "")
    return tag_for(coord) if coord else ""


def _map_segment(path: str, nbytes: int, create: bool) -> torch.Tensor:
    flags = os.O_RDWR | (os.O_CREAT | os.O_EXCL if create else 0)
    fd = os.open(path, flags, 0o600)
    try:
        if create:
            os.ftruncate(fd, max(nbytes, 1))
        mm = mmap.mmap(fd, max(nbytes, 1))
    finally:
        os.close(fd)
    # the tensor holds the mapping alive; it unmaps when the last view
    # of it is collected
    return torch.frombuffer(mm, dtype=torch.uint8)[:nbytes]


class IpcBuffer:
    """A device allocation that peer processes can map: ``tensor`` is its
    flat uint8 view, ``handle`` the picklable record a peer passes to
    ``open_ipc_handle``. The owner calls ``record()`` after writing it,
    so a peer's ``wait()`` orders its reads behind those writes."""

    def __init__(self, nbytes: int, device):
        device = torch.device(device)
        self.event = None
        self._path = None
        try:
            if device.type == "cuda":
                from torch.multiprocessing.reductions import reduce_tensor
                self.tensor = torch.empty(nbytes, dtype=torch.uint8,
                                          device=device)
                self.event = torch.cuda.Event(interprocess=True)
                self.event.record(torch.cuda.current_stream(device))
                self.handle = ("cuda", device.index, nbytes,
                               reduce_tensor(self.tensor)[1],
                               self.event.ipc_handle())
            else:
                name = (f"{SEG_PREFIX}_{job_tag()}_{os.getpid()}_"
                        f"{next(_seg_ids)}")
                self._path = os.path.join(SHM_DIR, name)
                self.tensor = _map_segment(self._path, nbytes, create=True)
                self.handle = ("shm", name, nbytes)
        except MPIError:
            raise
        except Exception as e:           # noqa: BLE001 — any export fault
            raise MPIError(ERR_OTHER, f"IPC export of {nbytes} B on "
                                      f"{device} failed: "
                                      f"{type(e).__name__}: {e}") from e

    def record(self) -> None:
        if self.event is not None:
            self.event.record(torch.cuda.current_stream(
                self.tensor.device))

    def close(self) -> None:
        self.tensor = None
        if self._path is not None:
            try:
                os.unlink(self._path)
            except OSError:
                pass
            self._path = None


class IpcMapping:
    """A peer's ``IpcBuffer`` opened in this process: ``tensor`` views
    the peer's memory; ``wait()`` makes this process's current stream
    wait for the owner's last ``record()``."""

    def __init__(self, handle):
        kind = handle[0]
        self.event = None
        try:
            if kind == "cuda":
                from torch.multiprocessing.reductions import \
                    rebuild_cuda_tensor
                _, index, nbytes, args, ev = handle
                self.tensor = rebuild_cuda_tensor(*args)
                self.event = torch.cuda.Event.from_ipc_handle(
                    torch.device("cuda", index), ev)
            elif kind == "shm":
                _, name, nbytes = handle
                self.tensor = _map_segment(os.path.join(SHM_DIR, name),
                                           nbytes, create=False)
            elif kind == "local":
                # an in-process export: the mapping is the tensor itself
                self.tensor = _local_ipc[handle[1]]
            else:
                raise ValueError(f"unknown handle kind {kind!r}")
        except Exception as e:           # noqa: BLE001 — any open fault
            raise MPIError(ERR_OTHER, f"IPC open of a {kind} handle "
                                      f"failed: {type(e).__name__}: "
                                      f"{e}") from e

    def wait(self) -> None:
        if self.event is not None:
            torch.cuda.current_stream(self.tensor.device).wait_event(
                self.event)

    def close(self) -> None:
        self.tensor = None
        self.event = None


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


class AsyncD2H:
    """A device-to-host copy in flight (``mem_copy_d2h_async``): ``host``
    is its destination, ``event`` the CUDA event recorded after the copy
    on a side stream (None on the CPU, where the copy is already done).
    ``mem_copy_d2h`` finishes it."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor, event=None):
        self.host = host
        self.event = event


# cudaErrorHostMemoryAlreadyRegistered: the pages are pinned already
_ALREADY_REGISTERED = 712


class CudaAccelComponent(Component):
    """CUDA device memory (peer of accelerator/cuda)."""

    name = "cuda"

    def __init__(self):
        super().__init__()
        # id(buf) -> (buf, refcount) of the numpy buffers pinned by
        # host_register (accelerator.h:574)
        self._pinned: dict = {}
        # a stream per device for D2H copies: they overlap compute on
        # the current stream instead of queueing behind it
        self._d2h_streams: dict = {}

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
        if isinstance(dev_buf, AsyncD2H):
            if dev_buf.event is not None:
                dev_buf.event.synchronize()
            return dev_buf.host.numpy()
        if isinstance(dev_buf, torch.Tensor):
            return to_numpy(dev_buf)
        return np.asarray(dev_buf)

    def mem_copy_d2h_async(self, dev_buf: torch.Tensor,
                           out: Optional[torch.Tensor] = None) -> AsyncD2H:
        """Begin a device-to-host copy without waiting for it (the async
        memcpy of ``accelerator.h:280``): a ``non_blocking`` copy into
        ``out`` (pinned host memory, allocated when None) on a side
        stream that first waits for the current stream's writes; a CUDA
        event marks its end. ``mem_copy_d2h`` finishes it."""
        src = dev_buf.detach()
        if not src.is_cuda:
            host = src.cpu() if out is None else out.copy_(src)
            return AsyncD2H(host)
        if out is None:
            out = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        cur = torch.cuda.current_stream(src.device)
        side = self._d2h_streams.get(src.device.index)
        if side is None:
            side = self._d2h_streams[src.device.index] = \
                torch.cuda.Stream(src.device)
        side.wait_stream(cur)
        ev = torch.cuda.Event()
        with torch.cuda.stream(side):
            out.copy_(src, non_blocking=True)
            ev.record(side)
        # the caching allocator must not hand the source to another
        # tensor before the side stream has read it
        src.record_stream(side)
        return AsyncD2H(out, ev)

    # -- host registration (accelerator.h:574) -------------------------
    def host_register(self, buf: np.ndarray) -> None:
        """Pin a host numpy buffer (``cudaHostRegister``), so copies
        between it and the card are DMA from its own pages. Counted:
        matched register/unregister pairs nest. A buffer whose pages are
        pinned already counts as registered."""
        entry = self._pinned.get(id(buf))
        if entry is not None:
            self._pinned[id(buf)] = (buf, entry[1] + 1)
            return
        if buf.nbytes:
            res = torch.cuda.cudart().cudaHostRegister(
                buf.ctypes.data, buf.nbytes, 0)
            code = int(res)
            if code not in (0, _ALREADY_REGISTERED):
                raise MPIError(ERR_OTHER, f"cudaHostRegister of "
                                          f"{buf.nbytes} B failed: error "
                                          f"{code}")
        self._pinned[id(buf)] = (buf, 1)

    def host_unregister(self, buf: np.ndarray) -> None:
        entry = self._pinned.get(id(buf))
        if entry is None:
            return
        if entry[1] > 1:
            self._pinned[id(buf)] = (buf, entry[1] - 1)
            return
        del self._pinned[id(buf)]
        if buf.nbytes:
            torch.cuda.cudart().cudaHostUnregister(buf.ctypes.data)

    def is_host_registered(self, buf: np.ndarray) -> bool:
        return id(buf) in self._pinned

    def create_stream(self, device=None) -> Stream:
        return Stream(torch.device(device or "cuda"))

    def create_event(self) -> Event:
        return Event(cuda=True)

    # -- IPC handles (accelerator.h:460-561) ---------------------------
    def ipc_buffer(self, nbytes: int, device) -> IpcBuffer:
        return IpcBuffer(nbytes, device)

    def open_ipc_handle(self, handle) -> IpcMapping:
        return IpcMapping(handle)

    def get_ipc_handle(self, buf: torch.Tensor) -> tuple:
        """Export ``buf`` within this process: the opaque registry
        handle (``("local", n)``) that ``open_ipc_handle`` maps back to
        the same tensor, with no copy, until ``close_ipc_handle``."""
        h = ("local", next(_local_ids))
        _local_ipc[h[1]] = buf
        return h

    def close_ipc_handle(self, handle) -> None:
        if handle[0] == "local":
            _local_ipc.pop(handle[1], None)

    # -- alloc (accelerator.h:364) -------------------------------------
    def mem_alloc(self, shape, dtype=torch.float32,
                  device=None) -> torch.Tensor:
        """A zeroed device allocation of ``shape``."""
        from ompi_tpu_torch.core.datatype import torch_dtype
        return torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                           device=device or self._default_device())

    def _default_device(self) -> torch.device:
        return torch.device("cuda", torch.cuda.current_device())

    def event_synchronize(self, bufs) -> None:
        """Block until the work that produces ``bufs`` (a tensor or a
        sequence of them) is done: each CUDA device they live on drains
        its current stream."""
        if isinstance(bufs, torch.Tensor):
            bufs = [bufs]
        devs = {b.device for b in bufs
                if isinstance(b, torch.Tensor) and b.is_cuda}
        for d in devs:
            torch.cuda.current_stream(d).synchronize()

    # -- device info (accelerator.h:598-657) ---------------------------
    def get_device_info(self) -> Tuple[str, int]:
        return ("cuda", torch.cuda.device_count())

    def get_device_attributes(self, device) -> dict:
        """``device_attrs`` plus, for a CUDA device, its properties: name,
        SM count, total memory, compute capability, and the caching
        allocator's ``memory_stats`` (None where there are none)."""
        d = torch.device(device)
        attrs = device_attrs(d)
        attrs["memory_stats"] = None
        if d.type == "cuda":
            p = torch.cuda.get_device_properties(d)
            attrs.update(name=p.name, sm_count=p.multi_processor_count,
                         total_memory=p.total_memory,
                         compute_capability=(p.major, p.minor))
            attrs["memory_stats"] = torch.cuda.memory_stats(d) or None
        return attrs

    def device_can_access_peer(self, dev_a, dev_b) -> bool:
        """The same device, or two CUDA devices with peer access."""
        a, b = torch.device(dev_a), torch.device(dev_b)
        if a == b or (a.type == b.type == "cpu"):
            return True
        if a.type == b.type == "cuda":
            return bool(torch.cuda.can_device_access_peer(a.index or 0,
                                                          b.index or 0))
        return False


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

    def host_register(self, buf: np.ndarray) -> None:
        """Nothing to pin on the CPU: the registration is only counted."""
        entry = self._pinned.get(id(buf))
        self._pinned[id(buf)] = (buf, entry[1] + 1 if entry else 1)

    def host_unregister(self, buf: np.ndarray) -> None:
        entry = self._pinned.get(id(buf))
        if entry is None:
            return
        if entry[1] > 1:
            self._pinned[id(buf)] = (buf, entry[1] - 1)
        else:
            del self._pinned[id(buf)]

    def create_stream(self, device=None) -> Stream:
        return Stream(None)

    def create_event(self) -> Event:
        return Event(cuda=False)

    def _default_device(self) -> torch.device:
        return torch.device("cpu")

    def event_synchronize(self, bufs) -> None:
        """CPU work is complete when the call returns."""

    def get_device_info(self) -> Tuple[str, int]:
        return ("cpu", 1)


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


def to_host_async(buf: torch.Tensor, out: Optional[torch.Tensor] = None
                  ) -> AsyncD2H:
    """Start a D2H copy; finish it with ``to_host``. The double-buffering
    primitive behind ``btl/devxfer.SegmentStager``."""
    return _mod().mem_copy_d2h_async(buf, out)


def _reset_for_tests():
    global _module
    _module = None
    _local_ipc.clear()
