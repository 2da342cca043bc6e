"""btl/devxfer — the device payload plane of per-rank pt2pt, over IPC.

Behavioral spec: ob1's rendezvous/RDMA protocol switch
(``pml_ob1_sendreq.h:389-460``) — above the eager limit, bulk payloads
leave the copy-in/copy-out byte path and ride an RDMA get: the sender
publishes the buffer, the receiver pulls it. The port of
``ompi_tpu/btl/devxfer.py``, whose engine is the PJRT transfer service;
here it is CUDA IPC (shared-memory segments when the ranks are bound to
the CPU).

A device tensor of at least ``btl_devxfer_min_bytes`` is cloned at send
into one of the sender's per-destination send slots — an exported
``IpcBuffer`` — and only a descriptor rides the ordered matching plane.
The receiver opens the slot's handle (once: mappings are cached per peer
and slot, since an open costs milliseconds), waits on the slot's
interprocess event, copies into a tensor on its own bound device,
synchronizes, and acks; the ack returns the slot to the sender's free
list. The get is one-sided and runs on the receiver's consumer thread, so
nothing deadlocks under THREAD_MULTIPLE. There is no fallback: a rank that
cannot export or open a handle raises ``MPIError``; the payload is never
quietly sent as host bytes.
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ompi_tpu_torch import accelerator
from ompi_tpu_torch.core.errhandler import ERR_PROC_FAILED, MPIError
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.runtime import ft


def eager_limit() -> int:
    """Payloads at or above this ride the IPC plane."""
    return int(var.var_get("btl_devxfer_min_bytes", 1 << 20))


class _Slot:
    __slots__ = ("id", "buf", "busy")

    def __init__(self, sid: int, buf: accelerator.IpcBuffer):
        self.id = sid
        self.buf = buf
        self.busy = False


class DevXfer:
    """One per Router: the send-slot pools (by destination world rank)
    and the receive-side mappings (by source world rank and slot id)."""

    def __init__(self, router):
        self.router = router
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._pools: Dict[int, List[_Slot]] = {}
        self._by_id: Dict[int, _Slot] = {}
        self._maps: Dict[Tuple[int, int], accelerator.IpcMapping] = {}
        self.stats = {"sent": 0, "received": 0, "opened": 0,
                      "slots": 0}

    def try_register(self, data: Any, wdest: int) -> Optional[dict]:
        """Sender-side protocol switch: a device tensor at or above the
        eager limit is cloned into a send slot; returns the descriptor to
        ship instead of bytes, or None for the host byte path."""
        if not (isinstance(data, torch.Tensor) and data.dim() > 0
                and accelerator.check_addr(data) == accelerator.LOCUS_DEVICE
                and data.numel() * data.element_size() >= eager_limit()):
            return None
        meta = {"shape": tuple(data.shape), "dtype": str(data.dtype)[6:]}
        if wdest == self.router.rank:
            # loopback: the descriptor never leaves the process
            return {"kind": "devlocal", "tensor": data.detach().clone(),
                    **meta}
        nbytes = data.numel() * data.element_size()
        slot, replaced = self._take_slot(wdest, nbytes, data.device)
        dst = slot.buf.tensor[:nbytes].view(data.dtype).view(data.shape)
        dst.copy_(data.detach())
        slot.buf.record()                # orders the copy before a read
        self.stats["sent"] += 1
        return {"kind": "devipc", "src": self.router.rank, "slot": slot.id,
                "handle": slot.buf.handle, "replaces": replaced,
                "nbytes": nbytes, **meta}

    def _take_slot(self, wdest: int, nbytes: int, device):
        """A free slot of this destination's pool large enough for the
        payload (a too-small free slot is replaced by a larger one)."""
        with self._lock:
            pool = self._pools.setdefault(wdest, [])
            free = [s for s in pool if not s.busy]
            fit = [s for s in free if s.buf.tensor.numel() >= nbytes]
            if fit:
                slot = min(fit, key=lambda s: s.buf.tensor.numel())
                slot.busy = True
                return slot, None
            old = free[0] if free else None
            if old is not None:
                pool.remove(old)
                self._by_id.pop(old.id, None)
            sid = next(self._ids)
        # allocate outside the lock; an export fault raises MPIError
        slot = _Slot(sid, accelerator.current_module().ipc_buffer(
            max(nbytes, 1 << 20), device))
        slot.busy = True
        with self._lock:
            pool.append(slot)
            self._by_id[sid] = slot
            self.stats["slots"] += 1
        if old is not None:
            old.buf.close()
        return slot, (old.id if old is not None else None)

    def release(self, sid: int) -> None:
        """The receiver's ack: its copy out of slot ``sid`` is done."""
        with self._lock:
            slot = self._by_id.get(sid)
            if slot is not None:
                slot.busy = False

    def resolve(self, desc: dict) -> torch.Tensor:
        """Receiver side, on the consumer thread: read the sender's slot
        into a tensor on this rank's device, then ack."""
        dtype = getattr(torch, desc["dtype"])
        if desc["kind"] == "devlocal":
            return desc["tensor"]
        src = int(desc["src"])
        if ft.is_failed(src):
            # ULFM fail-fast before any open or copy: once the exporting
            # process is gone, reads through its IPC handle are undefined
            raise MPIError(ERR_PROC_FAILED, f"device payload source rank "
                                            f"{src} has failed")
        key = (src, int(desc["slot"]))
        with self._lock:
            m = self._maps.get(key)
            stale = self._maps.pop((src, desc["replaces"]), None) \
                if desc.get("replaces") is not None else None
        if stale is not None:
            stale.close()
        if m is None:
            m = accelerator.current_module().open_ipc_handle(desc["handle"])
            with self._lock:
                self._maps[key] = m
                self.stats["opened"] += 1
        m.wait()
        out = torch.empty(desc["shape"], dtype=dtype,
                          device=self.router.device)
        src_view = m.tensor[:int(desc["nbytes"])].view(dtype) \
            .view(desc["shape"])
        out.copy_(src_view)
        if out.is_cuda:
            torch.cuda.current_stream(out.device).synchronize()
        self.router.endpoint.send_frame(src, {"ctl": "xferack",
                                              "slot": key[1]})
        self.stats["received"] += 1
        return out

    def close(self) -> None:
        """Finalize, after the job's last fence: unmap every peer slot,
        then free this rank's own."""
        with self._lock:
            maps, self._maps = list(self._maps.values()), {}
            slots = list(self._by_id.values())
            self._by_id.clear()
            self._pools.clear()
        for m in maps:
            m.close()
        for s in slots:
            s.buf.close()


class DevPayload:
    """Descriptor of a device payload in flight, resolved lazily on the
    consumer thread (reader threads stay free to deliver other frames).
    Carries shape and size, so probe and status byte counts are right
    before resolution."""

    def __init__(self, xfer: DevXfer, desc: dict):
        self._xfer = xfer
        self._desc = desc
        self._result = None
        self._rlock = threading.Lock()
        self.shape = tuple(desc["shape"])
        self.size = 1
        for d in self.shape:
            self.size *= int(d)
        self.nbytes = self.size * torch.empty(
            0, dtype=getattr(torch, desc["dtype"])).element_size()

    def resolve(self) -> torch.Tensor:
        with self._rlock:                # exactly once
            if self._result is None:
                self._result = self._xfer.resolve(self._desc)
                self._desc = None
            return self._result


def maybe_resolve(data):
    """Consumer-side hook: read a device payload through its handle;
    anything else passes through."""
    if isinstance(data, DevPayload):
        return data.resolve()
    return data


class SegmentStager:
    """Double-buffered device-to-host staging of a tensor's segments for
    the pipelined rendezvous (``pml/pipeline``; the reference's
    ``SegmentStager``, ``ompi_tpu/btl/devxfer.py:170-205``). Segments are
    element ranges of the flattened tensor, sliced on the device; each
    is copied into one of two reused host staging buffers (pinned on
    CUDA) by ``accelerator.to_host_async``. Fetching segment s finishes
    its copy and issues segment s+1's when its buffer is free, so the
    staging of s+1 overlaps the wire time of s. A buffer is free again
    once the caller ``release``s the segment it held (its bytes have
    left), so at most two staged segments are ever in flight."""

    def __init__(self, t: torch.Tensor, elems_per_seg: int,
                 timeout: float = 600.0):
        self._flat = t.detach().reshape(-1)
        self._eps = max(1, int(elems_per_seg))
        self._n = -(-int(self._flat.numel()) // self._eps)
        self._timeout = timeout
        width = min(self._eps, int(self._flat.numel()))
        pin = self._flat.is_cuda
        self._bufs = [torch.empty(width, dtype=self._flat.dtype,
                                  pin_memory=pin) for _ in range(2)]
        self._free = [threading.Event(), threading.Event()]
        for ev in self._free:
            ev.set()
        self._ahead: Dict[int, Any] = {}     # idx -> copy in flight
        self.staged = 0                      # segments copied to host

    @property
    def nseg(self) -> int:
        return self._n

    def _start(self, i: int, wait: bool = True) -> None:
        if not (0 <= i < self._n) or i in self._ahead:
            return
        free = self._free[i % 2]
        if not wait and not free.is_set():
            return                       # its buffer is still on the wire
        if not free.wait(self._timeout):
            raise MPIError(ERR_PROC_FAILED, "staging buffer never "
                                            "released by the wire")
        free.clear()
        seg = self._flat[i * self._eps:(i + 1) * self._eps]
        out = self._bufs[i % 2][:seg.numel()]
        self._ahead[i] = accelerator.to_host_async(seg, out)
        self.staged += 1

    def get(self, i: int) -> np.ndarray:
        """Segment ``i`` on the host, as a numpy view of its staging
        buffer, valid until ``release(i)``."""
        self._start(i)
        out = accelerator.to_host(self._ahead.pop(i))
        self._start(i + 1, wait=False)   # prefetch the next segment
        return out

    def release(self, i: int) -> None:
        """Segment ``i``'s bytes have left: its buffer may be reused."""
        self._free[i % 2].set()
