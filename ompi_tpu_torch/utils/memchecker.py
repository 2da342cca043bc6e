"""Memchecker — user-buffer state tracking around communication calls
(the port of ``ompi_tpu/utils/memchecker.py``).

Behavioral spec: ``opal/mca/memchecker/valgrind``
(``memchecker_valgrind_module.c``): the reference wraps
``VALGRIND_MAKE_MEM_*`` to mark user buffers *undefined* while a pending
operation owns them (a nonblocking send's buffer must not be modified, a
nonblocking receive's buffer must not be read) and *defined* again at
completion, so valgrind flags the misuse at the exact racing access.

There is no valgrind to delegate to, so the checker tracks buffers by
identity with content fingerprints:

- ``inflight(buf, why)``   — the library holds a read obligation
  (partitioned send between ``pready`` and completion, a pending ssend):
  a fingerprint is taken; ``verify(buf)`` at completion raises
  ``MemcheckError`` if the user mutated the buffer meanwhile.
- ``undefined(buf, why)``  — the library holds a write obligation (a
  posted receive's target): ``check_readable(buf)`` raises until
  ``defined(buf)``.

The JAX package tracks only numpy buffers, because its device arrays
are immutable. A torch tensor is mutable wherever it lives, so the port
tracks tensors too. Numpy arrays and CPU tensors keep the reference's
``zlib.crc32`` of their bytes. A CUDA tensor is never read back: its
fingerprint is a ``clone()`` on its own device, and ``verify`` compares
the two bit patterns there with ``torch.equal`` — one scalar comes back
to the host, never the payload.

Enabled with the MCA var ``mpi_memchecker_enable`` (off by default —
fingerprinting is a full buffer read, or a device copy, exactly like the
reference's memchecker being a debug-build feature). All entry points
are no-ops when disabled, so hot paths stay clean.
"""
from __future__ import annotations

import threading
import zlib
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ompi_tpu_torch.mca import var


class MemcheckError(RuntimeError):
    """A tracked buffer was used while the library owned it."""


def register_vars() -> None:
    var.var_register("mpi", "memchecker", "enable", vtype="bool",
                     default=False,
                     help="Track user buffer ownership around pt2pt "
                          "calls: detect user modification of in-flight "
                          "send buffers and reads of not-yet-delivered "
                          "receive buffers (the opal memchecker role; "
                          "debug feature, costs a buffer read or a "
                          "device copy per mark)")


register_vars()

_lock = threading.Lock()
# id(buf) -> ("inflight", fingerprint, why) | ("undefined", None, why);
# a fingerprint is a crc32 (host buffers) or a device clone (CUDA)
_tracked: Dict[int, Tuple[str, Any, str]] = {}
_violations = 0

# same-width integer views: a bit-for-bit compare on the device (a float
# compare would call NaN != NaN a mutation and -0.0 == 0.0 none)
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def enabled() -> bool:
    return bool(var.var_get("mpi_memchecker_enable", False))


def _buffer(buf: Any):
    """``buf`` if it is a trackable buffer (numpy or tensor), else None."""
    return buf if isinstance(buf, (np.ndarray, torch.Tensor)) else None


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.view(_BITS[t.element_size()])


def _fp(buf) -> Any:
    if isinstance(buf, torch.Tensor):
        if buf.is_cuda:
            return buf.detach().clone()
        buf = _bits(buf.contiguous()).reshape(-1).view(torch.uint8).numpy()
    return zlib.crc32(np.ascontiguousarray(buf).tobytes())


def _unchanged(buf, fp) -> bool:
    if isinstance(fp, torch.Tensor):
        return torch.equal(_bits(buf), _bits(fp))
    return _fp(buf) == fp


def inflight(buf: Any, why: str = "pending send") -> None:
    """Library takes a read obligation on ``buf``."""
    if not enabled():
        return
    a = _buffer(buf)
    if a is None:
        return
    fp = _fp(a)
    with _lock:
        _tracked[id(a)] = ("inflight", fp, why)


def undefined(buf: Any, why: str = "pending receive") -> None:
    """Library takes a write obligation on ``buf``: contents are
    undefined for the user until ``defined``."""
    if not enabled():
        return
    a = _buffer(buf)
    if a is None:
        return
    with _lock:
        _tracked[id(a)] = ("undefined", None, why)


def verify(buf: Any) -> None:
    """Completion of a read obligation: raise if the user mutated the
    buffer while the library owned it (the race valgrind would flag at
    the mutating store)."""
    if not enabled():
        return
    a = _buffer(buf)
    if a is None:
        return
    with _lock:
        ent = _tracked.pop(id(a), None)
    if ent is None or ent[0] != "inflight":
        return
    if not _unchanged(a, ent[1]):
        global _violations
        with _lock:
            _violations += 1
        raise MemcheckError(
            f"send buffer modified while in flight ({ent[2]}): MPI "
            f"forbids touching a buffer the library still owns")


def defined(buf: Any) -> None:
    """Completion of a write obligation: the buffer is the user's
    again."""
    if not enabled():
        return
    a = _buffer(buf)
    if a is not None:
        with _lock:
            _tracked.pop(id(a), None)


def check_readable(buf: Any) -> None:
    """Raise if ``buf`` is currently undefined (a posted receive's
    target that has not completed)."""
    if not enabled():
        return
    a = _buffer(buf)
    if a is None:
        return
    with _lock:
        ent = _tracked.get(id(a))
    if ent is not None and ent[0] == "undefined":
        raise MemcheckError(
            f"read of an undefined buffer ({ent[2]}): contents are "
            f"unspecified until the operation completes")


def violations() -> int:
    return _violations


def _reset_for_tests() -> None:
    global _violations
    with _lock:
        _tracked.clear()
        _violations = 0
