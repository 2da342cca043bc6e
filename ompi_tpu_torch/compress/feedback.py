"""Error-feedback accumulator — residual carry for iterative workloads.

The port of ``ompi_tpu/compress/feedback.py``, unchanged: it is numpy
only.

Quantized collectives bias iterative sums: each step's rounding error
is lost. Error feedback (1-bit SGD / EF-SGD lineage, HiCCL §5's
compression-composition caveat) keeps the residual locally and adds it
back into the NEXT step's payload before quantization, so the error a
step drops is re-offered rather than forgotten — the accumulated
drift stays bounded instead of growing with step count.

Usage (per logical stream, e.g. one gradient buffer)::

    ef = ErrorFeedback()
    x_comp = ef.compensate(key, x)          # x + carried residual
    codes, scales = codec.encode(x_comp)
    ef.record(key, x_comp, codec.decode(codes, scales, ...))

The accumulator is deliberately NOT wired into the collective hot path
by default: residuals are only meaningful when successive calls reuse
the same logical buffer, which the transport cannot know. The wire
layer exposes it behind ``mpi_base_compress_error_feedback`` for
callers that opt a stream in (see compress/wire.py).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Hashable

import numpy as np


class ErrorFeedback:
    """Per-key residual store. Keys identify a logical stream; shapes
    must be stable per key (a shape change resets that key's residual
    — a different buffer is a different stream)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._resid: Dict[Hashable, np.ndarray] = {}

    def compensate(self, key: Hashable, x: Any) -> np.ndarray:
        """Return ``x`` plus the carried residual for ``key``."""
        x = np.asarray(x)
        with self._lock:
            r = self._resid.get(key)
        if r is None or r.shape != x.shape:
            return x.copy()
        return (x + r.astype(x.dtype)).astype(x.dtype)

    def record(self, key: Hashable, x_compensated: Any,
               dequantized: Any) -> None:
        """Store what quantization dropped: compensated input minus
        its round-trip image."""
        xc = np.asarray(x_compensated, np.float64)
        dq = np.asarray(dequantized, np.float64)
        resid = xc - dq
        # a poisoned (non-finite) block carries no meaningful residual
        resid = np.where(np.isfinite(resid), resid, 0.0)
        with self._lock:
            self._resid[key] = resid.astype(np.float32)

    def residual(self, key: Hashable):
        with self._lock:
            r = self._resid.get(key)
        return None if r is None else r.copy()

    def reset(self, key: Hashable = None) -> None:
        with self._lock:
            if key is None:
                self._resid.clear()
            else:
                self._resid.pop(key, None)


# process-default accumulator (the wire layer's opt-in store)
default = ErrorFeedback()
