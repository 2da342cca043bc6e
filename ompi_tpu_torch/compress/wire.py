"""Host wire codec — the port of ``ompi_tpu/compress/wire.py``.

A host (numpy) payload above the compression floor travels as a
:class:`CompressedWire` — codes + per-block scales — so a 4 MB fp32 hop
ships about 1 MB. Hop semantics match the device schedules: a reduce
chain decodes, folds and re-encodes at every hop; a bcast chain encodes
once and forwards the codes.

Every encode accounts its bytes in the ``compress_bytes_*`` pvars and,
on a sample of calls, feeds the measured round-trip error into the
``compress_max_abs_error`` watermark; every decode counts a dequant.
Error feedback (``compress/feedback``) runs per (stream, shape, dtype)
when ``mpi_base_compress_error_feedback`` is on.

Its consumers are the per-rank tier's host hops (``core/rankcomm``'s
reduce, bcast and allreduce) and the pipelined rendezvous's per-segment
codec (``pml/pipeline``); the ``compress.quant``/``compress.dequant``
spans wait for ``trace/`` (A.17).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np

from ompi_tpu_torch.compress import codecs as _codecs
from ompi_tpu_torch.compress import feedback as _feedback
from ompi_tpu_torch.compress import stats as _stats
from ompi_tpu_torch.trace import core as _trace

_NP_ELIGIBLE = ("float32", "float64")


class CompressedWire:
    """The pickled wire form: plain attributes only."""

    __slots__ = ("codec", "block", "codes", "scales", "shape", "dtype")

    def __init__(self, codec: str, block: int, codes: np.ndarray,
                 scales: np.ndarray, shape: Tuple[int, ...], dtype: str):
        self.codec = codec
        self.block = block
        self.codes = codes
        self.scales = scales
        self.shape = shape
        self.dtype = dtype

    # pickle through __getstate__/__setstate__ (slots have no __dict__)
    def __getstate__(self):
        return (self.codec, self.block, self.codes, self.scales,
                self.shape, self.dtype)

    def __setstate__(self, st):
        (self.codec, self.block, self.codes, self.scales,
         self.shape, self.dtype) = st

    @property
    def nbytes(self) -> int:
        return int(self.codes.nbytes + self.scales.nbytes)


def _conf():
    from ompi_tpu_torch import compress as _c
    return _c


def eligible(data: Any, op=None, nbytes: Optional[int] = None) -> bool:
    """Host-path eligibility: compression on, a numpy float payload at or
    above the floor, and (when reducing) a sum op — the device path is
    gated the same way by ``coll/decision.compress_eligible``."""
    c = _conf()
    if not c.enabled():
        return False
    if not isinstance(data, np.ndarray):
        return False
    if data.dtype.name not in _NP_ELIGIBLE:
        return False
    if (data.nbytes if nbytes is None else nbytes) < c.min_bytes():
        return False
    if op is not None and getattr(op, "xla_prim", None) != "sum":
        return False
    return True


# verification sampling: the watermark's round trip costs passes over
# multi-MB payloads, so it runs on the FIRST encode of each (codec,
# shape, dtype) and every VERIFY_EVERY-th encode after; error feedback
# needs the dequantized image on every call
VERIFY_EVERY = 32
_seen_keys: set = set()
_encode_count = 0


def encode(arr: np.ndarray, stream_key: Any = None) -> CompressedWire:
    """Quantize ``arr`` for the wire. ``stream_key`` opts the payload
    into error feedback (meaningful only for repeated same-buffer calls;
    None for one-shot hops)."""
    global _encode_count
    c = _conf()
    codec = _codecs.get_codec(c.codec_name())
    block = c.block_elems()
    use_ef = stream_key is not None and c.error_feedback()
    if use_ef:
        key = (stream_key, arr.shape, arr.dtype.name)
        arr = _feedback.default.compensate(key, arr)
    tok = (_trace.begin(_stats.EV_QUANT, nbytes=int(arr.nbytes))
           if _trace.active else None)
    try:
        codes, scales = codec.encode(arr, block)
    finally:
        if tok is not None:
            _trace.end(tok)
    w = CompressedWire(codec.name, block, codes, scales,
                       tuple(arr.shape), arr.dtype.str)
    _stats.account(arr.nbytes, w.nbytes)
    _encode_count += 1
    vkey = (codec.name, tuple(arr.shape), arr.dtype.name)
    verify = use_ef or vkey not in _seen_keys \
        or _encode_count % VERIFY_EVERY == 0
    if verify:
        _seen_keys.add(vkey)
        dq = codec.decode(codes, scales, arr.shape, arr.dtype, block)
        diff = np.abs(np.asarray(arr, np.float32)
                      - np.asarray(dq, np.float32))
        finite = diff[np.isfinite(diff)]
        if finite.size:
            _stats.note_error(float(finite.max()))
        if use_ef:
            _feedback.default.record(key, arr, dq)
    return w


def decode(w: CompressedWire) -> np.ndarray:
    codec = _codecs.get_codec(w.codec)
    tok = (_trace.begin(_stats.EV_DEQUANT,
                        nbytes=int(getattr(w.codes, "nbytes", 0)))
           if _trace.active else None)
    try:
        out = codec.decode(w.codes, w.scales, w.shape, np.dtype(w.dtype),
                           w.block)
    finally:
        if tok is not None:
            _trace.end(tok)
    _stats.account_dequant()
    return out


def maybe_decode(payload: Any) -> Any:
    """Receive-side hook: decode wire payloads, pass everything else
    through."""
    if isinstance(payload, CompressedWire):
        return decode(payload)
    return payload


def _reset_for_tests() -> None:
    global _encode_count
    _seen_keys.clear()
    _encode_count = 0
