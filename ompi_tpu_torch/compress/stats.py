"""Compression observability — the port of ``ompi_tpu/compress/stats.py``.

pvars in the port's ``mca/pvar`` registry:

- ``compress_bytes_in``: payload bytes that entered quantization
  (wire-equivalent);
- ``compress_bytes_out``: bytes after quantization (codes + scales);
- ``compress_ratio``: out / in (1.0 before any compressed traffic);
- ``compress_max_abs_error``: high-watermark of the measured
  |x - dequant(quant(x))|, fed by the host wire path and by verification
  passes (the device schedules' error is checked out of band, by the
  tests and ``chip_smoke.py``).

The ``compress.quant`` / ``compress.dequant`` names are trace spans
(``compress/wire`` records them around the host codec, when tracing is
on) and declared MPI_T event types in ``utils/hooks``, so a profiler
hook and the trace's attribution (``trace.attribution.compress_by_rank``)
see compression time under one name.
"""
from __future__ import annotations

import threading
from typing import Dict

from ompi_tpu_torch.mca import pvar as _pvar
from ompi_tpu_torch.utils import hooks as _hooks

EV_QUANT = "compress.quant"
EV_DEQUANT = "compress.dequant"

_lock = threading.Lock()
_counters: Dict[str, float] = {
    "bytes_in": 0, "bytes_out": 0, "quant_calls": 0, "dequant_calls": 0,
    "max_abs_error": 0.0,
}


def account(bytes_in: int, bytes_out: int, quant_calls: int = 1) -> None:
    """Record one compression event: ``bytes_in`` wire-equivalent
    payload bytes replaced by ``bytes_out`` compressed bytes."""
    with _lock:
        _counters["bytes_in"] += int(bytes_in)
        _counters["bytes_out"] += int(bytes_out)
        _counters["quant_calls"] += int(quant_calls)


def account_dequant(calls: int = 1) -> None:
    with _lock:
        _counters["dequant_calls"] += int(calls)


def note_error(err: float) -> None:
    """Feed the max-abs-error watermark (measured round-trip error)."""
    err = float(err)
    if err != err:                       # NaN: a poisoned block, not a
        return                           # quantization error magnitude
    with _lock:
        if err > _counters["max_abs_error"]:
            _counters["max_abs_error"] = err


def snapshot() -> Dict[str, float]:
    with _lock:
        return dict(_counters)


def ratio() -> float:
    with _lock:
        if not _counters["bytes_in"]:
            return 1.0
        return _counters["bytes_out"] / _counters["bytes_in"]


def reset() -> None:
    with _lock:
        for k in _counters:
            _counters[k] = 0.0 if k == "max_abs_error" else 0


def _register() -> None:
    _pvar.pvar_register(
        "compress_bytes_in", lambda: snapshot()["bytes_in"],
        unit="bytes",
        help="Payload bytes that entered collective quantization "
             "(wire-equivalent)")
    _pvar.pvar_register(
        "compress_bytes_out", lambda: snapshot()["bytes_out"],
        unit="bytes",
        help="Bytes after quantization (codes + per-block scales): what "
             "the wire moves")
    _pvar.pvar_register(
        "compress_ratio", ratio, unit="ratio", var_class=_pvar.CLASS_LEVEL,
        help="compress_bytes_out / compress_bytes_in (1.0 before any "
             "compressed traffic)")
    _pvar.pvar_register(
        "compress_max_abs_error", lambda: snapshot()["max_abs_error"],
        unit="value", var_class="highwatermark",
        help="Largest measured per-element |x - dequant(quant(x))| "
             "(host codec path + verification passes)")
    # the span names are MPI_T event types too: tools can bind handlers
    _hooks.declare_event(EV_QUANT)
    _hooks.declare_event(EV_DEQUANT)


_register()
