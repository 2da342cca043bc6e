"""Performance variables (pvars) — the MPI_T performance-variable
backend, mirroring ``opal/mca/base/mca_base_pvar.c``.

Pvars are read-only named counters/levels sourced from
component-registered callables (the persistent-collective and bucket
counters of ``coll/persistent``, the tracer's, the hooks' drops) and
every SPC counter (``spc_<name>``, installed by ``refresh``). The port
of ``ompi_tpu/mca/pvar.py``.
"""
from __future__ import annotations

import os
import sys
import threading
from typing import Any, Callable, Dict, List

_lock = threading.Lock()
_pvars: Dict[str, Dict[str, Any]] = {}

# MPI_T pvar classes (mca_base_pvar.h's MCA_BASE_PVAR_CLASS_* set, plus
# the telemetry plane's histogram class — a pvar whose read returns the
# merged {count, sum, max, p50, p90, p99, buckets} snapshot of a log2
# bucket histogram, telemetry/hist.py)
CLASS_COUNTER = "counter"
CLASS_LEVEL = "level"
CLASS_HIGHWATERMARK = "highwatermark"
CLASS_HISTOGRAM = "histogram"


def _caller_site() -> str:
    """``file.py:line`` of the nearest frame outside this module — the
    owner identity for the double-register policy."""
    here = os.path.abspath(__file__)
    f = sys._getframe(1)
    while f is not None and os.path.abspath(f.f_code.co_filename) == here:
        f = f.f_back
    if f is None:
        return "<unknown>"
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


def pvar_register(name: str, read_fn: Callable[[], Any], *,
                  unit: str = "count", help: str = "",
                  var_class: str = CLASS_COUNTER,
                  comm: Any = None) -> None:
    """Register (or same-site rebind) one pvar.

    Double-register policy, mirroring ``var.var_register``: the SAME
    call site rebinding a name is allowed (reads follow the newest
    counter); a DIFFERENT site claiming an existing name raises — two
    owners silently shadowing each other's counters is the bug class.
    ``comm`` tags a per-communicator pvar with its owner's cid (the
    tracer's ``trace_skew_c<cid>``, the telemetry histograms), so
    ``pvar_retire_comm`` drops them when that communicator is freed or
    replaced by a shrink."""
    site = _caller_site()
    with _lock:
        v = _pvars.get(name)
        if v is not None and v.get("site") not in (None, site):
            raise ValueError(
                f"pvar '{name}' re-registered at {site} — owner is "
                f"{v['site']}")
        _pvars[name] = {"read": read_fn, "unit": unit, "help": help,
                        "class": var_class, "site": site,
                        "comm": None if comm is None else str(comm)}


def pvar_unregister(name: str) -> bool:
    """Drop one pvar; whether it existed. Never raises on a missing
    name: retirement races communicator frees by design."""
    with _lock:
        return _pvars.pop(name, None) is not None


def pvar_register_dict(prefix: str, stats: Dict[str, Any], *,
                       help_prefix: str = "") -> None:
    """One pvar per key of a live counter dict: reads reflect the dict's
    current values, so hot paths keep plain ``dict[k] += 1``
    increments. Re-registration rebinds the names to the newest dict."""
    def make_reader(d, k):
        return lambda: d.get(k, 0)

    for key in list(stats):
        pvar_register(f"{prefix}_{key}", make_reader(stats, key),
                      help=(f"{help_prefix}{key}" if help_prefix
                            else f"{prefix} counter {key}"))


def pvar_retire_comm(cid: Any) -> List[str]:
    """Retire every pvar tagged ``comm=cid`` (string-compared): the
    per-comm pvar-session teardown of a communicator free or shrink, so
    reads after it cannot report a dead communicator's keys. Returns the
    retired names."""
    scid = str(cid)
    with _lock:
        names = [n for n, v in _pvars.items() if v.get("comm") == scid]
        for n in names:
            del _pvars[n]
    return sorted(names)


def _install_spc_pvars() -> None:
    """Surface every SPC counter as a writable pvar ``spc_<name>``
    (``ompi_spc.c``). The membership check and the registration happen
    under one ``_lock`` hold, so concurrent ``refresh()`` calls register
    each name once."""
    from ompi_tpu_torch.runtime import spc

    def make_reader(key):
        return lambda: spc.read(key)

    def make_writer(key):
        return lambda value: spc.write(key, int(value))

    for key in spc.snapshot():
        full = f"spc_{key}"
        with _lock:
            if full in _pvars:
                continue
            _pvars[full] = {"read": make_reader(key), "unit": "count",
                            "help": f"SPC counter {key}",
                            "class": CLASS_COUNTER,
                            "write": make_writer(key)}


def refresh() -> None:
    """Register the SPC counters recorded since the last refresh."""
    _install_spc_pvars()


def pvar_read(name: str) -> Any:
    with _lock:
        v = _pvars.get(name)
    if v is None:
        raise KeyError(f"no such pvar: {name}")
    return v["read"]()


def pvar_write(name: str, value: Any) -> None:
    """MPI_T_pvar_write: only pvars registered with a writer accept
    writes; read-only pvars refuse."""
    with _lock:
        v = _pvars.get(name)
    if v is None:
        raise KeyError(f"no such pvar: {name}")
    wf = v.get("write")
    if wf is None:
        raise PermissionError(f"pvar {name} is read-only")
    wf(value)


def pvar_list() -> List[Dict[str, Any]]:
    with _lock:
        items = list(_pvars.items())
    return [{"name": n, "unit": v["unit"], "class": v["class"],
             "help": v["help"], "value": v["read"]()}
            for n, v in sorted(items)]


def pvar_names() -> List[str]:
    """Names only — enumeration must not invoke every counter's read
    closure."""
    with _lock:
        return sorted(_pvars)


def pvar_info(name: str) -> Dict[str, Any]:
    """One pvar's metadata WITHOUT reading its value."""
    with _lock:
        v = _pvars.get(name)
    if v is None:
        raise KeyError(f"no such pvar: {name}")
    return {"name": name, "unit": v["unit"], "class": v["class"],
            "help": v["help"]}
