"""Performance variables (pvars) — the MPI_T performance-variable
backend, mirroring ``opal/mca/base/mca_base_pvar.c``.

Pvars are read-only named counters/levels sourced from
component-registered callables (the persistent-collective and bucket
counters of ``coll/persistent``). The port of ``ompi_tpu/mca/pvar.py``'s
registry (:42-79, :167-181); the SPC counters and the per-communicator
pvar sessions wait for the planes that own them.
"""
from __future__ import annotations

import os
import sys
import threading
from typing import Any, Callable, Dict, List

_lock = threading.Lock()
_pvars: Dict[str, Dict[str, Any]] = {}

# MPI_T pvar classes (mca_base_pvar.h's MCA_BASE_PVAR_CLASS_* set)
CLASS_COUNTER = "counter"
CLASS_LEVEL = "level"


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
                  var_class: str = CLASS_COUNTER) -> None:
    """Register (or same-site rebind) one pvar.

    Double-register policy, mirroring ``var.var_register``: the SAME
    call site rebinding a name is allowed (reads follow the newest
    counter); a DIFFERENT site claiming an existing name raises — two
    owners silently shadowing each other's counters is the bug class."""
    site = _caller_site()
    with _lock:
        v = _pvars.get(name)
        if v is not None and v.get("site") not in (None, site):
            raise ValueError(
                f"pvar '{name}' re-registered at {site} — owner is "
                f"{v['site']}")
        _pvars[name] = {"read": read_fn, "unit": unit, "help": help,
                        "class": var_class, "site": site}


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
