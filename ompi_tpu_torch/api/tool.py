"""MPI_T — the tool information interface (mirrors ``ompi/mpi/tool``;
the port of ``ompi_tpu/api/tool.py``).

Control variables (cvars) are the MCA vars; performance variables
(pvars) surface SPC counters and monitoring tables. Shapes follow the
MPI_T C API loosely (enumerate / get_info / read / write), Pythonized.
"""
from __future__ import annotations

from typing import Any, Dict, List

from ompi_tpu_torch.mca import pvar as _pvar
from ompi_tpu_torch.mca import var as _var
from ompi_tpu_torch.utils import hooks as _hooks


def init_thread() -> None:            # MPI_T_init_thread
    _pvar.refresh()


def finalize() -> None:               # MPI_T_finalize
    pass


# -- control variables -----------------------------------------------------
def cvar_get_num() -> int:
    return len(_var.var_dump())


def cvar_get_info(index: int) -> Dict[str, Any]:
    return _var.var_dump()[index]


def cvar_read(name: str) -> Any:
    return _var.var_get(name)


def cvar_write(name: str, value: Any) -> None:
    _var.var_set(name, value)


def cvar_list() -> List[Dict[str, Any]]:
    return _var.var_list()


def cvar_names() -> List[str]:
    return _var.var_names()


# -- performance variables -------------------------------------------------
def pvar_get_num() -> int:
    _pvar.refresh()
    return len(_pvar.pvar_list())


def pvar_list() -> List[Dict[str, Any]]:
    _pvar.refresh()
    return _pvar.pvar_list()


def pvar_read(name: str) -> Any:
    _pvar.refresh()
    return _pvar.pvar_read(name)


# -- decision tables --------------------------------------------------------
def _platform(platform: str) -> str:
    """``platform``, or the running world's platform key when none is
    given: the rows its collectives read (``"gpu"`` on a CUDA world,
    ``"cpu"`` on a CPU one); "" before Init."""
    if platform:
        return platform
    from ompi_tpu_torch.coll import decision as _decision
    from ompi_tpu_torch.runtime.init import _state
    w = _state["world"]
    dev = getattr(w, "device", None)
    return _decision.platform_key(dev) if dev is not None else ""


def decision_table(comm_size: int = 0, multihost: bool = False,
                   platform: str = "") -> Dict[str, Any]:
    """The *effective* per-collective algorithm rules — fixed tables
    after the per-func MCA pins, the tuned dynamic-rules file, the
    multihost/platform branches, and (when ``mpi_base_compress`` is
    on) the compression rows. Without ``platform``, the running world's
    platform rows (the JAX package reads its platform-free rows there)."""
    from ompi_tpu_torch.coll import decision as _decision
    from ompi_tpu_torch.coll.tuned import _load_rules
    dyn = _load_rules(_var.var_get("coll_tuned_dynamic_rules", "") or "")
    return _decision.decision_table(comm_size, multihost, dyn,
                                    _platform(platform))


def decision_query(func: str, comm_size: int, nbytes: int,
                   multihost: bool = False, platform: str = "",
                   dtype: str = "float32", op=None) -> Dict[str, Any]:
    """What would run: the algorithm the decision layer picks for one
    (func, comm_size, nbytes) tuple plus whether the compressed path
    would claim it first (same gates coll/compressed applies)."""
    from ompi_tpu_torch.coll import decision as _decision
    from ompi_tpu_torch.coll.tuned import _load_rules
    dyn = _load_rules(_var.var_get("coll_tuned_dynamic_rules", "") or "")
    alg = _decision.decide(func, comm_size, nbytes, multihost, dyn,
                           _platform(platform))
    compressed = _decision.compress_eligible(func, nbytes, dtype, op)
    out: Dict[str, Any] = {"func": func, "algorithm": alg,
                           "compressed": compressed}
    if compressed:
        from ompi_tpu_torch import compress
        out["codec"] = compress.codec_name()
    return out


# -- events (MPI_T_event_*, ompi/mpi/tool/events.c shape) -------------------
# An event handle binds a callback to one event type; the backend is the
# profiling hook chain (the PMPI/PERUSE instrumentation point), filtered
# by event name.
class _EventHandle:
    def __init__(self, name: str, cb):
        self.name = name
        self.dropped = 0                 # MPI_T_event dropped-data count

        def _shim(event, comm, info):
            if event == name:
                try:
                    cb(event, comm, info)
                except Exception:
                    # count against THIS handle, then let fire()'s
                    # chain-level accounting log + count globally
                    self.dropped += 1
                    raise
        self._shim = _hooks.register_profiler(_shim)

    def free(self) -> None:
        _hooks.unregister_profiler(self._shim)


def event_get_num() -> int:
    return len(_hooks.known_events())


def event_list() -> List[str]:
    return _hooks.known_events()


def event_get_info(index: int) -> Dict[str, Any]:
    name = _hooks.known_events()[index]
    return {"name": name, "verbosity": 1,
            "desc": f"framework event {name}"}


def event_handle_alloc(name: str, cb) -> _EventHandle:
    """MPI_T_event_handle_alloc: ``cb(event, comm, info)`` fires on
    every occurrence of event type ``name``."""
    if name not in _hooks.known_events():
        _hooks.declare_event(name)
    return _EventHandle(name, cb)


def event_handle_free(handle: _EventHandle) -> None:
    handle.free()
