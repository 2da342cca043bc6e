"""MCA variable system — the single typed config plane.

Behavioral spec from the reference: ``opal/mca/base/mca_base_var.c``
(registration :426-514, env sourcing :304, param files :426-438) — typed,
registered variables with precedence  default < param file < environment <
programmatic/CLI, and per-variable *source tracking* so tools can report
where a value came from (``mca_base_var.h:135,291``).

Variables are named ``<framework>_<component>_<name>`` (e.g.
``coll_torch_priority``). Environment overrides use
``OMPI_TPU_TORCH_MCA_<framework>_<component>_<name>`` — a prefix of its
own, so one process can hold this package and ``ompi_tpu`` without either
reading the other's settings. The param file is JSON at
``$OMPI_TPU_TORCH_PARAM_FILE``, read only when that variable is set.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import os
import sys
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

ENV_PREFIX = "OMPI_TPU_TORCH_MCA_"
PARAM_FILE_ENV = "OMPI_TPU_TORCH_PARAM_FILE"

# Source precedence, low to high (mirrors MCA_BASE_VAR_SOURCE_*).
SOURCE_DEFAULT = "default"
SOURCE_FILE = "file"
SOURCE_ENV = "env"
SOURCE_SET = "api"          # programmatic var_set / CLI

_PRECEDENCE = {SOURCE_DEFAULT: 0, SOURCE_FILE: 1, SOURCE_ENV: 2, SOURCE_SET: 3}

_COERCE: Dict[str, Callable[[Any], Any]] = {
    "int": lambda v: int(v),
    "float": lambda v: float(v),
    "bool": lambda v: (v if isinstance(v, bool)
                       else str(v).strip().lower() in ("1", "true", "yes", "on")),
    "str": lambda v: str(v),
}


@dataclass
class _Var:
    name: str                      # full "<framework>_<component>_<name>"
    vtype: str
    default: Any
    help: str = ""
    value: Any = None
    source: str = SOURCE_DEFAULT
    enumerator: Optional[List[Any]] = None   # the allowed values, if any
    site: str = ""                 # "file.py:line" of the owning register


_lock = threading.Lock()
_registry: Dict[str, _Var] = {}
_param_file_cache: Optional[Dict[str, Any]] = None
_epoch = 0


def _load_param_file() -> Dict[str, Any]:
    global _param_file_cache
    if _param_file_cache is not None:
        return _param_file_cache
    path = os.environ.get(PARAM_FILE_ENV)
    data: Dict[str, Any] = {}
    if path:
        try:
            with open(path) as f:
                data = json.load(f)
            if not isinstance(data, dict):
                data = {}
        except (OSError, ValueError):
            data = {}
    _param_file_cache = data
    return data


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


def var_register(framework: str, component: str, name: str, *,
                 vtype: str = "str", default: Any = None,
                 help: str = "",
                 enumerator: Optional[List[Any]] = None) -> Any:
    """Register a typed variable; resolve its value through the precedence
    chain and return the resolved value (as ``mca_base_var_register`` does
    via its out-param). With an ``enumerator``, a file or environment
    value outside it resolves to the default (``var_set`` stays
    unchecked, as in the reference).

    Re-registering from the SAME call site or with the same
    (vtype, default) shape is a no-op returning the live value; a
    DIFFERENT site claiming the name with a conflicting vtype/default
    raises."""
    global _epoch
    full = "_".join(p for p in (framework, component, name) if p)
    coerce = _COERCE[vtype]
    site = _caller_site()
    with _lock:
        if full in _registry:
            v = _registry[full]
            if v.site != site and (v.vtype != vtype
                                   or v.default != default):
                raise ValueError(
                    f"MCA var '{full}' re-registered at {site} with "
                    f"conflicting type/default ({vtype!r}, {default!r})"
                    f" — owner is {v.site} ({v.vtype!r}, {v.default!r})")
            return v.value
        _epoch += 1
        v = _Var(name=full, vtype=vtype, default=default, help=help,
                 enumerator=enumerator, site=site)
        v.value, v.source = _resolve(full, coerce, default)
        if enumerator is not None and v.value not in enumerator:
            v.value, v.source = default, SOURCE_DEFAULT
        _registry[full] = v
        return v.value


def _resolve(full: str, coerce, default):
    value, source = default, SOURCE_DEFAULT
    fdata = _load_param_file()
    if full in fdata:
        try:
            value, source = coerce(fdata[full]), SOURCE_FILE
        except (ValueError, TypeError):
            pass
    env_key = ENV_PREFIX + full
    if env_key in os.environ:
        try:
            value, source = coerce(os.environ[env_key]), SOURCE_ENV
        except (ValueError, TypeError):
            pass
    return value, source


def var_get(full: str, default: Any = None) -> Any:
    scopes = _scope_stack.get()
    if scopes:                       # innermost active scope wins
        for sc in reversed(scopes):
            if full in sc.values:
                return sc.values[full]
    with _lock:
        v = _registry.get(full)
        return v.value if v is not None else default


class VarScope:
    """A private override layer for the var store — the per-instance
    parameter state of MPI-4 Sessions (``ompi/instance/instance.c``:
    each instance bootstraps its own MCA scope). Values set here are
    visible only while the scope is active (``with scope(s): ...``) and
    never bleed into the global store or other scopes."""

    def __init__(self):
        self.values: Dict[str, Any] = {}
        self._epoch = 0              # folded into epoch()

    def set(self, full: str, value: Any) -> None:
        with _lock:
            v = _registry.get(full)
        if v is not None:
            value = _COERCE[v.vtype](value)
        self.values[full] = value
        self._epoch += 1             # invalidate this scope's memo keys

    def unset(self, full: str) -> None:
        if self.values.pop(full, None) is not None:
            self._epoch += 1


_scope_stack: "contextvars.ContextVar[tuple]" = contextvars.ContextVar(
    "ompi_tpu_torch_var_scopes", default=())


def current_scopes() -> tuple:
    """Snapshot of the active scope stack — for deferred work (the
    rounds of a nonblocking schedule, run later by the progress engine)
    that must observe the scopes of its creation context."""
    return _scope_stack.get()


@contextlib.contextmanager
def scopes_active(stack: tuple):
    """Re-establish a snapshot taken with :func:`current_scopes`."""
    tok = _scope_stack.set(stack)
    try:
        yield
    finally:
        _scope_stack.reset(tok)


@contextlib.contextmanager
def scope(s: VarScope):
    """Activate a VarScope for the dynamic extent (decision layers and
    component selection read through it). Scope identity is folded into
    ``epoch()`` rather than bumping the global counter: a world
    communicator's memo entries stay hot while session and world
    collectives interleave, and each scope's entries key on its own
    (identity, epoch)."""
    tok = _scope_stack.set(_scope_stack.get() + (s,))
    try:
        yield s
    finally:
        _scope_stack.reset(tok)


def epoch():
    """Validity token for var-derived memos: the global mutation counter
    (bumped on every registration and every effective ``var_set``) alone
    when no scope is active — a plain int, the hot path — else a tuple
    folding in each active scope's (identity, epoch), so a session's
    overrides key its own memo entries without invalidating the
    world's. Compare with ``==``; never assume int."""
    scopes = _scope_stack.get()
    if not scopes:
        return _epoch
    return (_epoch,) + tuple((id(s), s._epoch) for s in scopes)


def bump_epoch() -> None:
    """Invalidate epoch-keyed memos for a decision-input change the var
    store itself cannot observe (the tuned dynamic-rules file reloading
    on an mtime change)."""
    global _epoch
    with _lock:
        _epoch += 1


def var_set(full: str, value: Any, source: str = SOURCE_SET) -> None:
    """Programmatic override (highest precedence)."""
    global _epoch
    with _lock:
        v = _registry.get(full)
        if v is None:
            raise KeyError(f"MCA var not registered: {full}")
        if _PRECEDENCE[source] >= _PRECEDENCE[v.source]:
            v.value = _COERCE[v.vtype](value)
            v.source = source
            _epoch += 1


def var_source(full: str) -> Optional[str]:
    with _lock:
        v = _registry.get(full)
        return v.source if v is not None else None


def var_overridden(full: str) -> bool:
    """True when a non-default value is in effect for ``full`` — an
    active session scope's override (which ``var_source`` cannot see),
    or env, file or ``var_set``: probe-earned defaults (the staged
    tier's switch point, the bml's sm threshold) yield to both."""
    for sc in reversed(_scope_stack.get()):
        if full in sc.values:
            return True
    return var_source(full) not in (None, SOURCE_DEFAULT)


def var_dump() -> List[Dict[str, Any]]:
    """Introspect all registered vars (``ompi_info -a`` equivalent)."""
    with _lock:
        return [
            {"name": v.name, "type": v.vtype, "value": v.value,
             "default": v.default, "source": v.source, "help": v.help,
             "enumerator": v.enumerator, "site": v.site}
            for v in sorted(_registry.values(), key=lambda v: v.name)
        ]


def var_list() -> List[Dict[str, Any]]:
    """Registered vars with their metadata, symmetric to
    ``pvar.pvar_list()``."""
    return var_dump()


def var_names() -> List[str]:
    """Names only, symmetric to ``pvar.pvar_names()``."""
    with _lock:
        return sorted(_registry)


def _reset_for_tests() -> None:
    global _epoch, _param_file_cache
    with _lock:
        _registry.clear()
        _epoch += 1
    _param_file_cache = None
