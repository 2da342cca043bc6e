"""ft/inject — the deterministic fault-injection plane (the port of
``ompi_tpu/ft/inject.py``).

Injection is a first-class MCA-configured subsystem so every fault class
the stack claims to survive has a deterministic, CI-runnable drill (one
``test_ft_<class>_recovers`` job per class).

Fault classes (``FAULT_CLASSES``), one MCA var each, all prefixed
``mpi_base_ft_inject_``:

- ``drop``    — swallow a matching bml frame before it is sequence-
  stamped (models loss before the wire; the receiver simply never
  sees the message, no reorder-buffer hole is created).
- ``delay``   — sleep a matching btl frame's sender (models congestion
  / a stalled peer; the detector's hysteresis must NOT read a delay
  under ``ft_hb_timeout`` as a death).
- ``corrupt`` — send a deliberately bad magic prefix on the tcp
  stream (models wire corruption; the receiver's framing check drops
  the connection WITHOUT a death report and the next send reconnects).
- ``sever``   — abruptly close the rail-0 socket to a peer (models a
  network cut; the peer's reader sees an identified EOF — exactly a
  death's signature — so survivors exercise the full ULFM path).
- ``kill``    — ``os._exit`` this rank at a named program point
  (models SIGKILL mid-collective). The process exits with a live CUDA
  context, as a SIGKILL leaves it; the context dies with the process.

Spec grammar (one spec per var): comma-separated ``key=value`` pairs —
``rank`` (which rank injects; omit = every rank), ``plane``
(``pml``/``tcp``/``sm``; omit = any), ``peer`` (destination filter),
``nth`` (1-based: act on the nth eligible frame, default 1), ``count``
(how many matches fire, default 1; ``-1`` = unlimited), ``ms`` (delay
only, default 50), ``point``/``hit`` (kill only: program-point name
and 1-based hit number). Example::

    --mca mpi_base_ft_inject 1 \
    --mca mpi_base_ft_inject_kill rank=2,point=coll.allreduce,hit=2

Gate contract: with ``mpi_base_ft_inject`` unset the hooks cost ONE
module attribute read (``if _inject.active:``) and the wire is
byte-identical.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

from ompi_tpu_torch.mca import var as _var

FAULT_CLASSES = ("drop", "delay", "corrupt", "sever", "kill")

# per-class spec var, spelled as literals so every name can be found
# beside its var_register site
_SPEC_VARS = {
    "drop": "mpi_base_ft_inject_drop",
    "delay": "mpi_base_ft_inject_delay",
    "corrupt": "mpi_base_ft_inject_corrupt",
    "sever": "mpi_base_ft_inject_sever",
    "kill": "mpi_base_ft_inject_kill",
}

# THE zero-cost gate: every btl hook reads this one attribute and
# falls through when False (the _trace.active idiom).
active = False

# how many faults actually fired, per class (pvar ``ft_injected``)
stats: Dict[str, int] = {c: 0 for c in FAULT_CLASSES}

_lock = threading.Lock()
_my_rank: Optional[int] = None
_specs: Dict[str, Optional[Dict[str, Any]]] = {c: None
                                               for c in FAULT_CLASSES}
# per-class monotone counters: eligible-frame matches and fired faults
_seen: Dict[str, int] = {}
_fired: Dict[str, int] = {}
_point_hits: Dict[str, int] = {}


def register_params() -> None:
    _var.var_register(
        "mpi", "base", "ft_inject", vtype="bool", default=False,
        help="Master switch for the deterministic fault-injection "
             "plane; off = byte-identical wire behavior")
    _var.var_register(
        "mpi", "base", "ft_inject_drop", vtype="str", default="",
        help="Drop spec: rank=R,plane=pml|tcp|sm,peer=P,nth=N,count=C "
             "— swallow matching frames before sequence stamping")
    _var.var_register(
        "mpi", "base", "ft_inject_delay", vtype="str", default="",
        help="Delay spec: rank=R,plane=...,peer=P,nth=N,count=C,ms=M "
             "— sleep the sender before matching frames")
    _var.var_register(
        "mpi", "base", "ft_inject_corrupt", vtype="str", default="",
        help="Corrupt spec: rank=R,peer=P,nth=N,count=C — send a bad "
             "magic prefix on the tcp stream (receiver drops the "
             "connection, no death report)")
    _var.var_register(
        "mpi", "base", "ft_inject_sever", vtype="str", default="",
        help="Sever spec: rank=R,peer=P,nth=N — abruptly close the "
             "rail-0 connection to the peer (reads as death there)")
    _var.var_register(
        "mpi", "base", "ft_inject_kill", vtype="str", default="",
        help="Kill spec: rank=R,point=NAME,hit=H — os._exit this rank "
             "at the H-th crossing of the named program point")


def _parse(spec: str) -> Optional[Dict[str, Any]]:
    spec = (spec or "").strip()
    if not spec:
        return None
    out: Dict[str, Any] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        k, v = part.split("=", 1)
        k, v = k.strip(), v.strip()
        if k in ("rank", "peer", "nth", "count", "hit"):
            out[k] = int(v)
        elif k == "ms":
            out[k] = float(v)
        else:
            out[k] = v
    out.setdefault("nth", 1)
    out.setdefault("count", 1)
    return out


def refresh(rank: Optional[int] = None) -> None:
    """(Re)read the MCA vars; called at endpoint bring-up with the
    process's world rank, and by tests after ``var_set``."""
    global active, _my_rank
    with _lock:
        if rank is not None:
            _my_rank = rank
        enabled = bool(_var.var_get("mpi_base_ft_inject", False))
        any_spec = False
        for c in FAULT_CLASSES:
            s = _parse(_var.var_get(_SPEC_VARS[c], ""))
            _specs[c] = s
            any_spec = any_spec or s is not None
        _seen.clear()
        _fired.clear()
        _point_hits.clear()
        for c in FAULT_CLASSES:
            stats[c] = 0
        active = enabled and any_spec


def _match(cls: str, plane: Optional[str], peer: Optional[int]
           ) -> Optional[Dict[str, Any]]:
    """One eligible frame against one class's spec; returns the spec
    when THIS occurrence should fire. Must be called with the gate
    already open (``active``)."""
    s = _specs[cls]
    if s is None:
        return None
    if "rank" in s and _my_rank is not None and s["rank"] != _my_rank:
        return None
    if plane is not None and "plane" in s and s["plane"] != plane:
        return None
    if peer is not None and "peer" in s and s["peer"] != peer:
        return None
    with _lock:
        n = _seen[cls] = _seen.get(cls, 0) + 1
        if n < s["nth"]:
            return None
        fired = _fired.get(cls, 0)
        if s["count"] >= 0 and fired >= s["count"]:
            return None
        _fired[cls] = fired + 1
        stats[cls] += 1
    return s


def frame_fault(plane: str, peer: int) -> Optional[Tuple[str, float]]:
    """Drop/delay decision for one outbound frame on ``plane`` to
    ``peer``. Returns ``("drop", 0)``, ``("delay", seconds)``, or
    None. Delay sleeps are the CALLER's job (the sm hook must not
    sleep holding ring locks)."""
    s = _match("drop", plane, peer)
    if s is not None:
        return ("drop", 0.0)
    s = _match("delay", plane, peer)
    if s is not None:
        return ("delay", s.get("ms", 50.0) / 1e3)
    return None


def should_corrupt(peer: int) -> bool:
    """Corrupt the next tcp frame's magic prefix to ``peer``?"""
    return _match("corrupt", "tcp", peer) is not None


def should_sever(peer: int) -> bool:
    """Abruptly cut the rail-0 connection to ``peer``?"""
    return _match("sever", "tcp", peer) is not None


def point(name: str) -> None:
    """Named program point (kill sites: ``coll.allreduce``,
    ``pml.send``, ...). A matching kill spec ``os._exit``s the process
    — the closest deterministic stand-in for SIGKILL mid-operation."""
    s = _specs["kill"]
    if s is None or s.get("point") != name:
        return
    if "rank" in s and _my_rank is not None and s["rank"] != _my_rank:
        return
    with _lock:
        h = _point_hits[name] = _point_hits.get(name, 0) + 1
    if h != s.get("hit", 1):
        return
    stats["kill"] += 1
    import os
    import sys
    sys.stderr.write(f"ft/inject: killing rank {_my_rank} at "
                     f"program point {name!r} (hit {h})\n")
    sys.stderr.flush()
    os._exit(137)                        # the SIGKILL exit signature


def delay_now(seconds: float) -> None:
    """The delay executor for hooks that may sleep in place."""
    if seconds > 0:
        time.sleep(seconds)


def _register_pvars() -> None:
    from ompi_tpu_torch.mca import pvar
    pvar.pvar_register_dict(
        "ft_injected", stats,
        help_prefix="Faults fired by ft/inject, class ")


_register_pvars()
