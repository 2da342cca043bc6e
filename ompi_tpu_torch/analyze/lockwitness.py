"""lockwitness — the runtime lock-order witness (dynamic half of
``ompi_tpu_torch.analyze``; the static half is mpilint). The port of
``ompi_tpu/analyze/lockwitness.py``.

The FreeBSD WITNESS / Linux lockdep idea scaled to this stack's lock
sites: while armed, every ``threading.Lock``/``threading.RLock``
CREATED afterwards is wrapped so the witness can record, at every
acquire, the set of locks the acquiring thread already holds. Each
(held-site -> acquired-site) pair becomes an edge in the global
acquisition-order graph; a cycle in that graph is a potential deadlock
(two threads can interleave the inverse orders), reported with the
first-observed acquisition stack of BOTH directions. Release time is
measured per acquire and long holds past ``mpi_base_lockwitness_hold_us``
are recorded, with the high-watermark surfaced as the pvar
``lockwitness_max_hold_us``.

Lock *identity* is the creation site (``file:line``), not the instance:
the per-peer / per-rail lock dicts in btl/tcp create hundreds of
instances from one line, and ordering discipline is per-site — exactly
like lockdep's lock classes. Same-site nesting (two peers' locks held
together) is recorded as a self-edge and listed, but excluded from
cycle detection by default: instance-level order within one class needs
runtime keys the witness does not have.

Gate contract (the trace/inject precedent): with
``mpi_base_lockwitness`` unset nothing is touched —
``threading.Lock`` IS the interpreter's original factory and the hot
paths are byte-identical (gate-tested by
tests/test_torch_analyze_lockwitness.py). Locks created BEFORE
``install()`` stay unwrapped; ``runtime/init`` arms the witness from the
var before transport bring-up (the mpirun route: ``--mca
mpi_base_lockwitness 1``, i.e. ``OMPI_TPU_TORCH_MCA_mpi_base_lockwitness=1``),
so endpoint bring-up creates witnessed locks. ``install()`` rebinds
``threading.Lock`` process-wide: a test that installs it uninstalls it.

Drill: the port's p40 (tests/test_torch_analyze_multiproc.py) runs
sends, persistent collectives and ft heartbeats concurrently under the
witness, with CUDA payloads over devxfer on a card, and asserts the
merged graph is acyclic (via ``tools/tracedump summary``).
"""
from __future__ import annotations

import json
import os
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

from ompi_tpu_torch.mca import var as _var

# originals, captured before any install() can rebind them
_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF_FILE = os.path.abspath(__file__)

installed = False            # factories rebound?
_recording = True            # wrappers record (flipped off by disable())

# witness state — guarded by a REAL lock (the witness must not witness
# itself) and touched only on acquire/release of wrapped locks
_state_lock = _ORIG_LOCK()
_sites: Dict[str, int] = {}                  # site -> locks created
_edges: Dict[Tuple[str, str], Dict[str, Any]] = {}
_long_holds: List[Dict[str, Any]] = []
_max_hold_us = 0.0
_hold_threshold_us = 5000.0
_tls = threading.local()                     # .held: per-thread vector

_LONG_HOLD_CAP = 64
_STACK_DEPTH = 12


def register_params() -> None:
    _var.var_register(
        "mpi", "base", "lockwitness", vtype="bool", default=False,
        help="Arm the runtime lock-order witness: wrap locks created "
             "after install, build the acquisition-order graph, report "
             "cycles (potential deadlocks) and long holds; off = "
             "threading.Lock untouched")
    _var.var_register(
        "mpi", "base", "lockwitness_hold_us", vtype="float",
        default=5000.0,
        help="Hold-time threshold in microseconds: a wrapped lock held "
             "longer is recorded as a long hold; the high-watermark is "
             "the pvar lockwitness_max_hold_us")


def _creation_site() -> str:
    """``relpath:line`` of the frame creating the lock — skipping this
    module and threading.py so Condition()'s internal RLock() keys on
    the Condition's creator."""
    for frame, lineno in traceback.walk_stack(None):
        fn = os.path.abspath(frame.f_code.co_filename)
        if fn == _SELF_FILE or fn.endswith(os.sep + "threading.py"):
            continue
        if fn.startswith(_PKG_ROOT + os.sep):
            rel = os.path.relpath(fn, _PKG_ROOT).replace(os.sep, "/")
            return f"{rel}:{lineno}"
        return f"{os.path.basename(fn)}:{lineno}"
    return "<unknown>"


def _held() -> List[List[Any]]:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _stack() -> List[str]:
    # last frames below the wrapper (acquire internals trimmed)
    raw = traceback.format_stack(limit=_STACK_DEPTH + 2)[:-2]
    return [ln.rstrip("\n") for ln in raw]


def _note_acquire(lock: "_WitnessLockBase") -> None:
    if not _recording:
        return
    held = _held()
    for ent in held:
        if ent[0] is lock:               # reentrant RLock acquire
            ent[3] += 1
            return
    site = lock._site
    new_edges = [(ent[1], site) for ent in held
                 if (ent[1], site) not in _edges]
    if new_edges or held:
        stk = _stack() if new_edges else None
        with _state_lock:
            for a, b in [(ent[1], site) for ent in held]:
                e = _edges.get((a, b))
                if e is None:
                    _edges[(a, b)] = {"count": 1, "stack": stk}
                else:
                    e["count"] += 1
    held.append([lock, site, time.perf_counter(), 1])


def _note_release(lock: "_WitnessLockBase") -> None:
    if not _recording:
        return
    global _max_hold_us
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        ent = held[i]
        if ent[0] is lock:
            ent[3] -= 1
            if ent[3] == 0:
                del held[i]
                us = (time.perf_counter() - ent[2]) * 1e6
                if us > _max_hold_us or us > _hold_threshold_us:
                    with _state_lock:
                        if us > _max_hold_us:
                            _max_hold_us = us
                        if us > _hold_threshold_us \
                                and len(_long_holds) < _LONG_HOLD_CAP:
                            _long_holds.append(
                                {"site": ent[1], "us": round(us, 1)})
            return
    # release of a lock acquired before install/enable: ignore


class _WitnessLockBase:
    """Shared wrapper shell; ``_lk`` is the real primitive."""

    __slots__ = ("_lk", "_site")

    def __init__(self) -> None:
        self._site = _creation_site()
        with _state_lock:
            _sites[self._site] = _sites.get(self._site, 0) + 1

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lk.acquire(blocking, timeout)
        if ok:
            _note_acquire(self)
        return ok

    def release(self) -> None:
        _note_release(self)
        self._lk.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} site={self._site} {self._lk!r}>"


class WitnessLock(_WitnessLockBase):
    __slots__ = ()

    def __init__(self) -> None:
        super().__init__()
        self._lk = _ORIG_LOCK()

    def locked(self) -> bool:
        return self._lk.locked()


class WitnessRLock(_WitnessLockBase):
    __slots__ = ()

    def __init__(self) -> None:
        super().__init__()
        self._lk = _ORIG_RLOCK()

    # threading.Condition protocol — delegate to the real RLock while
    # keeping the held-vector honest: a wait() fully releases, so the
    # accounting entry is popped and restored around it (restore does
    # NOT re-record edges: the reacquire order out of a wait queue is
    # the scheduler's, not the program's discipline).
    def _release_save(self):
        held = _held()
        ent = None
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                ent = held.pop(i)
                break
        return (self._lk._release_save(), ent)

    def _acquire_restore(self, state) -> None:
        inner, ent = state
        self._lk._acquire_restore(inner)
        if ent is not None and _recording:
            ent[2] = time.perf_counter()
            _held().append(ent)

    def _is_owned(self) -> bool:
        return self._lk._is_owned()


def install() -> None:
    """Rebind ``threading.Lock``/``RLock`` to witness factories and
    register the watermark pvar. Idempotent."""
    global installed, _recording, _hold_threshold_us
    if installed:
        _recording = True
        return
    register_params()
    _hold_threshold_us = float(
        _var.var_get("mpi_base_lockwitness_hold_us", 5000.0))
    from ompi_tpu_torch.mca import pvar as _pvar
    _pvar.pvar_register(
        "lockwitness_max_hold_us", lambda: round(_max_hold_us, 1),
        unit="us", var_class="highwatermark",
        help="Longest observed wrapped-lock hold time")
    _pvar.pvar_register(
        "lockwitness_edges", lambda: len(_edges),
        help="Distinct lock-order edges observed by the witness")
    threading.Lock = WitnessLock        # type: ignore[misc]
    threading.RLock = WitnessRLock      # type: ignore[misc]
    installed = True
    _recording = True


def uninstall() -> None:
    """Restore the interpreter's factories (already-wrapped locks keep
    working — their wrappers hold real primitives)."""
    global installed
    threading.Lock = _ORIG_LOCK         # type: ignore[misc]
    threading.RLock = _ORIG_RLOCK       # type: ignore[misc]
    installed = False


def disable() -> None:
    """Stop recording without unwrapping (mid-run snapshot hygiene)."""
    global _recording
    _recording = False


def reset() -> None:
    """Clear witness state (tests)."""
    global _max_hold_us
    with _state_lock:
        _sites.clear()
        _edges.clear()
        _long_holds.clear()
        _max_hold_us = 0.0


def maybe_install_from_var() -> None:
    """Arm from the MCA var — called by runtime.init before endpoint
    bring-up so transport/progress locks are created wrapped."""
    register_params()
    if bool(_var.var_get("mpi_base_lockwitness", False)):
        install()


# --------------------------------------------------------------------------
# graph analysis / reporting
# --------------------------------------------------------------------------
def find_cycles(edges: Optional[Dict[Tuple[str, str], Dict[str, Any]]]
                = None) -> List[Dict[str, Any]]:
    """Elementary cycles in the acquisition-order graph (DFS back-edge
    extraction; self-loops excluded — see module docstring). Each cycle
    reports its site sequence and every participating edge WITH the
    first-observed acquisition stack of both directions."""
    if edges is None:
        with _state_lock:
            edges = dict(_edges)
    adj: Dict[str, List[str]] = {}
    for (a, b) in edges:
        if a != b:
            adj.setdefault(a, []).append(b)
    for v in adj.values():
        v.sort()
    seen_cycles: set = set()
    out: List[Dict[str, Any]] = []
    color: Dict[str, int] = {}           # 0/abs=white 1=gray 2=black
    path: List[str] = []

    def dfs(u: str) -> None:
        color[u] = 1
        path.append(u)
        for w in adj.get(u, ()):
            if color.get(w, 0) == 0:
                dfs(w)
            elif color.get(w) == 1:
                cyc = path[path.index(w):]
                # canonical rotation for dedup
                k = min(range(len(cyc)), key=lambda i: cyc[i])
                canon = tuple(cyc[k:] + cyc[:k])
                if canon not in seen_cycles:
                    seen_cycles.add(canon)
                    cyc_edges = []
                    for i, a in enumerate(canon):
                        b = canon[(i + 1) % len(canon)]
                        e = edges.get((a, b), {})
                        cyc_edges.append(
                            {"a": a, "b": b,
                             "count": e.get("count", 0),
                             "stack": e.get("stack")})
                    out.append({"sites": list(canon),
                                "edges": cyc_edges})
        path.pop()
        color[u] = 2

    for u in sorted(adj):
        if color.get(u, 0) == 0:
            dfs(u)
    return out


def report() -> Dict[str, Any]:
    """The full witness state — graph, cycles, hold-time record."""
    with _state_lock:
        edges = dict(_edges)
        sites = dict(_sites)
        long_holds = list(_long_holds)
        max_hold = _max_hold_us
    cycles = find_cycles(edges)
    if cycles:
        # flight-recorder trigger: a lock-order cycle is incident
        # evidence even before it wedges anything (no-op when the
        # telemetry plane is off; rate-limited inside)
        from ompi_tpu_torch import telemetry as _telemetry
        if _telemetry.active:
            from ompi_tpu_torch.telemetry import flightrec as _flightrec
            _flightrec.record("lockwitness_cycle",
                              {"cycles": len(cycles),
                               "sites": cycles[0].get("sites")})
    return {
        "installed": installed,
        "sites": sites,
        "edges": [{"a": a, "b": b, "count": e["count"],
                   "stack": e.get("stack")}
                  for (a, b), e in sorted(edges.items())],
        "cycles": cycles,
        "max_hold_us": round(max_hold, 1),
        "long_holds": long_holds,
        "hold_threshold_us": _hold_threshold_us,
    }


def dump(path: str, rank: int = -1) -> None:
    """Persist the witness report (the ``trace.dump`` analogue);
    ``tools/tracedump summary`` merges these per-rank files into one
    graph and re-runs cycle detection on the union."""
    obj = {"lockwitness": report(), "rank": rank}
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1)
    os.replace(tmp, path)


def merge_reports(reports: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Union per-rank witness reports: summed edge counts, re-run cycle
    detection on the merged graph (an inversion SPLIT across ranks is
    not a deadlock — each process has its own locks — but within-rank
    edges from all ranks sharpen per-site statistics)."""
    edges: Dict[Tuple[str, str], Dict[str, Any]] = {}
    sites: Dict[str, int] = {}
    max_hold = 0.0
    long_holds: List[Dict[str, Any]] = []
    per_rank_cycles: Dict[int, List[Dict[str, Any]]] = {}
    for idx, rep in enumerate(reports):
        lw = rep.get("lockwitness", rep)
        rank = int(rep.get("rank", idx))
        for e in lw.get("edges", []):
            k = (e["a"], e["b"])
            cur = edges.get(k)
            if cur is None:
                edges[k] = {"count": e["count"], "stack": e.get("stack")}
            else:
                cur["count"] += e["count"]
                if cur.get("stack") is None:
                    cur["stack"] = e.get("stack")
        for s, n in lw.get("sites", {}).items():
            sites[s] = sites.get(s, 0) + n
        max_hold = max(max_hold, float(lw.get("max_hold_us", 0.0)))
        long_holds.extend(lw.get("long_holds", []))
        cycs = lw.get("cycles", [])
        if cycs:
            per_rank_cycles[rank] = cycs
    return {
        "ranks": len(reports),
        "sites": sites,
        "edges": [{"a": a, "b": b, **e}
                  for (a, b), e in sorted(edges.items())],
        "cycles": find_cycles(edges),
        "per_rank_cycles": per_rank_cycles,
        "max_hold_us": round(max_hold, 1),
        "long_holds": long_holds[:_LONG_HOLD_CAP],
    }
