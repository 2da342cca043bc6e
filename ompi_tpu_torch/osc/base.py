"""osc/base — the one-sided framework's shared plane.

Mirrors ``ompi/mca/osc/base``, as the JAX package's ``osc/base.py``
ports it: the component-independent state every osc component shares —
MCA parameters, MPI_T pvars, telemetry histograms, and the epoch state
machine (``osc_base_frame.c`` + the synchronization legality table of
MPI-3 ch. 11.5).

The epoch machine is ORIGIN-side bookkeeping: each window tracks which
access epochs are plausibly open (fence / per-target passive locks /
lock_all / PSCW start set) and refuses data ops outside all of them
with ``MPI_ERR_RMA_SYNC``.  One deliberate looseness, shared with the
reference: a fence with no assert info both ends an epoch and may
start the next, so once any fence has run the window stays
fence-accessible until freed — the machine catches the real bug
classes (op before any sync, unlock without lock, flush outside a
passive epoch, fence inside a passive epoch, complete without start)
without false-positives on legal fence-then-lock programs.
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List, Optional, Set

from ompi_tpu_torch.core.errhandler import ERR_RMA_SYNC, MPIError
from ompi_tpu_torch.mca import pvar as _pvar
from ompi_tpu_torch.mca import var

# the osc ops every component must serve; each has a parity test that
# holds the shm component against pt2pt and a numpy reference
OSC_OPS = ("put", "get", "accumulate")

def register_params() -> None:
    """Register the framework's MCA vars (idempotent: callers run it
    before each read, so the vars come back after a var-store reset)."""
    var.var_register(
        "mpi", "base", "osc", vtype="str", default="auto",
        help="One-sided component selection at window creation: "
             "'shm' backs same-host windows with /dev/shm segments "
             "(direct load/store RMA), 'pt2pt' emulates the window "
             "over the acked active-message plane, 'auto' picks shm "
             "when every rank of the communicator shares the host "
             "(docs/RMA.md)")
    var.var_register(
        "mpi", "base", "osc_epoch_check", vtype="bool", default=True,
        help="Enforce the MPI-3 epoch discipline on window ops: data "
             "ops outside every open access epoch, unlock without "
             "lock, flush outside a passive epoch and fence inside "
             "one raise MPI_ERR_RMA_SYNC instead of corrupting "
             "memory silently")
    var.var_register(
        "mpi", "base", "osc_shm_notes", vtype="bool", default=True,
        help="osc/shm: after a direct remote put/accumulate, send the "
             "target a descriptor-only note frame so its pvars "
             "account bytes landed in its window by peers (the "
             "completion/accounting ctl plane; off drops the frames, "
             "never the data)")


# -- pvars ------------------------------------------------------------------
stats: Dict[str, int] = {
    "puts": 0, "gets": 0, "accs": 0,
    "put_bytes": 0, "get_bytes": 0, "acc_bytes": 0,
    "fences": 0, "locks": 0, "epoch_errors": 0,
    "windows_shm": 0, "windows_pt2pt": 0, "notes": 0,
    "ft_failed_epochs": 0,
}

_pvars_registered = False


def register_pvars() -> None:
    global _pvars_registered
    if _pvars_registered:
        return
    _pvars_registered = True
    _pvar.pvar_register(
        "osc_puts", lambda: stats["puts"],
        help="One-sided Put operations issued by this process "
             "(both osc components; docs/RMA.md)")
    _pvar.pvar_register(
        "osc_gets", lambda: stats["gets"],
        help="One-sided Get operations issued by this process")
    _pvar.pvar_register(
        "osc_accs", lambda: stats["accs"],
        help="One-sided Accumulate-class operations issued by this "
             "process (accumulate/get_accumulate/fetch_and_op/CAS)")
    _pvar.pvar_register(
        "osc_put_bytes", lambda: stats["put_bytes"], unit="bytes",
        help="Bytes written into remote windows by this process's "
             "Put operations")
    _pvar.pvar_register(
        "osc_get_bytes", lambda: stats["get_bytes"], unit="bytes",
        help="Bytes read from remote windows by this process's Get "
             "operations")
    _pvar.pvar_register(
        "osc_acc_bytes", lambda: stats["acc_bytes"], unit="bytes",
        help="Bytes combined into remote windows by this process's "
             "accumulate-class operations")
    _pvar.pvar_register(
        "osc_fences", lambda: stats["fences"],
        help="Win_fence epoch boundaries this process crossed")
    _pvar.pvar_register(
        "osc_locks", lambda: stats["locks"],
        help="Passive-target locks this process acquired (Win_lock "
             "grants, exclusive and shared)")
    _pvar.pvar_register(
        "osc_epoch_errors", lambda: stats["epoch_errors"],
        help="RMA calls refused with MPI_ERR_RMA_SYNC by the epoch "
             "state machine (op outside every open epoch)")
    _pvar.pvar_register(
        "osc_windows_shm", lambda: stats["windows_shm"],
        help="Windows this process created on the osc/shm component "
             "(same-host /dev/shm segment windows)")
    _pvar.pvar_register(
        "osc_windows_pt2pt", lambda: stats["windows_pt2pt"],
        help="Windows this process created on the osc/pt2pt "
             "component (active-message emulation)")
    _pvar.pvar_register(
        "osc_notes", lambda: stats["notes"],
        help="Descriptor-only completion notes received from peers "
             "that wrote this process's shm windows directly")
    _pvar.pvar_register(
        "osc_ft_failed_epochs", lambda: stats["ft_failed_epochs"],
        help="Open window epochs failed with MPI_ERR_PROC_FAILED "
             "because a peer of the window died")


# -- telemetry histograms ----------------------------------------------------
def op_hist(kind: str):
    """The per-op-kind latency histogram (``tele_osc_put_us`` /
    ``tele_osc_get_us`` / ``tele_osc_acc_us``), created lazily so a
    telemetry-off process never allocates them. Callers gate on
    ``telemetry.active`` themselves (the hot-path discipline)."""
    from ompi_tpu_torch import telemetry as _tele
    return _tele.get_hist(
        f"tele_osc_{kind}_us", unit="us",
        help=f"One-sided {kind} origin-side completion latency "
             f"(docs/RMA.md)")


# -- live-window registry (flight recorder) ---------------------------------
_live_lock = threading.Lock()
_live: "weakref.WeakSet" = weakref.WeakSet()


def track_window(win) -> None:
    with _live_lock:
        _live.add(win)


def untrack_window(win) -> None:
    with _live_lock:
        _live.discard(win)


def open_epoch_state() -> List[Dict[str, Any]]:
    """Every live window's epoch state — the flight recorder's
    ``osc_epochs`` section (what was open when the incident fired)."""
    with _live_lock:
        wins = list(_live)
    out = []
    for w in wins:
        try:
            ep = w._epoch
            st = {"win": w.name, "component": w.component,
                  "fenced": ep.fenced, "lock_all": ep.lock_all,
                  "locked": sorted(ep.locked),
                  "pscw_access": sorted(ep.pscw_access),
                  "pscw_exposure": sorted(ep.pscw_exposure),
                  "dead_peers": sorted(getattr(w, "_dead", ()))}
            if (ep.fenced or ep.lock_all or ep.locked
                    or ep.pscw_access or ep.pscw_exposure
                    or st["dead_peers"]):
                out.append(st)
        except Exception:                # noqa: BLE001 — advisory only
            pass
    return out


# -- epoch state machine -----------------------------------------------------
class EpochState:
    """Origin-side access-epoch legality (MPI-3 ch. 11.5).

    States tracked: ``fenced`` (a Win_fence has run — active-target
    access plausibly open until the window dies), per-target passive
    ``locked`` map, ``lock_all``, and the PSCW ``start`` target set
    (access) / ``post`` origin set (exposure)."""

    def __init__(self) -> None:
        self.fenced = False
        self.lock_all = False
        self.locked: Dict[int, int] = {}      # target -> lock type
        self.pscw_access: Set[int] = set()
        self.pscw_exposure: Set[int] = set()

    # -- data-op legality ----------------------------------------------
    def check_access(self, target: int, op: str) -> None:
        if (self.fenced or self.lock_all or target in self.locked
                or target in self.pscw_access):
            return
        raise MPIError(
            ERR_RMA_SYNC,
            f"RMA {op} to rank {target} outside every access epoch "
            f"(no fence has run, target not locked, no lock_all, "
            f"not in the Win_start group)")

    # -- synchronization transitions -----------------------------------
    def fence(self) -> None:
        if self.locked or self.lock_all:
            raise MPIError(ERR_RMA_SYNC,
                           "Win_fence inside a passive-target epoch "
                           "(unlock first)")
        self.fenced = True

    def lock(self, target: int) -> None:
        if target in self.locked:
            raise MPIError(ERR_RMA_SYNC,
                           f"Win_lock: rank {target} already locked "
                           f"by this origin")
        if self.lock_all:
            raise MPIError(ERR_RMA_SYNC,
                           "Win_lock inside a lock_all epoch")

    def locked_ok(self, target: int, lock_type: int) -> None:
        self.locked[target] = lock_type

    def unlock(self, target: int) -> None:
        if target not in self.locked:
            raise MPIError(ERR_RMA_SYNC,
                           f"Win_unlock: rank {target} is not locked")

    def unlocked_ok(self, target: int) -> None:
        self.locked.pop(target, None)

    def lock_all_begin(self) -> None:
        if self.lock_all:
            raise MPIError(ERR_RMA_SYNC, "Win_lock_all twice")

    def lock_all_ok(self) -> None:
        self.lock_all = True

    def unlock_all(self) -> None:
        if not self.lock_all:
            raise MPIError(ERR_RMA_SYNC,
                           "Win_unlock_all without Win_lock_all")
        self.lock_all = False

    def flush(self, target: Optional[int] = None) -> None:
        if self.lock_all:
            return
        if target is not None and target in self.locked:
            return
        if target is None and self.locked:
            return
        raise MPIError(ERR_RMA_SYNC,
                       "Win_flush outside a passive-target epoch")

    def start(self, targets) -> None:
        self.pscw_access = set(int(t) for t in targets)

    def complete(self) -> None:
        if not self.pscw_access:
            raise MPIError(ERR_RMA_SYNC,
                           "Win_complete without Win_start")
        self.pscw_access = set()

    def post(self, origins) -> None:
        self.pscw_exposure = set(int(o) for o in origins)

    def wait(self) -> None:
        if not self.pscw_exposure:
            raise MPIError(ERR_RMA_SYNC, "Win_wait without Win_post")
        self.pscw_exposure = set()


def _reset_for_tests() -> None:
    for k in stats:
        stats[k] = 0
    with _live_lock:
        _live.clear()


register_params()
register_pvars()
