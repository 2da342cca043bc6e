"""ompi_tpu_torch.telemetry — the always-on telemetry plane (the port of
``ompi_tpu/telemetry/__init__.py``).

The trace ring answers "when / who was late" after the fact; this plane
answers "which rank is slow, on which comm, right now" the way a serving
fleet needs: histogram pvars on the hot paths, a progress-driven
straggler health monitor, a fault flight recorder, and the Prometheus
text exporter (telemetry/prom). Dumps use the reference's format, so its
merge tools read the port's files.

Hot-path contract — identical to every prior plane (trace, inject,
lockwitness): **off = byte-identical**. Every instrumentation point
guards on the module-level ``active`` flag (one attribute read, no
wire-format change, no allocation); the master gate is the MCA var
``mpi_base_telemetry``, armed from runtime init BEFORE any
communicator exists so the coll composers see it. A histogram times the
app-visible call on the host clock: on CUDA tensors that is dispatch and
whatever the call waits on, not kernel completion. No instrumentation
point synchronizes the card.

Value type: :class:`ompi_tpu_torch.telemetry.hist.Histogram` — fixed
log2-bucket, lock-free per-thread shards merged on read, surfaced as
``CLASS_HISTOGRAM`` pvars (p50/p90/p99/max derivation in the read).
Per-communicator instruments are tagged with their cid and retired by
``retire_comm`` on comm free/shrink (pvar session semantics).
"""
from __future__ import annotations

import json
import re
import threading
import time
from typing import Any, Dict, List, Optional

from ompi_tpu_torch.mca import pvar as _pvar
from ompi_tpu_torch.mca import var as _var
from ompi_tpu_torch.telemetry.hist import Histogram, merge_snapshots  # noqa: F401

# THE hot-path gate: instrumentation points read this module attribute
# and do nothing else when telemetry is off. Rebound (never mutated in
# place) by enable()/disable().
active: bool = False

_lock = threading.Lock()
_hists: Dict[str, Histogram] = {}

SIZE_CLASS_NAMES = ("small", "medium", "large", "huge")

# global (non-per-comm) hot-path instruments, armed by enable(); sites
# guard on ``active`` first, so None here is unreachable when it counts
PML_SEND: Optional[Histogram] = None
PML_RECV: Optional[Histogram] = None
SEGMENT: Optional[Histogram] = None
FLUSH: Optional[Histogram] = None
RAIL: Optional[Histogram] = None
SHMSEG: Optional[Histogram] = None
HB_GAP: Optional[Histogram] = None
HB_RTT: Optional[Histogram] = None


def register_params() -> None:
    _var.var_register(
        "mpi", "base", "telemetry", vtype="bool", default=False,
        help="Master gate for the always-on telemetry plane: histogram "
             "pvars on the coll/pml/btl/ft hot paths, the straggler "
             "health monitor, and the fault flight recorder; off = "
             "byte-identical wire behavior")
    _var.var_register(
        "mpi", "base", "telemetry_sample_s", vtype="float", default=0.25,
        help="Health-monitor sampling period in seconds (the straggler "
             "score / hysteresis evaluation cadence)")
    _var.var_register(
        "mpi", "base", "telemetry_window_s", vtype="float", default=5.0,
        help="Rolling window the health monitor scores over; samples "
             "older than this are dropped before each evaluation")
    _var.var_register(
        "mpi", "base", "telemetry_straggler_score", vtype="float",
        default=0.05,
        help="Straggler score (excess blocked-seconds per second of "
             "window) at or above which a peer becomes a straggler "
             "SUSPECT; declaration additionally needs "
             "telemetry_straggler_miss consecutive suspect samples")
    _var.var_register(
        "mpi", "base", "telemetry_straggler_miss", vtype="int",
        default=3,
        help="Consecutive suspect samples before telemetry.straggler "
             "fires — the hysteresis that keeps a one-off GC pause "
             "from paging (the ft detector's suspect->declare pattern)")
    _var.var_register(
        "mpi", "base", "telemetry_degraded_ms", vtype="float",
        default=0.0,
        help="Fire telemetry.degraded when this rank's own pml send "
             "p99 exceeds this many milliseconds (0 disables the "
             "self-health check)")
    _var.var_register(
        "mpi", "base", "telemetry_flightrec_dir", vtype="str",
        default="",
        help="Directory the fault flight recorder writes "
             "flightrec_<rank>.json snapshots into on proc-failure / "
             "revoke / lockwitness-cycle / straggler triggers "
             "(default: current directory)")


def telemetry_enabled() -> bool:
    """The MCA-var truth — consulted at comm construction / selection
    time (the composers wrap vtables only when this is on). Hot paths
    read ``active`` instead."""
    register_params()
    return bool(_var.var_get("mpi_base_telemetry", False))


def enable() -> None:
    """Turn the plane on (idempotent): sets the MCA var and arms the
    global hot-path instruments. Call BEFORE MPI.Init for collective
    latency histograms — the coll composers wrap at construction."""
    global active
    register_params()
    try:
        _var.var_set("mpi_base_telemetry", True)
    except KeyError:                     # var store reset mid-session
        pass
    _arm_core_hists()
    active = True


def disable() -> None:
    """Stop recording; existing histograms stay readable."""
    global active
    active = False
    register_params()
    try:
        _var.var_set("mpi_base_telemetry", False)
    except KeyError:
        pass


def maybe_enable_from_var() -> None:
    """Arm the plane when the MCA var (env/param-file) says so — called
    from runtime init so ``OMPI_TPU_TORCH_MCA_mpi_base_telemetry=1``
    works without code changes."""
    if telemetry_enabled() and not active:
        enable()


# -- histogram registry ------------------------------------------------------
def _register_hist_pvar(h: Histogram) -> None:
    """First-record pvar registration (never-hit instruments don't
    flood pvar_list); idempotent, check under the registry lock."""
    with _lock:
        if h.registered:
            return
        h.registered = True
    _pvar.pvar_register(h.name, h.snapshot, unit=h.unit, help=h.help,
                        var_class=_pvar.CLASS_HISTOGRAM, comm=h.comm)


def get_hist(name: str, *, unit: str = "us", help: str = "",
             comm: Any = None,
             labels: Optional[Dict[str, str]] = None) -> Histogram:
    """Get-or-create one named histogram."""
    with _lock:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = Histogram(name, unit=unit, help=help,
                                         comm=comm, labels=labels)
    return h


def histograms() -> List[Histogram]:
    with _lock:
        return [_hists[n] for n in sorted(_hists)]


def size_class(nbytes: int) -> int:
    """Fixed payload size classes: <=1 KiB, <=64 KiB, <=1 MiB, above —
    the per-(comm, func, size-class) latency dimension."""
    if nbytes <= 1024:
        return 0
    if nbytes <= 65536:
        return 1
    if nbytes <= 1048576:
        return 2
    return 3


def _cid_token(cid: Any) -> str:
    return re.sub(r"[^A-Za-z0-9]+", "_", str(cid)).strip("_") or "none"


def coll_hists(cid: Any, func: str) -> tuple:
    """The per-(comm, func) instrument tuple, one histogram per size
    class, resolved ONCE at vtable-wrap time so the per-call work is
    size-class index + record. Tagged with the cid for retirement."""
    tok = _cid_token(cid)
    return tuple(
        get_hist(f"tele_coll_{func}_c{tok}_{cls}", unit="us",
                 comm=cid,
                 labels={"comm": str(cid), "func": func, "sclass": cls},
                 help=f"Latency of {func} on comm {cid} "
                      f"({cls} payloads)")
        for cls in SIZE_CLASS_NAMES)


# -- coll vtable interposition (stacked world) ------------------------------
class _HistSlot:
    """Wraps ONE selected coll slot (the trace plane's _TracedSlot
    shape): the slot's own function records per-size-class latency into
    the comm's histogram tuple; every other attribute delegates to the
    real winner so fused fast paths keep working under telemetry."""

    def __init__(self, cid: Any, func: str, inner: Any):
        self._inner = inner
        target = getattr(inner, func)
        hists = coll_hists(cid, func)    # resolved ONCE, at wrap time
        # size class memo keyed on (shape, dtype): ``Tensor.nbytes`` is
        # not free, and on an 8 B allreduce every microsecond counts
        # against the 3% budget — repeat calls are one dict probe (the
        # sub-eager cache's bet)
        size_memo: Dict[Any, int] = {}

        def call(*a, **kw):
            if not active:               # telemetry turned off after wrap
                return target(*a, **kw)
            hist = hists[0]
            if a:
                x0 = a[0]
                key = (getattr(x0, "shape", None),
                       getattr(x0, "dtype", None))
                sc = size_memo.get(key)
                if sc is None:
                    sc = size_memo[key] = size_class(
                        int(getattr(x0, "nbytes", 0) or 0))
                hist = hists[sc]
            tok = hist.start()
            try:
                return target(*a, **kw)
            finally:
                hist.observe(tok)
        call.__name__ = func
        setattr(self, func, call)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def wrap_coll_vtable(comm, vtable: Dict[str, Any]) -> Dict[str, Any]:
    """Called by the selection composer (coll/framework) when telemetry
    is enabled: each selected slot is served through a latency-recording
    shim. Sits between monitoring (beneath) and trace (outermost) so
    histograms measure the same app-visible call the spans do, minus
    the tracer's own ring-append cost."""
    cid = getattr(comm, "cid", None)
    return {f: _HistSlot(cid, f, m) for f, m in vtable.items()}


def _arm_core_hists() -> None:
    g = globals()
    core = {
        "PML_SEND": ("tele_pml_send_us", "us", {"func": "send"},
                     "pml send service time (post to wire handoff)"),
        "PML_RECV": ("tele_pml_recv_us", "us", {"func": "recv"},
                     "pml recv service time (post to completion — the "
                     "blocked-waiting a late sender costs this rank)"),
        "SEGMENT": ("tele_pml_segment_us", "us", {"func": "segment"},
                    "pipeline segment service time (stage + encode, "
                    "pml/pipeline)"),
        "FLUSH": ("tele_btl_flush_frames", "frames", {"func": "flush"},
                  "btl ctl flush-window width (frames per coalesced "
                  "flush, btl/tcp)"),
        "RAIL": ("tele_btl_rail_bytes", "bytes", {"func": "rail"},
                 "payload bytes per rail frame (btl/bml striping)"),
        "SHMSEG": ("tele_btl_shm_seg_bytes", "bytes",
                   {"func": "shm_seg"},
                   "payload bytes packed into / adopted from shared "
                   "segment slots (btl/shmseg zero-copy plane, send "
                   "+ receive sides)"),
        "HB_GAP": ("tele_ft_hb_gap_us", "us", {"func": "hb_gap"},
                   "inter-arrival gap of ring heartbeats "
                   "(ft/detector ingress)"),
        "HB_RTT": ("tele_ft_hb_rtt_us", "us", {"func": "hb_rtt"},
                   "heartbeat echo round-trip time (hb/hbr ctl pair; "
                   "only stamped while telemetry is on)"),
    }
    for attr, (name, unit, labels, help_txt) in core.items():
        if g.get(attr) is None:
            g[attr] = get_hist(name, unit=unit, labels=labels,
                               help=help_txt)


# -- per-comm retirement (pvar session semantics) ----------------------------
def retire_comm(cid: Any) -> List[str]:
    """Retire every per-comm instrument owned by ``cid``: telemetry
    histograms, their pvars, and the trace plane's skew watermark
    (``trace_skew_c<cid>``). Called from Communicator free/shrink so a
    read after a shrink can't report dead-rank-era keys."""
    scid = str(cid)
    with _lock:
        names = [n for n, h in _hists.items() if h.comm == scid]
        for n in names:
            del _hists[n]
    retired = list(_pvar.pvar_retire_comm(scid))
    from ompi_tpu_torch.trace import attribution as _attr
    retired += _attr.retire_comm(cid)
    return sorted(set(names) | set(retired))


# -- snapshots / dump --------------------------------------------------------
def snapshot_hists(include_empty: bool = False) -> List[Dict[str, Any]]:
    out = []
    for h in histograms():
        snap = h.snapshot()
        if not snap["count"] and not include_empty:
            continue
        out.append({"name": h.name, "unit": h.unit, "comm": h.comm,
                    "labels": h.labels, "snap": snap})
    return out


def _osc_counters() -> Optional[Dict[str, int]]:
    """The one-sided plane's op/byte counters (``osc/base.stats``), when
    RMA ran at all — mpitop's ``osc`` section merges these per rank (the
    latency histograms ride ``hists`` like every other plane's)."""
    try:
        from ompi_tpu_torch.osc import base as _osc_base
        s = _osc_base.stats
        if not any(s.values()):
            return None
        return {k: int(v) for k, v in s.items()}
    except Exception:                    # noqa: BLE001 — the dump
        return None                      # must never fail on a plane


def dump(path: str, rank: Optional[int] = None) -> str:
    """Persist this process's telemetry for a merge tool (the
    reference's ``tools/mpitop`` reads it):
    ``{"telemetry": 1, "rank", "hists", "health"[, "osc"]}`` (the
    flight recorder writes a richer sibling format,
    telemetry/flightrec)."""
    if rank is None:
        from ompi_tpu_torch import trace as _trace
        rank = _trace.process_rank()
    from ompi_tpu_torch.telemetry import health as _health
    payload = {"telemetry": 1, "rank": int(rank),
               "time": time.time(),
               "hists": snapshot_hists(),
               "health": _health.scores_snapshot()}
    osc = _osc_counters()
    if osc:
        payload["osc"] = osc
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def shutdown() -> None:
    """Finalize-path teardown: stop the health monitor and disarm the
    flight recorder (their listeners must not outlive the world)."""
    from ompi_tpu_torch.telemetry import flightrec as _flightrec
    from ompi_tpu_torch.telemetry import health as _health
    _health.uninstall()
    _flightrec.disarm()


def _reset_for_tests() -> None:
    global active, PML_SEND, PML_RECV, SEGMENT, FLUSH, RAIL, SHMSEG, \
        HB_GAP, HB_RTT
    shutdown()
    active = False
    with _lock:
        _hists.clear()
    PML_SEND = PML_RECV = SEGMENT = FLUSH = RAIL = SHMSEG = None
    HB_GAP = HB_RTT = None
