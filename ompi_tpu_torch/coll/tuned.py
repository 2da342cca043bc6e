"""coll/tuned — the decision layer: the staging switch point, its probe,
the dynamic-rules file, and the tuned component.

The port of ``ompi_tpu/coll/tuned.py``. It mirrors two reference
components at once: coll/tuned's per-collective decisions
(``coll_tuned_decision_fixed.c``; the JSON file named by
``coll_tuned_dynamic_rules`` overrides :mod:`coll.decision`'s rows per
collective, ``{func: {"algorithm_rules": [[min_comm_size, min_bytes,
algorithm], ...]}}``, as tuned's dynamic file does,
``coll_tuned_component.c:187-191``), and coll/accelerator's staging shim
(``coll_accelerator_allreduce.c:55-80``) turned around: the native path is
the device, and the question is whether a host (numpy) buffer is large
enough to be worth staging onto it, or small enough for a numpy fold.

The switch point (``stage_min_for``) is, in order: the rules file's
per-collective ``stage_min_bytes``, a user-set
``coll_tuned_stage_min_bytes``, then the probe-earned value
(``staging_probe``: a two-point fit of the staged path — H2D, a torch op,
D2H — against the numpy fold plus the transport, confirmed by measurement
and given a 1.5x hysteresis band). On the per-rank tier rank 0 runs the
probe at Init on its own device and every rank adopts the same value
(``runtime/init``); on the single-controller tier the first staging
decision runs it on the world's device. A probe that fails on a CUDA
device raises; on the CPU it is advisory and the var's default stands.

The component (:class:`TunedCollComponent`, priority 60) routes each
stacked call: a tensor goes to coll/torch (the device), a numpy stacked
buffer below the switch point to coll/basic (the host), a larger one is
staged onto the device and its result copied back, so numpy in gives
numpy out, as in the reference. Across controllers a numpy stack is the
global array every controller passes: the host fold needs no exchange,
and a staged one crosses the controller tier and comes back whole.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ompi_tpu_torch import accelerator
from ompi_tpu_torch.coll.framework import coll_framework
from ompi_tpu_torch.core.errhandler import ERR_OTHER, MPIError
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.mca.base import Component

_rules_cache: Dict[str, Tuple[float, Dict]] = {}


def register_vars() -> None:
    """Register the tuned vars (at import, and again by ``init`` after a
    reset of the var store)."""
    var.var_register(
        "coll", "tuned", "priority", vtype="int", default=60,
        help="Selection priority of the tuned decision component")
    var.var_register(
        "coll", "tuned", "dynamic_rules", vtype="str", default="",
        help="Path to a JSON per-collective decision-rule override file "
             "(re-design of coll/tuned dynamic rules)")
    var.var_register(
        "coll", "tuned", "stage_min_bytes", vtype="int", default=1 << 20,
        help="Host buffers at least this large are staged onto the device "
             "and run there; smaller ones run the host algorithms. Set, it "
             "overrides the staging probe")
    var.var_register(
        "coll", "tuned", "small_allreduce_max_bytes", vtype="int",
        default=4096,
        help="Per-rank tier: host payloads at or below this take the "
             "combined small-message allreduce (one eager send per peer, "
             "reader-thread combining, one wakeup)")
    var.var_register(
        "coll", "tuned", "small_allreduce_max_ranks", vtype="int",
        default=32,
        help="The combined small-message allreduce sends rank-count "
             "squared messages; larger worlds use the tree algorithms")


register_vars()


def _load_rules(path: str) -> Dict[str, Dict]:
    """The rules in ``path``, memoized by mtime: the decision layer asks
    on every memo miss, so the JSON is parsed only when the file
    changed. A reload bumps the var epoch, so warm (shape, dtype, op)
    memo entries of coll/torch decide again."""
    if not path:
        return {}
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return {}
    cached = _rules_cache.get(path)
    if cached is not None and cached[0] == mtime:
        return cached[1]
    try:
        with open(path) as f:
            data = json.load(f)
        rules = data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        rules = {}
    _rules_cache[path] = (mtime, rules)
    var.bump_epoch()
    return rules


# -- the probe-earned staging threshold -------------------------------------
_NEVER_STAGE = 1 << 62
_probe_state: Dict[str, object] = {"ran": False}


def _probe_device() -> torch.device:
    """Where an unplaced probe runs: the current CUDA device under the
    cuda accelerator module, else the CPU."""
    if accelerator.current_module().name == "cuda" \
            and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def staging_probe(transport_bps: Optional[float] = None, nranks: int = 1,
                  device=None) -> Tuple[int, Dict[str, object]]:
    """Measure the staged-against-host crossover on ``device``.

    Two sizes bound a linear cost model per path. The staged side runs
    the staged tier's mechanics: ``torch.from_numpy(buf).to(device)``, a
    torch op, and ``.cpu()`` after a synchronize. The host side is the
    numpy fold plus, in a per-rank world, the transport's cost per byte
    for the host algorithm's wire volume (``transport_bps`` from the bml
    probe). The fitted crossover is then confirmed by measurement at the
    first size the fit would stage (walking up x2 while the host still
    wins, to 16 MiB), and the adopted value gets a 1.5x hysteresis band.
    Returns (crossover_bytes, basis)."""
    dev = torch.device(device) if device is not None else _probe_device()
    cuda = dev.type == "cuda"
    sizes = (256 << 10, 2 << 20)

    def staged(buf: np.ndarray) -> np.ndarray:
        y = torch.from_numpy(buf).to(dev) * 1.0
        if cuda:
            torch.cuda.synchronize(dev)
        return y.cpu().numpy()

    def _med(f, reps=3):
        f()                              # warm (first touch, allocator)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            f()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    stg, host = [], []
    for nb in sizes:
        buf = np.ones(nb // 4, np.float32)
        other = buf.copy()
        out = np.empty_like(buf)
        stg.append(_med(lambda: staged(buf)))
        host.append(_med(lambda: np.add(buf, other, out=out)))
    n1, n2 = sizes
    b_s = (stg[1] - stg[0]) / (n2 - n1)
    a_s = stg[0] - b_s * n1
    b_h = (host[1] - host[0]) / (n2 - n1)
    a_h = host[0] - b_h * n1
    # host-tier wire volume per member: 2 payloads for reduce + bcast,
    # 2(n-1)/n once the pipelined ring carries the large sizes
    from ompi_tpu_torch.pml import pipeline as _pl
    wire_factor = (2.0 * (nranks - 1) / nranks
                   if nranks > 1 and _pl.enabled() else 2.0)
    tx_per_byte = (wire_factor / transport_bps
                   if transport_bps and transport_bps > 0 and nranks > 1
                   else 0.0)
    b_h += tx_per_byte
    basis: Dict[str, object] = {
        "ran": True,
        "device": dev.type,
        "staged_per_mb_ms": round(b_s * (1 << 20) * 1e3, 3),
        "host_per_mb_ms": round(b_h * (1 << 20) * 1e3, 3),
        "staged_fixed_us": round(a_s * 1e6, 1),
        "host_fixed_us": round(a_h * 1e6, 1),
    }
    if transport_bps:
        basis["transport_gbps"] = round(transport_bps / 1e9, 3)
    if b_h <= b_s:
        cross = _NEVER_STAGE             # staging can win only on fixed
    else:                                # cost, which it never does
        cross = int(min(max((a_s - a_h) / (b_h - b_s), 64 << 10),
                        _NEVER_STAGE))
    if cross < _NEVER_STAGE:
        # the fit extrapolates: confirm at the first size it would stage,
        # walking up while the host path still wins there
        confirm: Dict[str, object] = {}
        candidate = int(min(max(cross, 64 << 10), 16 << 20))
        adopted = _NEVER_STAGE
        for _ in range(3):
            nb = candidate - (candidate % 4) or 4
            buf = np.ones(nb // 4, np.float32)
            other = buf.copy()
            out = np.empty_like(buf)
            staged_t = _med(lambda: staged(buf), reps=2)
            host_t = _med(lambda: np.add(buf, other, out=out),
                          reps=2) + tx_per_byte * nb
            confirm = {"confirm_bytes": nb,
                       "confirm_staged_ms": round(staged_t * 1e3, 3),
                       "confirm_host_ms": round(host_t * 1e3, 3)}
            if staged_t < host_t:
                adopted = candidate
                break
            if candidate >= 16 << 20:
                break
            candidate = min(candidate * 2, 16 << 20)
        basis.update(confirm)
        if adopted < _NEVER_STAGE:
            cross = int(min(adopted * 1.5, _NEVER_STAGE))
            basis["hysteresis"] = 1.5
        else:
            cross = _NEVER_STAGE
            basis["confirm_rejected_staging"] = True
    basis["stage_min_bytes"] = cross if cross < _NEVER_STAGE else -1
    return cross, basis


def adopt_probed_stage_min(value: int, basis: Dict[str, object]) -> None:
    """Install a probe result. On the per-rank tier rank 0 measures and
    every rank adopts the same value through the KV: the staging
    decision is collective and must agree across ranks; timings do
    not."""
    _probe_state.clear()
    _probe_state.update(basis)
    _probe_state["ran"] = True
    _probe_state["value"] = int(value)


def probed_stage_basis() -> Dict[str, object]:
    """The measured basis of the staging decision."""
    return dict(_probe_state)


def _probed_stage_min() -> Optional[int]:
    if not _probe_state.get("ran"):
        dev = _probe_device()
        try:
            value, basis = staging_probe(device=dev)
        except Exception as e:           # noqa: BLE001
            if dev.type == "cuda":
                raise MPIError(ERR_OTHER, f"staging probe on {dev} failed: "
                                          f"{type(e).__name__}: {e}") from e
            # advisory on the CPU: the var's default stands
            _probe_state.update(ran=True, error=True)
            return None
        adopt_probed_stage_min(value, basis)
    v = _probe_state.get("value")
    return int(v) if v is not None else None


def stage_min_for(func: str) -> int:
    """The staging switch point of one collective: the rules file's
    per-collective ``stage_min_bytes``, else a user-set var, else the
    probe-earned value. One decision plane for the single-controller
    component and the per-rank staged tier."""
    rules = _load_rules(var.var_get("coll_tuned_dynamic_rules", ""))
    override = rules.get(func, {}).get("stage_min_bytes")
    if override is not None:
        return int(override)
    if var.var_overridden("coll_tuned_stage_min_bytes"):
        return int(var.var_get("coll_tuned_stage_min_bytes", 1 << 20))
    probed = _probed_stage_min()
    if probed is not None:
        return probed
    return int(var.var_get("coll_tuned_stage_min_bytes", 1 << 20))


def small_allreduce_limits() -> Tuple[int, int]:
    """(max_bytes, max_ranks) of the combined small-message allreduce."""
    return (int(var.var_get("coll_tuned_small_allreduce_max_bytes", 4096)),
            int(var.var_get("coll_tuned_small_allreduce_max_ranks", 32)))


def _reset_for_tests() -> None:
    _probe_state.clear()
    _probe_state["ran"] = False


# -- the component ----------------------------------------------------------
class TunedCollModule:
    """Routes each call between coll/torch (``device``) and coll/basic
    (``host``): a tensor runs on the device; a numpy stacked buffer below
    the switch point runs the numpy fold; a larger one is staged onto the
    world's device and its result copied back, unless its op is a C
    user op (``_c_callback``), which only the numpy fold can call. The
    schedule introspection (``selected``, the memos) is the device
    module's."""

    def __init__(self, comm):
        from ompi_tpu_torch.coll.basic import BasicCollModule
        from ompi_tpu_torch.coll.torch_ import TorchCollModule
        self.comm = comm
        self.device = TorchCollModule(comm)
        self.host = BasicCollModule(comm)

    def __getattr__(self, name: str):
        # only reached for names this class lacks: the device module's
        # schedule state and introspection
        if name in ("device", "host", "comm"):
            raise AttributeError(name)
        return getattr(self.device, name)

    def _decide(self, func: str, buf):
        """(module, stage) for this call."""
        if not isinstance(buf, np.ndarray):
            return self.device, False
        if buf.nbytes >= stage_min_for(func):
            return self.device, True     # stage host -> device
        return self.host, False

    def _run(self, func: str, buf, *args):
        mod, stage = self._decide(func, buf)
        if stage and any(getattr(a, "_c_callback", None) is not None
                         for a in args):
            mod, stage = self.host, False  # a C fn pointer reads host memory
        if stage:
            x = torch.from_numpy(np.ascontiguousarray(buf)).to(
                self.comm.device)
            y = getattr(mod, func)(x, *args)
            if self.device._mc:
                # across controllers the result is this controller's
                # rows; numpy out is the whole stack, as numpy came in
                y = self.device.mc_full(y)
            return accelerator.to_numpy(y)
        return getattr(mod, func)(buf, *args)

    def allreduce(self, x, op):
        return self._run("allreduce", x, op)

    def reduce(self, x, op, root):
        return self._run("reduce", x, op, root)

    def bcast(self, x, root):
        return self._run("bcast", x, root)

    def allgather(self, x):
        return self._run("allgather", x)

    def gather(self, x, root):
        return self._run("gather", x, root)

    def scatter(self, x, root):
        return self._run("scatter", x, root)

    def alltoall(self, x):
        return self._run("alltoall", x)

    def reduce_scatter_block(self, x, op):
        return self._run("reduce_scatter_block", x, op)

    def scan(self, x, op):
        return self._run("scan", x, op)

    def exscan(self, x, op):
        return self._run("exscan", x, op)

    # device-only entries: the communicator gates them on a device buffer
    def allreduce_dtype(self, *args):
        return self.device.allreduce_dtype(*args)

    def bind_allreduce(self, example, op):
        return self.device.bind_allreduce(example, op)

    def selected(self, func: str, x=None, op=None, root=None) -> str:
        return self.device.selected(func, x, op, root)

    # a bucket of tensors runs on the device
    def folds(self, *args) -> bool:
        return self.device.folds(*args)

    def allreduce_members(self, *args):
        return self.device.allreduce_members(*args)

    def barrier(self) -> None:
        self.device.barrier()

    def _ibarrier_arrays(self):
        return self.device._ibarrier_arrays()


class TunedCollComponent(Component):
    name = "tuned"

    def register_params(self):
        register_vars()

    def comm_query(self, comm):
        if comm is None or getattr(comm, "is_per_rank", False):
            return None
        return (var.var_get("coll_tuned_priority", 60),
                TunedCollModule(comm))


coll_framework.register(TunedCollComponent())
