"""coll/persistent — pre-bound persistent collectives + bucket fusion.

The port of ``ompi_tpu/coll/persistent.py``, for the stacked tier (one
controller or several) and the per-rank tier. Two mechanisms behind the MPI-4
persistent-collective family (``MPI_Allreduce_init`` …):

1. **Plan pre-binding.** Validation, component selection and the
   algorithm selection run ONCE at ``*_init``, with one warm-up
   collective (the allreduce plan binds the selected schedule);
   ``MPI_Start`` is launch-only. A Start reads the send buffer's
   contents at Start, not at init: a tensor changed in place between
   starts gives the new result.
2. **Bucket fusion** (DDP-style gradient bucketing): concurrent small
   (i)allreduces on the same (comm, op, dtype) coalesce into ONE
   flattened fused allreduce. Buckets flush on the bytes threshold
   (``mpi_base_bucket_bytes``, per-rank payload), on the
   ``MPI_Startall`` boundary, on an explicit ``flush()``, or when the
   progress engine spins with the bucket idle. Off by default: with
   ``mpi_base_bucket`` off every result is the unfused path's.

No later flush or start writes a result: an unfused start's result is a
tensor of its own, and so is a fused member's, except where its flush
took the fold (``BucketFuser``), which makes each member's result a view
of that flush's own output. A start's completion is the CUDA event
recorded after its launch (``core/request``).

On the per-rank tier (``_perrank_plan``) an allreduce plan binds its
route at init, as the reference's does: ``staged_device`` (a numpy
buffer at or above the staging minimum, registered with the accelerator
so every Start copies from pinned pages), ``small_combine`` (the
combined small allreduce, pre-bound: N outstanding Starts pipeline) or
``generic`` (the one-shot dispatch); a device tensor's plan runs the
shared-buffer device tier through the generic route. bcast, allgather,
reduce_scatter_block and barrier plans run the host call (``host``).
Starts run on the comm's collective worker, and bucket flushes happen
only at program points every rank reaches alike (bytes, Startall, wait),
never from the progress engine's idle sweep.

Observability: pvars ``coll_persistent_starts``, ``coll_bucket_flushes``,
``coll_bucket_fused_members``, ``coll_bucket_flush_<reason>``,
``coll_bucket_folds``, ``coll_bucket_fold_tables`` and the level
``coll_bucket_occupancy``; spans (``trace/core``, armed by its
var, ``enable()`` or a recording profiler) ``coll.startall``,
``coll.bucket_flush`` with its children ``coll.bucket_pack``,
``coll.fused_allreduce`` and ``coll.bucket_unpack``, and
``coll.request_wait`` around each wait on a start that blocks.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _prof

from ompi_tpu_torch.coll import decision
from ompi_tpu_torch.coll.nbc import NbcModule, ScheduleRequest
from ompi_tpu_torch.core import multictl
from ompi_tpu_torch.core import op as op_mod
from ompi_tpu_torch.core.datatype import torch_dtype
from ompi_tpu_torch.core.errhandler import MPIError
from ompi_tpu_torch.core.request import Request, event_after
from ompi_tpu_torch.mca import pvar, var
from ompi_tpu_torch.ops import bucket_fold
from ompi_tpu_torch.runtime import progress as prog
from ompi_tpu_torch.runtime import spc
from ompi_tpu_torch.trace import core as _trace
from ompi_tpu_torch.utils import hooks

# The funcs with a pre-bound plan, and the funcs the BucketFuser
# coalesces (coll/decision's persistent and bucket rows).
PERSISTENT_FUNCS = ("allreduce", "bcast", "allgather",
                    "reduce_scatter_block", "barrier")
FUSED_FUNCS = ("allreduce",)

DEFAULT_BUCKET_BYTES = 1 << 20
# fold tables a fuser keeps (one per bucket shape and member addresses)
FOLD_TABLES_MAX = 64


# -- config (MCA vars) ------------------------------------------------------
def register_vars() -> None:
    """Register the ``mpi_base_bucket*`` vars (at import, and again by
    ``init`` after a reset of the var store)."""
    var.var_register(
        "mpi", "base", "bucket", vtype="bool", default=False,
        help="Coalesce concurrent small same-(comm, op, dtype) "
             "(i)allreduces into one flattened fused collective "
             "(DDP-style gradient bucketing). Off means every collective "
             "is the unfused path's")
    var.var_register(
        "mpi", "base", "bucket_bytes", vtype="int",
        default=DEFAULT_BUCKET_BYTES,
        help="Bucket flush threshold in bytes (per-rank payload): a "
             "bucket whose accumulated payload reaches this flushes "
             "as one collective; payloads above it never bucket")


register_vars()


def bucket_enabled() -> bool:
    return bool(var.var_get("mpi_base_bucket", False))


def bucket_bytes() -> int:
    return int(var.var_get("mpi_base_bucket_bytes", DEFAULT_BUCKET_BYTES))


# -- counters (MPI_T pvars) -------------------------------------------------
_COUNTERS = ("coll_persistent_starts", "coll_bucket_flushes",
             "coll_bucket_fused_members", "coll_bucket_flush_bytes",
             "coll_bucket_flush_startall", "coll_bucket_flush_idle",
             "coll_bucket_flush_explicit", "coll_bucket_folds",
             "coll_bucket_fold_tables")
_counts: Dict[str, int] = dict.fromkeys(_COUNTERS, 0)
_live_fusers: "weakref.WeakSet[BucketFuser]" = weakref.WeakSet()


def _count(name: str, n: int = 1) -> None:
    # lock-free on purpose: Start is the launch-only hot path and a
    # GIL-atomic dict increment is the whole cost
    _counts[name] = _counts.get(name, 0) + n


def _occupancy_bytes() -> int:
    return sum(f.pending_bytes() for f in list(_live_fusers))


def _register_pvars() -> None:
    def reader(key):
        return lambda: _counts.get(key, 0)

    pvar.pvar_register("coll_persistent_starts",
                       reader("coll_persistent_starts"),
                       help="Persistent-collective MPI_Start launches "
                            "through the pre-bound plan path")
    pvar.pvar_register("coll_bucket_flushes",
                       reader("coll_bucket_flushes"),
                       help="Fused collectives launched by the BucketFuser "
                            "(one per bucket flush)")
    pvar.pvar_register("coll_bucket_fused_members",
                       reader("coll_bucket_fused_members"),
                       help="Member collectives coalesced into fused "
                            "bucket launches")
    for reason in ("bytes", "startall", "idle", "explicit"):
        pvar.pvar_register(f"coll_bucket_flush_{reason}",
                           reader(f"coll_bucket_flush_{reason}"),
                           help=f"Bucket flushes triggered by: {reason}")
    pvar.pvar_register("coll_bucket_folds", reader("coll_bucket_folds"),
                       help="Bucket flushes whose fused allreduce ran as "
                            "one bucket fold (ops/bucket_fold)")
    pvar.pvar_register("coll_bucket_fold_tables",
                       reader("coll_bucket_fold_tables"),
                       help="Bucket fold tables built (one per bucket "
                            "shape and member addresses)")
    pvar.pvar_register("coll_bucket_occupancy", _occupancy_bytes,
                       unit="bytes", var_class=pvar.CLASS_LEVEL,
                       help="Bytes currently pending in unflushed "
                            "buckets across live fusers")


_register_pvars()
hooks.declare_event("coll.bucket_flush")


# -- plans ------------------------------------------------------------------
class CollPlan:
    """A pre-bound persistent-collective plan. ``fn``/``buf`` is the
    DIRECT form: Start calls ``fn(buf)`` (or ``fn()``) and parks its
    output and completion event on the outer request. ``launch()`` is the
    general form (a launcher returning a request; None for a direct
    plan, so the plan holds no reference to itself and its buffers go
    when its request goes, without waiting for the cycle collector).
    ``payload``/
    ``epilogue`` are the bucket-fusion adapters (None = not fusable).
    ``algorithm`` is what ``coll/decision`` chose at init for the plan's
    (func, per-rank bytes, platform). ``codec`` is the codec the
    compressed path takes for the plan's buffer (``_preselect_codec``),
    None where the compression gate declines it."""

    __slots__ = ("comm", "func", "launch", "fn", "buf", "op", "nbytes",
                 "algorithm", "codec", "bucket_key", "payload",
                 "epilogue", "__weakref__")

    def __init__(self, comm, func: str,
                 launch: Optional[Callable[[], Request]] = None, *,
                 fn: Optional[Callable] = None, buf: Any = None,
                 op=None, nbytes: int = 0, algorithm: str = "direct",
                 codec: Optional[str] = None,
                 bucket_key: Optional[Tuple] = None,
                 payload: Optional[Callable[[], Any]] = None,
                 epilogue: Optional[Callable[[Any], Any]] = None):
        self.comm = comm
        self.func = func
        self.fn = fn
        self.buf = buf
        self.launch = launch
        self.op = op
        self.nbytes = int(nbytes)
        self.algorithm = algorithm
        self.codec = codec
        self.bucket_key = bucket_key
        self.payload = payload
        self.epilogue = epilogue

    def _call(self):
        return self.fn(self.buf) if self.buf is not None else self.fn()

    def _direct(self) -> Request:
        """General-machinery form of a direct plan (the override in
        ``PersistentCollRequest.start`` normally short-circuits it)."""
        y = self._call()
        return Request(result=y, event=event_after(y))


class PersistentCollRequest(Request):
    """The request a persistent-collective ``*_init`` returns: Start
    launches the pre-bound plan (or enqueues into the comm's bucket when
    fusion is on); completion is the launch's event, or the inner
    request's, as in the base persistent machinery."""

    def __init__(self, plan: CollPlan):
        super().__init__(persistent_start=plan.launch or plan._direct)
        self.plan = plan

    def start(self) -> "PersistentCollRequest":
        self._check_startable()
        _count("coll_persistent_starts")
        p = self.plan
        self._error = None
        self.status.error = 0
        self._complete = False
        self._active = True
        try:
            if (p.bucket_key is not None and bucket_enabled()
                    and 0 < p.nbytes <= bucket_bytes()):
                self._inner_req = fuser_of(p.comm).enqueue(
                    p.bucket_key, p.payload, p.epilogue, p.nbytes, p.op)
            elif p.fn is not None and _crosses(p.comm):
                # across controllers the launch is a one-round schedule on
                # the comm's tier worker: a Start never blocks on the
                # other controllers, so starts on two comms in opposite
                # orders both finish
                mod = p.comm.__dict__.get("_start_nbc")
                if mod is None:
                    mod = p.comm._start_nbc = NbcModule(p.comm)
                self._inner_req = ScheduleRequest(mod, None,
                                                  [lambda _s: p._call()])
            elif p.fn is not None:
                # direct plan: the launch's output and event ARE the
                # completion state — no inner request
                y = p._call()
                self._result = y
                ev = event_after(y)
                if ev is not None and (_trace.active
                                       or _prof._is_profiler_enabled):
                    ev = _WaitSpanEvent(ev)
                self._event = ev
                self._inner_req = None
            else:
                self._inner_req = self._persistent_start()
        except MPIError as e:
            # the request completes carrying the error instead of the
            # start raising, so a waitall over a plan batch surfaces it
            self.fail(e)
        return self


class _WaitSpanEvent:
    """A direct plan's completion event, started while the tracer is
    armed: the base wait's ``synchronize`` goes through
    ``_wait_traced``, so the untraced wait keeps its own frame."""

    __slots__ = ("_ev",)

    def __init__(self, ev):
        self._ev = ev

    def query(self) -> bool:
        return self._ev.query()

    def synchronize(self) -> None:
        if _trace.active or _prof._is_profiler_enabled:
            _wait_traced(self._ev)
        else:
            self._ev.synchronize()


def _wait_traced(ev) -> None:
    """Block on a start's completion event for the armed tracer: a
    ``coll.request_wait`` span when the wait will block, none when the
    event has been reached (so the members of one bucket, which share
    its event, give one span)."""
    if ev.query():
        return
    tok = _trace.begin("coll.request_wait")
    try:
        ev.synchronize()
    finally:
        _trace.end(tok)


def _crosses(comm) -> bool:
    """A stacked comm whose collectives cross controllers (on the comm's
    own controller tier)."""
    return bool(getattr(comm, "is_multiprocess", False))


def _bucket_spec(comm, data, op) -> Optional[Tuple]:
    """(key, payload_fn, epilogue, per_rank_nbytes) when (comm tier,
    buffer, op) is bucket-fusable, else None. Fusion is elementwise, so
    any real non-pair reduction qualifies; pair (MINLOC/MAXLOC) and freed
    ops keep the unfused path. ``payload_fn`` reads the buffer's contents
    when the bucket flushes. On the per-rank tier a member is a numpy
    array of this rank's; on the stacked tier the leading axis is the
    rank."""
    if (op is None or getattr(op, "fn", None) is None
            or getattr(op, "is_loc", False)):
        return None
    if getattr(comm, "is_per_rank", False):
        if (not isinstance(data, np.ndarray) or data.ndim == 0
                or data.dtype.kind not in "fiub"):
            return None
        shape, dt = data.shape, data.dtype
        return ((op.uid, dt.str),
                lambda: np.ascontiguousarray(data).reshape(-1),
                lambda flat: np.asarray(flat).reshape(shape),
                int(data.nbytes))
    n = comm.size
    if getattr(data, "ndim", 0) < 1 or data.shape[0] != n:
        return None
    try:
        dt = torch_dtype(data.dtype)
    except TypeError:
        return None
    if dt.is_complex:
        return None
    shape = tuple(data.shape)
    dev = comm.device
    if getattr(comm, "is_multiprocess", False):
        # across controllers a member is this controller's rows: the
        # bucket flattens them to (L, -1), and the fused allreduce runs
        # across the controllers
        rows = comm._rows_of(data)

        def payload():
            return rows.local.reshape(rows.local.shape[0], -1)

        def epilogue(flat):
            return rows.like(flat.reshape(rows.local.shape))

        return ((op.uid, str(dt)), payload, epilogue,
                int(data.nbytes) // max(n, 1))

    if (isinstance(data, torch.Tensor) and data.device == dev
            and data.is_contiguous()):
        rows = data.view(n, -1)          # a view: read when it flushes

        def payload():
            return rows
    else:
        def payload():
            return torch.as_tensor(data, device=dev).reshape(n, -1)

    def epilogue(flat):
        return flat.reshape(shape)

    return ((op.uid, str(dt)), payload, epilogue,
            int(data.nbytes) // max(n, 1))


def _preselect_codec(func: str, nbytes: int, dtype, op=None
                     ) -> Optional[str]:
    """The compression gate, evaluated at init: the plan records the codec
    the compressed path would take (the codec itself rides the selected
    module's compressed schedule)."""
    if decision.compress_eligible(func, nbytes, dtype, op):
        from ompi_tpu_torch import compress
        return compress.codec_name()
    return None


def _decide(comm, func: str, nbytes: int) -> str:
    """The plan's recorded algorithm: ``coll/decision``'s choice for the
    plan's (func, per-rank bytes) on the communicator's platform, its
    multihost rows on a communicator spanning controllers, as the
    reference's plans record it (the var pins and the dynamic rules are
    the running module's to apply). A plan binds what the one-shot call
    runs."""
    return decision.decide(func, comm.size, nbytes,
                           bool(getattr(comm, "spans_processes", False)),
                           None, decision.platform_key(comm.device))


def _stacked_plan(comm, func: str, *args) -> CollPlan:
    """Validate, select and warm once (one collective on the spot, which
    the MPI-4 init contract permits); the plan's Start is launch-only."""
    if func == "barrier":
        mod = comm._coll("barrier")
        alg = _decide(comm, "barrier", 0)
        fn = getattr(mod, "_ibarrier_arrays", None)
        if fn is not None:
            fn()                                      # warm
            return CollPlan(comm, "barrier", fn=fn, algorithm=alg)

        def launch():
            mod.barrier()
            return Request.completed()
        return CollPlan(comm, "barrier", launch, algorithm=alg)

    if func == "allreduce":
        sendbuf, op = args
        comm._validate_stacked(sendbuf)
        comm._validate_op(op)
        mod = comm._coll("allreduce")
        bind = getattr(mod, "bind_allreduce", None)
        if bind is not None:
            fn = bind(sendbuf, op)                    # warm + bind
        else:
            fn = lambda buf: mod.allreduce(buf, op)   # noqa: E731
            fn(sendbuf)                               # warm
        per_rank = int(sendbuf.nbytes) // max(comm.size, 1)
        key, payload, epilogue = None, None, None
        spec = _bucket_spec(comm, sendbuf, op)
        if spec is not None:
            key, payload, epilogue, per_rank = spec
        return CollPlan(comm, "allreduce", fn=fn, buf=sendbuf, op=op,
                        nbytes=per_rank,
                        algorithm=_decide(comm, "allreduce", per_rank),
                        codec=_preselect_codec("allreduce", per_rank,
                                               sendbuf.dtype, op),
                        bucket_key=key, payload=payload, epilogue=epilogue)

    if func == "bcast":
        buf, root = args
        comm._validate_stacked(buf)
        comm._validate_root(root)
        mod = comm._coll("bcast")
        fn = lambda: mod.bcast(buf, root)             # noqa: E731
    elif func == "allgather":
        (buf,) = args
        comm._validate_stacked(buf)
        mod = comm._coll("allgather")
        fn = lambda: mod.allgather(buf)               # noqa: E731
    elif func == "reduce_scatter_block":
        buf, op = args
        comm._validate_stacked(buf, lead=2)
        comm._validate_op(op)
        mod = comm._coll("reduce_scatter_block")
        fn = lambda: mod.reduce_scatter_block(buf, op)  # noqa: E731
    else:
        raise ValueError(f"no persistent plan for collective {func!r}")
    fn()                                              # warm
    per_rank = int(buf.nbytes) // max(comm.size, 1)
    op = args[1] if func == "reduce_scatter_block" else None
    return CollPlan(comm, func, fn=fn, op=op, nbytes=per_rank,
                    algorithm=_decide(comm, func, per_rank),
                    codec=_preselect_codec(func, per_rank, buf.dtype, op))


def _perrank_plan(comm, func: str, *args) -> CollPlan:
    """The per-rank plan (``ompi_tpu/coll/persistent.py:388-438``): the
    allreduce route decided once, as the one-shot dispatch would decide
    it for this buffer; every Start runs on the comm's collective worker
    (or, for the small combine, posts its slot inline)."""
    from ompi_tpu_torch import accelerator
    from ompi_tpu_torch.core.rankcomm import RankCommunicator as RC
    from ompi_tpu_torch.core.rankcomm import _ran
    comm._check()
    if func == "allreduce":
        data, op = args
        comm._validate_op(op)
        if isinstance(data, torch.Tensor):
            nbytes = data.numel() * data.element_size()
        else:
            nbytes = int(getattr(data, "nbytes", 0) or 0)
        launch = None
        algorithm = "generic"
        if comm._stageable(data, op):
            # the registered buffer is read (and staged) at every Start;
            # registering it pins its pages, so each Start's copy to the
            # device is DMA from them
            algorithm = "staged_device"
            accelerator.current_module().host_register(data)

            def body(_c=comm, _d=data, _op=op):
                spc.record("coll_allreduce", 1)
                _ran("coll_staged_device")
                return _c._to_host(_c._device_allreduce(_c._to_dev(_d),
                                                        _op))
        elif comm._small_allreduce_ok(data):
            # a Start-only launcher: posts the slot and multicasts
            # inline, so N outstanding Starts pipeline on the wire
            algorithm = "small_combine"
            launch = comm.bind_small_allreduce(data, op)
        else:
            def body(_c=comm, _d=data, _op=op):
                return RC.allreduce(_c, _d, _op)
        if launch is None:
            launch = lambda: comm._nb(body)          # noqa: E731
        spec = _bucket_spec(comm, data, op)
        key, payload, epilogue = spec[:3] if spec else (None, None, None)
        plan = CollPlan(
            comm, "allreduce", launch, op=op, nbytes=nbytes,
            algorithm=algorithm,
            codec=_preselect_codec("allreduce", nbytes,
                                   getattr(data, "dtype", ""), op),
            bucket_key=key, payload=payload, epilogue=epilogue)
        if algorithm == "staged_device":
            weakref.finalize(plan, accelerator.current_module()
                             .host_unregister, data)
        return plan
    body = getattr(RC, func, None)
    if func not in PERSISTENT_FUNCS or body is None:
        raise ValueError(f"no persistent plan for collective {func!r}")
    if func == "bcast":
        comm._validate_root(args[1] if len(args) > 1 else 0)
    if func == "reduce_scatter_block":
        comm._validate_op(args[1])
    return CollPlan(comm, func, lambda: comm._nb(body, comm, *args),
                    nbytes=int(getattr(args[0], "nbytes", 0) or 0)
                    if args else 0,
                    algorithm="host")


def coll_init(comm, func: str, *args) -> PersistentCollRequest:
    """Build the pre-bound plan for ``func`` on ``comm`` and return the
    persistent request. Collective: every member calls the ``*_init``
    together."""
    if getattr(comm, "is_per_rank", False):
        return PersistentCollRequest(_perrank_plan(comm, func, *args))
    return PersistentCollRequest(_stacked_plan(comm, func, *args))


# -- bucket fusion ----------------------------------------------------------
class _BucketMemberReq(Request):
    """One member of a fused bucket: completed by the flush with its
    slice of the fused result and the flush's event. ``wait``
    force-flushes its own bucket (reason ``idle``) so a member can never
    deadlock on an unreached threshold; ``test`` spins the progress
    engine, whose idle sweep flushes a bucket left pending."""

    def __init__(self, fuser: "BucketFuser", key):
        super().__init__()
        self._complete = False
        self._delivered = threading.Event()
        self._fuser = fuser
        self._key = key

    def _deliver(self, result, event) -> None:
        self._result = result
        self._event = event
        self._delivered.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._complete = True
        self._delivered.set()

    def _settle(self) -> None:
        ev = self._event
        if ev is not None:
            if _trace.active or _prof._is_profiler_enabled:
                _wait_traced(ev)
            else:
                ev.synchronize()
        self._event = None
        self._complete = True

    def test(self):
        if not self._complete:
            if not self._delivered.is_set():
                if self._fuser._cross:
                    multictl.release()
                prog.progress()
            if self._delivered.is_set() and (self._event is None
                                             or self._event.query()):
                self._settle()
        if self._complete:
            if self._error is not None:
                raise self._error
            return True, self.status
        return False, None

    def wait(self, timeout: Optional[float] = None):
        if not self._complete:
            self._fuser.flush_key(self._key, "idle")
            if self._delivered.wait(timeout if timeout is not None
                                    else 600):
                self._settle()
        if self._error is not None:
            raise self._error
        return self.status


def _own(x):
    """A member's slice of the fused result as a tensor of its own."""
    if isinstance(x, torch.Tensor):
        return x.contiguous()
    return np.ascontiguousarray(x)


def _rows_signature(parts, n: int, dev) -> Optional[Tuple]:
    """``((data_ptr, w), ...)`` of the parts where every part is a
    contiguous ``(n, w)`` tensor of one dtype on ``dev``, else None."""
    dt = parts[0].dtype
    sig = []
    for p in parts:
        if not (isinstance(p, torch.Tensor) and p.ndim == 2
                and p.shape[0] == n and p.dtype == dt and p.device == dev
                and p.is_contiguous()):
            return None
        sig.append((p.data_ptr(), p.shape[1]))
    return tuple(sig)


class BucketFuser:
    """Per-communicator small-collective fuser (DDP-style gradient
    bucketing): members on the same (op, dtype) key accumulate until a
    flush trigger, then ride ONE flattened fused allreduce. On a per-rank
    comm every flush trigger is a point of the program order (the bytes
    threshold, Startall, a wait), so every rank fuses the same buckets;
    the progress engine's idle sweep is the stacked tier's alone, and a
    per-rank flush runs on the comm's collective worker, drawing its
    sequence tag in issue order.

    Across controllers (a multiprocess comm) a flush point is not one of
    the comm's call order everywhere (a wait is not), so the controllers
    agree on each bucket's members instead. The first member after a
    drain queues a held drain on the comm's tier worker
    (``multictl.hold``), in the comm's call order; any crossing, wait or
    flush releases it (``multictl.release``), closing it at the members
    enqueued so far. The drain then fuses them in rounds: each takes the
    first pending member's key and as many of that key's members as
    every controller holds (one MIN round of the tier), so the fused
    allreduces meet alike whatever each controller's release points,
    and every member is fused before the comm's next crossing runs.
    These flushes count as ``idle``.

    On a stacked comm whose rows all sit in this process, a flush takes
    the bucket fold (``ops/bucket_fold``) where the fused allreduce would
    run ``direct`` in ``coll/torch_`` on a predefined SUM, MAX or MIN of a
    float dtype the fold takes, with every member a contiguous ``(n,
    w_i)`` tensor on the comm's device: one pass reads every member's
    rows in place and writes each result once into every rank's row of
    one output per flush, so a member's result (persistent start,
    one-shot ``iallreduce``, the C ABI's ``pcoll_startall``) is a view
    of that output and not a tensor of its own. The fold's table is
    built once per bucket shape and member addresses and kept here.
    Every other flush packs, runs the selected allreduce and unpacks."""

    def __init__(self, comm):
        self.comm = comm
        self._per_rank = bool(getattr(comm, "is_per_rank", False))
        self._cross = not self._per_rank and _crosses(comm)
        # the idle sweep flushes when this process's engine spins, which
        # is no point of the program order other processes share: only
        # a comm whose rows all sit in this process takes it
        self._sweep = not self._per_rank and not getattr(
            comm, "is_multiprocess", False)
        self._lock = threading.RLock()
        # key -> [(member_req, payload_fn, epilogue, nbytes)]
        self._items: Dict[Tuple, List[Tuple]] = {}
        self._bytes: Dict[Tuple, int] = {}
        self._ops: Dict[Tuple, Any] = {}
        self._cb_registered = False
        # across controllers: members enqueued, and whether a held drain
        # waits on the comm's tier (a member's ``_seq`` is its ordinal)
        self._seq = 0
        self._held = False
        # fold tables by (member addresses and widths, dtype, op, rows),
        # each beside the var epoch at which the fold was last chosen
        self._tables: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        _live_fusers.add(self)

    def pending_bytes(self) -> int:
        with self._lock:
            return sum(self._bytes.values())

    def enqueue(self, key, payload_fn, epilogue, nbytes,
                op) -> _BucketMemberReq:
        req = _BucketMemberReq(self, key)
        with self._lock:
            self._items.setdefault(key, []).append(
                (req, payload_fn, epilogue, int(nbytes)))
            self._bytes[key] = self._bytes.get(key, 0) + int(nbytes)
            self._ops[key] = op
            full = self._bytes[key] >= bucket_bytes()
            if self._sweep and not self._cb_registered:
                prog.register(self._progress_cb, low_priority=True)
                self._cb_registered = True
            opened = self._cross and not self._held
            if self._cross:
                req._seq = self._seq
                self._seq += 1
                self._held = True
        if opened:
            multictl.hold(self.comm.layout, self._drain, self._close)
        if full:
            self.flush_key(key, "bytes")
        return req

    def _close(self) -> int:
        """At the release of the held drain: the members it may fuse
        (those enqueued so far); the next member opens another."""
        with self._lock:
            self._held = False
            return self._seq

    def _drain(self, cut: int) -> None:
        """On the comm's tier worker: fuse the members enqueued before
        ``cut``, in rounds of one key whose member count every controller
        agrees on (the MIN over the controllers of what each holds)."""
        while True:
            with self._lock:
                heads = [(v[0][0]._seq, k) for k, v in self._items.items()
                         if v and v[0][0]._seq < cut]
                if not heads:
                    return
                key = min(heads)[1]
                mine = sum(1 for it in self._items[key] if it[0]._seq < cut)
            try:
                m = int(multictl.run(self.comm.layout, "_device_allreduce",
                                     torch.tensor([mine], dtype=torch.int64,
                                                  device=self.comm.device),
                                     op_mod.MIN)[0])
            except Exception as e:  # noqa: BLE001 — each member raises it
                with self._lock:
                    for v in self._items.values():
                        while v and v[0][0]._seq < cut:
                            v.pop(0)[0]._fail(e)
                return
            with self._lock:
                items = self._items[key][:m]
                del self._items[key][:m]
                nbytes = sum(it[3] for it in items)
                self._bytes[key] -= nbytes
                op = self._ops[key]
            self._account(items, nbytes, "idle")
            self._fuse(items, op, nbytes, "idle")

    def _progress_cb(self) -> int:
        n = self.flush("idle")
        with self._lock:
            if not any(self._items.values()) and self._cb_registered:
                prog.unregister(self._progress_cb)
                self._cb_registered = False
        return n

    def flush(self, reason: str = "explicit") -> int:
        with self._lock:
            keys = [k for k, v in self._items.items() if v]
        return sum(self.flush_key(k, reason) for k in keys)

    def flush_key(self, key, reason: str) -> int:
        """Flush one bucket as ONE fused collective; returns the number
        of collectives launched (0 when already empty). Across
        controllers: release the held drain, which fuses on the tier's
        worker (0)."""
        if self._cross:
            multictl.release()
            return 0
        with self._lock:
            items = self._items.pop(key, None)
            total = self._bytes.pop(key, 0)
            op = self._ops.get(key)
        if not items:
            return 0
        self._account(items, total, reason)
        if self._per_rank:
            self.comm._coll_submit(
                lambda: self._fuse(items, op, total, reason))
        else:
            self._fuse(items, op, total, reason)
        return 1

    def _account(self, items: List[Tuple], total: int, reason: str) -> None:
        _count("coll_bucket_flushes")
        _count(f"coll_bucket_flush_{reason}")
        _count("coll_bucket_fused_members", len(items))
        hooks.fire("coll.bucket_flush", self.comm,
                   {"reason": reason, "members": len(items),
                    "bytes": total})

    def _fuse(self, items: List[Tuple], op, total: int, reason: str) -> None:
        tok = (_trace.begin("coll.bucket_flush",
                            cid=getattr(self.comm, "cid", None),
                            reason=reason, members=len(items),
                            nbytes=total)
               if _trace.active or _prof._is_profiler_enabled else None)
        try:
            self._launch_fused(items, op, tok is not None)
        except Exception as e:  # noqa: BLE001 — each member raises it
            for req, _pf, _ep, _nb in items:
                req._fail(e)
        finally:
            if tok is not None:
                _trace.end(tok)

    def _launch_fused(self, items: List[Tuple], op, traced: bool) -> None:
        """The fused allreduce of ``items``; on the stacked tier, while
        ``traced``, its three phases are the flush's child spans
        (``coll.bucket_pack``: the members' parts, and the fold's table
        and output where it takes the fold, else their concatenation;
        ``coll.fused_allreduce``: the fold's launch, or the selected
        allreduce; ``coll.bucket_unpack``: the members' results, the
        flush's event and the deliveries)."""
        if self._per_rank:
            from ompi_tpu_torch.core.rankcomm import RankCommunicator as RC
            flats = [pf() for _req, pf, _ep, _nb in items]
            fused = np.asarray(RC.allreduce(
                self.comm,
                flats[0] if len(flats) == 1 else np.concatenate(flats), op))
            off = 0
            for (req, _pf, ep, _nb), flat in zip(items, flats):
                ln = flat.shape[0]
                req._deliver(ep(fused[off:off + ln]), None)
                off += ln
            return
        comm = self.comm
        t_pack = _trace.begin("coll.bucket_pack") if traced else None
        try:
            parts = [pf() for _req, pf, _ep, _nb in items]     # (L, w_i)
            mod = comm._coll("allreduce")
            fold = self._fold_of(mod, parts, op) if self._sweep else None
            if fold is None:
                flat = (parts[0] if len(parts) == 1
                        else torch.cat(parts, dim=1))
        finally:
            if t_pack is not None:
                _trace.end(t_pack)
        t_red = _trace.begin("coll.fused_allreduce") if traced else None
        try:
            if fold is None:
                fused = comm._local_rows(mod.allreduce(comm._as_buffer(flat),
                                                       op))
            else:
                mod.allreduce_members(parts, *fold)
                _count("coll_bucket_folds")
        finally:
            if t_red is not None:
                _trace.end(t_red)
        t_unpack = _trace.begin("coll.bucket_unpack") if traced else None
        try:
            if fold is not None:
                table, out = fold
                outs = [ep(v) for (_req, _pf, ep, _nb), v
                        in zip(items, table.views(out))]
            else:
                outs, off = [], 0
                for (_req, _pf, ep, _nb), part in zip(items, parts):
                    w = part.shape[1]
                    outs.append(ep(fused if len(parts) == 1
                                   else _own(fused[:, off:off + w])))
                    off += w
            ev = event_after(outs)        # after the fold or the copies
            for (req, _pf, _ep, _nb), out_i in zip(items, outs):
                req._deliver(out_i, ev)
        finally:
            if t_unpack is not None:
                _trace.end(t_unpack)

    def _fold_of(self, mod, parts, op) -> Optional[Tuple]:
        """``(table, out)`` where this flush takes the bucket fold (the
        class docstring's conditions; ``mod`` is the comm's allreduce
        module), else None. The table comes from the fuser's cache or is
        built and kept; ``out`` is the flush's new output."""
        if getattr(type(mod), "allreduce_members", None) is None:
            return None
        n, dev = self.comm.size, self.comm.device
        sig = _rows_signature(parts, n, dev)
        if sig is None:
            return None
        dt = parts[0].dtype
        key = (sig, dt, op.uid, n)
        ep = var.epoch()
        with self._lock:
            hit = self._tables.get(key)
            if hit is not None:
                self._tables.move_to_end(key)
        if hit is None or hit[0] != ep:
            # the decision is the vars' (algorithm, module): asked again
            # once they change; the table, once built, is kept
            if not mod.folds(n, sum(w for _p, w in sig), dt, op):
                return None
            table = None if hit is None else hit[1]
            if table is None:
                table = bucket_fold.Table(parts, op.name)
                _count("coll_bucket_fold_tables")
            with self._lock:
                self._tables[key] = (ep, table)
                if len(self._tables) > FOLD_TABLES_MAX:
                    self._tables.popitem(last=False)
        else:
            table = hit[1]
        return table, torch.empty(n * table.total, dtype=dt, device=dev)


def fuser_of(comm) -> BucketFuser:
    f = getattr(comm, "_bucket_fuser", None)
    if f is None:
        f = comm._bucket_fuser = BucketFuser(comm)
    return f


def maybe_bucket_iallreduce(comm, data, op) -> Optional[Request]:
    """One-shot iallreduce bucketing: when ``mpi_base_bucket`` is on and
    the payload fuses, enqueue into the comm's fuser and return the
    member request; None keeps the unfused path. The caller has already
    validated (comm, data, op)."""
    if not bucket_enabled():
        return None
    spec = _bucket_spec(comm, data, op)
    if spec is None or not (0 < spec[3] <= bucket_bytes()):
        return None
    key, payload, epilogue, nbytes = spec
    return fuser_of(comm).enqueue(key, payload, epilogue, nbytes, op)


def startall(requests) -> Any:
    """MPI_Startall: start every request in order; bucketable persistent
    collectives enqueue (flushing on the bytes threshold as they
    accumulate) and any remainder flushes once at the startall boundary
    — K bucketable allreduces of b bytes launch ceil(K*b/bucket_bytes)
    fused collectives."""
    tok = (_trace.begin("coll.startall")
           if _trace.active or _prof._is_profiler_enabled else None)
    try:
        touched: List[BucketFuser] = []
        for r in requests:
            r.start()
            inner = getattr(r, "_inner_req", None)
            if isinstance(inner, _BucketMemberReq) and not inner._complete:
                touched.append(inner._fuser)
        seen: set = set()
        for f in touched:
            if id(f) not in seen:
                seen.add(id(f))
                f.flush("startall")
    finally:
        if tok is not None:
            _trace.end(tok)
    return requests


def flush_all(reason: str = "explicit") -> int:
    """Flush every live fuser's pending buckets."""
    return sum(f.flush(reason) for f in list(_live_fusers))


@contextlib.contextmanager
def startall_window():
    """Bundle a burst of persistent starts: buckets accumulated inside
    the window flush once at its boundary with reason ``startall``."""
    try:
        yield
    finally:
        flush_all("startall")


def counters() -> Dict[str, int]:
    """Snapshot of the persistent/bucket counters (tests, tools)."""
    return dict(_counts)


def _reset_for_tests() -> None:
    """Zero the counters and drop the live fusers."""
    for k in _counts:
        _counts[k] = 0
    _live_fusers.clear()
