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

Every result is a materialized tensor, never a view that a later flush
or start could write. A start's completion is the CUDA event recorded
after its launch (``core/request``).

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
``coll_bucket_fused_members``, ``coll_bucket_flush_<reason>`` and the
level ``coll_bucket_occupancy``.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ompi_tpu_torch.coll import decision
from ompi_tpu_torch.core.datatype import torch_dtype
from ompi_tpu_torch.core.errhandler import MPIError
from ompi_tpu_torch.core.request import Request, event_after
from ompi_tpu_torch.mca import pvar, var
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
             "coll_bucket_flush_explicit")
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
            elif p.fn is not None:
                # direct plan: the launch's output and event ARE the
                # completion state — no inner request
                y = p._call()
                self._result = y
                self._event = event_after(y)
                self._inner_req = None
            else:
                self._inner_req = self._persistent_start()
        except MPIError as e:
            # the request completes carrying the error instead of the
            # start raising, so a waitall over a plan batch surfaces it
            self.fail(e)
        return self


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
        if self._event is not None:
            self._event.synchronize()
        self._event = None
        self._complete = True

    def test(self):
        if not self._complete:
            if not self._delivered.is_set():
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


class BucketFuser:
    """Per-communicator small-collective fuser (DDP-style gradient
    bucketing): members on the same (op, dtype) key accumulate until a
    flush trigger, then ride ONE flattened fused allreduce. On a per-rank
    comm every flush trigger is a point of the program order (the bytes
    threshold, Startall, a wait), so every rank fuses the same buckets;
    the progress engine's idle sweep is the stacked tier's alone, and a
    per-rank flush runs on the comm's collective worker, drawing its
    sequence tag in issue order."""

    def __init__(self, comm):
        self.comm = comm
        self._per_rank = bool(getattr(comm, "is_per_rank", False))
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
        if full:
            self.flush_key(key, "bytes")
        return req

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
        of collectives launched (0 when already empty)."""
        with self._lock:
            items = self._items.pop(key, None)
            total = self._bytes.pop(key, 0)
            op = self._ops.get(key)
        if not items:
            return 0
        _count("coll_bucket_flushes")
        _count(f"coll_bucket_flush_{reason}")
        _count("coll_bucket_fused_members", len(items))
        hooks.fire("coll.bucket_flush", self.comm,
                   {"reason": reason, "members": len(items),
                    "bytes": total})

        def run():
            tok = (_trace.begin("coll.bucket_flush",
                                cid=getattr(self.comm, "cid", None),
                                reason=reason, members=len(items),
                                nbytes=total)
                   if _trace.active else None)
            try:
                self._launch_fused(items, op)
            except Exception as e:  # noqa: BLE001 — each member raises it
                for req, _pf, _ep, _nb in items:
                    req._fail(e)
            finally:
                if tok is not None:
                    _trace.end(tok)
        if self._per_rank:
            self.comm._coll_submit(run)
        else:
            run()
        return 1

    def _launch_fused(self, items: List[Tuple], op) -> None:
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
        parts = [pf() for _req, pf, _ep, _nb in items]     # (L, w_i)
        comm = self.comm
        fused = comm._local_rows(comm._coll("allreduce").allreduce(
            comm._as_buffer(parts[0] if len(parts) == 1
                            else torch.cat(parts, dim=1)), op))
        outs, off = [], 0
        for (_req, _pf, ep, _nb), part in zip(items, parts):
            w = part.shape[1]
            outs.append(ep(fused if len(parts) == 1
                           else _own(fused[:, off:off + w])))
            off += w
        ev = event_after(outs)              # after the slices' copies
        for (req, _pf, _ep, _nb), out in zip(items, outs):
            req._deliver(out, ev)


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
