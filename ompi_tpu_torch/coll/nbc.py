"""coll/nbc — nonblocking collectives as round-based *schedules*.

Behavioral spec: ``ompi/mca/coll/libnbc`` — a nonblocking collective is
compiled into a schedule of rounds (``nbc_internal.h:156-168``: each
round is a batch of send/recv/op/copy primitives with a barrier between
rounds) and executed incrementally by a progress callback registered
with ``opal_progress`` (``coll_libnbc_component.c:555-601``); the user's
``MPI_Test/Wait`` drives progress. The port of ``ompi_tpu/coll/nbc.py``.

- A round is a plain torch function of the schedule's state: the
  send/recv/op batch of a ring step collapses into an out-of-place
  ``index_put`` on the stacked tensor, at long index tensors built once
  per schedule on the state's device (the schedule cache).
- **The inter-round barrier is stream order.** Every round of a schedule
  goes to the stream that was current on the communicator's device when
  the schedule was created, so the device runs the rounds in order
  behind the host, as XLA chains the JAX rounds through their data
  dependencies. The progress engine therefore *dispatches* (never
  waits): each ``test()`` enqueues the next round and returns.
- Completion is a CUDA event recorded on that stream right after the
  last round (and the finalize slice, which materializes the result):
  ``test`` polls it, ``wait`` synchronizes on it. On the CPU the rounds
  run inside the dispatch and there is no event.
- Large payloads skip the multi-round schedule: one fused round
  dispatches the blocking path's selected lowering. The switch point is
  ``coll_nbc_fused_min_bytes`` (of the stacked buffer).
- With ``mpi_base_bucket`` on, small iallreduces coalesce in
  ``coll/persistent``'s BucketFuser before they reach this component;
  the fuser's idle sweep rides the same progress engine.
- Across controllers (a comm whose rows sit in several controller
  processes) the rounds step over this controller's rows along
  ``coll/torch``'s rank axis: a round that takes another controller's
  rows is one round of the hidden controller tier. The rounds run on
  that tier's collective worker, queued when the request starts, so
  every controller runs them in the order the comm's requests were
  started; ``test()`` reads whether they ran and never waits on another
  controller. The fused round dispatches the blocking cross-controller
  lowering.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ompi_tpu_torch.coll.framework import coll_framework
from ompi_tpu_torch.core import multictl
from ompi_tpu_torch.core import op as op_mod
from ompi_tpu_torch.core.errhandler import ERR_OP, MPIError
from ompi_tpu_torch.core.request import Request, event_on, stream_of
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.mca.base import Component
from ompi_tpu_torch.runtime import progress as prog


class ScheduleRequest(Request):
    """A request completed by dispatching schedule rounds through the
    progress engine (the libnbc NBC_Handle role)."""

    def __init__(self, module: "NbcModule", state: Any,
                 rounds: List[Callable[[Any], Any]],
                 finalize: Optional[Callable[[Any], Any]] = None):
        super().__init__()
        self._complete = False
        self._module = module
        self._state = state
        self._rounds = deque(rounds)
        self._finalize = finalize
        # the stream every round and the completion event go to
        self._stream = stream_of(module.comm.device)
        # rounds run later from the progress engine; they observe the MCA
        # var scopes of the creating context (a session collective's
        # deferred round would otherwise read the global store and ignore
        # the session's algorithm overrides)
        self._scopes = var.current_scopes()
        module._ensure_progress_cb()
        module._active.append(self)
        # across controllers the rounds run on the controller tier's
        # collective worker, queued in the order the comm's requests were
        # started (alike on every controller); test() only reads ``_ran``
        self._ran: Optional[threading.Event] = None
        self._failed: Optional[BaseException] = None
        if module.comm.is_multiprocess and self._rounds:
            self._ran = threading.Event()
            multictl.tier(module.comm.layout.ctrls)._coll_submit(self._run_all)
        elif not self._rounds:
            self._seal()

    @property
    def rounds_left(self) -> int:
        return len(self._rounds)

    def _seal(self) -> None:
        """After the last round: finalize, then mark the stream."""
        if self._finalize is not None:
            with var.scopes_active(self._scopes):
                self._state = self._finalize(self._state)
        self._event = event_on(self._stream)

    def _run_all(self) -> None:
        """Every round, then the seal, on the tier's worker; a round that
        moves rows between controllers is one tier round."""
        try:
            with torch.cuda.stream(self._stream), \
                    var.scopes_active(self._scopes):
                while self._rounds:
                    self._state = self._rounds[0](self._state)
                    self._rounds.popleft()
                self._seal()
        except BaseException as e:      # noqa: BLE001 — raised at wait
            self._failed = e
        finally:
            self._ran.set()

    def _progress(self) -> int:
        """Dispatch at most one round; returns 1 if something happened.
        Never blocks."""
        if self._complete:
            return 0
        if self._ran is not None:
            if not self._ran.is_set():
                # the tier's worker runs it: a polling caller yields the
                # interpreter to it instead of spinning against it
                time.sleep(0)
                return 0
            if self._failed is not None:
                self.fail(self._failed)
                self._module._active.remove(self)
                return 1
        elif self._rounds:
            rnd = self._rounds.popleft()
            with torch.cuda.stream(self._stream), \
                    var.scopes_active(self._scopes):
                self._state = rnd(self._state)
                if not self._rounds:
                    self._seal()
            return 1
        if self._event is not None and not self._event.query():
            return 0                       # in flight on the device
        self._result = self._state
        self._event = None
        self._complete = True
        self._module._active.remove(self)
        return 1

    def test(self):
        if not self._complete:
            prog.progress()
        if self._error is not None:
            raise self._error
        return (True, self.status) if self._complete else (False, None)

    def wait(self):
        if self._ran is not None:
            self._ran.wait()
        # drain the dispatch queue, then block on the completion event
        while not self._complete and self._rounds:
            prog.progress()
        if not self._complete:
            if self._event is not None:
                self._event.synchronize()
            while not self._complete:
                prog.progress()
        if self._error is not None:
            raise self._error
        return self.status


class NbcModule:
    """Round schedules per collective, on stacked tensors (N, ...)."""

    def __init__(self, comm):
        self.comm = comm
        self._active: List[ScheduleRequest] = []
        self._cb_registered = False
        # schedule cache: round lists and finalizers are pure functions
        # of (collective, nranks, shape, dtype, op or root); ScheduleRequest
        # copies the list into its own deque, so cached lists never change
        self._sched: Dict[Tuple, tuple] = {}
        self._ax = None

    # -- component progress callback (coll_libnbc_component.c:555) -----
    def _ensure_progress_cb(self) -> None:
        if not self._cb_registered:
            prog.register(self._progress_cb)
            self._cb_registered = True

    def _progress_cb(self) -> int:
        n = 0
        for req in list(self._active):
            n += req._progress()
        if not self._active:
            # keep the engine's callback list tight across many comms
            prog.unregister(self._progress_cb)
            self._cb_registered = False
        return n

    # -- fused fast path ----------------------------------------------
    def _fused_min(self) -> int:
        return var.var_get("coll_nbc_fused_min_bytes", 1 << 16)

    def _fused(self, func: str, x) -> Optional[Callable]:
        """For payloads past the switch point, the schedule is ONE round
        dispatching the blocking path's selected lowering (across
        controllers, its cross-controller lowering)."""
        if x.nbytes < self._fused_min():
            return None
        mod = self.comm.c_coll.get(func)
        return getattr(mod, func, None) if mod is not None else None

    # -- schedules ----------------------------------------------------
    def _axis(self):
        """The rank axis the rounds step along (``coll/torch``'s): every
        rank's row, or this controller's rows of a comm spanning
        controllers, whose rounds take other controllers' rows in one
        tier round each."""
        if self._ax is None:
            from ompi_tpu_torch.coll.torch_ import TorchCollModule
            self._ax = TorchCollModule(self.comm)._axis()
        return self._ax

    def _operand(self, x):
        """(this controller's rows as a tensor, the fused round's operand,
        the wrap of a result): the stacked tensor itself on one
        controller; across controllers the rows held here, the ``Rows``
        buffer, and ``Rows.like``."""
        if self.comm.is_multiprocess:
            rows = self.comm._rows_of(x)
            return rows.local, rows, rows.like
        x = self._tensor(x)
        return x, x, None

    def _tensor(self, x) -> torch.Tensor:
        dev = self.comm.device
        if isinstance(x, torch.Tensor):
            return x if x.device == dev else x.to(dev)
        return torch.as_tensor(np.asarray(x), device=dev)

    def _chunked(self, x: torch.Tensor, rec: int = 1):
        """Pad the flattened rank row to a multiple of comm size and view
        it as (L, N, C, rec) chunks (the ring algorithms' segmentation;
        L rows held here). ``rec`` is the record width a chunk never
        splits: 2 for the (value, index) pairs of MINLOC/MAXLOC, 1
        otherwise."""
        n, L = self.comm.size, x.shape[0]
        flat = x.reshape(L, -1, rec)
        length = flat.shape[1]
        c = max(1, math.ceil(length / n))
        pad = c * n - length
        if pad:
            flat = torch.cat([flat, flat.new_zeros((L, pad, rec))], dim=1)
        return flat.reshape(L, n, c, rec), length * rec, tuple(x.shape)

    @staticmethod
    def _wrapped(finalize, wrap):
        if wrap is None:
            return finalize
        if finalize is None:
            return wrap
        return lambda st: wrap(finalize(st))

    def iallreduce(self, x, op: op_mod.Op = op_mod.SUM) -> ScheduleRequest:
        """Ring allreduce: N-1 reduce-scatter rounds + N-1 allgather
        rounds (coll_base_allreduce.c:345; the 2(N-1)-step loop)."""
        n = self.comm.size
        x, whole, wrap = self._operand(x)
        if n == 1:
            return ScheduleRequest(self, x.clone(), [])
        fused = self._fused("allreduce", whole)
        if fused is not None:
            return ScheduleRequest(self, whole, [lambda b: fused(b, op)])
        # uint16/32/64 run on the signed twin (core/op.unsigned_route)
        route = op_mod.unsigned_route(x.dtype, op)
        if route is not None:
            x = route[1](x)
        if op.is_loc and (x.ndim < 2 or x.shape[-1] != 2):
            raise MPIError(ERR_OP, f"{op.name} needs trailing (value, "
                           f"index) pairs, got shape {tuple(x.shape)}")
        chunks, length, shape = self._chunked(x, 2 if op.is_loc else 1)
        skey = ("iar", n, shape, x.dtype, op.uid)
        hit = self._sched.get(skey)
        if hit is None:
            fn = op.fn
            ax = self._axis()
            rows = ax.lr
            r = np.arange(n)
            prev = (r - 1) % n             # each rank's ring predecessor

            def rs(c):
                # rank r folds the chunk (r-1-s) its predecessor holds
                # into its own copy
                cidx, take = ax.col(c), ax.get(prev, pos=c)
                return lambda acc: acc.index_put(
                    (rows, cidx), fn(acc[rows, cidx], take(acc)))

            def ag(c):
                # rank r takes the finished chunk (r-s) from its
                # predecessor
                cidx, take = ax.col(c), ax.get(prev, pos=c)
                return lambda acc: acc.index_put((rows, cidx), take(acc))

            rounds = ([rs((r - 1 - s) % n) for s in range(n - 1)]
                      + [ag((r - s) % n) for s in range(n - 1)])

            def finalize(acc):
                # one copy: the result never aliases the schedule's state
                return acc.reshape(acc.shape[0], -1)[:, :length].clone(
                    memory_format=torch.contiguous_format).reshape(shape)

            hit = self._sched[skey] = (rounds, finalize)
        rounds, finalize = hit
        if route is not None:
            finalize = (lambda acc, f=finalize, back=route[2]:
                        back(f(acc)))
        return ScheduleRequest(self, chunks, rounds,
                               self._wrapped(finalize, wrap))

    def ibcast(self, x, root: int = 0) -> ScheduleRequest:
        """Binomial-tree bcast: ceil(log2 N) rounds; in round k ranks
        with vrank < 2^k feed vrank + 2^k (coll_base_bcast binomial)."""
        n = self.comm.size
        x, whole, wrap = self._operand(x)
        if n == 1:
            return ScheduleRequest(self, x.clone(), [])
        fused = self._fused("bcast", whole)
        if fused is not None:
            return ScheduleRequest(self, whole, [lambda b: fused(b, root)])
        skey = ("ibc", n, tuple(x.shape), x.dtype, root)
        hit = self._sched.get(skey)
        if hit is None:
            ax = self._axis()
            rows = np.arange(n)
            vr = (rows - root) % n
            dev = self.comm.device
            rounds = []
            for k in range(max(1, math.ceil(math.log2(n)))):
                two_k = 1 << k
                active = (vr >= two_k) & (vr < 2 * two_k)
                take = ax.get(np.where(active, (vr - two_k + root) % n,
                                       rows))
                mask = torch.as_tensor(active[ax.mine], device=dev).reshape(
                    (len(ax.mine),) + (1,) * (x.ndim - 1))
                rounds.append(lambda b, take=take, mask=mask:
                              torch.where(mask, take(b), b))
            hit = self._sched[skey] = (rounds,)
        return ScheduleRequest(self, x, *hit, wrap)

    def iallgather(self, x) -> ScheduleRequest:
        """Ring allgather: N-1 rounds; round s moves the chunk each rank
        completed s rounds ago to its +1 neighbor (the ring algorithm of
        the base registry)."""
        n = self.comm.size
        x, whole, wrap = self._operand(x)
        fused = self._fused("allgather", whole)
        if fused is not None:
            return ScheduleRequest(self, whole, [fused])
        ax = self._axis()
        rows = ax.lr
        # the rounds move bits: a type torch cannot index_put (uint16/32/
        # 64) travels as its signed twin and is viewed back at the end
        twin = op_mod.SIGNED_TWIN.get(x.dtype)
        dt = x.dtype
        if twin is not None:
            x = x.view(twin)
        out0 = x.new_zeros((x.shape[0], n) + tuple(x.shape[1:])).index_put(
            (rows, ax.col(np.arange(n))), x)
        back = (lambda out: out.view(dt)) if twin is not None else None
        if n == 1:
            return ScheduleRequest(self, out0.view(dt), [], wrap)
        skey = ("iag", n, tuple(out0.shape), x.dtype)
        hit = self._sched.get(skey)
        if hit is None:
            r = np.arange(n)
            prev = (r - 1) % n

            def step(c):
                cidx, take = ax.col(c), ax.get(prev, pos=c)
                return lambda out: out.index_put((rows, cidx), take(out))

            hit = self._sched[skey] = (
                [step((r - 1 - s) % n) for s in range(n - 1)],)
        return ScheduleRequest(self, out0, *hit,
                               self._wrapped(back, wrap))

    def ibarrier(self) -> ScheduleRequest:
        """Dissemination barrier: ceil(log2 N) host rounds with no data
        plane (the reference's dissemination round count). Its
        completion event marks everything queued before it on the
        communicator's stream. Across controllers the first round is the
        controller tier's barrier, behind the device's earlier work."""
        n = self.comm.size
        rounds = [(lambda st: st)
                  for _ in range(max(1, math.ceil(math.log2(max(n, 2)))))]
        if self.comm.is_multiprocess:
            dev = self._axis()._mod
            rounds[0] = lambda st: dev._mc_barrier()
        return ScheduleRequest(self, None, rounds)


class NbcComponent(Component):
    name = "nbc"

    def register_params(self) -> None:
        var.var_register("coll", "nbc", "priority", vtype="int", default=30,
                         help="Selection priority of the schedule-based "
                              "nonblocking collective component")
        var.var_register("coll", "nbc", "fused_min_bytes", vtype="int",
                         default=1 << 16,
                         help="Payloads at/above this size (of the stacked "
                              "buffer) dispatch the blocking path's "
                              "lowering as one fused asynchronous round "
                              "instead of a multi-round schedule")

    def comm_query(self, comm):
        prio = var.var_get("coll_nbc_priority", 30)
        if comm is None or prio < 0:
            return None
        return (prio, NbcModule(comm))


coll_framework.register(NbcComponent())
