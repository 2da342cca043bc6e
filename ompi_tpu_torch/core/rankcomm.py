"""RankCommunicator — the per-rank (multi-controller) execution model.

Behavioral spec: the textbook MPI model every reference binding serves —
``MPI_Comm_rank`` returns this process's rank (``ompi/mpi/c/comm_rank.c.in``),
point-to-point moves bytes between processes
(``ompi/mca/pml/ob1/pml_ob1_recvfrag.c:296-330`` matching), collectives are
called by every member and return each caller its own result, and
``mpirun -n N`` launches N such processes. The port of
``ompi_tpu/core/rankcomm.py``.

One OS process is one MPI rank, bound to one device
(``cuda:(local_rank % device_count)``, or the CPU when the job asks for
it). Two tiers:

- **Host tier** (the byte planes of btl/tcp and btl/sm): pt2pt and the
  collectives on numpy arrays and Python objects run textbook algorithms
  (dissemination barrier, binomial bcast/reduce, ring allgather, pairwise
  alltoall — the coll/base registry, ``coll_base_functions.h:185-320``),
  plus the combined small-message allreduce, and for large payloads the
  in-segment shared-memory fold (btl/shmseg), the segment-pipelined ring
  allreduce and the chain bcast (whose hops ride pml/pipeline). With
  ``mpi_base_compress`` on, eligible host hops carry quantized payloads
  (``compress/wire``).
- **Device tier** (the shared-buffer tier): collectives on device tensors
  replace the reference's one XLA program over the process mesh. Each
  communicator lazily allocates, on every member's device, a staging slot
  that every member maps through IPC handles (CUDA IPC on the card,
  shared-memory segments on the CPU), exchanged once. An allreduce copies
  its input into its own slot, fences, reduces its 1/N chunk from every
  slot (a reduce-scatter read), fences, and gathers the reduced chunks;
  bcast, allgather and alltoall are the same reads without the reduction.
  A fence is a stream synchronize and a host barrier on the hidden
  channel. Slots alternate between two parity regions, so a region is
  rewritten only after the next device collective's first fence, which
  every peer reaches only after its reads of this one are done. No byte of
  the payload touches the host. Host numpy buffers of at least
  ``coll_tuned_stage_min_bytes`` are staged onto the device tier.

Internal collective traffic rides a hidden CID channel (``("c", cid)``),
so it never matches user point-to-point tags. Communicator creation is
collective, so a deterministic derivation (parent cid + per-parent
creation sequence + color) gives every member the same child CID with no
extra traffic (the property of ``comm_cid.c:61-109``).

ULFM over real process death (``mpiext/ftmpi``): the failure registry
(``runtime/ft``) is fed by the btl's EOF monitor, the heartbeat detector
and peers' obituaries; pending operations on a dead rank complete with
``ERR_PROC_FAILED``. ``revoke`` floods the router's revoke frame,
``agree`` and ``shrink`` run ``coll/ftagree``'s early-returning
agreement among the survivors. A dead member's device-tier slot is never
read again: every slot read checks the registry first, and ``shrink``
and ``free`` close the survivors' mappings of it without a fence.
"""
from __future__ import annotations

import functools
import itertools
import queue
import socket
import threading
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ompi_tpu_torch import accelerator
from ompi_tpu_torch.compress import wire as _cwire
from ompi_tpu_torch.core import op as op_mod
from ompi_tpu_torch.core.errhandler import (ERR_ARG, ERR_COMM, ERR_COUNT,
                                            ERR_OP, ERR_PROC_FAILED, ERR_RANK,
                                            ERR_REVOKED, ERR_ROOT,
                                            ERR_TOPOLOGY, ERRORS_ARE_FATAL,
                                            Errhandler, MPIError)
from ompi_tpu_torch.core.group import UNDEFINED, Group
from ompi_tpu_torch.core.info import Info
from ompi_tpu_torch.core.request import Request, Status
from ompi_tpu_torch.ft import inject as _inject
from ompi_tpu_torch.pml.perrank import (ANY_SOURCE, ANY_TAG,
                                        PerRankEngine, RankRequest, Router,
                                        _Msg)
from ompi_tpu_torch.runtime import ft, spc
from ompi_tpu_torch.utils import hooks as _hooks_mod

# what ran, by path: read by tests and the chip smoke; each bump is an
# SPC count too (``spc_<path>``), as the reference records them
counters: Dict[str, int] = dict.fromkeys((
    "coll_device", "coll_staged_device", "coll_small_combine",
    "coll_compress_direct", "coll_shm_fold", "coll_pipelined_ring",
    "coll_pipelined_chain"), 0)


def _ran(path: str) -> None:
    counters[path] += 1
    spc.record(path, 1)

# Compressed host-tier allreduce: worlds at or below this size take the
# direct code exchange (one parallel round, one quantization per
# contribution); larger worlds the binomial reduce and the code-forwarding
# bcast, whose wire bytes per rank stay O(1)
_WIRE_DIRECT_MAX_RANKS = 4

_SLOT_ALIGN = 1 << 20
_live_slots: "weakref.WeakSet" = weakref.WeakSet()


class _HiddenChannel:
    """A hidden matching-channel view of a communicator: same ranks,
    separate CID, so internal and tool messages never match user
    receives. Channels: "c" collectives, "part" partitioned pt2pt."""

    def __init__(self, comm: "RankCommunicator", prefix: str):
        self._comm = comm
        self.cid = (prefix, comm.cid)

    @property
    def size(self) -> int:
        return self._comm.size

    def rank(self) -> int:
        return self._comm.rank()

    def world_rank_of(self, local: int) -> int:
        return self._comm.world_rank_of(local)


class _CollChannel(_HiddenChannel):
    def __init__(self, comm: "RankCommunicator"):
        super().__init__(comm, "c")


def hidden_engine(comm: "RankCommunicator", prefix: str) -> PerRankEngine:
    """The matching engine of one hidden channel of ``comm``, made on
    first use (two engines on one CID would split matching state) and
    closed with the communicator."""
    with comm._lock:
        eng = comm._aux_pmls.get(prefix)
        if eng is None:
            eng = PerRankEngine(_HiddenChannel(comm, prefix), comm.router)
            comm._aux_pmls[prefix] = eng
    return eng


class _SlotRequest(Request):
    """A request completed by a posted CombineSlot (the persistent small
    allreduce's Start): waiting blocks on the slot, takes its rank-order
    fold and retires the slot's tag."""

    def __init__(self, eng, tag: int, slot, epilogue):
        super().__init__()
        self._complete = False
        self._eng = eng
        self._tag_ = tag
        self._slot = slot
        self._epilogue = epilogue

    def _collect(self, timeout: Optional[float] = None) -> None:
        try:
            out = self._slot.wait(600 if timeout is None else timeout)
        finally:
            self._eng.end_combine(self._tag_)
            self._complete = True
        self._result = self._epilogue(out)

    def test(self):
        if not self._complete:
            if not self._slot._event.is_set():
                return False, None
            self._collect()
        return True, self.status

    def wait(self, timeout: Optional[float] = None) -> Status:
        if not self._complete:
            self._collect(timeout)
        return self.status


def chunk_bounds(numel: int, n: int, rec: int = 1) -> List[int]:
    """Element bounds of the n chunks of the device tier's reduce-scatter
    read: chunk i is [b[i], b[i+1]); ragged sizes spread the remainder
    over the chunks, and a chunk may be empty. Bounds fall on whole
    records of ``rec`` elements (a pair op's (value, index) records)."""
    recs = numel // rec
    return [(recs * i) // n * rec for i in range(n + 1)]


class _SharedSlots:
    """The device tier's state of one communicator: this rank's exported
    slot (two parity regions of ``cap`` bytes) and every member's mapping
    of theirs."""

    def __init__(self, comm: "RankCommunicator"):
        self.comm = comm
        self.cap = 0
        self.buf: Optional[accelerator.IpcBuffer] = None
        self.maps: List[Optional[accelerator.IpcMapping]] = []
        self.parity = 0
        self.dead: set = set()           # members whose mapping closed
        _live_slots.add(self)

    def ensure(self, nbytes: int) -> None:
        """Grow the slots (collective: every member asks for the same
        size). The old slots are freed only after a fence, once no peer
        can still be reading them."""
        if self.buf is not None and nbytes <= self.cap:
            return
        if self.buf is not None:
            self.comm._fence()
            self.close()
        cap = max(-(-nbytes // _SLOT_ALIGN) * _SLOT_ALIGN, _SLOT_ALIGN)
        mod = accelerator.current_module()
        self.buf = mod.ipc_buffer(2 * cap, self.comm.device)
        handles = self.comm._host_allgather(self.buf.handle)
        me = self.comm.rank()
        self.maps = [None if i == me else mod.open_ipc_handle(h)
                     for i, h in enumerate(handles)]
        self.cap = cap

    def flip(self) -> int:
        """The parity region of the next collective."""
        self.parity ^= 1
        return self.parity

    def view(self, i: int, parity: int, nbytes: int, dtype) -> torch.Tensor:
        """Member i's region ``parity``, first ``nbytes``, as flat
        ``dtype``. A dead member's slot is never read: the registry is
        checked before the copy is issued (once its exporting process is
        gone, reads through its IPC handle are undefined)."""
        if i in self.dead or (i != self.comm.rank() and ft.is_failed(
                self.comm.world_rank_of(i))):
            raise MPIError(ERR_PROC_FAILED,
                           f"device-tier slot of rank {i} belongs to a "
                           f"failed process")
        t = self.buf.tensor if self.maps[i] is None else self.maps[i].tensor
        off = parity * self.cap
        return t[off:off + nbytes].view(dtype)

    def drop_failed(self) -> None:
        """Close this rank's mappings of failed members' slots without
        touching them (no fence: the dead never arrive)."""
        for i, m in enumerate(self.maps):
            if m is not None and ft.is_failed(self.comm.world_rank_of(i)):
                self.maps[i] = None
                self.dead.add(i)
                m.close()

    def close(self) -> None:
        for m in self.maps:
            if m is not None:
                m.close()
        self.maps = []
        self.dead = set()
        if self.buf is not None:
            self.buf.close()
            self.buf = None
        self.cap = 0


def close_device_tiers() -> None:
    """Finalize, after the job's last fence: drop every communicator's
    mappings and slots."""
    for s in list(_live_slots):
        s.close()
    _live_slots.clear()


def _serialized(fn):
    """Every public collective entry runs on the communicator's single
    collective context: ``_tag()`` draws at execution time, and the draws
    agree across ranks only if each rank runs the comm's collectives in
    issue order, one at a time. A blocking collective issued while
    nonblocking ones are pending queues behind them; with an idle worker
    it runs inline."""
    @functools.wraps(fn)
    def entry(self, *a, **kw):
        return self._coll_serial(fn, self, *a, **kw)
    return entry


class RankCommunicator:
    """A communicator whose caller is exactly one rank."""

    is_per_rank = True

    def __init__(self, group: Group, my_world_rank: int, router: Router,
                 device, *, cid: Any = "w", name: str = "",
                 parent: Optional["RankCommunicator"] = None,
                 errhandler: Optional[Errhandler] = None,
                 info: Optional[Info] = None):
        self.group = group
        self.router = router
        self.device = torch.device(device)
        self.cid = cid
        self.name = name or f"comm#{cid}"
        self.info = info.dup() if info else Info()
        self.errhandler = errhandler or (
            parent.errhandler if parent else ERRORS_ARE_FATAL)
        self.attributes: Dict[int, Any] = {}
        self.topo = None
        self._freed = False
        self._rank = group.rank_of(my_world_rank)
        if self._rank == UNDEFINED:
            raise MPIError(ERR_RANK, f"process world rank {my_world_rank} "
                                     f"is not a member of {self.name}")
        self._my_world = my_world_rank
        self._pml = PerRankEngine(self, router)
        self._coll_pml = PerRankEngine(_CollChannel(self), router)
        self._aux_pmls: Dict[str, PerRankEngine] = {}   # hidden_engine
        # ownership list (MPI-4 Sessions): a session-created comm carries
        # the session's comm list, so derived comms (dup/split/cart/
        # shrink) register too and finalize frees the whole family
        owners = getattr(parent, "_owner_list", None)
        if owners is not None:
            self._owner_list = owners
            owners.append(self)
        self._seq = itertools.count(1)          # collective sequence
        self._create_seq = itertools.count(1)   # comm-creation sequence
        self._small_fold: Dict[Any, Callable] = {}  # op.uid -> fold
        self._slots: Optional[_SharedSlots] = None
        self._lock = threading.Lock()
        self._cq: Optional["queue.Queue"] = None   # serial collective
        self._cworker: Optional[threading.Thread] = None  # executor
        self._cclosed = False
        # the interposition tier of the coll framework (sync, monitoring,
        # the tracer) wraps this comm's bound collective methods, as the
        # stacked composer wraps a vtable: the same MCA vars
        from ompi_tpu_torch.coll.interpose_perrank import interpose
        interpose(self)
        # revoke plane (MPIX_Comm_revoke): when the router's reliable
        # broadcast revokes this cid, every pending operation on the comm
        # completes with ERR_REVOKED
        router.register_revoke_cb(self.cid, self._on_revoked)

    # ------------------------------------------------------------------
    @property
    def size(self) -> int:
        return self.group.size

    def rank(self) -> int:
        """MPI_Comm_rank: this process's rank."""
        return self._rank

    def world_rank_of(self, local: int) -> int:
        return self.group.world_ranks[local]

    def _err(self, error_class: int, msg: str = ""):
        return self.errhandler.invoke(self, error_class, msg)

    def _check(self) -> None:
        if self._freed:
            raise MPIError(ERR_COMM, "communicator has been freed")
        if self.router.is_revoked(self.cid):
            # ULFM: every operation on a revoked comm (except the
            # recovery surface — shrink/agree/get_failed/free, which
            # bypass _check) raises ERR_REVOKED (comm_revoke.c)
            raise MPIError(ERR_REVOKED, f"{self.name} has been revoked")

    def _validate_root(self, root: int) -> int:
        if not (0 <= root < self.size):
            self._err(ERR_ROOT, f"root {root} out of range")
        return root

    def _validate_op(self, op) -> op_mod.Op:
        if not isinstance(op, op_mod.Op) or op.fn is None:
            self._err(ERR_OP, "invalid reduction op")
        return op

    # ==================================================================
    # Point-to-point (textbook signatures: the caller is the rank)
    # ==================================================================
    def send(self, data: Any, dest: int, tag: int = 0) -> None:
        self._check()
        spc.record("pml_send", 1)
        self._pml.send(data, dest, tag)

    def isend(self, data: Any, dest: int, tag: int = 0) -> Request:
        self._check()
        spc.record("pml_send", 1)
        return self._pml.send(data, dest, tag)

    def ssend(self, data: Any, dest: int, tag: int = 0) -> None:
        self._check()
        spc.record("pml_send", 1)
        self._pml.send(data, dest, tag, synchronous=True)

    def bsend(self, data: Any, dest: int, tag: int = 0) -> None:
        self.send(data, dest, tag)        # sends are always buffered

    def recv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG
             ) -> Tuple[Any, Status]:
        self._check()
        spc.record("pml_recv", 1)
        return self._pml.recv(source, tag)

    def irecv(self, source: int = ANY_SOURCE,
              tag: int = ANY_TAG) -> RankRequest:
        self._check()
        spc.record("pml_recv", 1)
        return self._pml.irecv(source, tag)

    def sendrecv(self, senddata: Any, dest: int, source: int = ANY_SOURCE,
                 sendtag: int = 0, recvtag: int = ANY_TAG
                 ) -> Tuple[Any, Status]:
        """Deadlock-free: the receive is posted before the (eager,
        buffered) send."""
        self._check()
        req = self._pml.irecv(source, recvtag)
        self._pml.send(senddata, dest, sendtag)
        st = req.wait()
        return req.get(), st

    def probe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG) -> Status:
        self._check()
        return self._pml.probe(source, tag)

    def iprobe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG):
        self._check()
        return self._pml.iprobe(source, tag)

    def mprobe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG):
        self._check()
        return self._pml.mprobe(source, tag)

    def improbe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG):
        self._check()
        flag, status = self._pml.iprobe(source, tag)
        if not flag:
            return False, None, None
        return True, self._pml.mprobe(source, tag), status

    def mrecv(self, message) -> Tuple[Any, Status]:
        return self._pml.mrecv(message)

    def send_init(self, data: Any, dest: int, tag: int = 0) -> Request:
        self._check()
        return Request(persistent_start=lambda: self._pml.send(
            data, dest, tag))

    def recv_init(self, source: int = ANY_SOURCE,
                  tag: int = ANY_TAG) -> Request:
        self._check()
        return Request(persistent_start=lambda: self._pml.irecv(
            source, tag))

    # ==================================================================
    # Collectives — host tier
    # ==================================================================
    def _tag(self) -> int:
        """Per-collective sequence tag: every member draws the same one."""
        return next(self._seq)

    def _csend(self, dest: int, tag: int, data: Any) -> None:
        self._coll_pml.send(data, dest, tag)

    def _crecv(self, src: int, tag: int) -> Any:
        data, _ = self._coll_pml.recv(src, tag)
        return data

    def _is_dev(self, data: Any) -> bool:
        """A tensor in device memory takes the device tier."""
        return (isinstance(data, torch.Tensor)
                and accelerator.check_addr(data) == accelerator.LOCUS_DEVICE)

    def _stageable(self, data: Any, op: Optional[op_mod.Op] = None,
                   nbytes: Optional[int] = None,
                   func: str = "allreduce") -> bool:
        """Whether a host buffer is staged onto the device tier. Called
        only with arguments whose shape, dtype and size agree on every
        member, so every rank decides alike (the device tier is
        collective); bcast carries the root's decision instead."""
        from ompi_tpu_torch.coll.tuned import stage_min_for
        if not isinstance(data, np.ndarray) or data.dtype.kind not in "fiub":
            return False
        if (data.nbytes if nbytes is None else nbytes) < stage_min_for(func):
            return False
        if op is not None and (op.is_loc or op.fn is None):
            return False                 # pair ops stay on the host fold
        return True

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    @staticmethod
    def _to_host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    def _dissemination(self, t: int) -> None:
        n, r = self.size, self._rank
        k = 1
        while k < n:
            self._csend((r + k) % n, t, None)
            self._crecv((r - k) % n, t)
            k <<= 1

    @_serialized
    def barrier(self) -> None:
        """Dissemination barrier: ceil(log2 n) rounds
        (coll_base_barrier.c)."""
        self._check()
        spc.record("coll_barrier", 1)
        self._dissemination(self._tag())

    @_serialized
    def bcast(self, data: Any = None, root: int = 0) -> Any:
        """Binomial-tree bcast (coll_base_bcast.c): non-root callers pass
        nothing and receive the root's value. A device tensor (passed by
        every caller, of one shape) takes the device tier. Host arguments
        are asymmetric, so the root's decision rides the first binomial
        round with the payload: staged -> (("stage", ...), None) and the
        payload takes the device tier; a large array -> (("chain",), None)
        and the payload follows as the pipelined chain; otherwise (None,
        data), compressed where eligible."""
        self._check()
        self._validate_root(root)
        spc.record("coll_bcast", 1)
        if self._is_dev(data):
            return self._device_bcast(data, root)
        if self._rank == root:
            if self._stageable(data, func="bcast"):
                msg = (("stage", tuple(data.shape), data.dtype.str), None)
            elif self._pipeline_bcast_ok(data):
                msg = (("chain",), None)
            elif _cwire.eligible(data):
                # quantize once at the root; the tree forwards the codes
                # as they are (one quantization error in all)
                msg = (None, _cwire.encode(data))
            else:
                msg = (None, data)
        else:
            msg = None
        meta, payload = self._host_bcast(msg, root)
        if meta is None:
            return data if self._rank == root \
                else _cwire.maybe_decode(payload)
        if meta[0] == "chain":
            return self._pipelined_chain_bcast(data, root)
        _ran("coll_staged_device")
        local = (data if self._rank == root
                 else np.empty(meta[1], np.dtype(meta[2])))
        res = self._device_bcast(self._to_dev(local), root)
        return data if self._rank == root else self._to_host(res)

    def _host_bcast(self, data: Any, root: int) -> Any:
        n, t = self.size, self._tag()
        vr = (self._rank - root) % n
        mask = 1
        while mask < n:                  # climb to my parent
            if vr & mask:
                data = self._crecv(((vr - mask) + root) % n, t)
                break
            mask <<= 1
        mask >>= 1
        while mask:                      # feed my subtree
            if vr + mask < n:
                self._csend(((vr + mask) + root) % n, t, data)
            mask >>= 1
        return data

    @_serialized
    def reduce(self, data: Any, op: op_mod.Op = op_mod.SUM,
               root: int = 0) -> Any:
        """Binomial reduce for commutative ops; a linear ordered fold at
        the root otherwise (coll_base_allreduce.c:291-294)."""
        self._check()
        self._validate_op(op)
        self._validate_root(root)
        spc.record("coll_reduce", 1)
        n, t = self.size, self._tag()
        if n == 1:
            return data
        if not op.commute:
            rows = self._gather(data, root)
            if self._rank != root:
                return None
            acc = rows[0]
            for x in rows[1:]:
                acc = _apply(op, acc, x)
            return acc
        if self._stageable(data, op, func="reduce"):
            _ran("coll_staged_device")
            y = self._device_allreduce(self._to_dev(data), op)
            return self._to_host(y) if self._rank == root else None
        # compressed hops: a large float sum is decoded, folded and
        # re-encoded at every tree level; the decision depends only on
        # (shape, dtype, nbytes, op), alike on every member
        use_wire = _cwire.eligible(data, op)
        vr = (self._rank - root) % n
        acc = data
        k = 1
        while k < n:
            if vr & k:
                self._csend(((vr - k) + root) % n, t,
                            _cwire.encode(acc) if use_wire else acc)
                return None
            if vr + k < n:
                acc = _apply(op, acc, _cwire.maybe_decode(
                    self._crecv(((vr + k) + root) % n, t)))
            k <<= 1
        return acc if self._rank == root else None

    def _small_allreduce(self, data: Any, op: op_mod.Op) -> Any:
        """Combined small-message allreduce: every rank sends its value to
        every peer once; reader threads park arrivals in a combining slot;
        the last arrival folds in rank order and wakes the caller once.
        One message latency replaces the reduce-then-bcast chain's
        2 log(n) serialized hops, and the rank-ordered fold keeps
        non-commutative ops and float results identical everywhere."""
        n, r, t = self.size, self._rank, self._tag()
        eng = self._coll_pml
        slot = eng.post_combine(t, n, n - 1, self._small_fold_for(op),
                                own=(r, data))
        try:
            eng.send_small(data, [(r + off) % n for off in range(1, n)], t)
            out = slot.wait()
        finally:
            eng.end_combine(t)
        if not isinstance(data, np.ndarray) and (
                isinstance(out, np.generic)
                or (isinstance(out, np.ndarray) and out.ndim == 0)):
            out = out.item()             # scalar in, Python scalar out
        return out

    def _small_fold_for(self, op: op_mod.Op) -> Callable:
        """The memoized rank-order fold of ``op``."""
        fold = self._small_fold.get(op.uid)
        if fold is None:
            def fold(vals):
                acc = vals[0]
                for v in vals[1:]:
                    acc = _apply(op, acc, v)
                return acc
            self._small_fold[op.uid] = fold
        return fold

    def bind_small_allreduce(self, data: Any, op: op_mod.Op) -> Callable:
        """Pre-bound persistent small allreduce (``coll/persistent``): the
        fold, the destinations and the engine's multicast template
        resolve once here. The launcher draws the sequence tag (on the
        comm's collective context, so its order never races deferred
        i-collectives), posts the combining slot and multicasts this
        rank's contribution; completion rides the slot through the
        returned request. N outstanding starts therefore pipeline: every
        contribution is on the wire before the first wait. ``data`` (the
        registered buffer) is read at every Start."""
        n, r = self.size, self._rank
        fold = self._small_fold_for(op)
        eng = self._coll_pml
        send = eng.bind_small_multicast(
            data, [(r + off) % n for off in range(1, n)])
        scalar_in = not isinstance(data, np.ndarray)

        def epilogue(out):
            if scalar_in and (isinstance(out, np.generic)
                              or (isinstance(out, np.ndarray)
                                  and out.ndim == 0)):
                out = out.item()
            return out

        def post():
            _ran("coll_small_combine")
            t = self._tag()
            slot = eng.post_combine(t, n, n - 1, fold, own=(r, data))
            send(data, t)
            return t, slot

        def launch() -> Request:
            t, slot = self._coll_serial(post)
            return _SlotRequest(eng, t, slot, epilogue)
        return launch

    def _small_allreduce_ok(self, data: Any) -> bool:
        from ompi_tpu_torch.coll.tuned import small_allreduce_limits
        max_bytes, max_ranks = small_allreduce_limits()
        if not (1 < self.size <= max_ranks):
            return False
        if isinstance(data, np.ndarray):
            return data.nbytes <= max_bytes
        return isinstance(data, (int, float, complex, np.generic))

    @_serialized
    def allreduce(self, data: Any, op: op_mod.Op = op_mod.SUM) -> Any:
        """The reference's dispatch, in its order
        (``ompi_tpu/core/rankcomm.py:672-697``): the device tier, the
        staged device tier, the combined small allreduce, the direct
        compressed exchange (small worlds), the in-segment fold, the
        pipelined ring, then reduce and bcast (compressed or plain)."""
        self._check()
        self._validate_op(op)
        if _inject.active:               # named kill site of the FT
            _inject.point("coll.allreduce")   # drill (ft/inject)
        spc.record("coll_allreduce", 1)
        if _hooks_mod._hooks:            # a tool is bound: fire the event
            _hooks_mod.fire("coll_allreduce", self,
                            {"value": int(getattr(data, "nbytes", 0) or 0)})
        if self._is_dev(data):
            return self._device_allreduce(data, op)
        if self._stageable(data, op):
            _ran("coll_staged_device")
            return self._to_host(self._device_allreduce(
                self._to_dev(data), op))
        if self._small_allreduce_ok(data):
            _ran("coll_small_combine")
            return self._small_allreduce(data, op)
        if _cwire.eligible(data, op) \
                and 1 < self.size <= _WIRE_DIRECT_MAX_RANKS:
            return self._wire_allreduce_direct(data, op)
        if self._shm_fold_ok(data, op):
            return self._shm_fold_allreduce(data, op)
        if self._pipeline_ring_ok(data, op):
            return self._pipelined_ring_allreduce(data, op)
        red = self.reduce(data, op, 0)
        if _cwire.eligible(data, op):
            # every rank must return the same value: the root broadcasts
            # the wire form and every member, the root too, decodes the
            # same image
            w = _cwire.encode(red) if self._rank == 0 else None
            return _cwire.maybe_decode(self.bcast(w, 0))
        return self.bcast(red, 0)

    def _wire_allreduce_direct(self, data: np.ndarray,
                               op: op_mod.Op) -> np.ndarray:
        """Direct compressed allreduce (small worlds): every rank
        quantizes its contribution once and sends the codes to every
        peer; every rank decodes all n images and folds them in rank
        order. One parallel round, one quantization error per
        contribution, and the same bits on every rank."""
        n, r, t = self.size, self._rank, self._tag()
        _ran("coll_compress_direct")
        w = _cwire.encode(data)
        for off in range(1, n):
            self._csend((r + off) % n, t, w)
        parts: Dict[int, Any] = {r: w}
        for _ in range(n - 1):
            d, st = self._coll_pml.recv(ANY_SOURCE, t)
            parts[st.source] = d
        out = None
        for i in range(n):
            img = _cwire.maybe_decode(parts[i])
            out = img if out is None else _apply(op, out, img)
        return out

    # -- in-segment shared-memory fold (btl/shmseg) ---------------------
    def _shm_fold_ok(self, data: Any, op: op_mod.Op) -> bool:
        """Rank-symmetric gate of the in-segment fold: every member on
        this host (the fold is the shared mapping), a payload that fits
        one workspace, an op with a numpy kernel, and the shm decision
        row selecting it. Commutativity is not needed: each slice is
        folded once, in rank order, by one rank."""
        if self.size < 2 or not isinstance(data, np.ndarray):
            return False
        if data.dtype.kind not in "fiu" or data.ndim == 0:
            return False
        if op.is_loc or not op.predefined \
                or op_mod.NP_COMBINERS.get(op.name) is None:
            return False
        ep = self.router.endpoint
        plane = getattr(ep, "shm_seg", None)
        if plane is None or int(data.nbytes) > plane.slot_bytes:
            return False
        from ompi_tpu_torch.coll import decision
        rules = decision.shm_rules().get("allreduce")
        if not rules or decision._match(rules, self.size,
                                        int(data.nbytes)) != "shm_fold":
            return False
        return all(ep._is_same_host(self.world_rank_of(i))
                   for i in range(self.size) if i != self._rank)

    def _shm_fold_allreduce(self, data: np.ndarray,
                            op: op_mod.Op) -> np.ndarray:
        """Node-local allreduce in the fold workspaces: every rank writes
        its contribution into its own per-comm shared segment once; after
        a fence it folds its slice of the elements across all members'
        segments in rank order and writes the folded slice back into
        every segment (disjoint slices: no writer races another); after
        the second fence it reads the whole result out of its own
        segment. About 4 byte-touches per rank against the ring's 2·P,
        and the same bits on every rank. No third fence: a rank's next
        write into its own segment comes after its own read-out, and
        peers touch that segment again only after the next collective's
        first fence."""
        from ompi_tpu_torch.btl import shmseg as _shmseg
        n, r = self.size, self._rank
        _ran("coll_shm_fold")
        plane = self.router.endpoint.shm_seg
        token = _shmseg.coll_token(self.cid)
        arr = np.ascontiguousarray(data)
        shape, dtype = arr.shape, arr.dtype
        flat = arr.reshape(-1)
        nbytes = int(arr.nbytes)
        ws = plane.coll_segment(token)
        ws.buf[0:nbytes] = memoryview(flat).cast("B")
        self._dissemination(self._tag())     # contributions visible
        views = [np.frombuffer(
            plane.coll_attach(token, self.world_rank_of(i)).buf,
            dtype=dtype, count=flat.size) for i in range(n)]
        b = chunk_bounds(flat.size, n)
        lo, hi = b[r], b[r + 1]
        npfn = op_mod.NP_COMBINERS[op.name]
        if hi > lo:
            acc = views[0][lo:hi].copy()
            for k in range(1, n):
                acc = npfn(acc, views[k][lo:hi])
            for v in views:
                v[lo:hi] = acc
        self._dissemination(self._tag())     # folded slices visible
        out = views[r].copy()
        _shmseg.count("folds")
        from ompi_tpu_torch import telemetry as _telemetry_mod
        if _telemetry_mod.active:
            _telemetry_mod.SHMSEG.record(nbytes)
        return out.reshape(shape)

    # -- segment-pipelined host tier (pml/pipeline) ---------------------
    def _pipeline_ring_ok(self, data: Any, op: op_mod.Op) -> bool:
        """Rank-symmetric gate of the pipelined ring: the pipeline rows
        select by size and bytes, and the fold must be a commutative
        predefined op with a numpy kernel (the ring reassociates chunk
        folds, as the other reordering schedules do)."""
        if self.size < 2 or not isinstance(data, np.ndarray):
            return False
        if data.dtype.kind not in "fiu" or data.ndim == 0:
            return False
        if not op.commute or op.is_loc or not op.predefined \
                or op_mod.NP_COMBINERS.get(op.name) is None:
            return False
        from ompi_tpu_torch.coll import decision
        rules = decision.pipeline_rules().get("allreduce")
        return bool(rules) and decision._match(
            rules, self.size, int(data.nbytes)) == "pipelined_ring"

    def _pipelined_ring_allreduce(self, data: np.ndarray,
                                  op: op_mod.Op) -> np.ndarray:
        """Segment-pipelined ring allreduce (coll_base_allreduce.c ring:
        a reduce-scatter ring, then an allgather ring). Each rank computes
        one chunk's whole fold and circulates it, so every rank holds the
        same bits; each chunk hop is a large pt2pt send that rides the
        pipelined rendezvous over the rails, and all ranks send and
        receive at once. Wire bytes per rank: 2(n-1)/n payloads."""
        n, r, t = self.size, self._rank, self._tag()
        _ran("coll_pipelined_ring")
        arr = np.ascontiguousarray(data)
        shape, flat = arr.shape, arr.reshape(-1)
        b = chunk_bounds(flat.size, n)
        # views: sends pack straight from the source; the fold below
        # replaces each entry with a fresh array, never writing the input
        chunks = [flat[b[i]:b[i + 1]] for i in range(n)]
        right, left = (r + 1) % n, (r - 1) % n
        npfn = op_mod.NP_COMBINERS[op.name]
        # reduce-scatter: at step s send chunk r-s, fold chunk r-s-1 in;
        # after n-1 steps this rank holds the whole fold of chunk r+1
        for s in range(n - 1):
            si, ri = (r - s) % n, (r - s - 1) % n
            req = self._coll_pml.irecv(left, t)
            self._csend(right, t, chunks[si])
            inc = req.get()
            chunks[ri] = npfn(chunks[ri],
                              np.asarray(inc).reshape(chunks[ri].shape))
        own = (r + 1) % n
        cur = chunks[own]
        for s in range(n - 1):           # allgather the folded chunks
            req = self._coll_pml.irecv(left, t)
            self._csend(right, t, cur)
            cur = np.asarray(req.get())
            idx = (own - 1 - s) % n
            chunks[idx] = cur.reshape(chunks[idx].shape)
        out = np.concatenate([np.asarray(c).reshape(-1) for c in chunks])
        return out.reshape(shape).astype(arr.dtype, copy=False)

    def _pipeline_bcast_ok(self, data: Any) -> bool:
        """Root-side gate of the chain bcast; the decision reaches the
        other ranks in the metadata round."""
        if self.size < 2 or not isinstance(data, np.ndarray):
            return False
        if data.dtype.kind not in "fiub" or data.ndim == 0:
            return False
        from ompi_tpu_torch.coll import decision
        rules = decision.pipeline_rules().get("bcast")
        return bool(rules) and decision._match(
            rules, self.size, int(data.nbytes)) == "pipelined_chain"

    def _pipelined_chain_bcast(self, data: Any, root: int) -> Any:
        """Segment-pipelined chain bcast (coll_base_bcast.c chain): the
        ranks form a chain from the root and the payload moves as a train
        of chunks; every inner rank forwards chunk c while its
        predecessor sends chunk c+1, so once the chain fills every link
        streams at once. Chunks large enough pipeline inside each hop
        too."""
        n, t = self.size, self._tag()
        vr = (self._rank - root) % n
        succ = ((vr + 1) + root) % n if vr + 1 < n else None
        pred = ((vr - 1) + root) % n
        _ran("coll_pipelined_chain")
        if vr == 0:
            arr = np.ascontiguousarray(data)
            flat = arr.reshape(-1)
            from ompi_tpu_torch.pml import pipeline as _pl
            seg = _pl.segment_bytes_for(int(arr.nbytes),
                                        self.router.endpoint)
            # a chunk is a few segments: big enough to pipeline inside
            # the hop, small enough that the chain fills quickly
            per = max(1, (seg * 4) // max(arr.dtype.itemsize, 1))
            k = max(1, -(-flat.size // per))
            self._csend(succ, t, (k, tuple(arr.shape), arr.dtype.str))
            for c in range(k):
                self._csend(succ, t, flat[c * per:(c + 1) * per])
            return data
        k, shape, dtstr = self._crecv(pred, t)
        if succ is not None:
            self._csend(succ, t, (k, shape, dtstr))
        parts: List[Any] = []
        for c in range(k):
            part = self._crecv(pred, t)
            if succ is not None:
                self._csend(succ, t, part)   # forward c while pred
            parts.append(part)               # streams c+1 behind it
        flat = np.concatenate([np.asarray(p).reshape(-1) for p in parts])
        return flat.reshape(shape).astype(np.dtype(dtstr), copy=False)

    def _gather(self, data: Any, root: int) -> Optional[List[Any]]:
        n, t = self.size, self._tag()
        if self._rank != root:
            self._csend(root, t, data)
            return None
        out: List[Any] = [None] * n
        out[root] = data
        for s in range(n):
            if s != root:
                out[s] = self._crecv(s, t)
        return out

    @_serialized
    def gather(self, data: Any, root: int = 0) -> Optional[List[Any]]:
        """Linear gather (coll/basic): the rank-ordered list at root,
        None elsewhere."""
        self._check()
        self._validate_root(root)
        spc.record("coll_gather", 1)
        return self._gather(data, root)

    @_serialized
    def scatter(self, chunks: Optional[Sequence[Any]] = None,
                root: int = 0) -> Any:
        """Linear scatter: root passes one chunk per rank."""
        self._check()
        self._validate_root(root)
        spc.record("coll_scatter", 1)
        n, t = self.size, self._tag()
        if self._rank == root:
            if chunks is None or len(chunks) != n:
                self._err(ERR_COUNT, "root must pass one chunk per rank")
            for d in range(n):
                if d != root:
                    self._csend(d, t, chunks[d])
            return chunks[root]
        return self._crecv(root, t)

    def _host_allgather(self, data: Any) -> List[Any]:
        """Ring allgather (coll_base_allgather ring): n-1 rounds, each
        forwarding the value received the round before."""
        n, r, t = self.size, self._rank, self._tag()
        out: List[Any] = [None] * n
        out[r] = cur = data
        right, left = (r + 1) % n, (r - 1) % n
        for s in range(n - 1):
            req = self._coll_pml.irecv(left, t)
            self._csend(right, t, cur)
            cur = req.get()
            out[(r - 1 - s) % n] = cur
        return out

    @_serialized
    def allgather(self, data: Any, *, uniform: bool = False) -> List[Any]:
        """Ring allgather. ``uniform=True`` asserts every caller passes one
        (shape, dtype) — the C ``MPI_Allgather`` guarantee — which lets a
        large host buffer be staged (the decision must be rank-symmetric,
        and the generic path legally carries ragged objects)."""
        self._check()
        spc.record("coll_allgather", 1)
        if self._is_dev(data):
            return self._device_allgather(data)
        if uniform and self._stageable(data, func="allgather"):
            _ran("coll_staged_device")
            return [self._to_host(g) for g in
                    self._device_allgather(self._to_dev(data))]
        return self._host_allgather(data)

    @_serialized
    def alltoall(self, chunks: Sequence[Any], *,
                 uniform: bool = False) -> List[Any]:
        """Pairwise-exchange alltoall (coll_base_alltoall pairwise).
        ``uniform=True`` asserts every caller passes chunks of one (shape,
        dtype), as for ``allgather``."""
        self._check()
        spc.record("coll_alltoall", 1)
        n, r = self.size, self._rank
        if len(chunks) != n:
            self._err(ERR_COUNT, "alltoall needs one chunk per peer")
        if n > 1 and all(self._is_dev(c) for c in chunks):
            return self._device_alltoall(chunks)
        if (uniform and n > 1
                and all(isinstance(c, np.ndarray) for c in chunks)
                and len({(c.shape, c.dtype.str) for c in chunks}) == 1
                and self._stageable(chunks[0], nbytes=chunks[0].nbytes * n,
                                    func="alltoall")):
            _ran("coll_staged_device")
            return [self._to_host(g) for g in self._device_alltoall(
                [self._to_dev(c) for c in chunks])]
        t = self._tag()
        out: List[Any] = [None] * n
        out[r] = chunks[r]
        for s in range(1, n):
            dest, src = (r + s) % n, (r - s) % n
            req = self._coll_pml.irecv(src, t)
            self._csend(dest, t, chunks[dest])
            out[src] = req.get()
        return out

    @_serialized
    def scan(self, data: Any, op: op_mod.Op = op_mod.SUM) -> Any:
        """Linear scan: inclusive prefix over ranks 0..r."""
        self._check()
        self._validate_op(op)
        spc.record("coll_scan", 1)
        n, r, t = self.size, self._rank, self._tag()
        acc = data
        if r > 0:
            acc = _apply(op, self._crecv(r - 1, t), data)
        if r + 1 < n:
            self._csend(r + 1, t, acc)
        return acc

    @_serialized
    def exscan(self, data: Any, op: op_mod.Op = op_mod.SUM) -> Any:
        """Exclusive prefix: rank 0 gets None."""
        self._check()
        self._validate_op(op)
        spc.record("coll_exscan", 1)
        n, r, t = self.size, self._rank, self._tag()
        prev = None if r == 0 else self._crecv(r - 1, t)
        if r + 1 < n:
            self._csend(r + 1, t, data if prev is None
                        else _apply(op, prev, data))
        return prev

    def reduce_scatter_block(self, chunks: Sequence[Any],
                             op: op_mod.Op = op_mod.SUM) -> Any:
        """chunks[j] is this rank's contribution for rank j; returns the
        fold of everyone's chunk for me (alltoall, then the host fold)."""
        self._check()
        self._validate_op(op)
        spc.record("coll_reduce_scatter_block", 1)
        if len(chunks) != self.size:
            self._err(ERR_COUNT, "need one chunk per rank")
        mine = self.alltoall(list(chunks))
        acc = mine[0]
        for x in mine[1:]:
            acc = _apply(op, acc, x)
        return acc

    # -- nonblocking collectives (a serial worker thread per comm) -----
    def _coll_worker_loop(self, q: "queue.Queue") -> None:
        # ONE worker per comm runs every deferred collective and any
        # funneled blocking body. It never fires the interposition
        # layers: blocking entries fire them on the caller thread before
        # funneling, and i-slots are interposition-exempt. A fresh
        # thread-local depth here would let sync's op counter race across
        # threads and desynchronize injected barriers between ranks, and
        # let an inner frame record a span whose sequence number differs
        # across ranks.
        from ompi_tpu_torch.coll.interpose_perrank import _tls as _itls
        _itls.sync_depth = 1
        _itls.mon_depth = 1
        _itls.trace_depth = 1
        _itls.tele_depth = 1
        while True:
            item = q.get()
            if item is None:
                q.task_done()
                return
            try:
                item()
            except BaseException:        # noqa: BLE001
                # runners report their own errors; anything escaping here
                # must not kill the worker and wedge the comm
                traceback.print_exc()
            finally:
                q.task_done()            # unfinished_tasks: busy signal

    def _coll_submit(self, runner: Callable) -> None:
        with self._lock:
            if self._cclosed:
                raise MPIError(ERR_COMM, "communicator has been freed")
            q = self._cq
            if q is None:
                q = self._cq = queue.Queue()
                self._cworker = threading.Thread(
                    target=self._coll_worker_loop, args=(q,), daemon=True,
                    name=f"coll-worker-{self.name}")
                self._cworker.start()
            q.put(runner)                # under the lock: a drain's
            #                              sentinel cannot overtake it

    def _coll_serial(self, fn: Callable, *a, **kw):
        """Run a collective body on the comm's single collective context
        (see _serialized). Reentrant: a body on the worker runs
        directly."""
        w = self._cworker
        if w is not None and threading.current_thread() is w:
            return fn(*a, **kw)
        box: Dict[str, Any] = {}
        ev: Optional[threading.Event] = None
        with self._lock:
            q = self._cq
            if q is not None and q.unfinished_tasks > 0:
                ev = threading.Event()

                def runner():
                    try:
                        box["res"] = fn(*a, **kw)
                    except BaseException as e:  # noqa: BLE001
                        box["err"] = e
                    finally:
                        ev.set()
                q.put(runner)
        if ev is None:                   # worker idle: inline
            return fn(*a, **kw)
        ev.wait()
        if "err" in box:
            raise box["err"]
        return box["res"]

    def _coll_drain(self) -> None:
        """Retire the worker after its pending jobs (MPI-3.1 6.4.3)."""
        with self._lock:
            q, t = self._cq, self._cworker
            self._cq = self._cworker = None
            self._cclosed = True
            if q is not None:
                q.put(None)
        if t is not None:
            t.join()

    def _nb(self, fn: Callable, *args) -> Request:
        req = RankRequest(ANY_SOURCE, ANY_TAG)

        def run():
            try:
                req._deliver(_Msg(self._rank, 0, fn(*args)))
            except BaseException as e:   # noqa: BLE001 — raised at wait
                req._fail(e)
        self._coll_submit(run)
        return req

    def ibarrier(self) -> Request:
        return self._nb(RankCommunicator.barrier, self)

    def ibcast(self, data: Any = None, root: int = 0) -> Request:
        return self._nb(RankCommunicator.bcast, self, data, root)

    def iallreduce(self, data: Any, op: op_mod.Op = op_mod.SUM) -> Request:
        from ompi_tpu_torch.coll import persistent as _pcoll
        if _pcoll.bucket_enabled():
            # bucket fusion: concurrent small iallreduces on one (op,
            # dtype) ride one fused collective, flushed at program points
            # every rank reaches alike
            r = _pcoll.maybe_bucket_iallreduce(self, data, op)
            if r is not None:
                return r
        return self._nb(RankCommunicator.allreduce, self, data, op)

    def iallgather(self, data: Any) -> Request:
        return self._nb(RankCommunicator.allgather, self, data)

    def ireduce(self, data: Any, op: op_mod.Op = op_mod.SUM,
                root: int = 0) -> Request:
        return self._nb(RankCommunicator.reduce, self, data, op, root)

    # -- persistent collectives (MPI-4 *_init; coll/persistent) --------
    # The plan — route, fold, multicast template, staging, codec gate —
    # binds once at init; Start is launch-only and bucketable starts fuse
    # (Startall).
    def _init_plan(self, func: str, *args) -> Request:
        self._check()
        from ompi_tpu_torch.coll import persistent as _pcoll
        return _pcoll.coll_init(self, func, *args)

    def allreduce_init(self, data: Any, op: op_mod.Op = op_mod.SUM):
        return self._init_plan("allreduce", data, op)

    def bcast_init(self, data: Any = None, root: int = 0):
        return self._init_plan("bcast", data, root)

    def allgather_init(self, data: Any):
        return self._init_plan("allgather", data)

    def reduce_scatter_block_init(self, chunks, op: op_mod.Op = op_mod.SUM):
        return self._init_plan("reduce_scatter_block", chunks, op)

    def barrier_init(self):
        return self._init_plan("barrier")

    # ==================================================================
    # Collectives — device tier (the shared-buffer tier)
    # ==================================================================
    def _fence(self) -> None:
        """Every member's device writes so far are visible to every
        member: a stream synchronize, then a host barrier on the hidden
        channel."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self._dissemination(self._tag())

    def _shared(self, nbytes: int) -> Tuple[_SharedSlots, int]:
        _ran("coll_device")
        if self._slots is None:
            self._slots = _SharedSlots(self)
        self._slots.ensure(nbytes)
        return self._slots, self._slots.flip()

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        return x.detach().to(self.device).contiguous().reshape(-1)

    def _device_allreduce(self, x: torch.Tensor,
                          op: op_mod.Op) -> torch.Tensor:
        """Copy in, fence, reduce my chunk from every slot, fence, gather
        the reduced chunks. Sum, max, min and prod are one torch
        reduction over the members; other ops fold in rank order
        (``Op.reduce_tree``), as the reference's ``_device_allreduce``.
        A pair op reads (value, index) records along the last axis, so
        its chunks hold whole records and fold in that shape."""
        flat = self._local(x)
        n, r = self.size, self._rank
        nbytes = flat.numel() * flat.element_size()
        rec = x.shape[-1] if op.is_loc and x.dim() else 1
        slots, p = self._shared(nbytes)
        mine = slots.view(r, p, nbytes, flat.dtype)
        mine.copy_(flat)
        self._fence()
        b = chunk_bounds(flat.numel(), n, rec)
        if b[r + 1] > b[r]:
            parts = torch.stack([slots.view(j, p, nbytes, flat.dtype)
                                 [b[r]:b[r + 1]] for j in range(n)])
            red = op.reduce_tree(parts.view(n, -1, rec), 0)
            mine[b[r]:b[r + 1]].copy_(red.reshape(-1))
        self._fence()
        out = torch.cat([slots.view(j, p, nbytes, flat.dtype)[b[j]:b[j + 1]]
                         for j in range(n)])
        return out.view(x.shape)

    def _device_bcast(self, x: torch.Tensor, root: int) -> torch.Tensor:
        flat = self._local(x)
        nbytes = flat.numel() * flat.element_size()
        slots, p = self._shared(nbytes)
        if self._rank == root:
            slots.view(root, p, nbytes, flat.dtype).copy_(flat)
        self._fence()
        return slots.view(root, p, nbytes, flat.dtype).clone().view(x.shape)

    def _device_allgather(self, x: torch.Tensor) -> List[torch.Tensor]:
        flat = self._local(x)
        n = self.size
        nbytes = flat.numel() * flat.element_size()
        slots, p = self._shared(nbytes)
        slots.view(self._rank, p, nbytes, flat.dtype).copy_(flat)
        self._fence()
        g = torch.stack([slots.view(j, p, nbytes, flat.dtype)
                         for j in range(n)]).view((n,) + tuple(x.shape))
        return list(g.unbind(0))

    def _device_alltoall(self, chunks: Sequence[torch.Tensor]
                         ) -> List[torch.Tensor]:
        n, r = self.size, self._rank
        flat = torch.stack([c.detach().to(self.device) for c in chunks])
        shape = tuple(flat.shape[1:])
        flat = flat.reshape(-1)
        per = flat.numel() // n
        nbytes = flat.numel() * flat.element_size()
        slots, p = self._shared(nbytes)
        slots.view(r, p, nbytes, flat.dtype).copy_(flat)
        self._fence()
        g = torch.stack([slots.view(j, p, nbytes, flat.dtype)
                         [r * per:(r + 1) * per] for j in range(n)])
        return list(g.view((n,) + shape).unbind(0))

    # ==================================================================
    # Communicator algebra (collective; deterministic CIDs)
    # ==================================================================
    def _child(self, group: Group, cid, name: str,
               info: Optional[Info] = None) -> "RankCommunicator":
        return RankCommunicator(group, self._my_world, self.router,
                                self.device, cid=cid, name=name,
                                parent=self, errhandler=self.errhandler,
                                info=info)

    def split(self, color: int, key: int = 0
              ) -> Optional["RankCommunicator"]:
        """MPI_Comm_split (comm.c:749): each caller passes its color and
        key and receives its child (or None)."""
        self._check()
        seq = next(self._create_seq)
        rows = self.allgather((color, key))
        if color == UNDEFINED:
            return None
        members = sorted((r for r in range(self.size)
                          if rows[r][0] == color),
                         key=lambda r: (rows[r][1], r))
        return self._child(Group([self.group.world_ranks[r]
                                  for r in members]),
                           ("s", self.cid, seq, color),
                           f"{self.name}.split({color})")

    def split_type(self, split_type: int, key: int = 0):
        if split_type == UNDEFINED:
            return None
        if split_type == 2:                 # COMM_TYPE_HWTHREAD
            color = self._rank
        elif split_type in (1, 3):          # SHARED / NUMA: same host
            names = self.allgather(socket.gethostname())
            color = names.index(names[self._rank])
        else:
            self._err(ERR_ARG, f"unknown split_type {split_type}")
            return None
        return self.split(color, key)

    def dup(self, info: Optional[Info] = None) -> "RankCommunicator":
        self._check()
        seq = next(self._create_seq)
        self.barrier()                      # dup is collective
        c = self._child(Group(self.group.world_ranks),
                        ("d", self.cid, seq), f"{self.name}.dup",
                        info or self.info)
        from ompi_tpu_torch.core.communicator import propagate_attrs
        try:
            propagate_attrs(self, c)
        except BaseException:
            c.free()                     # no half-built comm leaks
            raise
        return c

    def create(self, group: Group) -> Optional["RankCommunicator"]:
        self._check()
        seq = next(self._create_seq)
        self.barrier()
        if group.rank_of(self._my_world) == UNDEFINED:
            return None
        return self._child(group, ("g", self.cid, seq,
                                   tuple(group.world_ranks)),
                           f"{self.name}.create")

    # -- process topologies --------------------------------------------
    def create_cart(self, dims: Sequence[int],
                    periods: Optional[Sequence[bool]] = None,
                    reorder: bool = False) -> Optional["RankCommunicator"]:
        """MPI_Cart_create: callers beyond the cart size get None."""
        import math
        from ompi_tpu_torch.topo import CartTopology
        dims = list(dims)
        n = math.prod(dims)
        if n > self.size:
            self._err(ERR_ARG, f"cart size {n} exceeds comm size")
        sub = self.split(0 if self._rank < n else UNDEFINED)
        if sub is None:
            return None
        sub.topo = CartTopology(dims, list(periods) if periods
                                else [False] * len(dims))
        sub.name = f"{self.name}.cart"
        return sub

    def create_graph(self, index: Sequence[int], edges: Sequence[int],
                     reorder: bool = False) -> Optional["RankCommunicator"]:
        """MPI_Graph_create: callers beyond the graph size get None.
        Placement is identity: process binding is fixed at launch."""
        from ompi_tpu_torch.topo import GraphTopology
        topo = GraphTopology(index, edges)
        if topo.size > self.size:
            self._err(ERR_ARG, "graph larger than communicator")
        sub = self.split(0 if self._rank < topo.size else UNDEFINED)
        if sub is None:
            return None
        sub.topo = topo
        sub.name = f"{self.name}.graph"
        return sub

    def create_dist_graph_adjacent(self, sources: Sequence[int],
                                   destinations: Sequence[int]
                                   ) -> "RankCommunicator":
        """MPI_Dist_graph_create_adjacent: this rank's in and out
        neighbors; the full table is assembled collectively."""
        from ompi_tpu_torch.topo import DistGraphTopology
        rows = self.allgather(([int(s) for s in sources],
                               [int(d) for d in destinations]))
        c = self.dup()
        c.topo = DistGraphTopology([r[0] for r in rows],
                                   [r[1] for r in rows])
        c.name = f"{self.name}.dist_graph"
        return c

    def _cart(self):
        from ompi_tpu_torch.topo import CartTopology
        if not isinstance(self.topo, CartTopology):
            self._err(ERR_TOPOLOGY, "communicator has no cartesian topology")
        return self.topo

    def cart_coords(self, rank: Optional[int] = None):
        return self._cart().coords(self._rank if rank is None else rank)

    def cart_rank(self, coords: Sequence[int]) -> int:
        return self._cart().rank(coords)

    def cart_shift(self, direction: int, disp: int = 1):
        """MPI_Cart_shift for this rank: (source, dest)."""
        return self._cart().shift(self._rank, direction, disp)

    def _neighbor_exchange(self, outgoing: Sequence[Any]) -> List[Any]:
        """Post every receive, then send every chunk, then wait (a
        per-slot wait would deadlock on periodic rings of size >= 3).
        Directed topologies receive from in-neighbors and send to
        out-neighbors; None marks a PROC_NULL slot."""
        nbrs = list(self.topo.neighbors(self._rank))
        outs = (list(self.topo.out_neighbors(self._rank))
                if hasattr(self.topo, "out_neighbors") else nbrs)
        if len(outgoing) != len(outs):
            self._err(ERR_COUNT, "need one chunk per neighbor slot")
        t = self._tag()
        reqs = [self._coll_pml.irecv(nb, t) if 0 <= nb < self.size
                else None for nb in nbrs]
        for nb, c in zip(outs, outgoing):
            if 0 <= nb < self.size:
                self._coll_pml.send(c, nb, t)
        return [None if q is None else q.get() for q in reqs]

    def _need_topo(self) -> None:
        self._check()
        if self.topo is None:
            self._err(ERR_TOPOLOGY, "no topology attached")

    @_serialized
    def neighbor_allgather(self, data: Any) -> List[Any]:
        """MPI_Neighbor_allgather: ``data`` to every out-neighbor; one
        received buffer per neighbor slot, in neighbor order."""
        self._need_topo()
        outs = (self.topo.out_neighbors(self._rank)
                if hasattr(self.topo, "out_neighbors")
                else self.topo.neighbors(self._rank))
        return self._neighbor_exchange([data] * len(outs))

    @_serialized
    def neighbor_alltoall(self, chunks: Sequence[Any]) -> List[Any]:
        """MPI_Neighbor_alltoall: chunk j goes to my j-th neighbor."""
        self._need_topo()
        return self._neighbor_exchange(list(chunks))

    # -- ULFM over real process death (mpiext/ftmpi semantics) ---------
    # The failure registry is fed by the btl's EOF monitor, the heartbeat
    # detector and peers' obituaries; these methods are the MPIX_Comm_*
    # recovery surface of the per-rank world.
    def get_failed(self) -> List[int]:
        """MPIX_Comm_get_failed: comm-local ranks known dead."""
        return [r for r in range(self.size)
                if ft.is_failed(self.group.world_ranks[r])]

    def revoke(self) -> None:
        """MPIX_Comm_revoke: non-collective — one caller poisons the
        communicator everywhere. The router floods a ``revoke`` ctl frame
        (every first receipt re-forwards, the revoked-set test ends it —
        coll_base_revoke_local.c); locally and on every receiver the
        pending operations complete with ERR_REVOKED and new ones refuse
        in ``_check``. The recovery surface (shrink, agree, get_failed,
        free) keeps working."""
        self.router.revoke(self.cid)

    def is_revoked(self) -> bool:
        """MPIX_Comm_is_revoked (local, non-collective)."""
        return self.router.is_revoked(self.cid)

    def _on_revoked(self) -> None:
        """Router revoke callback: flush every pending operation —
        wildcards included (unlike a single peer death, a revoked comm
        can never match anything again, req_ft.c's revocation
        branch)."""
        def err():
            return MPIError(ERR_REVOKED, f"{self.name} has been revoked")
        for eng in (self._pml, self._coll_pml,
                    *list(self._aux_pmls.values())):
            try:
                eng._flush_all(err)
            except Exception:            # noqa: BLE001
                pass

    def agree(self, flag: int = 1, timeout: float = 20) -> int:
        """MPIX_Comm_agree: fault-tolerant agreement — AND-folds the
        integer ``flag`` over the surviving members and returns the
        agreed value on all of them, completing even with failed (or
        failing) participants. Runs on a revoked comm. The
        early-returning protocol lives in coll/ftagree."""
        from ompi_tpu_torch.coll import ftagree
        value, _failed = ftagree.perrank_agree(self, int(flag),
                                               timeout=timeout)
        return value

    def shrink(self, timeout: float = 20) -> "RankCommunicator":
        """MPIX_Comm_shrink: survivors agree on the failed set through
        coll/ftagree's early-returning agreement (a silent rank is itself
        suspected into the set) and build the survivor communicator
        through the normal construction. Collective among survivors;
        works on a revoked comm. Retried when a survivor's stale failure
        view elected a dead leader (detection is asynchronous; the failed
        exchange itself surfaces the death, and the retry settles)."""
        last: Optional[BaseException] = None
        for _ in range(3):
            try:
                return self._shrink_once(timeout)
            except (MPIError, OSError) as e:
                # OSError: a send raced the detector onto a just-dead
                # leader's broken socket
                last = e
                import time
                time.sleep(0.2)          # let the detector settle
        raise last

    def _shrink_once(self, timeout: float) -> "RankCommunicator":
        # no draw from _create_seq: ranks may take different numbers of
        # retries, and divergent draws would desync every later cid. The
        # child cid derives from the agreed failed set instead (the same
        # on every survivor, distinct per failure epoch).
        from ompi_tpu_torch.coll import ftagree
        _value, final = ftagree.perrank_agree(self, 1, timeout=timeout)
        survivors = [r for r in range(self.size) if r not in final]
        g = Group([self.group.world_ranks[r] for r in survivors])
        if self._slots is not None:
            # the dead members' slots are never read again: close the
            # mappings now, without a fence
            self._slots.drop_failed()
        child = self._child(g, ("shrink", self.cid, tuple(final)),
                            f"{self.name}.shrink")
        # the parent stays alive after a shrink, but its per-comm
        # instruments describe the dead-rank era — retire them so later
        # reads (trace_skew_c<cid>, tele_coll_*) can't report keys from
        # before the failure epoch
        from ompi_tpu_torch import telemetry as _telemetry
        _telemetry.retire_comm(self.cid)
        return child

    def free(self) -> None:
        # delete callbacks first: a failing one aborts the free with the
        # comm intact (MPI-3.1 6.7.2)
        from ompi_tpu_torch.core.communicator import fire_delete_attrs
        fire_delete_attrs(self)
        self.router.unregister_revoke_cb(self.cid)
        self._coll_drain()               # pending deferred collectives
        if self._slots is not None:
            if self.get_failed():
                # a dead member never reaches a fence: close the
                # mappings (the dead one's first, untouched) without one
                self._slots.drop_failed()
            else:
                # collective, like the device tier that allocated them:
                # no peer may still be reading this rank's slot
                self._fence()
            self._slots.close()
            self._slots = None
        self._pml.close()
        self._coll_pml.close()
        for eng in self._aux_pmls.values():
            eng.close()
        self._aux_pmls.clear()
        self._freed = True
        # pvar session semantics: per-comm instruments (telemetry
        # histograms, trace_skew_c<cid>) retire with the comm
        from ompi_tpu_torch import telemetry as _telemetry
        _telemetry.retire_comm(self.cid)

    # -- attributes / naming -------------------------------------------
    def set_attr(self, keyval: int, value: Any) -> None:
        self.attributes[keyval] = value

    def get_attr(self, keyval: int) -> Tuple[bool, Any]:
        if keyval in self.attributes:
            return True, self.attributes[keyval]
        return False, None

    def delete_attr(self, keyval: int) -> None:
        from ompi_tpu_torch.core.communicator import _keyvals
        val = self.attributes.pop(keyval, None)
        cb = _keyvals.get(keyval)
        if cb and cb[1] and val is not None:
            cb[1](self, keyval, val)

    def set_errhandler(self, errh: Errhandler) -> None:
        self.errhandler = errh

    def get_errhandler(self) -> Errhandler:
        return self.errhandler

    def set_name(self, name: str) -> None:
        self.name = name

    def get_name(self) -> str:
        return self.name

    def abort(self, errorcode: int = 1):
        import os
        import sys
        sys.stderr.write(f"MPI_Abort on {self.name} errorcode={errorcode}\n")
        sys.stderr.flush()
        os._exit(errorcode)

    def __repr__(self):
        return (f"RankCommunicator({self.name}, rank={self._rank}/"
                f"{self.size}, cid={self.cid!r}, device={self.device})")


def _apply(op: op_mod.Op, a: Any, b: Any) -> Any:
    """A reduction combiner on the host tier. Tensors fold with the op's
    torch combiner (a numpy operand moves to the tensor's device); numpy
    arrays with the C++ kernel table (``native/ops.cpp``) or the
    dtype-preserving numpy kernel of a predefined op, or the user's
    combiner over numpy; scalars come back as Python scalars."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        dev = (a if isinstance(a, torch.Tensor) else b).device
        return op(torch.as_tensor(a, device=dev),
                  torch.as_tensor(b, device=dev))
    an, bn = np.asarray(a), np.asarray(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        if op.predefined:
            from ompi_tpu_torch.native import native_reduce_local
            out = native_reduce_local(op.name, an, bn)
            if out is not None:
                return out
        return np.asarray(op_mod.np_combiner(op)(an, bn))
    r = np.asarray(op_mod.np_combiner(op)(an, bn))
    return r.item() if r.ndim == 0 else r
