"""Communicators — rank groups bound to devices, single-controller.

Behavioral spec: ``ompi/communicator`` — ``ompi_communicator_t`` holds a
group, a CID, and the ``c_coll`` vtable of selected collective modules;
``ompi_comm_split`` (``comm.c:749``), dup; CID allocation is a
distributed agreement (``comm_cid.c:61-109``).

Single-controller model, as in the JAX package: one process drives every
rank, and a rank's local buffer is one row of a stacked tensor of shape
``(N, *local)``. The stacked tensor lives on the communicator's device
(its first device): ``init(devices=[cuda:0] * 8)`` puts 8 ranks on one
card, ``devices=["cpu"] * 8`` puts them on the CPU. Spreading rows over
several cards waits for the per-rank (``torch.distributed``) tier.
``MPI_Comm_split`` is a row subset: a child communicator's members are
parent ranks, and its stacked buffers have one row per member. CID
agreement collapses to a controller-side counter.

ULFM (``mpiext/ftmpi``) runs over the communicator's failure registry
(``runtime/ft``): collectives and pt2pt that involve a failed rank raise
``ERR_PROC_FAILED``, ``revoke`` poisons the comm, ``agree`` is
``coll/ftagree``'s tree, and ``shrink`` builds the survivors' comm whose
rows are the survivors' rows of the stacked tensor, on the same device.

Point-to-point runs through the stacked matching engine
(``pml/stacked``), with the sending and receiving ranks explicit;
process topologies (``topo/``) attach to a communicator and their
neighbor collectives gather over the stacked tensor on the device.
Derived datatypes ride the blocking collectives through the convertor
(``_wire``), or, for a device allreduce, through the fused
``allreduce_dtype`` of the selected module.

Collectives here are the framework-level entry points: argument/locus
validation and errhandler invocation, then dispatch through the
per-communicator ``c_coll`` vtable populated by priority selection
(``coll_base_comm_select.c:234-273``). The nonblocking ``i*`` entries
return ``core/request`` Requests (schedules of ``coll/nbc`` where it won
the slot); the ``*_init`` entries build ``coll/persistent`` plans.
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ompi_tpu_torch.accelerator import (LOCUS_DEVICE, check_addr,
                                        device_locality, to_numpy)
from ompi_tpu_torch.core import convertor
from ompi_tpu_torch.core import op as op_mod
from ompi_tpu_torch.core.datatype import Datatype, torch_dtype
from ompi_tpu_torch.core.errhandler import (ERR_ARG, ERR_COMM, ERR_COUNT,
                                            ERR_OP, ERR_RANK, ERR_ROOT,
                                            ERR_TOPOLOGY, ERRORS_ARE_FATAL,
                                            Errhandler, MPIError)
from ompi_tpu_torch.core.group import Group, UNDEFINED
from ompi_tpu_torch.core.info import Info
from ompi_tpu_torch.core.request import Request, Status, event_after
from ompi_tpu_torch.runtime import ft, spc
from ompi_tpu_torch.utils import hooks


# Sentinel mirroring MPI_IN_PLACE: "sendbuf is recvbuf".
class _InPlaceType:
    def __repr__(self):
        return "MPI_IN_PLACE"


IN_PLACE = _InPlaceType()

_cid_lock = threading.Lock()
_cid_counter = itertools.count(0)


def _next_cid() -> int:
    """CID agreement (comm_cid.c:61-109). Single-controller: allocation
    order is globally observed by construction, so the iterative
    allreduce over available CIDs reduces to a monotone counter."""
    with _cid_lock:
        return next(_cid_counter)


class Communicator:
    def __init__(self, group: Group, devices: Sequence[Any], *,
                 name: str = "", parent: Optional["Communicator"] = None,
                 info: Optional[Info] = None,
                 errhandler: Optional[Errhandler] = None):
        if len(devices) != group.size:
            raise MPIError(ERR_ARG, "devices must match group size")
        self.group = group
        self.devices = tuple(torch.device(d) for d in devices)
        # where this communicator's stacked buffers live
        self.device = self.devices[0]
        self.cid = self._alloc_cid()
        self.name = name or f"comm#{self.cid}"
        self.info = info.dup() if info else Info()
        self.errhandler = errhandler or (
            parent.errhandler if parent is not None else ERRORS_ARE_FATAL)
        self.attributes: Dict[int, Any] = {}
        self.topo = None               # set by the topology entries
        self._freed = False
        self._revoked = False          # ULFM
        self._acked_failures: frozenset = frozenset()  # ULFM failure_ack
        # failure-knowledge domain: the process-wide default registry,
        # or (MPI-4 Sessions) the owning session's private one —
        # inherited through parent so sub-communicators share it
        self._ft = parent._ft if parent is not None else (
            ft.default_registry())
        # sub-eager dispatch cache: per-(shape, dtype, op) resolution of
        # the hottest allreduce call shape straight to the selected
        # module's entry point — validation is a pure function of the key
        # and runs once
        self._subeager: Dict[tuple, Any] = {}
        from ompi_tpu_torch.coll.framework import comm_select_coll
        self.c_coll: Dict[str, Any] = comm_select_coll(self)

    def _alloc_cid(self) -> int:
        """CID allocation hook: the process-wide space by default; MPI-4
        Sessions override it to draw from the instance's own space
        (comm_cid.c allocates within the instance namespace)."""
        return _next_cid()

    # ------------------------------------------------------------------
    @property
    def size(self) -> int:
        return self.group.size

    def rank(self) -> int:
        """Single-controller: the controller drives all ranks; per-rank
        identity lives in the stacked axis. Returns 0 for API parity."""
        return 0

    def _err(self, error_class: int, msg: str = ""):
        return self.errhandler.invoke(self, error_class, msg)

    def _check(self) -> None:
        if self._freed:
            raise MPIError(ERR_COMM, "communicator has been freed")
        if self._revoked:
            from ompi_tpu_torch.core.errhandler import ERR_REVOKED
            raise MPIError(ERR_REVOKED, "communicator has been revoked")

    # -- buffer helpers -------------------------------------------------
    def put(self, host_array) -> torch.Tensor:
        """Copy a host array (or a tensor) onto this communicator's device
        in the stacked wire layout. Always a copy: the result never
        aliases the caller's memory."""
        if isinstance(host_array, torch.Tensor):
            return host_array.to(self.device, copy=True)
        return torch.tensor(np.asarray(host_array), device=self.device)

    def alloc(self, local_shape: Tuple[int, ...], dtype=torch.float32,
              fill: Optional[float] = None) -> torch.Tensor:
        """Allocate a stacked buffer (size, *local_shape) on this
        communicator's device."""
        shape = (self.size,) + tuple(local_shape)
        dt = torch_dtype(dtype)
        if fill is None:
            return torch.zeros(shape, dtype=dt, device=self.device)
        return torch.full(shape, fill, dtype=dt, device=self.device)

    def stack(self, per_rank: Sequence[Any]) -> torch.Tensor:
        """Build a stacked buffer from per-rank host arrays or tensors."""
        if len(per_rank) != self.size:
            self._err(ERR_COUNT, "need one array per rank")
        if all(isinstance(a, torch.Tensor) for a in per_rank):
            return torch.stack([a.to(self.device) for a in per_rank])
        return self.put(np.stack([np.asarray(a) for a in per_rank]))

    def shard(self, stacked, rank: int) -> np.ndarray:
        """Rank ``rank``'s view of a stacked buffer (host copy)."""
        if isinstance(stacked, torch.Tensor):
            return to_numpy(stacked[rank])
        return np.array(stacked[rank])

    # -- validation + dispatch -----------------------------------------
    def _coll(self, func: str):
        self._check()
        self._check_ft_coll()
        m = self.c_coll.get(func)
        if m is None:
            self._err(ERR_ARG, f"no coll component provides {func} "
                               f"for {self.name}")
        spc.record(f"coll_{func}", 1)
        hooks.fire(f"coll_{func}", self, {})
        return m

    def _validate_op(self, op):
        if not isinstance(op, op_mod.Op) or op.fn is None:
            self._err(ERR_OP, "invalid reduction op")
        return op

    def _validate_root(self, root: int):
        if not (0 <= root < self.size):
            self._err(ERR_ROOT, f"root {root} out of range")
        return root

    def _validate_stacked(self, buf, lead: int = 1):
        if check_addr(buf) is None:
            self._err(ERR_ARG, "buffer must be a torch tensor or numpy array")
        if buf.ndim < lead or buf.shape[0] != self.size:
            self._err(ERR_COUNT,
                      f"stacked buffer must have leading axis {self.size}, "
                      f"got {tuple(getattr(buf, 'shape', ()))}")
        return buf

    def _wire(self, buf, datatype: Optional[Datatype], count: Optional[int]):
        """Pack a stacked buffer to wire (contiguous) form; return
        (packed, unpack_fn). ``unpack_fn(y, out)`` scatters a result into
        ``out`` in place — its holes, the elements outside the map, are
        left untouched — or into zeros when there is no ``out``."""
        if datatype is None or datatype.is_contiguous:
            return buf, None
        if count is None:
            count = buf.shape[-1] // max(datatype.extent, 1)
        packed = convertor.pack(buf, datatype, count)

        def unpack_fn(y, out=None):
            if out is None:
                shape = tuple(y.shape[:-1]) + (count * datatype.extent,)
                out = (torch.zeros(shape, dtype=y.dtype, device=y.device)
                       if isinstance(y, torch.Tensor)
                       else np.zeros(shape, dtype=y.dtype))
            return convertor.unpack(out, y, datatype, count)
        return packed, unpack_fn

    @staticmethod
    def _deliver(y, recvbuf):
        """A distinct tensor ``recvbuf`` receives the result in place (and
        is returned); otherwise the new tensor is the result."""
        if isinstance(recvbuf, torch.Tensor):
            recvbuf.copy_(torch.as_tensor(y))
            return recvbuf
        return y

    # ==================================================================
    # Collectives (blocking). Stacked-tensor API: input leading axis =
    # rank, result returned as a new tensor (a distinct ``recvbuf``
    # tensor, where a call takes one, receives it in place). IN_PLACE
    # passes recvbuf as the input.
    # ==================================================================
    def allreduce(self, sendbuf, op=op_mod.SUM, *,
                  datatype: Optional[Datatype] = None,
                  count: Optional[int] = None, recvbuf=None):
        in_place = sendbuf is IN_PLACE
        if in_place:
            sendbuf = recvbuf       # MPI_IN_PLACE (allreduce.c.in:54,78-79)
        # sub-eager fast path: contiguous device buffer, no recvbuf —
        # shape/dtype/op were validated when the key was filled (validity
        # is a pure function of the key), so a repeat call is one dict
        # probe. The freed-op and freed-comm checks stay per call.
        if (datatype is None and recvbuf is None
                and getattr(op, "fn", None) is not None
                and check_addr(sendbuf) == LOCUS_DEVICE):
            key = (sendbuf.shape, sendbuf.dtype, op.uid)
            fn = self._subeager.get(key)
            if fn is None:
                self._validate_stacked(sendbuf)
                self._validate_op(op)
                fn = self._subeager[key] = self._coll("allreduce").allreduce
                return fn(sendbuf, op)
            self._check()
            self._check_ft_coll()
            spc.record("coll_allreduce", 1)
            hooks.fire("coll_allreduce", self, {})
            return fn(sendbuf, op)
        self._validate_stacked(sendbuf)
        self._validate_op(op)
        # Fused derived-datatype path (the reference's conditions,
        # core/communicator.py:314-329): a device buffer, a real non-pair
        # op, no distinct recvbuf (whose holes cannot come from sendbuf),
        # and an exact-fit last dim — the fused chain returns sendbuf's
        # own shape, where the convertor path gives the truncated image.
        if (datatype is not None and not datatype.is_contiguous
                and not datatype.pair and not op.is_loc
                and (recvbuf is None or in_place)
                and check_addr(sendbuf) == LOCUS_DEVICE):
            fd = getattr(self._coll("allreduce"), "allreduce_dtype", None)
            cnt = (count if count is not None else
                   sendbuf.shape[-1] // max(datatype.extent, 1))
            if fd is not None and sendbuf.shape[-1] == cnt * datatype.extent:
                return fd(sendbuf, op, datatype, cnt, in_place)
        x, unpack_fn = self._wire(sendbuf, datatype, count)
        y = self._coll("allreduce").allreduce(x, op)
        if unpack_fn is None:
            return self._deliver(y, recvbuf)
        # Unpack into recvbuf (even for IN_PLACE, where recvbuf is the send
        # buffer): MPI leaves the elements outside the map untouched.
        return unpack_fn(y, recvbuf)

    def reduce(self, sendbuf, op=op_mod.SUM, root: int = 0, *,
               datatype: Optional[Datatype] = None,
               count: Optional[int] = None, recvbuf=None):
        """in (N, *s) -> out (N, *s), root's row significant."""
        if sendbuf is IN_PLACE:
            sendbuf = recvbuf
        self._validate_stacked(sendbuf)
        self._validate_op(op)
        self._validate_root(root)
        x, unpack_fn = self._wire(sendbuf, datatype, count)
        y = self._coll("reduce").reduce(x, op, root)
        if unpack_fn is None:
            return self._deliver(y, recvbuf)
        return unpack_fn(y, recvbuf)

    def bcast(self, buf, root: int = 0, *,
              datatype: Optional[Datatype] = None,
              count: Optional[int] = None):
        self._validate_stacked(buf)
        self._validate_root(root)
        x, unpack_fn = self._wire(buf, datatype, count)
        y = self._coll("bcast").bcast(x, root)
        return y if unpack_fn is None else unpack_fn(y)

    def allgather(self, sendbuf, *, datatype: Optional[Datatype] = None,
                  count: Optional[int] = None):
        """in (N, *s) -> out (N, N, *s): out[r, j] = rank j's sendbuf."""
        self._validate_stacked(sendbuf)
        x, _ = self._wire(sendbuf, datatype, count)
        return self._coll("allgather").allgather(x)

    def gather(self, sendbuf, root: int = 0, *,
               datatype: Optional[Datatype] = None,
               count: Optional[int] = None):
        """in (N, *s) -> out (N, N, *s), rows valid at root only."""
        self._validate_stacked(sendbuf)
        self._validate_root(root)
        x, _ = self._wire(sendbuf, datatype, count)
        return self._coll("gather").gather(x, root)

    def scatter(self, sendbuf, root: int = 0, *,
                datatype: Optional[Datatype] = None,
                count: Optional[int] = None):
        """in (N, N, *s) (root's row of chunks) -> out (N, *s)."""
        self._validate_stacked(sendbuf, lead=2)
        self._validate_root(root)
        x, _ = self._wire(sendbuf, datatype, count)
        return self._coll("scatter").scatter(x, root)

    def alltoall(self, sendbuf, *, datatype: Optional[Datatype] = None,
                 count: Optional[int] = None):
        """in (N, N, *s) -> out (N, N, *s): out[j, i] = in[i, j]."""
        self._validate_stacked(sendbuf, lead=2)
        if sendbuf.shape[1] != self.size:
            self._err(ERR_COUNT, "alltoall needs one chunk per peer")
        x, _ = self._wire(sendbuf, datatype, count)
        return self._coll("alltoall").alltoall(x)

    def reduce_scatter_block(self, sendbuf, op=op_mod.SUM, *,
                             datatype: Optional[Datatype] = None,
                             count: Optional[int] = None):
        """in (N, N, *s) -> out (N, *s): out[r] = reduce_i in[i, r]."""
        self._validate_stacked(sendbuf, lead=2)
        if sendbuf.shape[1] != self.size:
            self._err(ERR_COUNT, "reduce_scatter_block needs one chunk "
                                 "per peer")
        self._validate_op(op)
        x, _ = self._wire(sendbuf, datatype, count)
        return self._coll("reduce_scatter_block").reduce_scatter_block(x, op)

    def scan(self, sendbuf, op=op_mod.SUM):
        self._validate_stacked(sendbuf)
        self._validate_op(op)
        return self._coll("scan").scan(sendbuf, op)

    def exscan(self, sendbuf, op=op_mod.SUM):
        self._validate_stacked(sendbuf)
        self._validate_op(op)
        return self._coll("exscan").exscan(sendbuf, op)

    def barrier(self) -> None:
        self._coll("barrier").barrier()

    def reduce_scatter(self, sendbuf, recvcounts: Sequence[int],
                       op=op_mod.SUM) -> List[torch.Tensor]:
        """MPI_Reduce_scatter with per-rank counts: in (N, ..., total),
        total = sum(recvcounts); returns one tensor per rank (a ragged
        result is not one stacked tensor). A static (n, max) index map pads
        the segments on the device, and the padded stack rides
        ``reduce_scatter_block`` — so the compressed path takes it where
        eligible, and nothing round-trips through the host."""
        self._validate_stacked(sendbuf)
        self._validate_op(op)
        if len(recvcounts) != self.size:
            self._err(ERR_COUNT, "recvcounts must have comm-size entries")
        counts = [int(c) for c in recvcounts]
        total = sum(counts)
        if sendbuf.shape[-1] != total:
            self._err(ERR_COUNT, f"sendbuf last axis must be {total}")
        n = self.size
        m = max(counts) if counts else 0
        x = (sendbuf.to(self.device) if isinstance(sendbuf, torch.Tensor)
             else self.put(sendbuf))
        if m == 0:
            return [x[r, ..., 0:0] for r in range(n)]
        # segment j's element k sits at offset_j + k; entries past
        # counts[j] are masked to zero
        offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
        idx = np.minimum(offs[:, None] + np.arange(m)[None, :], total - 1)
        mask = np.arange(m)[None, :] < np.asarray(counts)[:, None]
        xs = x.index_select(-1, torch.as_tensor(idx.ravel(),
                                                device=self.device))
        xs = xs.reshape(x.shape[:-1] + (n, m))
        xs = torch.where(torch.as_tensor(mask, device=self.device), xs,
                         torch.zeros((), dtype=xs.dtype, device=self.device))
        # wire layout (N, N, ..., m): the chunk axis before payload axes
        red = self.reduce_scatter_block(torch.movedim(xs, -2, 1), op)
        return [red[r, ..., :counts[r]] for r in range(n)]

    # -- root-targeted forms -------------------------------------------
    def gather_root(self, sendbuf, root: int = 0) -> torch.Tensor:
        """Root-targeted gather (the stacked API's root-only recvbuf):
        rank root's recvbuf, an (N, *local) tensor on root's device only,
        where ``gather`` gives every row an (N, *local) block."""
        self._validate_stacked(sendbuf)
        self._validate_root(root)
        self._coll("gather")                       # state checks
        if isinstance(sendbuf, torch.Tensor):
            return sendbuf.to(self.devices[root], copy=True)
        return torch.tensor(np.asarray(sendbuf), device=self.devices[root])

    def scatter_root(self, chunks, root: int = 0) -> torch.Tensor:
        """Root-targeted scatter, the companion of :meth:`gather_root`:
        ``chunks`` is root's (N, *local) send buffer; returns the stacked
        (N, *local) buffer, row r for rank r, on the comm's device."""
        self._validate_root(root)
        if check_addr(chunks) is None:
            self._err(ERR_ARG, "chunks must be a torch tensor or numpy array")
        if chunks.ndim < 1 or chunks.shape[0] != self.size:
            self._err(ERR_COUNT, f"chunks must have leading axis {self.size}")
        self._coll("scatter")                      # state checks
        return self.put(chunks)

    # -- v-forms (variable counts): pad to the max, run fixed, slice ---
    # Ragged per-peer chunks are padded to the max count on the device,
    # ride the fixed-count collective, and the valid prefixes are cut out
    # on the way back: the stacked analogue of the reference's per-peer
    # count headers. Results are tensors on the comm's device.
    def _ragged(self, per_rank: Sequence[Any], what: str):
        if len(per_rank) != self.size:
            self._err(ERR_COUNT, f"{what} needs one entry per rank")
        return self._ragged_flat(per_rank)

    @staticmethod
    def _ragged_flat(chunks: Sequence[Any]):
        """Each chunk flattened, and its length: tensors stay tensors
        when all are; otherwise all go to numpy."""
        if all(isinstance(a, torch.Tensor) for a in chunks):
            arrs = [a.reshape(-1) for a in chunks]
        else:
            arrs = [(to_numpy(a) if isinstance(a, torch.Tensor)
                     else np.asarray(a)).reshape(-1) for a in chunks]
        return arrs, [int(a.shape[0]) for a in arrs]

    def _pad_stack(self, arrs, counts: Sequence[int],
                   m: int) -> torch.Tensor:
        """(N, m) zero-padded stack on the comm's device; tensor inputs
        are padded there, host inputs on the host and copied once."""
        if isinstance(arrs[0], torch.Tensor):
            out = torch.zeros((len(arrs), m), dtype=arrs[0].dtype,
                              device=self.device)
            for i, a in enumerate(arrs):
                out[i, :counts[i]] = a
            return out
        padded = np.zeros((len(arrs), m), dtype=arrs[0].dtype)
        for i, a in enumerate(arrs):
            padded[i, :counts[i]] = a
        return self.put(padded)

    def _valid(self, counts: Sequence[int], m: int) -> torch.Tensor:
        """Flat positions of the valid prefixes in an (n, m) padded row
        block, in rank order: one gather cuts them all out."""
        idx = np.concatenate([j * m + np.arange(c)
                              for j, c in enumerate(counts)])
        return torch.as_tensor(idx, device=self.device)

    def allgatherv(self, per_rank: Sequence[Any]) -> List[torch.Tensor]:
        """Ragged per-rank arrays in; per rank, the concatenation every
        rank receives."""
        arrs, counts = self._ragged(per_rank, "allgatherv")
        m = max(counts) if counts else 0
        if m == 0:
            return list(arrs)
        n = self.size
        g = self.allgather(self._pad_stack(arrs, counts, m))  # (N, N, m)
        return list(g.reshape(n, n * m)[:, self._valid(counts, m)])

    def gatherv(self, per_rank: Sequence[Any], root: int = 0) -> torch.Tensor:
        """MPI_Gatherv: ragged per-rank contributions; returns the
        concatenation (root's recvbuf)."""
        self._validate_root(root)
        arrs, counts = self._ragged(per_rank, "gatherv")
        m = max(counts) if counts else 0
        if m == 0:
            return arrs[0]
        g = self.gather(self._pad_stack(arrs, counts, m), root)
        return g[root].reshape(-1)[self._valid(counts, m)]

    def scatterv(self, chunks: Sequence[Any],
                 root: int = 0) -> List[torch.Tensor]:
        """MPI_Scatterv: ``chunks`` is root's ragged per-destination list;
        returns one tensor per rank."""
        self._validate_root(root)
        arrs, counts = self._ragged(chunks, "scatterv")
        m = max(counts) if counts else 0
        if m == 0:
            return list(arrs)
        s = self.scatter_root(self._pad_stack(arrs, counts, m), root)
        return [s[r, :counts[r]] for r in range(self.size)]

    def alltoallv(self, send_chunks: Sequence[Sequence[Any]]
                  ) -> List[List[torch.Tensor]]:
        """MPI_Alltoallv: ``send_chunks[i][j]`` is rank i's ragged chunk
        for rank j; returns ``recv`` with ``recv[j][i]`` = the chunk i
        sent to j."""
        n = self.size
        if len(send_chunks) != n:
            self._err(ERR_COUNT, "alltoallv needs one row per rank")
        for row in send_chunks:
            if len(row) != n:
                self._err(ERR_COUNT, "alltoallv needs one chunk per peer")
        flat = [c for row in send_chunks for c in row]
        arrs, sizes = self._ragged_flat(flat)
        counts = [sizes[i * n:(i + 1) * n] for i in range(n)]
        m = max(sizes, default=0)
        if m == 0:
            return [[arrs[i * n + j] for i in range(n)] for j in range(n)]
        t = self.alltoall(self._pad_stack(arrs, sizes, m).view(n, n, m))
        return [[t[j, i, :counts[i][j]] for i in range(n)]
                for j in range(n)]

    def alltoallw(self, send_chunks: Sequence[Sequence[Any]],
                  send_types: Sequence[Sequence[Optional[Datatype]]],
                  send_counts: Optional[Sequence[Sequence[int]]] = None
                  ) -> List[List[torch.Tensor]]:
        """MPI_Alltoallw: per-(src, dst) datatypes. Each chunk is packed on
        the host with its own datatype (the per-pair layouts preclude one
        device index map), then the packed chunks ride ``alltoallv``.
        ``send_counts[i][j]`` is the instance count; when omitted, the
        most instances that fit the chunk — the last one needs only the
        type's true extent (MPI's buffer-length rule)."""
        packed = []
        for i, (row, trow) in enumerate(zip(send_chunks, send_types)):
            prow = []
            for j, (c, t) in enumerate(zip(row, trow)):
                a = (to_numpy(c) if isinstance(c, torch.Tensor)
                     else np.asarray(c))
                if t is not None and not t.is_contiguous:
                    extent = max(t.extent, 1)
                    lo, rng = t.get_true_extent()
                    if send_counts is not None:
                        cnt = send_counts[i][j]
                    elif a.shape[-1] < lo + rng:
                        cnt = 0
                    else:
                        cnt = 1 + (a.shape[-1] - lo - rng) // extent
                    if a.shape[-1] < ((cnt - 1) * extent + lo + rng
                                      if cnt else 0):
                        self._err(ERR_COUNT,
                                  f"alltoallw chunk length {a.shape[-1]} "
                                  f"cannot hold {cnt} instances "
                                  f"(extent {extent}, true extent "
                                  f"{lo + rng})")
                    a = (convertor.pack(a, t, cnt) if cnt
                         else np.empty((0,), a.dtype))
                prow.append(a.ravel())
            packed.append(prow)
        return self.alltoallv(packed)

    # ==================================================================
    # Nonblocking variants: torch dispatch is asynchronous on the card —
    # the collective is enqueued on the stream and a Request holds its
    # output and the event recorded right after it.
    # ==================================================================
    def _nb(self, fn: Callable, *args, **kw) -> Request:
        out = fn(*args, **kw)
        return Request(result=out, event=event_after(out))

    def _isched(self, func: str):
        """The i-collective's vtable slot when a schedule component
        (coll/nbc) won it; None routes through async dispatch (_nb). Runs
        the same entry checks as _coll."""
        return self._coll(func) if func in self.c_coll else None

    def iallreduce(self, sendbuf, op=op_mod.SUM, **kw) -> Request:
        if not kw:
            from ompi_tpu_torch.coll import persistent as _pcoll
            if _pcoll.bucket_enabled():
                # DDP-style bucket fusion: concurrent small iallreduces
                # on the same (op, dtype) coalesce into one flattened
                # fused collective
                self._validate_stacked(sendbuf)
                self._validate_op(op)
                r = _pcoll.maybe_bucket_iallreduce(self, sendbuf, op)
                if r is not None:
                    return r
            m = self._isched("iallreduce")
            if m is not None:
                self._validate_stacked(sendbuf)
                self._validate_op(op)
                return m.iallreduce(sendbuf, op)
        return self._nb(self.allreduce, sendbuf, op, **kw)

    def ibcast(self, buf, root: int = 0) -> Request:
        m = self._isched("ibcast")
        if m is not None:
            self._validate_stacked(buf)
            self._validate_root(root)
            return m.ibcast(buf, root)
        return self._nb(self.bcast, buf, root)

    def ireduce(self, sendbuf, op=op_mod.SUM, root: int = 0, **kw) -> Request:
        return self._nb(self.reduce, sendbuf, op, root, **kw)

    def iallgather(self, sendbuf) -> Request:
        m = self._isched("iallgather")
        if m is not None:
            self._validate_stacked(sendbuf)
            return m.iallgather(sendbuf)
        return self._nb(self.allgather, sendbuf)

    def igather(self, sendbuf, root: int = 0) -> Request:
        return self._nb(self.gather, sendbuf, root)

    def iscatter(self, sendbuf, root: int = 0) -> Request:
        return self._nb(self.scatter, sendbuf, root)

    def ialltoall(self, sendbuf) -> Request:
        return self._nb(self.alltoall, sendbuf)

    def ireduce_scatter_block(self, sendbuf, op=op_mod.SUM) -> Request:
        return self._nb(self.reduce_scatter_block, sendbuf, op)

    def iscan(self, sendbuf, op=op_mod.SUM) -> Request:
        return self._nb(self.scan, sendbuf, op)

    def iexscan(self, sendbuf, op=op_mod.SUM) -> Request:
        return self._nb(self.exscan, sendbuf, op)

    def iallgatherv(self, per_rank: Sequence[Any]) -> Request:
        return self._nb(self.allgatherv, per_rank)

    def igatherv(self, per_rank: Sequence[Any], root: int = 0) -> Request:
        return self._nb(self.gatherv, per_rank, root)

    def iscatterv(self, chunks: Sequence[Any], root: int = 0) -> Request:
        return self._nb(self.scatterv, chunks, root)

    def ialltoallv(self, send_chunks: Sequence[Sequence[Any]]) -> Request:
        return self._nb(self.alltoallv, send_chunks)

    def ibarrier(self) -> Request:
        ms = self._isched("ibarrier")
        if ms is not None:
            return ms.ibarrier()
        m = self._coll("barrier")
        fn = getattr(m, "_ibarrier_arrays", None)
        if fn is not None:
            arrays = fn()
            return Request(result=arrays, event=event_after(arrays))
        # the winner has no async form: a completed synchronous barrier
        # is still a correct MPI_Ibarrier
        m.barrier()
        return Request.completed()

    # -- persistent collectives (MPI-4 MPI_Allreduce_init etc.) --------
    # Each init builds a pre-bound plan (coll/persistent: validated,
    # selected and warmed at init; Start is launch-only, and bucketable
    # starts fuse).
    def allreduce_init(self, sendbuf, op=op_mod.SUM, **kw) -> Request:
        if not kw:
            from ompi_tpu_torch.coll import persistent as _pcoll
            return _pcoll.coll_init(self, "allreduce", sendbuf, op)
        return Request(persistent_start=lambda: self.iallreduce(
            sendbuf, op, **kw))

    def allreduce_bind(self, example, op=op_mod.SUM) -> Callable:
        """Pre-bound hot-path handle (``MPI_Allreduce_init``'s purpose is
        to hoist per-call setup out of the loop): validation, selection
        and the algorithm check run ONCE here; the returned callable is
        the selected module's lowering alone. Buffers must have this
        communicator's stacked layout."""
        self._validate_stacked(example)
        self._validate_op(op)
        mod = self._coll("allreduce")
        bind = getattr(mod, "bind_allreduce", None)
        if bind is None:                 # host module won selection
            return lambda buf: mod.allreduce(buf, op)
        return bind(example, op)

    def bcast_init(self, buf, root: int = 0) -> Request:
        from ompi_tpu_torch.coll import persistent as _pcoll
        return _pcoll.coll_init(self, "bcast", buf, root)

    def allgather_init(self, sendbuf) -> Request:
        from ompi_tpu_torch.coll import persistent as _pcoll
        return _pcoll.coll_init(self, "allgather", sendbuf)

    def reduce_scatter_block_init(self, sendbuf,
                                  op=op_mod.SUM) -> Request:
        from ompi_tpu_torch.coll import persistent as _pcoll
        return _pcoll.coll_init(self, "reduce_scatter_block", sendbuf, op)

    def barrier_init(self) -> Request:
        from ompi_tpu_torch.coll import persistent as _pcoll
        return _pcoll.coll_init(self, "barrier")

    # ==================================================================
    # Point-to-point (pml framework; matching spec pml_ob1_recvfrag.c).
    # Single-controller: the sending rank (``src``) and the receiving
    # rank (``dst``) are explicit arguments; ``data`` is that rank's
    # local buffer.
    # ==================================================================
    @property
    def _pml(self):
        """The matching engine, made on first use: the pessimist
        message-logging engine when ``pml_v_protocol=pessimist``
        (``pml/vprotocol``), else the plain one."""
        eng = getattr(self, "_pml_engine", None)
        if eng is None:
            from ompi_tpu_torch.mca import var
            from ompi_tpu_torch.pml import vprotocol  # its var
            from ompi_tpu_torch.pml.stacked import MatchingEngine
            if var.var_get("pml_v_protocol", "none") == "pessimist":
                eng = self._pml_engine = vprotocol.PessimistEngine(self)
            else:
                eng = self._pml_engine = MatchingEngine(self)
        return eng

    def _record_pml(self, event: str) -> None:
        spc.record(event, 1)
        hooks.fire(event, self, {})

    def send(self, data, src: int, dest: int, tag: int = 0) -> None:
        """MPI_Send from rank ``src`` to ``dest``."""
        self._check()
        self._check_peer_ft(dest)
        self._record_pml("pml_send")
        self._pml.send(data, src, dest, tag)

    def isend(self, data, src: int, dest: int, tag: int = 0) -> Request:
        self._check()
        self._check_peer_ft(dest)
        self._record_pml("pml_send")
        return self._pml.send(data, src, dest, tag)

    def ssend(self, data, src: int, dest: int, tag: int = 0) -> None:
        """MPI_Ssend: completes only if the receive has started; raises
        the deadlock otherwise (single-controller semantics)."""
        self._check()
        self._check_peer_ft(dest)
        self._record_pml("pml_send")
        self._pml.send(data, src, dest, tag, synchronous=True)

    def bsend(self, data, src: int, dest: int, tag: int = 0) -> None:
        """MPI_Bsend: the payload is buffered (copied) at send time."""
        self._check()
        self._check_peer_ft(dest)
        self._record_pml("pml_send")
        self._pml.send(data, src, dest, tag)

    def recv(self, source: int, tag: int = -1, *, dst: int = 0):
        """MPI_Recv executed by rank ``dst``: returns (data, Status).
        Raises instead of deadlocking if no matching send was posted."""
        self._check()
        if source == -1:  # ANY_SOURCE
            self._check_anysource_ft()
        else:
            self._check_peer_ft(source)
        self._record_pml("pml_recv")
        return self._pml.recv(dst, source, tag)

    def irecv(self, source: int, tag: int = -1, *, dst: int = 0) -> Request:
        # ULFM (req_ft.c): a nonblocking wildcard receive posts normally
        # even with unacknowledged failures — a live sender may still
        # match it; the pending error surfaces at test/wait
        # (PtpRequest._check_ft). Only blocking recv raises at entry.
        self._check()
        if source != -1:  # named peer: fail fast, as the reference does
            self._check_peer_ft(source)
        self._record_pml("pml_recv")
        return self._pml.irecv(dst, source, tag)

    def sendrecv(self, senddata, src: int, dest: int, recvsource: int,
                 sendtag: int = 0, recvtag: int = -1):
        """MPI_Sendrecv executed by rank ``src``: post the send, then
        receive (deadlock-free by construction)."""
        self._check()
        self._check_peer_ft(dest)
        if recvsource == -1:  # ANY_SOURCE
            self._check_anysource_ft()
        else:
            self._check_peer_ft(recvsource)
        self._record_pml("pml_send")
        self._record_pml("pml_recv")
        self._pml.send(senddata, src, dest, sendtag)
        return self._pml.recv(src, recvsource, recvtag)

    def probe(self, source: int, tag: int = -1, *, dst: int = 0) -> Status:
        self._check()
        return self._pml.probe(dst, source, tag)

    def iprobe(self, source: int, tag: int = -1, *, dst: int = 0):
        self._check()
        return self._pml.iprobe(dst, source, tag)

    def mprobe(self, source: int, tag: int = -1, *, dst: int = 0):
        self._check()
        return self._pml.mprobe(dst, source, tag)

    def improbe(self, source: int, tag: int = -1, *, dst: int = 0):
        """MPI_Improbe: nonblocking matched probe — (flag, message,
        Status); on no match returns (False, None, None)."""
        self._check()
        flag, status = self._pml.iprobe(dst, source, tag)
        if not flag:
            return False, None, None
        return True, self._pml.mprobe(dst, source, tag), status

    def mrecv(self, message):
        self._check()
        return self._pml.mrecv(message)

    def send_init(self, data, src: int, dest: int, tag: int = 0) -> Request:
        """MPI_Send_init (persistent): each start sends ``data`` as it is
        then."""
        self._check()
        return Request(persistent_start=lambda: self._pml.send(
            data, src, dest, tag))

    def recv_init(self, source: int, tag: int = -1, *,
                  dst: int = 0) -> Request:
        self._check()
        return Request(persistent_start=lambda: self._pml.irecv(
            dst, source, tag))

    # -- partitioned pt2pt (MPI-4, mirrors ompi/mca/part/persist) ------
    def psend_init(self, parts: Sequence[Any], dest: int, tag: int = 0,
                   src: int = 0):
        """MPI_Psend_init: ``parts`` is the partition list; ``pready(i)``
        marks partition i; the message is sent when all are ready."""
        self._check()
        from ompi_tpu_torch.pml.partitioned import PartitionedSend
        return PartitionedSend(self, parts, src, dest, tag)

    def precv_init(self, source: int, tag: int = 0, partitions: int = 1,
                   *, dst: int = 0):
        self._check()
        from ompi_tpu_torch.pml.partitioned import PartitionedRecv
        return PartitionedRecv(self, source, tag, partitions, dst=dst)

    # ==================================================================
    # Communicator algebra
    # ==================================================================
    def dup(self, info: Optional[Info] = None) -> "Communicator":
        self._check()
        c = self.__class__(Group(self.group.world_ranks), self.devices,
                           name=f"{self.name}.dup", parent=self,
                           info=info or self.info,
                           errhandler=self.errhandler)
        try:
            propagate_attrs(self, c)
        except BaseException:
            c.free()                     # no half-built comm leaks
            raise
        return c

    def split(self, colors: Sequence[int], keys: Optional[Sequence[int]] = None
              ) -> List[Optional["Communicator"]]:
        """MPI_Comm_split (comm.c:749). ``colors[r]``/``keys[r]`` are rank
        r's arguments; returns one entry per rank — the new communicator
        containing that rank (shared object) or None (MPI_COMM_NULL) for
        color == UNDEFINED. Children are parent-row subsets."""
        self._check()
        if keys is None:
            keys = [0] * self.size
        if len(colors) != self.size or len(keys) != self.size:
            self._err(ERR_ARG, "need color/key per rank")
        by_color: Dict[int, List[int]] = {}
        for r, c in enumerate(colors):
            if c != UNDEFINED:
                by_color.setdefault(c, []).append(r)
        out: List[Optional[Communicator]] = [None] * self.size
        # Deterministic order over colors = identical CID allocation on
        # every rank (the agreement property of comm_cid.c).
        for c in sorted(by_color):
            members = sorted(by_color[c], key=lambda r: (keys[r], r))
            g = Group([self.group.world_ranks[r] for r in members])
            devs = [self.devices[r] for r in members]
            newc = self.__class__(
                g, devs, name=f"{self.name}.split({c})",
                parent=self, errhandler=self.errhandler)
            for r in members:
                out[r] = newc
        return out

    def split_type(self, split_type: int,
                   keys: Optional[Sequence[int]] = None):
        """MPI_Comm_split_type: group ranks by hardware locality.
        COMM_TYPE_SHARED groups ranks whose devices share a host process
        (``device_locality``; a torch device reads as process 0, so every
        rank of this controller); COMM_TYPE_NUMA uses a device's NUMA
        node where it exposes one, else its process; COMM_TYPE_HWTHREAD
        gives every rank its own communicator; UNDEFINED yields
        MPI_COMM_NULL everywhere."""
        if split_type == UNDEFINED:
            return [None] * self.size
        if split_type == 2:           # COMM_TYPE_HWTHREAD
            colors = list(range(self.size))
        elif split_type == 3:         # COMM_TYPE_NUMA
            colors = [int(getattr(d, "numa_node", None)
                          or device_locality(d)[0]) for d in self.devices]
        elif split_type == 1:         # COMM_TYPE_SHARED
            colors = [device_locality(d)[0] for d in self.devices]
        else:
            self._err(ERR_ARG, f"unknown split_type {split_type}")
            return [None] * self.size
        return self.split(colors, keys)

    def create(self, group: Group) -> Optional["Communicator"]:
        """MPI_Comm_create: new communicator over a subgroup."""
        self._check()
        ranks = []
        for wr in group.world_ranks:
            lr = self.group.rank_of(wr)
            if lr == UNDEFINED:
                self._err(ERR_RANK, "group not a subset of communicator")
            ranks.append(lr)
        devs = [self.devices[r] for r in ranks]
        return self.__class__(group, devs, name=f"{self.name}.create",
                              parent=self, errhandler=self.errhandler)

    def compare(self, other: "Communicator") -> int:
        from ompi_tpu_torch.core.group import (CONGRUENT, IDENT, SIMILAR,
                                               UNEQUAL)
        if self is other:
            return IDENT
        g = self.group.compare(other.group)
        if g == IDENT:
            return CONGRUENT
        return SIMILAR if g == SIMILAR else UNEQUAL

    def free(self) -> None:
        fire_delete_attrs(self)
        self._freed = True
        # pvar session semantics: instruments owned by this cid
        # (telemetry histograms, trace_skew_c<cid>) retire with it — a
        # later pvar read must not report a freed comm's keys
        from ompi_tpu_torch import telemetry as _telemetry
        _telemetry.retire_comm(self.cid)

    # -- process topologies (topo framework) ---------------------------
    def create_cart(self, dims: Sequence[int],
                    periods: Optional[Sequence[bool]] = None,
                    reorder: bool = False) -> "Communicator":
        """MPI_Cart_create. ``reorder=True`` orders ranks by their
        devices' physical coords where a device exposes them (a torch
        device does not: the order stays)."""
        import math
        from ompi_tpu_torch.topo import CartTopology
        dims = list(dims)
        if periods is None:
            periods = [False] * len(dims)
        n = math.prod(dims)
        if n > self.size:
            self._err(ERR_ARG, f"cart size {n} exceeds comm size")
        ranks = list(range(n))
        if reorder:
            ranks = sorted(ranks, key=lambda i: (
                device_locality(self.devices[i])[1] or (i,)))
        g = Group([self.group.world_ranks[r] for r in ranks])
        c = self.__class__(g, [self.devices[r] for r in ranks],
                           name=f"{self.name}.cart", parent=self,
                           errhandler=self.errhandler)
        c.topo = CartTopology(dims, periods)
        return c

    def _cart(self):
        from ompi_tpu_torch.topo import CartTopology
        if not isinstance(self.topo, CartTopology):
            self._err(ERR_TOPOLOGY, "communicator has no cartesian topology")
        return self.topo

    def _topo(self):
        if self.topo is None:
            self._err(ERR_TOPOLOGY, "no topology attached")
        return self.topo

    def cart_rank(self, coords: Sequence[int]) -> int:
        return self._cart().rank(coords)

    def cart_coords(self, rank: int) -> Tuple[int, ...]:
        return self._cart().coords(rank)

    def cart_shift(self, rank: int, direction: int,
                   disp: int = 1) -> Tuple[int, int]:
        return self._cart().shift(rank, direction, disp)

    def cart_sub(self, remain: Sequence[bool]) -> List["Communicator"]:
        """MPI_Cart_sub: split into sub-cart communicators along kept
        dims; returns one entry per rank."""
        from ompi_tpu_torch.topo import CartTopology
        colors, new_topo = self._cart().sub_keep(remain)
        subs = self.split(colors)
        for s in subs:
            if s is not None and s.topo is None:
                s.topo = CartTopology(new_topo.dims, new_topo.periods)
        return subs

    def create_graph(self, index: Sequence[int], edges: Sequence[int],
                     reorder: bool = False) -> "Communicator":
        """MPI_Graph_create. ``reorder=True`` runs the treematch
        placement: rank r is bound to the device slot that minimizes the
        graph's weighted hop count (``topo/treematch``)."""
        from ompi_tpu_torch.topo import GraphTopology
        topo = GraphTopology(index, edges)
        if topo.size > self.size:
            self._err(ERR_ARG, "graph larger than communicator")
        devices = list(self.devices[:topo.size])
        if reorder and topo.size > 1:
            from ompi_tpu_torch.topo import treematch as tm
            perm = tm.treematch_permutation(
                tm.comm_matrix_from_graph(index, edges),
                tm.hardware_distance(devices))
            devices = [devices[perm[r]] for r in range(topo.size)]
        c = self.__class__(Group(self.group.world_ranks[:topo.size]),
                           devices, name=f"{self.name}.graph", parent=self,
                           errhandler=self.errhandler)
        c.topo = topo
        return c

    def create_dist_graph_adjacent(self, sources, destinations
                                   ) -> "Communicator":
        from ompi_tpu_torch.topo import DistGraphTopology
        c = self.dup()
        c.topo = DistGraphTopology(sources, destinations)
        c.name = f"{self.name}.dist_graph"
        return c

    def graph_neighbors(self, rank: int) -> List[int]:
        return self._topo().neighbors(rank)

    def neighbor_allgather(self, sendbuf) -> List[Any]:
        """MPI_Neighbor_allgather: each rank receives its neighbors'
        buffers (in neighbor order). A tensor is exchanged on the
        communicator's device by one gather (``topo/neighbor``); a numpy
        array takes the host path."""
        self._validate_stacked(sendbuf)
        topo = self._topo()
        if isinstance(sendbuf, torch.Tensor):
            from ompi_tpu_torch.topo import neighbor as nbr
            return nbr.device_neighbor_allgather(self, sendbuf)
        host = np.asarray(sendbuf)
        out = []
        for r in range(self.size):
            nb = [n for n in topo.neighbors(r) if n >= 0]
            out.append(np.stack([host[n] for n in nb])
                       if nb else np.empty((0,) + host.shape[1:],
                                           host.dtype))
        return out

    def neighbor_alltoall(self, sendbuf) -> List[Any]:
        """MPI_Neighbor_alltoall: sendbuf (N, max_out_deg, *s); rank r's
        j-th chunk goes to its j-th out-neighbor; each rank receives one
        chunk per in-neighbor (in neighbor order). A tensor is exchanged
        on the device by one gather, a numpy array on the host."""
        self._validate_stacked(sendbuf, lead=2)
        topo = self._topo()
        if isinstance(sendbuf, torch.Tensor):
            from ompi_tpu_torch.topo import neighbor as nbr
            return nbr.device_neighbor_alltoall(self, sendbuf)
        from collections import deque
        host = np.asarray(sendbuf)
        out_nb = getattr(topo, "out_neighbors", topo.neighbors)
        # the chunk s sends to its j-th out-neighbor d lands at d at the
        # position of the matching occurrence of s in d's in-neighbor
        # list; FIFO per (sender, receiver) pair handles duplicate edges
        # (periodic dims of size <= 2, multigraph dist-graphs)
        recv: Dict[Tuple[int, int], Any] = {}
        for s in range(self.size):
            for j, d in enumerate(out_nb(s)):
                if 0 <= d < self.size:
                    recv.setdefault((d, s), deque()).append(host[s, j])
        out = []
        for r in range(self.size):
            chunks = []
            for n in topo.neighbors(r):
                if n < 0:
                    continue
                q = recv.get((r, n))
                chunks.append(q.popleft() if q
                              else np.zeros(host.shape[2:], host.dtype))
            out.append(np.stack(chunks) if chunks
                       else np.empty((0,) + host.shape[2:], host.dtype))
        return out

    def neighbor_allgatherv(self, per_rank: Sequence[Any]) -> List[Any]:
        """MPI_Neighbor_allgatherv: ragged contributions; rank r receives
        the concatenation of its neighbors' (variable-size) buffers in
        neighbor order."""
        topo = self._topo()
        arrs, _counts = self._ragged(per_rank, "neighbor_allgatherv")
        if isinstance(arrs[0], torch.Tensor):
            from ompi_tpu_torch.topo import neighbor as nbr
            return nbr.device_neighbor_allgatherv(self, arrs)
        out = []
        for r in range(self.size):
            nb = [n for n in topo.neighbors(r) if n >= 0]
            out.append(np.concatenate([arrs[n] for n in nb])
                       if nb else np.empty((0,), arrs[0].dtype))
        return out

    def neighbor_alltoallv(self, send_chunks: Sequence[Sequence[Any]]
                           ) -> List[List[Any]]:
        """MPI_Neighbor_alltoallv: ``send_chunks[r][j]`` is rank r's
        ragged chunk for its j-th out-neighbor; rank r receives one chunk
        per in-neighbor, as a list aligned with its in-neighbor order
        (empty where the sender provided no chunk — alignment is never
        silently shifted)."""
        topo = self._topo()
        if len(send_chunks) != self.size:
            self._err(ERR_COUNT, "need one chunk row per rank")
        flat = [c for row in send_chunks for c in row]
        if flat and all(isinstance(c, torch.Tensor) for c in flat):
            return self._neighbor_alltoallv_device(send_chunks)
        from collections import deque
        out_nb = getattr(topo, "out_neighbors", topo.neighbors)
        recv: Dict[Tuple[int, int], Any] = {}
        for s in range(self.size):
            for j, d in enumerate(out_nb(s)):
                if 0 <= d < self.size and j < len(send_chunks[s]):
                    c = send_chunks[s][j]
                    recv.setdefault((d, s), deque()).append(
                        (to_numpy(c) if isinstance(c, torch.Tensor)
                         else np.asarray(c)).ravel())
        empty = np.empty((0,), np.float32)
        out: List[List[Any]] = []
        for r in range(self.size):
            chunks = []
            for n in topo.neighbors(r):
                q = recv.get((r, n)) if n >= 0 else None
                chunks.append(q.popleft() if q else empty)
            out.append(chunks)
        return out

    def _neighbor_alltoallv_device(self, send_chunks) -> List[List[Any]]:
        """Device lowering of neighbor_alltoallv: every chunk flat, one
        concatenation and one gather (``topo/neighbor``), each received
        chunk a view cut to its sender's length (the plan's FIFO edge
        pairing says which sender's)."""
        from ompi_tpu_torch.topo import neighbor as nbr
        rows = [[c.reshape(-1) for c in row] for row in send_chunks]
        return nbr.device_neighbor_alltoallv(self, rows)

    # -- attributes (keyvals) ------------------------------------------
    def set_attr(self, keyval: int, value: Any) -> None:
        self.attributes[keyval] = value

    def get_attr(self, keyval: int) -> Tuple[bool, Any]:
        if keyval in self.attributes:
            return True, self.attributes[keyval]
        return False, None

    def delete_attr(self, keyval: int) -> None:
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
        """MPI_Abort: one controller drives every rank, so ending it ends
        the job — a line on stderr, then ``SystemExit(errorcode)``."""
        import sys
        sys.stderr.write(f"MPI_Abort on {self.name} errorcode={errorcode}\n")
        raise SystemExit(errorcode)

    # -- ULFM (mpiext/ftmpi semantics) ---------------------------------
    # The failure registry (runtime/ft) is the PMIx-event-stream
    # equivalent; these methods implement the MPIX_Comm_* surface over
    # it. Per ULFM, agree/shrink/failure_ack remain usable on revoked
    # communicators — they bypass _check().
    def _failed_local(self) -> List[int]:
        return [r for r, w in enumerate(self.group.world_ranks)
                if self._ft.is_failed(w)]

    def _check_ft_coll(self) -> None:
        """Collectives must not silently complete across a failure
        (ompi/request/req_ft.c: ops involving failed procs raise
        MPIX_ERR_PROC_FAILED until the comm is shrunk)."""
        if not self._ft.any_failed():        # hot path: nothing has failed
            return
        failed = self._failed_local()
        if failed:
            from ompi_tpu_torch.core.errhandler import ERR_PROC_FAILED
            self._err(ERR_PROC_FAILED,
                      f"rank(s) {failed} of {self.name} have failed "
                      f"(shrink or agree to continue)")

    def _check_peer_ft(self, peer: int) -> None:
        if peer is None or not (0 <= peer < self.size):
            return
        if self._ft.is_failed(self.group.world_ranks[peer]):
            from ompi_tpu_torch.core.errhandler import ERR_PROC_FAILED
            self._err(ERR_PROC_FAILED, f"peer rank {peer} has failed")

    def _check_anysource_ft(self) -> None:
        """A wildcard receive with unacknowledged failures raises
        MPIX_ERR_PROC_FAILED: the matching send might have come from the
        dead peer. failure_ack() re-arms wildcards."""
        unacked = [r for r in self._failed_local()
                   if self.group.world_ranks[r] not in self._acked_failures]
        if unacked:
            from ompi_tpu_torch.core.errhandler import ERR_PROC_FAILED
            self._err(ERR_PROC_FAILED,
                      f"ANY_SOURCE receive with unacknowledged failed "
                      f"rank(s) {unacked}; call failure_ack() first")

    def revoke(self) -> None:
        """MPIX_Comm_revoke. Single-controller: the comm object is the
        shared state all ranks observe, so setting the flag is the
        reliable revocation broadcast; pending pt2pt requests observe it
        at completion."""
        self._revoked = True

    def is_revoked(self) -> bool:
        return self._revoked

    def shrink(self, failed_ranks: Optional[Sequence[int]] = None
               ) -> "Communicator":
        """MPIX_Comm_shrink: agree on the failed set, return a new
        communicator over the survivors. Works on revoked comms. The
        child lives on the same device: its stacked buffers hold the
        survivors' rows, and nothing is copied to the host."""
        if self._freed:
            raise MPIError(ERR_COMM, "communicator has been freed")
        failed = set(failed_ranks or ())
        failed.update(self._failed_local())
        # agreement on the failed set: each rank's view as a bitmask,
        # AND-agreed (the ftagree pass the reference's shrink performs)
        mask = ~sum(1 << r for r in failed)
        agreed, _ = self._agree_module().agree([mask] * self.size)
        alive = [r for r in range(self.size)
                 if (agreed >> r) & 1 and r not in failed]
        g = Group([self.group.world_ranks[r] for r in alive])
        devs = [self.devices[r] for r in alive]
        child = self.__class__(g, devs, name=f"{self.name}.shrink",
                               parent=self, errhandler=self.errhandler)
        # the parent keeps living (ULFM shrink does not free it), but
        # its per-comm instruments describe the dead-rank era — retire
        # them so reads after the shrink start from the survivor set
        from ompi_tpu_torch import telemetry as _telemetry
        _telemetry.retire_comm(self.cid)
        return child

    def ishrink(self) -> Request:
        return Request.completed(self.shrink())

    def survivor_rows(self, stacked, child: "Communicator"):
        """The rows of ``stacked`` (a buffer of this comm) that belong to
        ``child``'s members, in ``child``'s rank order — an index on the
        device, so a shrunk comm's operands stay on the card."""
        rows = [self.group.rank_of(w) for w in child.group.world_ranks]
        if isinstance(stacked, torch.Tensor):
            idx = torch.tensor(rows, dtype=torch.long,
                               device=stacked.device)
            return stacked.index_select(0, idx)
        return np.asarray(stacked)[rows]

    def _agree_module(self):
        m = self.c_coll.get("agree")
        if m is None:
            from ompi_tpu_torch.coll.ftagree import FtAgreeModule
            return FtAgreeModule(self)
        return m

    def agree(self, flags: Sequence[int]) -> int:
        """MPIX_Comm_agree: uniform bitwise-AND agreement via
        coll/ftagree. Raises MPIX_ERR_PROC_FAILED (carrying the agreed
        value in ``.agreed_value``) when a participant failed and was not
        acknowledged — the ULFM contract: agreement is still reached."""
        if self._freed:
            raise MPIError(ERR_COMM, "communicator has been freed")
        value, failed = self._agree_module().agree(flags)
        unacked = [r for r in failed
                   if self.group.world_ranks[r] not in self._acked_failures]
        if unacked:
            from ompi_tpu_torch.core.errhandler import ERR_PROC_FAILED
            err = MPIError(ERR_PROC_FAILED,
                           f"agreement reached over failed rank(s) "
                           f"{unacked}")
            err.agreed_value = value
            raise err
        return value

    def iagree(self, flags: Sequence[int]) -> Request:
        return Request.completed(self.agree(flags))

    def failure_ack(self) -> None:
        """MPIX_Comm_failure_ack: acknowledge all currently-known
        failures, re-arming ANY_SOURCE receives and quieting agree()."""
        self._acked_failures = frozenset(self._acked_failures | {
            w for w in self.group.world_ranks if self._ft.is_failed(w)})

    def failure_get_acked(self) -> Group:
        """MPIX_Comm_failure_get_acked: group of acknowledged failed
        processes."""
        return Group([w for w in self.group.world_ranks
                      if w in self._acked_failures])

    def get_failed(self) -> Group:
        """MPIX_Comm_get_failed (MPI-5 FT): all known-failed members."""
        return Group([w for w in self.group.world_ranks
                      if self._ft.is_failed(w)])

    def ack_failed(self, num_to_ack: Optional[int] = None) -> Group:
        """MPIX_Comm_ack_failed (MPI-5 FT): acknowledge the first
        ``num_to_ack`` failed members (all, when None); returns the
        acked group."""
        failed = [w for w in self.group.world_ranks if self._ft.is_failed(w)]
        if num_to_ack is not None:
            failed = failed[:num_to_ack]
        self._acked_failures = frozenset(self._acked_failures | set(failed))
        return Group(sorted(self._acked_failures))

    def __repr__(self):
        return (f"Communicator({self.name}, size={self.size}, "
                f"cid={self.cid}, device={self.device})")


# -- keyval registry (MPI_Comm_create_keyval) ------------------------------
_keyvals: Dict[int, Tuple[Optional[Callable], Optional[Callable]]] = {}
_keyval_counter = itertools.count(100)


def create_keyval(copy_fn: Optional[Callable] = None,
                  delete_fn: Optional[Callable] = None) -> int:
    """MPI_Comm_create_keyval. ``copy_fn(comm, keyval, value) ->
    (keep: bool, new_value)`` runs at Comm_dup (no copy_fn => the
    attribute is not propagated, per MPI); ``delete_fn(comm, keyval,
    value)`` runs at attribute deletion / communicator free."""
    kv = next(_keyval_counter)
    _keyvals[kv] = (copy_fn, delete_fn)
    return kv


def free_keyval(keyval: int) -> None:
    _keyvals.pop(keyval, None)


def propagate_attrs(src, dst) -> None:
    """MPI attribute-copy semantics at Comm_dup (attribute.c:349-384):
    an attribute propagates only through its keyval's copy callback,
    which may veto or transform the value."""
    for kv, val in src.attributes.items():
        cb = _keyvals.get(kv)
        copy_fn = cb[0] if cb else None
        if copy_fn is None:
            continue
        keep, newval = copy_fn(src, kv, val)
        if keep:
            dst.attributes[kv] = newval


def fire_delete_attrs(comm) -> None:
    """Delete callbacks at communicator free (attribute.c free path).
    A raising callback propagates (MPI_Comm_free must report it)."""
    for kv, val in list(comm.attributes.items()):
        cb = _keyvals.get(kv)
        if cb and cb[1]:
            cb[1](comm, kv, val)
    comm.attributes.clear()
