"""C-ABI glue — flat, scalar-typed entry points for ``native/mpi_cabi.c``
(the port of ``ompi_tpu/api/cabi.py``).

The C shim (``libtpumpi_torch.so``, which ``tools/mpicc`` builds from a
generated copy of ``native/mpi_cabi.c`` that imports this module) embeds
CPython, imports this module once, and calls these functions with
memoryviews over the caller's C buffers.
Everything here is deliberately *flat*: int handles instead of objects,
``bytes`` instead of arrays, positional scalars instead of kwargs — so
the C side stays a thin marshalling layer (``PyObject_CallMethod`` with
format strings) and never touches numpy headers.

Behavioral spec: the reference's C bindings are one-screen wrappers that
validate args and dispatch into the core (`ompi/mpi/c/send.c.in`,
`allreduce.c.in:54-117`); this module is their counterpart — the
"binding layer" between a C ABI and the per-rank runtime. The glue is host
marshalling: every buffer crosses it as numpy, and the card enters where
the runtime puts it (a per-rank job binds ``cuda:0`` unless it sets
``mpi_base_device=cpu``; host buffers at or above
``coll_tuned_stage_min_bytes`` ride the staged device tier). Results that
come back as tensors are read to the host (``_host``). Handle
tables mirror the reference's fortran-handle indirection
(`ompi/mpi/fortran/base/` f2c tables): predefined handles are small
fixed ints, dynamically-created objects get monotonically-increasing
slots.

Error contract: glue functions raise :class:`MPIError`; the C shim maps
``exc.error_class`` to the MPI error code and applies the communicator's
errhandler semantics (ERRORS_ARE_FATAL prints + aborts, ERRORS_RETURN
returns the code — `ompi/errhandler/errhandler.h` behavior).
"""
from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ompi_tpu_torch.core import op as op_mod
from ompi_tpu_torch.core.errhandler import (ERR_ARG, ERR_COMM, ERR_GROUP,
                                      ERR_OP, ERR_PENDING, ERR_RANK,
                                      ERR_REQUEST, ERR_TOPOLOGY,
                                      ERR_TYPE, MPIError, error_string)

# ---------------------------------------------------------------------
# handle tables (mpi.h constants must match these values)
# ---------------------------------------------------------------------
COMM_NULL = 0
COMM_WORLD = 1
COMM_SELF = 2
_FIRST_DYNAMIC = 16

_lock = threading.Lock()
_comms: Dict[int, Any] = {}
_requests: Dict[int, Tuple[Any, int, bytes]] = {}
# handle -> (Request, dtype, posted-time buffer snapshot)
_next_comm = itertools.count(_FIRST_DYNAMIC)
_next_req = itertools.count(1)

# mpi.h MPI_Datatype constants -> numpy dtypes
_DT = {
    1: np.dtype(np.int8),      # MPI_CHAR
    2: np.dtype(np.int8),      # MPI_SIGNED_CHAR
    3: np.dtype(np.uint8),     # MPI_UNSIGNED_CHAR
    4: np.dtype(np.uint8),     # MPI_BYTE
    5: np.dtype(np.int16),     # MPI_SHORT
    6: np.dtype(np.uint16),    # MPI_UNSIGNED_SHORT
    7: np.dtype(np.int32),     # MPI_INT
    8: np.dtype(np.uint32),    # MPI_UNSIGNED
    9: np.dtype(np.int64),     # MPI_LONG
    10: np.dtype(np.uint64),   # MPI_UNSIGNED_LONG
    11: np.dtype(np.int64),    # MPI_LONG_LONG
    12: np.dtype(np.uint64),   # MPI_UNSIGNED_LONG_LONG
    13: np.dtype(np.float32),  # MPI_FLOAT
    14: np.dtype(np.float64),  # MPI_DOUBLE
    15: np.dtype(np.bool_),    # MPI_C_BOOL
    16: np.dtype(np.int8),     # MPI_INT8_T
    17: np.dtype(np.int16),    # MPI_INT16_T
    18: np.dtype(np.int32),    # MPI_INT32_T
    19: np.dtype(np.int64),    # MPI_INT64_T
    20: np.dtype(np.uint8),    # MPI_UINT8_T
    21: np.dtype(np.uint16),   # MPI_UINT16_T
    22: np.dtype(np.uint32),   # MPI_UINT32_T
    23: np.dtype(np.uint64),   # MPI_UINT64_T
    24: np.dtype(np.int64),    # MPI_AINT
    25: np.dtype(np.int64),    # MPI_COUNT
    26: np.dtype(np.int64),    # MPI_OFFSET
}

# mpi.h MPI_Op constants -> predefined ops (op.c:73-80 table).
# MPI_REPLACE/MPI_NO_OP (11/12) are accumulate-ONLY pseudo-ops: they
# resolve through _rma_op so collective reductions keep rejecting them
# with MPI_ERR_OP (passing MPI_NO_OP to MPI_Allreduce is erroneous).
_OPS = {
    1: op_mod.SUM, 2: op_mod.PROD, 3: op_mod.MAX, 4: op_mod.MIN,
    5: op_mod.LAND, 6: op_mod.LOR, 7: op_mod.LXOR,
    8: op_mod.BAND, 9: op_mod.BOR, 10: op_mod.BXOR,
}
_RMA_OPS = {11: op_mod.REPLACE, 12: op_mod.NO_OP}
# user-defined ops (MPI_Op_create): handles >= 32, combiner = a real C
# function pointer invoked through ctypes on the HOST reduction tier
_FIRST_DYN_OP = 32
_next_dyn_op = itertools.count(_FIRST_DYN_OP)
_op_ctx = threading.local()              # .dt: in-flight reduction's
#                                          datatype handle


def _handle_for_dtype(d: np.dtype) -> int:
    for h, dt in _DT.items():
        if dt == d:
            return h
    return 0


def op_create_c(fn_ptr: int, commute: int) -> int:
    """MPI_Op_create: wrap a C ``void (*)(void *invec, void *inoutvec,
    int *len, MPI_Datatype *dt)`` as a framework Op. The callback runs
    on the host reduction tier (per-rank textbook algorithms,
    coll/basic, reduce_local) — the tier where the reference's user
    ops run too. A C function pointer reads host memory only: the staged
    tiers (``RankCommunicator._stageable``, ``TunedCollModule``) keep an
    op with a ``_c_callback`` on the host fold, and a
    device tensor that reaches the combiner anyway is an ERR_OP, never a
    pointer into device memory. The host fold hands the combiner numpy
    arrays or CPU tensors (``op.np_combiner`` wraps a user op over
    tensors); it answers in the kind it was given."""
    import ctypes
    cb = ctypes.CFUNCTYPE(
        None, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_long))(fn_ptr)

    def combine(a, b):
        # MPI user-fn contract: inoutvec[i] = invec[i] OP inoutvec[i],
        # so a left fold a OP b passes invec=a, inoutvec=b
        tensors = isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor)
        for t in (a, b):
            if isinstance(t, torch.Tensor) and t.device.type != "cpu":
                raise MPIError(ERR_OP, "a C user op (MPI_Op_create) runs "
                                       "on the host fold; it was handed a "
                                       f"tensor on {t.device}")
        a_arr = np.ascontiguousarray(_host(a))
        b_arr = np.ascontiguousarray(_host(b)).copy()
        if a_arr.dtype != b_arr.dtype:
            a_arr = a_arr.astype(b_arr.dtype)
        ln = ctypes.c_int(int(b_arr.size))
        # the caller's ACTUAL handle (set by the collective entry
        # points): aliased handles (INT64_T vs LONG, BYTE vs
        # UNSIGNED_CHAR) are indistinguishable from the dtype alone
        h = getattr(_op_ctx, "dt", 0) or _handle_for_dtype(b_arr.dtype)
        dth = ctypes.c_long(h)
        cb(a_arr.ctypes.data, b_arr.ctypes.data,
           ctypes.byref(ln), ctypes.byref(dth))
        return torch.from_numpy(b_arr) if tensors else b_arr

    op = op_mod.op_create(combine, commute=bool(commute),
                          name=f"c_user@{fn_ptr:#x}")
    op._c_callback = cb                  # keep the CFUNCTYPE alive
    h = next(_next_dyn_op)
    with _lock:
        _OPS[h] = op
    return h


def op_free(o: int) -> None:
    if o < _FIRST_DYN_OP:
        raise MPIError(ERR_OP, "cannot free a predefined op")
    with _lock:
        if _OPS.pop(o, None) is None:
            raise MPIError(ERR_OP, f"invalid op handle {o}")


def _comm(h: int):
    if h in (COMM_WORLD, COMM_SELF):
        from ompi_tpu_torch.runtime import init as rt
        return rt.comm_world() if h == COMM_WORLD else rt.comm_self()
    with _lock:
        c = _comms.get(h)
    if c is None:
        raise MPIError(ERR_COMM, f"invalid communicator handle {h}")
    return c


def _register_comm(c) -> int:
    with _lock:
        h = next(_next_comm)
        _comms[h] = c
    return h


# ---------------------------------------------------------------------
# derived datatypes (handles >= 64): the convertor role for the C ABI.
#
# The GRANULE model (round-5 lb/extent redesign): a derived type is
# (base, idx, lb, extent) where the granule is one base element when
# ``base`` is a numpy dtype (homogeneous layouts — reducible, gathered
# element-wise) and one BYTE when ``base`` is None (heterogeneous
# structs, byte-strided hvector layouts). ``idx`` holds the granule
# offsets of the significant granules relative to the buffer pointer —
# offsets may be NEGATIVE (negative strides, explicit lb), which the
# old flattened representation rejected. ``lb``/``extent`` are the
# MPI lower bound and extent in granules (Type_create_resized sets
# both; extent may be smaller than the true span — overlapping
# elements are legal). ``idx is None`` is the lazy-contiguous form
# (``contig_n`` granules back to back) so bigcount types never
# materialize gigantic index arrays.
#
# Buffer-window convention with the C shim: for count elements the C
# side passes a memory window starting at buf + window_off(dt) of
# length (count-1)*extent + max(extent, true_span) bytes; positions
# inside the window are k*extent + idx - min_idx. _count_of() inverts
# that length back to the count. Pack gathers the significant
# granules (only they travel, MPI semantics); unpack overlays them
# into the receiver's existing window so gap bytes stay untouched
# (opal convertor contract, opal_convertor.c:83-102).
# ---------------------------------------------------------------------
_FIRST_DYN_TYPE = 64
_dyn_types: Dict[int, "DerivedType"] = {}
_next_dyn_type = itertools.count(_FIRST_DYN_TYPE)


class DerivedType:
    __slots__ = ("base", "idx", "lb", "extent", "contig_n")

    def __init__(self, base: Optional[np.dtype],
                 idx: Optional[np.ndarray], extent: int,
                 lb: Optional[int] = None, contig_n: int = 0):
        self.base = base                 # None => byte granularity
        self.idx = idx                   # None => lazy contiguous
        self.contig_n = contig_n         # granules when idx is None
        self.extent = int(extent)        # granules
        if lb is None:
            lb = 0 if idx is None or idx.size == 0 \
                else min(0, int(idx.min()))
        self.lb = int(lb)

    @property
    def granule(self) -> int:
        return self.base.itemsize if self.base is not None else 1

    @property
    def nsig(self) -> int:               # significant granules
        return self.contig_n if self.idx is None else int(self.idx.size)

    @property
    def min_idx(self) -> int:
        if self.idx is None or self.idx.size == 0:
            return 0
        return int(self.idx.min())

    @property
    def max_ub(self) -> int:             # one past the last granule
        if self.idx is None:
            return self.contig_n
        if self.idx.size == 0:
            return 0
        return int(self.idx.max()) + 1

    @property
    def span(self) -> int:               # true data span in granules
        return self.max_ub - self.min_idx

    def materialized_idx(self) -> np.ndarray:
        if self.idx is not None:
            return self.idx
        return np.arange(self.contig_n, dtype=np.int64)


def _dyn(dt: int) -> DerivedType:
    t = _dyn_types.get(dt)
    if t is None:
        raise MPIError(ERR_TYPE, f"invalid datatype handle {dt}")
    return t


def _as_granular(dt: int):
    """(base-or-None, idx-or-None(contig), contig_n, lb, extent) in the
    GRANULE units of the returned base — the uniform constructor
    input. Basic types are one contiguous granule."""
    if dt >= _FIRST_DYN_TYPE:
        t = _dyn(dt)
        return t.base, t.idx, t.contig_n, t.lb, t.extent
    return _dtype(dt), None, 1, 0, 1


def _register_type(t: DerivedType) -> int:
    h = next(_next_dyn_type)
    _dyn_types[h] = t
    return h


def _type_parts(dt: int):
    """Legacy 3-tuple view for code that predates the granule model:
    (base dtype — uint8 stands in for byte-granular layouts,
    materialized granule idx, extent in granules)."""
    if dt >= _FIRST_DYN_TYPE:
        t = _dyn(dt)
        return (t.base if t.base is not None else np.dtype(np.uint8),
                t.materialized_idx(), t.extent)
    return _dtype(dt), np.array([0], dtype=np.int64), 1


def _compose(old: int, placements: np.ndarray,
             extent_old_units: Optional[int] = None,
             lb: Optional[int] = None) -> DerivedType:
    """Build a DerivedType placing one copy of ``old`` at each GRANULE
    offset in ``placements`` (callers convert their element units to
    granules of old's base before composing)."""
    base, idx, contig_n, _olb, _oext = _as_granular(old)
    if idx is None:
        old_idx = None if contig_n == 1 else np.arange(contig_n,
                                                       dtype=np.int64)
        if old_idx is None:
            new_idx = placements.astype(np.int64, copy=True)
        else:
            new_idx = (placements[:, None] + old_idx[None, :]).ravel()
    else:
        new_idx = (placements[:, None] + idx[None, :]).ravel()
    ext = extent_old_units
    return DerivedType(base, new_idx,
                       ext if ext is not None else
                       (int(new_idx.max()) + 1 if new_idx.size else 0),
                       lb=lb)


def type_contiguous(count: int, oldtype: int) -> int:
    """MPI_Type_contiguous: count copies of oldtype back to back.
    Contiguous-of-contiguous stays LAZY (no index materialization), so
    bigcount types (2^31+ elements, c23_bigcount.c) cost O(1)."""
    if count < 0:
        raise MPIError(ERR_ARG, "negative count")
    base, idx, contig_n, lb, ext = _as_granular(oldtype)
    if idx is None and lb == 0 and ext == contig_n:
        return _register_type(DerivedType(base, None, count * contig_n,
                                          contig_n=count * contig_n))
    placements = np.arange(count, dtype=np.int64) * ext
    t = _compose(oldtype, placements, extent_old_units=count * ext)
    return _register_type(t)


def type_vector(count: int, blocklength: int, stride: int,
                oldtype: int) -> int:
    """MPI_Type_vector: count blocks of blocklength oldtypes, block
    starts stride oldtypes apart. Negative strides are now legal: the
    lb/extent model places elements BEHIND the buffer pointer exactly
    as the reference's (lb = (count-1)*stride, ub past block 0,
    ompi_datatype_add semantics)."""
    if count < 0 or blocklength < 0:
        raise MPIError(ERR_ARG, "negative count/blocklength")
    base, idx, contig_n, _lb, ext = _as_granular(oldtype)
    starts = np.arange(count, dtype=np.int64) * stride * ext
    within = np.arange(blocklength, dtype=np.int64) * ext
    placements = (starts[:, None] + within[None, :]).ravel()
    if count == 0:
        return _register_type(DerivedType(base,
                                          np.array([], np.int64), 0))
    lo = min(0, (count - 1) * stride) * ext
    hi = (max((count - 1) * stride, 0) + blocklength) * ext
    t = _compose(oldtype, placements, extent_old_units=hi - lo, lb=lo)
    return _register_type(t)


def type_create_hvector(count: int, blocklength: int, stride_bytes: int,
                        oldtype: int) -> int:
    """MPI_Type_create_hvector: stride in BYTES. A stride that is not
    a multiple of the base granule degrades the type to byte
    granularity (still exact — just ineligible for reductions)."""
    if count < 0 or blocklength < 0:
        raise MPIError(ERR_ARG, "negative count/blocklength")
    base, idx, contig_n, _lb, ext = _as_granular(oldtype)
    g = base.itemsize if base is not None else 1
    if stride_bytes % g == 0:
        stride = stride_bytes // g
        starts = np.arange(count, dtype=np.int64) * stride
        within = np.arange(blocklength, dtype=np.int64) * ext
        placements = (starts[:, None] + within[None, :]).ravel()
        if count == 0:
            return _register_type(DerivedType(base,
                                              np.array([], np.int64),
                                              0))
        lo = min(0, (count - 1) * stride)
        hi = max((count - 1) * stride, 0) + blocklength * ext
        t = _compose(oldtype, placements, extent_old_units=hi - lo,
                     lb=lo)
        return _register_type(t)
    # byte-granular fallback: expand old significant granules to bytes
    old_b = _to_byte_idx(oldtype)
    starts = np.arange(count, dtype=np.int64) * stride_bytes
    blk = (np.arange(blocklength, dtype=np.int64) * ext * g)
    place_b = (starts[:, None] + blk[None, :]).ravel()
    new_idx = (place_b[:, None] + old_b[None, :]).ravel()
    lo = int(min(0, new_idx.min())) if new_idx.size else 0
    hi = int(new_idx.max()) + 1 if new_idx.size else 0
    return _register_type(DerivedType(None, new_idx, hi - lo, lb=lo))


def _to_byte_idx(dt: int) -> np.ndarray:
    """Significant BYTE offsets of one element (degrade helper)."""
    base, idx, contig_n, _lb, _ext = _as_granular(dt)
    g = base.itemsize if base is not None else 1
    gi = (np.arange(contig_n, dtype=np.int64) if idx is None else idx)
    return (gi[:, None] * g
            + np.arange(g, dtype=np.int64)[None, :]).ravel()


def type_indexed(counts_view, displs_view, oldtype: int) -> int:
    """MPI_Type_indexed: block i has counts[i] oldtypes starting at
    displacement displs[i] (in oldtype extents). Arbitrary (including
    decreasing/negative) displacements are legal under the granule
    model; overlapping significant granules are rejected (the pack
    gather would be ambiguous on unpack)."""
    counts, displs = _ints(counts_view), _ints(displs_view)
    base, idx, contig_n, _lb, ext = _as_granular(oldtype)
    blocks = []
    for c, d in zip(counts, displs):
        c, d = int(c), int(d)
        if c < 0:
            raise MPIError(ERR_ARG, "negative block count")
        if c:
            blocks.append(np.arange(d * ext, (d + c) * ext - ext + 1,
                                    ext, dtype=np.int64))
    placements = (np.concatenate(blocks) if blocks
                  else np.array([], np.int64))
    _check_no_overlap(oldtype, placements)
    if placements.size == 0:
        return _register_type(DerivedType(base, np.array([], np.int64),
                                          0))
    lo = min(0, int(placements.min()))
    hi = int(placements.max()) + ext
    t = _compose(oldtype, placements, extent_old_units=hi - lo, lb=lo)
    return _register_type(t)


def _check_no_overlap(oldtype: int, placements: np.ndarray) -> None:
    base, idx, contig_n, _lb, ext = _as_granular(oldtype)
    nsig = contig_n if idx is None else idx.size
    if placements.size and nsig:
        # distinct placements of the same pattern overlap iff any two
        # placements are closer than the pattern allows; exact check
        # via the composed index set
        test = (placements[:, None]
                + (np.arange(contig_n, dtype=np.int64)
                   if idx is None else idx)[None, :]).ravel()
        if np.unique(test).size != test.size:
            raise MPIError(ERR_ARG, "overlapping indexed blocks "
                                    "unsupported")


def type_create_hindexed(counts_view, bdispls_view,
                         oldtype: int) -> int:
    """MPI_Type_create_hindexed: displacements in BYTES."""
    counts = _ints(counts_view)
    bdispls = np.frombuffer(bytes(bdispls_view), dtype=np.int64)
    base, idx, contig_n, _lb, ext = _as_granular(oldtype)
    g = base.itemsize if base is not None else 1
    if all(int(d) % g == 0 for d in bdispls):
        blocks = []
        for c, db in zip(counts, bdispls):
            c, d = int(c), int(db) // g
            if c < 0:
                raise MPIError(ERR_ARG, "negative block count")
            if c:
                blocks.append(d + np.arange(c, dtype=np.int64) * ext)
        placements = (np.concatenate(blocks) if blocks
                      else np.array([], np.int64))
        _check_no_overlap(oldtype, placements)
        if placements.size == 0:
            return _register_type(DerivedType(base,
                                              np.array([], np.int64),
                                              0))
        lo = min(0, int(placements.min()))
        hi = int(placements.max()) + ext
        t = _compose(oldtype, placements, extent_old_units=hi - lo,
                     lb=lo)
        return _register_type(t)
    # misaligned byte displacements: byte-granular type
    old_b = _to_byte_idx(oldtype)
    pieces = []
    for c, db in zip(counts, bdispls):
        c, db = int(c), int(db)
        for k in range(c):
            pieces.append(db + k * ext * g + old_b)
    new_idx = (np.concatenate(pieces) if pieces
               else np.array([], np.int64))
    if np.unique(new_idx).size != new_idx.size:
        raise MPIError(ERR_ARG, "overlapping hindexed blocks")
    lo = int(min(0, new_idx.min())) if new_idx.size else 0
    hi = int(new_idx.max()) + 1 if new_idx.size else 0
    return _register_type(DerivedType(None, new_idx, hi - lo, lb=lo))


def type_create_hindexed_block(blocklength: int, bdispls_view,
                               oldtype: int) -> int:
    """MPI_Type_create_hindexed_block: uniform blocklength, byte
    displacements."""
    bdispls = np.frombuffer(bytes(bdispls_view), dtype=np.int64)
    counts = np.full(len(bdispls), int(blocklength), np.intc)
    return type_create_hindexed(counts.tobytes(), bytes(bdispls_view),
                                oldtype)


def type_create_indexed_block(blocklength: int, displs_view,
                              oldtype: int) -> int:
    """MPI_Type_create_indexed_block: uniform blocklength."""
    displs = _ints(displs_view)
    counts = np.full(len(displs), int(blocklength), np.intc)
    return type_indexed(counts.tobytes(), bytes(displs_view), oldtype)


def type_create_struct(counts_view, bdispls_view,
                       types_view) -> int:
    """MPI_Type_create_struct: per-block types AND byte displacements.
    Homogeneous structs (every block the same base granule, aligned)
    keep element granularity; mixed-base structs become byte-granular
    (exact layout; reductions reject them, as the standard only
    defines reductions on basic types)."""
    counts = _ints(counts_view)
    bdispls = np.frombuffer(bytes(bdispls_view), dtype=np.int64)
    types = np.frombuffer(bytes(types_view), dtype=np.int64)
    if not (len(counts) == len(bdispls) == len(types)):
        raise MPIError(ERR_ARG, "struct arrays disagree on length")
    bases = set()
    for dt in types:
        b, _i, _c, _l, _e = _as_granular(int(dt))
        bases.add(b)
    if len(bases) == 1 and None not in bases:
        b = next(iter(bases))
        g = b.itemsize
        if all(int(d) % g == 0 for d in bdispls):
            # homogeneous + aligned: granule = base element
            pieces = []
            for c, db, dt in zip(counts, bdispls, types):
                c, d = int(c), int(db) // g
                _b, idx, contig_n, _l, ext = _as_granular(int(dt))
                gi = (np.arange(contig_n, dtype=np.int64)
                      if idx is None else idx)
                for k in range(c):
                    pieces.append(d + k * ext + gi)
            new_idx = (np.concatenate(pieces) if pieces
                       else np.array([], np.int64))
            if np.unique(new_idx).size != new_idx.size:
                raise MPIError(ERR_ARG, "overlapping struct blocks")
            lo = int(min(0, new_idx.min())) if new_idx.size else 0
            hi = int(new_idx.max()) + 1 if new_idx.size else 0
            return _register_type(DerivedType(b, new_idx, hi - lo,
                                              lb=lo))
    # heterogeneous: byte-granular
    pieces = []
    for c, db, dt in zip(counts, bdispls, types):
        c, db, dt = int(c), int(db), int(dt)
        old_b = _to_byte_idx(dt)
        _bb, _i, _cn, _l, ext = _as_granular(dt)
        g = _bb.itemsize if _bb is not None else 1
        for k in range(c):
            pieces.append(db + k * ext * g + old_b)
    new_idx = (np.concatenate(pieces) if pieces
               else np.array([], np.int64))
    if np.unique(new_idx).size != new_idx.size:
        raise MPIError(ERR_ARG, "overlapping struct blocks")
    lo = int(min(0, new_idx.min())) if new_idx.size else 0
    hi = int(new_idx.max()) + 1 if new_idx.size else 0
    return _register_type(DerivedType(None, new_idx, hi - lo, lb=lo))


def type_create_subarray(sizes_view, subsizes_view, starts_view,
                         order: int, oldtype: int) -> int:
    """MPI_Type_create_subarray: an n-D block of an n-D array. The
    significant granules are the block's positions in the FULL array
    (extent = whole array) — exactly the flat-index model."""
    sizes = [int(x) for x in _ints(sizes_view)]
    subs = [int(x) for x in _ints(subsizes_view)]
    starts = [int(x) for x in _ints(starts_view)]
    if not (len(sizes) == len(subs) == len(starts)):
        raise MPIError(ERR_ARG, "subarray dims disagree")
    for g_, s_, st_ in zip(sizes, subs, starts):
        if s_ < 0 or st_ < 0 or st_ + s_ > g_:
            raise MPIError(ERR_ARG, "subarray block out of range")
    base, idx, contig_n, _lb, ext = _as_granular(oldtype)
    # element offsets of the block within the full array, in units of
    # oldtype elements, honoring C vs Fortran order
    dims = sizes if order == 0 else list(reversed(sizes))
    subd = subs if order == 0 else list(reversed(subs))
    std = starts if order == 0 else list(reversed(starts))
    grids = np.meshgrid(*[np.arange(st_, st_ + s_, dtype=np.int64)
                          for st_, s_ in zip(std, subd)],
                        indexing="ij")
    flat = np.zeros_like(grids[0])
    stride = 1
    for d in range(len(dims) - 1, -1, -1):
        flat = flat + grids[d] * stride
        stride *= dims[d]
    placements = np.sort(flat.ravel()) * ext
    total = int(np.prod(sizes, dtype=np.int64)) * ext
    t = _compose(oldtype, placements, extent_old_units=total, lb=0)
    return _register_type(t)


# HPF distribution constants (mpi.h MPI_DISTRIBUTE_*)
_DIST_BLOCK, _DIST_CYCLIC, _DIST_NONE = 0, 1, 2
_DIST_DFLT_DARG = -49767


def type_create_darray(gsize: int, grank: int, gsizes_view,
                       distribs_view, dargs_view, psizes_view,
                       order: int, oldtype: int) -> int:
    """MPI_Type_create_darray: the HPF block/cyclic decomposition of a
    global array — the significant granules are exactly the calling
    rank's shard of the global index space, the same sharding math the
    framework's mesh layer does (reference:
    ompi/datatype/ompi_datatype_create_darray.c)."""
    gsizes = [int(x) for x in _ints(gsizes_view)]
    distribs = [int(x) for x in _ints(distribs_view)]
    dargs = [int(x) for x in _ints(dargs_view)]
    psizes = [int(x) for x in _ints(psizes_view)]
    ndims = len(gsizes)
    if not (len(distribs) == len(dargs) == len(psizes) == ndims):
        raise MPIError(ERR_ARG, "darray dims disagree")
    if int(np.prod(psizes, dtype=np.int64)) != gsize:
        raise MPIError(ERR_ARG, "psizes do not multiply to size")
    # process-grid coordinates: rank decomposed ROW-MAJOR over psizes
    # (MPI-3.1 15.4.2.2: always C order for the grid)
    coords = []
    rem = grank
    for p in reversed(psizes):
        coords.append(rem % p)
        rem //= p
    coords.reverse()
    per_dim = []
    for g_, d_, a_, p_, c_ in zip(gsizes, distribs, dargs, psizes,
                                  coords):
        if d_ == _DIST_NONE:
            if p_ != 1:
                raise MPIError(ERR_ARG,
                               "DISTRIBUTE_NONE needs psize 1")
            per_dim.append(np.arange(g_, dtype=np.int64))
        elif d_ == _DIST_BLOCK:
            b = ((g_ + p_ - 1) // p_ if a_ == _DIST_DFLT_DARG
                 else a_)
            if b * p_ < g_:
                raise MPIError(ERR_ARG, "block darg too small")
            lo = min(c_ * b, g_)
            hi = min(lo + b, g_)
            per_dim.append(np.arange(lo, hi, dtype=np.int64))
        elif d_ == _DIST_CYCLIC:
            k = 1 if a_ == _DIST_DFLT_DARG else a_
            j = np.arange(g_, dtype=np.int64)
            per_dim.append(j[(j // k) % p_ == c_])
        else:
            raise MPIError(ERR_ARG, f"bad distribution {d_}")
    base, idx, contig_n, _lb, ext = _as_granular(oldtype)
    dims = gsizes if order == 0 else list(reversed(gsizes))
    pdim = per_dim if order == 0 else list(reversed(per_dim))
    grids = np.meshgrid(*pdim, indexing="ij")
    flat = np.zeros_like(grids[0]) if grids else np.zeros(
        (), np.int64)
    stride = 1
    for d in range(len(dims) - 1, -1, -1):
        flat = flat + grids[d] * stride
        stride *= dims[d]
    placements = np.sort(flat.ravel()) * ext
    total = int(np.prod(gsizes, dtype=np.int64)) * ext
    t = _compose(oldtype, placements, extent_old_units=total, lb=0)
    return _register_type(t)


def type_dup(dt: int) -> int:
    """MPI_Type_dup; cached attributes propagate through their
    copy_fn (veto/transform, the comm-dup contract)."""
    t = _dyn(dt) if dt >= _FIRST_DYN_TYPE else None
    if t is None:
        base, idx, contig_n, lb, ext = _as_granular(dt)
        new = _register_type(DerivedType(base, None, ext,
                                         contig_n=contig_n))
    else:
        new = _register_type(DerivedType(
            t.base, None if t.idx is None else np.array(t.idx),
            t.extent, lb=t.lb, contig_n=t.contig_n))
    _obj_attrs_dup("type", dt, new)
    return new


def type_create_resized(oldtype: int, lb_bytes: int,
                        extent_bytes: int) -> int:
    """MPI_Type_create_resized: set lb and extent, in BYTES. Any lb
    (including negative) and any positive extent (including smaller
    than the true span — overlapping elements) are now representable."""
    base, idx, contig_n, _lb, _ext = _as_granular(oldtype)
    g = base.itemsize if base is not None else 1
    if lb_bytes % g or extent_bytes % g:
        # keep the layout exact by degrading to byte granularity
        bidx = _to_byte_idx(oldtype)
        return _register_type(DerivedType(None, bidx, int(extent_bytes),
                                          lb=int(lb_bytes)))
    if extent_bytes <= 0:
        raise MPIError(ERR_ARG, "extent must be positive")
    new_idx = (np.arange(contig_n, dtype=np.int64) if idx is None
               else np.array(idx))
    return _register_type(DerivedType(base, new_idx,
                                      extent_bytes // g,
                                      lb=lb_bytes // g))


# ---- constructor envelopes (MPI_Type_get_envelope/get_contents:
# type_get_envelope.c.in — tools reconstruct how a type was built) ----
_type_env: Dict[int, Tuple[int, list, list, list]] = {}
COMBINER_NAMED = 1

def _record_env_wrappers() -> None:
    """Wrap every public constructor so the (combiner, ints, aints,
    types) envelope is recorded without touching the constructor
    bodies; nested construction (indexed_block -> indexed) records the
    OUTERMOST call, matching the standard's user-visible combiner."""
    def ilist(v):
        return [int(x) for x in _ints(v)]

    def alist(v):
        return [int(x) for x in np.frombuffer(bytes(v), np.int64)]

    specs = {
        "type_contiguous": (3, lambda c, o: ([c], [], [o])),
        "type_vector": (4, lambda c, b, s, o: ([c, b, s], [], [o])),
        "type_create_hvector":
            (5, lambda c, b, s, o: ([c, b], [int(s)], [o])),
        "type_indexed":
            (6, lambda cv, dv, o:
             ([len(ilist(cv))] + ilist(cv) + ilist(dv), [], [o])),
        "type_create_hindexed":
            (7, lambda cv, dv, o:
             ([len(ilist(cv))] + ilist(cv), alist(dv), [o])),
        "type_create_indexed_block":
            (8, lambda b, dv, o:
             ([len(ilist(dv)), b] + ilist(dv), [], [o])),
        "type_create_hindexed_block":
            (9, lambda b, dv, o:
             ([len(alist(dv)), b], alist(dv), [o])),
        "type_create_struct":
            (10, lambda cv, dv, tv:
             ([len(ilist(cv))] + ilist(cv), alist(dv), alist(tv))),
        "type_create_subarray":
            (11, lambda sz, sb, st, order, o:
             ([len(ilist(sz))] + ilist(sz) + ilist(sb) + ilist(st)
              + [order], [], [o])),
        "type_create_darray":
            (12, lambda size, rank, g, d, a, p, order, o:
             ([size, rank, len(ilist(g))] + ilist(g) + ilist(d)
              + ilist(a) + ilist(p) + [order], [], [o])),
        "type_dup": (2, lambda o: ([], [], [o])),
        "type_create_resized":
            (13, lambda o, lb, ext: ([], [int(lb), int(ext)], [o])),
    }

    def wrap(fname, combiner, sig):
        orig = globals()[fname]

        def wrapped(*args, __orig=orig, __comb=combiner, __sig=sig):
            h = __orig(*args)
            try:
                ints, aints, types = __sig(*args)
                _type_env[h] = (__comb, [int(x) for x in ints],
                                [int(x) for x in aints],
                                [int(x) for x in types])
            except Exception:            # noqa: BLE001 — envelope is
                pass                     # advisory metadata
            return h
        wrapped.__name__ = fname
        globals()[fname] = wrapped

    for fname, (comb, sig) in specs.items():
        wrap(fname, comb, sig)


def type_get_envelope(dt: int) -> Tuple[int, int, int, int]:
    """(num_integers, num_addresses, num_datatypes, combiner)."""
    if dt < _FIRST_DYN_TYPE:
        _dtype(dt)
        return 0, 0, 0, COMBINER_NAMED
    _dyn(dt)
    env = _type_env.get(int(dt))
    if env is None:                      # registered by internal paths
        return 0, 0, 0, COMBINER_NAMED
    comb, ints, aints, types = env
    return len(ints), len(aints), len(types), comb


def type_get_contents(dt: int) -> Tuple[bytes, bytes, bytes]:
    """(int32 array, int64 address array, int64 type-handle array) —
    erroneous on NAMED types per the standard."""
    ni, na, nt, comb = type_get_envelope(dt)
    if comb == COMBINER_NAMED:
        raise MPIError(ERR_TYPE,
                       "get_contents on a named/unknown-envelope type")
    _comb, ints, aints, types = _type_env[int(dt)]
    return (np.asarray(ints, np.int32).tobytes(),
            np.asarray(aints, np.int64).tobytes(),
            np.asarray(types, np.int64).tobytes())


def type_base_bytes(dt: int) -> int:
    """Base-element size (MPI_Get_elements units); 1 for byte-granular
    heterogeneous layouts."""
    if dt >= _FIRST_DYN_TYPE:
        return _dyn(dt).granule
    return int(_dtype(dt).itemsize)


def op_commutative(o: int) -> int:
    return int(_rma_op(o).commute)


def type_commit(dt: int) -> None:
    if dt >= _FIRST_DYN_TYPE:
        _dyn(dt)                         # validates the handle
    else:
        _dtype(dt)


def type_free(dt: int) -> None:
    if _dyn_types.pop(dt, None) is None:  # atomic: double-free raises
        raise MPIError(ERR_TYPE, f"invalid datatype handle {dt}")
    _obj_attrs_free("type", dt)          # attr delete_fns fire
    _type_env.pop(int(dt), None)
    _type_names.pop(int(dt), None)


def type_extent_bytes(dt: int) -> int:
    """MPI extent of ONE element, in bytes (MPI_Type_get_extent)."""
    if dt >= _FIRST_DYN_TYPE:
        t = _dyn(dt)
        return t.extent * t.granule
    return int(_dtype(dt).itemsize)


def type_lb_bytes(dt: int) -> int:
    """MPI lower bound, in bytes (can be negative)."""
    if dt >= _FIRST_DYN_TYPE:
        t = _dyn(dt)
        return t.lb * t.granule
    return 0


def type_true_lb_bytes(dt: int) -> int:
    """True lower bound: offset of the first significant granule."""
    if dt >= _FIRST_DYN_TYPE:
        t = _dyn(dt)
        return t.min_idx * t.granule
    return 0


def type_true_span_bytes(dt: int) -> int:
    """True extent: bytes from the first to one past the last
    significant granule (MPI_Type_get_true_extent's extent)."""
    if dt >= _FIRST_DYN_TYPE:
        t = _dyn(dt)
        return t.span * t.granule
    return int(_dtype(dt).itemsize)


def type_window_off_bytes(dt: int) -> int:
    """Byte offset (<= 0) the C side adds to the buffer pointer to
    form the marshalling window (covers negative displacements)."""
    return type_true_lb_bytes(dt)


def type_size_bytes(dt: int) -> int:
    """Significant bytes of ONE element (MPI_Type_size /
    MPI_Get_count units)."""
    if dt >= _FIRST_DYN_TYPE:
        t = _dyn(dt)
        return t.nsig * t.granule
    return int(_dtype(dt).itemsize)


_idx_cache: Dict[Tuple[int, int], np.ndarray] = {}


def _win_idx(dt: int, count: int) -> Optional[np.ndarray]:
    """Significant-granule positions of ``count`` elements RELATIVE TO
    the marshalling window start (buf + min_idx); None for contiguous
    layouts (a slice suffices). Cached — dynamic handles are never
    recycled (monotonic counter), so (dt, count) keys cannot go
    stale."""
    t = _dyn(dt)
    if t.idx is None and t.extent == t.contig_n:
        return None                      # pure contiguous
    key = (dt, count)
    got = _idx_cache.get(key)
    if got is None:
        idx = t.materialized_idx()
        got = ((np.arange(count, dtype=np.int64)[:, None] * t.extent
                + idx).ravel() - t.min_idx) if count else \
            np.array([], dtype=np.int64)
        if len(_idx_cache) < 4096:
            _idx_cache[key] = got
    return got


def _pack(view, dt: int, count: int) -> np.ndarray:
    """Gather the significant granules of ``count`` type elements from
    the marshalling window."""
    if dt < _FIRST_DYN_TYPE:
        return np.frombuffer(view, dtype=_dtype(dt)).copy()
    t = _dyn(dt)
    a = np.frombuffer(view, dtype=t.base if t.base is not None
                      else np.uint8)
    wi = _win_idx(dt, count)
    if wi is None:
        return a[:count * t.contig_n].copy()
    return a[wi].copy()


def _unpack(data, dt: int, count: int,
            curbytes: bytes) -> Tuple[bytes, int]:
    """Overlay received significant granules into the receiver's
    current window content; gaps keep their bytes. Returns
    (window image, truncated flag) — a message larger than the posted
    type signature is MPI_ERR_TRUNCATE even though the C-side cap
    check only sees the (fixed-size) buffer image."""
    if dt < _FIRST_DYN_TYPE:
        base = _dtype(dt)
        flat = _host(data).ravel()
        if flat.dtype != base:
            flat = flat.view(base) if flat.dtype.itemsize == 1 \
                and flat.size and flat.size % base.itemsize == 0 \
                else flat.astype(base)
        return flat.tobytes(), 0
    t = _dyn(dt)
    base = t.base if t.base is not None else np.uint8
    flat = _host(data).ravel()
    if flat.dtype != base:
        # byte-granular types receive raw byte streams; element types
        # coerce (the wire carries the base dtype already)
        flat = flat.view(np.uint8) if t.base is None else \
            flat.astype(base)
    wi = _win_idx(dt, count)
    if wi is None:
        need = count * t.contig_n
        cur = np.frombuffer(curbytes, dtype=base).copy()
        n = min(flat.size, need)
        cur[:n] = flat[:n]
        return cur.tobytes(), int(flat.size > need)
    cur = np.frombuffer(curbytes, dtype=base).copy()
    n = min(flat.size, wi.size)
    cur[wi[:n]] = flat[:n]
    return cur.tobytes(), int(flat.size > wi.size)


def _dtype(dt: int) -> np.dtype:
    d = _DT.get(dt)
    if d is None:
        raise MPIError(ERR_TYPE, f"invalid datatype handle {dt}")
    return d


def _op(o: int) -> op_mod.Op:
    p = _OPS.get(o)
    if p is None:
        raise MPIError(ERR_OP, f"invalid op handle {o}")
    return p


def _rma_op(o: int) -> op_mod.Op:
    """Accumulate-path op lookup: the regular table PLUS the RMA-only
    pseudo-ops (MPI_REPLACE/MPI_NO_OP, accumulate semantics in
    ompi/op/op.c) which collective reductions must keep rejecting."""
    p = _OPS.get(o) or _RMA_OPS.get(o)
    if p is None:
        raise MPIError(ERR_OP, f"invalid op handle {o}")
    return p


def _host(x: Any) -> np.ndarray:
    """A result as a host numpy array: tensors (on any device) are read
    back with one ``.cpu()`` copy; everything else goes through
    ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _arr(view, dt: int) -> np.ndarray:
    """Copy a C buffer into a numpy array of the handle's dtype."""
    return np.frombuffer(view, dtype=_dtype(dt)).copy()


def _out(x: Any, dt: int) -> bytes:
    """Result -> raw bytes in the receiver's declared dtype."""
    a = _host(x)
    d = _dtype(dt)
    if a.dtype != d:
        a = a.astype(d)
    return a.tobytes()


def _status(st, payload: Optional[bytes] = None) -> Tuple[int, int, int]:
    """(source, tag, nbytes) — counts cross the ABI in BYTES; the C
    side's MPI_Get_count divides by the caller datatype's extent (the
    status->_ucount convention)."""
    if st is None:
        return (-1, -1, 0)
    nb = int(getattr(st, "nbytes", -1))
    if nb < 0:
        nb = len(payload) if payload is not None else int(st.count)
    return (int(st.source), int(st.tag), nb)


# ---------------------------------------------------------------------
# world lifecycle
# ---------------------------------------------------------------------
def init(required: int) -> int:
    """MPI_Init / MPI_Init_thread from a C main(): same env-driven
    bring-up the Python per-rank programs get (mpirun --per-rank sets
    OMPI_TPU_TORCH_MCA_* + the store address): each rank binds
    ``cuda:0`` unless the job sets ``mpi_base_device=cpu``, and a rank
    with no card and no such setting fails here (``_bind_device``)."""
    from ompi_tpu_torch.runtime import init as rt
    return rt.init(required)


def finalize() -> None:
    from ompi_tpu_torch.runtime import init as rt
    rt.finalize()


def initialized() -> int:
    from ompi_tpu_torch.runtime import init as rt
    return int(rt.initialized())


def finalized() -> int:
    from ompi_tpu_torch.runtime import init as rt
    return int(rt.finalized())


def abort(h: int, code: int) -> None:
    import os
    import sys
    sys.stderr.write(f"MPI_Abort: rank aborting with code {code}\n")
    sys.stderr.flush()
    os._exit(code if 0 < code < 256 else 1)


def error_str(code: int) -> str:
    # dynamic strings (MPI_Add_error_string) win over the predefined
    # table; unknown dynamic codes fall through to the generic text
    s = _err_strings.get(int(code))
    return s if s is not None else error_string(code)


def processor_name() -> str:
    import socket
    return socket.gethostname()


# ---------------------------------------------------------------------
# communicator queries / algebra
# ---------------------------------------------------------------------
def comm_rank(h: int) -> int:
    return int(_comm(h).rank())


def comm_size(h: int) -> int:
    return int(_comm(h).size)


def comm_dup(h: int) -> int:
    return _register_comm(_comm(h).dup())


def comm_split(h: int, color: int, key: int) -> int:
    sub = _comm(h).split(color, key)
    if sub is None:                      # MPI_UNDEFINED color
        return COMM_NULL
    return _register_comm(sub)


# ---------------------------------------------------------------------
# groups (ompi/group algebra through the handle table)
# ---------------------------------------------------------------------
GROUP_NULL = 0
GROUP_EMPTY = 1
_FIRST_DYN_GROUP = 16
_groups: Dict[int, Any] = {}
_next_group = itertools.count(_FIRST_DYN_GROUP)


def _group(gh: int):
    if gh == GROUP_EMPTY:
        from ompi_tpu_torch.core.group import Group
        return Group([])
    with _lock:
        g = _groups.get(gh)
    if g is None:
        raise MPIError(ERR_ARG, f"invalid group handle {gh}")
    return g


def _register_group(g) -> int:
    with _lock:
        gh = next(_next_group)
        _groups[gh] = g
    return gh


def _my_world_rank() -> int:
    from ompi_tpu_torch.runtime import init as rt
    w = rt.comm_world()
    return w.world_rank_of(w.rank())


def comm_group(h: int) -> int:
    return _register_group(_comm(h).group)


def group_size(gh: int) -> int:
    return int(_group(gh).size)


def group_rank(gh: int) -> int:
    """Calling process's rank in the group (MPI_UNDEFINED = -32766 if
    not a member, matching mpi.h)."""
    return int(_group(gh).rank_of(_my_world_rank()))


def group_incl(gh: int, ranks_view) -> int:
    return _register_group(
        _group(gh).incl([int(r) for r in _ints(ranks_view)]))


def group_excl(gh: int, ranks_view) -> int:
    return _register_group(
        _group(gh).excl([int(r) for r in _ints(ranks_view)]))


def group_union(a: int, b: int) -> int:
    return _register_group(_group(a).union(_group(b)))


def group_intersection(a: int, b: int) -> int:
    return _register_group(_group(a).intersection(_group(b)))


def group_difference(a: int, b: int) -> int:
    return _register_group(_group(a).difference(_group(b)))


def group_free(gh: int) -> int:
    """Returns GROUP_NULL (the C shim parses an int result)."""
    if gh != GROUP_EMPTY:
        with _lock:
            if _groups.pop(gh, None) is None:
                raise MPIError(ERR_ARG, f"invalid group handle {gh}")
    return GROUP_NULL


def comm_create(h: int, gh: int) -> int:
    """MPI_Comm_create: collective; non-members get COMM_NULL."""
    sub = _comm(h).create(_group(gh))
    if sub is None:
        return COMM_NULL
    return _register_comm(sub)


def cart_create(h: int, dims_view, periods_view, reorder: int) -> int:
    """MPI_Cart_create: dims/periods arrive as C int arrays; callers
    beyond the cart size get COMM_NULL."""
    dims = [int(d) for d in _ints(dims_view)]
    periods = [bool(p) for p in _ints(periods_view)]
    sub = _comm(h).create_cart(dims, periods, bool(reorder))
    if sub is None:
        return COMM_NULL
    return _register_comm(sub)


def cart_coords(h: int, rank: int) -> bytes:
    """Coordinates of ``rank`` as C ints (explicit rank works on both
    communicator flavors)."""
    return np.asarray(_comm(h).cart_coords(rank),
                      dtype=np.intc).tobytes()


def cart_rank(h: int, coords_view) -> int:
    return int(_comm(h).cart_rank([int(c) for c in _ints(coords_view)]))


def cart_shift(h: int, direction: int, disp: int) -> Tuple[int, int]:
    c = _comm(h)
    if getattr(c, "is_per_rank", False):  # implicit self-rank variant
        src, dst = c.cart_shift(direction, disp)
    else:                                 # single-controller signature
        src, dst = c.cart_shift(c.rank(), direction, disp)
    return int(src), int(dst)


def cart_get(h: int) -> Tuple[bytes, bytes, bytes]:
    """(dims, periods, my coords) as C int arrays (MPI_Cart_get)."""
    c = _comm(h)
    cart = c._cart()
    dims = np.asarray(cart.dims, dtype=np.intc)
    periods = np.asarray([int(p) for p in cart.periods], dtype=np.intc)
    coords = np.asarray(c.cart_coords(c.rank()), dtype=np.intc)
    return dims.tobytes(), periods.tobytes(), coords.tobytes()


def neighbor_count(h: int) -> int:
    """IN-neighbor slot count (receive side of neighbor colls)."""
    c = _comm(h)
    if c.topo is None:
        raise MPIError(ERR_TOPOLOGY, "no topology attached")
    return len(list(c.topo.neighbors(c.rank())))


def neighbor_out_count(h: int) -> int:
    """OUT-neighbor slot count (send side); equals neighbor_count on
    undirected topologies."""
    c = _comm(h)
    t = c.topo
    if t is None:
        raise MPIError(ERR_TOPOLOGY, "no topology attached")
    r = c.rank()
    if hasattr(t, "out_neighbors"):
        return len(list(t.out_neighbors(r)))
    return len(list(t.neighbors(r)))


def _overlay_rows(rows, rdt: int, curview) -> bytes:
    """Uniform per-slot overlay in topology-neighbor order; None slots
    (PROC_NULL neighbors on non-periodic edges) keep the caller's
    bytes (MPI leaves them undefined/untouched)."""
    cur = np.frombuffer(curview, _dtype(rdt)).copy()
    per = len(cur) // max(len(rows), 1)
    for i, row in enumerate(rows):
        if row is None:
            continue
        seg = _host(row).ravel()[:per]
        if seg.dtype != cur.dtype:
            seg = seg.astype(cur.dtype)
        cur[i * per:i * per + seg.size] = seg
    return cur.tobytes()


def neighbor_allgather(h: int, view, sdt: int, rdt: int,
                       curview) -> bytes:
    c = _comm(h)
    rows = c.neighbor_allgather(_pack(view, sdt,
                                      _count_of(view, sdt)))
    return _overlay_rows(rows, rdt, curview)


def neighbor_alltoall(h: int, view, sdt: int, percount: int, rdt: int,
                      curview) -> bytes:
    c = _comm(h)
    # directed topologies (dist graph): the SEND buffer holds one
    # chunk per OUT-neighbor; receives fill one slot per IN-neighbor
    n = neighbor_out_count(h)
    a = _pack(view, sdt, _count_of(view, sdt))
    # chunk size in SIGNIFICANT base elements: percount counts send
    # units, and a derived unit packs idx.size elements (slicing by
    # percount alone would mis-split derived payloads)
    _, idx, _ = _type_parts(sdt)
    per = percount * int(idx.size)
    # one chunk per neighbor SLOT (zero-count collectives must still
    # contribute an empty chunk per slot, not zero chunks)
    chunks = [a[i * per:(i + 1) * per] for i in range(n)]
    rows = c.neighbor_alltoall(chunks)
    return _overlay_rows(rows, rdt, curview)


def comm_get_name(h: int) -> str:
    return _comm(h).get_name()


def comm_set_name(h: int, name: str) -> None:
    _comm(h).set_name(name)


def comm_test_inter(h: int) -> int:
    c = _comm(h)
    return int(getattr(c, "remote_group", None) is not None
               or getattr(c, "remote_size", None) is not None)


def comm_remote_size(h: int) -> int:
    c = _comm(h)
    rs = getattr(c, "remote_size", None)
    if rs is None:
        rg = getattr(c, "remote_group", None)
        if rg is None:
            raise MPIError(ERR_COMM, "not an intercommunicator")
        rs = rg.size
    return int(rs)


# ---------------------------------------------------------------------
# MPI-4 Sessions (session_init.c.in family; runtime/session.Session)
# ---------------------------------------------------------------------
_sessions: Dict[int, Any] = {}
_next_session = itertools.count(1)
_session_groups: Dict[int, int] = {}     # group handle -> session


def _session(sh: int):
    with _lock:
        s = _sessions.get(sh)
    if s is None:
        raise MPIError(ERR_ARG, f"invalid session handle {sh}")
    return s


def session_init(errh: int) -> int:
    from ompi_tpu_torch.core import errhandler as eh
    from ompi_tpu_torch.runtime.session import Session
    handler = eh.ERRORS_RETURN if errh == 2 else eh.ERRORS_ARE_FATAL
    s = Session(errhandler=handler)
    with _lock:
        sh = next(_next_session)
        _sessions[sh] = s
    return sh


def session_finalize(sh: int) -> None:
    with _lock:
        s = _sessions.pop(sh, None)
    if s is None:
        raise MPIError(ERR_ARG, f"invalid session handle {sh}")
    s.finalize()


def session_get_num_psets(sh: int) -> int:
    return _session(sh).get_num_psets()


def session_get_nth_pset(sh: int, n: int) -> str:
    return _session(sh).get_nth_pset(int(n))


def group_from_session_pset(sh: int, name: str) -> int:
    gh = _register_group(_session(sh).group_from_pset(name))
    _session_groups[gh] = sh
    return gh


def comm_create_from_group(gh: int, tag: str) -> int:
    """MPI_Comm_create_from_group: the group must come from a session
    pset (Group_from_session_pset) so the instance linkage exists —
    the reference resolves the instance from the group the same way."""
    sh = _session_groups.get(gh)
    if sh is None:
        raise MPIError(ERR_ARG,
                       "group is not derived from a session pset")
    c = _session(sh).comm_create_from_group(_group(gh), tag)
    return COMM_NULL if c is None else _register_comm(c)


# ---------------------------------------------------------------------
# dynamic process management (dpm: ports + cross-job connect/accept)
# ---------------------------------------------------------------------
def _dpm_mod(h: int):
    c = _comm(h)
    if getattr(c, "is_per_rank", False):
        from ompi_tpu_torch.core import dpm_perrank as m
        return m
    from ompi_tpu_torch.core import dpm as m
    return m


def dpm_open_port(h: int) -> str:
    return _dpm_mod(h).open_port()


def dpm_close_port(h: int, name: str) -> None:
    _dpm_mod(h).close_port(name)


def dpm_comm_accept(port: str, h: int, root: int) -> int:
    c, m = _comm(h), _dpm_mod(h)
    if hasattr(m, "comm_accept"):        # per-rank bridge (p18 model)
        return _register_comm(m.comm_accept(port, c, root))
    return _register_comm(m.accept(port, c))


def dpm_comm_connect(port: str, h: int, root: int) -> int:
    c, m = _comm(h), _dpm_mod(h)
    if hasattr(m, "comm_connect"):
        return _register_comm(m.comm_connect(port, c, root))
    return _register_comm(m.connect(port, c))


def comm_disconnect(h: int) -> None:
    c = _claim_teardown(_comms, h, h)
    if c is None:
        raise MPIError(ERR_COMM, f"invalid communicator handle {h}")
    try:
        _icoll_worker_shutdown(h)        # drain BEFORE disconnect
        if hasattr(c, "disconnect"):
            c.disconnect()
        elif hasattr(c, "free"):
            c.free()
    except BaseException:
        with _lock:
            _closing.discard(h)          # handle stays valid on error
        raise
    with _lock:
        _comms.pop(h, None)
        _closing.discard(h)


def group_translate_ranks(a: int, ranks_view, b: int) -> bytes:
    """MPI_Group_translate_ranks: map each rank of group a to its rank
    in group b (MPI_UNDEFINED where absent)."""
    ga, gb = _group(a), _group(b)
    pos = {w: i for i, w in enumerate(gb.world_ranks)}
    out = []
    for r in _ints(ranks_view):
        r = int(r)
        if r == -2:                      # MPI_PROC_NULL maps to itself
            out.append(-2)
            continue
        if not 0 <= r < ga.size:
            raise MPIError(ERR_RANK, f"rank {r} not in group")
        out.append(pos.get(ga.world_ranks[r], -32766))
    return np.asarray(out, np.intc).tobytes()


def group_compare(a: int, b: int) -> int:
    """MPI_IDENT(0)/MPI_SIMILAR(2)/MPI_UNEQUAL(3)."""
    ga, gb = _group(a), _group(b)
    if list(ga.world_ranks) == list(gb.world_ranks):
        return 0
    if sorted(ga.world_ranks) == sorted(gb.world_ranks):
        return 2
    return 3


def _range_ranks(ranges: np.ndarray) -> list:
    out = []
    for i in range(0, len(ranges), 3):
        first, last, stride = (int(ranges[i]), int(ranges[i + 1]),
                               int(ranges[i + 2]))
        if stride == 0:
            raise MPIError(ERR_ARG, "zero stride in range")
        r = first
        while (stride > 0 and r <= last) or (stride < 0 and r >= last):
            out.append(r)
            r += stride
    return out


def group_range_incl(gh: int, ranges_view) -> int:
    return group_incl(gh, np.asarray(_range_ranks(_ints(ranges_view)),
                                     np.intc).tobytes())


def group_range_excl(gh: int, ranges_view) -> int:
    return group_excl(gh, np.asarray(_range_ranks(_ints(ranges_view)),
                                     np.intc).tobytes())


# ---- graph / dist_graph topologies (dist_graph_create.c.in family) --
def graph_create(h: int, index_view, edges_view, reorder: int) -> int:
    c = _comm(h)
    index = [int(x) for x in _ints(index_view)]
    edges = [int(x) for x in _ints(edges_view)]
    sub = c.create_graph(index, edges, bool(reorder))
    return COMM_NULL if sub is None else _register_comm(sub)


def _graph_topo(h: int, dist_ok: bool = False):
    from ompi_tpu_torch.topo import DistGraphTopology, GraphTopology
    t = _comm(h).topo
    kinds = ((GraphTopology, DistGraphTopology) if dist_ok
             else GraphTopology)
    if not isinstance(t, kinds):
        raise MPIError(ERR_TOPOLOGY, "no graph topology attached")
    return t


def graphdims_get(h: int) -> Tuple[int, int]:
    t = _graph_topo(h)
    return t.size, len(t.edges)


def graph_get(h: int) -> Tuple[bytes, bytes]:
    t = _graph_topo(h)
    return (np.asarray(t.index, np.intc).tobytes(),
            np.asarray(t.edges, np.intc).tobytes())


def _graph_rank(t, rank: int) -> int:
    if not 0 <= int(rank) < t.size:
        raise MPIError(ERR_RANK, f"rank {rank} not in graph")
    return int(rank)


def graph_neighbors(h: int, rank: int) -> bytes:
    t = _graph_topo(h)
    return np.asarray(t.neighbors(_graph_rank(t, rank)),
                      np.intc).tobytes()


def graph_neighbors_count(h: int, rank: int) -> int:
    t = _graph_topo(h)
    return len(t.neighbors(_graph_rank(t, rank)))


def topo_test(h: int) -> int:
    """MPI_Topo_test: 1 graph, 2 cart, 3 dist graph, -32766 none."""
    from ompi_tpu_torch.topo import (CartTopology, DistGraphTopology,
                               GraphTopology)
    t = _comm(h).topo
    if isinstance(t, CartTopology):
        return 2
    if isinstance(t, DistGraphTopology):
        return 3
    if isinstance(t, GraphTopology):
        return 1
    return -32766                        # MPI_UNDEFINED


def dist_graph_create_adjacent(h: int, sources_view, dests_view,
                               reorder: int) -> int:
    c = _comm(h)
    srcs = [int(x) for x in _ints(sources_view)]
    dsts = [int(x) for x in _ints(dests_view)]
    del reorder                          # identity placement
    return _register_comm(c.create_dist_graph_adjacent(srcs, dsts))


def dist_graph_neighbors(h: int) -> Tuple[bytes, bytes]:
    c = _comm(h)
    t = _graph_topo(h, dist_ok=True)
    r = c.rank()
    return (np.asarray(t.neighbors(r), np.intc).tobytes(),
            np.asarray(t.out_neighbors(r), np.intc).tobytes())


def dist_graph_neighbors_count(h: int) -> Tuple[int, int, int]:
    c = _comm(h)
    t = _graph_topo(h, dist_ok=True)
    r = c.rank()
    return len(t.neighbors(r)), len(t.out_neighbors(r)), 0


def cartdim_get(h: int) -> int:
    return len(_comm(h)._cart().dims)


def dims_create(nnodes: int, ndims: int, dims_view) -> bytes:
    """MPI_Dims_create: balanced factorization honoring nonzero
    entries in the caller's dims array."""
    fixed = [int(d) for d in _ints(dims_view)]
    from ompi_tpu_torch.topo.cart import dims_create as _dc
    return np.asarray(_dc(nnodes, ndims, fixed),
                      dtype=np.intc).tobytes()


# communicator attributes (MPI_Comm_create_keyval family): C callers
# cache library state (a void* value) under process-unique keyvals.
# Keyvals come from the CORE registry — a private counter would share
# the per-communicator attribute dict with Python-API keyvals and
# eventually collide with them.


def _handle_of(c) -> int:
    """Reverse map: communicator object -> its C handle (for the comm
    argument of user attribute callbacks)."""
    from ompi_tpu_torch.runtime import init as rt
    if c is rt.comm_world():
        return COMM_WORLD
    try:
        if c is rt.comm_self():
            return COMM_SELF
    except Exception:                    # noqa: BLE001 — no self yet
        pass
    with _lock:
        for h, obj in _comms.items():
            if obj is c:
                return h
    return COMM_NULL


# CFUNCTYPE objects per keyval: must outlive the keyval (a collected
# trampoline is a dangling C function pointer)
_keyval_refs: Dict[int, Any] = {}


def _attr_trampolines(copy_ptr: int, delete_ptr: int, extra: int,
                      handle_map) -> Tuple[Any, Any, list]:
    """Shared copy/delete trampoline builder for every attribute-
    bearing object class (comm/win/type): wraps the C function
    pointers via ctypes, firing them with handle_map(obj) as the
    first argument. copy_ptr 0 = NULL_COPY_FN (never propagated),
    1 = DUP_FN (propagate verbatim); delete_ptr 0 = NULL_DELETE_FN.
    Returns (copy_py, delete_py, keepalive-list) — the keepalive list
    must outlive the keyval (a collected trampoline is a dangling C
    function pointer)."""
    import ctypes
    CopyFn = ctypes.CFUNCTYPE(
        ctypes.c_int, ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int))
    DelFn = ctypes.CFUNCTYPE(
        ctypes.c_int, ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p)
    keep = []
    copy_py = None
    if copy_ptr == 1:                    # DUP_FN

        def copy_py(obj, kv, val):
            return True, val
    elif copy_ptr:
        cfn = CopyFn(copy_ptr)
        keep.append(cfn)

        def copy_py(obj, kv, val):
            out = ctypes.c_void_p(0)
            flag = ctypes.c_int(0)
            rc = cfn(handle_map(obj), int(kv), extra, int(val),
                     ctypes.byref(out), ctypes.byref(flag))
            if rc != 0:
                raise MPIError(rc, "user attribute copy_fn failed")
            return bool(flag.value), int(out.value or 0)
    delete_py = None
    if delete_ptr:
        dfn = DelFn(delete_ptr)
        keep.append(dfn)

        def delete_py(obj, kv, val):
            rc = dfn(handle_map(obj), int(kv), int(val), extra)
            if rc != 0:
                raise MPIError(rc, "user attribute delete_fn failed")
    return copy_py, delete_py, keep


def comm_create_keyval_c(copy_ptr: int, delete_ptr: int,
                         extra: int) -> int:
    """MPI_Comm_create_keyval with REAL callback invocation
    (attribute.c:349-384): copy_fn runs at every MPI_Comm_dup and may
    veto/transform the value; delete_fn runs at delete/overwrite/
    free."""
    from ompi_tpu_torch.core.communicator import create_keyval
    copy_py, delete_py, keep = _attr_trampolines(
        copy_ptr, delete_ptr, extra, _handle_of)
    kv = create_keyval(copy_py, delete_py)
    if keep:
        _keyval_refs[kv] = keep
    return kv


def comm_create_keyval() -> int:
    """Callback-free keyval (kept for older callers)."""
    return comm_create_keyval_c(0, 0, 0)


def comm_set_attr(h: int, keyval: int, value: int) -> None:
    c = _comm(h)
    kv = int(keyval)
    if kv in c.attributes:
        # MPI_Comm_set_attr over an existing attribute fires the
        # delete callback on the OLD value first (MPI-3.1 6.7.2)
        from ompi_tpu_torch.core.communicator import _keyvals
        cb = _keyvals.get(kv)
        if cb and cb[1]:
            cb[1](c, kv, c.attributes[kv])
    c.attributes[kv] = int(value)


def comm_get_attr(h: int, keyval: int) -> Tuple[int, int]:
    """(flag, value) — value is the stored C pointer/int."""
    attrs = _comm(h).attributes
    if int(keyval) in attrs:
        return 1, int(attrs[int(keyval)])
    return 0, 0


def comm_delete_attr(h: int, keyval: int) -> None:
    c = _comm(h)
    if int(keyval) not in c.attributes:
        raise MPIError(ERR_ARG, f"attribute {keyval} not set")
    c.delete_attr(int(keyval))           # fires the delete callback


def comm_free_keyval(keyval: int) -> None:
    from ompi_tpu_torch.core.communicator import free_keyval
    free_keyval(int(keyval))
    _keyval_refs.pop(int(keyval), None)


def comm_set_errhandler(h: int, which: int) -> None:
    """Propagate the C-side errhandler choice into the Python layer —
    without this, the communicator's default ERRORS_ARE_FATAL hook
    would print its abort banner and raise SystemExit before the C
    shim's ERRORS_RETURN path ever saw the real error class.

    PER-COMM (MPI semantics, errhandler.h): only the named
    communicator changes; the C shim keeps a matching per-comm table
    and consults it with the comm of the failing call."""
    from ompi_tpu_torch.core import errhandler as eh
    handler = eh.ERRORS_RETURN if which == 2 else eh.ERRORS_ARE_FATAL
    _comm(h).errhandler = handler


def comm_get_errhandler(h: int) -> int:
    from ompi_tpu_torch.core import errhandler as eh
    return 2 if _comm(h).errhandler is eh.ERRORS_RETURN else 1


# ---------------------------------------------------------------------
# MPI_Info objects (info_create.c.in family) over core/info.Info
# ---------------------------------------------------------------------
_infos: Dict[int, Any] = {}
_next_info = itertools.count(1)


def _info(ih: int):
    with _lock:
        i = _infos.get(ih)
    if i is None:
        raise MPIError(ERR_ARG, f"invalid info handle {ih}")
    return i


def info_create() -> int:
    from ompi_tpu_torch.core.info import Info
    with _lock:
        ih = next(_next_info)
        _infos[ih] = Info()
    return ih


def info_set(ih: int, key: str, value: str) -> None:
    _info(ih).set(key, value)


def info_get(ih: int, key: str) -> Tuple[int, str]:
    v = _info(ih).get(key)
    return (0, "") if v is None else (1, v)


def info_delete(ih: int, key: str) -> None:
    _info(ih).delete(key)


def info_get_nkeys(ih: int) -> int:
    return _info(ih).get_nkeys()


def info_get_nthkey(ih: int, n: int) -> str:
    return _info(ih).get_nthkey(n)


def info_dup(ih: int) -> int:
    dup = _info(ih).dup()
    with _lock:
        nh = next(_next_info)
        _infos[nh] = dup
    return nh


def info_free(ih: int) -> None:
    with _lock:
        if _infos.pop(ih, None) is None:
            raise MPIError(ERR_ARG, f"invalid info handle {ih}")


def comm_split_type(h: int, split_type: int, key: int) -> int:
    sub = _comm(h).split_type(split_type, key)
    if sub is None:                      # MPI_UNDEFINED
        return COMM_NULL
    return _register_comm(sub)


def comm_compare(a: int, b: int) -> int:
    """MPI_Comm_compare: IDENT(0) same object, CONGRUENT(1) same group
    same order, SIMILAR(2) same members, UNEQUAL(3)."""
    ca, cb = _comm(a), _comm(b)
    if ca is cb:
        return 0
    ga = list(ca.group.world_ranks)
    gb = list(cb.group.world_ranks)
    if ga == gb:
        return 1
    if sorted(ga) == sorted(gb):
        return 2
    return 3


def _claim_teardown(table: Dict, key, ckey):
    """Atomically claim a handle for teardown: returns the object, or
    None when the handle is unknown OR another thread already claimed
    it (the loser reports a clean invalid-handle error, never a
    double free). The caller must _closing.discard(ckey) when done."""
    with _lock:
        obj = table.get(key)
        if obj is None or ckey in _closing:
            return None
        _closing.add(ckey)
        return obj


def comm_free(h: int) -> None:
    if h in (COMM_WORLD, COMM_SELF):
        raise MPIError(ERR_COMM, "cannot free a predefined communicator")
    c = _claim_teardown(_comms, h, h)
    if c is None:
        raise MPIError(ERR_COMM, f"invalid communicator handle {h}")
    try:
        _icoll_worker_shutdown(h)        # drain BEFORE free: pending
        # nonblocking collectives must complete against a live comm
        # free FIRST, pop after: user delete callbacks fire inside
        # free() and must still resolve this comm's handle
        # (_handle_of); their errors propagate — MPI_Comm_free reports
        # callback failure (MPI-3.1 6.7.2), it does not swallow it
        if hasattr(c, "free"):
            c.free()
    except BaseException:
        with _lock:
            _closing.discard(h)          # a failed delete callback
        raise                            # leaves the comm VALID
        # (MPI-3.1 6.7.2 reference behavior: free did not happen)
    with _lock:
        _comms.pop(h, None)
        _closing.discard(h)


# ---------------------------------------------------------------------
# point-to-point
# ---------------------------------------------------------------------
def _count_of(view, dt: int) -> int:
    """Element count from the C-side window size. The shim sizes
    windows as (count-1)*extent + true_span bytes (exactly the data,
    never padded past it — a positive true-lb type would otherwise
    overrun the user buffer); the single inversion below is exact for
    every span/extent relation, and degenerates to len//size for
    basic types (span == extent == size)."""
    ext = type_extent_bytes(dt)
    if not ext:
        return 0
    span = type_true_span_bytes(dt)
    n = len(view)
    if n < span or n == 0:
        return 0
    return (n - span) // ext + 1


def send(h: int, view, dt: int, dest: int, tag: int, sync: int) -> None:
    c = _comm(h)
    data = _pack(view, dt, _count_of(view, dt))
    if sync:
        c.ssend(data, dest, tag)
    else:
        c.send(data, dest, tag)


def recv(h: int, source: int, tag: int, dt: int, curview
         ) -> Tuple[bytes, int, int, int, int]:
    """``curview`` is the receive buffer's CURRENT content — derived
    types overlay significant elements into it so gap bytes survive
    (the convertor contract); basic types ignore it."""
    data, st = _comm(h).recv(source, tag)
    if data is None:
        return b"", *_status(st), 0
    out, trunc = _unpack(data, dt, _count_of(curview, dt),
                         bytes(curview))
    src, t, cnt = _status(st, out)
    return out, src, t, cnt, trunc


def sendrecv(h: int, view, dt: int, dest: int, stag: int,
             source: int, rtag: int, rdt: int, curview
             ) -> Tuple[bytes, int, int, int, int]:
    c = _comm(h)
    data, st = c.sendrecv(_pack(view, dt, _count_of(view, dt)), dest,
                          source, sendtag=stag, recvtag=rtag)
    if data is None:
        return b"", *_status(st), 0
    out, trunc = _unpack(data, rdt, _count_of(curview, rdt),
                         bytes(curview))
    src, t, cnt = _status(st, out)
    return out, src, t, cnt, trunc


def isend(h: int, view, dt: int, dest: int, tag: int) -> int:
    req = _comm(h).isend(_pack(view, dt, _count_of(view, dt)), dest,
                         tag)
    with _lock:
        rh = next(_next_req)
        _requests[rh] = (req, dt, b"")
    return rh


def irecv(h: int, source: int, tag: int, dt: int, curview) -> int:
    """The buffer snapshot is taken at POST time — MPI forbids the
    application touching the buffer while the receive is pending, so
    overlaying into the posted-time content at completion is sound."""
    req = _comm(h).irecv(source, tag)
    with _lock:
        rh = next(_next_req)
        _requests[rh] = (req, dt, bytes(curview))
    return rh


def _take_req(rh: int) -> Tuple[Any, int, bytes]:
    with _lock:
        ent = _requests.get(rh)
    if ent is None:
        raise MPIError(ERR_REQUEST, f"invalid request handle {rh}")
    return ent


def _cancelled(req) -> int:
    """MPI_Test_cancelled's flag: the port's per-rank receive records a
    successful MPI_Cancel on its status (``Status.cancelled``)."""
    st = getattr(req, "status", None)
    return int(bool(getattr(req, "cancelled", False)
                    or getattr(st, "cancelled", False)))


def wait(rh: int) -> Tuple[bytes, int, int, int, int, int]:
    req, dt, snap = _take_req(rh)
    try:
        st = req.wait()
    except BaseException:
        # completed in error (ULFM peer death, recv timeout): the C
        # side frees its entry unconditionally, so this table must too
        # or errored requests leak forever
        with _lock:
            _requests.pop(rh, None)
        raise
    data = req.get() if hasattr(req, "get") else None
    with _lock:
        _requests.pop(rh, None)
    canc = _cancelled(req)
    if data is None:
        return b"", *_status(st), 0, canc
    if dt == 0:                          # _icoll_bytes: pre-marshalled
        out = bytes(data)
        src, t, _ = _status(st, out)
        return out, src, t, len(out), 0, canc
    out, trunc = _unpack(data, dt, _count_of(snap, dt), snap)
    src, t, cnt = _status(st, out)
    return out, src, t, cnt, trunc, canc


def test(rh: int) -> Tuple[int, bytes, int, int, int, int, int]:
    req, dt, snap = _take_req(rh)
    try:
        done, st = req.test()
    except BaseException:
        with _lock:
            _requests.pop(rh, None)     # completed in error: reclaim
        raise
    if not done:
        return 0, b"", -1, -1, 0, 0, 0
    data = req.get() if hasattr(req, "get") else None
    with _lock:
        _requests.pop(rh, None)
    canc = _cancelled(req)
    if data is None:
        return 1, b"", *_status(st), 0, canc
    if dt == 0:                          # _icoll_bytes: pre-marshalled
        out = bytes(data)
        src, t, _ = _status(st, out)
        return 1, out, src, t, len(out), 0, canc
    out, trunc = _unpack(data, dt, _count_of(snap, dt), snap)
    src, t, cnt = _status(st, out)
    return 1, out, src, t, cnt, trunc, canc


def probe(h: int, source: int, tag: int) -> Tuple[int, int, int]:
    return _status(_comm(h).probe(source, tag))


def iprobe(h: int, source: int, tag: int) -> Tuple[int, int, int, int]:
    ok, st = _comm(h).iprobe(source, tag)
    if not ok:
        return 0, -1, -1, 0
    return (1,) + _status(st)


# ---------------------------------------------------------------------
# collectives — counts are element counts of the C call; buffers arrive
# as memoryviews sized count*dtype. Root-only outputs return b"" on
# non-roots (the C side only copies when nonempty).
# ---------------------------------------------------------------------
def barrier(h: int) -> None:
    _comm(h).barrier()


def _icoll_handle(req, dt: int, snap: bytes = b"") -> int:
    with _lock:
        rh = next(_next_req)
        _requests[rh] = (req, dt, snap)
    return rh


def _is_perrank(c) -> bool:
    from ompi_tpu_torch.core.rankcomm import RankCommunicator
    return isinstance(c, RankCommunicator)


def ibarrier(h: int) -> int:
    """MPI_Ibarrier -> a request handle the existing wait/test paths
    complete (payload empty). Per-rank comms serialize the deferred
    barrier on their collective worker (RankCommunicator._nb), which
    preserves tag-draw order against every other collective entry."""
    return _icoll_handle(_comm(h).ibarrier(), 4)   # BYTE: no payload


def ibcast(h: int, view, dt: int, root: int) -> int:
    c = _comm(h)
    cnt = _count_of(view, dt)
    data = _pack(view, dt, cnt) if c.rank() == root else None
    # the buffer snapshot makes derived-type completion unpack into a
    # real extent image (same contract as the blocking bcast)
    return _icoll_handle(c.ibcast(data, root), dt, bytes(view))


class _DoneReq:
    """Immediately-complete request: on communicator-like objects with
    no worker machinery the 'nonblocking' collective runs synchronously
    at the i-call — legal MPI behavior (completion at MPI_Wait is a
    lower bound, not a mandate)."""

    _complete = True

    def __init__(self, data):
        self._data = data

    def wait(self, timeout=None):
        return None

    def test(self):
        return True, None

    def get(self):
        return self._data


class _AsyncBytesReq:
    """Marshalled nonblocking collective running on the communicator's
    serial worker thread. The GIL drops during torch compute and the
    device->host copy inside the job, so the C caller genuinely
    overlaps its own compute with the collective (the libnbc progress
    role, reference ompi/mca/coll/libnbc). Errors surface at
    wait/test as RankRequest's do — but this is deliberately NOT
    RankRequest (see wait() on the timeout contract): per-rank
    requests gamble on remote peers and need a bounded default;
    these jobs are local compute sharing one serial worker."""

    __slots__ = ("_event", "_data", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._data = None
        self._error: Optional[BaseException] = None

    def _run(self, job) -> None:
        try:
            self._data = job()
        except BaseException as e:
            self._error = e
        finally:
            self._event.set()

    def wait(self, timeout=None):
        # UNBOUNDED by default — deliberately unlike RankRequest's
        # 600 s budget: jobs here are local compute (no peer can hold
        # them hostage) but they SHARE one serial worker, so a fixed
        # budget would compound across queued jobs and a false
        # ERR_PENDING frees the request while the worker still holds
        # a zero-copy view of the C caller's buffer (use-after-free
        # once the caller reclaims it). An explicit timeout still
        # errors rather than silently faking completion.
        if not self._event.wait(timeout):
            raise MPIError(ERR_PENDING,
                           "nonblocking operation did not complete "
                           "within the wait timeout")
        if self._error is not None:
            raise self._error
        return None

    def test(self):
        if not self._event.is_set():
            return False, None
        if self._error is not None:
            raise self._error
        return True, None

    def get(self):
        return self._data


# one serial worker per communicator/file handle: issue order is
# preserved (MPI requires same-order collective calls per comm, and
# shared-file-pointer claims must happen in i-call order; on a single
# process matching is local, but serialization also keeps interposition
# counters and SPC increments race-free against each other). Comm
# workers key by the int handle, file workers by ("file", fh).
_icoll_workers: Dict[Any, Tuple["queue.Queue", threading.Thread]] = {}
# handles mid-teardown: the closing thread claims the handle here so a
# concurrent free/disconnect/close loses cleanly with ERR instead of
# double-freeing the underlying object
_closing: set = set()


def _icoll_drain(q: "queue.Queue") -> None:
    while True:
        item = q.get()
        if item is None:
            q.task_done()
            return
        req, job = item
        req._run(job)
        q.task_done()                    # keeps unfinished_tasks (the
        # _maybe_funnel busy signal) = queued + in-flight jobs


def _icoll_submit(key, job) -> _AsyncBytesReq:
    req = _AsyncBytesReq()
    with _lock:
        # re-validate under _lock: the caller's handle lookup happened
        # outside it, so a concurrent free/close may have completed in
        # between — submitting then would resurrect a worker no
        # shutdown will ever retire and run the job against a freed
        # object
        if isinstance(key, tuple):       # ("file", fh)
            if key in _closing or key[1] not in _files:
                raise MPIError(ERR_ARG,
                               f"invalid file handle {key[1]}")
        elif key in _closing or (key not in _comms
                                 and key not in (COMM_WORLD,
                                                 COMM_SELF)):
            raise MPIError(ERR_COMM,
                           f"invalid communicator handle {key}")
        ent = _icoll_workers.get(key)
        if ent is None:
            q = queue.Queue()
            t = threading.Thread(target=_icoll_drain, args=(q,),
                                 daemon=True,
                                 name=f"icoll-worker-{key}")
            _icoll_workers[key] = (q, t)
            t.start()
        else:
            q, _t = ent
        # enqueue under _lock: a concurrent shutdown's sentinel must
        # not overtake this job (a job behind the sentinel would never
        # complete — its waiter hangs silently)
        q.put((req, job))
    return req


def _icoll_worker_shutdown(key) -> None:
    """Retire a handle's worker, draining pending jobs first: MPI
    deallocation happens only after pending operations complete
    (MPI-3.1 6.4.3) — callers run this BEFORE freeing the object so
    the deferred jobs can still resolve its handle."""
    with _lock:
        ent = _icoll_workers.pop(key, None)
        if ent is None:
            return
        q, t = ent
        q.put(None)                      # queues behind pending jobs
    t.join()                             # outside _lock: jobs take it


def _file_nb_req(fh: int, job):
    """Deferred file op on the file's OWN serial worker, both tiers:
    no deferred file job draws the comm's collective sequence tag
    (individual ops pre-resolve their position at the i-call, shared
    ops claim through RMA), so the file is its own ordering domain —
    draining or funneling it never forces unrelated comm collectives
    to complete, and file_close on one domain cannot deadlock a
    program correct on the other."""
    if hasattr(_file(fh).comm, "_nb"):   # either tier's worker model
        return _icoll_submit(("file", fh), job)
    return _DoneReq(job())


def _file_blocking_serial(fh: int, fn, *a, **kw):
    """Blocking shared-pointer/ordered file op: must queue BEHIND any
    pending nonblocking ops on the same file, or its pointer claim
    (made at execution time) overtakes an earlier-issued i-op's claim
    and records land at swapped offsets. Funnels against the
    ("file", fh) worker, inline when it is idle."""
    key = ("file", fh)
    with _lock:
        ent = _icoll_workers.get(key)
        busy = (ent is not None
                and ent[0].unfinished_tasks > 0
                and threading.current_thread() is not ent[1])
        if busy:
            req = _AsyncBytesReq()
            ent[0].put((req, lambda: fn(*a, **kw)))
    if not busy:
        return fn(*a, **kw)
    req.wait()
    return req.get()


def _nb_job(c, key, job):
    """Dispatch a deferred byte-producing job on the handle's serial
    worker — the i-call returns before the job materializes (deferring
    the buffer read is legal: MPI forbids the caller from touching
    buffers until completion). Per-rank jobs ride the comm's own
    collective worker (RankCommunicator._nb), the chokepoint every
    collective entry shares, so tag draws stay in issue order;
    single-controller jobs ride the handle's serial worker here.
    Objects with no worker machinery run synchronously (_DoneReq,
    legal: completion at MPI_Wait is a lower bound)."""
    if _is_perrank(c):
        return c._nb(job)
    if hasattr(c, "_nb"):                # stacked single-controller
        return _icoll_submit(key, job)
    return _DoneReq(job())


def _icoll_bytes(h: int, job) -> int:
    """Generic nonblocking collective: run ``job`` — a closure over
    the blocking glue marshaller, returning the final C-buffer bytes —
    asynchronously (see _nb_job). The request entry's dt==0 marks the
    payload as pre-marshalled bytes: wait/test deliver it verbatim,
    no unpack."""
    req = _nb_job(_comm(h), h, job)
    return _icoll_handle(req, 0)


def igather(h: int, view, sdt: int, root: int, rdt: int) -> int:
    return _icoll_bytes(h, lambda: gather(h, view, sdt, root, rdt))


def igatherv(h: int, view, sdt: int, root: int, rdt: int, counts_view,
             displs_view, curview) -> int:
    counts, displs = bytes(counts_view), bytes(displs_view)
    snap = bytes(curview)
    return _icoll_bytes(h, lambda: gatherv(
        h, view, sdt, root, rdt, counts, displs, snap))


def iscatter(h: int, view, sdt: int, sendcount: int, root: int,
             rdt: int) -> int:
    return _icoll_bytes(h, lambda: scatter(
        h, view, sdt, sendcount, root, rdt))


def iscatterv(h: int, view, sdt: int, counts_view, displs_view,
              root: int, rdt: int) -> int:
    counts, displs = bytes(counts_view), bytes(displs_view)
    return _icoll_bytes(h, lambda: scatterv(
        h, view, sdt, counts, displs, root, rdt))


def iallgather(h: int, view, sdt: int, rdt: int) -> int:
    return _icoll_bytes(h, lambda: allgather(h, view, sdt, rdt))


def iallgatherv(h: int, view, sdt: int, rdt: int, counts_view,
                displs_view, curview) -> int:
    counts, displs = bytes(counts_view), bytes(displs_view)
    snap = bytes(curview)
    return _icoll_bytes(h, lambda: allgatherv(
        h, view, sdt, rdt, counts, displs, snap))


def ialltoall(h: int, view, sdt: int, percount: int, rdt: int) -> int:
    return _icoll_bytes(h, lambda: alltoall(h, view, sdt, percount, rdt))


def ialltoallv(h: int, view, sdt: int, scounts_view, sdispls_view,
               rdt: int, rcounts_view, rdispls_view, curview) -> int:
    sc, sd = bytes(scounts_view), bytes(sdispls_view)
    rc_, rd = bytes(rcounts_view), bytes(rdispls_view)
    snap = bytes(curview)
    return _icoll_bytes(h, lambda: alltoallv(
        h, view, sdt, sc, sd, rdt, rc_, rd, snap))


def ireduce(h: int, view, dt: int, o: int, root: int) -> int:
    return _icoll_bytes(h, lambda: reduce(h, view, dt, o, root))


def iscan(h: int, view, dt: int, o: int) -> int:
    return _icoll_bytes(h, lambda: scan(h, view, dt, o))


def iexscan(h: int, view, dt: int, o: int) -> int:
    return _icoll_bytes(h, lambda: exscan(h, view, dt, o))


def ireduce_scatter_block(h: int, view, dt: int, o: int,
                          recvcount: int) -> int:
    return _icoll_bytes(h, lambda: reduce_scatter_block(
        h, view, dt, o, recvcount))


def ireduce_scatter(h: int, view, dt: int, o: int, counts_view) -> int:
    counts = bytes(counts_view)      # the C array may not outlive us
    return _icoll_bytes(h, lambda: reduce_scatter(
        h, view, dt, o, counts))


def ineighbor_allgather(h: int, view, sdt: int, rdt: int,
                        curview) -> int:
    snap = bytes(curview)
    return _icoll_bytes(h, lambda: neighbor_allgather(
        h, view, sdt, rdt, snap))


def ineighbor_alltoall(h: int, view, sdt: int, percount: int, rdt: int,
                       curview) -> int:
    snap = bytes(curview)
    return _icoll_bytes(h, lambda: neighbor_alltoall(
        h, view, sdt, percount, rdt, snap))


def iallreduce(h: int, view, dt: int, o: int) -> int:
    # notes: the fold runs on a worker thread, so a C user op's
    # datatype handle comes from the dtype reverse map there (the
    # thread-local _op_ctx only covers blocking reductions); for
    # derived types the overlay base is the SEND buffer image (the
    # recv buffer's gap bytes are not round-tripped through this path)
    c = _comm(h)
    snap = bytes(view)
    req = c.iallreduce(_pack(view, dt, _count_of(view, dt)), _op(o))
    return _icoll_handle(req, dt, snap)


def test_peek(rh: int) -> int:
    """Non-consuming completion probe: 1 if wait/test would complete
    immediately (including completed-in-error). Lets MPI_Testall keep
    the standard's all-or-nothing contract — no request is consumed
    until every one is ready."""
    req, _dt, _snap = _take_req(rh)
    done = getattr(req, "_complete", False)
    if not done:
        try:
            done, _ = req.test()
        except BaseException:
            return 1                     # completed in error: done
        if done:
            # the request completed just now — but test() on our
            # request types does not deliver payloads, so nothing is
            # consumed; the later consuming call replays it
            return 1
    return int(bool(done))


def pack(view, dt: int, count: int) -> bytes:
    """MPI_Pack: the significant bytes of count elements (contiguous
    packing — the convertor's gather side)."""
    return _pack(view, dt, count).tobytes()


def unpack(data_view, dt: int, count: int, curview) -> bytes:
    """MPI_Unpack: scatter packed elements into a full-extent buffer
    image (gaps preserved for derived types)."""
    base, _, _ = _type_parts(dt)
    flat = np.frombuffer(data_view, dtype=base)
    return _unpack(flat, dt, count, bytes(curview))[0]


def pack_size(dt: int, count: int) -> int:
    """MPI_Pack_size: an upper bound on packed bytes."""
    return type_size_bytes(dt) * count


def bcast(h: int, view, dt: int, root: int) -> bytes:
    c = _comm(h)
    cnt = _count_of(view, dt)
    data = _pack(view, dt, cnt) if c.rank() == root else None
    got = c.bcast(data, root)
    return _unpack(got, dt, cnt, bytes(view))[0]


def reduce(h: int, view, dt: int, o: int, root: int) -> bytes:
    c = _comm(h)
    _op_ctx.dt = dt
    try:
        r = c.reduce(_arr(view, dt), _op(o), root)
    finally:
        _op_ctx.dt = 0
    return b"" if r is None else _out(r, dt)


def allreduce(h: int, view, dt: int, o: int) -> bytes:
    _op_ctx.dt = dt
    try:
        return _out(_comm(h).allreduce(_arr(view, dt), _op(o)), dt)
    finally:
        _op_ctx.dt = 0


def gather(h: int, view, sdt: int, root: int, rdt: int) -> bytes:
    """rdt is the receive datatype, significant (and validated) at the
    root only — 0 elsewhere (MPI-3.1 significance rules)."""
    c = _comm(h)
    rows = c.gather(_arr(view, sdt), root)
    if rows is None:
        return b""
    return _out(np.concatenate([np.atleast_1d(_host(r)) for r in rows]), rdt)


def scatter(h: int, view, sdt: int, sendcount: int, root: int,
            rdt: int) -> bytes:
    """sdt/sendcount significant at root only; rdt == 0 means the
    caller asked for no output copy (MPI_IN_PLACE at the root)."""
    c = _comm(h)
    chunks: Optional[list] = None
    if c.rank() == root:
        a = _arr(view, sdt)
        chunks = [a[i * sendcount:(i + 1) * sendcount]
                  for i in range(c.size)]
    got = c.scatter(chunks, root)
    return b"" if rdt == 0 else _out(got, rdt)


def allgather(h: int, view, sdt: int, rdt: int) -> bytes:
    c = _comm(h)
    a = _arr(view, sdt)
    if getattr(c, "is_per_rank", False):   # C signature: uniform counts
        rows = c.allgather(a, uniform=True)
    else:
        rows = c.allgather(a)
    return _out(np.concatenate([np.atleast_1d(_host(r)) for r in rows]), rdt)


def alltoall(h: int, view, sdt: int, percount: int, rdt: int) -> bytes:
    c = _comm(h)
    a = _arr(view, sdt)
    chunks = [a[i * percount:(i + 1) * percount] for i in range(c.size)]
    # the C signature fixes one sendcount/sendtype on every rank, so
    # chunk uniformity holds globally -> large chunks may take the
    # staged device tier (a per-rank-communicator option)
    if getattr(c, "is_per_rank", False):
        out = c.alltoall(chunks, uniform=True)
    else:
        out = c.alltoall(chunks)
    return _out(np.concatenate([np.atleast_1d(_host(r)) for r in out]), rdt)


def scan(h: int, view, dt: int, o: int) -> bytes:
    _op_ctx.dt = dt
    try:
        return _out(_comm(h).scan(_arr(view, dt), _op(o)), dt)
    finally:
        _op_ctx.dt = 0


def exscan(h: int, view, dt: int, o: int) -> bytes:
    c = _comm(h)
    _op_ctx.dt = dt
    try:
        r = c.exscan(_arr(view, dt), _op(o))
    finally:
        _op_ctx.dt = 0
    if r is None:                        # rank 0: result undefined
        return _out(np.zeros_like(_arr(view, dt)), dt)
    return _out(r, dt)


def _ints(view) -> np.ndarray:
    """A C int[] argument (counts/displs arrays)."""
    return np.frombuffer(view, dtype=np.intc)


def _overlay(rows, rdt: int, counts, displs, curview) -> bytes:
    """Place per-rank segments at their displacements inside the
    receiver's existing content (bytes between segments survive)."""
    cur = np.frombuffer(curview, _dtype(rdt)).copy()
    for i, row in enumerate(rows):
        seg = _host(row).ravel()[:counts[i]]
        if seg.dtype != cur.dtype:
            seg = seg.astype(cur.dtype)
        cur[displs[i]:displs[i] + counts[i]] = seg
    return cur.tobytes()


def allgatherv(h: int, view, sdt: int, rdt: int, counts_view,
               displs_view, curview) -> bytes:
    """MPI_Allgatherv: rank i's contribution lands at displs[i] with
    counts[i] elements; bytes between segments keep their content."""
    c = _comm(h)
    rows = c.allgather(_arr(view, sdt))
    return _overlay(rows, rdt, _ints(counts_view), _ints(displs_view),
                    curview)


def gatherv(h: int, view, sdt: int, root: int, rdt: int, counts_view,
            displs_view, curview) -> bytes:
    c = _comm(h)
    rows = c.gather(_arr(view, sdt), root)
    if rows is None:
        return b""
    return _overlay(rows, rdt, _ints(counts_view), _ints(displs_view),
                    curview)


def scatterv(h: int, view, sdt: int, counts_view, displs_view,
             root: int, rdt: int) -> bytes:
    c = _comm(h)
    chunks: Optional[list] = None
    if c.rank() == root:
        a = _arr(view, sdt)
        counts, displs = _ints(counts_view), _ints(displs_view)
        chunks = [a[displs[i]:displs[i] + counts[i]]
                  for i in range(c.size)]
    return _out(c.scatter(chunks, root), rdt)


def alltoallv(h: int, view, sdt: int, scounts_view, sdispls_view,
              rdt: int, rcounts_view, rdispls_view, curview) -> bytes:
    c = _comm(h)
    sc, sd = _ints(scounts_view), _ints(sdispls_view)
    rc, rd = _ints(rcounts_view), _ints(rdispls_view)
    a = _arr(view, sdt)
    chunks = [a[sd[i]:sd[i] + sc[i]] for i in range(c.size)]
    out = c.alltoall(chunks)
    return _overlay(out, rdt, rc, rd, curview)


def reduce_scatter(h: int, view, dt: int, o: int, counts_view) -> bytes:
    """MPI_Reduce_scatter: elementwise reduction of the full vector;
    rank r receives its counts[r] segment. The base 'nonoverlapping'
    composition (reduce + scatterv,
    coll_base_reduce_scatter.c:nonoverlapping): here one allreduce —
    which on large host buffers rides the staged device tier — then a
    local slice."""
    c = _comm(h)
    counts = _ints(counts_view)
    _op_ctx.dt = dt
    try:
        full = _host(c.allreduce(_arr(view, dt), _op(o)))
    finally:
        _op_ctx.dt = 0
    r = c.rank()
    start = int(counts[:r].sum())
    return _out(full[start:start + int(counts[r])], dt)


def reduce_scatter_block(h: int, view, dt: int, o: int,
                         recvcount: int) -> bytes:
    c = _comm(h)
    a = _arr(view, dt)
    chunks = [a[i * recvcount:(i + 1) * recvcount] for i in range(c.size)]
    _op_ctx.dt = dt
    try:
        return _out(c.reduce_scatter_block(chunks, _op(o)), dt)
    finally:
        _op_ctx.dt = 0


# ---------------------------------------------------------------------
# one-sided RMA (MPI_Win_allocate family): the window IS interpreter
# memory whose address the C program holds — remote puts mutate it
# asynchronously (reader-thread application), so direct loads after a
# fence see them, the shared-memory window model of osc/sm.
# ---------------------------------------------------------------------
_wins: Dict[int, Any] = {}
_next_win = itertools.count(1)


def _win(wh: int):
    with _lock:
        w = _wins.get(wh)
    if w is None:
        raise MPIError(ERR_ARG, f"invalid window handle {wh}")
    return w


def win_allocate(nbytes: int, disp_unit: int, h: int
                 ) -> Tuple[int, int]:
    """Returns (window handle, base address). The base points at the
    window's byte storage inside the embedded interpreter — stable for
    the window's lifetime (handlers mutate it in place). Allocation
    goes through the osc framework's selection step: same-host
    communicators get an osc/shm window (the base address then points
    INTO the /dev/shm segment peers map directly), everything else
    gets the osc/pt2pt emulation — with the epoch state machine, FT
    and telemetry planes wrapped around either (docs/RMA.md)."""
    from ompi_tpu_torch.osc.window import win_allocate as _osc_allocate
    c = _comm(h)
    win = _osc_allocate(c, max(int(nbytes), 1), dtype=np.uint8,
                        name=f"cabi_win{nbytes}")
    # displacement scaling uses the TARGET's declared unit (they may
    # legitimately differ per rank — the same reason RankWindow
    # allgathers per-rank sizes)
    win._disp_units = [int(u) for u in
                       c.allgather(np.int64(max(int(disp_unit), 1)))]
    with _lock:
        wh = next(_next_win)
        _wins[wh] = win
    return wh, int(win.local.ctypes.data)


def win_create(h: int, base_view, disp_unit: int) -> int:
    """MPI_Win_create (win_create.c.in:79): the CALLER's memory is the
    exposure region — remote puts applied by the reader thread land
    directly in the C program's buffer, so its plain loads observe
    them after the synchronization call (the osc/sm model). Caller
    memory pins the selection to osc/pt2pt — it cannot be
    retroactively placed in a /dev/shm segment."""
    from ompi_tpu_torch.osc.window import win_create as _osc_create
    c = _comm(h)
    storage = np.frombuffer(base_view, dtype=np.uint8)
    win = _osc_create(c, storage,
                      name=f"cabi_wincreate{storage.size}")
    win._disp_units = [int(u) for u in
                       c.allgather(np.int64(max(int(disp_unit), 1)))]
    with _lock:
        wh = next(_next_win)
        _wins[wh] = win
    return wh


def win_flush(wh: int, target: int) -> None:
    """Every RMA op here is target-acked before returning, so flush
    variants are ordering no-ops (documented semantics, not a stub:
    completion already happened)."""
    _win(wh).flush(target)


def win_flush_all(wh: int) -> None:
    _win(wh).flush()


def win_lock_all(wh: int) -> None:
    from ompi_tpu_torch.osc.perrank import LOCK_SHARED
    w = _win(wh)
    for t in range(w.comm.size):
        w.lock(t, LOCK_SHARED)


def win_unlock_all(wh: int) -> None:
    w = _win(wh)
    for t in range(w.comm.size):
        w.unlock(t)


def win_get_group(wh: int) -> int:
    return _register_group(_win(wh).comm.group)


def win_fetch_and_op(wh: int, view, dt: int, o: int, target: int,
                     disp: int) -> bytes:
    """Returns the target's PRIOR value (the MPI result buffer)."""
    w = _win(wh)
    op = _rma_op(o)
    if not op.predefined:
        raise MPIError(ERR_OP, "MPI_Fetch_and_op needs a predefined op")
    a = _arr(view, dt)[:1]
    old = w.get_accumulate_typed(a, target,
                                 _byte_disp(w, target, disp),
                                 op=op.name)
    return _out(np.asarray(old), dt)


def win_compare_and_swap(wh: int, origin_view, compare_view, dt: int,
                         target: int, disp: int) -> bytes:
    w = _win(wh)
    origin = _arr(origin_view, dt)[:1]
    compare = _arr(compare_view, dt)[:1]
    old = w.compare_and_swap_typed(compare, origin, target,
                                   _byte_disp(w, target, disp))
    return _out(np.asarray(old).ravel(), dt)


def win_get_accumulate(wh: int, view, dt: int, o: int, target: int,
                       disp: int, result_count: int,
                       rdt: int) -> bytes:
    """Fetch-then-accumulate; for MPI_NO_OP the origin buffer is
    ignored and the fetch length comes from result_count (MPI-3.1
    11.3.4 significance rules)."""
    w = _win(wh)
    op = _rma_op(o)
    if not op.predefined:
        raise MPIError(ERR_OP,
                       "MPI_Get_accumulate needs a predefined op")
    if op.name == "no_op":
        # origin buffer/count/datatype are IGNORED for MPI_NO_OP
        # (MPI-3.1 11.3.4): the fetch is sized and typed by the
        # RESULT arguments
        data = np.zeros(result_count, _dtype(rdt))
        out_dt = rdt
    else:
        data = _arr(view, dt)
        out_dt = rdt if rdt else dt
    old = w.get_accumulate_typed(data, target,
                                 _byte_disp(w, target, disp),
                                 op=op.name)
    return _out(np.asarray(old), out_dt)


def win_rput(wh: int, view, dt: int, target: int, disp: int) -> int:
    """MPI_Rput -> request handle; completion == remote completion."""
    w = _win(wh)
    a = _pack(view, dt, _count_of(view, dt))
    req = w.rput(a.view(np.uint8), target,
                 _byte_disp(w, target, disp))
    return _icoll_handle(req, 0)


def win_rget(wh: int, target: int, disp: int, dt: int, count: int,
             curview) -> int:
    """MPI_Rget -> request handle; completion payload is the origin
    buffer image (same overlay contract as win_get)."""
    from ompi_tpu_torch.pml.perrank import thread_request
    w = _win(wh)
    snap = bytes(curview)
    bd = _byte_disp(w, target, disp)

    def job():
        nbytes = type_size_bytes(dt) * count
        raw = w.get(target, bd, nbytes).tobytes()
        base, _, _ = _type_parts(dt)
        return _unpack(np.frombuffer(raw, base), dt, count, snap)[0]
    return _icoll_handle(thread_request(job), 0)


def win_raccumulate(wh: int, view, dt: int, o: int, target: int,
                    disp: int) -> int:
    from ompi_tpu_torch.pml.perrank import thread_request
    w = _win(wh)
    op = _rma_op(o)
    if not op.predefined:
        raise MPIError(ERR_OP,
                       "MPI_Raccumulate needs a predefined op")
    a = _pack(view, dt, _count_of(view, dt))
    bd = _byte_disp(w, target, disp)
    return _icoll_handle(thread_request(
        lambda: w.accumulate_typed(a, target, bd, op=op.name)), 0)


def win_free(wh: int) -> None:
    with _lock:                          # atomic: double-free raises
        w = _wins.pop(wh, None)
    if w is None:
        raise MPIError(ERR_ARG, f"invalid window handle {wh}")
    _obj_attrs_free("win", wh)           # attr delete_fns fire
    w.free()


def win_fence(wh: int) -> None:
    _win(wh).fence()


def win_lock(wh: int, lock_type: int, target: int) -> None:
    _win(wh).lock(target, lock_type)


def win_unlock(wh: int, target: int) -> None:
    _win(wh).unlock(target)


def _byte_disp(w, target: int, disp: int) -> int:
    units = w._disp_units
    if not 0 <= target < len(units):
        raise MPIError(ERR_ARG, f"bad RMA target {target}")
    return disp * units[target]


def win_put(wh: int, view, dt: int, target: int, disp: int) -> None:
    w = _win(wh)
    a = _pack(view, dt, _count_of(view, dt))
    w.put(a.view(np.uint8), target, _byte_disp(w, target, disp))


def win_get(wh: int, target: int, disp: int, dt: int,
            count: int, curview) -> bytes:
    """Returns the origin buffer IMAGE: significant bytes fetched from
    the target, overlaid into the origin's current content for derived
    datatypes (gap elements keep their bytes, like the recv path)."""
    w = _win(wh)
    nbytes = type_size_bytes(dt) * count
    raw = w.get(target, _byte_disp(w, target, disp), nbytes).tobytes()
    base, _, _ = _type_parts(dt)
    flat = np.frombuffer(raw, dtype=base)
    return _unpack(flat, dt, count, bytes(curview))[0]


def win_accumulate(wh: int, view, dt: int, o: int, target: int,
                   disp: int) -> None:
    w = _win(wh)
    op = _rma_op(o)
    if not op.predefined:
        raise MPIError(ERR_OP,
                       "MPI_Accumulate requires a predefined op")
    a = _pack(view, dt, _count_of(view, dt))
    w.accumulate_typed(a, target, _byte_disp(w, target, disp),
                       op=op.name)


# ---------------------------------------------------------------------
# MPI-IO (MPI_File_* over io/perrank.RankFile): byte-addressed view,
# each call brings its own datatype (offsets are byte offsets against
# the default view, the MPI "native" etype=byte default)
# ---------------------------------------------------------------------
_files: Dict[int, Any] = {}
_next_file = itertools.count(1)

# MPI_MODE_* (mpi.h values) -> POSIX flags (io/file MODE_* are POSIX)
_MPI_MODE_RDONLY = 2
_MPI_MODE_RDWR = 8
_MPI_MODE_WRONLY = 4
_MPI_MODE_CREATE = 1
_MPI_MODE_EXCL = 64
_MPI_MODE_APPEND = 128


def _file(fh: int):
    with _lock:
        f = _files.get(fh)
    if f is None:
        raise MPIError(ERR_ARG, f"invalid file handle {fh}")
    return f


def file_open(h: int, path: str, amode: int) -> int:
    import os as _os

    from ompi_tpu_torch.io.perrank import RankFile
    flags = 0
    if amode & _MPI_MODE_RDWR:
        flags |= _os.O_RDWR
    elif amode & _MPI_MODE_WRONLY:
        flags |= _os.O_WRONLY
    # O_RDONLY is 0
    if amode & _MPI_MODE_CREATE:
        flags |= _os.O_CREAT
    if amode & _MPI_MODE_EXCL:
        flags |= _os.O_EXCL
    # MPI_MODE_APPEND means the INITIAL position is EOF — it must NOT
    # become O_APPEND (Linux pwrite on an O_APPEND fd ignores the
    # offset and appends, breaking every positioned write)
    f = RankFile(_comm(h), path, amode=flags, etype=np.uint8)
    if amode & _MPI_MODE_APPEND:
        f.seek_shared(f.get_size())      # collective, like the open
    with _lock:
        fh = next(_next_file)
        _files[fh] = f
        _file_amodes[fh] = int(amode)    # MPI_File_get_amode
    return fh


def file_close(fh: int) -> None:
    key = ("file", fh)
    f = _claim_teardown(_files, fh, key)
    if f is None:
        raise MPIError(ERR_ARG, f"invalid file handle {fh}")
    try:
        _icoll_worker_shutdown(key)      # drain pending i-ops first:
        # their deferred jobs still resolve this file's handle
        f.close()
    except BaseException:
        with _lock:
            _closing.discard(key)        # handle stays valid on error
        raise
    with _lock:
        _files.pop(fh, None)
        _file_amodes.pop(fh, None)
        _file_views.pop(fh, None)
        _file_pos.pop(fh, None)
        _file_atomicity.pop(fh, None)
        _closing.discard(key)


def file_delete(path: str) -> None:
    import os as _os
    try:
        _os.unlink(path)
    except OSError as e:
        raise MPIError(ERR_ARG, f"MPI_File_delete: {e}") from None


def _file_write(fh: int, view, dt: int, collective: bool,
                offset: Optional[int]) -> int:
    """Returns the SIGNIFICANT bytes written (status counting)."""
    f = _file(fh)
    a = _pack(view, dt, _count_of(view, dt))
    data = a.view(np.uint8)
    if offset is None:
        f.write_shared(data)
    elif collective:
        f.write_at_all(int(offset), data)
    else:
        f.write_at(int(offset), data)
    return int(a.nbytes)


def _file_read(fh: int, nbytes: int, dt: int, curview,
               collective: bool, offset: Optional[int]
               ) -> Tuple[bytes, int]:
    """(origin buffer image, delivered significant bytes) — a short
    read at EOF reports what was actually read, never the request."""
    f = _file(fh)
    if offset is None:
        raw = f.read_shared(int(nbytes))
    elif collective:
        raw = f.read_at_all(int(offset), int(nbytes))
    else:
        raw = f.read_at(int(offset), int(nbytes))
    raw = np.ascontiguousarray(raw)
    base, _, _ = _type_parts(dt)
    usable = (raw.nbytes // base.itemsize) * base.itemsize
    flat = raw.view(np.uint8)[:usable].view(base)
    cnt = _count_of(curview, dt) if len(curview) else flat.size
    return _unpack(flat, dt, cnt, bytes(curview))[0], int(flat.nbytes)


def file_write_at(fh: int, offset: int, view, dt: int) -> int:
    return _file_write(fh, view, dt, False, offset)


def file_write_at_all(fh: int, offset: int, view, dt: int) -> int:
    return _file_write(fh, view, dt, True, offset)


def file_write_shared(fh: int, view, dt: int) -> int:
    # shared-pointer claim orders behind pending i-ops on this file
    return _file_blocking_serial(fh, _file_write, fh, view, dt,
                                 False, None)


def file_read_at(fh: int, offset: int, nbytes: int, dt: int, curview
                 ) -> Tuple[bytes, int]:
    return _file_read(fh, nbytes, dt, curview, False, offset)


def file_read_at_all(fh: int, offset: int, nbytes: int, dt: int,
                     curview) -> Tuple[bytes, int]:
    return _file_read(fh, nbytes, dt, curview, True, offset)


def file_read_shared(fh: int, nbytes: int, dt: int, curview
                     ) -> Tuple[bytes, int]:
    # shared-pointer claim orders behind pending i-ops on this file
    return _file_blocking_serial(fh, _file_read, fh, nbytes, dt,
                                 curview, False, None)


def file_get_size(fh: int) -> int:
    return int(_file(fh).get_size())


def file_set_size(fh: int, nbytes: int) -> None:
    _file(fh).set_size(int(nbytes))


def file_sync(fh: int) -> None:
    _file(fh).sync()


# ---------------------------------------------------------------------
# MPI_T — the tool information interface from C (ompi/mpi/tool/*): the
# third leg of the profiling story next to PMPI and the monitoring
# interposers. Handles are indices into the sorted var/pvar dumps,
# stable within one MPI_T epoch (the C side allocs/frees handles but
# they carry no state beyond the index).
# ---------------------------------------------------------------------
# MPI_T indices must be STABLE (the spec allows the count to grow but
# an index, once returned, keeps naming the same variable): keep an
# append-only NAME order across enumerations. Enumeration never reads
# counter values (a tool loop over N pvars must not pay N reads per
# call).
_t_orders: Dict[str, list] = {"cvar": [], "pvar": []}


def _t_stable(kind: str, names) -> list:
    order = _t_orders[kind]
    known = set(order)
    for name in sorted(names):
        if name not in known:
            order.append(name)
    cur = set(names)
    return [n for n in order if n in cur]


# MPI_T keeps the JAX package's component names as synonyms: coll/torch
# is the port of coll/xla, so every coll_torch_<x> cvar is listed as
# coll_xla_<x> too, and reading or writing either reaches the one
# variable (``target``). The reference keeps a renamed component's vars
# the same way (btl_vader_* after vader became btl/sm,
# mca_base_var_register_synonym).
_T_PORT_PREFIX, _T_SYNONYM_PREFIX = "coll_torch_", "coll_xla_"


def _t_cvars() -> Dict[str, Dict[str, Any]]:
    from ompi_tpu_torch.mca import var as _v
    out = {d["name"]: d for d in _v.var_dump()}
    for name, d in list(out.items()):
        if name.startswith(_T_PORT_PREFIX):
            syn = _T_SYNONYM_PREFIX + name[len(_T_PORT_PREFIX):]
            out.setdefault(syn, dict(d, name=syn, target=name))
    return out


def t_cvar_get_num() -> int:
    return len(_t_stable("cvar", _t_cvars().keys()))


def _t_cvar(i: int) -> Dict[str, Any]:
    cur = _t_cvars()
    names = _t_stable("cvar", cur.keys())
    if not 0 <= int(i) < len(names):
        raise MPIError(ERR_ARG, f"bad cvar index {i}")
    return cur[names[int(i)]]


def t_cvar_get_info(i: int) -> Tuple[str, str, str]:
    v = _t_cvar(i)
    return v["name"], str(v["type"]), v.get("help") or ""


def t_cvar_get_index(name: str) -> int:
    for idx, n in enumerate(_t_stable("cvar", _t_cvars().keys())):
        if n == name:
            return idx
    raise MPIError(ERR_ARG, f"no such cvar {name!r}")


def t_cvar_kind(i: int) -> int:
    """1 = string-typed, 0 = integer-typed (the C marshalling switch
    and the handle's element count source)."""
    v = _t_cvar(i)
    return int(v["type"] == "str" or isinstance(v["value"], str))


def t_cvar_read(i: int) -> Tuple[int, int, str]:
    """(is_string, int_value, str_value) for the C marshaller."""
    v = _t_cvar(i)
    val = v["value"]
    if v["type"] == "str" or isinstance(val, str):
        return 1, 0, "" if val is None else str(val)
    return 0, int(val or 0), ""


def t_cvar_write_int(i: int, value: int) -> None:
    from ompi_tpu_torch.mca import var as _v
    v = _t_cvar(i)
    _v.var_set(v.get("target", v["name"]),
               bool(value) if v["type"] == "bool" else int(value))


def t_cvar_write_str(i: int, value: str) -> None:
    from ompi_tpu_torch.mca import var as _v
    v = _t_cvar(i)
    _v.var_set(v.get("target", v["name"]), value)


def _t_pvar_names() -> list:
    from ompi_tpu_torch.mca import pvar as _p
    _p.refresh()
    return _t_stable("pvar", _p.pvar_names())


def t_pvar_get_num() -> int:
    return len(_t_pvar_names())


def _t_pvar(i: int) -> Dict[str, Any]:
    from ompi_tpu_torch.mca import pvar as _p
    names = _t_pvar_names()
    if not 0 <= int(i) < len(names):
        raise MPIError(ERR_ARG, f"bad pvar index {i}")
    return _p.pvar_info(names[int(i)])


def t_pvar_get_info(i: int) -> Tuple[str, str, str]:
    v = _t_pvar(i)
    return v["name"], str(v.get("class", "counter")), v.get("help") or ""


def t_pvar_get_index(name: str) -> int:
    for idx, n in enumerate(_t_pvar_names()):
        if n == name:
            return idx
    raise MPIError(ERR_ARG, f"no such pvar {name!r}")


def t_pvar_read(i: int) -> int:
    from ompi_tpu_torch.mca import pvar as _p
    val = _p.pvar_read(_t_pvar(i)["name"])
    return int(val or 0)


# ---------------------------------------------------------------------
# round-5 wave 3 glue: send modes, matched probe + cancel, dynamic
# error space, intra-job intercommunicators, Cart_sub,
# Comm_create_group, Alltoallw, file views + individual pointers,
# dynamic RMA windows, spawn of executables, MPI_T events.
# ---------------------------------------------------------------------
def _window_len(dt: int, count: int) -> int:
    """Bytes of the marshalling window for ``count`` elements (the C
    shim's dt_window length, mirrored for in-glue slicing)."""
    if count <= 0:
        return 0
    return ((count - 1) * type_extent_bytes(dt)
            + type_true_span_bytes(dt))


def issend(h: int, view, dt: int, dest: int, tag: int) -> int:
    """MPI_Issend: completes when the receive is matched — run the
    blocking ssend (ack-based) on a worker thread."""
    from ompi_tpu_torch.pml.perrank import thread_request
    c = _comm(h)
    data = _pack(view, dt, _count_of(view, dt))
    req = thread_request(lambda: c.ssend(data, dest, tag))
    with _lock:
        rh = next(_next_req)
        _requests[rh] = (req, 0, b"")
    return rh


def request_cancel(rh: int) -> None:
    """MPI_Cancel on a glue-side request (receives only matter: sends
    here complete eagerly and are past the cancellation point)."""
    req, _dt, _snap = _take_req(rh)
    fn = getattr(req, "cancel", None)
    if fn is not None:
        fn()


# ---- matched probe (mprobe.c.in): message handles -------------------
_messages: Dict[int, Tuple[Any, int]] = {}
_next_msg = itertools.count(1)


def _msg_nbytes(m) -> int:
    d = m.data
    nb = getattr(d, "nbytes", None)
    if nb is not None:
        return int(nb)
    return 0


def mprobe(h: int, source: int, tag: int) -> Tuple[int, int, int, int]:
    c = _comm(h)
    m = c.mprobe(source, tag)
    with _lock:
        mh = next(_next_msg)
        _messages[mh] = (m, h)
    return mh, int(m.src), int(m.tag), _msg_nbytes(m)


def improbe(h: int, source: int, tag: int
            ) -> Tuple[int, int, int, int, int]:
    c = _comm(h)
    ok, m, st = c.improbe(source, tag)
    if not ok:
        return 0, 0, -1, -1, 0
    with _lock:
        mh = next(_next_msg)
        _messages[mh] = (m, h)
    return 1, mh, int(m.src), int(m.tag), _msg_nbytes(m)


def _take_msg(mh: int):
    with _lock:
        ent = _messages.pop(mh, None)
    if ent is None:
        raise MPIError(ERR_ARG, f"invalid message handle {mh}")
    return ent


def mrecv(mh: int, dt: int, curview
          ) -> Tuple[bytes, int, int, int, int, int]:
    m, h = _take_msg(mh)
    data, st = _comm(h).mrecv(m)
    if data is None:
        return b"", *_status(st), 0, 0
    out, trunc = _unpack(data, dt, _count_of(curview, dt),
                         bytes(curview))
    src, t, cnt = _status(st, out)
    return out, src, t, cnt, trunc, 0


def imrecv(mh: int, dt: int, curview) -> int:
    """The message is already matched and local: the request is born
    complete (imrecv.c.in fast path on an already-arrived frag)."""
    m, h = _take_msg(mh)
    from ompi_tpu_torch.pml.perrank import RankRequest
    req = RankRequest(m.src, m.tag)
    req._deliver(m)
    with _lock:
        rh = next(_next_req)
        _requests[rh] = (req, dt, bytes(curview))
    return rh


# ---- dynamic error space (add_error_class.c.in) ---------------------
_err_strings: Dict[int, str] = {}
_err_class_of: Dict[int, int] = {}
_next_err_class = itertools.count(101)   # past MPI_ERR_LASTCODE
_next_err_code = itertools.count(1001)


def add_error_class() -> int:
    c = next(_next_err_class)
    _err_class_of[c] = c
    _added_classes.append(c)             # LIFO removal bookkeeping
    return c


def add_error_code(cls: int) -> int:
    code = next(_next_err_code)
    _err_class_of[code] = int(cls)
    _added_codes.append(code)
    return code


def add_error_string(code: int, s: str) -> None:
    _err_strings[int(code)] = str(s)


def error_class_of(code: int) -> int:
    return _err_class_of.get(int(code), int(code))


# ---- local reduction (reduce_local.c.in) ----------------------------
def reduce_local(inview, inoutview, dt: int, o: int) -> bytes:
    op = _op(o)
    _op_ctx.dt = dt
    try:
        a, b = _arr(inview, dt), _arr(inoutview, dt)
        # MPI contract: inoutbuf = inbuf OP inoutbuf; the framework's
        # reduce_local folds numpy on the host (the native kernel table
        # for predefined ops, the C callback for a user op)
        res = np.asarray(_host(op_mod.reduce_local(a, b, op)),
                         dtype=_dtype(dt))
    finally:
        _op_ctx.dt = 0
    return res.tobytes()


# ---- Cart_sub (cart_sub.c.in) ---------------------------------------
def cart_sub(h: int, remain_view) -> int:
    """Split the cartesian comm into lower-dimension slices: ranks
    sharing every DROPPED dimension's coordinate land in one new comm,
    which keeps the remaining dims as its cartesian topology."""
    c = _comm(h)
    topo = getattr(c, "topo", None)
    if topo is None or not hasattr(topo, "sub_keep"):
        raise MPIError(ERR_TOPOLOGY,
                       "communicator has no cartesian topology")
    remain = [bool(x) for x in _ints(remain_view)]
    colors, new_topo = topo.sub_keep(remain)
    sub = c.split(colors[c.rank()], key=c.rank())
    sub.topo = new_topo
    sub.name = f"{c.name}.sub"
    return _register_comm(sub)


# ---- intra-job intercommunicators (intercomm_create.c.in) -----------
class _RankIntercomm:
    """A per-rank intercommunicator between two disjoint groups of ONE
    job: sends address the REMOTE group through a dedicated CID both
    sides derive identically; status.MPI_SOURCE is the sender's rank
    in its own (remote-to-me) group — the MPI intercomm contract."""

    is_per_rank = True

    def __init__(self, local_comm, remote_world, cid):
        from ompi_tpu_torch.pml.perrank import PerRankEngine
        self.local_comm = local_comm
        self.remote_world = list(remote_world)
        self.remote_size = len(remote_world)
        self.cid = cid
        self.name = f"intercomm#{cid[-1]}"
        outer = self

        class _View:
            """Engine addressing shim: rank() = MY local rank (the
            header's source field), world_rank_of = REMOTE group."""
            cid = outer.cid
            size = outer.remote_size

            def rank(self):
                return outer.local_comm.rank()

            def world_rank_of(self, j):
                return outer.remote_world[j]

        self._pml = PerRankEngine(_View(), local_comm.router)

    @property
    def size(self) -> int:
        return self.local_comm.size      # MPI_Comm_size: LOCAL size

    def rank(self) -> int:
        return self.local_comm.rank()

    def send(self, data, dest: int, tag: int = 0):
        return self._pml.send(data, dest, tag)

    def ssend(self, data, dest: int, tag: int = 0):
        return self._pml.send(data, dest, tag, synchronous=True)

    def isend(self, data, dest: int, tag: int = 0):
        return self._pml.send(data, dest, tag)

    def recv(self, source: int = -1, tag: int = -1):
        return self._pml.recv(source, tag)

    def irecv(self, source: int = -1, tag: int = -1):
        return self._pml.irecv(source, tag)

    def sendrecv(self, senddata, dest, source=-1, sendtag=0,
                 recvtag=-1):
        req = self._pml.irecv(source, recvtag)
        self._pml.send(senddata, dest, sendtag)
        st = req.wait()
        return req.get(), st

    def free(self) -> None:
        self._pml.close()

    def disconnect(self) -> None:
        self.free()


def intercomm_create(lh: int, local_leader: int, ph: int,
                     remote_leader: int, tag: int) -> int:
    local = _comm(lh)
    peer = _comm(ph)
    my_worlds = [local.world_rank_of(i) for i in range(local.size)]
    # the two leaders swap group rosters through the peer comm; every
    # member then learns the remote roster via its local leader
    if local.rank() == local_leader:
        req = peer.irecv(remote_leader, tag)
        peer.send(my_worlds, remote_leader, tag)
        req.wait()
        remote = req.get()
    else:
        remote = None
    remote = local.bcast(remote, root=local_leader)
    # identical CID on both sides: the ordered pair of rosters + tag
    a, b = sorted([tuple(my_worlds), tuple(remote)])
    cid = ("ic", a, b, int(tag))
    inter = _RankIntercomm(local, remote, cid)
    return _register_comm(inter)


def intercomm_merge(h: int, high: int) -> int:
    inter = _comms.get(h) if h >= _FIRST_DYNAMIC else None
    if not isinstance(inter, _RankIntercomm):
        raise MPIError(ERR_COMM, "not an intra-job intercommunicator")
    from ompi_tpu_torch.core.group import Group
    from ompi_tpu_torch.core.rankcomm import RankCommunicator
    local = inter.local_comm
    mine = [local.world_rank_of(i) for i in range(local.size)]
    # group order: low group first; ties (same high flag both sides)
    # break on smallest world rank, the reference's documented rule
    # (intercomm_merge.c.in)
    me_key = (bool(high), min(mine))     # low group sorts first
    peer_key = None
    # the high flag must be consistent within each group; leaders
    # exchange it so both sides order identically
    if local.rank() == 0:
        inter.send(int(high), 0, tag=0)
        flag, _st = inter.recv(0, tag=0)
        peer_key = (bool(int(flag)), min(inter.remote_world))
    peer_key = local.bcast(peer_key, root=0)
    ordered = (mine + inter.remote_world
               if me_key < peer_key else
               inter.remote_world + mine)
    cid = ("icm", inter.cid)
    flat = RankCommunicator(Group(ordered), local._my_world,
                            local.router, local.device, cid=cid,
                            name="intercomm-merge")
    return _register_comm(flat)


def comm_create_group(h: int, gh: int, tag: int) -> int:
    """MPI_Comm_create_group: collective over the GROUP only — members
    not in the group never call (comm_create would deadlock there).
    The CID derives from the member roster + tag, which every member
    computes identically with zero traffic."""
    c = _comm(h)
    g = _group(gh)
    from ompi_tpu_torch.core.group import Group
    from ompi_tpu_torch.core.rankcomm import RankCommunicator
    worlds = list(g.world_ranks)
    me = c.world_rank_of(c.rank())
    if me not in worlds:
        raise MPIError(ERR_GROUP,
                       "caller is not a member of the group")
    cid = ("cg", c.cid, tuple(worlds), int(tag))
    sub = RankCommunicator(Group(worlds), me, c.router, c.device, cid=cid,
                           name=f"comm-group#{tag}", parent=c)
    return _register_comm(sub)


# ---- Alltoallw (alltoallw.c.in) -------------------------------------
def alltoallw(h: int, sview, scounts_v, sdispls_v, stypes_v,
              rview, rcounts_v, rdispls_v, rtypes_v) -> bytes:
    c = _comm(h)
    n = c.size
    scounts = [int(x) for x in _ints(scounts_v)]
    sdispls = [int(x) for x in _ints(sdispls_v)]
    stypes = np.frombuffer(bytes(stypes_v), dtype=np.int64)
    rcounts = [int(x) for x in _ints(rcounts_v)]
    rdispls = [int(x) for x in _ints(rdispls_v)]
    rtypes = np.frombuffer(bytes(rtypes_v), dtype=np.int64)
    sbytes = bytes(sview)
    chunks = []
    for j in range(n):
        dtj, cj, off = int(stypes[j]), scounts[j], sdispls[j]
        wl = _window_len(dtj, cj)
        chunks.append(_pack(memoryview(sbytes)[off:off + wl], dtj, cj))
    out = c.alltoall(chunks)
    cur = bytearray(bytes(rview))
    for j in range(n):
        dtj, cj, off = int(rtypes[j]), rcounts[j], rdispls[j]
        wl = _window_len(dtj, cj)
        img, _tr = _unpack(out[j], dtj, cj, bytes(cur[off:off + wl]))
        cur[off:off + wl] = img
    return bytes(cur)


# ---- file views + individual pointers (file_set_view.c.in) ----------
_file_views: Dict[int, Tuple[int, int, int, str]] = {}
_file_pos: Dict[int, int] = {}
_file_amodes: Dict[int, int] = {}


def _view_of(fh: int) -> Tuple[int, int, int, str]:
    return _file_views.get(fh, (0, 4, 4, "native"))   # BYTE/BYTE


def file_set_view(fh: int, disp: int, et: int, ft: int,
                  rep: str) -> None:
    f = _file(fh)
    if rep not in ("native", "internal"):
        raise MPIError(ERR_ARG,
                       f"unsupported data representation {rep!r} "
                       f"(native/internal only)")
    if type_size_bytes(et) <= 0 or type_size_bytes(ft) <= 0:
        raise MPIError(ERR_TYPE, "zero-size etype/filetype")
    if type_window_off_bytes(ft) != 0:
        raise MPIError(ERR_TYPE,
                       "negative-lb filetypes unsupported in views")
    _file_views[fh] = (int(disp), int(et), int(ft), rep)
    _file_pos[fh] = 0
    f.seek_shared(0)                     # set_view resets BOTH pointers


def file_get_view(fh: int) -> Tuple[int, int, int, str]:
    _file(fh)
    return _view_of(fh)


def file_seek(fh: int, offset: int, whence: int) -> None:
    _file(fh)
    disp, et, ft, _rep = _view_of(fh)
    if whence == 0:                      # MPI_SEEK_SET
        _file_pos[fh] = int(offset)
    elif whence == 1:                    # MPI_SEEK_CUR
        _file_pos[fh] = _file_pos.get(fh, 0) + int(offset)
    elif whence == 2:                    # MPI_SEEK_END
        esz = type_size_bytes(et)
        sigb = type_size_bytes(ft)
        extb = type_extent_bytes(ft)
        fsize = _file(fh).get_size()
        data = max(0, fsize - disp)
        tiles, rem = divmod(data, extb)
        vis = tiles * sigb + min(rem, sigb)
        _file_pos[fh] = vis // esz + int(offset)
    else:
        raise MPIError(ERR_ARG, f"bad whence {whence}")
    if _file_pos[fh] < 0:
        raise MPIError(ERR_ARG, "file pointer before view start")


def file_get_position(fh: int) -> int:
    _file(fh)
    return int(_file_pos.get(fh, 0))


def _vis_runs(fh: int, vis0: int, n: int):
    """Map [vis0, vis0+n) visible bytes through the filetype tiling to
    coalesced (file_offset, length) byte runs (the reference's
    flattened-filetype iovec, ompio build_io_array role)."""
    disp, _et, ft, _rep = _view_of(fh)
    sigb = type_size_bytes(ft)
    extb = type_extent_bytes(ft)
    if sigb == extb:                     # trivial (contiguous) view
        return [(disp + vis0, n)]
    bidx = _to_byte_idx(ft)              # sig byte offsets in one tile
    v = np.arange(vis0, vis0 + n, dtype=np.int64)
    fbyte = disp + (v // sigb) * extb + bidx[v % sigb]
    runs = []
    if n:
        starts = np.flatnonzero(np.diff(fbyte) != 1)
        prev = 0
        for s in list(starts) + [n - 1]:
            runs.append((int(fbyte[prev]), int(s - prev + 1)))
            prev = s + 1
    return runs


def _vis_read(fh: int, vis0: int, n: int) -> bytes:
    f = _file(fh)
    parts = [bytes(f.read_at(off, ln).view(np.uint8).tobytes())
             for off, ln in _vis_runs(fh, vis0, n)]
    return b"".join(parts)


def _vis_write(fh: int, vis0: int, data: bytes) -> None:
    f = _file(fh)
    pos = 0
    for off, ln in _vis_runs(fh, vis0, len(data)):
        f.write_at(off, np.frombuffer(data[pos:pos + ln], np.uint8))
        pos += ln


def _ind_offset(fh: int, offset: int, advance_elems: int,
                et: int) -> int:
    """Resolve -1 to the individual pointer (etype units) and advance
    it; explicit offsets leave the pointer alone (MPI _at semantics)."""
    if offset == -1:
        pos = _file_pos.get(fh, 0)
        _file_pos[fh] = pos + advance_elems
        return pos
    return int(offset)


def file_read_ind(fh: int, offset: int, nbytes: int, dt: int,
                  curview) -> Tuple[bytes, int]:
    disp, et, ft, _rep = _view_of(fh)
    esz = type_size_bytes(et)
    pos = _ind_offset(fh, offset, int(nbytes) // esz, et)
    raw = _vis_read(fh, pos * esz, int(nbytes))
    flat = np.frombuffer(raw, dtype=np.uint8)
    base = type_base_bytes(dt)
    usable = (flat.nbytes // base) * base
    flat = flat[:usable]
    bdt, _i, _e = _type_parts(dt)
    flat = flat.view(bdt)
    cnt = _count_of(curview, dt) if len(curview) else flat.size
    return _unpack(flat, dt, cnt, bytes(curview))[0], int(flat.nbytes)


def file_write_ind(fh: int, offset: int, view, dt: int) -> int:
    disp, et, ft, _rep = _view_of(fh)
    esz = type_size_bytes(et)
    a = _pack(view, dt, _count_of(view, dt))
    data = a.view(np.uint8).tobytes()
    pos = _ind_offset(fh, offset, len(data) // esz, et)
    _vis_write(fh, pos * esz, data)
    return int(a.nbytes)


def file_get_amode(fh: int) -> int:
    # stored MPI amode (not the translated os flags)
    return int(_file_amodes.get(fh, 0))


def file_preallocate(fh: int, nbytes: int) -> None:
    _file(fh).preallocate(int(nbytes))


def _file_seek_shared_impl(fh: int, offset: int, whence: int) -> None:
    f = _file(fh)
    disp, et, ft, _rep = _view_of(fh)
    esz = type_size_bytes(et)
    if whence == 0:
        f.seek_shared(int(offset) * esz)
    elif whence == 1:
        f.seek_shared(f.get_position_shared() + int(offset) * esz)
    elif whence == 2:
        f.seek_shared(max(0, f.get_size() - disp) + int(offset) * esz)
    else:
        raise MPIError(ERR_ARG, f"bad whence {whence}")


def file_seek_shared(fh: int, offset: int, whence: int) -> None:
    # the pointer write orders behind pending i-ops on this file
    return _file_blocking_serial(fh, _file_seek_shared_impl, fh,
                                 offset, whence)


def file_get_position_shared(fh: int) -> int:
    f = _file(fh)
    _disp, et, _ft, _rep = _view_of(fh)
    return int(f.get_position_shared()) // type_size_bytes(et)


def _file_read_ordered_impl(fh: int, offset: int, nbytes: int,
                            dt: int, curview) -> Tuple[bytes, int]:
    f = _file(fh)
    disp, et, ft, _rep = _view_of(fh)
    if type_size_bytes(ft) != type_extent_bytes(ft) or disp:
        raise MPIError(ERR_TYPE, "ordered access needs a trivial view")
    raw = f.read_ordered(int(nbytes))
    flat = np.ascontiguousarray(raw).view(np.uint8)
    bdt, _i, _e = _type_parts(dt)
    usable = (flat.nbytes // bdt.itemsize) * bdt.itemsize
    flat = flat[:usable].view(bdt)
    cnt = _count_of(curview, dt) if len(curview) else flat.size
    return _unpack(flat, dt, cnt, bytes(curview))[0], int(flat.nbytes)


def file_read_ordered(fh: int, offset: int, nbytes: int, dt: int,
                      curview) -> Tuple[bytes, int]:
    return _file_blocking_serial(fh, _file_read_ordered_impl, fh,
                                 offset, nbytes, dt, curview)


def _file_write_ordered_impl(fh: int, offset: int, view,
                             dt: int) -> int:
    f = _file(fh)
    disp, et, ft, _rep = _view_of(fh)
    if type_size_bytes(ft) != type_extent_bytes(ft) or disp:
        raise MPIError(ERR_TYPE, "ordered access needs a trivial view")
    a = _pack(view, dt, _count_of(view, dt))
    f.write_ordered(a.view(np.uint8))
    return int(a.nbytes)


def file_write_ordered(fh: int, offset: int, view, dt: int) -> int:
    return _file_blocking_serial(fh, _file_write_ordered_impl, fh,
                                 offset, view, dt)


class _FileReadReq:
    """Request adapter: the inner request completes with raw visible
    bytes; get() decodes into the posted datatype's base so the glue
    wait/unpack path can overlay (derived types keep their gaps)."""

    def __init__(self, inner, dt):
        self._inner = inner
        self._dt = dt

    def wait(self, timeout=None):
        return self._inner.wait(timeout)

    def test(self):
        return self._inner.test()

    def get(self):
        raw = self._inner.get()
        bdt, _i, _e = _type_parts(self._dt)
        flat = np.frombuffer(raw or b"", np.uint8)
        usable = (flat.nbytes // bdt.itemsize) * bdt.itemsize
        return flat[:usable].view(bdt)


def file_iread(fh: int, offset: int, nbytes: int, dt: int,
               curview) -> int:
    snap = bytes(curview)
    # resolve the individual pointer NOW (i-ops are ordered at call)
    _disp, et, _ft, _rep = _view_of(fh)
    esz = type_size_bytes(et)
    pos = _ind_offset(fh, offset, int(nbytes) // esz, et)
    req = _file_nb_req(fh,
                       lambda: _vis_read(fh, pos * esz, int(nbytes)))
    with _lock:
        rh = next(_next_req)
        _requests[rh] = (_FileReadReq(req, dt), dt, snap)
    return rh


def file_iwrite(fh: int, offset: int, view, dt: int) -> int:
    a = _pack(view, dt, _count_of(view, dt))
    data = a.view(np.uint8).tobytes()
    disp, et, ft, _rep = _view_of(fh)
    esz = type_size_bytes(et)
    pos = _ind_offset(fh, offset, len(data) // esz, et)
    req = _file_nb_req(fh, lambda: _vis_write(fh, pos * esz, data))
    with _lock:
        rh = next(_next_req)
        _requests[rh] = (req, 0, b"")
    return rh


# ---- dynamic RMA windows (win_create_dynamic.c.in) ------------------
class _DynRegions:
    """Slice-indexable address-space storage for a dynamic window:
    resolves absolute addresses into attached regions (win_attach) and
    exposes the numpy get/set surface RankWindow's handler uses."""

    def __init__(self):
        self.regions = []                # (addr, size, uint8 view)

    def _resolve(self, start: int, stop: int):
        for addr, size, view in self.regions:
            if addr <= start and stop <= addr + size:
                return view, start - addr
        raise MPIError(ERR_ARG,
                       f"RMA range [{start:#x},{stop:#x}) is not "
                       f"attached to this dynamic window")

    def __getitem__(self, key):
        if isinstance(key, slice):
            view, off = self._resolve(key.start, key.stop)
            return view[off:off + (key.stop - key.start)]
        view, off = self._resolve(key, key + 1)
        return view[off]

    def __setitem__(self, key, val):
        if isinstance(key, slice):
            view, off = self._resolve(key.start, key.stop)
            view[off:off + (key.stop - key.start)] = val
        else:
            view, off = self._resolve(key, key + 1)
            view[off] = val


def win_create_dynamic(h: int) -> int:
    from ompi_tpu_torch.osc.perrank import RankWindow
    c = _comm(h)
    win = RankWindow(c, 0, dtype=np.uint8, name="cabi_windyn")
    win.local = _DynRegions()
    # origin-side bounds checks are impossible (attach sets are local
    # to each target): advertise an unbounded exposure; the target's
    # resolve raises on unattached ranges
    win.size = 1 << 62
    win.sizes = [1 << 62] * c.size
    win._disp_units = [1] * c.size       # disps are absolute addresses
    with _lock:
        wh = next(_next_win)
        _wins[wh] = win
    return wh


def win_attach(wh: int, addr: int, size: int) -> None:
    import ctypes
    w = _win(wh)
    if not isinstance(w.local, _DynRegions):
        raise MPIError(ERR_ARG, "win_attach needs a dynamic window")
    buf = (ctypes.c_ubyte * int(size)).from_address(int(addr))
    view = np.frombuffer(buf, dtype=np.uint8)
    if not view.flags.writeable:
        view = np.ctypeslib.as_array(buf)
    w.local.regions.append((int(addr), int(size), view))


def win_detach(wh: int, addr: int) -> None:
    w = _win(wh)
    if not isinstance(w.local, _DynRegions):
        raise MPIError(ERR_ARG, "win_detach needs a dynamic window")
    before = len(w.local.regions)
    w.local.regions = [r for r in w.local.regions if r[0] != int(addr)]
    if len(w.local.regions) == before:
        raise MPIError(ERR_ARG, "address was not attached")


# ---- wave-4 closers: thread queries, object info, names -------------
def query_thread() -> int:
    from ompi_tpu_torch.runtime import init as rt
    return int(rt.query_thread())


def is_thread_main() -> int:
    import threading
    return int(threading.current_thread() is threading.main_thread())


def comm_remote_group(h: int) -> int:
    c = _comm(h)
    from ompi_tpu_torch.core.group import Group
    if getattr(c, "remote_size", None) is None:
        raise MPIError(ERR_COMM, "not an intercommunicator")
    remote = getattr(c, "remote_world", None)
    if remote is not None:               # intra-job _RankIntercomm
        return _register_group(Group(list(remote)))
    rcomm = getattr(c, "remote_comm", None)
    if rcomm is not None:                # single-controller Intercomm
        return _register_group(Group(list(rcomm.group.world_ranks)))
    # cross-job bridge: the remote job's world ranks live in ANOTHER
    # rank namespace — fabricating 0..rs-1 would alias local ranks and
    # corrupt group algebra; refuse honestly
    raise MPIError(ERR_COMM,
                   "remote group is not addressable across a cross-job "
                   "bridge intercommunicator (separate world-rank "
                   "namespaces)")


_obj_infos: Dict[Tuple[str, int], int] = {}


def _obj_check(kind: str, h: int) -> None:
    {"comm": _comm, "win": _win, "file": _file}[kind](h)


def obj_set_info(kind: str, h: int, ih: int) -> None:
    """MPI_Comm/Win/File_set_info: hints are accepted and retrievable
    (none change behavior yet — the reference ignores unknown hints
    the same way). The handle is validated like every other entry
    point, and a replaced hint set frees its predecessor."""
    _obj_check(kind, h)
    old = _obj_infos.get((kind, int(h)))
    _obj_infos[(kind, int(h))] = int(info_dup(ih))
    if old is not None:
        try:
            info_free(old)
        except MPIError:
            pass


def obj_get_info(kind: str, h: int) -> int:
    _obj_check(kind, h)
    ih = _obj_infos.get((kind, int(h)))
    return info_dup(ih) if ih is not None else info_create()


_type_names: Dict[int, str] = {}


def type_set_name(dt: int, name: str) -> None:
    type_commit(dt)                      # validates either handle kind
    _type_names[int(dt)] = str(name)


def type_get_name(dt: int) -> str:
    got = _type_names.get(int(dt))
    if got is not None:
        return got
    if dt >= _FIRST_DYN_TYPE:
        return ""                        # unnamed derived type
    return {1: "MPI_CHAR", 2: "MPI_SIGNED_CHAR", 3: "MPI_UNSIGNED_CHAR",
            4: "MPI_BYTE", 5: "MPI_SHORT", 6: "MPI_UNSIGNED_SHORT",
            7: "MPI_INT", 8: "MPI_UNSIGNED", 9: "MPI_LONG",
            10: "MPI_UNSIGNED_LONG", 11: "MPI_LONG_LONG",
            12: "MPI_UNSIGNED_LONG_LONG", 13: "MPI_FLOAT",
            14: "MPI_DOUBLE", 15: "MPI_C_BOOL", 16: "MPI_INT8_T",
            17: "MPI_INT16_T", 18: "MPI_INT32_T", 19: "MPI_INT64_T",
            20: "MPI_UINT8_T", 21: "MPI_UINT16_T", 22: "MPI_UINT32_T",
            23: "MPI_UINT64_T", 24: "MPI_AINT", 25: "MPI_COUNT",
            26: "MPI_OFFSET"}.get(int(dt), "")


def type_match_size(typeclass: int, nbytes: int) -> int:
    """MPI_Type_match_size: the predefined type of a class with the
    requested size (type_match_size.c.in)."""
    table = {1: {4: 13, 8: 14},          # REAL: float, double
             2: {1: 16, 2: 17, 4: 18, 8: 19}}   # INTEGER: intN_t
    got = table.get(int(typeclass), {}).get(int(nbytes))
    if got is None:
        raise MPIError(ERR_ARG,
                       f"no predefined type of class {typeclass} with "
                       f"size {nbytes}")
    return got


def _all_with_barrier(fh: int, op):
    """Collective completion around a fallible per-rank IO op: EVERY
    rank reaches the barrier even when its own op failed (the
    collective-hang class io/perrank.py's open avoids the same way),
    then the local failure surfaces."""
    exc = None
    out = None
    try:
        out = op()
    except BaseException as e:           # noqa: BLE001 — re-raised
        exc = e
    _file(fh).comm.barrier()
    if exc is not None:
        raise exc
    return out


def file_read_all(fh: int, offset: int, nbytes: int, dt: int,
                  curview) -> Tuple[bytes, int]:
    """MPI_File_read_all: collective at the INDIVIDUAL pointer — the
    view-relative read plus the collective completion the two-phase
    path provides for _at_all; with per-rank individual pointers the
    aggregation happens at the byte-run level already, so the
    collective contract reduces to a completion barrier."""
    return _all_with_barrier(
        fh, lambda: file_read_ind(fh, offset, nbytes, dt, curview))


def file_write_all(fh: int, offset: int, view, dt: int) -> int:
    return _all_with_barrier(
        fh, lambda: file_write_ind(fh, offset, view, dt))


# ---- shared-memory windows (win_allocate_shared.c.in; osc/sm) -------
def win_allocate_shared(h: int, nbytes: int,
                        disp_unit: int) -> Tuple[int, int]:
    """MPI_Win_allocate_shared: ONE /dev/shm segment holds every
    rank's contribution contiguously; every process maps the whole,
    so plain C loads/stores reach ANY rank's portion directly (the
    osc/sm model — no RPC on the load/store path) while the usual
    acked RMA ops keep working against each rank's slice. Returns
    (window handle, address of MY portion in THIS process)."""
    import os as _os
    c = _comm(h)
    from ompi_tpu_torch.osc.perrank import RankWindow
    sizes = [int(s) for s in c.allgather(np.int64(int(nbytes)))]
    offsets = [0]
    for s in sizes[:-1]:
        offsets.append(offsets[-1] + s)
    total = max(1, sum(sizes))
    r = c.rank()
    name = None
    if r == 0:
        name = f"ompitpu_shmwin_{_os.getpid()}_{id(c) & 0xffff:x}"
        with open(f"/dev/shm/{name}", "wb") as f:
            f.truncate(total)
    name = c.bcast(name, root=0)
    mm = np.memmap(f"/dev/shm/{name}", dtype=np.uint8, mode="r+",
                   shape=(total,))
    c.barrier()                          # everyone mapped
    if r == 0:
        _os.unlink(f"/dev/shm/{name}")   # segment dies with the job
    my = mm[offsets[r]:offsets[r] + int(nbytes)]
    win = RankWindow(c, int(nbytes), dtype=np.uint8,
                     name=f"shmwin:{name}", storage=my)
    win._shm_map = mm
    win._shm_offsets = offsets
    win._shm_sizes = sizes
    win._disp_units = [int(u) for u in
                       c.allgather(np.int64(max(int(disp_unit), 1)))]
    with _lock:
        wh = next(_next_win)
        _wins[wh] = win
    return wh, int(mm.ctypes.data) + offsets[r]


def win_shared_query(wh: int, rank: int) -> Tuple[int, int, int]:
    """(size, disp_unit, address of RANK's portion in MY mapping).
    rank MPI_PROC_NULL (-2) means 'the lowest rank', per standard."""
    w = _win(wh)
    mm = getattr(w, "_shm_map", None)
    if mm is None:
        raise MPIError(ERR_ARG, "not a shared-memory window")
    t = 0 if rank == -2 else int(rank)
    if not 0 <= t < len(w._shm_sizes):
        raise MPIError(ERR_RANK, f"bad target rank {rank}")
    return (w._shm_sizes[t], w._disp_units[t],
            int(mm.ctypes.data) + w._shm_offsets[t])


# ---- PSCW active-target epochs (win_post.c.in family) ---------------
def _group_local_ranks(w, gh: int) -> list:
    g = _group(gh)
    out = []
    for wr in g.world_ranks:
        lr = w.comm.group.rank_of(wr)
        if lr < 0:
            raise MPIError(ERR_GROUP,
                           f"group member {wr} is not in the window's "
                           f"communicator")
        out.append(lr)
    return out


def win_post(wh: int, gh: int) -> None:
    w = _win(wh)
    w.post(_group_local_ranks(w, gh))


def win_start(wh: int, gh: int) -> None:
    w = _win(wh)
    w.start(_group_local_ranks(w, gh))


def win_complete(wh: int) -> None:
    _win(wh).complete()


def win_wait(wh: int) -> None:
    _win(wh).wait()


def win_set_name(wh: int, name: str) -> None:
    _win(wh).name = str(name)


def win_get_name(wh: int) -> str:
    return str(_win(wh).name)


def comm_idup(h: int) -> Tuple[int, int]:
    """MPI_Comm_idup: duplication here is synchronous under the hood
    (deterministic CIDs need no traffic), so the request is born
    complete — legal: completion at MPI_Wait is a lower bound."""
    newh = comm_dup(h)
    from ompi_tpu_torch.pml.perrank import RankRequest, _Msg
    req = RankRequest(-1, -1)
    req._deliver(_Msg(-1, 0, None))
    with _lock:
        rh = next(_next_req)
        _requests[rh] = (req, 0, b"")
    return newh, rh


# ---- external32 (pack_external.c.in; MPI-3.1 13.5.2) ----------------
def _external32_swap(a: np.ndarray) -> np.ndarray:
    """Native <-> external32: big-endian fixed-size representation.
    This runtime's basic types already match external32 sizes, so the
    transform is a byte order swap on little-endian hosts."""
    if a.dtype.byteorder == ">" or a.dtype.itemsize == 1:
        return a
    import sys as _sys
    if _sys.byteorder == "big":
        return a
    return a.byteswap()


def _external32_check(dt: int) -> None:
    """Byte-granular layouts (heterogeneous structs, misaligned
    h-types) pack as raw uint8 soup with no element structure left to
    byte-swap — emitting them as 'external32' would silently ship
    native-endian data. Refuse rather than lie on the wire."""
    if dt >= _FIRST_DYN_TYPE and _dyn(dt).base is None:
        raise MPIError(ERR_TYPE,
                       "external32 requires an element-structured "
                       "datatype (heterogeneous/misaligned layouts "
                       "lose the element boundaries needed for byte "
                       "order conversion)")


def pack_external(view, dt: int, count: int) -> bytes:
    _external32_check(dt)
    a = _pack(view, dt, count)
    return _external32_swap(a).tobytes()


def unpack_external(data_view, dt: int, count: int, curview) -> bytes:
    _external32_check(dt)
    bdt, _i, _e = _type_parts(dt)
    flat = np.frombuffer(data_view, dtype=np.uint8)
    usable = (flat.nbytes // bdt.itemsize) * bdt.itemsize
    typed = flat[:usable].view(bdt)
    return _unpack(_external32_swap(typed), dt, count,
                   bytes(curview))[0]


# ---- spawn of executables (comm_spawn.c.in) -------------------------
_parent_comm_handle: Optional[int] = None
_spawned_procs: list = []                # reaped opportunistically


def comm_spawn(h: int, command: str, argv_joined: str, maxprocs: int,
               root: int) -> int:
    """MPI_Comm_spawn: the root launches ``maxprocs`` OS processes
    running ``command`` under a fresh mpirun --per-rank job whose
    MPI_Init dials back through the dpm port plane
    (OMPI_TPU_TORCH_PARENT_PORT); both jobs then hold a cross-job
    intercommunicator — the PMPI parent-nspace handshake over this
    runtime's coordination plane (reference: dpm.c:108-170 +
    comm_spawn.c.in). The child job is the port's own ``tools/mpirun.py``
    and inherits this process's environment, ``OMPI_TPU_TORCH_MCA_*``
    included: a CPU job spawns CPU children, a card job card
    children."""
    import os as _os
    import subprocess as _sp
    import sys as _sys
    c = _comm(h)
    argv = ([a for a in argv_joined.split("\x1f") if a != ""]
            if argv_joined else [])
    return _spawn_launch(c, root, int(maxprocs), [command, *argv])


def _spawn_launch(c, root: int, nprocs: int, cmdline: list) -> int:
    """Shared launch/accept plumbing for Comm_spawn and
    Comm_spawn_multiple: the root forks an mpirun --per-rank job with
    the parent port in its env; every rank joins the bounded
    collective accept (a command that fails to exec surfaces as an
    error, not a hang)."""
    import os as _os
    import subprocess as _sp
    import sys as _sys
    from ompi_tpu_torch.core import dpm_perrank as dpm
    # reap earlier spawns that have since exited (no zombie per spawn)
    global _spawned_procs
    _spawned_procs = [p for p in _spawned_procs if p.poll() is None]
    port = dpm.open_port() if c.rank() == root else None
    port = c.bcast(port, root=root)
    if c.rank() == root:
        mpirun = _os.path.join(
            _os.path.dirname(_os.path.dirname(
                _os.path.abspath(__file__))), "tools", "mpirun.py")
        env = dict(_os.environ)
        env["OMPI_TPU_TORCH_PARENT_PORT"] = port
        _spawned_procs.append(
            _sp.Popen([_sys.executable, mpirun, "--per-rank", "-n",
                       str(nprocs), *cmdline], env=env))
    inter = dpm.comm_accept(port, c, root=root, timeout=120)
    if c.rank() == root:
        dpm.close_port(port)
    return _register_comm(inter)


def comm_get_parent() -> int:
    """MPI_Comm_get_parent: COMM_NULL unless this world was spawned."""
    global _parent_comm_handle
    if _parent_comm_handle is not None:
        return _parent_comm_handle
    from ompi_tpu_torch.runtime import init as rt
    parent = getattr(rt, "_parent_intercomm", None)
    if parent is None:
        return COMM_NULL
    _parent_comm_handle = _register_comm(parent)
    return _parent_comm_handle


# ---- partitioned point-to-point (MPI-4 ch. 4; pml/part_perrank) -----
_part_reqs: Dict[int, Tuple[Any, int, int]] = {}
_next_part = itertools.count(1)          # (req, dt, is_recv)


def psend_init(h: int, view, partitions: int, count: int, dt: int,
               dest: int, tag: int) -> int:
    """MPI_Psend_init: zero-copy per-partition views over the CALLER'S
    buffer — pready(k) reads partition k's bytes at that moment, the
    partitioned contract (the buffer must stay valid until freed).
    Basic datatypes only (the reference's partitioned chapter shares
    the restriction in practice: partitions are contiguous lanes)."""
    if dt >= _FIRST_DYN_TYPE:
        raise MPIError(ERR_TYPE,
                       "partitioned transfers take basic datatypes")
    c = _comm(h)
    base = np.frombuffer(view, dtype=_dtype(dt))
    per = int(count)
    parts = [base[k * per:(k + 1) * per] for k in range(partitions)]
    from ompi_tpu_torch.pml import part_perrank as pp
    req = pp.psend_init(c, parts, dest, tag)
    with _lock:
        ph = next(_next_part)
        _part_reqs[ph] = (req, dt, 0)
    return ph


def precv_init(h: int, partitions: int, count: int, dt: int,
               source: int, tag: int) -> int:
    if dt >= _FIRST_DYN_TYPE:
        raise MPIError(ERR_TYPE,
                       "partitioned transfers take basic datatypes")
    c = _comm(h)
    from ompi_tpu_torch.pml import part_perrank as pp
    req = pp.precv_init(c, partitions, source, tag)
    with _lock:
        ph = next(_next_part)
        _part_reqs[ph] = (req, dt, 1)
    return ph


def _part(ph: int):
    with _lock:
        ent = _part_reqs.get(ph)
    if ent is None:
        raise MPIError(ERR_REQUEST, f"invalid partitioned handle {ph}")
    return ent


def part_start(ph: int) -> None:
    _part(ph)[0].start()


def part_pready(ph: int, k: int) -> None:
    _part(ph)[0].pready(int(k))


def part_pready_range(ph: int, lo: int, hi: int) -> None:
    _part(ph)[0].pready_range(int(lo), int(hi))


def part_parrived(ph: int, k: int) -> int:
    return int(bool(_part(ph)[0].parrived(int(k))))


def part_test(ph: int) -> Tuple[int, bytes, int, int, int, int, int]:
    """Non-blocking completion check WITHOUT consuming the handle."""
    req, dt, is_recv = _part(ph)
    done, st = req.test()
    if not done:
        return 0, b"", -1, -1, 0, 0, 0
    out, src, tag, nb, tr, canc = part_wait(ph)
    return 1, out, src, tag, nb, tr, canc


def part_wait(ph: int) -> Tuple[bytes, int, int, int, int, int]:
    """Completion WITHOUT consuming the handle (partitioned requests
    are persistent: Start re-arms them)."""
    req, dt, is_recv = _part(ph)
    st = req.wait()
    if not is_recv:
        return b"", int(st.source), int(st.tag), 0, 0, 0
    parts = req.get()
    out = np.concatenate([_host(p).ravel() for p in parts]) \
        if parts else np.array([], _dtype(dt))
    if out.dtype != _dtype(dt):
        out = out.astype(_dtype(dt))
    raw = out.tobytes()
    return raw, int(st.source), int(st.tag), len(raw), 0, 0


def part_free(ph: int) -> None:
    with _lock:
        if _part_reqs.pop(ph, None) is None:
            raise MPIError(ERR_REQUEST,
                           f"invalid partitioned handle {ph}")


# ---- MPI_T events + pvar write --------------------------------------
def t_pvar_write(i: int, value: int) -> None:
    from ompi_tpu_torch.mca import pvar as _p
    info = _t_pvar(i)
    _p.pvar_write(info["name"], int(value))


_t_event_regs: Dict[int, Any] = {}
_next_t_event_reg = itertools.count(1)
_t_event_instances: Dict[int, Tuple[str, int]] = {}
_next_t_event_inst = itertools.count(1)


def t_event_get_num() -> int:
    from ompi_tpu_torch.api import tool as _tool
    return int(_tool.event_get_num())


def t_event_get_index(name: str) -> int:
    from ompi_tpu_torch.api import tool as _tool
    try:
        return _tool.event_list().index(name)
    except ValueError:
        return -1


def t_event_get_info(i: int) -> Tuple[str, int, int, int, str]:
    from ompi_tpu_torch.api import tool as _tool
    names = _tool.event_list()
    if not 0 <= int(i) < len(names):
        raise MPIError(ERR_ARG, f"bad event index {i}")
    ev = _tool.event_get_info(int(i))
    # one MPI_UINT64_T element: the event's value payload
    return (ev["name"], int(ev.get("verbosity", 1)), 23, 1,
            ev.get("desc", ""))


def t_event_handle_alloc(i: int, cb_ptr: int, user_data: int) -> int:
    import ctypes
    from ompi_tpu_torch.api import tool as _tool
    names = _tool.event_list()
    if not 0 <= int(i) < len(names):
        raise MPIError(ERR_ARG, f"bad event index {i}")
    name = names[int(i)]
    reg = next(_next_t_event_reg)
    cfn = ctypes.CFUNCTYPE(None, ctypes.c_long, ctypes.c_long,
                           ctypes.c_int, ctypes.c_void_p)(cb_ptr)

    def on_event(event: str, comm, info) -> None:
        inst = next(_next_t_event_inst)
        _t_event_instances[inst] = (event,
                                    int(info.get("value", 0) or 0))
        try:
            cfn(inst, reg, 0, user_data)
        finally:
            _t_event_instances.pop(inst, None)

    handle = _tool.event_handle_alloc(name, on_event)
    _t_event_regs[reg] = (handle, cfn)   # keep the CFUNCTYPE alive
    return reg


def t_event_handle_free(reg: int) -> None:
    from ompi_tpu_torch.api import tool as _tool
    ent = _t_event_regs.pop(int(reg), None)
    if ent is None:
        raise MPIError(ERR_ARG, f"bad event registration {reg}")
    _tool.event_handle_free(ent[0])


def t_event_read(inst: int, element_index: int) -> int:
    ent = _t_event_instances.get(int(inst))
    if ent is None or element_index != 0:
        raise MPIError(ERR_ARG, "bad event instance/element")
    return int(ent[1])


def exc_code(exc: BaseException) -> int:
    """Map a glue exception to an MPI error code for the C shim."""
    if isinstance(exc, MPIError):
        return int(exc.error_class)
    if isinstance(exc, (ValueError, TypeError)):
        return ERR_ARG
    return 16                            # ERR_OTHER


# ---- MPI_T categories (ompi/mpi/tool/category_*.c): variables group
# by FRAMEWORK — the first segment of every var name, exactly the
# reference's framework-as-category convention ------------------------
def _t_cvar_names() -> list:
    return _t_stable("cvar", _t_cvars().keys())


def _t_categories() -> list:
    cats = sorted({n.split("_", 1)[0] for n in _t_cvar_names()}
                  | {n.split("_", 1)[0] for n in _t_pvar_names()})
    return cats


def t_category_get_num() -> int:
    return len(_t_categories())


def t_category_get_info(i: int) -> Tuple[str, str, int, int]:
    cats = _t_categories()
    if not 0 <= int(i) < len(cats):
        raise MPIError(ERR_ARG, f"bad category index {i}")
    c = cats[int(i)]
    ncv = sum(1 for n in _t_cvar_names() if n.split("_", 1)[0] == c)
    npv = sum(1 for n in _t_pvar_names() if n.split("_", 1)[0] == c)
    return c, f"framework {c}", ncv, npv


def t_category_get_index(name: str) -> int:
    try:
        return _t_categories().index(name)
    except ValueError:
        raise MPIError(ERR_ARG, f"no such category {name!r}") from None


def t_category_get_cvars(i: int) -> bytes:
    c = _t_categories()[int(i)]
    idxs = [k for k, n in enumerate(_t_cvar_names())
            if n.split("_", 1)[0] == c]
    return np.asarray(idxs, np.int32).tobytes()


def t_category_get_pvars(i: int) -> bytes:
    c = _t_categories()[int(i)]
    idxs = [k for k, n in enumerate(_t_pvar_names())
            if n.split("_", 1)[0] == c]
    return np.asarray(idxs, np.int32).tobytes()


# ---------------------------------------------------------------------
# neighbor v/w collectives (neighbor_allgatherv.c.in,
# neighbor_alltoallv.c.in, neighbor_alltoallw.c.in)
# ---------------------------------------------------------------------
def _overlay_v_rows(rows, rdt: int, counts, displs, curview) -> bytes:
    """Per-slot overlay at explicit element displacements in
    topology-neighbor order; None slots (PROC_NULL neighbors on
    non-periodic edges) keep the caller's bytes."""
    cur = np.frombuffer(curview, _dtype(rdt)).copy()
    for i, row in enumerate(rows):
        if row is None:
            continue
        seg = _host(row).ravel()[:int(counts[i])]
        if seg.dtype != cur.dtype:
            seg = seg.astype(cur.dtype)
        cur[int(displs[i]):int(displs[i]) + seg.size] = seg
    return cur.tobytes()


def neighbor_allgatherv(h: int, view, sdt: int, rdt: int, counts_view,
                        displs_view, curview) -> bytes:
    c = _comm(h)
    rows = c.neighbor_allgather(_pack(view, sdt, _count_of(view, sdt)))
    return _overlay_v_rows(rows, rdt, _ints(counts_view),
                           _ints(displs_view), curview)


def neighbor_alltoallv(h: int, view, sdt: int, scounts_v, sdispls_v,
                       rdt: int, rcounts_v, rdispls_v,
                       curview) -> bytes:
    c = _comm(h)
    sc, sd = _ints(scounts_v), _ints(sdispls_v)
    a = _arr(view, sdt)
    n_out = neighbor_out_count(h)
    chunks = [a[int(sd[i]):int(sd[i]) + int(sc[i])]
              for i in range(n_out)]
    rows = c.neighbor_alltoall(chunks)
    return _overlay_v_rows(rows, rdt, _ints(rcounts_v),
                           _ints(rdispls_v), curview)


def neighbor_alltoallw(h: int, sview, scounts_v, sdispls_v, stypes_v,
                       rview, rcounts_v, rdispls_v, rtypes_v) -> bytes:
    """w-variant over the topology: per-neighbor datatypes with BYTE
    (MPI_Aint) displacements, exactly the flat alltoallw marshalling
    per slot."""
    c = _comm(h)
    n_out = neighbor_out_count(h)
    n_in = neighbor_count(h)
    scounts = [int(x) for x in _ints(scounts_v)]
    sdispls = np.frombuffer(bytes(sdispls_v), dtype=np.int64)
    stypes = np.frombuffer(bytes(stypes_v), dtype=np.int64)
    sbytes = bytes(sview)
    chunks = []
    for j in range(n_out):
        dtj, cj, off = int(stypes[j]), scounts[j], int(sdispls[j])
        wl = _window_len(dtj, cj)
        chunks.append(_pack(memoryview(sbytes)[off:off + wl], dtj, cj))
    rows = c.neighbor_alltoall(chunks)
    rcounts = [int(x) for x in _ints(rcounts_v)]
    rdispls = np.frombuffer(bytes(rdispls_v), dtype=np.int64)
    rtypes = np.frombuffer(bytes(rtypes_v), dtype=np.int64)
    cur = bytearray(bytes(rview))
    for j in range(n_in):
        if j >= len(rows) or rows[j] is None:
            continue
        dtj, cj, off = int(rtypes[j]), rcounts[j], int(rdispls[j])
        wl = _window_len(dtj, cj)
        img, _tr = _unpack(rows[j], dtj, cj, bytes(cur[off:off + wl]))
        cur[off:off + wl] = img
    return bytes(cur)


def ineighbor_allgatherv(h: int, view, sdt: int, rdt: int, counts_view,
                         displs_view, curview) -> int:
    counts, displs = bytes(counts_view), bytes(displs_view)
    snap = bytes(curview)
    return _icoll_bytes(h, lambda: neighbor_allgatherv(
        h, view, sdt, rdt, counts, displs, snap))


def ineighbor_alltoallv(h: int, view, sdt: int, sc_v, sd_v, rdt: int,
                        rc_v, rd_v, curview) -> int:
    sc, sd, rc_, rd = bytes(sc_v), bytes(sd_v), bytes(rc_v), bytes(rd_v)
    snap = bytes(curview)
    return _icoll_bytes(h, lambda: neighbor_alltoallv(
        h, view, sdt, sc, sd, rdt, rc_, rd, snap))


def ineighbor_alltoallw(h: int, sview, sc_v, sd_v, st_v, rview, rc_v,
                        rd_v, rt_v) -> int:
    sc, sd, st = bytes(sc_v), bytes(sd_v), bytes(st_v)
    rc_, rd, rt = bytes(rc_v), bytes(rd_v), bytes(rt_v)
    return _icoll_bytes(h, lambda: neighbor_alltoallw(
        h, sview, sc, sd, st, rview, rc_, rd, rt))


def ialltoallw(h: int, sview, sc_v, sd_v, st_v, rview, rc_v, rd_v,
               rt_v) -> int:
    """MPI_Ialltoallw over the nonblocking worker (the per-peer
    marshalling runs there too — real overlap on per-rank comms)."""
    sc, sd, st = bytes(sc_v), bytes(sd_v), bytes(st_v)
    rc_, rd, rt = bytes(rc_v), bytes(rd_v), bytes(rt_v)
    return _icoll_bytes(h, lambda: alltoallw(
        h, sview, sc, sd, st, rview, rc_, rd, rt))


# ---------------------------------------------------------------------
# persistent collectives (MPI-4 *_init family; allreduce_init.c.in,
# barrier_init.c.in, ... — the reference routes them through
# ompi/mca/coll's *_init slots). Each MPI_X_init captures the
# nonblocking marshaller with its C-side argument VIEWS held live (not
# snapshotted): persistent semantics — the send buffer and the
# count/displacement arrays are re-read at every MPI_Start, and MPI-4
# requires the caller keep them valid and unchanged until
# MPI_Request_free.
# ---------------------------------------------------------------------
_pcolls: Dict[int, Any] = {}
_next_pcoll = itertools.count(1)


def _pcoll_register(thunk) -> int:
    with _lock:
        ph = next(_next_pcoll)
        _pcolls[ph] = thunk
    return ph


def _pcoll_prebind(name: str, *args):
    """Pre-bound persistent-collective thunk (coll/persistent's cabi
    leg): the handle->comm resolution, op mapping, and element-count
    arithmetic the one-shot marshaller re-derives at every MPI_Start
    run ONCE here; Start re-reads only the C buffer bytes (persistent
    semantics: the app refills the registered buffer between rounds)
    and dispatches the comm's nonblocking entry — which rides the
    BucketFuser when ``mpi_base_bucket`` is on. Returns None when the
    collective has no prebound form (generic re-dispatch glue)."""
    if name == "allreduce":
        h, view, dt, o = args
        c, op = _comm(h), _op(o)
        cnt = _count_of(view, dt)

        def thunk():
            snap = bytes(view)
            return _icoll_handle(
                c.iallreduce(_pack(view, dt, cnt), op), dt, snap)
        return thunk
    if name == "bcast":
        h, view, dt, root = args
        c = _comm(h)
        cnt = _count_of(view, dt)
        is_root = c.rank() == root

        def thunk():
            data = _pack(view, dt, cnt) if is_root else None
            return _icoll_handle(c.ibcast(data, root), dt, bytes(view))
        return thunk
    if name == "barrier":
        (h,) = args
        c = _comm(h)
        return lambda: _icoll_handle(c.ibarrier(), 4)
    return None


def pcoll_init(name: str, *args) -> int:
    thunk = None
    try:
        thunk = _pcoll_prebind(name, *args)
    except MPIError:
        raise                            # arg validation stays loud
    except Exception:                    # noqa: BLE001 — prebind is an
        thunk = None                     # optimization, never a gate
    if thunk is None:
        fn = globals()["i" + name]
        thunk = lambda: fn(*args)        # noqa: E731
    return _pcoll_register(thunk)


def pcoll_alltoallw_init(h: int, sview, sc_v, sd_v, st_v, rview, rc_v,
                         rd_v, rt_v) -> int:
    """The w-variants' datatype arrays are C-side TEMPORARIES (the
    wrapper widens MPI_Datatype[] to int64 in malloc'd scratch freed
    on return), so they are snapshotted at init; the data buffers
    stay live per persistent semantics."""
    sc, sd, st = bytes(sc_v), bytes(sd_v), bytes(st_v)
    rc_, rd, rt = bytes(rc_v), bytes(rd_v), bytes(rt_v)
    return _pcoll_register(lambda: ialltoallw(
        h, sview, sc, sd, st, rview, rc_, rd, rt))


def pcoll_neighbor_alltoallw_init(h: int, sview, sc_v, sd_v, st_v,
                                  rview, rc_v, rd_v, rt_v) -> int:
    sc, sd, st = bytes(sc_v), bytes(sd_v), bytes(st_v)
    rc_, rd, rt = bytes(rc_v), bytes(rd_v), bytes(rt_v)
    return _pcoll_register(lambda: ineighbor_alltoallw(
        h, sview, sc, sd, st, rview, rc_, rd, rt))


def pcoll_start(ph: int) -> int:
    """MPI_Start on a persistent collective: dispatch a fresh
    nonblocking operation; returns the inner request handle the
    ordinary wait/test paths complete."""
    thunk = _pcolls.get(ph)
    if thunk is None:
        raise MPIError(ERR_REQUEST,
                       "stale persistent-collective handle")
    from ompi_tpu_torch.coll import persistent as _persistent
    _persistent._count("coll_persistent_starts")
    return thunk()


def pcoll_startall(phs) -> list:
    """MPI_Startall over persistent collectives: dispatch every
    captured thunk inside one startall window, so bucketable
    allreduces accumulated by the fuser flush at the boundary — K
    small allreduces issue ceil(K*bytes/bucket_bytes) wire collectives
    instead of K. Returns the inner request handles in call order."""
    from ompi_tpu_torch.coll import persistent as _persistent
    out = []
    with _persistent.startall_window():
        for ph in phs:
            out.append(pcoll_start(int(ph)))
    return out


def pcoll_free(ph: int) -> None:
    _pcolls.pop(ph, None)


# ---------------------------------------------------------------------
# win/type keyvals + attributes (win_create_keyval.c.in,
# type_create_keyval.c.in): the comm attribute model over a generic
# (kind, handle)-keyed registry. delete_fn fires on delete/overwrite/
# free; MPI_Type_dup propagates attributes through copy_fn (the only
# dup operation these object classes have).
# ---------------------------------------------------------------------
_obj_keyvals: Dict[int, Tuple[Any, Any]] = {}
_next_obj_kv = itertools.count(1 << 20)   # disjoint from comm keyvals
_obj_attrs: Dict[Tuple[str, int], Dict[int, int]] = {}


def obj_create_keyval_c(copy_ptr: int, delete_ptr: int,
                        extra: int) -> int:
    """Keyval for win/type attributes with real C callback invocation;
    first callback argument is the raw integer handle (every handle
    class here is an int token, so the comm trampoline shape serves
    all — see _attr_trampolines)."""
    copy_py, delete_py, keep = _attr_trampolines(
        copy_ptr, delete_ptr, extra, int)
    with _lock:
        kv = next(_next_obj_kv)
        _obj_keyvals[kv] = (copy_py, delete_py)
    if keep:
        _keyval_refs[kv] = keep
    return kv


def obj_free_keyval(kv: int) -> None:
    _obj_keyvals.pop(int(kv), None)
    _keyval_refs.pop(int(kv), None)


def obj_set_attr(kind: str, h: int, keyval: int, value: int) -> None:
    kv = int(keyval)
    if kv not in _obj_keyvals:
        raise MPIError(ERR_ARG, f"unknown {kind} keyval {kv}")
    d = _obj_attrs.setdefault((kind, int(h)), {})
    if kv in d:                          # overwrite fires delete_fn
        cb = _obj_keyvals.get(kv)
        if cb and cb[1]:
            cb[1](h, kv, d[kv])
    d[kv] = int(value)


def obj_get_attr(kind: str, h: int, keyval: int) -> Tuple[int, int]:
    d = _obj_attrs.get((kind, int(h)), {})
    if int(keyval) in d:
        return 1, int(d[int(keyval)])
    return 0, 0


def obj_delete_attr(kind: str, h: int, keyval: int) -> None:
    kv = int(keyval)
    d = _obj_attrs.get((kind, int(h)), {})
    if kv not in d:
        raise MPIError(ERR_ARG, f"attribute {kv} not set")
    cb = _obj_keyvals.get(kv)
    if cb and cb[1]:
        cb[1](h, kv, d[kv])
    del d[kv]


def _obj_attrs_free(kind: str, h: int) -> None:
    """Object teardown: fire delete_fn for every cached attribute."""
    d = _obj_attrs.pop((kind, int(h)), None)
    if not d:
        return
    for kv, val in list(d.items()):
        cb = _obj_keyvals.get(kv)
        if cb and cb[1]:
            cb[1](h, kv, val)


def _obj_attrs_dup(kind: str, old: int, new: int) -> None:
    """Type_dup attribute propagation through copy_fn (veto or
    transform, the comm-dup contract)."""
    d = _obj_attrs.get((kind, int(old)), {})
    for kv, val in list(d.items()):
        cb = _obj_keyvals.get(kv)
        if cb and cb[0]:
            flag, out = cb[0](old, kv, val)
            if flag:
                _obj_attrs.setdefault((kind, int(new)), {})[kv] = out


# ---- dynamic error-space removal (remove_error_class.c.in family):
# MPI-4.1 requires LIFO removal — only the most recently added
# class/code may be removed ------------------------------------------
_added_classes: list = []
_added_codes: list = []


def remove_error_class(c: int) -> None:
    if not _added_classes or _added_classes[-1] != int(c):
        raise MPIError(ERR_ARG,
                       "error classes must be removed in LIFO order")
    _added_classes.pop()
    _err_class_of.pop(int(c), None)
    _err_strings.pop(int(c), None)


def remove_error_code(code: int) -> None:
    if not _added_codes or _added_codes[-1] != int(code):
        raise MPIError(ERR_ARG,
                       "error codes must be removed in LIFO order")
    _added_codes.pop()
    _err_class_of.pop(int(code), None)
    _err_strings.pop(int(code), None)


def remove_error_string(code: int) -> None:
    if _err_strings.pop(int(code), None) is None:
        raise MPIError(ERR_ARG, f"no string set for code {code}")


# ---- MPI_Type_get_value_index (MPI-4.1, type_get_value_index.c.in):
# the (value, index) pair datatype. Built lazily as a packed struct
# over the existing constructor machinery and cached, so the returned
# handle is USABLE from C (send/recv/pack) — stronger than the
# standard's MPI_DATATYPE_NULL escape hatch. -------------------------
_value_index_cache: Dict[Tuple[int, int], int] = {}


def type_get_value_index(vdt: int, idt: int) -> int:
    key = (int(vdt), int(idt))
    h = _value_index_cache.get(key)
    if h is None:
        vsz = type_size_bytes(vdt)
        isz = type_size_bytes(idt)
        counts = np.array([1, 1], np.intc).tobytes()
        displs = np.array([0, vsz], np.int64).tobytes()
        types = np.array([int(vdt), int(idt)], np.int64).tobytes()
        h = type_create_struct(counts, displs, types)
        # pad the extent to the C struct's (basic types: alignment ==
        # size), so an array of `struct {value; index;}` strides right
        align = max(vsz, isz, 1)
        ext = -(-(vsz + isz) // align) * align
        if type_extent_bytes(h) != ext:
            h = type_create_resized(h, 0, ext)
        type_commit(h)
        _value_index_cache[key] = h
    return h


# ---------------------------------------------------------------------
# wave 8: MPI-IO chapter closers (file_set_atomicity.c.in,
# file_get_byte_offset.c.in, file_iread_shared.c.in families)
# ---------------------------------------------------------------------
_file_atomicity: Dict[int, int] = {}


def file_set_atomicity(fh: int, flag: int) -> None:
    """Recorded and reported; writes on this runtime are pwrite-run
    atomic already (one OS write per coalesced run), the property the
    flag requests."""
    _file(fh)
    _file_atomicity[fh] = int(bool(flag))


def file_get_atomicity(fh: int) -> int:
    _file(fh)
    return _file_atomicity.get(fh, 0)


def file_get_byte_offset(fh: int, offset: int) -> int:
    """MPI_File_get_byte_offset: a view-relative offset in ETYPE units
    -> the absolute byte displacement in the file (through the
    filetype tiling)."""
    _file(fh)
    disp, et, ft, _rep = _view_of(fh)
    esz = type_size_bytes(et)
    vis = int(offset) * esz
    sigb = type_size_bytes(ft)
    extb = type_extent_bytes(ft)
    if sigb == extb:                     # contiguous view
        return disp + vis
    bidx = _to_byte_idx(ft)
    return disp + (vis // sigb) * extb + int(bidx[vis % sigb])


def file_get_group(fh: int) -> int:
    return _register_group(_file(fh).comm.group)


def _file_nb(fh: int, job) -> int:
    """Nonblocking file op on the file's serial worker (shared-pointer
    claims happen in i-call order); the request entry's dt==0 delivers
    the job's byte image verbatim at Wait."""
    req = _file_nb_req(fh, job)
    with _lock:
        rh = next(_next_req)
        _requests[rh] = (req, 0, b"")
    return rh


def file_iread_shared(fh: int, nbytes: int, dt: int, curview) -> int:
    snap = bytes(curview)
    return _file_nb(fh, lambda: _file_read(
        fh, nbytes, dt, snap, False, None)[0])


def file_iwrite_shared(fh: int, view, dt: int) -> int:
    a = _pack(view, dt, _count_of(view, dt))
    data = a.view(np.uint8).tobytes()

    def job() -> bytes:
        # write_shared returns the claimed start offset; the request
        # payload contract wants bytes/None (write side: no payload)
        _file(fh).write_shared(np.frombuffer(data, np.uint8))
        return b""

    return _file_nb(fh, job)


# ---------------------------------------------------------------------
# wave 9: the closure set — nonblocking sendrecv (isendrecv.c.in),
# the general dist_graph constructor, intercomms from groups, the
# cross-process naming service, Comm_join, MPMD spawn, request-based
# get_accumulate, environment/hardware info, session queries, and
# PSCW Win_test.
# ---------------------------------------------------------------------
class _PairReq:
    """MPI_Isendrecv compound request: complete when BOTH inner ops
    are; status and payload come from the receive side."""

    def __init__(self, sreq, rreq):
        self._s = sreq
        self._r = rreq

    def wait(self, timeout=None):
        del timeout                      # request classes differ here
        self._s.wait()
        return self._r.wait()

    def test(self):
        ds = self._s.test()
        done_s = ds[0] if isinstance(ds, tuple) else bool(ds)
        if not done_s:
            return False, None
        return self._r.test()

    def get(self):
        return self._r.get()


def isendrecv(h: int, view, sdt: int, dest: int, stag: int,
              source: int, rtag: int, rdt: int, curview) -> int:
    c = _comm(h)
    rreq = c.irecv(source, rtag)
    sreq = c.isend(_pack(view, sdt, _count_of(view, sdt)), dest, stag)
    with _lock:
        rh = next(_next_req)
        _requests[rh] = (_PairReq(sreq, rreq), rdt, bytes(curview))
    return rh


def isendrecv_replace(h: int, view, dt: int, dest: int, stag: int,
                      source: int, rtag: int) -> int:
    c = _comm(h)
    data = _pack(view, dt, _count_of(view, dt))   # send image NOW
    rreq = c.irecv(source, rtag)
    sreq = c.isend(data, dest, stag)
    with _lock:
        rh = next(_next_req)
        _requests[rh] = (_PairReq(sreq, rreq), dt, bytes(view))
    return rh


def rget_accumulate(wh: int, view, dt: int, o: int, target: int,
                    disp: int, result_count: int, rdt: int) -> int:
    """MPI_Rget_accumulate: the blocking fetch-then-accumulate on a
    completion thread; the request payload is the result image."""
    from ompi_tpu_torch.pml.perrank import thread_request
    w = _win(wh)
    op = _rma_op(o)
    if not op.predefined:
        raise MPIError(ERR_OP,
                       "MPI_Rget_accumulate needs a predefined op")
    if op.name == "no_op":
        data = np.zeros(result_count, _dtype(rdt))
        out_dt = rdt
    else:
        data = _arr(view, dt).copy()     # origin image at call time
        out_dt = rdt if rdt else dt
    bd = _byte_disp(w, target, disp)

    def job() -> bytes:
        old = w.get_accumulate_typed(data, target, bd, op=op.name)
        return _out(np.asarray(old), out_dt)
    return _icoll_handle(thread_request(job), 0)


def win_test(wh: int) -> int:
    """MPI_Win_test: nonblocking Win_wait — 1 only when every origin's
    completion token is already here (then consumed, ending the
    exposure epoch exactly as Win_wait would)."""
    w = _win(wh)
    origins = getattr(w, "_pscw_origins", [])
    if not origins:
        return 1
    eng = w._pscw_engine()
    for o in origins:
        ok, _st = eng.iprobe(o, w._pscw_tag(1))
        if not ok:
            return 0
    w.wait()                             # all present: cannot block
    return 1


def dist_graph_create(h: int, n: int, sources_v, degrees_v, dests_v,
                      reorder: int) -> int:
    """MPI_Dist_graph_create: arbitrary edge contributions are
    allgathered and redistributed so every rank learns its own
    adjacency, then the adjacent constructor takes over."""
    c = _comm(h)
    srcs = _ints(sources_v)
    degs = _ints(degrees_v)
    dsts = _ints(dests_v)
    edges = []
    k = 0
    for i in range(int(n)):
        for _ in range(int(degs[i])):
            edges.append((int(srcs[i]), int(dsts[k])))
            k += 1
    flat = [e for sub in c.allgather(edges) for e in sub]
    me = c.rank()
    ins = np.array([s for (s, d) in flat if d == me], np.intc)
    outs = np.array([d for (s, d) in flat if s == me], np.intc)
    return dist_graph_create_adjacent(h, ins.tobytes(),
                                      outs.tobytes(), reorder)


def intercomm_create_from_groups(lgh: int, local_leader: int,
                                 rgh: int, remote_leader: int,
                                 stringtag: str) -> int:
    """MPI_Intercomm_create_from_groups: no peer communicator — the
    remote roster IS the remote group, and the local intracomm forms
    under the (stringtag, group) CID rule directly (the Sessions-
    world constructor; any group works, not only pset-derived ones —
    intercomm_create_from_groups.c.in takes arbitrary groups)."""
    from ompi_tpu_torch.core.group import Group
    from ompi_tpu_torch.core.rankcomm import RankCommunicator
    w = _comm(COMM_WORLD)
    if not getattr(w, "is_per_rank", False):
        raise MPIError(ERR_COMM,
                       "intercomm_create_from_groups needs the "
                       "per-rank world")
    mine = list(_group(lgh).world_ranks)
    remote = list(_group(rgh).world_ranks)
    local = RankCommunicator(
        Group(mine), w._my_world, w.router, w.device,
        cid=("icfg-l", tuple(mine), str(stringtag)),
        name="icfg-local")
    a, b = sorted([tuple(mine), tuple(remote)])
    cid = ("icg", a, b, str(stringtag))
    return _register_comm(_RankIntercomm(local, remote, cid))


# ---- the naming service (publish_name.c.in family): a cross-process
# fcntl-locked JSON registry — the ompi-server role played by the
# filesystem, reachable from independently-launched jobs. The port keeps
# a registry of its own (``OMPI_TPU_TORCH_NAME_SERVER_FILE``, default
# ``ompi_tpu_torch_names_<uid>.json`` in the temp dir, ``TMPDIR``
# honoured): a JAX-package job running beside a port job must not see
# the port's published names -------------------------------------------
def _namesvc_path() -> str:
    import os as _os
    import tempfile
    return _os.environ.get(
        "OMPI_TPU_TORCH_NAME_SERVER_FILE",
        _os.path.join(tempfile.gettempdir(),
                      f"ompi_tpu_torch_names_{_os.getuid()}.json"))


def _namesvc_update(fn):
    import fcntl
    import json
    import os as _os
    path = _namesvc_path()
    with open(path + ".lock", "a+") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            try:
                with open(path) as f:
                    d = json.load(f)
            except (OSError, ValueError):
                d = {}
            out = fn(d)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(d, f)
            _os.replace(tmp, path)
            return out
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def publish_name(service: str, port: str) -> None:
    def put(d):
        if service in d:
            from ompi_tpu_torch.core.errhandler import ERR_SERVICE
            raise MPIError(ERR_SERVICE,
                           f"service {service!r} already published")
        d[str(service)] = str(port)
    _namesvc_update(put)


def lookup_name(service: str) -> str:
    def get(d):
        if service not in d:
            from ompi_tpu_torch.core.errhandler import ERR_NAME
            raise MPIError(ERR_NAME,
                           f"service {service!r} not published")
        return d[str(service)]
    return _namesvc_update(get)


def unpublish_name(service: str) -> None:
    def drop(d):
        if str(service) not in d:
            from ompi_tpu_torch.core.errhandler import ERR_SERVICE
            raise MPIError(ERR_SERVICE,
                           f"service {service!r} not published")
        del d[str(service)]
    _namesvc_update(drop)


def comm_join(fd: int) -> int:
    """MPI_Comm_join: the two processes swap port strings over the
    caller-provided socket/pipe fd; the lexicographically smaller
    port accepts, the other connects — a size-1 x size-1 intercomm."""
    import os as _os
    port = dpm_open_port(COMM_SELF)
    _os.write(int(fd), port.encode().ljust(256, b"\0"))
    peer = b""
    while len(peer) < 256:
        chunk = _os.read(int(fd), 256 - len(peer))
        if not chunk:
            from ompi_tpu_torch.core.errhandler import ERR_INTERN
            raise MPIError(ERR_INTERN,
                           "MPI_Comm_join: peer closed fd")
        peer += chunk
    peer_port = peer.rstrip(b"\0").decode()
    if port < peer_port:
        out = dpm_comm_accept(port, COMM_SELF, 0)
    else:
        out = dpm_comm_connect(peer_port, COMM_SELF, 0)
    dpm_close_port(COMM_SELF, port)
    return out


def comm_spawn_multiple(h: int, count: int, cmds_joined: str,
                        argvs_joined: str, maxprocs_joined: str,
                        root: int) -> int:
    """MPI_Comm_spawn_multiple: ONE child world running different
    binaries — the job launches the MPMD dispatch shim, which execs
    entry i for ranks [sum(maxprocs[:i]), sum(maxprocs[:i+1]))."""
    import json
    import sys as _sys
    import tempfile
    c = _comm(h)
    # spec arguments are significant ONLY at root; the launch rides
    # the shared plumbing with the MPMD shim as the command (it reads
    # OMPI_TPU_TORCH_MCA_mpi_base_process_id to pick its entry, then execs
    # the real binary with env intact)
    total = 0
    specfile = ""
    if c.rank() == root:
        cmds = cmds_joined.split("\x1e")
        argvs = [([a for a in grp.split("\x1f") if a != ""]
                  if grp else [])
                 for grp in argvs_joined.split("\x1e")]
        maxprocs = [int(x) for x in maxprocs_joined.split(",")]
        spec = [{"command": cmds[i], "argv": argvs[i],
                 "maxprocs": maxprocs[i]} for i in range(int(count))]
        total = sum(maxprocs)
        tf = tempfile.NamedTemporaryFile(
            "w", suffix=".mpmd.json", delete=False)
        json.dump(spec, tf)
        tf.close()
        specfile = tf.name
    return _spawn_launch(c, root, total,
                         [_sys.executable, "-m",
                          "ompi_tpu_torch.tools.mpmd_exec", specfile])


def info_create_env() -> int:
    """MPI_Info_create_env: the launch environment's info keys."""
    import os as _os
    import sys as _sys
    ih = info_create()
    info_set(ih, "command", _sys.argv[0] if _sys.argv else "")
    info_set(ih, "argv", "\x1f".join(_sys.argv[1:]))
    info_set(ih, "maxprocs", str(
        _os.environ.get("OMPI_TPU_TORCH_MCA_mpi_base_num_processes", "1")))
    info_set(ih, "host", _os.uname().nodename)
    info_set(ih, "wdir", _os.getcwd())
    info_set(ih, "soft", "")
    info_set(ih, "arch", _os.uname().machine)
    info_set(ih, "thread_level", "MPI_THREAD_MULTIPLE")
    return ih


def get_hw_resource_info() -> int:
    """MPI_Get_hw_resource_info (MPI-4.1): what this runtime can see
    of the hardware. The accelerator keys name the CUDA cards
    (``torch.cuda.device_count()``, ``torch.cuda.get_device_name(0)``).
    With no card they follow ``mpiext/accel.Device_inventory``, which
    then reports the CPU's one record: one accelerator of its kind."""
    import os as _os
    ih = info_create()
    info_set(ih, "mpi_hw_resource_type", "host")
    info_set(ih, "num_cpus", str(_os.cpu_count() or 1))
    if torch.cuda.is_available():
        info_set(ih, "num_accelerators", str(torch.cuda.device_count()))
        info_set(ih, "accelerator_kind", torch.cuda.get_device_name(0))
    else:
        from ompi_tpu_torch.mpiext.accel import Device_inventory
        inv = Device_inventory()
        info_set(ih, "num_accelerators", str(len(inv)))
        info_set(ih, "accelerator_kind", str(inv[0]["kind"]))
    return ih


def session_get_info(sh: int) -> int:
    _session(sh)
    ih = info_create()
    info_set(ih, "thread_level", "MPI_THREAD_MULTIPLE")
    info_set(ih, "mpi_size", str(comm_size(COMM_WORLD)))
    return ih


def session_get_pset_info(sh: int, name: str) -> int:
    _session(sh)
    names = [session_get_nth_pset(sh, i)
             for i in range(session_get_num_psets(sh))]
    if str(name) not in names:
        raise MPIError(ERR_ARG, f"unknown pset {name!r}")
    gh = group_from_session_pset(sh, str(name))
    n = group_size(gh)
    group_free(gh)
    ih = info_create()
    info_set(ih, "mpi_size", str(n))
    return ih


# activate the constructor-envelope recorders (must run after every
# constructor definition; see _record_env_wrappers)
_record_env_wrappers()


def _reset_for_tests() -> None:
    """Retire every serial worker (draining its jobs) and empty the
    handle tables of dynamic objects, so a test starts from the
    predefined handles alone; ``runtime.init._reset_for_tests`` forgets
    the world they named."""
    global _parent_comm_handle
    with _lock:
        keys = list(_icoll_workers)
    for key in keys:
        _icoll_worker_shutdown(key)
    with _lock:
        for table in (_comms, _requests, _groups, _infos, _wins, _files,
                      _messages, _part_reqs, _pcolls, _sessions):
            table.clear()
        _closing.clear()
    _parent_comm_handle = None


def _capture_op_ctx():
    """The in-flight reduction's datatype handle must travel with a
    funneled collective body (rankcomm._coll_serial): the glue sets
    _op_ctx.dt on the CALLER thread before c.reduce/allreduce/scan,
    and a C user op's combiner reads it on whichever thread runs the
    fold — without propagation the worker-side fallback reverse-maps
    the numpy dtype, which cannot distinguish aliased handles
    (INT64_T vs LONG)."""
    dt = getattr(_op_ctx, "dt", 0)

    def apply():
        _op_ctx.dt = dt

    def reset():
        _op_ctx.dt = 0
    return (apply, reset)


def _register_op_ctx_propagator() -> None:
    from ompi_tpu_torch.core import rankcomm as _rankcomm_mod
    _rankcomm_mod.register_tls_propagator(_capture_op_ctx)


_register_op_ctx_propagator()
