"""Reduction-op framework: MPI_Op -> torch combiner.

Behavioral spec from the reference: predefined ops declared at
``ompi/op/op.c:73-80``; the (op x type) kernel table in
``ompi/mca/op/base/op_base_functions.c``.

An op is (a) a torch binary combiner usable in device-side folds, and
(b) where one torch reduction over the rank axis computes it
(``sum``/``amax``/``amin``), a tag — ``xla_prim``, the name the JAX
package gives the same gate — that the device collective component keys
on to take that one-shot reduction instead of an ordered fold.
MINLOC/MAXLOC operate on (value, index) pair types carried as a trailing
axis of size 2. User-defined ops (MPI_Op_create) supply a torch combiner;
the ``commute`` flag gates algorithm choice as the reference documents
(``coll_base_allreduce.c:291-294``).

torch has no add, sum, prod, max or min kernels for its unsigned types
wider than a byte. A predefined op on uint16, uint32 or uint64 runs on
the signed type of the same width (``unsigned_route``): SUM, PROD and
the bitwise and logical ops on the same bits, which gives the same
result mod 2**n; MAX and MIN on the bits with the top one flipped, which
orders the signed values as the unsigned ones. The result is flipped
back and viewed as the operand type, as MPI keeps it.
"""
from __future__ import annotations

import itertools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

_op_counter = itertools.count()

# the signed type of the same width, for the unsigned types torch cannot
# add, reduce or compare (the convertor's index copies use it too)
SIGNED_TWIN = {torch.uint16: torch.int16, torch.uint32: torch.int32,
               torch.uint64: torch.int64}
_SAME_BITS = frozenset(("sum", "prod", "band", "bor", "bxor", "land", "lor",
                        "lxor"))
_ORDERED = frozenset(("max", "min"))


def _route(dtype, name: str):
    twin = SIGNED_TWIN.get(dtype)
    if twin is None:
        return None
    if name in _ORDERED:
        top = torch.iinfo(twin).min
        return (twin, lambda t: t.view(twin) ^ top,
                lambda t: (t ^ top).view(dtype))
    if name in _SAME_BITS:
        return twin, lambda t: t.view(twin), lambda t: t.view(dtype)
    return None


def unsigned_route(dtype, op) -> Optional[Tuple[torch.dtype, Callable,
                                                Callable]]:
    """``(twin, into, back)`` when predefined ``op`` on ``dtype`` must run
    on the signed twin (see the module doc): ``into`` maps an operand to
    the twin, ``back`` maps a result of the twin's reduction to
    ``dtype``. None when torch reduces ``dtype`` itself, and for user ops
    (their combiner sees the operand type)."""
    if op is None or not op.predefined:
        return None
    return _route(dtype, op.name)


class Op:
    """An MPI reduction operator.

    ``fn(a, b)`` must be an elementwise torch combiner.
    ``xla_prim`` in {"sum", "max", "min", None}: when set, collectives may
    lower to the one-shot reduction over the rank axis.
    """

    def __init__(self, fn: Callable, *, commute: bool = True,
                 name: str = "user_op", xla_prim: Optional[str] = None,
                 is_loc: bool = False, predefined: bool = False):
        self.fn = fn
        self.commute = commute
        self.name = name
        # Cache identity: distinct user ops share the default name, so
        # caches keyed on the name alone would collide.
        self.uid = name if predefined else f"{name}#{next(_op_counter)}"
        self.xla_prim = xla_prim
        self.is_loc = is_loc         # MINLOC/MAXLOC pair semantics
        self.predefined = predefined

    def __call__(self, a, b):
        """Combine two operands, taking uint16/32/64 through the signed
        twin for a predefined op: the pairwise callers (the per-rank
        tier, reduce_local, the in-graph folds) combine through here. The
        coll/torch and nbc schedules route whole buffers at their entry
        and call ``fn`` directly."""
        r = (_route(getattr(a, "dtype", None), self.name)
             if self.predefined else None)
        if r is None:
            return self.fn(a, b)
        _twin, into, back = r
        return back(self.fn(into(a), into(b)))

    def __repr__(self):
        return f"Op({self.name})"

    def is_commute(self) -> bool:
        return self.commute

    def free(self) -> None:
        if self.predefined:
            raise ValueError("cannot free a predefined op")
        self.fn = None

    def reduce_tree(self, stacked: torch.Tensor, axis: int = 0):
        """Fold ``stacked`` along ``axis`` with this op.

        For predefined arithmetic ops this is one torch reduction; for
        the rest an associative fold via binary splitting, preserving rank
        order for non-commutative ops."""
        n = stacked.shape[axis]
        if n == 1:
            return stacked.select(axis, 0)
        r = unsigned_route(stacked.dtype, self)
        if r is not None:
            _twin, into, back = r
            return back(self.reduce_tree(into(stacked), axis))
        if self.predefined and self.name in _TORCH_REDUCERS:
            return _TORCH_REDUCERS[self.name](stacked, axis)

        # Ordered binary-splitting fold: combines (0..k) with (k..n) so the
        # result equals left-to-right application for associative ops.
        def fold(lo, hi):
            if hi - lo == 1:
                return stacked.select(axis, lo)
            mid = (lo + hi) // 2
            return self.fn(fold(lo, mid), fold(mid, hi))
        return fold(0, n)


def _land(a, b):
    return torch.logical_and(a != 0, b != 0).to(a.dtype)


def _lor(a, b):
    return torch.logical_or(a != 0, b != 0).to(a.dtype)


def _lxor(a, b):
    return torch.logical_xor(a != 0, b != 0).to(a.dtype)


def _minloc(a, b):
    """Pair reduce on trailing axis [..., 2] = (value, index); ties pick
    the lower index — MPI MINLOC semantics (op_base_functions.c pair ops)."""
    av, ai = a[..., 0], a[..., 1]
    bv, bi = b[..., 0], b[..., 1]
    take_a = (av < bv) | ((av == bv) & (ai <= bi))
    return torch.stack([torch.where(take_a, av, bv),
                        torch.where(take_a, ai, bi)], dim=-1)


def _maxloc(a, b):
    av, ai = a[..., 0], a[..., 1]
    bv, bi = b[..., 0], b[..., 1]
    take_a = (av > bv) | ((av == bv) & (ai <= bi))
    return torch.stack([torch.where(take_a, av, bv),
                        torch.where(take_a, ai, bi)], dim=-1)


# One-shot reductions over an axis. dtype= keeps integer sums and products
# in the operand type (torch would widen them to int64).
_TORCH_REDUCERS = {
    "sum": lambda x, ax: torch.sum(x, dim=ax, dtype=x.dtype),
    "prod": lambda x, ax: torch.prod(x, dim=ax, dtype=x.dtype),
    "max": lambda x, ax: torch.amax(x, dim=ax),
    "min": lambda x, ax: torch.amin(x, dim=ax),
}


def _np_logical(npfn):
    """MPI logical ops yield 0/1 IN THE OPERAND TYPE."""
    def fn(a, b):
        return npfn(a, b).astype(np.asarray(b).dtype)
    return fn


def _np_minloc(a, b):
    a, b = np.asarray(a), np.asarray(b)
    av, ai = a[..., 0], a[..., 1]
    bv, bi = b[..., 0], b[..., 1]
    take_a = (av < bv) | ((av == bv) & (ai <= bi))
    return np.stack([np.where(take_a, av, bv),
                     np.where(take_a, ai, bi)], axis=-1)


def _np_maxloc(a, b):
    a, b = np.asarray(a), np.asarray(b)
    av, ai = a[..., 0], a[..., 1]
    bv, bi = b[..., 0], b[..., 1]
    take_a = (av > bv) | ((av == bv) & (ai <= bi))
    return np.stack([np.where(take_a, av, bv),
                     np.where(take_a, ai, bi)], axis=-1)


# Dtype-preserving numpy combiners for the predefined ops — the HOST
# fold table (the op/base scalar-loop role), used by coll/basic.
NP_COMBINERS = {
    "sum": np.add,
    "prod": np.multiply,
    "max": np.maximum,
    "min": np.minimum,
    "band": np.bitwise_and,
    "bor": np.bitwise_or,
    "bxor": np.bitwise_xor,
    "land": _np_logical(np.logical_and),
    "lor": _np_logical(np.logical_or),
    "lxor": _np_logical(np.logical_xor),
    "minloc": _np_minloc,
    "maxloc": _np_maxloc,
}

SUM = Op(torch.add, name="sum", xla_prim="sum", predefined=True)
PROD = Op(torch.mul, name="prod", predefined=True)
MAX = Op(torch.maximum, name="max", xla_prim="max", predefined=True)
MIN = Op(torch.minimum, name="min", xla_prim="min", predefined=True)
LAND = Op(_land, name="land", predefined=True)
LOR = Op(_lor, name="lor", predefined=True)
LXOR = Op(_lxor, name="lxor", predefined=True)
BAND = Op(torch.bitwise_and, name="band", predefined=True)
BOR = Op(torch.bitwise_or, name="bor", predefined=True)
BXOR = Op(torch.bitwise_xor, name="bxor", predefined=True)
MINLOC = Op(_minloc, name="minloc", is_loc=True, predefined=True)
MAXLOC = Op(_maxloc, name="maxloc", is_loc=True, predefined=True)


def op_create(fn: Callable, commute: bool = True, name: str = "user_op") -> Op:
    """MPI_Op_create equivalent: ``fn`` is an elementwise torch combiner."""
    return Op(fn, commute=commute, name=name)


def np_combiner(op: Op) -> Callable:
    """The host (numpy) combiner of ``op``: the NP_COMBINERS entry of a
    predefined op, else the user's torch combiner wrapped over numpy."""
    if op.predefined and op.name in NP_COMBINERS:
        return NP_COMBINERS[op.name]

    def fn(a, b):
        return op.fn(torch.from_numpy(np.asarray(a)),
                     torch.from_numpy(np.asarray(b))).numpy()
    return fn


def reduce_local(inbuf, inoutbuf, op: Op):
    """MPI_Reduce_local: combine ``inbuf`` into ``inoutbuf`` with ``op``
    (no communication; the same combiner the collectives use). Returns
    ``inbuf op inoutbuf`` as a new tensor, or a new numpy array when both
    buffers are host arrays."""
    if not isinstance(op, Op) or op.fn is None:
        raise TypeError("invalid reduction op")
    if isinstance(inbuf, torch.Tensor) or isinstance(inoutbuf, torch.Tensor):
        return op(torch.as_tensor(inbuf), torch.as_tensor(inoutbuf))
    return np_combiner(op)(np.asarray(inbuf), np.asarray(inoutbuf))
