"""OSHMEM-lite: the OpenSHMEM programming model over the framework (the
port of ``ompi_tpu/shmem/api.py``).

Behavioral spec: ``oshmem/`` — symmetric heap (memheap), put/get with
remote completion (spml, ``oshmem/mca/spml/spml.h:229-330``), atomics,
and collectives (scoll; scoll/mpi delegates to the MPI coll stack).

The symmetric heap is one stacked RMA window per context
(``osc/framework.Win``): every PE's heap is a row on ``comm.device``, so
a "symmetric address" is a plain offset valid on all PEs (symmetry by
construction, no address exchange). ``put`` hands the caller's data to
``Win.put`` as it is, so a CUDA origin is copied into the row on the
card and never visits the host. ``get``, ``g`` and every test, wait,
lock and fetching atomic return host values as the reference's do: each
reads the element(s) it needs back from the card, one synchronisation
per call. The collectives (broadcast, reductions, alltoall, collect)
work on the heap rows where they live, in the reference's fold order,
and ``collect`` returns host numpy with one device-to-host copy.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ompi_tpu_torch.accelerator import to_numpy
from ompi_tpu_torch.core import op as op_mod
from ompi_tpu_torch.core.errhandler import ERR_ARG, ERR_PENDING, MPIError
from ompi_tpu_torch.osc.framework import Win, _origin

# shmem_wait_until / shmem_test comparison constants
# (oshmem/include/shmem.h SHMEM_CMP_*).
CMP_EQ, CMP_NE, CMP_GT, CMP_LE, CMP_LT, CMP_GE = range(6)

_CMP_FNS = {
    CMP_EQ: lambda a, b: a == b,
    CMP_NE: lambda a, b: a != b,
    CMP_GT: lambda a, b: a > b,
    CMP_LE: lambda a, b: a <= b,
    CMP_LT: lambda a, b: a < b,
    CMP_GE: lambda a, b: a >= b,
}

# shmem_put_signal signal operations (SHMEM_SIGNAL_SET / _ADD).
SIGNAL_SET = 0
SIGNAL_ADD = 1


class ShmemCtx:
    """A SHMEM context: ``n_pes`` processing elements over a
    communicator, one symmetric heap of ``heap_size`` elements."""

    def __init__(self, comm, heap_size: int = 1 << 16, dtype=np.float32):
        self.comm = comm
        self.heap = Win(comm, heap_size, dtype=dtype, name="symheap")
        self._brk = 0
        self.heap_size = heap_size
        # Buddy allocator (C++ — the memheap/buddy component role) when
        # the native library is available; bump-allocator fallback. The
        # buddy system manages exactly 2^k elements, so it only serves
        # power-of-two heaps — any other size would either truncate the
        # window or hand out offsets beyond it.
        from ompi_tpu_torch.native import get_lib
        self._lib = get_lib()
        self._live: dict = {}            # offset -> nelems (memheap
        #                                  allocation metadata)
        self._buddy = -1
        if (self._lib is not None and heap_size > 0
                and heap_size & (heap_size - 1) == 0):
            max_order = heap_size.bit_length() - 1
            self._buddy = self._lib.ompi_tpu_buddy_create(max_order, 0)

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_buddy", -1)
        if lib is not None and h >= 0:
            try:
                lib.ompi_tpu_buddy_destroy(h)
            except Exception:
                pass

    # -- the heap rows, for the collectives -----------------------------
    def _rows(self, addr: int, nelems: int) -> torch.Tensor:
        """Every PE's ``[addr, addr + nelems)``: a view of the heap rows
        where they live, bounds-checked as a window access."""
        if addr < 0 or nelems < 0 or addr + nelems > self.heap_size:
            raise MPIError(ERR_ARG, "RMA access beyond window bounds")
        return self.heap.buffer[:, addr:addr + nelems]

    # -- setup (shmem_init / shmem_my_pe / shmem_n_pes) ----------------
    @property
    def n_pes(self) -> int:
        return self.comm.size

    def malloc(self, nelems: int) -> int:
        """shmem_malloc: symmetric allocation — returns the symmetric
        offset, identical on every PE. Served by the native buddy
        allocator (oshmem/mca/memheap/buddy role: power-of-two blocks,
        split/coalesce), falling back to a bump allocator. Live sizes
        are tracked host-side (the memheap metadata) so realloc/free
        know block extents on either path."""
        if self._buddy >= 0:
            addr = self._lib.ompi_tpu_buddy_alloc(self._buddy, nelems)
            if addr < 0:
                raise MPIError(ERR_ARG, "symmetric heap exhausted")
            self._live[int(addr)] = nelems
            return int(addr)
        if self._brk + nelems > self.heap_size:
            raise MPIError(ERR_ARG, "symmetric heap exhausted")
        addr = self._brk
        self._brk += nelems
        self._live[addr] = nelems
        return addr

    def free(self, addr: int) -> None:
        """shmem_free: returns the block to the buddy allocator (no-op
        on the bump fallback)."""
        if self._live.pop(addr, None) is None:
            raise MPIError(ERR_ARG,
                           f"shmem_free: invalid or double free at "
                           f"offset {addr}")
        if self._buddy >= 0:
            rc = self._lib.ompi_tpu_buddy_free(self._buddy, addr)
            if rc != 0:
                raise MPIError(ERR_ARG,
                               f"shmem_free: invalid or double free at "
                               f"offset {addr}")

    def align(self, alignment: int, nelems: int) -> int:
        """shmem_align: allocation whose symmetric offset is a multiple
        of ``alignment`` (elements). The buddy allocator's power-of-two
        blocks are naturally size-aligned; the bump path pads."""
        if alignment <= 0 or alignment & (alignment - 1):
            raise MPIError(ERR_ARG, "alignment must be a power of two")
        if self._buddy >= 0:
            # buddy blocks of 2^k elements sit at 2^k-aligned offsets:
            # request a block at least max(alignment, nelems)
            return self.malloc(max(alignment, nelems))
        pad = (-self._brk) % alignment
        if self._brk + pad + nelems > self.heap_size:
            raise MPIError(ERR_ARG, "symmetric heap exhausted")
        self._brk += pad
        return self.malloc(nelems)

    def calloc(self, count: int) -> int:
        """shmem_calloc: zero-initialized symmetric allocation (a
        recycled block may carry stale content)."""
        addr = self.malloc(count)
        with self.heap._lock:
            self._rows(addr, count).zero_()
        return addr

    def realloc(self, addr: int, nelems: int) -> int:
        """shmem_realloc: symmetric resize — every PE's content (up to
        the smaller extent) moves to the new block, row to row where the
        heap lives."""
        old = self._live.get(addr)
        if old is None:
            raise MPIError(ERR_ARG,
                           f"shmem_realloc: offset {addr} is not a "
                           f"live allocation")
        new = self.malloc(nelems)
        keep = min(old, nelems)
        with self.heap._lock:
            self._rows(new, keep).copy_(self._rows(addr, keep).clone())
        self.free(addr)
        return new

    # -- RMA (spml put/get) --------------------------------------------
    def put(self, dest_pe: int, addr: int, data) -> None:
        """shmem_put: deliver ``data`` into dest_pe's heap at ``addr``
        (a tensor is handed to the window as it is)."""
        self.heap.put(data, dest_pe, addr)

    def get(self, src_pe: int, addr: int, nelems: int):
        return self.heap.get(src_pe, addr, nelems)

    def p(self, dest_pe: int, addr: int, value) -> None:
        self.put(dest_pe, addr, np.asarray([value]))

    def g(self, src_pe: int, addr: int):
        return self.get(src_pe, addr, 1)[0]

    # Nonblocking-implicit variants (shmem_put_nbi / shmem_get_nbi):
    # completion is deferred to quiet(). A put is queued on the heap's
    # stream at the call, so these alias the blocking calls — the
    # contract (result not guaranteed until quiet) still holds.
    def put_nbi(self, dest_pe: int, addr: int, data) -> None:
        self.put(dest_pe, addr, data)

    def get_nbi(self, src_pe: int, addr: int, nelems: int):
        return self.get(src_pe, addr, nelems)

    def iput(self, dest_pe: int, addr: int, data, tst: int = 1,
             sst: int = 1) -> None:
        """shmem_iput: strided put — element i of the (source-strided)
        ``data`` lands at ``addr + i*tst`` on the target. Assembled on
        the heap's device (holes keep their current content) and written
        with one put, not one put per element."""
        src = _origin(data, self.heap.buffer)[::sst]
        n = src.shape[0]
        if n == 0:
            return
        span = (n - 1) * tst + 1
        with self.heap._lock:
            row = self._rows(addr, span)[dest_pe].clone()
            row[::tst] = src
            self.put(dest_pe, addr, row)

    def iget(self, src_pe: int, addr: int, nelems: int,
             tst: int = 1, sst: int = 1):
        """shmem_iget: strided get — reads ``nelems`` elements from
        ``addr, addr+sst, ...`` and returns them laid out as the local
        target buffer would be: element i at index ``i*tst`` (holes
        zero-filled), exactly mirroring iput's target stride. One read
        of the source span (the reference reads element by element)."""
        if not nelems:
            return np.zeros(0, dtype=float)
        vals = self.get(src_pe, addr, (nelems - 1) * sst + 1)[::sst]
        out = np.zeros((nelems - 1) * tst + 1, dtype=vals.dtype)
        out[::tst] = vals
        return out

    def ptr(self, pe: int):
        """shmem_ptr: direct load/store access to ``pe``'s heap segment.
        A host snapshot, as the reference returns: reads are direct,
        stores must go through put — the same degradation shmem_ptr has
        on non-shared-memory PEs, where it returns NULL and callers fall
        back to put/get."""
        return self.get(pe, 0, self.heap_size)

    # -- pt2pt synchronization (shmem_wait_until / shmem_test) ---------
    def test(self, pe: int, addr: int, cmp: int, value) -> bool:
        """shmem_test: does PE ``pe``'s heap word at ``addr`` satisfy
        the comparison now?"""
        fn = _CMP_FNS.get(cmp)
        if fn is None:
            raise MPIError(ERR_ARG, f"bad SHMEM_CMP constant: {cmp}")
        return bool(fn(self.g(pe, addr), value))

    def wait_until(self, pe: int, addr: int, cmp: int, value) -> None:
        """shmem_wait_until. Single-controller: no other thread can
        change the heap while we block, so an unsatisfied wait is a
        deadlock — surfaced, like the matching engine does."""
        if not self.test(pe, addr, cmp, value):
            raise MPIError(
                ERR_PENDING,
                "shmem_wait_until would deadlock: condition is not "
                "satisfied and no concurrent producer exists "
                "(single-controller: perform the put first)")

    # -- signaling (shmem_put_signal, SHMEM 1.5) -----------------------
    def put_signal(self, dest_pe: int, addr: int, data, sig_addr: int,
                   signal, sig_op: int = SIGNAL_SET) -> None:
        """shmem_put_signal: deliver ``data`` then update the signal
        word at ``sig_addr`` (SET or ADD) — delivery ordering (payload
        visible before signal) is by construction here: both are queued
        in order on the heap's stream."""
        self.put(dest_pe, addr, data)
        if sig_op == SIGNAL_ADD:
            self.atomic_add(dest_pe, sig_addr, signal)
        else:
            self.atomic_set(dest_pe, sig_addr, signal)

    def signal_fetch(self, pe: int, sig_addr: int):
        """shmem_signal_fetch."""
        return self.g(pe, sig_addr)

    def signal_wait_until(self, pe: int, sig_addr: int, cmp: int,
                          value) -> None:
        self.wait_until(pe, sig_addr, cmp, value)

    # -- distributed locks (shmem_set_lock / test / clear) -------------
    def set_lock(self, addr: int, pe: int = 0) -> None:
        """shmem_set_lock: acquire the lock at symmetric ``addr`` on
        behalf of PE ``pe``. Held-lock acquisition is a deadlock in a
        single-controller world and is surfaced."""
        if not self.test_lock(addr, pe):
            raise MPIError(
                ERR_PENDING,
                f"shmem_set_lock would deadlock: lock at offset {addr} "
                f"is already held")

    def test_lock(self, addr: int, pe: int = 0) -> bool:
        """shmem_test_lock: try-acquire; True on success. Implemented
        as compare-and-swap 0 -> pe+1 on the lock word at PE 0's heap
        (the lock-owner PE in OpenSHMEM's algorithm)."""
        prev = self.atomic_compare_swap(0, addr, 0, pe + 1)
        return int(prev) == 0

    def clear_lock(self, addr: int, pe: int = 0) -> None:
        """shmem_clear_lock: release (must hold it)."""
        prev = self.atomic_compare_swap(0, addr, pe + 1, 0)
        if int(prev) != pe + 1:
            raise MPIError(ERR_ARG,
                           f"shmem_clear_lock: PE {pe} does not hold "
                           f"the lock at offset {addr}")

    # -- atomics (oshmem/mca/atomic) -----------------------------------
    def atomic_set(self, dest_pe: int, addr: int, value) -> None:
        self.p(dest_pe, addr, value)

    def atomic_fetch(self, src_pe: int, addr: int):
        return self.g(src_pe, addr)

    def atomic_swap(self, dest_pe: int, addr: int, value):
        return self.heap.fetch_and_op(value, dest_pe, op_mod.REPLACE, addr)

    def atomic_add(self, dest_pe: int, addr: int, value) -> None:
        self.heap.accumulate(np.asarray([value]), dest_pe, op_mod.SUM, addr)

    def atomic_fetch_add(self, dest_pe: int, addr: int, value):
        return self.heap.fetch_and_op(value, dest_pe, op_mod.SUM, addr)

    def atomic_compare_swap(self, dest_pe: int, addr: int, cond, value):
        return self.heap.compare_and_swap(value, cond, dest_pe, addr)

    def atomic_inc(self, dest_pe: int, addr: int) -> None:
        """shmem_atomic_inc (shmem_inc.c)."""
        self.atomic_add(dest_pe, addr, 1)

    def atomic_fetch_inc(self, dest_pe: int, addr: int):
        """shmem_atomic_fetch_inc (shmem_finc.c)."""
        return self.atomic_fetch_add(dest_pe, addr, 1)

    # bitwise AMOs (shmem_and/or/xor.c + fetching shmem_f{and,or,xor}.c);
    # on unsigned heaps they run on the signed twin (core/op's routing)
    def atomic_and(self, dest_pe: int, addr: int, value) -> None:
        self.heap.accumulate(np.asarray([value]), dest_pe, op_mod.BAND,
                             addr)

    def atomic_or(self, dest_pe: int, addr: int, value) -> None:
        self.heap.accumulate(np.asarray([value]), dest_pe, op_mod.BOR,
                             addr)

    def atomic_xor(self, dest_pe: int, addr: int, value) -> None:
        self.heap.accumulate(np.asarray([value]), dest_pe, op_mod.BXOR,
                             addr)

    def atomic_fetch_and(self, dest_pe: int, addr: int, value):
        return self.heap.fetch_and_op(value, dest_pe, op_mod.BAND, addr)

    def atomic_fetch_or(self, dest_pe: int, addr: int, value):
        return self.heap.fetch_and_op(value, dest_pe, op_mod.BOR, addr)

    def atomic_fetch_xor(self, dest_pe: int, addr: int, value):
        return self.heap.fetch_and_op(value, dest_pe, op_mod.BXOR, addr)

    # -- accessibility / introspection ---------------------------------
    def pe_accessible(self, pe: int) -> bool:
        """shmem_pe_accessible.c: is ``pe`` a reachable PE?"""
        return 0 <= pe < self.n_pes

    def addr_accessible(self, addr: int, pe: int) -> bool:
        """shmem_addr_accessible.c: is the symmetric offset valid on
        ``pe``'s heap? (symmetry by construction: one bound check)"""
        return self.pe_accessible(pe) and 0 <= addr < self.heap_size

    @staticmethod
    def info_get_version():
        """shmem_info.c: the OpenSHMEM spec level implemented."""
        return (1, 5)

    @staticmethod
    def info_get_name() -> str:
        return "ompi_tpu-OpenSHMEM"

    @staticmethod
    def pcontrol(level: int = 1) -> None:
        """shmem_pcontrol.c: profiling control — recorded as an SPC
        event (the reference's hook point for PMPI-style tools)."""
        from ompi_tpu_torch.runtime import spc
        spc.record("shmem_pcontrol", int(level))

    def global_exit(self, status: int = 0) -> None:
        """shmem_global_exit.c: terminate ALL PEs. Single-controller:
        every PE lives in this process — one SystemExit is the whole
        job."""
        raise SystemExit(status)

    # deprecated cache-management entry points (shmem_*cache*.c,
    # shmem_udcflush*.c): kept callable, documented no-ops — exactly
    # the reference's status for them since OpenSHMEM 1.3
    def clear_cache_inv(self) -> None:
        pass

    def set_cache_inv(self) -> None:
        pass

    def udcflush(self) -> None:
        pass

    # -- multi-variable sync (shmem_{test,wait}_ivars.c, SHMEM 1.4) ----
    def _ivar_state(self, pe: int, addrs, cmp: int, value):
        fn = _CMP_FNS.get(cmp)
        if fn is None:
            raise MPIError(ERR_ARG, f"bad SHMEM_CMP constant: {cmp}")
        return [bool(fn(self.g(pe, a), value)) for a in addrs]

    def test_all(self, pe: int, addrs, cmp: int, value) -> bool:
        return all(self._ivar_state(pe, addrs, cmp, value))

    def test_any(self, pe: int, addrs, cmp: int, value):
        """Index of ANY satisfied variable, or None."""
        st = self._ivar_state(pe, addrs, cmp, value)
        return st.index(True) if True in st else None

    def test_some(self, pe: int, addrs, cmp: int, value):
        """Indices of every satisfied variable (possibly empty)."""
        st = self._ivar_state(pe, addrs, cmp, value)
        return [i for i, ok in enumerate(st) if ok]

    def wait_until_all(self, pe: int, addrs, cmp: int, value) -> None:
        """Single-controller: like wait_until, an unsatisfied wait has
        no concurrent producer and is surfaced as the deadlock it is."""
        if not self.test_all(pe, addrs, cmp, value):
            raise MPIError(ERR_PENDING,
                           "shmem_wait_until_all would deadlock: "
                           "conditions unsatisfied with no concurrent "
                           "producer (perform the puts first)")

    def wait_until_any(self, pe: int, addrs, cmp: int, value) -> int:
        got = self.test_any(pe, addrs, cmp, value)
        if got is None:
            raise MPIError(ERR_PENDING,
                           "shmem_wait_until_any would deadlock")
        return got

    def wait_until_some(self, pe: int, addrs, cmp: int, value):
        got = self.test_some(pe, addrs, cmp, value)
        if not got:
            raise MPIError(ERR_PENDING,
                           "shmem_wait_until_some would deadlock")
        return got

    # -- ordering / completion -----------------------------------------
    def fence(self) -> None:
        self.heap.flush_all()

    def quiet(self) -> None:
        self.heap.flush_all()

    # -- collectives (scoll; delegate to coll like scoll/mpi) ----------
    def barrier_all(self) -> None:
        self.comm.barrier()

    def sync_all(self) -> None:
        """shmem_sync.c: barrier WITHOUT the implied quiet (no
        completion of pending puts) — pure arrival synchronization."""
        self.comm.barrier()

    def barrier(self, start: int, log_stride: int, size: int) -> None:
        """Active-set barrier (the pre-teams shmem_barrier.c calling
        convention): PEs {start + i*2^log_stride : i < size}. Includes
        the implied quiet, then synchronizes the strided team."""
        self.quiet()
        self.team_world().split_strided(start, 1 << log_stride,
                                        size).sync()

    def broadcast(self, addr: int, nelems: int, root_pe: int) -> None:
        self.team_world().broadcast(addr, nelems, root_pe)

    def collect(self, addr: int, nelems: int):
        """fcollect: concatenation of every PE's segment, symmetric
        result returned (host array, one device-to-host copy)."""
        with self.heap._lock:
            return to_numpy(self._rows(addr, nelems).reshape(-1))

    def reduce(self, addr: int, nelems: int,
               op: op_mod.Op = op_mod.SUM) -> None:
        """to_all reduction over all PEs' segments; result written back
        symmetrically."""
        self.team_world().reduce(addr, nelems, op)

    def alltoall(self, addr: int, nelems: int) -> None:
        """shmem_alltoall: PE i's j-th ``nelems`` block lands in PE j's
        segment at block i (symmetric, in place in the heap)."""
        n = self.n_pes
        with self.heap._lock:
            rows = self._rows(addr, nelems * n)
            blocks = rows.reshape(n, n, nelems).transpose(0, 1).clone()
            rows.copy_(blocks.reshape(n, n * nelems))

    def alltoalls(self, addr: int, nelems: int, dst: int = 1,
                  sst: int = 1) -> None:
        """shmem_alltoalls: strided alltoall — PE i's block j is read
        with source stride ``sst`` and written into PE j's segment with
        destination stride ``dst`` at block i. Every PE's destination row
        is assembled on the heap's device (holes keep their current
        content) and written back in one copy."""
        n = self.n_pes
        span_src = nelems * sst * n
        span_dst = (n * nelems - 1) * dst + 1
        with self.heap._lock:
            blocks = self._rows(addr, span_src).clone()
            dest = self._rows(addr, span_dst)
            out = dest.clone()
            for j in range(n):
                for i in range(n):
                    seg = blocks[i, j * nelems * sst:
                                 (j + 1) * nelems * sst:sst]
                    base = i * nelems * dst
                    out[j, base:base + (nelems - 1) * dst + 1:dst] = seg
            dest.copy_(out)

    def fcollect(self, addr: int, nelems: int):
        """shmem_fcollect: fixed-size concatenation (alias of collect
        with uniform block size)."""
        return self.collect(addr, nelems)

    def collect_varying(self, addr: int, nelems_per_pe: List[int]):
        """shmem_collect: concatenation with per-PE block sizes (the
        varying-nelems form the f-variant fixes)."""
        with self.heap._lock:
            rows = self._rows(addr, max(map(int, nelems_per_pe),
                                        default=0))
            return to_numpy(torch.cat([rows[pe, :int(ne)] for pe, ne
                                       in enumerate(nelems_per_pe)]))

    # Named to_all reductions (shmem_<type>_<op>_to_all surface).
    def sum_to_all(self, addr, nelems):
        self.reduce(addr, nelems, op_mod.SUM)

    def prod_to_all(self, addr, nelems):
        self.reduce(addr, nelems, op_mod.PROD)

    def max_to_all(self, addr, nelems):
        self.reduce(addr, nelems, op_mod.MAX)

    def min_to_all(self, addr, nelems):
        self.reduce(addr, nelems, op_mod.MIN)

    def and_to_all(self, addr, nelems):
        self.reduce(addr, nelems, op_mod.BAND)

    def or_to_all(self, addr, nelems):
        self.reduce(addr, nelems, op_mod.BOR)

    def xor_to_all(self, addr, nelems):
        self.reduce(addr, nelems, op_mod.BXOR)

    # -- contexts (shmem_ctx_create, SHMEM 1.4) ------------------------
    def ctx_create(self) -> "ShmemCommCtx":
        """shmem_ctx_create: an independent ordering stream over the
        same heap (its quiet orders only its own operations)."""
        return ShmemCommCtx(self)

    # -- teams (spml teams, oshmem/mca/spml/spml.h:689-784) -------------
    def team_world(self) -> "ShmemTeam":
        return ShmemTeam(self, list(range(self.n_pes)))


class ShmemCommCtx:
    """A communication context (``shmem_ctx_t``): put/get/atomics
    delegated to the parent heap, with an independent completion scope —
    ``quiet`` orders only operations issued through this context (the
    contexts framework's purpose; here each op is queued at issue, so
    the scope is trivially satisfied, but the op count makes the scope
    observable/testable)."""

    def __init__(self, parent: ShmemCtx):
        self.parent = parent
        self.pending_ops = 0

    def put(self, dest_pe: int, addr: int, data) -> None:
        self.parent.put(dest_pe, addr, data)
        self.pending_ops += 1

    def get(self, src_pe: int, addr: int, nelems: int):
        self.pending_ops += 1
        return self.parent.get(src_pe, addr, nelems)

    def atomic_add(self, dest_pe: int, addr: int, value) -> None:
        self.parent.atomic_add(dest_pe, addr, value)
        self.pending_ops += 1

    def quiet(self) -> None:
        self.parent.quiet()
        self.pending_ops = 0

    def fence(self) -> None:
        self.parent.fence()

    def destroy(self) -> None:
        self.quiet()


class ShmemTeam:
    """A SHMEM team: an ordered PE subset with its own collectives
    (``spml.h:689-784`` team create/translate), over the heap rows of
    its PEs."""

    def __init__(self, ctx: ShmemCtx, pes: list):
        self.ctx = ctx
        self.pes = list(pes)

    @property
    def n_pes(self) -> int:
        return len(self.pes)

    def translate_pe(self, pe: int, dest: "ShmemTeam") -> int:
        """shmem_team_translate_pe: this team's ``pe`` in ``dest``'s
        numbering (-1 if absent)."""
        world_pe = self.pes[pe]
        try:
            return dest.pes.index(world_pe)
        except ValueError:
            return -1

    def split_strided(self, start: int, stride: int,
                      size: int) -> "ShmemTeam":
        """shmem_team_split_strided over this team's numbering."""
        sel = [self.pes[start + i * stride] for i in range(size)]
        return ShmemTeam(self.ctx, sel)

    def split_2d(self, xrange: int):
        """shmem_team_split_2d: (x, y) sub-teams of an xrange-wide grid."""
        xs = [ShmemTeam(self.ctx, self.pes[i:i + xrange])
              for i in range(0, self.n_pes, xrange)]
        ys = [ShmemTeam(self.ctx, self.pes[i::xrange])
              for i in range(min(xrange, self.n_pes))]
        return xs, ys

    def sync(self) -> None:
        """shmem_team_sync: order heap updates across the team."""
        self.ctx.heap.flush_all()

    def broadcast(self, addr: int, nelems: int, root_pe: int) -> None:
        """Team broadcast: ``root_pe`` in team numbering; the root's
        segment is copied row to row where the heap lives."""
        root = self.pes[root_pe]
        with self.ctx.heap._lock:
            rows = self.ctx._rows(addr, nelems)
            for pe in self.pes:
                if pe != root:
                    rows[pe].copy_(rows[root])

    def reduce(self, addr: int, nelems: int,
               op: op_mod.Op = op_mod.SUM) -> None:
        """Fold the team's segments in PE order (the reference's order,
        so float sums round alike) and write the result to every
        member."""
        with self.ctx.heap._lock:
            rows = self.ctx._rows(addr, nelems)
            acc = rows[self.pes[0]].clone()
            for pe in self.pes[1:]:
                acc = op(acc, rows[pe])
            for pe in self.pes:
                rows[pe].copy_(acc)
