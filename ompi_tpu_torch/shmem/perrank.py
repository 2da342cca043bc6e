"""shmem/perrank — OpenSHMEM for the per-rank execution model.

Behavioral spec: ``oshmem/`` — PEs address each other's symmetric heap
with plain offsets (symmetry by construction: every PE allocates the
same segments in the same order, ``memheap``); ``spml`` provides
put/get with remote completion (``spml.h:229-330``); ``scoll/mpi``
delegates collectives to the MPI stack; atomics through ``atomic/*``.

One PE is one OS process is one MPI rank (the port of
``ompi_tpu/shmem/perrank.py``). The symmetric heap is a
:class:`RankWindow` exposure region per PE (the reference's mmap'd
segment, in host memory), so a "symmetric address" is an offset valid on
every PE; put/get/atomics are the window's acked active messages
(target-side application on the reader thread — genuine one-sided
progress, the spml put/get contract). A CUDA origin is staged with one
``.cpu()`` copy, as every per-rank window stages it.
``shmem_wait_until`` polls the LOCAL heap, which remote puts mutate
asynchronously — the flag-polling idiom every SHMEM program is built on.
Collectives delegate to the per-rank communicator (scoll/mpi's exact
design).
"""
from __future__ import annotations

import time

import numpy as np

from ompi_tpu_torch.core import op as op_mod
from ompi_tpu_torch.core.errhandler import ERR_ARG, ERR_PENDING, MPIError
from ompi_tpu_torch.osc.perrank import RankWindow
from ompi_tpu_torch.shmem.api import (  # noqa: F401 (re-exported)
    CMP_EQ, CMP_GE, CMP_GT, CMP_LE, CMP_LT, CMP_NE, SIGNAL_ADD, SIGNAL_SET,
    _CMP_FNS)


class ShmemRankCtx:
    """A per-rank SHMEM context: my PE number is real, peers are other
    processes."""

    def __init__(self, comm, heap_size: int = 1 << 12,
                 dtype=np.float32):
        self.comm = comm
        self.heap_size = int(heap_size)
        self.win = RankWindow(comm, heap_size, dtype=dtype,
                              name="symheap")
        self._brk = 0

    # -- PE identity ----------------------------------------------------
    def my_pe(self) -> int:
        return self.comm.rank()

    def n_pes(self) -> int:
        return self.comm.size

    # -- symmetric allocation (shmem_malloc: collective, same offset
    # everywhere — the memheap contract) --------------------------------
    def malloc(self, count: int) -> int:
        if self._brk + count > self.heap_size:
            raise MPIError(ERR_ARG, "symmetric heap exhausted")
        off = self._brk
        self._brk += count
        return off

    # -- RMA (spml put/get) ----------------------------------------------
    def put(self, dest_off: int, data, pe: int) -> None:
        self.win.put(data, pe, dest_off)

    def get(self, src_off: int, count: int, pe: int) -> np.ndarray:
        return self.win.get(pe, src_off, count)

    def p(self, off: int, value, pe: int) -> None:
        self.win.put([value], pe, off)

    def g(self, off: int, pe: int):
        return self.win.get(pe, off, 1)[0]

    # -- atomics (oshmem/mca/atomic) ---------------------------------
    def atomic_add(self, off: int, value, pe: int) -> None:
        self.win.accumulate([value], pe, off, op="sum")

    def atomic_fetch_add(self, off: int, value, pe: int):
        return self.win.fetch_and_op(value, pe, off, op="sum")

    def atomic_fetch(self, off: int, pe: int):
        return self.win.fetch_and_op(0, pe, off, op="no_op")

    def atomic_set(self, off: int, value, pe: int) -> None:
        self.win.accumulate([value], pe, off, op="replace")

    def atomic_compare_swap(self, off: int, cond, value, pe: int):
        return self.win.compare_and_swap(cond, value, pe, off)

    def atomic_swap(self, off: int, value, pe: int):
        """shmem_swap.c: unconditional fetch-and-replace."""
        return self.win.fetch_and_op(value, pe, off, op="replace")

    def atomic_inc(self, off: int, pe: int) -> None:
        self.atomic_add(off, 1, pe)

    def atomic_fetch_inc(self, off: int, pe: int):
        return self.atomic_fetch_add(off, 1, pe)

    # bitwise AMOs (shmem_{and,or,xor}.c + shmem_f{and,or,xor}.c),
    # applied atomically on the TARGET's reader thread
    def atomic_and(self, off: int, value, pe: int) -> None:
        self.win.accumulate([value], pe, off, op="band")

    def atomic_or(self, off: int, value, pe: int) -> None:
        self.win.accumulate([value], pe, off, op="bor")

    def atomic_xor(self, off: int, value, pe: int) -> None:
        self.win.accumulate([value], pe, off, op="bxor")

    def atomic_fetch_and(self, off: int, value, pe: int):
        return self.win.fetch_and_op(value, pe, off, op="band")

    def atomic_fetch_or(self, off: int, value, pe: int):
        return self.win.fetch_and_op(value, pe, off, op="bor")

    def atomic_fetch_xor(self, off: int, value, pe: int):
        return self.win.fetch_and_op(value, pe, off, op="bxor")

    # -- signaling (shmem_put_signal.c, SHMEM 1.5) ---------------------
    def put_signal(self, dest_off: int, data, sig_off: int, signal,
                   pe: int, sig_op: int = SIGNAL_SET) -> None:
        """Deliver the payload, then flip the signal word — the acked
        put guarantees payload-before-signal ordering, so the target's
        signal_wait_until genuinely gates on delivered data."""
        self.put(dest_off, data, pe)
        if sig_op == SIGNAL_ADD:
            self.atomic_add(sig_off, signal, pe)
        else:
            self.atomic_set(sig_off, signal, pe)

    def signal_fetch(self, sig_off: int):
        with self.win._lock:
            return self.win.local[sig_off]

    def signal_wait_until(self, sig_off: int, cmp: int, value,
                          timeout: float = 60):
        self.wait_until(sig_off, cmp, value, timeout)
        return self.signal_fetch(sig_off)

    # -- distributed locks (shmem_lock.c) — per-rank these BLOCK for
    # real: the holder is another OS process that will release
    def test_lock(self, off: int) -> bool:
        """Try-acquire via CAS 0 -> my_pe+1 on the lock word at PE 0
        (the lock-owner PE of OpenSHMEM's algorithm)."""
        prev = self.atomic_compare_swap(off, 0, self.my_pe() + 1, 0)
        return int(prev) == 0

    def set_lock(self, off: int, timeout: float = 60) -> None:
        deadline = time.monotonic() + timeout
        poll = 0.0002
        while not self.test_lock(off):
            if time.monotonic() > deadline:
                raise MPIError(ERR_PENDING,
                               f"shmem_set_lock timed out at offset "
                               f"{off}")
            time.sleep(poll)
            poll = min(poll * 2, 0.005)

    def clear_lock(self, off: int) -> None:
        prev = self.atomic_compare_swap(off, self.my_pe() + 1, 0, 0)
        if int(prev) != self.my_pe() + 1:
            raise MPIError(ERR_ARG,
                           f"shmem_clear_lock: PE {self.my_pe()} does "
                           f"not hold the lock at offset {off}")

    # -- ordering / sync -------------------------------------------------
    def fence(self) -> None:
        """shmem_fence/quiet: every put is acked, so ordering and
        remote completion already hold."""

    quiet = fence

    def barrier_all(self) -> None:
        self.comm.barrier()

    def wait_until(self, off: int, cmp: int, value,
                   timeout: float = 60) -> None:
        """Poll the LOCAL heap until the comparison holds — the flag
        that a remote PE's put/atomic flips (shmem_wait_until)."""
        fn = _CMP_FNS[cmp]
        deadline = time.monotonic() + timeout
        poll = 0.0002
        while True:
            with self.win._lock:
                cur = self.win.local[off]
            if fn(cur, value):
                return
            if time.monotonic() > deadline:
                raise MPIError(ERR_PENDING,
                               f"shmem_wait_until timed out "
                               f"(local[{off}]={cur})")
            time.sleep(poll)
            poll = min(poll * 2, 0.005)

    def test(self, off: int, cmp: int, value) -> bool:
        with self.win._lock:
            return bool(_CMP_FNS[cmp](self.win.local[off], value))

    # -- multi-variable sync (shmem_{test,wait}_ivars.c, SHMEM 1.4):
    # real polling loops — remote puts mutate the local heap
    # asynchronously from the reader thread
    def _ivar_state(self, offs, cmp: int, value):
        fn = _CMP_FNS[cmp]
        with self.win._lock:
            return [bool(fn(self.win.local[o], value)) for o in offs]

    def test_all(self, offs, cmp: int, value) -> bool:
        return all(self._ivar_state(offs, cmp, value))

    def test_any(self, offs, cmp: int, value):
        st = self._ivar_state(offs, cmp, value)
        return st.index(True) if True in st else None

    def test_some(self, offs, cmp: int, value):
        return [i for i, ok in enumerate(self._ivar_state(offs, cmp,
                                                          value)) if ok]

    def _wait_ivars(self, done, timeout: float):
        deadline = time.monotonic() + timeout
        poll = 0.0002
        while True:
            got = done()
            if got is not None:
                return got
            if time.monotonic() > deadline:
                raise MPIError(ERR_PENDING, "shmem_wait_until_* timed "
                                            "out")
            time.sleep(poll)
            poll = min(poll * 2, 0.005)

    def wait_until_all(self, offs, cmp: int, value,
                       timeout: float = 60) -> None:
        self._wait_ivars(
            lambda: True if self.test_all(offs, cmp, value) else None,
            timeout)

    def wait_until_any(self, offs, cmp: int, value,
                       timeout: float = 60) -> int:
        return self._wait_ivars(
            lambda: self.test_any(offs, cmp, value), timeout)

    def wait_until_some(self, offs, cmp: int, value,
                        timeout: float = 60):
        return self._wait_ivars(
            lambda: self.test_some(offs, cmp, value) or None, timeout)

    # -- accessibility / introspection ---------------------------------
    def pe_accessible(self, pe: int) -> bool:
        return 0 <= pe < self.n_pes()

    def addr_accessible(self, off: int, pe: int) -> bool:
        return self.pe_accessible(pe) and 0 <= off < self.heap_size

    @staticmethod
    def info_get_version():
        return (1, 5)

    @staticmethod
    def info_get_name() -> str:
        return "ompi_tpu-OpenSHMEM"

    # -- collectives (scoll/mpi: delegate to the MPI stack) -----------
    def broadcast(self, off: int, count: int, root_pe: int) -> None:
        with self.win._lock:
            seg = self.win.local[off:off + count].copy()
        out = self.comm.bcast(seg, root=root_pe)
        with self.win._lock:
            self.win.local[off:off + count] = out

    def collect(self, src_off: int, count: int) -> np.ndarray:
        with self.win._lock:
            seg = self.win.local[src_off:src_off + count].copy()
        return np.concatenate(self.comm.allgather(seg))

    def reduce(self, off: int, count: int,
               op: op_mod.Op = op_mod.SUM) -> np.ndarray:
        with self.win._lock:
            seg = self.win.local[off:off + count].copy()
        return np.asarray(self.comm.allreduce(seg, op))

    def finalize(self) -> None:
        self.win.free()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finalize()
        return False
