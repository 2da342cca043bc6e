"""The port's OpenSHMEM (``ompi_tpu_torch/shmem``) against the JAX
package's: ``tests/test_shmem_ext.py`` (17), ``test_aux.py::
test_shmem_lite``, ``test_api_surface.py::test_shmem_{teams,
team_reduce_and_atomics,alltoall}`` and ``test_native_runtime.py::
test_shmem_malloc_free_reuses_space``.

Each body runs once per package — the port's ``ShmemCtx`` on its 8-rank
CPU world, the reference's on its 8-device world — with the reference
test's own assertions, and returns what it observed; the two lists must
agree element for element. Heap rows live on the world's device; ``get``
and every fetching call return host numpy in both packages. The port
also takes tensor origins (``test_tensor_origins``), which the
reference's heap would turn into host copies.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import ompi_tpu as R
import ompi_tpu_torch as P
from ompi_tpu.shmem import api as r_api
from ompi_tpu_torch.shmem import api as p_api

N = 8


@pytest.fixture()
def pworld():
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    yield P.get_comm_world()
    P._reset_for_tests()


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _agree(body, world, pworld):
    """Run ``body(pkg, api, comm)`` through both packages; every value
    the port observed equals the reference's (same dtype class, same
    values)."""
    got = body(P, p_api, pworld)
    want = body(R, r_api, world)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = _host(a), _host(b)
        assert a.shape == b.shape, (a, b)
        np.testing.assert_array_equal(a, b.astype(a.dtype))
    return got


# -- tests/test_shmem_ext.py ------------------------------------------------
def _ctx(api, comm, dtype=np.float64, heap=1 << 10):
    return api.ShmemCtx(comm, heap_size=heap, dtype=dtype)


def test_wait_until_and_test(world, pworld):
    def body(pkg, api, comm):
        ctx = _ctx(api, comm)
        a = ctx.malloc(4)
        ctx.p(2, a, 7.0)
        out = [ctx.test(2, a, api.CMP_EQ, 7.0),
               ctx.test(2, a, api.CMP_GE, 7.0),
               ctx.test(2, a, api.CMP_LT, 7.0)]
        assert out == [True, True, False]
        ctx.wait_until(2, a, api.CMP_NE, 0.0)   # satisfied -> returns
        with pytest.raises(pkg.MPIError) as ei:
            ctx.wait_until(2, a, api.CMP_EQ, 99.0)  # deadlock surfaced
        return out + [ei.value.error_class]
    got = _agree(body, world, pworld)
    assert got[-1] == P.ERR_PENDING


def test_put_signal_set_and_add(world, pworld):
    def body(pkg, api, comm):
        ctx = _ctx(api, comm)
        data = ctx.malloc(4)
        sig = ctx.malloc(1)
        ctx.put_signal(3, data, np.float64([1, 2, 3, 4]), sig, 1.0,
                       api.SIGNAL_SET)
        out = [ctx.get(3, data, 4), ctx.signal_fetch(3, sig)]
        assert np.allclose(out[0], [1, 2, 3, 4]) and out[1] == 1.0
        ctx.put_signal(3, data, np.float64([5, 6, 7, 8]), sig, 1.0,
                       api.SIGNAL_ADD)
        out.append(ctx.signal_fetch(3, sig))
        assert out[-1] == 2.0
        ctx.signal_wait_until(3, sig, api.CMP_EQ, 2.0)
        return out + [ctx.get(3, data, 4)]
    _agree(body, world, pworld)


def test_locks(world, pworld):
    def body(pkg, api, comm):
        ctx = _ctx(api, comm)
        lk = ctx.malloc(1)
        out = [ctx.test_lock(lk, pe=2), ctx.test_lock(lk, pe=5)]
        assert out == [True, False]              # acquired, contended
        for fn in (ctx.set_lock, ctx.clear_lock):  # deadlock, not holder
            with pytest.raises(pkg.MPIError) as ei:
                fn(lk, pe=5)
            out.append(ei.value.error_class)
        ctx.clear_lock(lk, pe=2)
        ctx.set_lock(lk, pe=5)                   # now free
        out.append(ctx.g(0, lk))
        ctx.clear_lock(lk, pe=5)
        return out + [ctx.g(0, lk)]
    assert _agree(body, world, pworld)[2:] == [P.ERR_PENDING, P.ERR_ARG,
                                                6.0, 0.0]


def test_iput_iget_strided(world, pworld):
    def body(pkg, api, comm):
        ctx = _ctx(api, comm)
        a = ctx.malloc(16)
        ctx.put(1, a, np.zeros(16))
        ctx.iput(1, a, np.float64([1, 2, 3, 4]), tst=2)
        row = ctx.get(1, a, 8)
        assert np.allclose(row, [1, 0, 2, 0, 3, 0, 4, 0])
        got = ctx.iget(1, a, 4, sst=2)
        assert np.allclose(got, [1, 2, 3, 4])
        # target stride spaces elements locally (mirrors iput)
        spaced = ctx.iget(1, a, 4, tst=2, sst=2)
        assert np.allclose(spaced, [1, 0, 2, 0, 3, 0, 4])
        return [row, got, spaced]
    _agree(body, world, pworld)


def test_alltoalls_strided(world, pworld):
    def body(pkg, api, comm):
        ctx = _ctx(api, comm)
        n = ctx.n_pes
        a = ctx.malloc(2 * n)
        for pe in range(n):                    # PE pe's block j = pe*10+j
            ctx.put(pe, a, np.float64([pe * 10 + j for j in range(n)]))
        ctx.alltoalls(a, 1, dst=1, sst=1)
        out = [ctx.get(pe, a, 2 * n) for pe in range(n)]
        for pe in range(n):
            assert np.allclose(out[pe][:n], [i * 10 + pe for i in range(n)])
        return out
    _agree(body, world, pworld)


@pytest.mark.parametrize("dst,sst", [(2, 1), (1, 2)])
def test_alltoalls_strides_against_reference(world, pworld, dst, sst):
    """The port assembles alltoalls' rows on the heap's device; the
    reference assembles them on the host. Both with holes and source
    strides."""
    def body(pkg, api, comm):
        ctx = _ctx(api, comm, heap=64)
        n = ctx.n_pes
        a = ctx.malloc(32)
        for pe in range(n):
            ctx.put(pe, a, np.arange(32, dtype=np.float64) + 100 * pe)
        ctx.alltoalls(a, 1, dst=dst, sst=sst)
        return [ctx.get(pe, a, 32) for pe in range(n)]
    _agree(body, world, pworld)


def test_collect_varying_and_fcollect(world, pworld):
    def body(pkg, api, comm):
        ctx = _ctx(api, comm)
        n = ctx.n_pes
        a = ctx.malloc(4)
        for pe in range(n):
            ctx.put(pe, a, np.float64([pe, pe, pe, pe]))
        f = ctx.fcollect(a, 2)
        assert np.allclose(f, np.repeat(np.arange(n), 2))
        sizes = [1 + (pe % 2) for pe in range(n)]
        got = ctx.collect_varying(a, sizes)
        want = np.concatenate([[pe] * s for pe, s in enumerate(sizes)])
        assert np.allclose(got, want)
        return [f, got, ctx.collect(a, 4)]
    _agree(body, world, pworld)


def test_named_reductions(world, pworld):
    def body(pkg, api, comm):
        ctx = _ctx(api, comm)
        a = ctx.malloc(2)
        for pe in range(ctx.n_pes):
            ctx.put(pe, a, np.float64([pe + 1, 1.0]))
        ctx.max_to_all(a, 2)
        out = [ctx.get(0, a, 2)]
        assert np.allclose(out[0], [ctx.n_pes, 1.0])
        for pe in range(ctx.n_pes):
            ctx.put(pe, a, np.float64([pe + 1, 2.0]))
        ctx.sum_to_all(a, 2)
        n = ctx.n_pes
        out.append(ctx.get(3, a, 2))
        assert np.allclose(out[-1], [n * (n + 1) / 2, 2.0 * n])
        for name in ("prod_to_all", "min_to_all"):
            for pe in range(n):
                ctx.put(pe, a, np.float64([pe + 1.5, 2.0 - pe]))
            getattr(ctx, name)(a, 2)
            out.append(ctx.get(5, a, 2))
        return out
    _agree(body, world, pworld)


def test_named_reductions_float32_bits(world, pworld, rng):
    """A float32 sum over 8 PEs folds in PE order in both packages, so
    the sums agree bit for bit, not only within a tolerance."""
    x = rng.standard_normal((N, 64)).astype(np.float32)

    def body(pkg, api, comm):
        ctx = _ctx(api, comm, dtype=np.float32)
        a = ctx.malloc(64)
        for pe in range(N):
            ctx.put(pe, a, x[pe])
        ctx.sum_to_all(a, 64)
        return [ctx.get(pe, a, 64) for pe in range(N)]
    got = _agree(body, world, pworld)
    np.testing.assert_allclose(got[0], x.sum(0), rtol=1e-5, atol=1e-6)


def test_named_bitwise_reductions(world, pworld):
    def body(pkg, api, comm):
        ctx = api.ShmemCtx(comm, heap_size=1 << 8, dtype=np.int64)
        a = ctx.malloc(1)
        out = []
        for name in ("or_to_all", "and_to_all", "xor_to_all"):
            for pe in range(ctx.n_pes):
                ctx.p(pe, a, (1 << pe) | 0b1)
            getattr(ctx, name)(a, 1)
            out.append(ctx.g(0, a))
        assert int(out[0]) == (1 << ctx.n_pes) - 1
        return out
    _agree(body, world, pworld)


def test_ctx_create_scope(world, pworld):
    def body(pkg, api, comm):
        ctx = _ctx(api, comm)
        c = ctx.ctx_create()
        a = ctx.malloc(2)
        c.put(1, a, np.float64([4, 5]))
        out = [c.pending_ops]
        c.quiet()
        out.append(c.pending_ops)
        assert out == [1, 0]
        out.append(ctx.get(1, a, 2))
        assert np.allclose(out[-1], [4, 5])
        c.destroy()
        return out
    _agree(body, world, pworld)


def test_ptr_snapshot(world, pworld):
    def body(pkg, api, comm):
        ctx = _ctx(api, comm)
        a = ctx.malloc(2)
        ctx.put(2, a, np.float64([8, 9]))
        snap = ctx.ptr(2)
        assert np.allclose(snap[a:a + 2], [8, 9])
        ctx.put(2, a, np.float64([1, 1]))      # a snapshot, not a view
        return [snap]
    got = _agree(body, world, pworld)
    assert isinstance(got[0], np.ndarray) and got[0][0] == 8.0


def test_heap_calloc_realloc_align_free(world, pworld):
    def body(pkg, api, comm):
        ctx = _ctx(api, comm)
        a = ctx.calloc(8)
        out = [ctx.get(1, a, 8)]
        assert np.allclose(out[0], 0.0)
        ctx.p(1, a, 42.0)
        b = ctx.realloc(a, 16)                 # content moves
        out.append(ctx.get(1, b, 1))
        assert out[-1][0] == 42.0
        with pytest.raises(pkg.MPIError):
            ctx.free(a)                        # a was freed by realloc
        c = ctx.align(8, 4)
        assert c % 8 == 0
        ctx.free(c)
        with pytest.raises(pkg.MPIError):
            ctx.free(c)                        # double free surfaced
        return out + [np.asarray([a, b, c])]
    _agree(body, world, pworld)


def test_atomic_inc_and_fetch_inc(world, pworld):
    def body(pkg, api, comm):
        ctx = _ctx(api, comm)
        a = ctx.malloc(1)
        ctx.p(2, a, 10.0)
        ctx.atomic_inc(2, a)
        out = [ctx.atomic_fetch_inc(2, a), ctx.g(2, a)]
        assert out == [11.0, 12.0]
        return out
    _agree(body, world, pworld)


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.uint32])
def test_bitwise_atomics(world, pworld, dtype):
    """``ictx``'s bitwise atomics, on the reference's int64 heap and on
    int32 and uint32 heaps (the port's unsigned routing)."""
    def body(pkg, api, comm):
        ictx = api.ShmemCtx(comm, heap_size=1 << 10, dtype=dtype)
        a = ictx.malloc(1)
        ictx.p(1, a, 0b1100)
        ictx.atomic_and(1, a, 0b1010)
        out = [ictx.g(1, a)]
        assert out[-1] == 0b1000
        ictx.atomic_or(1, a, 0b0001)
        out.append(ictx.g(1, a))
        assert out[-1] == 0b1001
        old = ictx.atomic_fetch_xor(1, a, 0b1111)
        out += [old, ictx.g(1, a)]
        assert old == 0b1001 and out[-1] == 0b0110
        out.append(ictx.atomic_fetch_and(1, a, 0b0010))
        assert out[-1] == 0b0110
        out.append(ictx.atomic_fetch_or(1, a, 0b1000))
        assert out[-1] == 0b0010
        ictx.atomic_xor(1, a, 0b0101)
        return out + [ictx.g(1, a)]
    got = _agree(body, world, pworld)
    assert np.asarray(got[0]).dtype == np.dtype(dtype)


def test_ivars_test_and_wait(world, pworld):
    def body(pkg, api, comm):
        ctx = _ctx(api, comm)
        offs = [ctx.malloc(1) for _ in range(3)]
        ctx.p(0, offs[0], 5.0)
        ctx.p(0, offs[2], 5.0)
        out = [ctx.test_all(0, offs, api.CMP_EQ, 5.0),
               ctx.test_any(0, offs, api.CMP_EQ, 5.0),
               ctx.test_some(0, offs, api.CMP_EQ, 5.0)]
        assert out == [False, 0, [0, 2]]
        ctx.p(0, offs[1], 5.0)
        ctx.wait_until_all(0, offs, api.CMP_EQ, 5.0)   # satisfied
        out += [ctx.wait_until_any(0, offs, api.CMP_EQ, 5.0),
                ctx.wait_until_some(0, offs, api.CMP_NE, 9.0)]
        assert out[3:] == [0, [0, 1, 2]]
        for fn in (ctx.wait_until_all, ctx.wait_until_any,
                   ctx.wait_until_some):
            with pytest.raises(pkg.MPIError):
                fn(0, offs, api.CMP_EQ, 99.0)       # deadlock surfaced
        return out
    _agree(body, world, pworld)


def test_accessibility_info_pcontrol_cache(world, pworld):
    def body(pkg, api, comm):
        ctx = _ctx(api, comm)
        a = ctx.malloc(2)
        out = [ctx.pe_accessible(ctx.n_pes - 1), ctx.pe_accessible(ctx.n_pes),
               ctx.addr_accessible(a, 0), ctx.addr_accessible(1 << 30, 0),
               list(ctx.info_get_version())]
        assert out == [True, False, True, False, [1, 5]]
        assert "OpenSHMEM" in ctx.info_get_name()
        ctx.pcontrol(2)                        # SPC-recorded no-op
        ctx.clear_cache_inv()                  # deprecated no-ops
        ctx.set_cache_inv()
        ctx.udcflush()
        return out
    _agree(body, world, pworld)
    from ompi_tpu_torch.runtime import spc
    assert spc.read("shmem_pcontrol") == 2


def test_active_set_barrier_and_sync(world, pworld):
    def body(pkg, api, comm):
        ctx = _ctx(api, comm)
        ctx.sync_all()
        # PEs {0, 2, 4, ...}: stride 2^1 active set
        ctx.barrier(0, 1, ctx.n_pes // 2)
        return [ctx.n_pes]
    _agree(body, world, pworld)


def test_global_exit_raises_systemexit(world, pworld):
    def body(pkg, api, comm):
        with pytest.raises(SystemExit) as ei:
            _ctx(api, comm).global_exit(3)
        return [ei.value.code]
    _agree(body, world, pworld)


# -- tests/test_aux.py, test_api_surface.py, test_native_runtime.py ---------
def test_shmem_lite(world, pworld):
    def body(pkg, api, comm):
        from_pkg = (P.shmem if pkg is P else R.shmem)
        ctx = from_pkg.ShmemCtx(comm, heap_size=64)
        assert ctx.n_pes == comm.size
        a = ctx.malloc(4)
        b = ctx.malloc(2)
        assert (a, b) == (0, 4)
        ctx.put(1, a, np.arange(4, dtype=np.float32))
        out = [ctx.get(1, a, 4)]
        np.testing.assert_array_equal(out[0], np.arange(4))
        ctx.p(2, b, 7.0)
        out.append(ctx.g(2, b))
        ctx.atomic_add(2, b, 3.0)
        out.append(ctx.atomic_fetch_add(2, b, 1.0))
        assert out[1:] == [7.0, 10.0]
        old = ctx.atomic_compare_swap(2, b, cond=11.0, value=99.0)
        out += [old, ctx.g(2, b)]
        assert out[3:] == [11.0, 99.0]
        for pe in range(ctx.n_pes):
            ctx.put(pe, a, np.full(4, float(pe), np.float32))
        ctx.reduce(a, 4, pkg.SUM)
        out.append(ctx.get(0, a, 4))
        np.testing.assert_array_equal(out[-1], sum(range(ctx.n_pes)))
        ctx.broadcast(b, 1, root_pe=2)
        out.append(ctx.g(0, b))
        assert out[-1] == 99.0
        ctx.barrier_all()
        return out
    import ompi_tpu.shmem  # noqa: F401
    import ompi_tpu_torch.shmem  # noqa: F401
    _agree(body, world, pworld)


def test_shmem_teams(world, pworld):
    def body(pkg, api, comm):
        ctx = api.ShmemCtx(comm, heap_size=32)
        team = ctx.team_world()
        assert team.n_pes == comm.size
        evens = team.split_strided(0, 2, comm.size // 2)
        assert evens.pes == list(range(0, comm.size, 2))
        out = [team.translate_pe(2, evens), evens.translate_pe(1, team),
               team.translate_pe(1, evens)]
        assert out == [1, 2, -1]
        addr = ctx.malloc(4)
        for pe in range(comm.size):
            ctx.put(pe, addr, np.full(4, pe, np.float32))
        evens.broadcast(addr, 4, 0)        # root = team pe 0 = world pe 0
        out += [ctx.get(pe, addr, 4) for pe in range(comm.size)]
        np.testing.assert_array_equal(out[3 + 2], np.zeros(4, np.float32))
        np.testing.assert_array_equal(out[3 + 1], np.ones(4, np.float32))
        xs, ys = team.split_2d(2)
        assert xs[0].pes == [0, 1] and ys[0].pes[0] == 0
        return out + [[t.pes for t in xs], [t.pes for t in ys]]
    _agree(body, world, pworld)


def test_shmem_team_reduce_and_atomics(world, pworld):
    def body(pkg, api, comm):
        ctx = api.ShmemCtx(comm, heap_size=16)
        team = ctx.team_world().split_strided(0, 1, 2)    # PEs {0,1}
        addr = ctx.malloc(2)
        for pe in range(comm.size):
            ctx.put(pe, addr, np.full(2, float(pe + 1), np.float32))
        team.reduce(addr, 2, pkg.SUM)
        out = [ctx.get(0, addr, 2), ctx.get(3, addr, 2)]
        np.testing.assert_array_equal(out[0], np.full(2, 3.0, np.float32))
        np.testing.assert_array_equal(out[1], np.full(2, 4.0, np.float32))
        ctx.atomic_set(2, addr, 5.0)
        out.append(ctx.atomic_fetch(2, addr))
        old = ctx.atomic_swap(2, addr, 7.0)
        out += [old, ctx.atomic_fetch(2, addr)]
        assert out[2:] == [5.0, 5.0, 7.0]
        return out
    _agree(body, world, pworld)


def test_shmem_alltoall(world, pworld):
    def body(pkg, api, comm):
        n = comm.size
        ctx = api.ShmemCtx(comm, heap_size=n)
        addr = ctx.malloc(n)
        for pe in range(n):
            ctx.put(pe, addr, np.arange(n, dtype=np.float32) + 10 * pe)
        ctx.alltoall(addr, 1)
        out = [ctx.get(j, addr, n) for j in range(n)]
        for j in range(n):
            np.testing.assert_array_equal(
                out[j], np.array([10 * i + j for i in range(n)],
                                 np.float32))
        return out
    _agree(body, world, pworld)


def test_shmem_malloc_free_reuses_space(world, pworld):
    def body(pkg, api, comm):
        ctx = api.ShmemCtx(comm, heap_size=32)
        addrs = [ctx.malloc(8) for _ in range(4)]    # fills the heap
        assert len(set(addrs)) == 4
        with pytest.raises(Exception):
            ctx.malloc(8)
        ctx.free(addrs[0])
        again = ctx.malloc(8)
        assert again == addrs[0]                     # space reclaimed
        return [addrs, again]
    _agree(body, world, pworld)


def test_bump_allocator_on_odd_heaps(world, pworld):
    """A heap that is not a power of two takes the bump allocator in
    both packages (the buddy serves only 2^k elements)."""
    def body(pkg, api, comm):
        ctx = api.ShmemCtx(comm, heap_size=24)
        out = [ctx._buddy < 0, ctx.malloc(5), ctx.align(8, 3),
               ctx.malloc(4)]
        with pytest.raises(pkg.MPIError):
            ctx.malloc(16)
        return out
    assert _agree(body, world, pworld) == [True, 0, 8, 11]


# -- the port only: tensor origins ------------------------------------------
def test_tensor_origins(pworld, world):
    """``put`` takes a tensor as it is (the row is written from it where
    the heap lives); the values equal a numpy origin's through the
    reference."""
    x = np.random.default_rng(7).standard_normal((N, 16)).astype(np.float32)

    def body(pkg, api, comm, origin):
        ctx = api.ShmemCtx(comm, heap_size=64)
        a = ctx.malloc(16)
        for pe in range(N):
            ctx.put(pe, a, origin(x[(pe + 1) % N]))
        ctx.iput(3, a, origin(x[0][:4]), tst=3)
        ctx.max_to_all(a, 16)
        return [ctx.get(pe, a, 16) for pe in range(N)] + [ctx.collect(a, 16)]
    got = body(P, p_api, pworld, torch.from_numpy)
    want = body(R, r_api, world, np.asarray)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    ctx = p_api.ShmemCtx(pworld, heap_size=64)
    assert ctx.heap.buffer.device == pworld.device
