"""Parity of the port's v- and root-form collectives with the JAX
package's (``core/communicator.py``'s ``allgatherv``, ``gatherv``,
``scatterv``, ``alltoallv``, ``reduce_scatter(counts)``, ``gather_root``,
``scatter_root`` and the ``i*v`` requests).

The same ragged numpy inputs from a seed go to the port's 8-rank CPU
world and the conftest's JAX world. Data movement is held bit for bit
against the reference; ``reduce_scatter`` at rtol 1e-5 / atol 1e-5 (the
direct lowering sums the 8 rows in XLA's order there, torch's here).
Every result is a tensor on the comm's device: device inputs are padded
on the device and nothing round-trips through numpy.
"""
import numpy as np
import pytest
import torch

import ompi_tpu_torch as P
from ompi_tpu_torch.core.errhandler import ERR_COUNT, ERR_ROOT, MPIError

N = 8


@pytest.fixture()
def pworld():
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    w = P.get_comm_world()
    yield w
    P._reset_for_tests()


def _ragged(seed, counts, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "i":
        return [rng.integers(-99, 99, c).astype(dtype) for c in counts]
    return [rng.standard_normal(c).astype(dtype) for c in counts]


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def _tensors(seq):
    return [torch.from_numpy(a) for a in seq]


# No case pads to 8 elements: the JAX package's own
# test_reduce_scatter_counts_device_and_scaled needs its (8, 8, 8) float32
# reduce_scatter_block to be new to the JAX world's schedule cache.
COUNTS = {"ragged": [2 * r + 1 for r in range(N)],
          "with_zero": [0, 3, 1, 0, 5, 2, 7, 4],
          "equal": [5] * N}


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
@pytest.mark.parametrize("counts", sorted(COUNTS))
def test_allgatherv(pworld, world, kind, counts):
    per = _ragged(1, COUNTS[counts])
    got = pworld.allgatherv(_tensors(per) if kind == "tensor" else per)
    want = world.allgatherv(per)
    assert len(got) == N
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device == pworld.device
        _same(g, w)


@pytest.mark.parametrize("root", [0, 3, 7])
@pytest.mark.parametrize("counts", sorted(COUNTS))
def test_gatherv(pworld, world, counts, root):
    per = _ragged(2, COUNTS[counts])
    got = pworld.gatherv(_tensors(per), root)
    assert isinstance(got, torch.Tensor)
    _same(got, world.gatherv(per, root))


@pytest.mark.parametrize("root", [0, 1, 6])
@pytest.mark.parametrize("counts", sorted(COUNTS))
def test_scatterv(pworld, world, counts, root):
    chunks = _ragged(3, COUNTS[counts])
    got = pworld.scatterv(_tensors(chunks), root)
    want = world.scatterv(chunks, root)
    for g, w, c in zip(got, want, chunks):
        _same(g, w)
        _same(g, c)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_alltoallv(pworld, world, kind, dtype):
    rng = np.random.default_rng(4)
    send = [[_ragged(int(rng.integers(1 << 30)), [(i + j) % 3 + (i == j)],
                     dtype)[0] for j in range(N)] for i in range(N)]
    arg = [_tensors(row) for row in send] if kind == "tensor" else send
    got = pworld.alltoallv(arg)
    want = world.alltoallv(send)
    for j in range(N):
        for i in range(N):
            _same(got[j][i], want[j][i])
            _same(got[j][i], send[i][j])


def test_alltoallv_all_empty(pworld):
    send = [[np.zeros(0, np.float32)] * N for _ in range(N)]
    got = pworld.alltoallv(send)
    assert all(got[j][i].size == 0 for i in range(N) for j in range(N))


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
@pytest.mark.parametrize("counts", sorted(COUNTS))
def test_reduce_scatter_counts(pworld, world, mpi, kind, counts):
    cs = COUNTS[counts]
    x = np.random.default_rng(5).standard_normal(
        (N, sum(cs))).astype(np.float32)
    arg = pworld.stack(list(x)) if kind == "tensor" else x
    before = set(pworld.c_coll["reduce_scatter_block"]._cache)
    got = pworld.reduce_scatter(arg, cs, P.SUM)
    want = world.reduce_scatter(world.stack(list(x)), cs, mpi.SUM)
    red = x.sum(0, dtype=np.float64)
    off = 0
    for r, c in enumerate(cs):
        assert got[r].device == pworld.device and got[r].shape == (c,)
        np.testing.assert_allclose(got[r].numpy(), np.asarray(want[r]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[r].numpy(), red[off:off + c],
                                   rtol=1e-5, atol=1e-5)
        off += c
    if max(cs):
        # the lowering is reduce_scatter_block on the (N, N, max) pad
        new = set(pworld.c_coll["reduce_scatter_block"]._cache) - before
        assert any(k[0] == "reduce_scatter_block" for k in new)


def test_reduce_scatter_counts_max_and_leading_axes(pworld, world, mpi):
    cs = [2, 0, 1, 3, 2, 2, 1, 1]
    x = np.random.default_rng(6).integers(-50, 50, (N, 3, sum(cs))) \
        .astype(np.int32)
    got = pworld.reduce_scatter(pworld.put(x), cs, P.MAX)
    want = world.reduce_scatter(world.put(x), cs, mpi.MAX)
    for g, w in zip(got, want):
        _same(g, w)


def test_reduce_scatter_all_zero_counts(pworld):
    x = pworld.alloc((0,))
    out = pworld.reduce_scatter(x, [0] * N, P.SUM)
    assert [o.shape for o in out] == [(0,)] * N


@pytest.mark.parametrize("root", [0, 5])
def test_gather_root_and_scatter_root(pworld, world, root):
    x = np.random.default_rng(7).standard_normal((N, 3, 4)) \
        .astype(np.float32)
    st = pworld.put(x)
    g = pworld.gather_root(st, root)
    _same(g, np.asarray(world.gather_root(world.put(x), root)))
    assert g.device == pworld.devices[root]
    g[0, 0, 0] = 123.0                     # a copy, not a view
    assert st[0, 0, 0] != 123.0
    _same(pworld.gather_root(x, root), x)  # host input
    for arg in (x, torch.from_numpy(x)):
        s = pworld.scatter_root(arg, root)
        _same(s, np.asarray(world.scatter_root(x, root)))
        assert s.device == pworld.device
    s[1, 1, 1] = -7.0
    assert x[1, 1, 1] != -7.0


def test_errors_use_the_errhandler(pworld):
    pworld.set_errhandler(P.ERRORS_RETURN)
    with pytest.raises(MPIError) as e:
        pworld.allgatherv([np.ones(2)] * (N - 1))
    assert e.value.error_class == ERR_COUNT
    with pytest.raises(MPIError) as e:
        pworld.gatherv([np.ones(2)] * N, root=N)
    assert e.value.error_class == ERR_ROOT
    with pytest.raises(MPIError) as e:
        pworld.alltoallv([[np.ones(1)] * N] * (N - 1))
    assert e.value.error_class == ERR_COUNT
    with pytest.raises(MPIError) as e:
        pworld.alltoallv([[np.ones(1)] * (N - 1)] * N)
    assert e.value.error_class == ERR_COUNT
    with pytest.raises(MPIError) as e:
        pworld.reduce_scatter(pworld.alloc((4,)), [1] * N)
    assert e.value.error_class == ERR_COUNT
    with pytest.raises(MPIError) as e:
        pworld.reduce_scatter(pworld.alloc((4,)), [1] * (N - 1))
    assert e.value.error_class == ERR_COUNT
    with pytest.raises(MPIError) as e:
        pworld.scatter_root(np.ones((N - 1, 2)), 0)
    assert e.value.error_class == ERR_COUNT


def test_nonblocking_v_forms(pworld, world):
    per = _ragged(8, COUNTS["ragged"])
    tp = _tensors(per)
    send = [[a[:(i + j) % 4] for j, a in enumerate(tp)] for i in range(N)]
    cases = [(pworld.iallgatherv(tp), world.allgatherv(per)),
             (pworld.igatherv(tp, 2), [world.gatherv(per, 2)]),
             (pworld.iscatterv(tp, 4), world.scatterv(per, 4))]
    for req, want in cases:
        got = req.wait() and req.get()
        got = got if isinstance(got, list) else [got]
        assert req.test()[0]
        for g, w in zip(got, want):
            _same(g, w)
    req = pworld.ialltoallv(send)
    got = req.get()
    for j in range(N):
        for i in range(N):
            _same(got[j][i], send[i][j].numpy())


@pytest.mark.parametrize("size", [3, 5])
def test_v_forms_on_split_communicators(pworld, size):
    sub = pworld.split([0] * size + [P.UNDEFINED] * (N - size))[0]
    per = _ragged(9, [2 * r + 1 for r in range(size)])
    cat = np.concatenate(per)
    for o in sub.allgatherv(per):
        _same(o, cat)
    _same(sub.gatherv(per, size - 1), cat)
    for o, c in zip(sub.scatterv(per, 1), per):
        _same(o, c)
    x = np.random.default_rng(10).standard_normal((size, 9)) \
        .astype(np.float32)
    cs = [3, 2, 4] if size == 3 else [1, 2, 3, 2, 1]
    red = x.sum(0, dtype=np.float64)
    off = 0
    for o, c in zip(sub.reduce_scatter(x, cs), cs):
        np.testing.assert_allclose(o.numpy(), red[off:off + c], rtol=1e-5,
                                   atol=1e-5)
        off += c
