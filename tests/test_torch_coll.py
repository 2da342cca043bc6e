"""Parity of the port's collectives with the JAX package's.

An 8-rank port world on the CPU (``Init(devices=["cpu"] * 8)``) against
the conftest's 8-device JAX world: the same stacked inputs, made with
numpy from a seed, go through every collective of the port's device
component (``coll/torch``) and of ``coll/xla``, and through the port's
host oracle (``coll/basic``). Tolerances: exact for integers, MAX, MIN,
MAXLOC and data movement; rtol 1e-5 (float32) and 1e-12 (float64) for
SUM and PROD, whose summation order differs between the packages.

Each test starts the port from a fresh state (``_reset_for_tests``), so
the tests run in any order and under xdist.
"""
import zlib

import numpy as np
import pytest
import torch

import ompi_tpu_torch as P
from ompi_tpu_torch.coll.basic import BasicCollModule
from ompi_tpu_torch.mca import var as pvar

N = 8
DTYPES = ["float32", "float64", "int32"]
OPS = {"float32": ["SUM", "MAX", "MIN", "PROD", "MAXLOC"],
       "float64": ["SUM", "MAX", "MIN", "PROD", "MAXLOC"],
       "int32": ["SUM", "MAX", "MIN", "PROD", "BAND", "MAXLOC"]}
REDUCING = ["allreduce", "reduce", "reduce_scatter_block", "scan", "exscan"]
MOVING = ["bcast", "allgather", "gather", "scatter", "alltoall"]
ROOT = 3
CASES = [(dtype, op) for dtype in DTYPES for op in OPS[dtype]]


def _seed(*parts) -> int:
    return zlib.crc32("|".join(parts).encode())


@pytest.fixture()
def pworld():
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    w = P.get_comm_world()
    yield w
    P._reset_for_tests()


def _data(dtype, op, lead, seed):
    """Stacked input: ``lead`` = (N,) or (N, N), then 5 elements (and a
    trailing (value, index) pair for MAXLOC)."""
    rng = np.random.default_rng(seed)
    shape = lead + (5,)
    if op == "MAXLOC":
        val = rng.integers(0, 4, size=shape)           # ties on purpose
        idx = np.broadcast_to(
            np.arange(N).reshape((N,) + (1,) * (len(shape) - 1)), shape)
        return np.stack([val, idx], axis=-1).astype(dtype)
    if np.dtype(dtype).kind == "i":
        lo, hi = (-3, 4) if op == "PROD" else (-1000, 1000)
        return rng.integers(lo, hi, size=shape).astype(dtype)
    if op == "PROD":
        return (1 + 0.1 * rng.standard_normal(shape)).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _assert_match(got, want, dtype, op):
    """Values and shape. The dtype is checked against the input's
    separately: under x64 the JAX package's PROD fold widens int32 to
    int64 (``jnp.prod``), where MPI and the port keep the operand type."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if np.dtype(dtype).kind == "f" and op in ("SUM", "PROD"):
        rtol = 1e-5 if dtype == "float32" else 1e-12
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)
    else:
        np.testing.assert_array_equal(got, want)


def _run(comm, func, x, op=None):
    args = (x,) if op is None else (x, op)
    kw = {"root": ROOT} if func in ("reduce", "bcast", "gather",
                                    "scatter") else {}
    return getattr(comm, func)(*args, **kw)


def _significant(func, y):
    """Rows that carry the result: root's row for rooted reductions and
    gathers (the JAX side may run a root-targeted schedule)."""
    y = np.asarray(y)
    return y[ROOT] if func in ("reduce", "gather") else y


@pytest.mark.parametrize("dtype,op", CASES)
@pytest.mark.parametrize("func", REDUCING)
def test_reducing_collective_matches_jax(pworld, world, mpi, func, dtype, op):
    lead = (N, N) if func == "reduce_scatter_block" else (N,)
    x = _data(dtype, op, lead, seed=_seed(func, dtype, op))
    got = _run(pworld, func, pworld.put(x), getattr(P, op))
    assert isinstance(got, torch.Tensor) and got.numpy().dtype == x.dtype
    want = _run(world, func, world.put(x), getattr(mpi, op))
    oracle = _run(BasicCollModule(pworld), func, x, getattr(P, op))
    _assert_match(_significant(func, got), _significant(func, want),
                  dtype, op)
    _assert_match(_significant(func, got), _significant(func, oracle),
                  dtype, op)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("func", MOVING)
def test_moving_collective_matches_jax(pworld, world, func, dtype):
    lead = (N, N) if func in ("scatter", "alltoall") else (N,)
    x = _data(dtype, "SUM", lead, seed=_seed(func, dtype))
    got = _run(pworld, func, pworld.put(x))
    assert isinstance(got, torch.Tensor) and got.numpy().dtype == x.dtype
    want = _run(world, func, world.put(x))
    oracle = _run(BasicCollModule(pworld), func, x)
    _assert_match(_significant(func, got), _significant(func, want),
                  dtype, "copy")
    _assert_match(_significant(func, got), _significant(func, oracle),
                  dtype, "copy")


def test_results_never_alias_rows(pworld):
    x = pworld.put(np.arange(N * 3, dtype=np.float32).reshape(N, 3))
    for y in (pworld.allreduce(x), pworld.bcast(x, 0), pworld.allgather(x)):
        before = y[1].clone()
        y[0].fill_(-7.0)
        assert torch.equal(y[1], before)
    assert torch.equal(x, pworld.put(
        np.arange(N * 3, dtype=np.float32).reshape(N, 3)))


def test_subeager_cache_serves_repeat_allreduce(pworld):
    x = pworld.alloc((2,), fill=1.0)
    for _ in range(3):
        y = pworld.allreduce(x, P.SUM)
    assert len(pworld._subeager) == 1
    assert torch.equal(y, torch.full((N, 2), float(N)))


def test_host_input_and_recvbuf(pworld):
    x = np.ones((N, 4), np.float32)
    y = pworld.allreduce(x, P.SUM)            # numpy in: numpy out (tuned)
    assert isinstance(y, np.ndarray) and np.all(y == N)
    recv = pworld.put(x)
    out = pworld.allreduce(P.IN_PLACE, P.MAX, recvbuf=recv)
    assert out is recv and torch.all(recv == 1)


def test_split_and_dup_match_jax(pworld, world):
    colors = [r % 2 for r in range(N)]
    keys = [N - r for r in range(N)]           # reversed order in each half
    ours, theirs = pworld.split(colors, keys), world.split(colors, keys)
    for r in range(N):
        assert ours[r].group.world_ranks == theirs[r].group.world_ranks
    evens = ours[0]
    rows = np.arange(evens.size * 4, dtype=np.float64).reshape(evens.size, 4)
    got = evens.allreduce(evens.stack(list(rows)), P.SUM)
    np.testing.assert_array_equal(got.numpy(),
                                  np.broadcast_to(rows.sum(0), rows.shape))
    assert ours[0] is ours[2] and ours[1] is not ours[0]
    undefined = pworld.split([P.UNDEFINED] + [0] * (N - 1))
    assert undefined[0] is None and undefined[1].size == N - 1
    d = pworld.dup()
    assert d.cid != pworld.cid and d.compare(pworld) == P.CONGRUENT
    assert torch.equal(d.allgather(pworld.alloc((1,), fill=2.0)),
                       torch.full((N, N, 1), 2.0))


@pytest.mark.parametrize("case", ["bad_root", "wrong_stacked_shape",
                                  "not_a_tensor", "bad_op"])
def test_errors_return(pworld, case):
    import ompi_tpu as J
    pworld.set_errhandler(P.ERRORS_RETURN)
    x = pworld.alloc((3,))
    call, cls = {
        "bad_root": (lambda: pworld.bcast(x, root=N), J.ERR_ROOT),
        "wrong_stacked_shape": (lambda: pworld.allreduce(torch.zeros(N - 1)),
                                J.ERR_COUNT),
        "not_a_tensor": (lambda: pworld.allgather([[1.0]] * N), J.ERR_ARG),
        "bad_op": (lambda: pworld.allreduce(x, "sum"), J.ERR_OP),
    }[case]
    with pytest.raises(P.MPIError) as e:
        call()
    assert e.value.error_class == cls           # same class as ompi_tpu


def test_errors_are_fatal_by_default(pworld, capsys):
    with pytest.raises(SystemExit):
        pworld.reduce(pworld.alloc((1,)), P.SUM, root=-1)
    assert "MPI_ERR_ROOT" in capsys.readouterr().err


def test_mca_env_var_is_seen(monkeypatch):
    """A var set through OMPI_TPU_TORCH_MCA_ reaches the port (and the
    JAX package's prefix does not); a value outside the var's enumerator
    resolves to its default, as in the reference."""
    monkeypatch.setenv("OMPI_TPU_TORCH_MCA_coll_torch_allreduce_algorithm",
                       "ring")
    monkeypatch.setenv("OMPI_TPU_TORCH_MCA_coll_torch_bcast_algorithm",
                       "no_such_schedule")
    monkeypatch.setenv("OMPI_TPU_MCA_coll_torch_priority", "5")
    P._reset_for_tests()
    try:
        P.Init(devices=["cpu"] * N)
        w = P.get_comm_world()
        assert pvar.var_get("coll_torch_allreduce_algorithm") == "ring"
        assert pvar.var_source("coll_torch_allreduce_algorithm") == "env"
        assert pvar.var_get("coll_torch_bcast_algorithm") == "auto"
        assert pvar.var_source("coll_torch_bcast_algorithm") == "default"
        assert pvar.var_get("coll_torch_priority") == 40
        assert w._coll_winners["allreduce"] == "tuned"
        x = w.alloc((2,), fill=1.0)
        assert torch.all(w.allreduce(x) == N)      # the ring ran
        assert w._coll("allreduce").selected("allreduce", x,
                                             P.SUM) == "ring"
        pvar.var_set("coll_torch_allreduce_algorithm", "direct")
        assert torch.all(w.allreduce(x) == N)
    finally:
        P._reset_for_tests()


def test_include_var_selects_the_host_component(pworld):
    pvar.var_set("coll_base_include", "basic,self")
    d = pworld.dup()
    assert set(d._coll_winners.values()) == {"basic"}
    y = d.allreduce(pworld.alloc((2,), fill=3.0), P.MAX)
    assert isinstance(y, np.ndarray) and np.all(y == 3.0)


def test_init_without_cuda_or_devices_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: Init() binds it")
    P._reset_for_tests()
    with pytest.raises(P.MPIError):
        P.Init()
    assert not P.Initialized()


def test_self_and_lifecycle(pworld):
    s = P.get_comm_self()
    x = s.alloc((3,), fill=2.0)
    y = s.allreduce(x)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    P.Finalize()
    assert P.Finalized()
    with pytest.raises(P.MPIError):
        P.get_comm_world()


@pytest.mark.parametrize("np_dtype", ["float32", "float64", "float16",
                                      "int32", "int64", "int8", "uint8",
                                      "bool", "complex64"])
def test_predefined_datatypes_match_jax_names(np_dtype):
    from ompi_tpu.core import datatype as jdt
    ours, theirs = P.from_numpy_dtype(np_dtype), jdt.from_numpy_dtype(np_dtype)
    assert ours.name == theirs.name
    assert ours.base.itemsize == np.dtype(np_dtype).itemsize
    assert P.from_torch_dtype(ours.base) is ours
