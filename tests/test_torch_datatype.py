"""Parity of the port's derived datatypes, convertor and datatype-aware
collectives with the JAX package's.

The same numpy inputs, made from a seed, go through the reference (its
``core/datatype``, ``core/convertor`` and collectives on a ``dup()`` of
its 8-device world, freed afterwards) and through the port on its 8-rank
CPU world. Index maps, extents, packed data, data movement, MAX/MIN,
integer results and external32 bytes are exact; float SUM is held to
rtol = atol = 1e-5 (float32) and 1e-12 (float64), the tolerances of
``tests/test_torch_coll.py``: the packages sum 8 rows in another order.
"""
import numpy as np
import pytest
import torch

import ompi_tpu as R
import ompi_tpu_torch as P
from ompi_tpu.core import convertor as r_conv
from ompi_tpu.core import datatype as r_dt
from ompi_tpu.core.op import reduce_local as r_reduce_local
from ompi_tpu_torch.core import convertor
from ompi_tpu_torch.core import datatype as p_dt
from ompi_tpu_torch.core.datatype import FLOAT, INT, from_numpy_dtype
from ompi_tpu_torch.mca import var as pvar

N = 8


@pytest.fixture()
def pworld():
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    yield P.get_comm_world()
    P._reset_for_tests()


@pytest.fixture()
def rworld(world):
    d = world.dup()
    yield d
    d.free()


def _np(x):
    return np.ascontiguousarray(x.numpy() if isinstance(x, torch.Tensor)
                                else np.asarray(x))


def _exact(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got, want)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = 1e-5 if np.dtype(dtype) == np.float32 else 1e-12
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# Each entry takes a package's datatype module and returns a type; the
# same calls build the reference's and the port's.
TYPES = {
    "contig": lambda m: m.FLOAT.create_contiguous(5),
    "vector": lambda m: m.FLOAT.create_vector(3, 2, 4),
    "vector_of_vector": lambda m: m.FLOAT.create_vector(2, 1, 3)
    .create_vector(2, 1, 3),
    "indexed": lambda m: m.INT.create_indexed([2, 1], [0, 5]),
    "indexed_block": lambda m: m.DOUBLE.create_indexed_block(2, [1, 4, 9]),
    "subarray_c": lambda m: m.FLOAT.create_subarray([4, 4], [2, 2], [1, 1]),
    "subarray_f": lambda m: m.FLOAT.create_subarray([3, 5], [2, 3], [1, 2],
                                                   order="F"),
    "resized_up": lambda m: m.INT.create_indexed([2, 1], [0, 5])
    .create_resized(0, 8),
    # extent below the true extent: consecutive instances overlap
    "resized_overlap": lambda m: m.FLOAT.create_vector(2, 2, 3)
    .create_resized(0, 3),
    # an indexed map that repeats a position within one instance
    "indexed_repeat": lambda m: m.FLOAT.create_indexed([2, 2], [0, 1]),
    "struct": lambda m: m.Datatype.create_struct([2, 1], [0, 6],
                                                 [m.FLOAT, m.FLOAT]),
    "struct_of_vector": lambda m: m.Datatype.create_struct(
        [1, 2], [1, 10], [m.FLOAT.create_vector(2, 1, 2), m.FLOAT]),
}


def _pair(name):
    return TYPES[name](r_dt).commit(), TYPES[name](p_dt).commit()


# -- mirrors of tests/test_datatype.py --------------------------------------
def test_predefined_sizes():
    assert FLOAT.get_size() == 4
    assert P.DOUBLE.get_size() == 8
    assert P.INT8_T.get_size() == 1
    assert FLOAT.is_contiguous
    assert from_numpy_dtype(np.float32) is FLOAT
    for name in ("FLOAT", "DOUBLE", "FLOAT16", "BFLOAT16", "INT", "LONG",
                 "SHORT", "CHAR", "BYTE", "UNSIGNED", "UNSIGNED_LONG",
                 "INT8_T", "UINT64_T", "C_BOOL", "C_FLOAT_COMPLEX",
                 "C_DOUBLE_COMPLEX", "FLOAT_INT", "DOUBLE_INT", "LONG_INT",
                 "SHORT_INT", "TWOINT"):
        r, p = getattr(R, name), getattr(P, name)
        assert (p.get_size(), p.get_extent(), p.count, p.pair,
                p.is_contiguous, p.name) == (
            r.get_size(), r.get_extent(), r.count, r.pair,
            r.is_contiguous, r.name), name
    for npdt in (np.float32, np.float64, np.int32, np.uint8, np.bool_,
                 np.complex64):
        assert from_numpy_dtype(npdt).name == \
            r_dt.from_numpy_dtype(npdt).name


def test_contiguous():
    t = FLOAT.create_contiguous(5).commit()
    assert t.count == 5 and t.extent == 5 and t.is_contiguous
    assert t.get_size() == 20


def test_vector_layout():
    t = FLOAT.create_vector(3, 2, 4).commit()
    np.testing.assert_array_equal(t.indices, [0, 1, 4, 5, 8, 9])
    assert t.extent == 10 and not t.is_contiguous
    assert t.get_true_extent() == (0, 10)


def test_indexed_and_resized():
    t = INT.create_indexed([2, 1], [0, 5]).commit()
    np.testing.assert_array_equal(t.indices, [0, 1, 5])
    assert t.create_resized(0, 8).extent == 8


def test_subarray():
    t = FLOAT.create_subarray([4, 4], [2, 2], [1, 1]).commit()
    np.testing.assert_array_equal(t.indices, [5, 6, 9, 10])
    assert t.extent == 16


def test_struct_homogeneous():
    t = P.Datatype.create_struct([2, 1], [0, 6], [FLOAT, FLOAT]).commit()
    np.testing.assert_array_equal(t.indices, [0, 1, 6])


def test_struct_heterogeneous_rejected():
    with pytest.raises(TypeError):
        P.Datatype.create_struct([1, 1], [0, 1], [FLOAT, INT])
    with pytest.raises(TypeError):
        R.Datatype.create_struct([1, 1], [0, 1], [R.FLOAT, R.INT])


@pytest.mark.parametrize("name", sorted(TYPES))
def test_constructors_match_reference(name):
    r, p = _pair(name)
    np.testing.assert_array_equal(p.indices, r.indices)
    assert (p.extent, p.lb, p.count, p.get_size(), p.get_extent(),
            p.get_true_extent(), p.is_contiguous) == (
        r.extent, r.lb, r.count, r.get_size(), r.get_extent(),
        r.get_true_extent(), r.is_contiguous)
    for a, b in zip(p.runs(), r.runs()):
        np.testing.assert_array_equal(a, b)
    for count in (1, 3):
        np.testing.assert_array_equal(p.flat_indices(count),
                                      r.flat_indices(count))
    assert p.uid != _pair(name)[1].uid            # uids are unique
    p.free()


def test_pack_unpack_host_roundtrip(rng):
    t = FLOAT.create_vector(3, 2, 4).commit()
    buf = rng.standard_normal((2, 2 * t.extent)).astype(np.float32)
    packed = convertor.pack(buf, t, 2)
    assert packed.shape == (2, 12)
    np.testing.assert_array_equal(packed[0, :6], buf[0, [0, 1, 4, 5, 8, 9]])
    out = convertor.unpack(np.zeros_like(buf), packed, t, 2)
    np.testing.assert_array_equal(out[0, [0, 1, 4, 5, 8, 9]],
                                  buf[0, [0, 1, 4, 5, 8, 9]])
    assert out[0, 2] == 0 and out[0, 3] == 0    # holes preserved


def test_pack_unpack_device(pworld, rng):
    t = FLOAT.create_vector(2, 1, 3).commit()      # indices 0, 3
    host = rng.standard_normal((N, t.extent)).astype(np.float32)
    packed = convertor.pack(pworld.stack(list(host)), t, 1)
    assert isinstance(packed, torch.Tensor)
    np.testing.assert_array_equal(packed.numpy(), host[:, [0, 3]])


@pytest.mark.parametrize("name", sorted(TYPES))
@pytest.mark.parametrize("count", [1, 3])
def test_convertor_matches_reference(name, count):
    """pack and unpack, numpy and tensor, against the reference's numpy
    convertor; unpack leaves the holes as they were. Overlapping types
    unpack to numpy's last-writer result on both paths."""
    r, p = _pair(name)
    rng = np.random.default_rng(count)
    dt = r.base
    width = (count - 1) * r.extent + r.get_true_extent()[0] + \
        r.get_true_extent()[1] + 2
    buf = rng.standard_normal((3, width)).astype(dt)
    want = r_conv.pack(buf, r, count)
    _exact(convertor.pack(buf, p, count), want)
    _exact(convertor.pack(torch.from_numpy(buf), p, count), want)
    packed = rng.standard_normal(np.asarray(want).shape).astype(dt)
    base = rng.standard_normal(buf.shape).astype(dt)
    ref = r_conv.unpack(base.copy(), packed, r, count)
    last = base.copy()
    last[..., r.flat_indices(count)] = packed      # numpy's last writer
    if not r.is_contiguous:
        _exact(ref, last)
    _exact(convertor.unpack(base.copy(), packed, p, count), ref)
    t = torch.from_numpy(base.copy())
    got = convertor.unpack(t, torch.from_numpy(packed), p, count)
    _exact(got, ref)
    if not p.is_contiguous:
        assert got is t                            # in place


def test_unpack_overlap_keeps_last_writer():
    """The port-only keep-last scatter: a resized type whose instances
    overlap, unpacked into a tensor, equals numpy's fancy assignment, and
    each position is written once."""
    t = FLOAT.create_vector(2, 2, 3).create_resized(0, 3).commit()
    idx = t.flat_indices(4)
    dst, src = t.scatter_indices(4)
    assert len(set(idx.tolist())) < idx.size
    assert sorted(dst.tolist()) == sorted(set(idx.tolist()))
    packed = np.arange(idx.size, dtype=np.float32) + 1
    want = np.zeros((2, 15), np.float32)
    want[..., idx] = packed
    got = convertor.unpack(torch.zeros(2, 15), torch.from_numpy(
        np.stack([packed, packed])), t, 4)
    _exact(got, want)
    assert t.scatter_indices(1)[1] is None         # one instance: no repeat


def test_device_index_tensors_built_once(pworld):
    t = FLOAT.create_vector(4, 1, 2).commit()
    x = pworld.put(np.ones((N, 7), np.float32))
    convertor.pack(x, t, 1)
    idx = t._dev_cache[("gather", 1, x.device)]
    for _ in range(3):
        convertor.pack(x, t, 1)
        convertor.unpack(x.clone(), torch.ones(N, 4), t, 1)
        pworld.allreduce(x, P.SUM, datatype=t, count=1)
    assert t._dev_cache[("gather", 1, x.device)] is idx
    assert len(t._dev_cache) == 1


def test_tensor_index_past_the_buffer_raises_on_the_host():
    t = FLOAT.create_vector(3, 1, 4).commit()      # last index 8
    with pytest.raises(IndexError):
        convertor.pack(torch.zeros(2, 8), t, 1)
    with pytest.raises(IndexError):
        convertor.unpack(torch.zeros(2, 8), torch.zeros(2, 3), t, 1)


# -- the collectives' datatype= --------------------------------------------
def test_allreduce_derived_datatype(rworld, pworld, rng):
    t = FLOAT.create_vector(2, 2, 3).commit()      # indices 0,1,3,4
    host = rng.standard_normal((N, 5)).astype(np.float32)
    y = pworld.allreduce(pworld.stack(list(host)), P.SUM, datatype=t,
                         count=1)
    sel = [0, 1, 3, 4]
    np.testing.assert_allclose(y[0].numpy()[sel], host[:, sel].sum(0),
                               rtol=1e-5)
    assert y[0, 2] == 0                            # the hole
    ry = rworld.allreduce(rworld.stack(list(host)), R.SUM,
                          datatype=r_dt.FLOAT.create_vector(2, 2, 3).commit(),
                          count=1)
    _close(y, ry, np.float32)


def test_bcast_derived_datatype(rworld, pworld, rng):
    pt = FLOAT.create_indexed([1, 2], [0, 2]).commit()
    rt = r_dt.FLOAT.create_indexed([1, 2], [0, 2]).commit()
    host = rng.standard_normal((N, pt.extent)).astype(np.float32)
    y = pworld.bcast(pworld.stack(list(host)), root=1, datatype=pt, count=1)
    for r in range(N):
        np.testing.assert_array_equal(y[r].numpy()[[0, 2, 3]],
                                      host[1][[0, 2, 3]])
    _exact(y, rworld.bcast(rworld.stack(list(host)), root=1, datatype=rt,
                           count=1))


def test_allreduce_in_place_derived_preserves_holes(rworld, pworld, rng):
    pt = FLOAT.create_vector(2, 1, 2).commit()     # indices 0, 2
    rt = r_dt.FLOAT.create_vector(2, 1, 2).commit()
    host = rng.standard_normal((N, 3)).astype(np.float32)
    buf = pworld.stack(list(host))
    y = pworld.allreduce(P.IN_PLACE, P.SUM, datatype=pt, count=1,
                         recvbuf=buf)
    np.testing.assert_allclose(y[0].numpy()[[0, 2]], host[:, [0, 2]].sum(0),
                               rtol=1e-5)
    _exact(y[:, 1], host[:, 1])                    # holes, bit for bit
    ry = rworld.allreduce(R.IN_PLACE, R.SUM, datatype=rt, count=1,
                          recvbuf=rworld.stack(list(host)))
    _close(y, ry, np.float32)


CASES = [("float32", "SUM"), ("float64", "SUM"), ("float32", "MAX"),
         ("int32", "SUM"), ("int32", "MIN")]


def _input(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "i":
        return rng.integers(-999, 999, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _match(got, want, dtype, op):
    """Under the conftest's x64 the reference sums int32 in int64
    (``jnp.sum``); MPI and the port keep the operand type, so integer
    results compare by value, with the port's dtype the input's."""
    if np.dtype(dtype).kind == "f" and op == "SUM":
        _close(got, want, dtype)
    elif np.dtype(dtype).kind == "i":
        got, want = _np(got), _np(want)
        assert got.dtype == np.dtype(dtype) and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        _exact(got, want)


@pytest.mark.parametrize("dtype,op", CASES)
@pytest.mark.parametrize("name", ["vector", "subarray_c", "struct"])
def test_allreduce_reduce_datatype(rworld, pworld, dtype, op, name):
    """allreduce (fused; IN_PLACE; distinct recvbuf; host) and reduce
    with a derived type, against the reference."""
    r = TYPES[name](r_dt).create_resized(0, TYPES[name](r_dt).extent)
    p = TYPES[name](p_dt).create_resized(0, r.extent)
    r, p = r.commit(), p.commit()
    x = _input(dtype, (N, 2 * r.extent), len(name))
    rop, pop = getattr(R, op), getattr(P, op)
    kw = dict(count=2)
    _match(pworld.allreduce(pworld.stack(list(x)), pop, datatype=p, **kw),
           rworld.allreduce(rworld.stack(list(x)), rop, datatype=r, **kw),
           dtype, op)
    _match(pworld.allreduce(P.IN_PLACE, pop, datatype=p, **kw,
                            recvbuf=pworld.stack(list(x))),
           rworld.allreduce(R.IN_PLACE, rop, datatype=r, **kw,
                            recvbuf=rworld.stack(list(x))), dtype, op)
    base = _input(dtype, x.shape, 99)
    rb = rworld.allreduce(rworld.stack(list(x)), rop, datatype=r, **kw,
                          recvbuf=base.copy())
    pb = base.copy()
    _match(pworld.allreduce(pworld.stack(list(x)), pop, datatype=p, **kw,
                            recvbuf=pb), rb, dtype, op)
    _match(pb, rb, dtype, op)                      # into recvbuf, in place
    _match(pworld.allreduce(x, pop, datatype=p, **kw),
           rworld.allreduce(x, rop, datatype=r, **kw), dtype, op)
    _match(pworld.reduce(pworld.stack(list(x)), pop, 3, datatype=p, **kw)[3],
           np.asarray(rworld.reduce(rworld.stack(list(x)), rop, 3,
                                    datatype=r, **kw))[3], dtype, op)


@pytest.mark.parametrize("func", ["allgather", "gather", "bcast",
                                  "scatter", "alltoall",
                                  "reduce_scatter_block"])
def test_moving_collectives_datatype(rworld, pworld, func):
    r, p = _pair("indexed_block")                  # DOUBLE, extent 11
    lead = (N, N) if func in ("scatter", "alltoall",
                              "reduce_scatter_block") else (N,)
    x = _input("float64", lead + (2 * r.extent,), len(func))
    args = {"allgather": (), "gather": (2,), "bcast": (5,), "scatter": (6,),
            "alltoall": (), "reduce_scatter_block": ()}[func]
    rargs = args + ((R.SUM,) if func == "reduce_scatter_block" else ())
    pargs = args + ((P.SUM,) if func == "reduce_scatter_block" else ())
    want = getattr(rworld, func)(rworld.put(x), *rargs, datatype=r, count=2)
    got = getattr(pworld, func)(pworld.put(x), *pargs, datatype=p, count=2)
    if func == "gather":
        got, want = got[2], np.asarray(want)[2]
    _match(got, want, "float64", "SUM" if func.startswith("reduce")
           else "MAX")


def test_fused_allreduce_taken_under_the_reference_conditions(
        rworld, pworld, monkeypatch):
    """``allreduce_dtype`` runs exactly where the reference's does
    (core/communicator.py:314-329), and nowhere else."""
    seen = {}
    for name, comm in (("ref", rworld), ("port", pworld)):
        mod = comm._coll("allreduce")
        orig = mod.allreduce_dtype
        calls = seen[name] = []

        def spy(*a, _o=orig, _c=calls):
            _c.append(a[3:])         # (count, preserve_gaps)
            return _o(*a)
        monkeypatch.setattr(mod, "allreduce_dtype", spy)
    for M, comm, dtm, name in ((R, rworld, r_dt, "ref"),
                               (P, pworld, p_dt, "port")):
        vec = dtm.FLOAT.create_vector(2, 2, 3).commit()     # extent 5
        x = np.ones((N, 10), np.float32)
        pairs = np.ones((N, 2), np.float32)
        cases = [
            lambda: comm.allreduce(comm.put(x), M.SUM, datatype=vec),
            lambda: comm.allreduce(M.IN_PLACE, M.MAX, datatype=vec,
                                   count=2, recvbuf=comm.put(x)),
            lambda: comm.allreduce(comm.put(x), M.SUM, datatype=vec,
                                   count=2, recvbuf=comm.put(x)),
            lambda: comm.allreduce(x, M.SUM, datatype=vec, count=2),
            lambda: comm.allreduce(comm.put(x), M.SUM, datatype=vec,
                                   count=1),                # not exact fit
            lambda: comm.allreduce(comm.put(x), M.SUM,
                                   datatype=dtm.FLOAT.create_contiguous(2)),
            lambda: comm.allreduce(comm.put(pairs), M.MAXLOC,
                                   datatype=dtm.FLOAT_INT),
            lambda: comm.allreduce(comm.put(x), M.SUM),
        ]
        for c in cases:
            c()
    assert seen["ref"] == seen["port"] == [(2, False), (2, True)]


def test_fused_allreduce_memo_and_holes(pworld):
    t = FLOAT.create_subarray([6, 8], [3, 4], [1, 2]).commit()
    host = _input("float32", (N, 48), 5)
    x = pworld.stack(list(host))
    pworld.allreduce(P.IN_PLACE, P.MAX, datatype=t, recvbuf=x)
    mod = pworld._coll("allreduce")
    fk = [k for k in mod._fast if k[0] == "allreduce_dt"]
    assert len(fk) == 1
    fn = mod._fast[fk[0]][1]
    y = pworld.allreduce(P.IN_PLACE, P.MAX, datatype=t, recvbuf=x)
    assert y is x and mod._fast[fk[0]][1] is fn
    holes = np.setdiff1d(np.arange(48), t.indices)
    _exact(y[:, holes], host[:, holes])
    _exact(y[:, t.indices], np.broadcast_to(host[:, t.indices].max(0),
                                            (N, t.count)))
    pvar.var_set("coll_torch_allreduce_algorithm", "ring")
    pworld.allreduce(P.IN_PLACE, P.MAX, datatype=t, recvbuf=x)
    assert mod._fast[fk[0]][1] is not fn            # the epoch moved


def test_fused_allreduce_through_compressed(pworld):
    """A comm with compression on delegates the derived-datatype
    allreduce to the uncompressed schedule."""
    pvar.var_set("mpi_base_compress", True)
    cw = pworld.dup()
    assert cw._coll_winners["allreduce"] == "compressed"
    t = FLOAT.create_vector(4, 3, 5).commit()
    host = _input("float32", (N, 18), 8)
    want = pworld.allreduce(pworld.stack(list(host)), P.SUM, datatype=t)
    _exact(cw.allreduce(cw.stack(list(host)), P.SUM, datatype=t), want)


# -- alltoallw, reduce_local, MPI_Pack and external32 -----------------------
def test_alltoallw(rworld, pworld):
    rng = np.random.default_rng(4)
    names = ["vector", "indexed_block", None, "subarray_c"]
    rtypes = [[None if names[(i + j) % 4] is None else
               TYPES[names[(i + j) % 4]](r_dt).commit() for j in range(N)]
              for i in range(N)]
    ptypes = [[None if names[(i + j) % 4] is None else
               TYPES[names[(i + j) % 4]](p_dt).commit() for j in range(N)]
              for i in range(N)]
    chunks = [[rng.standard_normal(
        (t.extent * (1 + (i + j) % 2) if t is not None else (i * j) % 5),
    ).astype(np.float32) for j, t in enumerate(row)]
        for i, row in enumerate(rtypes)]
    want = rworld.alltoallw(chunks, rtypes)
    for got in (pworld.alltoallw(chunks, ptypes),
                pworld.alltoallw([[torch.from_numpy(c) for c in row]
                                  for row in chunks], ptypes)):
        for j in range(N):
            for i in range(N):
                _exact(got[j][i], np.asarray(want[j][i]))
    counts = [[1] * N for _ in range(N)]
    want = rworld.alltoallw(chunks, rtypes, counts)
    got = pworld.alltoallw(chunks, ptypes, counts)
    for j in range(N):
        for i in range(N):
            _exact(got[j][i], np.asarray(want[j][i]))


@pytest.mark.parametrize("op,dtype", [
    (op, dt) for op in ("SUM", "PROD", "MAX", "MIN", "MAXLOC")
    for dt in ("float32", "int32")] + [("BAND", "int32"), ("LXOR", "int32")])
def test_reduce_local(op, dtype):
    rng = np.random.default_rng(len(op))
    shape = (6, 2) if op == "MAXLOC" else (5, 3)
    a = rng.integers(-9, 9, shape).astype(dtype)
    b = rng.integers(-9, 9, shape).astype(dtype)
    want = np.asarray(r_reduce_local(a, b, getattr(R, op)))
    _exact(P.reduce_local(torch.from_numpy(a), torch.from_numpy(b),
                          getattr(P, op)), want.astype(dtype))
    _exact(P.reduce_local(a, b, getattr(P, op)), want.astype(dtype))
    with pytest.raises(TypeError):
        P.reduce_local(a, b, "sum")


@pytest.mark.parametrize("name", ["contig", "vector", "subarray_f",
                                  "indexed_repeat"])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_pack_external_and_position(name, kind):
    r, p = _pair(name)
    rng = np.random.default_rng(2)
    buf = rng.standard_normal(2 * r.extent).astype(r.base)
    pbuf = torch.from_numpy(buf) if kind == "tensor" else buf
    ext = P.Pack_external(p, pbuf, 2)
    assert ext == R.Pack_external(r, buf, 2)
    assert P.Pack_size(p, 2) == R.Pack_size(r, 2) == len(ext)
    out = P.Unpack_external(p, ext, 2, out_buf=(
        torch.zeros(2 * r.extent) if kind == "tensor"
        else np.zeros(2 * r.extent, r.base)))
    want = R.Unpack_external(r, ext, 2,
                             out_buf=np.zeros(2 * r.extent, r.base))
    _exact(out, want)
    outbuf_p, outbuf_r = bytearray(), bytearray()
    pos_p = P.Pack(pbuf, p, 2, outbuf_p, 0)
    pos_p = P.Pack(pbuf, p, 1, outbuf_p, pos_p)
    pos_r = R.Pack(buf, r, 2, outbuf_r, 0)
    pos_r = R.Pack(buf, r, 1, outbuf_r, pos_r)
    assert (pos_p, bytes(outbuf_p)) == (pos_r, bytes(outbuf_r))
    tgt = (torch.zeros(2 * r.extent, dtype=torch.float32)
           if kind == "tensor" else np.zeros(2 * r.extent, r.base))
    got, pos = P.Unpack(outbuf_p, 0, tgt, p, 2)
    rgot, rpos = R.Unpack(outbuf_r, 0, np.zeros(2 * r.extent, r.base), r, 2)
    assert pos == rpos
    _exact(got, rgot)


def test_pack_external_bfloat16():
    x = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    ext = P.Pack_external(P.BFLOAT16, x, 3)
    assert ext == x.view(torch.int16).numpy().astype(">i2").tobytes()
    back = P.Unpack_external(P.BFLOAT16, ext, 3,
                             out_buf=torch.zeros(3, dtype=torch.bfloat16))
    assert torch.equal(back, x)


@pytest.mark.parametrize("name", [
    "FLOAT", "DOUBLE", "FLOAT16", "BFLOAT16", "INT", "LONG", "SHORT", "CHAR",
    "BYTE", "UINT16_T", "UNSIGNED", "UNSIGNED_LONG", "C_BOOL",
    "C_FLOAT_COMPLEX", "C_DOUBLE_COMPLEX"])
def test_convertor_every_predefined_type(name):
    """Tensor pack, unpack and keep-last unpack for every predefined base
    type (torch has no index_copy_ for uint16/32/64: those move as the
    signed type of their width), against an element-by-element loop."""
    base = getattr(P, name).base
    vec = P.Datatype(base).create_vector(3, 1, 2).commit()     # 0, 2, 4
    ovl = vec.create_resized(0, 2).commit()                    # overlaps
    src = torch.arange(20).view(2, 10).to(base)
    p = convertor.pack(src, vec, 2)
    u = convertor.unpack(torch.zeros_like(src), p, vec, 2)
    o = convertor.unpack(torch.zeros((2, 7), dtype=base), p, ovl, 2)
    want_p = torch.zeros((2, 6), dtype=base)
    want_u = torch.zeros_like(src)
    want_o = torch.zeros((2, 7), dtype=base)
    for c, pos in enumerate(vec.flat_indices(2).tolist()):
        want_p[:, c] = src[:, pos]
        want_u[:, pos] = src[:, pos]
    for c, pos in enumerate(ovl.flat_indices(2).tolist()):
        want_o[:, pos] = want_p[:, c]
    assert p.dtype == u.dtype == o.dtype == base
    assert torch.equal(p, want_p) and torch.equal(u, want_u)
    assert torch.equal(o, want_o)
