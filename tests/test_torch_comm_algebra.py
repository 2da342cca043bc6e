"""Parity of the port's communicator algebra and attributes with the JAX
package's: ``split_type``, ``create``, the keyval registry and
attributes through ``dup`` and ``free``.

Each check runs on the reference (on a ``dup()`` of its world, or on a
communicator it creates, freed afterwards) and on the port's 8-rank CPU
world; sizes, world ranks, attribute values and callback traces must be
identical, and collectives on the new communicators agree (float SUM at
rtol = atol = 1e-5).
"""
import numpy as np
import pytest
import torch

import ompi_tpu as R
import ompi_tpu_torch as P
from ompi_tpu.core.group import UNDEFINED as R_UNDEFINED
from ompi_tpu_torch.core.errhandler import ERR_RANK
from ompi_tpu_torch.core.group import UNDEFINED

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


def _shape(subs):
    """split result: per rank, the member world ranks (None for
    MPI_COMM_NULL), and which ranks share one object."""
    return ([None if s is None else s.group.world_ranks for s in subs],
            [[j for j, t in enumerate(subs) if t is s and s is not None]
             for s in subs])


# -- mirrors of tests/test_comm.py:66-90 ------------------------------------
def test_comm_create_subgroup(rworld, pworld):
    out = []
    for M, w in ((R, rworld), (P, pworld)):
        sub = w.create(w.group.incl([0, 1]))
        assert sub.size == 2
        y = sub.allreduce(sub.alloc((3,), np.float32, fill=1.0), M.SUM)
        out.append(np.asarray(y))
        sub.free()
    np.testing.assert_array_equal(out[1], out[0])
    np.testing.assert_allclose(out[1][0], 2.0 * np.ones(3))


@pytest.mark.parametrize("ranks", [[5, 2, 7], [0], [3, 4, 5, 6]])
def test_comm_create_collectives(rworld, pworld, ranks):
    x = np.random.default_rng(len(ranks)).standard_normal(
        (len(ranks), 4)).astype(np.float32)
    got = []
    for M, w in ((R, rworld), (P, pworld)):
        sub = w.create(w.group.incl(ranks))
        assert sub.group.world_ranks == tuple(ranks)
        got.append((np.asarray(sub.allreduce(sub.stack(list(x)), M.SUM)),
                    np.asarray(sub.bcast(sub.stack(list(x)), 0))))
        sub.free()
    np.testing.assert_allclose(got[1][0], got[0][0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1][1], got[0][1])


def test_comm_create_not_a_subset(rworld, pworld):
    pworld.set_errhandler(P.ERRORS_RETURN)
    sub = pworld.split([0] * 4 + [UNDEFINED] * 4)[0]
    with pytest.raises(P.MPIError) as e:
        sub.create(pworld.group.incl([1, 6]))
    assert e.value.error_class == ERR_RANK
    rsub = rworld.split([0] * 4 + [R_UNDEFINED] * 4)[0]
    rsub.set_errhandler(R.ERRORS_RETURN)
    with pytest.raises(R.MPIError) as re:
        rsub.create(rworld.group.incl([1, 6]))
    assert re.value.error_class == ERR_RANK
    rsub.free()


def test_split_type_shared(rworld, pworld):
    got = [_shape(w.split_type(M.COMM_TYPE_SHARED))
           for M, w in ((R, rworld), (P, pworld))]
    assert got[0] == got[1]
    assert got[1][0][0] == tuple(range(N))        # one host: one comm


def test_attributes_keyvals(rworld, pworld):
    traces = []
    for M, w in ((R, rworld), (P, pworld)):
        calls = []
        kv = M.create_keyval(delete_fn=lambda c, k, v: calls.append(v))
        w.set_attr(kv, "hello")
        found, val = w.get_attr(kv)
        assert found and val == "hello"
        w.delete_attr(kv)
        w.delete_attr(kv)                          # absent: no callback
        assert w.get_attr(kv) == (False, None)
        M.free_keyval(kv)
        traces.append(calls)
    assert traces[0] == traces[1] == ["hello"]


# -- mirrors of tests/test_comm.py:146-166 ----------------------------------
@pytest.mark.parametrize("kind", ["UNDEFINED", "COMM_TYPE_HWTHREAD",
                                  "COMM_TYPE_NUMA", "COMM_TYPE_SHARED"])
def test_split_type(rworld, pworld, kind):
    got = []
    for M, w in ((R, rworld), (P, pworld)):
        t = (R_UNDEFINED if M is R else UNDEFINED) if kind == "UNDEFINED" \
            else getattr(M, kind)
        got.append(_shape(w.split_type(t)))
    assert got[0] == got[1]
    if kind == "UNDEFINED":
        assert got[1][0] == [None] * N
    if kind == "COMM_TYPE_HWTHREAD":
        assert all(len(s) == 1 for s in got[1][0])


def test_split_type_keys_and_unknown(rworld, pworld):
    keys = list(range(N, 0, -1))
    got = [_shape(w.split_type(M.COMM_TYPE_SHARED, keys))
           for M, w in ((R, rworld), (P, pworld))]
    assert got[0] == got[1] and got[1][0][0] == tuple(range(N - 1, -1, -1))
    pworld.set_errhandler(P.ERRORS_RETURN)
    with pytest.raises(P.MPIError):
        pworld.split_type(7)


def test_dup_attribute_copy_semantics(rworld, pworld):
    got = []
    for M, w in ((R, rworld), (P, pworld)):
        kv_nocopy = M.create_keyval()
        kv_copy = M.create_keyval(copy_fn=lambda c, k, v: (True, v + 1))
        kv_veto = M.create_keyval(copy_fn=lambda c, k, v: (False, None))
        w.set_attr(kv_nocopy, 10)
        w.set_attr(kv_copy, 20)
        w.set_attr(kv_veto, 30)
        d = w.dup()
        dd = d.dup()
        got.append([d.get_attr(kv) for kv in (kv_nocopy, kv_copy, kv_veto)]
                   + [dd.get_attr(kv_copy)])
        for kv in (kv_nocopy, kv_copy, kv_veto):
            w.delete_attr(kv)
            M.free_keyval(kv)
        dd.free()
        d.free()
    assert got[0] == got[1] == [(False, None), (True, 21), (False, None),
                                (True, 22)]


# -- port: free and dup fire the callbacks ----------------------------------
def test_free_fires_delete_callbacks(rworld, pworld):
    traces = []
    for M, w in ((R, rworld), (P, pworld)):
        calls = []
        kv = M.create_keyval(copy_fn=lambda c, k, v: (True, v * 2),
                             delete_fn=lambda c, k, v: calls.append(v))
        w.set_attr(kv, 4)
        d = w.dup()
        d.free()                                   # deletes 8
        w.delete_attr(kv)                          # deletes 4
        M.free_keyval(kv)
        traces.append((calls, d.attributes))
    assert traces[0] == traces[1] == ([8, 4], {})


def test_dup_with_a_raising_copy_fn_frees_the_child(pworld):
    def boom(c, k, v):
        raise RuntimeError("copy refused")
    deleted = []
    kv = P.create_keyval(copy_fn=boom)
    kv2 = P.create_keyval(copy_fn=lambda c, k, v: (True, v),
                          delete_fn=lambda c, k, v: deleted.append(v))
    pworld.set_attr(kv2, "first")               # copied before the raise
    pworld.set_attr(kv, 1)
    with pytest.raises(RuntimeError):
        pworld.dup()
    assert deleted == ["first"]                   # the child was freed
    P.free_keyval(kv)
    P.free_keyval(kv2)
    assert P.KEYVAL_INVALID == R.KEYVAL_INVALID


def test_exports_match_the_reference():
    for name in ("ANY_SOURCE", "ANY_TAG", "PROC_NULL", "KEYVAL_INVALID",
                 "COMM_TYPE_SHARED", "COMM_TYPE_HWTHREAD", "COMM_TYPE_NUMA",
                 "UNDEFINED", "ERR_PENDING"):
        assert getattr(P, name) == getattr(R, name), name
    for name in ("create_keyval", "free_keyval", "reduce_local", "Pack",
                 "Unpack", "Pack_external", "Unpack_external", "Pack_size"):
        assert callable(getattr(P, name)), name
    assert torch.is_tensor(P.reduce_local(torch.ones(2), torch.ones(2),
                                          P.SUM))
