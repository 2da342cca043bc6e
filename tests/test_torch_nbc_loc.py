"""The ``coll/nbc`` ring iallreduce on MINLOC/MAXLOC pairs.

The ring pads and chunks each rank's row into N chunks. A chunk must
hold whole (value, index) pairs: at 4 pairs per rank on 8 ranks a chunk
of the flattened row is one element, half a pair. The reference raises
``ValueError`` there (it stays as it is); the port chunks whole pairs, so
its result equals numpy's MINLOC/MAXLOC and its own blocking
``allreduce`` for odd and even pair counts.
"""
import numpy as np
import pytest
import torch

import ompi_tpu_torch as P

N = 8


@pytest.fixture()
def pworld():
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    yield P.get_comm_world()
    P._reset_for_tests()


def _pairs(npairs, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    # few distinct values, so ties must break on the lower index
    v = rng.integers(0, 4, size=(N, npairs)).astype(dtype)
    idx = rng.permutation(N * npairs).reshape(N, npairs).astype(dtype)
    return np.stack([v, idx], axis=-1)


def _numpy_loc(x, kind):
    v, i = x[..., 0], x[..., 1]
    best = v.min(axis=0) if kind == "minloc" else v.max(axis=0)
    hit = np.where(v == best, i, np.inf)
    return np.stack([best, hit.min(axis=0).astype(x.dtype)], axis=-1)


def _wait(req):
    while not req.test()[0]:
        pass
    return req.get()


@pytest.mark.parametrize("npairs", [1, 3, 4, 5, 8, 9])
@pytest.mark.parametrize("kind", ["minloc", "maxloc"])
def test_ring_iallreduce_keeps_pairs_whole(pworld, kind, npairs):
    op = P.MINLOC if kind == "minloc" else P.MAXLOC
    x = _pairs(npairs, seed=npairs * 2 + (kind == "maxloc"))
    got = _wait(pworld.iallreduce(pworld.put(x), op))
    assert isinstance(got, torch.Tensor)
    blocking = pworld.allreduce(pworld.put(x), op)
    want = np.broadcast_to(_numpy_loc(x, kind), x.shape)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(blocking))


def test_ring_iallreduce_loc_2d_records(pworld):
    """A (3, 4) block of pairs per rank: 12 pairs cut into 8 chunks."""
    x = _pairs(12, seed=7).reshape(N, 3, 4, 2)
    got = _wait(pworld.iallreduce(pworld.put(x), P.MAXLOC))
    want = _numpy_loc(x.reshape(N, 12, 2), "maxloc").reshape(3, 4, 2)
    np.testing.assert_array_equal(got.numpy(),
                                  np.broadcast_to(want, x.shape))


def test_four_pairs_on_eight_ranks_reference_raises(pworld, world, mpi):
    """The case that splits a pair: the reference raises ValueError, the
    port equals numpy and its blocking path."""
    x = _pairs(4, seed=11)
    c = world.dup()
    req = c.iallreduce(c.put(x), mpi.MINLOC)
    with pytest.raises(ValueError):
        _wait(req)
    # the failed schedule stays on the reference's progress list, where
    # every later progress() call would run it again: take it off
    req._module._active.remove(req)
    req._module._progress_cb()           # unregisters the idle callback
    c.free()
    got = _wait(pworld.iallreduce(pworld.put(x), P.MINLOC))
    np.testing.assert_array_equal(
        got.numpy(), np.broadcast_to(_numpy_loc(x, "minloc"), x.shape))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(pworld.allreduce(pworld.put(x), P.MINLOC)))


def test_loc_op_without_pairs_is_an_op_error(pworld):
    x = np.zeros((N, 5), np.float32)
    with pytest.raises(P.MPIError) as e:
        pworld.iallreduce(pworld.put(x), P.MINLOC)
    assert e.value.error_class == P.ERR_OP
