"""``coll/basic``'s host scan with a combiner that returns each element as
a 1-element array (as a C user function's wrapper does): the port writes
the element without NumPy's deprecated array-to-scalar conversion, so
the scan runs with that warning turned into an error, and it equals the
reference's scan of the same inputs (which still warns)."""
import warnings

import numpy as np
import pytest
import torch

import ompi_tpu_torch as P

N = 8


@pytest.fixture(scope="module")
def pworld():
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    yield P.get_comm_world()
    P._reset_for_tests()


@pytest.mark.parametrize("shape,dtype", [((N,), np.int32),
                                         ((N,), np.float64),
                                         ((N, 3), np.float32)])
def test_scan_one_element_combiner(pworld, world, mpi, shape, dtype):
    import jax.numpy as jnp
    x = (np.random.default_rng(5).integers(-9, 9, shape)).astype(dtype)
    op = P.op_create(lambda a, b: torch.atleast_1d(a + b), commute=True)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="Conversion of an array",
                                category=DeprecationWarning)
        got = pworld.scan(x, op)
    ref_op = mpi.op_create(lambda a, b: jnp.atleast_1d(a + b), commute=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = np.asarray(world.scan(x, ref_op))
    assert isinstance(got, np.ndarray) and got.dtype == x.dtype
    assert got.shape == want.shape == x.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.cumsum(x, axis=0, dtype=dtype))
