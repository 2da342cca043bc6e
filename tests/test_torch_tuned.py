"""The port's coll/tuned: the tuned component on the single-controller
tier, the staging switch point and its probe.

The reference's ``TunedCollModule`` (priority 60) sends a numpy stacked
buffer below ``stage_min`` to coll/basic and stages a larger one onto the
device, copying the result back: numpy in, numpy out. Without the
component the port's coll/torch took the call and returned a tensor.
Here the same seeded numpy stacks go through the conftest's 8-device JAX
world and an 8-rank CPU port world on both sides of the switch point:
both return numpy; the port's result equals coll/torch's on the same
tensor (bit for bit where the call is staged, which is coll/torch's own
fold; float SUM within rtol 1e-5 where coll/basic's numpy fold runs) and
the reference's (float SUM within rtol 1e-5, the rest exact).
"""
import json

import numpy as np
import pytest
import torch

import ompi_tpu_torch as P
from ompi_tpu_torch.coll import tuned
from ompi_tpu_torch.coll.basic import BasicCollModule
from ompi_tpu_torch.coll.torch_ import TorchCollModule
from ompi_tpu_torch.mca import var as pvar

N = 8
STAGE_MIN = 1 << 20
SIZES = {"below": 10, "above": 300000}     # per-rank float32 elements


@pytest.fixture()
def pworld():
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    pvar.var_set("coll_tuned_stage_min_bytes", STAGE_MIN)
    w = P.get_comm_world()
    yield w
    P._reset_for_tests()


def _stack(func, elems, seed):
    rng = np.random.default_rng(seed)
    lead = (N, N) if func in ("alltoall", "reduce_scatter_block") else (N,)
    return rng.standard_normal(lead + (elems,)).astype(np.float32)


CALLS = {
    "allreduce": lambda c, x, m: c.allreduce(x, m.SUM),
    "reduce": lambda c, x, m: c.reduce(x, m.SUM, 2),
    "bcast": lambda c, x, m: c.bcast(x, 3),
    "allgather": lambda c, x, m: c.allgather(x),
    "alltoall": lambda c, x, m: c.alltoall(x),
    "reduce_scatter_block": lambda c, x, m: c.reduce_scatter_block(x, m.SUM),
    "scan": lambda c, x, m: c.scan(x, m.MAX),
}
REDUCING = {"allreduce", "reduce", "reduce_scatter_block"}


@pytest.mark.parametrize("side", sorted(SIZES))
@pytest.mark.parametrize("func", sorted(CALLS))
def test_numpy_stack_returns_numpy(pworld, world, mpi, func, side):
    """Numpy in, numpy out on both sides of ``stage_min``, in both
    packages; the values are coll/torch's on the same tensor."""
    x = _stack(func, SIZES[side], seed=len(func) * 7 + SIZES[side])
    staged = x.nbytes >= STAGE_MIN
    assert staged == (side == "above")
    got = CALLS[func](pworld, x, P)
    assert isinstance(got, np.ndarray), type(got)
    ref = CALLS[func](world, x, mpi)
    assert isinstance(ref, np.ndarray), type(ref)
    dev = TorchCollModule(pworld)
    want = CALLS[func](_Bare(dev, pworld), torch.from_numpy(x), P).numpy()
    sig = (slice(2, 3) if func == "reduce" else slice(None))
    if func in REDUCING and not staged:
        np.testing.assert_allclose(got[sig], want[sig], rtol=1e-5,
                                   atol=1e-5)
    else:
        np.testing.assert_array_equal(got[sig], want[sig])
    if func in REDUCING:
        np.testing.assert_allclose(got[sig], np.asarray(ref)[sig],
                                   rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, np.asarray(ref))


class _Bare:
    """A module called through the communicator's method names."""

    def __init__(self, mod, comm):
        self.m, self.comm = mod, comm

    def allreduce(self, x, op):
        return self.m.allreduce(x, op)

    def reduce(self, x, op, root):
        return self.m.reduce(x, op, root)

    def bcast(self, x, root):
        return self.m.bcast(x, root)

    def allgather(self, x):
        return self.m.allgather(x)

    def alltoall(self, x):
        return self.m.alltoall(x)

    def reduce_scatter_block(self, x, op):
        return self.m.reduce_scatter_block(x, op)

    def scan(self, x, op):
        return self.m.scan(x, op)


def test_tuned_wins_and_routes(pworld):
    """tuned wins every blocking slot at priority 60, as in the
    reference; a tensor runs on coll/torch, a small numpy stack on
    coll/basic, a large one staged on coll/torch."""
    for func in ("allreduce", "bcast", "reduce", "alltoall", "barrier"):
        assert pworld._coll_winners[func] == "tuned"
    assert ("tuned", 60) in pworld._coll_priorities
    mod = pworld._coll("allreduce")
    assert isinstance(mod.device, TorchCollModule)
    assert isinstance(mod.host, BasicCollModule)
    t = pworld.alloc((4,), fill=1.0)
    assert mod._decide("allreduce", t) == (mod.device, False)
    small = np.ones((N, 4), np.float32)
    assert mod._decide("allreduce", small) == (mod.host, False)
    big = np.ones((N, STAGE_MIN // (4 * N)), np.float32)
    assert mod._decide("allreduce", big) == (mod.device, True)
    y = pworld.allreduce(t)
    assert isinstance(y, torch.Tensor) and torch.all(y == N)
    assert mod.selected("allreduce", t, P.SUM) == "direct"


def test_stage_min_precedence(pworld, tmp_path):
    """The rules file's per-collective value beats a user-set var, which
    beats the probe."""
    assert tuned.stage_min_for("allreduce") == STAGE_MIN
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps({"bcast": {"stage_min_bytes": 4096}}))
    pvar.var_set("coll_tuned_dynamic_rules", str(rules))
    assert tuned.stage_min_for("bcast") == 4096
    assert tuned.stage_min_for("allreduce") == STAGE_MIN


def test_probe_runs_when_the_var_is_unset():
    """With no user-set var, the first staging decision runs the probe
    on the world's device and adopts its value."""
    P._reset_for_tests()
    try:
        P.Init(devices=["cpu"] * 4)
        assert not tuned.probed_stage_basis().get("ran")
        w = P.get_comm_world()
        y = w.allreduce(np.ones((4, 10), np.float32))
        assert isinstance(y, np.ndarray) and np.all(y == 4)
        basis = tuned.probed_stage_basis()
        assert basis["ran"] and basis["device"] == "cpu"
        assert tuned.stage_min_for("allreduce") == basis["value"]
    finally:
        P._reset_for_tests()


def test_staging_probe_basis_keys():
    """The port's probe reports the reference's basis (the same keys, plus
    the device it ran on), and a finite crossover is confirmed by
    measurement with the 1.5x band, as the reference's is."""
    from ompi_tpu.coll.tuned import staging_probe as ref_probe
    _, ref_basis = ref_probe(transport_bps=1e6, nranks=2)
    cross, basis = tuned.staging_probe(transport_bps=1e6, nranks=2,
                                       device="cpu")
    shared = {"ran", "staged_per_mb_ms", "host_per_mb_ms",
              "staged_fixed_us", "host_fixed_us", "transport_gbps",
              "stage_min_bytes"}
    assert shared <= set(ref_basis) and shared <= set(basis)
    assert basis["device"] == "cpu" and basis["transport_gbps"] == 0.001
    assert basis.get("confirm_bytes")
    if cross < tuned._NEVER_STAGE:
        assert basis["hysteresis"] == 1.5
        assert basis["stage_min_bytes"] == cross
    else:
        assert basis["confirm_rejected_staging"] is True
        assert basis["stage_min_bytes"] == -1


def test_adopted_value_is_the_switch_point():
    P._reset_for_tests()
    try:
        P.Init(devices=["cpu"] * 2)
        tuned.adopt_probed_stage_min(12345, {"device": "cpu"})
        assert tuned.stage_min_for("allreduce") == 12345
        assert tuned.probed_stage_basis()["value"] == 12345
        pvar.var_set("coll_tuned_stage_min_bytes", 777)
        assert tuned.stage_min_for("allreduce") == 777
    finally:
        P._reset_for_tests()
