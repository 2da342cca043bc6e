"""A run with the timed path broken underneath comes out not correct,
for each fault the cells can have: a call that returns its input
unchanged, half of the ranks' data left out (the rest counted double, as
a mean over them), the exchange between ranks left out (each rank sees
only its own data), and one answer altered where it is produced. The
faults break the collective bodies the world's communicator selects, so
the persistent plans and the bucket fuser run them too."""
import pytest
import torch

import run
from benchlib import spec
from conftest import tiny

WORKLOADS = [w["name"] for w in spec.load_spec()["workloads"]]
FAULTS = ["unchanged", "half", "no_exchange", "altered"]
FUNCS = ("allreduce", "allgather", "alltoall", "bcast", "reduce",
         "reduce_scatter_block", "gather", "scatter")


class _Broken:
    def __init__(self, mod, fault):
        self._mod, self._fault = mod, fault

    def __getattr__(self, name):
        if name == "bind_allreduce":      # plans fall back to allreduce
            raise AttributeError(name)
        real = getattr(self._mod, name)
        if name not in FUNCS:
            return real
        return lambda x, *a: self._run(real, x, a)

    def _run(self, real, x, a):
        n = x.shape[0]
        if self._fault == "unchanged":
            return x
        if self._fault == "half":
            y = x.clone()
            y[n // 2:] = x[:n // 2]
            return real(y, *a)
        if self._fault == "no_exchange":
            return torch.stack([real(x[r:r + 1].expand_as(x).contiguous(),
                                     *a)[r] for r in range(n)])
        if self._fault == "altered":
            y = real(x, *a).clone()
            y[..., -1] += 1e-3 * (float(y.abs().max()) + 1.0)
            return y
        return real(x, *a)


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", FAULTS)
def test_broken_path_is_not_correct(fresh_world, monkeypatch, workload,
                                    fault):
    from ompi_tpu_torch.core.communicator import Communicator
    real_coll = Communicator._coll
    monkeypatch.setattr(Communicator, "_coll", lambda self, func: _Broken(
        real_coll(self, func), fault))
    cfg, mix = tiny(workload)
    res, lines = run.execute(workload, 2**31 + 3, 0.1, 0, "cpu", 0.0,
                             cfg=cfg, mix=mix)
    assert res["attempted"] > 0
    assert not res["correct"], lines


@pytest.mark.parametrize("workload", WORKLOADS)
def test_unbroken_wrapper_is_correct(fresh_world, monkeypatch, workload):
    """The wrapper alone, with no fault, changes nothing."""
    from ompi_tpu_torch.core.communicator import Communicator
    real_coll = Communicator._coll
    monkeypatch.setattr(Communicator, "_coll", lambda self, func: _Broken(
        real_coll(self, func), "none"))
    cfg, mix = tiny(workload)
    res, lines = run.execute(workload, 2**31 + 3, 0.1, 0, "cpu", 0.0,
                             cfg=cfg, mix=mix)
    assert res["correct"], lines
