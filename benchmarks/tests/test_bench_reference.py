"""The plain reference against the port's CPU path (``devices=["cpu"] *
8``) at small sizes: a whole run on the CPU comes out correct, and each
collective's reference agrees with the port call by call."""
import pytest
import torch

import run
from benchlib import spec
from conftest import tiny
from reference import collectives as ref
from reference import grad_sync as gref

WORKLOADS = [w["name"] for w in spec.load_spec()["workloads"]]
FUNCS = ["allreduce", "allgather", "alltoall", "bcast", "reduce",
         "reduce_scatter_block", "gather", "scatter"]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cpu_run_is_correct(fresh_world, workload, trace):
    cfg, mix = tiny(workload)
    res, lines = run.execute(workload, 2**31 + 17, 0.2, trace, "cpu", 0.0,
                             cfg=cfg, mix=mix)
    assert res["correct"], lines
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert lines[-len(res["checks"]):] and all(
        ln.startswith("check ") for ln in lines[-len(res["checks"]):])


@pytest.mark.parametrize("func", FUNCS)
@pytest.mark.parametrize("root", [0, 5])
def test_reference_equals_the_port_call(fresh_world, func, root):
    import ompi_tpu_torch as MPI
    MPI.Init(devices=["cpu"] * 8)
    w = MPI.get_comm_world()
    g = torch.Generator().manual_seed(7)
    blocked = func in ("alltoall", "reduce_scatter_block", "scatter")
    x = torch.randn((8, 8, 4) if blocked else (8, 32), generator=g)
    call = {"allreduce": lambda: w.allreduce(x, MPI.SUM),
            "allgather": lambda: w.allgather(x),
            "alltoall": lambda: w.alltoall(x),
            "bcast": lambda: w.bcast(x, root),
            "reduce": lambda: w.reduce(x, MPI.SUM, root),
            "reduce_scatter_block": lambda: w.reduce_scatter_block(
                x, MPI.SUM),
            "gather": lambda: w.gather(x, root),
            "scatter": lambda: w.scatter(x, root)}[func]
    got = call()
    want = ref.collective(func, x, root)
    rows = ref.significant(func, root, 8)
    if func in ref.REDUCTIONS:
        torch.testing.assert_close(got[rows].double(), want[rows],
                                   rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(got[rows], want[rows])


def test_grad_sync_reference_is_the_mean_on_every_rank():
    g = torch.randn(8, 3, 5, generator=torch.Generator().manual_seed(1))
    m = gref.mean(g)
    assert m.shape == (8, 3, 5) and m.dtype == torch.float64
    assert torch.allclose(m[3], g.double().mean(0))
    assert gref.mean(g, torch.bfloat16).dtype == torch.bfloat16
