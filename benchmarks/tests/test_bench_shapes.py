"""GPT-2 medium's gradient tensors, as the DDP cells hand them in."""
import math

import pytest

from benchlib import least_bytes, spec
from conftest import tiny


def _shapes():
    cfg = spec.config("ddp_gpt2m_w8")
    return cfg, spec.model(cfg["model_type"]).shapes(cfg)


def test_gpt2_medium_has_292_tensors_and_354823168_parameters():
    _, shapes = _shapes()
    assert len(shapes) == 292
    assert sum(math.prod(s) for _, s in shapes) == 354_823_168


def test_gpt2_medium_shapes_are_the_published_widths():
    cfg, shapes = _shapes()
    named = dict(shapes)
    assert named["transformer.wte.weight"] == (50257, 1024)
    assert named["transformer.wpe.weight"] == (1024, 1024)
    assert named["transformer.h.23.attn.c_attn.weight"] == (1024, 3072)
    assert named["transformer.h.0.mlp.c_fc.weight"] == (1024, 4096)
    assert named["transformer.h.0.mlp.c_proj.weight"] == (4096, 1024)
    assert "lm_head.weight" not in named          # tied to wte
    assert shapes[0][0] == "transformer.wte.weight"
    assert shapes[-1][0] == "transformer.ln_f.bias"


def test_gpt2_medium_bytes_per_rank_and_bucketable_payload():
    cfg, shapes = _shapes()
    per_rank = 4 * sum(math.prod(s) for _, s in shapes)
    assert per_rank == 1_419_292_672
    assert cfg["dp_world"] * per_rank == 11_354_341_376
    cap = 25 * 1024 * 1024
    bucketable = [4 * math.prod(s) for _, s in shapes
                  if 4 * math.prod(s) <= cap]
    assert sum(bucketable) == 1_213_440_000
    assert least_bytes.grad_sync(8, per_rank) == 2 * 11_354_341_376


def test_ddp_bucket_cap_is_ddps_25_MiB():
    cfg, _ = _shapes()
    assert int(cfg["ddp_bucket_cap_mb"] * 1024 * 1024) == 26_214_400


@pytest.mark.parametrize("func", ["allreduce", "allgather", "alltoall",
                                  "bcast", "reduce", "reduce_scatter_block",
                                  "gather", "scatter"])
def test_collective_sizes_follow_nccl_tests(fresh_world, func):
    """A call's size is the larger of a rank's send and receive buffers:
    allgather and gather send a block of b / n and receive n of them."""
    cfg, mix = tiny("w8_coll_32MiB")
    cell = spec.driver("collectives").Cell(cfg, mix, "cpu")
    cell.load(5)
    n, b = cell.n, cell.b
    x = cell.inputs[func]
    y = cell.fns[func](cell.w, x, 0)
    send = x[0].numel() * 4
    recv = y[0].numel() * 4
    assert max(send, recv) == b
    if func in ("allgather", "gather"):
        assert send == b // n
