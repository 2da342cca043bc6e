"""The bucket fold's CUDA kernel (``csrc/bucket_fold.cu``) against its
plain version (``ops/bucket_fold.fold_plain``), bit for bit: both sum
the rank rows in rank order in float32 and round once.

Marked ``chip``: each test needs a CUDA card and skips without one. The
file imports no JAX; on the card:

    python -m pytest --noconftest -m chip tests/test_torch_bucket_fold_cuda.py
"""
import pytest
import torch

from ompi_tpu_torch.ops import bucket_fold as BF

pytestmark = pytest.mark.chip

# a bucket of the DDP cell (GPT-2 medium's gradients in DDP's reverse
# order at its 25 MiB cap: layer 23's attention, then layer 22's
# LayerNorms and MLP, 32 MiB a rank); tail widths; a member whose rows
# are not 16-byte aligned
CELL = [1024, 1024, 1024, 1024 * 1024, 3072, 1024 * 3072, 1024, 1024,
        1024, 1024 * 4096]
WIDTHS = {"cell": CELL, "tail": [4099, 1, 33, 1024 * 1024 + 3],
          "unaligned": [3, 4096, 5, 1024]}


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _fold_both(parts, op, dtype=torch.float32):
    table = BF.Table(parts, op)
    n = parts[0].shape[0]
    out = torch.empty(n * table.total, dtype=dtype, device=parts[0].device)
    launched = BF.launches
    BF.fold(parts, table, out)
    torch.cuda.synchronize()
    assert BF.launches == launched + 1
    want = BF.fold_plain(parts, op, torch.empty_like(out))
    return out, want


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("shape", sorted(WIDTHS))
def test_kernel_sum_f32_equals_the_plain_fold(card, shape, n):
    g = torch.Generator(device=card).manual_seed(n)
    parts = [torch.randn((n, w), device=card, generator=g)
             for w in WIDTHS[shape]]
    got, want = _fold_both(parts, "sum")
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_kernel_dtypes_and_ops_equal_the_plain_fold(card, op, dtype):
    g = torch.Generator(device=card).manual_seed(7)
    parts = [torch.randn((8, w), device=card, generator=g).to(dtype)
             for w in WIDTHS["tail"]]
    got, want = _fold_both(parts, op, dtype)
    assert torch.equal(got, want)


def test_kernel_raises_on_what_it_does_not_take(card):
    parts = [torch.randn((8, 16), device=card)]
    table = BF.Table(parts, "sum")
    with pytest.raises(ValueError):
        BF.fold([parts[0].t().contiguous().t()], table,
                torch.empty(8 * 16, device=card))
    with pytest.raises(ValueError):
        BF.fold(parts, table, torch.empty(8 * 16, device=card,
                                          dtype=torch.float64))
    with pytest.raises(ValueError):     # another tensor than the table's
        BF.fold([parts[0].clone()], table, torch.empty(8 * 16, device=card))
