"""The least-byte arithmetic of every collective: from MPI's semantics,
at the cell's sizes and in closed form."""
import pytest

from benchlib import least_bytes

MiB = 1 << 20


@pytest.mark.parametrize("func,read,written", [
    ("allreduce", 8 * 32, 8 * 32),
    ("allgather", 32, 8 * 32),
    ("alltoall", 8 * 32, 8 * 32),
    ("bcast", 32, 7 * 32),
    ("reduce", 8 * 32, 32),
    ("reduce_scatter_block", 8 * 32, 8 * 4),
    ("gather", 32, 32),
    ("scatter", 32, 8 * 4),
])
def test_least_bytes_at_32MiB_on_8_ranks(func, read, written):
    assert least_bytes.collective(func, 8, 32 * MiB) == (read * MiB,
                                                         written * MiB)
    assert least_bytes.total(func, 8, 32 * MiB) == (read + written) * MiB


@pytest.mark.parametrize("n", [2, 3, 8])
def test_least_bytes_scale_with_ranks(n):
    b = 12 * n
    assert least_bytes.total("allgather", n, b) == b + n * b
    assert least_bytes.total("gather", n, b) == 2 * b
    assert least_bytes.total("reduce_scatter_block", n, b) == n * b + b
    assert least_bytes.total("bcast", n, b) == n * b


def test_one_round_of_the_cycle():
    from benchlib import spec
    calls = spec.traffic("coll_cycle_32MiB")["calls"]
    total = sum(least_bytes.total(f, 8, 32 * MiB) for f in calls)
    assert total == (512 + 288 + 512 + 256 + 288 + 288 + 64 + 64) * MiB


def test_unknown_collective_has_no_rule():
    with pytest.raises(KeyError):
        least_bytes.collective("scan", 8, 64)
