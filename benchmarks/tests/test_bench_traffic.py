"""The traffic generator: deterministic by seed, and every seed gives
the same calls, roots and sizes."""
import pytest

from benchlib import spec
from benchlib.traffic import MARKS, Schedule, torch_seed

SEEDS = [0, 1, 2**31 - 1, 2**31 + 5, 4_000_000_004, 2**40 + 3]


def _mix():
    return spec.traffic("coll_cycle_32MiB")


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_schedule(seed):
    a, b = Schedule(_mix(), 8, seed), Schedule(_mix(), 8, seed)
    assert [a.mark(i) for i in range(200)] == [b.mark(i) for i in range(200)]
    assert [a.call(i) for i in range(200)] == [b.call(i) for i in range(200)]
    assert torch_seed(seed) == torch_seed(seed)


def test_seeds_change_values_only():
    a, b = Schedule(_mix(), 8, 11), Schedule(_mix(), 8, 12)
    assert [a.mark(i) for i in range(64)] != [b.mark(i) for i in range(64)]
    assert [a.call(i) for i in range(500)] == [b.call(i) for i in range(500)]
    assert torch_seed(11) != torch_seed(12)


def test_calls_cycle_and_roots_cycle_over_the_ranks():
    mix = _mix()
    s = Schedule(mix, 8, 3)
    c = len(mix["calls"])
    assert [s.call(i)[0] for i in range(c)] == mix["calls"]
    assert [s.call(k * c)[1] for k in range(9)] == [0, 1, 2, 3, 4, 5, 6, 7, 0]
    assert {s.call(i)[1] for i in range(c)} == {0}


def test_marks_are_bounded_and_reused_cyclically():
    s = Schedule(_mix(), 8, 5)
    assert all(-1.0 <= s.mark(i) < 1.0 for i in range(1000))
    assert s.mark(7) == s.mark(7 + MARKS)


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_seed_fits_a_generator(seed):
    import torch
    v = torch_seed(seed)
    assert 0 <= v < 2**63
    torch.Generator().manual_seed(v)


def test_grad_sync_mix_is_one_step_per_call():
    s = Schedule(spec.traffic("ddp_bucket25"), 8, 9)
    assert s.call(5) == ("step", 0)
