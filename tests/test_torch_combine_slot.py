"""Mirror of ``tests/test_combine_slot.py`` through both packages: the
``CombineSlot`` of ``pml/perrank`` (the inline reader-thread fold behind
the small-message allreduce) on the same feeds in each."""
import importlib
import threading

import numpy as np
import pytest

PKGS = ["ompi_tpu", "ompi_tpu_torch"]


def _slot(pkg, *a):
    return importlib.import_module(f"{pkg}.pml.perrank").CombineSlot(*a)


def _fold_sub(vals):
    acc = vals[0]
    for v in vals[1:]:
        acc = acc - v
    return acc


@pytest.mark.parametrize("pkg", PKGS)
def test_rank_ordered_fold_is_deterministic(pkg):
    for arrival in ([1, 2, 3], [3, 2, 1], [2, 3, 1]):
        slot = _slot(pkg, 4, 3, _fold_sub)
        slot.put_own(0, 100.0)
        for src in arrival:
            slot.feed(src, float(src))
        assert slot.wait(5) == 100.0 - 1.0 - 2.0 - 3.0


@pytest.mark.parametrize("pkg", PKGS)
def test_last_arrival_completes_once(pkg):
    slot = _slot(pkg, 2, 1, lambda vs: vs[0] + vs[1])
    slot.put_own(0, np.float64(1.5))
    assert not slot._event.is_set()
    slot.feed(1, np.float64(2.5))
    assert slot.wait(5) == 4.0
    slot.feed(1, np.float64(99.0))           # duplicates are ignored
    assert slot.result == 4.0


@pytest.mark.parametrize("pkg", PKGS)
def test_fail_wakes_waiter(pkg):
    slot = _slot(pkg, 2, 1, lambda vs: vs)
    err = RuntimeError("peer died")
    seen = {}

    def wait():
        try:
            slot.wait(5)
        except RuntimeError as e:
            seen["err"] = e

    t = threading.Thread(target=wait)
    t.start()
    slot.fail(err)
    t.join(5)
    assert seen["err"] is err
    slot.feed(1, 1.0)                        # ignored after failure
    assert slot.result is None


@pytest.mark.parametrize("pkg", PKGS)
def test_fold_exception_surfaces_at_wait(pkg):
    slot = _slot(pkg, 2, 1, lambda vs: 1 / 0)
    slot.put_own(0, 1.0)
    slot.feed(1, 2.0)
    with pytest.raises(ZeroDivisionError):
        slot.wait(5)


@pytest.mark.parametrize("pkg", PKGS)
def test_concurrent_feeds_fold_exactly_once(pkg):
    n = 8
    folds = []
    slot = _slot(pkg, n, n - 1, lambda vs: folds.append(1) or sum(vs))
    slot.put_own(0, 0)
    threads = [threading.Thread(target=slot.feed, args=(i, i))
               for i in range(1, n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(5)
    assert slot.wait(5) == sum(range(n))
    assert folds == [1]
