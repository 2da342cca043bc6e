"""Mirror of the ``btl/sm`` ring cases of ``tests/test_btl_sm.py`` that
no other port test holds: an oversized record, a threaded SPSC stress
with wraps and backpressure, and a second handle attached by name. Each
runs on the reference's ``Ring`` and on the port's with the same
records."""
import importlib
import threading

import pytest

PKGS = ["ompi_tpu", "ompi_tpu_torch"]


def _ring(pkg, *a, **kw):
    return importlib.import_module(f"{pkg}.btl.sm").Ring(*a, **kw)


@pytest.mark.parametrize("pkg", PKGS)
def test_ring_rejects_oversized(pkg):
    ring = _ring(pkg, None, capacity=128, create=True)
    try:
        assert not ring.fits(1000)
        assert not ring.push(b"x" * 1000, timeout=0.1)
        assert ring.push(b"y" * 32)
        assert ring.pop() == b"y" * 32
    finally:
        ring.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_ring_spsc_threaded_stress(pkg):
    ring = _ring(pkg, None, capacity=1 << 12, create=True)
    n = 2000
    got = []

    def consume():
        while len(got) < n:
            rec = ring.pop()
            if rec is not None:
                got.append(rec)

    t = threading.Thread(target=consume)
    t.start()
    try:
        for i in range(n):
            assert ring.push((b"%06d" % i) * (1 + i % 40), timeout=30), i
        t.join(timeout=60)
        assert not t.is_alive()
        assert got == [(b"%06d" % i) * (1 + i % 40) for i in range(n)]
    finally:
        ring.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_attach_by_name(pkg):
    ring = _ring(pkg, None, capacity=1 << 12, create=True)
    other = _ring(pkg, ring.name, capacity=1 << 12)
    try:
        assert other.push(b"hello over shm")
        assert ring.pop() == b"hello over shm"
    finally:
        other.close()
        ring.close()
