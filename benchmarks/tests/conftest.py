"""The benchmark's own tests: on the CPU at small sizes, except those
marked ``chip``, which need a CUDA card and skip without one.

    python -m pytest benchmarks/tests -q
"""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for _p in (str(BENCH.parent), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips on a machine without one")


@pytest.fixture
def fresh_world():
    """A fresh port state before and after the test (the drivers Init
    the world when none is open)."""
    import ompi_tpu_torch
    ompi_tpu_torch._reset_for_tests()
    yield
    ompi_tpu_torch._reset_for_tests()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny(workload):
    """The cell's configuration and mix at a size a CPU test holds: every
    key but the sizes as the files give them."""
    from benchlib import spec
    c = spec.cell(spec.load_spec(), workload)
    cfg, mix = spec.config(c["config"]), spec.traffic(c["traffic"])
    if mix["kind"] == "collectives":
        mix.update(bytes_per_rank=8 * 16 * 4, warmup_rounds=1,
                   profile_rounds=1, dispatch_rounds=1)
    else:
        cfg.update(n_embd=16, n_layer=2, vocab_size=50, n_positions=8,
                   ddp_bucket_cap_mb=2000 / (1024 * 1024))
        mix.update(warmup_steps=1, profile_steps=1)
    return cfg, mix
