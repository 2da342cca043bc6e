"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's);
the reference imports nothing of the port either."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

import run

BENCH = Path(run.__file__).resolve().parent
NEVER = {"jax", "jaxlib", "flax", "ompi_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & NEVER


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert set(_imports(path)) <= {"__future__", "typing", "torch", "numpy"}


def test_guard_compares_whole_top_level_names():
    mods = ["ompi_tpu_torch", "ompi_tpu_torch.coll", "jax_like", "jaxlibx",
            "flaxen", "torch"]
    assert run.forbidden_modules(mods) == []
    assert run.forbidden_modules(mods + ["jax.numpy", "ompi_tpu.coll",
                                         "jaxlib", "flax"]) == [
        "flax", "jax.numpy", "jaxlib", "ompi_tpu.coll"]


def test_a_cpu_run_loads_neither(tmp_path):
    code = ("import sys, time; sys.path.insert(0, %r); import run; "
            "sys.path.insert(0, %r); from conftest import tiny; "
            "cfg, mix = tiny('ddp_gpt2m_bucket25'); "
            "run.execute('ddp_gpt2m_bucket25', 3, 0.1, 0, 'cpu', 0.0, "
            "cfg=cfg, mix=mix); print(run.forbidden_modules())"
            % (str(BENCH), str(BENCH / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
