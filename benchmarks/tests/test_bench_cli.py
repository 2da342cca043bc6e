"""The command exits non-zero and prints no result without a card, and
in a checkout that holds only the benchmark (no program)."""
import os
import shutil
import subprocess
import sys

import run

BENCH = run.BENCH


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(kw)
    return env


def test_no_card_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "w8_coll_32MiB",
         "--seed", "4000000004", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env=_env(CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_fails_without_the_program(tmp_path):
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    # skip the look for a card, as a run on a card would pass it
    code = ("import sys; sys.path.insert(0, 'benchmarks'); import run; "
            "res, _ = run.execute('w8_coll_32MiB', 1, 0.1, 0, 'cpu', 0.0); "
            "print(res)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path, env=_env())
    assert out.returncode != 0
    assert "ompi_tpu_torch" in out.stderr
    assert out.stdout.strip() == ""
