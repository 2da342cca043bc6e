"""The MPI C ABI on the port: the reference's C conformance programs
(``tests/cabi_programs/``), compiled with the port's ``mpicc`` and run
under the port's ``mpirun --per-rank`` with the ranks bound to the CPU.

The mirror of ``tests/test_cabi.py``: the same 40 (program, ranks) cases
with the same arguments and time limits (imported from it, so the two
cannot drift), the same ``OK cNN`` count per rank, the PMPI LD_PRELOAD
interposer, the PMPI twin of every exported symbol (on the port's
library) and ``--showme``.

Two things differ from the reference's harness:

- Three programs write fixed ``/tmp`` paths that the reference's own runs
  use too (``c12_mpiio.c``, ``c33_io2.c`` and ``c36_icoll_blocking_mix.c``),
  so a port run and a reference run in one suite could share a file.
  Each is compiled from a copy in which only those path literals point
  into a directory of this module's own (``TEMP_PATHS`` lists each literal
  and how often it occurs; the test asserts both). No size, seed or check
  changes. For the same reason each case names a name-server file of
  its own (``OMPI_TPU_TORCH_NAME_SERVER_FILE``).
- Each program is compiled on first use into a cache shared by the run's
  workers, keyed by the hash of its (patched) source and headers, and
  renamed into place: each program compiles once per run, not once per
  worker.
"""
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile

import pytest

from test_cabi import CASES, PROG_ARGS, PROG_TIMEOUT
from ompi_tpu_torch.tools import mpicc

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PROGS = os.path.join(_REPO, "tests", "cabi_programs")
_MPIRUN = os.path.join(_REPO, "ompi_tpu_torch", "tools", "mpirun.py")

pytestmark = pytest.mark.skipif(shutil.which("gcc") is None,
                                reason="no C compiler")

# program -> (fixed path literal, its replacement under {d}, occurrences)
TEMP_PATHS = {
    "c12_mpiio.c": ('"/tmp/ompi_tpu_c12_%d.dat"', '"{d}/c12_%d.dat"', 1),
    "c33_io2.c": ('"/tmp/c33_io2_%ld.dat"', '"{d}/c33_%ld.dat"', 1),
    "c36_icoll_blocking_mix.c": ('"/tmp/c36_shared_%d.bin"',
                                 '"{d}/c36_%d.bin"', 1),
}
# c36 formats its path into a 64-byte buffer: the directory takes at
# most 40 of them
_DIR_MAX = 40


@pytest.fixture(scope="module")
def io_dir():
    """A short directory of this module's own for the patched paths
    (under the temp root, or under /tmp when that root is too long)."""
    d = tempfile.mkdtemp(prefix="otc")
    if len(d) > _DIR_MAX:
        shutil.rmtree(d)
        d = tempfile.mkdtemp(prefix="otc", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    """The compile cache, shared by every worker of the run."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    d = base / "torch_cabi_bin"
    d.mkdir(exist_ok=True)
    return d


def patched_source(src: str, io_dir: str) -> str:
    """The program's source, its fixed temp path (if any) moved into
    ``io_dir``; asserts the literal and its count."""
    with open(os.path.join(_PROGS, src)) as f:
        text = f.read()
    if src in TEMP_PATHS:
        old, new, count = TEMP_PATHS[src]
        assert text.count(old) == count, (src, old, text.count(old))
        text = text.replace(old, new.format(d=io_dir))
    return text


def compile_cached(cache_dir, src: str, io_dir: str,
                   extra=()) -> str:
    """Compile ``src`` with the port's mpicc (on first use in the run);
    returns the binary's path."""
    text = patched_source(src, io_dir)
    h = hashlib.sha256(text.encode())
    h.update(" ".join(extra).encode())
    for hdr in mpicc.HEADERS:
        h.update(hdr.read_bytes())
    stem = src.removesuffix(".c")
    out = cache_dir / f"{stem}.{h.hexdigest()[:16]}"
    if out.exists():
        return str(out)
    work = cache_dir / f"{stem}.{os.getpid()}.c"
    tmp = cache_dir / f"{out.name}.{os.getpid()}.tmp"
    work.write_text(text)
    try:
        res = subprocess.run(
            [sys.executable, "-m", "ompi_tpu_torch.tools.mpicc", *extra,
             str(work), "-o", str(tmp)],
            capture_output=True, text=True, timeout=300, cwd=_REPO)
        assert res.returncode == 0, \
            f"mpicc failed for {src}:\n{res.stdout}\n{res.stderr}"
        os.replace(tmp, out)
    finally:
        for p in (work, tmp):
            if p.exists():
                p.unlink()
    return str(out)


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "OMPI_TPU_TORCH_"))}
    env.update(extra)
    return env


def _run(binary, n, tmo, args=(), env=None):
    return subprocess.run(
        [sys.executable, _MPIRUN, "--per-rank", "-n", str(n),
         "--timeout", str(tmo), "--mca", "mpi_base_device", "cpu", binary,
         *args], env=env or _env(), capture_output=True, text=True,
        timeout=tmo + 50, cwd=_REPO)


def test_temp_paths_are_the_only_change(io_dir):
    """The patched copies differ from the programs in the path literals
    alone, and the directory leaves c36's 64-byte path buffer room."""
    assert len(io_dir) <= _DIR_MAX
    for src, (old, new, count) in TEMP_PATHS.items():
        with open(os.path.join(_PROGS, src)) as f:
            text = f.read()
        got = patched_source(src, io_dir)
        assert got != text
        assert got.replace(new.format(d=io_dir), old) == text


@pytest.mark.parametrize("src,n", CASES,
                         ids=[f"{c[0].removesuffix('.c')}-n{c[1]}"
                              for c in CASES])
def test_cabi_program(cache_dir, io_dir, tmp_path, src, n):
    binary = compile_cached(cache_dir, src, io_dir)
    tmo = PROG_TIMEOUT.get(src, 150)
    # a name server of the case's own (c18, c35 publish names)
    env = _env(OMPI_TPU_TORCH_NAME_SERVER_FILE=str(tmp_path / "names.json"))
    res = _run(binary, n, tmo, PROG_ARGS.get(src, []), env=env)
    assert res.returncode == 0, \
        f"rc={res.returncode}\n--- out\n{res.stdout}\n--- err\n" \
        f"{res.stderr[-4000:]}"
    marker = f"OK {src.removesuffix('.c')}"
    assert res.stdout.count(marker) == n, res.stdout


def test_pmpi_interposer_ld_preload(cache_dir, io_dir, tmp_path):
    """The PMPI contract end to end: a profiling tool that redefines
    MPI_Allreduce/MPI_Bcast (weak aliases) and calls PMPI_* onward is
    LD_PRELOADed under an unmodified program binary; every rank's
    counters must fire."""
    tool = compile_cached(cache_dir, "pmpi_tool.c", io_dir,
                          extra=("-shared", "-fPIC"))
    binary = compile_cached(cache_dir, "c03_coll.c", io_dir)
    res = _run(binary, 2, 150, env=_env(LD_PRELOAD=tool))
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("PMPI_TOOL")]
    assert len(lines) == 2, res.stdout
    for ln in lines:
        assert "allreduce=1" in ln and "bcast=1" in ln, ln
    assert res.stdout.count("OK c03_coll") == 2


def test_every_exported_symbol_has_pmpi_twin():
    """Every weak MPI_X the port's library exports is backed by a strong
    PMPI_X, and the library is the port's own."""
    so = mpicc.build_lib()
    assert so.parent == mpicc.BUILD_DIR and so.name == "libtpumpi_torch.so"
    out = subprocess.run(["nm", "-D", str(so)], capture_output=True,
                         text=True, timeout=60).stdout
    weak = {ln.split()[-1] for ln in out.splitlines() if " W MPI_" in ln}
    strong = {ln.split()[-1] for ln in out.splitlines()
              if " T PMPI_" in ln}
    assert weak, "no weak MPI_ symbols exported"
    missing = {w for w in weak if "P" + w not in strong}
    assert not missing, f"MPI_ symbols without PMPI_ twin: {missing}"


def test_mpicc_showme():
    res = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.mpicc", "--showme"],
        capture_output=True, text=True, timeout=60, cwd=_REPO)
    assert res.returncode == 0
    assert "-ltpumpi_torch" in res.stdout and "include" in res.stdout
    assert f"-Wl,-rpath,{mpicc.BUILD_DIR}" in res.stdout
    assert f"-L{mpicc.NATIVE_DIR}" not in res.stdout
