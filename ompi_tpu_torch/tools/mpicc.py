"""``mpicc`` for the port — the compiler wrapper for the MPI C ABI.

Behavioral spec: the reference's wrapper compilers are argv shims that
splice in include/lib flags from wrapper-data text files
(``ompi/tools/wrappers``). The port of ``ompi_tpu/tools/mpicc.py``: the
wrapper also owns building the bindings library, on demand.

The C shim is the repository's ``native/mpi_cabi.c``, read as it is. Its
module name and its library-version string belong to the JAX package, so
the wrapper writes a generated copy into the git-ignored
``ompi_tpu_torch/_build/`` in which ``SUBSTITUTIONS`` swap exactly those
(each replaced exactly as many times as it lists, so a drifted C source
fails the build instead of linking the JAX package's glue), and compiles
the copy with gcc into ``_build/libtpumpi_torch.<hash>.so``. The hash
covers the copy, the headers and the flags; a build writes to a
per-thread temp file and renames it into place (the protocol of
``native/loader.py``), so concurrent builders never see half a library.
``_build/libtpumpi_torch.so`` is a symlink to the current build, which
the programs link and find through their rpath. Nothing is written to
``native/``.

Usage::

    python -m ompi_tpu_torch.tools.mpicc prog.c -o prog   # compile+link
    python -m ompi_tpu_torch.tools.mpicc --showme         # print the flags

The produced binaries embed CPython (the runtime's host language), so
the link line carries the python embed flags; ``-rpath`` entries make
the binaries runnable without LD_LIBRARY_PATH. Run them under the port's
``mpirun --per-rank``: every rank binds ``cuda:0`` unless the job sets
``--mca mpi_base_device cpu``.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import List, Optional

_PKG = Path(__file__).resolve().parent.parent
_REPO = _PKG.parent
NATIVE_DIR = _REPO / "native"
INCLUDE_DIR = _REPO / "include"
BUILD_DIR = _PKG / "_build"
SRC = NATIVE_DIR / "mpi_cabi.c"
HEADERS = (INCLUDE_DIR / "mpi.h", INCLUDE_DIR / "mpi_pmpi.h",
           NATIVE_DIR / "pmpi_aliases.h")
LIB_NAME = "tpumpi_torch"
SO = BUILD_DIR / f"lib{LIB_NAME}.so"

# (text in native/mpi_cabi.c, its replacement, how many times it occurs)
SUBSTITUTIONS = (
    ('PyImport_ImportModule("ompi_tpu.api.cabi")',
     'PyImport_ImportModule("ompi_tpu_torch.api.cabi")', 2),
    ("cannot import ompi_tpu.api.cabi ",
     "cannot import ompi_tpu_torch.api.cabi ", 1),
    ('"ompi_tpu (TPU-native MPI over XLA/ICI), MPI 3.1 subset"',
     '"ompi_tpu_torch (MPI over PyTorch/CUDA), MPI 3.1 subset"', 1),
)


def _py_embed_flags() -> tuple:
    inc = sysconfig.get_path("include")
    libdir = sysconfig.get_config_var("LIBDIR") or "/usr/local/lib"
    ldver = sysconfig.get_config_var("LDVERSION") \
        or sysconfig.get_config_var("VERSION")
    return inc, libdir, f"python{ldver}"


def generate_source() -> str:
    """``native/mpi_cabi.c`` with ``SUBSTITUTIONS`` applied. Raises
    ``RuntimeError`` when a substitution's count differs from the
    source's."""
    text = SRC.read_text()
    for old, new, count in SUBSTITUTIONS:
        got = text.count(old)
        if got != count:
            raise RuntimeError(
                f"mpicc: {SRC} holds {old!r} {got} times, expected "
                f"{count}; the generated copy would not be the port's")
        text = text.replace(old, new)
    return text


def _build_flags(cc: str) -> List[str]:
    inc, libdir, pylib = _py_embed_flags()
    return [cc, "-O2", "-shared", "-fPIC", "-std=c11",
            f"-I{inc}", f"-I{INCLUDE_DIR}", f"-I{NATIVE_DIR}",
            f'-DOMPI_TPU_ROOT="{_REPO}"',
            f"-L{libdir}", f"-l{pylib}", "-ldl", "-lm",
            f"-Wl,-rpath,{libdir}"]


def lib_path(cc: str = "gcc", source: Optional[str] = None) -> Path:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha256(" ".join(_build_flags(cc)).encode())
    h.update((generate_source() if source is None else source).encode())
    for p in HEADERS:
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{LIB_NAME}.{h.hexdigest()[:16]}.so"


def _replace_atomically(path: Path, write) -> None:
    tmp = path.with_name(
        f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if tmp.exists() or tmp.is_symlink():
            tmp.unlink()


def build_lib(cc: str = "gcc", force: bool = False) -> Path:
    """Build (or find) the port's bindings library and point ``SO`` at
    it; returns ``SO``. Raises ``RuntimeError`` with gcc's output when
    the build fails."""
    source = generate_source()
    target = lib_path(cc, source)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if force or not target.exists():
        csrc = target.with_suffix(".c")
        _replace_atomically(csrc, lambda p: p.write_text(source))

        def compile_to(tmp: Path) -> None:
            cmd = _build_flags(cc)
            cmd[1:1] = [str(csrc), "-o", str(tmp)]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=180)
            except (OSError, subprocess.SubprocessError) as e:
                raise RuntimeError(f"mpicc: {cc} failed: {e}") from e
            if res.returncode != 0:
                raise RuntimeError(f"mpicc: {cc} exit {res.returncode} "
                                   f"building {SO.name}\n{res.stderr}")
        _replace_atomically(target, compile_to)
    if not (SO.is_symlink() and os.readlink(SO) == target.name):
        _replace_atomically(SO, lambda p: p.symlink_to(target.name))
    return SO


def wrapper_flags() -> List[str]:
    """The flags mpicc splices into the user's compile line."""
    _, libdir, pylib = _py_embed_flags()
    return [f"-I{INCLUDE_DIR}",
            f"-L{BUILD_DIR}", f"-l{LIB_NAME}",
            f"-Wl,-rpath,{BUILD_DIR}",
            f"-L{libdir}", f"-l{pylib}",
            f"-Wl,-rpath,{libdir}"]


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    cc = os.environ.get("OMPI_TPU_TORCH_CC", "gcc")
    if args and args[0] == "--showme":
        print(" ".join([cc] + wrapper_flags()))
        return 0
    try:
        build_lib(cc)
    except (OSError, RuntimeError) as e:
        sys.stderr.write(f"{e}\nmpicc: failed to build {SO.name}\n")
        return 1
    cmd = [cc] + args + wrapper_flags()
    try:
        return subprocess.run(cmd).returncode
    except OSError as e:
        sys.stderr.write(f"mpicc: {e}\n")
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
