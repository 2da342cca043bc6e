"""Build the port's CUDA kernels from ``ompi_tpu_torch/csrc``.

Each source compiles with ``nvcc`` into a shared library with a plain C
interface (loaded with ``ctypes``), for Hopper (``sm_90a``), into
``ompi_tpu_torch/_build/`` (git-ignored). A library is named by a hash
of its source and flags, so an edited source builds anew and an
unchanged one is reused. Nothing builds at import: the first call that
needs a kernel builds it, and ``build_all`` builds every source at once,
one ``nvcc`` per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {"flash_fold": CSRC / "flash_fold.cu",
           "bucket_fold": CSRC / "bucket_fold.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``). Raises if there is none."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels build only where the CUDA toolkit is")


def lib_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None,
              verbose: bool = False) -> Dict[str, dict]:
    """Build every named source not yet built, all ``nvcc`` processes at
    once. Returns ``{name: {"seconds": s, "log": text}}`` (``seconds`` 0.0
    for a library already built). ``verbose`` adds ``-Xptxas=-v`` (each
    kernel's registers, shared memory and spills in ``log``). Raises
    with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, dict] = {}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        path = lib_path(name)
        if path.exists():
            out[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
    return lib
