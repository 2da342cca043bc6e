"""Build-on-demand loader for the native host library (ctypes).

The library is the repository's ``native/{convertor,ops,memheap,
matching,containers}.cpp``, read as they are and compiled with
``g++ -O3 -shared -fPIC -std=c++17`` (no ``-ffast-math``: the float
results stay IEEE, bit for bit) into the git-ignored
``ompi_tpu_torch/_build/``, named by a hash of the sources and flags as
the CUDA kernels are (``ops/_build.lib_path``). A build writes to a
per-process temp file and renames it into place, so concurrent builders
never observe a half-written library. Nothing is written to ``native/``.

Nothing builds at import: the first ``get_lib()`` builds (or finds) the
library. A build that fails keeps the compiler's output
(``build_error()``) and every native path declines, so its caller runs
its torch or numpy route. ``OMPI_TPU_TORCH_DISABLE_NATIVE=1`` turns the
library off.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG.parent / "native"
BUILD_DIR = _PKG / "_build"
SOURCES = tuple(NATIVE_DIR / f for f in (
    "convertor.cpp", "ops.cpp", "memheap.cpp", "matching.cpp",
    "containers.cpp"))
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
ABI = 3                          # native/convertor.cpp:ompi_tpu_native_abi

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error = ""
_seconds = 0.0


def lib_path() -> Path:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libompi_tpu_native.{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """The library's path, compiled first when absent. Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    global _seconds
    missing = [str(s) for s in SOURCES if not s.exists()]
    if missing:
        # a partial tree would pass the ABI probe (one file owns the
        # version) and miss symbols at bind time
        raise RuntimeError(f"native sources missing: {missing}")
    path = lib_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        res = subprocess.run(["g++", *FLAGS, *map(str, SOURCES), "-o",
                              str(tmp)], capture_output=True, text=True,
                             timeout=180)
        if res.returncode != 0:
            raise RuntimeError(f"g++ exit {res.returncode}\n{res.stderr}")
        os.replace(tmp, path)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"g++ failed: {e}") from e
    finally:
        if tmp.exists():
            tmp.unlink()
    _seconds = time.perf_counter() - t0
    return path


def _bind(lib: ctypes.CDLL) -> None:
    """The full signature table (every symbol of the five sources; the
    memheap symbols serve the symmetric heap)."""
    i64 = ctypes.c_int64
    vp = ctypes.c_void_p
    pi64 = ctypes.POINTER(ctypes.c_int64)
    lib.ompi_tpu_native_abi.restype = ctypes.c_int
    # convertor.cpp
    lib.ompi_tpu_pack_runs_rows.argtypes = [vp, vp, vp, vp] + [i64] * 7
    lib.ompi_tpu_pack_runs_rows.restype = None
    lib.ompi_tpu_unpack_runs_rows.argtypes = \
        lib.ompi_tpu_pack_runs_rows.argtypes
    lib.ompi_tpu_unpack_runs_rows.restype = None
    # ops.cpp
    lib.ompi_tpu_reduce_local.argtypes = [i64, i64, vp, vp, i64]
    lib.ompi_tpu_reduce_local.restype = ctypes.c_int
    # i64-in/i64-out symbols: memheap.cpp (buddy), matching.cpp and the
    # containers' handles
    for fn, nargs in (("buddy_create", 2), ("buddy_alloc", 2),
                      ("buddy_free", 2), ("buddy_used", 1),
                      ("match_create", 1), ("match_send", 7),
                      ("match_take", 6), ("match_post", 6),
                      ("match_cancel", 3),
                      ("fifo_create", 1), ("fifo_push", 2),
                      ("lifo_create", 1), ("lifo_push", 2),
                      ("ring_create", 1), ("ring_push", 2),
                      ("hotel_create", 1), ("hotel_checkin", 3),
                      ("hotel_occupancy", 1),
                      ("bitmap_create", 1), ("bitmap_test", 2),
                      ("bitmap_find_and_set", 1),
                      ("parray_create", 1), ("parray_add", 2),
                      ("parray_set", 3), ("parray_remove", 2)):
        f = getattr(lib, f"ompi_tpu_{fn}")
        f.argtypes = [i64] * nargs
        f.restype = i64
    for fn in ("buddy_destroy", "match_destroy", "fifo_destroy",
               "lifo_destroy", "ring_destroy", "hotel_destroy",
               "bitmap_destroy", "parray_destroy"):
        f = getattr(lib, f"ompi_tpu_{fn}")
        f.argtypes = [i64]
        f.restype = None
    for fn in ("bitmap_set", "bitmap_clear"):
        f = getattr(lib, f"ompi_tpu_{fn}")
        f.argtypes = [i64, i64]
        f.restype = None
    # pointer-out symbols
    for fn, nargs in (("fifo_pop", 1), ("lifo_pop", 1), ("ring_pop", 1),
                      ("hotel_checkout", 2), ("hotel_evict_one", 2),
                      ("parray_get", 2)):
        f = getattr(lib, f"ompi_tpu_{fn}")
        f.argtypes = [i64] * nargs + [pi64]
        f.restype = i64


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; None when it is
    switched off or did not build (then ``build_error()`` says why)."""
    global _lib, _tried, _error
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("OMPI_TPU_TORCH_DISABLE_NATIVE"):
            _error = "disabled by OMPI_TPU_TORCH_DISABLE_NATIVE"
            return None
        try:
            lib = ctypes.CDLL(str(_build()))
            abi = lib.ompi_tpu_native_abi()
            if abi != ABI:
                raise RuntimeError(f"native ABI {abi}, expected {ABI}")
            _bind(lib)
            _lib = lib
        except (RuntimeError, OSError, AttributeError) as e:
            # AttributeError: a symbol missing from the library
            _error = f"{type(e).__name__}: {e}"
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def build_error() -> str:
    """Why the library is unavailable ("" when it loaded or was never
    asked for)."""
    get_lib()
    return _error


def build_seconds() -> float:
    """Seconds this process spent compiling the library (0.0 when it
    found it built)."""
    return _seconds


def _reset_for_tests() -> None:
    """Forget the loaded library so the next ``get_lib()`` loads again."""
    global _lib, _tried, _error, _seconds
    with _lock:
        _lib, _tried, _error, _seconds = None, False, "", 0.0
