"""opal_output — verbosity-gated diagnostic streams (the port of
``ompi_tpu/utils/output.py``).

Behavioral spec: ``opal/util/output.h:32-58`` — components open named
output streams; each stream has a verbosity level controlled by a
per-framework MCA var (``<framework>_base_verbose``); ``opal_output(id,
fmt, ...)`` writes unconditionally, ``opal_output_verbose(level, id,
...)`` only when the stream's verbosity is at least ``level``.

Streams write to file objects (stderr by default; capturable for tests).
A stream's verbosity reads the live MCA var at call time, so
``--mca coll_base_verbose 10`` (or
``OMPI_TPU_TORCH_MCA_coll_base_verbose=10``) takes effect mid-run. The
var names are the reference's.
"""
from __future__ import annotations

import sys
import threading
from typing import Dict, Optional, TextIO

from ompi_tpu_torch.mca import var

_lock = threading.Lock()
_streams: Dict[int, "Stream"] = {}
_next_id = 1


class Stream:
    def __init__(self, sid: int, prefix: str, framework: str,
                 file: Optional[TextIO]):
        self.id = sid
        self.prefix = prefix
        self.framework = framework
        self.file = file

    def verbosity(self) -> int:
        if not self.framework:
            return 0
        return int(var.var_get(f"{self.framework}_base_verbose", 0) or 0)


def open_stream(prefix: str = "", framework: str = "",
                file: Optional[TextIO] = None) -> int:
    """Returns a stream id (opal_output_open). ``framework`` binds the
    stream's verbosity to ``<framework>_base_verbose`` (registered here
    when the framework hasn't opened yet — registration is idempotent)."""
    global _next_id
    if framework:
        var.var_register(framework, "base", "verbose", vtype="int",
                         default=0,
                         help=f"Verbosity for the {framework} framework")
    with _lock:
        sid = _next_id
        _next_id += 1
        _streams[sid] = Stream(sid, prefix, framework, file)
    return sid


def close_stream(sid: int) -> None:
    with _lock:
        _streams.pop(sid, None)


def output(sid: int, message: str) -> None:
    """Unconditional write (opal_output)."""
    s = _streams.get(sid)
    if s is None:
        return
    f = s.file or sys.stderr
    f.write(f"[{s.prefix}] {message}\n" if s.prefix else message + "\n")


def output_verbose(level: int, sid: int, message: str) -> None:
    """Write only when the stream's verbosity >= level
    (opal_output_verbose)."""
    s = _streams.get(sid)
    if s is None or s.verbosity() < level:
        return
    output(sid, message)


def _reset_for_tests() -> None:
    global _next_id
    with _lock:
        _streams.clear()
        _next_id = 1
