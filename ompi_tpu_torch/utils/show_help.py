"""show_help — user-facing diagnostic catalogs with de-duplication (the
port of ``ompi_tpu/utils/show_help.py``).

Behavioral spec: ``opal/util/show_help.h`` — components ship
``help-*.txt`` message catalogs (INI-style ``[topic]`` sections with
``%s``-style substitution); ``opal_show_help(file, topic, ...)`` renders
the catalog text, and repeated emissions of the same (file, topic) are
aggregated ("N more processes sent help message ...") instead of
spamming every rank's copy.

The catalogs are this package's own ``help/*.txt`` files (the same
INI-section format and text as the reference's); de-duplication is per
(catalog, topic) with a count, flushed on demand — the single-controller
analogue of the reference's cross-rank aggregation window.
"""
from __future__ import annotations

import os
import re
import sys
import threading
from typing import Dict, List, Optional, TextIO, Tuple

_lock = threading.Lock()
_catalog_cache: Dict[str, Dict[str, str]] = {}
_seen: Dict[Tuple[str, str], int] = {}

_HELP_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "help")


def _load_catalog(name: str) -> Dict[str, str]:
    cat = _catalog_cache.get(name)
    if cat is not None:
        return cat
    cat = {}
    path = os.path.join(_HELP_DIR, name)
    try:
        with open(path) as f:
            topic, lines = None, []
            for raw in f:
                m = re.match(r"^\[(.+)\]\s*$", raw)
                if m:
                    if topic is not None:
                        cat[topic] = "".join(lines).rstrip("\n")
                    topic, lines = m.group(1), []
                elif topic is not None and not raw.startswith("#"):
                    lines.append(raw)
            if topic is not None:
                cat[topic] = "".join(lines).rstrip("\n")
    except OSError:
        pass
    _catalog_cache[name] = cat
    return cat


def render(filename: str, topic: str, *args) -> str:
    """Catalog text with %s substitution; a self-describing fallback
    when the catalog/topic is missing (the reference prints a 'sorry,
    no help' banner rather than failing)."""
    text = _load_catalog(filename).get(topic)
    if text is None:
        return (f"Help message {filename!r} / topic {topic!r} "
                f"unavailable (args: {args})")
    try:
        return text % args if args else text
    except (TypeError, ValueError):
        return text


def show_help(filename: str, topic: str, *args,
              want_error_header: bool = True,
              file: Optional[TextIO] = None) -> str:
    """Render + emit with de-duplication: the first emission prints the
    full message; repeats are counted and summarized by flush()."""
    key = (filename, topic)
    out = file or sys.stderr
    with _lock:
        n = _seen.get(key, 0)
        _seen[key] = n + 1
        first = (n == 0)
    msg = render(filename, topic, *args)
    if first:
        if want_error_header:
            bar = "-" * 60
            out.write(f"{bar}\n{msg}\n{bar}\n")
        else:
            out.write(msg + "\n")
    return msg


def flush(file: Optional[TextIO] = None) -> List[str]:
    """Emit the aggregation summary ('N more ... sent help message X')
    and reset counts — the reference's periodic aggregation output."""
    out = file or sys.stderr
    lines = []
    with _lock:
        for (fname, topic), n in _seen.items():
            if n > 1:
                line = (f"{n - 1} more occurrence(s) of help message "
                        f"[{fname} / {topic}] suppressed")
                lines.append(line)
                out.write(line + "\n")
        _seen.clear()
    return lines


def _reset_for_tests() -> None:
    with _lock:
        _seen.clear()
        _catalog_cache.clear()
