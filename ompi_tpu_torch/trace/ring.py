"""Span storage — the fixed-capacity, drop-and-count ring buffer.

The reference stack's observability is counters (SPC, MPI_T pvars,
coll/monitoring byte tables): "how many / how much", never "when / who
was late". Spans add the timeline. The storage contract is what a hot
path needs: bounded memory, no blocking ever — on overflow the NEW span
is dropped and counted (``trace_dropped`` pvar), so a runaway trace
degrades to a truncated one, never to backpressure on the communication
path.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional


class Span:
    """One timed interval (or instant) on this process's timeline.

    ``ts`` is ``time.perf_counter()`` seconds — the same clock
    ``tools/mpisync.measure_offset`` aligns across controllers, so
    multi-host spans merge onto one timebase by subtracting the
    measured offset.
    """

    __slots__ = ("name", "ts", "dur", "tid", "rank", "cid", "seq",
                 "kind", "args")

    def __init__(self, name: str, ts: float, dur: float, tid: int,
                 rank: int = -1, cid: Optional[str] = None,
                 seq: Optional[int] = None, kind: str = "span",
                 args: Optional[Dict[str, Any]] = None):
        self.name = name
        self.ts = ts
        self.dur = dur
        self.tid = tid
        self.rank = rank
        self.cid = cid
        self.seq = seq
        self.kind = kind
        self.args = args

    def to_dict(self) -> Dict[str, Any]:
        d = {"name": self.name, "ts": self.ts, "dur": self.dur,
             "tid": self.tid, "rank": self.rank, "kind": self.kind}
        if self.cid is not None:
            d["cid"] = self.cid
        if self.seq is not None:
            d["seq"] = self.seq
        if self.args:
            d["args"] = self.args
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Span":
        return cls(d["name"], d["ts"], d.get("dur", 0.0),
                   d.get("tid", 0), d.get("rank", -1), d.get("cid"),
                   d.get("seq"), d.get("kind", "span"), d.get("args"))

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, ts={self.ts:.6f}, "
                f"dur={self.dur * 1e6:.1f}us, rank={self.rank})")


class SpanRing:
    """Fixed-capacity span store. ``push`` never blocks and never grows
    the buffer past ``capacity``: an arrival into a full ring is dropped
    and counted. The short lock guards only the index bump — contention
    is the enabled-tracing case, where a few ns of serialization is the
    cost of a coherent timeline."""

    def __init__(self, capacity: int):
        self.capacity = max(int(capacity), 1)
        self._buf: List[Optional[Span]] = []
        self._lock = threading.Lock()
        self.pushed = 0                  # spans accepted
        self.dropped = 0                 # spans refused (ring full)

    def push(self, span: Span) -> bool:
        with self._lock:
            if len(self._buf) >= self.capacity:
                self.dropped += 1
                return False
            self._buf.append(span)
            self.pushed += 1
            return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.pushed = 0
            self.dropped = 0
