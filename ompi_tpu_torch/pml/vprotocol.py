"""pml/vprotocol — pessimist message-logging fault tolerance (the port of
``ompi_tpu/pml/vprotocol.py``).

Behavioral spec: the reference's ``pml/v`` interposition PML with its
``vprotocol/pessimist`` component (``ompi/mca/pml/v``,
``ompi/mca/vprotocol/pessimist`` — 2,065 LoC): every *nondeterministic
event* in the message layer is logged synchronously before it is allowed
to influence execution (pessimist = no determinant may be outrun by a
message it determines), so a failed execution can be replayed to the
exact same state. The two event classes are

- **determinants** — which send matched which receive. The only true
  nondeterminism in MPI matching is wildcard receives (MPI_ANY_SOURCE /
  MPI_ANY_TAG): the per-(src,dest) non-overtaking rule fixes everything
  else.
- **sender-based payload log** — message payloads escrowed at the sender
  so a restarted process can be fed messages whose senders are not being
  rolled back (orphan redelivery).

Single-controller re-design: the matching engine is controller-resident state
(``pml/stacked.py``), so "logging before delivery" is a synchronous
append — the pessimist protocol's hard part on a real wire (holding the
message until its determinant is stable) is free here. Replay runs the
same application code against an engine constructed with the recorded
determinant log: wildcard receives are *forced* to their logged
(source, tag) resolution, which by non-overtaking reproduces the
original delivery order exactly. Payloads escrowed in the log can be
redelivered without re-executing the sender (``redeliver``).

Torch tensors are mutable, so the sender-based log holds its own
``clone()`` of a tensor payload, on the payload's device: neither the
sender overwriting its buffer nor the receiver writing into the
delivered tensor (the engine's own clone) can change the escrow. A JSON
snapshot carries a tensor payload as its raw bytes (base64) with its
torch dtype name and shape, so bf16 and every bit pattern survive; a
restored tensor payload sits on the CPU until ``redeliver`` moves it to
the destination rank's device.

Enabled per-communicator via the MCA var ``pml_v_protocol=pessimist``
(the reference enables pml/v the same way, by component selection).
"""
from __future__ import annotations

import base64
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from ompi_tpu_torch.core.errhandler import ERR_OTHER, MPIError
from ompi_tpu_torch.pml.stacked import (ANY_SOURCE, ANY_TAG, CH_P2P,
                                  MatchingEngine, PtpRequest, _Msg)
from ompi_tpu_torch.mca import var



def _register_vars() -> None:
    var.var_register(
        "pml", "v", "protocol", vtype="str", default="none",
        enumerator=["none", "pessimist"],
        help="Message-logging fault-tolerance protocol interposed on the "
             "pt2pt matching engine (vprotocol/pessimist role): "
             "'pessimist' logs determinants + sender payloads for "
             "deterministic replay")


_register_vars()


class Event:
    """One logged event. ``kind`` is 'send' or 'match'.

    send:  (seq, src, dest, tag, channel, payload)   — sender-based log
    match: (seq, dest, posted_src, posted_tag, src, tag, channel)
           — the determinant: the receive posted as (posted_src,
           posted_tag) was resolved to the message (src, tag).
    """
    __slots__ = ("seq", "kind", "src", "dest", "tag", "channel",
                 "payload", "posted_src", "posted_tag")

    def __init__(self, seq: int, kind: str, *, src: int = -9,
                 dest: int = -9, tag=None, channel: int = CH_P2P,
                 payload: Any = None, posted_src: int = -9,
                 posted_tag=None):
        self.seq = seq
        self.kind = kind
        self.src = src
        self.dest = dest
        self.tag = tag
        self.channel = channel
        self.payload = payload
        self.posted_src = posted_src
        self.posted_tag = posted_tag

    def to_dict(self) -> Dict:
        d = {"seq": self.seq, "kind": self.kind, "src": self.src,
             "dest": self.dest, "tag": self.tag, "channel": self.channel,
             "posted_src": self.posted_src,
             "posted_tag": self.posted_tag}
        p = self.payload
        if isinstance(p, torch.Tensor):
            host = p.detach().to("cpu").contiguous()
            d["payload"] = base64.b64encode(
                host.view(-1).view(torch.uint8).numpy().tobytes()
            ).decode("ascii")
            d["payload_torch_dtype"] = str(host.dtype)[len("torch."):]
            d["payload_shape"] = list(host.shape)
        elif p is not None:
            d["payload"] = (np.asarray(p).tolist()
                            if hasattr(p, "__array__") else p)
            d["payload_dtype"] = (str(np.asarray(p).dtype)
                                  if hasattr(p, "__array__") else None)
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "Event":
        payload = d.get("payload")
        if payload is not None and d.get("payload_torch_dtype"):
            raw = bytearray(base64.b64decode(payload))
            buf = (torch.frombuffer(raw, dtype=torch.uint8) if raw
                   else torch.empty(0, dtype=torch.uint8))
            payload = buf.view(getattr(torch, d["payload_torch_dtype"])
                               ).reshape(d["payload_shape"])
        elif payload is not None and d.get("payload_dtype"):
            payload = np.asarray(payload, dtype=d["payload_dtype"])
        return cls(d["seq"], d["kind"], src=d.get("src", -9),
                   dest=d.get("dest", -9), tag=d.get("tag"),
                   channel=d.get("channel", CH_P2P), payload=payload,
                   posted_src=d.get("posted_src", -9),
                   posted_tag=d.get("posted_tag"))


class PessimistEngine(MatchingEngine):
    """Matching engine with pessimist event logging (record mode) and
    determinant-forced matching (replay mode)."""

    def __init__(self, comm, replay_log: Optional[List[Event]] = None):
        super().__init__(comm)
        self.log: List[Event] = []
        self._seq = 0
        # Replay: per-dest FIFO of match determinants, consumed by
        # wildcard receives in posting order (the pessimist guarantee:
        # receive k at a rank resolves identically across executions).
        self._replay: Optional[Dict[int, Deque[Event]]] = None
        if replay_log is not None:
            self._replay = {}
            for ev in replay_log:
                # Only wildcard resolutions are nondeterministic; a
                # named receive replays itself (and consumes no
                # determinant), so enqueuing its match event would
                # shift every later wildcard onto the wrong one.
                if ev.kind == "match" and (ev.posted_src == ANY_SOURCE
                                           or ev.posted_tag == ANY_TAG):
                    self._replay.setdefault(ev.dest, deque()).append(ev)

    # -- record side ---------------------------------------------------
    def _next_seq(self) -> int:
        s = self._seq
        self._seq += 1
        return s

    def _log_send(self, data, src, dest, tag, channel) -> None:
        snap = data
        if isinstance(snap, np.ndarray):
            snap = snap.copy()
        elif isinstance(snap, torch.Tensor):
            snap = snap.clone()
        self.log.append(Event(self._next_seq(), "send", src=src,
                              dest=dest, tag=tag, channel=channel,
                              payload=snap))

    def _log_match(self, dest: int, posted_src: int, posted_tag,
                   msg: _Msg) -> None:
        self.log.append(Event(self._next_seq(), "match", dest=dest,
                              posted_src=posted_src,
                              posted_tag=posted_tag, src=msg.src,
                              tag=msg.tag, channel=msg.channel))

    def send(self, data, src, dest, tag, synchronous=False,
             channel=CH_P2P):
        # Pessimist rule: the event is durable *before* the message can
        # match anything (log-then-send).
        self._log_send(data, src, dest, tag, channel)
        return super().send(data, src, dest, tag, synchronous, channel)

    def irecv(self, dest, source, tag, channel=CH_P2P) -> PtpRequest:
        if self._replay is not None and (source == ANY_SOURCE
                                         or tag == ANY_TAG):
            det = self._pop_determinant(dest, source, tag)
            source, tag = det.src, det.tag
        posted_src, posted_tag = source, tag
        req = super().irecv(dest, source, tag, channel)
        if req._complete:
            if req.status.source >= 0:      # not PROC_NULL
                self._log_match(dest, posted_src, posted_tag,
                                _Msg(req.status.source, dest,
                                     req.status.tag, None,
                                     channel=channel))
            return req
        # Deferred match: interpose on delivery so the determinant is
        # logged the instant the matching send arrives.
        orig_deliver = req.deliver

        def deliver(msg, _orig=orig_deliver):
            self._log_match(dest, posted_src, posted_tag, msg)
            _orig(msg)
        req.deliver = deliver               # type: ignore[method-assign]
        return req

    def mprobe(self, dest, source, tag):
        if self._replay is not None and (source == ANY_SOURCE
                                         or tag == ANY_TAG):
            det = self._pop_determinant(dest, source, tag)
            source, tag = det.src, det.tag
        msg = super().mprobe(dest, source, tag)
        self._log_match(dest, source, tag, msg)
        return msg

    # -- replay side ---------------------------------------------------
    def _pop_determinant(self, dest: int, source: int, tag) -> Event:
        q = (self._replay or {}).get(dest)
        if not q:
            raise MPIError(
                ERR_OTHER,
                f"pessimist replay: no determinant left for a wildcard "
                f"receive at rank {dest} (log and execution diverged)")
        det = q.popleft()
        if ((det.posted_src != source and det.posted_src != ANY_SOURCE
             and source != ANY_SOURCE)
                or (det.posted_tag != tag and det.posted_tag != ANY_TAG
                    and tag != ANY_TAG)):
            raise MPIError(
                ERR_OTHER,
                f"pessimist replay: determinant mismatch at rank {dest} "
                f"(logged receive ({det.posted_src}, {det.posted_tag}), "
                f"replayed ({source}, {tag}))")
        return det

    def redeliver(self, dest: int) -> int:
        """Re-inject every logged send addressed to ``dest`` from the
        sender-based payload log (orphan redelivery: the senders are
        not being re-executed). Returns the number re-injected."""
        n = 0
        # Redelivered payloads were counted when first sent; keep the
        # per-peer profile matrix at first-execution truth.
        saved = {k: list(v) for k, v in self.traffic.items()}
        devs = getattr(self.comm, "devices", None)
        for ev in self.log:
            if ev.kind == "send" and ev.dest == dest:
                p = ev.payload
                if isinstance(p, torch.Tensor) and devs is not None:
                    p = p.to(devs[dest])       # a restored escrow: CPU
                super().send(p, ev.src, ev.dest, ev.tag,
                             channel=ev.channel)
                n += 1
        self.traffic = saved
        return n

    # -- persistence (checkpoint escrow) -------------------------------
    def snapshot(self) -> List[Dict]:
        return [ev.to_dict() for ev in self.log]

    @classmethod
    def restore_log(cls, dicts: List[Dict]) -> List[Event]:
        return [Event.from_dict(d) for d in dicts]
