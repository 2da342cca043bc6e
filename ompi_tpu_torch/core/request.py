"""Request lifecycle — test/wait{,any,all,some}, persistent and
generalized requests.

Behavioral spec: ``ompi/request/request.h`` (:311-430 wait/test family,
:451-470 completion sync). The port of ``ompi_tpu/core/request.py``.

Torch dispatch is asynchronous on a CUDA device: a collective returns
tensors whose values the device's stream produces later. A torch tensor
cannot be asked whether its producer has run (JAX asks each output array
``is_ready()``), so a request on CUDA tensors holds a CUDA event recorded
on the stream right after its work was dispatched: ``test`` polls the
event, ``wait`` synchronizes on it — never on the whole device. A request
on CPU tensors or host arrays is born complete, as the JAX package's
host path is: the CPU ran the work inside the call.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import torch

from ompi_tpu_torch.accelerator import Event
from ompi_tpu_torch.core.errhandler import ERR_REQUEST, MPIError


class Status:
    """MPI_Status: source, tag, error, element count."""

    __slots__ = ("source", "tag", "error", "count", "cancelled",
                 "nbytes")

    ANY_SOURCE = -1
    ANY_TAG = -1

    def __init__(self, source: int = -1, tag: int = -1, error: int = 0,
                 count: int = 0, nbytes: int = -1):
        self.source = source
        self.tag = tag
        self.error = error
        self.count = count
        self.cancelled = False
        # payload size in bytes (-1 = unknown), what the reference keeps
        # in status->_ucount for MPI_Get_count
        self.nbytes = nbytes

    def get_count(self, datatype=None) -> int:
        if datatype is None or datatype.count == 0:
            return self.count
        return self.count // datatype.count

    def is_cancelled(self) -> bool:
        return self.cancelled


# -- completion markers ------------------------------------------------------
def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def stream_of(device) -> Optional[torch.cuda.Stream]:
    """The current stream of a CUDA device; None for the CPU."""
    device = torch.device(device)
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


def event_on(stream: Optional[torch.cuda.Stream]) -> Optional[Event]:
    """An event recorded on ``stream`` now (None for no stream)."""
    if stream is None:
        return None
    ev = Event(cuda=True)
    ev.record(stream)
    return ev


def event_after(tree) -> Optional[Event]:
    """The completion marker of work that produced ``tree``: an event on
    the current stream of its first CUDA tensor's device, recorded now —
    right after the dispatch. None when ``tree`` holds no CUDA tensor."""
    for t in _tensors(tree):
        if t.is_cuda:
            return event_on(stream_of(t.device))
    return None


class Request:
    """A pending operation. ``result`` is the operation's output (stacked
    tensors); ``event`` marks the end of its device work (None: complete
    already); ``on_complete`` runs exactly once at completion."""

    def __init__(self, result: Any = None, event: Optional[Event] = None,
                 on_complete: Optional[Callable[[Any], Any]] = None,
                 status: Optional[Status] = None,
                 persistent_start: Optional[Callable[[], "Request"]] = None):
        self._result = result
        self._event = event
        self._on_complete = on_complete
        self._complete = event is None
        self._freed = False
        self._free_pending = False
        self.status = status or Status()
        self._persistent_start = persistent_start
        self._active = persistent_start is None
        self._inner_req: Optional["Request"] = None
        self._error: Optional[BaseException] = None

    # -- ULFM completion-in-error (ompi/request/req_ft.c) ------------------
    def fail(self, err: BaseException) -> None:
        """Complete the request NOW, carrying ``err``: wait/test/get raise
        it; ``status.error`` reports its class."""
        self._error = err
        self.status.error = int(getattr(err, "error_class", 0) or 0)
        self._event = None
        self._on_complete = None
        self._inner_req = None
        self._complete = True

    # -- completion --------------------------------------------------------
    def _finish(self):
        if self._on_complete is not None:
            cb, self._on_complete = self._on_complete, None
            self._result = cb(self._result)
        self._event = None
        self._complete = True
        if self._free_pending:
            # MPI_Request_free was called while the operation was in
            # flight: the deallocation completes with the operation
            # (request_free.c.in deferred-free semantics)
            self._free_pending = False
            self._freed = True

    def test(self) -> Tuple[bool, Optional[Status]]:
        """MPI_Test: non-blocking completion check."""
        if self._complete:
            if self._error is not None:
                raise self._error
            return True, self.status
        if self._inner_req is not None:
            # started persistent request: delegate to this iteration's
            # operation (which may itself be schedule-backed)
            ok, _st = self._inner_req.test()
            if ok:
                self._result = self._inner_req._result
                self._finish()
                return True, self.status
            return False, None
        if self._event is None or self._event.query():
            self._finish()
            return True, self.status
        return False, None

    def wait(self) -> Status:
        """MPI_Wait: block until complete; returns the Status."""
        if not self._complete:
            if self._inner_req is not None:
                self._inner_req.wait()
                self._result = self._inner_req._result
            elif self._event is not None:
                self._event.synchronize()
            self._finish()
        if self._error is not None:
            raise self._error
        return self.status

    def get(self) -> Any:
        """Wait and return the operation's result value (the functional
        API's analogue of reading recvbuf)."""
        self.wait()
        return self._result

    def cancel(self) -> None:
        # queued device work cannot be cancelled; as the reference does
        # for already-started requests: no-op
        if not self._complete:
            self.status.cancelled = False

    def free(self) -> None:
        """MPI_Request_free. On an ACTIVE request (started, not yet
        completed) the free is DEFERRED: the operation runs to completion
        and the handle is released then — but it is unusable
        (un-startable) from this call on, the standard's contract."""
        if self._active and not self._complete:
            self._free_pending = True
            return
        self._freed = True

    # -- persistent requests (MPI_Send_init / MPI_Start) -------------------
    def _check_startable(self) -> None:
        """MPI_Start argument checks (start.c.in:56-70): the request must
        be persistent, not freed (or free-pending), and INACTIVE."""
        if self._persistent_start is None:
            raise MPIError(ERR_REQUEST,
                           "MPI_Start on a non-persistent request")
        if self._freed or self._free_pending:
            raise MPIError(ERR_REQUEST,
                           "MPI_Start on a freed request")
        if self._active and not self._complete:
            raise MPIError(ERR_REQUEST,
                           "MPI_Start on an active persistent request "
                           "(complete it with MPI_Wait/MPI_Test first)")

    def start(self) -> "Request":
        self._check_startable()
        self._error = None
        self.status.error = 0
        self._complete = False
        self._active = True
        try:
            self._inner_req = self._persistent_start()
        except MPIError as e:
            # the START failed: the REQUEST completes carrying the error
            # (req_ft.c), so a waitall over a batch surfaces it
            self.fail(e)
        return self

    @staticmethod
    def completed(result: Any = None, status: Optional[Status] = None):
        return Request(result=result, status=status)


# -- generalized requests (MPI_Grequest_start) -----------------------------
class Grequest(Request):
    def __init__(self, query_fn=None, free_fn=None, cancel_fn=None):
        super().__init__()
        self._complete = False
        self._q, self._f, self._c = query_fn, free_fn, cancel_fn

    def complete(self, result: Any = None) -> None:     # MPI_Grequest_complete
        self._result = result
        self._complete = True
        if self._q:
            self._q(self.status)

    def test(self):
        return (True, self.status) if self._complete else (False, None)

    def wait(self):
        while not self._complete:
            time.sleep(0)            # yield; completion is external
        return self.status

    def cancel(self):
        if self._c:
            self._c(self._complete)


# -- wait/test families (request.h:311-430) --------------------------------
def waitall(requests: Sequence[Request]) -> List[Status]:
    return [r.wait() for r in requests]


def startall(requests: Sequence[Request]) -> Sequence[Request]:
    """MPI_Startall. Persistent COLLECTIVES on the same communicator
    coalesce: bucketable ones enqueue into the comm's BucketFuser and
    flush once at the startall boundary (``coll/persistent``).
    Everything else starts singly, in order."""
    from ompi_tpu_torch.coll import persistent as _pcoll
    return _pcoll.startall(requests)


UNDEFINED = -32766


def waitany(requests: Sequence[Request]) -> Tuple[int, Optional[Status]]:
    if not requests:
        return UNDEFINED, None       # MPI: empty list returns immediately
    while True:
        for i, r in enumerate(requests):
            ok, st = r.test()
            if ok:
                return i, st
        time.sleep(0)


def waitsome(requests: Sequence[Request]) -> Tuple[List[int], List[Status]]:
    if not requests:
        return [], []
    while True:
        idx = [i for i, r in enumerate(requests) if r.test()[0]]
        if idx:
            return idx, [requests[i].status for i in idx]
        time.sleep(0)


def testall(requests: Sequence[Request]) -> Tuple[bool, Optional[List[Status]]]:
    if all(r.test()[0] for r in requests):
        return True, [r.status for r in requests]
    return False, None


def testany(requests: Sequence[Request]) -> Tuple[bool, int, Optional[Status]]:
    if not requests:
        return True, UNDEFINED, None
    for i, r in enumerate(requests):
        ok, st = r.test()
        if ok:
            return True, i, st
    return False, -1, None


def testsome(requests: Sequence[Request]) -> Tuple[List[int], List[Status]]:
    idx = [i for i, r in enumerate(requests) if r.test()[0]]
    return idx, [requests[i].status for i in idx]
