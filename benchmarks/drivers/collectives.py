"""Traffic kind ``collectives``: one caller in a closed loop dispatches
the stacked world's collectives ahead, with no synchronisation per call,
cycling through the mix's ``calls`` and, for the rooted ones, over the
roots. The window ends with a ``synchronize``; every call dispatched in
it has then completed.

Sizes follow nccl-tests: ``bytes_per_rank`` is a call's size, the
larger of a rank's send and receive buffers. ``alltoall``,
``reduce_scatter_block`` and ``scatter`` send ``n`` blocks of
``bytes_per_rank / n``; ``allgather`` and ``gather`` send one such block
and receive ``n`` of them.

What is judged is what the timed calls produced: the last call of each
collective in the window, against the plain reference
(``reference/collectives.py``) on the inputs of that call. A traced run
makes its dispatch rounds and its profiled rounds before the window, so
the window's calls are the last."""
from __future__ import annotations

import math
import statistics
import time
from typing import Any, Callable, Dict, List, Tuple

import torch

from benchlib import compare, least_bytes
from benchlib import profile as prof_mod
from benchlib.traffic import Schedule, torch_seed
from reference import collectives as ref

# the send buffer is n blocks of bytes_per_rank / n
BLOCKED = ("alltoall", "reduce_scatter_block", "scatter")
# the send buffer is one block of bytes_per_rank / n
GATHERED = ("allgather", "gather")


def _calls(MPI) -> Dict[str, Callable[[Any, torch.Tensor, int], Any]]:
    return {
        "allreduce": lambda w, x, r: w.allreduce(x, MPI.SUM),
        "allgather": lambda w, x, r: w.allgather(x),
        "alltoall": lambda w, x, r: w.alltoall(x),
        "bcast": lambda w, x, r: w.bcast(x, r),
        "reduce": lambda w, x, r: w.reduce(x, MPI.SUM, r),
        "reduce_scatter_block": lambda w, x, r: w.reduce_scatter_block(
            x, MPI.SUM),
        "gather": lambda w, x, r: w.gather(x, r),
        "scatter": lambda w, x, r: w.scatter(x, r),
    }


class Cell:
    """The world, the inputs of one seed, and the loop over the calls."""

    def __init__(self, cfg: Dict[str, Any], mix: Dict[str, Any], device):
        import ompi_tpu_torch as MPI
        self.MPI = MPI
        self.cfg, self.mix = cfg, mix
        self.device = torch.device(device)
        self.n = int(cfg["ranks"])
        if not MPI.Initialized():
            MPI.Init(devices=[self.device] * self.n)
        self.w = MPI.get_comm_world()
        if self.w.size != self.n:
            raise RuntimeError(f"the world has {self.w.size} ranks, the "
                               f"configuration {self.n}")
        self.fns = _calls(MPI)
        self.names = list(mix["calls"])
        self.b = int(mix["bytes_per_rank"])
        self.elems = self.b // 4
        self.k = int(mix.get("marked_elements", 1))
        self.last: Dict[str, Tuple[Any, int]] = {}

    def load(self, seed: int) -> None:
        """Every call's input from the seed, made on the device in one
        call."""
        n, e = self.n, self.elems
        self.inputs, self.last = {}, {}
        self.sched = Schedule(self.mix, n, seed)
        g = torch.Generator(device=self.device)
        g.manual_seed(torch_seed(seed))
        shapes = [(n, n, e // n) if name in BLOCKED
                  else (n, e // n) if name in GATHERED else (n, e)
                  for name in self.names]
        sizes = [math.prod(s) for s in shapes]
        flat = torch.randn(sum(sizes), generator=g, device=self.device,
                           dtype=torch.float32)
        for name, shape, x in zip(self.names, shapes, flat.split(sizes)):
            self.inputs[name] = x.view(shape)

    def one(self, i: int) -> None:
        """Call ``i``: mark its input, dispatch it, keep its output."""
        name, root = self.sched.call(i)
        x = self.inputs[name]
        x.view(self.n, -1)[:, :self.k].fill_(self.sched.mark(i))
        self.last[name] = (self.fns[name](self.w, x, root), root)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        """Every (collective, root) pair the window will call."""
        for i in range(int(self.mix.get("warmup_rounds", 1))
                       * len(self.names) * self.n):
            self.one(i)
        self.sync()

    def window(self, seconds: float, timed: bool) -> Dict[str, Any]:
        """The measured window: calls until ``seconds`` have passed, then
        one synchronize. ``timed`` adds CUDA events around each call (the
        traced run)."""
        rec: Dict[str, Any] = {"events": [], "funcs": [], "failed": 0,
                               "errors": []}
        cuda = timed and self.device.type == "cuda"
        i = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            if cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            try:
                self.one(i)
            except self.MPI.MPIError as err:
                rec["failed"] += 1
                rec["errors"].append(repr(err))
            if cuda:
                e1.record()
                rec["events"].append((e0, e1))
                rec["funcs"].append(self.sched.call(i)[0])
            i += 1
            if time.perf_counter() >= deadline:
                break
        self.sync()
        rec["window_s"] = time.perf_counter() - t0
        rec["calls"] = i
        return rec

    def dispatch(self) -> List[Tuple[str, float]]:
        """(collective, host seconds from the call to its return, no sync
        inside) over ``dispatch_rounds`` rounds, with the device's queue
        drained before each call: in the window the queue is full and a
        call's return waits for the device, so there it reads the
        device's pace and not the host's path."""
        out: List[Tuple[str, float]] = []
        for i in range(int(self.mix.get("dispatch_rounds", 1))
                       * len(self.names)):
            name, root = self.sched.call(i)
            x = self.inputs[name]
            x.view(self.n, -1)[:, :self.k].fill_(self.sched.mark(i))
            self.sync()
            d0 = time.perf_counter()
            self.last[name] = (self.fns[name](self.w, x, root), root)
            out.append((name, time.perf_counter() - d0))
        self.sync()
        return out

    def traced(self) -> Dict[str, Any]:
        """``profile_rounds`` rounds under the profiler, each call and
        mark under a label of its own."""
        from torch.profiler import record_function
        rounds = int(self.mix.get("profile_rounds", 1))

        def work():
            for i in range(rounds * len(self.names)):
                name, root = self.sched.call(i)
                x = self.inputs[name]
                with record_function("bench.mark"):
                    x.view(self.n, -1)[:, :self.k].fill_(self.sched.mark(i))
                with record_function(f"bench.coll.{name}"):
                    self.last[name] = (self.fns[name](self.w, x, root), root)
        return prof_mod.trace(work)

    def outputs(self) -> Dict[str, Tuple[Any, int]]:
        """What is judged: each collective's last output and root."""
        return self.last

    def checks(self, outputs: Dict[str, Tuple[Any, int]]
               ) -> List[compare.Check]:
        """Each collective's last output against the reference on the
        input of that call (the input buffers hold its values still)."""
        lim = self.mix["limits"]
        out: List[compare.Check] = []
        for name in self.names:
            if name not in outputs:
                out.append((name, float("inf"), 0.0))
                continue
            got, root = outputs[name]
            want = ref.collective(name, self.inputs[name], root)
            rows = ref.significant(name, root, self.n)
            if name in ref.REDUCTIONS:
                v = compare.rel_gap(got[rows], want[rows])
                out.append((name, v, float(lim["reduction_rel_gap"])))
            else:
                v = compare.max_abs(got[rows], want[rows])
                out.append((name, v, float(lim["movement_max_abs"])))
        return out

    def control(self) -> Dict[str, Tuple[Any, int]]:
        """The control: the reference in bfloat16 put in the program's
        place, on the last inputs and roots of the outputs it replaces."""
        return {name: (ref.collective(name, self.inputs[name], root,
                                      torch.bfloat16), root)
                for name, (_, root) in self.last.items()}

    def least_bytes(self, name: str) -> int:
        return least_bytes.total(name, self.n, self.b)


def run(cfg, mix, seed, seconds, trace, device, t_start) -> Dict[str, Any]:
    t = [time.perf_counter()]
    cell = Cell(cfg, mix, device)
    t.append(time.perf_counter())
    cell.load(seed)
    t.append(time.perf_counter())
    cell.warm()
    t.append(time.perf_counter())
    setup_s = t[-1] - t_start
    parts = {"imports": t[0] - t_start, "init": t[1] - t[0],
             "inputs": t[2] - t[1], "warm": t[3] - t[2]}
    pre: Dict[str, Any] = {}
    if trace:
        dispatch = cell.dispatch()
        pre["dispatch_s"] = [s for _, s in dispatch]
        by_call = {f: statistics.median(s for g, s in dispatch if g == f)
                   for f in cell.names}
        pre["notes"] = ["dispatch median us: " + ", ".join(
            f"{f} {s * 1e6:.1f}" for f, s in by_call.items())]
        pre["profile"] = cell.traced()
    rec = cell.window(seconds, timed=bool(trace))
    rec.update(pre)
    rec.update(kind="collectives", setup_s=setup_s, setup_parts=parts,
               payload_bytes=cell.b, attempted=rec["calls"])
    if trace:
        rec["call_device_s"] = [e0.elapsed_time(e1) * 1e-3
                                for e0, e1 in rec.pop("events")]
        rec["call_least_bytes"] = [cell.least_bytes(f) for f in rec["funcs"]]
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(cell.device)
                                if cell.device.type == "cuda" else 0)
    rec["checks"] = cell.checks(cell.outputs())
    return rec
