"""Traffic kind ``grad_sync``: data-parallel gradient averaging through
the port's ``models/transformer.BucketedGradSync`` (copy-in, ``Startall``
over persistent allreduce plans, mean). One step hands in the step's
gradients and synchronises; steps run back to back in a closed loop.

The gradients are float32, one flat buffer made on the device from the
seed; each tensor is a contiguous ``(ranks, *shape)`` slice of it, in
reverse parameter order, as DDP buckets them. The bucket fuser is on
where the mix says ``bucket``, at the configuration's DDP bucket cap,
``ddp_bucket_cap_mb`` MiB as DDP counts it. Before step ``i`` the
benchmark writes ``mark(i)`` into the first ``marked_elements`` of every
tensor's every row with one ``index_fill_``, so each step's gradients
differ from the last without a pass over them.

What is judged is the last step of the window: every tensor's mean on
every rank, against the plain reference (``reference/grad_sync.py``) on
that step's gradients. A traced run profiles its steps before the
window, so the window's step is the last."""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List

import numpy as np
import torch

from benchlib import compare, least_bytes, spec
from benchlib import profile as prof_mod
from benchlib.traffic import Schedule, torch_seed
from reference import grad_sync as ref


class Cell:
    def __init__(self, cfg: Dict[str, Any], mix: Dict[str, Any], device):
        import ompi_tpu_torch as MPI
        from ompi_tpu_torch.coll import persistent
        from ompi_tpu_torch.mca import var
        self.MPI, self.persistent = MPI, persistent
        self.cfg, self.mix = cfg, mix
        self.device = torch.device(device)
        self.n = int(cfg["dp_world"])
        if not MPI.Initialized():
            MPI.Init(devices=[self.device] * self.n)
        self.w = MPI.get_comm_world()
        var.var_set("mpi_base_bucket", bool(mix["bucket"]))
        var.var_set("mpi_base_bucket_bytes",
                    int(cfg["ddp_bucket_cap_mb"] * 1024 * 1024))
        named = spec.model(cfg["model_type"]).shapes(cfg)[::-1]
        self.names = [nm for nm, _ in named]
        self.shapes = [s for _, s in named]
        self.numels = [math.prod(s) for s in self.shapes]
        self.per_rank_bytes = 4 * sum(self.numels)
        self.k = int(mix.get("marked_elements", 1))
        self.sync_obj = None
        self.out: List[torch.Tensor] = []

    def load(self, seed: int) -> None:
        """The gradients of every rank, in one call on the device, and the
        index of the elements each step marks."""
        n = self.n
        self.flat, self.leaves, self.out = None, [], []
        self.sched = Schedule(self.mix, n, seed)
        g = torch.Generator(device=self.device)
        g.manual_seed(torch_seed(seed))
        self.flat = torch.randn(n * sum(self.numels), generator=g,
                                device=self.device, dtype=torch.float32)
        self.leaves, marks, off = [], [], 0
        for shape, m in zip(self.shapes, self.numels):
            leaf = self.flat[n * off:n * (off + m)]
            self.leaves.append(leaf.view(n, *shape))
            k = min(self.k, m)
            marks.append((n * off + np.arange(n)[:, None] * m
                          + np.arange(k)[None, :]).reshape(-1))
            off += m
        self.mark_idx = torch.as_tensor(np.concatenate(marks),
                                        device=self.device)
        self.out = []
        if self.sync_obj is None:
            from ompi_tpu_torch.models.transformer import BucketedGradSync
            self.sync_obj = BucketedGradSync(self.w, self.leaves)

    def step(self, i: int) -> None:
        self.flat.index_fill_(0, self.mark_idx, self.sched.mark(i))
        self.out = []
        self.out = self.sync_obj(self.leaves)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        for i in range(int(self.mix.get("warmup_steps", 1))):
            self.step(i)
            self.sync()

    def flushes(self) -> int:
        return int(self.persistent.counters()["coll_bucket_flushes"])

    def window(self, seconds: float, timed: bool = False) -> Dict[str, Any]:
        """Steps until ``seconds`` have passed. A step is timed on the host
        clock from handing in the gradients to the synchronised result;
        ``call_s`` is the part up to ``__call__``'s return. Every run
        keeps both, so ``timed`` changes nothing here."""
        step_s: List[float] = []
        call_s: List[float] = []
        f0 = self.flushes()
        i = 0
        t0 = time.perf_counter()
        while True:
            self.flat.index_fill_(0, self.mark_idx, self.sched.mark(i))
            ts = time.perf_counter()
            self.out = []
            self.out = self.sync_obj(self.leaves)
            tc = time.perf_counter()
            self.sync()
            te = time.perf_counter()
            step_s.append(te - ts)
            call_s.append(tc - ts)
            i += 1
            if te - t0 >= seconds:
                break
        return {"window_s": te - t0, "steps": i, "step_s": step_s,
                "call_s": call_s, "flushes": self.flushes() - f0}

    def traced(self) -> Dict[str, Any]:
        from torch.profiler import record_function
        steps = int(self.mix.get("profile_steps", 1))

        def work():
            for i in range(steps):
                with record_function("bench.mark"):
                    self.flat.index_fill_(0, self.mark_idx,
                                          self.sched.mark(i))
                self.out = []
                with record_function("bench.ddp.call"):
                    self.out = self.sync_obj(self.leaves)
                with record_function("bench.ddp.sync"):
                    self.sync()
        return prof_mod.trace(work)

    def outputs(self) -> List[torch.Tensor]:
        """What is judged: the last step's result."""
        return self.out

    def free_program(self) -> None:
        """Drop the program's state (staging, plans, results held by its
        requests); the last step's outputs stay, to be judged."""
        self.sync_obj = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def checks(self, outputs: List[torch.Tensor]) -> List[compare.Check]:
        """Every tensor's mean on every rank against the reference on the
        gradients of the step that produced it: the worst tensor."""
        worst, where = 0.0, ""
        if len(outputs) != len(self.leaves):
            worst, where = float("inf"), "missing outputs"
        for name, got, g in zip(self.names, outputs, self.leaves):
            v = compare.rel_gap(got, ref.mean(g))
            if not v <= worst:
                worst, where = v, name
        self.worst_tensor = where
        return [("mean_rel_gap", worst,
                 float(self.mix["limits"]["mean_rel_gap"]))]

    def control(self) -> List[torch.Tensor]:
        """The reference in bfloat16 in the program's place."""
        return [ref.mean(g, torch.bfloat16) for g in self.leaves]


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
        pre.update(profile=cell.traced(),
                   profile_steps=int(mix.get("profile_steps", 1)))
    rec = cell.window(seconds)
    rec.update(pre)
    rec.update(kind="grad_sync", setup_s=setup_s, setup_parts=parts,
               attempted=rec["steps"], ranks=cell.n, failed=0,
               grad_bytes=cell.n * cell.per_rank_bytes)
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(cell.device)
                                if cell.device.type == "cuda" else 0)
    cell.free_program()
    rec["checks"] = cell.checks(cell.outputs())
    rec["worst_tensor"] = cell.worst_tensor
    return rec
