#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ompi_tpu_torch``) on one NVIDIA
card: the quickest proof that the port still builds, runs and agrees
with itself on the GPU.

    python3 chip_smoke.py

Phases, one or more lines each:

1. device     — the card (``nvidia-smi`` name and power limit), torch and
                CUDA versions.
2. build      — every CUDA kernel of the port, built with ``nvcc`` from
                ``ompi_tpu_torch/csrc`` (one process per source, in
                parallel) into the git-ignored build directory.
3. kernels    — each kernel's wrapper against its plain torch version on
                the card, at the shapes the main path gives it, at larger,
                ragged and ring-block ones, and at edge shapes that reach
                every compiled instantiation; max abs error and the share
                of the tolerance it uses. Per timed shape and mask mode:
                device time (median of CUDA-event timings), the plain
                version's time, the least time the card could take
                (``bound``, from ``fold_work``), the all-scores fp32 bound, the
                launch floor, and SDPA on 4-D views as the library's
                yardstick (modes 0 and 1, fresh accumulators).
4. collectives — ``Init(devices=[cuda:0] * 8)`` and the Standard journey
                on 32 MB fp32 per rank (256 MB stacked), every result
                checked against numpy on a host copy.
5. flagship   — ``entry()``'s forward under ``torch.no_grad()`` at its
                batch (2) and at batch 64, through the flash-fold kernel
                (its launch count read around these runs), against the
                same forward through the plain fold.
6. train      — ``dryrun_multichip(8)`` on the card (the JAX dryrun's
                pp=2 x dp=1 x tp=2 x sp=2 step, dp=2 against dp=1, Ulysses
                against dense attention) and the same ``_run_flagship``
                on the CPU, whose losses must match the card's; the
                combined step at the flagship's full width (float32,
                MoE), with replicated leaves checked across ranks after
                each step; the dense ``sgd_train_step`` on dp=2 x tp=2 x
                sp=2 against the single-device step. Step times (host
                clock), peak memory, and no kernel launch in training.
7. nonblocking — on the same 8-rank world: every ``i*`` entry at 32 MB
                and at 37 elements per rank (the ``coll/nbc`` fused round
                and its ring/binomial schedules) against its blocking
                counterpart; persistent plans started 10 times over a
                buffer changed in place; ``Startall`` over the flagship's
                gradient-shaped leaves with bucket fusion on and off; and
                the DDP train step at the flagship's full width on dp=8
                (``BucketedGradSync``, bucket on and off) against the
                in-graph dp pmean step. Host and device times, device
                busy share, fused flushes per step, peak memory, and no
                kernel launch in training.
8. algorithms — every algorithm schedule of ``coll/torch`` forced through
                its ``coll_torch_<func>_algorithm`` var: at 37 elements
                per rank on the 8-rank world and on split
                sub-communicators of sizes 3, 5 and 6, each against the
                direct lowering on the card, bit for bit against the same
                schedule on the CPU port where it combines with ``op.fn``
                alone, and what ran against the reference's demotion
                rules; then at 32 MB per rank on the 8-rank world, each
                checked against the direct lowering and timed (device ms,
                share of HBM, host µs per dispatch). Phase 4 prints what
                ``auto`` picked beside each of its times.
9. compression — on the same world: each real codec's torch half at 32
                MB on the card against the CPU, bit for bit, with
                poisoned blocks, within ``error_bound``; allreduce SUM,
                allgather and reduce_scatter_block on a communicator
                dup'ed with ``mpi_base_compress`` on, per codec (int8,
                fp8, null) at 4 and 32 MB per rank, against float64
                numpy within the reference's envelopes, rows identical,
                bit for bit against the CPU port, with the wire ratio
                from the pvars, device ms against the uncompressed
                schedules and host µs per dispatch; the gates (var off,
                MAX, int32, under the floor: bit-identical, no byte
                counted); ``allreduce_bind``, a compressed plan and a
                fused ``Startall`` bucket; the DDP step with compressed
                buckets against the uncompressed one; the v- and
                root-form collectives with ragged counts against numpy.
10. ptp_topo_datatype — on the same world: a sendrecv ring of eight 32 MB
                messages (receives posted first, then sends first), each
                unchanged after its sender wrote over the buffer, bit for
                bit against numpy and the CPU port; ``ssend`` against a
                posted ``irecv``; partitioned pt2pt with 16 x 2 MB
                partitions; host µs of an 8 B send+recv pair and of an
                ANY_SOURCE/ANY_TAG match with 256 messages queued. A vector
                and a subarray type on a (4096, 2048) fp32 matrix per rank:
                pack/unpack, the fused in-place ``allreduce_dtype`` SUM
                against the unfused ``_wire`` chain and a contiguous
                allreduce of the same bytes (holes bit for bit, the sum
                against float64 numpy, MAX bit for bit against the CPU
                port), ``bcast`` with the vector type, ``reduce_local``,
                ``alltoallw``, an overlapping type's keep-last unpack, and
                the convertor on every predefined type. A 2x4 cart, a
                dist-graph with duplicate edges and a reordered graph:
                ``neighbor_allgather``/``alltoall`` and their ragged v-forms
                against the host path and the CPU port, bit for bit, with
                device ms and share of HBM. ``split_type``, ``create`` and
                attributes through ``dup``/``free``.
11. perrank   — ``ompi_tpu_torch/tools/mpirun.py --per-rank -n 8`` runs this
                script as its rank program (``--perrank-rank``): eight rank
                processes, each bound to ``cuda:0``. On the shared-buffer
                device tier (CUDA IPC slots) with 32 MB fp32 per rank:
                allreduce SUM/MAX/PROD and int32 SUM, MAXLOC on 9 and 2**20
                (value, index) records, bcast, allgather, alltoall, and
                reduce_scatter_block through the host fold;
                numpy staged onto the device tier above a set
                ``coll_tuned_stage_min_bytes``; host-tier numpy collectives
                at 37 elements; a devxfer ring of eight 32 MB CUDA messages,
                each unchanged after its sender overwrote its buffer; 8 B
                send+recv and a wildcard match; ``split`` into two comms of
                4 with an allreduce on each. Every rank checks every result
                against numpy and that every device result is a CUDA tensor
                on ``cuda:0``; rank 0 prints call ms (a CUDA-event span
                that includes the host fences), bytes over that span as a
                share of HBM, and host µs per 8 B round trip and per
                dispatch. Any rank failing, or the job passing its timeout,
                fails the phase.
12. dataplane — the tuned component on the single-controller 8-rank
                world: a numpy (8, 1 MiB fp32) stack returns numpy equal to
                coll/torch on the same tensor, staged and on the host (ms
                of each). Then the per-rank large-message data plane, 8
                rank processes on ``cuda:0`` (``--dataplane-rank``; rails 2,
                two shared slots per pool): the staging probe rank 0 ran on
                the card at Init, adopted alike by every rank; with the
                host tier forced, the pipelined ring allreduce (SUM f32,
                MAX f32 and i32) and the chain bcast on 32 MB per rank
                against numpy, the same bits on every rank, both rails
                carrying bytes at rails 2 and only rail 0 at rails 1;
                the in-segment fold (``mpi_base_shm_zerocopy``) against
                the ring (MAX bit for bit, SUM rtol 1e-5) and
                pt2pt adoption counted by the shmseg pvars; a 32 MB CUDA
                tensor sent past devxfer's limit, staged segment by
                segment through ``SegmentStager`` and unchanged after its
                sender overwrote it, against the devxfer ring in the same
                job; compressed host hops (int8_block, fp8_block) on the
                direct allreduce (comms of 4), the reduce and the bcast
                within the reference's envelopes, the same bits on every
                rank; persistent plans (device tier, staged numpy on
                pinned pages, 8 B small combine) bit for bit against their
                one-shot calls and a 14-plan bucketed ``Startall``. The
                ring and chain are timed on 1 and 2 rails in turns
                (``mpi_base_btl_rails`` is read per segment). The job has
                its own 300 s launcher limit.
                ``python3 chip_smoke.py --perrank`` runs phases 1, 11 and
                12 alone.

Then a JSON line with one record per kernel, the ``nvidia-smi`` line, and
as the last line ``{"ok": true, "device": {...}}``. Any failure raises:
the script exits non-zero and prints no result. Without a CUDA device it
exits non-zero at once.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend

import ompi_tpu_torch as MPI
from ompi_tpu_torch import accelerator
from ompi_tpu_torch import entry as E
from ompi_tpu_torch.coll import decision, persistent
from ompi_tpu_torch.coll.nbc import ScheduleRequest
from ompi_tpu_torch.coll.torch_ import ALGORITHMS
from ompi_tpu_torch.compress.codecs import get_codec
from ompi_tpu_torch.core import convertor
from ompi_tpu_torch.entry import CONFIG, entry
from ompi_tpu_torch.models import transformer as T
from ompi_tpu_torch.ops import _build
from ompi_tpu_torch.mca import pvar, var
from ompi_tpu_torch.ops import flash_attention as FA
from ompi_tpu_torch.parallel import InGraphComm, Mesh, P
from ompi_tpu_torch.parallel.mesh import tree_leaves, tree_map

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W): fp32 outside
# the tensor cores, TF32 on them (3xTF32 runs three TF32 products for each
# fp32 one), and HBM3 bandwidth.
FP32_FLOPS = 67e12
TF32X3_FLOPS = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12

N_RANKS = 8
LOCAL_ELEMS = 8 << 20          # 32 MB of fp32 per rank, 256 MB stacked


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def device_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Median device time of one ``fn()`` in ms, from CUDA events. A
    sleep kernel queued before each start event keeps the queue full, so
    the events time the device's work and not the host's launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Median wall time of one ``fn()`` in ms, synchronised."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# -- phase 1 -----------------------------------------------------------
def phase_device() -> tuple:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind} | nvidia-smi: {smi} | torch {torch.__version__}"
          f" | CUDA {torch.version.cuda} | count "
          f"{torch.cuda.device_count()}")
    # a float32 reference is full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi, kind


# -- phase 2 -----------------------------------------------------------
def _ptxas_summary(log: str) -> list:
    """'kernel<DP>: R registers, S B spilled' for each kernel that
    ``nvcc -Xptxas=-v`` compiled."""
    out, name, spill = [], "?", "0"
    for ln in log.splitlines():
        entry_fn = re.search(r"Compiling entry function '(\S+)'", ln)
        if entry_fn:
            m = re.search(r"([a-z_]+_kernel)(?:ILi(\d+)E)?", entry_fn.group(1))
            name = (m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
                    if m else entry_fn.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(f"{name}: {m.group(1)} registers, {spill} B spilled")
    return out


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build_all(verbose=True)
    for name, rec in built.items():
        phase("build", f"{name}: {rec['seconds']:.2f} s "
              f"{' | '.join(_ptxas_summary(rec['log']))}")
    phase("build", f"all kernels built in {time.perf_counter() - t0:.2f} s")


# -- phase 3 -----------------------------------------------------------
def _fold_inputs(BH, Sq, Sk, D, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(s, device="cuda", generator=g)  # noqa: E731
    q = rnd(BH, Sq, D) * D ** -0.5
    k, v = rnd(BH, Sk, D), rnd(BH, Sk, D)
    fresh = (torch.zeros(BH, Sq, D, device="cuda"),
             torch.full((BH, Sq), -1e30, device="cuda"),
             torch.zeros(BH, Sq, device="cuda"))
    return q, k, v, fresh


def _err_share(got, want, atol, rtol, what):
    """Max abs error and the largest share of the tolerance it uses:
    max of err / (atol + rtol * |want|); the check fails above 1."""
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    err = (got - want).abs()
    share = (err / (atol + rtol * want.abs())).max().item()
    check(share <= 1.0, f"{what}: max abs err {err.max().item():.3g} "
          f"beyond atol {atol} rtol {rtol}")
    return err.max().item(), share


def _fold_bound(BH, Sq, Sk, D, mode, fresh_heads=0):
    """The least time the card could take for the fold: the larger of the
    flops the mask allows at the 3xTF32 rate and the bytes the mode must
    move at the HBM rate (``fold_work``); and the all-scores bound, every
    score counted at the fp32 rate, as the first CUDA fold was measured."""
    flops, nbytes = FA.fold_work(BH, Sq, Sk, D, mode, fresh_heads)
    t_ops, t_bytes = flops / TF32X3_FLOPS, nbytes / HBM_BYTES_PER_S
    fp32 = max(4 * BH * Sq * Sk * D / FP32_FLOPS,
               4 * BH * (3 * Sq * D + 2 * Sk * D + 4 * Sq) / HBM_BYTES_PER_S)
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", fp32 * 1e3)


def _instantiation(q, k, v):
    """(padded head width, copy width) the kernel picks for these inputs,
    as flash_fold_f32 picks them."""
    D = q.shape[-1]
    dp = next(w for w in (16, 32, 64, 128) if D <= w)
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    return dp, 16 if D % 4 == 0 and aligned else 4


def _sdpa(q, k, v, mode):
    """The library's causal/full attention on 4-D views of the same fp32
    tensors: o / l, not (o, m, l)."""
    q4, k4, v4 = q.unsqueeze(0), k.unsqueeze(0), v.unsqueeze(0)
    return F.scaled_dot_product_attention(q4, k4, v4, scale=1.0,
                                          is_causal=mode == 1)[0]


def _sdpa_backend(q, k, v, mode):
    q4, k4, v4 = q.unsqueeze(0), k.unsqueeze(0), v.unsqueeze(0)
    return SDPBackend(torch._fused_sdp_choice(
        q4, k4, v4, None, 0.0, mode == 1, scale=1.0)).name


# (name, BH, Sq, Sk, D, checks, timed): a check "a>b" folds mode a with
# the plain fold first, then holds mode b of the kernel against the plain
# fold on that; "fresh2" is mode 2 on fresh accumulators. Timed modes are
# timed on the accumulators of their check.
_b = 2  # entry()'s batch
FOLD_SHAPES = [
    ("entry", _b * CONFIG.n_heads, CONFIG.seq, CONFIG.seq, CONFIG.d_head,
     ["0", "1"], ["0", "1"]),
    ("batch64", 64 * CONFIG.n_heads, CONFIG.seq, CONFIG.seq, CONFIG.d_head,
     ["0", "1"], ["0", "1"]),
    ("aligned", 32, 1024, 1024, 128, ["0", "1", "1>2", "1>0"],
     ["0", "1", "1>2"]),
    ("ragged", 3, 100, 260, 40, ["0", "1", "fresh2"], ["0", "1"]),
    ("ring", 32, 256, 256, 64, ["0", "1", "1>2"], ["0", "1", "1>2"]),
    # edge shapes: every head-width instantiation with both copy widths
    ("d24", 2, 70, 90, 24, ["0", "1"], []),
    ("d30", 2, 70, 90, 30, ["0", "1"], []),
    ("d1", 2, 33, 47, 1, ["0", "1"], []),
    ("d16_offset", 2, 64, 64, 16, ["0", "1"], []),
    ("d37", 2, 65, 129, 37, ["0", "1"], []),
    ("d127", 2, 80, 100, 127, ["0", "1"], []),
    ("sq1", 4, 1, 200, 128, ["0", "1"], []),
    ("sk_lt_sq", 3, 130, 20, 32, ["0", "1", "1>2"], []),
]


def _edge_inputs(name, BH, Sq, Sk, D, seed):
    q, k, v, fresh = _fold_inputs(BH, Sq, Sk, D, seed)
    if name.endswith("_offset"):
        # contiguous tensors one float past a 16-byte boundary: the
        # kernel takes its 4-byte copies
        def off(t):
            buf = torch.empty(t.numel() + 1, device="cuda")
            out = buf[1:].view(t.shape)
            out.copy_(t)
            return out
        q, k, v = off(q), off(k), off(v)
    return q, k, v, fresh


def phase_kernels() -> tuple:
    """flash_fold against _fold_torch. Tolerances: o atol = rtol = 1e-4,
    m and l 1e-5 — the kernel sums in another order (online over 32-row
    K tiles, 3xTF32 products) than the one-shot plain fold."""
    floor_x = torch.zeros(1, device="cuda")
    launch_floor_ms = device_ms(lambda: floor_x.add_(1.0))
    phase("kernels", f"launch floor (one 1-element torch op, device time): "
          f"{launch_floor_ms:.4f} ms")
    out, checked, covered = {}, [], set()
    for si, (name, BH, Sq, Sk, D, checks, timed) in enumerate(FOLD_SHAPES):
        q, k, v, fresh = _edge_inputs(name, BH, Sq, Sk, D, seed=100 + si)
        inst = _instantiation(q, k, v)
        covered.add(inst)
        accs = {}
        for check_spec in checks:
            spec = check_spec
            acc, label = fresh, f"mode {spec}"
            if ">" in spec:            # a first fold (plain), then this one
                first, spec = spec.split(">")
                acc = FA._fold_torch(q, k, v, *fresh, int(first))
                label = f"mode {spec} after mode {first}"
            elif spec == "fresh2":
                label = "mode 2 on fresh accumulators"
            mode = 2 if spec == "fresh2" else int(spec)
            got = FA.flash_block_update(q, k, v, *acc, mode)
            want = FA._fold_torch(q, k, v, *acc, mode)
            torch.cuda.synchronize()
            e = [_err_share(got[0], want[0], 1e-4, 1e-4, f"{name} {label} o"),
                 _err_share(got[1], want[1], 1e-5, 1e-5, f"{name} {label} m"),
                 _err_share(got[2], want[2], 1e-5, 1e-5, f"{name} {label} l")]
            if spec == "fresh2":
                check(bool((got[2] == float(Sk)).all()),
                      f"{name}: mode 2 on fresh accumulators must give "
                      f"l == Sk")
            chk = {"shape": [BH, Sq, Sk, D], "mode": check_spec,
                   "dp": inst[0], "copy_bytes": inst[1],
                   "err": dict(zip("oml", (x[0] for x in e))),
                   "tol_share": dict(zip("oml", (x[1] for x in e)))}
            errs = (f"max abs err o {e[0][0]:.3g} m {e[1][0]:.3g} l "
                    f"{e[2][0]:.3g}; tolerance used o {e[0][1]:.1%} m "
                    f"{e[1][1]:.1%} l {e[2][1]:.1%}")
            checked.append(chk)
            accs[check_spec] = (acc, mode, got, chk, errs)
            phase("kernels", f"flash_fold {name} (BH={BH}, Sq={Sq}, Sk={Sk},"
                  f" D={D}; DP={inst[0]}, {inst[1]}-byte copies) {label}: "
                  f"{errs}")
        for spec in timed:
            acc, mode, got, chk, errs = accs[spec]
            fresh_heads = int((acc[1] <= -1e30).any(dim=1).sum())
            ms = device_ms(lambda: FA.flash_block_update(q, k, v, *acc, mode))
            plain_ms = device_ms(lambda: FA._fold_torch(q, k, v, *acc, mode))
            bound_ms, bound_by, fp32_ms = _fold_bound(BH, Sq, Sk, D, mode,
                                                      fresh_heads)
            rec = {**chk, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "bound_fp32_ms": fp32_ms,
                   "launch_floor_ms": launch_floor_ms,
                   "max_abs_err": max(chk["err"].values()),
                   "library_ms": None, "library_backend": None}
            lib = ""
            if spec in ("0", "1"):     # fresh accumulators: the main path's use
                rec["library_backend"] = _sdpa_backend(q, k, v, mode)
                rec["library_ms"] = device_ms(lambda: _sdpa(q, k, v, mode))
                diff = (_sdpa(q, k, v, mode) - got[0] / got[2][..., None]
                        ).abs().max().item()
                lib = (f", library {rec['library_ms']:.4f} ms (SDPA, "
                       f"{rec['library_backend']}, 4-D views; computes o/l, "
                       f"not (o, m, l); max |SDPA - o/l| {diff:.3g})")
            out[(name, spec)] = rec
            phase("kernels", f"flash_fold {name} mode {spec}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.6f} ms ({bound_by}), kernel/bound "
                  f"{ms / bound_ms:.1f}x, bound_fp32 {fp32_ms:.6f} ms, "
                  f"launch floor {launch_floor_ms:.4f} ms; {errs}{lib}")
    want = {(dp, w) for dp in (16, 32, 64, 128) for w in (16, 4)}
    check(covered == want, f"instantiations checked {sorted(covered)}, "
          f"want {sorted(want)}")
    return out, checked


# -- phase 4 -----------------------------------------------------------
def _close(got, want, rtol, atol, what):
    ok = np.allclose(got, want, rtol=rtol, atol=atol)
    check(ok, f"{what}: max abs err "
          f"{np.max(np.abs(got.astype(np.float64) - want)):.3g}")


def phase_collectives(w) -> None:
    """Float SUM/PROD/scan results: rtol 1e-5 (atol 1e-5 for sums near
    zero) — the device sums 8 rows in another order than numpy. MAX, MIN,
    data movement and int32 are exact."""
    n = w.size
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((n, LOCAL_ELEMS), device="cuda", generator=g)
    y = torch.randn((n, n, LOCAL_ELEMS // n), device="cuda", generator=g)
    xp = 1 + 1e-3 * torch.randn((n, LOCAL_ELEMS), device="cuda", generator=g)
    xi = torch.randint(-1000, 1000, (n, LOCAL_ELEMS), device="cuda",
                       dtype=torch.int32, generator=g)
    xh, yh, xph, xih = (t.cpu().numpy() for t in (x, y, xp, xi))
    local_bytes = LOCAL_ELEMS * 4
    local_mib = local_bytes / 2 ** 20

    def run(name, fn, pick, read=x.numel() * 4):
        """Time ``fn`` and return its result on the host. The rate is the
        least device traffic of the call — the input it must read
        (``read``: the stacked input, or root's row alone) read once and
        the stacked output written once — over its time; all 8 ranks
        share one card's memory. ``auto``'s pick for the call's ``pick``
        = (func, buffer, op, root) stands beside it."""
        func, buf, op, root = pick
        alg = w._coll(func).selected(func, buf, op, root)
        if (func, alg) in (("reduce", "alias"), ("gather", "allgather")):
            to = "allreduce" if func == "reduce" else "allgather"
            alg += f" -> {to} {w._coll(to).selected(to, buf, op)}"
        ms = host_ms(fn)
        res = fn()
        moved = read + res.numel() * res.element_size()
        phase("collectives", f"{name} (auto: {alg}): {ms:.3f} ms for "
              f"{local_mib:.0f} MiB per rank; {moved / 1e6:.0f} MB in+out, "
              f"{moved / ms / 1e6:.1f} GB/s "
              f"({moved / ms / 1e9 / (HBM_BYTES_PER_S / 1e12):.1%} of "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
        return res.cpu().numpy()

    r = run("allreduce SUM f32", lambda: w.allreduce(x, MPI.SUM),
            ("allreduce", x, MPI.SUM, None))
    _close(r, np.broadcast_to(xh.sum(0), xh.shape), 1e-5, 1e-5,
           "allreduce SUM")
    r = run("allreduce MAX f32", lambda: w.allreduce(x, MPI.MAX),
            ("allreduce", x, MPI.MAX, None))
    check(np.array_equal(r, np.broadcast_to(xh.max(0), xh.shape)),
          "allreduce MAX")
    r = run("allreduce PROD f32", lambda: w.allreduce(xp, MPI.PROD),
            ("allreduce", xp, MPI.PROD, None))
    _close(r, np.broadcast_to(xph.prod(0), xph.shape), 1e-5, 0,
           "allreduce PROD")
    r = run("allreduce SUM i32", lambda: w.allreduce(xi, MPI.SUM),
            ("allreduce", xi, MPI.SUM, None))
    check(np.array_equal(r, np.broadcast_to(xih.sum(0, dtype=np.int32),
                                            xih.shape)), "allreduce i32")
    r = run("reduce MIN root 2", lambda: w.reduce(x, MPI.MIN, root=2),
            ("reduce", x, MPI.MIN, 2))
    check(np.array_equal(r[2], xh.min(0)), "reduce MIN")
    r = run("bcast root 3", lambda: w.bcast(x, root=3),
            ("bcast", x, None, 3), read=local_bytes)
    check(np.array_equal(r, np.broadcast_to(xh[3], xh.shape)), "bcast")
    r = run("allgather", lambda: w.allgather(x),
            ("allgather", x, None, None))
    check(r.shape == (n, n, LOCAL_ELEMS), "allgather shape")
    check(all(np.array_equal(r[i], xh) for i in range(n)), "allgather")
    r = run("gather root 1", lambda: w.gather(x, root=1),
            ("gather", x, None, 1))
    check(np.array_equal(r[1], xh), "gather")
    del r
    r = run("scatter root 5", lambda: w.scatter(y, root=5),
            ("scatter", y, None, 5),
            read=local_bytes)
    check(np.array_equal(r, yh[5]), "scatter")
    r = run("alltoall", lambda: w.alltoall(y),
            ("alltoall", y, None, None))
    check(np.array_equal(r, np.swapaxes(yh, 0, 1)), "alltoall")
    r = run("reduce_scatter_block SUM",
            lambda: w.reduce_scatter_block(y, MPI.SUM),
            ("reduce_scatter_block", y, MPI.SUM, None))
    _close(r, yh.sum(0), 1e-5, 1e-5, "reduce_scatter_block")
    r = run("scan SUM", lambda: w.scan(x, MPI.SUM),
            ("scan", x, MPI.SUM, None))
    pre = np.cumsum(xh, axis=0)
    _close(r, pre, 1e-5, 1e-5, "scan")
    r = run("exscan SUM", lambda: w.exscan(x, MPI.SUM),
            ("exscan", x, MPI.SUM, None))
    _close(r[1:], pre[:-1], 1e-5, 1e-5, "exscan")
    check(np.array_equal(r[0], xh[0]), "exscan row 0")
    del r, pre
    phase("collectives", f"barrier (auto: "
          f"{w._coll('barrier').selected('barrier')}): "
          f"{host_ms(w.barrier, iters=20):.4f} ms")

    evens, odds = w.split([i % 2 for i in range(n)])[0:2]
    check(evens.size == n // 2 and odds.size == n // 2, "split sizes")
    sub = evens.allreduce(evens.stack([x[i] for i in range(0, n, 2)]),
                          MPI.SUM).cpu().numpy()
    _close(sub, np.broadcast_to(xh[0::2].sum(0), sub.shape), 1e-5, 1e-5,
           "split allreduce")
    phase("collectives", f"split even/odd: {evens.name} size {evens.size},"
          f" allreduce SUM on it checked")

    w.set_errhandler(MPI.ERRORS_RETURN)
    try:
        w.bcast(x, root=n)
        raise RuntimeError("chip_smoke check failed: bad root accepted")
    except MPI.MPIError as e:
        phase("collectives", f"ERRORS_RETURN bad root raised: {e}")

    small = w.alloc((2,), dtype=torch.float32, fill=1.0)   # 8 B per rank
    before = len(w._subeager)
    calls = 2000
    w.allreduce(small, MPI.SUM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        res = w.allreduce(small, MPI.SUM)
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) / calls * 1e6
    check(len(w._subeager) == before + 1, "8 B allreduce missed _subeager")
    check(bool((res == n).all()), "8 B allreduce value")
    phase("collectives", f"8 B allreduce (8 ranks, _subeager path): "
          f"{us:.2f} us/call")
    w.set_errhandler(MPI.ERRORS_ARE_FATAL)


# -- phase 5 -----------------------------------------------------------
def phase_flagship() -> int:
    fn, (params, tokens) = entry()
    g = torch.Generator(device="cuda").manual_seed(11)
    tokens64 = torch.randint(0, CONFIG.vocab, (64, CONFIG.seq),
                             device="cuda", generator=g)
    L = CONFIG.n_layers

    FA.launches = 0                     # the main path starts here
    with torch.no_grad():
        logits = fn(params, tokens)
        torch.cuda.synchronize()
        check(FA.launches == L, f"{FA.launches} kernel launches in one "
              f"forward, want {L}")
        logits64 = fn(params, tokens64)
        torch.cuda.synchronize()
    launches = FA.launches              # ... and ends here
    check(launches == 2 * L, f"{launches} launches in two forwards")

    # the same forward through the plain fold: with autograd on,
    # attention takes the training path, _fold_torch
    with torch.enable_grad():
        ref = fn(params, tokens).detach()
        ref64 = fn(params, tokens64).detach()
    check(FA.launches == launches, "the plain-fold forward launched")
    for name, got, want, B in (("batch 2", logits, ref, 2),
                               ("batch 64", logits64, ref64, 64)):
        check(tuple(got.shape) == (B, CONFIG.seq, CONFIG.vocab),
              f"{name} logits shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"{name} non-finite logits")
        err = (got - want).abs().max().item()
        check(err <= 2e-2, f"{name} logits vs plain fold: {err:.3g}")
        phase("flagship", f"entry forward {name}: logits {tuple(got.shape)}"
              f" {got.dtype}, max abs err vs plain fold {err:.3g} "
              f"(atol 2e-2, bf16)")
    # an independent formulation of the same attention: dense softmax
    with torch.no_grad():
        dense64 = T.forward(params, tokens64,
                            dataclasses.replace(CONFIG, use_flash=False))
    err = (logits64 - dense64).abs().max().item()
    check(err <= 5e-2, f"batch 64 logits vs dense attention: {err:.3g}")
    phase("flagship", f"entry forward batch 64 against dense softmax "
          f"attention: max abs err {err:.3g} (atol 5e-2: bf16 "
          f"probabilities and outputs)")

    with torch.no_grad():
        for name, tok in (("batch 2", tokens), ("batch 64", tokens64)):
            k_ms = host_ms(lambda: fn(params, tok), iters=20, warmup=3)
            with torch.enable_grad():
                p_ms = host_ms(lambda: fn(params, tok), iters=20, warmup=3)
            phase("flagship", f"forward {name}: {k_ms:.3f} ms with the "
                  f"kernel, {p_ms:.3f} ms with the plain fold (host clock,"
                  f" synchronised)")
    return launches


# -- phase 6 -----------------------------------------------------------
def _device_share(fn, iters: int = 3) -> str:
    """Kernels, device time and the device's busy share of the wall time
    per ``fn()`` call, from ``torch.profiler`` (CUPTI) over ``iters``
    calls after one warm-up; "not measured" when the profiler records no
    device time. The profiler's own host cost lengthens the wall time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / iters
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in dev) / iters
    if dev_us <= 0:
        return "device time not measured (the profiler recorded none)"
    kernels = sum(e.count for e in dev) / iters
    return (f"{kernels:.0f} device ops, {dev_us / 1e3:.3f} ms device time "
            f"in {wall_us / 1e3:.3f} ms wall per step under the profiler: "
            f"device busy {dev_us / wall_us:.1%}, idle "
            f"{1 - dev_us / wall_us:.1%}")


def _losses_close(got, want, what):
    """The JAX dryrun's tolerances: step 1 rtol 1e-4 / atol 1e-5, step 2
    rtol 2e-3 / atol 1e-4."""
    for i, (a, b, rtol, atol) in enumerate(zip(got, want, (1e-4, 2e-3),
                                               (1e-5, 1e-4))):
        check(abs(a - b) <= atol + rtol * abs(b),
              f"{what} step-{i + 1} loss {a} != {b}")


def phase_train(smi: str) -> None:
    """The training path on the card: no kernel launches (the train
    steps need autograd, which the flash kernel lacks), fp32 products."""
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "the train checks assume fp32 products (allow_tf32 is on)")
    dev = torch.device("cuda", 0)
    before = FA.launches

    # (1) the JAX dryrun's step, dp=2 against dp=1 and Ulysses, on the
    # card; the same step on the CPU must give the same losses
    res = E.dryrun_multichip(8)
    tok_dry = np.random.default_rng(0).integers(
        0, E.DRYRUN_CONFIG.vocab, (8, E.DRYRUN_CONFIG.seq + 1))
    cpu = E._run_flagship(2, 1, 2, 2, tok_dry, device="cpu")
    _losses_close(res["dp1"], cpu, "card vs CPU")
    phase("train", f"dryrun losses: card dp=1 {res['dp1']}, dp=2 "
          f"{res['dp2']}, CPU dp=1 {cpu}; Ulysses max abs err "
          f"{res['ulysses_err']:.3g}")
    _, _, p, step = E.flagship_step(2, 1, 2, 2, tok_dry, device=dev)
    dry_ms = host_ms(lambda: step(p), iters=10, warmup=2)

    # (2) the combined step at the flagship's full width, float32, MoE
    cfg = dataclasses.replace(CONFIG, dtype=torch.float32, moe=True,
                              moe_experts=2)
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (8, cfg.seq + 1))
    torch.cuda.reset_peak_memory_stats()
    mesh, specs, p, step = E.flagship_step(2, 1, 2, 2, tok, cfg=cfg,
                                           device=dev)
    for i in range(2):
        p, loss = step(p)
        loss = float(mesh.unshard(loss, P()))
        div = mesh.divergence(p, specs)
        check(np.isfinite(loss), f"full-width step {i + 1}: loss {loss}")
        check(div <= 1e-6, f"full-width step {i + 1}: replicated leaves "
              f"differ by {div:.3g}")
        check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(p)),
              f"full-width step {i + 1}: non-finite params")
        phase("train", f"full-width pp=2 x dp=1 x tp=2 x sp=2 step "
              f"{i + 1}: loss {loss:.6f}, largest divergence of a "
              f"replicated leaf across its ranks {div:.3g} (limit 1e-6)")
    peak = torch.cuda.max_memory_allocated()
    full_ms = host_ms(lambda: step(p), iters=10, warmup=2)

    # (3) the dense step on dp=2 x tp=2 x sp=2 against one device
    cfg_d = dataclasses.replace(cfg, moe=False, moe_experts=0)
    params = T.init_params(cfg_d, torch.Generator().manual_seed(0), dev)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (8, cfg.seq + 1))).to(dev)
    batch = (tok[:, :-1], tok[:, 1:])
    ref_p, ref_loss = T.sgd_train_step(params, batch, cfg_d, 1e-2)
    mesh = Mesh((2, 2, 2), ("dp", "tp", "sp"), dev)
    specs = E._param_specs(params)
    comms = [InGraphComm(a, 2, mesh) for a in ("dp", "tp", "sp")]
    sharded = mesh.shard(params, specs)
    sb = mesh.shard(batch, (P("dp", "sp"),) * 2)
    new_p, loss = T.sgd_train_step(sharded, sb, cfg_d, 1e-2, *comms)
    loss = float(mesh.unshard(loss, P()))
    check(abs(loss - float(ref_loss)) <= 1e-5 * abs(float(ref_loss)),
          f"8-rank dense loss {loss} != single-device {float(ref_loss)}")
    worst = 0.0
    for a, b in zip(tree_leaves(mesh.unshard(new_p, specs)),
                    tree_leaves(ref_p)):
        check(bool(torch.allclose(a, b, rtol=2e-4, atol=2e-6)),
              f"8-rank dense params differ from single-device by "
              f"{(a - b).abs().max().item():.3g}")
        worst = max(worst, (a - b).abs().max().item())
    phase("train", f"dense sgd_train_step dp=2 x tp=2 x sp=2 against one "
          f"device: loss {loss:.6f} vs {float(ref_loss):.6f}, params max "
          f"abs diff {worst:.3g} (loss rtol 1e-5; params rtol 2e-4 atol "
          f"2e-6)")
    one_ms = host_ms(lambda: T.sgd_train_step(params, batch, cfg_d, 1e-2),
                     iters=10, warmup=2)
    eight_ms = host_ms(lambda: T.sgd_train_step(sharded, sb, cfg_d, 1e-2,
                                                *comms), iters=10, warmup=2)

    phase("train", f"full-width MoE step, torch.profiler: "
          f"{_device_share(lambda: step(p))} | {smi}")
    dense = _device_share(lambda: T.sgd_train_step(params, batch, cfg_d,
                                                   1e-2))
    phase("train", f"full-width dense step, one device, torch.profiler: "
          f"{dense} | {smi}")
    launched = FA.launches - before
    check(launched == 0, f"{launched} kernel launches in training")
    for name, ms in (("dryrun pp=2 x dp=1 x tp=2 x sp=2 step", dry_ms),
                     ("full-width pp=2 x dp=1 x tp=2 x sp=2 MoE step",
                      full_ms),
                     ("full-width dense step, one device", one_ms),
                     ("full-width dense step, dp=2 x tp=2 x sp=2", eight_ms)):
        phase("train", f"{name}: {ms:.3f} ms per step (host clock, "
              f"synchronised, median of 10 after 2 warm-ups) | {smi}")
    phase("train", f"full-width MoE step peak memory: {peak} B "
          f"({peak / 2 ** 20:.1f} MiB, torch.cuda.max_memory_allocated) | "
          f"{smi}")
    phase("train", f"flash_fold launches across the train steps: "
          f"{launched} (training runs the plain fold)")


# -- phase 7 -----------------------------------------------------------
SMALL_ELEMS = 37               # per rank: not a multiple of the 8 ranks
SCHEDULE_SLOTS = ("iallreduce", "ibcast", "iallgather", "ibarrier")


def _inputs(n, elems, seed):
    """Float, PROD-safe float, int32 (N, elems) and (N, N, elems // N or
    elems) stacked inputs on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    chunk = elems // n if elems % n == 0 else elems
    return (torch.randn((n, elems), device="cuda", generator=g),
            1 + 1e-3 * torch.randn((n, elems), device="cuda", generator=g),
            torch.randint(-1000, 1000, (n, elems), device="cuda",
                          dtype=torch.int32, generator=g),
            torch.randn((n, n, chunk), device="cuda", generator=g))


def _held(name, got, want, rtol=None, atol=0.0, rows=slice(None)):
    """``got`` against ``want`` on the card: exact, or within rtol/atol."""
    got, want = got[rows], want[rows]
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {tuple(got.shape)} {got.dtype} against "
          f"{tuple(want.shape)} {want.dtype}")
    ok = (torch.equal(got, want) if rtol is None else
          bool(torch.allclose(got, want, rtol=rtol, atol=atol)))
    err = (got.double() - want.double()).abs().max().item()
    check(ok, f"{name}: max abs err {err:.3g} against the blocking call")
    return err


def _i_entries(w, elems, seed) -> str:
    """Every i-entry against its blocking counterpart: float SUM/PROD
    rtol 1e-5 (atol 1e-5 for SUM, whose sums come near zero), the rest
    exact. Returns the largest float error."""
    n = w.size
    x, xp, xi, y = _inputs(n, elems, seed)
    S = MPI.SUM
    cases = [
        ("iallreduce SUM f32", lambda: w.iallreduce(x, S),
         lambda: w.allreduce(x, S), 1e-5, 1e-5, slice(None)),
        ("iallreduce MAX f32", lambda: w.iallreduce(x, MPI.MAX),
         lambda: w.allreduce(x, MPI.MAX), None, 0, slice(None)),
        ("iallreduce PROD f32", lambda: w.iallreduce(xp, MPI.PROD),
         lambda: w.allreduce(xp, MPI.PROD), 1e-5, 0, slice(None)),
        ("iallreduce SUM i32", lambda: w.iallreduce(xi, S),
         lambda: w.allreduce(xi, S), None, 0, slice(None)),
        ("ibcast root 3", lambda: w.ibcast(x, 3), lambda: w.bcast(x, 3),
         None, 0, slice(None)),
        ("ireduce MIN root 2", lambda: w.ireduce(x, MPI.MIN, 2),
         lambda: w.reduce(x, MPI.MIN, 2), None, 0, 2),
        ("iallgather", lambda: w.iallgather(x), lambda: w.allgather(x),
         None, 0, slice(None)),
        ("igather root 1", lambda: w.igather(x, 1), lambda: w.gather(x, 1),
         None, 0, 1),
        ("iscatter root 5", lambda: w.iscatter(y, 5),
         lambda: w.scatter(y, 5), None, 0, slice(None)),
        ("ialltoall", lambda: w.ialltoall(y), lambda: w.alltoall(y),
         None, 0, slice(None)),
        ("ireduce_scatter_block SUM", lambda: w.ireduce_scatter_block(y, S),
         lambda: w.reduce_scatter_block(y, S), 1e-5, 1e-5, slice(None)),
        ("iscan SUM", lambda: w.iscan(x, S), lambda: w.scan(x, S), 1e-5,
         1e-5, slice(None)),
        ("iexscan SUM", lambda: w.iexscan(x, S), lambda: w.exscan(x, S),
         1e-5, 1e-5, slice(1, None)),
    ]
    worst, rounds = 0.0, {}
    for name, nb, blocking, rtol, atol, rows in cases:
        req = nb()
        if isinstance(req, ScheduleRequest):
            rounds[name.split()[0]] = req.rounds_left
        err = _held(f"{name} ({elems}/rank)", req.get(), blocking(), rtol,
                    atol, rows)
        check(req.test()[0], f"{name}: test() after get() is False")
        if rtol is not None:
            worst = max(worst, err)
        del req
    w.ibarrier().wait()
    return (f"{len(cases)} entries and ibarrier held; largest float SUM/"
            f"PROD error {worst:.3g}; nbc schedule rounds {rounds}")


def phase_nonblocking_journey(w, smi: str) -> None:
    """(1) i-collectives, (2) persistent plans, (3) bucket fusion."""
    n = w.size
    winners = {s: w._coll_winners.get(s) for s in SCHEDULE_SLOTS}
    check(set(winners.values()) == {"nbc"}, f"schedule slots: {winners}")
    phase("nonblocking", f"schedule slot winners: {winners}")

    # (1) every i-entry at 37 elements and at 32 MB per rank
    x = torch.randn((n, SMALL_ELEMS), device="cuda")
    probes = {"iallreduce": w.iallreduce(x), "ibcast": w.ibcast(x, 0),
              "iallgather": w.iallgather(x), "ibarrier": w.ibarrier()}
    rounds = {k: r.rounds_left for k, r in probes.items()}
    want = {"iallreduce": 2 * (n - 1), "ibcast": math.ceil(math.log2(n)),
            "iallgather": n - 1, "ibarrier": math.ceil(math.log2(n))}
    check(rounds == want, f"schedule rounds {rounds}, want {want}")
    MPI.Waitall(list(probes.values()))
    phase("nonblocking", f"rounds_left before the first test() at "
          f"{SMALL_ELEMS} elements per rank: {rounds} (ring allreduce "
          f"2(N-1) = {2 * (n - 1)})")
    for elems in (SMALL_ELEMS, LOCAL_ELEMS):
        phase("nonblocking", f"i-entries at {elems} elements per rank: "
              f"{_i_entries(w, elems, seed=20 + elems % 97)}")

    big = torch.randn((n, LOCAL_ELEMS), device="cuda")
    host_us, after = [], []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        req = w.iallreduce(big, MPI.SUM)
        req.test()                          # dispatches its one round
        host_us.append((time.perf_counter() - t0) * 1e6)
        after.append(req.test()[0])
        req.wait()
    reqs = []

    def dispatch():
        r = w.iallreduce(big, MPI.SUM)
        r.test()
        reqs.append(r)
    dev = device_ms(dispatch, iters=10, warmup=2)
    MPI.Waitall(reqs)
    phase("nonblocking", f"256 MB stacked iallreduce (fused round): "
          f"dispatch {statistics.median(host_us):.1f} us on the host "
          f"(median of 10), {dev:.4f} ms on the device (CUDA events); "
          f"test() right after the dispatch: {after[0]} (True in "
          f"{sum(after)} of 10) | {smi}")

    # (2) persistent plans at 32 MB per rank
    s0 = pvar.pvar_read("coll_persistent_starts")
    buf = big.clone()
    req = w.allreduce_init(buf, MPI.SUM)
    check(req.plan.algorithm == "direct" and req.plan.codec is None,
          f"plan {req.plan.algorithm} {req.plan.codec}")
    for i in range(10):
        buf.mul_(0.5).add_(float(i))        # Start reads the contents
        req.start()
        _held(f"allreduce_init start {i + 1}", req.get(),
              w.allreduce(buf, MPI.SUM))
    y = torch.randn((n, n, LOCAL_ELEMS // n), device="cuda")
    for name, init, blocking in (
            ("bcast_init", lambda: w.bcast_init(buf, 6),
             lambda: w.bcast(buf, 6)),
            ("allgather_init", lambda: w.allgather_init(buf),
             lambda: w.allgather(buf)),
            ("reduce_scatter_block_init",
             lambda: w.reduce_scatter_block_init(y, MPI.SUM),
             lambda: w.reduce_scatter_block(y, MPI.SUM))):
        r = init()
        r.start()
        _held(name, r.get(), blocking())
        del r
    r = w.barrier_init()
    r.start()
    r.wait()
    starts = pvar.pvar_read("coll_persistent_starts") - s0
    check(starts == 14, f"coll_persistent_starts moved {starts}, want 14")
    phase("nonblocking", f"persistent plans at 32 MB per rank: "
          f"allreduce_init started 10 times over a buffer changed in "
          f"place, each equal to the blocking allreduce of the current "
          f"contents; bcast/allgather/reduce_scatter_block/barrier_init "
          f"once each; coll_persistent_starts +{starts}")
    del buf, y, big

    small = w.alloc((2,), dtype=torch.float32, fill=1.0)   # 8 B per rank
    preq = w.allreduce_init(small, MPI.SUM)
    calls = 2000

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    def start_wait():
        preq.start()
        preq.wait()
    p_us = per_call(start_wait)
    b_us = per_call(lambda: w.allreduce(small, MPI.SUM))
    check(bool((preq.get() == n).all()), "8 B persistent allreduce value")
    phase("nonblocking", f"8 B persistent allreduce Start+Wait "
          f"{p_us:.2f} us/call (the wait synchronizes on its event), "
          f"8 B blocking allreduce {b_us:.2f} us/call (host clock, "
          f"{calls} calls) | {smi}")

    # (3) bucket fusion over the flagship's gradient-shaped leaves
    cfg = dataclasses.replace(CONFIG, dtype=torch.float32)
    shapes = [tuple(t.shape) for t in tree_leaves(
        T.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))]
    g = torch.Generator(device="cuda").manual_seed(9)
    leaves = [torch.randint(-8, 8, (n,) + s, device="cuda",
                            generator=g).float() for s in shapes]
    plans = [w.allreduce_init(t, MPI.SUM) for t in leaves]
    results = {}
    for on in (True, False):
        var.var_set("mpi_base_bucket", on)
        f0 = persistent.counters()["coll_bucket_flushes"]
        MPI.Startall(plans)
        results[on] = [r.get() for r in plans]
        results[f"flushes {on}"] = (persistent.counters()
                                    ["coll_bucket_flushes"] - f0)
    same = all(torch.equal(a, b)
               for a, b in zip(results[True], results[False]))
    check(same, "bucket on and off disagree at integer-valued inputs")
    per_rank = sum(t.nbytes for t in leaves) // n
    phase("nonblocking", f"Startall over {len(plans)} gradient-shaped "
          f"leaves ({per_rank} B per rank): bucket on "
          f"{results['flushes True']} fused flushes "
          f"(mpi_base_bucket_bytes {persistent.bucket_bytes()}), bucket "
          f"off {len(plans)} allreduces and {results['flushes False']} "
          f"flushes; results byte-identical")

    def startall_get():
        MPI.Startall(plans)
        for r in plans:
            r.get()

    def startall_device_ms():
        """Device time of the work one Startall queues: CUDA events
        around the Startall alone, the gets after the end event."""
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda._sleep(2_000_000)
            start.record()
            MPI.Startall(plans)
            end.record()
            for r in plans:
                r.get()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)
    turns = []
    for on in (True, False, False, True):       # in turns
        var.var_set("mpi_base_bucket", on)
        turns.append((on, host_ms(startall_get, iters=20, warmup=3),
                      startall_device_ms()))
    var.var_set("mpi_base_bucket", False)
    phase("nonblocking", f"Startall + get over the {len(plans)} leaves, "
          "in turns (host clock synchronised, median of 20; the device "
          "time of the Startall's work by CUDA events, median of 20): "
          + "; ".join(
              f"bucket {'on' if on else 'off'} {h:.3f} ms host, {d:.4f} "
              f"ms device" for on, h, d in turns) + f" | {smi}")


def _ddp_losses_close(got, want, what):
    """Step 1 rtol 1e-5; step 2 rtol 2e-3 / atol 1e-4 (the dryrun's)."""
    for i, (a, b, rtol, atol) in enumerate(zip(got, want, (1e-5, 2e-3),
                                               (0.0, 1e-4))):
        check(abs(a - b) <= atol + rtol * abs(b),
              f"{what} step-{i + 1} loss {a} != {b}")


def phase_ddp(w, smi: str) -> None:
    """(4) the DDP train step at the flagship's full width on dp=8."""
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "the train checks assume fp32 products (allow_tf32 is on)")
    dev = torch.device("cuda", 0)
    n = w.size
    before = FA.launches
    cfg = dataclasses.replace(CONFIG, dtype=torch.float32)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), dev)
    mesh = Mesh((n,), ("dp",), dev)
    specs = tree_map(lambda _: P(), params)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2 * n, cfg.seq + 1)))
    batch = mesh.shard((tok[:, :-1], tok[:, 1:]), (P("dp"), P("dp")))
    dpc = InGraphComm("dp", n, mesh)
    start = mesh.shard(params, specs)

    def make(kind):
        """A step function for (a) bucket on, (b) bucket off, (c) the
        in-graph pmean; (a) and (b) own their BucketedGradSync."""
        if kind == "c":
            return lambda p: T.sgd_train_step(p, batch, cfg, 1e-2, dpc)
        sync = T.BucketedGradSync(w, start)
        return lambda p: T.sgd_train_step(p, batch, cfg, 1e-2, dpc,
                                          grad_sync=sync)

    runs, steps, bucket = {}, {}, {"a": True, "b": False, "c": False}
    for kind in ("a", "b", "c"):
        var.var_set("mpi_base_bucket", bucket[kind])
        step = steps[kind] = make(kind)
        if kind == "a":
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        p, losses, flushes = start, [], []
        for i in range(2):
            f0 = persistent.counters()["coll_bucket_flushes"]
            p, loss = step(p)
            flushes.append(persistent.counters()["coll_bucket_flushes"] - f0)
            losses.append(float(loss[0]))
            div = mesh.divergence(p, specs)
            check(np.isfinite(losses[-1]), f"DDP ({kind}) step {i + 1}: "
                  f"loss {losses[-1]}")
            check(div <= 1e-6, f"DDP ({kind}) step {i + 1}: replicated "
                  f"leaves differ by {div:.3g}")
            if kind == "a":
                peak = torch.cuda.max_memory_allocated()
            runs.setdefault(kind, {})[f"div{i + 1}"] = div
        runs[kind].update(params=p, losses=losses, flushes=flushes,
                          prof=_device_share(lambda: step(start)), ms=[])
    for kind in ("a", "b", "c", "c", "b", "a"):     # times in turns
        var.var_set("mpi_base_bucket", bucket[kind])
        runs[kind]["ms"].append(host_ms(lambda: steps[kind](start),
                                        iters=10, warmup=2))
    var.var_set("mpi_base_bucket", False)
    for kind in ("a", "b"):
        _ddp_losses_close(runs[kind]["losses"], runs["c"]["losses"],
                          f"DDP ({kind}) against the in-graph pmean")
    worst = 0.0
    for a, b in zip(tree_leaves(runs["a"]["params"]),
                    tree_leaves(runs["c"]["params"])):
        check(bool(torch.allclose(a, b, rtol=2e-4, atol=2e-6)),
              f"DDP (a) params differ from (c) by "
              f"{(a - b).abs().max().item():.3g}")
        worst = max(worst, (a - b).abs().max().item())
    launched = FA.launches - before
    check(launched == 0, f"{launched} kernel launches in the DDP steps")
    names = {"a": "BucketedGradSync, bucket on",
             "b": "BucketedGradSync, bucket off",
             "c": "in-graph dp pmean"}
    for kind, r in runs.items():
        phase("ddp", f"({kind}) {names[kind]}: losses "
              f"{r['losses'][0]:.6f}, {r['losses'][1]:.6f}; largest "
              f"divergence of a replicated leaf {r['div1']:.3g}, "
              f"{r['div2']:.3g} (limit 1e-6); fused flushes per step "
              f"{r['flushes']}")
    phase("ddp", f"(a) against (c): params max abs diff {worst:.3g} "
          f"after 2 steps (rtol 2e-4, atol 2e-6); losses within step 1 "
          f"rtol 1e-5, step 2 rtol 2e-3 / atol 1e-4")
    for kind, r in runs.items():
        phase("ddp", f"({kind}) {names[kind]}: "
              f"{' and '.join(f'{ms:.3f}' for ms in r['ms'])} ms per step "
              f"(timed in turns a b c c b a; host clock, synchronised, "
              f"median of 10 after 2 warm-ups); torch.profiler: "
              f"{r['prof']} | {smi}")
    phase("ddp", f"(a) peak memory: {peak} B ({peak / 2 ** 20:.1f} MiB, "
          f"torch.cuda.max_memory_allocated), of which {base} B "
          f"({base / 2 ** 20:.1f} MiB) was allocated before its first "
          f"step | {smi}")
    phase("ddp", f"flash_fold launches across the DDP steps: {launched}")


# -- phase 8 -----------------------------------------------------------
ALG_CHECK_ELEMS = 37           # per rank: no schedule's chunking divides it
ALG_CHECK_SIZES = (8, 3, 5, 6)
ALG_FUNCS = ("allreduce", "reduce", "bcast", "allgather", "gather",
             "scatter", "alltoall", "reduce_scatter_block", "scan", "exscan")
ALG_REDUCING = ("allreduce", "reduce", "reduce_scatter_block", "scan",
                "exscan")
ALG_ROOTED = ("reduce", "bcast", "gather", "scatter")
# The lowering each schedule is held against: reduce's and gather's
# symmetric aliases, every other collective's direct lowering.
ALG_BASELINE = {"reduce": "alias", "gather": "allgather"}
# Schedules whose every combine is op.fn on the same operands in the same
# order on any device: the card's result equals the CPU port's bit for bit.
ALG_BITWISE = {"ring", "ring_segmented", "recursive_doubling",
               "in_order_binary", "knomial", "recursive_halving",
               "butterfly"}


def _alg_var(func: str) -> str:
    return f"coll_torch_{'scan' if func == 'exscan' else func}_algorithm"


def _alg_expected(func: str, alg: str, n: int, op) -> str:
    """What the reference's rules run for ``alg`` forced on ``n`` ranks
    with ``op``: coll/decision's structural demotions, then each
    collective's own (coll/xla.py:1209-1658)."""
    f = "scan" if func == "exscan" else func
    if (alg in decision.REORDERING and op is not None and not op.commute
            and (f, alg) not in decision.ORDER_PRESERVING):
        alg = "direct"
    elif (alg in decision.POW2_ONLY and n & (n - 1)
          and (f, alg) not in decision.POW2_EXEMPT):
        alg = "direct"
    elif alg in decision.EVEN_ONLY and n % 2:
        alg = "direct"
    elif alg == "two_procs" and n != 2:
        alg = "direct"
    elif (alg in ("rabenseifner", "rabenseifner_root")
          or (f, alg) == ("reduce_scatter_block", "hier")) \
            and op.xla_prim != "sum":
        alg = "direct"
    if f == "reduce" and alg not in ("knomial", "in_order_binary",
                                     "rabenseifner_root"):
        alg = "alias"
    return alg


def _alg_run(comm, func, x, op, root):
    """``func`` on ``comm`` from the numpy ``x``: (host result, the
    algorithm that ran)."""
    buf = comm.put(x)
    args = (buf,) + ((op,) if op is not None else ()) + \
        ((root,) if root is not None else ())
    y = getattr(comm, func)(*args)
    return y.cpu().numpy(), comm._coll(func).selected(func, buf, op, root)


def _alg_checks(card, cpu, ops) -> str:
    """Every (collective, algorithm, op) at 37 elements per rank on a
    card communicator: against the direct lowering on the card (data
    movement, MAX, int32 and the non-commutative op exact; float32 SUM
    and PROD rtol 1e-5, atol 1e-5), bit for bit against the same schedule
    on the CPU port where it combines with op.fn alone (and wherever the
    result is exact), and what ran against the reference's rules."""
    n = card.size
    root = n - 1
    cases = bitwise = 0
    worst = 0.0
    demoted = {}
    for fi, func in enumerate(ALG_FUNCS):
        name = _alg_var(func)
        f = "scan" if func == "exscan" else func
        lead = (n, n) if func in ("scatter", "alltoall",
                                  "reduce_scatter_block") else (n,)
        r = root if func in ALG_ROOTED else None
        kinds = ([("float32", "SUM"), ("float32", "PROD"),
                  ("float32", "MAX"), ("int32", "SUM"),
                  ("float32", "right_take")]
                 if func in ALG_REDUCING else [("float32", None)])
        for ki, (dtype, opname) in enumerate(kinds):
            op = ops[opname] if opname else None
            rng = np.random.default_rng(1000 * n + 10 * fi + ki)
            if dtype == "int32":
                x = rng.integers(-1000, 1000, lead + (ALG_CHECK_ELEMS,),
                                 dtype=np.int32)
            else:
                x = rng.standard_normal(lead + (ALG_CHECK_ELEMS,)) \
                    .astype(np.float32)
                if opname == "PROD":
                    x = (1 + 0.05 * x).astype(np.float32)
            var.var_set(name, ALG_BASELINE.get(f, "direct"))
            want, _ = _alg_run(card, func, x, op, r)
            for alg in ALGORITHMS[f][1:]:
                var.var_set(name, alg)
                got, ran = _alg_run(card, func, x, op, r)
                on_cpu, ran_cpu = _alg_run(cpu, func, x, op, r)
                what = f"{func} {alg} {opname} {dtype} n={n}"
                expected = _alg_expected(func, alg, n, op)
                check(ran == ran_cpu == expected,
                      f"{what}: ran {ran} (CPU {ran_cpu}), the "
                      f"reference's rules give {expected}")
                if ran != alg:
                    why = f" [{opname}]" if ran_cpu != _alg_expected(
                        func, alg, n, ops["SUM"]) else ""
                    demoted[f"{func} {alg}->{ran}{why}"] = None
                rows = root if func in ("reduce", "gather") else slice(None)
                g, w_ = got[rows], want[rows]
                check(g.shape == w_.shape and g.dtype == w_.dtype,
                      f"{what}: {g.shape} {g.dtype} against direct "
                      f"{w_.shape} {w_.dtype}")
                exact = opname in (None, "MAX", "right_take") \
                    or dtype == "int32"
                if exact:
                    check(np.array_equal(g, w_), f"{what}: differs from "
                          f"the direct lowering")
                else:
                    err = float(np.max(np.abs(g.astype(np.float64) - w_)))
                    worst = max(worst, err)
                    check(np.allclose(g, w_, rtol=1e-5, atol=1e-5),
                          f"{what}: max abs err {err:.3g} against direct")
                if exact or ran in ALG_BITWISE:
                    check(got.dtype == on_cpu.dtype and np.array_equal(
                        got.view(np.uint8), on_cpu.view(np.uint8)),
                        f"{what}: the card's bits differ from the CPU "
                        f"port's")
                    bitwise += 1
                cases += 1
            var.var_set(name, "auto")
    for alg in ALGORITHMS["barrier"][1:]:
        var.var_set("coll_torch_barrier_algorithm", alg)
        card.barrier()
        tok = card._coll("barrier")._ibarrier_arrays()[0].cpu()
        ref = cpu._coll("barrier")._ibarrier_arrays()[0]
        check(torch.equal(tok, ref) and bool((tok >= n).all()),
              f"barrier {alg} n={n}: token {tok.tolist()} against the "
              f"CPU port's {ref.tolist()}")
        check(card._coll("barrier").selected("barrier") == alg,
              f"barrier {alg} n={n} did not run")
        cases += 1
    var.var_set("coll_torch_barrier_algorithm", "auto")
    return (f"n={n}: {cases} (collective, algorithm, op) cases held "
            f"against the direct lowering, {bitwise} of them bit for bit "
            f"against the CPU port; largest float SUM/PROD error "
            f"{worst:.3g}; demoted by the reference's rules: "
            f"{', '.join(demoted) or 'none'}")


def _dispatch_us(fn, iters: int = 5) -> float:
    """Median host time of one ``fn()`` dispatch in µs, each started on
    an idle device queue (a schedule is a Python loop of launches)."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def _alg_times(w, smi: str) -> list:
    """Every (collective, algorithm) at 32 MB per rank on the 8-rank
    world, each checked against the direct lowering on the card (SUM
    rtol 1e-5, atol 1e-5; the rest exact) and timed: device ms (CUDA
    events, median of 5 after 2 warm-ups), the share of HBM for the
    least in+out traffic (phase 4's formula), and host µs of one
    dispatch."""
    n = w.size
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((n, LOCAL_ELEMS), device="cuda", generator=g)
    y = torch.randn((n, n, LOCAL_ELEMS // n), device="cuda", generator=g)
    local = LOCAL_ELEMS * 4
    specs = [("allreduce", x, MPI.SUM, None), ("reduce", x, MPI.SUM, 2),
             ("bcast", x, None, 3), ("allgather", x, None, None),
             ("gather", x, None, 1), ("scatter", y, None, 5),
             ("alltoall", y, None, None),
             ("reduce_scatter_block", y, MPI.SUM, None),
             ("scan", x, MPI.SUM, None), ("exscan", x, MPI.SUM, None)]
    table = []
    for func, buf, op, root in specs:
        f = "scan" if func == "exscan" else func
        args = (buf,) + ((op,) if op is not None else ()) + \
            ((root,) if root is not None else ())

        def call():
            return getattr(w, func)(*args)
        var.var_set(_alg_var(func), ALG_BASELINE.get(f, "direct"))
        want = call()
        rows = root if func in ("reduce", "gather") else slice(None)
        read = local if func in ("bcast", "scatter") else buf.numel() * 4
        moved = read + want.numel() * want.element_size()
        for alg in ALGORITHMS[f][1:]:
            var.var_set(_alg_var(func), alg)
            got = call()
            ran = w._coll(func).selected(func, buf, op, root)
            what = f"{func} {alg} at 32 MB/rank"
            check(ran == _alg_expected(func, alg, n, op),
                  f"{what}: ran {ran}")
            if op is None:
                check(torch.equal(got[rows], want[rows]),
                      f"{what}: differs from the direct lowering")
            else:
                err = (got[rows].double() - want[rows].double()).abs() \
                    .max().item()
                check(bool(torch.allclose(got[rows], want[rows], rtol=1e-5,
                                          atol=1e-5)),
                      f"{what}: max abs err {err:.3g} against direct")
            del got
            ms = device_ms(call, iters=5, warmup=2)
            us = _dispatch_us(call)
            share = moved / ms / 1e9 / (HBM_BYTES_PER_S / 1e12)
            phase("algorithms", f"{func} {alg} (ran {ran}): {ms:.4f} ms "
                  f"device, {share:.1%} of {HBM_BYTES_PER_S / 1e12:.2f} "
                  f"TB/s for {moved / 1e6:.0f} MB in+out, host "
                  f"{us:.1f} us per dispatch | {smi}")
            table.append({"func": func, "algorithm": alg, "ran": ran,
                          "ms": ms, "hbm_share": share, "host_us": us})
        var.var_set(_alg_var(func), "auto")
        del want
        torch.cuda.empty_cache()
    mod = w._coll("barrier")
    for alg in ALGORITHMS["barrier"][1:]:
        var.var_set("coll_torch_barrier_algorithm", alg)
        ms = device_ms(mod._barrier_arrays, iters=5, warmup=2)
        us = _dispatch_us(mod._barrier_arrays)
        phase("algorithms", f"barrier {alg} (ran {mod.selected('barrier')})"
              f": {ms:.4f} ms device for the token schedule, host {us:.1f} "
              f"us per dispatch | {smi}")
    var.var_set("coll_torch_barrier_algorithm", "auto")
    return table


def phase_algorithms(w, smi: str) -> None:
    """Every schedule of coll/torch forced through its var: checks at 37
    elements per rank on the 8-rank world and on split sub-communicators
    of sizes 3, 5 and 6, then times at 32 MB per rank on the 8-rank
    world."""
    t0 = time.perf_counter()
    ops = {"SUM": MPI.SUM, "PROD": MPI.PROD, "MAX": MPI.MAX,
           "right_take": MPI.op_create(lambda a, b: b, commute=False)}
    n = w.size
    cpu_world = MPI.Communicator(MPI.Group(range(n)),
                                 [torch.device("cpu")] * n, name="cpu_world")
    for size in ALG_CHECK_SIZES:
        colors = [0] * size + [MPI.UNDEFINED] * (n - size)
        card = w if size == n else w.split(colors)[0]
        cpu = cpu_world if size == n else cpu_world.split(colors)[0]
        phase("algorithms", _alg_checks(card, cpu, ops))
    table = _alg_times(w, smi)
    for func in ALG_FUNCS:
        rows = [t for t in table if t["func"] == func]
        base = rows[0]["ms"]
        best = min(rows, key=lambda t: t["ms"])
        phase("algorithms", f"{func}: fastest {best['algorithm']} "
              f"{best['ms']:.4f} ms against {rows[0]['algorithm']} "
              f"{base:.4f} ms")
    phase("algorithms", f"phase 8 took {time.perf_counter() - t0:.1f} s")


# -- phase 9 -----------------------------------------------------------
CODECS = ("int8_block", "fp8_block", "null")
REAL_CODECS = ("int8_block", "fp8_block")
CODEC_BLOCK = 256
COMPRESS_ELEMS = (1 << 20, LOCAL_ELEMS)    # per rank: 4 MB and 32 MB fp32
# per-hop relative code step of each codec (codecs.error_bound / maxabs)
CODEC_EPS = {"int8_block": 1 / 254, "fp8_block": 1 / 16, "null": 0.0}
# The reference's envelopes (0.02 max|ref| for the reductions, max|x|/64
# for allgather) are int8_block's; fp8_block's error bound is 254/16 times
# int8's, so its envelopes are scaled by that ratio.
ENVELOPE_SCALE = {"int8_block": 1.0, "fp8_block": 254 / 16, "null": 1.0}
V_COUNTS = {37: [37 - 3 * r for r in range(N_RANKS)],
            LOCAL_ELEMS: [LOCAL_ELEMS - 4099 * r for r in range(N_RANKS)]}


def _wire() -> tuple:
    return (pvar.pvar_read("compress_bytes_in"),
            pvar.pvar_read("compress_bytes_out"))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two float tensors, NaN-aware (every NaN
    equals every NaN; all other values compare by their bits)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    a, b = a.contiguous(), b.contiguous()
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    ity = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.view(ity)[~nan], b.view(ity)[~nan])


def _codec_checks(smi: str) -> None:
    """Each real codec's device half at 32 MB (one rank's row) on the card
    against the same call on the CPU: codes on finite blocks, scales and
    dequantized values NaN-aware, bit for bit. Blocks of scales spread
    over six decades; three blocks hold inf, nan and -inf."""
    E, blk = LOCAL_ELEMS, CODEC_BLOCK
    g = torch.Generator(device="cuda").manual_seed(21)
    spread = torch.logspace(-3, 3, E // blk, device="cuda")
    x = torch.randn(E, device="cuda", generator=g) * \
        spread.repeat_interleave(blk)
    x[1000], x[5000], x[9000] = math.inf, math.nan, -math.inf
    xc = x.cpu()
    for name in REAL_CODECS:
        c = get_codec(name)
        qc, qs = c.torch_quant(x, blk)
        dq = c.torch_dequant(qc, qs, E, torch.float32, blk)
        hc, hs = c.torch_quant(xc, blk)
        hd = c.torch_dequant(hc, hs, E, torch.float32, blk)
        fin = torch.isfinite(hs)
        check(int((~fin).sum()) == 3, f"{name}: {int((~fin).sum())} "
              "poisoned blocks, 3 expected")
        check(torch.equal(qc.cpu().view(-1, blk)[fin], hc.view(-1, blk)[fin]),
              f"{name}: card codes differ from the CPU's on finite blocks")
        check(_same_bits(qs.cpu(), hs), f"{name}: card scales differ")
        check(_same_bits(dq.cpu(), hd), f"{name}: card dequant differs")
        blocks = hd.view(-1, blk)
        check(bool(torch.isnan(blocks[~fin]).all()),
              f"{name}: a poisoned block kept a finite value")
        xb = xc.double().view(-1, blk)
        maxabs = xb.abs().amax(1).numpy()
        bound = torch.from_numpy(c.error_bound(maxabs))
        err = (xb - blocks.double()).abs().amax(1)
        # relative slack 1e-4: the float32 rounding of x / scale, of the
        # scale and of the dequantized product can move a rounding tie by
        # a few parts in 1e6 of the block's max
        over = err[fin] > bound[fin] * (1 + 1e-4)
        check(not bool(over.any()), f"{name}: error above error_bound in "
              f"{int(over.sum())} blocks")
        share = float((err[fin] / bound[fin]).max())
        q_ms = device_ms(lambda: c.torch_quant(x, blk), iters=10, warmup=2)
        d_ms = device_ms(lambda: c.torch_dequant(qc, qs, E, torch.float32,
                                                 blk), iters=10, warmup=2)
        nb = E // blk
        q_bound = (4 * E + E + 4 * nb) / HBM_BYTES_PER_S * 1e3
        d_bound = (E + 4 * nb + 4 * E) / HBM_BYTES_PER_S * 1e3
        phase("compression", f"{name} at 32 MB: card = CPU bit for bit "
              f"(codes on {int(fin.sum())} finite blocks, scales and "
              f"dequant NaN-aware; 3 poisoned blocks all NaN); largest "
              f"error {share:.6f} of error_bound; torch_quant {q_ms:.4f} "
              f"ms (bound {q_bound:.4f}, bytes), torch_dequant {d_ms:.4f} "
              f"ms (bound {d_bound:.4f}) | {smi}")


def _alg_ms(w, func, args, alg) -> float:
    var.var_set(_alg_var(func), alg)
    try:
        return device_ms(lambda: getattr(w, func)(*args), iters=5, warmup=2)
    finally:
        var.var_set(_alg_var(func), "auto")


def _compressed_colls(w, cw, ccpu, smi: str) -> list:
    """allreduce SUM, allgather and reduce_scatter_block on the
    compression comm at 4 MB and 32 MB per rank for every codec: against
    float64 numpy (0.02 max|ref| for the reductions, max|x|/64 for
    allgather, the reference's envelopes, times ENVELOPE_SCALE), rows
    identical across ranks,
    bit for bit against the CPU port, wire ratio from the pvars (<= 0.3
    for the real codecs); device ms against the plain schedules and host
    us per dispatch."""
    n, rows = w.size, []
    for elems in COMPRESS_ELEMS:
        g = torch.Generator(device="cuda").manual_seed(31 + elems)
        x = torch.randn((n, elems), device="cuda", generator=g)
        y = torch.randn((n, n, elems // n), device="cuda", generator=g)
        xh, yh = x.cpu(), y.cpu()
        refs = {"allreduce": xh.double().sum(0),
                "reduce_scatter_block": yh.double().sum(0)}
        plain = {"allreduce": [("direct", _alg_ms(w, "allreduce",
                                                  (x, MPI.SUM), "direct")),
                               ("ring_segmented", _alg_ms(
                                   w, "allreduce", (x, MPI.SUM),
                                   "ring_segmented"))],
                 "allgather": [("direct", _alg_ms(w, "allgather", (x,),
                                                  "direct"))],
                 "reduce_scatter_block": [("direct", _alg_ms(
                     w, "reduce_scatter_block", (y, MPI.SUM), "direct"))]}
        for name in CODECS:
            var.var_set("mpi_base_compress_codec", name)
            for func, buf, host, op in (
                    ("allreduce", x, xh, MPI.SUM),
                    ("allgather", x, xh, None),
                    ("reduce_scatter_block", y, yh, MPI.SUM)):
                args = (buf,) + ((op,) if op else ())
                what = f"compressed {func} {name} at {elems * 4 >> 20} MB"
                check(cw._coll(func).selected(func, buf, op) ==
                      f"compressed:{name}", f"{what}: not selected")
                w0 = _wire()
                got = getattr(cw, func)(*args)
                torch.cuda.synchronize()
                w1 = _wire()
                moved_in, moved_out = w1[0] - w0[0], w1[1] - w0[1]
                check(moved_in > 0, f"{what}: no compressed bytes counted")
                ratio = moved_out / moved_in
                if name != "null":
                    check(ratio <= 0.3, f"{what}: wire ratio {ratio:.3f}")
                cpu = getattr(ccpu, func)(host, *args[1:])
                got_h = got.cpu()
                check(_same_bits(got_h, cpu), f"{what}: card differs from "
                      f"the CPU port")
                if func == "allgather":
                    env = float(xh.abs().max()) / 64 * ENVELOPE_SCALE[name]
                    err = max(float((got_h[r].double() - xh.double())
                                    .abs().max()) for r in range(n))
                    scale = float(xh.abs().max())
                    same = all(torch.equal(got_h[r], got_h[0])
                               for r in range(1, n))
                else:
                    ref = refs[func]
                    scale = float(ref.abs().max())
                    env = 0.02 * scale * ENVELOPE_SCALE[name]
                    err = float((got_h.double() - ref).abs().max())
                    same = (func != "allreduce" or
                            bool((got_h == got_h[:1]).all()))
                check(err <= env, f"{what}: max abs err {err:.4g} > "
                      f"envelope {env:.4g}")
                check(same, f"{what}: rows differ across ranks")
                del got, got_h, cpu
                ms = device_ms(lambda: getattr(cw, func)(*args), iters=5,
                               warmup=2)
                us = _dispatch_us(lambda: getattr(cw, func)(*args))
                vs = ", ".join(f"{a} {m:.4f} ms (x{ms / m:.2f})"
                               for a, m in plain[func])
                phase("compression", f"{what}: wire ratio {ratio:.4f} "
                      f"({moved_out} of {moved_in} B); max rel err "
                      f"{err / scale:.3g} (envelope {env / scale:.3g}); card "
                      f"= CPU bit for bit; {ms:.4f} ms device against "
                      f"uncompressed {vs}; host {us:.1f} us per dispatch "
                      f"| {smi}")
                rows.append({"func": func, "codec": name, "ms": ms,
                             "ratio": ratio, "rel_err": err / scale})
                torch.cuda.empty_cache()
        del x, y
    var.var_set("mpi_base_compress_codec", "int8_block")
    return rows


def _gates(w, cw) -> str:
    """With the var off, a MAX op, int32 data, or a payload under the
    floor: bit-identical to the plain path, and no compressed byte."""
    n = w.size
    g = torch.Generator(device="cuda").manual_seed(41)
    x = torch.randn((n, 1 << 20), device="cuda", generator=g)
    y = torch.randn((n, n, (1 << 20) // n), device="cuda", generator=g)
    xi = torch.randint(-1000, 1000, (n, 1 << 20), device="cuda",
                       dtype=torch.int32, generator=g)
    small = x[:, :1000].contiguous()
    cases = [("MAX", "allreduce", (x, MPI.MAX)),
             ("int32 SUM", "allreduce", (xi, MPI.SUM)),
             ("under the floor", "allreduce", (small, MPI.SUM)),
             ("under the floor", "allgather", (small,))]
    off = [("var off", "allreduce", (x, MPI.SUM)),
           ("var off", "allgather", (x,)),
           ("var off", "reduce_scatter_block", (y, MPI.SUM))]
    for i, (why, func, args) in enumerate(cases + off):
        if i == len(cases):
            var.var_set("mpi_base_compress", False)
        w0 = _wire()
        got = getattr(cw, func)(*args)
        torch.cuda.synchronize()
        check(_wire() == w0, f"{func} ({why}): compressed bytes moved")
        check(torch.equal(got, getattr(w, func)(*args)),
              f"{func} ({why}): differs from the plain path")
    var.var_set("mpi_base_compress", True)
    held = ", ".join(f"{f} ({why})" for why, f, _ in cases + off)
    return (f"gates held: {held} bit-identical to the plain path with no "
            f"compressed byte")


def _plans(w, cw) -> str:
    """allreduce_bind and a persistent plan on the compression comm at 4 MB
    per rank; Startall over 16 members of 32 KiB per rank with the floor
    at 256 KiB and 1 MiB buckets: the fused bucket takes the codec."""
    n = w.size
    g = torch.Generator(device="cuda").manual_seed(51)
    x = torch.randn((n, 1 << 20), device="cuda", generator=g)
    want = cw.allreduce(x, MPI.SUM)
    w0 = _wire()
    got = cw.allreduce_bind(x, MPI.SUM)(x)
    torch.cuda.synchronize()
    check(_wire()[0] > w0[0], "allreduce_bind: the codec did not engage")
    check(torch.equal(got, want), "allreduce_bind differs from allreduce")
    req = cw.allreduce_init(x, MPI.SUM)
    check(req.plan.codec == "int8_block", f"plan codec {req.plan.codec}")
    req.start()
    check(torch.equal(req.get(), want), "persistent plan differs")
    small = w.allreduce_init(x[:, :8], MPI.SUM)
    check(small.plan.codec is None, "a plain comm's plan has a codec")
    var.var_set("mpi_base_compress_min_bytes", 256 << 10)
    var.var_set("mpi_base_bucket", True)
    var.var_set("mpi_base_bucket_bytes", 1 << 20)
    try:
        c2 = w.dup()
        xs = [torch.randn((n, 8192), device="cuda", generator=g)
              for _ in range(16)]
        reqs = [c2.allreduce_init(b, MPI.SUM) for b in xs]
        check(all(r.plan.codec is None for r in reqs),
              "a 32 KiB member plan took the codec")
        f0 = persistent.counters()["coll_bucket_flushes"]
        w0 = _wire()
        MPI.Startall(reqs)
        outs = [r.get() for r in reqs]
        w1 = _wire()
        flushes = persistent.counters()["coll_bucket_flushes"] - f0
        check(w1[0] > w0[0], "the fused bucket did not take the codec")
        ratio = (w1[1] - w0[1]) / (w1[0] - w0[0])
        check(ratio <= 0.3, f"fused bucket wire ratio {ratio:.3f}")
        worst = 0.0
        for b, o in zip(xs, outs):
            ref = b.double().sum(0)
            err = float((o[0].double() - ref).abs().max())
            check(err <= 0.02 * float(ref.abs().max()),
                  f"bucket member error {err:.3g}")
            check(bool((o == o[:1]).all()), "bucket member rows differ")
            worst = max(worst, err / float(ref.abs().max()))
        for r in reqs + [req, small]:
            r.free()
    finally:
        var.var_set("mpi_base_bucket", False)
        var.var_set("mpi_base_bucket_bytes", 1 << 20)
        var.var_set("mpi_base_compress_min_bytes", 4 << 20)
    return (f"allreduce_bind and allreduce_init (plan.codec int8_block) at "
            f"4 MB equal the compressed allreduce bit for bit; Startall "
            f"over 16 x 32 KiB plans (no member codec): {flushes} fused "
            f"flush(es) took the codec, wire ratio {ratio:.4f}, largest "
            f"member rel err {worst:.3g} (envelope 0.02)")


class _TappedSync(T.BucketedGradSync):
    """BucketedGradSync that keeps each step's gradients and the synced
    means, so the codec's error is held against its bound."""

    taps: list

    def __call__(self, grads):
        out = super().__call__(grads)
        self.taps.append((tree_leaves(grads), tree_leaves(out)))
        return out


def _sync_bound(grads, eps: float, n: int) -> float:
    """Bound on |synced mean - exact mean| for one step: every element of
    a partial sum is at most S = sum_r max|g_r| in size, a ring allreduce
    quantizes each element n times (n-1 reduce-scatter hops, then the
    allgather codes), each within eps of its block's max, and the block
    max of the finished sum grows by at most n*eps*S; the mean divides by
    n."""
    s = sum(max(float(leaf[r].abs().max()) for leaf in grads)
            for r in range(n))
    return s * eps * (1 + n * eps)


def _ddp_compressed(w, smi: str) -> None:
    """The phase 7 DDP step on dp=8 through BucketedGradSync, bucket on:
    (a) uncompressed, (d) on a comm with compression on and the floor at
    64 KiB, so the fused buckets take the codec."""
    dev = torch.device("cuda", 0)
    n = w.size
    cfg = dataclasses.replace(CONFIG, dtype=torch.float32)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), dev)
    mesh = Mesh((n,), ("dp",), dev)
    specs = tree_map(lambda _: P(), params)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2 * n, cfg.seq + 1)))
    batch = mesh.shard((tok[:, :-1], tok[:, 1:]), (P("dp"), P("dp")))
    dpc = InGraphComm("dp", n, mesh)
    start = mesh.shard(params, specs)
    lr = 1e-2
    var.var_set("mpi_base_bucket", True)
    var.var_set("mpi_base_compress_min_bytes", 64 << 10)
    cd = w.dup()
    mod = cd._coll("allreduce")
    engaged: list = []
    flat_allreduce = mod.allreduce

    def recording(x, op):
        engaged.append((x.nbytes // n >> 10, mod._eligible("allreduce", x,
                                                            op)))
        return flat_allreduce(x, op)
    mod.allreduce = recording
    syncs = {"a": _TappedSync(w, start), "d": _TappedSync(cd, start)}
    runs = {}
    for kind, sync in syncs.items():
        sync.taps = []
        p, losses, ps = start, [], []
        for _ in range(2):
            p, loss = T.sgd_train_step(p, batch, cfg, lr, dpc,
                                       grad_sync=sync)
            losses.append(float(loss[0]))
            ps.append(p)
            check(mesh.divergence(p, specs) <= 1e-6,
                  f"DDP ({kind}): replicated leaves diverged")
        runs[kind] = {"losses": losses, "params": ps, "ms": []}
    steps = engaged[:]
    eps = CODEC_EPS["int8_block"]
    bounds = []
    for grads, out in syncs["d"].taps:
        b = _sync_bound(grads, eps, n)
        err = max(float((o[0].double() - g.double().mean(0)).abs().max())
                  for g, o in zip(grads, out))
        check(err <= b, f"DDP (d): synced grads off by {err:.3g}, bound "
              f"{b:.3g}")
        bounds.append((err, b))
    la, ld = runs["a"]["losses"], runs["d"]["losses"]
    pa, pd = runs["a"]["params"], runs["d"]["params"]

    def pdiff(i):
        return max(float((a - d).abs().max())
                   for a, d in zip(tree_leaves(pa[i]), tree_leaves(pd[i])))
    pmax = max(float(t.abs().max()) for t in tree_leaves(start))
    d1, d2 = pdiff(0), pdiff(1)
    tol1 = lr * bounds[0][1] + 2 * 2 ** -23 * pmax
    tol2 = 2 * (tol1 + lr * bounds[1][1])
    g2 = syncs["a"].taps[1][1]
    g2_l1 = sum(float(o[0].double().abs().sum()) for o in g2)
    ltol = 2 * g2_l1 * d1 + 1e-6 * abs(la[1])
    check(abs(ld[0] - la[0]) <= 1e-6 * abs(la[0]),
          f"DDP (d) step-1 loss {ld[0]} != (a) {la[0]}")
    check(d1 <= tol1, f"DDP (d) step-1 params off by {d1:.3g} > {tol1:.3g}")
    check(d2 <= tol2, f"DDP (d) step-2 params off by {d2:.3g} > {tol2:.3g}")
    check(abs(ld[1] - la[1]) <= ltol, f"DDP (d) step-2 loss {ld[1]} vs "
          f"{la[1]}, tolerance {ltol:.3g}")
    for kind in ("a", "d", "d", "a"):               # times in turns
        step = (lambda s=syncs[kind]: T.sgd_train_step(
            start, batch, cfg, lr, dpc, grad_sync=s))
        runs[kind]["ms"].append(host_ms(step, iters=10, warmup=2))
    mod.allreduce = flat_allreduce
    var.var_set("mpi_base_bucket", False)
    var.var_set("mpi_base_compress_min_bytes", 4 << 20)
    per_step = len(steps) // 2
    phase("compression", f"DDP dp=8 bucket on, compression floor 64 KiB: "
          f"fused buckets per step (KiB per rank, took the codec) "
          f"{steps[:per_step]}; synced-grad error {bounds[0][0]:.3g}, "
          f"{bounds[1][0]:.3g} against bounds {bounds[0][1]:.3g}, "
          f"{bounds[1][1]:.3g} (S*eps*(1+n*eps), eps 1/254)")
    phase("compression", f"DDP (d) against (a): losses {ld[0]!r} and "
          f"{la[0]!r} (same params: rtol 1e-6), {ld[1]!r} and {la[1]!r} "
          f"(tolerance {ltol:.3g}: "
          f"twice the first-order change, |g2|_1 * max|dp1|); params max "
          f"abs diff {d1:.3g} (bound lr*err1 + 2 ulp = {tol1:.3g}), "
          f"{d2:.3g} (limit {tol2:.3g}, twice the summed bounds)")
    phase("compression", "DDP step ms (timed in turns a d d a; host clock, "
          "synchronised, median of 10 after 2 warm-ups): " + "; ".join(
              f"({k}) {' and '.join(f'{m:.3f}' for m in r['ms'])}"
              for k, r in runs.items()) + f" | {smi}")


def _vforms(w, cw) -> str:
    """Each v- and root-form with ragged counts against numpy, exactly
    (reduce_scatter: float SUM rtol 1e-5 / atol 1e-5, phase 4's), at 37
    elements and 32 MB per rank; the i-forms against the blocking calls;
    reduce_scatter on the compression comm takes the codec."""
    n, out = w.size, []
    for elems, counts in V_COUNTS.items():
        g = torch.Generator(device="cuda").manual_seed(61 + elems)
        per = [torch.randn(c, device="cuda", generator=g) for c in counts]
        host = [p.cpu().numpy() for p in per]
        cat = np.concatenate(host)
        for r, o in enumerate(w.allgatherv(per)):
            check(o.is_cuda and np.array_equal(o.cpu().numpy(), cat),
                  f"allgatherv row {r} at {elems}")
        check(np.array_equal(w.gatherv(per, 3).cpu().numpy(), cat),
              f"gatherv at {elems}")
        for r, o in enumerate(w.scatterv(per, 5)):
            check(np.array_equal(o.cpu().numpy(), host[r]),
                  f"scatterv row {r} at {elems}")
        ach = [[per[(i + j) % n][:counts[(i * j) % n] // n + j]
                for j in range(n)] for i in range(n)]
        recv = w.alltoallv(ach)
        check(all(torch.equal(recv[j][i], ach[i][j]) for i in range(n)
                  for j in range(n)), f"alltoallv at {elems}")
        total = sum(counts)
        x = torch.randn((n, total), device="cuda", generator=g)
        red = x.cpu().double().sum(0).numpy()
        offs = np.concatenate([[0], np.cumsum(counts)])
        for r, o in enumerate(w.reduce_scatter(x, counts)):
            _close(o.cpu().numpy(), red[offs[r]:offs[r + 1]], 1e-5, 1e-5,
                   f"reduce_scatter row {r} at {elems}")
        st = w.stack(per_rank=[p[:counts[-1]] for p in per])
        check(torch.equal(w.gather_root(st, 2), st), "gather_root")
        check(torch.equal(w.scatter_root(st, 4), st), "scatter_root")
        for name, nb, blocking in (
                ("iallgatherv", lambda: w.iallgatherv(per),
                 lambda: w.allgatherv(per)),
                ("igatherv", lambda: w.igatherv(per, 1),
                 lambda: w.gatherv(per, 1)),
                ("iscatterv", lambda: w.iscatterv(per, 6),
                 lambda: w.scatterv(per, 6)),
                ("ialltoallv", lambda: w.ialltoallv(ach),
                 lambda: [c for row in w.alltoallv(ach) for c in row])):
            got = nb().get()
            got = [c for row in got for c in row] if name == "ialltoallv" \
                else got
            want = blocking()
            check(all(torch.equal(a, b) for a, b in zip(
                got if isinstance(got, list) else [got],
                want if isinstance(want, list) else [want])), name)
        out.append(f"{elems} elements per rank (counts {counts[0]}.."
                   f"{counts[-1]})")
        if elems == LOCAL_ELEMS:
            w0 = _wire()
            cs = cw.reduce_scatter(x, counts)
            torch.cuda.synchronize()
            check(_wire()[0] > w0[0], "reduce_scatter on the compression "
                  "comm did not take the codec")
            err = max(float(np.abs(o.cpu().double().numpy()
                                   - red[offs[r]:offs[r + 1]]).max())
                      for r, o in enumerate(cs))
            check(err <= 0.02 * float(np.abs(red).max()),
                  f"compressed reduce_scatter err {err:.3g}")
        del per, x
        torch.cuda.empty_cache()
    return (f"allgatherv, gatherv, scatterv, alltoallv, gather_root, "
            f"scatter_root exact and reduce_scatter within rtol 1e-5 / atol "
            f"1e-5 against numpy at {' and '.join(out)}; the i-forms equal "
            f"the blocking calls; reduce_scatter at 32 MB on the compression "
            f"comm took the codec (rel err {err / np.abs(red).max():.3g})")


def phase_compression(w, smi: str) -> None:
    """Codecs, compressed collectives, gates, plans and DDP, and the v-
    and root-forms on the 8-rank cuda:0 world."""
    t0 = time.perf_counter()
    _codec_checks(smi)
    n = w.size
    cpu_world = MPI.Communicator(MPI.Group(range(n)),
                                 [torch.device("cpu")] * n, name="cpu_world")
    var.var_set("mpi_base_compress", True)
    cw, ccpu = w.dup(), cpu_world.dup()
    check(cw._coll_winners["allreduce"] == "compressed" and
          w._coll_winners["allreduce"] == "tuned",
          f"winners {cw._coll_winners}")
    table = decision.decision_table(n, platform="gpu")
    check(all(any(row[2] == "compressed:int8_block" for row in table[f])
              for f in ("allreduce", "allgather", "reduce_scatter_block")),
          "decision_table lacks the compression rows")
    rows = _compressed_colls(w, cw, ccpu, smi)
    phase("compression", _gates(w, cw))
    phase("compression", _plans(w, cw))
    _ddp_compressed(w, smi)
    phase("compression", _vforms(w, cw))
    var.var_set("mpi_base_compress", False)
    worst = max(r["ratio"] for r in rows if r["codec"] != "null")
    phase("compression", f"largest real-codec wire ratio {worst:.4f} (limit "
          f"0.3); compress_ratio pvar over the phase "
          f"{pvar.pvar_read('compress_ratio'):.4f}; phase 9 took "
          f"{time.perf_counter() - t0:.1f} s")


# -- phase 10 ----------------------------------------------------------
MAT = (4096, 2048)             # 32 MB of fp32 per rank, a matrix
NBR_ELEMS = 2 << 20            # 8 MB of fp32 per rank for the topologies
DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
          torch.int32, torch.int64, torch.int16, torch.int8, torch.uint8,
          torch.uint16, torch.uint32, torch.uint64, torch.bool,
          torch.complex64, torch.complex128)


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _bits(a, b) -> bool:
    """Bit-for-bit equality of two arrays or tensors (shape, dtype and
    every byte, NaN and -0.0 included)."""
    a, b = np.ascontiguousarray(_host(a)), np.ascontiguousarray(_host(b))
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def _hbm(nbytes: int, ms: float) -> str:
    return (f"{nbytes / 1e6:.0f} MB, {nbytes / ms / 1e6:.1f} GB/s "
            f"({nbytes / ms / 1e9 / (HBM_BYTES_PER_S / 1e12):.1%} of "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")


def _ring(w, buf, tag: int, sends_first: bool, clobber: bool = False):
    """Each rank r sends its row to r + 1 and receives from r - 1:
    receives posted first (matched at send) or sends first (queued as
    unexpected, matched at receive). ``clobber`` writes over the whole
    send buffer before the receives complete."""
    n = w.size
    post = lambda: [w.irecv((r - 1) % n, tag, dst=r) for r in range(n)]
    reqs = [] if sends_first else post()
    for r in range(n):
        w.send(buf[r], src=r, dest=(r + 1) % n, tag=tag)
    if clobber:
        buf.fill_(-1.0)
    if sends_first:
        reqs = post()
    return [q.get() for q in reqs], [q.status for q in reqs]


def _ptp(w, cpu, smi: str) -> None:
    n = w.size
    g = torch.Generator(device="cuda").manual_seed(101)
    x = torch.randn((n, LOCAL_ELEMS), device="cuda", generator=g)
    xh = x.cpu().numpy()
    want = [xh[(r - 1) % n] for r in range(n)]
    cpu_got, _ = _ring(cpu, torch.from_numpy(xh.copy()), 1, True)
    for sends_first in (False, True):
        got, sts = _ring(w, x, 1, sends_first)
        check(all(o.device == x.device for o in got), "ring off the card")
        check(all(_bits(o, want[r]) and _bits(o, cpu_got[r])
                  for r, o in enumerate(got)),
              f"ring (sends first: {sends_first}) against numpy / CPU port")
        check([(s.source, s.tag, s.count) for s in sts]
              == [((r - 1) % n, 1, LOCAL_ELEMS) for r in range(n)],
              "ring statuses")
    got, _ = _ring(w, x.clone(), 2, True, clobber=True)
    check(all(_bits(o, want[r]) for r, o in enumerate(got)),
          "a message changed when its sender wrote over the buffer")
    del got, cpu_got
    moved = 2 * LOCAL_ELEMS * 4 * n
    ms = {sf: device_ms(lambda sf=sf: _ring(w, x, 3, sf), iters=10,
                        warmup=2) for sf in (False, True)}
    phase("ptp", f"sendrecv ring, 8 x 32 MB fp32 (eager limit "
          f"{var.var_get('pml_stacked_eager_limit')} B): = numpy = CPU port "
          f"bit for bit, receives posted first and sends first; each "
          f"message unchanged after its sender wrote -1 over the buffer; "
          f"device {ms[False]:.4f} ms posted first, {ms[True]:.4f} ms "
          f"sends first; {_hbm(moved, ms[False])} | {smi}")

    req = w.irecv(0, 5, dst=1)
    w.ssend(x[0], src=0, dest=1, tag=5)
    check(req.test()[0] and _bits(req.get(), xh[0]), "ssend to posted irecv")
    try:
        w.ssend(x[0], src=0, dest=1, tag=6)
        check(False, "unmatched ssend did not raise")
    except MPI.MPIError as e:
        check(e.error_class == MPI.ERR_PENDING, f"ssend raised {e}")
    parts = list(x[2].view(16, -1))
    sreq = w.psend_init(parts, dest=3, tag=9, src=2)
    rreq = w.precv_init(2, 9, 16, dst=3)

    def partitioned():
        sreq.start()
        rreq.start()
        for i in range(16):
            sreq.pready(i)
        rreq.wait()
        return rreq.get()
    got = partitioned()
    check(sreq.test()[0] and all(rreq.parrived(i) for i in range(16)),
          "partitions")
    check(_bits(torch.cat(got), xh[2]), "partitioned 16 x 2 MB")
    p_ms = device_ms(partitioned, iters=10, warmup=2)

    small = torch.ones(2, device="cuda")                 # 8 B
    pair = []
    for _ in range(1000):
        t0 = time.perf_counter()
        w.send(small, src=0, dest=1, tag=4)
        w.recv(0, 4, dst=1)
        pair.append((time.perf_counter() - t0) * 1e6)
    for i in range(256):
        w.send(small, src=i % n, dest=0, tag=i)
    match = []
    for i in range(1000):
        t0 = time.perf_counter()
        _, st = w.recv(MPI.ANY_SOURCE, MPI.ANY_TAG, dst=0)
        match.append((time.perf_counter() - t0) * 1e6)
        w.send(small, src=st.source, dest=0, tag=st.tag)
    for _ in range(256):
        w.recv(MPI.ANY_SOURCE, MPI.ANY_TAG, dst=0)
    check(w.iprobe(MPI.ANY_SOURCE, MPI.ANY_TAG, dst=0) == (False, None),
          "wildcard queue drained")
    torch.cuda.synchronize()
    phase("ptp", f"ssend to a posted irecv matched, unmatched ssend raised "
          f"ERR_PENDING; partitioned 16 x 2 MB = numpy, device "
          f"{p_ms:.4f} ms ({_hbm(2 * LOCAL_ELEMS * 4, p_ms)}); 8 B send + "
          f"recv pair {statistics.median(pair):.2f} us (host clock, median "
          f"of 1000); ANY_SOURCE/ANY_TAG recv with 256 queued "
          f"{statistics.median(match):.2f} us (median of 1000) | {smi}")


def _probe_dtypes() -> str:
    """The convertor's gather, scatter and keep-last scatter on the card
    for every predefined base type, against a host loop."""
    ok, bad = [], []
    for dt in DTYPES:
        vec = MPI.Datatype(dt).create_vector(3, 1, 2).commit()  # 0, 2, 4
        ovl = vec.create_resized(0, 2).commit()       # instances overlap
        src = torch.arange(20, device="cuda").view(2, 10).to(dt)
        try:
            p = convertor.pack(src, vec, 2)
            u = convertor.unpack(torch.zeros_like(src), p, vec, 2)
            o = convertor.unpack(torch.zeros((2, 7), dtype=dt,
                                             device="cuda"), p, ovl, 2)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as e:
            bad.append(f"{dt} ({type(e).__name__}: {str(e)[:80]})")
            continue
        sh, ph = src.cpu(), p.cpu()
        want_u, want_o = torch.zeros_like(sh), torch.zeros((2, 7), dtype=dt)
        for c, pos in enumerate(vec.flat_indices(2).tolist()):
            check(bool((ph[:, c] == sh[:, pos]).all()), f"pack {dt}")
            want_u[:, pos] = sh[:, pos]
        for c, pos in enumerate(ovl.flat_indices(2).tolist()):
            want_o[:, pos] = ph[:, c]                # the last writer wins
        check(torch.equal(u.cpu(), want_u) and torch.equal(o.cpu(), want_o),
              f"convertor on the card for {dt}")
        ok.append(str(dt).replace("torch.", ""))
    return (f"convertor pack/unpack/keep-last unpack on the card = host "
            f"loop for {', '.join(ok)}; cannot run: {', '.join(bad) or 'none'}")


def _datatypes(w, cpu, smi: str) -> None:
    n, L = w.size, MAT[0] * MAT[1]
    g = torch.Generator(device="cuda").manual_seed(103)
    x = torch.randn((n, L), device="cuda", generator=g)
    xh = x.cpu().numpy()
    types = {
        "vector(4096, 1024, 2048) resized to the matrix":
            MPI.FLOAT.create_vector(MAT[0], 1024, MAT[1])
            .create_resized(0, L).commit(),
        "subarray (2048, 1024) at (1024, 512)":
            MPI.FLOAT.create_subarray(MAT, (2048, 1024), (1024, 512))
            .commit(),
    }
    mod = w._coll("allreduce")
    for name, t in types.items():
        idx = t.flat_indices(1)
        k = idx.size
        holes = np.ones(L, bool)
        holes[idx] = False
        p = convertor.pack(x, t, 1)
        check(_bits(p, xh[:, idx]), f"{name}: pack")
        u = convertor.unpack(torch.zeros_like(x), p, t, 1)
        uh = u.cpu().numpy()
        check(_bits(uh[:, idx], xh[:, idx]) and not uh[:, holes].any(),
              f"{name}: unpack")
        del u, uh
        moved = 2 * n * k * 4 + k * 8
        pk = device_ms(lambda: convertor.pack(x, t, 1), iters=10, warmup=2)
        out = torch.zeros_like(x)
        up = device_ms(lambda: convertor.unpack(out, p, t, 1), iters=10,
                       warmup=2)
        del out
        xf = x.clone()
        y = w.allreduce(MPI.IN_PLACE, MPI.SUM, datatype=t, recvbuf=xf)
        check(y is xf and any(key[0] == "allreduce_dt" and key[4] == t.uid
                              for key in mod._fast), f"{name}: not fused")
        yh = y.cpu().numpy()
        check(_bits(yh[:, holes], xh[:, holes]), f"{name}: holes changed")
        _close(yh[:, idx], np.broadcast_to(
            xh[:, idx].astype(np.float64).sum(0), (n, k)), 1e-5, 1e-5,
            f"{name}: fused SUM")
        xu = x.clone()
        packed, unpack_fn = w._wire(xu, t, 1)
        unpack_fn(w.allreduce(packed, MPI.SUM), xu)
        check(torch.equal(xu, y), f"{name}: fused != unfused chain")
        del yh, xu, packed
        ym = w.allreduce(MPI.IN_PLACE, MPI.MAX, datatype=t,
                         recvbuf=x.clone())
        ycm = cpu.allreduce(MPI.IN_PLACE, MPI.MAX, datatype=t,
                            recvbuf=torch.from_numpy(xh.copy()))
        check(_bits(ym, ycm), f"{name}: MAX card != CPU port")
        del ym, ycm
        xs = x.clone()
        fused = device_ms(lambda: w.allreduce(
            MPI.IN_PLACE, MPI.SUM, datatype=t, recvbuf=xs), iters=8,
            warmup=2)
        xs.copy_(x)

        def unfused():
            pk_, un = w._wire(xs, t, 1)
            un(w.allreduce(pk_, MPI.SUM), xs)
        chain = device_ms(unfused, iters=8, warmup=2)
        contig = device_ms(lambda: w.allreduce(p, MPI.SUM), iters=8,
                           warmup=2)
        del xs
        phase("datatype", f"{name}: {k} of {L} elements per rank; pack "
              f"{pk:.4f} ms ({_hbm(moved, pk)}), unpack {up:.4f} ms "
              f"({_hbm(moved, up)}); in-place allreduce SUM fused "
              f"{fused:.4f} ms, unfused _wire chain {chain:.4f} ms, "
              f"contiguous allreduce of the {n * k * 4 / 1e6:.0f} MB packed "
              f"{contig:.4f} ms; holes unchanged bit for bit, SUM within "
              f"rtol 1e-5 / atol 1e-5 of float64 numpy, fused = unfused, "
              f"MAX = CPU port bit for bit | {smi}")
    vec = next(iter(types.values()))
    idx = vec.flat_indices(1)
    b = w.bcast(x, root=2, datatype=vec)
    bh = b.cpu().numpy()
    check(_bits(bh[:, idx], np.broadcast_to(xh[2, idx], (n, idx.size)))
          and not bh[:, np.setdiff1d(np.arange(L), idx)].any(),
          "bcast with the vector type")
    del b, bh
    a, c = x[0], x[1]
    rl = MPI.reduce_local(a, c, MPI.SUM)
    check(_bits(rl, xh[0] + xh[1]), "reduce_local SUM at 32 MB")
    rl_ms = device_ms(lambda: MPI.reduce_local(a, c, MPI.SUM), iters=10,
                      warmup=2)
    kinds = [MPI.FLOAT.create_vector(3, 2, 5).commit(),
             MPI.FLOAT.create_indexed([1, 3], [0, 4]).commit(), None,
             MPI.FLOAT.create_subarray((4, 6), (2, 3), (1, 2)).commit()]
    tys = [[kinds[(i + j) % 4] for j in range(n)] for i in range(n)]
    chunks = [[torch.randn(((t.extent if t else 3) * (1 + (i * j) % 3),),
                           device="cuda", generator=g)
               for j, t in enumerate(row)] for i, row in enumerate(tys)]
    recv = w.alltoallw(chunks, tys)
    for i in range(n):
        for j in range(n):
            t, ch = tys[i][j], chunks[i][j].cpu().numpy()
            cnt = (1 + (ch.size - sum(t.get_true_extent())) // t.extent
                   if t else None)
            want = ch[t.flat_indices(cnt)] if t else ch
            check(recv[j][i].is_cuda and _bits(recv[j][i], want),
                  f"alltoallw {i} -> {j}")
    ov = MPI.FLOAT.create_vector(2, 2, 3).create_resized(0, 3).commit()
    cnt = 1 << 18
    oidx = ov.flat_indices(cnt)
    packed = torch.randn((n, oidx.size), device="cuda", generator=g)
    got = convertor.unpack(torch.zeros((n, 3 * cnt + 2), device="cuda"),
                           packed, ov, cnt)
    want = np.zeros((n, 3 * cnt + 2), np.float32)
    want[:, oidx] = packed.cpu().numpy()
    check(_bits(got, want), "overlapping resized type: unpack != numpy's "
          "last writer")
    phase("datatype", f"bcast with the vector type = numpy; reduce_local "
          f"SUM at 32 MB = numpy bit for bit, {rl_ms:.4f} ms "
          f"({_hbm(3 * LOCAL_ELEMS * 4, rl_ms)}); alltoallw over vector, "
          f"indexed, contiguous and subarray chunks of 3-72 elements = "
          f"numpy; an overlapping resized type ({oidx.size} indices onto "
          f"{len(set(oidx.tolist()))} positions) unpacks to numpy's "
          f"last-writer result | {smi}")
    phase("datatype", _probe_dtypes())


def _nbr_check(what, comm, cpu_comm, fn, x):
    """The device path's result against the host path (numpy) and the
    CPU port, bit for bit; every output on cuda:0. Returns the least
    traffic of the call: every input row that some rank receives read
    once (at most the input's bytes), every output written once."""
    dev = fn(comm, x)
    host = fn(comm, _nested(x, _host))
    cpu = fn(cpu_comm, _nested(x, lambda t: torch.from_numpy(_host(t))))
    d, h, c = _flat(dev), _flat(host), _flat(cpu)
    check(all(a.device == torch.device("cuda", 0) for a in d),
          f"{what}: an output is off cuda:0")
    check(len(d) == len(h) == len(c) and all(
        (a.numel() == 0 and np.asarray(b).size == 0) or _bits(a, b)
        for a, b in zip(d, h)) and all(_bits(a, b) for a, b in zip(d, c)),
        f"{what}: device != host path / CPU port")
    out = sum(a.numel() * a.element_size() for a in d)
    ins = sum(a.numel() * a.element_size() for a in _flat(x))
    return min(ins, out) + out


def _flat(v) -> list:
    if isinstance(v, (list, tuple)):
        return [a for b in v for a in _flat(b)]
    return [v]


def _nested(x, f):
    if isinstance(x, list):
        return [_nested(a, f) for a in x]
    return f(x)


def _topologies(w, cpu, smi: str) -> None:
    n = w.size
    g = torch.Generator(device="cuda").manual_seed(107)
    lines = []

    def timed(what, comm, cpu_comm, fn, x):
        nbytes = _nbr_check(what, comm, cpu_comm, fn, x)
        ms = device_ms(lambda: fn(comm, x), iters=10, warmup=2)
        lines.append(f"{what} {ms:.4f} ms ({_hbm(nbytes, ms)})")

    cart = w.create_cart([2, 4], [True, False])
    ccart = cpu.create_cart([2, 4], [True, False])
    check(cart.cart_shift(0, 0, 1) == (4, 4) and
          cart.cart_shift(0, 1, 1) == (-2, 1), "cart_shift")
    x = torch.randn((n, NBR_ELEMS), device="cuda", generator=g)
    timed("cart 2x4 neighbor_allgather (8 MB per rank)", cart, ccart,
          lambda c, b: c.neighbor_allgather(b), x)
    y = torch.randn((n, 4, NBR_ELEMS // 4), device="cuda", generator=g)
    timed("neighbor_alltoall (4 x 2 MB chunks)", cart, ccart,
          lambda c, b: c.neighbor_alltoall(b), y)
    src = [[1], [0, 0, 2], [1, 2], [-2, 4], [3, 5], [4], [7], [6, 3]]
    dst = [[1, 1], [0, 2], [2, 1], [4], [3, 5], [4], [7], [6]]
    dg, cdg = (c.create_dist_graph_adjacent(src, dst) for c in (w, cpu))
    z = torch.randn((n, 2, NBR_ELEMS // 2), device="cuda", generator=g)
    timed("dist-graph with duplicate edges neighbor_alltoall", dg, cdg,
          lambda c, b: c.neighbor_alltoall(b), z)
    timed("dist-graph neighbor_allgather", dg, cdg,
          lambda c, b: c.neighbor_allgather(b), x)
    index, edges = [], []
    for r in range(n):
        edges += [(r - 1) % n, (r + 1) % n, (r + 3) % n]
        index.append(len(edges))
    gr, cgr = (c.create_graph(index, edges, reorder=True) for c in (w, cpu))
    check(gr.graph_neighbors(0) == [n - 1, 1, 3], "graph neighbors")
    _close(gr.allreduce(x[:, :1024]).cpu().numpy(),
           np.broadcast_to(x[:, :1024].cpu().double().sum(0).numpy(),
                           (n, 1024)), 1e-5, 1e-5, "reordered graph allreduce")
    timed("graph (reorder=True) neighbor_allgather", gr, cgr,
          lambda c, b: c.neighbor_allgather(b), x)
    per = [x[r, :(r + 1) * (NBR_ELEMS // n)] for r in range(n)]
    timed("cart neighbor_allgatherv (1-8 MB per rank)", cart, ccart,
          lambda c, b: c.neighbor_allgatherv(b), per)
    rows = [[x[r, :((r + j) % 4 + 1) * (NBR_ELEMS // 16)]
             for j in range(4)] for r in range(n)]
    timed("cart neighbor_alltoallv (up to 5 MB per rank)", cart, ccart,
          lambda c, b: c.neighbor_alltoallv(b), rows)
    phase("topology", "device = host path = CPU port bit for bit, every "
          "output on cuda:0; device ms (CUDA events, median of 10), bytes "
          "= the rows received read once (at most the input) and the "
          "output written once: "
          + "; ".join(lines) + f" | {smi}")


def _algebra(w) -> None:
    n = w.size
    shared = w.split_type(MPI.COMM_TYPE_SHARED)
    check(all(s is shared[0] for s in shared) and shared[0].size == n,
          "split_type SHARED")
    hw = w.split_type(MPI.COMM_TYPE_HWTHREAD)
    check(all(s.size == 1 for s in hw), "split_type HWTHREAD")
    check(w.split_type(MPI.UNDEFINED) == [None] * n, "split_type UNDEFINED")
    sub = w.create(w.group.incl([1, 4, 6]))
    res = sub.allreduce(sub.alloc((3,), fill=2.0), MPI.SUM)
    check(res.is_cuda and bool((res == 6).all()), "create + allreduce")
    trace = []
    kv = MPI.create_keyval(copy_fn=lambda c, k, v: (True, v + 1),
                           delete_fn=lambda c, k, v: trace.append(v))
    w.set_attr(kv, 10)
    d = w.dup()
    check(d.get_attr(kv) == (True, 11), "attribute through dup")
    d.free()
    w.delete_attr(kv)
    MPI.free_keyval(kv)
    check(trace == [11, 10], f"delete callbacks {trace}")
    phase("algebra", "split_type SHARED (one comm of 8), HWTHREAD (8 of "
          "1), UNDEFINED (COMM_NULL); create over ranks 1, 4, 6 with an "
          "allreduce on the card; an attribute copied through dup and "
          "deleted at free and delete_attr")


def phase_ptp_topo_datatype(w, smi: str) -> None:
    """Point-to-point, derived datatypes, topologies and communicator
    algebra on the 8-rank cuda:0 world, against numpy and the CPU port."""
    t0 = time.perf_counter()
    n = w.size
    cpu = MPI.Communicator(MPI.Group(range(n)), [torch.device("cpu")] * n,
                           name="cpu_world")
    _ptp(w, cpu, smi)
    torch.cuda.empty_cache()
    _datatypes(w, cpu, smi)
    torch.cuda.empty_cache()
    _topologies(w, cpu, smi)
    _algebra(w)
    phase("ptp", f"phase 10 took {time.perf_counter() - t0:.1f} s")


# -- phase 11 ----------------------------------------------------------
PR_RANKS = 8
PR_SEED = 1100
PR_TIMEOUT = 300               # seconds the per-rank job may take


def _pr_inputs(n: int) -> list:
    """Every rank's 32 MB fp32 input, made from the seed by every rank,
    so each can hold its results against numpy."""
    return [np.random.default_rng(PR_SEED + j).random(LOCAL_ELEMS,
                                                      dtype=np.float32)
            for j in range(n)]


def _pr_timed(fn, iters: int = 5):
    """(result, median device ms from CUDA events, median host µs) of one
    collective call. The device tier fences through the host, so the
    events span the whole call: the device ms include the fences."""
    res = fn()
    dev, host = [], []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        res = fn()
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e6)
        dev.append(start.elapsed_time(end))
    return res, statistics.median(dev), statistics.median(host)


def _perrank_rank(report: str) -> int:
    """The rank program of phase 11 (run by mpirun --per-rank); rank 0
    writes its lines to ``report``."""
    from ompi_tpu_torch.core import rankcomm
    MPI.Init()
    w = MPI.get_comm_world()
    r, n = w.rank(), w.size
    dev = torch.device("cuda", 0)
    check(w.device == dev, f"rank {r} bound to {w.device}")
    lines = []
    total_mb = n * LOCAL_ELEMS * 4 / 1e6

    def on_card(t, what):
        check(isinstance(t, torch.Tensor) and t.device == dev,
              f"rank {r}: {what} is not a CUDA tensor on cuda:0")
        return t.cpu().numpy()

    def share(mb, ms):
        return f"{mb / ms / 1e3 / (HBM_BYTES_PER_S / 1e12):.1%}"

    xs = _pr_inputs(n)
    per = LOCAL_ELEMS // n
    x = torch.from_numpy(xs[r]).to(dev)
    xp = torch.from_numpy(0.5 + xs[r]).to(dev)
    xi = torch.from_numpy((xs[r] * 1000).astype(np.int32)).to(dev)
    stack = np.stack(xs).astype(np.float64)
    cases = [
        ("allreduce SUM f32", lambda: w.allreduce(x, MPI.SUM),
         stack.sum(0), 1e-5),
        ("allreduce MAX f32", lambda: w.allreduce(x, MPI.MAX),
         stack.max(0), 0),
        ("allreduce PROD f32", lambda: w.allreduce(xp, MPI.PROD),
         (0.5 + stack).prod(0), 1e-5),
        ("allreduce SUM i32", lambda: w.allreduce(xi, MPI.SUM),
         np.stack([(a * 1000).astype(np.int32) for a in xs]).sum(0), 0),
    ]
    for name, fn, want, rtol in cases:
        y, ms, us = _pr_timed(fn)
        got = on_card(y, name)
        if rtol:
            ok = np.allclose(got, want, rtol=rtol, atol=1e-6)
        else:
            ok = np.array_equal(got, want)
        check(ok, f"rank {r}: {name} differs from numpy (max abs err "
              f"{np.max(np.abs(got - want)):.3g})")
        lines.append(f"{name}: {ms:.3f} ms call, {us:.0f} us host per "
                     f"dispatch ({share(2 * total_mb, ms)} of HBM for "
                     f"{2 * total_mb:.0f} MB in+out over 8 ranks)")
    # a pair op: chunks of the reduce-scatter read hold whole records
    for recs in (9, 1 << 20):
        pr = [np.stack([np.round(a[:recs] * 4), j * recs + np.arange(recs)],
                       -1).astype(np.float32) for j, a in enumerate(xs)]
        want = pr[0]
        for q in pr[1:]:
            take = (q[:, 0] > want[:, 0]) | ((q[:, 0] == want[:, 0])
                                             & (q[:, 1] < want[:, 1]))
            want = np.where(take[:, None], q, want)
        xl = torch.from_numpy(pr[r]).to(dev)
        y, ms, us = _pr_timed(lambda: w.allreduce(xl, MPI.MAXLOC))
        check(np.array_equal(on_card(y, "allreduce MAXLOC"), want),
              f"rank {r}: allreduce MAXLOC on {recs} records differs")
    lines.append(f"allreduce MAXLOC f32, {recs} (value, index) records: "
                 f"{ms:.3f} ms call, {us:.0f} us host per dispatch")
    y, ms, us = _pr_timed(lambda: w.bcast(x if r == 3 else
                                          torch.empty_like(x), 3))
    check(np.array_equal(on_card(y, "bcast"), xs[3]), f"rank {r}: bcast")
    lines.append(f"bcast root 3: {ms:.3f} ms call, {us:.0f} us host")
    rows, ms, us = _pr_timed(lambda: w.allgather(x), iters=3)
    for j in range(n):
        check(np.array_equal(on_card(rows[j], "allgather"), xs[j]),
              f"rank {r}: allgather row {j}")
    del rows
    lines.append(f"allgather: {ms:.3f} ms call, {us:.0f} us host "
                 f"({share(total_mb * (1 + n), ms)} of HBM)")
    chunks = list(x.view(n, per).unbind(0))
    got, ms, us = _pr_timed(lambda: w.alltoall(chunks))
    for j in range(n):
        check(np.array_equal(on_card(got[j], "alltoall"),
                             xs[j][r * per:(r + 1) * per]),
              f"rank {r}: alltoall chunk {j}")
    lines.append(f"alltoall: {ms:.3f} ms call, {us:.0f} us host "
                 f"({share(2 * total_mb, ms)} of HBM)")
    y, ms, us = _pr_timed(lambda: w.reduce_scatter_block(chunks, MPI.SUM))
    check(np.allclose(on_card(y, "reduce_scatter_block"),
                      stack[:, r * per:(r + 1) * per].sum(0), rtol=1e-5,
                      atol=1e-6), f"rank {r}: reduce_scatter_block")
    lines.append(f"reduce_scatter_block (alltoall + host fold): {ms:.3f} ms"
                 f" call, {us:.0f} us host")

    # numpy staged onto the device tier
    from ompi_tpu_torch.mca import var
    var.var_set("coll_tuned_stage_min_bytes", 1 << 20)
    staged0 = rankcomm.counters["coll_staged_device"]
    h = xs[r][:1 << 20]
    y, ms, us = _pr_timed(lambda: w.allreduce(h, MPI.SUM), iters=3)
    check(isinstance(y, np.ndarray) and np.allclose(
        y, stack[:, :1 << 20].sum(0), rtol=1e-5, atol=1e-6),
        f"rank {r}: staged allreduce")
    check(rankcomm.counters["coll_staged_device"] == staged0 + 4,
          f"rank {r}: numpy allreduce not staged")
    lines.append(f"staged numpy allreduce (4 MB, stage min 1 MiB): "
                 f"{us:.0f} us host")

    # host tier at 37 elements
    small = [a[:37].astype(np.float64) for a in xs]
    check(np.allclose(w.allreduce(small[r], MPI.SUM),
                      np.sum(small, 0), rtol=1e-12), "host allreduce")
    check(np.array_equal(w.bcast(small[r] if r == 0 else None, 0),
                         small[0]), "host bcast")
    check(all(np.array_equal(a, b) for a, b in
              zip(w.allgather(small[r]), small)), "host allgather")
    got = w.alltoall([small[r] + j for j in range(n)])
    check(all(np.array_equal(got[j], small[j] + r) for j in range(n)),
          "host alltoall")
    red = w.reduce(small[r], MPI.MAX, root=1)
    check(red is None if r != 1 else np.array_equal(red, np.max(small, 0)),
          "host reduce")
    check(np.allclose(w.scan(small[r], MPI.SUM),
                      np.sum(small[:r + 1], 0), rtol=1e-12), "host scan")

    # devxfer ring of eight 32 MB CUDA messages
    right, left = (r + 1) % n, (r - 1) % n
    # a 2 MB message first: the 32 MB ring then replaces its send slot,
    # and the receiver drops the stale mapping
    got = w.sendrecv(x[:1 << 19], right, left)[0]
    check(np.array_equal(on_card(got, "devxfer 2 MB"), xs[left][:1 << 19]),
          f"rank {r}: devxfer 2 MB")
    recv0 = w.router.xfer.stats["received"]

    def ring():
        buf = x.clone()
        req = w.irecv(left, tag=11)
        w.send(buf, right, tag=11)
        buf.fill_(-1.0)                 # the sender overwrites its buffer
        return req.get()
    w.barrier()
    z, ms, us = _pr_timed(ring, iters=3)
    check(np.array_equal(on_card(z, "devxfer ring"), xs[left]),
          f"rank {r}: devxfer message changed after its sender's overwrite")
    check(w.router.xfer.stats["received"] == recv0 + 4,
          f"rank {r}: ring did not ride devxfer")
    lines.append(f"devxfer ring, 8 x 32 MB: {ms:.3f} ms call, {us:.0f} "
                 f"us host per round ({share(2 * total_mb, ms)} of HBM "
                 f"for each message read and written once)")

    # the host barrier each device-tier fence waits on
    _, _, bar_us = _pr_timed(w.barrier, iters=20)
    lines.append(f"barrier (3-round dissemination over tcp): {bar_us:.0f} "
                 f"us host; a device collective waits on two of them")

    # 8 B send+recv and a wildcard match
    w.barrier()
    b8 = np.zeros(1, np.float64)
    reps = 200
    if r in (0, 1):
        t0 = time.perf_counter()
        for _ in range(reps):
            if r == 0:
                w.send(b8, 1, tag=5)
                w.recv(1, tag=5)
            else:
                w.recv(0, tag=5)
                w.send(b8, 0, tag=5)
        rt_us = (time.perf_counter() - t0) / reps * 1e6
        if r == 1:
            for i in range(256):
                w.send(np.array([i]), 0, tag=100 + i % 7)
            w.send(b8, 0, tag=999)
        else:
            w.recv(1, tag=999)            # the 256 are queued before it
            t0 = time.perf_counter()
            seen = sorted(int(w.recv(MPI.ANY_SOURCE, MPI.ANY_TAG)[0][0])
                          for _ in range(256))
            wild_us = (time.perf_counter() - t0) / 256 * 1e6
            check(seen == list(range(256)), "wildcard matches")
            lines.append(f"8 B send+recv round trip (ranks 0 and 1): "
                         f"{rt_us:.1f} us host ({rt_us / 2:.1f} us per "
                         f"8 B pair); ANY_SOURCE/ANY_TAG match with 256 "
                         f"queued: {wild_us:.1f} us per match")
    w.barrier()

    # split into two comms of 4
    sub = w.split(r % 2, key=r)
    check(sub.size == 4 and sub.rank() == r // 2, "split")
    members = [j for j in range(n) if j % 2 == r % 2]
    for elems in (1 << 18, 1 << 21):    # the second grows the slots
        s_got = on_card(sub.allreduce(x[:elems], MPI.SUM),
                        "split allreduce")
        check(np.allclose(s_got, stack[members, :elems].sum(0), rtol=1e-5,
                          atol=1e-6), f"rank {r}: split allreduce")
    sub.free()
    MPI.Finalize()
    if r == 0:
        with open(report, "w") as f:
            json.dump(lines, f)
    print(f"OK perrank rank={r}/{n}", flush=True)
    return 0


def phase_perrank(smi: str) -> None:
    """Launch the per-rank job and relay rank 0's lines."""
    import tempfile
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "rank0.json")
        cmd = [sys.executable,
               os.path.join(root, "ompi_tpu_torch", "tools", "mpirun.py"),
               "--per-rank", "-n", str(PR_RANKS), "--timeout",
               str(PR_TIMEOUT), os.path.abspath(__file__), "--perrank-rank",
               report]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=PR_TIMEOUT + 60, cwd=root)
        oks = res.stdout.count("OK perrank")
        if res.returncode != 0 or oks != PR_RANKS:
            sys.stderr.write(res.stderr[-6000:])
            check(False, f"per-rank job rc={res.returncode}, {oks} of "
                  f"{PR_RANKS} ranks OK:\n{res.stdout[-3000:]}")
        with open(report) as f:
            lines = json.load(f)
    for line in lines:
        phase("perrank", f"{line} | {smi}")
    phase("perrank", "'ms call' is a CUDA-event span on rank 0's stream "
          "that includes the host fences; 'of HBM' divides bytes by it")
    phase("perrank", f"8 rank processes on cuda:0, every result = numpy "
          f"on every rank (float SUM/PROD rtol 1e-5, the rest exact), "
          f"every device result on cuda:0; phase 11 took "
          f"{time.perf_counter() - t0:.1f} s | {smi}")


DP_SEED = 1200


def _dp_timed(fn, iters: int = 3):
    """(last result, median host ms) of a host-tier call."""
    res, ts = fn(), []
    for _ in range(iters):
        t0 = time.perf_counter()
        res = fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return res, statistics.median(ts)


def _same_everywhere(w, arr) -> bool:
    """Every rank holds the same bits of ``arr`` (a digest allgather)."""
    import hashlib
    digest = hashlib.sha1(np.ascontiguousarray(arr).tobytes()).hexdigest()
    return len(set(w.allgather(digest))) == 1


def _dataplane_rank(report: str) -> int:
    """The rank program of phase 12 (run by mpirun --per-rank). Rank 0
    writes its lines to ``report``."""
    from ompi_tpu_torch.btl import shmseg
    from ompi_tpu_torch.coll import tuned
    from ompi_tpu_torch.core import rankcomm
    from ompi_tpu_torch.pml import pipeline
    MPI.Init()
    w = MPI.get_comm_world()
    r, n = w.rank(), w.size
    dev = torch.device("cuda", 0)
    check(w.device == dev, f"rank {r} bound to {w.device}")
    c = rankcomm.counters
    lines = []
    # the staging probe rank 0 ran on the card at Init
    basis = tuned.probed_stage_basis()
    check(basis.get("ran") and basis.get("device") == "cuda",
          f"rank {r}: stage probe basis {basis}")
    vals = w.allgather(int(basis["value"]))
    check(len(set(vals)) == 1, f"stage probe values differ: {vals}")
    lines.append(
        f"stage probe (rank 0 on cuda:0, adopted by all {n} ranks): "
        f"staged {basis['staged_per_mb_ms']} ms/MB + "
        f"{basis['staged_fixed_us']} us fixed, host "
        f"{basis['host_per_mb_ms']} ms/MB + {basis['host_fixed_us']} us "
        f"fixed (transport {basis.get('transport_gbps')} GB/s); "
        f"confirmed at {basis.get('confirm_bytes')} B: staged "
        f"{basis.get('confirm_staged_ms')} ms against host "
        f"{basis.get('confirm_host_ms')} ms; adopted stage_min_bytes "
        f"{basis['stage_min_bytes']}")
    var.var_set("coll_tuned_stage_min_bytes", 1 << 62)     # host tier
    xs = _pr_inputs(n)
    stack = np.stack(xs)
    xi = (xs[r] * 1000).astype(np.int32)
    mb = LOCAL_ELEMS * 4 >> 20

    # the pipelined ring and chain over 1 and 2 rails, in turns
    s0, i0 = (pvar.pvar_read("pml_pipeline_segments"),
              pvar.pvar_read("pml_pipeline_inits"))
    ring0 = c["coll_pipelined_ring"]
    ring_ms, chain_ms, overlap = {1: [], 2: []}, {1: [], 2: []}, {}
    for rails in (1, 2, 2, 1):
        var.var_set("mpi_base_btl_rails", rails)
        before = [pvar.pvar_read(f"btl_rail_bytes_c{k}") for k in (0, 1)]
        y, ms = _dp_timed(lambda: w.allreduce(xs[r], MPI.SUM), iters=1)
        ring_ms[rails].append(ms)
        overlap[rails] = pvar.pvar_read("pml_overlap_ratio")
        b, ms = _dp_timed(lambda: w.bcast(xs[0] if r == 0 else None, 0),
                          iters=1)
        chain_ms[rails].append(ms)
        # a rank that is done early may already send the next turn's
        # segments: the counters are read between two barriers
        w.barrier()
        grew = [pvar.pvar_read(f"btl_rail_bytes_c{k}") - before[k]
                for k in (0, 1)]
        w.barrier()
        check(grew[0] > 0 and (grew[1] > 0) == (rails == 2),
              f"rank {r}: rails {rails} carried {grew} bytes")
    check(np.allclose(y, stack.astype(np.float64).sum(0), rtol=1e-5,
                      atol=1e-6), f"rank {r}: pipelined ring SUM")
    check(_same_everywhere(w, y), "pipelined ring SUM: ranks differ")
    check(np.array_equal(b, xs[0]), f"rank {r}: chain bcast")
    ring_sum = y
    ym, ms_max = _dp_timed(lambda: w.allreduce(xs[r], MPI.MAX), iters=1)
    check(np.array_equal(ym, stack.max(0)), f"rank {r}: ring MAX f32")
    yi, _ = _dp_timed(lambda: w.allreduce(xi, MPI.MAX), iters=1)
    check(np.array_equal(yi, np.stack([(a * 1000).astype(np.int32)
                                       for a in xs]).max(0)),
          f"rank {r}: ring MAX i32")
    check(_same_everywhere(w, yi), "pipelined ring MAX i32: ranks differ")
    check(c["coll_pipelined_ring"] - ring0 == 12,
          f"rank {r}: the ring did not run every call")
    check(c["coll_pipelined_chain"] == 8, f"rank {r}: chain did not run")
    segs = pvar.pvar_read("pml_pipeline_segments") - s0
    inits = pvar.pvar_read("pml_pipeline_inits") - i0
    per_rail = [pvar.pvar_read(f"btl_rail_bytes_c{k}") for k in (0, 1)]
    for rails in (1, 2):
        lines.append(
            f"pipelined ring allreduce SUM, {mb} MB f32 per rank, rails "
            f"{rails}: {ring_ms[rails][0]:.1f} / {ring_ms[rails][1]:.1f} ms "
            f"per call (host clock, runs in turns 1 2 2 1), "
            f"pml_overlap_ratio {overlap[rails]}; chain bcast "
            f"{chain_ms[rails][0]:.1f} / {chain_ms[rails][1]:.1f} ms")
    lines.append(f"pipelined ring MAX f32 (rails 1): {ms_max:.1f} ms; "
                 f"{segs / max(inits, 1):.1f} segments per train; bytes "
                 f"per rail {per_rail}")

    # the in-segment fold against the ring, and pt2pt adoption
    var.var_set("mpi_base_shm_zerocopy", True)
    f0 = c["coll_shm_fold"]
    yf, ms_fold = _dp_timed(lambda: w.allreduce(xs[r], MPI.SUM))
    check(np.allclose(yf, ring_sum, rtol=1e-5, atol=1e-6),
          f"rank {r}: fold SUM against the ring")
    ymf, _ = _dp_timed(lambda: w.allreduce(xs[r], MPI.MAX), iters=1)
    check(np.array_equal(ymf, ym), f"rank {r}: fold MAX against the ring")
    check(_same_everywhere(w, yf), "fold SUM: ranks differ")
    check(c["coll_shm_fold"] - f0 == 6, f"rank {r}: the fold did not run")
    right, left = (r + 1) % n, (r - 1) % n
    a0, p0 = (pvar.pvar_read("btl_shm_adoptions"),
              pvar.pvar_read("btl_shm_seg_packs"))
    w.barrier()                  # no message lands before the counts
    req = w.irecv(left, tag=21)
    w.send(xs[r], right, tag=21)
    got = req.get()
    check(np.array_equal(got, xs[left]), f"rank {r}: zero-copy pt2pt")
    del got
    check(pvar.pvar_read("btl_shm_adoptions") - a0 == 1 and
          pvar.pvar_read("btl_shm_seg_packs") - p0 == 1,
          f"rank {r}: pt2pt did not ride the shared segment "
          f"({pvar.pvar_read('btl_shm_adoptions') - a0} adoptions, "
          f"{pvar.pvar_read('btl_shm_seg_packs') - p0} packs)")
    var.var_set("mpi_base_shm_zerocopy", False)
    w.barrier()
    ring_med = statistics.median(ring_ms[1] + ring_ms[2])
    lines.append(f"in-segment fold SUM, {mb} MB f32 per rank: "
                 f"{ms_fold:.1f} ms per fold (host clock) against the "
                 f"pipelined ring's {ring_med:.1f} (median of the four "
                 f"turns); MAX bit for bit, SUM "
                 f"rtol 1e-5; pt2pt adopted in place (btl_shm_adoptions "
                 f"+1, btl_shm_seg_packs +1 on every rank)")

    # a CUDA tensor through the pipeline, against the devxfer ring
    x = torch.from_numpy(xs[r]).to(dev)

    def ring(tag):
        buf = x.clone()
        q = w.irecv(left, tag=tag)
        w.send(buf, right, tag=tag)
        buf.fill_(-1.0)                  # the sender overwrites its buffer
        return q.get()
    var.var_set("btl_devxfer_min_bytes", 1 << 40)
    st0, recv0 = pipeline.stats["staged"], w.router.xfer.stats["received"]
    w.barrier()
    z, ms_pipe = _dp_timed(lambda: ring(31))
    # a CUDA payload arrives as numpy, as on the eager path
    check(np.array_equal(z if isinstance(z, np.ndarray) else z.numpy(),
                         xs[left]),
          f"rank {r}: pipelined CUDA message changed")
    staged = pipeline.stats["staged"] - st0
    check(staged > 0 and w.router.xfer.stats["received"] == recv0,
          f"rank {r}: the CUDA tensor did not go through SegmentStager")
    var.var_set("btl_devxfer_min_bytes", 1 << 20)
    w.barrier()
    zd, ms_xfer = _dp_timed(lambda: ring(32))
    check(np.array_equal(zd.cpu().numpy(), xs[left]),
          f"rank {r}: devxfer message changed")
    lines.append(f"CUDA tensor ring, 8 x {mb} MB, devxfer declined: "
                 f"{ms_pipe:.1f} ms per message through SegmentStager "
                 f"({staged // 4} segments staged per message) against "
                 f"{ms_xfer:.1f} ms through devxfer in the same job (host "
                 f"clock, median of 3)")

    # compressed host hops, with the pipeline off so the bcast takes the
    # compressed tree, not the chain
    full = np.stack([a[:1 << 19] for a in xs])           # 2 MB per rank
    mine = full[r]
    ref = full.astype(np.float64).sum(0)
    sub = w.split(r // 4, key=r)                        # two comms of 4
    members = [j for j in range(n) if j // 4 == r // 4]
    sub_ref = full[members].astype(np.float64).sum(0)
    var.var_set("mpi_base_pipeline_enable", False)
    var.var_set("mpi_base_compress", True)
    var.var_set("mpi_base_compress_min_bytes", 1 << 20)
    ratios = []
    for codec in ("int8_block", "fp8_block"):
        var.var_set("mpi_base_compress_codec", codec)
        scale = ENVELOPE_SCALE[codec]
        d0 = c["coll_compress_direct"]
        bi0 = pvar.pvar_read("compress_bytes_in")
        bo0 = pvar.pvar_read("compress_bytes_out")
        ya = sub.allreduce(mine, MPI.SUM)
        check(c["coll_compress_direct"] == d0 + 1,
              f"rank {r}: {codec} direct allreduce did not run")
        check(np.abs(ya - sub_ref).max() <= 0.02 * np.abs(sub_ref).max()
              * scale, f"rank {r}: {codec} direct allreduce envelope")
        check(_same_everywhere(sub, ya), f"{codec} direct: ranks differ")
        red = w.reduce(mine, MPI.SUM, root=2)
        if r == 2:
            check(np.abs(red - ref).max() <= 0.02 * np.abs(ref).max()
                  * scale, f"{codec} reduce envelope")
        bc = w.bcast(mine if r == 5 else None, 5)
        check(np.abs(bc - full[5]).max() <= np.abs(full[5]).max() / 64
              * scale, f"rank {r}: {codec} bcast envelope")
        import hashlib
        digests = w.allgather(hashlib.sha1(bc.tobytes()).hexdigest())
        check(len({d for j, d in enumerate(digests) if j != 5}) == 1,
              f"{codec} bcast: the receiving ranks differ")
        ratios.append(
            (pvar.pvar_read("compress_bytes_out") - bo0)
            / max(pvar.pvar_read("compress_bytes_in") - bi0, 1))
        lines.append(f"compressed host hops {codec}, 2 MB f32 per rank: "
                     f"direct allreduce (comms of 4), reduce and bcast "
                     f"within the envelope x{scale:.3g}; wire ratio "
                     f"{ratios[-1]:.4f} (compress_ratio pvar "
                     f"{pvar.pvar_read('compress_ratio'):.4f})")
    var.var_set("mpi_base_compress", False)
    var.var_set("mpi_base_pipeline_enable", True)
    sub.free()

    # persistent plans on the per-rank tier
    def per_call_us(fn, reps=200):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6
    pd = w.allreduce_init(x, MPI.SUM)
    check(pd.plan.algorithm == "generic", f"device plan {pd.plan.algorithm}")
    pd.start()
    pd.wait()
    check(torch.equal(pd.get(), w.allreduce(x, MPI.SUM)),
          f"rank {r}: device-tier plan differs from the one-shot call")
    var.var_set("coll_tuned_stage_min_bytes", 1 << 20)
    h = xs[r][:1 << 20].copy()
    ps = w.allreduce_init(h, MPI.SUM)
    check(ps.plan.algorithm == "staged_device",
          f"staged plan {ps.plan.algorithm}")
    check(accelerator.current_module().is_host_registered(h),
          "the staged plan's buffer is not registered")
    ps.start()
    ps.wait()
    check(np.array_equal(ps.get(), w.allreduce(h, MPI.SUM)),
          f"rank {r}: staged plan differs from the one-shot call")
    b8 = np.full(1, float(r + 1))
    p8 = w.allreduce_init(b8, MPI.SUM)
    check(p8.plan.algorithm == "small_combine",
          f"8 B plan {p8.plan.algorithm}")

    def start_wait():
        p8.start()
        p8.wait()
    w.barrier()
    sw_us = per_call_us(start_wait)
    w.barrier()
    one_us = per_call_us(lambda: w.allreduce(b8, MPI.SUM))
    check(p8.get()[0] == w.allreduce(b8, MPI.SUM)[0] == n * (n + 1) / 2,
          f"rank {r}: 8 B plan")
    var.var_set("mpi_base_bucket", True)
    leaves = [np.full(64 + j, float(j + r), np.float32) for j in range(14)]
    plans = [w.allreduce_init(leaf, MPI.SUM) for leaf in leaves]
    fl0 = pvar.pvar_read("coll_bucket_flushes")
    MPI.Startall(plans)
    outs = [q.get() for q in plans]
    flushes = pvar.pvar_read("coll_bucket_flushes") - fl0
    var.var_set("mpi_base_bucket", False)
    for leaf, out in zip(leaves, outs):
        check(np.array_equal(out, w.allreduce(leaf, MPI.SUM)),
              f"rank {r}: bucketed plan differs")
    check(1 <= flushes < 14, f"rank {r}: {flushes} flushes for 14 plans")
    lines.append(f"persistent plans: device tier (generic), staged numpy "
                 f"on pinned pages (staged_device), 8 B (small_combine) "
                 f"bit for bit against the one-shot calls; 8 B "
                 f"Start+Wait {sw_us:.1f} us against {one_us:.1f} us per "
                 f"one-shot allreduce (host clock, 200 calls); Startall "
                 f"over 14 plans: {flushes} fused flush(es)")
    MPI.Finalize()
    if r == 0:
        with open(report, "w") as f:
            json.dump(lines, f)
    print(f"OK dataplane rank={r}/{n}", flush=True)
    return 0


def _tuned_single(w, smi: str) -> None:
    """The tuned component on the single-controller world: a numpy
    (8, 1 MiB fp32) stack returns numpy equal to coll/torch on the same
    tensor, staged (bit for bit) and on the host (rtol 1e-5)."""
    x = np.random.default_rng(DP_SEED).standard_normal(
        (w.size, 1 << 18)).astype(np.float32)
    mod = w._coll("allreduce")
    check(w._coll_winners["allreduce"] == "tuned", "tuned did not win")
    want = mod.device.allreduce(torch.from_numpy(x).to("cuda"),
                                MPI.SUM).cpu().numpy()
    y = w.allreduce(x, MPI.SUM)          # the probe-earned route
    from ompi_tpu_torch.coll import tuned
    basis = tuned.probed_stage_basis()
    check(isinstance(y, np.ndarray) and basis.get("device") == "cuda",
          f"numpy in gave {type(y)}; probe {basis}")
    times = {}
    for route, smin in (("staged", 0), ("host", 1 << 62)):
        var.var_set("coll_tuned_stage_min_bytes", smin)
        got = w.allreduce(x, MPI.SUM)
        check(isinstance(got, np.ndarray), f"{route}: {type(got)}")
        if route == "staged":
            check(np.array_equal(got, want), "staged: differs from "
                  "coll/torch on the same tensor")
        else:
            check(np.allclose(got, want, rtol=1e-5, atol=1e-5),
                  "host: differs from coll/torch on the same tensor")
        times[route] = host_ms(lambda: w.allreduce(x, MPI.SUM))
    phase("dataplane", f"tuned: numpy (8, 1 MiB f32) allreduce returns "
          f"numpy = coll/torch; staged {times['staged']:.3f} ms, host "
          f"{times['host']:.3f} ms (host clock); the single-controller "
          f"probe: staged {basis.get('staged_per_mb_ms')} ms/MB against "
          f"host {basis.get('host_per_mb_ms')} ms/MB, stage_min_bytes "
          f"{basis.get('stage_min_bytes')} (-1: never stage) | {smi}")


def _run_job(rank_flag: str, mca) -> list:
    """Launch 8 rank processes of this script and return rank 0's
    lines."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "rank0.json")
        cmd = [sys.executable,
               os.path.join(root, "ompi_tpu_torch", "tools", "mpirun.py"),
               "--per-rank", "-n", str(PR_RANKS), "--timeout",
               str(PR_TIMEOUT)]
        for k, v in mca:
            cmd += ["--mca", k, str(v)]
        cmd += [os.path.abspath(__file__), rank_flag, report]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=PR_TIMEOUT + 60, cwd=root)
        oks = res.stdout.count("OK ")
        if res.returncode != 0 or oks != PR_RANKS:
            sys.stderr.write(res.stderr[-6000:])
            check(False, f"per-rank job rc={res.returncode}, {oks} "
                  f"of {PR_RANKS} ranks OK:\n{res.stdout[-3000:]}")
        with open(report) as f:
            return json.load(f)


def phase_dataplane(smi: str) -> None:
    """The per-rank large-message data plane, 8 rank processes on
    cuda:0."""
    t0 = time.perf_counter()
    lines = _run_job("--dataplane-rank", [("mpi_base_btl_rails", 2),
                                          ("mpi_base_shm_seg_count", 2)])
    for line in lines:
        phase("dataplane", f"{line} | {smi}")
    phase("dataplane", f"8 rank processes on cuda:0, every check passed on "
          f"every rank; phase 12 took {time.perf_counter() - t0:.1f} s "
          f"| {smi}")


def main() -> int:
    if "--perrank-rank" in sys.argv:
        return _perrank_rank(sys.argv[-1])
    if "--dataplane-rank" in sys.argv:
        return _dataplane_rank(sys.argv[-1])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if "--perrank" in sys.argv:
        smi, _ = phase_device()
        phase_perrank(smi)
        MPI.Init(devices=[torch.device("cuda", 0)] * N_RANKS)
        _tuned_single(MPI.get_comm_world(), smi)
        MPI.Finalize()
        torch.cuda.empty_cache()
        phase_dataplane(smi)
        return 0
    t0 = time.perf_counter()
    smi, kind = phase_device()
    phase_build()
    kern, checked = phase_kernels()
    MPI.Init(devices=[torch.device("cuda", 0)] * N_RANKS)
    world = MPI.get_comm_world()
    phase_collectives(world)
    launches = phase_flagship()
    phase_train(smi)
    t7 = time.perf_counter()
    phase_nonblocking_journey(world, smi)
    phase_ddp(world, smi)
    phase("nonblocking", f"phase 7 took {time.perf_counter() - t7:.1f} s "
          f"| {smi}")
    phase_algorithms(world, smi)
    phase_compression(world, smi)
    phase_ptp_topo_datatype(world, smi)
    _tuned_single(world, smi)
    MPI.Finalize()
    torch.cuda.empty_cache()
    phase_perrank(smi)
    phase_dataplane(smi)
    main = kern[("entry", "1")]        # the main path's fold
    record = {"kernels": [{
        "name": "flash_fold", "route": "cuda",
        "source": "ompi_tpu_torch/csrc/flash_fold.cu",
        "replaces": "ompi_tpu/ops/flash_attention.py:72",
        "launches": launches,
        **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")},
        "shapes": list(kern.values()),
        "checks": checked,
    }]}
    phase("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
