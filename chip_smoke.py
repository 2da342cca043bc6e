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
13. observe   — on the live 8-rank world on ``cuda:0``, before
                ``Finalize``: tracing and monitoring on for a ``dup()``,
                each of allreduce, bcast, reduce, allgather, gather,
                scatter, alltoall,
                reduce_scatter_block, scan and barrier at 32 MB fp32 per
                rank, twice: bit for bit the plain world's result, one
                ``coll_<func>`` span per call (the dup's cid, seq 0 and 1),
                a Perfetto export that loads as JSON, monitoring bytes equal
                to the payloads, SPC counts equal to the calls; a ring of 64
                under 1000 calls counting its drops; host µs per 8 B
                allreduce with tracing off and on, and with the SPC
                counters off and on, each in turns. uint16/32/64 x
                SUM, PROD, MAX, MIN, BAND on tensors and staged numpy stacks,
                exact against numpy. ``pml_v_protocol=pessimist``: wildcard
                receives of 1 MiB CUDA tensors logged, a replay from the
                JSON snapshot forcing the logged order, redelivery bit for
                bit after the senders overwrote their buffers. Then 8 rank
                processes on ``cuda:0`` with tracing on
                (``--observe-rank``; 300 s launcher limit): rank 5 sleeps
                200 ms before the third 32 MB device allreduce, every rank
                dumps its spans and rank 0's ``late_arrival`` must name rank
                5 with a skew of at least 150 ms; a 32 MB host-tier ring
                with ``pml_send``, ``pml_recv``, ``pml.segment`` and
                ``btl.rail`` spans and one ``coll_allreduce`` span per call;
                ``coll_sync_barrier_before=3`` leaving results unchanged; a
                32 MB CUDA tensor sent from rank 0 to rank 1 in 4
                partitions (``pready`` 2, 0, 1, 3), twice through the same
                requests, bit for bit; µs per 8 B round trip with tracing
                off and on, in turns.
14. resilience — on the live 8-rank world on ``cuda:0``, before
                ``Finalize``: telemetry on for a ``dup()`` (every slot
                wrapped), the Standard collectives at 32 MB per rank
                against numpy, calls counted per func, the 32 MB
                allreduce histogram's p50 beside its CUDA-event time; the
                dup's ``trace_skew_c<cid>`` and histogram pvars gone after
                ``free()``; Prometheus text and a telemetry dump; host µs
                per 8 B allreduce with the plane off and on, in turns.
                ``fail_rank(3)``: allreduce, send and recv naming rank 3
                raise ``ERR_PROC_FAILED``; revoke, agree (reporting rank
                3) and shrink to 7 ranks; the 32 MB allreduce on the
                survivors' rows of the stacked tensor against numpy, ms
                before and after; ``BucketedGradSync.shrink`` and one
                full-width DDP step on the 7 ranks against the in-graph
                pmean step; ``probe_devices`` on the 8 handles. Then 8
                rank processes on ``cuda:0`` (``--resilience-rank``,
                ``mpirun --enable-recovery``, telemetry, heartbeats at
                p34's settings and the zero-copy pools on): rank 5 exits
                at its 2nd allreduce; the survivors detect it within 2x
                the heartbeat timeout with nobody else declared, revoke,
                agree and shrink, run a 32 MB CUDA allreduce on the 7 and
                a devxfer ring against exact sums, and leave flight
                records that ``flightrec.merge`` reads as an incident
                naming rank 5; the job's rc is 137, no survivor's stderr
                shows a CUDA error, and no ``otpt*`` file of the job is
                left in ``/dev/shm``.
                ``python3 chip_smoke.py --perrank`` runs phases 1, 11, 12,
                13 and 14's job alone; ``--resilience`` runs phases 1 and
                14 alone.
15. sessions  — on the 8-rank world before phase 14 fails a rank of it,
                32 MB fp32 per rank: (a) two ``Session(devices=[cuda:0] *
                8)`` with ``ring`` and ``recursive_doubling`` in their own
                var scopes (the world keeps ``auto``): each session's
                deferred iallreduce builds only its algorithm, its
                allreduce = numpy, ``selected()`` names it, CIDs come from
                its own space, a failure injected in one session's
                registry stays there, finalize frees every comm; 8 B
                allreduce host us on a session comm against the world in
                turns. (b) ``Comm_spawn(child_main, 4, world)``: a 4-row
                child on ``cuda:0``; the intercomm's bcast, allreduce,
                allgather and alltoall against numpy with every output on
                the card; ``merge`` to 12 rows; ports,
                names, join and disconnect; the intercomm allreduce's
                device ms. (c) han (``coll_han_split=4``) and xhc (``2,2``
                and the auto ladder) on dups of the world against numpy and
                against coll/torch's direct lowering (MAX and int32 bit for
                bit, float SUM rtol 1e-5), a small han message going
                flat; adapt's 1 MB segments at 32 MB against the blocking
                calls bit for bit, the callback once; device ms beside
                direct's (no gain is claimed). (d) acoll's empty detection
                on the card, ``mem_alloc``, ``event_synchronize``, the
                in-process IPC round trip, the device queries. In a fresh
                process (``--fresh-check``), no ``Memcpy DtoH`` event
                inside the intercomm, han and xhc calls (torch.profiler,
                with a ``.cpu()`` control: this process's profiler stops
                reporting memcpy records after phases 3 and 4), and the
                8 B allreduce on a session comm against the world again.
                Then,
                after phase 14's job, (e) two 2-rank jobs bridged through
                ``dpm_perrank`` (messages both ways from every rank, a CUDA
                tensor arriving as numpy with the same bits) and a 3-rank
                job running two sessions on CUDA tensors over the device
                tier, all three at once, each under a 60 s limit.
                ``python3 chip_smoke.py --sessions`` runs phases 1 and 15
                alone.
16. onesided  — on the 8-rank world before phase 14 fails a rank of it:
                (a) the native host library (g++ of ``native/*.cpp``,
                built in phase 2 beside nvcc): every entry point the paths
                call, counted through a wrapper swapped in for
                ``native.get_lib``; the per-rank host fold (SUM, MAX) on 8
                numpy rows of 32 MB fp32, coll/basic's BAND/BXOR/LAND fold
                on int32, reduce_local over 10 dtypes x 10 ops with NaNs,
                a vector and an indexed type packed and unpacked from a
                (4096, 2048) host matrix, each bit for bit against its
                numpy route with host ms beside it; the 8 x 32 MB ring and
                256 wildcard matches with the native matching core and the
                Python one, in the same order. (b) ``Win`` on ``cuda:0``, 8
                x 32 MB fp32: put ring, get, accumulate SUM/MAX/REPLACE/
                NO_OP (and on uint32), get_accumulate, fetch_and_op,
                compare_and_swap, rput/raccumulate, PSCW, lock, attach,
                against numpy, every row on the card; device ms of a 32 MB
                put and accumulate from a CUDA and a numpy origin beside
                their bounds. (c) after phase 15's jobs, all at once: p43
                on osc/shm (with a telemetry dump's ``osc`` section and a
                flight record's ``osc_epochs``) and on osc/pt2pt, 4 ranks
                at 32 MB per window from CUDA origins; p13 on 3 ranks; p44
                (rank 2 SIGKILLed in a fence epoch, rc 247, no ``otpt*``
                file left); and in a fresh process (``--osc-fresh-check``)
                0 ``Memcpy DtoH`` in put and accumulate from a CUDA origin,
                with a ``.cpu()`` control. The phase must end within 90 s.
                ``python3 chip_smoke.py --onesided`` runs phases 1 and 16
                alone.

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
    """Every CUDA kernel (one nvcc per source) and, beside them on a
    thread, the native host library (g++ of native/*.cpp)."""
    import threading
    from ompi_tpu_torch import native
    from ompi_tpu_torch.native import loader
    t0 = time.perf_counter()
    host = threading.Thread(target=native.get_lib)
    host.start()
    built = _build.build_all(verbose=True)
    host.join()
    for name, rec in built.items():
        phase("build", f"{name}: {rec['seconds']:.2f} s "
              f"{' | '.join(_ptxas_summary(rec['log']))}")
    check(native.native_available(), f"the native library did not build: "
          f"{native.build_error()}")
    phase("build", f"native host library {loader.lib_path().name}: "
          f"{loader.build_seconds():.2f} s (g++ -O3, native/*.cpp)")
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


# -- phase 13 ----------------------------------------------------------
OBS_SEED = 1300
OBS_COLLS = ("allreduce", "bcast", "reduce", "allgather", "gather",
             "scatter", "alltoall", "reduce_scatter_block", "scan",
             "barrier")


def _obs_args(w, func, x):
    """The arguments of one call of ``func`` on the stacked ``x``."""
    n = w.size
    return {"allreduce": (x, MPI.SUM), "bcast": (x, 3),
            "reduce": (x, MPI.SUM, 2), "allgather": (x,),
            "gather": (x, 1), "scatter": (x, 4),
            "alltoall": (x.view(n, n, -1),),
            "reduce_scatter_block": (x.view(n, n, -1), MPI.SUM),
            "scan": (x, MPI.SUM), "barrier": ()}[func]


def _obs_same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return bool(torch.equal(a, b))


def _obs_8b_us(comm, calls: int = 2000) -> float:
    """Host µs per 8 B allreduce on ``comm`` (synchronised at the end)."""
    small = comm.alloc((2,), dtype=torch.float32, fill=1.0)
    comm.allreduce(small, MPI.SUM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        comm.allreduce(small, MPI.SUM)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def _obs_tracing(w, dev, elems: int) -> list:
    """13(a): every collective once per round, two rounds, on a dup
    built with monitoring and tracing on, against the same calls on the
    plain world."""
    from ompi_tpu_torch import trace
    from ompi_tpu_torch.coll import monitoring
    from ompi_tpu_torch.runtime import spc
    n = w.size
    g = torch.Generator(device=dev).manual_seed(OBS_SEED)
    x = torch.rand((n, elems), generator=g, device=dev)
    trace.enable()
    trace.reset()
    var.var_set("coll_monitoring_enable", True)
    d = w.dup()
    var.var_set("coll_monitoring_enable", False)
    monitoring.reset()
    spc_before = spc.snapshot()
    for _ in range(2):
        for func in OBS_COLLS:
            args = _obs_args(w, func, x)
            want = getattr(w, func)(*args)
            got = getattr(d, func)(*args)
            check(_obs_same(got, want), f"traced {func} differs from the "
                  f"untraced call")
    torch.cuda.synchronize()
    spans = trace.spans()
    for func in OBS_COLLS:
        mine = [s for s in spans if s.name == f"coll_{func}"]
        check([s.seq for s in mine] == [0, 1]
              and all(s.cid == str(d.cid) for s in mine),
              f"coll_{func} spans {[(s.cid, s.seq) for s in mine]}")
    check(all(s.name.startswith("coll_") for s in spans),
          f"unexpected spans {sorted({s.name for s in spans})}")
    export = json.loads(json.dumps(trace.perfetto.export(spans)))
    check(len([e for e in export["traceEvents"] if e["ph"] == "X"])
          == 2 * len(OBS_COLLS), "perfetto export")
    snap = monitoring.snapshot()
    for func in OBS_COLLS:
        args = _obs_args(w, func, x)
        nbytes = args[0].nbytes if args else 0
        check(snap.get((d.cid, func)) == (2, 2 * nbytes),
              f"monitoring {func}: {snap.get((d.cid, func))}")
    spc_after = spc.snapshot()
    for func in OBS_COLLS:
        key = f"coll_{func}"
        check(spc_after.get(key, 0) - spc_before.get(key, 0) == 4,
              f"spc {key}: {spc_after.get(key, 0) - spc_before.get(key, 0)}"
              f" for 4 calls")
    lines = [f"tracing: 10 collectives x 2 rounds at {elems * 4 >> 20} MB "
             f"fp32 per rank on a dup with monitoring and tracing on = the "
             f"plain world bit for bit; one coll_<func> span per call, cid "
             f"{d.cid}, seq 0, 1; Perfetto export loads as JSON; monitoring "
             f"bytes = payloads; SPC coll_<func> +4 per function (2 traced, "
             f"2 untraced calls)"]
    d.free()
    # a small ring under many calls: drops are counted, never block
    trace.enable(capacity=64)
    dt = w.dup()
    small = dt.alloc((2,), dtype=torch.float32, fill=1.0)
    for _ in range(1000):
        dt.allreduce(small, MPI.SUM)
    st = trace.stats()
    check(st["spans"] == 64 and st["dropped"] == 936
          and pvar.pvar_read("trace_dropped") == 936,
          f"ring of 64 under 1000 calls: {st}")
    lines.append(f"ring of 64 under 1000 allreduces: trace_spans "
                 f"{pvar.pvar_read('trace_spans')}, trace_dropped "
                 f"{pvar.pvar_read('trace_dropped')}")
    # host µs per 8 B allreduce, tracing off (the plain world, unwrapped)
    # and on (the traced dup), in turns a b b a
    trace.enable(capacity=1 << 16)
    us = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        trace.reset()
        us[mode].append(_obs_8b_us(w if mode == "off" else dt))
    dt.free()
    trace.disable()
    trace.reset()
    lines.append("8 B allreduce host us/call, tracing off then on, in "
                 "turns (off on on off): "
                 + ", ".join(f"{u:.2f}" for u in (us["off"][0], *us["on"],
                                                   us["off"][1])))
    # host µs per 8 B allreduce on the plain world with the SPC counters
    # off and on (``mpi_base_spc_enable``; tracing off), in turns a b b a.
    # spc.reset() makes record() read the switch again.
    spc_us = {False: [], True: []}
    try:
        for on in (False, True, True, False):
            var.var_set("mpi_base_spc_enable", on)
            spc.reset()
            spc_us[on].append(_obs_8b_us(w))
    finally:
        var.var_set("mpi_base_spc_enable", True)
        spc.reset()
    lines.append("8 B allreduce host us/call, SPC off then on, in turns "
                 "(off on on off): "
                 + ", ".join(f"{u:.2f}" for u in (spc_us[False][0],
                                                   *spc_us[True],
                                                   spc_us[False][1])))
    return lines


def _obs_unsigned(w, dev) -> str:
    """13(b): unsigned reductions on the card, on a tensor and on a numpy
    stack staged above stage_min, exact against numpy."""
    n = w.size
    rng = np.random.default_rng(OBS_SEED + 1)
    ops = {"SUM": np.add, "PROD": np.multiply, "MAX": np.maximum,
           "MIN": np.minimum, "BAND": np.bitwise_and}
    cases = 0
    saved = var.var_get("coll_tuned_stage_min_bytes")
    var.var_set("coll_tuned_stage_min_bytes", 4096)
    try:
        for dt in (np.uint16, np.uint32, np.uint64):
            x = rng.integers(0, np.iinfo(dt).max, size=(n, 4096), dtype=dt,
                             endpoint=True)
            for name, fold in ops.items():
                want = np.broadcast_to(fold.reduce(x, 0, dtype=dt), x.shape)
                op = getattr(MPI, name)
                t = w.allreduce(torch.from_numpy(x).to(dev), op)
                check(t.device == dev and t.dtype == torch.from_numpy(x).dtype
                      and np.array_equal(t.cpu().numpy(), want),
                      f"{name} {np.dtype(dt).name} tensor on the card")
                h = w.allreduce(x.copy(), op)
                check(isinstance(h, np.ndarray) and h.dtype == dt
                      and np.array_equal(h, want),
                      f"{name} {np.dtype(dt).name} staged numpy")
                cases += 2
    finally:
        var.var_set("coll_tuned_stage_min_bytes", saved)
    return (f"unsigned reductions: uint16/32/64 x SUM, PROD, MAX, MIN, BAND "
            f"on (8, 4096) tensors on {dev} and numpy stacks staged above "
            f"stage_min (4096 B): {cases} cases exact against numpy, "
            f"operand type kept, every tensor result on {dev}")


def _obs_vprotocol(w, dev, elems: int) -> str:
    """13(c): pessimist logging of wildcard receives of CUDA tensors; a
    replay from the JSON snapshot forces the logged order; redelivery
    gives the logged bits after the senders overwrote their buffers."""
    from ompi_tpu_torch.pml import vprotocol
    var.var_set("pml_v_protocol", "pessimist")
    c = w.dup()
    check(isinstance(c._pml, vprotocol.PessimistEngine), "pessimist engine")
    var.var_set("pml_v_protocol", "none")    # the engine is chosen once
    g = torch.Generator(device=dev).manual_seed(OBS_SEED + 2)
    bufs = {s: torch.rand(elems, generator=g, device=dev)
            for s in (1, 2, 3, 4)}
    keep = {s: b.clone() for s, b in bufs.items()}
    # wildcard receives posted first match in arrival order
    reqs = [c.irecv(MPI.ANY_SOURCE, MPI.ANY_TAG, dst=0) for _ in range(4)]
    for s in (3, 1, 4, 2):
        c.send(bufs[s], s, 0, tag=10 + s)
    order = [q.wait().source for q in reqs]
    check(order == [3, 1, 4, 2], f"arrival order {order}")
    for q, s in zip(reqs, order):
        check(q.get().device == dev and torch.equal(q.get(), keep[s]),
              "wildcard payload")
    snap = json.dumps(c._pml.snapshot())
    log = vprotocol.PessimistEngine.restore_log(json.loads(snap))
    check(sum(e.kind == "match" for e in log) == 4, "determinants logged")
    rep = vprotocol.PessimistEngine(c, replay_log=log)
    reqs = [rep.irecv(0, MPI.ANY_SOURCE, MPI.ANY_TAG) for _ in range(4)]
    for s in (2, 4, 1, 3):                   # another arrival order
        rep.send(keep[s], s, 0, 10 + s)
    again = [q.wait().source for q in reqs]
    check(again == order, f"replay order {again} != {order}")
    for b in bufs.values():
        b.fill_(-1.0)                        # the senders reuse buffers
    fresh = vprotocol.PessimistEngine(c, replay_log=log)
    fresh.log = log
    check(fresh.redeliver(0) == 4, "redeliver count")
    for _ in range(4):
        data, st = fresh.recv(0, MPI.ANY_SOURCE, MPI.ANY_TAG)
        check(data.device == dev and torch.equal(data, keep[st.source]),
              "redelivered payload")
    torch.cuda.synchronize()
    c.free()
    return (f"vprotocol pessimist: 4 wildcard receives of {elems * 4 >> 20} "
            f"MiB CUDA tensors logged (order {order}); a replay from the "
            f"JSON snapshot ({len(snap) >> 20} MiB) forced that order; "
            f"redeliver gave the logged bits on {dev} after the senders "
            f"overwrote their buffers")


def _observe_rank(report: str) -> int:
    """The rank program of phase 13 (run by mpirun --per-rank with
    tracing on); rank 0 writes its lines to ``report``."""
    from ompi_tpu_torch import trace
    from ompi_tpu_torch.pml import part_perrank as part
    MPI.Init()
    w = MPI.get_comm_world()
    r, n = w.rank(), w.size
    dev = w.device
    check(trace.is_active() and w._coll_interposers == ["trace"],
          f"rank {r}: tracing not armed ({w._coll_interposers})")
    lines = []
    out_dir = os.path.dirname(report)
    late = 5 if n > 5 else n - 1
    mb = LOCAL_ELEMS * 4 >> 20
    # device-tier allreduce, 32 MB per rank; exact sums whatever the order
    base = (torch.arange(LOCAL_ELEMS, device=dev) % 1024).float()
    x = base + r
    want = base * n + n * (n - 1) / 2
    for i in range(4):
        if i == 2 and r == late:
            time.sleep(0.2)
        got = w.allreduce(x, MPI.SUM)
        check(got.device == dev and torch.equal(got, want),
              f"rank {r}: device allreduce {i}")
    # host-tier pipelined ring, 32 MB per rank
    var.var_set("coll_tuned_stage_min_bytes", 1 << 62)
    xh = (np.arange(LOCAL_ELEMS) % 1024).astype(np.float32) + r
    ring = w.allreduce(xh, MPI.SUM)
    check(np.array_equal(ring, want.cpu().numpy()), f"rank {r}: host ring")
    # coll/sync: a barrier before every 3rd collective changes nothing
    var.var_set("coll_sync_barrier_before", 3)
    ws = w.dup()
    var.var_set("coll_sync_barrier_before", 0)
    check(ws._coll_interposers == ["sync", "trace"], "sync interposer")
    for i in range(7):
        check(torch.equal(ws.allreduce(x, MPI.SUM), want)
              and float(ws.allreduce(np.float64(i), MPI.SUM)) == i * n,
              f"rank {r}: allreduce under coll/sync")
    ws.free()
    # part_perrank: rank 0 sends rank 1 a 32 MB CUDA tensor in 4 parts
    q = LOCAL_ELEMS // 4
    src = torch.rand(LOCAL_ELEMS, generator=torch.Generator(
        device=dev).manual_seed(OBS_SEED + 3), device=dev)
    if r == 0:
        ps = part.psend_init(w, [src[k * q:(k + 1) * q] for k in range(4)],
                             dest=1, tag=9)
    elif r == 1:
        pr = part.precv_init(w, 4, source=0, tag=9)
    polls = 0
    for rnd in range(2):
        if r == 0:
            ps.start()
            for k in (2, 0, 1, 3):
                ps.pready(k)
            ps.wait()
        elif r == 1:
            pr.start()
            polls += 1
            while not all(pr.parrived(k) for k in range(4)):
                polls += 1                   # rounds of parrived polls
            pr.wait(timeout=120)
            got = torch.cat(pr.get())
            check(got.device == dev and torch.equal(got, src * 2 ** rnd),
                  f"partitioned round {rnd}")
        w.barrier()
        if r == 0:
            src.mul_(2.0)        # the sender rewrites its partitions' data
    torch.cuda.synchronize()
    trace.dump(os.path.join(out_dir, f"trace_r{r}.json"))
    names = [s.name for s in trace.spans()]
    counts = {k: names.count(k) for k in
              ("coll_allreduce", "coll_barrier", "pml_send", "pml_recv",
               "pml.segment", "btl.rail")}
    check(counts["coll_allreduce"] == 5 + 14,
          f"rank {r}: coll_allreduce spans {counts['coll_allreduce']}")
    for k in ("pml_send", "pml_recv", "pml.segment", "btl.rail"):
        check(counts[k] > 0, f"rank {r}: no {k} span")
    w.barrier()
    if r == 0:
        spans = []
        for j in range(n):
            spans += trace.load_dump(
                os.path.join(out_dir, f"trace_r{j}.json"))["spans"]
        reps = trace.attribution.late_arrival(spans)
        third = [p for p in reps if p["name"] == "coll_allreduce"
                 and p["cid"] == str(w.cid) and p["seq"] == 2]
        check(len(third) == 1 and third[0]["nranks"] == n
              and third[0]["critical_rank"] == late
              and third[0]["skew_s"] >= 0.15,
              f"attribution of the third allreduce: {third}")
        json.dumps(trace.perfetto.export(spans))
        lines.append(
            f"per-rank job, tracing on: spans on rank 0 {counts}; "
            f"late_arrival names rank {third[0]['critical_rank']} of the "
            f"third {mb} MB device allreduce with skew "
            f"{third[0]['skew_s'] * 1e3:.1f} ms (rank {late} slept 200 ms); "
            f"worst occurrence of the run: {reps[0]['name']} seq "
            f"{reps[0]['seq']} ({reps[0]['skew_s'] * 1e3:.1f} ms)")
        lines.append(f"host ring ({mb} MB per rank) and device allreduces "
                     f"= exact sums; coll_sync_barrier_before=3 left 14 "
                     f"results unchanged; part_perrank {mb} MB tensor in 4 "
                     f"partitions (pready 2, 0, 1, 3), two rounds through "
                     f"the same requests, bit for bit on {dev}")
    # µs per 8 B round trip between ranks 0 and 1, tracing off and on
    b8 = np.zeros(1, np.float64)
    rt = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        (trace.enable if mode == "on" else trace.disable)()
        w.barrier()
        if r in (0, 1):
            reps_ = 200
            t0 = time.perf_counter()
            for _ in range(reps_):
                if r == 0:
                    w.send(b8, 1, tag=5)
                    w.recv(1, tag=5)
                else:
                    w.recv(0, tag=5)
                    w.send(b8, 0, tag=5)
            rt[mode].append((time.perf_counter() - t0) / reps_ * 1e6)
    trace.disable()
    polls = w.allgather(polls)[1]            # rank 1 polled
    if r == 0:
        lines.append(f"8 B round trip (ranks 0 and 1) host us, tracing off "
                     f"then on, in turns (off on on off): "
                     + ", ".join(f"{u:.1f}" for u in (
                         rt["off"][0], *rt["on"], rt["off"][1]))
                     + f"; rank 1 polled parrived in {polls} rounds over "
                     f"the 2 partitioned rounds")
    w.barrier()
    MPI.Finalize()
    if r == 0:
        with open(report, "w") as f:
            json.dump(lines, f)
    print(f"OK observe rank={r}/{n}", flush=True)
    return 0


def phase_observe_world(w, smi: str) -> float:
    """Phase 13, first half: tracing, monitoring and SPC on the 8-rank
    world, the unsigned reductions and the pessimist engine on the card.
    Returns the seconds it took."""
    t0 = time.perf_counter()
    dev = w.device
    for line in _obs_tracing(w, dev, LOCAL_ELEMS):
        phase("observe", f"{line} | {smi}")
    phase("observe", _obs_unsigned(w, dev))
    phase("observe", _obs_vprotocol(w, dev, 1 << 18))
    return time.perf_counter() - t0


def phase_observe_job(smi: str, world_s: float) -> None:
    """Phase 13, second half: the traced per-rank job."""
    t0 = time.perf_counter()
    for line in _run_job("--observe-rank", [("mpi_base_trace_enable", 1)]):
        phase("observe", f"{line} | {smi}")
    phase("observe", f"phase 13 took {world_s + time.perf_counter() - t0:.1f}"
          f" s | {smi}")


# -- phase 14 ----------------------------------------------------------
RES_SEED = 1400
RES_VICTIM = 5                 # the per-rank job's killed rank
RES_HB_TIMEOUT = 0.8           # p34's heartbeat settings
RES_ENV = (("mpi_base_telemetry", 1), ("mpi_base_ft_hb_period", 0.1),
           ("mpi_base_ft_hb_timeout", RES_HB_TIMEOUT),
           ("mpi_base_ft_hb_miss", 3), ("mpi_base_ft_inject", 1),
           ("mpi_base_shm_zerocopy", 1))
# armed after the healthy allreduces are timed: the victim exits at the
# 2nd allreduce after that
RES_KILL = f"rank={RES_VICTIM},point=coll.allreduce,hit=2"


def _res_std(t, dev, host) -> list:
    """The Standard collectives on ``t`` (stacked ``host`` rows on the
    card), each against numpy on the host copy."""
    n = t.size
    x = t.put(host)
    _close(t.allreduce(x, MPI.SUM).cpu().numpy(),
           np.broadcast_to(host.sum(0), host.shape), 1e-5, 1e-5,
           "telemetry allreduce")
    check(np.array_equal(t.bcast(x, root=3).cpu().numpy(),
                         np.broadcast_to(host[3], host.shape)),
          "telemetry bcast")
    g = t.allgather(x[:, :1024]).cpu().numpy()
    check(all(np.array_equal(g[i], host[:, :1024]) for i in range(n)),
          "telemetry allgather")
    y = x.view(n, n, -1)
    yh = host.reshape(n, n, -1)
    check(np.array_equal(t.alltoall(y).cpu().numpy(),
                         np.swapaxes(yh, 0, 1)), "telemetry alltoall")
    _close(t.reduce_scatter_block(y, MPI.SUM).cpu().numpy(), yh.sum(0),
           1e-5, 1e-5, "telemetry reduce_scatter_block")
    t.barrier()
    return ["allreduce", "bcast", "allgather", "alltoall",
            "reduce_scatter_block", "barrier"]


def _res_telemetry(w, dev, smi) -> list:
    """Phase 14(a), telemetry: histograms on a dup built with the plane
    on, retirement at free, the Prometheus text and the dump, and the
    8 B allreduce's cost with the plane off and on."""
    import tempfile

    from ompi_tpu_torch import telemetry
    from ompi_tpu_torch.telemetry import prom
    from ompi_tpu_torch.trace import attribution
    n, lines = w.size, []
    rng = np.random.default_rng(RES_SEED)
    host = rng.standard_normal((n, LOCAL_ELEMS), dtype=np.float32)
    telemetry.enable()
    t = w.dup()
    check(t.c_coll and all(isinstance(m, telemetry._HistSlot)
                           for m in t.c_coll.values()),
          "telemetry: the dup's vtable is not wrapped")
    funcs = _res_std(t, dev, host)
    x = t.put(host)
    ev_ms = device_ms(lambda: t.allreduce(x, MPI.SUM), iters=10, warmup=2)
    sclass = telemetry.SIZE_CLASS_NAMES[telemetry.size_class(
        x.numel() * x.element_size())]
    huge = telemetry.get_hist(
        f"tele_coll_allreduce_c{telemetry._cid_token(t.cid)}_{sclass}")
    snap = huge.snapshot()
    counted = {f: sum(h.merged()["count"] for h in telemetry.histograms()
                      if h.comm == str(t.cid)
                      and h.labels.get("func") == f) for f in funcs}
    check(all(c >= 1 for c in counted.values()) and snap["count"] >= 13,
          f"telemetry counts {counted}, allreduce {sclass} "
          f"{snap['count']}")
    lines.append(
        f"telemetry on: a dup built with the plane on wraps its "
        f"{len(t.c_coll)} slots; the Standard collectives at "
        f"{LOCAL_ELEMS * 4 >> 20} MB per rank = numpy; calls counted per "
        f"func {counted}; {LOCAL_ELEMS * 4 >> 20} MB allreduce histogram "
        f"p50 {snap['p50'] / 1e3:.3f} ms p99 {snap['p99'] / 1e3:.3f} ms "
        f"(host clock of the app-visible call, {snap['count']} calls) "
        f"beside its CUDA-event time {ev_ms:.3f} ms (median of 10)")
    attribution.late_arrival([
        {"kind": "span", "name": "coll_allreduce", "cid": t.cid, "seq": 1,
         "rank": q, "ts": 1.0 + (0.2 if q == 3 else 0.0), "dur": 1e-3}
        for q in range(n)])
    mine = [p for p in pvar.pvar_names()
            if p == f"trace_skew_c{t.cid}" or f"_c{t.cid}_" in p]
    check(f"trace_skew_c{t.cid}" in mine and len(mine) > 1,
          f"per-comm pvars before free: {mine}")
    text = prom.render(rank=0)
    check("# TYPE ompi_tpu_tele_coll_allreduce histogram" in text,
          "prom text has no allreduce family")
    with tempfile.TemporaryDirectory() as tmp:
        path = telemetry.dump(os.path.join(tmp, "telemetry_0.json"), rank=0)
        with open(path) as f:
            dumped = json.load(f)
    check(dumped["telemetry"] == 1 and any(
        h["name"] == huge.name for h in dumped["hists"]), "telemetry dump")
    t.free()
    left = [p for p in mine if p in set(pvar.pvar_names())]
    check(left == [] and not [h for h in telemetry.histograms()
                              if h.comm == str(t.cid)],
          f"per-comm pvars after free: {left}")
    lines.append(
        f"free() retired the dup's {len(mine)} per-comm pvars "
        f"(trace_skew_c{t.cid} and its histograms); prom text "
        f"{len(text.splitlines())} lines; the dump holds "
        f"{len(dumped['hists'])} histograms")
    # 8 B allreduce: the plane off (a comm built with it off: no shim)
    # and on, in turns
    telemetry.disable()
    off = w.dup()
    telemetry.enable()
    on = w.dup()
    us = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        us[mode].append(_obs_8b_us(off if mode == "off" else on))
    telemetry.disable()
    gated = _obs_8b_us(on)           # wrapped, plane off: one read
    on.free()
    off.free()
    lines.append(
        f"8 B allreduce host us, telemetry off then on, in turns (off on "
        f"on off): {us['off'][0]:.2f}, {us['on'][0]:.2f}, "
        f"{us['on'][1]:.2f}, {us['off'][1]:.2f}; on costs "
        f"{(statistics.mean(us['on']) / statistics.mean(us['off']) - 1):.1%}"
        f"; a wrapped comm with the plane turned off {gated:.2f}")
    return lines


def _res_ulfm(w, dev, smi) -> list:
    """Phase 14(a), ULFM: fail world rank 3, then revoke, agree and
    shrink; the shrunk comm's 32 MB allreduce and a DDP step on it."""
    from ompi_tpu_torch.runtime import ft
    n, lines = w.size, []
    check(ft.Registry().probe_devices(w.devices) == [],
          "probe_devices on the 8 cuda:0 handles")
    rng = np.random.default_rng(RES_SEED + 1)
    host = rng.standard_normal((n, LOCAL_ELEMS), dtype=np.float32)
    f = w.dup()
    f.set_errhandler(MPI.ERRORS_RETURN)
    x = f.put(host)
    before = device_ms(lambda: f.allreduce(x, MPI.SUM), iters=10, warmup=2)
    # the DDP synchronizer is built while all 8 ranks live
    cfg = dataclasses.replace(CONFIG, dtype=torch.float32)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), dev)
    specs = tree_map(lambda _: P(), params)
    sync = T.BucketedGradSync(f, Mesh((n,), ("dp",), dev).shard(params,
                                                              specs))
    ft.fail_rank(f.group.world_ranks[3], "phase 14 drill")
    raised = []
    for name, fn in (("allreduce", lambda: f.allreduce(x, MPI.SUM)),
                     ("send", lambda: f.send(x[0], src=0, dest=3)),
                     ("recv", lambda: f.recv(source=3, dst=0))):
        try:
            fn()
        except MPI.MPIError as e:
            raised.append((name, e.error_class))
    check(raised == [("allreduce", MPI.ERR_PROC_FAILED),
                     ("send", MPI.ERR_PROC_FAILED),
                     ("recv", MPI.ERR_PROC_FAILED)], f"raised {raised}")
    t0 = time.perf_counter()
    f.revoke()
    try:
        f.agree([0b11] * n)
        check(False, "agree over an unacknowledged failure returned")
    except MPI.MPIError as e:
        check(e.error_class == MPI.ERR_PROC_FAILED and "[3]" in str(e)
              and e.agreed_value == 0b11, f"agree: {e}")
    s = f.shrink()
    rs_ms = (time.perf_counter() - t0) * 1e3
    check(s.size == n - 1 and 3 not in s.group.world_ranks
          and s.device == dev, f"shrunk comm {s}")
    xs = f.survivor_rows(x, s)
    check(xs.device == dev, "survivor rows left the card")
    keep = [r for r in range(n) if r != 3]
    _close(s.allreduce(xs, MPI.SUM).cpu().numpy(),
           np.broadcast_to(host[keep].sum(0), (n - 1, LOCAL_ELEMS)),
           1e-5, 1e-5, "shrunk allreduce")
    after = device_ms(lambda: s.allreduce(xs, MPI.SUM), iters=10, warmup=2)
    lines.append(
        f"fail_rank(3): allreduce, send and recv naming rank 3 raise "
        f"ERR_PROC_FAILED; revoke, agree (reports [3], agreed "
        f"{0b11:#b}) and shrink to {s.size} ranks took {rs_ms:.2f} ms "
        f"(host clock); {LOCAL_ELEMS * 4 >> 20} MB allreduce on the "
        f"survivors' rows of the stacked {dev} tensor = numpy of the 7 "
        f"rows, {after:.3f} ms against {before:.3f} ms on 8 ranks (CUDA "
        f"events, median of 10); probe_devices on the 8 handles: []")
    lines.append(_res_ddp(sync, s, cfg, params, specs, dev))
    return lines


def _res_ddp(sync, s, cfg, params, specs, dev) -> str:
    """``sync`` (a BucketedGradSync built on the 8 ranks) shrunk onto
    ``s``, one DDP step there against the in-graph dp pmean on the same
    7 ranks."""
    n = s.size
    mesh = Mesh((n,), ("dp",), dev)
    start = mesh.shard(params, specs)
    tok = torch.from_numpy(np.random.default_rng(RES_SEED + 2).integers(
        0, cfg.vocab, (2 * n, cfg.seq + 1)))
    batch = mesh.shard((tok[:, :-1], tok[:, 1:]), (P("dp"), P("dp")))
    dpc = InGraphComm("dp", n, mesh)
    sync.shrink(s)
    check(sync.n == n and sync.comm is s, "BucketedGradSync.shrink")
    pa, la = T.sgd_train_step(start, batch, cfg, 1e-2, dpc, grad_sync=sync)
    pc, lc = T.sgd_train_step(start, batch, cfg, 1e-2, dpc)
    div = mesh.divergence(pa, specs)
    check(np.isfinite(float(la[0])) and div <= 1e-6,
          f"DDP on the shrunk comm: loss {float(la[0])}, divergence {div}")
    _ddp_losses_close([float(la[0])], [float(lc[0])], "shrunk DDP step")
    worst = max((a - b).abs().max().item()
                for a, b in zip(tree_leaves(pa), tree_leaves(pc)))
    check(all(bool(torch.allclose(a, b, rtol=2e-4, atol=2e-6))
              for a, b in zip(tree_leaves(pa), tree_leaves(pc))),
          f"shrunk DDP params differ from the pmean step by {worst:.3g}")
    return (f"BucketedGradSync built on 8 ranks, shrunk onto {n}: one "
            f"full-width DDP step, loss {float(la[0]):.6f} (pmean step "
            f"{float(lc[0]):.6f}), replicated-leaf divergence {div:.3g}, "
            f"params within rtol 2e-4 atol 2e-6 of the pmean step (max "
            f"abs diff {worst:.3g})")


def phase_resilience_world(w, smi: str) -> float:
    """Phase 14(a) on the live 8-rank world, just before Finalize (it
    leaves world rank 3 failed). Returns the seconds it took."""
    t0 = time.perf_counter()
    dev = w.device
    for line in _res_telemetry(w, dev, smi) + _res_ulfm(w, dev, smi):
        phase("resilience", f"{line} | {smi}")
    return time.perf_counter() - t0


def _resilience_rank(report: str) -> int:
    """The rank program of phase 14(b) (mpirun --per-rank
    --enable-recovery, telemetry and heartbeats on, rank 5 killed at its
    2nd allreduce); each survivor writes its flight record, rank 0 its
    lines to ``report``."""
    from ompi_tpu_torch import telemetry
    from ompi_tpu_torch.accelerator import job_tag
    from ompi_tpu_torch.ft import inject
    from ompi_tpu_torch.runtime import ft
    from ompi_tpu_torch.telemetry import flightrec
    MPI.Init()
    w = MPI.get_comm_world()
    r, n = w.rank(), w.size
    dev = w.device
    out_dir = os.path.dirname(report)
    check(telemetry.active and w.router.detector is not None,
          f"rank {r}: telemetry or the detector is off")
    w.set_errhandler(MPI.ERRORS_RETURN)
    w.barrier()
    # a 1 MiB host ring through the zero-copy pools: every rank, the
    # victim too, maps its /dev/shm pools before the kill
    h = np.full(1 << 18, float(r), np.float32)
    w.send(h, (r + 1) % n, tag=3)
    got, _ = w.recv((r - 1) % n, tag=3)
    check(np.array_equal(got, np.full(1 << 18, float((r - 1) % n),
                                      np.float32)), f"rank {r}: host ring")
    base = (torch.arange(LOCAL_ELEMS, device=dev) % 1024).float()
    x = base + r
    full = base * n + n * (n - 1) / 2

    def timed(comm, want) -> float:
        """Median host ms of 5 synchronised 32 MB allreduces on
        ``comm`` (after one untimed), each equal to ``want``."""
        times = []
        for i in range(6):
            comm.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = comm.allreduce(x, MPI.SUM)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
            check(y.device == dev and torch.equal(y, want),
                  f"rank {r}: allreduce on {comm.name}")
        return statistics.median(times)

    before_ms = timed(w, full)
    var.var_set("mpi_base_ft_inject_kill", RES_KILL)
    inject.refresh()
    check(torch.equal(w.allreduce(x, MPI.SUM), full),   # point hit 1
          f"rank {r}: healthy allreduce")
    t_in = time.perf_counter()
    try:
        w.allreduce(x, MPI.SUM)                      # the victim dies here
        check(False, f"rank {r}: an allreduce over a dead rank returned")
    except MPI.MPIError as e:
        # a survivor blocked on a live peer that bailed out is released
        # by the revoke that any first detector floods
        check(e.error_class in (MPI.ERR_PROC_FAILED, MPI.ERR_REVOKED),
              f"rank {r}: {e}")
    t_rev = time.perf_counter()
    err_ms = (t_rev - t_in) * 1e3
    w.revoke()
    deadline = time.monotonic() + 30
    while w.get_failed() != [RES_VICTIM]:
        check(time.monotonic() < deadline, f"rank {r}: {w.get_failed()}")
        time.sleep(0.01)
    check(w.agree(1) == 1, f"rank {r}: agree")
    s = w.shrink()
    rs_ms = (time.perf_counter() - t_rev) * 1e3
    sr, sn = s.rank(), s.size
    check(sn == n - 1 and sr == (r if r < RES_VICTIM else r - 1),
          f"rank {r}: shrunk to {sn}, rank {sr}")
    lat = pvar.pvar_read("ft_detect_latency_us")
    after_ms = timed(s, base * sn + sum(q for q in range(n)
                                        if q != RES_VICTIM))
    # a devxfer ring of 32 MB CUDA tensors among the survivors
    pulls = w.router.xfer.stats["received"]
    msg = base * (sr + 1)
    s.send(msg, (sr + 1) % sn, tag=4)
    got, _ = s.recv((sr - 1) % sn, tag=4)
    check(got.device == dev and torch.equal(got, base * ((sr - 1) % sn + 1)),
          f"rank {r}: devxfer ring")
    xfer = w.router.xfer.stats["received"] - pulls
    failed = sorted(ft.failed_ranks())
    rows = s.allgather((lat, rs_ms, before_ms, after_ms, failed, xfer,
                        err_ms))
    s.barrier()                       # every flight record is written
    frecs = sorted(f for f in os.listdir(out_dir)
                   if f.startswith("flightrec_") and f.endswith(".json"))
    if r == 0:
        pays = []
        for name in frecs:
            with open(os.path.join(out_dir, name)) as fh:
                pays.append(json.load(fh))
        rep = flightrec.merge(pays)
        ranks = sorted({p["rank"] for p in pays})
        check(rep["critical_rank"] == RES_VICTIM
              and rep.get("critical_absent") is True
              and ranks == [q for q in range(n) if q != RES_VICTIM],
              f"flight records: ranks {ranks}, report {rep}")
        check(all(row[4] == [RES_VICTIM] for row in rows),
              f"a survivor was declared: {[row[4] for row in rows]}")
        # detection: every survivor's failed allreduce raised within 2x
        # the heartbeat timeout, and so did the ft_detect_latency_us of
        # the victim's ring successor, the one rank that heard its beats
        # (the others count from their detector's start, as the
        # reference's pvar does)
        lats = [row[0] for row in rows]
        errs = [row[6] for row in rows]
        succ = RES_VICTIM                # its shrunk rank is the victim's
        check(max(errs) < 2 * RES_HB_TIMEOUT * 1e3
              and lats[succ] < 2 * RES_HB_TIMEOUT * 1e6,
              f"detection: errors after {errs} ms, latencies {lats} us")
        lines = [
            f"8 rank processes on {dev}, telemetry and heartbeats on "
            f"(period 0.1 s, timeout {RES_HB_TIMEOUT} s, miss 3): rank "
            f"{RES_VICTIM} exited at its 2nd allreduce after the kill "
            f"spec was armed; the 7 survivors "
            f"saw ERR_PROC_FAILED or ERR_REVOKED, revoked, agreed and "
            f"shrank; failed set {rows[0][4]} on every survivor (none "
            f"declared); detection latency us per survivor {lats} (limit "
            f"{2 * RES_HB_TIMEOUT * 1e6:.0f}; the silence since the "
            f"victim was last known alive, less one period: its ring "
            f"successor heard its beats, the others count from their "
            f"detector's start); the failed allreduce raised after ms "
            f"{[round(row[6], 1) for row in rows]}",
            f"revoke -> shrink ms per survivor "
            f"{[round(row[1], 2) for row in rows]}; "
            f"{LOCAL_ELEMS * 4 >> 20} MB CUDA allreduce ms on rank 0 "
            f"(host clock with the fences, median of 5): {rows[0][2]:.3f} "
            f"on 8 ranks and {rows[0][3]:.3f} on the 7 survivors, = exact "
            f"sums; devxfer ring of "
            f"{LOCAL_ELEMS * 4 >> 20} MB CUDA tensors among the "
            f"survivors pulled {sum(row[5] for row in rows)} slots",
            f"flight records {frecs}; flightrec.merge: critical rank "
            f"{rep['critical_rank']} (absent: "
            f"{rep.get('critical_absent')}), accusations "
            f"{rep['accusations']}; job tag {job_tag()}"]
        with open(report, "w") as fh:
            json.dump({"lines": lines, "tag": job_tag()}, fh)
    s.free()
    w.free()
    MPI.Finalize()
    print(f"OK resilience rank={r}/{n}", flush=True)
    return 0


def phase_resilience_job(smi: str, world_s: float) -> None:
    """Phase 14(b): the per-rank ULFM drill, 8 rank processes on cuda:0,
    with the launcher in recovery mode (the victim's 137 is the job's
    rc; the 7 survivors must print OK)."""
    import glob
    import tempfile
    from ompi_tpu_torch.accelerator import SHM_DIR
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "rank0.json")
        cmd = [sys.executable,
               os.path.join(root, "ompi_tpu_torch", "tools", "mpirun.py"),
               "--per-rank", "-n", str(PR_RANKS), "--timeout",
               str(PR_TIMEOUT), "--enable-recovery",
               "--mca", "mpi_base_telemetry_flightrec_dir", tmp]
        for k, v in RES_ENV:
            cmd += ["--mca", k, str(v)]
        cmd += [os.path.abspath(__file__), "--resilience-rank", report]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=PR_TIMEOUT + 60, cwd=root)
        oks = res.stdout.count("OK resilience")
        if res.returncode != 137 or oks != PR_RANKS - 1:
            sys.stderr.write(res.stderr[-6000:])
            check(False, f"resilience job rc={res.returncode} (want 137), "
                  f"{oks} of {PR_RANKS - 1} survivors OK:\n"
                  f"{res.stdout[-3000:]}")
        cuda_err = [ln for ln in res.stderr.splitlines()
                    if "CUDA error" in ln or "cudaError" in ln]
        check(not cuda_err, f"CUDA errors in the survivors' stderr: "
              f"{cuda_err[:5]}")
        with open(report) as f:
            rep = json.load(f)
    left = glob.glob(os.path.join(SHM_DIR, f"otpt*_{rep['tag']}_*"))
    check(rep["tag"] and not left, f"shared segments left: {left}")
    for line in rep["lines"]:
        phase("resilience", f"{line} | {smi}")
    phase("resilience", f"no otpt*_{rep['tag']}_* file left under "
          f"{SHM_DIR}; no CUDA error in any survivor's stderr; phase 14 "
          f"took {world_s + time.perf_counter() - t0:.1f} s | {smi}")


# -- phase 15 ----------------------------------------------------------
SES_SEED = 1500
SES_CHILD = 4                  # ranks of the spawned child world
SES_JOB_TIMEOUT = 60           # seconds each per-rank job may take
SES_JOB_PHASE_S = 90           # the per-rank part must end within this
SES_SEG = 1 << 18              # adapt's segment: 1 MB of fp32 per rank
SES_DIRECT = ("allreduce", "bcast", "reduce", "allgather")


def _dtoh_events(fn) -> int:
    """Device-to-host copies inside ``fn()``: the ``Memcpy DtoH`` events
    ``torch.profiler`` records from the card."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "DtoH" in e.key)


def _dup_with(w, **vals):
    """A dup of ``w`` selected while the MCA vars ``vals`` hold; the
    global values come back after."""
    saved = {k: var.var_get(k) for k in vals}
    for k, v in vals.items():
        var.var_set(k, v)
    try:
        return w.dup()
    finally:
        for k, v in saved.items():
            var.var_set(k, v)


def _composed(w) -> list:
    """(name, comm) of phase 15's composition dups: han with low groups
    of 4, xhc with levels 2,2 and xhc on the host ladder."""
    xa = _dup_with(w, coll_xhc_priority=80)
    return [("han split 4", _dup_with(w, coll_han_priority=80,
                                      coll_han_split=4)),
            ("xhc 2,2", _dup_with(w, coll_xhc_priority=80,
                                  coll_xhc_levels="2,2")),
            (f"xhc auto ({xa.c_coll['allreduce'].level_basis})", xa)]


def _fresh_check(report: str) -> int:
    """Phase 15's checks that need a process of their own
    (``--fresh-check``, started by ``phase_sessions_world``). The DtoH
    counts: in the script's own process torch.profiler stops reporting
    memcpy records once phases 3 and 4 have run, so a zero there would
    prove nothing. An 8-row world on cuda:0 runs the intercomm's four
    collectives with a spawned 4-row child and han's and xhc's at 32 MB
    fp32 per rank, each once to warm and once under the profiler; a 4 KB
    ``.cpu()`` is the positive control. Then the 8 B allreduce on the
    world and on a session comm with no override, in turns."""
    from ompi_tpu_torch.runtime import session as S
    dev = torch.device("cuda", 0)
    MPI.Init(devices=[dev] * N_RANKS)
    w = MPI.get_comm_world()
    n, m = w.size, SES_CHILD
    g = torch.Generator(device=dev).manual_seed(SES_SEED)
    x = torch.randn((n, LOCAL_ELEMS), device=dev, generator=g)
    cx = torch.randn((m, LOCAL_ELEMS), device=dev, generator=g)
    inter = MPI.Comm_spawn(None, m, w)
    q = LOCAL_ELEMS // m
    la = x.view(n, m, q)
    rb = cx.view(m, n, LOCAL_ELEMS // n)[:, :, :q].contiguous()
    calls = {"intercomm bcast": lambda: inter.bcast(x[2], root=2),
             "intercomm allreduce": lambda: inter.allreduce(x, cx, MPI.SUM),
             "intercomm allgather": lambda: inter.allgather(x, cx),
             "intercomm alltoall": lambda: inter.alltoall(la, rb)}
    for name, c in _composed(w):
        calls[f"{name} allreduce"] = (
            lambda c=c: c.allreduce(x, MPI.SUM))
        calls[f"{name} bcast"] = lambda c=c: c.bcast(x, root=5)
        calls[f"{name} reduce"] = lambda c=c: c.reduce(x, MPI.SUM, root=6)
        if name.startswith("han"):
            calls[f"{name} allgather"] = lambda c=c: c.allgather(x)
    counts = {}
    for name, fn in calls.items():
        fn()
        counts[name] = _dtoh_events(fn)
        torch.cuda.empty_cache()
    t = torch.ones(1024, device=dev)
    rep = {"counts": counts, "control": _dtoh_events(lambda: t.cpu())}
    s0 = S.Session(devices=[dev] * n)
    c0 = s0.comm_create_from_group(s0.group_from_pset("mpi://WORLD"))
    small_w = w.alloc((2,), dtype=torch.float32, fill=1.0)
    small_s = c0.alloc((2,), dtype=torch.float32, fill=1.0)
    rep["us"] = [_us_per_call(lambda: w.allreduce(small_w, MPI.SUM)),
                 _us_per_call(lambda: c0.allreduce(small_s, MPI.SUM)),
                 _us_per_call(lambda: c0.allreduce(small_s, MPI.SUM)),
                 _us_per_call(lambda: w.allreduce(small_w, MPI.SUM))]
    s0.finalize()
    with open(report, "w") as fh:
        json.dump(rep, fh)
    MPI.Finalize()
    return 0


def _ses_fresh(smi: str) -> list:
    """Runs ``_fresh_check`` in a fresh process and holds its counts: 0 in
    every call, at least 1 in the control."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "dtoh.json")
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--fresh-check", report], capture_output=True,
                             text=True, timeout=180, cwd=root)
        if res.returncode != 0:
            sys.stderr.write(res.stderr[-6000:])
            check(False, f"the fresh-process check exited "
                  f"{res.returncode}")
        with open(report) as f:
            rep = json.load(f)
    check(rep["control"] >= 1, f"the profiler saw {rep['control']} DtoH "
          f"events in a .cpu() copy: it cannot vouch for zero elsewhere")
    bad = {k: v for k, v in rep["counts"].items() if v}
    check(not bad, f"Memcpy DtoH events inside {bad}")
    us = rep["us"]
    return [f"0 Memcpy DtoH events (torch.profiler, a fresh process) in "
            f"each of {len(rep['counts'])} calls at "
            f"{LOCAL_ELEMS * 4 >> 20} MB per rank: "
            f"{', '.join(rep['counts'])}; the control's .cpu() copy "
            f"showed {rep['control']}",
            f"the same fresh process, 8 B allreduce host us/call (2000 "
            f"calls after 200, in turns world, session, session, world; no "
            f"override): {us[0]:.2f}, {us[1]:.2f}, {us[2]:.2f}, "
            f"{us[3]:.2f}; the scope wrapper costs "
            f"{(us[1] + us[2] - us[0] - us[3]) / 2:.2f} us/call"]


def _direct_scope():
    """A var scope that forces coll/torch's direct lowering: the
    comparison baseline, with the global store untouched."""
    sc = var.VarScope()
    for func in SES_DIRECT:
        sc.set(f"coll_torch_{func}_algorithm", "direct")
    return sc


def _us_per_call(fn, calls: int = 2000, warmup: int = 200) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def _ses_sessions(w, x, xh, smi: str) -> list:
    """15(a): two sessions with their own algorithm in their own scope."""
    from ompi_tpu_torch.runtime import ft
    from ompi_tpu_torch.runtime import session as S
    dev, n = w.device, w.size
    alg = "coll_torch_allreduce_algorithm"
    want = np.broadcast_to(xh.sum(0), xh.shape)
    r0 = S.instance_refcount()
    world_alg = w._coll("allreduce").selected("allreduce", x, MPI.SUM)
    world_var = var.var_get(alg)
    sessions = [(S.Session(devices=[dev] * n), "ring"),
                (S.Session(devices=[dev] * n), "recursive_doubling")]
    check(S.instance_refcount() == r0 + 2, "session refcount")
    comms = []
    for s, name in sessions:
        s.var_set(alg, name)
        c = s.comm_create_from_group(s.group_from_pset("mpi://WORLD"))
        check(isinstance(c, S.SessionCommunicator) and c.cid == 0
              and c.device == dev, f"session comm {c!r}")
        # the deferred round first, on a fresh comm: the schedule it
        # builds is the session's algorithm
        req = c.iallreduce(x, MPI.SUM)
        req.wait()
        y = req.get()
        check(y.device == dev, "session iallreduce device")
        _close(y.cpu().numpy(), want, 1e-5, 1e-5, f"{name} iallreduce")
        built = [k for k in c.c_coll["allreduce"].device._cache
                 if k[0] == "allreduce"]
        check(built and all(k[1] == name for k in built),
              f"{name} session's deferred round built {built}")
        y = c.allreduce(x, MPI.SUM)
        _close(y.cpu().numpy(), want, 1e-5, 1e-5, f"{name} allreduce")
        with var.scope(s.scope):
            sel = c._coll("allreduce").selected("allreduce", x, MPI.SUM)
        check(sel == name, f"session selected {sel}, wanted {name}")
        d = c.dup()
        check(isinstance(d, S.SessionCommunicator) and d.cid == 1,
              f"a session dup drew cid {d.cid}")
        comms.append((c, d))
    check(var.var_get(alg) == world_var and w._coll("allreduce").selected(
        "allreduce", x, MPI.SUM) == world_alg, "the world's pick moved")
    (c1, _), (c2, _) = comms
    s1 = sessions[0][0]
    # a failure injected in session 1 stays there
    c1.set_errhandler(MPI.ERRORS_RETURN)
    s1.ft_registry.fail_rank(0, "injected in session 1")
    try:
        c1.allreduce(x, MPI.SUM)
        check(False, "session 1's allreduce over its failed rank returned")
    except MPI.MPIError as e:
        check(e.error_class == MPI.ERR_PROC_FAILED, f"session 1: {e}")
    check(not ft.is_failed(0), "the world registry saw session 1's failure")
    _close(c2.allreduce(x, MPI.SUM).cpu().numpy(), want, 1e-5, 1e-5,
           "session 2 after session 1's failure")
    _close(w.allreduce(x, MPI.SUM).cpu().numpy(), want, 1e-5, 1e-5,
           "world after session 1's failure")
    # the wrapper's cost: a session with no override runs the world's
    # algorithm, so only the scope differs
    s0 = S.Session(devices=[dev] * n)
    c0 = s0.comm_create_from_group(s0.group_from_pset("mpi://WORLD"))
    small_w = w.alloc((2,), dtype=torch.float32, fill=1.0)
    small_s = c0.alloc((2,), dtype=torch.float32, fill=1.0)
    with var.scope(s0.scope):
        check(c0._coll("allreduce").selected("allreduce", small_s, MPI.SUM)
              == w._coll("allreduce").selected("allreduce", small_w,
                                               MPI.SUM),
              "the timed session comm runs another algorithm")
    us = [_us_per_call(lambda: w.allreduce(small_w, MPI.SUM)),
          _us_per_call(lambda: c0.allreduce(small_s, MPI.SUM)),
          _us_per_call(lambda: c0.allreduce(small_s, MPI.SUM)),
          _us_per_call(lambda: w.allreduce(small_w, MPI.SUM))]
    s0.finalize()
    for s, _ in sessions:
        s.finalize()
    check(all(c._freed and d._freed for c, d in comms),
          "finalize left a session comm alive")
    check(S.instance_refcount() == r0, "the refcount did not fall back")
    return [
        f"two Session(devices=[{dev}] * {n}): coll_torch_allreduce_algorithm "
        f"ring and recursive_doubling in their scopes, the world's "
        f"'{world_var}' (picks {world_alg}) unchanged; each session's "
        f"deferred iallreduce built only its algorithm, its allreduce "
        f"= numpy (rtol 1e-5, atol 1e-5) and selected() names it; CIDs "
        f"0, 1 in each session's space; a failure injected in session "
        f"1's registry raised there alone (session 2 and the world = "
        f"numpy); finalize freed all 4 comms, refcount back to {r0}",
        f"8 B allreduce host us/call (2000 calls after 200, in turns world, "
        f"session, session, world; the session has no override, so both "
        f"run the world's algorithm): {us[0]:.2f}, {us[1]:.2f}, "
        f"{us[2]:.2f}, {us[3]:.2f}; the scope wrapper costs "
        f"{(us[1] + us[2] - us[0] - us[3]) / 2:.2f} us/call"]


def _ses_dpm(w, x, xh, smi: str) -> list:
    """15(b): spawn, the intercomm collectives and the rendezvous."""
    from ompi_tpu_torch.core import dpm
    dev, n, m = w.device, w.size, SES_CHILD
    ran = []

    def child_main(child):
        y = child.allreduce(child.alloc((4,), fill=2.0), MPI.SUM)
        ran.append((child.size, y.device, y.cpu().tolist()))

    inter = MPI.Comm_spawn(child_main, m, w)
    child = inter.remote_comm
    check(ran == [(m, dev, [[2.0 * m] * 4] * m)]
          and child.devices == (dev,) * m,
          f"spawned child: {ran}, {child.devices}")
    check(MPI.Comm_get_parent(child).remote_size == n
          and MPI.Comm_get_parent(w) is None, "Comm_get_parent")
    g = torch.Generator(device=dev).manual_seed(SES_SEED + 1)
    cx = torch.randn((m, LOCAL_ELEMS), device=dev, generator=g)
    cxh = cx.cpu().numpy()
    q = LOCAL_ELEMS // m
    la = x.view(n, m, q)
    rb = cx.view(m, n, LOCAL_ELEMS // n)[:, :, :q].contiguous()
    # the intercomm collectives, each held against its expected value and
    # profiled for device-to-host copies
    calls = {
        "bcast": lambda: inter.bcast(x[2], root=2),
        "allreduce": lambda: inter.allreduce(x, cx, MPI.SUM),
        "allgather": lambda: inter.allgather(x, cx),
        "alltoall": lambda: inter.alltoall(la, rb),
    }
    out = calls["bcast"]()
    check(out.device == dev and out.shape == (m, LOCAL_ELEMS)
          and torch.equal(out, x[2].expand(m, -1)), "intercomm bcast")
    lo, ro = calls["allreduce"]()
    check(lo.device == ro.device == dev, "intercomm allreduce device")
    _close(lo.cpu().numpy(), np.broadcast_to(cxh.sum(0), (n, LOCAL_ELEMS)),
           1e-5, 1e-5, "intercomm allreduce local side")
    _close(ro.cpu().numpy(), np.broadcast_to(xh.sum(0), (m, LOCAL_ELEMS)),
           1e-5, 1e-5, "intercomm allreduce remote side")
    del lo, ro
    lo, ro = calls["allgather"]()
    check(lo.device == ro.device == dev and lo.shape == (n, m, LOCAL_ELEMS)
          and ro.shape == (m, n, LOCAL_ELEMS)
          and all(torch.equal(lo[i], cx) for i in range(n))
          and all(torch.equal(ro[j], x) for j in range(m)),
          "intercomm allgather")
    del lo, ro
    lo, ro = calls["alltoall"]()
    check(lo.device == ro.device == dev
          and torch.equal(lo, rb.transpose(0, 1))
          and torch.equal(ro, la.transpose(0, 1)), "intercomm alltoall")
    del lo, ro
    merged = inter.merge()
    check(merged.size == n + m and merged.devices == (dev,) * (n + m),
          f"merge: {merged.size} rows on {set(merged.devices)}")
    allx = torch.cat([x, cx])
    _close(merged.allreduce(allx, MPI.SUM).cpu().numpy(),
           np.broadcast_to(np.concatenate([xh, cxh]).sum(0),
                           (n + m, LOCAL_ELEMS)),
           1e-5, 1e-5, "merged allreduce")
    del allx
    ms = device_ms(lambda: inter.allreduce(x, cx, MPI.SUM), iters=10,
                   warmup=2)
    moved = 2 * (n + m) * LOCAL_ELEMS * 4
    # the rendezvous between the world's halves, the names, join
    halves = w.split([0] * (n // 2) + [1] * (n - n // 2))
    a, b = halves[0], halves[-1]
    port = MPI.Open_port()
    MPI.Publish_name("sessions-phase", port)
    check(MPI.Lookup_name("sessions-phase") == port, "Lookup_name")
    areq = MPI.Comm_iaccept(port, a)
    check(not areq.test()[0], "iaccept completed alone")
    ib = MPI.Comm_connect(port, b)
    ia = areq.get()
    check(areq.test()[0] and ia.remote_comm is b and ib.remote_comm is a,
          "accept/connect pairing")
    la2 = a.stack([x[i, :8] for i in range(a.size)])
    rb2 = b.stack([x[i, :8] for i in range(a.size, n)])
    lo, ro = ia.allreduce(la2, rb2, MPI.MAX)
    check(torch.equal(lo[0], rb2.max(0).values)
          and torch.equal(ro[0], la2.max(0).values), "halves' MAX")
    MPI.Unpublish_name("sessions-phase")
    MPI.Close_port(port)
    j1 = MPI.Comm_join("phase-15", a)
    jb = MPI.Comm_join("phase-15", b)
    check(j1.test()[0] and j1.get().remote_comm is b and jb.remote_comm is a,
          "Comm_join")
    MPI.Comm_disconnect(child)
    check(MPI.Comm_get_parent(child) is None and child._freed,
          "Comm_disconnect")
    MPI.Comm_disconnect(inter)
    dpm._reset_for_tests()
    return [
        f"Comm_spawn(child_main, {m}, world): a {m}-row child on {dev} "
        f"(its allreduce ran there); the intercomm's bcast, allreduce, "
        f"allgather and alltoall between the {n} parent and {m} child "
        f"rows at {LOCAL_ELEMS * 4 >> 20} MB per rank = numpy (sums rtol "
        f"1e-5) or the inputs exactly, every output on {dev}; merge: "
        f"{n + m} rows on {dev}, allreduce = numpy",
        f"intercomm allreduce SUM: {ms:.3f} ms device (CUDA events, "
        f"median of 10): {_hbm(moved, ms)} for the least in+out traffic",
        "Open_port/Publish_name/Lookup_name, Comm_iaccept pending until "
        "Comm_connect, the halves' intercomm MAX exact, Comm_join and "
        "Comm_disconnect (get_parent None after)"]


def _cmp_direct(what, got, direct, wanth, sums: bool) -> None:
    """``got`` against coll/torch's direct lowering and numpy: float sums
    rtol 1e-5 (atol 1e-5 near zero), everything else bit for bit."""
    if sums:
        _close(got.cpu().numpy(), direct.cpu().numpy(), 1e-5, 1e-5,
               f"{what} vs direct")
        _close(got.cpu().numpy(), wanth, 1e-5, 1e-5, f"{what} vs numpy")
    else:
        check(_bits(got, direct), f"{what} vs direct (bit for bit)")
        check(np.array_equal(_host(got), wanth), f"{what} vs numpy")


def _ses_compose(w, x, xh, smi: str) -> list:
    """15(c): han, xhc and adapt on the card."""
    from ompi_tpu_torch.coll import adapt, han, xhc
    dev, n = w.device, w.size
    g = torch.Generator(device=dev).manual_seed(SES_SEED + 2)
    xi = torch.randint(-1000, 1000, (n, LOCAL_ELEMS), device=dev,
                       dtype=torch.int32, generator=g)
    xih = xi.cpu().numpy()
    direct = _direct_scope()

    def flat(fn):
        with var.scope(direct):
            return fn()

    d_sum = flat(lambda: w.allreduce(x, MPI.SUM))
    d_max = flat(lambda: w.allreduce(x, MPI.MAX))
    d_int = flat(lambda: w.allreduce(xi, MPI.SUM))
    d_ms = device_ms(lambda: flat(lambda: w.allreduce(x, MPI.SUM)),
                     iters=10, warmup=2)
    want_sum = np.broadcast_to(xh.sum(0), xh.shape)
    want_max = np.broadcast_to(xh.max(0), xh.shape)
    want_int = np.broadcast_to(xih.sum(0, dtype=np.int32), xih.shape)
    moved = 2 * n * LOCAL_ELEMS * 4
    lines = []

    comps = _composed(w)
    hc, xc, xa = (c for _, c in comps)
    check(hc._coll_winners["allreduce"] == "han", "han not selected")
    hm = hc.c_coll["allreduce"]
    check(isinstance(hm, han.HanModule), "han module")
    for c in (xc, xa):
        check(c._coll_winners["allreduce"] == "xhc"
              and isinstance(c.c_coll["allreduce"], xhc.XhcModule),
              "xhc not selected")
    for name, c in comps:
        c.allreduce(x, MPI.SUM)               # builds han's tiers
        _cmp_direct(f"{name} allreduce SUM", c.allreduce(x, MPI.SUM),
                    d_sum, want_sum, True)
        _cmp_direct(f"{name} allreduce MAX", c.allreduce(x, MPI.MAX),
                    d_max, want_max, False)
        _cmp_direct(f"{name} allreduce i32", c.allreduce(xi, MPI.SUM),
                    d_int, want_int, False)
        check(np.array_equal(_host(c.bcast(x, root=5)),
                             np.broadcast_to(xh[5], xh.shape)),
              f"{name} bcast")
        _close(_host(c.reduce(x, MPI.SUM, root=6))[6], xh.sum(0), 1e-5,
               1e-5, f"{name} reduce")
        c.barrier()
        if c is hc:
            ag = hc.allgather(x)
            check(ag.device == dev and ag.shape == (n, n, LOCAL_ELEMS)
                  and all(torch.equal(ag[i], x) for i in range(n)),
                  "han allgather")
            del ag
        ms = device_ms(lambda: c.allreduce(x, MPI.SUM), iters=10, warmup=2)
        mod = c.c_coll["allreduce"]
        shape = (f"low groups {mod.h.groups}" if c is hc
                 else f"levels {mod.levels}")
        lines.append(
            f"{name}: {shape}; "
            f"allreduce SUM/MAX/i32, bcast, reduce"
            f"{', allgather' if c is hc else ''} and barrier = numpy, "
            f"MAX and i32 = direct bit for bit, SUM = direct rtol 1e-5; "
            f"allreduce SUM "
            f"{ms:.3f} ms device against direct {d_ms:.3f} ms: "
            f"{_hbm(moved, ms)}")
    small = hc.alloc((4,), fill=1.0)
    check(hm._strategy("allreduce", int(small.nbytes)) == "flat"
          and torch.equal(hc.allreduce(small, MPI.SUM),
                          torch.full_like(small, float(n))),
          "han's small message did not go flat")
    lines.append("han's 128 B allreduce went flat (the next component) "
                 "and = numpy; no gain is claimed: one card has no tier "
                 "to save")
    for c in (hc, xc, xa):
        c.free()
    # adapt: 1 MB segments of the 32 MB rows, against the blocking calls
    am = adapt.AdaptModule(w, SES_SEG)
    fired = []
    req = am.ibcast_adapt(x, root=3, on_complete=lambda r: fired.append(1))
    req.wait()
    req.wait()
    check(len(req._segments) == LOCAL_ELEMS // SES_SEG and fired == [1],
          f"adapt ibcast: {len(req._segments)} segments, callback "
          f"{len(fired)} times")
    check(_bits(req.get(), w.bcast(x, root=3)), "adapt ibcast vs bcast")
    fired.clear()
    with var.scope(direct):
        req = am.ireduce_adapt(x, MPI.SUM, 0,
                               on_complete=lambda r: fired.append(1))
        req.wait()
        check(fired == [1] and _bits(req.get(), w.allreduce(x, MPI.SUM)),
              "adapt ireduce vs the blocking allreduce (direct, bit for "
              "bit)")

    def span(fn):
        def run():
            r = fn()
            while not r.test()[0]:
                pass
        return device_ms(run, iters=5, warmup=1)

    b_ms = device_ms(lambda: w.bcast(x, root=3), iters=10, warmup=2)
    ab_ms = span(lambda: am.ibcast_adapt(x, root=3))
    with var.scope(direct):
        ar_ms = span(lambda: am.ireduce_adapt(x, MPI.SUM, 0))
    lines.append(
        f"adapt at {LOCAL_ELEMS * 4 >> 20} MB per rank in "
        f"{LOCAL_ELEMS // SES_SEG} segments of {SES_SEG * 4 >> 20} MB: "
        f"ibcast_adapt = bcast and ireduce_adapt = the direct allreduce "
        f"bit for bit, each callback fired once; ibcast_adapt {ab_ms:.3f} "
        f"ms span (CUDA events, with the host's dispatch of every "
        f"segment) against bcast {b_ms:.3f} ms device; ireduce_adapt "
        f"{ar_ms:.3f} ms span against direct allreduce {d_ms:.3f} ms: "
        f"{_hbm(moved, ar_ms)}")
    return lines


def _ses_accel(w, x) -> list:
    """15(d): acoll's detection and the accelerator surface."""
    dev = w.device
    detected = var.var_get("coll_acoll_detected")
    seg = var.var_get("coll_torch_segsize")
    src = var.var_source("coll_torch_segsize")
    check(detected == "" and seg == 1 << 20 and src == "default",
          f"acoll on {torch.cuda.get_device_name(dev)}: detected "
          f"{detected!r}, coll_torch_segsize {seg} ({src})")
    mod = accelerator.current_module()
    z = mod.mem_alloc((w.size, 1024), torch.float32, device=dev)
    check(z.device == dev and not bool(z.any()), "mem_alloc")
    torch.cuda._sleep(20_000_000)
    y = z + 1
    mod.event_synchronize([y])
    check(torch.cuda.current_stream(dev).query(), "event_synchronize "
          "returned before the queued kernel ended")
    h = mod.get_ipc_handle(x)
    check(mod.open_ipc_handle(h).tensor is x, "ipc round trip")
    mod.close_ipc_handle(h)
    try:
        mod.open_ipc_handle(h)
        check(False, "a closed ipc handle opened")
    except MPI.MPIError:
        pass
    info = mod.get_device_info()
    attrs = mod.get_device_attributes(dev)
    check(info == ("cuda", torch.cuda.device_count())
          and attrs["name"] == torch.cuda.get_device_name(dev)
          and attrs["sm_count"] > 0 and attrs["total_memory"] > 0,
          f"device info {info}, attributes {attrs}")
    check(mod.device_can_access_peer(dev, dev), "peer access to itself")
    ms = attrs["memory_stats"] or {}
    return [
        f"coll_acoll_detected {detected!r} on "
        f"{torch.cuda.get_device_name(dev)} (no table row: no hint "
        f"installed); coll_torch_segsize {seg} from its {src}",
        f"mem_alloc on {dev}; event_synchronize after a queued sleep "
        f"kernel; get_ipc_handle -> open_ipc_handle (the same tensor) -> "
        f"close_ipc_handle (reopen raises); get_device_info {info}; "
        f"get_device_attributes: {attrs['name']}, {attrs['sm_count']} SMs, "
        f"{attrs['total_memory'] / 2 ** 30:.1f} GiB, compute capability "
        f"{attrs['compute_capability']}, allocated "
        f"{ms.get('allocated_bytes.all.current', 0) / 2 ** 30:.2f} GiB; "
        f"device_can_access_peer({dev}, {dev}) True"]


def phase_sessions_world(w, smi: str) -> float:
    """Phase 15(a)-(d) on the live 8-rank world, before phase 14 fails a
    rank of it. Returns the seconds it took."""
    t0 = time.perf_counter()
    dev = w.device
    g = torch.Generator(device=dev).manual_seed(SES_SEED)
    x = torch.randn((w.size, LOCAL_ELEMS), device=dev, generator=g)
    xh = x.cpu().numpy()
    for part in (_ses_sessions(w, x, xh, smi), _ses_dpm(w, x, xh, smi),
                 _ses_compose(w, x, xh, smi), _ses_accel(w, x),
                 _ses_fresh(smi)):
        for line in part:
            phase("sessions", f"{line} | {smi}")
    return time.perf_counter() - t0


def _bridge_rank(role: str, port_file: str, report: str) -> int:
    """A rank of one of phase 15(e)'s two 2-rank jobs: rendezvous with
    the other job through dpm_perrank and exchange messages both ways,
    non-roots included; one message is a CUDA tensor."""
    from ompi_tpu_torch.core import dpm_perrank as dpm
    MPI.Init()
    w = MPI.get_comm_world()
    r, n = w.rank(), w.size
    dev = w.device
    t0 = time.perf_counter()
    if role == "accept":
        port = dpm.open_port() if r == 0 else None
        if r == 0:
            with open(port_file + ".tmp", "w") as f:
                f.write(port)
            os.rename(port_file + ".tmp", port_file)
        port = w.bcast(port, root=0)
        ic = dpm.comm_accept(port, w, root=0, timeout=SES_JOB_TIMEOUT - 10)
    else:
        deadline = time.monotonic() + SES_JOB_TIMEOUT - 10
        while not os.path.exists(port_file):
            check(time.monotonic() < deadline, "no port file")
            time.sleep(0.02)
        port = open(port_file).read().strip()
        ic = dpm.comm_connect(port, w, root=0)
    rdv_ms = (time.perf_counter() - t0) * 1e3
    check(ic.remote_size == n, f"remote size {ic.remote_size}")
    mine = 100 if role == "accept" else 200
    other = 300 - mine
    ic.send(np.array([mine + r, r]), remote_rank=r, tag=7)
    data, st = ic.recv(source=r, tag=7, timeout=30)
    check(data[0] == other + r and st.source == r, f"{data}, {st.source}")
    t = torch.arange(1 << 20, device=dev, dtype=torch.float32) + mine + r
    t1 = time.perf_counter()
    ic.send(t, remote_rank=r, tag=9)
    got, _ = ic.recv(source=r, tag=9, timeout=30)
    cross_ms = (time.perf_counter() - t1) * 1e3
    want = (torch.arange(1 << 20, dtype=torch.float32) + other + r).numpy()
    check(isinstance(got, np.ndarray) and _bits(got, want),
          f"the CUDA tensor crossed as {type(got).__name__}")
    if r == 0:
        for rr in range(ic.remote_size):
            ic.send({"from": role, "to": rr}, remote_rank=rr, tag=8)
    obj, _ = ic.recv(source=0, tag=8, timeout=30)
    check(obj["to"] == r and obj["from"] != role, f"{obj}")
    ic.disconnect()
    if role == "accept" and r == 0:
        dpm.close_port(port)
        with open(report, "w") as fh:
            json.dump({"lines": [
                f"two 2-rank jobs on {dev}: dpm_perrank rendezvous in "
                f"{rdv_ms:.1f} ms (accept side, rank 0), messages both "
                f"ways from every rank (root-relayed), a 4 MB CUDA tensor "
                f"arrived as numpy with the same bits (send + recv "
                f"{cross_ms:.1f} ms, host clock)"]}, fh)
    MPI.Finalize()
    print(f"OK bridge {role} rank={r}/{n}", flush=True)
    return 0


def _sessions_rank(report: str) -> int:
    """A rank of phase 15(e)'s 3-rank sessions job (p23 on CUDA
    tensors)."""
    from ompi_tpu_torch.core.rankcomm import counters
    from ompi_tpu_torch.runtime.session import Session
    MPI.Init()
    w = MPI.get_comm_world()
    r, n = w.rank(), w.size
    dev = w.device
    s1, s2 = Session(), Session()
    check(int(s1.get_pset_info("mpi://WORLD").get("size")) == n
          and s1.get_nth_pset(1) == "mpi://SELF", "psets")
    grp = tuple(range(n))
    c1 = s1.comm_create_from_group(s1.group_from_pset("mpi://WORLD"),
                                   tag="work")
    c2 = s2.comm_create_from_group(s2.group_from_pset("mpi://WORLD"),
                                   tag="work")
    check(c1.cid == ("s", "work", grp, 0) and c2.cid == ("s", "work", grp, 1)
          and c1.rank() == c2.rank() == r, f"cids {c1.cid}, {c2.cid}")
    base = (torch.arange(LOCAL_ELEMS, device=dev) % 1024).float()
    tri = n * (n - 1) / 2
    before = counters["coll_device"]
    t0 = time.perf_counter()
    y1 = c1.allreduce(base + r, MPI.SUM)
    y2 = c2.allreduce(base * 2 + r, MPI.SUM)
    torch.cuda.synchronize()
    two_ms = (time.perf_counter() - t0) * 1e3
    check(counters["coll_device"] == before + 2, "the device tier missed")
    check(torch.equal(y1, base * n + tri)
          and torch.equal(y2, base * 2 * n + tri), "session allreduces")
    # independent traffic on one tag: a CUDA tensor ring on each comm
    for c, k in ((c1, 1.0), (c2, 2.0)):
        c.send(base * k + r, (r + 1) % n, tag=3)
        got, _ = c.recv((r - 1) % n, tag=3)
        check(got.device == dev and torch.equal(got, base * k + (r - 1) % n),
              "session ring")
    c2d = c2.dup()
    check(torch.equal(c2d.allreduce(base, MPI.SUM), base * n), "dup")
    w.barrier()
    s1.finalize()
    check(c1._freed, "s1's comm survived its finalize")
    check(torch.equal(c2.allreduce(base, MPI.SUM), base * n)
          and torch.equal(w.allreduce(base, MPI.SUM), base * n),
          "s2 and the world after s1's finalize")
    s2.finalize()
    check(c2._freed and c2d._freed, "s2's family survived")
    w.barrier()
    if r == 0:
        with open(report, "w") as fh:
            json.dump({"lines": [
                f"{n}-rank job on {dev}: two sessions, tag 'work', CIDs "
                f"{c1.cid} and {c2.cid}; their {LOCAL_ELEMS * 4 >> 20} MB "
                f"CUDA allreduces took the device tier (2 launches, "
                f"{two_ms:.1f} ms host clock for both) = exact sums; "
                f"independent CUDA tensor rings on the same tag; session 1 "
                f"finalized while session 2, its dup and the world went "
                f"on"]}, fh)
    MPI.Finalize()
    print(f"OK sessions rank={r}/{n}", flush=True)
    return 0


def phase_sessions_job(smi: str, world_s: float) -> None:
    """Phase 15(e): the two bridged 2-rank jobs and the 3-rank sessions
    job, all three at once, each under its own limit."""
    import signal
    import tempfile
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    mpirun = os.path.join(root, "ompi_tpu_torch", "tools", "mpirun.py")
    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        port_file = os.path.join(tmp, "port.txt")
        jobs = []
        for name, n, args in (
                ("bridge accept", 2,
                 ["--bridge-rank", "accept", port_file,
                  os.path.join(tmp, "bridge.json")]),
                ("bridge connect", 2,
                 ["--bridge-rank", "connect", port_file,
                  os.path.join(tmp, "unused.json")]),
                ("sessions", 3,
                 ["--sessions-rank", os.path.join(tmp, "sessions.json")])):
            cmd = [sys.executable, mpirun, "--per-rank", "-n", str(n),
                   "--timeout", str(SES_JOB_TIMEOUT), me] + args
            jobs.append((name, n, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, cwd=root, start_new_session=True)))
        outs = []
        deadline = time.monotonic() + SES_JOB_TIMEOUT + 5
        for name, n, p in jobs:
            try:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                outs.append(("", f"{name}: killed at the phase's limit"))
        for _name, _n, p in jobs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
        for (name, n, p), (out, err) in zip(jobs, outs):
            oks = out.count("OK ")
            if p.returncode != 0 or oks != n:
                sys.stderr.write(err[-6000:])
                check(False, f"{name} job rc={p.returncode}, {oks} of {n} "
                      f"ranks OK:\n{out[-3000:]}")
        lines = []
        for rep in ("bridge.json", "sessions.json"):
            with open(os.path.join(tmp, rep)) as f:
                lines += json.load(f)["lines"]
    job_s = time.perf_counter() - t0
    check(job_s < SES_JOB_PHASE_S, f"the per-rank part took {job_s:.1f} s")
    for line in lines:
        phase("sessions", f"{line} | {smi}")
    phase("sessions", f"per-rank part {job_s:.1f} s (limit "
          f"{SES_JOB_PHASE_S} s); phase 15 took {world_s + job_s:.1f} s "
          f"| {smi}")


# -- phase 16 ----------------------------------------------------------
OSC_SEED = 1600
OSC_ROWS = 8                   # host numpy rows per fold, 32 MB fp32 each
OSC_SMALL = 1 << 20            # uint32 window, dynamic regions (elements)
OSC_JOB_TIMEOUT = 60           # seconds each per-rank job may take
OSC_JOB_PHASE_S = 90           # phase 16 must end within this
OSC_ENTRY = ("ompi_tpu_reduce_local", "ompi_tpu_pack_runs_rows",
             "ompi_tpu_unpack_runs_rows", "ompi_tpu_match_send",
             "ompi_tpu_match_take", "ompi_tpu_match_post")
OSC_HB = (("mpi_base_ft_hb_period", 0.1), ("mpi_base_ft_hb_timeout", 0.8),
          ("mpi_base_ft_hb_miss", 3))


class _CountingLib:
    """The port's native library with a count per entry point called
    through it. Phase 16 swaps it in for ``native.get_lib`` in this
    process (as ``tests/test_native_runtime.py`` patches ``get_lib``):
    the package itself keeps no counter."""

    def __init__(self, lib):
        self._lib = lib
        self.counts = dict.fromkeys(OSC_ENTRY, 0)

    def __getattr__(self, name):
        f = getattr(self._lib, name)
        if name not in self.counts:
            return f

        def counted(*args):
            self.counts[name] += 1
            return f(*args)
        return counted


def _osc_native_checks(w) -> list:
    """16(a): the native host library on the paths that call it."""
    import functools
    from ompi_tpu_torch import native as N
    from ompi_tpu_torch.coll import basic
    from ompi_tpu_torch.core import op as op_mod
    from ompi_tpu_torch.core import rankcomm
    from ompi_tpu_torch.native import loader
    check(N.native_available(), f"the native library did not build: "
          f"{N.build_error()}")
    path = loader.lib_path()
    check(path.parent == loader.BUILD_DIR and path.exists(),
          f"native library at {path}")
    lines = [f"native library {path.name} in {loader.BUILD_DIR.name}/ "
             f"(g++ -O3 of native/*.cpp), built in "
             f"{loader.build_seconds():.2f} s in this process, ABI "
             f"{N.get_lib().ompi_tpu_native_abi()}"]
    lib = _CountingLib(N.get_lib())
    real = N.get_lib
    N.get_lib = lambda: lib
    try:
        rng = np.random.default_rng(OSC_SEED)
        rows = rng.standard_normal((OSC_ROWS, LOCAL_ELEMS), dtype=np.float32)
        times = []
        for op in (MPI.SUM, MPI.MAX):
            npfn = op_mod.NP_COMBINERS[op.name]
            nat = lambda op=op: functools.reduce(
                lambda a, b: rankcomm._apply(op, a, b), rows)
            ref = lambda npfn=npfn: functools.reduce(npfn, rows)
            check(_bits(nat(), ref()), f"rankcomm._apply {op.name}: native "
                  f"against numpy")
            times.append((f"host fold {op.name}", host_ms(nat, 3),
                          host_ms(ref, 3)))
        del rows
        ints = rng.integers(-2 ** 31, 2 ** 31 - 1, (OSC_ROWS, LOCAL_ELEMS),
                            dtype=np.int32)
        for op in (MPI.BAND, MPI.BXOR, MPI.LAND):
            npfn = op_mod.NP_COMBINERS[op.name]
            nat = lambda op=op: basic._np_fold(op, ints)
            ref = lambda npfn=npfn: functools.reduce(npfn, ints)
            check(_bits(nat(), ref()), f"coll/basic {op.name} on int32")
            times.append((f"basic {op.name} int32", host_ms(nat, 3),
                          host_ms(ref, 3)))
        del ints
        # reduce_local: 10 dtypes x 10 ops, NaNs in the float operands
        ops = ("SUM", "PROD", "MAX", "MIN", "BAND", "BOR", "BXOR", "LAND",
               "LOR", "LXOR")
        dts = (np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
               np.uint32, np.uint64, np.float32, np.float64)
        native_cases = 0
        for dt in dts:
            if np.dtype(dt).kind == "f":
                a = rng.standard_normal(OSC_SMALL).astype(dt)
                b = rng.standard_normal(OSC_SMALL).astype(dt)
                a[::7], b[3::11] = np.nan, np.nan
            else:
                info = np.iinfo(dt)
                a = rng.integers(info.min, info.max, OSC_SMALL, dtype=dt,
                                 endpoint=True)
                b = rng.integers(info.min, info.max, OSC_SMALL, dtype=dt,
                                 endpoint=True)
            for name in ops:
                if np.dtype(dt).kind == "f" and name.startswith("B"):
                    continue             # no bitwise op on floats
                op = getattr(MPI, name)
                before = lib.counts["ompi_tpu_reduce_local"]
                got = op_mod.reduce_local(a, b, op)
                want = op_mod.np_combiner(op)(a, b)
                native_cases += lib.counts["ompi_tpu_reduce_local"] > before
                check(_bits(got, want), f"reduce_local {name} on "
                      f"{np.dtype(dt).name}")
        check(native_cases == len(dts) * len(ops) - 6,
              f"{native_cases} reduce_local cases took the C++ table")
        lines.append(f"reduce_local: {len(dts)} dtypes x {len(ops)} ops at "
                     f"{OSC_SMALL} elements (NaNs in the float operands; "
                     f"no bitwise op on the 2 float dtypes): all "
                     f"{native_cases} through the C++ table, bit for bit "
                     f"= the numpy route")
        # the convertor on a (4096, 2048) host matrix
        L = MAT[0] * MAT[1]
        m = rng.standard_normal(L, dtype=np.float32)
        types = {"vector(4096, 1024, 2048)":
                 MPI.FLOAT.create_vector(MAT[0], 1024, MAT[1]).commit(),
                 "indexed (4096 blocks of 1..1024)":
                 MPI.FLOAT.create_indexed(
                     list(rng.integers(1, 1025, MAT[0])),
                     list(np.arange(MAT[0]) * MAT[1])).commit()}
        for name, t in types.items():
            idx = t.flat_indices(1)
            p = convertor.pack(m, t, 1)
            check(_bits(p, m[idx]), f"{name}: native pack")
            u = convertor.unpack(np.zeros_like(m), p, t, 1)
            fancy = np.zeros_like(m)
            fancy[idx] = m[idx]
            check(_bits(u, fancy), f"{name}: native unpack")
            out = np.zeros_like(m)
            times.append((f"pack {name}", host_ms(
                lambda t=t: convertor.pack(m, t, 1), 5),
                host_ms(lambda idx=idx: np.ascontiguousarray(m[idx]), 5)))
            times.append((f"unpack {name}", host_ms(
                lambda t=t, p=p: convertor.unpack(out, p, t, 1), 5),
                host_ms(lambda idx=idx, p=p: out.__setitem__(idx, p), 5)))
        # matching: the 8 x 32 MB ring and 256 wildcards, native on and off
        g = torch.Generator(device="cuda").manual_seed(OSC_SEED)
        x = torch.randn((w.size, LOCAL_ELEMS), device="cuda", generator=g)
        xh = x.cpu().numpy()
        engines = {}
        for label, off in (("python", "1"), ("native", None)):
            if off:
                os.environ["OMPI_TPU_TORCH_DISABLE_NATIVE_MATCH"] = off
            try:
                d = w.dup()
                d.send(x[0, :2], src=0, dest=1, tag=0)   # makes the engine
                d.recv(0, 0, dst=1)
            finally:
                os.environ.pop("OMPI_TPU_TORCH_DISABLE_NATIVE_MATCH", None)
            check((d._pml._lib is not None) == (label == "native"),
                  f"{label} matching engine")
            engines[label] = d
        seen = {}
        for label, d in engines.items():
            order = []
            for sends_first in (False, True):
                got, sts = _ring(d, x, 1, sends_first)
                check(all(_bits(o, xh[(r - 1) % w.size])
                          for r, o in enumerate(got)),
                      f"{label} ring (sends first {sends_first})")
                order += [(s.source, s.tag) for s in sts]
            small = torch.ones(2, device="cuda")
            for i in range(256):
                d.send(small * i, src=(i * 3) % w.size, dest=0, tag=i % 7)
            us = []
            for _ in range(256):
                t0 = time.perf_counter()
                data, st = d.recv(MPI.ANY_SOURCE, MPI.ANY_TAG, dst=0)
                us.append((time.perf_counter() - t0) * 1e6)
                order.append((st.source, st.tag, float(data[0])))
            seen[label] = order
            ring_ms = device_ms(lambda d=d: _ring(d, x, 3, False), iters=5,
                                warmup=1)
            times.append((f"{label} matching: ring ms / wildcard us",
                          ring_ms, statistics.median(us)))
        check(seen["python"] == seen["native"], "matching order differs "
              "between the native and the Python engine")
        for d in engines.values():
            d.free()
        del x
    finally:
        N.get_lib = real
    counts = lib.counts
    check(all(counts.values()), f"a native entry point was never called: "
          f"{counts}")
    lines.append("native calls made through the library in this phase: "
                 + ", ".join(f"{k[9:]} {v}" for k, v in counts.items()))
    lines.append("ring order, statuses and 256 wildcard matches: the "
                 "native engine = the Python engine")
    for what, a, b in times:
        lines.append(f"{what}: native {a:.3f}, numpy/python {b:.3f} "
                     f"(host ms, median)" if "matching" not in what else
                     f"{what}: {a:.4f} ms (device), {b:.2f} us (host, "
                     f"median of 256)")
    return lines


def _osc_win_checks(w) -> list:
    """16(b): the single-controller Win on cuda:0, 8 x 32 MB fp32."""
    dev = torch.device("cuda", 0)
    n = w.size
    g = torch.Generator(device=dev).manual_seed(OSC_SEED + 1)
    x = torch.randn((n, LOCAL_ELEMS), device=dev, generator=g)
    xh = x.cpu().numpy()
    win = MPI.Win.allocate(w, LOCAL_ELEMS, np.float32)
    on_card = lambda wn: (wn.buffer.device == dev
                          and wn.buffer.shape[0] == n)
    check(on_card(win), f"window on {win.buffer.device}")
    win.fence()
    for r in range(n):
        win.put(x[r], (r + 1) % n)
    win.fence()
    check(all(torch.equal(win.buffer[(r + 1) % n], x[r]) for r in range(n)),
          "fenced put ring")
    check(_bits(win.get(3, 5, 1000), xh[2, 5:1005]), "get")
    row = xh[3].copy()                     # row 4 holds x[3]
    for name, inc, fn in (("SUM", 5, np.add), ("MAX", 6, np.maximum),
                          ("REPLACE", 7, lambda a, b: b),
                          ("NO_OP", 0, lambda a, b: a)):
        win.accumulate(x[inc], 4, getattr(MPI, name))
        want = fn(row, xh[inc])
        got = win.get(4)
        if name == "SUM":
            _close(got, want, 1e-5, 0.0, "accumulate SUM")
        else:
            check(_bits(got, want), f"accumulate {name}")
        row = got
    # uint32: the signed twin through Op.__call__, exact
    rng = np.random.default_rng(OSC_SEED)
    u = rng.integers(0, 2 ** 32 - 1, (3, OSC_SMALL), dtype=np.uint32,
                     endpoint=True)
    uw = MPI.Win.allocate(w, OSC_SMALL, np.uint32)
    check(on_card(uw) and uw.buffer.dtype == torch.uint32, "uint32 window")
    uw.put(u[0], 1)
    cur = u[0]
    ud = torch.from_numpy(u).to(dev)
    for name, k, fn in (("SUM", 1, np.add), ("MAX", 2, np.maximum),
                        ("REPLACE", 1, lambda a, b: b),
                        ("NO_OP", 2, lambda a, b: a)):
        uw.accumulate(ud[k], 1, getattr(MPI, name))
        cur = fn(cur, u[k])
        check(_bits(uw.get(1), cur), f"uint32 accumulate {name}")
    # get_accumulate, fetch_and_op, compare_and_swap
    before = win.get(2, 7, OSC_SMALL)
    old = win.get_accumulate(x[1, :OSC_SMALL], 2, MPI.SUM, target_disp=7)
    check(_bits(old, before), "get_accumulate's fetch")
    _close(win.get(2, 7, OSC_SMALL), before + xh[1, :OSC_SMALL], 1e-5, 0.0,
           "get_accumulate SUM")
    v0 = win.get(6, 11, 1)[0]
    check(win.fetch_and_op(3.0, 6, MPI.SUM, target_disp=11) == v0
          and win.get(6, 11, 1)[0] == np.float32(v0 + np.float32(3.0)),
          "fetch_and_op")
    v1 = win.get(6, 11, 1)[0]
    check(win.compare_and_swap(42.0, v1, 6, 11) == v1
          and win.get(6, 11, 1)[0] == 42.0, "compare_and_swap (swap)")
    check(win.compare_and_swap(7.0, 1.5, 6, 11) == 42.0
          and win.get(6, 11, 1)[0] == 42.0, "compare_and_swap (no swap)")
    # requests, PSCW, lock/unlock
    req = win.rput(x[2], 0)
    racc = win.raccumulate(x[3], 0, MPI.MAX)
    check(req._event is not None, "rput did not complete on an event")
    req.wait()
    racc.wait()
    check(_bits(win.get(0), np.maximum(xh[2], xh[3])), "rput + raccumulate")
    grp = w.group
    win.post(grp)
    win.start(grp)
    win.put(x[4], 1)
    win.complete()
    win.wait()
    check(win.test() and _bits(win.get(1), xh[4]), "PSCW")
    win.lock(5)
    win.accumulate(x[5], 5, MPI.REPLACE)
    win.unlock(5)
    check(_bits(win.get(5), xh[5]), "lock / unlock")
    dyn = MPI.Win.create_dynamic(w, np.float32)
    b0 = dyn.attach(OSC_SMALL)
    dyn.put(x[0, :OSC_SMALL], 5, b0)
    b1 = dyn.attach(OSC_SMALL)
    dyn.put(x[1, :OSC_SMALL], 5, b1)
    check(b0 == 0 and b1 == OSC_SMALL and on_card(dyn)
          and _bits(dyn.get(5), np.concatenate([xh[0, :OSC_SMALL],
                                                xh[1, :OSC_SMALL]])),
          "attach")
    check(on_card(win) and on_card(uw), "a window row left cuda:0")
    # device ms: 32 MB from a CUDA origin and from a numpy origin
    nb = LOCAL_ELEMS * 4
    put_b, acc_b = 2 * nb / HBM_BYTES_PER_S * 1e3, 3 * nb / HBM_BYTES_PER_S \
        * 1e3
    ms = {"put cuda": device_ms(lambda: win.put(x[1], 2)),
          "acc cuda": device_ms(lambda: win.accumulate(x[1], 2, MPI.SUM)),
          "put numpy": device_ms(lambda: win.put(xh[1], 2), iters=10),
          "acc numpy": device_ms(lambda: win.accumulate(xh[1], 2, MPI.SUM),
                                 iters=10)}
    for wn in (win, uw, dyn):
        wn.free()
    del x, ud
    torch.cuda.empty_cache()
    return [
        "Win on cuda:0, 8 x 32 MB fp32 (256 MB stacked, every row on "
        "cuda:0 after every call): fenced put ring, get, accumulate SUM "
        "(rtol 1e-5) / MAX / REPLACE / NO_OP, uint32 SUM / MAX / REPLACE / "
        "NO_OP exact, get_accumulate, fetch_and_op, compare_and_swap "
        "(swap and no swap), rput + raccumulate on a CUDA event, PSCW, "
        "lock / unlock, attach: all = numpy",
        f"32 MB put from a CUDA origin {ms['put cuda']:.4f} ms (bound "
        f"{put_b:.4f} ms, 64 MiB over 3.35 TB/s: {put_b / ms['put cuda']:.1%}"
        f" of HBM); accumulate SUM {ms['acc cuda']:.4f} ms (bound "
        f"{acc_b:.4f} ms, 96 MiB: {acc_b / ms['acc cuda']:.1%}); from a numpy "
        f"origin (one pageable host-to-device copy): put "
        f"{ms['put numpy']:.4f} ms, accumulate {ms['acc numpy']:.4f} ms "
        f"(device ms, CUDA events, median)"]


def phase_onesided_world(w, smi: str) -> float:
    """Phase 16(a) and (b) on the live 8-rank world on cuda:0."""
    t0 = time.perf_counter()
    for line in _osc_native_checks(w) + _osc_win_checks(w):
        phase("onesided", f"{line} | {smi}")
    return time.perf_counter() - t0


def _osc_fresh_check(report: str) -> int:
    """16(b)'s DtoH count in a process of its own (``--osc-fresh-check``;
    see ``_fresh_check``): a 32 MB put and accumulate from a CUDA origin
    on the 8-row world's window, each warmed once, then counted under
    the profiler, with a ``.cpu()`` control."""
    dev = torch.device("cuda", 0)
    MPI.Init(devices=[dev] * N_RANKS)
    w = MPI.get_comm_world()
    win = MPI.Win.allocate(w, LOCAL_ELEMS, np.float32)
    x = torch.randn((2, LOCAL_ELEMS), device=dev)
    calls = {"put": lambda: win.put(x[0], 3),
             "accumulate SUM": lambda: win.accumulate(x[1], 3, MPI.SUM),
             "accumulate MAX": lambda: win.accumulate(x[1], 4, MPI.MAX),
             "rput": lambda: win.rput(x[0], 5).wait(),
             "raccumulate": lambda: win.raccumulate(x[1], 5, MPI.SUM)
             .wait()}
    counts = {}
    for name, fn in calls.items():
        fn()
        counts[name] = _dtoh_events(fn)
    t = torch.ones(1024, device=dev)
    with open(report, "w") as fh:
        json.dump({"counts": counts,
                   "control": _dtoh_events(lambda: t.cpu())}, fh)
    win.free()
    MPI.Finalize()
    return 0


def _osc_p43(w, comp: str, out_dir: str) -> list:
    """The port's p43 drill at 32 MB per window, CUDA origins; rank 0's
    lines (host ms per op) and, on shm, its telemetry dump and flight
    record."""
    from ompi_tpu_torch import telemetry
    from ompi_tpu_torch.api import mpi as api
    from ompi_tpu_torch.telemetry import flightrec
    r, n = w.rank(), w.size
    nxt, prv = (r + 1) % n, (r - 1) % n
    full = np.random.default_rng(OSC_SEED + 43).standard_normal(
        (n, LOCAL_ELEMS), dtype=np.float32)
    origin = torch.from_numpy(full).to(w.device)
    p0 = pvar.pvar_read("osc_puts")
    win = api.Win_allocate(w, LOCAL_ELEMS, np.float32, name="p43",
                           force=comp)
    check(win.component == comp, win.component)
    win.local[:] = 0.0
    win.fence()
    win.put(origin[r], nxt)
    win.fence()
    check(np.array_equal(win.local, full[prv]), "put ring")
    lines = []
    if comp == "shm" and r == 0:
        path = flightrec.record("osc_check", {"rank": r})
        with open(path) as f:
            epochs = json.load(f)["osc_epochs"]
        check(epochs and epochs[0]["fenced"], f"osc_epochs {epochs}")
        lines.append(f"flight record {os.path.basename(path)}: osc_epochs "
                     f"{epochs}")
    win.fence()
    view = win.get((r + 2) % n, 0, LOCAL_ELEMS)
    got = np.asarray(view).copy()
    win.fence()
    check(np.array_equal(got, full[(r + 1) % n]), "get ring")
    if comp == "shm":
        check(not np.asarray(view).flags.owndata, "shm get copied")
    del view
    win.fence()
    win.local[:] = 0.0
    win.fence()
    win.accumulate(origin[r], 0, op="sum")
    win.accumulate(origin[r].abs(), 1, op="max")
    win.fence()
    if r == 0:
        check(np.allclose(win.local, full.sum(axis=0, dtype=np.float32),
                          rtol=1e-4, atol=1e-4), "sum fan-in")
    if r == 1:
        check(np.array_equal(win.local, np.abs(full).max(axis=0)),
              "max fan-in")
    w.barrier()                          # the checks read before the
    win.lock(nxt)                        # passive puts land
    win.put(origin[r] * 2.0, nxt)
    win.flush(nxt)
    win.unlock(nxt)
    w.barrier()
    check(np.array_equal(win.local, full[prv] * 2.0), "passive put")
    check(pvar.pvar_read("osc_puts") - p0 >= 2, "osc_puts")
    # host ms per op at 32 MB (medians of 3, inside one fence epoch)
    win.fence()
    ms = {}
    for kind, fn in (("put", lambda: win.put(origin[r], nxt)),
                     ("get", lambda: win.get(nxt, 0, LOCAL_ELEMS)),
                     ("acc", lambda: win.accumulate(origin[r].abs(), nxt,
                                                    op="max"))):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        ms[kind] = statistics.median(ts)
    win.fence()
    if comp == "shm" and r == 0:
        path = os.path.join(out_dir, "telemetry_0.json")
        telemetry.dump(path, rank=0)
        with open(path) as f:
            osc = json.load(f).get("osc", {})
        check(osc.get("puts", 0) >= 5 and osc.get("fences", 0) >= 8,
              f"telemetry dump osc section {osc}")
        lines.append(f"telemetry dump: osc section puts {osc['puts']}, gets "
                     f"{osc['gets']}, accs {osc['accs']}, fences "
                     f"{osc['fences']}, windows_shm {osc['windows_shm']}")
    w.barrier()
    win.free()
    lines.insert(0, f"p43 {comp}, 4 ranks, 32 MB per window, CUDA origins "
                 f"staged with .cpu(): put/get ring, sum/max fan-in, "
                 f"passive put = numpy on every rank; rank 0 host ms per "
                 f"32 MB op: put {ms['put']:.2f}, get {ms['get']:.2f}, "
                 f"accumulate {ms['acc']:.2f} (median of 3)")
    return lines


def _osc_p13(w) -> list:
    """The port's p13 on 3 ranks (one CUDA origin in the first put)."""
    from ompi_tpu_torch.osc.perrank import LOCK_EXCLUSIVE, RankWindow
    r, n = w.rank(), w.size
    win = RankWindow(w, 16, np.float32)
    win.fence()
    win.put(torch.tensor([float(r + 1)], device=w.device), target=0, disp=r)
    win.fence()
    if r == 0:
        check(np.allclose(win.local[:n], np.arange(1, n + 1)), "p13 put")
    win.fence()
    win.accumulate([1.0], target=n - 1, disp=8, op="sum")
    win.fence()
    if r == n - 1:
        check(win.local[8] == float(n), "p13 accumulate")
    check(np.allclose(win.get(target=0, disp=0, count=n),
                      np.arange(1, n + 1)), "p13 get")
    old = win.fetch_and_op(1.0, target=0, disp=12, op="sum")
    check(0.0 <= old < n, "p13 fetch_and_op")
    win.fence()
    prev = win.compare_and_swap(0.0, float(r + 1), target=0, disp=15)
    check(w.allreduce(1 if prev == 0.0 else 0, MPI.SUM) == 1, "p13 CAS")
    win.fence()
    for _ in range(3):
        win.lock(1, LOCK_EXCLUSIVE)
        cur = win.get(target=1, disp=3, count=1)[0]
        win.put([cur + 1.0], target=1, disp=3)
        win.unlock(1)
    w.barrier()
    if r == 1:
        check(win.local[3] == float(3 * n), "p13 passive counter")
    win.free()
    w4 = RankWindow(w, 4, np.float64)
    w4.fence()
    right = (r + 1) % n
    w4.rput(np.array([10.0 + r, 20.0 + r]), right, disp=1).wait()
    ra = w4.raccumulate(np.array([0.25, 0.25]), right, disp=1, op="sum")
    ra.wait()
    g = w4.rget(right, disp=1, count=2)
    check(g.get()[0] == 10.25 + r, "p13 request RMA")
    w4.fence()
    w4.free()
    return ["p13, 3 ranks: put (a CUDA origin), accumulate, get, "
            "fetch_and_op, compare_and_swap (one winner), passive "
            "counter, rput / raccumulate / rget: every rank OK"]


def _osc_p44(w) -> list:
    """The port's p44: rank 2 SIGKILLs itself inside an exposure epoch;
    the survivors get ERR_PROC_FAILED from fence and from a put to it,
    revoke, free, shrink and allocate again."""
    import signal
    from ompi_tpu_torch.api import mpi as api
    r, n = w.rank(), w.size
    victim = 2
    nxt, prv = (r + 1) % n, (r - 1) % n
    api.Comm_set_errhandler(w, MPI.ERRORS_RETURN)
    w.barrier()
    full = np.random.default_rng(OSC_SEED + 44).standard_normal(
        (n, 1 << 14), dtype=np.float32)
    win = api.Win_allocate(w, 1 << 14, np.float32, name="p44", force="shm")
    win.local[:] = 0.0
    win.fence()
    win.put(torch.from_numpy(full[r]).to(w.device), nxt)
    win.fence()
    check(np.array_equal(win.local, full[prv]), "p44 healthy ring")
    if r == victim:
        os.kill(os.getpid(), signal.SIGKILL)
    t0 = time.perf_counter()
    deadline = time.monotonic() + 15
    while w.get_failed() != [victim]:
        check(time.monotonic() < deadline, f"p44 failed {w.get_failed()}")
        time.sleep(0.02)
    detect_ms = (time.perf_counter() - t0) * 1e3
    for what, fn in (("fence", win.fence),
                     ("put", lambda: win.put(full[r], victim))):
        try:
            fn()
            check(False, f"p44 {what} over a dead rank did not error")
        except MPI.MPIError as e:
            check(e.error_class == MPI.ERR_PROC_FAILED, f"p44 {what}: {e}")
    check(pvar.pvar_read("osc_ft_failed_epochs") >= 1, "p44 torn epoch")
    if r == 0:
        MPI.MPIX_Comm_revoke(w)
    deadline = time.monotonic() + 10
    while not MPI.MPIX_Comm_is_revoked(w):
        check(time.monotonic() < deadline, "p44 revoke")
        time.sleep(0.02)
    try:
        win.free()
    except MPI.MPIError:
        pass
    s = MPI.MPIX_Comm_shrink(w)
    n2, sr = s.size, s.rank()
    check(n2 == n - 1 and sr == {0: 0, 1: 1, 3: 2}[r], "p44 shrink")
    full2 = np.random.default_rng(OSC_SEED + 45).standard_normal(
        (n2, 1 << 14), dtype=np.float32)
    win2 = api.Win_allocate(s, 1 << 14, np.float32, name="p44b",
                            force="shm")
    win2.local[:] = 0.0
    win2.fence()
    win2.put(full2[sr], (sr + 1) % n2)
    win2.fence()
    check(np.array_equal(win2.local, full2[(sr - 1) % n2]), "p44 ring")
    win2.free()
    s.barrier()
    s.free()
    return [f"p44, 4 ranks: rank 2 SIGKILLed in a fence epoch; rank 0 saw "
            f"it failed after {detect_ms:.1f} ms, then ERR_PROC_FAILED "
            f"from fence and from a put to it, revoke, free, shrink to 3 "
            f"and a fenced ring on a new window"]


def _osc_rank(kind: str, report: str) -> int:
    """The rank program of phase 16(c) (``--osc-rank KIND REPORT``, run
    by mpirun --per-rank on cuda:0); rank 0 writes its lines."""
    from ompi_tpu_torch.accelerator import job_tag
    MPI.Init()
    w = MPI.get_comm_world()
    check(w.device.type == "cuda", f"rank on {w.device}")
    out_dir = os.path.dirname(report)
    if kind.startswith("p43"):
        lines = _osc_p43(w, kind[4:], out_dir)
    elif kind == "p13":
        lines = _osc_p13(w)
    else:
        lines = _osc_p44(w)
    if w.rank() == 0:
        with open(report, "w") as fh:
            json.dump({"tag": job_tag(), "lines": lines}, fh)
    r = w.rank()
    MPI.Finalize()
    print(f"OK osc {kind} rank={r}", flush=True)
    return 0


def phase_onesided_job(smi: str, world_s: float) -> None:
    """Phase 16(c): the p43 drill on shm and on pt2pt, p13 and p44 as
    per-rank jobs on cuda:0, and 16(b)'s fresh-process DtoH count, all
    started at once."""
    import glob
    import signal
    import tempfile
    from ompi_tpu_torch.accelerator import SHM_DIR
    from ompi_tpu_torch.osc.shm import WIN_PREFIX
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    mpirun = os.path.join(root, "ompi_tpu_torch", "tools", "mpirun.py")
    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for kind, n, mca, want_rc in (
                ("p43 shm", 4, (("mpi_base_telemetry", 1),
                                ("mpi_base_telemetry_flightrec_dir", tmp)),
                 0),
                ("p43 pt2pt", 4, (), 0), ("p13", 3, (), 0),
                ("p44", 4, OSC_HB, 256 - signal.SIGKILL)):
            rep = os.path.join(tmp, kind.replace(" ", "_") + ".json")
            cmd = [sys.executable, mpirun, "--per-rank", "-n", str(n),
                   "--timeout", str(OSC_JOB_TIMEOUT)]
            if kind == "p44":
                cmd.append("--enable-recovery")
            for k, v in mca:
                cmd += ["--mca", k, str(v)]
            cmd += [me, "--osc-rank", kind.replace(" ", "_"), rep]
            jobs.append((kind, n - (kind == "p44"), want_rc, rep,
                         subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True,
                                          cwd=root, start_new_session=True)))
        fresh = os.path.join(tmp, "dtoh.json")
        jobs.append(("fresh DtoH check", 0, 0, fresh, subprocess.Popen(
            [sys.executable, me, "--osc-fresh-check", fresh],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=root, start_new_session=True)))
        outs = []
        deadline = time.monotonic() + OSC_JOB_TIMEOUT + 5
        for kind, _n, _rc, _rep, p in jobs:
            try:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                outs.append(("", f"{kind}: killed at the phase's limit"))
        for *_x, p in jobs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
        lines, tags = [], []
        for (kind, n, want_rc, rep, p), (out, err) in zip(jobs, outs):
            oks = out.count("OK osc")
            if p.returncode != want_rc or oks != n:
                sys.stderr.write(err[-6000:])
                check(False, f"{kind}: rc={p.returncode} (want {want_rc}), "
                      f"{oks} of {n} ranks OK:\n{out[-3000:]}")
            with open(rep) as f:
                res = json.load(f)
            if n:
                lines += res["lines"]
                tags.append(res["tag"])
            else:
                check(res["control"] >= 1, f"the profiler saw "
                      f"{res['control']} DtoH events in a .cpu() copy")
                bad = {k: v for k, v in res["counts"].items() if v}
                check(not bad, f"Memcpy DtoH events inside Win {bad}")
                lines.append(f"0 Memcpy DtoH events (torch.profiler, a fresh "
                             f"process) in each of "
                             f"{', '.join(res['counts'])} from a CUDA origin "
                             f"at 32 MB; the control's .cpu() showed "
                             f"{res['control']}")
    left = [f for t in tags
            for f in glob.glob(os.path.join(SHM_DIR, f"otpt*_{t}_*"))]
    check(all(tags) and not left, f"files left: {left}")
    job_s = time.perf_counter() - t0
    for line in lines:
        phase("onesided", f"{line} | {smi}")
    check(world_s + job_s < OSC_JOB_PHASE_S, f"phase 16 took "
          f"{world_s + job_s:.1f} s")
    phase("onesided", f"per-rank jobs rc 0, 0, 0 and {256 - signal.SIGKILL} "
          f"(p44's victim, killed by SIGKILL); no {WIN_PREFIX}_ or other "
          f"otpt*_ file of the four jobs left under {SHM_DIR}; per-rank part "
          f"{job_s:.1f} s; phase 16 took {world_s + job_s:.1f} s (limit "
          f"{OSC_JOB_PHASE_S} s) | {smi}")


def main() -> int:
    if "--perrank-rank" in sys.argv:
        return _perrank_rank(sys.argv[-1])
    if "--dataplane-rank" in sys.argv:
        return _dataplane_rank(sys.argv[-1])
    if "--observe-rank" in sys.argv:
        return _observe_rank(sys.argv[-1])
    if "--resilience-rank" in sys.argv:
        return _resilience_rank(sys.argv[-1])
    if "--bridge-rank" in sys.argv:
        return _bridge_rank(*sys.argv[-3:])
    if "--sessions-rank" in sys.argv:
        return _sessions_rank(sys.argv[-1])
    if "--fresh-check" in sys.argv:
        return _fresh_check(sys.argv[-1])
    if "--osc-rank" in sys.argv:
        return _osc_rank(sys.argv[-2].replace("_", " "), sys.argv[-1])
    if "--osc-fresh-check" in sys.argv:
        return _osc_fresh_check(sys.argv[-1])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if "--resilience" in sys.argv:
        smi, _ = phase_device()
        MPI.Init(devices=[torch.device("cuda", 0)] * N_RANKS)
        res_s = phase_resilience_world(MPI.get_comm_world(), smi)
        MPI.Finalize()
        torch.cuda.empty_cache()
        phase_resilience_job(smi, res_s)
        return 0
    if "--sessions" in sys.argv:
        smi, _ = phase_device()
        MPI.Init(devices=[torch.device("cuda", 0)] * N_RANKS)
        ses_s = phase_sessions_world(MPI.get_comm_world(), smi)
        MPI.Finalize()
        torch.cuda.empty_cache()
        phase_sessions_job(smi, ses_s)
        return 0
    if "--onesided" in sys.argv:
        smi, _ = phase_device()
        MPI.Init(devices=[torch.device("cuda", 0)] * N_RANKS)
        osc_s = phase_onesided_world(MPI.get_comm_world(), smi)
        MPI.Finalize()
        torch.cuda.empty_cache()
        phase_onesided_job(smi, osc_s)
        return 0
    if "--perrank" in sys.argv:
        smi, _ = phase_device()
        phase_perrank(smi)
        MPI.Init(devices=[torch.device("cuda", 0)] * N_RANKS)
        _tuned_single(MPI.get_comm_world(), smi)
        world_s = phase_observe_world(MPI.get_comm_world(), smi)
        MPI.Finalize()
        torch.cuda.empty_cache()
        phase_dataplane(smi)
        phase_observe_job(smi, world_s)
        phase_resilience_job(smi, 0.0)
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
    world_s = phase_observe_world(world, smi)
    ses_s = phase_sessions_world(world, smi)
    osc_s = phase_onesided_world(world, smi)
    res_s = phase_resilience_world(world, smi)
    MPI.Finalize()
    torch.cuda.empty_cache()
    phase_perrank(smi)
    phase_dataplane(smi)
    phase_observe_job(smi, world_s)
    phase_resilience_job(smi, res_s)
    phase_sessions_job(smi, ses_s)
    phase_onesided_job(smi, osc_s)
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
