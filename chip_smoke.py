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
                the card, at the shapes the main path gives it and at
                larger and ragged ones; max abs error, device time
                (median of CUDA-event timings), the plain version's time
                and the least time the card could take (``bound``).
4. collectives — ``Init(devices=[cuda:0] * 8)`` and the Standard journey
                on 32 MB fp32 per rank (256 MB stacked), every result
                checked against numpy on a host copy.
5. flagship   — ``entry()``'s forward under ``torch.no_grad()`` at its
                batch (2) and at batch 64, through the flash-fold kernel
                (its launch count read around these runs), against the
                same forward through the plain fold.

Then a JSON line with one record per kernel, the ``nvidia-smi`` line, and
as the last line ``{"ok": true, "device": {...}}``. Any failure raises:
the script exits non-zero and prints no result. Without a CUDA device it
exits non-zero at once.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import ompi_tpu_torch as MPI
from ompi_tpu_torch.entry import CONFIG, entry
from ompi_tpu_torch.models import transformer as T
from ompi_tpu_torch.ops import _build
from ompi_tpu_torch.ops import flash_attention as FA

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W): fp32 outside
# the tensor cores, and HBM3 bandwidth.
FP32_FLOPS = 67e12
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
def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build_all(verbose=True)
    for name, rec in built.items():
        ptxas = [ln.strip() for ln in rec["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        phase("build", f"{name}: {rec['seconds']:.2f} s "
              f"{' | '.join(ptxas)}")
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


def _max_err(got, want, atol, rtol, what):
    err = (got - want).abs()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    check(bool((err <= atol + rtol * want.abs()).all()),
          f"{what}: max abs err {err.max().item():.3g} beyond "
          f"atol {atol} rtol {rtol}")
    return err.max().item()


def _fold_bound_ms(BH, Sq, Sk, D):
    flops = 4 * BH * Sq * Sk * D
    nbytes = 4 * BH * (3 * Sq * D + 2 * Sk * D + 4 * Sq)
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_kernels() -> dict:
    """flash_fold against _fold_torch. Tolerances: o atol = rtol = 1e-4,
    m and l 1e-5 — the kernel sums in another order (online over 32-row
    K tiles) than the one-shot plain fold."""
    b = 2  # entry()'s batch
    shapes = [
        ("entry", b * CONFIG.n_heads, CONFIG.seq, CONFIG.seq,
         CONFIG.d_head, ["1"]),
        ("entry_b64", 64 * CONFIG.n_heads, CONFIG.seq, CONFIG.seq,
         CONFIG.d_head, ["1"]),
        ("aligned", 32, 1024, 1024, 128, ["0", "1", "1>2", "1>0"]),
        ("ragged", 3, 100, 260, 40, ["0", "1", "fresh2"]),
    ]
    out = {}
    for si, (name, BH, Sq, Sk, D, modes) in enumerate(shapes):
        q, k, v, fresh = _fold_inputs(BH, Sq, Sk, D, seed=100 + si)
        errs = []
        for spec in modes:
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
            e = [_max_err(got[0], want[0], 1e-4, 1e-4, f"{name} o"),
                 _max_err(got[1], want[1], 1e-5, 1e-5, f"{name} m"),
                 _max_err(got[2], want[2], 1e-5, 1e-5, f"{name} l")]
            if spec == "fresh2":
                check(bool((got[2] == float(Sk)).all()),
                      f"{name}: mode 2 on fresh accumulators must give "
                      f"l == Sk")
            errs.append(max(e))
            phase("kernels", f"flash_fold {name} (BH={BH}, Sq={Sq}, "
                  f"Sk={Sk}, D={D}) {label}: max abs err o {e[0]:.3g} "
                  f"m {e[1]:.3g} l {e[2]:.3g}")
        tmode = 1
        ms = device_ms(lambda: FA.flash_block_update(q, k, v, *fresh, tmode))
        plain_ms = device_ms(lambda: FA._fold_torch(q, k, v, *fresh, tmode))
        bound_ms, bound_by = _fold_bound_ms(BH, Sq, Sk, D)
        out[name] = {"max_abs_err": max(errs), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by}
        phase("kernels", f"flash_fold {name} mode 1: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), kernel/bound {ms / bound_ms:.1f}x")
    return out


# -- phase 4 -----------------------------------------------------------
def _close(got, want, rtol, atol, what):
    ok = np.allclose(got, want, rtol=rtol, atol=atol)
    check(ok, f"{what}: max abs err "
          f"{np.max(np.abs(got.astype(np.float64) - want)):.3g}")


def phase_collectives() -> None:
    """Float SUM/PROD/scan results: rtol 1e-5 (atol 1e-5 for sums near
    zero) — the device sums 8 rows in another order than numpy. MAX, MIN,
    data movement and int32 are exact."""
    MPI.Init(devices=[torch.device("cuda", 0)] * N_RANKS)
    w = MPI.get_comm_world()
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

    def run(name, fn, read=x.numel() * 4):
        """Time ``fn`` and return its result on the host. The rate is the
        least device traffic of the call — the input it must read
        (``read``: the stacked input, or root's row alone) read once and
        the stacked output written once — over its time; all 8 ranks
        share one card's memory."""
        ms = host_ms(fn)
        res = fn()
        moved = read + res.numel() * res.element_size()
        phase("collectives", f"{name}: {ms:.3f} ms for {local_mib:.0f} MiB "
              f"per rank; {moved / 1e6:.0f} MB in+out, "
              f"{moved / ms / 1e6:.1f} GB/s "
              f"({moved / ms / 1e9 / (HBM_BYTES_PER_S / 1e12):.1%} of "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
        return res.cpu().numpy()

    r = run("allreduce SUM f32", lambda: w.allreduce(x, MPI.SUM))
    _close(r, np.broadcast_to(xh.sum(0), xh.shape), 1e-5, 1e-5,
           "allreduce SUM")
    r = run("allreduce MAX f32", lambda: w.allreduce(x, MPI.MAX))
    check(np.array_equal(r, np.broadcast_to(xh.max(0), xh.shape)),
          "allreduce MAX")
    r = run("allreduce PROD f32", lambda: w.allreduce(xp, MPI.PROD))
    _close(r, np.broadcast_to(xph.prod(0), xph.shape), 1e-5, 0,
           "allreduce PROD")
    r = run("allreduce SUM i32", lambda: w.allreduce(xi, MPI.SUM))
    check(np.array_equal(r, np.broadcast_to(xih.sum(0, dtype=np.int32),
                                            xih.shape)), "allreduce i32")
    r = run("reduce MIN root 2", lambda: w.reduce(x, MPI.MIN, root=2))
    check(np.array_equal(r[2], xh.min(0)), "reduce MIN")
    r = run("bcast root 3", lambda: w.bcast(x, root=3), read=local_bytes)
    check(np.array_equal(r, np.broadcast_to(xh[3], xh.shape)), "bcast")
    r = run("allgather", lambda: w.allgather(x))
    check(r.shape == (n, n, LOCAL_ELEMS), "allgather shape")
    check(all(np.array_equal(r[i], xh) for i in range(n)), "allgather")
    r = run("gather root 1", lambda: w.gather(x, root=1))
    check(np.array_equal(r[1], xh), "gather")
    del r
    r = run("scatter root 5", lambda: w.scatter(y, root=5),
            read=local_bytes)
    check(np.array_equal(r, yh[5]), "scatter")
    r = run("alltoall", lambda: w.alltoall(y))
    check(np.array_equal(r, np.swapaxes(yh, 0, 1)), "alltoall")
    r = run("reduce_scatter_block SUM",
            lambda: w.reduce_scatter_block(y, MPI.SUM))
    _close(r, yh.sum(0), 1e-5, 1e-5, "reduce_scatter_block")
    r = run("scan SUM", lambda: w.scan(x, MPI.SUM))
    pre = np.cumsum(xh, axis=0)
    _close(r, pre, 1e-5, 1e-5, "scan")
    r = run("exscan SUM", lambda: w.exscan(x, MPI.SUM))
    _close(r[1:], pre[:-1], 1e-5, 1e-5, "exscan")
    check(np.array_equal(r[0], xh[0]), "exscan row 0")
    del r, pre
    phase("collectives", f"barrier: {host_ms(w.barrier, iters=20):.4f} ms")

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
    MPI.Finalize()


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    smi, kind = phase_device()
    phase_build()
    kern = phase_kernels()
    phase_collectives()
    launches = phase_flagship()
    main_shape = kern["entry"]
    record = {"kernels": [{
        "name": "flash_fold", "route": "cuda",
        "source": "ompi_tpu_torch/csrc/flash_fold.cu",
        "replaces": "ompi_tpu/ops/flash_attention.py:72",
        "launches": launches,
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None,
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
