"""coll decision tables — fixed per-collective algorithm selection.

The port of ``ompi_tpu/coll/decision.py``: the re-design of coll/tuned's
decision functions (``coll_tuned_decision_fixed.c:40-45``) as ordered
``[min_comm_size, min_message_bytes, algorithm]`` rules, the *last* rule
whose thresholds are both met winning, retunable through the tuned
dynamic-rules JSON (``coll/tuned``) exactly as the reference's dynamic
file is (``coll_tuned_component.c:187-191``).

The rows are the reference's, unchanged. They are keyed by platform:
``"cpu"`` takes the rows measured on the JAX package's 8-rank host mesh;
every other platform takes the ``FIXED_RULES`` rows, which encode ICI
wire-byte arithmetic, not a measurement. :func:`platform_key` names a
torch device the way JAX names its platform (``cuda`` is JAX's
``"gpu"``), so a dynamic-rules file written for JAX on a GPU reads the
same here. There is no ``"gpu"`` row: on one card every rank is a row of
one tensor in one HBM, and which schedule wins there is a measurement
(``chip_smoke.py``'s ``algorithms`` phase), not a port item.

The compression gate (:func:`compress_eligible`) and its rows are the
reference's too, and so are the per-rank tier's host rows: the
segment-pipeline rows and plan (:func:`pipeline_rules`,
:func:`pipeline_plan`) and the shared-segment fold rows
(:func:`shm_rules`).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

# Fixed decision tables. Every entry names an algorithm coll/torch
# implements for that collective.
FIXED_RULES: Dict[str, List[Sequence]] = {
    "allreduce": [
        [0, 0, "direct"],
        [0, 64 << 20, "rabenseifner"],
    ],
    "bcast": [
        [0, 0, "direct"],
        [0, 64 << 20, "scatter_allgather"],
    ],
    "allgather": [[0, 0, "direct"]],
    "alltoall": [[0, 0, "direct"]],
    "reduce_scatter_block": [[0, 0, "direct"]],
    "barrier": [[0, 0, "direct"]],
    # Root-targeted collectives: below the threshold one symmetric op,
    # above it the root-directed schedule (reduce moves 1/2, gather and
    # scatter 1/n of the symmetric alias's wire bytes).
    "reduce": [
        [0, 0, "alias"],
        [0, 64 << 10, "rabenseifner_root"],
    ],
    "gather": [
        [0, 0, "allgather"],
        [0, 64 << 10, "binomial"],
    ],
    "scatter": [
        [0, 0, "direct"],
        [0, 64 << 10, "binomial"],
    ],
}

# Algorithms that reorder combines relative to rank order: selection
# demotes them to 'direct' for non-commutative ops
# (coll_base_allreduce.c:291-294). reduce's in_order_binary is absent on
# purpose: its combine order is rank order.
REORDERING = frozenset({
    "ring", "ring_segmented", "hier", "recursive_doubling",
    "rabenseifner", "rabenseifner_root", "knomial",
    "recursive_halving", "butterfly",
})

# (collective, algorithm) pairs exempt from the REORDERING demotion:
# scan's recursive doubling folds the contiguous left range in front of
# the local value.
ORDER_PRESERVING = frozenset({("scan", "recursive_doubling")})

# (collective, algorithm) pairs exempt from the POW2_ONLY demotion:
# scan's recursive doubling runs partial rounds over range(n - d).
POW2_EXEMPT = frozenset({("scan", "recursive_doubling")})

# Algorithms only defined for power-of-two communicator sizes.
POW2_ONLY = frozenset({"recursive_doubling", "recursive_halving"})

# Algorithms only defined for even communicator sizes.
EVEN_ONLY = frozenset({"neighborexchange"})


def platform_key(device) -> str:
    """The reference's platform name for a torch device: ``"cpu"`` for
    the CPU, ``"gpu"`` (JAX's name for NVIDIA devices) for CUDA."""
    kind = torch.device(device).type
    return "gpu" if kind == "cuda" else kind


def _match(rules: List[Sequence], comm_size: int, nbytes: int) -> str:
    alg = "direct"
    for rule in rules:
        try:
            if comm_size >= rule[0] and nbytes >= rule[1]:
                alg = str(rule[2])
        except (IndexError, TypeError):
            continue                  # malformed user rule: skip it
    return alg


_SYMMETRIC_FALLBACK = {"reduce": "alias", "gather": "allgather",
                       "scatter": "direct"}


def effective_rules(func: str, multihost: bool = False,
                    dynamic: Dict[str, Dict] | None = None,
                    platform: str = "") -> List[Sequence]:
    """The rule list :func:`decide` scans for ``func`` after every
    override source (dynamic file, multihost structure, measured platform
    rows): the one source ``decide`` and ``decision_table`` both read."""
    rules = None
    if dynamic:
        rules = dynamic.get(func, {}).get("algorithm_rules")
    if rules:
        return rules
    if multihost and func in ("allreduce", "bcast", "allgather",
                              "reduce_scatter_block", "barrier"):
        return [[0, 0, "hier"]]
    if func in _SYMMETRIC_FALLBACK:
        if multihost:
            return [[0, 0, _SYMMETRIC_FALLBACK[func]]]
        if platform == "cpu":
            # measured on the JAX package's 8-rank host mesh: the
            # log-round root-targeted schedules lose to one symmetric op
            # at every size there
            return [[0, 0, _SYMMETRIC_FALLBACK[func]]]
    if platform == "cpu" and func == "allreduce":
        # measured there too: rabenseifner <= direct from 1 MB up
        return [[0, 0, "direct"], [0, 1 << 20, "rabenseifner"]]
    rules = FIXED_RULES.get(func)
    if not rules:
        return [[0, 0, "direct"]]
    return rules


def decide(func: str, comm_size: int, nbytes: int, multihost: bool,
           dynamic: Dict[str, Dict] | None = None,
           platform: str = "") -> str:
    """Pick an algorithm for ``func`` on a ``comm_size``-rank comm moving
    ``nbytes`` per rank. A ``{func: {"algorithm_rules": [...]}}`` entry
    of the dynamic-rules dict replaces the fixed rows wholesale."""
    return _match(effective_rules(func, multihost, dynamic, platform),
                  comm_size, nbytes)


# -- compression gating (compress/, coll/compressed) -------------------------
# Only these collectives have a compressed schedule, and only these dtypes
# quantize meaningfully (integer payloads would need a lossless codec; f16
# is already half width).
COMPRESSIBLE = frozenset({"allreduce", "allgather",
                          "reduce_scatter_block"})
COMPRESS_DTYPES = frozenset({"float32", "float64", "bfloat16"})


def dtype_name(dt) -> str:
    """The numpy-style name of a torch or numpy dtype: ``str`` of a torch
    dtype is ``"torch.float32"``, which no gate row would match."""
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return str(getattr(dt, "name", dt))


def compress_eligible(func: str, nbytes: int, dtype, op=None) -> bool:
    """True when the (func, per-rank payload, dtype, op) tuple takes the
    compressed path: the MCA var is on, the payload is a large eligible
    float, and the reduction (if any) is a sum — every other op keeps the
    uncompressed path (dequantized partial maxima or products would change
    the documented error model)."""
    from ompi_tpu_torch import compress
    if not compress.enabled():
        return False
    if func not in COMPRESSIBLE:
        return False
    if dtype_name(dtype) not in COMPRESS_DTYPES:
        return False
    if nbytes < compress.min_bytes():
        return False
    if op is not None and func != "allgather" \
            and getattr(op, "xla_prim", None) != "sum":
        return False
    return True


def compression_rules() -> Dict[str, List[Sequence]]:
    """The compression rows (after MCA overrides) in the fixed tables'
    ``[min_comm_size, min_bytes, algorithm]`` shape; empty while
    ``mpi_base_compress`` is off."""
    from ompi_tpu_torch import compress
    if not compress.enabled():
        return {}
    alg = f"compressed:{compress.codec_name()}"
    return {func: [[0, compress.min_bytes(), alg]]
            for func in sorted(COMPRESSIBLE)}


# -- large-message pipeline gating (pml/pipeline) ----------------------------
# Host-tier collectives with a segment-pipelined schedule (core/rankcomm):
# the ring allreduce and the chain bcast, whose chunk hops ride the pml's
# pipelined rendezvous.
PIPELINED: Dict[str, str] = {"allreduce": "pipelined_ring",
                             "bcast": "pipelined_chain"}


def pipeline_rules() -> Dict[str, List[Sequence]]:
    """The segment-pipeline rows in the fixed tables' shape; empty when
    ``mpi_base_pipeline_enable`` is off. Two ranks at least: a one-rank
    ring is a copy."""
    from ompi_tpu_torch.pml import pipeline as _pl
    if not _pl.enabled():
        return {}
    mb = _pl.min_bytes()
    return {func: [[2, mb, alg]] for func, alg in sorted(PIPELINED.items())}


def pipeline_plan(nbytes: int, rails: int = 1,
                  rail_gbps: "float | None" = None) -> Dict[str, int]:
    """Segment size and rail count of one ``nbytes`` pipelined transfer:
    segments sized to carry about 2 ms of wire time at the probed per-rail
    bandwidth (the bml probe's tcp estimate, ``probe_basis['rail_gbps']``),
    clamped to [256 KiB, 8 MiB], grown toward ``pipeline_depth`` segments
    per train (up to the ceiling) and never fewer than about 4 segments.
    The floor on the count is there because the window must fill before
    anything overlaps; the growth because each segment costs a fixed slice
    of host time (header, syscall, rail-thread wake)."""
    seg = 1 << 20
    if rail_gbps:
        seg = int(float(rail_gbps) * 1e9 * 0.002)
    seg = max(256 << 10, min(8 << 20, seg))
    from ompi_tpu_torch.pml import pipeline as _pl
    seg = max(seg, min(8 << 20, int(nbytes) // max(1, _pl.depth())))
    seg = min(seg, max(64 << 10, int(nbytes) // 4))
    return {"segment_bytes": int(seg), "rails": max(1, int(rails))}


# -- zero-copy shared-segment fold gating (btl/shmseg) ------------------------
# Node-local collectives with an in-segment schedule (core/rankcomm): every
# member's contribution is folded in place in shared memory.
SHM_FOLDS: Dict[str, str] = {"allreduce": "shm_fold"}


def shm_rules() -> Dict[str, List[Sequence]]:
    """The in-segment fold rows in the fixed tables' shape; empty when
    ``mpi_base_shm_zerocopy`` is off. Two ranks at least."""
    from ompi_tpu_torch.btl import shmseg as _shm
    if not _shm.enabled():
        return {}
    mb = _shm.min_bytes()
    return {func: [[2, mb, alg]] for func, alg in sorted(SHM_FOLDS.items())}


def persistent_rules() -> Dict[str, List[Sequence]]:
    """The pre-bound persistent-plan rows (MPI-4 ``*_init``), keyed
    ``<func>_init``: always present."""
    from ompi_tpu_torch.coll import persistent as _p
    return {f"{func}_init": [[0, 0, "persistent_prebound"]]
            for func in _p.PERSISTENT_FUNCS}


def bucket_rules() -> Dict[str, List[Sequence]]:
    """Bucket-fusion rows; empty when ``mpi_base_bucket`` is off. The
    bytes threshold is a ceiling, so it rides in the algorithm label."""
    from ompi_tpu_torch.coll import persistent as _p
    if not _p.bucket_enabled():
        return {}
    b = _p.bucket_bytes()
    return {func: [[0, 0, f"bucket_fuse:<={b}B"]]
            for func in sorted(_p.FUSED_FUNCS)}


def decision_table(comm_size: int = 0, multihost: bool = False,
                   dynamic: Dict[str, Dict] | None = None,
                   platform: str = "") -> Dict[str, List[Sequence]]:
    """The effective selection table after every override source: the
    per-func pins (``coll_torch_<func>_algorithm``), the dynamic-rules
    file, the multihost and platform rows, the compression rows, the
    bucket rows, the pipeline and shared-segment rows and the persistent
    rows."""
    from ompi_tpu_torch.mca import var as _var
    table: Dict[str, List[Sequence]] = {}
    for func in sorted(set(FIXED_RULES) | {"scan"}):
        pinned = _var.var_get(f"coll_torch_{func}_algorithm", "auto")
        if pinned not in (None, "auto"):
            table[func] = [[0, 0, str(pinned)]]
        else:
            table[func] = [list(r) for r in effective_rules(
                func, multihost, dynamic, platform)]
    for func, rows in compression_rules().items():
        table[func] = table[func] + [list(r) for r in rows]
    for func, rows in bucket_rules().items():
        table[func] = table[func] + [list(r) for r in rows]
    for func, rows in pipeline_rules().items():
        table[func] = table[func] + [list(r) for r in rows]
    for func, rows in shm_rules().items():
        table[func] = table[func] + [list(r) for r in rows]
    for func, rows in persistent_rules().items():
        table[func] = [list(r) for r in rows]
    return table
