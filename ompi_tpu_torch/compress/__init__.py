"""ompi_tpu_torch.compress — quantized and compressed collectives.

The port of ``ompi_tpu/compress``: block-scaled quantization codecs
(``codecs``, a numpy host half and a torch device half), the host wire
form (``wire``), an error-feedback accumulator (``feedback``) and the
byte/ratio/error pvars (``stats``). The ``coll/compressed`` component
composes the codecs into the ``coll/torch`` schedules.

Config (MCA vars, framework ``mpi``/``base``; environment prefix
``OMPI_TPU_TORCH_MCA_``):

- ``mpi_base_compress`` (bool, off): master switch. Off means every
  path is byte-identical to the uncompressed framework. A communicator
  selects its components when it is built, so turn it on, then ``dup()``.
- ``mpi_base_compress_codec``: ``int8_block`` (default), ``fp8_block``
  or ``null``.
- ``mpi_base_compress_min_bytes`` (default 4 MiB): per-rank payload
  floor below which compression never engages.
- ``mpi_base_compress_block`` (default 256): elements per scale block.
- ``mpi_base_compress_error_feedback`` (bool, off): opt keyed wire
  streams into the residual accumulator.
"""
from __future__ import annotations

from ompi_tpu_torch.mca import var as _var

from ompi_tpu_torch.compress import feedback, stats  # noqa: F401
from ompi_tpu_torch.compress.codecs import (Codec, DEFAULT_BLOCK,  # noqa: F401
                                            codec_names, get_codec)
from ompi_tpu_torch.compress.feedback import ErrorFeedback  # noqa: F401

DEFAULT_MIN_BYTES = 4 << 20


def _register_vars() -> None:
    _var.var_register(
        "mpi", "base", "compress", vtype="bool", default=False,
        help="Enable block-scaled quantized collectives for large "
             "f32/f64/bf16 sum reductions and gathers")
    _var.var_register(
        "mpi", "base", "compress_codec", vtype="str",
        default="int8_block",
        help="Compression codec: int8_block (symmetric int8, "
             "err <= block_max/254), fp8_block (e4m3, relative err "
             "<= 2^-4), or null (identity; schedule A/B baseline)")
    _var.var_register(
        "mpi", "base", "compress_min_bytes", vtype="int",
        default=DEFAULT_MIN_BYTES,
        help="Per-rank payload floor for compressed collectives; "
             "smaller payloads take the uncompressed path unchanged")
    _var.var_register(
        "mpi", "base", "compress_block", vtype="int", default=DEFAULT_BLOCK,
        help="Elements per quantization block (one float32 scale per "
             "block rides the wire next to the 1-byte codes)")
    _var.var_register(
        "mpi", "base", "compress_error_feedback", vtype="bool",
        default=False,
        help="Carry quantization residuals per wire stream and fold "
             "them into the next payload (iterative workloads)")


def _ensure() -> None:
    """Register the vars once (again after a reset of the var store): a
    registration walks the caller's frames, and the gates run per call."""
    if _var.var_get("mpi_base_compress") is None:
        _register_vars()


def enabled() -> bool:
    _ensure()
    return bool(_var.var_get("mpi_base_compress", False))


def codec_name() -> str:
    _ensure()
    return str(_var.var_get("mpi_base_compress_codec", "int8_block"))


def min_bytes() -> int:
    _ensure()
    return int(_var.var_get("mpi_base_compress_min_bytes",
                            DEFAULT_MIN_BYTES))


def block_elems() -> int:
    _ensure()
    return max(1, int(_var.var_get("mpi_base_compress_block",
                                   DEFAULT_BLOCK)))


def error_feedback() -> bool:
    _ensure()
    return bool(_var.var_get("mpi_base_compress_error_feedback", False))


def _reset_for_tests() -> None:
    """Zero the byte/error counters, empty the default error-feedback
    store and forget the wire's verification sampling."""
    from ompi_tpu_torch.compress import wire
    stats.reset()
    feedback.default.reset()
    wire._reset_for_tests()
