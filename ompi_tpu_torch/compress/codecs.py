"""Block-scaled quantization codecs: the port of
``ompi_tpu/compress/codecs.py``.

A codec maps a float payload to (codes, scales): ``codes`` is the
1-byte-per-element wire form, ``scales`` one float32 per block of
``block`` elements (the block's max-abs over the code range), so
dequantization is one multiply. Two real codecs and the null codec:

- ``int8_block``: symmetric round-to-nearest int8; per-element error at
  most ``block_maxabs / 254``.
- ``fp8_block``: scale to 448, then cast to float8_e4m3fn (3 mantissa
  bits); per-element error at most ``block_maxabs / 16``, much smaller
  for small elements (logarithmic code spacing).
- ``null``: identity (codes are the payload), the fallback for unknown
  names and the schedules' A/B baseline.

Non-finite policy: a block holding any inf/nan gets a NaN scale, so the
whole block dequantizes to NaN (an overflow is never laundered into a
finite value).

Each codec has two halves, each with its reference's arithmetic:

- the host half (``encode``/``decode`` on numpy, the wire path) multiplies
  by the reciprocal of the scale, as the reference's does. Its fp8 cast
  goes through ``torch.float8_e4m3fn`` where the reference uses
  ``ml_dtypes``; so ``fp8_block`` is always registered.
- the device half (``torch_quant``/``torch_dequant``, composed into the
  ``coll/torch`` schedules by ``coll/compressed``) divides by the scale,
  as ``jnp_quant`` does, and runs on the tensor's own device with no host
  copy. ``torch.round`` rounds half to even, as ``jnp.rint`` does. Its
  scale is ``maximum(maxabs, 1e-30) * float32(1 / range)``: that is what
  ``jnp_quant``'s ``/ range`` becomes once XLA compiles it (it rewrites a
  division by a constant as a product with the constant's reciprocal),
  and the reference's schedules always run compiled. The ``_rows`` forms
  quantize each row of a ``(..., L)`` tensor on its own, padding each row
  to whole blocks, as ``jnp_quant`` pads each payload.

torch's f32 -> float8_e4m3fn cast saturates above 464 where ``ml_dtypes``
and XLA give NaN. A finite block never gets there (|x / scale| <= 448 up
to one rounding), so the codes differ only inside poisoned blocks, whose
dequantized values are NaN in both packages.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_BLOCK = 256

_INT8_RANGE = 127.0
_F8_RANGE = 448.0                        # e4m3fn max finite
# the float32 reciprocals the compiled reference multiplies by
_RECIP = {r: float(np.float32(1.0 / r)) for r in (_INT8_RANGE, _F8_RANGE)}


def _pad_blocks(flat: np.ndarray, block: int) -> Tuple[np.ndarray, int]:
    nb = -(-flat.size // block) if flat.size else 1
    pad = nb * block - flat.size
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, flat.dtype)])
    return flat.reshape(nb, block), pad


def _np_to_f8(a: np.ndarray) -> np.ndarray:
    """float32 numpy -> float8_e4m3fn bytes, as an int8 array."""
    a = np.ascontiguousarray(a, np.float32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(torch.float8_e4m3fn).view(torch.int8) \
        .numpy()


def _np_from_f8(codes: np.ndarray) -> np.ndarray:
    """int8 bytes of float8_e4m3fn codes -> float32 numpy."""
    c = np.ascontiguousarray(codes, np.int8)
    if not c.flags.writeable:
        c = c.copy()
    return torch.from_numpy(c).view(torch.float8_e4m3fn) \
        .to(torch.float32).numpy()


def _t_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """(..., L) -> (..., nb, block) float32, each row zero-padded to
    whole blocks (one block for an empty row, as the reference)."""
    lead, n = x.shape[:-1], x.shape[-1]
    nb = -(-n // block) if n else 1
    flat = x.to(torch.float32)
    if nb * block != n:
        flat = F.pad(flat, (0, nb * block - n))
    return flat.reshape(lead + (nb, block))


def _t_scales(blocks: torch.Tensor, code_range: float) -> torch.Tensor:
    """Per-block scale: max-abs over the code range, NaN for a block
    holding inf or nan (jnp.where(isfinite, maximum(m, 1e-30) / R, nan),
    as XLA compiles it)."""
    maxabs = blocks.abs().amax(-1)
    return torch.where(torch.isfinite(maxabs),
                       torch.clamp_min(maxabs, 1e-30) * _RECIP[code_range],
                       torch.full_like(maxabs, float("nan")))


def _t_unblock(blocks: torch.Tensor, total: int, dtype) -> torch.Tensor:
    out = blocks.reshape(blocks.shape[:-2] + (-1,))[..., :total]
    return out.to(dtype)


class Codec:
    """Base: name, wire cost model, numpy encode/decode, torch kernels."""

    name = "base"
    code_bytes = 1                       # wire bytes per element

    def wire_bytes(self, nelems: int, block: int) -> int:
        """Wire bytes for ``nelems`` payload elements (codes + scales)."""
        nb = -(-nelems // block) if nelems else 1
        return nelems * self.code_bytes + nb * 4

    # -- numpy (host / wire path) ------------------------------------------
    def encode(self, arr: np.ndarray, block: int = DEFAULT_BLOCK
               ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def decode(self, codes: np.ndarray, scales: np.ndarray,
               shape: Tuple[int, ...], dtype: Any,
               block: int = DEFAULT_BLOCK) -> np.ndarray:
        raise NotImplementedError

    # -- torch (device path) -----------------------------------------------
    def torch_quant_rows(self, x: torch.Tensor, block: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(..., L) -> codes (..., nb * block), scales (..., nb)."""
        raise NotImplementedError

    def torch_dequant_rows(self, codes: torch.Tensor, scales: torch.Tensor,
                           total: int, dtype, block: int) -> torch.Tensor:
        """codes (..., nb * block), scales (..., nb) -> (..., total)."""
        raise NotImplementedError

    def torch_quant(self, x: torch.Tensor, block: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The whole of ``x`` as one flat payload (``jnp_quant``)."""
        codes, scales = self.torch_quant_rows(x.reshape(1, -1), block)
        return codes[0], scales[0]

    def torch_dequant(self, codes: torch.Tensor, scales: torch.Tensor,
                      total: int, dtype, block: int) -> torch.Tensor:
        """``jnp_dequant``: the flat payload's first ``total`` elements."""
        return self.torch_dequant_rows(codes[None], scales[None], total,
                                       dtype, block)[0]

    def error_bound(self, block_maxabs):
        """Per-element absolute error bound given the block max-abs."""
        raise NotImplementedError


class NullCodec(Codec):
    """Identity codec: full-width wire, zero error. Exists so the
    compressed schedules can be run (and A/B'd) with the compression
    arithmetic taken out of the comparison."""

    name = "null"

    def wire_bytes(self, nelems: int, block: int) -> int:
        return nelems * 4                # payload travels full width

    def encode(self, arr, block=DEFAULT_BLOCK):
        flat = np.ascontiguousarray(arr).reshape(-1)
        return flat.copy(), np.ones(1, np.float32)

    def decode(self, codes, scales, shape, dtype, block=DEFAULT_BLOCK):
        return np.asarray(codes, dtype=dtype).reshape(shape)

    def torch_quant_rows(self, x, block):
        return x, torch.ones(x.shape[:-1] + (1,), dtype=torch.float32,
                             device=x.device)

    def torch_dequant_rows(self, codes, scales, total, dtype, block):
        return codes[..., :total].to(dtype)

    def error_bound(self, block_maxabs):
        return np.zeros_like(np.asarray(block_maxabs, np.float64))


class Int8BlockCodec(Codec):
    """Symmetric per-block int8: scale = maxabs/127, codes = rint(x/s)."""

    name = "int8_block"

    def encode(self, arr, block=DEFAULT_BLOCK):
        # one abs/max pass, one multiply by the reciprocal into a temp,
        # in-place rint, one int8 store (the reference's pass-lean path)
        flat = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
        blocks, _pad = _pad_blocks(flat, block)
        maxabs = np.abs(blocks).max(axis=1)
        scales = np.maximum(maxabs, 1e-30) * np.float32(1 / _INT8_RANGE)
        # non-finite blocks: scale -> NaN poisons the whole block on
        # decode; the sanitize pass runs only when some block held inf/nan
        finite = np.isfinite(maxabs)
        all_finite = bool(finite.all())
        if not all_finite:
            scales[~finite] = np.nan
        scales = scales.astype(np.float32, copy=False)
        with np.errstate(invalid="ignore", over="ignore"):
            tmp = blocks * (np.float32(1.0) / scales)[:, None]
            np.rint(tmp, out=tmp)
            if not all_finite:
                np.nan_to_num(tmp, copy=False, nan=0.0,
                              posinf=_INT8_RANGE, neginf=-_INT8_RANGE)
            codes = tmp.astype(np.int8)
        return codes.reshape(-1), scales

    def decode(self, codes, scales, shape, dtype, block=DEFAULT_BLOCK):
        scales = np.asarray(scales, np.float32)
        out = codes.astype(np.float32).reshape(len(scales), block)
        out *= scales[:, None]
        total = int(np.prod(shape)) if shape else 1
        out = out.reshape(-1)[:total].reshape(shape)
        return out.astype(dtype, copy=False)

    def torch_quant_rows(self, x, block):
        blocks = _t_blocks(x, block)
        scales = _t_scales(blocks, _INT8_RANGE)
        codes = torch.round(blocks / scales[..., None]).to(torch.int8)
        return codes.reshape(x.shape[:-1] + (-1,)), scales

    def torch_dequant_rows(self, codes, scales, total, dtype, block):
        blocks = codes.to(torch.float32).reshape(scales.shape + (block,))
        return _t_unblock(blocks * scales[..., None], total, dtype)

    def error_bound(self, block_maxabs):
        m = np.asarray(block_maxabs, np.float64)
        # rint is within 0.5 code; the 1e-30 floor keeps the all-zero
        # block exact
        return m / (2.0 * _INT8_RANGE) + 1e-30


class Fp8BlockCodec(Codec):
    """Per-block scale-to-448 + e4m3 cast: logarithmic code spacing."""

    name = "fp8_block"

    def encode(self, arr, block=DEFAULT_BLOCK):
        flat = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
        blocks, _pad = _pad_blocks(flat, block)
        maxabs = np.abs(blocks).max(axis=1)
        scales = np.maximum(maxabs, 1e-30) * np.float32(1 / _F8_RANGE)
        finite = np.isfinite(maxabs)
        all_finite = bool(finite.all())
        if not all_finite:
            scales[~finite] = np.nan
        scales = scales.astype(np.float32, copy=False)
        with np.errstate(invalid="ignore", over="ignore"):
            scaled = blocks * (np.float32(1.0) / scales)[:, None]
            if not all_finite:
                np.nan_to_num(scaled, copy=False, nan=0.0,
                              posinf=_F8_RANGE, neginf=-_F8_RANGE)
        # int8 view for the wire: raw bytes move whatever the receiver
        # knows about fp8
        return _np_to_f8(scaled).reshape(-1), scales

    def decode(self, codes, scales, shape, dtype, block=DEFAULT_BLOCK):
        scales = np.asarray(scales, np.float32)
        out = _np_from_f8(codes).reshape(len(scales), block)
        out *= scales[:, None]
        total = int(np.prod(shape)) if shape else 1
        out = out.reshape(-1)[:total].reshape(shape)
        return out.astype(dtype, copy=False)

    def torch_quant_rows(self, x, block):
        blocks = _t_blocks(x, block)
        scales = _t_scales(blocks, _F8_RANGE)
        codes = (blocks / scales[..., None]).to(torch.float8_e4m3fn)
        # int8 view, so every schedule moves a plain byte payload
        return codes.view(torch.int8).reshape(x.shape[:-1] + (-1,)), scales

    def torch_dequant_rows(self, codes, scales, total, dtype, block):
        f8 = codes.reshape(scales.shape + (block,)).view(torch.float8_e4m3fn)
        return _t_unblock(f8.to(torch.float32) * scales[..., None], total,
                          dtype)

    def error_bound(self, block_maxabs):
        # worst relative error 2^-4 lands on the largest element:
        # 448 * 2^-4 * scale = maxabs / 16 (plus the same zero floor)
        return np.asarray(block_maxabs, np.float64) / 16.0 + 1e-30


_REGISTRY: Dict[str, Codec] = {
    "null": NullCodec(),
    "int8_block": Int8BlockCodec(),
    "fp8_block": Fp8BlockCodec(),
}


def get_codec(name: str) -> Codec:
    """Codec by name; unknown names get the null codec (a mistyped MCA
    var must not corrupt data — it just stops compressing)."""
    return _REGISTRY.get(name, _REGISTRY["null"])


def codec_names():
    return sorted(_REGISTRY)
