"""Flash-attention block update — the fold the flagship's attention and
the ring schedule run, as a hand-written CUDA kernel.

The fold takes one K/V block into running flash accumulators (o, m, l)
without materializing the (Sq, Sk) score matrix in device memory. This
module owns:

- ``_fold_torch`` — the plain torch version, line for line the JAX
  package's ``_fold_jnp``: the CPU path, the autograd (training) path,
  and the oracle the kernel is held against.
- ``flash_block_update`` — the public entry. On CUDA tensors it launches
  the kernel in ``csrc/flash_fold.cu`` (the port of the TPU kernel
  ``_block_kernel``) or raises; on CPU tensors it runs ``_fold_torch``.
- ``launches`` — how many times the kernel was launched.

Mask ``mode``: 0 = attend fully (earlier ring block), 1 = causal diagonal
(the resident block), 2 = fully masked (later block). Masked scores are
``-1e30``, not ``-inf``, so a fully-masked fold on fresh accumulators
(``m = -1e30``) is NOT the identity: every column gets ``exp(0) = 1`` and
``l`` becomes ``Sk``. The JAX package's kernel and fold both behave so,
and its ring orders the diagonal block first; the port gives the same
result.
"""
from __future__ import annotations

import ctypes

import torch

from ompi_tpu_torch.ops import _build

_NEG = -1e30
_MAX_D = 128        # the kernel keeps a row of o in 4 registers per lane

launches = 0        # kernel launches, counted where the kernel launches


def _fold_torch(q, k, v, o, m, l, mode):
    """q: (BH, Sq, D) pre-scaled; k/v: (BH, Sk, D); o: (BH, Sq, D);
    m/l: (BH, Sq); mode: int."""
    s = torch.einsum("bqd,bkd->bqk", q, k)
    Sq, Sk = q.shape[1], k.shape[1]
    row = torch.arange(Sq, device=q.device)[:, None]
    col = torch.arange(Sk, device=q.device)[None, :]
    allow = (row >= col if mode == 1 else
             torch.full((Sq, Sk), mode == 0, device=q.device))
    s = torch.where(allow[None], s, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum("bqk,bkd->bqd", p, v)
    return o_new, m_new, l_new


def _kernel() -> ctypes.CDLL:
    lib = _build.load("flash_fold")
    fn = lib.flash_fold_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, o, m, l, mode) -> None:
    """What the kernel takes; raises on anything else."""
    dev = q.device
    for name, t in zip("qkvoml", (q, k, v, o, m, l)):
        if not (isinstance(t, torch.Tensor) and t.is_cuda and t.device == dev):
            raise ValueError(f"flash_block_update: {name} must be a CUDA "
                             f"tensor on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"flash_block_update: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_block_update: {name} must be "
                             f"contiguous")
    if q.ndim != 3:
        raise ValueError(f"flash_block_update: q must be (BH, Sq, D), got "
                         f"{tuple(q.shape)}")
    BH, Sq, D = q.shape
    Sk = k.shape[1] if k.ndim == 3 else -1
    want = {"k": (BH, Sk, D), "v": (BH, Sk, D), "o": (BH, Sq, D),
            "m": (BH, Sq), "l": (BH, Sq)}
    for name, t in (("k", k), ("v", v), ("o", o), ("m", m), ("l", l)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"flash_block_update: {name} must be "
                             f"{want[name]}, got {tuple(t.shape)}")
    if not (0 < D <= _MAX_D and Sq > 0 and Sk > 0):
        raise ValueError(f"flash_block_update: the kernel takes "
                         f"0 < D <= {_MAX_D} and non-empty Sq, Sk; got "
                         f"D={D}, Sq={Sq}, Sk={Sk}")
    if mode not in (0, 1, 2):
        raise ValueError(f"flash_block_update: mode must be 0, 1 or 2, "
                         f"got {mode!r}")


def _launch(q, k, v, o, m, l, mode):
    global launches
    mode = int(mode)
    _check(q, k, v, o, m, l, mode)
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    lib = _kernel()
    o_out = torch.empty_like(o)
    m_out = torch.empty_like(m)
    l_out = torch.empty_like(l)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_fold_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), o_out.data_ptr(), m_out.data_ptr(),
            l_out.data_ptr(), BH, Sq, Sk, D, mode, stream)
    if rc != 0:
        raise RuntimeError(f"flash_fold kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return o_out, m_out, l_out


def flash_block_update(q, k, v, o, m, l, mode):
    """Fold one K/V block into the flash accumulators.

    Args (all float32, q pre-scaled):
      q: (BH, Sq, D); k, v: (BH, Sk, D); o: (BH, Sq, D); m, l: (BH, Sq)
      mode: 0 full, 1 causal diagonal, 2 fully masked
    Returns (o, m, l) updated, as new tensors. CPU tensors take the plain
    fold; CUDA tensors take the kernel (which raises on what it does not
    take — there is no fallback)."""
    if all(t.device.type == "cpu" for t in (q, k, v, o, m, l)):
        return _fold_torch(q, k, v, o, m, l, mode)
    return _launch(q, k, v, o, m, l, mode)
