"""Checkpoint / resume — application-level checkpointing (the port of
``ompi_tpu/io/checkpoint.py``).

The reference dropped transparent (BLCR) checkpointing after v1.6; its
modern story is application-level checkpointing + ULFM recovery
(``docs/tuning-apps/fault-tolerance/checkpoint-restart.rst:25-27``).
This module saves and restores communicator-distributed state (stacked
tensors, nested dicts/lists/tuples of tensors and arrays) atomically,
so a job revoked and shrunk through ULFM can resume.

On-disk layout, the reference's: ``leaves.npz`` (leaf ``i`` under
``l<i>``) beside ``meta.json`` (leaf count, step, structure), published
crash-safely through ``<path>.old``. The structure is flattened by plain
recursion: dict keys in sorted order, list and tuple items in order,
``None`` an empty node, anything else a leaf. A tensor comes to the host
with one copy per leaf. numpy has no bfloat16, so a bf16 leaf is saved
as its 16-bit pattern (``view(torch.int16)``) with ``bfloat16`` as its
dtype in ``meta.json``, and restored as a bf16 tensor bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, List, Optional

import numpy as np
import torch

from ompi_tpu_torch.core.errhandler import ERR_ARG, MPIError


def _flatten(tree: Any, leaves: List[Any]) -> Any:
    """Append ``tree``'s leaves to ``leaves``; return its structure as
    JSON (``{"dict": [sorted keys], "c": [...], "order": [keys]}``,
    ``{"list"|"tuple": [...]}``, ``None`` or a leaf's index). Leaves go
    in sorted-key order; ``order`` keeps the dict's own key order for the
    rebuild."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return {"dict": keys, "c": [_flatten(tree[k], leaves)
                                    for k in keys], "order": list(tree)}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_flatten(x, leaves) for x in tree]}
    if tree is None:
        return None
    leaves.append(tree)
    return len(leaves) - 1


def _unflatten(struct: Any, leaves: List[Any]) -> Any:
    if isinstance(struct, dict):
        if "dict" in struct:
            got = {k: _unflatten(c, leaves)
                   for k, c in zip(struct["dict"], struct["c"])}
            return {k: got[k] for k in struct["order"]}
        if "list" in struct:
            return [_unflatten(c, leaves) for c in struct["list"]]
        return tuple(_unflatten(c, leaves) for c in struct["tuple"])
    if struct is None:
        return None
    return leaves[struct]


def _to_saved(x: Any):
    """(host array, dtype name) of one leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy(), "bfloat16"
        a = t.cpu().numpy()
        return a, a.dtype.str
    a = np.asarray(x)
    return a, a.dtype.str


def save(path: str, state: Any, *, step: Optional[int] = None) -> None:
    """Atomically checkpoint ``state`` (nested dicts/lists/tuples of
    tensors and arrays — device tensors are fetched D2H) to directory
    ``path``."""
    leaves: List[Any] = []
    struct = _flatten(state, leaves)
    saved = [_to_saved(x) for x in leaves]
    tmp = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(path))
                           or ".")
    try:
        np.savez(os.path.join(tmp, "leaves.npz"),
                 **{f"l{i}": a for i, (a, _d) in enumerate(saved)})
        meta = {"n_leaves": len(leaves), "step": step, "tree": struct,
                "dtypes": [d for _a, d in saved]}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        # Crash-safe publish: the previous checkpoint is parked at
        # ``<path>.old`` until the new one is in place — at no instant
        # is there zero recoverable checkpoint on disk (restore() falls
        # back to .old).
        old = path + ".old"
        if os.path.isdir(old):
            shutil.rmtree(old)
        if os.path.isdir(path):
            os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _placed(a: np.ndarray, dtype: str, like: Any, comm):
    """One restored leaf. A leaf whose leading dim is ``comm.size`` goes
    to ``comm.device`` (the stacked re-placement); otherwise a tensor in
    ``like`` brings it back as a tensor on that tensor's device, and
    anything else as numpy. bf16 is always a tensor (numpy has none)."""
    stacked = (comm is not None and a.ndim >= 1
               and a.shape[0] == comm.size)
    if stacked:
        device = comm.device
    elif isinstance(like, torch.Tensor):
        device = like.device
    elif dtype == "bfloat16":
        device = torch.device("cpu")
    else:
        return a
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def restore(path: str, like: Any, *, comm=None) -> Any:
    """Restore a checkpoint into the structure of ``like``; stacked
    leaves are re-placed onto ``comm``'s device when given. Falls back to
    ``<path>.old`` if a crash interrupted the last save's publish."""
    if not os.path.isdir(path) and os.path.isdir(path + ".old"):
        path = path + ".old"
    likes: List[Any] = []
    struct = _flatten(like, likes)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta["n_leaves"] != len(likes):
        raise MPIError(ERR_ARG, f"checkpoint {path} holds "
                                f"{meta['n_leaves']} leaves, the structure "
                                f"to restore into {len(likes)}")
    with np.load(os.path.join(path, "leaves.npz")) as data:
        loaded = [_placed(data[f"l{i}"], meta["dtypes"][i], likes[i], comm)
                  for i in range(len(likes))]
    return _unflatten(struct, loaded)


def latest_step(path: str) -> Optional[int]:
    try:
        with open(os.path.join(path, "meta.json")) as f:
            return json.load(f).get("step")
    except (OSError, ValueError):
        return None
