"""GPT-2's parameter tensors (Hugging Face ``GPT2LMHeadModel``, in
``named_parameters()`` order), from a configuration's sizes. The output
head is tied to ``wte``, as published, so it adds no tensor. Conv1D
weights are stored (in, out)."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple


def shapes(cfg: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...]]]:
    d = int(cfg["n_embd"])
    inner = int(cfg.get("n_inner") or 4 * d)
    out: List[Tuple[str, Tuple[int, ...]]] = [
        ("transformer.wte.weight", (int(cfg["vocab_size"]), d)),
        ("transformer.wpe.weight", (int(cfg["n_positions"]), d)),
    ]
    for i in range(int(cfg["n_layer"])):
        h = f"transformer.h.{i}."
        out += [
            (h + "ln_1.weight", (d,)), (h + "ln_1.bias", (d,)),
            (h + "attn.c_attn.weight", (d, 3 * d)),
            (h + "attn.c_attn.bias", (3 * d,)),
            (h + "attn.c_proj.weight", (d, d)), (h + "attn.c_proj.bias", (d,)),
            (h + "ln_2.weight", (d,)), (h + "ln_2.bias", (d,)),
            (h + "mlp.c_fc.weight", (d, inner)),
            (h + "mlp.c_fc.bias", (inner,)),
            (h + "mlp.c_proj.weight", (inner, d)),
            (h + "mlp.c_proj.bias", (d,)),
        ]
    out += [("transformer.ln_f.weight", (d,)), ("transformer.ln_f.bias", (d,))]
    return out
