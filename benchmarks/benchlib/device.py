"""The card: the look for it, its name and power limit, and the table of
published peaks that shares are taken against."""
from __future__ import annotations

import subprocess
import sys
from typing import Dict, Optional

# Published peaks (NVIDIA's data sheet, SXM part). They assume the full
# 700 W power limit; every result prints the card's own limit beside it.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def require_cuda(chips: int) -> None:
    """Exit non-zero, printing no result, without enough CUDA cards:
    a measurement never falls back to the CPU."""
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("benchmark: no CUDA device is visible\n")
        sys.exit(3)
    if torch.cuda.device_count() < chips:
        sys.stderr.write(f"benchmark: the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} are visible\n")
        sys.exit(3)


def power_limit() -> str:
    """``nvidia-smi``'s power limit of card 0, or "unknown"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    line = out.stdout.strip().splitlines()
    return line[0].strip() if out.returncode == 0 and line else "unknown"


def peak(kind: str, what: str) -> Optional[float]:
    return PEAKS.get(kind, {}).get(what)
