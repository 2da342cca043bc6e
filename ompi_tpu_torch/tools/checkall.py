"""checkall — the port's single CI gate: checkparity + mpilint + MCA-var
index freshness in one run (the port of ``ompi_tpu/tools/checkall.py``).

``python -m ompi_tpu_torch.tools.checkall`` folds the three static
contracts of ``ompi_tpu_torch/`` into one exit status:

1. **checkparity**: parity-test pairs for the lossy, fused, pipelined,
   fault and one-sided paths, and a fixture pair per analyzer rule,
   in ``tests/test_torch_*.py``.
2. **mpilint**: zero non-baselined findings and zero stale baseline
   entries over the whole ``ompi_tpu_torch/`` tree
   (``analyze/baseline.json``).
3. **MCA-var index freshness**: the committed
   ``ompi_tpu_torch/analyze/MCAVARS.md`` matches what the tree's
   ``var_register`` sites generate (``docs/MCAVARS.md`` is the
   reference's).

Prints a JSON report; exit 1 on any violation. The same checks run
in-process in tier-1 (tests/test_torch_lint_clean.py).
"""
from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional

from ompi_tpu_torch.analyze import mpilint as _mpilint
from ompi_tpu_torch.tools import checkparity as _checkparity


def mcavars_fresh(doc_path: Optional[str] = None) -> Dict[str, Any]:
    """Is the committed analyze/MCAVARS.md what the tree generates?"""
    doc_path = doc_path or _mpilint.default_mcavars_path()
    want = _mpilint.render_mcavars()
    try:
        with open(doc_path, encoding="utf-8") as f:
            have = f.read()
    except OSError:
        have = ""
    return {"ok": have == want, "path": doc_path,
            "hint": ("" if have == want else
                     "regenerate: python -m ompi_tpu_torch.tools.mpilint "
                     "--emit-mcavars ompi_tpu_torch/analyze/MCAVARS.md")}


def run_all(tests_dir: Optional[str] = None) -> Dict[str, Any]:
    parity = _checkparity.audit(tests_dir)
    lint = _mpilint.run_lint()
    lint_slim = {k: v for k, v in lint.items() if k != "var_registry"}
    mcavars = mcavars_fresh()
    return {"ok": bool(parity["ok"] and lint["ok"] and mcavars["ok"]),
            "checkparity": parity,
            "mpilint": lint_slim,
            "mcavars": mcavars}


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m ompi_tpu_torch.tools.checkall",
        description="checkparity + mpilint + MCA-var index freshness "
                    "— the port's one-shot CI gate.")
    ap.add_argument("--tests", default=None,
                    help="tests directory (default: <repo>/tests)")
    args = ap.parse_args(argv)
    report = run_all(args.tests)
    print(json.dumps(report, indent=1))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
