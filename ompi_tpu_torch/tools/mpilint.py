"""CLI shim: ``python -m ompi_tpu_torch.tools.mpilint`` — the documented
entry point for the port's static analyzer (the port of
``ompi_tpu/tools/mpilint.py``). The engine (rule
catalog, baseline handling, MCAVARS generation) lives in
:mod:`ompi_tpu_torch.analyze.mpilint`; this wrapper exists so the tools/
namespace stays the single CLI surface (tracedump, checkparity,
mpisync precedent) and ``-m`` runs don't shadow the analyze package
module in ``sys.modules``.
"""
from __future__ import annotations

import sys

from ompi_tpu_torch.analyze.mpilint import main

if __name__ == "__main__":
    sys.exit(main())
