"""ompi_tpu_torch.analyze — the port's static analysis and runtime
concurrency witness (the port of ``ompi_tpu/analyze/``).

Two halves:

- :mod:`ompi_tpu_torch.analyze.mpilint` — an AST-based static pass over
  the whole ``ompi_tpu_torch/`` tree with project-specific rules
  (MCA-var and pvar discipline, the completion-closure bug class,
  blocking calls under hot-path locks, span and histogram balance). Run
  it with ``python -m ompi_tpu_torch.tools.mpilint``; tier-1 enforces
  zero non-baselined findings (tests/test_torch_lint_clean.py).
- :mod:`ompi_tpu_torch.analyze.lockwitness` — a runtime lock-order
  witness behind the MCA var ``mpi_base_lockwitness``: per-thread
  held-lock vectors, the global acquisition-order graph, cycle
  (potential deadlock) reports with both stacks, and hold-time
  watermarks. Off = zero overhead (``threading.Lock`` is untouched).

Intentional violations live in ``analyze/baseline.json`` — one entry
per suppression, each with a one-line justification. The generated
MCA-var index is ``analyze/MCAVARS.md``.
"""
from ompi_tpu_torch.analyze.mpilint import (  # noqa: F401
    RULES, Finding, default_baseline_path, load_baseline, render_mcavars,
    run_lint,
)
