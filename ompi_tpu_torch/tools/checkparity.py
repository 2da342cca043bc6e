"""checkparity — CI audit for the port's collective test-parity contracts
(the port of ``ompi_tpu/tools/checkparity.py``).

It audits the port's own function lists against the port's tests, the
``tests/test_torch_*.py`` files:

1. **Compression parity**: every collective ``coll/compressed`` wraps
   (``WRAPPED_FUNCS``) has a ``test_compressed_<func>_matches_uncompressed``.
2. **Persistent/fused parity**: every pre-bound persistent plan
   (``coll/persistent.PERSISTENT_FUNCS``) has a
   ``test_persistent_<func>_matches_unfused``, and every bucket-fused
   collective (``FUSED_FUNCS``) a ``test_bucketed_<func>_matches_unfused``.
3. **Pipeline parity**: every segment-pipelined host-tier schedule
   (``coll/decision.PIPELINED``) has a
   ``test_pipelined_<func>_matches_unpipelined``.
3b. **Shm-fold parity**: every in-segment fold schedule
   (``coll/decision.SHM_FOLDS``) has a ``test_shmfold_<func>_matches_ring``.
4. **Fault-recovery parity**: every injectable fault class
   (``ft/inject.FAULT_CLASSES``) has a ``test_ft_<class>_recovers``.
7. **One-sided parity**: every osc op (``osc/base.OSC_OPS``) has a
   ``test_osc_<op>_matches_pt2pt``.
6. **Lint-rule fixture parity**: every rule of the port's analyzer
   (``analyze/mpilint.RULES``) has a fixture pair, the entries
   ``bad_<rule>.py`` (must fire it) and ``good_<rule>.py`` (must not) of
   a module-level ``LINT_FIXTURES`` dict in a port test file (the
   reference's ``tests/fixtures/lint/`` stays the reference's), plus a
   test whose name contains ``lint_<rule>``.

The reference's rule 5 (multi-process tests of some files carry the
``slow`` marker) is not carried over: the port's per-rank jobs run
unmarked in tier-1 by design, each under its own time limit.

Usage::

    python -m ompi_tpu_torch.tools.checkparity [--tests DIR]

Prints a JSON report; exit status 1 on any violation (the CI entry).
``tests/test_torch_lint_clean.py`` runs the audit in tier-1.
"""
from __future__ import annotations

import ast
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _test_functions(path: str):
    """Yield (name, node) for every test function in a file (module
    level and class level)."""
    try:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
    except (OSError, SyntaxError):
        return
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name.startswith("test"):
            yield node.name, node


def _lint_fixture_names(path: str) -> List[str]:
    """The string keys of a module-level ``LINT_FIXTURES`` dict."""
    try:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
    except (OSError, SyntaxError):
        return []
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == "LINT_FIXTURES"
                        for t in node.targets):
            return [k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)]
    return []


def audit(tests_dir: Optional[str] = None) -> Dict[str, Any]:
    tests_dir = tests_dir or os.path.join(_REPO, "tests")
    from ompi_tpu_torch.analyze.mpilint import RULES
    from ompi_tpu_torch.coll.compressed import WRAPPED_FUNCS
    from ompi_tpu_torch.coll.decision import PIPELINED, SHM_FOLDS
    from ompi_tpu_torch.coll.persistent import FUSED_FUNCS, PERSISTENT_FUNCS
    from ompi_tpu_torch.ft.inject import FAULT_CLASSES
    from ompi_tpu_torch.osc.base import OSC_OPS

    wanted = {f"test_compressed_{func}_matches_uncompressed": func
              for func in WRAPPED_FUNCS}
    wanted_pers = {f"test_persistent_{func}_matches_unfused": func
                   for func in PERSISTENT_FUNCS}
    wanted_pers.update({f"test_bucketed_{func}_matches_unfused": func
                        for func in FUSED_FUNCS})
    wanted_pipe = {f"test_pipelined_{func}_matches_unpipelined": func
                   for func in PIPELINED}
    wanted_shm = {f"test_shmfold_{func}_matches_ring": func
                  for func in SHM_FOLDS}
    wanted_ft = {f"test_ft_{cls}_recovers": cls
                 for cls in FAULT_CLASSES}
    wanted_osc = {f"test_osc_{op}_matches_pt2pt": op
                  for op in OSC_OPS}
    found: set = set()
    found_osc: set = set()
    found_pers: set = set()
    found_pipe: set = set()
    found_shm: set = set()
    found_ft: set = set()
    found_lint: set = set()
    fixtures: set = set()
    for path in sorted(glob.glob(os.path.join(tests_dir, "**",
                                              "test_torch_*.py"),
                                 recursive=True)):
        fixtures.update(_lint_fixture_names(path))
        for name, _node in _test_functions(path) or ():
            if name in wanted:
                found.add(name)
            if name in wanted_pers:
                found_pers.add(name)
            if name in wanted_pipe:
                found_pipe.add(name)
            if name in wanted_shm:
                found_shm.add(name)
            if name in wanted_ft:
                found_ft.add(name)
            if name in wanted_osc:
                found_osc.add(name)
            for rule in RULES:
                if f"lint_{rule}" in name:
                    found_lint.add(rule)
    missing_fixtures = [f"LINT_FIXTURES[{kind}_{rule}.py]"
                        for rule in sorted(RULES)
                        for kind in ("bad", "good")
                        if f"{kind}_{rule}.py" not in fixtures]
    missing = sorted(set(wanted) - found)
    missing_pers = sorted(set(wanted_pers) - found_pers)
    missing_pipe = sorted(set(wanted_pipe) - found_pipe)
    missing_shm = sorted(set(wanted_shm) - found_shm)
    missing_ft = sorted(set(wanted_ft) - found_ft)
    missing_osc = sorted(set(wanted_osc) - found_osc)
    missing_lint = sorted(f"test *lint_{r}* (fixture-pair test)"
                          for r in set(RULES) - found_lint)
    return {"ok": not missing and not missing_pers and not missing_pipe
            and not missing_shm and not missing_ft and not missing_osc
            and not missing_fixtures and not missing_lint,
            "wrapped_funcs": list(WRAPPED_FUNCS),
            "persistent_funcs": list(PERSISTENT_FUNCS),
            "fused_funcs": list(FUSED_FUNCS),
            "pipelined_funcs": sorted(PIPELINED),
            "shm_fold_funcs": sorted(SHM_FOLDS),
            "fault_classes": list(FAULT_CLASSES),
            "osc_ops": list(OSC_OPS),
            "lint_rules": sorted(RULES),
            "missing_parity": missing,
            "missing_persistent_parity": missing_pers,
            "missing_pipeline_parity": missing_pipe,
            "missing_shm_fold_parity": missing_shm,
            "missing_ft_recovery": missing_ft,
            "missing_osc_parity": missing_osc,
            "missing_lint_fixtures": missing_fixtures,
            "missing_lint_tests": missing_lint}


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m ompi_tpu_torch.tools.checkparity",
        description="Audit the port's parity-test pairs and lint "
                    "fixture pairs.")
    ap.add_argument("--tests", default=None,
                    help="tests directory (default: <repo>/tests)")
    args = ap.parse_args(argv)
    report = audit(args.tests)
    print(json.dumps(report, indent=1))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
