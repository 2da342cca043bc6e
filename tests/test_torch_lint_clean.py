"""Tier-1 enforcement of the port's static contracts, and the port's
checkparity against the reference's.

The checks of ``tests/test_lint_clean.py`` for the port's tree: the
port's mpilint is clean over ``ompi_tpu_torch/`` (zero non-baselined
findings, zero stale baseline entries), every baseline entry carries a
reason, the committed ``ompi_tpu_torch/analyze/MCAVARS.md`` is fresh, and
the port's ``tools/checkall`` gate agrees. Then the mirrors of
``tests/test_compress_tools.py`` (5), ``tests/test_ft.py::
test_ft_checkparity_recovery_rule`` and ``tests/test_osc_framework.py::
test_osc_checkparity_rule7_covers_ops``: each runs the reference's
checkparity over the reference's tree and the port's over the port's
tests, on the same synthetic trees where the reference builds one. The
port's audit has no slow-marker rule (its per-rank jobs run unmarked in
tier-1), so a synthetic tree the reference rejects for an unmarked
subprocess test is accepted by the port's when its pairs are present.
"""
import json
import os
import textwrap

import pytest

from ompi_tpu.tools import checkparity as r_checkparity
from ompi_tpu_torch.analyze import mpilint
from ompi_tpu_torch.mca import var as _var
from ompi_tpu_torch.tools import checkall, checkparity

_TESTS = os.path.dirname(os.path.abspath(__file__))
PAIRS = ("allreduce", "allgather", "reduce_scatter_block")


def test_lint_clean_tree():
    rep = mpilint.run_lint()
    assert len(rep["rules"]) >= 5
    assert rep["files"] > 50            # the whole package, not a stub
    assert rep["root"].endswith("ompi_tpu_torch")
    assert not rep["findings"], \
        "non-baselined mpilint findings:\n" + "\n".join(
            f"{f['path']}:{f['line']}: [{f['rule']}] {f['message']} "
            f"(key: {f['key']})" for f in rep["findings"])
    assert not rep["stale_baseline"], \
        f"stale baseline entries (delete them): {rep['stale_baseline']}"
    assert rep["ok"]


def test_baseline_entries_all_justified():
    with open(mpilint.default_baseline_path(), encoding="utf-8") as f:
        data = json.load(f)
    assert data["suppressions"], "baseline exists but is empty?"
    for ent in data["suppressions"]:
        assert ent.get("why", "").strip(), \
            f"baseline entry without a reason: {ent}"
        assert ent["key"].split(":", 1)[0] in mpilint.RULES, ent


def test_mcavars_doc_fresh():
    res = checkall.mcavars_fresh()
    assert res["path"].endswith(os.path.join("ompi_tpu_torch", "analyze",
                                             "MCAVARS.md"))
    assert res["ok"], res["hint"]


def test_checkall_gate():
    rep = checkall.run_all()
    assert rep["checkparity"]["ok"], rep["checkparity"]
    assert rep["mpilint"]["ok"], rep["mpilint"]["findings"]
    assert rep["mcavars"]["ok"], rep["mcavars"]["hint"]
    assert rep["ok"]


def test_var_registry_indexes_known_vars():
    """The static registry sees the vars the running process registers."""
    reg = mpilint.run_lint(rules=["mca_var"])["var_registry"]
    for name in ("mpi_base_per_rank", "mpi_base_ft_inject_kill",
                 "mpi_base_lockwitness", "mpi_base_trace_enable",
                 "hook_comm_method_display",
                 "coll_torch_allreduce_algorithm"):
        assert name in reg, name
    _var.var_register("mpi", "base", "lint_probe", vtype="int",
                      default=1, help="registry-symmetry probe")
    assert "mpi_base_lint_probe" in _var.var_names()
    entry = [v for v in _var.var_list()
             if v["name"] == "mpi_base_lint_probe"][0]
    assert entry["site"].startswith("test_torch_lint_clean.py:")


# -- checkparity (mirror of tests/test_compress_tools.py) ------------------
def test_checkparity_audit_passes_on_this_tree():
    ref = r_checkparity.audit(_TESTS)
    port = checkparity.audit(_TESTS)
    assert ref["ok"], ref
    assert port["ok"], port
    for key in ("wrapped_funcs", "persistent_funcs", "fused_funcs",
                "pipelined_funcs", "shm_fold_funcs", "fault_classes",
                "osc_ops", "lint_rules"):
        assert port[key] == ref[key], key
    assert set(port["wrapped_funcs"]) == set(PAIRS)
    assert "unmarked_slow" not in port


def _pair_tests(funcs):
    return "".join(f"def test_compressed_{f}_matches_uncompressed():\n"
                   f"    pass\n\n" for f in funcs)


def test_checkparity_detects_missing_pair_and_unmarked_slow(tmp_path):
    body = "import subprocess\n\n" + _pair_tests(["allreduce"]) + \
        "def test_spawns_without_marker():\n" \
        "    subprocess.run(['true'])\n"
    (tmp_path / "test_compress_x.py").write_text(body)
    (tmp_path / "test_torch_compress_x.py").write_text(body)
    ref = r_checkparity.audit(str(tmp_path))
    port = checkparity.audit(str(tmp_path))
    for rep in (ref, port):
        assert not rep["ok"]
        for f in PAIRS[1:]:
            assert f"test_compressed_{f}_matches_uncompressed" \
                in rep["missing_parity"]
    assert ref["unmarked_slow"] == \
        ["test_compress_x.py::test_spawns_without_marker"]
    assert "unmarked_slow" not in port


def test_checkparity_accepts_slow_marks(tmp_path):
    body = "import subprocess\nimport pytest\n\n" + _pair_tests(PAIRS) + \
        "@pytest.mark.slow\ndef test_spawns_marked():\n" \
        "    subprocess.run(['true'])\n"
    (tmp_path / "test_compress_ok.py").write_text(body)
    (tmp_path / "test_torch_compress_ok.py").write_text(body)
    for rep in (r_checkparity.audit(str(tmp_path)),
                checkparity.audit(str(tmp_path))):
        assert not rep["missing_parity"], rep
    assert not r_checkparity.audit(str(tmp_path))["unmarked_slow"]


def test_checkparity_module_pytestmark(tmp_path):
    """A module-wide slow mark satisfies the reference; the port's audit
    only reads the pairs, and an unmarked subprocess test in a port file
    is no violation there."""
    marked = "import subprocess\nimport pytest\n\n" \
        "pytestmark = pytest.mark.slow\n\n" + _pair_tests(PAIRS)
    (tmp_path / "test_compress_mod.py").write_text(marked)
    (tmp_path / "test_torch_compress_mod.py").write_text(
        "import subprocess\n\n" + _pair_tests(PAIRS)
        + "def test_spawns():\n    subprocess.run(['true'])\n")
    ref = r_checkparity.audit(str(tmp_path))
    port = checkparity.audit(str(tmp_path))
    assert not ref["missing_parity"] and not ref["unmarked_slow"], ref
    assert not port["missing_parity"], port


def test_checkparity_cli(tmp_path, capsys):
    for tool in (r_checkparity, checkparity):
        rc = tool.main(["--tests", _TESTS])
        out = json.loads(capsys.readouterr().out)
        assert rc == 0 and out["ok"]
    (tmp_path / "test_compress_bad.py").write_text(
        "def test_nothing():\n    pass\n")
    (tmp_path / "test_torch_compress_bad.py").write_text(
        "def test_nothing():\n    pass\n")
    for tool in (r_checkparity, checkparity):
        rc = tool.main(["--tests", str(tmp_path)])
        out = json.loads(capsys.readouterr().out)
        assert rc == 1 and out["missing_parity"]


def test_port_audit_reads_only_port_tests(tmp_path):
    """Pairs named in a reference test file do not satisfy the port's
    audit, and the lint fixture pairs come from ``LINT_FIXTURES``."""
    (tmp_path / "test_compress_x.py").write_text(_pair_tests(PAIRS))
    port = checkparity.audit(str(tmp_path))
    assert sorted(port["missing_parity"]) == sorted(
        f"test_compressed_{f}_matches_uncompressed" for f in PAIRS)
    assert len(port["missing_lint_fixtures"]) == 2 * len(mpilint.RULES)
    (tmp_path / "test_torch_lint_fx.py").write_text(textwrap.dedent(f"""
        LINT_FIXTURES = {{{", ".join(
            f'"{k}_{r}.py": ""' for r in mpilint.RULES
            for k in ("bad", "good"))}}}
        """))
    assert checkparity.audit(str(tmp_path))["missing_lint_fixtures"] == []


# -- the ft and osc rules ---------------------------------------------------
@pytest.mark.parametrize("pkg", ["ompi_tpu", "ompi_tpu_torch"])
def test_ft_checkparity_recovery_rule(pkg):
    import importlib
    inject = importlib.import_module(f"{pkg}.ft.inject")
    tool = r_checkparity if pkg == "ompi_tpu" else checkparity
    rep = tool.audit()
    assert rep["fault_classes"] == list(inject.FAULT_CLASSES)
    assert rep["missing_ft_recovery"] == []        # every class paired
    assert rep.get("unmarked_slow", []) == []
    assert rep["ok"]


@pytest.mark.parametrize("pkg", ["ompi_tpu", "ompi_tpu_torch"])
def test_osc_checkparity_rule7_covers_ops(pkg):
    import importlib
    base = importlib.import_module(f"{pkg}.osc.base")
    tool = r_checkparity if pkg == "ompi_tpu" else checkparity
    report = tool.audit(_TESTS)
    assert report["osc_ops"] == list(base.OSC_OPS)
    assert report["missing_osc_parity"] == []
    assert not [t for t in report.get("unmarked_slow", [])
                if t.startswith("test_osc")]
