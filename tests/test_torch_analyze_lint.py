"""Mirror of ``tests/test_analyze_lint.py`` through both packages' mpilint.

The port's analyzer is rooted at ``ompi_tpu_torch/``; its fixture pairs
are new, modeled on the port's own code (the ctl flush window, the
``coll_torch_*`` vars, the request completion path), and live in
``LINT_FIXTURES`` below: the port's checkparity audits that every rule
has a ``bad_<rule>.py`` and a ``good_<rule>.py`` entry there, and a test
whose name carries ``lint_<rule>`` (the reference's fixture tree
``tests/fixtures/lint/`` stays the reference's). Every rule must fire on
its bad fixture and stay silent on its good one, in both packages' lint
engines, and both engines must report the same findings on the same
fixture tree — the port's fixtures and the reference's.
"""
import json
import os
import textwrap

import pytest

from ompi_tpu.analyze import mpilint as r_lint
from ompi_tpu_torch.analyze import mpilint as p_lint

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REF_FIXTURES = os.path.join(_REPO, "tests", "fixtures", "lint")
ENGINES = {"ompi_tpu": r_lint, "ompi_tpu_torch": p_lint}

LINT_FIXTURES = {
    "bad_mca_var.py": '''
        from ompi_tpu_torch.mca import var as _var


        def register():
            _var.var_register("coll", "torch", "fixture_segsize",
                              vtype="int", default=1 << 20, help="fixture")


        def read_typo():
            # typo: the registered name is coll_torch_fixture_segsize
            return _var.var_get("coll_torch_fixture_segsiez", 0)


        def read_dynamic(func):
            return _var.var_get(f"coll_torch_fixture_{func}", "auto")


        def register_dynamic(component):
            _var.var_register("coll", component, "fixture_dyn", default="")
        ''',
    "good_mca_var.py": '''
        from ompi_tpu_torch.mca import var as _var


        def register():
            _var.var_register("coll", "torch", "fixture_good_seg",
                              vtype="int", default=4, help="fixture")
            _var.var_register("coll", "torch", "fixture_good_seg",
                              vtype="int", default=4, help="fixture")


        def read():
            return _var.var_get("coll_torch_fixture_good_seg", 4)


        def read_passthrough(full_name):
            return _var.var_get(full_name, None)


        def not_an_mca_name():
            return _var.var_get("Not-A-Var", None)
        ''',
    "bad_pvar.py": '''
        from ompi_tpu_torch.mca import pvar as _pvar

        _seen = set()


        def install_racy():
            # unlocked membership check, then register: the SPC race
            if "fixture_ctl_frames" not in _seen:
                _pvar.pvar_register("fixture_ctl_frames", lambda: 0)


        def read_missing():
            return _pvar.pvar_read("fixture_never_registered_count")
        ''',
    "good_pvar.py": '''
        import threading

        from ompi_tpu_torch.mca import pvar as _pvar

        _lock = threading.Lock()
        _seen = set()
        ctl_stats = {"frames": 0, "batches": 0}


        def install_guarded():
            with _lock:
                if "fixture_good_flushes" not in _seen:
                    _pvar.pvar_register("fixture_good_flushes", lambda: 0)
                    _seen.add("fixture_good_flushes")


        def install_dict():
            _pvar.pvar_register_dict("fixture_ctl", ctl_stats)


        def read_all():
            return (_pvar.pvar_read("fixture_good_flushes"),
                    _pvar.pvar_read("fixture_ctl_batches"),
                    _pvar.pvar_read("spc_fixture_any"))
        ''',
    "bad_closure.py": '''
        class SlotRequestRegression:
            def __init__(self):
                self._release_cb = None

            def cancel(self):
                cb = self._release_cb
                if cb is not None:
                    cb()

            def _deliver(self, payload):
                self.payload = payload       # the callback survives

            def _fail(self, exc):
                self.exc = exc               # ... here too


        class Slotter:
            def arm(self, req):
                req._release_cb = lambda: self._release(req)

            def _release(self, req):
                pass
        ''',
    "good_closure.py": '''
        class SlotRequestFixed:
            def __init__(self):
                self._release_cb = None

            def cancel(self):
                cb = self._release_cb
                if cb is not None:
                    cb()

            def _deliver(self, payload):
                self.payload = payload
                self._release_cb = None

            def _fail(self, exc):
                self.exc = exc
                self._release_cb = None


        class SlotterFixed:
            def arm(self, req):
                req._release_cb = lambda: self._release(req)

            def _release(self, req):
                pass
        ''',
    "bad_lock_blocking.py": '''
        import subprocess
        import threading
        import time

        _peer_lock = threading.Lock()


        def flush_window(sock, frames):
            with _peer_lock:
                time.sleep(0.001)
                sock.sendall(b"".join(frames))


        def read_reply(sock):
            with _peer_lock:
                return sock.recv(4096)


        def retire(sender_thread):
            with _peer_lock:
                subprocess.run(["true"])
                sender_thread.join()
        ''',
    "good_lock_blocking.py": '''
        import threading

        _peer_lock = threading.Lock()
        _queued = []


        def flush_window(sock):
            with _peer_lock:
                batch = b"".join(_queued)
                _queued.clear()
            sock.sendall(batch)


        def defer(sock):
            with _peer_lock:
                def later():
                    sock.sendall(b"x")
                _queued.append(later)


        def names(parts):
            with _peer_lock:
                return "/".join(parts)
        ''',
    "bad_span_balance.py": '''
        from ompi_tpu_torch import trace as _trace


        def unbalanced(send):
            tok = _trace.begin("btl_ctl_flush")
            send()
            _trace.end(tok)


        def dropped(send):
            _trace.begin("btl_ctl_flush")
            send()
        ''',
    "good_span_balance.py": '''
        from ompi_tpu_torch import trace as _trace


        def balanced(send):
            tok = _trace.begin("btl_ctl_flush") if _trace.active else None
            try:
                return send()
            finally:
                if tok is not None:
                    _trace.end(tok, sent=True)


        def scoped(send):
            with _trace.span("btl_ctl_flush"):
                return send()
        ''',
    "bad_histogram_balance.py": '''
        from ompi_tpu_torch import telemetry as _tele

        flush_hist = _tele.get_hist("fixture_flush_width")


        def unbalanced(send):
            tok = flush_hist.start()
            send()
            flush_hist.observe(tok)


        def dropped(send):
            flush_hist.start()
            send()
        ''',
    "good_histogram_balance.py": '''
        import threading

        from ompi_tpu_torch import telemetry as _tele

        flush_hist = _tele.get_hist("fixture_flush_width")


        def balanced(send):
            tok = flush_hist.start() if _tele.active else None
            try:
                return send()
            finally:
                flush_hist.observe(tok)


        def a_thread(send):
            t = threading.Thread(target=send)
            t.start()
            t.join()
        ''',
}


@pytest.fixture(scope="module")
def port_fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("lint_fixtures")
    for name, body in LINT_FIXTURES.items():
        (d / name).write_text(textwrap.dedent(body).lstrip())
    return str(d)


def _pair(root, rule):
    """Each engine's (bad findings, good findings) for one rule; the two
    engines must agree."""
    got = []
    for engine in (p_lint, r_lint):
        rep = engine.run_lint(root=root, baseline=None, rules=[rule],
                              all_hot=True)
        got.append(([f for f in rep["findings"]
                     if f["path"] == f"bad_{rule}.py"],
                    [f for f in rep["findings"]
                     if f["path"] == f"good_{rule}.py"]))
    assert got[0] == got[1]
    return got[0]


@pytest.fixture(params=["port_fixtures", "ref_fixtures"])
def fixtures(request, port_fixtures):
    return port_fixtures if request.param == "port_fixtures" \
        else _REF_FIXTURES


# -- per-rule fixture pairs (the port's checkparity rule 6) ----------------
def test_lint_mca_var_fixture_pair(fixtures):
    bad, good = _pair(fixtures, "mca_var")
    assert not good, good
    msgs = "\n".join(f["message"] for f in bad)
    assert "does not resolve" in msgs
    assert "dynamic (f-string)" in msgs
    assert "dynamic var_register" in msgs


def test_lint_pvar_fixture_pair(fixtures):
    bad, good = _pair(fixtures, "pvar")
    assert not good, good
    msgs = "\n".join(f["message"] for f in bad)
    assert "check-and-register race" in msgs
    assert "no matching" in msgs


def test_lint_closure_fixture_pair(fixtures):
    bad, good = _pair(fixtures, "closure")
    assert not good, good
    flagged = {f["key"] for f in bad}
    cls, attr = (("SlotRequestRegression", "_release_cb")
                 if fixtures != _REF_FIXTURES
                 else ("RankRequestRegression", "_cancel_fn"))
    assert f"closure:bad_closure.py:{cls}._deliver:{attr}" in flagged
    assert f"closure:bad_closure.py:{cls}._fail:{attr}" in flagged


def test_lint_lock_blocking_fixture_pair(fixtures):
    bad, good = _pair(fixtures, "lock_blocking")
    assert not good, good
    whats = "\n".join(f["message"] for f in bad)
    for what in ("time.sleep", ".sendall", ".recv", ".join (thread)",
                 "subprocess"):
        assert what in whats, what


def test_lint_span_balance_fixture_pair(fixtures):
    bad, good = _pair(fixtures, "span_balance")
    assert not good, good
    msgs = "\n".join(f["message"] for f in bad)
    assert "not ended in a finally" in msgs
    assert "discarded" in msgs


def test_lint_histogram_balance_fixture_pair(fixtures):
    bad, good = _pair(fixtures, "histogram_balance")
    assert not good, good
    assert len(bad) == 2, bad


@pytest.mark.parametrize("pkg", sorted(ENGINES))
def test_rule_catalog_shape(pkg):
    engine = ENGINES[pkg]
    assert len(engine.RULES) >= 6
    for fn in engine.RULES.values():
        assert (fn.__doc__ or "").strip()
    assert sorted(engine.RULES) == sorted(r_lint.RULES)


# -- seeded regressions of the real bug classes -----------------------------
@pytest.mark.parametrize("pkg", sorted(ENGINES))
def test_seeded_closure_regression_caught(tmp_path, pkg):
    (tmp_path / "perrank.py").write_text(textwrap.dedent("""\
        class RankRequest:
            def __init__(self):
                self._cancel_fn = None
            def cancel(self):
                fn = getattr(self, "_cancel_fn", None)
                if fn is not None:
                    fn()
            def _deliver(self, payload):
                self.payload = payload
            def _fail(self, exc):
                self.exc = exc

        class Poster:
            def post(self, req):
                req._cancel_fn = lambda: self._cancel_posted(req)
            def _cancel_posted(self, req):
                pass
        """))
    rep = ENGINES[pkg].run_lint(root=str(tmp_path), baseline=None,
                                rules=["closure"])
    keys = {f["key"] for f in rep["findings"]}
    assert "closure:perrank.py:RankRequest._deliver:_cancel_fn" in keys
    assert "closure:perrank.py:RankRequest._fail:_cancel_fn" in keys


@pytest.mark.parametrize("pkg", sorted(ENGINES))
def test_seeded_mca_var_typo_caught(tmp_path, pkg):
    (tmp_path / "mod.py").write_text(textwrap.dedent(f"""\
        from {pkg}.mca import var as _var

        def register():
            _var.var_register("mpi", "base", "ft_inject", vtype="bool",
                              default=False, help="x")

        def read():
            return _var.var_get("mpi_base_ft_injcet", False)  # typo
        """))
    rep = ENGINES[pkg].run_lint(root=str(tmp_path), baseline=None,
                                rules=["mca_var"])
    assert any(f["key"] == "mca_var:mod.py:mpi_base_ft_injcet"
               for f in rep["findings"]), rep["findings"]


# -- baseline round trip ----------------------------------------------------
@pytest.mark.parametrize("pkg", sorted(ENGINES))
def test_baseline_round_trip(tmp_path, port_fixtures, pkg):
    engine = ENGINES[pkg]
    raw = engine.run_lint(root=port_fixtures, baseline=None, all_hot=True)
    assert raw["findings"] and not raw["ok"]
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"suppressions": [
        {"key": f["key"], "why": "fixture: intentional"}
        for f in raw["findings"]]}))
    clean = engine.run_lint(root=port_fixtures, baseline=str(base),
                            all_hot=True)
    assert clean["ok"], clean["findings"]
    assert len(clean["suppressed"]) == len(raw["findings"])
    assert all(s["why"] == "fixture: intentional"
               for s in clean["suppressed"])
    data = json.loads(base.read_text())
    data["suppressions"].append({"key": "mca_var:gone.py:nothing",
                                 "why": "stale"})
    base.write_text(json.dumps(data))
    stale = engine.run_lint(root=port_fixtures, baseline=str(base),
                            all_hot=True)
    assert not stale["ok"]
    assert stale["stale_baseline"] == ["mca_var:gone.py:nothing"]


# -- CLI --------------------------------------------------------------------
@pytest.mark.parametrize("pkg", sorted(ENGINES))
def test_cli_exit_codes(tmp_path, capsys, port_fixtures, pkg):
    engine = ENGINES[pkg]
    assert engine.main(["--root", port_fixtures, "--baseline",
                        "none"]) == 1
    capsys.readouterr()
    (tmp_path / "ok.py").write_text("x = 1\n")
    assert engine.main(["--root", str(tmp_path)]) == 0
    capsys.readouterr()
    assert engine.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in engine.RULES:
        assert rule in out


@pytest.mark.parametrize("pkg", sorted(ENGINES))
def test_cli_json_format(capsys, port_fixtures, pkg):
    rc = ENGINES[pkg].main(["--root", port_fixtures, "--baseline", "none",
                            "--format", "json"])
    assert rc == 1
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] is False
    assert "var_registry" not in rep
    assert any(f["rule"] == "mca_var" for f in rep["findings"])


@pytest.mark.parametrize("pkg", sorted(ENGINES))
def test_cli_emit_mcavars(tmp_path, capsys, pkg):
    out = tmp_path / "MCAVARS.md"
    engine = ENGINES[pkg]
    assert engine.main(["--emit-mcavars", str(out)]) == 0
    text = out.read_text()
    assert text.startswith("# MCA variables")
    assert "`mpi_base_lockwitness`" in text
    assert "`mpi_base_ft_inject_kill`" in text
    if pkg == "ompi_tpu_torch":
        assert "`coll_torch_allreduce_algorithm`" in text
        assert "`hook_comm_method_display`" in text
        assert "OMPI_TPU_TORCH_MCA_" in text
    assert engine.main(["--emit-mcavars", "-"]) == 0
    assert capsys.readouterr().out == text


def test_port_engine_roots_at_the_port():
    rep = p_lint.run_lint()
    assert rep["root"] == os.path.join(_REPO, "ompi_tpu_torch")
    assert p_lint.default_baseline_path() == os.path.join(
        _REPO, "ompi_tpu_torch", "analyze", "baseline.json")
