"""The port's composition components against the reference's: coll/han
(two-level sub-communicator composition) and coll/xhc (n-level ladder)
from ``tests/test_han_xhc.py``, coll/adapt (segmented event-driven
ibcast/ireduce) from ``tests/test_sync_adapt.py``, and coll/acoll (device
kind hints) from ``tests/test_acoll.py``.

Each case sets the same MCA vars on a dup of the port's 8-rank CPU world
and of the reference's 8-device world and feeds both the same seeded
inputs. The observations (what was selected, ladders, tiers, segment
counts, callbacks) must be identical; results are exact for data
movement and MAX/MIN, and rtol 1e-5 for float32 sums, which the
composition adds in another order than numpy or the other package. The
reference's vars are restored after each test.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch as P
from ompi_tpu.coll import acoll as r_acoll
from ompi_tpu.coll import adapt as r_adapt
from ompi_tpu.coll import han as r_han
from ompi_tpu.coll import xhc as r_xhc
from ompi_tpu.mca import var as r_var
from ompi_tpu.utils import locality as r_loc
from ompi_tpu_torch.coll import acoll as p_acoll
from ompi_tpu_torch.coll import adapt as p_adapt
from ompi_tpu_torch.coll import han as p_han
from ompi_tpu_torch.coll import xhc as p_xhc
from ompi_tpu_torch.mca import var as p_var
from ompi_tpu_torch.utils import locality as p_loc

N = 8
PORT = SimpleNamespace(name="port", MPI=P, var=p_var, han=p_han, xhc=p_xhc,
                       adapt=p_adapt, acoll=p_acoll, seg="coll_torch_segsize",
                       mod="ompi_tpu_torch.coll.acoll")
REF = SimpleNamespace(name="ref", MPI=ompi_tpu, var=r_var, han=r_han,
                      xhc=r_xhc, adapt=r_adapt, acoll=r_acoll,
                      seg="coll_xla_segsize", mod="ompi_tpu.coll.acoll")


@pytest.fixture()
def worlds(world):
    """Both worlds, and a setter that applies one MCA var to both (the
    reference's old values come back afterwards)."""
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    saved = {}

    def set_(name, value):
        saved.setdefault(name, r_var.var_get(name))
        r_var.var_set(name, value)
        p_var.var_set(name, value)

    r_han._reset_rules_for_tests()
    yield [(PORT, P.get_comm_world()), (REF, world)], set_
    for name, value in saved.items():
        r_var.var_set(name, value)
    r_han._reset_rules_for_tests()
    P._reset_for_tests()


def _host(y):
    return (y.cpu().numpy() if isinstance(y, torch.Tensor)
            else np.asarray(y))


def _pair(worlds, fn):
    """(port, ref) results of ``fn(pkg, comm)``."""
    (pp, pw), (rp, rw) = worlds
    return fn(pp, pw), fn(rp, rw)


def _same(worlds, fn):
    port, ref = _pair(worlds, fn)
    assert port == ref, (port, ref)
    return port


def _close(a, b, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=1e-6)


@pytest.fixture()
def han_worlds(worlds):
    """Dups with a synthetic 2-node hierarchy (low groups of 4) and han's
    priority above every data-plane component."""
    ws, set_ = worlds
    set_("coll_han_priority", 80)
    set_("coll_han_split", 4)
    return [(pkg, w.dup()) for pkg, w in ws]


def test_han_wins_with_hierarchy(han_worlds):
    assert _same(han_worlds, lambda pkg, c: (
        c._coll_winners["allreduce"],
        isinstance(c.c_coll["allreduce"], pkg.han.HanModule))) == \
        ("han", True)


def test_han_not_selected_without_hierarchy(worlds):
    ws, set_ = worlds
    set_("coll_han_priority", 80)
    set_("coll_han_split", 0)
    # one process (reference) / one device (port): no hierarchy
    assert _same(ws, lambda pkg, w: w.dup()._coll_winners["allreduce"]
                 != "han")


def test_han_allreduce(han_worlds, rng):
    x = rng.standard_normal((N, 300)).astype(np.float32)  # > 256 B: hier

    def run(pkg, c):
        out = _host(c.allreduce(c.stack(list(x)), pkg.MPI.SUM))
        m = c.c_coll["allreduce"]
        tiers = (len(m.h.low), m.h.up.size,
                 all(getattr(t, "_han_inner", False)
                     for t in m.h.low + [m.h.up]))
        return out, tiers
    (po, pt), (ro, rt) = _pair(han_worlds, run)
    assert pt == rt == (2, 2, True)
    for r in range(N):
        _close(po[r], x.sum(0))
    _close(po, ro)


def test_han_allreduce_max(han_worlds, rng):
    x = rng.standard_normal((N, 130)).astype(np.float32)
    po, ro = _pair(han_worlds, lambda pkg, c: _host(
        c.allreduce(c.stack(list(x)), pkg.MPI.MAX)))
    np.testing.assert_array_equal(po, ro)
    np.testing.assert_array_equal(po[0], x.max(0))


def test_han_bcast_reduce(han_worlds, rng):
    x = rng.standard_normal((N, 65)).astype(np.float32)

    def run(pkg, c):
        buf = c.stack(list(x))
        return (_host(c.bcast(buf, root=5)),
                _host(c.reduce(buf, pkg.MPI.SUM, root=6))[6])
    (pb, pr), (rb, rr) = _pair(han_worlds, run)
    np.testing.assert_array_equal(pb, rb)
    np.testing.assert_array_equal(pb, np.broadcast_to(x[5], pb.shape))
    _close(pr, rr)
    _close(pr, x.sum(0))


def test_han_allgather(han_worlds, rng):
    x = rng.standard_normal((N, 7)).astype(np.float32)
    po, ro = _pair(han_worlds, lambda pkg, c: _host(
        c.allgather(c.stack(list(x)))))
    np.testing.assert_array_equal(po, ro)
    for r in range(N):
        np.testing.assert_array_equal(po[r], x)


def test_han_barrier(han_worlds):
    def run(pkg, c):
        c.barrier()              # composes the low/up barriers
        m = c.c_coll["barrier"]
        return c._coll_winners["barrier"], m._strategy("barrier", 0)
    assert _same(han_worlds, run) == ("han", "hier")


def test_han_small_message_goes_flat(han_worlds, rng):
    """Default dynamic table: <= 256 B skips the hierarchy and delegates
    to the next component."""
    x = rng.standard_normal((N, 4)).astype(np.float32)   # 16 B

    def run(pkg, c):
        m = c.c_coll["allreduce"]
        return (m._strategy("allreduce", 16),
                _host(c.allreduce(c.stack(list(x)), pkg.MPI.SUM)))
    (ps, po), (rs, ro) = _pair(han_worlds, run)
    assert ps == rs == "flat"
    _close(po[0], x.sum(0))
    _close(po, ro)


def test_han_dynamic_rules_file(worlds, tmp_path, rng):
    ws, set_ = worlds
    rules = {"allreduce": [{"max_bytes": 10**9, "algorithm": "flat"}]}
    path = tmp_path / "han_rules.json"
    path.write_text(json.dumps(rules))
    set_("coll_han_priority", 80)
    set_("coll_han_split", 4)
    set_("coll_han_dynamic_rules", str(path))
    x = rng.standard_normal((N, 1000)).astype(np.float32)

    def run(pkg, w):
        pkg.han._reset_rules_for_tests()
        c = w.dup()
        m = c.c_coll["allreduce"]
        return (m._strategy("allreduce", 1 << 20),
                _host(c.allreduce(c.stack(list(x)), pkg.MPI.SUM)))
    (ps, po), (rs, ro) = _pair(ws, run)
    assert ps == rs == "flat"
    _close(po[0], x.sum(0))
    _close(po, ro)


# ---------------------------------------------------------------------
def test_build_levels():
    cases = [(8, [2, 2]), (4, [4]), (1, [2]), (12, [3, 2]), (7, [2])]
    for n, sizes in cases:
        assert p_xhc.build_levels(n, sizes) == r_xhc.build_levels(n, sizes)
    lv = p_xhc.build_levels(8, [2, 2])
    assert lv == [[[0, 1], [2, 3], [4, 5], [6, 7]], [[0, 2], [4, 6]],
                  [[0, 4]]]


@pytest.fixture()
def xhc_worlds(worlds):
    ws, set_ = worlds
    set_("coll_xhc_priority", 80)
    set_("coll_xhc_levels", "2,2")
    return [(pkg, w.dup()) for pkg, w in ws]


def test_xhc_wins_and_ladder(xhc_worlds):
    assert _same(xhc_worlds, lambda pkg, c: (
        c._coll_winners["allreduce"],
        isinstance(c.c_coll["allreduce"], pkg.xhc.XhcModule),
        c.c_coll["allreduce"].levels)) == (
        "xhc", True, [[[0, 1], [2, 3], [4, 5], [6, 7]], [[0, 2], [4, 6]],
                      [[0, 4]]])


def test_xhc_allreduce_ops(xhc_worlds, rng):
    x = rng.standard_normal((N, 50)).astype(np.float32)

    def run(pkg, c):
        buf = c.stack(list(x))
        return [_host(c.allreduce(buf, op))
                for op in (pkg.MPI.SUM, pkg.MPI.MAX, pkg.MPI.MIN)]
    (ps, pm, pn), (rs, rm, rn) = _pair(xhc_worlds, run)
    for r in range(N):
        _close(ps[r], x.sum(0))
    _close(ps, rs)
    np.testing.assert_array_equal(pm, rm)
    np.testing.assert_array_equal(pn, rn)
    np.testing.assert_array_equal(pm[0], x.max(0))
    np.testing.assert_array_equal(pn[0], x.min(0))


def test_xhc_bcast_reduce_barrier(xhc_worlds, rng):
    x = rng.standard_normal((N, 9)).astype(np.float32)

    def run(pkg, c):
        buf = c.stack(list(x))
        out = _host(c.bcast(buf, root=3))
        red = _host(c.reduce(buf, pkg.MPI.SUM, root=1))
        c.barrier()
        return out, red
    (pb, pr), (rb, rr) = _pair(xhc_worlds, run)
    np.testing.assert_array_equal(pb, rb)
    np.testing.assert_array_equal(pb[7], x[3])
    _close(pr[1], x.sum(0))
    _close(pr, rr)


def test_xhc_ladder_without_levels_var(worlds, rng):
    """With ``coll_xhc_levels`` unset on rows that all share one device
    (the CPU here), xhc still builds a >= 2-level ladder from the host
    topology or a labeled synthetic factorization, in both packages
    alike."""
    ws, set_ = worlds
    set_("coll_xhc_priority", 80)
    x = rng.standard_normal((N, 17)).astype(np.float32)

    def run(pkg, w):
        c = w.dup()
        m = c.c_coll["allreduce"]
        return ((c._coll_winners["allreduce"],
                 isinstance(m, pkg.xhc.XhcModule), m.levels,
                 getattr(m, "level_basis", "")),
                _host(c.allreduce(c.stack(list(x)), pkg.MPI.SUM)))
    (pobs, po), (robs, ro) = _pair(ws, run)
    assert pobs == robs
    assert pobs[0] == "xhc" and len(pobs[2]) >= 2
    assert pobs[3] in ("os-topology", "synthetic-mesh", "device-locality")
    _close(po[0], x.sum(0))
    _close(po, ro)


def test_ladder_sizes_provenance():
    for n in (2, 4, 6, 7, 8, 12, 16):
        assert p_loc.ladder_sizes(n) == r_loc.ladder_sizes(n), n
    sizes, basis = p_loc.ladder_sizes(8)
    assert sizes and basis in ("os-topology", "synthetic-mesh")
    assert p_loc.ladder_sizes(2)[0] is None
    assert p_loc.ladder_sizes(7)[0] is None
    assert p_loc._balanced_factor(12) == r_loc._balanced_factor(12) == 3
    assert p_loc.host_topology() == r_loc.host_topology()


# -- coll/adapt --------------------------------------------------------
def test_adapt_segmented_ibcast(worlds, rng):
    ws, _ = worlds
    x = rng.standard_normal((N, 30)).astype(np.float32)   # 4 segments

    def run(pkg, w):
        m = pkg.adapt.AdaptModule(w, 8)
        req = m.ibcast_adapt(w.stack(list(x)), root=2)
        return (isinstance(req, pkg.adapt.AdaptRequest),
                len(req._segments), _host(req.get()))
    (pk, pn, po), (rk, rn, ro) = _pair(ws, run)
    assert (pk, pn) == (rk, rn) == (True, 4)
    np.testing.assert_array_equal(po, ro)
    np.testing.assert_array_equal(po, np.broadcast_to(x[2], po.shape))


def test_adapt_segments_progress_independently(worlds, rng):
    ws, _ = worlds
    x = rng.standard_normal((N, 16)).astype(np.float32)

    def run(pkg, w):
        m = pkg.adapt.AdaptModule(w, 4)
        req = m.ireduce_adapt(w.stack(list(x)), pkg.MPI.SUM, 0)
        spins = 0
        while not req.test()[0]:
            spins += 1
            assert spins < 100_000
        return req.segments_done, _host(req.get())
    (pd, po), (rd, ro) = _pair(ws, run)
    assert pd == rd == 4
    _close(po[0], x.sum(0))
    _close(po, ro)


def test_adapt_completion_callback(worlds, rng):
    ws, _ = worlds
    x = rng.standard_normal((N, 20)).astype(np.float32)

    def run(pkg, w):
        m = pkg.adapt.AdaptModule(w, 16)
        fired = []
        req = m.ibcast_adapt(w.stack(list(x)), root=0,
                             on_complete=lambda result: fired.append(
                                 tuple(_host(result).shape)))
        req.wait()
        first = list(fired)
        req.wait()                     # the callback fires exactly once
        return first, len(fired), _host(req.get()).tolist()
    assert _same(ws, run)[:2] == ([(N, 20)], 1)


def test_adapt_selected_as_component(worlds):
    ws, set_ = worlds
    set_("coll_adapt_priority", 90)

    def run(pkg, w):
        c = w.dup()
        # adapt provides no standard vtable slot (only *_adapt entry
        # points), so nbc keeps the i-slots; adapt is in the list
        return (isinstance(c.c_coll.get("iallreduce"),
                           pkg.adapt.AdaptModule),
                dict(c._coll_priorities).get("adapt"),
                c._coll_winners["iallreduce"])
    assert _same(ws, run) == (False, 90, "nbc")


# -- coll/acoll --------------------------------------------------------
def test_generation_detection():
    """The reference's TPU-generation rows were chosen for a TPU's links
    and match no device the port runs on: by design the port's table has
    only the measured host row, so every TPU kind detects as None."""
    for kind in ("cpu", "GoldenGate-9000", "NVIDIA H100 80GB HBM3"):
        assert p_acoll.detect_generation(kind) == \
            r_acoll.detect_generation(kind)
    assert p_acoll.detect_generation("cpu") == "cpu"
    for kind in ("TPU v4", "TPU v5p", "TPU v5 lite", "TPU v5e", "TPU v6e"):
        assert r_acoll.detect_generation(kind) is not None
        assert p_acoll.detect_generation(kind) is None


def test_hints_installed_at_default_precedence(worlds):
    """On a CPU world both detectors matched 'cpu'; the install never
    overrides an explicit setting. The port's fresh world shows the hint
    itself: 4 MB segments at DEFAULT precedence (the reference's shared
    world may carry other tests' explicit settings by now)."""
    ws, _ = worlds
    assert (p_var.var_get("coll_torch_segsize"),
            p_var.var_source("coll_torch_segsize")) == (4 << 20, "default")

    def run(pkg, w):
        seen = pkg.var.var_get("coll_acoll_detected")
        v = pkg.var._registry.get(pkg.seg)
        saved = (v.value, v.source)
        pkg.var.var_set(pkg.seg, 12345)
        try:
            pkg.acoll.AcollComponent._hints_done = False
            pkg.acoll.AcollComponent()._ensure_hints()
            after = (pkg.var.var_get(pkg.seg), pkg.var.var_source(pkg.seg))
        finally:
            v.value, v.source = saved
            pkg.var.bump_epoch()
            pkg.acoll.AcollComponent._hints_done = True
        return seen, after
    assert _same(ws, run) == ("cpu", (12345, "api"))


def test_acoll_never_wins_selection(worlds):
    ws, _ = worlds
    assert _same(ws, lambda pkg, w: [
        getattr(m, "__module__", "") == pkg.mod
        for m in w.c_coll.values()].count(True)) == 0


def test_hint_table_shape():
    for tbl in (p_acoll.GENERATION_HINTS, r_acoll.GENERATION_HINTS):
        for gen, (segsize, arity) in tbl.items():
            assert segsize >= 1 << 20 and arity in (None, 2, 4), gen
            assert (arity is None) == (gen == "cpu"), gen
    assert p_acoll.GENERATION_HINTS["cpu"] == r_acoll.GENERATION_HINTS["cpu"]
    assert set(p_acoll.GENERATION_HINTS) == {"cpu"}
