"""The port's MPI-4 Sessions against the reference's
(``tests/test_sessions.py``): per-session MCA var scope, CID space, coll
selection and failure registry — two sessions must not bleed state into
each other or the world.

Each case runs the same steps on the port's 8-rank CPU world and on the
reference's 8-device world, with the same seeded inputs; the
observations (values, error classes, CIDs, class membership, what ran,
results) must be identical — exact for counts, CIDs and integers, rtol
1e-6 for float32 sums. Each test resets both packages' session
refcounts and per-rank create ordinals and the port's runtime.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch as P
from ompi_tpu.mca import var as r_var
from ompi_tpu.runtime import ft as r_ft
from ompi_tpu.runtime import session as r_session
from ompi_tpu_torch.mca import var as p_var
from ompi_tpu_torch.runtime import ft as p_ft
from ompi_tpu_torch.runtime import session as p_session

N = 8
PORT = SimpleNamespace(name="port", MPI=P, var=p_var, ft=p_ft,
                       S=p_session, alg="coll_torch_allreduce_algorithm")
REF = SimpleNamespace(name="ref", MPI=ompi_tpu, var=r_var, ft=r_ft,
                      S=r_session, alg="coll_xla_allreduce_algorithm")


def _reset_ref_sessions():
    r_session._instance_refcount = 0
    r_session._pr_create_seq.clear()


@pytest.fixture()
def worlds(world):
    P._reset_for_tests()
    _reset_ref_sessions()
    r_ft._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    yield [(PORT, P.get_comm_world()), (REF, world)]
    r_ft._reset_for_tests()
    _reset_ref_sessions()
    P._reset_for_tests()


def _both(worlds, fn):
    (pp, pw), (rp, rw) = worlds
    port, ref = fn(pp, pw), fn(rp, rw)
    assert port == ref, (port, ref)
    return port


def _host(y):
    return (y.cpu().numpy() if isinstance(y, torch.Tensor)
            else np.asarray(y))


def _row0(y):
    return _host(y)[0].tolist()


def _close(a, b, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol)


def _err(fn, *a, **kw):
    try:
        fn(*a, **kw)
    except (P.MPIError, ompi_tpu.MPIError) as e:
        return e.error_class
    return None


def test_var_scope_isolation(worlds, rng):
    x = rng.standard_normal((N, 8)).astype(np.float32)

    def run(pkg, world):
        S = pkg.S.Session
        base = pkg.var.var_get(pkg.alg, "auto")
        with S() as s1, S() as s2:
            s1.var_set(pkg.alg, "ring")
            s2.var_set(pkg.alg, "recursive_doubling")
            seen = (s1.var_get(pkg.alg), s2.var_get(pkg.alg),
                    pkg.var.var_get(pkg.alg, "auto") == base)
            c1 = s1.comm_create_from_group(s1.group_from_pset("mpi://WORLD"))
            c2 = s2.comm_create_from_group(s2.group_from_pset("mpi://WORLD"))
            y1 = _host(c1.allreduce(c1.put(x), pkg.MPI.SUM))
            y2 = _host(c2.allreduce(c2.put(x), pkg.MPI.SUM))
            with pkg.var.scope(s1.scope):
                a1 = c1.c_coll["allreduce"].device._algorithm(
                    "allreduce", 32, True)
            with pkg.var.scope(s2.scope):
                a2 = c2.c_coll["allreduce"].device._algorithm(
                    "allreduce", 32, True)
        return seen, a1, a2, y1, y2

    (ps, pa1, pa2, py1, py2), (rs, ra1, ra2, ry1, ry2) = [
        run(pkg, w) for pkg, w in worlds]
    assert (ps, pa1, pa2) == (rs, ra1, ra2) == (
        ("ring", "recursive_doubling", True), "ring", "recursive_doubling")
    _close(py1, ry1)
    _close(py2, ry2)
    _close(py1[0], x.sum(0), rtol=1e-5)


def test_session_var_set_does_not_leak_to_world(worlds):
    def run(pkg, world):
        with pkg.S.Session() as s:
            s.var_set("coll_nbc_priority", -1)
            prio = pkg.var.var_get("coll_nbc_priority", 30)
            req = world.iallreduce(world.alloc((4,), np.float32, fill=1.0),
                                   pkg.MPI.SUM)
            req.wait()
            return prio, s.var_get("coll_nbc_priority"), \
                _row0(req.get())
    assert _both(worlds, run) == (30, -1, [8.0] * 4)


def test_cid_space_isolation(worlds):
    def run(pkg, world):
        SC = pkg.S.SessionCommunicator
        with pkg.S.Session() as s1, pkg.S.Session() as s2:
            c1a = s1.comm_create_from_group(
                s1.group_from_pset("mpi://WORLD"))
            c1b = s1.comm_create_from_group(
                s1.group_from_pset("mpi://SELF"))
            c2a = s2.comm_create_from_group(
                s2.group_from_pset("mpi://WORLD"))
            subs = c1a.split([r % 2 for r in range(c1a.size)])
            return (c1a.cid, c1b.cid, c2a.cid, isinstance(subs[0], SC),
                    subs[0].cid > c1b.cid, sorted({s.cid for s in subs}))
    obs = _both(worlds, run)
    assert obs[:5] == (0, 1, 0, True, True)


def test_ft_registry_isolation(worlds):
    def run(pkg, world):
        SC = pkg.S.SessionCommunicator
        with pkg.S.Session() as s1, pkg.S.Session() as s2:
            c1 = s1.comm_create_from_group(s1.group_from_pset("mpi://WORLD"))
            c2 = s2.comm_create_from_group(s2.group_from_pset("mpi://WORLD"))
            c1.set_errhandler(pkg.MPI.ERRORS_RETURN)
            s1.ft_registry.fail_rank(0, "injected in s1")
            e1 = _err(c1.allreduce, c1.alloc((2,), np.float32, fill=1.0),
                      pkg.MPI.SUM)
            y2 = _row0(c2.allreduce(c2.alloc((2,), np.float32, fill=1.0),
                                    pkg.MPI.SUM))
            w = _row0(world.allreduce(
                world.alloc((2,), np.float32, fill=1.0), pkg.MPI.SUM))
            shrunk = c1.shrink()
            ys = _row0(shrunk.allreduce(
                shrunk.alloc((2,), np.float32, fill=1.0), pkg.MPI.SUM))
            return (e1, y2, pkg.ft.is_failed(0), w,
                    isinstance(shrunk, SC), shrunk.size, ys)
    assert _both(worlds, run) == (
        P.ERR_PROC_FAILED, [8.0, 8.0], False, [8.0, 8.0], True, 7,
        [7.0, 7.0])


def test_session_agree_uses_session_registry(worlds):
    def run(pkg, world):
        with pkg.S.Session() as s1, pkg.S.Session() as s2:
            c1 = s1.comm_create_from_group(s1.group_from_pset("mpi://WORLD"))
            c2 = s2.comm_create_from_group(s2.group_from_pset("mpi://WORLD"))
            s1.ft_registry.fail_rank(0, "injected in s1")
            try:
                c1.agree([~0] * c1.size)
                got = None
            except (P.MPIError, ompi_tpu.MPIError) as e:
                got = (e.error_class, hasattr(e, "agreed_value"))
            return (got, c2.agree([~0] * c2.size),
                    world.agree([~0] * world.size))
    assert _both(worlds, run) == ((P.ERR_PROC_FAILED, True), ~0, ~0)


def test_session_scope_reaches_deferred_nbc_rounds(worlds):
    def run(pkg, world):
        with pkg.S.Session() as s:
            s.var_set(pkg.alg, "ring")
            c = s.comm_create_from_group(s.group_from_pset("mpi://WORLD"))
            x = c.alloc((1 << 15,), np.float32, fill=1.0)   # > fused_min
            req = c.iallreduce(x, pkg.MPI.SUM)
            req.wait()
            out = _host(req.get())[0]
            dev = c.c_coll["allreduce"].device
            ran = any(k[0] == "allreduce" and "ring" in k
                      for k in dev._cache)
            return float(out.min()), float(out.max()), ran
    assert _both(worlds, run) == (8.0, 8.0, True)


def test_session_bound_handle_uses_session_algorithm(worlds):
    def run(pkg, world):
        with pkg.S.Session() as s:
            s.var_set(pkg.alg, "recursive_doubling")
            c = s.comm_create_from_group(s.group_from_pset("mpi://WORLD"))
            x = c.alloc((16,), np.float32, fill=2.0)
            h = c.allreduce_bind(x, pkg.MPI.SUM)
            out = _row0(h(x))
            dev = c.c_coll["allreduce"].device
            ran = any(k[0] == "allreduce" and "recursive_doubling" in k
                      for k in dev._cache)
            return out, ran
    assert _both(worlds, run) == ([16.0] * 16, True)


def test_instance_refcount(worlds):
    def run(pkg, world):
        rc = pkg.S.instance_refcount
        r0 = rc()
        s1, s2 = pkg.S.Session(), pkg.S.Session()
        seen = [rc() - r0]
        s1.finalize()
        s1.finalize()                      # idempotent
        seen.append(rc() - r0)
        s2.finalize()
        seen.append(rc() - r0)
        return seen
    assert _both(worlds, run) == [2, 1, 0]


def test_finalized_session_rejects_use(worlds):
    def run(pkg, world):
        s = pkg.S.Session()
        s.finalize()
        return (_err(s.group_from_pset, "mpi://WORLD"),
                _err(s.var_set, "coll_nbc_priority", 10))
    assert _both(worlds, run) == (P.ERR_OTHER, P.ERR_OTHER)


def test_session_finalize_frees_comms(worlds):
    def run(pkg, world):
        s = pkg.S.Session()
        c = s.comm_create_from_group(s.group_from_pset("mpi://WORLD"))
        d = c.dup()
        subs = c.split([r % 2 for r in range(c.size)])
        s.finalize()
        return (c._freed, d._freed,
                all(sc._freed for sc in subs if sc is not None),
                _err(c.barrier), _err(d.barrier))
    assert _both(worlds, run) == (True, True, True, P.ERR_COMM, P.ERR_COMM)


def test_scope_epoch_keeps_world_memos_hot(worlds, rng):
    x = rng.standard_normal((N, 4)).astype(np.float32)

    def run(pkg, world):
        # one world collective first: a fresh port world registers its
        # lazily registered vars (spc) on its first call, as the
        # reference's shared world did long before this test
        world.allreduce(world.put(x), pkg.MPI.SUM)
        e0 = pkg.var.epoch()
        with pkg.S.Session() as s:
            c = s.comm_create_from_group(s.group_from_pset("mpi://WORLD"))
            a = _host(c.allreduce(c.put(x), pkg.MPI.SUM))
            b = _host(world.allreduce(world.put(x), pkg.MPI.SUM))
            a2 = _host(c.allreduce(c.put(x), pkg.MPI.SUM))
        same = pkg.var.epoch() == e0        # outside any scope
        with pkg.var.scope(s.scope):
            t1 = pkg.var.epoch()
            t2 = pkg.var.epoch()
        return (same, t1 == t2, t1 != e0, isinstance(e0, int),
                isinstance(t1, tuple)), (a, b, a2)

    (pobs, pres), (robs, rres) = [run(pkg, w) for pkg, w in worlds]
    assert pobs == robs == (True, True, True, True, True)
    for p, r in zip(pres, rres):
        _close(p, r)


def test_session_devices_and_psets(worlds):
    """Psets follow the session's rows. The port resolves its rows from
    an explicit list first, then the running world's, then one per CUDA
    device, and raises with neither a CUDA device nor a list; it groups
    shared-memory psets by CUDA device index, so rows on one device (or
    the CPU) get no ``mpix://shared`` pset, as the reference's world of
    one process gets none."""
    def run(pkg, world):
        with pkg.S.Session() as s:
            names = [s.get_nth_pset(i) for i in range(s.get_num_psets())]
            sizes = [s.get_pset_info(n).get("size") for n in names]
            return names, sizes, _err(s.group_from_pset, "mpi://NONE")
    assert _both(worlds, run) == (["mpi://WORLD", "mpi://SELF"],
                                  [str(N), "1"], P.ERR_ARG)
    with p_session.Session(devices=["cpu"] * 3) as s:
        assert s.get_pset_info("mpi://WORLD").get("size") == "3"
    if not torch.cuda.is_available():
        P.Finalize()
        with pytest.raises(P.MPIError):
            p_session.Session()
