"""The port's dynamic process management and intercommunicators against
the reference's (``tests/test_dpm.py`` and the intercomm cases of
``tests/test_pp_ep_inter.py``): spawn, ports, connect/accept, the naming
service, join, disconnect, and the intercomm collectives.

Each case runs the same steps on the port's 8-rank CPU world and on the
reference's 8-device world, with the same inputs; the observations
(sizes, ranks, error classes, identities, results) must be identical,
exact for data movement and rtol 1e-6 for float32 sums. Both packages'
DPM registries are reset around every test. The port's spawn treats a
rank as a slot and does not de-duplicate an explicit device list; the
one case where that changes an observation (``maxprocs=3`` over
``[d0, d0, d1]``) is checked on the port alone.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch as P
from ompi_tpu.core import dpm as r_dpm
from ompi_tpu.core.intercomm import intercomm_create as r_icreate
from ompi_tpu_torch.core import dpm as p_dpm
from ompi_tpu_torch.core.intercomm import intercomm_create as p_icreate

N = 8
PORT = SimpleNamespace(name="port", MPI=P, dpm=p_dpm, icreate=p_icreate)
REF = SimpleNamespace(name="ref", MPI=ompi_tpu, dpm=r_dpm,
                      icreate=r_icreate)


@pytest.fixture()
def worlds(world):
    P._reset_for_tests()
    r_dpm._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    yield [(PORT, P.get_comm_world()), (REF, world)]
    r_dpm._reset_for_tests()
    P._reset_for_tests()


def _both(worlds, fn):
    (pp, pw), (rp, rw) = worlds
    port, ref = fn(pp, pw), fn(rp, rw)
    assert port == ref, (port, ref)
    return port


def _host(y):
    return (y.cpu().numpy() if isinstance(y, torch.Tensor)
            else np.asarray(y))


def _err(fn, *a, **kw):
    try:
        fn(*a, **kw)
    except (P.MPIError, ompi_tpu.MPIError) as e:
        return e.error_class
    return None


def test_spawn_basic(worlds):
    def run(pkg, world):
        ran = []

        def child_main(child):
            x = child.alloc((3,), np.float32, fill=2.0)
            y = child.allreduce(x, pkg.MPI.SUM)
            ran.append((child.size, float(_host(y)[0, 0])))

        inter = pkg.MPI.Comm_spawn(child_main, 4, world)
        child = inter.remote_comm
        parent_view = pkg.MPI.Comm_get_parent(child)
        return (ran, inter.size, inter.remote_size,
                bool(set(child.group.world_ranks)
                     & set(world.group.world_ranks)),
                parent_view is not None and parent_view.remote_size,
                pkg.MPI.Comm_get_parent(world))
    assert _both(worlds, run) == ([(4, 8.0)], N, 4, False, N, None)


def test_spawn_intercomm_traffic(worlds):
    def run(pkg, world):
        inter = pkg.MPI.Comm_spawn(None, 2, world)
        child = inter.remote_comm
        out = inter.bcast(np.arange(3, dtype=np.float32), root=0,
                          root_side="local")
        return _host(out).tolist(), _host(out).shape[0] == child.size
    assert _both(worlds, run) == ([[0.0, 1.0, 2.0]] * 2, True)


def test_spawn_multiple_appnums(worlds):
    def run(pkg, world):
        mains = []

        def app_a(child, appnum):
            mains.append(("a", appnum, child.size))

        def app_b(child, appnum):
            mains.append(("b", appnum, child.size))

        inter = pkg.MPI.Comm_spawn_multiple([(app_a, 2), (app_b, 3)], world)
        child = inter.remote_comm
        return child.size, child._spawn_appnums, mains
    assert _both(worlds, run) == (5, [0, 0, 1, 1, 1],
                                  [("a", 0, 5), ("b", 1, 5)])


def test_spawn_on_explicit_devices(worlds):
    def run(pkg, world):
        devs = world.devices[:2]
        inter = pkg.MPI.Comm_spawn(None, 2, world, devices=devs)
        return inter.remote_comm.devices == tuple(devs), inter.remote_size
    assert _both(worlds, run) == (True, 2)


def test_spawn_bad_args(worlds):
    def run(pkg, world):
        return (_err(pkg.MPI.Comm_spawn, None, 0, world),
                _err(pkg.MPI.Comm_spawn, None, 2, world, devices=[]))
    assert _both(worlds, run) == (P.ERR_ARG, P.ERR_ARG)


def test_spawn_oversubscribe(worlds):
    def run(pkg, world):
        e = _err(pkg.MPI.Comm_spawn, None, world.size + 1, world)
        soft = pkg.MPI.Comm_spawn(None, world.size + 5, world, soft=True)
        d = world.devices
        three = pkg.MPI.Comm_spawn(None, 2, world, devices=[d[0], d[0], d[1]])
        return e, soft.remote_size, three.remote_size
    assert _both(worlds, run) == (P.ERR_SPAWN, N, 2)
    # by design: a rank is a slot, so the port spawns 3 ranks over
    # [d0, d0, d1] where the reference's one-rank-per-device rule gives 2
    w = worlds[0][1]
    d = w.devices
    inter = P.Comm_spawn(None, 3, w, devices=[d[0], d[0], d[1]])
    assert inter.remote_size == 3
    assert inter.remote_comm.devices == (d[0], d[0], d[1])


def test_rendezvous_fifo_multiple_clients(worlds):
    def run(pkg, world):
        subs = world.split([0, 0, 1, 1, 2, 2, 3, 3])
        server, c1, c2 = subs[0], subs[2], subs[4]
        port = pkg.MPI.Open_port()
        a1 = pkg.MPI.Comm_iaccept(port, server)
        a2 = pkg.MPI.Comm_iaccept(port, server)
        i1 = pkg.MPI.Comm_connect(port, c1)
        obs = [a1.test()[0], a2.test()[0],
               a1.get().remote_comm is c1, i1.remote_comm is server]
        i2 = pkg.MPI.Comm_connect(port, c2)
        obs += [a2.test()[0], a2.get().remote_comm is c2,
                i2.remote_comm is server]
        return obs
    assert _both(worlds, run) == [True, False, True, True, True, True, True]


def test_connect_accept_rendezvous(worlds):
    def run(pkg, world):
        subs = world.split([0, 0, 0, 0, 1, 1, 1, 1])
        a, b = subs[0], subs[4]
        port = pkg.MPI.Open_port()
        obs = [_err(pkg.MPI.Comm_accept, port, a)]
        areq = pkg.MPI.Comm_iaccept(port, a)
        obs.append(areq.test()[0])
        inter_b = pkg.MPI.Comm_connect(port, b)
        obs.append(areq.test()[0])
        inter_a = areq.get()
        obs += [inter_a.size, inter_a.remote_size,
                inter_b.local_comm is b, inter_b.remote_comm is a,
                inter_a.local_comm is a, inter_a.remote_comm is b]
        pkg.MPI.Close_port(port)
        obs.append(_err(pkg.MPI.Comm_connect, port, b))
        return obs
    assert _both(worlds, run) == [P.ERR_PENDING, False, True, 4, 4, True,
                                  True, True, True, P.ERR_PORT]


def test_naming_service(worlds):
    def run(pkg, world):
        port = pkg.MPI.Open_port()
        pkg.MPI.Publish_name("ocean", port)
        obs = [pkg.MPI.Lookup_name("ocean") == port,
               _err(pkg.MPI.Publish_name, "ocean", port)]
        pkg.MPI.Unpublish_name("ocean")
        obs += [_err(pkg.MPI.Lookup_name, "ocean"),
                _err(pkg.MPI.Comm_connect, "tpu://port/999", world)]
        return obs
    assert _both(worlds, run) == [True, P.ERR_SERVICE, P.ERR_NAME,
                                  P.ERR_PORT]


def test_nested_spawn_namespaces_disjoint(worlds):
    def run(pkg, world):
        a = pkg.MPI.Comm_spawn(None, 4, world).remote_comm
        nested = pkg.MPI.Comm_spawn(None, 4, a).remote_comm
        c = pkg.MPI.Comm_spawn(None, 8, world).remote_comm
        ws = [set(x.group.world_ranks) for x in (world, a, nested, c)]
        return [sorted(s) for s in ws], [
            bool(ws[i] & ws[j]) for i in range(4) for j in range(i + 1, 4)]
    ranks, overlaps = _both(worlds, run)
    assert not any(overlaps)


def test_join(worlds):
    def run(pkg, world):
        subs = world.split([0, 0, 0, 0, 1, 1, 1, 1])
        a, b = subs[0], subs[4]
        r1 = pkg.MPI.Comm_join("sock-7", a)
        obs = [r1.test()[0]]
        inter_b = pkg.MPI.Comm_join("sock-7", b)
        obs += [inter_b.remote_comm is a, r1.test()[0],
                r1.get().remote_comm is b]
        return obs
    assert _both(worlds, run) == [False, True, True, True]


def test_disconnect(worlds):
    def run(pkg, world):
        inter = pkg.MPI.Comm_spawn(None, 2, world)
        child = inter.remote_comm
        obs = [pkg.MPI.Comm_get_parent(child) is not None]
        pkg.MPI.Comm_disconnect(child)
        obs += [pkg.MPI.Comm_get_parent(child) is None, child._freed]
        pkg.MPI.Comm_disconnect(inter)
        return obs
    assert _both(worlds, run) == [True, True, True]


def _halves(world):
    n = world.size
    subs = world.split([0 if r < n // 2 else 1 for r in range(n)])
    return subs[0], subs[-1]


def test_intercomm_basics(worlds):
    def run(pkg, world):
        n = world.size
        a, b = _halves(world)
        inter = pkg.icreate(a, b)
        obs = [inter.size, inter.remote_size,
               _err(pkg.icreate, a, a)]          # overlapping groups
        la = a.stack([np.full(2, r + 1.0, np.float32)
                      for r in range(a.size)])
        rb = b.stack([np.full(2, 10.0 * (r + 1), np.float32)
                      for r in range(b.size)])
        lo, ro = inter.allreduce(la, rb, pkg.MPI.SUM)
        obs += [_host(lo).tolist(), _host(ro).tolist()]
        out = inter.bcast(np.asarray([5.0, 6.0], np.float32), root=1,
                          root_side="local")
        obs += [_host(out).tolist(), out.shape[0] == b.size]
        merged = inter.merge()
        merged_high = inter.merge(high=True)
        obs += [merged.size == n,
                merged_high.group.world_ranks[:b.size]
                == b.group.world_ranks]
        x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
        obs.append(_host(merged.allreduce(merged.stack(list(x)),
                                          pkg.MPI.SUM)).tolist())
        inter.barrier()
        return obs
    obs = _both(worlds, run)
    assert obs[2] == P.ERR_ARG
    assert obs[3][0] == [100.0, 100.0] and obs[4][0] == [10.0, 10.0]


def test_intercomm_alltoall(worlds):
    def run(pkg, world):
        a, b = _halves(world)
        inter = pkg.icreate(a, b)
        ls, rs = a.size, b.size
        la = np.arange(ls * rs * 1, dtype=np.float32).reshape(ls, rs, 1)
        rb = 100 + np.arange(rs * ls * 1,
                             dtype=np.float32).reshape(rs, ls, 1)
        lo, ro = inter.alltoall(a.stack(list(la)), b.stack(list(rb)))
        lo, ro = _host(lo), _host(ro)
        ok = all(ro[j, i, 0] == la[i, j, 0] and lo[i, j, 0] == rb[j, i, 0]
                 for i in range(ls) for j in range(rs))
        return lo.tolist(), ro.tolist(), ok
    assert _both(worlds, run)[2]


def test_intercomm_tensors_stay_on_device(worlds):
    """On tensors every crossing stays a tensor on the receiving group's
    device, and the values equal the reference's."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N, 5)).astype(np.float32)

    def run(pkg, world):
        inter = pkg.MPI.Comm_spawn(None, 4, world)
        child = inter.remote_comm
        cx = child.stack(list(x[:4] * 2))
        lo, ro = inter.allreduce(world.stack(list(x)), cx, pkg.MPI.MAX)
        go, gr = inter.allgather(world.stack(list(x)), cx)
        bo = inter.bcast(world.stack(list(x))[3], root=3)
        outs = (lo, ro, go, gr, bo)
        kinds = ([isinstance(o, torch.Tensor) and o.device == c.device
                  for o, c in zip(outs, (world, child, world, child,
                                         child))]
                 if pkg is PORT else [True] * 5)
        return kinds, [_host(o).tolist() for o in outs]
    kinds, _ = _both(worlds, run)
    assert kinds == [True] * 5
