"""Parity of the port's process topologies with the JAX package's:
``topo/cart`` (cart, graph, dist-graph), the neighbor collectives on the
device (``topo/neighbor``) and on the host, and ``topo/treematch``.

The same numpy inputs, made from a seed, go through the reference on
communicators built from a ``dup()`` of its 8-device world (freed
afterwards) and through the port's 8-rank CPU world. Everything here is
data movement or rank arithmetic, so everything is exact: neighbor
results bit for bit (the port's device path against its host path and
against both reference paths), ``cart_*``, ``dims_create``, the plans'
wave lists and the treematch permutations.
"""
import numpy as np
import pytest
import torch

import ompi_tpu as R
import ompi_tpu_torch as P
from ompi_tpu.topo import dims_create as r_dims_create
from ompi_tpu.topo import treematch as r_tm
from ompi_tpu_torch.core.errhandler import ERR_BUFFER, ERR_TOPOLOGY
from ompi_tpu_torch.topo import CartTopology, dims_create
from ompi_tpu_torch.topo import neighbor as nbr
from ompi_tpu_torch.topo import treematch as tm

N = 8


@pytest.fixture()
def pworld():
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    yield P.get_comm_world()
    P._reset_for_tests()


@pytest.fixture()
def rworld(world):
    d = world.dup()
    made = []
    d.made = made
    yield d
    for c in made:
        c.free()
    d.free()


def _bits(got, want):
    """Exact equality of values, shape and dtype."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got, want)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def _values(got, want):
    """Equal values (NaN equal to NaN), shape and dtype; the sign of a
    zero is not compared. The reference's device neighbor path writes
    -0.0 as +0.0 (its host path and the port keep the sign)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got, want)
    np.testing.assert_array_equal(got, want)


def _rows(got, want, same=_bits):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, list):
            _rows(g, w, same)
        else:
            same(g, w)


def _make(comm, kind, *args):
    """A topology communicator on either package; the reference's are
    freed by the fixture."""
    c = getattr(comm, kind)(*args)
    if hasattr(comm, "made"):
        comm.made.append(c)
    return c


def _ring_graph(n):
    index, edges = [], []
    for r in range(n):
        edges += [(r - 1) % n, (r + 1) % n]
        index.append(len(edges))
    return index, edges


def _star_graph(n):
    index, edges, cum = [], [], 0
    for r in range(n):
        nb = list(range(1, n)) if r == 0 else [0]
        cum += len(nb)
        index.append(cum)
        edges.extend(nb)
    return index, edges


# (kind, args) of every topology the neighbor tests run on
TOPOS = {
    "cart_2x4_periodic_row": ("create_cart", [2, 4], [True, False]),
    "cart_ring": ("create_cart", [8], [True]),
    "cart_line": ("create_cart", [8], [False]),
    "cart_2_periodic": ("create_cart", [2], [True]),      # duplicate edges
    "cart_2x2x2": ("create_cart", [2, 2, 2], [True, False, True]),
    "graph_star": ("create_graph",) + tuple(_star_graph(N)),
    "graph_3": ("create_graph", [1, 3, 4], [1, 0, 2, 1]),
    # a multigraph dist-graph: 0 -> 1 twice, a self edge, a PROC_NULL
    # in-slot and an in-slot whose sender has no matching out-slot
    "dist_graph_dup": ("create_dist_graph_adjacent",
                       [[1], [0, 0, 2], [1, 2], [-2, 4], [3, 5], [4],
                        [7], [6, 3]],
                       [[1, 1], [0, 2], [2, 1], [4], [3, 5], [4],
                        [7], [6]]),
}


def _topo(comm, name):
    kind, *args = TOPOS[name]
    return _make(comm, kind, *args)


# -- mirrors of tests/test_ptp_topo.py (topologies) -------------------------
def test_dims_create():
    for args in [(12, 2), (24, 3), (8, 3), (6, 2, [3, 0]), (7, 2),
                 (16, 4), (1, 3), (30, 3, [0, 5, 0])]:
        assert dims_create(*args) == r_dims_create(*args), args
    assert dims_create(12, 2) == [4, 3]
    for bad in [(6, 2, [4, 0]), (12, 2, [2, 2])]:
        with pytest.raises(P.MPIError):
            dims_create(*bad)
        with pytest.raises(R.MPIError):
            r_dims_create(*bad)


def test_cart_topology(rworld, pworld):
    out = []
    for comm in (rworld, pworld):
        cart = _make(comm, "create_cart", [2, 4], [True, False])
        subs = cart.cart_sub([False, True])
        out.append((cart.size, cart.cart_rank([1, 2]), cart.cart_coords(6),
                    [cart.cart_shift(r, d, k) for r in range(N)
                     for d in (0, 1) for k in (1, 2, -1)],
                    [cart.cart_rank([a, b]) for a in (-1, 0, 3)
                     for b in (0, 3)],
                    subs[0].size, subs[0] is subs[1], subs[0] is subs[4],
                    subs[0].topo.dims, subs[0].topo.periods,
                    subs[0].group.world_ranks))
        with pytest.raises(Exception) as e:
            cart.cart_rank([0, 4])
        out.append(e.value.error_class)
    assert out[0] == out[2] and out[1] == out[3] == ERR_TOPOLOGY
    assert out[0][1:3] == (6, (1, 2))
    assert out[0][3][0] == (4, 4) and out[0][3][3] == (-2, 1)


@pytest.mark.parametrize("name", sorted(TOPOS))
def test_neighbor_allgather(rworld, pworld, name):
    """Device and host paths, both packages: the same rows, bit for bit
    (NaN, -0.0 and all) against the reference's host path."""
    rc, pc = _topo(rworld, name), _topo(pworld, name)
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal((pc.size, 3, 2)).astype(np.float32)
    x[1, 0, 0], x[-1, 1, 1] = np.nan, -0.0
    want = rc.neighbor_allgather(x)
    _rows(rc.neighbor_allgather(rc.put(x)), want, _values)
    _rows(pc.neighbor_allgather(x), want)
    dev = pc.neighbor_allgather(pc.put(x))
    assert all(isinstance(a, torch.Tensor) for a in dev)
    _rows(dev, want)


@pytest.mark.parametrize("name", sorted(TOPOS))
def test_neighbor_alltoall(rworld, pworld, name):
    rng = np.random.default_rng(7 + len(name))
    rc, pc = _topo(rworld, name), _topo(pworld, name)
    d_out = max(nbr._plan(pc).max_out, 1)
    x = rng.integers(-99, 99, (pc.size, d_out, 2)).astype(np.int64)
    want = rc.neighbor_alltoall(x)
    _rows([np.asarray(a) for a in rc.neighbor_alltoall(rc.put(x))], want)
    _rows(pc.neighbor_alltoall(x), want)
    _rows(pc.neighbor_alltoall(pc.put(x)), want)


def test_cart_neighbor_allgather(rworld, pworld):
    for comm in (rworld, pworld):
        cart = _make(comm, "create_cart", [8], [True])
        x = np.arange(8, dtype=np.float32)[:, None]
        outs = cart.neighbor_allgather(cart.stack(list(x)))
        np.testing.assert_array_equal(np.asarray(outs[0]).ravel(),
                                      [7.0, 1.0])


def test_graph_topology_neighbor_alltoall(rworld, pworld):
    for comm in (rworld, pworld):
        g = _make(comm, "create_graph", [1, 3, 4], [1, 0, 2, 1])
        assert g.graph_neighbors(1) == [0, 2]
        send = np.zeros((3, 2, 1), np.float32)
        send[0, 0], send[1, 0], send[1, 1], send[2, 0] = 10, 21, 22, 32
        outs = g.neighbor_alltoall(g.stack(list(send)))
        np.testing.assert_array_equal(np.asarray(outs[0]).ravel(), [21.0])
        np.testing.assert_array_equal(np.asarray(outs[1]).ravel(),
                                      [10.0, 32.0])
        np.testing.assert_array_equal(np.asarray(outs[2]).ravel(), [22.0])


def test_neighbor_alltoall_duplicate_edges(rworld, pworld):
    """Periodic ring of size 2: both neighbors of each rank are the same
    rank — chunks must not overwrite each other."""
    for comm in (rworld, pworld):
        cart2 = _make(comm, "create_cart", [2], [True])
        send = np.zeros((2, 2, 1), np.float32)
        send[0, 0], send[0, 1], send[1, 0], send[1, 1] = 1, 2, 3, 4
        outs = cart2.neighbor_alltoall(cart2.stack(list(send)))
        np.testing.assert_array_equal(np.asarray(outs[0]).ravel(), [3, 4])
        np.testing.assert_array_equal(np.asarray(outs[1]).ravel(), [1, 2])


# -- mirrors of tests/test_neighbor_device.py -------------------------------
def test_halo_exchange_2d_cart_device(rworld, pworld):
    rc = _make(rworld, "create_cart", [2, N // 2], [True, False])
    pc = _make(pworld, "create_cart", [2, N // 2], [True, False])
    x = np.arange(N * 3, dtype=np.float32).reshape(N, 3)
    want = rc.neighbor_allgather(rc.put(x))
    xt = pc.put(x)
    out = pc.neighbor_allgather(xt)
    _rows(out, [np.asarray(a) for a in want])
    _rows(out, pc.neighbor_allgather(x))
    # the plan keeps the reference's wave schedule, exactly
    plan, rplan = nbr._plan(pc), rc._nbr_plan[1]
    assert plan.n_waves == rplan.n_waves >= 1
    assert [w["perm"] for w in plan.waves] == [w["perm"] for w in
                                              rplan.waves]
    for w in plan.waves:
        dsts = [d for _, d in w["perm"]]
        srcs = [s for s, _ in w["perm"]]
        assert len(set(dsts)) == len(dsts) and len(set(srcs)) == len(srcs)


def test_neighbor_alltoall_device_matches_host(rworld, pworld):
    for comm in (rworld, pworld):
        cart = _make(comm, "create_cart", [N], [True])
        deg = len(cart.topo.neighbors(0))
        send = np.arange(N * deg * 2, dtype=np.float32).reshape(N, deg, 2)
        dev = cart.neighbor_alltoall(cart.put(send))
        host = cart.neighbor_alltoall(send)
        for r in range(N):
            _bits(np.asarray(dev[r]) if not isinstance(dev[r], torch.Tensor)
                  else dev[r], host[r])


def test_neighbor_alltoall_nonperiodic_edges(rworld, pworld):
    rc = _make(rworld, "create_cart", [N], [False])
    pc = _make(pworld, "create_cart", [N], [False])
    send = np.arange(N * 2 * 2, dtype=np.float32).reshape(N, 2, 2)
    want = [np.asarray(a) for a in rc.neighbor_alltoall(rc.put(send))]
    dev = pc.neighbor_alltoall(pc.put(send))
    _rows(dev, want)
    assert [tuple(a.shape) for a in dev] == [a.shape for a in want]
    assert dev[0].shape[0] == 1 and dev[3].shape[0] == 2


def test_neighbor_allgather_graph_device(rworld, pworld):
    index, edges = _star_graph(N)
    rg = _make(rworld, "create_graph", index, edges)
    pg = _make(pworld, "create_graph", index, edges)
    x = np.arange(N * 2, dtype=np.float32).reshape(N, 2)
    dev = pg.neighbor_allgather(pg.put(x))
    _rows(dev, [np.asarray(a) for a in rg.neighbor_allgather(rg.put(x))])
    _rows(dev, pg.neighbor_allgather(x))
    assert dev[0].shape[0] == N - 1 and dev[1].shape[0] == 1


@pytest.mark.parametrize("name", ["cart_ring", "cart_2x4_periodic_row",
                                  "dist_graph_dup", "graph_star"])
def test_neighbor_allgatherv_device(rworld, pworld, name):
    rng = np.random.default_rng(11)
    per = [rng.standard_normal(r % 3 * 2 + 1).astype(np.float32)
           for r in range(N)]
    rc, pc = _topo(rworld, name), _topo(pworld, name)
    import jax.numpy as jnp
    want = rc.neighbor_allgatherv([jnp.asarray(a) for a in per])
    want = [np.asarray(a) for a in want]
    _rows(rc.neighbor_allgatherv(per), want)
    dev = pc.neighbor_allgatherv([torch.from_numpy(a) for a in per])
    assert all(isinstance(a, torch.Tensor) for a in dev)
    _rows(dev, want)
    _rows(pc.neighbor_allgatherv(per), want)


@pytest.mark.parametrize("name", ["cart_ring", "cart_line",
                                  "cart_2_periodic", "dist_graph_dup"])
def test_neighbor_alltoallv_device(rworld, pworld, name):
    rc, pc = _topo(rworld, name), _topo(pworld, name)
    out_nb = getattr(pc.topo, "out_neighbors", pc.topo.neighbors)
    send = [[np.full((r + j + 1,), float(r * 10 + j), np.float32)
             for j in range(len(out_nb(r)))] for r in range(pc.size)]
    import jax.numpy as jnp
    want = rc.neighbor_alltoallv([[jnp.asarray(c) for c in row]
                                  for row in send])
    want = [[np.asarray(c) for c in row] for row in want]
    dev = pc.neighbor_alltoallv([[torch.from_numpy(c) for c in row]
                                 for row in send])
    _rows(dev, want)
    host = pc.neighbor_alltoallv(send)
    for r in range(pc.size):
        assert len(host[r]) == len(dev[r])
        for a, b in zip(host[r], dev[r]):
            if a.size:
                _bits(b, a)
            else:
                assert b.numel() == 0


# -- port-only: one gather per call from cached device index tensors --------
def test_neighbor_index_tensors_are_cached(pworld):
    cart = pworld.create_cart([2, 4], [True, False])
    x = pworld.put(np.arange(N * 8, dtype=np.float32).reshape(N, 4, 2))
    cart.neighbor_allgather(x)
    cart.neighbor_alltoall(x)
    plan = nbr._plan(cart)
    ag, a2a = plan._dev[("ag", x.device)], plan._dev[("a2a", 4, x.device)]
    calls = []
    orig = torch.Tensor.index_select

    def counting(t, dim, idx):
        calls.append(idx)
        return orig(t, dim, idx)
    torch.Tensor.index_select = counting
    try:
        for _ in range(3):
            cart.neighbor_allgather(x)
            cart.neighbor_alltoall(x)
    finally:
        torch.Tensor.index_select = orig
    # one gather per call, always from the same cached index tensor
    assert len(calls) == 6
    assert all(c is ag for c in calls[0::2])
    assert all(c is a2a[0] for c in calls[1::2])
    # a new topology drops the old plan and its index tensors
    cart.topo = CartTopology([8], [True])
    assert nbr._plan(cart) is not plan


def test_neighbor_buffer_on_another_device_raises(pworld):
    cart = pworld.create_cart([8], [True])
    with pytest.raises(P.MPIError) as e:
        cart.neighbor_allgather(torch.empty((N, 2), device="meta"))
    assert e.value.error_class == ERR_BUFFER
    pworld.set_errhandler(P.ERRORS_RETURN)
    with pytest.raises(P.MPIError) as e:
        pworld.neighbor_allgather(pworld.put(np.zeros((N, 1))))
    assert e.value.error_class == ERR_TOPOLOGY


# -- mirrors of tests/test_treematch_accel.py:20-80 -------------------------
class _Dev:
    def __init__(self, i, coords, proc=0):
        self.id = i
        self.coords = coords
        self.process_index = proc
        self.platform = "fake"


def test_hardware_distance_manhattan_and_dcn():
    devs = [_Dev(0, (0, 0)), _Dev(1, (0, 1)), _Dev(2, (1, 0)),
            _Dev(3, (1, 1), proc=1)]
    d = tm.hardware_distance(devs)
    np.testing.assert_array_equal(d, r_tm.hardware_distance(devs))
    assert d[0, 1] == 1 and d[1, 2] == 2 and d[0, 3] == 2 + 8
    lin = tm.hardware_distance([torch.device("cpu")] * 5)
    np.testing.assert_array_equal(
        lin, np.abs(np.arange(5)[:, None] - np.arange(5)[None, :]))


def test_comm_matrix_from_graph():
    for index, edges in ([[2, 4, 6, 8], [1, 3, 0, 2, 1, 3, 0, 2]],
                         _star_graph(N), _ring_graph(N)):
        np.testing.assert_array_equal(
            tm.comm_matrix_from_graph(index, edges),
            r_tm.comm_matrix_from_graph(index, edges))


def test_treematch_improves_placement():
    devs = [_Dev(0, (0,)), _Dev(1, (3,)), _Dev(2, (1,)), _Dev(3, (2,))]
    hw = tm.hardware_distance(devs)
    cm = np.zeros((4, 4))
    for a, b in ((0, 1), (1, 2), (2, 3)):
        cm[a, b] = cm[b, a] = 10.0
    perm = tm.treematch_permutation(cm, hw)
    assert perm == r_tm.treematch_permutation(cm, hw)
    assert sorted(perm) == [0, 1, 2, 3]
    assert tm.placement_cost(cm, hw, perm) == 10.0 * 3 < \
        tm.placement_cost(cm, hw)


@pytest.mark.parametrize("n", [6, 8])
def test_treematch_deterministic(n):
    devs = [_Dev(i, (i,)) for i in range(n)]
    hw = tm.hardware_distance(devs)
    cm = np.random.default_rng(n).random((n, n))
    cm = cm + cm.T
    perm = tm.treematch_permutation(cm, hw)
    assert perm == tm.treematch_permutation(cm, hw)
    assert perm == r_tm.treematch_permutation(cm, hw)
    assert tm.placement_cost(cm, hw, perm) == \
        r_tm.placement_cost(cm, hw, perm)


def test_graph_create_reorder(world, rworld, pworld):
    """reorder=True: the treematch permutation on the linear fallback
    distance is the reference's on its CPU devices; the topology is
    unchanged and collectives still work."""
    index, edges = _ring_graph(N)
    cm = tm.comm_matrix_from_graph(index, edges)
    assert (tm.treematch_permutation(cm, tm.hardware_distance(
        list(pworld.devices)))
        == r_tm.treematch_permutation(cm, r_tm.hardware_distance(
            list(world.devices))))
    rc = _make(rworld, "create_graph", index, edges, True)
    pc = _make(pworld, "create_graph", index, edges, True)
    assert pc.size == rc.size == N
    assert pc.graph_neighbors(0) == rc.graph_neighbors(0) == [N - 1, 1]
    x = np.stack([np.full(3, r, np.float32) for r in range(N)])
    np.testing.assert_array_equal(pc.allreduce(pc.stack(list(x)))[0],
                                  np.asarray(rc.allreduce(rc.stack(list(x))))[0])
