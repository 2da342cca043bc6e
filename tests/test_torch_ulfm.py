"""The port's ULFM surface against the reference's (``tests/test_ulfm.py``):
revoke, shrink, agree, failure acknowledgment and request-level FT on the
single-controller world, through injected failures.

Each case runs on a dup of the port's 8-rank CPU world and on a dup of the
reference's 8-device world, each with a clean failure registry, with the
same injected failures and the same seeded inputs; the observations
(error classes, agreed values, group sizes and members, results) must be
identical, exact for counts and integer values, rtol 1e-6 for float32
sums. The port's shrunk comm also keeps its operands on the parent's
device: its stacked rows are the survivors' rows.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch as P
from ompi_tpu.coll import ftagree as r_ftagree
from ompi_tpu.mpiext import ftmpi as r_ftmpi
from ompi_tpu.runtime import ft as r_ft
from ompi_tpu_torch.coll import ftagree as p_ftagree
from ompi_tpu_torch.mpiext import ftmpi as p_ftmpi
from ompi_tpu_torch.runtime import ft as p_ft

N = 8
PORT = SimpleNamespace(name="port", MPI=P, ftmpi=p_ftmpi, ft=p_ft,
                       ftagree=p_ftagree)
REF = SimpleNamespace(name="ref", MPI=ompi_tpu, ftmpi=r_ftmpi, ft=r_ft,
                      ftagree=r_ftagree)


@pytest.fixture()
def comms(world):
    """A dup of each package's world with a clean failure registry, so
    injected failures never leak into other tests."""
    P._reset_for_tests()
    r_ft._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    out = []
    for pkg, w in ((PORT, P.get_comm_world()), (REF, world)):
        c = w.dup()
        c.set_errhandler(pkg.MPI.ERRORS_RETURN)
        out.append((pkg, c))
    yield out
    r_ft._reset_for_tests()
    P._reset_for_tests()


def _both(comms, fn):
    """``fn(pkg, comm)`` on both; the observations must be identical."""
    (pp, pc), (rp, rc) = comms
    port, ref = fn(pp, pc), fn(rp, rc)
    assert port == ref, (port, ref)
    return port


def _ones(c, n=4):
    return c.put(np.ones((c.size, n), np.float32))


def _val(y):
    return float(np.asarray(y.cpu() if isinstance(y, torch.Tensor)
                            else y)[0, 0])


def _err(fn, *a, **kw):
    """The error class ``fn`` raised, or None."""
    try:
        fn(*a, **kw)
    except (P.MPIError, ompi_tpu.MPIError) as e:
        return e.error_class
    return None


def test_collective_raises_proc_failed(comms):
    def run(pkg, c):
        before = _val(c.allreduce(_ones(c)))
        pkg.ftmpi.fail_rank(c.group.world_ranks[1], "test kill")
        return before, _err(c.allreduce, _ones(c))

    assert _both(comms, run) == (float(N), 75)


def test_shrink_produces_working_comm(comms):
    def run(pkg, c):
        pkg.ftmpi.fail_rank(c.group.world_ranks[1])
        pkg.ftmpi.fail_rank(c.group.world_ranks[3])
        small = pkg.ftmpi.Comm_shrink(c)
        rows = np.arange(N * 3, dtype=np.float32).reshape(N, 3)
        x = small.put(rows[[r for r in range(N) if r not in (1, 3)]])
        y = np.asarray(small.allreduce(x).cpu()
                       if pkg is PORT else small.allreduce(x))
        return (small.size, list(small.group.world_ranks),
                _val(small.allreduce(_ones(small))), y.tolist())

    size, members, ones, y = _both(comms, run)
    assert size == N - 2 and 1 not in members and 3 not in members
    assert ones == float(N - 2)
    rows = np.arange(N * 3, dtype=np.float32).reshape(N, 3)
    want = rows[[0, 2, 4, 5, 6, 7]].sum(0)
    np.testing.assert_allclose(np.asarray(y)[0], want, rtol=1e-6)


def test_shrunk_rows_stay_on_the_parent_device(comms):
    """The port's shrink makes no host copy: the child lives on the
    parent's device and ``survivor_rows`` picks the survivors' rows of a
    parent buffer there, which the child's allreduce folds as the
    reference folds the same rows."""
    (pp, pc), (rp, rc) = comms
    rows = np.random.default_rng(3).standard_normal((N, 5)) \
        .astype(np.float32)
    for pkg, c in comms:
        pkg.ftmpi.fail_rank(c.group.world_ranks[6])
    ps, rs = pc.shrink(), rc.shrink()
    px = pc.survivor_rows(pc.put(rows), ps)
    assert isinstance(px, torch.Tensor) and px.device == pc.device
    assert ps.device == pc.device and px.shape == (N - 1, 5)
    py = ps.allreduce(px)
    ry = np.asarray(rs.allreduce(rs.put(np.delete(rows, 6, 0))))
    np.testing.assert_allclose(py.cpu().numpy(), ry, rtol=1e-6)


def test_agree_masks_and_flags_failures(comms):
    def run(pkg, c):
        flags = [0b111] * c.size
        flags[2] = 0b101
        seen = [c.agree(flags)]          # no failure: plain AND
        pkg.ftmpi.fail_rank(c.group.world_ranks[2])
        try:
            c.agree(flags)
            seen.append(None)
        except (P.MPIError, ompi_tpu.MPIError) as e:
            seen.append((e.error_class, e.agreed_value))
        pkg.ftmpi.Comm_failure_ack(c)
        seen.append(c.agree(flags))      # acked: quiet again
        return seen

    assert _both(comms, run) == [0b101, (75, 0b111), 0b111]


def test_iagree_and_ishrink(comms):
    def run(pkg, c):
        req = pkg.ftmpi.Comm_iagree(c, [1] * c.size)
        waited = req.wait() is not None
        got = req.get()
        pkg.ftmpi.fail_rank(c.group.world_ranks[0])
        sreq = pkg.ftmpi.Comm_ishrink(c)
        sreq.wait()
        return waited, got, sreq.get().size

    assert _both(comms, run) == (True, 1, N - 1)


def test_failure_ack_and_get_acked(comms):
    def run(pkg, c):
        seen = [pkg.ftmpi.Comm_failure_get_acked(c).size]
        wr = c.group.world_ranks[1]
        pkg.ftmpi.fail_rank(wr)
        seen += [pkg.ftmpi.Comm_get_failed(c).size,
                 pkg.ftmpi.Comm_failure_get_acked(c).size]
        pkg.ftmpi.Comm_failure_ack(c)
        acked = pkg.ftmpi.Comm_failure_get_acked(c)
        return seen, acked.size, list(acked.world_ranks) == [wr]

    assert _both(comms, run) == ([0, 1, 0], 1, True)


def test_ack_failed_partial(comms):
    def run(pkg, c):
        for r in (1, 2):
            pkg.ftmpi.fail_rank(c.group.world_ranks[r])
        return (pkg.ftmpi.Comm_ack_failed(c, 1).size,
                pkg.ftmpi.Comm_ack_failed(c).size)

    assert _both(comms, run) == (1, 2)


def test_pt2pt_to_failed_peer_raises(comms):
    def run(pkg, c):
        pkg.ftmpi.fail_rank(c.group.world_ranks[2])
        return (_err(c.send, np.ones(2, np.float32), src=0, dest=2, tag=7),
                _err(c.recv, source=2, tag=7, dst=0))

    assert _both(comms, run) == (75, 75)


def test_sendrecv_checks_both_peers(comms):
    def run(pkg, c):
        pkg.ftmpi.fail_rank(c.group.world_ranks[2])
        return (_err(c.sendrecv, np.ones(1, np.float32), src=0, dest=2,
                     recvsource=1),
                _err(c.sendrecv, np.ones(1, np.float32), src=0, dest=1,
                     recvsource=2))

    assert _both(comms, run) == (75, 75)


def test_anysource_needs_ack(comms):
    def run(pkg, c):
        pkg.ftmpi.fail_rank(c.group.world_ranks[1])
        first = _err(c.recv, source=-1, tag=7, dst=0)
        pkg.ftmpi.Comm_failure_ack(c)
        # acked: the wildcard re-arms and sees a live sender's message
        c.send(np.full(2, 5.0, np.float32), src=0, dest=3, tag=7)
        data, st = c.recv(source=-1, tag=7, dst=3)
        return first, st.source, float(np.asarray(data)[0])

    assert _both(comms, run) == (75, 0, 5.0)


def test_pending_irecv_fails_when_peer_dies(comms):
    def run(pkg, c):
        req = c.irecv(source=2, tag=9, dst=0)
        pkg.ftmpi.fail_rank(c.group.world_ranks[2])
        return _err(req.wait)

    assert _both(comms, run) == 75


def test_revoke_blocks_ops_but_not_shrink_agree(comms):
    def run(pkg, c):
        x = _ones(c, 2)
        pkg.ftmpi.Comm_revoke(c)
        seen = [pkg.ftmpi.Comm_is_revoked(c), _err(c.allreduce, x),
                _err(c.send, np.ones(1), src=0, dest=1)]
        # ULFM: agree and shrink still work on a revoked communicator
        seen.append(c.agree([3] * c.size))
        fresh = pkg.ftmpi.Comm_shrink(c)
        seen += [fresh.size, fresh.is_revoked()]
        return seen

    assert _both(comms, run) == [True, 72, 72, 3, N, False]


def test_pending_irecv_observes_revoke(comms):
    def run(pkg, c):
        req = c.irecv(source=1, tag=3, dst=0)
        pkg.ftmpi.Comm_revoke(c)
        return _err(req.wait)

    assert _both(comms, run) == 72


def test_failure_listener_epoch(comms):
    def run(pkg, c):
        events = []
        pkg.ftmpi.add_failure_listener(lambda r, why: events.append((r, why)))
        e0 = pkg.ftmpi.failure_epoch()
        pkg.ftmpi.fail_rank(c.group.world_ranks[0], "kill")
        pkg.ftmpi.fail_rank(c.group.world_ranks[0], "kill-again")  # dedup
        return pkg.ftmpi.failure_epoch() - e0, events

    assert _both(comms, run) == (1, [(0, "kill")])


def test_ftagree_tree_structure():
    """The agreement value is the AND of live contributions only, for
    every failure pattern (exhaustive over 4 ranks), in both trees."""
    contribs = [0b1111, 0b1110, 0b1101, 0b1011]
    for mask in range(16):
        alive = [(mask >> r) & 1 == 1 for r in range(4)]
        expect = ~0
        for r in range(4):
            if alive[r]:
                expect &= contribs[r]
        assert p_ftagree._tree_agree(contribs, alive) == expect
        assert r_ftagree._tree_agree(contribs, alive) == expect


def test_probe_devices_healthy(comms):
    def run(pkg, c):
        return pkg.ftmpi.probe_devices(c.devices), pkg.ftmpi.failed_ranks()

    assert _both(comms, run) == ([], frozenset())
