"""The port's per-rank tier: textbook MPI programs under the port's
``mpirun --per-rank`` as real multi-process jobs on the CPU.

The counterparts of the reference's ``tests/perrank_programs`` that need
only this slice (pt2pt, collectives on both tiers, communicator algebra,
topologies, the sm/bml byte planes, THREAD_MULTIPLE, staged collectives
and the device payload plane), at the reference's rank counts. Each
program is a string written to ``tmp_path`` and launched by
``ompi_tpu_torch/tools/mpirun.py --per-rank -n N --mca mpi_base_device
cpu``; every rank prints ``OK <name>``, as ``tests/test_perrank.py``
checks. On the CPU a "device" tensor is a CPU tensor, and the device tier
and devxfer use shared-memory segments as their handle kind.

Every job has its own limit (the launcher's ``--timeout`` and a hard
kill of the whole process group a few seconds later), so a hung rank
fails its test instead of the suite.
"""
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MPIRUN = os.path.join(_REPO, "ompi_tpu_torch", "tools", "mpirun.py")
JOB_TIMEOUT = 50                 # the launcher stops the job after this
KILL_AFTER = 58                  # ... and the test kills what is left

HEADER = """\
import os
import sys
import numpy as np
import torch
import ompi_tpu_torch as MPI
from ompi_tpu_torch.runtime.init import _state
"""


def run_job(path, n, mca=(), timeout=JOB_TIMEOUT, env=None, cpu=True):
    """Launch ``path`` on ``n`` ranks, bound to the CPU unless ``cpu`` is
    False; returns (returncode, stdout, stderr). Every process of the job
    is killed at the end, whatever happened."""
    cmd = [sys.executable, MPIRUN, "--per-rank", "-n", str(n),
           "--timeout", str(timeout)]
    if cpu:
        cmd += ["--mca", "mpi_base_device", "cpu"]
    for k, v in mca:
        cmd += ["--mca", k, str(v)]
    cmd.append(str(path))
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("OMPI_TPU_TORCH_")}
    base.update(env or {})
    proc = subprocess.Popen(cmd, env=base, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=_REPO,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=KILL_AFTER)
    except subprocess.TimeoutExpired:
        out, err = "", "killed at the test's limit"
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    return proc.returncode, out, err


def write_prog(tmp_path, name, body):
    path = tmp_path / f"{name}.py"
    path.write_text(HEADER + textwrap.dedent(body))
    return path


PROGRAMS = {
    "p01_hello": (2, """
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        assert r == int(os.environ["OMPI_TPU_TORCH_MCA_mpi_base_process_id"])
        assert n == 2 and 0 <= r < n
        assert MPI.get_comm_self().size == 1
        assert MPI.get_comm_self().rank() == 0
        assert MPI.Get_processor_name().endswith("cpu:0")
        assert w.device == torch.device("cpu")
        MPI.Finalize()
        print(f"OK p01_hello rank={r}/{n}", flush=True)
        """),
    "p02_ring": (4, """
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        right, left = (r + 1) % n, (r - 1) % n
        if r == 0:
            w.send(np.array([0], dtype=np.int64), right, tag=7)
            token, st = w.recv(left, tag=7)
            assert st.source == left and st.tag == 7
            assert token.sum() == n * (n - 1) // 2, token
        else:
            token, st = w.recv(left, tag=7)    # recv first: really blocks
            assert st.source == left
            w.send(np.concatenate([token, [r]]), right, tag=7)
        mine = np.zeros((n, n))
        for (s, d), (msgs, _) in w._pml.traffic.items():
            mine[s, d] += msgs
        total = sum(w.allgather(mine))
        assert total[r, right] == 1 and total[left, r] == 1, total
        MPI.Finalize()
        print(f"OK p02_ring rank={r}/{n}", flush=True)
        """),
    "p03_halo": (3, """
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        right, left = (r + 1) % n, (r - 1) % n
        local = np.full(4, float(r))
        lh, _ = w.sendrecv(local[-1:], dest=right, source=left, sendtag=1,
                           recvtag=1)
        rh, _ = MPI.Sendrecv(w, local[:1], left, right, 2, 2)
        assert lh[0] == float(left) and rh[0] == float(right), (lh, rh)
        MPI.Finalize()
        print(f"OK p03_halo rank={r}/{n}", flush=True)
        """),
    "p04_bcast": (3, """
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        x = np.arange(8, dtype=np.float32) if r == 0 else None
        x = w.bcast(x, root=0)
        assert np.array_equal(x, np.arange(8, dtype=np.float32)), x
        obj = {"msg": "hi", "from": n - 1} if r == n - 1 else None
        assert w.bcast(obj, root=n - 1) == {"msg": "hi", "from": n - 1}
        t = w.bcast(torch.arange(5.0) * (r == 1), root=1)
        assert isinstance(t, torch.Tensor) and torch.equal(t,
                                                           torch.arange(5.0))
        MPI.Finalize()
        print(f"OK p04_bcast rank={r}/{n}", flush=True)
        """),
    "p05_allreduce": (2, """
        from ompi_tpu_torch.core import rankcomm
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        y = w.allreduce(np.full(5, float(r + 1)), MPI.SUM)
        assert np.allclose(y, n * (n + 1) / 2), y
        m = w.allreduce(np.array([float(r)]), MPI.MAX)
        assert m[0] == n - 1, m
        assert w.allreduce(r + 1, MPI.SUM) == n * (n + 1) // 2
        dev0 = rankcomm.counters["coll_device"]
        yd = w.allreduce(torch.full((3,), float(r + 1)), MPI.SUM)
        assert isinstance(yd, torch.Tensor)
        assert torch.allclose(yd, torch.full((3,), n * (n + 1) / 2)), yd
        md = w.allreduce(torch.tensor([float(r)]), MPI.MAX)
        assert float(md[0]) == n - 1, md
        assert w.allreduce(torch.zeros(0), MPI.SUM).shape == (0,)
        big = w.allreduce(torch.full((3 << 19,), float(r)), MPI.SUM)
        assert bool((big == n * (n - 1) / 2).all())   # grew the slots
        assert w._slots.cap == 6 << 20
        assert rankcomm.counters["coll_device"] == dev0 + 4
        MPI.Finalize()
        print(f"OK p05_allreduce rank={r}/{n}", flush=True)
        """),
    "p06_gather_scatter": (3, """
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        root = n - 1
        rows = w.gather(np.full(2, float(r)), root=root)
        if r == root:
            assert len(rows) == n
            for i, row in enumerate(rows):
                assert np.allclose(row, float(i)), (i, row)
            chunks = [np.full(3, 10.0 + i) for i in range(n)]
        else:
            assert rows is None
            chunks = None
        mine = w.scatter(chunks, root=root)
        assert np.allclose(mine, 10.0 + r), mine
        MPI.Finalize()
        print(f"OK p06_gather_scatter rank={r}/{n}", flush=True)
        """),
    "p07_alltoall": (2, """
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        got = w.alltoall([np.array([r, j]) for j in range(n)])
        for i, c in enumerate(got):
            assert np.array_equal(c, [i, r]), (i, c)
        rows = w.allgather(np.array([r * 10]))
        assert [int(x[0]) for x in rows] == [i * 10 for i in range(n)]
        gotd = w.alltoall([torch.tensor([float(r), float(j)])
                           for j in range(n)])
        for i, c in enumerate(gotd):
            assert isinstance(c, torch.Tensor)
            assert torch.equal(c, torch.tensor([float(i), float(r)])), c
        rowsd = w.allgather(torch.tensor([float(r + 1)]))
        assert [float(x[0]) for x in rowsd] == [i + 1.0 for i in range(n)]
        MPI.Finalize()
        print(f"OK p07_alltoall rank={r}/{n}", flush=True)
        """),
    "p08_barrier_probe": (3, """
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        for _ in range(3):
            w.barrier()
        if r == 0:
            w.send(np.arange(6), dest=1, tag=42)
            w.barrier()
        elif r == 1:
            w.barrier()                   # the send happened before it
            st = MPI.Probe(w, 0, 42)
            assert st.source == 0 and st.tag == 42 and st.count == 6
            ok, st2 = w.iprobe(source=0)
            assert ok and st2.count == 6
            data, _ = w.recv(source=0, tag=42)
            assert np.array_equal(data, np.arange(6))
            assert not w.iprobe(source=0)[0]     # consumed
        else:
            w.barrier()
        MPI.Finalize()
        print(f"OK p08_barrier_probe rank={r}/{n}", flush=True)
        """),
    "p09_isend_irecv": (3, """
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        reqs = [MPI.Irecv(w, MPI.ANY_SOURCE, 5) for _ in range(n - 1)]
        for peer in range(n):
            if peer != r:
                MPI.Isend(w, np.array([r, peer]), peer, 5)
        MPI.Waitall(reqs)
        seen = set()
        for q in reqs:
            data = q.get()
            assert data[1] == r
            seen.add(int(data[0]))
        assert seen == set(range(n)) - {r}, seen
        MPI.Finalize()
        print(f"OK p09_isend_irecv rank={r}/{n}", flush=True)
        """),
    "p10_split": (4, """
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        sub = w.split(color=r % 2, key=-r)        # key reverses the order
        members = [i for i in range(n) if i % 2 == r % 2]
        assert sub.size == len(members)
        assert sub.rank() == sorted(members, reverse=True).index(r)
        s = sub.allreduce(np.array([float(r)]), MPI.SUM)
        assert np.allclose(s, sum(members)), (s, members)
        sd = sub.allreduce(torch.tensor([float(r)]), MPI.SUM)
        assert float(sd[0]) == sum(members)
        d = w.dup()
        assert d.rank() == r and d.size == n
        assert d.allreduce(np.array([1.0]), MPI.SUM)[0] == n
        assert float(d.allreduce(torch.ones(4), MPI.SUM)[0]) == n
        d.free()
        shared = w.split_type(MPI.COMM_TYPE_SHARED)
        assert shared.size == n and shared.rank() == r
        shared.free()
        assert w.split(MPI.UNDEFINED) is None
        g = w.create(w.group.incl([3, 1]))
        if r in (1, 3):
            assert g.size == 2 and g.rank() == (0 if r == 3 else 1)
            assert g.allreduce(r, MPI.SUM) == 4
            g.free()
        else:
            assert g is None
        sub.free()
        MPI.Finalize()
        print(f"OK p10_split rank={r}/{n}", flush=True)
        """),
    "p11_scan_reduce": (3, """
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        s = w.scan(np.array([float(r + 1)]), MPI.SUM)
        assert s[0] == (r + 1) * (r + 2) / 2, s
        e = w.exscan(np.array([float(r + 1)]), MPI.SUM)
        if r == 0:
            assert e is None
        else:
            assert e[0] == r * (r + 1) / 2, e
        t = w.reduce(np.array([float(r)]), MPI.SUM, root=0)
        if r == 0:
            assert t[0] == n * (n - 1) / 2, t
        else:
            assert t is None
        mat = MPI.op_create(lambda a, b: a @ b, commute=False, name="matmul")
        m = np.array([[1.0, float(r + 1)], [0.0, 1.0]])
        p = w.reduce(m, mat, root=0)
        if r == 0:
            expect = np.eye(2)
            for i in range(n):
                expect = expect @ np.array([[1.0, float(i + 1)], [0.0, 1.0]])
            assert np.allclose(p, expect), (p, expect)
        rs = w.reduce_scatter_block(
            [np.array([float(r + j)]) for j in range(n)], MPI.SUM)
        assert rs[0] == sum(i + r for i in range(n)), rs
        MPI.Finalize()
        print(f"OK p11_scan_reduce rank={r}/{n}", flush=True)
        """),
    "p12_ssend_mprobe": (2, """
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        if r == 0:
            MPI.Ssend(w, np.array([123]), 1, 9)
            w.send({"k": "v"}, dest=1, tag=10)
        else:
            data, st = MPI.Recv(w, 0, 9)
            assert data[0] == 123 and st.source == 0
            msg = w.mprobe(source=0, tag=10)
            obj, st = w.mrecv(msg)
            assert obj == {"k": "v"} and st.tag == 10
        w.barrier()
        MPI.Finalize()
        print(f"OK p12_ssend_mprobe rank={r}/{n}", flush=True)
        """),
    "p15_cart_halo": (4, """
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        cart = w.create_cart([2, 2], periods=[True, True])
        me = cart.rank()
        ci, cj = cart.cart_coords()
        assert cart.cart_rank([ci, cj]) == me
        src, dest = cart.cart_shift(direction=0, disp=1)
        halo, st = cart.sendrecv(np.full(3, float(me)), dest=dest,
                                 source=src, sendtag=4, recvtag=4)
        assert st.source == src and np.allclose(halo, float(src))
        nbrs = cart.topo.neighbors(me)
        got = cart.neighbor_allgather(np.full(2, float(me)))
        assert len(got) == len(nbrs) == 4
        for nb, g in zip(nbrs, got):
            assert np.allclose(g, float(nb)), (nb, g)
        recv = cart.neighbor_alltoall([np.array([float(me), float(j)])
                                       for j in range(4)])
        for j, (nb, c) in enumerate(zip(nbrs, recv)):
            assert c[0] == float(nb), (j, c)
        cart.free()
        sub = w.split(0 if r < 3 else MPI.UNDEFINED)
        if sub is not None:
            ring = sub.create_cart([3], periods=[True])
            got3 = ring.neighbor_allgather(np.array([float(ring.rank())]))
            left, right = (ring.rank() - 1) % 3, (ring.rank() + 1) % 3
            assert got3[0][0] == left and got3[1][0] == right, got3
            ring.free()
            sub.free()
        MPI.Finalize()
        print(f"OK p15_cart_halo rank={r}/{n}", flush=True)
        """),
    "p16_master_worker": (4, """
        WORK, RESULT, STOP = 1, 2, 3
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        ntask = 3 * (n - 1)
        if r == 0:
            nxt = 0
            for k in range(1, n):
                w.send(np.array([nxt]), dest=k, tag=WORK)
                nxt += 1
            results = {}
            while len(results) < ntask:
                data, st = w.recv(source=MPI.ANY_SOURCE, tag=RESULT)
                results[int(data[0])] = data[1]
                if nxt < ntask:
                    w.send(np.array([nxt]), dest=st.source, tag=WORK)
                    nxt += 1
                else:
                    w.send(np.array([0]), dest=st.source, tag=STOP)
            assert all(results[t] == t * t for t in range(ntask)), results
        else:
            while True:
                data, st = w.recv(source=0, tag=MPI.ANY_TAG)
                if st.tag == STOP:
                    break
                task = int(data[0])
                w.send(np.array([task, task * task]), dest=0, tag=RESULT)
        MPI.Finalize()
        print(f"OK p16_master_worker rank={r}/{n}", flush=True)
        """),
    "p19_sm_bml": (2, """
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        peer = 1 - r
        ep = _state["router"].endpoint
        assert ep.sm is not None, "the sm plane is up on one host"
        assert not ep.probe_basis["ran"], "a user-set min_bytes skips it"
        med = (256 << 10) // 8           # 256 KB >= min_bytes -> sm
        big = (8 << 20) // 8             # 8 MB > the 4 MB ring -> tcp
        sizes = [1, med, 1, big, med, 1]
        if r == 0:
            for i, sz in enumerate(sizes):
                w.send(np.full(sz, i, dtype=np.int64), peer, tag=3)
        else:
            for i, sz in enumerate(sizes):
                data, st = w.recv(0, tag=3)
                assert int(data[0]) == i and data.size == sz, (i, data.size)
        w.barrier()
        if r == 0:
            assert ep.stats["sm"] >= 2 and ep.stats["tcp"] >= 4, ep.stats
        MPI.Finalize()
        print(f"OK p19_sm_bml rank={r}/{n} {ep.stats}", flush=True)
        """),
    "p25_thread_multiple": (2, """
        import threading
        assert MPI.Init_thread(MPI.THREAD_MULTIPLE) == MPI.THREAD_MULTIPLE
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        peer = 1 - r
        NTHREADS, NMSG, BIG = 4, 25, (64 << 10) // 8
        errors = []

        def sender(t):
            try:
                for i in range(NMSG):
                    size = BIG if i % 5 == 4 else 1
                    w.send(np.full(size, t * 1000 + i, np.int64), peer,
                           tag=100 + t)
            except BaseException as e:
                errors.append(("send", t, e))

        def receiver(t):
            try:
                for i in range(NMSG):
                    data, st = w.recv(peer, tag=100 + t)
                    assert st.tag == 100 + t
                    assert int(data[0]) == t * 1000 + i, (t, i, data)
                    assert data.size == (BIG if i % 5 == 4 else 1)
            except BaseException as e:
                errors.append(("recv", t, e))

        threads = [threading.Thread(target=f, args=(t,))
                   for f in (sender, receiver) for t in range(NTHREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=40)
        assert not any(th.is_alive() for th in threads), "threads hung"
        assert not errors, errors
        w.barrier()
        stats = _state["router"].endpoint.stats
        assert stats["tcp"] > 0 and stats["sm"] > 0, stats
        MPI.Finalize()
        print(f"OK p25_thread_multiple rank={r}/{n} {stats}", flush=True)
        """),
    "p27_staged_coll": (3, """
        from ompi_tpu_torch.core import rankcomm
        from ompi_tpu_torch.mca import var
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        var.var_set("coll_tuned_stage_min_bytes", 1 << 16)
        ELEMS = 1 << 18                                   # 1 MB f32
        c = rankcomm.counters

        def staged(k):
            return c["coll_staged_device"] - k
        k = c["coll_staged_device"]
        y = w.allreduce(np.full(ELEMS, float(r + 1), np.float32), MPI.SUM)
        assert isinstance(y, np.ndarray) and y.shape == (ELEMS,)
        assert y[0] == n * (n + 1) / 2 and staged(k) == 1
        ys = w.allreduce(np.full(4, float(r + 1), np.float32), MPI.SUM)
        assert ys[0] == n * (n + 1) / 2 and staged(k) == 1
        g = w.bcast(np.arange(ELEMS, dtype=np.float32) if r == 1 else None,
                    root=1)
        assert isinstance(g, np.ndarray) and g[12345] == 12345.0
        assert staged(k) == 2
        rr = w.reduce(np.full(ELEMS, 2.0, np.float32), MPI.SUM, root=0)
        assert (rr[0] == 2.0 * n) if r == 0 else rr is None
        rows = w.allgather(np.full(ELEMS // n, float(r), np.float32),
                           uniform=True)
        assert all(rows[i][0] == float(i) for i in range(n))
        assert staged(k) == 4
        out = w.alltoall([np.full(ELEMS // n, float(r * n + j), np.float32)
                          for j in range(n)], uniform=True)
        assert all(out[i][0] == float(i * n + r) for i in range(n))
        assert staged(k) == 5
        rows2 = w.allgather(np.full(ELEMS // n, float(r), np.float32))
        assert all(rows2[i][0] == float(i) for i in range(n))
        assert staged(k) == 5                  # not uniform: host ring
        m = w.allreduce(np.full(ELEMS, float(r), np.float32), MPI.MAX)
        p = w.allreduce(np.full(ELEMS, 2.0, np.float32), MPI.PROD)
        i8 = w.allreduce(np.full(ELEMS, np.int64(1) << 40, np.int64),
                         MPI.SUM)
        assert m[0] == n - 1 and p[0] == 2.0 ** n and i8[0] == n << 40
        loc = w.allreduce(np.tile([[float(r), r]], (ELEMS // 2, 1)),
                          MPI.MAXLOC)
        # a pair op folds on the host; only the bcast of its result stages
        assert staged(k) == 9 and loc[0, 0] == n - 1
        MPI.Finalize()
        print(f"OK p27_staged_coll rank={r}/{n}", flush=True)
        """),
    "p28_devxfer": (3, """
        from ompi_tpu_torch.mca import var
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        xfer = _state["router"].xfer
        ELEMS = 1 << 19                  # 2 MB f32: above the 1 MB limit
        right, left = (r + 1) % n, (r - 1) % n
        x = torch.arange(ELEMS, dtype=torch.float32) + 1000.0 * r
        req = w.irecv(left, tag=3)
        w.send(x, right, tag=3)
        x.fill_(-1.0)                    # cloned at send: safe to reuse
        st = req.wait()
        y = req.get()
        assert isinstance(y, torch.Tensor), type(y)
        assert y[12345] == 12345.0 + 1000.0 * left, y[12340:12350]
        assert st.nbytes == ELEMS * 4 and st.count == ELEMS
        assert xfer.stats["sent"] == 1 and xfer.stats["received"] == 1
        x = torch.arange(ELEMS, dtype=torch.float32) + 1000.0 * r
        z = w.sendrecv(x * 2, right)[0]
        assert z[1] == 2 * (1 + 1000.0 * left)
        s = w.sendrecv(torch.full((8,), float(r)), right)[0]
        assert isinstance(s, torch.Tensor) and s[0] == float(left)
        var.var_set("btl_devxfer_min_bytes", 1 << 30)   # host byte path
        h = w.sendrecv(x.to(torch.bfloat16), right)[0]
        assert h.dtype == torch.bfloat16 and h[0] == 1000.0 * left
        var.var_set("btl_devxfer_min_bytes", 1 << 20)
        assert xfer.stats["received"] == 2
        preq = w.recv_init(left, tag=7)
        preq.start()
        w.send(x + 5.0, right, tag=7)
        preq.wait()
        assert float(preq.get()[0]) == 1000.0 * left + 5.0
        a = torch.full((ELEMS,), float(r))
        q1 = w.irecv(right, tag=9)
        q2 = w.irecv(left, tag=9)
        w.send(a, left, tag=9)
        w.send(a + 1, right, tag=9)
        assert float(q1.get()[0]) == float(right)
        assert float(q2.get()[0]) == float(left) + 1
        big = torch.arange(3 << 19, dtype=torch.float32) + r
        got = w.sendrecv(big, right, left)[0]    # replaces a 2 MB slot
        assert torch.equal(got, torch.arange(3 << 19,
                                             dtype=torch.float32) + left)
        loop = w.sendrecv(x, r, r)[0]            # loopback clone
        assert torch.equal(loop, x) and loop.data_ptr() != x.data_ptr()
        # once the acks are in (a barrier orders them: every frame of a
        # sender is delivered in order), more sends to each neighbour reuse
        # the slots: no new export, no new open
        w.barrier()
        slots, opened = xfer.stats["slots"], xfer.stats["opened"]
        for i in range(5):
            w.barrier()
            got = w.sendrecv(x + i, right, left)[0]
            assert got[0] == 1000.0 * left + i
        assert (xfer.stats["slots"], xfer.stats["opened"]) == (slots, opened)
        MPI.Finalize()
        print(f"OK p28_devxfer rank={r}/{n} {xfer.stats}", flush=True)
        """),
    "p23_sessions": (3, """
        from ompi_tpu_torch.core.rankcomm import counters
        from ompi_tpu_torch.runtime.session import Session
        MPI.Init()
        world = MPI.get_comm_world()
        r, n = world.rank(), world.size
        s1 = Session()
        s2 = Session()
        # psets enumerate processes, not devices
        names = [s1.get_nth_pset(i) for i in range(s1.get_num_psets())]
        assert "mpi://WORLD" in names and "mpi://SELF" in names
        assert int(s1.get_pset_info("mpi://WORLD").get("size")) == n
        # comms of both sessions coexist; their traffic cannot cross
        # (own CIDs) even with identical tags
        c1 = s1.comm_create_from_group(s1.group_from_pset("mpi://WORLD"),
                                       tag="work")
        c2 = s2.comm_create_from_group(s2.group_from_pset("mpi://WORLD"),
                                       tag="work")
        assert c1.rank() == r and c1.size == n
        assert c2.rank() == r and c2.size == n
        assert c1.cid == ("s", "work", (0, 1, 2), 0), c1.cid
        assert c2.cid == ("s", "work", (0, 1, 2), 1), c2.cid
        want = n * (n - 1) / 2
        assert float(np.asarray(c1.allreduce(np.float64(r), MPI.SUM))) \
            == want
        assert float(np.asarray(c2.allreduce(np.float64(r * 10),
                                             MPI.SUM))) == want * 10
        # tensors take the device tier on the session comms; its slots
        # belong to the tuple-CID comm
        before = counters["coll_device"]
        t1 = c1.allreduce(torch.full((1 << 14,), float(r)), MPI.SUM)
        t2 = c2.allreduce(torch.full((1 << 14,), float(2 * r)), MPI.SUM)
        assert counters["coll_device"] == before + 2, counters
        assert float(t1.min()) == float(t1.max()) == want
        assert float(t2.min()) == float(t2.max()) == 2 * want
        # pt2pt on a session comm rides its own channel
        if r == 0:
            c1.send(np.array([42.0]), 1, tag=3)
        elif r == 1:
            data, st = c1.recv(0, tag=3)
            assert float(data[0]) == 42.0 and st.source == 0
        cs = s1.comm_create_from_group(s1.group_from_pset("mpi://SELF"),
                                       tag="self")
        assert cs.size == 1 and cs.rank() == 0
        # derived comms join the session's ownership list
        c2d = c2.dup()
        assert float(np.asarray(c2d.allreduce(np.float64(1.0), MPI.SUM))) \
            == n
        # finalize one session; the other and the world keep working
        world.barrier()
        s1.finalize()
        assert c1._freed and cs._freed
        assert float(np.asarray(c2.allreduce(np.float64(1.0), MPI.SUM))) \
            == n
        assert float(np.asarray(world.allreduce(np.float64(2.0),
                                                MPI.SUM))) == 2 * n
        s2.finalize()
        assert c2d._freed and c2._freed      # the family was freed
        world.barrier()
        MPI.Finalize()
        print(f"OK p23_sessions rank={r}/{n}", flush=True)
        """),
}

ENVS = {
    # the reference's p19/p25 pin the sm threshold before Init
    "p19_sm_bml": {"OMPI_TPU_TORCH_MCA_btl_sm_min_bytes": str(32 << 10)},
    "p25_thread_multiple": {
        "OMPI_TPU_TORCH_MCA_btl_sm_min_bytes": str(32 << 10)},
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_perrank_program(tmp_path, name):
    n, body = PROGRAMS[name]
    rc, out, err = run_job(write_prog(tmp_path, name, body), n,
                           env=ENVS.get(name))
    assert rc == 0, f"rc={rc}\n--- out\n{out}\n--- err\n{err[-4000:]}"
    assert out.count(f"OK {name}") == n, out


P18_CONNECT = """
    import time
    from ompi_tpu_torch.core import dpm_perrank as dpm
    role, port_file = sys.argv[1], sys.argv[2]
    MPI.Init()
    world = MPI.get_comm_world()
    r, n = world.rank(), world.size
    if role == "accept":
        if r == 0:
            port = dpm.open_port()
            with open(port_file + ".tmp", "w") as f:
                f.write(port)
            os.rename(port_file + ".tmp", port_file)   # atomic publish
            port = world.bcast(port, root=0)
        else:
            port = world.bcast(None, root=0)
        ic = dpm.comm_accept(port, world, root=0, timeout=40)
    else:
        deadline = time.monotonic() + 40
        while not os.path.exists(port_file):
            if time.monotonic() > deadline:
                raise SystemExit("port file never appeared")
            time.sleep(0.05)
        port = open(port_file).read().strip()
        ic = dpm.comm_connect(port, world, root=0, timeout=40)
    assert ic.remote_size == n, ic.remote_size
    # every local rank messages its same-numbered remote peer, both ways,
    # non-roots included (the root relay both ways)
    token = 100 if role == "accept" else 200
    ic.send(np.array([token + r, r]), remote_rank=r, tag=7)
    data, st = ic.recv(source=r, tag=7, timeout=30)
    expect = (200 if role == "accept" else 100) + r
    assert data[0] == expect and st.source == r, (data, st.source)
    # a tensor crosses as numpy with the same bits
    t = torch.arange(5, dtype=torch.float32) + token + r
    ic.send(t, remote_rank=r, tag=9)
    got, _ = ic.recv(source=r, tag=9, timeout=30)
    other = (200 if role == "accept" else 100) + r
    assert isinstance(got, (np.ndarray, torch.Tensor)), type(got)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.arange(5, dtype=np.float32) + other)
    # local rank 0 also messages every remote rank
    if r == 0:
        for rr in range(ic.remote_size):
            ic.send({"from": role, "to": rr}, remote_rank=rr, tag=8)
    obj, st8 = ic.recv(source=0, tag=8, timeout=30)
    assert obj["to"] == r and obj["from"] != role, obj
    ic.disconnect()
    if role == "accept" and r == 0:
        dpm.close_port(port)
    MPI.Finalize()
    print(f"OK p18_connect {role} rank={r}/{n}", flush=True)
    """


def test_p18_cross_job_connect(tmp_path):
    """Two separately launched 2-rank jobs rendezvous through
    ``dpm_perrank.open_port``/``comm_accept``/``comm_connect`` and
    exchange messages both ways over the root-relayed bridge, non-roots
    included (the reference's p18, as ``tests/test_perrank.py`` runs it).
    Each job has its own launcher limit and process-group kill."""
    path = write_prog(tmp_path, "p18_connect", P18_CONNECT)
    port_file = str(tmp_path / "port.txt")
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("OMPI_TPU_TORCH_")}
    procs = []
    for role in ("accept", "connect"):
        cmd = [sys.executable, MPIRUN, "--per-rank", "-n", "2",
               "--timeout", str(JOB_TIMEOUT), "--mca", "mpi_base_device",
               "cpu", str(path), role, port_file]
        procs.append(subprocess.Popen(cmd, env=base, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True,
                                      cwd=_REPO, start_new_session=True))
    outs = []
    deadline = time.monotonic() + KILL_AFTER
    for proc in procs:
        try:
            outs.append(proc.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            outs.append(("", "killed at the test's limit"))
    for proc in procs:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    for proc, (out, err), role in zip(procs, outs, ("accept", "connect")):
        assert proc.returncode == 0, \
            f"{role} rc={proc.returncode}\n{out}\n{err[-4000:]}"
        assert out.count(f"OK p18_connect {role}") == 2, out


LOC_DEVICE = """
    from ompi_tpu_torch.core.rankcomm import counters
    MPI.Init()
    w = MPI.get_comm_world()
    r, n = w.rank(), w.size


    def pairs(shape, dtype, seed):
        # values with ties (small integers), indices unique per rank
        rows = []
        for j in range(n):
            g = np.random.default_rng(seed + j)
            v = g.integers(0, 3, shape).astype(dtype)
            i = (100 * j + np.arange(np.prod(shape))).reshape(shape)
            rows.append(np.stack([v, i.astype(dtype)], axis=-1))
        return rows


    def expect(rows, better):
        # independent of the port: per record, the best value, ties to
        # the lower index
        out = rows[0].copy()
        for x in rows[1:]:
            v, i = x[..., 0], x[..., 1]
            bv, bi = out[..., 0], out[..., 1]
            take = better(v, bv) | ((v == bv) & (i < bi))
            out = np.where(take[..., None], x, out)
        return out


    for shape, dtype, seed in (((9,), np.float32, 1), ((3, 3), np.float64, 2),
                               ((1,), np.float32, 3), ((37,), np.int32, 4)):
        rows = pairs(shape, dtype, seed)
        for op, better in ((MPI.MINLOC, np.less), (MPI.MAXLOC, np.greater)):
            before = counters["coll_device"]
            got = w.allreduce(torch.from_numpy(rows[r]), op)
            assert counters["coll_device"] == before + 1   # device tier
            assert isinstance(got, torch.Tensor)
            assert got.shape == rows[r].shape, got.shape
            np.testing.assert_array_equal(got.numpy(), expect(rows, better))
    MPI.Finalize()
    print(f"OK loc_device rank={r}/{n}", flush=True)
    """


@pytest.mark.parametrize("n", [3, 8])
def test_loc_ops_on_device_tier(tmp_path, n):
    """MINLOC/MAXLOC on tensors take the shared-buffer tier, whose chunks
    hold whole (value, index) records; exact against numpy."""
    rc, out, err = run_job(write_prog(tmp_path, "loc_device", LOC_DEVICE), n)
    assert rc == 0, f"rc={rc}\n--- out\n{out}\n--- err\n{err[-4000:]}"
    assert out.count("OK loc_device") == n, out


def test_launcher_propagates_first_failure(tmp_path):
    """Rank 1 exits 3 while rank 0 sleeps: the job ends at once with rank
    1's code, and rank 0 is stopped."""
    path = write_prog(tmp_path, "fail", """
        import time
        MPI.Init()
        if MPI.get_comm_world().rank() == 1:
            sys.exit(3)
        time.sleep(40)
        """)
    t0 = time.monotonic()
    rc, out, err = run_job(path, 2, timeout=45)
    assert rc == 3, (rc, out, err[-2000:])
    assert time.monotonic() - t0 < 30


def test_launcher_timeout(tmp_path):
    path = write_prog(tmp_path, "hang", """
        import time
        time.sleep(60)
        """)
    rc, _, _ = run_job(path, 2, timeout=3)
    assert rc == 124


def test_init_without_cuda_raises(tmp_path):
    """A per-rank Init with no CUDA device and no explicit CPU request
    raises MPIError; it never moves to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: Init binds it")
    path = write_prog(tmp_path, "nocuda", """
        try:
            MPI.Init()
        except MPI.MPIError as e:
            assert "mpi_base_device=cpu" in str(e), e
            print("OK nocuda", flush=True)
        else:
            raise SystemExit("Init bound a rank without CUDA")
        """)
    rc, out, err = run_job(path, 1, cpu=False)
    assert rc == 0 and "OK nocuda" in out, (out, err[-2000:])


WIRE_CASES = {
    # compression on the host hops runs now: quantized, within the
    # reference's envelope, the same bits on every rank
    "allreduce": """
        from ompi_tpu_torch.core.rankcomm import counters
        from ompi_tpu_torch.mca import pvar
        x = np.random.default_rng(r).standard_normal(1 << 16) \\
            .astype(np.float32)
        rows = w.allgather(x)
        y = w.allreduce(x, MPI.SUM)
        assert counters["coll_compress_direct"] == 1
        assert pvar.pvar_read("compress_bytes_in") > 0
        ref = np.sum(rows, axis=0, dtype=np.float64)
        assert np.abs(y - ref).max() <= 0.02 * np.abs(ref).max()
        ys = w.allgather(y)
        assert all(np.array_equal(ys[0], v) for v in ys)
        """,
    # a persistent plan binds the one-shot route and gives its result
    "allreduce_init": """
        x = np.full(1 << 16, float(r + 1), np.float32)
        p = w.allreduce_init(x, MPI.SUM)
        assert p.plan.algorithm == "generic" and p.plan.codec
        p.start()
        p.wait()
        assert np.array_equal(p.get(), w.allreduce(x, MPI.SUM))
        """,
    # the ULFM recovery entries run: shrink with nobody failed gives a
    # working comm of every member, revoke poisons the comm everywhere
    "shrink": """
        s = w.shrink()
        assert s.size == 2 and s.rank() == r, (s.size, s.rank())
        y = s.allreduce(np.full(4, float(r + 1)), MPI.SUM)
        assert np.array_equal(y, np.full(4, 3.0)), y
        s.free()
        """,
    "revoke": """
        import time
        if r == 0:
            w.revoke()
        deadline = time.monotonic() + 20
        while not w.is_revoked():
            assert time.monotonic() < deadline, "revoke did not arrive"
            time.sleep(0.01)
        try:
            w.barrier()
        except MPI.MPIError as e:
            assert e.error_class == MPI.ERR_REVOKED, e
        else:
            raise SystemExit("a collective ran on a revoked comm")
        """,
}


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_compressed_host_hops_raise(tmp_path, case):
    """With compression on, the compressed allreduce and its persistent
    plan run (they raised while the hops waited for their slice), and so
    do the ULFM entries: ``revoke`` leaves ``is_revoked()`` true on every
    rank, and ``shrink`` with nobody failed returns a working 2-rank
    comm."""
    body = textwrap.dedent(WIRE_CASES[case])
    path = write_prog(tmp_path, "wire", "MPI.Init()\n"
                      "w = MPI.get_comm_world()\n"
                      "r = w.rank()\n" + body +
                      "MPI.Finalize()\nprint('OK wire', flush=True)\n")
    rc, out, err = run_job(path, 2, mca=[("mpi_base_compress", "1"),
                                         ("mpi_base_compress_min_bytes",
                                          "1024"),
                                         ("coll_tuned_stage_min_bytes",
                                          str(1 << 40))])
    assert out.count("OK wire") == 2, (rc, out, err[-3000:])
