"""The port's per-rank large-message data plane: pml/pipeline over striped
rails, btl/shmseg and the in-segment fold, the pipelined ring and chain,
compressed host hops, the staging probe, and the per-rank persistent
plans.

Jobs: the port's counterparts of the reference's programs p29_stage_probe,
p30_bidir_bulk, p31_compress, p32_persistent, p33_largemsg and p42_shmseg
(both its ``basic`` and ``pipe`` modes), launched by the port's ``mpirun
--per-rank`` on CPU ranks, each under its own limit (``run_job`` of
``test_torch_perrank.py``). Every rank prints ``OK <name>``.

In process: the PipeStore with segments out of order and the init frame
before, between and after them; SegPlane pack, adopt and free; the
SegmentStager against a plain slice; the decision rows
(``pipeline_plan`` over a grid, the pipeline and shm rows of
``decision_table``) exactly against the reference's.
"""
import gc
import itertools
import pickle
import threading

import numpy as np
import pytest
import torch

from ompi_tpu_torch import accelerator
from ompi_tpu_torch.btl import shmseg
from ompi_tpu_torch.btl.devxfer import SegmentStager
from ompi_tpu_torch.coll import decision
from ompi_tpu_torch.mca import var
from ompi_tpu_torch.pml import pipeline
from test_torch_perrank import run_job, write_prog

PROGRAMS = {
    "p29_stage_probe": (3, """
        from ompi_tpu_torch.coll import tuned
        from ompi_tpu_torch.core.rankcomm import counters
        from ompi_tpu_torch.mca import var
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        # every rank adopted rank 0's measurement, on its device
        basis = tuned.probed_stage_basis()
        assert basis.get("ran") and basis.get("device") == "cpu", basis
        for key in ("staged_per_mb_ms", "host_per_mb_ms", "staged_fixed_us",
                    "host_fixed_us", "stage_min_bytes"):
            assert key in basis, (key, basis)
        mins = w.allgather(int(basis["value"]))
        assert all(m == mins[0] for m in mins), mins
        eff = tuned.stage_min_for("allreduce")
        assert eff == int(basis["value"]), (eff, basis)
        # the decision obeys its own measurement
        big = np.full((8 << 20) // 4, float(r + 1), np.float32)
        before = counters["coll_staged_device"]
        y = w.allreduce(big, MPI.SUM)
        assert y[0] == n * (n + 1) / 2
        assert (counters["coll_staged_device"] > before) == \\
            (big.nbytes >= eff)
        # a user-set var overrides the probe
        var.var_set("coll_tuned_stage_min_bytes", 1 << 16)
        assert tuned.stage_min_for("allreduce") == 1 << 16
        before = counters["coll_staged_device"]
        y2 = w.allreduce(np.full(1 << 16, 1.0, np.float32), MPI.SUM)
        assert y2[0] == float(n)
        assert counters["coll_staged_device"] == before + 1
        MPI.Finalize()
        print(f"OK p29_stage_probe rank={r}/{n}", flush=True)
        """),
    "p30_bidir_bulk": (2, """
        from ompi_tpu_torch.mca import pvar
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        peer = 1 - r
        payload = np.full(48 << 20, r + 1, dtype=np.uint8)
        for tag in (9, 10):                  # twice over the same sockets
            req = w.irecv(peer, tag=tag)
            w.ssend(payload, peer, tag=tag)  # ack-bearing, both ways
            st = req.wait()
            got = req.get()
            assert st.source == peer and got.nbytes == payload.nbytes
            assert got[0] == peer + 1 and got[-1] == peer + 1
        assert pvar.pvar_read("pml_pipeline_inits") == 2   # pipelined
        MPI.Finalize()
        print(f"OK p30_bidir_bulk rank={r}/{n}", flush=True)
        """),
    "p31_compress": (None, """
        from ompi_tpu_torch.core.rankcomm import counters
        from ompi_tpu_torch.mca import pvar, var
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        var.var_set("coll_tuned_stage_min_bytes", 1 << 62)   # host tier
        elems = 1 << 18                      # 1 MB f32 per rank
        full = np.random.default_rng(7).normal(size=(n, elems)) \\
            .astype(np.float32)
        mine = full[r].copy()
        ref = full.sum(axis=0)
        y0 = w.allreduce(mine, MPI.SUM)
        assert np.allclose(y0, ref, atol=1e-3)
        var.var_set("mpi_base_compress", True)
        var.var_set("mpi_base_compress_min_bytes", 1 << 20)
        bi0 = pvar.pvar_read("compress_bytes_in")
        bo0 = pvar.pvar_read("compress_bytes_out")
        y1 = w.allreduce(mine, MPI.SUM)
        bi = pvar.pvar_read("compress_bytes_in") - bi0
        bo = pvar.pvar_read("compress_bytes_out") - bo0
        assert bi > 0 and bo / bi <= 0.3, (bi, bo)
        # the direct exchange up to 4 ranks, the tree beyond
        assert counters["coll_compress_direct"] == (1 if n <= 4 else 0)
        err = np.abs(y1 - ref).max()
        assert err <= 0.02 * np.abs(ref).max(), err
        assert pvar.pvar_read("compress_max_abs_error") > 0
        rows = w.gather(y1.copy(), 0)
        if r == 0:
            assert all(np.array_equal(x, rows[0]) for x in rows[1:])
        red = w.reduce(mine, MPI.SUM, 0)
        if r == 0:
            assert np.abs(red - ref).max() <= 0.02 * np.abs(ref).max()
        b = w.bcast(mine if r == 0 else None, 0)
        if r:
            assert np.abs(b - full[0]).max() <= \\
                np.abs(full[0]).max() / 64
        var.var_set("mpi_base_compress", False)
        y2 = w.allreduce(mine, MPI.SUM)
        assert np.array_equal(y2, y0), "the off path changed"
        MPI.Finalize()
        print(f"OK p31_compress rank={r}/{n} ratio={bo / bi:.3f}",
              flush=True)
        """),
    "p32_persistent": (3, """
        import math
        from ompi_tpu_torch.mca import pvar, var
        MPI.Init()
        w = MPI.get_comm_world()
        n, r = w.size, w.rank()
        data = np.full(1024, float(r + 1), np.float32)          # 4 KiB
        ref = np.asarray(w.allreduce(data, MPI.SUM))
        req = w.allreduce_init(data, MPI.SUM)
        assert req.plan.algorithm == "small_combine"
        s0 = pvar.pvar_read("coll_persistent_starts")
        for _ in range(3):
            req.start()
            req.wait()
            assert np.asarray(req.get()).tobytes() == ref.tobytes()
        assert pvar.pvar_read("coll_persistent_starts") - s0 == 3
        data[:] = float(10 * (r + 1))        # read at every Start
        req.start()
        req.wait()
        assert req.get()[0] == 10.0 * n * (n + 1) / 2
        # N outstanding small Starts pipeline on the wire
        outs = [w.allreduce_init(np.full(2, float(i + r), np.float32),
                                 MPI.SUM) for i in range(4)]
        for q in outs:
            q.start()
        for i, q in enumerate(outs):
            q.wait()
            assert q.get()[0] == sum(i + k for k in range(n))
        # the staged and the generic routes, bound at init
        var.var_set("coll_tuned_stage_min_bytes", 1 << 16)
        st = np.arange(1 << 16, dtype=np.float32) + r
        sp = w.allreduce_init(st, MPI.SUM)
        assert sp.plan.algorithm == "staged_device"
        sp.start()
        sp.wait()
        assert np.array_equal(sp.get(), w.allreduce(st, MPI.SUM))
        tp = w.allreduce_init(torch.full((5,), float(r)), MPI.SUM)
        assert tp.plan.algorithm == "generic"
        tp.start()
        tp.wait()
        assert torch.equal(tp.get(), torch.full((5,), float(sum(range(n)))))
        for func, args in (("bcast", (data if r == 0 else None, 0)),
                           ("allgather", (data[:4],)),
                           ("reduce_scatter_block",
                            ([data[:4]] * n, MPI.SUM)),
                           ("barrier", ())):
            p = getattr(w, f"{func}_init")(*args)
            assert p.plan.algorithm == "host"
            p.start()
            p.wait()
            one = getattr(w, func)(*args)
            got = p.get()
            if func == "allgather":
                assert all(np.array_equal(a, b) for a, b in zip(got, one))
            elif func != "barrier":
                assert np.array_equal(got, one)
        # bucketed Startall: K small allreduces, ceil(K*b/B) flushes
        K, elems = 16, 1024
        bufs = [np.full(elems, float(i + r + 1), np.float32)
                for i in range(K)]
        refs = [np.asarray(w.allreduce(b, MPI.SUM)) for b in bufs]
        var.var_set("mpi_base_bucket", True)
        var.var_set("mpi_base_bucket_bytes", 1 << 14)        # 4 members
        f0 = pvar.pvar_read("coll_bucket_flushes")
        reqs = [w.allreduce_init(b, MPI.SUM) for b in bufs]
        MPI.Startall(reqs)
        for q, e in zip(reqs, refs):
            q.wait()
            assert np.asarray(q.get()).tobytes() == e.tobytes()
        flushes = pvar.pvar_read("coll_bucket_flushes") - f0
        assert 1 <= flushes <= math.ceil(K * elems * 4 / (1 << 14))
        var.var_set("mpi_base_bucket", False)
        sreq = w.allreduce_init(np.float64(r + 1), MPI.SUM)
        sreq.start()
        sreq.wait()
        assert sreq.get() == n * (n + 1) / 2
        w.barrier()
        MPI.Finalize()
        print(f"OK p32_persistent rank={r}/{n}", flush=True)
        """),
    "p33_largemsg": (2, """
        from ompi_tpu_torch.core.rankcomm import counters
        from ompi_tpu_torch.mca import pvar, var
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        var.var_set("coll_tuned_stage_min_bytes", 1 << 62)   # host tier
        var.var_set("mpi_base_pipeline_min_bytes", 1 << 20)
        var.var_set("mpi_base_pipeline_segment_bytes", 512 << 10)
        elems = 1 << 21                      # 8 MB f32 per rank
        full = np.random.default_rng(11).normal(size=(n, elems)) \\
            .astype(np.float32)
        mine = full[r].copy()
        ref = full.sum(axis=0)
        s0 = pvar.pvar_read("pml_pipeline_segments")
        i0 = pvar.pvar_read("pml_pipeline_inits")
        y1 = w.allreduce(mine, MPI.SUM)
        assert counters["coll_pipelined_ring"] == 1
        assert pvar.pvar_read("pml_pipeline_inits") - i0 >= 1
        assert pvar.pvar_read("pml_pipeline_segments") - s0 > 1
        assert np.allclose(y1, ref, rtol=1e-4, atol=1e-3)
        var.var_set("mpi_base_pipeline_enable", False)
        y0 = w.allreduce(mine, MPI.SUM)      # reduce + bcast
        var.var_set("mpi_base_pipeline_enable", True)
        assert counters["coll_pipelined_ring"] == 1
        assert np.allclose(y0, y1, rtol=1e-5, atol=1e-4)
        imine = (full[r] * 100).astype(np.int64)
        iref = sum((full[k] * 100).astype(np.int64) for k in range(n))
        assert np.array_equal(w.allreduce(imine, MPI.SUM), iref)
        rows = w.gather(y1.copy(), 0)
        if r == 0:
            assert all(np.array_equal(x, rows[0]) for x in rows[1:])
        data = full[0].copy() if r == 0 else None
        assert np.array_equal(w.bcast(data, 0), full[0])
        assert counters["coll_pipelined_chain"] == 1
        var.var_set("mpi_base_pipeline_enable", False)
        assert np.array_equal(w.bcast(data, 0), full[0])
        var.var_set("mpi_base_pipeline_enable", True)
        assert 0.0 <= pvar.pvar_read("pml_overlap_ratio") <= 1.0
        rails = int(var.var_get("mpi_base_btl_rails", 1))
        per = [pvar.pvar_read(f"btl_rail_bytes_c{c}") for c in range(rails)]
        assert all(b > 0 for b in per), per
        # a device tensor devxfer declines is staged segment by segment
        var.var_set("btl_devxfer_min_bytes", 1 << 40)
        from ompi_tpu_torch.pml import pipeline
        st0 = pipeline.stats["staged"]
        t = torch.arange(elems, dtype=torch.float32) + r
        req = w.irecv(1 - r, 5)
        w.send(t, 1 - r, 5)
        t.fill_(-1.0)                        # safe once send returned
        got = req.get()
        assert isinstance(got, torch.Tensor)
        assert torch.equal(got, torch.arange(elems, dtype=torch.float32)
                           + (1 - r))
        assert pipeline.stats["staged"] - st0 == 16
        # bf16, which numpy lacks, travels as its bytes
        b16 = (torch.arange(elems) % 251).to(torch.bfloat16)
        req = w.irecv(1 - r, 6)
        w.send(b16 + r, 1 - r, 6)
        got = req.get()
        assert got.dtype == torch.bfloat16 and torch.equal(got, b16 + (1 - r))
        assert pipeline.stats["staged"] - st0 == 24
        MPI.Finalize()
        print(f"OK p33_largemsg rank={r}/{n} rails={rails}", flush=True)
        """),
    "p42_shmseg": (2, """
        from ompi_tpu_torch.core.rankcomm import counters
        from ompi_tpu_torch.mca import pvar, var
        MODE = os.environ.get("P42_MODE", "basic")
        MPI.Init()
        w = MPI.get_comm_world()
        r, n = w.rank(), w.size
        var.var_set("coll_tuned_stage_min_bytes", 1 << 62)
        var.var_set("mpi_base_shm_zerocopy", True)
        if MODE == "pipe":
            var.var_set("mpi_base_pipeline_min_bytes", 1 << 20)
            var.var_set("mpi_base_pipeline_segment_bytes", 512 << 10)
        slot = int(var.var_get("mpi_base_shm_seg_bytes"))
        elems = 1 << 20                      # 4 MB f32 per rank
        full = np.random.default_rng(7).normal(size=(n, elems)) \\
            .astype(np.float32)
        mine = full[r].copy()
        a0 = pvar.pvar_read("btl_shm_adoptions")
        p0 = pvar.pvar_read("btl_shm_seg_packs")
        w.barrier()                      # no message lands before a0
        if r == 0:
            w.send(mine, 1, 77)
            w.ssend(mine, 1, 77)             # the descriptor-ack path
            w.send(full[0], 1, 78)
            var.var_set("mpi_base_shm_zerocopy", False)
            w.send(full[0], 1, 79)
            var.var_set("mpi_base_shm_zerocopy", True)
        elif r == 1:
            g1 = w.recv(0, 77)[0]
            g2 = w.recv(0, 77)[0]
            assert np.array_equal(g1, full[0]) and np.array_equal(g2, full[0])
            g1 += 1.0                        # adopted arrays are writable
            on = w.recv(0, 78)[0]
            off = w.recv(0, 79)[0]
            assert on.tobytes() == off.tobytes(), "off gate changed bytes"
            del g1, g2, on, off              # drop adoptions: slots recycle
        if MODE == "basic" and mine.nbytes <= slot:
            if r == 1:
                assert pvar.pvar_read("btl_shm_adoptions") - a0 >= 3
            if r == 0:
                assert pvar.pvar_read("btl_shm_seg_packs") - p0 >= 3
        if MODE == "pipe" and r == 0:
            assert pvar.pvar_read("btl_shm_seg_packs") - p0 > 0
        f0 = pvar.pvar_read("btl_shm_fold_ops")
        y1 = w.allreduce(mine, MPI.SUM)
        ym = w.allreduce(mine, MPI.MAX)
        var.var_set("mpi_base_shm_zerocopy", False)
        y0 = w.allreduce(mine, MPI.SUM)
        ym0 = w.allreduce(mine, MPI.MAX)
        var.var_set("mpi_base_shm_zerocopy", True)
        assert np.allclose(y1, y0, rtol=1e-5, atol=1e-5), "fold != ring"
        assert np.array_equal(ym, ym0), "MAX fold != ring"
        if MODE == "basic":
            assert pvar.pvar_read("btl_shm_fold_ops") - f0 == 2
            assert counters["coll_shm_fold"] == 2
        imine = (full[r] * 100).astype(np.int64)
        iref = sum((full[k] * 100).astype(np.int64) for k in range(n))
        assert np.array_equal(w.allreduce(imine, MPI.SUM), iref)
        rows = w.gather(y1.copy(), 0)
        if r == 0:
            assert all(np.array_equal(x, rows[0]) for x in rows[1:])
        rails = int(var.var_get("mpi_base_btl_rails", 1))
        if rails > 1 and MODE == "pipe":
            per = [pvar.pvar_read(f"btl_rail_bytes_c{c}")
                   for c in range(rails)]
            assert all(b > 0 for b in per), per
        MPI.Finalize()
        print(f"OK p42_shmseg rank={r}/{n} mode={MODE}", flush=True)
        """),
}

# (program, ranks, extra mca, extra env) per job
JOBS = {
    "p29_stage_probe": ("p29_stage_probe", 3, (), None),
    "p30_bidir_bulk": ("p30_bidir_bulk", 2, (), None),
    "p31_compress-direct": ("p31_compress", 3, (), None),
    "p31_compress-tree": ("p31_compress", 5, (), None),
    "p32_persistent": ("p32_persistent", 3, (), None),
    "p33_largemsg-rails1": ("p33_largemsg", 2, (), None),
    "p33_largemsg-rails2": ("p33_largemsg", 2,
                            (("mpi_base_btl_rails", 2),), None),
    "p42_shmseg-basic": ("p42_shmseg", 2, (), None),
    "p42_shmseg-pipe": ("p42_shmseg", 2,
                        (("mpi_base_btl_rails", 2),
                         ("mpi_base_shm_seg_bytes", 1 << 20)),
                        {"P42_MODE": "pipe"}),
}


@pytest.mark.parametrize("job", sorted(JOBS))
def test_dataplane_program(tmp_path, job):
    name, n, mca, env = JOBS[job]
    body = PROGRAMS[name][1]
    rc, out, err = run_job(write_prog(tmp_path, name, body), n, mca=mca,
                           env=env)
    assert rc == 0, f"rc={rc}\n--- out\n{out}\n--- err\n{err[-4000:]}"
    assert out.count(f"OK {name}") == n, out


# -- in-process pieces --------------------------------------------------
class _Router:
    def __init__(self):
        self.pipes = pipeline.PipeStore()


def _train(payload: np.ndarray, seg_elems: int, uid: int = 1):
    flat = payload.reshape(-1)
    nseg = -(-flat.size // seg_elems)
    segs = []
    for i in range(nseg):
        seg = flat[i * seg_elems:(i + 1) * seg_elems]
        segs.append(({"pipeseg": 1, "pipe": uid, "psrc": 3, "idx": i,
                      "n": nseg, "off": i * seg_elems * flat.itemsize,
                      "tb": payload.nbytes},
                     bytes(memoryview(seg).cast("B"))))
    desc = {"kind": "pipe", "pipe": uid, "psrc": 3, "nseg": nseg,
            "nbytes": payload.nbytes,
            "inner": {"kind": "nd", "dtype": payload.dtype.str,
                      "shape": payload.shape}}
    return desc, segs


@pytest.mark.parametrize("init_at", ["before", "between", "after"])
def test_pipestore_out_of_order(init_at):
    """Segments land in any order; the init frame before, between or after
    them; the payload assembles exactly, and the store forgets it."""
    payload = np.arange(1000, dtype=np.float64).reshape(10, 100)
    desc, segs = _train(payload, 96)
    order = list(reversed(segs))
    order = order[1::2] + order[::2]     # interleaved, out of order
    router = _Router()
    at = {"before": 0, "between": len(order) // 2,
          "after": len(order)}[init_at]
    got = None
    for k in range(len(order) + 1):
        if k == at:
            got = pipeline.PipePayload(router, desc)
            assert got.size == 1000 and got.nbytes == payload.nbytes
        if k < len(order):
            router.pipes.deliver(dict(order[k][0]), order[k][1])
    out = pipeline.maybe_resolve(got)
    assert out.shape == payload.shape and np.array_equal(out, payload)
    assert router.pipes.pending() == 0


def test_pipestore_compressed_train():
    """A compressed train's segments are kept per index and decoded in
    order on the consumer thread."""
    from ompi_tpu_torch import compress
    from ompi_tpu_torch.compress import wire
    compress._register_vars()
    payload = np.random.default_rng(0).standard_normal(3000) \
        .astype(np.float32)
    router = _Router()
    segs = [payload[i:i + 1000] for i in range(0, 3000, 1000)]
    desc = {"kind": "pipe", "pipe": 9, "psrc": 1, "nseg": 3,
            "nbytes": payload.nbytes,
            "inner": {"kind": "nd", "dtype": payload.dtype.str,
                      "shape": payload.shape, "comp": "int8_block"}}
    for i in (2, 0):
        router.pipes.deliver({"pipeseg": 1, "pipe": 9, "psrc": 1, "idx": i,
                              "n": 3}, pickle.dumps(wire.encode(segs[i])))
    pp = pipeline.PipePayload(router, desc)
    router.pipes.deliver({"pipeseg": 1, "pipe": 9, "psrc": 1, "idx": 1,
                          "n": 3}, pickle.dumps(wire.encode(segs[1])))
    want = np.concatenate([wire.decode(wire.encode(s)) for s in segs])
    assert np.array_equal(pp.resolve(), want)


def test_pipestore_fail_peer():
    from ompi_tpu_torch.core.errhandler import MPIError
    payload = np.arange(10, dtype=np.int32)
    desc, segs = _train(payload, 4)
    router = _Router()
    router.pipes.deliver(dict(segs[0][0]), segs[0][1])
    pp = pipeline.PipePayload(router, desc)
    router.pipes.fail_peer(3)
    with pytest.raises(MPIError, match="died mid-train"):
        pp.resolve()


class _DictKV:
    def __init__(self):
        self.d = {}

    def set(self, k, v):
        self.d[k] = v

    def get(self, k):
        return self.d[k]


def test_segplane_pack_adopt_free(tmp_path):
    """One sender plane packs into its pool for a peer; the peer adopts
    the payload in place (no copy: a write through the adoption shows in
    the slot); dropping the adoption sends segfree, which returns the
    slot; a dry pool declines."""
    kv = _DictKV()
    frees = []
    sender = shmseg.SegPlane(0, kv.set, kv.get)
    receiver = shmseg.SegPlane(
        1, kv.set, kv.get,
        ctl_send=lambda owner, h: frees.append((owner, h)))
    try:
        a = np.arange(4096, dtype=np.float32)
        desc = sender.pack(1, a)
        assert desc == {"o": 0, "i": desc["i"], "n": a.nbytes}
        inner = {"kind": "nd", "dtype": a.dtype.str, "shape": (64, 64)}
        got = receiver.adopt(desc, inner)
        assert got.shape == (64, 64) and np.array_equal(got.ravel(), a)
        got[0, 0] = -5.0                 # the slot itself, not a copy
        assert np.frombuffer(receiver._attach(0).buf, np.float32,
                             count=1,
                             offset=desc["i"] * sender.slot_bytes)[0] == -5
        del got
        gc.collect()
        assert frees == [(0, {"ctl": "segfree", "peer": 1,
                              "i": desc["i"]})]
        sender.release(1, desc["i"])
        held = [sender.pack(1, a) for _ in range(sender.slot_count)]
        assert all(h is not None for h in held)
        assert sender.pack(1, a) is None        # dry: the ring path
        assert shmseg.stats["no_slot"] >= 1
        assert sender.pack(1, np.zeros(sender.slot_bytes + 4,
                                       np.uint8)) is None
    finally:
        receiver.close()
        sender.close()


def test_segplane_fold_workspace_and_peer_failure():
    kv = _DictKV()
    p0 = shmseg.SegPlane(0, kv.set, kv.get)
    p1 = shmseg.SegPlane(1, kv.set, kv.get)
    try:
        tok = shmseg.coll_token(("w",))
        ws0 = p0.coll_segment(tok)
        ws0.buf[0:4] = b"abcd"
        assert bytes(p1.coll_attach(tok, 0).buf[0:4]) == b"abcd"
        a = np.ones(16, np.uint8)
        held = [p0.pack(1, a) for _ in range(p0.slot_count)]
        assert p0.pack(1, a) is None
        p0.peer_failed(1)                # a dead peer frees nothing
        assert p0.pack(1, a) is not None and held
    finally:
        p1.close()
        p0.close()


@pytest.mark.parametrize("elems,per", [(1000, 300), (1024, 256), (7, 100),
                                       (513, 1)])
def test_segment_stager_matches_a_plain_slice(elems, per):
    """Each staged segment equals the plain slice of the flattened tensor,
    and the two staging buffers are reused."""
    accelerator.select_for_devices(["cpu"])
    for dtype in (torch.float32, torch.int64, torch.uint8):
        t = (torch.arange(elems) * 3 + 7).to(dtype).reshape(-1, 1)
        flat = t.reshape(-1)
        s = SegmentStager(t, per)
        assert s.nseg == -(-elems // per)
        bufs = set()
        for i in range(s.nseg):
            got = s.get(i)
            assert isinstance(got, np.ndarray)
            bufs.add(got.__array_interface__["data"][0])
            assert torch.equal(torch.from_numpy(got.copy()),
                               flat[i * per:(i + 1) * per])
            s.release(i)
        assert len(bufs) <= 2 and s.staged == s.nseg


def test_segment_stager_waits_for_release():
    """Segment s+2 reuses segment s's buffer only after its release."""
    accelerator.select_for_devices(["cpu"])
    t = torch.arange(30, dtype=torch.float32)
    s = SegmentStager(t, 10, timeout=5)
    first = s.get(0).copy()
    s.get(1)
    done = threading.Event()

    def third():
        s.get(2)
        done.set()
    th = threading.Thread(target=third)
    th.start()
    assert not done.wait(0.3)            # buffer 0 still on the wire
    s.release(0)
    th.join(5)
    assert done.is_set() and np.array_equal(first, np.arange(10))


# -- decision rows against the reference's ------------------------------
GRID = list(itertools.product(
    (64 << 10, 1 << 20, 4 << 20, 33 << 20, 512 << 20),
    (1, 2, 4), (None, 0.1, 1.5, 12.0)))


def test_pipeline_plan_matches_reference():
    from ompi_tpu.coll import decision as jdecision
    for nbytes, rails, gbps in GRID:
        assert decision.pipeline_plan(nbytes, rails, gbps) == \
            jdecision.pipeline_plan(nbytes, rails, gbps), \
            (nbytes, rails, gbps)


def test_pipeline_and_shm_rows_match_reference():
    """The pipeline and shm rows of decision_table, with the gates off and
    on, equal the reference's."""
    from ompi_tpu.coll import decision as jdecision
    from ompi_tpu.mca import var as jvar

    def rows(mod, table):
        return {f: [r for r in rs if r[2] in ("pipelined_ring",
                                              "pipelined_chain", "shm_fold")]
                for f, rs in table.items()}

    pipeline.register_params()
    shmseg.register_params()
    from ompi_tpu.btl import shmseg as jshm
    from ompi_tpu.pml import pipeline as jpl
    jpl.register_params()
    jshm.register_params()
    before = {k: (jvar.var_get(k), jvar.var_source(k)) for k in (
        "mpi_base_shm_zerocopy", "mpi_base_pipeline_min_bytes")}
    try:
        for zc, pmin in ((False, 4 << 20), (True, 1 << 20)):
            for v in (var, jvar):
                v.var_set("mpi_base_shm_zerocopy", zc)
                v.var_set("mpi_base_pipeline_min_bytes", pmin)
            for plat in ("cpu", "gpu"):
                assert rows(decision, decision.decision_table(
                    8, False, None, plat)) == rows(
                    jdecision, jdecision.decision_table(8, False, None, plat))
            assert decision.pipeline_rules() == jdecision.pipeline_rules()
            assert decision.shm_rules() == jdecision.shm_rules()
    finally:
        for k, (val, _src) in before.items():
            jvar.var_set(k, val)
        var._reset_for_tests()


def test_host_register_counts():
    """Registration nests: a buffer stays registered until its last
    unregister (on the CPU only counted; on CUDA its pages are pinned,
    checked by chip_smoke.py's staged plan)."""
    mod = accelerator.select_for_devices(["cpu"])
    a, b = np.zeros(16, np.float32), np.zeros(4)
    mod.host_register(a)
    mod.host_register(a)
    mod.host_register(b)
    mod.host_unregister(a)
    assert mod.is_host_registered(a) and mod.is_host_registered(b)
    mod.host_unregister(a)
    mod.host_unregister(b)
    mod.host_unregister(b)               # unbalanced: a no-op
    assert not mod.is_host_registered(a)
    assert not mod.is_host_registered(b)
    t = torch.arange(6.0)
    copy = accelerator.to_host_async(t)  # the CPU's copy is done at once
    assert np.array_equal(accelerator.to_host(copy), t.numpy())
