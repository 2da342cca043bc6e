"""The port's parity pairs that its ``tools/checkparity`` audits.

One test per entry of the port's function lists, named as the audit
names it: every collective ``coll/compressed`` wraps against the
uncompressed world (within the int8 codec's envelope, the reference's
0.02 of the scale), every persistent plan against its one-shot blocking
call (bit for bit), the pipelined ring and chain against the unpipelined
schedules, and the in-segment shared-memory fold against the ring. The
compressed and persistent pairs run on the port's 8-rank CPU world with
the reference's world beside it on the same inputs; the pipelined and
shm-fold pairs are 2-rank per-rank jobs on CPU ranks, each under its own
limit (``run_job`` of ``test_torch_perrank.py``).
"""
import numpy as np
import pytest
import torch

import ompi_tpu_torch as P
from ompi_tpu.mca import var as jvar
from ompi_tpu_torch.mca import pvar, var
from test_torch_perrank import run_job, write_prog

N = 8
FLOOR = 64 << 10                  # compression floor for these pairs


@pytest.fixture()
def pworld():
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    yield P.get_comm_world()
    P._reset_for_tests()


@pytest.fixture()
def compress_pair(pworld, world):
    """(port comm with compression on, plain port world, JAX comm with
    compression on, plain JAX world)."""
    from ompi_tpu import compress as jcompress
    from ompi_tpu.coll import persistent as jpersistent
    jcompress._register_vars()
    saved = {k: jvar.var_get(k) for k in ("mpi_base_compress",
                                          "mpi_base_compress_min_bytes")}
    for v in (var, jvar):
        v.var_set("mpi_base_compress", True)
        v.var_set("mpi_base_compress_min_bytes", FLOOR)
    pc, jc = pworld.dup(), world.dup()
    try:
        yield pc, pworld, jc, world
    finally:
        jc.free()
        jpersistent.flush_all("explicit")
        for k, v in saved.items():
            jvar.var_set(k, v)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _compressed_pair(pair, func):
    pc, pw, jc, jw = pair
    shape = (N, N, 1 << 14) if func == "reduce_scatter_block" \
        else (N, 1 << 14)
    x = _normal(shape, seed=len(func))
    call = ((lambda c, m: c.allgather(c.put(x))) if func == "allgather"
            else (lambda c, m: getattr(c, func)(c.put(x), m.SUM)))
    b0 = pvar.pvar_read("compress_bytes_in")
    got = np.asarray(call(pc, P))
    assert pvar.pvar_read("compress_bytes_in") > b0, "codec not engaged"
    plain = np.asarray(call(pw, P))
    assert got.shape == plain.shape and got.dtype == plain.dtype
    scale = float(np.abs(plain).max())
    assert np.abs(got - plain).max() <= 0.02 * scale
    import ompi_tpu as J
    jgot = np.asarray(call(jc, J))
    assert np.abs(got - jgot).max() <= 0.02 * scale


def test_compressed_allreduce_matches_uncompressed(compress_pair):
    _compressed_pair(compress_pair, "allreduce")


def test_compressed_allgather_matches_uncompressed(compress_pair):
    _compressed_pair(compress_pair, "allgather")


def test_compressed_reduce_scatter_block_matches_uncompressed(
        compress_pair):
    _compressed_pair(compress_pair, "reduce_scatter_block")


# -- persistent plans against their one-shot calls -------------------------
def _ints(shape, seed):
    """Integer-valued float32: every combine order is exact."""
    return np.random.default_rng(seed).integers(-8, 8, size=shape) \
        .astype(np.float32)


def _plan_pair(pworld, world, mpi, shape, init, blocking, starts=3):
    x = _ints(shape, seed=sum(shape))
    want = np.asarray(blocking(pworld, pworld.put(x), P))
    req = init(pworld, pworld.put(x), P)
    for _ in range(starts):               # re-armable start/wait cycles
        req.start()
        req.wait()
    got = req.get()
    assert isinstance(got, torch.Tensor)
    assert np.asarray(got).tobytes() == want.tobytes()
    jreq = init(world, world.put(x), mpi)
    jreq.start()
    jreq.wait()
    assert np.asarray(got).tobytes() == np.asarray(jreq.get()).tobytes()


def test_persistent_allreduce_matches_unfused(pworld, world, mpi):
    _plan_pair(pworld, world, mpi, (N, 32),
               lambda c, b, m: c.allreduce_init(b, m.SUM),
               lambda c, b, m: c.allreduce(b, m.SUM))


def test_persistent_bcast_matches_unfused(pworld, world, mpi):
    _plan_pair(pworld, world, mpi, (N, 16),
               lambda c, b, m: c.bcast_init(b, 0),
               lambda c, b, m: c.bcast(b, 0))


def test_persistent_allgather_matches_unfused(pworld, world, mpi):
    _plan_pair(pworld, world, mpi, (N, 8),
               lambda c, b, m: c.allgather_init(b),
               lambda c, b, m: c.allgather(b))


def test_persistent_reduce_scatter_block_matches_unfused(pworld, world,
                                                         mpi):
    _plan_pair(pworld, world, mpi, (N, N, 4),
               lambda c, b, m: c.reduce_scatter_block_init(b, m.SUM),
               lambda c, b, m: c.reduce_scatter_block(b, m.SUM))


def test_persistent_barrier_matches_unfused(pworld, world):
    for comm in (pworld, world):
        req = comm.barrier_init()
        for _ in range(2):
            req.start()
            st = req.wait()
        assert st is not None
        assert req.test()[0]
        comm.barrier()                    # the one-shot call after it


# -- the per-rank host-tier schedules against their plain forms -------------
PAIRS = """
    from ompi_tpu_torch.core.rankcomm import counters
    from ompi_tpu_torch.mca import pvar, var
    PAIR = os.environ["PARITY_PAIR"]
    MPI.Init()
    w = MPI.get_comm_world()
    r, n = w.rank(), w.size
    var.var_set("coll_tuned_stage_min_bytes", 1 << 62)   # host tier
    elems = 1 << 20                                      # 4 MB f32
    full = np.random.default_rng(5).normal(size=(n, elems)) \\
        .astype(np.float32)
    mine = full[r].copy()
    if PAIR == "pipelined_allreduce":
        var.var_set("mpi_base_pipeline_min_bytes", 1 << 20)
        var.var_set("mpi_base_pipeline_segment_bytes", 256 << 10)
        y1 = w.allreduce(mine, MPI.SUM)
        assert counters["coll_pipelined_ring"] == 1, dict(counters)
        var.var_set("mpi_base_pipeline_enable", False)
        y0 = w.allreduce(mine, MPI.SUM)          # reduce + bcast
        assert counters["coll_pipelined_ring"] == 1
        assert np.allclose(y1, y0, rtol=1e-5, atol=1e-5), "ring != plain"
        assert np.allclose(y1, full.sum(axis=0), rtol=1e-4, atol=1e-4)
    elif PAIR == "pipelined_bcast":
        var.var_set("mpi_base_pipeline_min_bytes", 1 << 20)
        var.var_set("mpi_base_pipeline_segment_bytes", 256 << 10)
        data = full[1].copy() if r == 1 else None
        y1 = w.bcast(data, 1)
        assert counters["coll_pipelined_chain"] == 1, dict(counters)
        var.var_set("mpi_base_pipeline_enable", False)
        y0 = w.bcast(data, 1)
        assert counters["coll_pipelined_chain"] == 1
        assert y1.tobytes() == y0.tobytes() == full[1].tobytes()
    else:
        var.var_set("mpi_base_shm_zerocopy", True)
        f0 = pvar.pvar_read("btl_shm_fold_ops")
        y1 = w.allreduce(mine, MPI.SUM)
        m1 = w.allreduce(mine, MPI.MAX)
        assert pvar.pvar_read("btl_shm_fold_ops") - f0 == 2
        assert counters["coll_shm_fold"] == 2, dict(counters)
        var.var_set("mpi_base_shm_zerocopy", False)
        y0 = w.allreduce(mine, MPI.SUM)          # the ring
        m0 = w.allreduce(mine, MPI.MAX)
        assert counters["coll_shm_fold"] == 2
        assert np.allclose(y1, y0, rtol=1e-5, atol=1e-5), "fold != ring"
        assert m1.tobytes() == m0.tobytes(), "MAX fold != ring"
    MPI.Finalize()
    print(f"OK parity {PAIR} rank={r}/{n}", flush=True)
    """


def _run_pair(tmp_path, pair):
    rc, out, err = run_job(write_prog(tmp_path, "parity_pairs", PAIRS), 2,
                           env={"PARITY_PAIR": pair})
    assert rc == 0, f"rc={rc}\n--- out\n{out}\n--- err\n{err[-4000:]}"
    assert out.count(f"OK parity {pair}") == 2, out


def test_pipelined_allreduce_matches_unpipelined(tmp_path):
    _run_pair(tmp_path, "pipelined_allreduce")


def test_pipelined_bcast_matches_unpipelined(tmp_path):
    _run_pair(tmp_path, "pipelined_bcast")


def test_shmfold_allreduce_matches_ring(tmp_path):
    _run_pair(tmp_path, "shmfold_allreduce")
