"""Mirror of ``tests/test_analyze_multiproc.py``: the port's p40, the
lock-order witness drill, as a real 4-rank per-rank job on CPU ranks.

Under ``mpi_base_lockwitness=1`` (armed by ``Init`` before transport
bring-up) each rank runs a pt2pt ring on a worker thread, with one
payload a tensor of at least ``btl_devxfer_min_bytes`` (it rides
devxfer's shared-memory segments on CPU ranks), while the main thread
re-arms a persistent allreduce plan and the ft heartbeat detector ticks.
Every rank asserts its acquisition-order graph is acyclic and dumps it;
the port's ``tracedump --format summary`` merges the four dumps, and the
reference's tracedump beside it must give the same lockwitness section.
The reference's drill is slow-marked; the port's runs in tier-1 under
its own limit, as the port's per-rank jobs do.
"""
import glob
import json
import os

from test_torch_perrank import run_job, write_prog

P40 = """
    import threading
    from ompi_tpu_torch.analyze import lockwitness
    from ompi_tpu_torch.mca import pvar
    MPI.Init(MPI.THREAD_MULTIPLE)
    assert lockwitness.installed, "witness must be armed by Init"
    w = MPI.get_comm_world()
    n, r = w.size, w.rank()
    assert n == 4
    NMSG = 20
    errors = []
    # an app-level ordered pair both threads nest in one global order
    order_outer = threading.Lock()
    order_inner = threading.Lock()

    def pt2pt_ring():
        try:
            right, left = (r + 1) % n, (r - 1) % n
            for i in range(NMSG):
                if i == 0:   # one payload on the device payload plane
                    msg = torch.full((1 << 18,), float(r * 1000),
                                     device=w.device)
                else:
                    msg = np.full(256, r * 1000 + i, np.int64)
                with order_outer:
                    with order_inner:
                        pass
                if r % 2 == 0:
                    w.send(msg, right, tag=40)
                    data, _ = w.recv(left, tag=40)
                else:
                    data, _ = w.recv(left, tag=40)
                    w.send(msg, right, tag=40)
                first = float(data.reshape(-1)[0])
                assert first == left * 1000 + (i if i else 0), (i, first)
        except BaseException as e:   # noqa: BLE001
            errors.append(e)

    th = threading.Thread(target=pt2pt_ring)
    th.start()
    data = np.full(512, float(r + 1), np.float32)
    ref = np.asarray(w.allreduce(data, MPI.SUM))
    req = w.allreduce_init(data, MPI.SUM)
    for _ in range(10):
        req.start()
        req.wait()
    assert np.asarray(req.get()).tobytes() == ref.tobytes()
    th.join(timeout=40)
    assert not th.is_alive(), "pt2pt thread hung"
    assert not errors, errors
    assert _state["router"].xfer.stats["sent"] >= 1, \\
        _state["router"].xfer.stats
    w.barrier()
    rep = lockwitness.report()
    assert rep["installed"] and rep["sites"], "no witnessed locks"
    assert rep["edges"], "no acquisition-order edges observed"
    assert rep["cycles"] == [], rep["cycles"]
    assert pvar.pvar_read("lockwitness_max_hold_us") > 0.0
    assert pvar.pvar_read("lockwitness_edges") == len(rep["edges"])
    lockwitness.dump(os.path.join(os.environ["P40_DUMP_DIR"],
                                  f"lw_r{r}.json"), rank=r)
    MPI.Finalize()
    print(f"OK p40_lockwitness rank={r}/{n} sites={len(rep['sites'])} "
          f"edges={len(rep['edges'])}", flush=True)
    """


def test_lockwitness_drill_acyclic(tmp_path):
    rc, out, err = run_job(
        write_prog(tmp_path, "p40_lockwitness", P40), 4,
        mca=(("mpi_base_lockwitness", 1), ("mpi_base_ft_hb_period", 0.05)),
        env={"P40_DUMP_DIR": str(tmp_path)})
    assert rc == 0, f"rc={rc}\n--- out\n{out}\n--- err\n{err[-4000:]}"
    assert out.count("OK p40_lockwitness") == 4, out
    files = sorted(glob.glob(os.path.join(str(tmp_path), "lw_r*.json")))
    assert len(files) == 4, files
    from ompi_tpu.tools import tracedump as r_tracedump
    from ompi_tpu_torch.tools import tracedump
    sections = []
    for tool in (tracedump, r_tracedump):
        out_path = tmp_path / f"summary_{tool.__name__}.json"
        assert tool.main(["--format", "summary", "-o", str(out_path),
                          *files]) == 0
        sections.append(json.loads(out_path.read_text())["lockwitness"])
    lwsec = sections[0]
    assert sections[1] == lwsec
    assert lwsec["ranks"] == 4
    assert lwsec["edges"], "drill observed no lock nesting at all"
    assert lwsec["cycles"] == [], json.dumps(lwsec["cycles"], indent=1)
    assert lwsec["per_rank_cycles"] == {}
    assert lwsec["max_hold_us"] > 0.0
