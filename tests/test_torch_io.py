"""The port's MPI-IO and checkpointing (``ompi_tpu_torch/io``) against
the JAX package's: ``tests/test_io.py`` (8) and
``tests/test_io_frameworks.py`` (12, with their cases), plus a
checkpoint written and read back by each package and the bf16 round
trip.

Each body runs once per package — the port on its 8-rank CPU world, the
reference on its 8-device world — with the reference test's own
assertions, in a directory of its own, and returns what it observed (the
bytes on disk included); the two lists must agree. Where the packages
differ by design the test asserts both behaviours and says so: a stacked
checkpoint leaf comes back as a tensor on ``comm.device`` in the port
(a ``jax.Array`` on the mesh in the reference), and a bf16 leaf comes
back as a bf16 tensor in the port, where the reference returns raw
``|V2`` void bytes (a fault of the reference; the bits agree).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

import ompi_tpu as R
import ompi_tpu_torch as P
from ompi_tpu.core.datatype import FLOAT as R_FLOAT
from ompi_tpu.core.datatype import coalesce_runs as r_coalesce
from ompi_tpu.io import checkpoint as r_ckpt
from ompi_tpu.io import fbtl as r_fbtl
from ompi_tpu.io import fcoll as r_fcoll
from ompi_tpu.io import file as r_file
from ompi_tpu.io import fs as r_fs
from ompi_tpu.io import sharedfp as r_sfp
from ompi_tpu.mca import var as r_var
from ompi_tpu_torch.core.datatype import FLOAT as P_FLOAT
from ompi_tpu_torch.core.datatype import coalesce_runs as p_coalesce
from ompi_tpu_torch.io import checkpoint as p_ckpt
from ompi_tpu_torch.io import fbtl as p_fbtl
from ompi_tpu_torch.io import fcoll as p_fcoll
from ompi_tpu_torch.io import file as p_file
from ompi_tpu_torch.io import fs as p_fs
from ompi_tpu_torch.io import sharedfp as p_sfp
from ompi_tpu_torch.mca import var as p_var

N = 8


class _Pkg:
    def __init__(self, name, top, file, fbtl, fcoll, fs, sfp, var, ckpt,
                 FLOAT, coalesce):
        self.name, self.top, self.file, self.fbtl = name, top, file, fbtl
        self.fcoll, self.fs, self.sfp, self.var = fcoll, fs, sfp, var
        self.ckpt, self.FLOAT, self.coalesce = ckpt, FLOAT, coalesce


PORT = _Pkg("port", P, p_file, p_fbtl, p_fcoll, p_fs, p_sfp, p_var,
            p_ckpt, P_FLOAT, p_coalesce)
REF = _Pkg("ref", R, r_file, r_fbtl, r_fcoll, r_fs, r_sfp, r_var, r_ckpt,
           R_FLOAT, r_coalesce)


@pytest.fixture()
def pworld():
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    yield P.get_comm_world()
    P._reset_for_tests()


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _agree(body, world, pworld, tmp_path):
    """``body(pkg, comm, dir)`` through both packages, each in its own
    directory; every observed value agrees."""
    out = []
    for pkg, comm in ((PORT, pworld), (REF, world)):
        d = tmp_path / pkg.name
        d.mkdir()
        out.append(body(pkg, comm, d))
    got, want = out
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, (bytes, str)):
            assert a == b
            continue
        a, b = _host(a), _host(b)
        assert a.shape == b.shape, (a, b)
        np.testing.assert_array_equal(a, b.astype(a.dtype))
    return got


@pytest.fixture()
def _vars(world, pworld):
    """Set an MCA var in both packages; every value comes back after."""
    saved = []

    def set_(name, value):
        for v in (p_var, r_var):
            saved.append((v, name, v.var_get(name)))
            v.var_set(name, value)

    yield set_
    for v, name, value in reversed(saved):
        v.var_set(name, value)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# -- tests/test_io.py ---------------------------------------------------------
def test_write_read_at(world, pworld, tmp_path):
    def body(pkg, comm, d):
        with pkg.file.File.open(comm, str(d / "a.bin")) as f:
            f.etype = np.dtype(np.float32)
            f.write_at(0, np.arange(8, dtype=np.float32))
            f.write_at(10, np.asarray([9.0], np.float32))
            out = [f.read_at(0, 8), f.read_at(10, 1), f.get_size()]
            np.testing.assert_array_equal(out[0], np.arange(8))
            assert out[1][0] == 9.0 and out[2] == 11
        return out + [_bytes(d / "a.bin")]
    _agree(body, world, pworld, tmp_path)


def test_collective_write_read(world, pworld, tmp_path):
    def body(pkg, comm, d):
        n = comm.size
        with pkg.file.File.open(comm, str(d / "c.bin")) as f:
            f.etype = np.dtype(np.float32)
            x = comm.stack([np.full(4, r, np.float32) for r in range(n)])
            f.write_at_all(0, x)           # device buffer straight to file
            back = f.read_at_all(0, 4)
            for r in range(n):
                np.testing.assert_array_equal(back[r], np.full(4, r))
        return [back, _bytes(d / "c.bin")]
    got = _agree(body, world, pworld, tmp_path)
    assert isinstance(got[0], np.ndarray)          # reads are host numpy


def test_file_view_strided(world, pworld, tmp_path):
    """A vector filetype view: writes land only on selected elements."""
    def body(pkg, comm, d):
        t = pkg.FLOAT.create_vector(2, 1, 2).create_resized(0, 4).commit()
        with pkg.file.File.open(comm, str(d / "v.bin")) as f:
            f.etype = np.dtype(np.float32)
            f.write_at(0, np.zeros(8, np.float32))   # preallocate plain
            f.set_view(0, np.float32, t)
            f.write_at(0, np.asarray([1.0, 2.0, 3.0, 4.0], np.float32))
            f.set_view(0, np.float32, None)
            out = [f.read_at(0, 8)]
            np.testing.assert_array_equal(out[0], [1, 0, 2, 0, 3, 0, 4, 0])
            f.set_view(0, pkg.FLOAT, t)          # etype as a Datatype
            out.append(f.read_at(0, 4))
            np.testing.assert_array_equal(out[-1], [1, 2, 3, 4])
            out.append(f.read_at(1, 2))          # unaligned view offset
            np.testing.assert_array_equal(out[-1], [2, 3])
            assert f.get_view()[1] == np.dtype(np.float32)
        return out
    _agree(body, world, pworld, tmp_path)


def test_shared_pointer(world, pworld, tmp_path):
    def body(pkg, comm, d):
        with pkg.file.File.open(comm, str(d / "s.bin")) as f:
            f.etype = np.dtype(np.float32)
            f.write_shared(np.asarray([1.0, 2.0], np.float32))
            f.write_shared(np.asarray([3.0], np.float32))
            out = [f.get_position_shared()]
            assert out[0] == 3
            f.seek_shared(0)
            out.append(f.read_shared(3))
            np.testing.assert_array_equal(out[-1], [1, 2, 3])
        return out
    _agree(body, world, pworld, tmp_path)


def test_nonblocking_io(world, pworld, tmp_path):
    def body(pkg, comm, d):
        with pkg.file.File.open(comm, str(d / "nb.bin")) as f:
            f.etype = np.dtype(np.float32)
            req = f.iwrite_at(0, np.arange(4, dtype=np.float32))
            req.wait()
            req2 = f.iread_at(0, 4)
            out = [req2.get()]
            np.testing.assert_array_equal(out[0], np.arange(4))
            x = comm.stack([np.full(2, r, np.float32)
                            for r in range(comm.size)])
            f.iwrite_at_all(4, x).wait()
            out.append(f.iread_at_all(4, 2).get())
        return out
    _agree(body, world, pworld, tmp_path)
    f = p_file.File.open(pworld, str(tmp_path / "req.bin"))
    assert isinstance(f.iread_at(0, 1), P.Request)
    f.close()


def test_checkpoint_roundtrip(world, pworld, tmp_path):
    def body(pkg, comm, d):
        state = {
            "step": np.int64(7),
            "buf": comm.stack([np.full(3, r, np.float32)
                               for r in range(comm.size)]),
            "nested": {"w": np.eye(2, dtype=np.float32)},
        }
        path = str(d / "ckpt")
        pkg.ckpt.save(path, state, step=7)
        assert pkg.ckpt.latest_step(path) == 7
        like = {"step": np.int64(0),
                "buf": comm.alloc((3,), np.float32),
                "nested": {"w": np.zeros((2, 2), np.float32)}}
        restored = pkg.ckpt.restore(path, like, comm=comm)
        assert int(restored["step"]) == 7
        np.testing.assert_array_equal(_host(restored["buf"])[1],
                                      np.full(3, 1.0))
        np.testing.assert_array_equal(restored["nested"]["w"], np.eye(2))
        return [restored["step"], _host(restored["buf"]),
                restored["nested"]["w"], _bytes(d / "ckpt" / "leaves.npz")]
    _agree(body, world, pworld, tmp_path)
    # re-placed on the comm's device: a jax.Array on the reference's
    # mesh, a tensor on the port's device (the difference by design)
    path = str(tmp_path / "p2")
    p_ckpt.save(path, {"buf": pworld.alloc((3,), fill=2.0)}, step=1)
    got = p_ckpt.restore(path, {"buf": np.zeros((N, 3), np.float32)},
                         comm=pworld)
    assert isinstance(got["buf"], torch.Tensor)
    assert got["buf"].device == pworld.device


def test_checkpoint_ulfm_resume_flow(world, pworld, tmp_path):
    """The documented recovery story: checkpoint, revoke, shrink,
    restore onto the surviving communicator."""
    def body(pkg, comm, d):
        path = str(d / "ck2")
        buf = comm.stack([np.full(2, r, np.float32)
                          for r in range(comm.size)])
        pkg.ckpt.save(path, {"buf": buf}, step=1)
        dup = comm.dup()
        dup.revoke()
        survivors = dup.shrink([comm.size - 1])
        # stacked shape no longer matches the shrunken world: restore
        # leaves the leaf on host and the application re-shards
        full = pkg.ckpt.restore(path, {"buf": np.zeros((comm.size, 2),
                                                       np.float32)},
                                comm=survivors)
        assert isinstance(full["buf"], np.ndarray)    # not auto-placed
        resharded = survivors.stack(list(np.asarray(full["buf"])[:-1]))
        np.testing.assert_array_equal(_host(resharded)[0], [0, 0])
        return [full["buf"], _host(resharded)]
    _agree(body, world, pworld, tmp_path)


def test_checkpoint_crash_safe_fallback(world, pworld, tmp_path):
    """A crash between parking the old checkpoint and publishing the new
    one must not lose everything: restore falls back to .old."""
    def body(pkg, comm, d):
        path = str(d / "cs")
        pkg.ckpt.save(path, {"v": np.asarray([1.0])}, step=1)
        pkg.ckpt.save(path, {"v": np.asarray([2.0])}, step=2)
        out = [pkg.ckpt.restore(path, {"v": np.zeros(1)})["v"]]
        assert out[0][0] == 2.0
        # simulate the crash window: new checkpoint gone, .old parked
        shutil.copytree(path, path + ".old")
        shutil.rmtree(path)
        out.append(pkg.ckpt.restore(path, {"v": np.zeros(1)})["v"])
        assert out[-1][0] == 2.0
        return out
    _agree(body, world, pworld, tmp_path)


# -- tests/test_io_frameworks.py ----------------------------------------------
def test_fs_selects_ufs_for_plain_paths(world, pworld, tmp_path):
    def body(pkg, comm, d):
        m = pkg.fs.select_fs(str(d / "f.bin"))
        assert m.name == "ufs"
        fstype = pkg.fs._mount_fstype(str(d))
        assert isinstance(fstype, str)
        return [m.name, fstype]
    _agree(body, world, pworld, tmp_path)


def test_fs_parallel_component_claims_its_type(world, pworld, tmp_path):
    def body(pkg, comm, d):
        out = []
        for c in (pkg.fs.LustreComponent(), pkg.fs.GpfsComponent()):
            fst = c.fstypes[0]
            out += [c.file_query("/mnt/lfs/x", fst)[0],
                    c.file_query("/home/x", "ext4") is None]
        assert out == [50, True, 50, True]
        return out
    _agree(body, world, pworld, tmp_path)


def test_fs_include_list(world, pworld, tmp_path, _vars):
    """``fs_base_include`` that excludes every component still opens the
    file with the generic module."""
    def body(pkg, comm, d):
        return [pkg.fs.select_fs(str(d / "g.bin")).name]
    _agree(body, world, pworld, tmp_path)
    _vars("fs_base_include", "lustre")
    for pkg in (PORT, REF):
        assert pkg.fs.select_fs(str(tmp_path / "g.bin")).name == "ufs"


def test_fbtl_runs_roundtrip(world, pworld, tmp_path):
    def body(pkg, comm, d):
        fd = os.open(str(d / "b.bin"), os.O_RDWR | os.O_CREAT)
        fbtl = pkg.fbtl.PosixFbtl()
        runs = [(0, 4), (4, 4), (8, 4)]
        data = np.arange(3, dtype=np.int32).tobytes()
        out = [fbtl.pwritev_runs(fd, runs, data)]
        assert out[0] == 12
        back = fbtl.preadv_runs(fd, [(0, 12)])
        assert np.frombuffer(back, np.int32).tolist() == [0, 1, 2]
        # disjoint runs with a hole
        fbtl.pwritev_runs(fd, [(20, 4), (28, 4)],
                          np.array([7, 8], np.int32).tobytes())
        got = np.frombuffer(fbtl.preadv_runs(fd, [(20, 4), (28, 4)]),
                            np.int32)
        assert got.tolist() == [7, 8]
        tail = fbtl.preadv_runs(fd, [(100, 8)])   # short read zero-fills
        assert tail == b"\0" * 8
        os.close(fd)
        return out + [back, tail, _bytes(d / "b.bin")]
    _agree(body, world, pworld, tmp_path)


def _per_rank_interleaved(n, block):
    """Rank r owns elements r, r+n, r+2n, ... (round-robin interleave —
    the access pattern two-phase IO exists for)."""
    per = []
    for r in range(n):
        offs = np.arange(block) * n + r
        data = np.full(block, 100 + r, np.int32)
        per.append((offs, data))
    return per


@pytest.mark.parametrize("cls", ["IndividualFcoll", "TwoPhaseFcoll",
                                 "VulcanFcoll"])
@pytest.mark.parametrize("layout", ["interleaved", "contiguous"])
def test_fcoll_components_agree(world, pworld, tmp_path, cls, layout):
    n, block = 4, 8

    def body(pkg, comm, d):
        fd = os.open(str(d / f"{cls}.bin"), os.O_RDWR | os.O_CREAT)
        fc = getattr(pkg.fcoll, cls)(pkg.fbtl.PosixFbtl())
        per = _per_rank_interleaved(n, block)
        if layout == "contiguous":
            per = [(np.arange(block) + r * block, dat)
                   for r, (_o, dat) in enumerate(per)]
        out = [fc.write(fd, per, 4)]
        assert out[0] == n * block
        arr = np.frombuffer(os.pread(fd, n * block * 4, 0), np.int32)
        expect = (np.tile(100 + np.arange(n), block)
                  if layout == "interleaved"
                  else np.repeat(100 + np.arange(n), block))
        assert arr.tolist() == expect.tolist()
        got = fc.read(fd, [o for o, _d in per], np.dtype(np.int32))
        for r in range(n):
            assert got[r].tolist() == [100 + r] * block
        os.close(fd)
        return out + [arr] + got
    _agree(body, world, pworld, tmp_path)


def test_two_phase_coalesces_across_ranks(world, pworld, tmp_path):
    """The interleaved pattern coalesces to ONE contiguous run across
    ranks — the aggregation individual IO can't do."""
    def body(pkg, comm, d):
        per = _per_rank_interleaved(4, 8)
        tp = pkg.fcoll.TwoPhaseFcoll(pkg.fbtl.PosixFbtl())
        offs, data = tp._merge(per)
        starts, lens = pkg.coalesce(offs)
        assert len(starts) == 1 and int(lens[0]) == 32
        assert data.tolist() == np.tile(100 + np.arange(4), 8).tolist()
        return [offs, data, starts, lens]
    _agree(body, world, pworld, tmp_path)


def test_vulcan_domains_split_evenly(world, pworld, tmp_path):
    def body(pkg, comm, d):
        tp = pkg.fcoll.TwoPhaseFcoll(pkg.fbtl.PosixFbtl(), n_aggregators=4)
        starts = np.arange(0, 80, 10)
        lens = np.full(8, 5)
        doms = tp._domains(starts, lens)
        assert len(doms) == 4
        assert sum(s.stop - s.start for s in doms) == 8
        return [[(s.start, s.stop) for s in doms]]
    _agree(body, world, pworld, tmp_path)


def test_fcoll_selection_var(world, pworld, tmp_path, _vars):
    _vars("io_base_fcoll", "vulcan")
    for pkg in (PORT, REF):
        got = pkg.fcoll.select_fcoll(pkg.fbtl.PosixFbtl())
        assert isinstance(got, pkg.fcoll.VulcanFcoll) and got.n_agg == 4
    _vars("io_base_fcoll", "individual")
    for pkg in (PORT, REF):
        assert isinstance(pkg.fcoll.select_fcoll(pkg.fbtl.PosixFbtl()),
                          pkg.fcoll.IndividualFcoll)
    _vars("io_base_fcoll", "dynamic")
    _vars("io_vulcan_aggregators", 2)
    for pkg in (PORT, REF):
        assert pkg.fcoll.VulcanFcoll(pkg.fbtl.PosixFbtl()).n_agg == 2


def test_file_collective_write_with_interleaved_view(world, pworld,
                                                    tmp_path):
    """End to end: the two-phase fcoll writes the stacked blocks as
    coalesced runs; read_at_all round-trips."""
    def body(pkg, comm, d):
        n = comm.size
        path = str(d / "view.bin")
        with pkg.file.File(comm, path, etype=np.int32) as f:
            f.set_view(0, np.int32)
            data = comm.stack([np.full(6, r, np.int32) for r in range(n)])
            out = [f.write_at_all(0, data)]
            assert out[0] == 6 * n
            back = f.read_at_all(0, 6)
            for r in range(n):
                assert back[r].tolist() == [r] * 6
        return out + [back, _bytes(path)]
    _agree(body, world, pworld, tmp_path)


def test_sharedfp_sm(world, pworld, tmp_path):
    def body(pkg, comm, d):
        p = pkg.sfp.SmSharedfp("x")
        out = [p.fetch_add(10), p.fetch_add(5)]
        assert out == [0, 10]
        p.seek(100)
        out.append(p.get())
        assert out[-1] == 100
        p.close()
        return out
    _agree(body, world, pworld, tmp_path)


def test_sharedfp_lockedfile_shared_across_handles(world, pworld,
                                                   tmp_path):
    def body(pkg, comm, d):
        path = str(d / "lf.bin")
        a = pkg.sfp.LockedFileSharedfp(path)
        b = pkg.sfp.LockedFileSharedfp(path)
        out = [a.fetch_add(8), b.fetch_add(4), a.get()]
        assert out == [0, 8, 12]       # b observes a's advance via the fs
        b.seek(3)
        out.append(a.get())
        a.close()
        b.close()
        assert not os.path.exists(path + ".sharedfp")
        return out
    _agree(body, world, pworld, tmp_path)


def test_sharedfp_lockedfile_through_file(world, pworld, tmp_path, _vars):
    _vars("io_base_sharedfp", "lockedfile")

    def body(pkg, comm, d):
        with pkg.file.File(comm, str(d / "lk.bin"), etype=np.int32) as f:
            assert f.sharedfp.name == "lockedfile"
            f.write_shared(np.array([4, 5], np.int32))
            f.write_ordered(comm.stack([np.full(1, r, np.int32)
                                        for r in range(comm.size)]))
            out = [f.get_position_shared(), f.read_at(0, 2 + comm.size)]
        return out
    _agree(body, world, pworld, tmp_path)


def test_sharedfp_individual_orders_at_sync(world, pworld, tmp_path,
                                            _vars):
    _vars("io_base_sharedfp", "individual")

    def body(pkg, comm, d):
        path = str(d / "ind.bin")
        with pkg.file.File(comm, path, etype=np.int32) as f:
            f.write_shared(np.array([1, 1], np.int32))
            f.write_shared(np.array([2, 2, 2], np.int32))
            # nothing on disk until sync; pointer undefined mid-stream
            with pytest.raises(RuntimeError):
                f.sharedfp.fetch_add(1)
            f.sync()
            out = [f.read_at(0, 5), f.get_position_shared()]
            assert out[0].tolist() == [1, 1, 2, 2, 2] and out[1] == 5
        return out
    _agree(body, world, pworld, tmp_path)


def test_write_read_ordered(world, pworld, tmp_path):
    def body(pkg, comm, d):
        n = comm.size
        path = str(d / "ord.bin")
        with pkg.file.File(comm, path, etype=np.int32) as f:
            data = comm.stack([np.full(3, r, np.int32) for r in range(n)])
            out = [f.write_ordered(data), f.get_position_shared()]
            assert out == [3 * n, 3 * n]
            f.seek_shared(0)
            back = f.read_ordered(3)
            for r in range(n):
                assert back[r].tolist() == [r] * 3
            out += [back, f.get_position_shared()]
            assert out[-1] == 3 * n
        return out
    _agree(body, world, pworld, tmp_path)


# -- the port's tensors through the file and the checkpoint -----------------
def test_tensor_writes_equal_numpy_writes(pworld, tmp_path):
    """A tensor handed to every write entry puts the bytes a numpy array
    would (``to_host``: one copy per call), bf16 and views included."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((N, 5)).astype(np.float32)
    paths = []
    for origin in (np.asarray, torch.from_numpy):
        path = str(tmp_path / f"t{len(paths)}.bin")
        with p_file.File(pworld, path, etype=np.float32) as f:
            f.write_at(0, origin(x[0]))
            f.write_at_all(5, pworld.stack([origin(r) for r in x]))
            f.write_shared(origin(x[1]))
            f.write_ordered(pworld.stack([origin(r) for r in x]))
            f.write_at(200, origin(x)[:, 2])       # a strided view
        paths.append(path)
    assert _bytes(paths[0]) == _bytes(paths[1])
    with p_file.File(pworld, str(tmp_path / "bf.bin"),
                     etype=torch.float32) as f:
        t = torch.from_numpy(x[0]).bfloat16()
        f.write_at(0, t)
        np.testing.assert_array_equal(f.read_at(0, 5), t.float().numpy())


@pytest.mark.parametrize("same_pkg", ["port", "ref"])
def test_checkpoint_written_and_read_by_each_package(world, pworld,
                                                     tmp_path, same_pkg):
    """A nested state with lists, tuples, ints, floats, a stacked buffer
    and a 2-D matrix: saved and restored by the same package, every leaf
    back bit for bit."""
    pkg, comm = (PORT, pworld) if same_pkg == "port" else (REF, world)
    rng = np.random.default_rng(5)
    stacked = rng.standard_normal((N, 6)).astype(np.float32)
    mat = rng.standard_normal((3, 4))
    state = {"a": [np.int32(3), mat], "b": (np.float32(1.5),
                                            {"z": comm.stack(list(stacked))}),
             "c": np.arange(5, dtype=np.int64)}
    like = {"a": [np.int32(0), np.zeros((3, 4))],
            "b": (np.float32(0), {"z": comm.alloc((6,), np.float32)}),
            "c": np.zeros(5, np.int64)}
    path = str(tmp_path / "nest")
    pkg.ckpt.save(path, state, step=12)
    got = pkg.ckpt.restore(path, like, comm=comm)
    assert pkg.ckpt.latest_step(path) == 12
    assert int(got["a"][0]) == 3 and float(got["b"][0]) == 1.5
    np.testing.assert_array_equal(got["a"][1], mat)
    np.testing.assert_array_equal(_host(got["b"][1]["z"]), stacked)
    np.testing.assert_array_equal(got["c"], np.arange(5))
    assert isinstance(got["b"], tuple) and isinstance(got["a"], list)


def test_checkpoint_bf16_bits_against_reference(world, pworld, tmp_path):
    """A bf16 leaf: the port saves its 16-bit pattern and restores a
    bf16 tensor bit for bit; the reference restores raw ``|V2`` void
    bytes (its fault, recorded in ROADMAP queue C) whose bits are the
    same."""
    import jax.numpy as jnp
    x = np.random.default_rng(3).standard_normal((N, 33)).astype(np.float32)
    pt = torch.from_numpy(x).bfloat16()
    p_ckpt.save(str(tmp_path / "p"), {"w": pt, "s": pworld.put(pt)}, step=3)
    r_ckpt.save(str(tmp_path / "r"), {"w": jnp.asarray(x, jnp.bfloat16)},
                step=3)
    pgot = p_ckpt.restore(str(tmp_path / "p"),
                          {"w": torch.zeros(1), "s": torch.zeros(1)},
                          comm=pworld)
    rgot = r_ckpt.restore(str(tmp_path / "r"), {"w": np.zeros(1)})
    assert pgot["w"].dtype == torch.bfloat16
    assert torch.equal(pgot["w"].view(torch.int16), pt.view(torch.int16))
    assert pgot["s"].device == pworld.device          # stacked: placed
    assert rgot["w"].dtype.str == "|V2"               # the fault
    np.testing.assert_array_equal(
        pgot["w"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(rgot["w"]).view(np.uint16))
    with open(tmp_path / "p" / "meta.json") as f:
        assert json.load(f)["dtypes"] == ["bfloat16"] * 2


def test_checkpoint_leaf_count_mismatch_raises(pworld, tmp_path):
    p_ckpt.save(str(tmp_path / "m"), {"a": np.ones(2), "b": np.ones(1)})
    with pytest.raises(P.MPIError):
        p_ckpt.restore(str(tmp_path / "m"), {"a": np.zeros(2)})
