"""The port's native host library (``ompi_tpu_torch/native``) against the
JAX package's (``tests/test_native.py``, ``test_native_containers.py``
and ``test_native_runtime.py``).

Both packages compile the same ``native/*.cpp``: the reference into
``native/``, the port into ``ompi_tpu_torch/_build/``. Each case feeds
both the same seeded numpy inputs and requires the same bytes — every
reduce kernel over every dtype and op (NaNs included), pack and unpack,
matching order with the native core on and off, and the containers'
observable sequences (the thread-stress cases run on the port). The
port's own additions: CUDA-like and bf16/f16 tensors are refused without
a call into the library, the call sites (convertor, reduce_local, the
per-rank host fold, coll/basic) take the native route and agree with
their numpy routes bit for bit, the two switches work, and a build adds
no file to ``native/``. ``test_shmem_malloc_free_reuses_space`` waits
for the port's ``shmem``.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import pytest
import torch

import ompi_tpu.native as r_native
from ompi_tpu.core import convertor as r_conv
from ompi_tpu.core import datatype as r_dt
from ompi_tpu.core import op as r_op
from ompi_tpu.native import containers as RC
from ompi_tpu.pml import stacked as r_stacked
import ompi_tpu_torch.native as p_native
from ompi_tpu_torch.coll import basic as p_basic
from ompi_tpu_torch.core import convertor as p_conv
from ompi_tpu_torch.core import datatype as p_dt
from ompi_tpu_torch.core import op as p_op
from ompi_tpu_torch.core import rankcomm as p_rankcomm
from ompi_tpu_torch.core.errhandler import MPIError
from ompi_tpu_torch.native import containers as PC
from ompi_tpu_torch.native import loader as p_loader
from ompi_tpu_torch.pml import stacked as p_stacked

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OPS = ("sum", "prod", "max", "min", "band", "bor", "bxor", "land", "lor",
       "lxor")
DTYPES = (np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
          np.uint32, np.uint64, np.float32, np.float64)


def _operands(rng, dtype, n=257):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        a = rng.standard_normal(n).astype(dtype)
        b = rng.standard_normal(n).astype(dtype)
        a[::7] = np.nan                  # NaN in either operand
        b[3::11] = np.nan
        a[5], b[5] = 0.0, -0.0
        return a, b
    info = np.iinfo(dtype)
    a = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    b = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    a[::9] = 0
    return a, b


# -- build -----------------------------------------------------------------
def test_native_builds_into_the_port_build_dir():
    assert p_native.native_available(), p_native.build_error()
    assert p_native.build_error() == ""
    path = p_loader.lib_path()
    assert path.parent == p_loader.BUILD_DIR and path.exists()
    assert p_loader.ABI == 3
    assert p_native.get_lib().ompi_tpu_native_abi() == 3


def test_native_build_adds_no_file_to_native_dir(tmp_path, monkeypatch):
    """A fresh build of the port's library writes only its build dir:
    ``native/`` (the reference's cache) gains nothing."""
    before = set(os.listdir(p_loader.NATIVE_DIR))
    monkeypatch.setattr(p_loader, "BUILD_DIR", tmp_path / "_build")
    p_loader._reset_for_tests()
    try:
        lib = p_loader.get_lib()
        assert lib is not None, p_loader.build_error()
        assert p_loader.build_seconds() > 0
        built = os.listdir(tmp_path / "_build")
        assert built == [p_loader.lib_path().name], built
    finally:
        p_loader._reset_for_tests()
    after = set(os.listdir(p_loader.NATIVE_DIR))
    ours = {n for n in after - before if "." in n and not n.startswith(
        ("libompi_tpu_native.so", "libtpumpi.so"))}
    assert not ours, ours


def test_native_switch_off_and_build_failure_visible(monkeypatch, tmp_path):
    monkeypatch.setenv("OMPI_TPU_TORCH_DISABLE_NATIVE", "1")
    p_loader._reset_for_tests()
    try:
        assert not p_native.native_available()
        assert "OMPI_TPU_TORCH_DISABLE_NATIVE" in p_native.build_error()
        a = np.ones(3, np.float32)
        assert p_native.native_reduce_local("sum", a, a) is None
    finally:
        p_loader._reset_for_tests()
    monkeypatch.delenv("OMPI_TPU_TORCH_DISABLE_NATIVE")
    # a compiler failure keeps g++'s stderr
    bad = tmp_path / "bad.cpp"
    bad.write_text("int ompi_tpu_native_abi(void) { return nope; }\n")
    monkeypatch.setattr(p_loader, "SOURCES", (bad,))
    monkeypatch.setattr(p_loader, "BUILD_DIR", tmp_path / "_build")
    p_loader._reset_for_tests()
    try:
        assert p_loader.get_lib() is None
        assert "g++ exit" in p_loader.build_error()
        assert "nope" in p_loader.build_error()
    finally:
        p_loader._reset_for_tests()


# -- ops.cpp: every (op, dtype), NaNs included -------------------------------
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("opname", OPS)
def test_reduce_kernel_same_bytes_as_reference(opname, dtype):
    a, b = _operands(np.random.default_rng(OPS.index(opname)), dtype)
    got = p_native.native_reduce_local(opname, a, b)
    want = r_native.native_reduce_local(opname, a, b)
    if want is None:                     # bitwise on float: both decline
        assert got is None
        return
    assert got is not None and got.dtype == a.dtype
    assert got.tobytes() == want.tobytes()
    # the same kernel on CPU tensors
    t = p_native.native_reduce_local(opname, torch.from_numpy(a),
                                     torch.from_numpy(b))
    assert t.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("opname,ref", [
    ("sum", np.add), ("prod", np.multiply),
    ("max", np.maximum), ("min", np.minimum),
])
@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.int64, np.uint16,
                                   np.float32, np.float64])
def test_reduce_kernels_arith(rng, opname, ref, dtype):
    if np.issubdtype(dtype, np.integer):
        a = rng.integers(1, 5, 33).astype(dtype)
        b = rng.integers(1, 5, 33).astype(dtype)
    else:
        a = rng.standard_normal(33).astype(dtype)
        b = rng.standard_normal(33).astype(dtype)
    out = p_native.native_reduce_local(opname, a, b)
    assert out is not None and out.dtype == a.dtype
    np.testing.assert_array_equal(out, ref(a, b))


@pytest.mark.parametrize("opname,ref", [
    ("band", np.bitwise_and), ("bor", np.bitwise_or),
    ("bxor", np.bitwise_xor),
])
def test_reduce_kernels_bitwise(rng, opname, ref):
    a = rng.integers(0, 255, 64).astype(np.uint8)
    b = rng.integers(0, 255, 64).astype(np.uint8)
    np.testing.assert_array_equal(p_native.native_reduce_local(opname, a, b),
                                  ref(a, b))
    assert p_native.native_reduce_local(
        opname, np.ones(3, np.float32), np.ones(3, np.float32)) is None


def test_reduce_kernels_logical(rng):
    a = rng.integers(0, 2, 40).astype(np.int32)
    b = rng.integers(0, 2, 40).astype(np.int32)
    np.testing.assert_array_equal(p_native.native_reduce_local("land", a, b),
                                  a.astype(bool) & b.astype(bool))
    np.testing.assert_array_equal(
        p_native.native_reduce_local("lxor", a, b),
        (a.astype(bool) ^ b.astype(bool)).astype(np.int32))


def test_reduce_into_is_in_place_and_leaves_inbuf(rng):
    a, b = _operands(rng, np.int32)
    a0, b0 = a.copy(), b.copy()
    assert p_native.native_reduce_into("bxor", a, b)
    np.testing.assert_array_equal(a, a0)
    np.testing.assert_array_equal(b, a0 ^ b0)


class _Counting:
    """Wraps the library's reduce symbol to count calls into it."""

    def __init__(self, lib):
        self.lib = lib
        self.calls = 0

    def __getattr__(self, name):
        f = getattr(self.lib, name)
        if name != "ompi_tpu_reduce_local":
            return f

        def wrapped(*args):
            self.calls += 1
            return f(*args)
        return wrapped


@pytest.fixture()
def counted(monkeypatch):
    """The port's library with its reduce calls counted."""
    c = _Counting(p_native.get_lib())
    monkeypatch.setattr(p_native, "get_lib", lambda: c)
    return c


def test_device_and_half_tensors_refused_without_a_call(counted):
    """A CUDA pointer handed to host C++ is a segfault, not an error: a
    tensor off the CPU (``meta`` stands in for the card here), bf16 and
    f16, a non-contiguous or grad-tracking ``inout`` and a mixed pair
    are all declined before the library is called."""
    f32 = torch.ones(8)
    cases = [
        (torch.empty(8, device="meta"), torch.empty(8, device="meta")),
        (f32, torch.empty(8, device="meta")),
        (torch.ones(8, dtype=torch.bfloat16),
         torch.ones(8, dtype=torch.bfloat16)),
        (torch.ones(8, dtype=torch.float16),
         torch.ones(8, dtype=torch.float16)),
        (f32, np.ones(8, np.float32)),
        (np.ones(8, np.float32), np.ones(8, np.float64)),
    ]
    for a, b in cases:
        assert p_native.native_reduce_into("sum", a, b) is False
        assert p_native.native_reduce_local("sum", a, b) is None
    # in place needs a contiguous, grad-free inout; the functional form
    # reduces into its own contiguous copy, as the reference's does
    pairs = ((torch.ones(4, 4), torch.ones(4, 4).t()),
             (f32, torch.ones(8, requires_grad=True)))
    for a, b in pairs:
        assert p_native.native_reduce_into("sum", a, b) is False
    assert counted.calls == 0
    for a, b in pairs:
        out = p_native.native_reduce_local("sum", a, b)
        assert torch.equal(out, (a + b).detach())
    assert counted.calls == 2
    assert p_native.native_reduce_into("sum", f32, torch.ones(8))
    assert counted.calls == 3


# -- the call sites ------------------------------------------------------------
def _no_native(monkeypatch):
    monkeypatch.setattr(p_native, "get_lib", lambda: None)


@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.uint32,
                                   np.uint64])
def test_reduce_local_native_matches_reference_and_fallback(
        rng, monkeypatch, counted, dtype):
    a, b = _operands(rng, dtype)
    for name in ("SUM", "MAX", "MIN", "PROD", "LOR"):
        native = p_op.reduce_local(a, b, getattr(p_op, name))
        assert native.tobytes() == np.asarray(
            r_op.reduce_local(a, b, getattr(r_op, name))).tobytes()
        if name in ("SUM", "PROD"):
            # a NaN-free pair: numpy's route must give the same bits
            # (the NaN payloads of numpy and C++ may differ)
            x, y = np.nan_to_num(a), np.nan_to_num(b)
            assert (p_op.reduce_local(x, y, p_op.SUM).tobytes()
                    == np.add(x, y).tobytes())
    assert counted.calls == 5 + 2
    _no_native(monkeypatch)
    x, y = _operands(np.random.default_rng(5), dtype)
    keep = ~(np.isnan(x) | np.isnan(y) | (x == 0) | (y == 0))
    x, y = x[keep], y[keep]            # no NaN payloads, no signed zeros
    for name in ("MAX", "MIN", "SUM"):
        fb = p_op.reduce_local(x, y, getattr(p_op, name))
        nat = r_native.native_reduce_local(name.lower(), x, y)
        assert fb.tobytes() == nat.tobytes()


def test_rankcomm_host_fold_takes_native(rng, counted, monkeypatch):
    """The per-rank host fold (``rankcomm._apply``): SUM/MAX on numpy
    rows, bit for bit against the numpy route."""
    a = rng.standard_normal(4096).astype(np.float32)
    b = rng.standard_normal(4096).astype(np.float32)
    got = [p_rankcomm._apply(op, a, b) for op in (p_op.SUM, p_op.MAX)]
    assert counted.calls == 2
    _no_native(monkeypatch)
    want = [p_rankcomm._apply(op, a, b) for op in (p_op.SUM, p_op.MAX)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    # scalars and tensors keep their routes
    assert p_rankcomm._apply(p_op.SUM, 2, 3) == 5


@pytest.mark.parametrize("opname", ["BAND", "BXOR", "LAND", "BOR", "LOR",
                                    "LXOR"])
def test_basic_fold_takes_native(rng, counted, monkeypatch, opname):
    """coll/basic's fold runs the in-place native loop for the remaining
    predefined commutative ops; sum/prod/max/min stay numpy."""
    x = rng.integers(-50, 50, (8, 513)).astype(np.int32)
    op = getattr(p_op, opname)
    got = p_basic._np_fold(op, x)
    assert counted.calls == 7
    p_basic._np_fold(p_op.SUM, x)
    assert counted.calls == 7
    ref = np.asarray(__import__("ompi_tpu.coll.basic", fromlist=["_np_fold"])
                     ._np_fold(getattr(r_op, opname), x))
    assert got.tobytes() == ref.tobytes()
    _no_native(monkeypatch)
    assert p_basic._np_fold(op, x).tobytes() == got.tobytes()


# -- convertor.cpp --------------------------------------------------------------
def _types(mod):
    return {
        "vector": lambda: mod.FLOAT.create_vector(4, 3, 5),
        "indexed": lambda: mod.FLOAT.create_indexed([2, 1, 4], [0, 3, 6]),
        "int8 vector": lambda: mod.INT8_T.create_vector(3, 2, 4),
        "resized": lambda: mod.FLOAT.create_vector(2, 2, 3)
        .create_resized(0, 9),
        "overlapping": lambda: mod.FLOAT.create_indexed([3, 3], [0, 1]),
        "double subarray": lambda: mod.DOUBLE.create_subarray(
            [6, 8], [3, 4], [2, 1]),
        "indexed block": lambda: mod.FLOAT.create_indexed_block(2, [7, 1, 4]),
    }


@pytest.mark.parametrize("name", list(_types(p_dt)))
def test_native_pack_unpack_matches_reference(rng, monkeypatch, name):
    pt = _types(p_dt)[name]().commit()
    rt = _types(r_dt)[name]().commit()
    count, rows = 3, 4
    np_dt = np.int8 if "int8" in name else (
        np.float64 if "double" in name else np.float32)
    width = count * pt.extent
    buf = (rng.integers(-100, 100, (rows, width)) if np_dt == np.int8
           else rng.standard_normal((rows, width))).astype(np_dt)
    idx = pt.flat_indices(count)
    assert p_conv._native_args(buf, pt, count) is not None
    packed = p_conv.pack(buf, pt, count)
    assert packed.tobytes() == np.asarray(r_conv.pack(buf, rt, count)) \
        .tobytes()
    assert packed.tobytes() == np.ascontiguousarray(buf[..., idx]).tobytes()
    out = np.zeros_like(buf)
    p_conv.unpack(out, packed, pt, count)
    want = np.zeros_like(buf)
    r_conv.unpack(want, packed, rt, count)
    assert out.tobytes() == want.tobytes()
    fancy = np.zeros_like(buf)
    fancy[..., idx] = packed
    assert out.tobytes() == fancy.tobytes()
    _no_native(monkeypatch)
    out2 = np.zeros_like(buf)
    p_conv.unpack(out2, p_conv.pack(buf, pt, count), pt, count)
    assert out2.tobytes() == out.tobytes()


def test_native_pack_runs_the_library(rng):
    """The convertor's host path calls the run-copy loops (counted on a
    wrapper of the port's library), and an undersized buffer falls back
    to numpy, which raises."""
    t = p_dt.FLOAT.create_vector(4, 3, 5).commit()
    buf = rng.standard_normal((2, 3 * t.extent)).astype(np.float32)
    lib = p_native.get_lib()
    geo = p_conv._native_args(buf, t, 3)
    assert geo is not None and geo[0] is lib
    assert p_conv._native_pack(buf, t, 3) is not None
    short = buf[:, :2 * t.extent + 3].copy()
    assert p_conv._native_args(short, t, 3) is None
    with pytest.raises(IndexError):
        p_conv.pack(short, t, 3)


def test_runs_coalescing():
    t = p_dt.FLOAT.create_vector(2, 3, 5).commit()     # idx 0,1,2,5,6,7
    offs, lens = t.runs()
    np.testing.assert_array_equal(offs, [0, 5])
    np.testing.assert_array_equal(lens, [3, 3])


def test_fallback_without_native(rng, monkeypatch):
    monkeypatch.setattr(p_loader, "_lib", None)
    monkeypatch.setattr(p_loader, "_tried", True)       # the build failed
    t = p_dt.FLOAT.create_vector(3, 2, 4).commit()
    buf = rng.standard_normal((2, 2 * t.extent)).astype(np.float32)
    packed = p_conv.pack(buf, t, 2)
    np.testing.assert_array_equal(packed, buf[..., t.flat_indices(2)])


def test_tensor_pack_keeps_index_select(rng, monkeypatch):
    """CPU tensors keep the tensor route (index_select), never the host
    loops, with the same bytes."""
    t = p_dt.FLOAT.create_vector(4, 3, 5).commit()
    host = rng.standard_normal((2, 3 * t.extent)).astype(np.float32)
    want = p_conv.pack(host, t, 3)
    seen = []
    orig = p_conv._native_pack
    monkeypatch.setattr(p_conv, "_native_pack",
                        lambda *a: seen.append(1) or orig(*a))
    got = p_conv.pack(torch.from_numpy(host), t, 3)
    assert not seen and isinstance(got, torch.Tensor)
    assert got.numpy().tobytes() == want.tobytes()
    p_conv.pack(host, t, 3)
    assert seen == [1]


# -- memheap.cpp (buddy) ------------------------------------------------------
def test_buddy_alloc_free_coalesce():
    for lib in (p_native.get_lib(), r_native.get_lib()):
        h = lib.ompi_tpu_buddy_create(6, 0)          # 64-element heap
        assert h > 0
        a = lib.ompi_tpu_buddy_alloc(h, 16)
        b = lib.ompi_tpu_buddy_alloc(h, 16)
        c = lib.ompi_tpu_buddy_alloc(h, 32)
        assert {a, b} == {0, 16} and c == 32
        assert lib.ompi_tpu_buddy_alloc(h, 1) == -1   # exhausted
        assert lib.ompi_tpu_buddy_used(h) == 64
        assert lib.ompi_tpu_buddy_free(h, a) == 0
        assert lib.ompi_tpu_buddy_free(h, b) == 0
        assert lib.ompi_tpu_buddy_alloc(h, 32) == 0    # coalesced
        assert lib.ompi_tpu_buddy_free(h, 16) == -1   # double free
        lib.ompi_tpu_buddy_destroy(h)


def test_buddy_rounds_to_power_of_two():
    lib = p_native.get_lib()
    h = lib.ompi_tpu_buddy_create(5, 0)          # 32 elements
    a = lib.ompi_tpu_buddy_alloc(h, 5)           # -> 8-block
    b = lib.ompi_tpu_buddy_alloc(h, 8)
    assert a != b and a % 8 == 0 and b % 8 == 0
    lib.ompi_tpu_buddy_destroy(h)


# -- matching.cpp: backend parity --------------------------------------------
class _FakeComm:
    size = 4


def _engine(pkg, monkeypatch, native: bool):
    env = ("OMPI_TPU_TORCH_DISABLE_NATIVE_MATCH" if pkg is p_stacked
           else "OMPI_TPU_DISABLE_NATIVE_MATCH")
    if native:
        monkeypatch.delenv(env, raising=False)
    else:
        monkeypatch.setenv(env, "1")
    eng = pkg.MatchingEngine(_FakeComm())
    assert (eng._lib is not None) == native
    return eng


def _order_scenario(pkg, eng):
    """The order every receive saw: FIFO per pair, ANY_SOURCE in rank
    order, posted receives matched in post order, 256 wildcard matches."""
    seen = []
    eng.send(np.array([1.0]), 0, 1, 7)
    eng.send(np.array([2.0]), 0, 1, 7)
    seen += [eng.recv(1, 0, 7)[0][0], eng.recv(1, 0, 7)[0][0]]
    eng.send(np.array([30.0]), 3, 2, 5)
    eng.send(np.array([10.0]), 1, 2, 5)
    for src, tag in ((pkg.ANY_SOURCE, pkg.ANY_TAG), (pkg.ANY_SOURCE, 5)):
        d, st = eng.recv(2, src, tag)
        seen += [d[0], st.source, st.tag]
    r1 = eng.irecv(3, pkg.ANY_SOURCE, 9)
    r2 = eng.irecv(3, 0, pkg.ANY_TAG)
    eng.send(np.array([5.0]), 0, 3, 9)
    seen += [r1.test()[0], r2.test()[0], r1.get()[0]]
    eng.send(np.array([6.0]), 0, 3, 11)
    seen += [r2.test()[0], r2.get()[0]]
    for i in range(256):
        eng.send(np.array([float(i)]), (i * 7) % 4, 0, i % 5)
    for _ in range(256):
        d, st = eng.recv(0, pkg.ANY_SOURCE, pkg.ANY_TAG)
        seen += [d[0], st.source, st.tag]
    return seen


@pytest.mark.parametrize("native", [True, False])
def test_matching_backend(monkeypatch, native):
    got = _order_scenario(p_stacked, _engine(p_stacked, monkeypatch, native))
    want = _order_scenario(r_stacked, _engine(r_stacked, monkeypatch, True))
    assert got == want
    assert got[:2] == [1.0, 2.0] and got[2:5] == [10.0, 1, 5]


@pytest.mark.parametrize("native", [True, False])
def test_matching_backend_probe_and_ssend(monkeypatch, native):
    eng = _engine(p_stacked, monkeypatch, native)
    ok, st = eng.iprobe(1, 0, 3)
    assert not ok
    eng.send(np.arange(4), 0, 1, 3)
    ok, st = eng.iprobe(1, 0, 3)
    assert ok and st.count == 4
    assert eng.iprobe(1, 0, 3)[0]            # probe does not consume
    msg = eng.mprobe(1, 0, 3)                # mprobe consumes
    data, _ = eng.mrecv(msg)
    assert data.size == 4
    assert eng.iprobe(1, 0, 3)[0] is False
    with pytest.raises(MPIError):            # unmatched ssend: deadlock
        eng.send(np.ones(1), 2, 0, 1, synchronous=True)
    assert eng.iprobe(0, 2, 1)[0] is False   # ... and not enqueued
    r = eng.irecv(0, 2, 1)
    eng.send(np.ones(1), 2, 0, 1, synchronous=True)
    assert r.test()[0]


@pytest.mark.parametrize("native", [True, False])
def test_matching_backend_partitioned_channel(monkeypatch, native):
    eng = _engine(p_stacked, monkeypatch, native)
    eng.send(np.array([1.0]), 0, 1, ("part", 4, 0),
             channel=p_stacked.CH_PART)
    assert eng.iprobe(1, 0, -1)[0] is False   # invisible to p2p channel
    r = eng.irecv(1, 0, ("part", 4, 0), channel=p_stacked.CH_PART)
    ok, _ = r.test()
    assert ok and r.get()[0] == 1.0
    eng.send(np.array([2.0]), 0, 1, ("part", 4, 1),
             channel=p_stacked.CH_PART)
    r2 = eng.irecv(1, 0, ("part", 4, 2), channel=p_stacked.CH_PART)
    assert r2.test()[0] is False


def test_matching_engines_from_many_threads(monkeypatch):
    """Engines made, driven and dropped from eight threads at once: the
    core's process-wide table stays consistent."""
    monkeypatch.delenv("OMPI_TPU_TORCH_DISABLE_NATIVE_MATCH", raising=False)
    errors = []

    def work(t):
        try:
            for _ in range(30):
                eng = p_stacked.MatchingEngine(_FakeComm())
                for i in range(8):
                    eng.send(np.array([float(i)]), t % 4, (t + 1) % 4, i)
                got = [eng.recv((t + 1) % 4, t % 4, i)[0][0]
                       for i in range(8)]
                assert got == [float(i) for i in range(8)]
                del eng
        except BaseException as e:       # noqa: BLE001 — reported below
            errors.append(e)
    threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors


# -- containers.cpp -------------------------------------------------------------
def _both(scenario):
    """The scenario's observable trace on the port's and the reference's
    containers: identical."""
    got = scenario(PC)
    assert got == scenario(RC)
    return got


def test_fifo_order_and_bounds():
    def run(C):
        with C.Fifo(8) as f:
            pushed = [f.push(i) for i in range(9)]
            return pushed, [f.pop() for _ in range(9)]
    pushed, popped = _both(run)
    assert pushed == [True] * 8 + [False]
    assert popped == list(range(8)) + [None]


def test_fifo_exact_capacity_bound():
    def run(C):
        with C.Fifo(6) as f:
            pushed = [f.push(i) for i in range(7)]
            return pushed, f.pop(), f.push(6)
    pushed, first, again = _both(run)
    assert pushed == [True] * 6 + [False] and first == 0 and again


def test_bitmap_negative_index_safe():
    def run(C):
        with C.Bitmap(8) as b:
            b.set(-1)
            b.clear(-5)
            return b.test(-1), b.find_and_set()
    assert _both(run) == (False, 0)


def test_lifo_order_and_pool_exhaustion():
    def run(C):
        with C.Lifo(4) as s:
            pushed = [s.push(i) for i in range(5)]
            return pushed, [s.pop() for _ in range(5)]
    pushed, popped = _both(run)
    assert pushed == [True] * 4 + [False]
    assert popped == [3, 2, 1, 0, None]


def test_ring_buffer():
    def run(C):
        with C.RingBuffer(3) as r:
            trace = [r.push(1), r.push(2), r.push(3), r.push(4), r.pop(),
                     r.push(4)]
            return trace + [r.pop(), r.pop(), r.pop()]
    assert _both(run) == [True, True, True, False, 1, True, 2, 3, 4]


def _stress(make_queue, n_threads=4, per_thread=2000):
    q = make_queue()
    produced = [list(range(t * per_thread, (t + 1) * per_thread))
                for t in range(n_threads)]
    popped = [[] for _ in range(n_threads)]
    start = threading.Barrier(2 * n_threads)

    def producer(t):
        start.wait()
        for v in produced[t]:
            while not q.push(v):
                pass

    def consumer(t):
        start.wait()
        count = 0
        while count < per_thread:
            v = q.pop()
            if v is not None:
                popped[t].append(v)
                count += 1

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(n_threads)]
    threads += [threading.Thread(target=consumer, args=(t,))
                for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    q.close()
    drained = sorted(v for lst in popped for v in lst)
    assert drained == sorted(v for lst in produced for v in lst)


def test_fifo_mpmc_stress():
    """4 producers x 4 consumers; every element exactly once."""
    _stress(lambda: PC.Fifo(256))


def test_lifo_mpmc_stress():
    _stress(lambda: PC.Lifo(256))


def test_fifo_per_producer_order():
    def run(C):
        q = C.Fifo(1024)
        for i in range(100):
            q.push(i)
        seen = [q.pop() for _ in range(100)]
        q.close()
        return seen
    assert _both(run) == list(range(100))


def test_hotel_checkin_checkout_evict():
    def run(C):
        with C.Hotel(3) as h:
            rooms = [h.checkin(occupant=101, deadline=50),
                     h.checkin(occupant=102, deadline=10),
                     h.checkin(occupant=103, deadline=90)]
            trace = [rooms, h.checkin(104, 1), h.occupancy,
                     h.evict_one(now=5), h.evict_one(now=20),
                     h.evict_one(now=20), h.checkout(rooms[0]),
                     h.checkout(rooms[0]), h.occupancy,
                     h.checkin(105, 99)]
            return trace
    t = _both(run)
    rooms = t[0]
    assert sorted(rooms) == [0, 1, 2] and t[1] == -1 and t[2] == 3
    assert t[3] is None and t[4] == (rooms[1], 102) and t[5] is None
    assert t[6] == 101 and t[7] is None and t[8] == 1
    assert t[9] in (rooms[0], rooms[1])


def test_bitmap():
    def run(C):
        with C.Bitmap(64) as b:
            trace = [b.test(3)]
            b.set(3)
            trace.append(b.test(3))
            b.clear(3)
            trace += [b.test(3), b.find_and_set(), b.find_and_set()]
            b.set(2)
            trace.append(b.find_and_set())
            b.set(1000)
            return trace + [b.test(1000)]
    assert _both(run) == [False, True, False, 0, 1, 3, True]


def test_bitmap_find_all_then_grow():
    def run(C):
        with C.Bitmap(64) as b:
            return [b.find_and_set() for _ in range(65)]
    assert _both(run) == list(range(65))


def test_pointer_array_recycling():
    def run(C):
        a = C.PointerArray()
        i0, i1 = a.add(100), a.add(200)
        trace = [a.get(i0), a.get(i1), a.remove(i0), a.get(i0)]
        i2 = a.add(300)
        trace += [i2 == i0, a.set(50, 999), a.get(50), a.get(49)]
        a.close()
        return trace
    assert _both(run) == [100, 200, True, None, True, True, 999, None]
