"""Parity of the port's ``coll/compressed`` component with the JAX
package's, on the 8-rank worlds (the port's on the CPU, the conftest's
JAX world): selection, the compressed schedules against the reference's
compressed comm, the gates, the decision-table rows, ``allreduce_bind``,
``CollPlan.codec``, compressed bucket fusion and the hier ``inner_q``.

Both packages get the same vars: compression on, the floor at the
reference fixture's 256 KiB, and segments small enough that the
segmented ring runs four chains. Tolerances against the reference:

- allgather, every codec and dtype, and float64 reductions: bit for bit;
- float32 reductions through a real codec: XLA's CPU backend contracts
  the dequantizing multiply and the following add into one fused
  multiply-add (one rounding where the port's separate torch ops round
  twice), and ``test_float32_departure_is_fma_contraction`` reproduces
  the reference's reduce_scatter_block bit for bit from the port's codes
  with a single-rounding fold. Most elements then differ by a few float32
  ulps of the result's scale; where the one-ulp difference lands on a
  rounding tie of a later hop's quantization, an element differs by one
  code step. So: at most 0.1% of the elements beyond 4 ulps, every
  element within the reference's 0.02 envelope;
- the reference's ``null`` codec cannot run its compressed allreduce
  (its ones-scales break the ring's scan carry); the port's null
  allreduce equals the reference's uncompressed ring_segmented instead.

Each test starts the port from a fresh state and restores every JAX var
it sets.
"""
import zlib

import numpy as np
import pytest
import torch

import ompi_tpu_torch as P
from ompi_tpu.coll import decision as jdecision
from ompi_tpu.coll import persistent as jpersistent
from ompi_tpu.compress import codecs as jcodecs
from ompi_tpu.mca import pvar as jpvar
from ompi_tpu.mca import var as jvar
from ompi_tpu_torch.coll import decision, persistent
from ompi_tpu_torch.compress import codecs
from ompi_tpu_torch.mca import pvar, var

N = 8
ELEMS = 1 << 16              # 256 KiB of float32 per rank: the floor
FLOOR = 256 << 10
SEGSIZE = 8 << 10            # 4 segments of the 32 KiB ring chunks
CODECS = ("int8_block", "fp8_block", "null")
FUNCS = ("allreduce", "allgather", "reduce_scatter_block")
# float32 reductions: the reference's fused multiply-adds against the
# port's two roundings (see the module docstring)
F32_ULPS = 4


@pytest.fixture()
def pworld():
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    yield P.get_comm_world()
    P._reset_for_tests()


@pytest.fixture()
def both(pworld, world, request):
    """set(**vars): set each MCA var in every package that registers it
    (the JAX ones are restored after the test); ``set.worlds`` holds the
    two worlds."""
    from ompi_tpu import compress as jcompress
    jcompress._register_vars()
    saved = {}

    def set_(**kv):
        for k, v in kv.items():
            found = False
            if jvar.var_get(k) is not None:
                saved.setdefault(k, jvar.var_get(k))
                jvar.var_set(k, v)
                found = True
            if var.var_get(k) is not None:
                var.var_set(k, v)
                found = True
            assert found, f"no package registers {k}"

    def restore():
        jpersistent.flush_all("explicit")
        for k, v in saved.items():
            jvar.var_set(k, v)
    request.addfinalizer(restore)
    set_.worlds = (pworld, world)
    return set_


@pytest.fixture()
def comms(both):
    """(port comm, JAX comm) dup'ed with compression on."""
    both(mpi_base_compress=True, mpi_base_compress_min_bytes=FLOOR,
         coll_xla_segsize=SEGSIZE, coll_torch_segsize=SEGSIZE)
    pw, jw = both.worlds
    pc, jc = pw.dup(), jw.dup()
    yield pc, jc
    jc.free()


def _codec(both, name):
    both(mpi_base_compress_codec=name)


def _bytes():
    return (pvar.pvar_read("compress_bytes_in"),
            pvar.pvar_read("compress_bytes_out"))


def _jbytes():
    return (jpvar.pvar_read("compress_bytes_in"),
            jpvar.pvar_read("compress_bytes_out"))


def _args(func, dtype, seed, elems=ELEMS):
    rng = np.random.default_rng(seed)
    shape = (N, N, elems // N) if func == "reduce_scatter_block" \
        else (N, elems)
    return rng.standard_normal(shape).astype(dtype)


def _call(comm, func, x, mpi):
    if func == "allgather":
        return comm.allgather(comm.put(x))
    return getattr(comm, func)(comm.put(x), mpi.SUM)


def _near_f32(got, want):
    """A float32 reduction through a real codec against the reference's:
    at most 0.1% of the elements beyond F32_ULPS ulps of the scale, all
    within the reference's envelope (0.02 of the scale)."""
    d = np.abs(got.astype(np.float64) - want)
    scale = float(np.abs(want).max())
    beyond = float((d > F32_ULPS * np.spacing(np.float32(scale))).mean())
    assert beyond <= 1e-3, f"{beyond:.2%} of the elements differ"
    assert d.max() <= 0.02 * scale


# -- selection ---------------------------------------------------------------
def test_component_selected_only_while_enabled(both, mpi):
    pw, jw = both.worlds
    assert pw._coll_winners["allreduce"] == "tuned"
    both(mpi_base_compress=True)
    pc, jc = pw.dup(), jw.dup()
    try:
        for func in FUNCS:
            assert pc._coll_winners[func] == "compressed"
            assert jc._coll_winners[func] == "compressed"
        for func in ("bcast", "reduce", "barrier", "alltoall", "scan"):
            assert pc._coll_winners[func] == "tuned"
        for func in ("iallreduce", "ibcast", "iallgather", "ibarrier"):
            assert pc._coll_winners[func] == "nbc"
        assert ("compressed", 62) in pc._coll_priorities
        assert [c.name for _p, c, _m in pc._coll_selected][0] == "compressed"
        both(coll_compressed_priority=-1)
        assert "compressed" not in pw.dup()._coll_winners.values()
    finally:
        jc.free()


# -- the compressed schedules against the reference's --------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("func", FUNCS)
@pytest.mark.parametrize("name", CODECS)
def test_compressed_matches_reference(comms, both, mpi, name, func, dtype):
    pc, jc = comms
    _codec(both, name)
    x = _args(func, dtype, zlib.crc32(f"{name}|{func}".encode()))
    b0, j0 = _bytes(), _jbytes()
    got = _call(pc, func, x, P).numpy()
    b1 = _bytes()
    assert b1[0] > b0[0], "the compressed path never engaged"
    ratio = (b1[1] - b0[1]) / (b1[0] - b0[0])
    assert ratio <= (0.3 if name != "null" else 1.0)
    if name == "null" and func == "allreduce":
        with pytest.raises(TypeError):
            _call(jc, func, x, mpi)
        both(mpi_base_compress=False,
             coll_xla_allreduce_algorithm="ring_segmented")
        want = np.asarray(both.worlds[1].allreduce(both.worlds[1].put(x),
                                                   mpi.SUM))
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
        return
    want = np.asarray(_call(jc, func, x, mpi))
    # both packages count the same wire bytes for the call
    assert (b1[0] - b0[0], b1[1] - b0[1]) == tuple(
        a - b for a, b in zip(_jbytes(), j0))
    assert got.shape == want.shape and got.dtype == want.dtype
    if func == "allgather" or dtype == np.float64 or name == "null":
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
    else:
        _near_f32(got, want)
    if func != "reduce_scatter_block":
        for r in range(1, N):
            assert np.array_equal(got[0], got[r]), "ranks diverged"


def test_float32_departure_is_fma_contraction(comms, both, mpi):
    """The reference's float32 reduce_scatter_block equals, bit for bit,
    the port's codes folded with ONE rounding per dequantize-and-add
    (an exact float64 product plus the running float32 sum, rounded
    once): XLA's CPU backend contracts the two into a fused multiply-add
    that picks the second operand's product first."""
    pc, jc = comms
    x = _args("reduce_scatter_block", np.float32, 5)
    want = np.asarray(jc.reduce_scatter_block(jc.put(x), mpi.SUM))
    c = codecs.get_codec("int8_block")
    qc, qs = c.torch_quant_rows(torch.from_numpy(x).reshape(N, N, -1), 256)
    prod = (qc.transpose(0, 1).double().reshape(N, N, -1, 256)
            * qs.transpose(0, 1).double()[..., None]).reshape(N, N, -1)
    acc = (prod[:, 0] + prod[:, 1].float().double()).float()
    for i in range(2, N):
        acc = (acc.double() + prod[:, i]).float()
    assert np.array_equal(acc.numpy().view(np.uint32), want.view(np.uint32))
    got = pc.reduce_scatter_block(pc.put(x), P.SUM).numpy()
    assert not np.array_equal(got, want)        # the port rounds twice


def test_compressed_allreduce_4mb_acceptance(both, mpi):
    """The reference's acceptance row at its default 4 MiB floor: within
    0.02 of the result's scale, <= 0.3 on the wire, the same on every
    rank, and near the reference's (``_near_f32``)."""
    both(mpi_base_compress=True)
    pw, jw = both.worlds
    pc, jc = pw.dup(), jw.dup()
    try:
        host = np.random.default_rng(9).standard_normal(
            (N, 1 << 20)).astype(np.float32)
        b0 = _bytes()
        y = pc.allreduce(pc.put(host), P.SUM).numpy()
        b1 = _bytes()
        assert (b1[1] - b0[1]) / (b1[0] - b0[0]) <= 0.3
        ref = host.sum(axis=0, dtype=np.float64)
        assert np.abs(y[0] - ref).max() <= 0.02 * np.abs(ref).max()
        for r in range(1, N):
            assert np.array_equal(y[0], y[r])
        _near_f32(y, np.asarray(jc.allreduce(jc.put(host), mpi.SUM)))
    finally:
        jc.free()


def test_bfloat16_payload_is_eligible(comms, both):
    pc, _ = comms
    x = torch.from_numpy(_args("allreduce", np.float32, 3, 1 << 17)) \
        .to(torch.bfloat16)
    b0 = _bytes()
    y = pc.allreduce(x, P.SUM)
    assert _bytes()[0] > b0[0] and y.dtype == torch.bfloat16
    ref = x.double().sum(0)
    assert float((y[0].double() - ref).abs().max()) <= \
        0.02 * float(ref.abs().max())


# -- gates ----------------------------------------------------------------
@pytest.mark.parametrize("case", ["var_off", "max", "int32", "small"])
def test_gates_are_bit_identical_and_move_no_bytes(comms, both, pworld,
                                                   case):
    pc, _ = comms
    rng = np.random.default_rng(4)
    x = rng.standard_normal((N, 1 << 17)).astype(np.float32)
    op = P.SUM
    if case == "max":
        op = P.MAX
    elif case == "int32":
        x = rng.integers(0, 100, size=x.shape).astype(np.int32)
    elif case == "small":
        x = x[:, :64].copy()
    elif case == "var_off":
        both(mpi_base_compress=False)
    b0 = _bytes()
    out = [pc.allreduce(pc.put(x), op)]
    if case in ("var_off", "small"):
        out.append(pc.allgather(pc.put(x)))
        y = np.ascontiguousarray(x[:, :(x.shape[1] // N) * N]) \
            .reshape(N, N, -1)
        out.append(pc.reduce_scatter_block(pc.put(y), P.SUM))
        want = [pworld.allreduce(pworld.put(x), op),
                pworld.allgather(pworld.put(x)),
                pworld.reduce_scatter_block(pworld.put(y), P.SUM)]
    else:
        want = [pworld.allreduce(pworld.put(x), op)]
    assert _bytes() == b0, "compressed bytes moved"
    for g, w in zip(out, want):
        assert torch.equal(g, w)


def test_compress_eligible_matches_reference(both, mpi):
    both(mpi_base_compress=True)
    for func in FUNCS + ("bcast", "reduce"):
        for nbytes in (0, (4 << 20) - 1, 4 << 20, 64 << 20):
            for tdt, jdt in ((torch.float32, "float32"),
                             (torch.float64, "float64"),
                             (torch.bfloat16, "bfloat16"),
                             (torch.float16, "float16"),
                             (torch.int32, "int32")):
                for op, jop in ((P.SUM, mpi.SUM), (P.MAX, mpi.MAX),
                                (None, None)):
                    assert decision.compress_eligible(func, nbytes, tdt, op) \
                        == jdecision.compress_eligible(func, nbytes, jdt, jop)
    assert decision.dtype_name(torch.float32) == "float32"
    assert decision.dtype_name(np.dtype(np.float64)) == "float64"
    both(mpi_base_compress=False)
    assert not decision.compress_eligible("allreduce", 64 << 20,
                                          torch.float32, P.SUM)


def test_decision_table_rows_follow_the_var(both):
    t_off = decision.decision_table(N, platform="cpu")
    assert not any("compressed" in str(r[2])
                   for rows in t_off.values() for r in rows)
    assert decision.compression_rules() == {}
    both(mpi_base_compress=True, mpi_base_compress_codec="fp8_block")
    assert decision.compression_rules() == jdecision.compression_rules()
    t_on = decision.decision_table(N, platform="cpu")
    for func in FUNCS:
        rows = [r for r in t_on[func] if str(r[2]).startswith("compressed:")]
        assert rows == [[0, 4 << 20, "compressed:fp8_block"]]
        assert [r for r in t_on[func] if r not in rows] == t_off[func]
    assert not any(str(r[2]).startswith("compressed:")
                   for r in t_on["bcast"])


# -- persistent: allreduce_bind, CollPlan.codec, bucket fusion ----------
def test_allreduce_bind_routes_through_compressed(comms):
    pc, _ = comms
    rng = np.random.default_rng(6)
    x = pc.put(rng.standard_normal((N, ELEMS)).astype(np.float32))
    bound = pc.allreduce_bind(x, P.SUM)
    b0 = _bytes()
    y = bound(x)
    assert _bytes()[0] > b0[0]
    assert torch.equal(y, pc.allreduce(x, P.SUM))
    small = pc.put(rng.standard_normal((N, 2)).astype(np.float32))
    bsmall = pc.allreduce_bind(small, P.SUM)
    b2 = _bytes()
    assert torch.equal(bsmall(small), pc.allreduce(small, P.SUM))
    assert _bytes() == b2


def test_plan_codec_matches_reference(comms, mpi):
    pc, jc = comms
    rng = np.random.default_rng(8)
    x = rng.standard_normal((N, ELEMS)).astype(np.float32)
    y = rng.standard_normal((N, N, ELEMS // N)).astype(np.float32)
    cases = [("allreduce_init", (x, "SUM"), "int8_block"),
             ("allreduce_init", (x, "MAX"), None),
             ("allreduce_init", (x[:, :16].copy(), "SUM"), None),
             ("allreduce_init", (x.astype(np.int32), "SUM"), None),
             ("allgather_init", (x,), "int8_block"),
             ("reduce_scatter_block_init", (y, "SUM"), "int8_block"),
             ("bcast_init", (x, 2), None)]
    for meth, args, want in cases:
        pa = [pc.put(args[0])] + [getattr(P, a) if isinstance(a, str) else a
                                  for a in args[1:]]
        ja = [jc.put(args[0])] + [getattr(mpi, a) if isinstance(a, str)
                                  else a for a in args[1:]]
        preq, jreq = getattr(pc, meth)(*pa), getattr(jc, meth)(*ja)
        assert preq.plan.codec == jreq.plan.codec == want, meth
        preq.start()
        assert preq.get() is not None


def test_bucketed_compressed_parity_and_ratio(both, mpi):
    """16 members of 32 KiB per rank, each under the 256 KiB floor, fuse
    into one 512 KiB bucket that takes the codec, in both packages: the
    same flush count and wire bytes, each member within the codec's
    envelope, the same on every rank, and near the reference's member."""
    both(mpi_base_compress=True, mpi_base_compress_min_bytes=FLOOR,
         mpi_base_bucket=True, mpi_base_bucket_bytes=1 << 20)
    pw, jw = both.worlds
    pc, jc = pw.dup(), jw.dup()
    try:
        rng = np.random.default_rng(12)
        xs = [rng.standard_normal((N, 8192)).astype(np.float32)
              for _ in range(16)]
        preqs = [pc.allreduce_init(pc.stack(list(x)), P.SUM) for x in xs]
        jreqs = [jc.allreduce_init(jc.stack(list(x)), mpi.SUM) for x in xs]
        assert all(r.plan.codec is None for r in preqs + jreqs)
        f0, jf0 = persistent.counters(), jpersistent.counters()
        b0, j0 = _bytes(), _jbytes()
        P.Startall(preqs)
        mpi.Startall(jreqs)
        outs = [r.get().numpy() for r in preqs]
        jouts = [np.asarray(r.get()) for r in jreqs]
        b1, j1 = _bytes(), _jbytes()
        flushes = (persistent.counters()["coll_bucket_flushes"]
                   - f0["coll_bucket_flushes"])
        assert flushes == 1 == (jpersistent.counters()["coll_bucket_flushes"]
                                - jf0["coll_bucket_flushes"])
        assert b1[0] > b0[0]
        assert (b1[0] - b0[0], b1[1] - b0[1]) == (j1[0] - j0[0],
                                                  j1[1] - j0[1])
        assert (b1[1] - b0[1]) / (b1[0] - b0[0]) <= 0.3
        for x, got, want in zip(xs, outs, jouts):
            ref = x.sum(axis=0, dtype=np.float64)
            assert np.abs(got[0] - ref).max() <= 0.02 * np.abs(ref).max()
            for r in range(1, N):
                assert np.array_equal(got[0], got[r])
            _near_f32(got, want)
    finally:
        jc.free()


# -- hier inner_q ----------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compressed_hier_inner_two_tier(comms, mpi, dtype):
    """The hier schedule with the codec composed in, reached through
    ``_groups()`` (the single-controller comm is never multihost): only
    the high-tier chunk quantizes; within the reference's envelope and
    the same on every rank. Against the reference's ``inner_q``: bit for
    bit in float64 (two-member group sums are order-free), ``_near_f32``
    in float32 (XLA's fused multiply-adds)."""
    pc, jc = comms
    dev = pc.c_coll["allreduce"].device
    low, high = dev._groups()
    assert (len(low), len(low[0])) == (4, 2)
    inner = dev._hier_allreduce_inner(P.SUM, low, high,
                                      (codecs.get_codec("int8_block"), 128))
    x = np.random.default_rng(13).standard_normal((N, 4096)).astype(dtype)
    out = inner(pc.put(x)).numpy()
    ref = x.sum(axis=0, dtype=np.float64)
    assert np.abs(out[0] - ref).max() <= 0.02 * np.abs(ref).max()
    for r in range(1, N):
        assert np.array_equal(out[0], out[r])
    jdev = jc.c_coll["allreduce"].device
    jlow, jhigh = jdev._groups()
    assert (jlow, jhigh) == (low, high)
    jinner = jdev._hier_allreduce_inner(
        mpi.SUM, jlow, jhigh, (jcodecs.get_codec("int8_block"), 128))
    want = np.asarray(jdev._smap(jinner, 2, 2)(jc.put(x)))
    if dtype == np.float64:
        assert np.array_equal(out.view(np.uint8), want.view(np.uint8))
    else:
        _near_f32(out, want)


def test_selected_names_the_codec(comms, both):
    pc, _ = comms
    x = pc.put(_args("allreduce", np.float32, 1))
    mod = pc._coll("allreduce")
    assert mod.selected("allreduce", x, P.SUM) == "compressed:int8_block"
    assert mod.selected("allreduce", x, P.MAX) == \
        pc._coll("bcast").selected("allreduce", x, P.MAX)
    _codec(both, "fp8_block")
    assert mod.selected("allreduce", x, P.SUM) == "compressed:fp8_block"
