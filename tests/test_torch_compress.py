"""Parity of the port's compression plane (``ompi_tpu_torch/compress``)
with the JAX package's (``ompi_tpu/compress``): codecs, error feedback,
the host wire form, the byte/error pvars and the MCA vars.

The same numpy inputs from a seed go through both packages. Tolerances:

- the torch device half (``torch_quant``/``torch_dequant``) against the
  reference's compiled ``jnp_quant``/``jnp_dequant``: bit for bit (codes
  on finite blocks; scales and dequantized values NaN-aware). The
  reference's schedules always run ``jnp_quant`` compiled, where XLA
  turns its ``maximum(m, 1e-30) / 127`` into ``* float32(1 / 127)``; the
  port computes the scale that way. Run eagerly, ``jnp_quant`` divides,
  and its scales then differ from the compiled ones by at most one ulp;
  that test states it;
- the port's numpy ``encode``/``decode`` against the reference's: bit for
  bit, codes of poisoned blocks included (the fp8 cast goes through
  torch where the reference uses ``ml_dtypes``);
- error bounds, poisoning, error feedback and the wire layer as the
  reference's own tests hold them.
"""
import pickle
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ompi_tpu_torch as P
from ompi_tpu.compress import codecs as jcodecs
from ompi_tpu.compress import feedback as jfeedback
from ompi_tpu_torch import compress
from ompi_tpu_torch.compress import codecs, feedback, stats, wire
from ompi_tpu_torch.compress.feedback import ErrorFeedback
from ompi_tpu_torch.core import op as op_mod
from ompi_tpu_torch.mca import pvar, var

REAL = ("int8_block", "fp8_block")
SHAPES = [(), (1,), (5,), (255,), (256,), (257,), (4, 129), (1000,),
          (20549,)]
BLOCK = 64


@pytest.fixture()
def pworld():
    P._reset_for_tests()
    P.Init(devices=["cpu"] * 8)
    yield P.get_comm_world()
    P._reset_for_tests()


@pytest.fixture()
def compress_on(pworld):
    var.var_set("mpi_base_compress", True)
    var.var_set("mpi_base_compress_min_bytes", 1 << 10)


def _payload(shape, dtype, seed):
    """Normal values at one scale, with a sprinkle of tiny ones (fp8
    subnormals)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * rng.uniform(0.01, 100)
    flat = x.reshape(-1)
    if flat.size:
        flat[rng.integers(0, flat.size, max(1, flat.size // 50))] *= 1e-6
    return np.asarray(x, dtype=dtype)


def _seed(*parts) -> int:
    return zlib.crc32("|".join(map(str, parts)).encode())


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 4: np.uint32, 8: np.uint64}[a.itemsize])


def _same_nan_aware(a, b):
    a, b = np.asarray(a), np.asarray(b)
    nan = np.isnan(a)
    return (a.shape == b.shape and np.array_equal(nan, np.isnan(b))
            and np.array_equal(_bits(a)[~nan], _bits(b)[~nan]))


def _jit_quant(name):
    c = jcodecs.get_codec(name)
    q = jax.jit(c.jnp_quant, static_argnums=1)
    d = jax.jit(c.jnp_dequant, static_argnums=(2, 3, 4))
    return q, d


def _block_bound(codec, x, block):
    """Per-element bound from the per-block error model."""
    flat = np.asarray(x, np.float64).reshape(-1)
    nb = -(-flat.size // block) if flat.size else 1
    flat = np.pad(flat, (0, nb * block - flat.size))
    maxabs = np.abs(flat.reshape(nb, block)).max(axis=1)
    return np.repeat(codec.error_bound(maxabs), block)[:x.size]


# -- the device half against the reference's compiled jnp kernels --------
@pytest.mark.parametrize("name", REAL + ("null",))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_torch_quant_matches_compiled_jnp(name, dtype, shape):
    x = _payload(shape, dtype, _seed(name, shape))
    q, d = _jit_quant(name)
    # the null codec's jnp codes keep the payload's shape; compare flat
    jc, js = (np.asarray(a).reshape(-1) for a in q(jnp.asarray(x), BLOCK))
    c = codecs.get_codec(name)
    tc, ts = c.torch_quant(torch.from_numpy(x), BLOCK)
    assert np.array_equal(_bits(tc.numpy()), _bits(jc))
    assert np.array_equal(_bits(ts.numpy()), _bits(js))
    jd = np.asarray(d(jnp.asarray(jc), jnp.asarray(js), x.size,
                      jnp.dtype(dtype), BLOCK))
    td = c.torch_dequant(torch.from_numpy(jc.copy()),
                         torch.from_numpy(js.copy()), x.size,
                         torch.from_numpy(x).dtype, BLOCK)
    assert td.dtype == torch.from_numpy(x).dtype
    assert np.array_equal(_bits(td.numpy()), _bits(jd))


@pytest.mark.parametrize("name", REAL)
def test_eager_jnp_quant_divides_its_scale(name):
    """Run eagerly, ``jnp_quant`` divides by the constant range; compiled,
    XLA multiplies by its float32 reciprocal, as the port does. The
    scales then differ by at most one ulp, and the dequantized images
    stay within the codec's bound."""
    c, jc = codecs.get_codec(name), jcodecs.get_codec(name)
    x = _payload((20549,), np.float32, 7)
    ec, es = (np.asarray(a) for a in jc.jnp_quant(jnp.asarray(x), BLOCK))
    tc, ts = c.torch_quant(torch.from_numpy(x), BLOCK)
    ulps = np.abs(_bits(ts.numpy()).astype(np.int64)
                  - _bits(es).astype(np.int64))
    assert ulps.max() <= 1 and ulps.any()
    ed = np.asarray(jc.jnp_dequant(jnp.asarray(ec), jnp.asarray(es), x.size,
                                   jnp.float32, BLOCK))
    bound = _block_bound(c, x, BLOCK) * (1 + 1e-4)
    assert (np.abs(ed.astype(np.float64) - x) <= bound).all()


@pytest.mark.parametrize("name", REAL)
@pytest.mark.parametrize("bad", [np.inf, -np.inf, np.nan])
def test_torch_quant_poisoned_blocks(name, bad):
    """A block holding inf or nan: NaN scale, all-NaN dequant, in both
    packages; codes compared on the finite blocks only (casting NaN to a
    code is implementation-defined, and torch's fp8 cast saturates where
    XLA's gives NaN)."""
    x = _payload((5 * BLOCK,), np.float32, 3)
    x[2 * BLOCK + 5] = bad
    q, d = _jit_quant(name)
    jc, js = (np.asarray(a) for a in q(jnp.asarray(x), BLOCK))
    c = codecs.get_codec(name)
    tc, ts = c.torch_quant(torch.from_numpy(x), BLOCK)
    fin = np.isfinite(js)
    assert fin.tolist() == [True, True, False, True, True]
    assert _same_nan_aware(ts.numpy(), js)
    assert np.array_equal(tc.numpy().reshape(-1, BLOCK)[fin],
                          jc.reshape(-1, BLOCK)[fin])
    td = c.torch_dequant(tc, ts, x.size, torch.float32, BLOCK).numpy()
    jd = np.asarray(d(jnp.asarray(jc), jnp.asarray(js), x.size,
                      jnp.float32, BLOCK))
    assert _same_nan_aware(td, jd)
    assert np.isnan(td[2 * BLOCK:3 * BLOCK]).all()
    assert np.isfinite(np.delete(td, np.s_[2 * BLOCK:3 * BLOCK])).all()


@pytest.mark.parametrize("name", REAL)
def test_torch_quant_rows_pad_each_row(name):
    """The row form quantizes each row as ``jnp_quant`` quantizes one
    payload: padded to whole blocks per row, never across rows."""
    x = _payload((6, 100), np.float32, 11)
    c = codecs.get_codec(name)
    rc, rs = c.torch_quant_rows(torch.from_numpy(x), BLOCK)
    assert rc.shape == (6, 128) and rs.shape == (6, 2)
    q, _ = _jit_quant(name)
    for r in range(6):
        jc, js = (np.asarray(a) for a in q(jnp.asarray(x[r]), BLOCK))
        assert np.array_equal(_bits(rc[r].numpy()), _bits(jc))
        assert np.array_equal(_bits(rs[r].numpy()), _bits(js))
    back = c.torch_dequant_rows(rc, rs, 100, torch.float32, BLOCK)
    assert back.shape == (6, 100)


def test_bfloat16_payload_quantizes_through_float32():
    x = torch.from_numpy(_payload((300,), np.float32, 5)).to(torch.bfloat16)
    for name in REAL:
        c = codecs.get_codec(name)
        qc, qs = c.torch_quant(x, BLOCK)
        want = c.torch_quant(x.to(torch.float32), BLOCK)
        assert torch.equal(qc, want[0]) and torch.equal(qs, want[1])
        assert c.torch_dequant(qc, qs, 300, torch.bfloat16,
                               BLOCK).dtype == torch.bfloat16


# -- the host half against the reference's numpy codecs ------------------
@pytest.mark.parametrize("name", REAL + ("null",))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_encode_decode_match_reference(name, dtype, shape):
    x = _payload(shape, dtype, _seed("host", name, shape))
    jc = jcodecs.get_codec(name)
    pc = codecs.get_codec(name)
    rc, rs = jc.encode(x, BLOCK)
    gc, gs = pc.encode(x, BLOCK)
    assert gc.dtype == rc.dtype and gs.dtype == rs.dtype
    assert np.array_equal(_bits(gc), _bits(rc))
    assert np.array_equal(_bits(gs), _bits(rs))
    rd = jc.decode(rc, rs, x.shape, x.dtype, BLOCK)
    gd = pc.decode(gc, gs, x.shape, x.dtype, BLOCK)
    assert gd.shape == x.shape and gd.dtype == x.dtype
    assert np.array_equal(_bits(gd), _bits(rd))


@pytest.mark.parametrize("name", REAL)
def test_encode_poisoned_blocks_match_reference(name):
    x = np.ones(4 * BLOCK, np.float32)
    x[BLOCK + 3], x[3 * BLOCK] = np.inf, np.nan
    rc, rs = jcodecs.get_codec(name).encode(x, BLOCK)
    gc, gs = codecs.get_codec(name).encode(x, BLOCK)
    assert np.array_equal(_bits(gc), _bits(rc))
    assert _same_nan_aware(gs, rs)
    dq = codecs.get_codec(name).decode(gc, gs, x.shape, x.dtype, BLOCK)
    assert np.isnan(dq[BLOCK:2 * BLOCK]).all()
    assert np.isnan(dq[3 * BLOCK:]).all()
    assert np.isfinite(dq[:BLOCK]).all()


@pytest.mark.parametrize("name", REAL)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(), (1,), (5,), (255,), (256,), (257,),
                                   (4, 129), (1000,)])
def test_roundtrip_error_bound(name, dtype, shape, rng):
    """The reference's bound test, on both halves of the port."""
    codec = codecs.get_codec(name)
    x = np.asarray(rng.normal(size=shape) * rng.uniform(0.01, 100), dtype)
    codes, scales = codec.encode(x, BLOCK)
    dq = codec.decode(codes, scales, x.shape, x.dtype, BLOCK)
    assert dq.shape == x.shape and dq.dtype == x.dtype
    bound = _block_bound(codec, x, BLOCK)
    err = np.abs(np.asarray(x, np.float64) - dq).reshape(-1)
    assert (err <= bound + 1e-12).all()
    tx = torch.from_numpy(np.ascontiguousarray(x))
    tq, ts = codec.torch_quant(tx, BLOCK)
    td = codec.torch_dequant(tq, ts, x.size, tx.dtype, BLOCK).numpy()
    terr = np.abs(np.asarray(x, np.float64).reshape(-1) - td)
    assert (terr <= bound + 1e-12).all()


@pytest.mark.parametrize("name", REAL)
def test_nonfinite_poisons_exactly_its_block(name):
    codec = codecs.get_codec(name)
    block = 128
    for bad in (np.inf, -np.inf, np.nan):
        x = np.ones(3 * block, np.float32)
        x[block + 5] = bad
        codes, scales = codec.encode(x, block)
        dq = codec.decode(codes, scales, x.shape, x.dtype, block)
        assert np.isnan(dq[block:2 * block]).all()
        assert np.isfinite(dq[:block]).all()
        assert np.isfinite(dq[2 * block:]).all()


def test_int8_codes_wire_width():
    codec = codecs.get_codec("int8_block")
    x = np.linspace(-4, 4, 512, dtype=np.float32)
    codes, scales = codec.encode(x, 128)
    assert codes.dtype == np.int8 and codes.nbytes == 512
    assert scales.dtype == np.float32 and scales.size == 4
    assert codec.wire_bytes(512, 128) == 512 + 4 * 4
    assert codec.wire_bytes(512, 128) / x.nbytes <= 0.3
    for name in codecs.codec_names():
        assert (codecs.get_codec(name).wire_bytes(1000, 256)
                == jcodecs.get_codec(name).wire_bytes(1000, 256))


def test_null_codec_identity_and_unknown_name_fallback(rng):
    x = rng.normal(size=100).astype(np.float32)
    null = codecs.get_codec("null")
    codes, scales = null.encode(x)
    assert np.array_equal(null.decode(codes, scales, x.shape, x.dtype), x)
    assert codecs.get_codec("no_such_codec") is null
    assert null.wire_bytes(100, 256) == 400
    t = torch.from_numpy(x)
    tc, ts = null.torch_quant(t, 256)
    assert torch.equal(null.torch_dequant(tc, ts, 100, t.dtype, 256), t)
    assert codecs.codec_names() == ["fp8_block", "int8_block", "null"]


@pytest.mark.parametrize("name", REAL)
def test_sum_of_quantized_vs_quantize_of_sum(name, rng):
    codec = codecs.get_codec(name)
    k = 8
    parts = [rng.normal(size=640).astype(np.float32) for _ in range(k)]
    exact = np.sum(parts, axis=0)

    def rt(v):
        c, s = codec.encode(v, BLOCK)
        return codec.decode(c, s, v.shape, v.dtype, BLOCK)

    err_soq = np.abs(np.sum([rt(p) for p in parts], axis=0) - exact)
    err_qos = np.abs(rt(exact) - exact)
    bounds = np.sum([_block_bound(codec, p, BLOCK) for p in parts], axis=0)
    assert (err_soq <= bounds + 1e-9).all()
    assert (err_qos <= _block_bound(codec, exact, BLOCK) + 1e-9).all()


# -- error feedback --------------------------------------------------------
@pytest.mark.parametrize("name", REAL)
def test_error_feedback_bounds_drift_and_matches_reference(name, rng):
    """Iterative accumulation of one payload: the carried residual keeps
    the drift below the plain path's, and the port's accumulator gives
    the reference's sums bit for bit."""
    codec, jcodec = codecs.get_codec(name), jcodecs.get_codec(name)
    steps = 50
    x = (rng.normal(size=256) * 0.37 + 0.11).astype(np.float32)

    def run(c, ef):
        acc = np.zeros_like(x, np.float64)
        for _ in range(steps):
            comp = ef.compensate("k", x) if ef else x
            s = c.encode(comp, BLOCK)
            dq = c.decode(*s, comp.shape, comp.dtype, BLOCK)
            if ef:
                ef.record("k", comp, dq)
            acc += dq
        return acc

    acc_plain = run(codec, None)
    acc_ef = run(codec, ErrorFeedback())
    assert np.array_equal(acc_ef, run(jcodec, jfeedback.ErrorFeedback()))
    exact = x.astype(np.float64) * steps
    drift_plain = np.abs(acc_plain - exact).mean()
    drift_ef = np.abs(acc_ef - exact).mean()
    assert drift_ef <= drift_plain + 1e-9
    assert drift_ef <= 0.5 * steps * _block_bound(codec, x, BLOCK).mean()


def test_error_feedback_resets_on_shape_change():
    ef = ErrorFeedback()
    a = np.ones(8, np.float32)
    ef.record("k", a, a * 0.9)
    assert ef.residual("k").shape == (8,)
    comp = ef.compensate("k", np.ones(4, np.float32))
    assert comp.shape == (4,)                 # stale shape ignored
    ef.record("j", a, np.full(8, np.nan, np.float32))
    assert np.array_equal(ef.residual("j"), np.zeros(8, np.float32))
    ef.reset("k")
    assert ef.residual("k") is None and ef.residual("j") is not None
    ef.reset()
    assert ef.residual("j") is None


# -- the wire layer ----------------------------------------------------------
def test_wire_eligibility_gates(compress_on):
    big = np.ones(1 << 18, np.float32)
    assert wire.eligible(big, op_mod.SUM)
    assert wire.eligible(big)
    assert wire.eligible(big.astype(np.float64), op_mod.SUM)
    assert not wire.eligible(big, op_mod.MAX)
    assert not wire.eligible(big.astype(np.int32), op_mod.SUM)
    assert not wire.eligible(np.ones(4, np.float32), op_mod.SUM)
    assert wire.eligible(np.ones(4, np.float32), op_mod.SUM, nbytes=1 << 20)
    assert not wire.eligible([1.0] * 100000, op_mod.SUM)
    assert not wire.eligible(torch.ones(1 << 18), op_mod.SUM)
    var.var_set("mpi_base_compress", False)
    assert not wire.eligible(big, op_mod.SUM)


def test_wire_roundtrip_stats_watermark_and_reference_parity(compress_on,
                                                             rng):
    from ompi_tpu.compress import wire as jwire
    x = rng.normal(size=1 << 12).astype(np.float32)
    before = stats.snapshot()
    w = wire.encode(x)
    out = wire.decode(w)
    after = stats.snapshot()
    assert after["bytes_in"] - before["bytes_in"] == x.nbytes
    assert after["bytes_out"] - before["bytes_out"] == w.nbytes
    assert w.nbytes / x.nbytes <= 0.3
    assert after["quant_calls"] == before["quant_calls"] + 1
    assert after["dequant_calls"] == before["dequant_calls"] + 1
    assert pvar.pvar_read("compress_max_abs_error") > 0
    assert pvar.pvar_read("compress_ratio") == pytest.approx(
        after["bytes_out"] / after["bytes_in"])
    assert out.shape == x.shape and out.dtype == x.dtype
    assert np.abs(out - x).max() <= np.abs(x).max() / 64
    assert wire.maybe_decode("hello") == "hello"
    assert wire.maybe_decode(w) is not w
    # the reference's wire form of the same payload, field by field
    r = jwire.CompressedWire("int8_block", 256,
                             *jcodecs.get_codec("int8_block").encode(x, 256),
                             x.shape, x.dtype.str)
    assert (w.codec, w.block, w.shape, w.dtype) == \
        (r.codec, r.block, r.shape, r.dtype)
    assert np.array_equal(w.codes, r.codes)
    assert np.array_equal(_bits(w.scales), _bits(r.scales))
    assert np.array_equal(_bits(out), _bits(jwire.decode(r)))


def test_wire_payload_pickles_compactly(compress_on, rng):
    var.var_set("mpi_base_compress_codec", "fp8_block")
    x = rng.normal(size=1 << 16).astype(np.float32)
    w = wire.encode(x)
    assert w.codec == "fp8_block"
    blob = pickle.dumps(w)
    assert len(blob) <= int(0.3 * x.nbytes)
    w2 = pickle.loads(blob)
    assert np.array_equal(wire.decode(w2), wire.decode(w))


def test_wire_verification_sampling(compress_on, rng):
    """The watermark's round trip runs on a key's first encode and on
    every VERIFY_EVERY-th one after; a NaN error is not a magnitude."""
    x = rng.normal(size=1 << 10).astype(np.float32)
    wire.encode(x)
    first = stats.snapshot()["max_abs_error"]
    assert first > 0
    stats.note_error(float("nan"))
    assert stats.snapshot()["max_abs_error"] == first
    stats.note_error(first / 2)
    assert stats.snapshot()["max_abs_error"] == first
    assert ("int8_block", x.shape, "float32") in wire._seen_keys


def test_wire_error_feedback_stream(compress_on, rng):
    var.var_set("mpi_base_compress_error_feedback", True)
    feedback.default.reset()
    x = (rng.normal(size=2048) + 0.2).astype(np.float32)
    acc = np.zeros_like(x, np.float64)
    for _ in range(20):
        acc += wire.decode(wire.encode(x, stream_key="grad"))
    exact = x.astype(np.float64) * 20
    drift_ef = np.abs(acc - exact).mean()
    assert feedback.default.residual(("grad", x.shape, "float32")) \
        is not None
    feedback.default.reset()
    var.var_set("mpi_base_compress_error_feedback", False)
    acc2 = np.zeros_like(x, np.float64)
    for _ in range(20):
        acc2 += wire.decode(wire.encode(x, stream_key="grad"))
    assert drift_ef <= np.abs(acc2 - exact).mean() + 1e-9


# -- vars, pvars, reset --------------------------------------------------
def test_pvars_registered():
    names = set(pvar.pvar_names())
    for n in ("compress_bytes_in", "compress_bytes_out", "compress_ratio",
              "compress_max_abs_error"):
        assert n in names
    assert pvar.pvar_info("compress_ratio")["class"] == "level"
    assert pvar.pvar_info("compress_max_abs_error")["class"] == \
        "highwatermark"


def test_vars_defaults_and_environment(monkeypatch):
    P._reset_for_tests()
    try:
        assert compress.enabled() is False
        assert compress.codec_name() == "int8_block"
        assert compress.min_bytes() == 4 << 20
        assert compress.block_elems() == 256
        assert compress.error_feedback() is False
        monkeypatch.setenv("OMPI_TPU_TORCH_MCA_mpi_base_compress", "1")
        monkeypatch.setenv("OMPI_TPU_TORCH_MCA_mpi_base_compress_codec",
                           "fp8_block")
        monkeypatch.setenv("OMPI_TPU_TORCH_MCA_mpi_base_compress_block", "0")
        monkeypatch.setenv("OMPI_TPU_MCA_mpi_base_compress_min_bytes", "7")
        P._reset_for_tests()
        P.Init(devices=["cpu"] * 2)
        assert compress.enabled() is True
        assert compress.codec_name() == "fp8_block"
        assert compress.block_elems() == 1         # clamped to one element
        assert compress.min_bytes() == 4 << 20     # the JAX prefix is not read
        assert var.var_source("mpi_base_compress") == "env"
    finally:
        P._reset_for_tests()


def test_reset_zeroes_stats_and_feedback(compress_on, rng):
    x = rng.normal(size=1 << 12).astype(np.float32)
    wire.decode(wire.encode(x))
    feedback.default.record("s", x, x * 0.5)
    assert stats.snapshot()["bytes_in"] > 0
    P._reset_for_tests()
    snap = stats.snapshot()
    assert snap["bytes_in"] == snap["bytes_out"] == 0
    assert snap["max_abs_error"] == 0.0
    assert feedback.default.residual("s") is None
    assert not wire._seen_keys
