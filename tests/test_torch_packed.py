"""The port's int8 and sub-byte packed-weight datapaths on the CPU against
the JAX package's.

Inputs come from seeded numpy generators (MSR-structured int8 codes with
deliberate outlier rows, as ``tests/test_packed.py`` draws them) and go
through both packages; the JAX side runs its Pallas kernels in interpret
mode with a pinned dataflow, or its XLA oracles.  Tolerances: quantized
values, packed planes, sidecars and every integer accumulation are
compared bit for bit, and so is every result whose epilogue is scale,
bias and residual only (one f32 multiply and adds, rounded alike in
both); a fused silu within atol 1e-5, the reference's own bound (the two
frameworks' silu may round one ulp apart).  The packed smoke model runs
in float32, as the dense parity test does, at its atol 1e-4 on logits
and KV, with equal greedy tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.core import quant as jquant
from repro.core.dataflow import DataflowSpec as JSpec
from repro.core.dataflow import IS as JIS, OS as JOS, WS as JWS
from repro.kernels import ops as jops, pack as jpack, ref as jref
from repro.models import layers as jlayers, lm as jlm
from repro.serve.engine import Engine as JaxEngine
from repro_torch.configs.base import ArchConfig
from repro_torch.core import dataflow as tdf
from repro_torch.core import quant
from repro_torch.kernels import _build, matmul_df, ops, pack, ref
from repro_torch.models import bridge, layers, lm
from repro_torch.runtime import health
from repro_torch.serve.engine import Engine, RequestState

BITS = (4, 5)
ANCHORS = {"os": JOS, "ws": JWS, "is": JIS}
JAX_BLOCK = (32, 32, 32)
MAX_LEN = 48
FIELDS = ("codes", "highbits", "scale", "outlier_idx", "outlier_delta")


@pytest.fixture(autouse=True)
def _private_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))


def _mk_codes(rng, k, n, bits, n_outliers):
    """MSR-structured int8 codes: in-range rows + deliberate outliers."""
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    q = rng.integers(lo, hi + 1, size=(k, n)).astype(np.int8)
    for r in rng.choice(k, size=n_outliers, replace=False):
        q[r] = rng.integers(-120, 121, size=n).astype(np.int8)
    return q


def _mk_scale(rng, n):
    return ((rng.random((1, n)) + 0.5) / 127.0).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.from_numpy(want.reshape(-1)[:0].copy()).dtype
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _same_planes(tp, jp_) -> None:
    for f in FIELDS:
        if getattr(jp_, f) is None:
            assert getattr(tp, f) is None
            continue
        _same(getattr(tp, f), getattr(jp_, f))


def _packed_pair(rng, k, n, bits, n_outliers=3):
    q = _mk_codes(rng, k, n, bits, n_outliers)
    s = _mk_scale(rng, n)
    return (jpack.pack_int8(jnp.asarray(q), jnp.asarray(s), bits=bits),
            pack.pack_int8(_t(q), _t(s), bits=bits), q)


# ---------------------------------------------------------------------------
# Quantization and packing.
# ---------------------------------------------------------------------------
QUANT_CASES = {"tensor": None, "last": -1, "groups": (0, 2)}


@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("axis", sorted(QUANT_CASES))
def test_symmetric_int8_matches_bit_for_bit(axis, zeros):
    x = np.random.default_rng(1).standard_normal((6, 5, 4)).astype(
        np.float32) * 3
    if zeros:
        x[..., 1] = 0.0
        x = np.zeros_like(x) if axis == "tensor" else x
    jq, js = jquant.symmetric_int8(jnp.asarray(x), axis=QUANT_CASES[axis])
    tq, ts = quant.symmetric_int8(_t(x), axis=QUANT_CASES[axis])
    _same(tq, jq)
    _same(ts, js)
    if zeros and axis == "tensor":
        assert float(ts) == 1.0
    np.testing.assert_array_equal(quant.dequantize(tq, ts).numpy(),
                                  np.asarray(jquant.dequantize(jq, js)))


@pytest.mark.parametrize("cap", [None, "fixed"])
@pytest.mark.parametrize("k", [64, 70])
@pytest.mark.parametrize("bits", BITS)
def test_pack_int8_planes_match(bits, k, cap):
    rng = np.random.default_rng(10 * k + bits)
    mo = None if cap is None else jpack.outlier_capacity(k)   # 1 here
    q = _mk_codes(rng, k, 9, bits, 2 if mo is None else mo)
    s = _mk_scale(rng, 9)
    jpw = jpack.pack_int8(jnp.asarray(q), jnp.asarray(s), bits=bits,
                          max_outliers=mo)
    tpw = pack.pack_int8(_t(q), _t(s), bits=bits, max_outliers=mo)
    _same_planes(tpw, jpw)
    assert (tpw.bits, tpw.k, tpw.n, tpw.k_pad) == (jpw.bits, jpw.k, jpw.n,
                                                   jpw.k_pad)
    np.testing.assert_array_equal(pack.unpack_weights(tpw)[0].numpy(), q)
    _same(pack.unpack_codes(tpw), jpack.unpack_codes(jpw))
    _same(pack.dequantize(tpw), jpack.dequantize(jpw))
    with pytest.raises(ValueError, match="exceed max_outliers"):
        pack.pack_int8(_t(q), _t(s), bits=bits, max_outliers=0)


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("bits", BITS)
def test_pack_weights_matches(bits, group):
    w = np.random.default_rng(bits + group).standard_normal(
        (40, 12)).astype(np.float32)
    w[7] *= 25.0                               # an outlier row
    jpw = jpack.pack_weights(jnp.asarray(w), bits=bits, group_size=group)
    tpw = pack.pack_weights(_t(w), bits=bits, group_size=group)
    _same_planes(tpw, jpw)
    _same(ref.pack_roundtrip(_t(w), bits=bits, group_size=group),
          jref.pack_roundtrip(jnp.asarray(w), bits=bits, group_size=group))


@pytest.mark.parametrize("cin", [32, 20])
@pytest.mark.parametrize("bits", BITS)
def test_pack_conv_weights_matches(bits, cin):
    w = np.random.default_rng(cin + bits).standard_normal(
        (3, 2, cin, 7)).astype(np.float32)
    w[0, 1, 3, :] *= 30.0
    jpcw = jpack.pack_conv_weights(jnp.asarray(w), bits=bits)
    tpcw = pack.pack_conv_weights(_t(w), bits=bits)
    _same_planes(tpcw, jpcw)
    assert (tpcw.cin, tpcw.cin_pad) == (jpcw.cin, jpcw.cin_pad)
    jq, _ = jpack.unpack_conv_weights(jpcw)
    tq, _ = pack.unpack_conv_weights(tpcw)
    _same(tq, jq)


def test_unpack_block_decodes_every_code():
    """Every code value of both widths, with the top nibble setting the
    int32 word's sign bit."""
    for bits in BITS:
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
        q = np.tile(np.arange(lo, hi + 1, dtype=np.int8), 64 // (hi - lo + 1))
        q = np.stack([q, q[::-1]], axis=1)           # (64, 2)
        tpw = pack.pack_int8(_t(q), torch.ones(2), bits=bits)
        assert int(tpw.codes.min()) < 0               # sign bit in use
        np.testing.assert_array_equal(pack.unpack_codes(tpw).numpy(), q)
        assert tpw.outlier_idx.numel() == 0


# ---------------------------------------------------------------------------
# GEMMs and convs: the CPU path against the JAX ops in interpret mode.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("anchor", sorted(ANCHORS))
def test_matmul_packed_matches_interpret(anchor, bits):
    rng = np.random.default_rng(42 + bits)
    m, k, n = 24, 100, 80                      # K not a multiple of 32
    jpw, tpw, q = _packed_pair(rng, k, n, bits)
    assert int((tpw.outlier_idx < tpw.k_pad).sum()) >= 3
    aq = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    want = jops.matmul_packed(
        jnp.asarray(aq), jpw, a_scale=jnp.float32(0.013),
        spec=JSpec.basic(ANCHORS[anchor], block=JAX_BLOCK),
        backend="interpret")
    got = ops.matmul_packed(_t(aq), tpw, a_scale=0.013)
    _same(got, want)
    _same(ref.matmul_packed_ref(_t(aq), tpw, a_scale=torch.tensor(0.013)),
          want)
    _same(ops.matmul_packed(_t(aq), tpw, a_scale=0.013, backend="torch"),
          want)


@pytest.mark.parametrize("bits", BITS)
def test_matmul_packed_fused_epilogue(bits):
    rng = np.random.default_rng(5 + bits)
    m, k, n = 16, 64, 48
    jpw, tpw, _ = _packed_pair(rng, k, n, bits, 2)
    aq = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    bias = rng.random(n).astype(np.float32)
    resid = rng.random((m, n)).astype(np.float32)
    spec = JSpec.basic(JWS, block=(16, 32, 16))
    for act in (None, "silu"):
        want = jops.matmul_packed_fused(
            jnp.asarray(aq), jpw, a_scale=jnp.float32(0.02),
            bias=jnp.asarray(bias), residual=jnp.asarray(resid),
            activation=act, spec=spec, backend="interpret")
        got = ops.matmul_packed_fused(_t(aq), tpw, a_scale=0.02,
                                      bias=_t(bias), residual=_t(resid),
                                      activation=act)
        # the reference may contract scale * acc + bias into one FMA
        # (ROADMAP C); the port rounds each stage, as its own oracle does
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
        assert torch.equal(got, ref.matmul_packed_ref(
            _t(aq), tpw, a_scale=torch.tensor(0.02), bias=_t(bias),
            residual=_t(resid), activation=act))


SCALES = {"tensor": lambda rng, m, n: (np.float32(0.02), np.float32(0.5)),
          "column": lambda rng, m, n: (np.float32(0.02),
                                       rng.random(n).astype(np.float32)),
          "row": lambda rng, m, n: (rng.random((m, 1)).astype(np.float32),
                                    np.float32(0.03))}


@pytest.mark.parametrize("kind", sorted(SCALES))
def test_int8_matmul_matches(kind):
    rng = np.random.default_rng(len(kind))
    m, k, n = 20, 70, 36
    aq = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    bq = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    sa, sb = SCALES[kind](rng, m, n)
    spec = JSpec(anchor=JOS, block=JAX_BLOCK)
    jargs = (jnp.asarray(aq), jnp.asarray(bq), jnp.asarray(sa),
             jnp.asarray(sb))
    targs = (_t(aq), _t(bq), _t(np.asarray(sa)), _t(np.asarray(sb)))
    _same(ops.int8_matmul(*targs),
          jops.int8_matmul(*jargs, spec=spec, backend="interpret"))
    _same(ops.int8_matmul(*targs), jref.int8_matmul_ref(*jargs))
    _same(ref.int8_matmul_ref(*targs), jref.int8_matmul_ref(*jargs))
    _same(ops.int8_matmul_fused(*targs),
          jops.int8_matmul_fused(*jargs, spec=spec, backend="interpret"))
    # With bias and residual, within rtol 1e-6 plus one ulp of the largest
    # value: the reference may contract scale * acc + bias into one FMA
    # (ROADMAP C); the port rounds each stage, as its own oracle does.
    bias = rng.random(n).astype(np.float32)
    resid = rng.random((m, n)).astype(np.float32)
    got = ops.int8_matmul_fused(*targs, bias=_t(bias), residual=_t(resid))
    want = np.asarray(jops.int8_matmul_fused(
        *jargs, bias=jnp.asarray(bias), residual=jnp.asarray(resid),
        spec=spec, backend="interpret"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=np.spacing(np.abs(want).max()))
    scale = (targs[2] * targs[3]).reshape(
        (m, 1) if kind == "row" else (1, -1))
    assert torch.equal(got, ref.matmul_fused_ref(
        targs[0], targs[1], scale=scale, bias=_t(bias), residual=_t(resid)))
    _same(ops.matmul(_t(aq), _t(bq)),
          jops.matmul(jnp.asarray(aq), jnp.asarray(bq), spec=spec,
                      backend="interpret"))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("anchor", sorted(ANCHORS))
def test_conv2d_packed_matches_interpret(anchor, bits):
    rng = np.random.default_rng(13 + bits)
    n_b, ih, iw, cin, cout, fh = 1, 6, 7, 20, 16, 2
    w = rng.normal(size=(fh, fh, cin, cout)).astype(np.float32)
    w[0, 1, 3, :] *= 30.0                     # force outlier rows
    jpcw = jpack.pack_conv_weights(jnp.asarray(w), bits=bits)
    tpcw = pack.pack_conv_weights(_t(w), bits=bits)
    assert int((tpcw.outlier_idx < fh * fh * tpcw.cin_pad).sum()) >= 1
    xq = rng.integers(-127, 128, size=(n_b, ih, iw, cin)).astype(np.int8)
    want = jops.conv2d_packed(jnp.asarray(xq), jpcw, stride=1,
                              x_scale=jnp.float32(0.02),
                              spec=JSpec.basic(ANCHORS[anchor]),
                              backend="interpret")
    _same(ops.conv2d_packed(_t(xq), tpcw, stride=1, x_scale=0.02), want)
    bias = rng.random(cout).astype(np.float32)
    want = jref.conv2d_packed_ref(jnp.asarray(xq), jpcw, 1,
                                  x_scale=jnp.float32(0.02),
                                  bias=jnp.asarray(bias), activation="relu")
    _same(ops.conv2d_packed_fused(_t(xq), tpcw, stride=1, x_scale=0.02,
                                  bias=_t(bias), activation="relu"), want)


def test_conv_sidecar_offsets_address_the_outlier_taps():
    """The conv kernel reads each outlier row of a packed filter at
    ``base(pixel) + offset``: for every real slot the offset the wrapper
    computes lands on that row's (ky, kx, c) in the pixel's window, and
    empty slots (and pad channels) get -1."""
    from repro_torch.kernels import conv2d_df

    n, ih, iw, cin, f, s = 1, 9, 8, 20, 3, 2
    q = np.random.default_rng(4).integers(-8, 8, (f, f, cin, 6))
    q[1, 2, 7], q[2, 0, 19] = 127, -127      # the two outlier rows
    pcw = pack.pack_conv_weights(_t(q.astype(np.float32) * 0.01), 4,
                                 max_outliers=4)
    conv = tdf.ConvProblem(ih=ih, iw=iw, fh=f, fw=f, s=s, cin=cin, cout=6,
                           n=n)
    offs = conv2d_df._window_offsets(pcw.outlier_idx, conv, pcw.cin_pad)
    x = torch.arange(ih * iw * cin).reshape(ih, iw, cin)
    flat = x.flatten()
    real = 0
    for slot, off in zip(pcw.outlier_idx.tolist(), offs.tolist()):
        tap, c = divmod(slot, pcw.cin_pad)
        ky, kx = divmod(tap, f)
        if slot >= f * f * pcw.cin_pad or c >= cin:
            assert off == -1
            continue
        real += 1
        for oy, ox in ((0, 0), (1, 2), (3, 2)):
            base = ((oy * s) * iw + ox * s) * cin
            assert flat[base + off] == x[oy * s + ky, ox * s + kx, c]
    assert real == 2 and int((offs == -1).sum()) == 2


def test_plan_charges_packed_and_int8_bytes():
    """Resident operands are charged at their real size: int8 one byte an
    element, packed planes their words; what does not fit raises naming
    its bytes."""
    specs = {name: tdf.DataflowSpec.basic(a, block=matmul_df.BLOCK)
             for name, a in (("ws", tdf.WS), ("is", tdf.IS))}
    p4 = matmul_df.plan(specs["ws"], 4, 6144, 2048, torch.int8, 4)
    assert p4.kernel == "matmul_rmw"
    assert list(p4.resident.values()) == [6144 // 8 * 64 * 4]
    assert p4.smem_bytes == 6144 // 8 * 64 * 4 + matmul_df.TILE_BYTES
    with pytest.raises(ValueError, match="254464 bytes of shared memory"):
        matmul_df.plan(specs["ws"], 4, 6144, 2048, torch.int8, 5)
    with pytest.raises(ValueError, match="401920 bytes"):
        matmul_df.plan(specs["ws"], 4, 6144, 2048, torch.int8)
    with pytest.raises(ValueError, match="packed 5-bit"):
        matmul_df.plan(specs["ws"], 4, 6144, 2048, torch.int8, 5)
    p8 = matmul_df.plan(specs["is"], 4, 6144, 2048, torch.int8)
    assert list(p8.resident.values()) == [4 * 6144]
    whole = tdf.DataflowSpec(tdf.IS, {tdf.WS: tdf.Residency.WHOLE},
                             (tdf.WS,), matmul_df.BLOCK)
    pw = matmul_df.plan(whole, 4, 96, 100, torch.int8, 5)
    assert pw.resident["B whole (96, 128) packed 5-bit"] == \
        (96 // 8 + 96 // 32) * 128 * 4
    conv = tdf.ConvProblem(ih=7, iw=7, fh=3, fw=3, s=1, cin=500, cout=64)
    from repro_torch.kernels import conv2d_df
    pc = conv2d_df.plan(tdf.DataflowSpec.basic(tdf.WS,
                                               block=conv2d_df.BLOCK),
                        conv, torch.int8, 4)
    assert list(pc.resident.values()) == [9 * 512 // 8 * 64 * 4]


def test_malformed_operands_raise():
    rng = np.random.default_rng(6)
    _, tpw, _ = _packed_pair(rng, 32, 8, 4, 0)
    with pytest.raises(ValueError, match="K=16"):
        ops.matmul_packed(torch.zeros((4, 16), dtype=torch.int8), tpw)
    with pytest.raises(ValueError, match="per-tensor"):
        ops.matmul_packed(torch.zeros((4, 32), dtype=torch.int8), tpw,
                          a_scale=torch.ones(4))
    with pytest.raises(TypeError, match="float or both int8"):
        ops.matmul(torch.zeros((2, 3), dtype=torch.int8), torch.zeros(3, 4))
    with pytest.raises(ValueError, match="int8 activations"):
        matmul_df.matmul_df(torch.zeros(4, 32), tpw.codes,
                            matmul_df.BASIC_OS, weight_bits=4)
    with pytest.raises(ValueError, match="bit plane"):
        matmul_df.matmul_df(torch.zeros((4, 32), dtype=torch.int8),
                            tpw.codes, matmul_df.BASIC_OS, weight_bits=5)
    with pytest.raises(ValueError, match="per-row scales"):
        ops.int8_matmul_fused(torch.zeros((4, 8), dtype=torch.int8),
                              torch.zeros((8, 6), dtype=torch.int8),
                              torch.ones(4, 1), torch.ones(6))
    with pytest.raises(TypeError, match="write"):
        ops.matmul_fused(torch.zeros((4, 8), dtype=torch.int8),
                         torch.zeros((8, 6), dtype=torch.int8),
                         bias=torch.ones(6), out_dtype=torch.int32)
    pcw = pack.pack_conv_weights(torch.randn(2, 2, 8, 5), 4)
    with pytest.raises(ValueError, match="packed cin"):
        ops.conv2d_packed(torch.zeros((1, 4, 4, 9), dtype=torch.int8), pcw)


@pytest.mark.parametrize("entry", ["int8_matmul_fused", "matmul_packed",
                                   "conv2d_packed"])
def test_fault_sites_fire(monkeypatch, entry):
    rng = np.random.default_rng(7)
    _, tpw, _ = _packed_pair(rng, 32, 8, 4, 1)
    aq = torch.ones((3, 32), dtype=torch.int8)
    pcw = pack.pack_conv_weights(torch.randn(2, 2, 8, 5), 4)
    site, call = {
        "int8_matmul_fused": ("kernel.matmul", lambda: ops.int8_matmul_fused(
            aq, torch.ones((32, 8), dtype=torch.int8), 0.5, 0.5)),
        "matmul_packed": ("kernel.matmul",
                          lambda: ops.matmul_packed(aq, tpw, a_scale=0.1)),
        "conv2d_packed": ("kernel.conv2d", lambda: ops.conv2d_packed(
            torch.ones((1, 4, 4, 8), dtype=torch.int8), pcw)),
    }[entry]
    monkeypatch.setenv("REPRO_FAULT_PLAN", f"{site}:0:raise,{site}:1:nan")
    health.reset_faults()
    try:
        with pytest.raises(health.SimulatedFailure):
            call()
        assert bool(torch.isnan(call()).all())
        assert [(f.site, f.hit) for f in health.fault_log()] == [
            (site, 0), (site, 1)]
    finally:
        health.reset_faults()


# ---------------------------------------------------------------------------
# The packed-MLP decoder: layers, bridge, serving.
# ---------------------------------------------------------------------------
def _cfgs(bits):
    """The JAX package's packed smoke model (``tests/test_packed.py``), in
    float32 like the dense parity tests' smoke config."""
    kw = dict(name="packed-smoke", family="dense", n_layers=2, d_model=64,
              n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=256, d_head=32,
              packed_weights=True, packed_weight_bits=bits,
              param_dtype="float32", act_dtype="float32")
    return JArchConfig(**kw), ArchConfig(**kw)


@pytest.fixture(scope="module", params=BITS, ids=["wb4", "wb5"])
def model(request):
    jcfg, cfg = _cfgs(request.param)
    jp = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                  device="cpu")
    return jcfg, cfg, jp, tp


def test_bridge_carries_the_packed_model(model):
    jcfg, cfg, jp, tp = model
    for name in ("w1", "w3", "w2"):
        got, want = tp["layers"]["mlp"][name], jp["layers"]["mlp"][name]
        assert isinstance(got, pack.PackedWeights)
        assert (got.bits, got.k, got.n) == (want.bits, want.k, want.n)
        _same_planes(got, want)
    fresh = lm.init_model(cfg, seed=0, device="cpu")
    for name in ("w1", "w3", "w2"):
        a, b = fresh["layers"]["mlp"][name], tp["layers"]["mlp"][name]
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None)
            if x is not None:
                assert x.shape == y.shape and x.dtype == y.dtype
    tree = jax.tree.map(np.asarray, jp)
    w1 = tree["layers"]["mlp"]["w1"]
    tree["layers"]["mlp"]["w1"] = dataclasses.replace(
        w1, outlier_delta=np.zeros((2, 3, 4), np.int32))
    with pytest.raises(ValueError, match="w1.outlier_delta: shape"):
        bridge.params_from_numpy(tree, cfg, device="cpu")


def test_packed_mlp_apply_matches(model):
    """Layer 0's MLP: the int8 activations of both projections' inputs
    bit for bit, the output within the silu's atol."""
    jcfg, cfg, jp, tp = model
    x = np.random.default_rng(3).standard_normal((2, 5, cfg.d_model)).astype(
        np.float32)
    jmlp = jax.tree.map(lambda t: t[0], jp["layers"]["mlp"])
    tmlp = {k: v.layer(0) for k, v in tp["layers"]["mlp"].items()}
    want = jlayers.packed_mlp_apply(jmlp, jnp.asarray(x))
    got = layers.packed_mlp_apply(tmlp, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    xq, xs = quant.symmetric_int8(_t(x).reshape(-1, cfg.d_model))
    jxq, jxs = jquant.symmetric_int8(jnp.asarray(x).reshape(-1, cfg.d_model))
    _same(xq, jxq)
    _same(ops.matmul_packed(xq, tmlp["w3"], a_scale=xs),
          jops.matmul_packed(jxq, jmlp["w3"], a_scale=jxs))
    with layers.forced_backend("torch"):
        assert torch.equal(layers.mlp_apply(tmlp, _t(x)), got)


def test_prefill_logits_and_kv_match(model):
    jcfg, cfg, jp, tp = model
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 13))
    jl, jc = jlm.prefill(jp, jnp.asarray(toks, jnp.int32), jcfg,
                         max_len=MAX_LEN)
    tl, tc = lm.prefill(tp, torch.as_tensor(toks), cfg, max_len=MAX_LEN)
    for got, want in ((tl, jl), (tc["k"], jc["k"]), (tc["v"], jc["v"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.argmax(np.asarray(jl), -1))


def test_paged_decode_logits_and_greedy_tokens_match(model):
    """Two live rows and an idle one (the scratch page, a stale token)
    decode 6 greedy steps in both packages, each off its own pools."""
    jcfg, cfg, jp, tp = model
    page, max_pages, rows, live = 8, MAX_LEN // 8, 3, 2
    n_pages = rows * max_pages
    rng = np.random.default_rng(2)
    lens = np.array([5, 17, 0])
    shape = (cfg.n_layers, cfg.n_kv_heads, n_pages + 1, page, cfg.d_head)
    k_pool, v_pool = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    tables = np.zeros((rows, max_pages), np.int32)
    last = np.zeros(rows, np.int64)
    for r in range(live):
        toks = rng.integers(0, cfg.vocab_size, (1, int(lens[r])))
        jl, jc = jlm.prefill(jp, jnp.asarray(toks, jnp.int32), jcfg,
                             max_len=MAX_LEN)
        last[r] = int(np.argmax(np.asarray(jl)[0]))
        tables[r] = rng.permutation(max_pages) + r * max_pages
        for j in range(max_pages):
            k_pool[:, :, tables[r, j]] = np.asarray(
                jc["k"])[:, 0, :, j * page:(j + 1) * page]
            v_pool[:, :, tables[r, j]] = np.asarray(
                jc["v"])[:, 0, :, j * page:(j + 1) * page]
    jk, jv = jnp.asarray(k_pool), jnp.asarray(v_pool)
    tk, tv = _t(k_pool.copy()), _t(v_pool.copy())
    kv = lens.copy()
    for _ in range(6):
        wp = np.array([tables[r, kv[r] // page] if r < live else n_pages
                       for r in range(rows)], np.int32)
        wo = np.where(np.arange(rows) < live, kv % page, 0).astype(np.int32)
        args = (last[:, None], tables, kv.astype(np.int32), wp, wo)
        jl, (jk, jv) = jlm.paged_decode_step(
            jp, jk, jv, *[jnp.asarray(a, jnp.int32) for a in args], jcfg)
        tl, (tk, tv) = lm.paged_decode_step(
            tp, tk, tv, *[torch.as_tensor(a) for a in args], cfg)
        np.testing.assert_allclose(tl[:live].numpy(),
                                   np.asarray(jl)[:live], atol=1e-4, rtol=0)
        tok = tl.argmax(dim=-1).numpy()
        np.testing.assert_array_equal(tok[:live],
                                      np.argmax(np.asarray(jl), -1)[:live])
        last = np.where(np.arange(rows) < live, tok, 7)
        kv = kv + (np.arange(rows) < live)


def test_engine_matches_jax_engine(model):
    """The packed smoke model served through the port's ``Engine`` on the
    CPU: every request DONE, no kernel launched, and the greedy tokens of
    the JAX package's ``Engine`` on the same weights and requests (its
    scheduler fills idle decode rows as the port's does, so the
    per-tensor activation quantization sees the same batch)."""
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (7, 12, 3, 17)]
    jeng = JaxEngine(jcfg, jp, max_len=MAX_LEN)
    jreqs = [jeng.submit(p, 5) for p in prompts]
    jeng.drain()
    before = dict(_build.LAUNCHES)
    eng = Engine(cfg, tp, max_len=MAX_LEN, device="cpu")
    reqs = [eng.submit(p, 5) for p in prompts]
    eng.drain()
    assert all(r.state == RequestState.DONE for r in reqs)
    assert eng.stats()["demotions"] == 0
    assert [list(r.out_tokens) for r in reqs] == \
        [list(r.out_tokens) for r in jreqs]
    assert _build.LAUNCHES == before


def test_init_model_draws_the_packed_mlp():
    _, cfg = _cfgs(5)
    p = lm.init_model(cfg, seed=3, device="cpu")
    w1 = p["layers"]["mlp"]["w1"]
    n, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    cap = pack.outlier_capacity(d)
    assert w1.codes.shape == (n, d // 8, ff) and w1.codes.dtype == torch.int32
    assert w1.highbits.shape == (n, d // 32, ff)
    assert w1.outlier_idx.shape == (n, cap)
    assert torch.equal(w1.scale, torch.full(
        (n, 1, ff), 1.0 / (127.0 * d ** 0.5)))
    for i in range(n):
        lp = w1.layer(i)
        q, _ = pack.unpack_weights(lp)
        real = lp.outlier_idx[lp.outlier_idx < lp.k_pad]
        assert real.numel() == min(2, cap)
        inside = torch.ones(d, dtype=torch.bool)
        inside[real.long()] = False
        assert int(q[inside].min()) >= -16 and int(q[inside].max()) <= 15
        assert int(q[~inside].abs().max()) > 15
        assert int(q.abs().max()) <= 100


def test_packed_bench_runs_on_the_cpu():
    from repro_torch.bench import packed as bench_packed

    rows = bench_packed.run("cpu", iters=1,
                            shapes=[(4, 64, 96), (20, 96, 64)])
    assert {r["kind"] for r in rows if r["bench"] == "packed_b1"} == \
        set(bench_packed.KINDS)
    assert all(r["ms"] is None for r in rows if r["bench"] == "packed_b1")
    summary = rows[-1]
    assert summary["wb4_over_int8_ms_m4"] is None
    assert summary["wb4_over_int8_weight_bytes"] < 0.65
