"""The int8 KV cache of the port: int8 K/V with per-position f32 scales
through B2 and B7, and the dense decoder served from an int8 slot cache.

On the CPU, against the JAX package on the same seeded numpy inputs:
``layers._quantize_kv``'s codes and scales bit for bit; ``ref.
attention_ref`` / ``ops.attention(backend="torch")`` with scales against
JAX ``ops.attention(backend="interpret")`` (its Pallas kernel in
interpret mode) over the serving cases of the JAX package's own tests
(decode at index 40, int8 with window 24 at the last slot, a cached
8-token chunk) plus a per-row ``kv_len``; the scale-validation errors;
``layers.attention_apply`` over an int8 cache (codes, scales and output);
``lm.prefill`` -> ``decode_step`` and ``prefill_chunk`` on bridged
weights and a bridged JAX cache (``bridge.cache_from_numpy``), and the
JAX package's own bound (int8 logits within 0.05 of the bf16 cache's, at
under 0.6x its bytes); the port's ``Engine`` tokens against the JAX
``Engine``'s on an int8 config (no page pool); and a warm ``snapshot``
/ ``restore`` of an int8 slot cache against the uninterrupted tokens.
The JAX package is imported inside the tests that use it.

On the card (marker ``card``, skipped here): B2 over int8 K/V against
its plain twin over causal, windowed, scalar and per-row ``kv_len`` (0
among them), Sq = 1, 3, 17, 65 and 200 and groups of 1, 2 and 4, each
launch counted under ``flash_attention_i8kv``; B7 over int8 K/V equal
to B2's int8 output bit for bit, counted under
``kv_stationary_cluster_i8kv``; both at d_head 16 too; under float32
queries B2's f32 kernel over int8 K/V (K1, counted under
``flash_attention_f32_i8kv``) against its plain twin over the same masks,
Sq and groups at d_head 16, 32, 64 and 128, and B7's f32 kernel over
int8 K/V (K2, counted under ``kv_stationary_f32_i8kv``) equal to K1 bit
for bit; int8 K with a bf16 V refused.
Those tests import no JAX, so they run on the card without the repo's
conftest:

    PYTHONPATH=src python -m pytest --noconftest -q -m card \
        tests/test_torch_int8_kv.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import quant
from repro_torch.kernels import _build, attention_df, ops, ref
from repro_torch.models import bridge, layers, lm

# The kernels' tolerance against the plain version (B2's, chip_smoke.py):
# bf16 outputs of f32 softmax math on both sides.
CARD_TOL = dict(atol=4e-3, rtol=8e-3)
# float32 queries (B2's f32 tolerance, chip_smoke.py's f32_tol): f32 math on
# both sides, only the order of the sums differs.
F32_CARD_TOL = dict(atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the int8 attention kernels run only "
                    "there")
    return torch.device("cuda")


def _int8_operands(dev, b, hq, hkv, sq, skv, d, seed,
                   dtype=torch.bfloat16):
    """Queries of ``dtype`` (bf16 or float32); K/V drawn in ``dtype`` and
    quantized per position (``quant.symmetric_int8`` over the head dim),
    as the cache holds them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, hq, sq, d), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b, hkv, skv, d), generator=gen, device=dev).to(
        dtype) for _ in range(2))
    (kq, ks), (vq, vs) = quant.symmetric_int8(k, -1), quant.symmetric_int8(
        v, -1)
    return q, kq, vq, ks, vs


# (causal, window, kv_len): kv_len "short" is a scalar below Skv, a list
# one length per batch row (0 among them).
MASKS = [(True, None, None), (True, 24, "short"), (False, None, [0, 40]),
         (True, 40, [70, 0]), (False, 16, "short")]


def _lens(kv_len, skv, dev):
    if isinstance(kv_len, list):
        return torch.tensor(kv_len, dtype=torch.int32, device=dev)
    return {None: None, "short": skv - 9}[kv_len]


@pytest.mark.card
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("sq", [1, 3, 17, 65, 200])
def test_b2_int8_kv_matches_its_plain_twin_on_the_card(card, sq, group):
    hkv, d = 2, 128 if group != 4 else 64
    b, skv = 2, sq + 57
    q, kq, vq, ks, vs = _int8_operands(card, b, hkv * group, hkv, sq, skv,
                                       d, sq * 10 + group)
    for causal, window, kv_len in MASKS:
        lens = _lens(kv_len, skv, card)
        before = (_build.LAUNCHES["flash_attention"],
                  _build.LAUNCHES["flash_attention_i8kv"])
        got = attention_df.flash_attention(
            q, kq, vq, causal=causal, window=window, kv_len=lens,
            k_scale=ks, v_scale=vs)
        assert (_build.LAUNCHES["flash_attention"],
                _build.LAUNCHES["flash_attention_i8kv"]) == \
            (before[0] + 1, before[1] + 1)
        want = ref.attention_ref(q, kq, vq, causal=causal, window=window,
                                 kv_len=lens, k_scale=ks, v_scale=vs)
        assert got.dtype == torch.bfloat16
        assert torch.allclose(got.float(), want.float(), **CARD_TOL), (
            causal, window, kv_len, (got.float() - want.float()).abs().max())


@pytest.mark.card
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("sq", [1, 3, 17, 65, 200])
def test_b7_int8_kv_equals_b2_bitwise_on_the_card(card, sq, group):
    hkv, d = 2, 128 if group != 4 else 32
    b, skv = 2, sq + 57
    q, kq, vq, ks, vs = _int8_operands(card, b, hkv * group, hkv, sq, skv,
                                       d, sq * 10 + group + 5)
    for causal, window, kv_len in MASKS:
        lens = _lens(kv_len, skv, card)
        before = (_build.LAUNCHES["kv_stationary_cluster"],
                  _build.LAUNCHES["kv_stationary_cluster_i8kv"])
        got = attention_df.kv_stationary_attention(
            q, kq, vq, causal=causal, window=window, kv_len=lens,
            k_scale=ks, v_scale=vs)
        assert (_build.LAUNCHES["kv_stationary_cluster"],
                _build.LAUNCHES["kv_stationary_cluster_i8kv"]) == \
            (before[0] + 1, before[1] + 1)
        want = attention_df.flash_attention(
            q, kq, vq, causal=causal, window=window, kv_len=lens,
            k_scale=ks, v_scale=vs)
        assert torch.equal(got, want), (causal, window, kv_len, (
            got.float() - want.float()).abs().max())


@pytest.mark.card
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("sq", [1, 3, 17, 65, 200])
def test_k1_f32_queries_over_int8_kv_match_the_plain_twin_on_the_card(
        card, sq, group, d):
    """B2's f32 kernel over int8 K/V (K1), each launch counted under
    ``flash_attention_f32_i8kv``, within B2's f32 tolerance of the plain
    twin."""
    hkv, b, skv = 2, 2, sq + 57
    q, kq, vq, ks, vs = _int8_operands(card, b, hkv * group, hkv, sq, skv,
                                       d, sq * 10 + group + d,
                                       torch.float32)
    for causal, window, kv_len in MASKS:
        lens = _lens(kv_len, skv, card)
        before = (_build.LAUNCHES["flash_attention"],
                  _build.LAUNCHES["flash_attention_f32_i8kv"])
        got = attention_df.flash_attention(
            q, kq, vq, causal=causal, window=window, kv_len=lens,
            k_scale=ks, v_scale=vs)
        assert (_build.LAUNCHES["flash_attention"],
                _build.LAUNCHES["flash_attention_f32_i8kv"]) == \
            (before[0] + 1, before[1] + 1)
        want = ref.attention_ref(q, kq, vq, causal=causal, window=window,
                                 kv_len=lens, k_scale=ks, v_scale=vs)
        assert got.dtype == torch.float32
        assert torch.allclose(got, want, **F32_CARD_TOL), (
            causal, window, kv_len, (got - want).abs().max())


@pytest.mark.card
@pytest.mark.parametrize("d", [16, 32, 128])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("sq", [1, 17, 200])
def test_k2_equals_k1_bitwise_on_the_card(card, sq, group, d):
    """B7's f32 kernel over int8 K/V (K2, counted under
    ``kv_stationary_f32_i8kv``) folds B2's f32 tiles with B2's f32 step:
    its output equals K1's bit for bit, as B7's f32 output over float K/V
    equals B2's."""
    hkv, b, skv = 2, 2, sq + 57
    q, kq, vq, ks, vs = _int8_operands(card, b, hkv * group, hkv, sq, skv,
                                       d, sq * 10 + group + d + 1,
                                       torch.float32)
    kf, vf = kq.float() * ks, vq.float() * vs
    for causal, window, kv_len in MASKS:
        lens = _lens(kv_len, skv, card)
        before = (_build.LAUNCHES["kv_stationary"],
                  _build.LAUNCHES["kv_stationary_f32_i8kv"])
        got = attention_df.kv_stationary_attention(
            q, kq, vq, causal=causal, window=window, kv_len=lens,
            k_scale=ks, v_scale=vs)
        assert (_build.LAUNCHES["kv_stationary"],
                _build.LAUNCHES["kv_stationary_f32_i8kv"]) == \
            (before[0] + 1, before[1] + 1)
        want = attention_df.flash_attention(
            q, kq, vq, causal=causal, window=window, kv_len=lens,
            k_scale=ks, v_scale=vs)
        assert torch.equal(got, want), (causal, window, kv_len, (
            got - want).abs().max())
        mask = dict(causal=causal, window=window, kv_len=lens)
        assert torch.equal(attention_df.kv_stationary_attention(
            q, kf, vf, **mask), attention_df.flash_attention(
            q, kf, vf, **mask)), ("float K/V", causal, window, kv_len)


@pytest.mark.card
@pytest.mark.parametrize("sq", [1, 17, 200])
def test_bf16_queries_over_int8_kv_at_d_head_16_on_the_card(card, sq):
    """B2's bf16 int8 path at d_head 16 (one 16-byte code chunk a row)
    within B2's tolerance of the plain twin, and B7's cluster kernel over
    the same int8 K/V equal to it bit for bit."""
    for group in (1, 2, 4):
        hkv, b, skv = 2, 2, sq + 57
        q, kq, vq, ks, vs = _int8_operands(card, b, hkv * group, hkv, sq,
                                           skv, 16, sq + group)
        for causal, window, kv_len in MASKS:
            mask = dict(causal=causal, window=window,
                        kv_len=_lens(kv_len, skv, card), k_scale=ks,
                        v_scale=vs)
            got = attention_df.flash_attention(q, kq, vq, **mask)
            want = ref.attention_ref(q, kq, vq, **mask)
            assert torch.allclose(got.float(), want.float(), **CARD_TOL), (
                group, causal, window, kv_len)
            assert torch.equal(attention_df.kv_stationary_attention(
                q, kq, vq, **mask), got), (group, causal, window, kv_len)


@pytest.mark.card
def test_int8_kv_needs_int8_k_and_v_on_the_card(card):
    q, kq, vq, ks, vs = _int8_operands(card, 1, 2, 2, 4, 64, 64, 0)
    for fn in (attention_df.flash_attention,
               attention_df.kv_stationary_attention):
        for qq in (q, q.float()):
            with pytest.raises(TypeError, match="per-position"):
                fn(qq, kq, vq.to(qq.dtype), k_scale=ks, v_scale=vs)


# ---------------------------------------------------------------------------
# On the CPU, against the JAX package.
# ---------------------------------------------------------------------------
CFG = configs.get_smoke("qwen3-1.7b")
CFG8 = dataclasses.replace(CFG, kv_cache_dtype="int8")
MAX_LEN = 48
# f32 on both sides; the JAX kernel dequantizes K/V at the block load where
# the port folds the scales into scores and probabilities (the same math
# in another order).
ATT_TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (imported here, so the card tests above
    run without JAX)."""
    import types

    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.kernels import ops as jops
    from repro.models import layers as jlayers
    from repro.models import lm as jlm
    from repro.serve.engine import Engine as JaxEngine

    jcfg = jconfigs.get_smoke("qwen3-1.7b")
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, ops=jops, layers=jlayers, lm=jlm, Engine=JaxEngine,
        cfg=jcfg, cfg8=dataclasses.replace(jcfg, kv_cache_dtype="int8"))


@pytest.fixture(scope="module")
def params(jx):
    jp = jx.lm.init_model(jx.cfg, jx.jax.random.PRNGKey(0))
    return jp, bridge.params_from_numpy(jx.jax.tree.map(np.asarray, jp), CFG,
                                        device="cpu")


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 33, 128), (1, 2, 5, 32)])
def test_quantize_kv_codes_and_scales_bit_for_bit(jx, dtype, shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32) * 3
    x[0, 0, 1] = 0.0                    # amax 0: scale 1, codes 0
    xj = jx.jnp.asarray(x, dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jx.layers._quantize_kv(xj)
    tq, ts = layers._quantize_kv(xt)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == shape[:-1] + (1,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# (Sq, Skv, kv_len, window): the JAX package's serving cases (decode at
# index 40, int8 with window 24 at the last slot, a cached 8-token chunk)
# and a per-row kv_len.
ATTENTION_CASES = {"decode_at_40": (1, 64, 41, None),
                   "window24_last_slot": (1, 64, 64, 24),
                   "cached_chunk": (8, 64, 24, None),
                   "per_row_kv_len": (3, 64, [5, 40], None)}


def _int8_case(jx, name):
    sq, skv, kv_len, window = ATTENTION_CASES[name]
    rng = np.random.default_rng(len(name))
    b, hq, hkv, d = 2, 4, 2, 32
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
            for _ in range(2))
    (kq, ks), (vq, vs) = (quant.symmetric_int8(torch.from_numpy(x), -1)
                          for x in (k, v))
    lens = np.asarray(kv_len, np.int32)
    return q, kq, vq, ks, vs, lens, window


@pytest.mark.parametrize("name", sorted(ATTENTION_CASES))
def test_attention_with_scales_matches_jax_interpret(jx, name):
    q, kq, vq, ks, vs, lens, window = _int8_case(jx, name)
    jnp = jx.jnp
    want = jx.ops.attention(
        jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
        window=window, kv_len=jnp.asarray(lens),
        k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()),
        backend="interpret")
    kv = torch.from_numpy(lens) if lens.ndim else int(lens)
    tq = torch.from_numpy(q)
    for got in (ref.attention_ref(tq, kq, vq, window=window, kv_len=kv,
                                  k_scale=ks, v_scale=vs),
                ops.attention(tq, kq, vq, window=window, kv_len=kv,
                              k_scale=ks, v_scale=vs, backend="torch"),
                ops.attention(tq, kq, vq, window=window, kv_len=kv,
                              k_scale=ks, v_scale=vs, anchor="ws")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


@pytest.mark.parametrize("anchor", ["os", "ws"])
def test_attention_rejects_malformed_kv_scales(anchor):
    """The JAX package's validation, with its messages."""
    b, h, s, d = 1, 2, 8, 32
    q = torch.zeros((b, h, s, d))
    kq = torch.zeros((b, h, s, d), dtype=torch.int8)
    good = torch.ones((b, h, s, 1))
    with pytest.raises(ValueError, match="per-position"):
        ops.attention(q, kq, kq, anchor=anchor)
    with pytest.raises(ValueError, match="per-position"):
        ops.attention(q, kq, kq, k_scale=good, anchor=anchor)
    for bad in (torch.ones((b, h, s)),          # squeezed lane
                torch.ones(()),                 # per-tensor
                torch.ones((b, h, 1, 1))):      # per-head
        with pytest.raises(ValueError, match="trailing"):
            ops.attention(q, kq, kq, k_scale=bad, v_scale=good,
                          anchor=anchor)
        with pytest.raises(ValueError, match="trailing"):
            ops.attention(q, kq, kq, k_scale=good, v_scale=bad,
                          anchor=anchor)
    out = ops.attention(q, kq, kq, k_scale=good, v_scale=good, anchor=anchor)
    assert out.shape == q.shape


def _layer0(jx, jp, tp):
    return (jx.jax.tree.map(lambda a: a[0], jp["layers"]["attn"]),
            {k: t[0] for k, t in tp["layers"]["attn"].items()})


# (window, S, cache_index, attend_local): the int8 cases of the JAX
# package's attention_apply tests, a prefill from zero (attend_local: the
# fresh float K/V attended) and a per-row cache index.
APPLY_CASES = {"decode_at_40": (None, 1, 40, False),
               "window24_last_slot": (24, 1, 47, False),
               "cached_chunk": (None, 8, 16, False),
               "prefill_local": (None, 12, 0, True),
               "per_row_index": (None, 1, [3, 30], False)}


@pytest.mark.parametrize("name", sorted(APPLY_CASES))
def test_attention_apply_int8_cache_matches_jax(jx, params, name):
    window, s, idx, local = APPLY_CASES[name]
    jp, tp = params
    pj, pt = _layer0(jx, jp, tp)
    jnp = jx.jnp
    rng = np.random.default_rng(len(name) + s)
    b, hkv, dh = 2, CFG.n_kv_heads, CFG.d_head
    x = (rng.standard_normal((b, s, CFG.d_model)) * 0.3).astype(np.float32)
    # a filled history: codes in [-127, 127], scales as the cache holds them
    codes = [rng.integers(-127, 128, (b, hkv, MAX_LEN, dh)).astype(np.int8)
             for _ in range(2)]
    scales = [rng.uniform(0.005, 0.03, (b, hkv, MAX_LEN, 1)).astype(
        np.float32) for _ in range(2)]
    cache = codes + scales
    lens = np.asarray(idx, np.int32)
    pos = (lens.reshape(-1, 1) + np.arange(s)[None, :]).astype(np.int32)
    jout, jcache = jx.layers.attention_apply(
        pj, jnp.asarray(x), jx.cfg8, positions=jnp.asarray(pos),
        window=window, kv_cache=tuple(jnp.asarray(c) for c in cache),
        cache_index=jnp.asarray(lens), attend_local=local, backend="xla")
    tcache = tuple(torch.from_numpy(c.copy()) for c in cache)
    tout, tnew = layers.attention_apply(
        pt, torch.from_numpy(x), CFG8, positions=torch.from_numpy(pos),
        window=window, kv_cache=tcache,
        cache_index=torch.from_numpy(lens) if lens.ndim else int(lens),
        attend_local=local)
    assert tnew is tcache or all(a is b_ for a, b_ in zip(tnew, tcache))
    # codes round per position from float K/V each package computes in
    # its own order: a code may sit one step off, its scale as close as
    # the K/V themselves
    for got, want in zip(tnew[:2], jcache[:2]):
        diff = np.abs(got.numpy().astype(np.int32)
                      - np.asarray(want).astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.999
    for got, want in zip(tnew[2:], jcache[2:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-4,
                               rtol=0)


def test_init_cache_holds_codes_and_scales():
    c = lm.init_cache(CFG8, 3, MAX_LEN, CFG.act_dtype, "cpu")
    shape = (CFG.n_layers, 3, CFG.n_kv_heads, MAX_LEN, CFG.d_head)
    assert sorted(c) == ["index", "k", "k_scale", "v", "v_scale"]
    assert c["k"].dtype == c["v"].dtype == torch.int8
    assert tuple(c["k"].shape) == shape
    for name in ("k_scale", "v_scale"):
        assert c[name].dtype == torch.float32
        assert tuple(c[name].shape) == shape[:-1] + (1,)
        assert bool((c[name] == 1).all())
    assert sorted(lm.init_cache(CFG, 1, 8, "float32", "cpu")) == \
        ["index", "k", "v"]
    assert not lm.supports_paged_decode(CFG8) and lm.int8_kv(CFG8)


def test_prefill_decode_and_chunk_logits_match_jax(jx, params):
    """Prefill over an int8 cache, then the port's decode step and chunk on
    exactly the JAX package's cache (bridged), logits against JAX's."""
    jp, tp = params
    jnp = jx.jnp
    toks = np.random.default_rng(4).integers(0, CFG.vocab_size, (2, 21))
    jl, jc = jx.lm.prefill(jp, jnp.asarray(toks[:, :13], jnp.int32),
                           jx.cfg8, max_len=MAX_LEN)
    tl, tc = lm.prefill(tp, torch.as_tensor(toks[:, :13]), CFG8,
                        max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
    assert tc["k"].dtype == torch.int8 and tc["index"] == 13
    np.testing.assert_allclose(tc["k_scale"].numpy(), _np(jc["k_scale"]),
                               rtol=1e-5)
    cache = bridge.cache_from_numpy(jx.jax.tree.map(np.asarray, jc), CFG8,
                                    device="cpu")
    assert cache["index"] == 13 and cache["k"].dtype == torch.int8
    step = jnp.asarray(toks[:, 13:14], jnp.int32)
    jd, jc2 = jx.lm.decode_step(jp, dict(jc), step, jx.cfg8)
    td, tc2 = lm.decode_step(tp, cache, torch.as_tensor(toks[:, 13:14]),
                             CFG8)
    np.testing.assert_allclose(td.numpy(), _np(jd), **LOGIT_TOL)
    assert tc2["index"] == 14
    # the step wrote position 13 as JAX did, codes within one step
    diff = np.abs(tc2["k"][:, :, :, 13].numpy().astype(np.int32)
                  - np.asarray(jc2["k"][:, :, :, 13]).astype(np.int32))
    assert diff.max() <= 1
    cache = bridge.cache_from_numpy(jx.jax.tree.map(np.asarray, jc2), CFG8,
                                    device="cpu")
    chunk = toks[:, 14:]
    jl3, _ = jx.lm.prefill_chunk(jp, dict(jc2), jnp.asarray(chunk, jnp.int32),
                                 jx.cfg8, 14)
    tl3, tc3 = lm.prefill_chunk(tp, cache, torch.as_tensor(chunk), CFG8, 14)
    np.testing.assert_allclose(tl3.numpy(), _np(jl3), **LOGIT_TOL)
    assert tc3["index"] == 21


def test_cache_bridge_rejects_a_mismatched_cache(jx, params):
    jp, _ = params
    _, jc = jx.lm.prefill(jp, jx.jnp.zeros((1, 4), jx.jnp.int32), jx.cfg8,
                          max_len=8)
    tree = jx.jax.tree.map(np.asarray, jc)
    bad = dict(tree)
    del bad["v_scale"]
    with pytest.raises(ValueError, match="int8 cache"):
        bridge.cache_from_numpy(bad, CFG8, device="cpu")
    bad = dict(tree, k_scale=tree["k_scale"][..., 0])
    with pytest.raises(ValueError, match="k_scale"):
        bridge.cache_from_numpy(bad, CFG8, device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        bridge.cache_from_numpy(tree, dataclasses.replace(CFG8, n_layers=3),
                                device="cpu")
    _, jc16 = jx.lm.prefill(jp, jx.jnp.zeros((1, 4), jx.jnp.int32), jx.cfg,
                            max_len=8)
    c16 = bridge.cache_from_numpy(jx.jax.tree.map(np.asarray, jc16), CFG,
                                  device="cpu")
    assert sorted(c16) == ["index", "k", "v"] and c16["index"] == 4


def test_int8_decode_close_to_bf16_cache(params):
    """The JAX package's own bound: decode logits off the int8 cache within
    0.05 (relative to the largest logit) of the float cache's, at under
    0.6x a bf16 cache's bytes."""
    _, tp = params
    rng = np.random.default_rng(0)
    b, s = 2, 20
    toks = torch.as_tensor(rng.integers(0, CFG.vocab_size, (b, s)))
    _, c16 = lm.prefill(tp, toks[:, :s - 1], CFG, max_len=s + 2)
    d16, _ = lm.decode_step(tp, c16, toks[:, s - 1:], CFG)
    _, c8 = lm.prefill(tp, toks[:, :s - 1], CFG8, max_len=s + 2)
    assert c8["k"].dtype == torch.int8 and "k_scale" in c8
    d8, _ = lm.decode_step(tp, c8, toks[:, s - 1:], CFG8)
    bytes16 = c16["k"].numel() * 2
    bytes8 = c8["k"].numel() * 1 + c8["k_scale"].numel() * 4
    assert bytes8 < 0.6 * bytes16
    rel = float((d8 - d16).abs().max() / (d16.abs().max() + 1e-9))
    assert rel < 0.05, rel


@pytest.mark.parametrize("run", ["drain", "serve"])
def test_port_engine_matches_jax_engine_on_int8_cache(jx, params, run):
    """Mixed lengths through the continuous scheduler (drain) and equal
    lengths through the batch-synchronous loop (serve): the port's tokens
    are the JAX engine's, off the int8 slot cache with no page pool."""
    from repro_torch.serve.engine import Engine

    jp, tp = params
    rng = np.random.default_rng(7)
    lens = [7, 12, 2, 23] if run == "drain" else [9, 9, 9]
    prompts = [rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32)
               for n in lens]
    out = []
    for eng in (Engine(CFG8, tp, max_len=MAX_LEN, device="cpu"),
                jx.Engine(jx.cfg8, jp, max_len=MAX_LEN)):
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.drain() if run == "drain" else eng.serve(reqs)
        assert all(r.state.value == "done" for r in reqs)
        out.append([list(r.out_tokens) for r in reqs])
    assert out[0] == out[1]
    port = Engine(CFG8, tp, max_len=MAX_LEN, device="cpu")
    port.submit(prompts[0], 2)
    port.drain()
    assert port._scheduler.paged is None
    assert port._scheduler.cache["k"].dtype == torch.int8


def test_scheduler_builds_no_pool_for_an_int8_cache(params):
    """The pool holds float K/V: an int8 config gets no mirror pool and no
    prefix reuse (a shared prefix is prefilled again), and decodes off the
    slot cache, whose codes and scales the installed rows fill."""
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import ContinuousScheduler

    _, tp = params
    eng = Engine(CFG8, tp, max_len=MAX_LEN, device="cpu")
    sched = ContinuousScheduler(eng)
    assert sched.paged is None and not sched.use_paged
    rng = np.random.default_rng(3)
    shared = rng.integers(0, CFG.vocab_size, (19,)).astype(np.int32)
    for p in (shared, np.concatenate([shared[:16], shared[:5]])):
        sched.enqueue(eng.submit(p, 3))
    eng._backlog.clear()
    sched.step()                       # the first prompt, and a decode step
    assert sched.cache["k"].dtype == torch.int8
    live = int(sched.cache["index"][0])
    assert live == 19 + 1
    assert bool((sched.cache["k_scale"][:, 0, :, :live] != 1).any())
    sched.drain()
    assert sched.report()["paged_decode"] is False


def test_warm_snapshot_restore_of_int8_slot_cache(params, tmp_path):
    """The batch loop over an int8 slot cache, snapshotted every 2 steps and
    killed (the journal's last tokens and terminals lost): a fresh engine
    restores the snapshot's codes and scales and finishes with the
    uninterrupted tokens."""
    import json
    import os

    from repro_torch.serve.engine import Engine

    _, tp = params
    prompts = np.random.default_rng(0).integers(
        0, CFG.vocab_size, (2, 8)).astype(np.int32)

    def run(jdir, **kw):
        eng = Engine(CFG8, tp, max_len=MAX_LEN, device="cpu",
                     journal_dir=str(jdir), **kw)
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.serve(reqs)
        return [list(r.out_tokens) for r in reqs]

    base = run(tmp_path / "base")
    jdir = tmp_path / "crash"
    assert run(jdir, snapshot_every=2) == base
    path = os.path.join(str(jdir), "journal.jsonl")
    keep = [line for line in open(path).readlines()
            if json.loads(line)["rec"]["kind"] not in ("done", "failed",
                                                       "evicted")]
    tok = [i for i, line in enumerate(keep)
           if json.loads(line)["rec"]["kind"] == "token"]
    open(path, "w").writelines(
        line for i, line in enumerate(keep) if i not in set(tok[-2:]))
    eng = Engine(CFG8, tp, max_len=MAX_LEN, device="cpu",
                 journal_dir=str(jdir))
    rec = eng.restore()
    armed = eng._pending_resume
    cache = armed["cache"]
    assert cache is not None and cache["k"].dtype == torch.int8
    assert cache["k_scale"].dtype == torch.float32
    eng.serve(rec)
    assert [list(r.out_tokens) for r in rec] == base
    assert [r.state.value for r in rec] == ["done"] * 2
    st = eng.stats()
    assert st["recovered"] == 2 and st["replay_divergence"] == 0


def test_int8_kernel_paths_are_registered_and_counted(monkeypatch):
    """The int8 launches' keys: registered beside the bf16 kernels they
    share a source with, and counted beside the library's count (and B7's
    cluster tile's) when a launch is given ``also``."""
    from repro_torch.core.dataflow import registered_kernels

    regs = registered_kernels()
    for key, library in (("flash_attention_i8kv", "flash_attention"),
                         ("kv_stationary_cluster_i8kv", "kv_stationary"),
                         ("flash_attention_f32_i8kv", "flash_attention"),
                         ("kv_stationary_f32_i8kv", "kv_stationary")):
        assert key in _build.I8KV_LAUNCHES and key in _build.LAUNCHES
        assert regs[key].source == regs[library].source
        assert regs[key].replaces == regs[library].replaces

    class Lib:
        @staticmethod
        def flash_attention(*args):
            return 0

        @staticmethod
        def kv_stationary(*args):
            took = args[-2]
            took[0], took[1], took[2], took[3] = 1, 66176, 16, 2
            return 0

    monkeypatch.setattr(_build, "library", lambda name: Lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    assert _build.launch("flash_attention", 1,
                         also="flash_attention_i8kv") is None
    assert _build.launch("kv_stationary", 1,
                         also="kv_stationary_cluster_i8kv") == \
        ("kv_stationary_cluster", 66176, 16, 2)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "flash_attention": 1, "flash_attention_i8kv": 1, "kv_stationary": 1,
        "kv_stationary_cluster": 1, "kv_stationary_cluster_i8kv": 1}


def test_kv_int8_plan_is_pinned():
    """B7's int8 cluster kernel keeps the bf16 plan's clusters and CTAs;
    its shared memory is the ring of 2 int8 K and V blocks, the block
    converted to bf16 with its 128 scales, and 4 mbarriers (a 128-byte
    line)."""
    for (b, hq, hkv, sq, skv, d), smem in (
            ((1, 16, 8, 512, 512, 128), 2 * 16384 + 32768 + 512 + 128),
            ((2, 8, 2, 200, 200, 32), 2 * 4096 + 8192 + 512 + 128)):
        bf16 = attention_df.kv_stationary_plan(b, hq, hkv, sq, skv, d=d)
        i8 = attention_df.kv_stationary_plan(b, hq, hkv, sq, skv, d=d,
                                             kv_int8=True)
        assert i8.smem_bytes == smem
        assert (i8.cluster, i8.ctas) == (bf16.cluster, bf16.ctas)
        attention_df.check_took(i8, ("kv_stationary_cluster", smem, i8.ctas,
                                     i8.cluster))
        with pytest.raises(_build.KernelError, match="plan says"):
            attention_df.check_took(i8, ("kv_stationary_cluster",
                                         bf16.smem_bytes, i8.ctas,
                                         i8.cluster))
