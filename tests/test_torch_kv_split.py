"""Cache attention split over the keys: B2's row statistics and the
log-sum-exp merge.

On the CPU, on seeded numpy inputs handed to both packages:

  * B2's plain version (``attention_df.flash_attention``, which is
    ``ref.attention_ref`` for CPU tensors) with ``return_lse`` over each
    of 1, 2 and 4 key ranges of a cache, each range banded by ``kv_len -
    k0`` (lengths below 0 and over the range's size among them), merged
    by ``parallel.merge_key_ranges``, against the JAX package's
    ``ref.attention_ref`` over the whole buffer: bf16 and float32 q,
    float and int8 K/V with per-position scales, groups 1, 2 and 16,
    d_head 16 and 128, scalar and per-row ``kv_len``, causal with and
    without a window that straddles a range boundary, Sq 1 and 5.  Each
    range's statistic against a ``torch.logsumexp`` of its logits under
    a mask built here from the rows' and keys' positions in the whole
    cache; one range's merge equal to the unsplit output bit for bit;
  * ``merge_key_ranges``' edges (rows no range sees, a range seeing
    none), ``ops.attention(return_lse=True)`` pinned to B2, and the
    statistics launch counted under ``flash_attention_lse`` beside B2's
    own count;
  * ``layers.attention_key_range`` writing the fresh K/V into a range's
    buffers exactly where its positions fall, and the decode step of the
    qwen3 smoke config with its cache attention split over 2 and 4 key
    ranges on one device (``parallel.Splits(keys=)``), from a float and an
    int8 cache, scalar and per-row index, against the JAX
    ``decode_step``, and its ``prefill_chunk`` split likewise (chunks
    across a range boundary and wholly in one range) against the JAX
    ``prefill_chunk`` and the unsplit chunk.

On the card (marker ``card``, skipped here): B2's statistics against its
plain version on every path (bf16 and f32 q, float and int8 K/V) at
d_head 16 and 128, over ranges seen whole, in part and not at all, and
the output of a launch with statistics equal to one without, bit for
bit.  Those tests import no JAX:

    PYTHONPATH=src python -m pytest --noconftest -q -m card \\
        tests/test_torch_kv_split.py
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import quant
from repro_torch.kernels import _build, attention_df, ops, ref
from repro_torch.models import layers, lm, parallel

# Against the JAX oracle over the whole buffer, relative to each element
# and, absolute, to the outputs' largest magnitude (an output near 0 is a
# difference of terms of that size).  float32: the same f32 softmax cut
# into ranges and merged, so only the order of the sums and the merge's
# exp/divide differ (1e-5).  bf16 q: every range's output is rounded to
# bf16 before the merge and the merge rounds again, against one rounding
# of the whole: two bf16 roundings, 2^-8 relative each.
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# Statistics against an independent logsumexp, both f32 over the same
# logits.
LSE_TOL = dict(atol=1e-5, rtol=1e-5)
# On the card, B2's kernels against its plain version: chip_smoke.py's B2
# tolerances (bf16 outputs, float32 outputs) and its statistics' (an f32
# log-sum-exp summed in another order).
CARD_TOL = {torch.bfloat16: dict(atol=4e-3, rtol=8e-3),
            torch.float32: dict(atol=1e-4, rtol=1e-4)}
CARD_LSE_TOL = dict(atol=1e-4, rtol=1e-5)

SKV, B = 16, 3
# (kv_len per row, Sq): scalar and per-row lengths, per-row lengths whose
# rows see some ranges whole and others not at all.
LENGTHS = {"scalar": 13, "per_row": [16, 9, 3]}
WINDOW = 6        # straddles the boundaries at 4, 8 and 12


def _draw(seed, dtype, kv, group, d, sq):
    """q (B, Hq, Sq, D), K/V (B, Hkv, SKV, D) as numpy float32 (bf16
    values for bf16), and for int8 K/V codes with per-position scales."""
    rng = np.random.default_rng(seed)
    hkv = 2 if group < 16 else 1
    hq = hkv * group
    q = rng.normal(size=(B, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(B, hkv, SKV, d)).astype(np.float32)
    v = rng.normal(size=(B, hkv, SKV, d)).astype(np.float32)
    if dtype == torch.bfloat16:
        q, k, v = (torch.from_numpy(a).to(dtype).float().numpy()
                   for a in (q, k, v))
    if kv == "float":
        return q, k, v, None, None
    (kq, ks), (vq, vs) = (quant.symmetric_int8(torch.from_numpy(a), -1)
                          for a in (k, v))
    return q, kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy()


def _jax_whole(q, k, v, ks, vs, dtype, kv_len, window):
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    kdt = jnp.int8 if ks is not None else jdt
    out = jref.attention_ref(
        jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(kdt),
        jnp.asarray(v).astype(kdt), causal=True, window=window,
        kv_len=jnp.asarray(kv_len, dtype=jnp.int32),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs))
    return np.asarray(out.astype(jnp.float32))


def _mask(sq, k0, n, kv_len, window):
    """(B, 1, Sq, n): which keys of the range [k0, k0 + n) each row sees,
    from positions in the whole cache: row i of batch row b sits at
    ``i + kv_len[b] - Sq``."""
    lens = np.broadcast_to(np.asarray(kv_len), (B,))
    pos = np.arange(sq)[None, :, None] + lens[:, None, None] - sq
    key = k0 + np.arange(n)[None, None, :]
    seen = (key < lens[:, None, None]) & (key <= pos)
    if window is not None:
        seen &= key > pos - window
    return torch.from_numpy(seen[:, None])


def _ranges(n_ranges):
    step = SKV // n_ranges
    return [(k0, step) for k0 in range(0, SKV, step)]


def _local_len(kv_len, k0):
    if isinstance(kv_len, list):
        return torch.tensor(kv_len, dtype=torch.int32) - k0
    return kv_len - k0


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("group", [1, 2, 16])
@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_split_and_merge_equals_jax_whole_buffer(dtype, kv, group, d):
    seed = 7 * group + d + (kv == "int8") + 3 * (dtype == torch.bfloat16)
    for sq in (1, 5):
        q, k, v, ks, vs = _draw(seed + sq, dtype, kv, group, d, sq)
        tq = torch.from_numpy(q).to(dtype)
        tk = torch.from_numpy(k) if ks is not None else \
            torch.from_numpy(k).to(dtype)
        tv = torch.from_numpy(v) if vs is not None else \
            torch.from_numpy(v).to(dtype)
        tks = None if ks is None else torch.from_numpy(ks)
        tvs = None if vs is None else torch.from_numpy(vs)
        hkv = tk.shape[1]
        for lens in LENGTHS.values():
            for window in (None, WINDOW):
                want = _jax_whole(q, k, v, ks, vs, dtype, lens, window)
                whole = attention_df.flash_attention(
                    tq, tk, tv, window=window,
                    kv_len=_local_len(lens, 0), k_scale=tks, v_scale=tvs)
                for n_ranges in (1, 2, 4):
                    outs, lses = [], []
                    for k0, n in _ranges(n_ranges):
                        sl = slice(k0, k0 + n)
                        out, lse = attention_df.flash_attention(
                            tq, tk[:, :, sl], tv[:, :, sl], window=window,
                            kv_len=_local_len(lens, k0),
                            k_scale=None if tks is None else tks[:, :, sl],
                            v_scale=None if tvs is None else tvs[:, :, sl],
                            return_lse=True)
                        assert out.dtype == dtype and lse.dtype == \
                            torch.float32
                        assert lse.shape == tq.shape[:3]
                        # the statistic: a logsumexp of the range's logits
                        logits = torch.einsum(
                            "bhgqd,bhkd->bhgqk",
                            tq.float().reshape(B, hkv, group, sq, d),
                            tk[:, :, sl].float()) * d ** -0.5
                        if tks is not None:
                            logits = logits * tks[:, :, sl, 0][
                                :, :, None, None, :]
                        seen = _mask(sq, k0, n, lens, window)[:, :, None]
                        lse_want = torch.logsumexp(
                            logits.masked_fill(~seen, float("-inf")), -1)
                        torch.testing.assert_close(
                            lse, lse_want.reshape(lse.shape), **LSE_TOL)
                        outs.append(out)
                        lses.append(lse)
                    merged = parallel.merge_key_ranges(outs, lses)
                    tol = TOL[dtype]
                    np.testing.assert_allclose(
                        merged.float().numpy(), want, rtol=tol,
                        atol=tol * float(np.abs(want).max()))
                    if n_ranges == 1:
                        assert torch.equal(merged, whole)


def test_ranges_cover_each_domain_of_the_length():
    """The cases above hold ranges that a row sees whole (local length
    over the range), in part, and not at all (local length <= 0)."""
    kinds = set()
    for lens in LENGTHS.values():
        for n_ranges in (2, 4):
            for k0, n in _ranges(n_ranges):
                for ln in np.broadcast_to(np.asarray(lens) - k0, (B,)):
                    kinds.add("none" if ln <= 0 else
                              "whole" if ln > n else "part")
    assert kinds == {"none", "whole", "part"}


def test_merge_edges():
    """A row no range sees merges to 0; a range that sees none of a row's
    keys weighs 0; the merge is in the outputs' dtype."""
    out_a = torch.ones(1, 1, 2, 4)
    out_b = torch.full((1, 1, 2, 4), 3.0)
    inf = float("-inf")
    lse_a = torch.tensor([[[0.0, inf]]])
    lse_b = torch.tensor([[[inf, inf]]])
    got = parallel.merge_key_ranges([out_a, torch.zeros_like(out_b)],
                                    [lse_a, lse_b])
    assert torch.equal(got[0, 0, 0], torch.ones(4))
    assert torch.equal(got[0, 0, 1], torch.zeros(4))
    # equal statistics: the mean; log 3 against log 1: weights 3 : 1
    got = parallel.merge_key_ranges(
        [out_a.bfloat16(), out_b.bfloat16()],
        [torch.tensor([[[0.0, np.log(3.0)]]]), torch.zeros(1, 1, 2)])
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got[0, 0, 0].float(), torch.full((4,), 2.0))
    torch.testing.assert_close(got[0, 0, 1].float(), torch.full((4,), 1.5))


def test_ops_attention_statistics_pin_b2():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(2, 4, 1, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 2, 8, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 2, 8, 16)).astype(np.float32))
    out, lse = ops.attention(q, k, v, kv_len=-2, return_lse=True)
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.isneginf(lse).all()
    out, lse = ops.attention(q, k, v, kv_len=20, return_lse=True,
                             backend="torch")
    want, want_lse = ref.attention_ref(q, k, v, kv_len=20, return_lse=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    # a range wholly before the row is seen whole
    assert torch.equal(out, ref.attention_ref(q, k, v, causal=False))
    with pytest.raises(ValueError, match="OS anchor"):
        ops.attention(q, k, v, anchor="ws", return_lse=True)


def test_statistics_launch_is_registered_and_counted(monkeypatch):
    from repro_torch.core.dataflow import registered_kernels

    regs = registered_kernels()
    key = attention_df.FLASH_LSE.name
    assert key == _build.FLASH_LSE and key in _build.LAUNCHES
    assert regs[key].source == regs["flash_attention"].source
    assert regs[key].replaces == regs["flash_attention"].replaces

    class Lib:
        @staticmethod
        def flash_attention(*args):
            return 0

    monkeypatch.setattr(_build, "library", lambda name: Lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    _build.launch("flash_attention", 1, also=(key, "flash_attention_i8kv"))
    _build.launch("flash_attention", 1, also=())
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "flash_attention": 2, "flash_attention_i8kv": 1, key: 1}
    # q, k, v, the scales, out and the statistics: seven pointers first
    sig = _build.SIGNATURES["flash_attention"]
    assert sig[:8] == (ctypes.c_void_p,) * 7 + (ctypes.c_int,)


@pytest.mark.parametrize("idx", [3, 5, 9, [1, 4, 7], [6, 2, 10]],
                         ids=lambda i: str(i))
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_key_range_writes_its_positions_only(idx, int8):
    """Each range's buffers receive exactly the fresh K/V (codes and
    scales for an int8 cache) whose positions fall in them: cut into
    ranges, the writes rebuild ``attention_apply``'s cache."""
    cfg = dataclasses.replace(configs.get_smoke("qwen3-1.7b"),
                              kv_cache_dtype="int8" if int8 else "auto")
    p = lm.init_model(cfg, seed=1, device="cpu")["layers"]["attn"]
    p = {k: v[0] for k, v in p.items()}
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(3, 2, cfg.d_model))
                         .astype(np.float32))
    index = torch.tensor(idx) if isinstance(idx, list) else idx
    pos = (index[:, None] if torch.is_tensor(index) else index) \
        + torch.arange(2)[None, :]
    whole = lm._layer_cache(lm.init_cache(cfg, 3, 12, "float32", "cpu"), 0)
    split = tuple(b.clone() for b in whole)
    layers.attention_apply(p, x, cfg, positions=pos, kv_cache=whole,
                           cache_index=index)
    for k0 in (0, 4, 8):
        own = tuple(b[:, :, k0:k0 + 4].clone() for b in split)
        layers.attention_key_range(p, x, cfg, pos, None, own, index, k0)
        for got, want in zip(own, whole):
            assert torch.equal(got, want[:, :, k0:k0 + 4])


def _jax_decode_logits(cfg_name, over, toks, steps, ragged):
    """The JAX parameters, prefill cache (numpy) and decode logits."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import lm as jlm

    jcfg = dataclasses.replace(jconfigs.get_smoke(cfg_name), **over)
    jp = jlm.init_model(jcfg, jax.random.PRNGKey(2))
    logits, cache = jlm.prefill(jp, jnp.asarray(toks), jcfg, max_len=24)
    prefilled = jax.tree.map(np.asarray, cache)
    got = []
    for j, nxt in enumerate(steps):
        cache = dict(cache)
        if j == len(steps) - 1:
            cache["index"] = jnp.asarray(ragged)
        logits, cache = jlm.decode_step(jp, cache, jnp.asarray(nxt), jcfg)
        got.append(np.asarray(logits))
    return jp, prefilled, np.stack(got)


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_key_ranges_decode_matches_jax(kv):
    """The qwen3 smoke decoder's decode steps with the cache attention
    split over 2 and 4 key ranges of its 24 positions (``Splits``),
    the last step at one index per row (a row whose keys all lie in the
    first range), against the JAX ``decode_step`` on one device.  Both
    decode from the JAX prefill's cache (``bridge.cache_from_numpy``): a
    prefill value quantized to the next int8 code by one package and not
    the other (the two round f32 sums apart) moves the logits by ~1e-3,
    on one device as much as split."""
    import jax

    from repro_torch.models import bridge

    over = {"kv_cache_dtype": kv}
    cfg = dataclasses.replace(configs.get_smoke("qwen3-1.7b"), **over)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, (3, 4, 1)).astype(np.int32)
    ragged = np.array([4, 17, 11, 12], dtype=np.int32)
    jp, prefilled, want = _jax_decode_logits("qwen3-1.7b", over, toks,
                                             steps, ragged)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      device="cpu")
    for n_ranges in (2, 4):
        cache = bridge.cache_from_numpy(prefilled, cfg, device="cpu")
        got = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(lm, "_runner",
                       lambda dist: parallel.Splits(keys=n_ranges))
            for j, nxt in enumerate(steps):
                if j == len(steps) - 1:
                    cache["index"] = torch.from_numpy(ragged)
                logits, cache = lm.decode_step(params, cache,
                                               torch.from_numpy(nxt), cfg)
                got.append(logits.numpy())
        got = np.stack(got)[..., :cfg.vocab_size]
        np.testing.assert_allclose(got, want[..., :cfg.vocab_size],
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_key_ranges_prefill_chunk_matches_jax(kv):
    """``lm.prefill_chunk`` with the cache attention split over 2 and 4
    key ranges of its 24 positions (``Splits``: S queries a range, valid
    length ``start + S - k0``): a chunk at 9-15 (across the 2 ranges'
    boundary at 12), then one at 16-21 (wholly in the second, the first
    seen whole), each chunk's logits against the JAX ``prefill_chunk`` on
    one device and the unsplit chunk, from the JAX prefill's cache of 9
    positions (``bridge.cache_from_numpy``)."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import lm as jlm

    from repro_torch.models import bridge

    over = {"kv_cache_dtype": kv}
    cfg = dataclasses.replace(configs.get_smoke("qwen3-1.7b"), **over)
    jcfg = dataclasses.replace(jconfigs.get_smoke("qwen3-1.7b"), **over)
    rng = np.random.default_rng(12)
    head = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    chunks = [(9, rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)),
              (16, rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32))]
    jp = jlm.init_model(jcfg, jax.random.PRNGKey(4))
    _, jc = jlm.prefill(jp, jnp.asarray(head), jcfg, max_len=24)
    prefilled = jax.tree.map(np.asarray, jc)
    want = []
    for start, toks in chunks:
        logits, jc = jlm.prefill_chunk(jp, jc, jnp.asarray(toks), jcfg,
                                       start)
        want.append(np.asarray(logits))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      device="cpu")
    runs = {}
    for n_ranges in (1, 2, 4):
        cache = bridge.cache_from_numpy(prefilled, cfg, device="cpu")
        got = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(lm, "_runner",
                       lambda dist: parallel.Splits(keys=n_ranges))
            for start, toks in chunks:
                logits, cache = lm.prefill_chunk(
                    params, cache, torch.from_numpy(toks), cfg, start)
                got.append(logits.numpy())
        runs[n_ranges] = np.stack(got)[..., :cfg.vocab_size]
        np.testing.assert_allclose(
            runs[n_ranges], np.stack(want)[..., :cfg.vocab_size],
            atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(runs[n_ranges], runs[1], atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B2's statistics are written by its "
                    "CUDA kernels")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_card_statistics_match_plain(card, dtype, kv, d):
    gen = torch.Generator(device=card).manual_seed(d)
    b, hq, hkv, skv = 3, 8, 2, 200
    for sq in (1, 5, 70):
        q = torch.randn((b, hq, sq, d), generator=gen, device=card).to(dtype)
        k, v = (torch.randn((b, hkv, skv, d), generator=gen,
                            device=card).to(dtype) for _ in range(2))
        ks = vs = None
        if kv == "int8":
            (k, ks), (v, vs) = (quant.symmetric_int8(t, -1) for t in (k, v))
        for kv_len in (-3, 0, 90, skv, 330,
                       torch.tensor([250, -40, 120], device=card)):
            for window in (None, 64):
                kw = dict(window=window, kv_len=kv_len, k_scale=ks,
                          v_scale=vs)
                before = _build.LAUNCHES[_build.FLASH_LSE]
                out, lse = attention_df.flash_attention(q, k, v, **kw,
                                                        return_lse=True)
                torch.cuda.synchronize()
                assert _build.LAUNCHES[_build.FLASH_LSE] == before + 1
                plain, plain_lse = ref.attention_ref(q, k, v, **kw,
                                                     return_lse=True)
                torch.testing.assert_close(out.float(), plain.float(),
                                           **CARD_TOL[dtype])
                assert torch.equal(torch.isneginf(lse),
                                   torch.isneginf(plain_lse))
                seen = ~torch.isneginf(plain_lse)
                torch.testing.assert_close(lse[seen], plain_lse[seen],
                                           **CARD_LSE_TOL)
                assert torch.equal(out, attention_df.flash_attention(
                    q, k, v, **kw))
