"""The audio encoder-decoder of the port (whisper) against the JAX
package's, and the teacher-forced ``forward`` of every family, on the
smoke configs (float32, CPU): whisper-smoke has 2 encoder and 2 decoder
layers, d_model 64, 4 heads of 16, d_ff 128.

Piece by piece: ``layers.bidir_attention`` through both of its branches
(the masked einsum, and the double-chunked online softmax forced by a
small ``chunked_threshold``, also at chunks smaller than the inputs),
``lm.encode`` and ``lm._cross_attention``, each within atol 1e-5 (the
frameworks order their float32 sums differently); the bridged layout
against the port's ``init_model``.  Then the model: ``forward`` of
every family's smoke config (qwen3, the moonshot MoE with its summed
load-balancing loss, mamba2, hymba and whisper) within the dense tests'
ATOL 1e-4; ``prefill(enc_frames=)`` and ``decode_step`` logits and every
cache buffer, ``cross_k``/``cross_v`` included, over a float and an int8
KV cache, the JAX cache crossing over through ``cache_from_numpy``; the
reference's decode-consistency invariant port against port (``forward``
against ``prefill`` + ``decode_step``, rtol/atol 1e-3 as in
``tests/test_arch_smoke.py``); ``hot_conv_problems`` equal to the
reference's field by field; the grouped and depthwise conv twins (float
within 1e-6, int8 bit for bit); and the audio ``Engine``'s outcome
against the JAX engine's: every request FAILED on a whole-prompt prefill
(neither engine passes frames), the same tokens with chunked prefill.

Inputs come from seeded numpy generators; the JAX parameters
(``repro.models.lm.init_model``) cross over through
``models.bridge.params_from_numpy``.  On the CPU only
(``JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q
tests/test_torch_audio.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro_torch import configs
from repro_torch.kernels import ref
from repro_torch.models import bridge, layers, lm
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import SchedulerConfig

NAME = "whisper-tiny"
MAX_LEN = 24
ATOL = 1e-4                 # the dense tests' bound on float32 logits
PIECE_ATOL = 1e-5           # one attention or encoder pass
CONSISTENCY = dict(rtol=1e-3, atol=1e-3)   # tests/test_arch_smoke.py:62-66
# (registry name, config changes) of each family's smoke config.
FAMILIES = {"qwen3": ("qwen3-1.7b", ()),
            "moonshot": ("moonshot-v1-16b-a3b", ()),
            "mamba2": ("mamba2-780m", ()),
            "hymba": ("hymba-1.5b", ()),
            "hymba4": ("hymba-1.5b", (("n_layers", 4),)),
            "whisper": (NAME, ()),
            "whisper_int8": (NAME, (("kv_cache_dtype", "int8"),))}


@functools.lru_cache(maxsize=None)
def _both(case: str):
    """(port cfg, JAX cfg, JAX params, port params) of a ``FAMILIES``
    entry, the port's bridged from the JAX package's."""
    name, changes = FAMILIES[case]
    cfg = dataclasses.replace(configs.get_smoke(name), **dict(changes))
    jcfg = dataclasses.replace(jconfigs.get_smoke(name), **dict(changes))
    jp = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, jp, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _close(got, want, atol=ATOL, rtol=0.0) -> None:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _frames(cfg, b, s, seed):
    return _rand((b, s, cfg.d_model), seed) if cfg.is_encoder_decoder \
        else None


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Config, layout.
# ---------------------------------------------------------------------------
def test_config_twin_has_the_reference_values():
    for get, jget in ((configs.get, jconfigs.get),
                      (configs.get_smoke, jconfigs.get_smoke)):
        cfg, jcfg = get(NAME), jget(NAME)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        for prop in ("padded_vocab", "q_dim", "kv_dim", "has_attention",
                     "has_ssm"):
            assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    full = configs.get(NAME)
    assert (full.n_enc_layers, full.n_layers, full.d_model, full.n_heads,
            full.d_head, full.d_ff, full.padded_vocab) == \
        (4, 4, 384, 6, 64, 1536, 51_968)
    assert NAME in configs.ARCH_NAMES and not configs.QUEUED
    for cfg in (full, configs.get_smoke(NAME)):
        lm._check_supported(cfg)
        assert not lm.supports_paged_decode(cfg)


def test_bridge_gives_the_init_model_layout():
    cfg, _, _, tp = _both("whisper")
    fresh = lm.init_model(cfg, seed=0, device="cpu")

    def shapes(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(shapes(v, prefix + (k,)))
            else:
                out[prefix + (k,)] = (tuple(v.shape), v.dtype)
        return out

    got = shapes(tp)
    assert got == shapes(fresh)
    assert got[("encoder", "layers", "mlp", "w2")][0] == (2, 128, 64)
    assert got[("layers", "cross", "wk")][0] == (2, 64, 64)
    assert set(got) == set(bridge.expected_shapes(cfg))


def test_bridge_rejects_a_tree_without_the_encoder():
    cfg, _, jp, _ = _both("whisper")
    tree = jax.tree.map(np.asarray, jp)
    del tree["encoder"]["final_norm"]
    del tree["layers"]["cross"]["wv"]
    with pytest.raises(ValueError, match="missing layers.cross.wv") as err:
        bridge.params_from_numpy(tree, cfg, device="cpu")
    assert "missing encoder.final_norm" in str(err.value)


# ---------------------------------------------------------------------------
# The pieces.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("threshold", [2048, 8], ids=["plain", "chunked"])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_bidir_attention_matches_both_branches(threshold, heads):
    hq, hkv = heads
    q, k, v = (_rand((2, hq, 7, 16), 1), _rand((2, hkv, 19, 16), 2),
               _rand((2, hkv, 19, 16), 3))
    want = jlayers.bidir_attention(*map(jnp.asarray, (q, k, v)), 0.25,
                                   chunked_threshold=threshold)
    got = layers.bidir_attention(*map(torch.from_numpy, (q, k, v)), 0.25,
                                 chunked_threshold=threshold)
    _close(got, want, PIECE_ATOL)


def test_chunked_attention_matches_at_small_chunks():
    """Chunks smaller than the inputs: several q and KV chunks, the last
    of each short (the reference pads it and masks the padding)."""
    q, k, v = (_rand((1, 4, 11, 16), 4), _rand((1, 2, 21, 16), 5),
               _rand((1, 2, 21, 16), 6))
    mask_fn = lambda qp, kp: jnp.ones((qp.shape[0], kp.shape[0]), bool)
    want = jlayers._chunked_attention(*map(jnp.asarray, (q, k, v)),
                                      mask_fn, 0.25, q_chunk=4, kv_chunk=8)
    got = layers._chunked_attention(*map(torch.from_numpy, (q, k, v)), 0.25,
                                    q_chunk=4, kv_chunk=8)
    _close(got, want, PIECE_ATOL)
    _close(got, layers._plain_attention(*map(torch.from_numpy, (q, k, v)),
                                        0.25), PIECE_ATOL)


@pytest.mark.parametrize("enc_len", [9, 40])
def test_encode_matches(enc_len):
    cfg, jcfg, jp, tp = _both("whisper")
    frames = _frames(cfg, 2, enc_len, enc_len)
    want = jlm.encode(jp, jnp.asarray(frames), jcfg)
    got = lm.encode(tp, torch.from_numpy(frames), cfg)
    _close(got, want, PIECE_ATOL)


def test_cross_attention_matches():
    cfg, jcfg, jp, tp = _both("whisper")
    x, enc = _rand((2, 5, cfg.d_model), 7), _rand((2, 13, cfg.d_model), 8)
    want = jlm._cross_attention(_layer0(jp["layers"])["cross"],
                                jnp.asarray(x), jnp.asarray(enc), jcfg)
    got = lm._cross_attention(lm._layer_params(tp)[0]["cross"],
                              torch.from_numpy(x), torch.from_numpy(enc),
                              cfg)
    _close(got, want, PIECE_ATOL)


# ---------------------------------------------------------------------------
# The model.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["qwen3", "moonshot", "mamba2", "hymba",
                                  "hymba4", "whisper"])
def test_forward_matches_every_family(case):
    """Logits at every position and the summed MoE loss (0 elsewhere)."""
    cfg, jcfg, jp, tp = _both(case)
    toks, frames = _tokens(cfg, (2, 12), 11), _frames(cfg, 2, 10, 12)
    want, jaux = jlm.forward(jp, jnp.asarray(toks), jcfg,
                             enc_frames=None if frames is None
                             else jnp.asarray(frames), remat="none")
    got, aux = lm.forward(tp, torch.from_numpy(toks), cfg,
                          enc_frames=None if frames is None
                          else torch.from_numpy(frames))
    assert tuple(got.shape) == (2, 12, cfg.padded_vocab)
    _close(got, want)
    _close(aux, jaux, 1e-5)
    assert (float(aux) > 0) == bool(cfg.n_experts)
    hidden, haux = lm.forward_hidden(tp, torch.from_numpy(toks), cfg,
                                     enc_frames=None if frames is None
                                     else torch.from_numpy(frames))
    assert torch.equal(layers.unembed(lm._head(tp), hidden), got)
    assert torch.equal(haux, aux)


@pytest.mark.parametrize("case", ["whisper", "whisper_int8"])
def test_prefill_and_decode_match_with_the_cross_cache(case):
    cfg, jcfg, jp, tp = _both(case)
    toks, frames = _tokens(cfg, (2, 9), 21), _frames(cfg, 2, 14, 22)
    want, jcache = jlm.prefill(jp, jnp.asarray(toks), jcfg, max_len=MAX_LEN,
                               enc_frames=jnp.asarray(frames))
    got, cache = lm.prefill(tp, torch.from_numpy(toks), cfg,
                            max_len=MAX_LEN,
                            enc_frames=torch.from_numpy(frames))
    _close(got, want)
    assert cache["index"] == int(jcache["index"])
    assert sorted(k for k in cache if k != "index") == \
        sorted(k for k in jcache if k != "index")
    for name in lm.CACHE_KEYS:
        if name in cache:
            assert tuple(cache[name].shape) == tuple(jcache[name].shape)
            _close(cache[name], np.asarray(jcache[name], np.float32))
    assert cache["cross_k"].dtype == torch.float32
    assert cache["k"].dtype == (torch.int8 if case == "whisper_int8"
                                else torch.float32)
    # decode on the JAX package's own cache, carried across
    nxt = _tokens(cfg, (2, 1), 23)
    jlog, jnew = jlm.decode_step(jp, dict(jcache), jnp.asarray(nxt), jcfg)
    tcache = bridge.cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg,
                                     device="cpu")
    tlog, tnew = lm.decode_step(tp, tcache, torch.from_numpy(nxt), cfg)
    _close(tlog[:, :cfg.vocab_size], np.asarray(jlog)[:, :cfg.vocab_size])
    for name in lm.CACHE_KEYS:
        if name in tnew:
            _close(tnew[name], np.asarray(jnew[name], np.float32))
    assert torch.equal(tnew["cross_k"], tcache["cross_k"])
    assert tnew["index"] == int(jnew["index"])


def test_prefill_without_frames_raises_as_the_reference():
    cfg, jcfg, jp, tp = _both("whisper")
    toks = _tokens(cfg, (1, 4), 31)
    with pytest.raises(ValueError, match="enc_frames"):
        jlm.prefill(jp, jnp.asarray(toks), jcfg)
    for fn in (lambda: lm.prefill(tp, torch.from_numpy(toks), cfg),
               lambda: lm.forward(tp, torch.from_numpy(toks), cfg)):
        with pytest.raises(ValueError, match="enc_frames"):
            fn()


@pytest.mark.parametrize("case", ["qwen3", "mamba2", "hymba", "whisper"])
def test_decode_consistency_port_against_port(case):
    """The reference's invariant (``tests/test_arch_smoke.py``): the
    teacher-forced forward's logits at the last position are those of a
    prefill of the rest and one decode step."""
    cfg, _, _, tp = _both(case)
    b, s = 2, 12
    toks = torch.from_numpy(_tokens(cfg, (b, s), 1))
    frames = _frames(cfg, b, s, 2)
    enc = None if frames is None else torch.from_numpy(frames)
    logits, _ = lm.forward(tp, toks, cfg, enc_frames=enc)
    kw = {} if enc is None else {"enc_frames": enc}
    _, cache = lm.prefill(tp, toks[:, :s - 1], cfg, max_len=s + 2, **kw)
    dec, _ = lm.decode_step(tp, cache, toks[:, s - 1:s], cfg)
    np.testing.assert_allclose(dec[:, :cfg.vocab_size].numpy(),
                               logits[:, s - 1, :cfg.vocab_size].numpy(),
                               **CONSISTENCY)


@pytest.mark.parametrize("batch,seq", [(1, 16), (4, 1500), (2, 7)])
@pytest.mark.parametrize("name", [NAME, "qwen3-1.7b"])
def test_hot_problems_equal_the_reference(name, batch, seq):
    for get, jget in ((configs.get, jconfigs.get),
                      (configs.get_smoke, jconfigs.get_smoke)):
        cfg, jcfg = get(name), jget(name)
        got = lm.hot_conv_problems(cfg, batch, seq)
        want = jlm.hot_conv_problems(jcfg, batch, seq)
        assert [dataclasses.asdict(p) for p in got] == \
            [dataclasses.asdict(p) for p in want]
        assert bool(got) == (cfg.family == "audio")
        assert [dataclasses.asdict(p) for p in
                lm.hot_gemm_problems(cfg, batch, seq)] == \
            [dataclasses.asdict(p) for p in
             jlm.hot_gemm_problems(jcfg, batch, seq)]
    assert (lm.AUDIO_N_MELS, lm.AUDIO_CONV_KERNEL) == \
        (jlm.AUDIO_N_MELS, jlm.AUDIO_CONV_KERNEL)


# ---------------------------------------------------------------------------
# The grouped and depthwise conv twins.
# ---------------------------------------------------------------------------
def _conv_inputs(dtype, shape_x, shape_w, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return (rng.integers(-128, 128, shape_x).astype(np.int8),
                rng.integers(-128, 128, shape_w).astype(np.int8))
    return (rng.standard_normal(shape_x).astype(np.float32),
            rng.standard_normal(shape_w).astype(np.float32))


def _conv_check(got, want, dtype):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    if dtype == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("stride,groups", [(1, 2), (2, 4), (1, 8)])
def test_grouped_conv_matches(dtype, stride, groups):
    x, w = _conv_inputs(dtype, (2, 9, 10, 8), (3, 3, 8 // groups, 16),
                        stride + groups)
    want = jref.grouped_conv2d_ref(jnp.asarray(x), jnp.asarray(w), stride,
                                   groups)
    got = ref.grouped_conv2d_ref(torch.from_numpy(x), torch.from_numpy(w),
                                 stride, groups)
    _conv_check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_conv_matches(dtype, stride):
    x, w = _conv_inputs(dtype, (2, 11, 9, 6), (3, 3, 6), 40 + stride)
    want = jref.depthwise_conv2d_ref(jnp.asarray(x), jnp.asarray(w), stride)
    got = ref.depthwise_conv2d_ref(torch.from_numpy(x), torch.from_numpy(w),
                                   stride)
    _conv_check(got, want, dtype)
    # groups == C == Cout: the grouped conv is the depthwise one
    wg = np.asarray(w)[:, :, None, :]
    grouped = ref.grouped_conv2d_ref(torch.from_numpy(x),
                                     torch.from_numpy(wg), stride, groups=6)
    _conv_check(grouped, want, dtype)


def test_grouped_conv_refuses_a_bad_filter():
    x = torch.zeros((1, 4, 4, 6))
    with pytest.raises(ValueError, match="groups"):
        ref.grouped_conv2d_ref(x, torch.zeros((1, 1, 4, 6)), groups=2)


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["whole", "chunked"])
def test_audio_engine_outcome_equals_the_jax_engine(mode):
    """Neither engine passes encoder frames: a whole-prompt prefill fails
    (ValueError, retried, then FAILED), a chunked prefill runs over the
    cache's zero cross K/V and emits tokens; the port gives the JAX
    engine's states, errors' exception class and tokens."""
    cfg, jcfg, jp, tp = _both("whisper")
    prompts = [_tokens(cfg, (n,), 50 + n) for n in (9, 5, 9)]
    sc = dict(prefill_chunk=4) if mode == "chunked" else {}
    out = []
    for make, params, c, sc_cls, kw in (
            (Engine, tp, cfg, SchedulerConfig, {"device": "cpu"}),
            (JaxEngine, jp, jcfg, JaxSchedulerConfig, {})):
        eng = make(c, params, max_len=32, scheduler_config=sc_cls(**sc),
                   **kw)
        reqs = [eng.submit(p, 3) for p in prompts]
        eng.drain()
        out.append([(r.state.value, list(r.out_tokens),
                     (r.error or "").split(":")[-2:-1]) for r in reqs])
    assert out[0] == out[1]
    states = {s for s, _, _ in out[0]}
    assert states == ({"done"} if mode == "chunked" else {"failed"})
    if mode == "whole":
        assert all(" ValueError" in e[0] for _, _, e in out[0])
