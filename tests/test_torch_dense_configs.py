"""The other dense decoders of the port against the JAX package's, on
their smoke configs (2 layers, float32, CPU): minicpm-2b (MHA 6/6,
d_head 16, d_ff 192), mistral-nemo-12b (GQA 4/2, d_head 32),
minitron-8b (untied head, vocab 768) and chameleon-34b (family ``vlm``,
qk-norm, untied head).

Each case is one parametrized test over the four configs: the config
twin's fields and values; the bridged weights' layout (the untied head,
chameleon's qk-norm); prefill logits and cache; ``prefill_chunk``;
paged-decode logits and greedy tokens; the port's ``Engine`` tokens
against the JAX ``Engine``'s.  Then: the port's plain attention at
d_head 16 with float32 queries over int8 K/V against the JAX
``flash_attention`` and ``kv_stationary_attention`` in interpret mode; a
padded vocab (minicpm-smoke at ``vocab_size=509``, padded 512) decoded
and served; chameleon-smoke admitted; the audio smoke config, once queued,
admitted (the MoE configs are held in ``tests/test_torch_moe.py``,
the SSM and hybrid ones in ``tests/test_torch_ssm.py``).

The JAX parameters (``repro.models.lm.init_model``) cross over through
``models.bridge.params_from_numpy``; token ids, page layouts and
attention inputs come from seeded numpy generators and go through both
packages.  Tolerances are ``tests/test_torch_model.py``'s: logits and KV
within atol 1e-4 (float32 through two layers; the two frameworks order
their sums differently), greedy tokens exactly equal; attention over int8
K/V within 2e-5 (``tests/test_torch_int8_kv.py``'s: the JAX kernel
dequantizes K/V at the block load where the port folds the scales into
scores and probabilities, ROADMAP C).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro.serve.engine import Engine as JaxEngine
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.core import quant
from repro_torch.kernels import ops, ref
from repro_torch.models import bridge, lm
from repro_torch.serve.engine import Engine, RequestState

NAMES = ["minicpm-2b", "mistral-nemo-12b", "minitron-8b", "chameleon-34b"]
# The JAX package's configs the port once queued, by the ROADMAP entry
# that ported them: each is now in the registry and admitted.
PORTED_LAST = {"whisper-tiny": "A10"}
MAX_LEN = 48
ATOL = 1e-4
ATT_TOL = dict(atol=2e-5, rtol=2e-5)


@functools.lru_cache(maxsize=None)
def _both(name: str, vocab_size: int = 0):
    """(port cfg, JAX cfg, JAX params, port params) of ``name``'s smoke
    config (at ``vocab_size`` when given), the port's bridged from the
    JAX package's."""
    cfg, jcfg = configs.get_smoke(name), jconfigs.get_smoke(name)
    if vocab_size:
        cfg = dataclasses.replace(cfg, vocab_size=vocab_size)
        jcfg = dataclasses.replace(jcfg, vocab_size=vocab_size)
    jp = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, jp, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_config_twin_has_the_reference_values(name):
    for get, jget in ((configs.get, jconfigs.get),
                      (configs.get_smoke, jconfigs.get_smoke)):
        assert dataclasses.asdict(get(name)) == dataclasses.asdict(jget(name))
        assert get(name).padded_vocab == jget(name).padded_vocab
        assert get(name).q_dim == jget(name).q_dim
    assert name in configs.ARCH_NAMES


@pytest.mark.parametrize("name", sorted(PORTED_LAST))
def test_registry_refuses_only_the_queued_configs(name):
    """Nothing is queued now: the config once queued resolves to the
    reference's values, and only an unknown name is refused."""
    assert configs.QUEUED == {} and name in configs.ARCH_NAMES
    assert dataclasses.asdict(configs.get(name)) == \
        dataclasses.asdict(jconfigs.get(name))
    with pytest.raises(KeyError, match="ROADMAP") as err:
        configs.get(name + "-unknown")
    assert "queued in ROADMAP.md: none" in str(err.value)
    assert not set(NAMES) & set(PORTED_LAST)


@pytest.mark.parametrize("name", NAMES)
def test_bridge_gives_the_init_model_layout(name):
    cfg, _, _, tp = _both(name)
    fresh = lm.init_model(cfg, seed=0, device="cpu")

    def shapes(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(shapes(v, prefix + (k,)))
            else:
                out[prefix + (k,)] = (tuple(v.shape), v.dtype)
        return out

    assert shapes(tp) == shapes(fresh)
    assert ("lm_head" in tp) == (not cfg.tie_embeddings)
    assert ("q_norm" in tp["layers"]["attn"]) == cfg.qk_norm
    assert tp["layers"]["attn"]["wq"].shape[-1] == cfg.q_dim
    assert tp["layers"]["attn"]["wo"].shape[1] == cfg.q_dim


@pytest.mark.parametrize("name", NAMES)
def test_prefill_logits_and_cache_match(name):
    cfg, jcfg, jp, tp = _both(name)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 13))
    jl, jc = jlm.prefill(jp, jnp.asarray(toks, jnp.int32), jcfg,
                         max_len=MAX_LEN)
    tl, tc = lm.prefill(tp, torch.as_tensor(toks), cfg, max_len=MAX_LEN)
    assert tuple(tl.shape) == (2, cfg.padded_vocab)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    assert tc["index"] == 13


@pytest.mark.parametrize("name", NAMES)
def test_prefill_chunk_matches(name):
    cfg, jcfg, jp, tp = _both(name)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 21))
    _, jc = jlm.prefill(jp, jnp.asarray(toks[:, :8], jnp.int32), jcfg,
                        max_len=MAX_LEN)
    _, tc = lm.prefill(tp, torch.as_tensor(toks[:, :8]), cfg,
                       max_len=MAX_LEN)
    jl, jc = jlm.prefill_chunk(jp, jc, jnp.asarray(toks[:, 8:], jnp.int32),
                               jcfg, 8)
    tl, tc = lm.prefill_chunk(tp, tc, torch.as_tensor(toks[:, 8:]), cfg, 8)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    assert tc["index"] == 21


def _paged_decode(name, vocab_size=0, steps=8):
    """Two live rows of different lengths plus an idle row (scratch page)
    decode ``steps`` greedy steps in both packages, each off its own
    pools; returns the logits of every step, port and JAX."""
    cfg, jcfg, jp, tp = _both(name, vocab_size)
    page, max_pages = 8, MAX_LEN // 8
    rows, live = 3, 2
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
        last[r] = int(np.argmax(np.asarray(jl)[0, :cfg.vocab_size]))
        tables[r] = rng.permutation(max_pages) + r * max_pages
        for j in range(max_pages):
            k_pool[:, :, tables[r, j]] = np.asarray(
                jc["k"])[:, 0, :, j * page:(j + 1) * page]
            v_pool[:, :, tables[r, j]] = np.asarray(
                jc["v"])[:, 0, :, j * page:(j + 1) * page]
    jstep = jax.jit(lambda p, kp, vp, t, bt, kv, wp, wo:
                    jlm.paged_decode_step(p, kp, vp, t, bt, kv, wp, wo, jcfg))
    jk, jv = jnp.asarray(k_pool), jnp.asarray(v_pool)
    tk, tv = torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy())
    kv = lens.copy()
    out = []
    for _ in range(steps):
        wp = np.array([tables[r, kv[r] // page] if r < live else n_pages
                       for r in range(rows)], np.int32)
        wo = np.where(np.arange(rows) < live, kv % page, 0).astype(np.int32)
        args = (last[:, None], tables, kv.astype(np.int32), wp, wo)
        jl, (jk, jv) = jstep(jp, jk, jv,
                             *[jnp.asarray(a, jnp.int32) for a in args])
        tl, (tk, tv) = lm.paged_decode_step(
            tp, tk, tv, *[torch.as_tensor(a) for a in args], cfg)
        out.append((tl[:live], np.asarray(jl)[:live]))
        tok = tl.argmax(dim=-1).numpy()
        np.testing.assert_array_equal(tok[:live],
                                      np.argmax(np.asarray(jl), -1)[:live])
        last = np.where(np.arange(rows) < live, tok, 0)
        kv = kv + (np.arange(rows) < live)
    _close(tk[:, :, :n_pages], np.asarray(jk)[:, :, :n_pages])
    return out


@pytest.mark.parametrize("name", NAMES)
def test_paged_decode_logits_and_greedy_tokens_match(name):
    for got, want in _paged_decode(name):
        _close(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_port_engine_matches_jax_engine(name):
    cfg, jcfg, jp, tp = _both(name)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (7, 12, 2, 23)]
    jeng = JaxEngine(jcfg, jp, max_len=MAX_LEN)
    jreqs = [jeng.submit(p, 6) for p in prompts]
    jeng.drain()
    eng = Engine(cfg, tp, max_len=MAX_LEN, device="cpu")
    reqs = [eng.submit(p, 6) for p in prompts]
    eng.drain()
    assert [r.state for r in reqs] == [RequestState.DONE] * 4
    assert [list(r.out_tokens) for r in reqs] == \
        [list(r.out_tokens) for r in jreqs]
    assert eng.stats()["demotions"] == 0


# (Sq, Skv, kv_len, window): decode at index 40, a windowed last slot, a
# cached 8-token chunk and a per-row kv_len (0 among them), as the int8
# cases of tests/test_torch_int8_kv.py, at d_head 16.
D16_CASES = {"decode_at_40": (1, 64, 41, None),
             "window24_last_slot": (1, 64, 64, 24),
             "cached_chunk": (8, 64, 24, None),
             "per_row_kv_len": (3, 64, [0, 40], None)}


@pytest.mark.parametrize("anchor", ["os", "ws"])
@pytest.mark.parametrize("case", sorted(D16_CASES))
def test_f32_queries_over_int8_kv_at_d_head_16_match_jax_interpret(
        case, anchor):
    """float32 queries over int8 K/V at d_head 16 (minicpm-smoke's heads,
    MHA and a group of 2): the port's plain twin (``ref.attention_ref``,
    what K1 and K2 are held to on the card) and its ``ops.attention``
    against the JAX package's Pallas kernels in interpret mode, OS
    (``flash_attention``) and WS (``kv_stationary_attention``)."""
    sq, skv, kv_len, window = D16_CASES[case]
    rng = np.random.default_rng(len(case) + sq)
    for hq, hkv in ((6, 6), (4, 2)):
        b, d = 2, 16
        q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
        k, v = (rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
                for _ in range(2))
        (kq, ks), (vq, vs) = (quant.symmetric_int8(torch.from_numpy(x), -1)
                              for x in (k, v))
        lens = np.asarray(kv_len, np.int32)
        want = jops.attention(
            jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
            window=window, kv_len=jnp.asarray(lens),
            k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()),
            backend="interpret", anchor=anchor)
        kv = torch.from_numpy(lens) if lens.ndim else int(lens)
        tq = torch.from_numpy(q)
        for got in (ref.attention_ref(tq, kq, vq, window=window, kv_len=kv,
                                      k_scale=ks, v_scale=vs),
                    ops.attention(tq, kq, vq, window=window, kv_len=kv,
                                  k_scale=ks, v_scale=vs, anchor=anchor)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **ATT_TOL)


def test_padded_vocab_decodes_and_serves():
    """minicpm-smoke at vocab_size 509 (padded to 512): the port's
    paged-decode logits past vocab_size are -inf, as the JAX package's
    (whose engine's all-finite sentinel would therefore refuse every
    decode step, ROADMAP C); the rest match within ATOL; the port's engine
    serves it, checking only the first vocab_size columns, and emits no
    padding id."""
    for got, want in _paged_decode("minicpm-2b", vocab_size=509, steps=4):
        assert got.shape[-1] == 512
        assert bool(torch.isneginf(got[:, 509:]).all())
        assert bool(np.isneginf(want[:, 509:]).all())
        assert not bool(np.isfinite(want).all())     # the sentinel trips
        _close(got[:, :509], want[:, :509])
    cfg, _, _, tp = _both("minicpm-2b", 509)
    eng = Engine(cfg, tp, max_len=MAX_LEN, device="cpu")
    rng = np.random.default_rng(4)
    reqs = [eng.submit(rng.integers(0, 509, (n,)).astype(np.int32), 6)
            for n in (5, 19)]
    eng.drain()
    assert [r.state for r in reqs] == [RequestState.DONE] * 2
    assert all(t < 509 for r in reqs for t in r.out_tokens[1:])
    assert eng.stats()["failed"] == 0 and eng.stats()["demotions"] == 0


def test_chameleon_is_admitted_as_a_dense_backbone():
    cfg = configs.get_smoke("chameleon-34b")
    assert cfg.family == "vlm" and cfg.family in lm.DENSE_FAMILIES
    lm._check_supported(cfg)
    lm._check_supported(configs.get("chameleon-34b"))


@pytest.mark.parametrize("name", sorted(PORTED_LAST))
def test_moe_ssm_and_audio_configs_still_raise(name):
    """The port's twin of each config once queued (the JAX package's
    values) is admitted by the model now; the same config with its
    family's fields broken (an audio config without its encoder) still
    raises, naming no ROADMAP entry."""
    cfg = base.ArchConfig(**dataclasses.asdict(jconfigs.get_smoke(name)))
    lm._check_supported(cfg)
    broken = dataclasses.replace(cfg, is_encoder_decoder=False)
    with pytest.raises(NotImplementedError) as err:
        lm._check_supported(broken)
    assert PORTED_LAST[name] not in str(err.value)
