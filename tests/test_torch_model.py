"""The port's dense decoder against the JAX package's, on the
qwen3-1.7b smoke config (2 layers, d_model 128, float32, CPU).

The JAX parameters (``repro.models.lm.init_model``) cross over through
``models.bridge.params_from_numpy``; token ids and page layouts come
from seeded numpy generators and go through both packages.  Tolerance:
logits and KV within atol 1e-4 (float32 through two layers; the two
frameworks order their sums differently), greedy tokens exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.models import bridge, lm

CFG = configs.get_smoke("qwen3-1.7b")
JCFG = jconfigs.get_smoke("qwen3-1.7b")
MAX_LEN = 48
ATOL = 1e-4


@pytest.fixture(scope="module")
def params():
    jp = jlm.init_model(JCFG, jax.random.PRNGKey(0))
    return jp, bridge.params_from_numpy(jax.tree.map(np.asarray, jp), CFG,
                                        device="cpu")


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


def test_config_twin_has_the_reference_fields_and_values():
    ref = {f.name: f.default for f in dataclasses.fields(jbase.ArchConfig)}
    port = {f.name: f.default for f in dataclasses.fields(base.ArchConfig)}
    assert port == ref
    for name in ("qwen3-1.7b",):
        for get, jget in ((configs.get, jconfigs.get),
                          (configs.get_smoke, jconfigs.get_smoke)):
            assert dataclasses.asdict(get(name)) == \
                dataclasses.asdict(jget(name))
            assert get(name).padded_vocab == jget(name).padded_vocab
    # the last config once queued (ROADMAP A10) is the reference's too
    for get, jget in ((configs.get, jconfigs.get),
                      (configs.get_smoke, jconfigs.get_smoke)):
        assert dataclasses.asdict(get("whisper-tiny")) == \
            dataclasses.asdict(jget("whisper-tiny"))
    with pytest.raises(KeyError, match="ROADMAP"):
        configs.get("no-such-arch")


def test_bridge_gives_the_init_model_layout(params):
    _, tp = params
    fresh = lm.init_model(CFG, seed=0, device="cpu")

    def shapes(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(shapes(v, prefix + (k,)))
            else:
                out[prefix + (k,)] = (tuple(v.shape), v.dtype)
        return out

    assert shapes(tp) == shapes(fresh)


def test_bridge_rejects_a_mismatched_tree(params):
    jp, _ = params
    tree = jax.tree.map(np.asarray, jp)
    del tree["layers"]["mlp"]["w3"]
    tree["final_norm"] = np.ones(7, np.float32)
    with pytest.raises(ValueError, match="missing layers.mlp.w3") as err:
        bridge.params_from_numpy(tree, CFG, device="cpu")
    assert "final_norm: shape (7,)" in str(err.value)


def test_prefill_logits_and_cache_match(params):
    jp, tp = params
    toks = np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 13))
    jl, jc = jlm.prefill(jp, jnp.asarray(toks, jnp.int32), JCFG,
                         max_len=MAX_LEN)
    tl, tc = lm.prefill(tp, torch.as_tensor(toks), CFG, max_len=MAX_LEN)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    assert tc["index"] == 13


def test_prefill_chunk_matches(params):
    jp, tp = params
    toks = np.random.default_rng(1).integers(0, CFG.vocab_size, (1, 21))
    _, jc = jlm.prefill(jp, jnp.asarray(toks[:, :8], jnp.int32), JCFG,
                        max_len=MAX_LEN)
    _, tc = lm.prefill(tp, torch.as_tensor(toks[:, :8]), CFG,
                       max_len=MAX_LEN)
    jl, jc = jlm.prefill_chunk(jp, jc, jnp.asarray(toks[:, 8:], jnp.int32),
                               JCFG, 8)
    tl, tc = lm.prefill_chunk(tp, tc, torch.as_tensor(toks[:, 8:]), CFG, 8)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    assert tc["index"] == 21


def test_paged_decode_logits_and_greedy_tokens_match(params):
    """Two live rows of different lengths plus an idle row (scratch page)
    decode 8 greedy steps in both packages, each off its own pools."""
    jp, tp = params
    page, max_pages = 8, MAX_LEN // 8
    rows, live = 3, 2
    n_pages = rows * max_pages
    rng = np.random.default_rng(2)
    lens = np.array([5, 17, 0])
    shape = (CFG.n_layers, CFG.n_kv_heads, n_pages + 1, page, CFG.d_head)
    k_pool, v_pool = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    tables = np.zeros((rows, max_pages), np.int32)
    last = np.zeros(rows, np.int64)
    for r in range(live):
        toks = rng.integers(0, CFG.vocab_size, (1, int(lens[r])))
        jl, jc = jlm.prefill(jp, jnp.asarray(toks, jnp.int32), JCFG,
                             max_len=MAX_LEN)
        last[r] = int(np.argmax(np.asarray(jl)[0]))
        tables[r] = rng.permutation(max_pages) + r * max_pages
        for j in range(max_pages):
            k_pool[:, :, tables[r, j]] = np.asarray(
                jc["k"])[:, 0, :, j * page:(j + 1) * page]
            v_pool[:, :, tables[r, j]] = np.asarray(
                jc["v"])[:, 0, :, j * page:(j + 1) * page]
    jstep = jax.jit(lambda p, kp, vp, t, bt, kv, wp, wo:
                    jlm.paged_decode_step(p, kp, vp, t, bt, kv, wp, wo, JCFG))
    jk, jv = jnp.asarray(k_pool), jnp.asarray(v_pool)
    tk, tv = torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy())
    kv = lens.copy()
    for _ in range(8):
        wp = np.array([tables[r, kv[r] // page] if r < live else n_pages
                       for r in range(rows)], np.int32)
        wo = np.where(np.arange(rows) < live, kv % page, 0).astype(np.int32)
        args = (last[:, None], tables, kv.astype(np.int32), wp, wo)
        jl, (jk, jv) = jstep(jp, jk, jv,
                             *[jnp.asarray(a, jnp.int32) for a in args])
        tl, (tk, tv) = lm.paged_decode_step(
            tp, tk, tv, *[torch.as_tensor(a) for a in args], CFG)
        _close(tl[:live], np.asarray(jl)[:live])
        tok = tl.argmax(dim=-1).numpy()
        np.testing.assert_array_equal(tok[:live],
                                      np.argmax(np.asarray(jl), -1)[:live])
        last = np.where(np.arange(rows) < live, tok, 0)
        kv = kv + (np.arange(rows) < live)
    _close(tk[:, :, :n_pages], np.asarray(jk)[:, :, :n_pages])
