"""The MoE decoders of the port against the JAX package's, on their smoke
configs (2 layers, float32, CPU): qwen3-moe-235b-a22b's (8 experts top-2,
no shared experts, GQA 4/2, qk-norm) and moonshot-v1-16b-a3b's (8 experts
top-2, one shared expert, MHA 4/4).

The routed-expert layer piece by piece (``models/moe.py``): ``_route``
(the same top-k experts, gates and load-balancing loss within 1e-6),
``_dispatch_indices`` (every output equal, with and without dropped
assignments), ``moe_apply`` with and without shared experts and with
drops, at float32 within ATOL and at bfloat16 within BF16_TOL; the
initialized layout and dtypes against the JAX package's through the
bridge.  Then the model: prefill, ``prefill_chunk`` and paged decode
(logits within ATOL, greedy tokens equal) and the port's ``Engine``
against the JAX ``Engine`` (the same tokens), also at a GQA group of 16.
B3's plain version at a group of 16 against the JAX package's paged
kernel in interpret mode.  ``moe_apply`` makes no host sync.

The JAX parameters (``repro.models.lm.init_model``) cross over through
``models.bridge.params_from_numpy``; inputs come from seeded numpy
generators.  Tolerances: ``tests/test_torch_dense_configs.py``'s ATOL
(1e-4) for float32 logits and layer outputs (the two frameworks order
their float32 sums differently); 1e-6 for the router's gates and loss
(one softmax and a renormalization apart); 1e-5 for paged attention
(``tests/test_torch_paged_split.py``'s).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import attention_df as jattn
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serve.engine import Engine as JaxEngine
from repro_torch import configs
from repro_torch.core.dataflow import GemmProblem
from repro_torch.kernels import ref
from repro_torch.models import bridge, lm, moe
from repro_torch.serve.engine import Engine, RequestState

NAMES = ["qwen3-moe-235b-a22b", "moonshot-v1-16b-a3b"]
MAX_LEN = 48
ATOL = 1e-4
ROUTE_TOL = 1e-6
# bfloat16 moe_apply against the JAX package's: the frameworks round the
# expert GEMMs' outputs, silu and the gated sum over k at different points
# (bf16 roundings of outputs up to ~4 in magnitude, ulp up to 2^-6).
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
PAGED_TOL = dict(atol=1e-5, rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _both(name: str, **changes):
    """(port cfg, JAX cfg, JAX params, port params) of ``name``'s smoke
    config with ``changes``, the port's bridged from the JAX package's."""
    cfg = dataclasses.replace(configs.get_smoke(name), **changes)
    jcfg = dataclasses.replace(jconfigs.get_smoke(name), **changes)
    jp = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, jp, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _layer0(tree):
    """Layer 0's view of a stacked (JAX or port) MoE tree."""
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def _close(got: torch.Tensor, want, atol=ATOL) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


# ---------------------------------------------------------------------------
# Configs.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_config_twin_has_the_reference_values(name):
    for get, jget in ((configs.get, jconfigs.get),
                      (configs.get_smoke, jconfigs.get_smoke)):
        assert dataclasses.asdict(get(name)) == dataclasses.asdict(jget(name))
    assert configs.get(name).family in lm.MOE_FAMILIES
    assert name in configs.ARCH_NAMES and name not in configs.QUEUED


# ---------------------------------------------------------------------------
# The routed-expert layer.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tokens", [1, 4, 37])
@pytest.mark.parametrize("name", NAMES)
def test_route_matches(name, tokens):
    cfg, _, jp, tp = _both(name)
    x = _x(cfg, (tokens,), tokens)
    jg, je, jaux = jmoe._route(jnp.asarray(x),
                               jp["layers"]["moe"]["router"][0], cfg.top_k)
    tg, te, taux = moe._route(torch.from_numpy(x),
                              tp["layers"]["moe"]["router"][0], cfg.top_k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=ROUTE_TOL,
                               rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ROUTE_TOL,
                               rtol=0)
    assert tg.dtype == torch.float32


@pytest.mark.parametrize("capacity_factor", [0.1, 2.0],
                         ids=["drops", "no_drops"])
def test_dispatch_indices_match(capacity_factor):
    """Every output of the sort-based dispatch equals the reference's, on
    the same expert ids (the reference's own top-k of 64 tokens over 8
    experts, top 2): at capacity factor 0.1 (capacity 8 of ~16 a expert:
    drops, as ``tests/test_ssm_moe.py``'s drop test) and 2.0 (none)."""
    cfg, _, jp, _ = _both("qwen3-moe-235b-a22b")
    x = _x(cfg, (64,), 5)
    _, je, _ = jmoe._route(jnp.asarray(x), jp["layers"]["moe"]["router"][0],
                           cfg.top_k)
    cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    cap = moe.capacity(cfg, 64)
    assert cap == max(8, int(capacity_factor * 64 * cfg.top_k
                             / cfg.n_experts))
    want = jmoe._dispatch_indices(je, cfg.top_k, cfg.n_experts, cap)
    got = moe._dispatch_indices(torch.from_numpy(np.array(je)).long(),
                                cfg.top_k, cfg.n_experts, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dropped = int((~got[4]).sum())
    assert (dropped > 0) == (capacity_factor < 1.0)


@pytest.mark.parametrize("capacity_factor", [None, 0.1],
                         ids=["configured", "drops"])
@pytest.mark.parametrize("name", NAMES)
def test_moe_apply_matches(name, capacity_factor):
    """``moe_apply`` on layer 0's weights (moonshot's with its shared
    expert, qwen3-moe's without), a (3, 11) batch: y within ATOL and the
    loss within 1e-6 of the reference's; with capacity factor 0.1 some
    assignments drop in both."""
    changes = {} if capacity_factor is None else {
        "capacity_factor": capacity_factor}
    cfg, jcfg, jp, tp = _both(name, **changes)
    jl, tl = _layer0(jp["layers"]["moe"]), _layer0(tp["layers"]["moe"])
    assert ("shared" in tl) == bool(cfg.n_shared_experts)
    x = _x(cfg, (3, 11), 7)
    jy, jaux = jmoe.moe_apply(jl, jnp.asarray(x), jcfg)
    ty, taux = moe.moe_apply(tl, torch.from_numpy(x), cfg)
    assert tuple(ty.shape) == x.shape and ty.dtype == torch.float32
    _close(ty, jy)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ROUTE_TOL,
                               rtol=0)
    if capacity_factor is not None:
        _, te, _ = moe._route(torch.from_numpy(x).reshape(-1, cfg.d_model),
                              tl["router"], cfg.top_k)
        keep = moe._dispatch_indices(te, cfg.top_k, cfg.n_experts,
                                     moe.capacity(cfg, 33))[4]
        assert not bool(keep.all())


@pytest.mark.parametrize("name", NAMES)
def test_moe_apply_bf16_matches(name):
    """bfloat16 weights and activations (the served dtype) at the smoke
    width: y within BF16_TOL of the JAX package's bf16 ``moe_apply``, and
    bf16 out."""
    cfg, jcfg, jp, tp = _both(name, param_dtype="bfloat16",
                              act_dtype="bfloat16")
    jl, tl = _layer0(jp["layers"]["moe"]), _layer0(tp["layers"]["moe"])
    assert tl["w1"].dtype == torch.bfloat16
    assert tl["router"].dtype == torch.float32
    x = _x(cfg, (2, 9), 8)
    jy, _ = jmoe.moe_apply(jl, jnp.asarray(x, jnp.bfloat16), jcfg)
    ty, _ = moe.moe_apply(tl, torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               **BF16_TOL)


def test_moe_apply_makes_no_host_sync(monkeypatch):
    """``moe_apply`` (moonshot's, with its shared expert through
    ``layers.mlp_apply``) never reads a tensor back to the host."""
    cfg, _, _, tp = _both("moonshot-v1-16b-a3b")
    tl = _layer0(tp["layers"]["moe"])
    x = torch.from_numpy(_x(cfg, (2, 5), 9))
    want, _ = moe.moe_apply(tl, x, cfg)

    def sync(*args, **kwargs):
        raise AssertionError("moe_apply synced with the host")

    for name in ("item", "cpu", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, sync)
    got, aux = moe.moe_apply(tl, x, cfg)
    monkeypatch.undo()
    assert torch.equal(got, want) and aux.ndim == 0


def test_capacity_is_the_reference_formula():
    for name in NAMES:
        for full in (configs.get(name), configs.get_smoke(name)):
            for t in (1, 4, 17, 64, 511):
                assert moe.capacity(full, t) == max(
                    8, int(full.capacity_factor * t * full.top_k
                           / full.n_experts))
    # four decode rows never overflow a decode capacity of 8
    assert moe.capacity(configs.get("moonshot-v1-16b-a3b"), 4) == 8
    assert moe.capacity(configs.get("qwen3-moe-235b-a22b"), 4) == 8


# ---------------------------------------------------------------------------
# Init and bridge.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_init_moe_layout_matches_the_jax_init(name, dtype):
    """``lm.init_model``'s tree (the MoE leaves drawn a layer at a time)
    has the bridged JAX tree's paths, shapes and dtypes: the router
    float32, the experts in ``param_dtype``; and its draws have the
    reference's scales."""
    cfg, _, _, tp = _both(name, param_dtype=dtype)
    fresh = lm.init_model(cfg, seed=0, device="cpu")

    def layout(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(layout(v, prefix + (k,)))
            else:
                out[prefix + (k,)] = (tuple(v.shape), v.dtype)
        return out

    assert layout(fresh) == layout(tp)
    assert "mlp" not in fresh["layers"]
    m = fresh["layers"]["moe"]
    assert m["router"].dtype == torch.float32
    assert m["w1"].dtype == getattr(torch, dtype)
    assert set(bridge.expected_shapes(cfg)) == set(layout(fresh))
    d, f = cfg.d_model, cfg.d_ff
    std = float(m["w2"].float().std())
    assert abs(std / (2.0 / (d + f)) ** 0.5 - 1) < 0.05
    assert abs(float(m["router"].std()) * d ** 0.5 - 1) < 0.1
    # a layer at a time draws the same as a second init
    again = lm.init_model(cfg, seed=0, device="cpu")["layers"]["moe"]
    assert torch.equal(again["w1"], m["w1"])


def test_dense_draws_are_unchanged():
    """The dense decoders' draws do not move: a MoE branch in
    ``init_model`` leaves qwen3-1.7b-smoke's leaves as a plain replay of
    the generator gives them."""
    cfg = configs.get_smoke("qwen3-1.7b")
    p = lm.init_model(cfg, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(3)
    n, d = cfg.n_layers, cfg.d_model
    wq = torch.randn((n, d, cfg.q_dim), generator=gen) * (
        2.0 / (d + cfg.q_dim)) ** 0.5
    assert torch.equal(p["layers"]["attn"]["wq"], wq)
    for shape in ((n, d, cfg.kv_dim),) * 2 + ((n, cfg.q_dim, d),):
        torch.randn(shape, generator=gen)
    torch.randn((cfg.padded_vocab, d), generator=gen)
    w1 = torch.randn((n, d, cfg.d_ff), generator=gen) * (
        2.0 / (d + cfg.d_ff)) ** 0.5
    assert torch.equal(p["layers"]["mlp"]["w1"], w1)


def test_bridge_refuses_a_tree_of_the_wrong_width():
    cfg, _, jp, _ = _both("moonshot-v1-16b-a3b")
    tree = jax.tree.map(np.asarray, jp)
    tree["layers"]["moe"]["shared"]["w1"] = tree["layers"]["moe"][
        "shared"]["w1"][..., :-1]
    with pytest.raises(ValueError, match="layers.moe.shared.w1"):
        bridge.params_from_numpy(tree, cfg, device="cpu")
    del tree["layers"]["moe"]["shared"]
    with pytest.raises(ValueError, match="missing layers.moe.shared.w3"):
        bridge.params_from_numpy(tree, cfg, device="cpu")


def test_hot_gemm_problems_are_the_shared_experts():
    """What reaches B1: moonshot's shared experts' two shapes (width
    d_ff * 2 = 2816), nothing for qwen3-moe (no shared experts)."""
    ms = configs.get("moonshot-v1-16b-a3b")
    assert lm.hot_gemm_problems(ms, 4, 1) == [
        GemmProblem(4, 2048, 2816, in_dtype="bfloat16"),
        GemmProblem(4, 2816, 2048, in_dtype="bfloat16")]
    assert lm.hot_gemm_problems(configs.get("qwen3-moe-235b-a22b"), 1,
                                511) == []


def test_only_dense_and_moe_decoders_are_admitted():
    lm._check_supported(configs.get("qwen3-moe-235b-a22b"))
    bad = dataclasses.replace(configs.get_smoke("moonshot-v1-16b-a3b"),
                              n_experts=0)
    with pytest.raises(NotImplementedError, match="MoE, SSM and hybrid"):
        lm._check_supported(bad)
    bad = dataclasses.replace(configs.get_smoke("qwen3-1.7b"), n_experts=4,
                              top_k=1)
    with pytest.raises(NotImplementedError, match="MoE, SSM and hybrid"):
        lm._check_supported(bad)


# ---------------------------------------------------------------------------
# The model.
# ---------------------------------------------------------------------------
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


@pytest.mark.parametrize("name", NAMES)
def test_paged_decode_logits_and_greedy_tokens_match(name):
    """Two live rows of different lengths and an idle row (the scratch
    page; its stale token takes expert slots in both packages) decode 8
    greedy steps, each package off its own pools."""
    cfg, jcfg, jp, tp = _both(name)
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
    for _ in range(8):
        wp = np.array([tables[r, kv[r] // page] if r < live else n_pages
                       for r in range(rows)], np.int32)
        wo = np.where(np.arange(rows) < live, kv % page, 0).astype(np.int32)
        args = (last[:, None], tables, kv.astype(np.int32), wp, wo)
        jl, (jk, jv) = jstep(jp, jk, jv,
                             *[jnp.asarray(a, jnp.int32) for a in args])
        tl, (tk, tv) = lm.paged_decode_step(
            tp, tk, tv, *[torch.as_tensor(a) for a in args], cfg)
        _close(tl[:live], np.asarray(jl)[:live])
        tok = tl.argmax(dim=-1).numpy()
        np.testing.assert_array_equal(tok[:live],
                                      np.argmax(np.asarray(jl), -1)[:live])
        last = np.where(np.arange(rows) < live, tok, 0)
        kv = kv + (np.arange(rows) < live)
    _close(tk[:, :, :n_pages], np.asarray(jk)[:, :, :n_pages])


def _engines_agree(name, **changes):
    cfg, jcfg, jp, tp = _both(name, **changes)
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


@pytest.mark.parametrize("name", NAMES)
def test_port_engine_matches_jax_engine(name):
    _engines_agree(name)


def test_port_engine_matches_jax_engine_at_group_16():
    """qwen3-moe-smoke widened to 32 q heads over 2 kv heads, the group
    of 16 that qwen3-moe-235b-a22b's 64 over 4 gives: the engine admits
    it (B3 takes it) and serves the JAX engine's tokens."""
    _engines_agree("qwen3-moe-235b-a22b", n_heads=32, d_head=16)


# ---------------------------------------------------------------------------
# B3 at a group of 16.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("case", [
    (4, 16, 1, 32, 16, 6, [0, 17, 45, 90]),
    (2, 64, 4, 32, 8, 8, [33, 60]),
], ids=["hkv1_page16", "qwen3_moe_heads_page8"])
def test_paged_plain_version_at_group_16_matches_jax_interpret(case,
                                                                window):
    """``ref.paged_attention_ref`` (what B3's 16-warp kernel is held to on
    the card) at 16 q heads per kv head against the JAX package's
    ``paged_flash_attention(..., group=16, interpret=True)``, float32."""
    rows, hq, hkv, d, page, max_pages, lens = case
    assert hq // hkv == 16
    rng = np.random.default_rng(sum(lens) + hq)
    n_pages = rows * max_pages + 1
    k, v = (rng.standard_normal((hkv, n_pages, page, d)).astype(np.float32)
            for _ in range(2))
    tables = rng.permutation(n_pages - 1)[:rows * max_pages].reshape(
        rows, max_pages).astype(np.int32)
    q = rng.standard_normal((rows, hq, 1, d)).astype(np.float32)
    kv = np.asarray(lens, np.int32)
    want = jattn.paged_flash_attention(
        jnp.asarray(q.reshape(rows * hq, 1, d)), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(tables), jnp.asarray(kv), group=16,
        window=window, interpret=True)
    got = ref.paged_attention_ref(*(torch.from_numpy(a) for a in
                                    (q, k, v, tables, kv)), window=window)
    np.testing.assert_allclose(got.numpy().reshape(rows * hq, 1, d),
                               np.asarray(want), **PAGED_TOL)


def test_engine_refuses_only_groups_over_16():
    """The engine's kernel check follows B3's group bound: a group of 16
    is served on the card's kernels, a group of 32 is refused naming the
    bound."""
    from repro_torch.kernels import attention_df

    assert attention_df.MAX_GROUP == 16
    for heads, refused in ((32, False), (64, True)):
        cfg = dataclasses.replace(configs.get_smoke("qwen3-moe-235b-a22b"),
                                  n_heads=heads, d_head=16)
        eng = Engine(cfg, lm.init_model(cfg, seed=0, device="cpu"),
                     max_len=MAX_LEN, device="cpu")
        why = eng._kernels_refuse()
        assert (why is not None) == refused
        if refused:
            assert "GQA group 32" in why and "16" in why
