"""The SSM and hybrid decoders of the port against the JAX package's, on
their smoke configs (float32, CPU): mamba2-780m's (2 attention-free
layers of a Mamba2 block, state 16, heads of 16, chunk 8) and
hymba-1.5b's (3 layers of attention and a Mamba2 block side by side,
GQA 4/2, d_head 16, window 8 on all but the first, middle and last
layers).  hymba-smoke's three layers are all full-attention layers, so
the window binds only in a 4-layer variant ("hymba4": layer 1 windowed),
at prompts of 12 to 40 tokens.

The Mamba2 block piece by piece (``models/ssm.py``): ``_causal_conv``
with and without a tail, ``_ssd_chunked`` at a length no multiple of the
chunk, ``mamba_apply`` without a state, with one at L > 1 (where the
reference runs its per-token recurrence and the port its chunked SSD
seeded with the state), at L = 1 and split across two calls; the port's
chunked SSD against its own per-token recurrence (the reference's rtol
and atol, 1e-4), the zero padding leaving the final state as it was;
the initialized layout against the bridged one; no host sync.  Then the
model: prefill, ``prefill_chunk`` and the slot-cache ``decode_step``
(logits and every cache leaf), also over an int8 KV cache; the port's
``Engine`` against the JAX ``Engine`` (mixed batches, chunked prefill);
the retry contract (a failed step leaves the committed state as it was);
two identical prompts live together (no prefix reuse on SSM state);
snapshot and restore.

The JAX parameters (``repro.models.lm.init_model``) cross over through
``models.bridge.params_from_numpy``, JAX caches through
``cache_from_numpy``; inputs come from seeded numpy generators.
Tolerances: ATOL 1e-4 for float32 logits, block outputs, K/V and SSM
state, absolute, as ``tests/test_torch_moe.py``'s (the two frameworks
order their float32 sums differently, and the port's chunked SSD sums in
another order than the reference's recurrence); greedy tokens exactly
equal.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.models import bridge, lm, ssm
from repro_torch.runtime import health
from repro_torch.serve.engine import Engine, RequestState
from repro_torch.serve.scheduler import SchedulerConfig

NAMES = ["mamba2-780m", "hymba-1.5b"]
# (registry name, config changes): the smoke configs, hymba's at 4 layers
# (its layer 1 windowed) and over an int8 KV cache.
CASES = {"mamba2": ("mamba2-780m", ()),
         "hymba": ("hymba-1.5b", ()),
         "hymba4": ("hymba-1.5b", (("n_layers", 4),)),
         "hymba4_int8": ("hymba-1.5b", (("n_layers", 4),
                                        ("kv_cache_dtype", "int8")))}
MAX_LEN = 48
ATOL = 1e-4
# The reference's own bound for its chunked SSD against its recurrence
# (tests/test_ssm_moe.py::test_ssd_chunked_matches_recurrence).
SSD_TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _both(case: str):
    """(port cfg, JAX cfg, JAX params, port params) of a ``CASES`` entry,
    the port's bridged from the JAX package's."""
    name, changes = CASES[case]
    cfg = dataclasses.replace(configs.get_smoke(name), **dict(changes))
    jcfg = dataclasses.replace(jconfigs.get_smoke(name), **dict(changes))
    jp = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, jp, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def _close(got, want, atol=ATOL) -> None:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=0)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# Configs.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_config_twin_has_the_reference_values(name):
    for get, jget in ((configs.get, jconfigs.get),
                      (configs.get_smoke, jconfigs.get_smoke)):
        cfg, jcfg = get(name), jget(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        for prop in ("padded_vocab", "q_dim", "kv_dim", "d_inner",
                     "ssm_heads", "has_attention", "has_ssm",
                     "subquadratic"):
            assert getattr(cfg, prop) == getattr(jcfg, prop), prop
        assert [cfg.layer_window(i) for i in range(cfg.n_layers + 1)] == \
            [jcfg.layer_window(i) for i in range(jcfg.n_layers + 1)]
    assert name in configs.ARCH_NAMES and name not in configs.QUEUED


def test_hymba_windows_every_layer_but_three():
    full = configs.get("hymba-1.5b")
    wins = [full.layer_window(i) for i in range(full.n_layers)]
    assert [i for i, w in enumerate(wins) if w is None] == [0, 16, 31]
    assert set(wins) == {None, 1024}
    smoke = configs.get_smoke("hymba-1.5b")
    assert [smoke.layer_window(i) for i in range(3)] == [None] * 3
    assert [_both("hymba4")[0].layer_window(i) for i in range(4)] == \
        [None, 8, None, None]


@pytest.mark.parametrize("name", NAMES)
def test_ssm_and_hybrid_configs_are_admitted(name):
    for cfg in (configs.get(name), configs.get_smoke(name)):
        lm._check_supported(cfg)
    # the audio encoder-decoder (A10) is admitted now
    audio = base.ArchConfig(**dataclasses.asdict(
        jconfigs.get_smoke("whisper-tiny")))
    lm._check_supported(audio)
    # a family whose paths disagree with its fields stays refused
    odd = dataclasses.replace(configs.get_smoke(name), family="dense")
    with pytest.raises(NotImplementedError, match="fit none") as err:
        lm._check_supported(odd)
    assert "A10" not in str(err.value)


def test_state_bytes_are_the_shapes():
    """The slot cache's SSM state per row: mamba2-780m 48 x 48 x 128 x 64
    x 4 B, hymba-1.5b 32 x 50 x 16 x 64 x 4 B."""
    for name, want in (("mamba2-780m", 48 * 48 * 128 * 64 * 4),
                       ("hymba-1.5b", 32 * 50 * 16 * 64 * 4)):
        cfg = configs.get(name)
        assert cfg.n_layers * cfg.ssm_heads * cfg.ssm_state \
            * cfg.ssm_headdim * 4 == want


# ---------------------------------------------------------------------------
# The Mamba2 block.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches(with_tail):
    x, w, b = _rand((2, 7, 12), 0), _rand((4, 12), 1, 0.1), _rand((12,), 2)
    tail = _rand((2, 3, 12), 3) if with_tail else None
    jy, jtail = jssm._causal_conv(*_j(x, w, b),
                                  None if tail is None else jnp.asarray(tail))
    ty, ttail = ssm._causal_conv(*_t(x, w, b),
                                 None if tail is None else
                                 torch.from_numpy(tail))
    _close(ty, jy)
    _close(ttail, jtail)


def _ssd_inputs(length, seed, b=2, h=3, p=4, n=5):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, length, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, length, h)))).astype(
        np.float32)
    a = -np.arange(1, h + 1, dtype=np.float32) / h
    bm = rng.standard_normal((b, length, n)).astype(np.float32)
    cm = rng.standard_normal((b, length, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, p)).astype(np.float32)
    return xh, dt, a, bm, cm, s0


def test_ssd_chunked_pads_a_ragged_length():
    """L = 13 over chunks of 4: the port pads to 16 itself; the reference
    takes the padded inputs (dt 0 on the padding) and the first 13
    outputs."""
    xh, dt, a, bm, cm, _ = _ssd_inputs(13, 0)
    pad = [(0, 0), (0, 3)]
    jy, js = jssm._ssd_chunked(
        *_j(np.pad(xh, pad + [(0, 0), (0, 0)]), np.pad(dt, pad + [(0, 0)]),
            a, np.pad(bm, pad + [(0, 0)]), np.pad(cm, pad + [(0, 0)])), 4)
    ty, ts = ssm._ssd_chunked(*_t(xh, dt, a, bm, cm), 4)
    assert tuple(ty.shape) == xh.shape
    _close(ty, np.asarray(jy)[:, :13])
    _close(ts, js)


@pytest.mark.parametrize("length", [1, 5, 13, 24])
def test_chunked_from_a_state_equals_the_recurrence(length):
    """The port's chunked SSD seeded with a state against its per-token
    recurrence from the same state, at the reference's bound."""
    xh, dt, a, bm, cm, s0 = _ssd_inputs(length, length)
    args = _t(xh, dt, a, bm, cm)
    y, s = ssm._ssd_chunked(*args, 8, torch.from_numpy(s0))
    yr, sr = ssm._ssd_recurrent(*args, torch.from_numpy(s0))
    np.testing.assert_allclose(y.numpy(), yr.numpy(), **SSD_TOL)
    np.testing.assert_allclose(s.numpy(), sr.numpy(), **SSD_TOL)


def test_padding_leaves_the_final_state_unchanged():
    """Padded positions (dt = 0) change no state: a prompt of 13 in
    chunks of 8 (3 padded) and of 13 (none), and the recurrence over the
    13 alone, reach one final state."""
    xh, dt, a, bm, cm, s0 = _ssd_inputs(13, 7)
    args = _t(xh, dt, a, bm, cm)
    _, padded = ssm._ssd_chunked(*args, 8, torch.from_numpy(s0))
    _, whole = ssm._ssd_chunked(*args, 13, torch.from_numpy(s0))
    _, rec = ssm._ssd_recurrent(*args, torch.from_numpy(s0))
    np.testing.assert_allclose(padded.numpy(), whole.numpy(), **SSD_TOL)
    np.testing.assert_allclose(padded.numpy(), rec.numpy(), **SSD_TOL)


def _block(case):
    cfg, jcfg, jp, tp = _both(case)
    return cfg, jcfg, _layer0(jp["layers"]["mamba"]), \
        _layer0(tp["layers"]["mamba"])


def _state(cfg, batch, seed):
    """A nonzero (state, tail), float32, for both packages."""
    s = _rand((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim), seed,
              0.5)
    tail = _rand((batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
                 seed + 1)
    return s, tail


@pytest.mark.parametrize("case", ["mamba2", "hymba"])
@pytest.mark.parametrize("length,stateful", [(11, False), (11, True),
                                              (1, True), (20, True)],
                         ids=["chunked", "state_L11", "state_L1",
                              "state_L20"])
def test_mamba_apply_matches(case, length, stateful):
    """Without a state both packages run the chunked SSD; with one the
    reference runs its per-token recurrence over all L tokens, the port
    its chunked SSD from the state (L > 1) or the recurrence (L = 1)."""
    cfg, jcfg, jl, tl = _block(case)
    x = _rand((2, length, cfg.d_model), length)
    st = _state(cfg, 2, 5) if stateful else None
    jy, jst = jssm.mamba_apply(jl, jnp.asarray(x), jcfg,
                               None if st is None else tuple(_j(*st)))
    ty, tst = ssm.mamba_apply(tl, torch.from_numpy(x), cfg,
                              None if st is None else tuple(_t(*st)))
    _close(ty, jy)
    assert (tst is None) == (jst is None)
    if tst is not None:
        _close(tst[0], jst[0])
        _close(tst[1], jst[1])
        assert tst[0].dtype == tst[1].dtype == torch.float32


@pytest.mark.parametrize("case", ["mamba2", "hymba"])
def test_mamba_apply_split_across_two_calls(case):
    """13 tokens then 6 from the carried state equal the reference's 19
    in one call (its recurrence from the zero state)."""
    cfg, jcfg, jl, tl = _block(case)
    x = _rand((2, 19, cfg.d_model), 19)
    zero = tuple(_t(*[np.zeros_like(a) for a in _state(cfg, 2, 0)]))
    jy, jst = jssm.mamba_apply(jl, jnp.asarray(x), jcfg,
                               tuple(_j(*[a.numpy() for a in zero])))
    ty1, st1 = ssm.mamba_apply(tl, torch.from_numpy(x[:, :13]), cfg, zero)
    ty2, st2 = ssm.mamba_apply(tl, torch.from_numpy(x[:, 13:]), cfg, st1)
    _close(torch.cat([ty1, ty2], 1), jy)
    _close(st2[0], jst[0])
    _close(st2[1], jst[1])


def test_mamba_apply_leaves_the_callers_state():
    cfg, _, _, tl = _block("mamba2")
    st = tuple(_t(*_state(cfg, 2, 3)))
    before = tuple(t.clone() for t in st)
    for length in (1, 9):
        x = torch.from_numpy(_rand((2, length, cfg.d_model), length))
        _, new = ssm.mamba_apply(tl, x, cfg, st)
        assert all(torch.equal(a, b) for a, b in zip(st, before))
        assert not any(n.data_ptr() == s.data_ptr()
                       for n, s in zip(new, st))


def test_mamba_apply_makes_no_host_sync(monkeypatch):
    cfg, _, _, tl = _block("hymba")
    st = tuple(_t(*_state(cfg, 2, 4)))
    xs = [torch.from_numpy(_rand((2, n, cfg.d_model), n)) for n in (1, 13)]
    want = [ssm.mamba_apply(tl, x, cfg, st)[0] for x in xs]

    def sync(*args, **kwargs):
        raise AssertionError("mamba_apply synced with the host")

    for name in ("item", "cpu", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, sync)
    got = [ssm.mamba_apply(tl, x, cfg, st)[0] for x in xs]
    monkeypatch.undo()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("case", ["mamba2", "hymba"])
def test_init_model_gives_the_bridged_layout(case):
    cfg, _, _, tp = _both(case)
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
    assert set(bridge.expected_shapes(cfg)) == set(shapes(fresh))
    # the reference's fixed leaves, every layer
    m = fresh["layers"]["mamba"]
    h = cfg.ssm_heads
    assert torch.equal(m["a_log"], torch.log(torch.arange(
        1, h + 1, dtype=torch.float32)).expand(cfg.n_layers, h))
    assert bool((m["d_skip"] == 1).all()) and bool((m["dt_bias"] == 0).all())
    if case == "mamba2":
        assert set(fresh["layers"]) == {"ln1", "mamba"}


# ---------------------------------------------------------------------------
# The model.
# ---------------------------------------------------------------------------
def _cache_close(tc, jc):
    assert set(tc) == set(jc)
    for key in tc:
        if key == "index":
            continue
        want = np.asarray(jc[key])
        if want.dtype == np.int8:
            # codes of float values within ATOL: at most one code apart
            assert np.abs(tc[key].numpy().astype(np.int32)
                          - want.astype(np.int32)).max() <= 1, key
        else:
            _close(tc[key], want)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_decode_and_chunk_match(case):
    """A 2-row prefill of 21 tokens, two greedy slot-cache decode steps
    (one index for both rows, then one per row), and a 12-token chunk at
    28 onto a prefilled 28-token row: logits and every cache leaf."""
    cfg, jcfg, jp, tp = _both(case)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 21))
    jl, jc = jlm.prefill(jp, jnp.asarray(toks, jnp.int32), jcfg,
                         max_len=MAX_LEN)
    tl, tc = lm.prefill(tp, torch.as_tensor(toks), cfg, max_len=MAX_LEN)
    _close(tl, jl)
    _cache_close(tc, jc)
    assert tc["index"] == 21
    for ragged in (False, True):
        nxt = np.argmax(np.asarray(jl)[:, :cfg.vocab_size], -1)[:, None]
        if ragged:
            jc["index"] = jnp.asarray([21, 22], jnp.int32)
            tc["index"] = torch.tensor([21, 22], dtype=torch.int32)
        jl, jc = jlm.decode_step(jp, dict(jc), jnp.asarray(nxt, jnp.int32),
                                 jcfg)
        tl, tc = lm.decode_step(tp, tc, torch.as_tensor(nxt), cfg)
        _close(tl[:, :cfg.vocab_size], np.asarray(jl)[:, :cfg.vocab_size])
        np.testing.assert_array_equal(
            tl[:, :cfg.vocab_size].argmax(-1).numpy(),
            np.argmax(np.asarray(jl)[:, :cfg.vocab_size], -1))
        _cache_close(tc, jc)

    toks = rng.integers(0, cfg.vocab_size, (1, 40))
    _, jc = jlm.prefill(jp, jnp.asarray(toks[:, :28], jnp.int32), jcfg,
                        max_len=MAX_LEN)
    _, tc = lm.prefill(tp, torch.as_tensor(toks[:, :28]), cfg,
                       max_len=MAX_LEN)
    jl, jc = jlm.prefill_chunk(jp, jc, jnp.asarray(toks[:, 28:], jnp.int32),
                               jcfg, 28)
    tl, tc = lm.prefill_chunk(tp, tc, torch.as_tensor(toks[:, 28:]), cfg, 28)
    _close(tl, jl)
    _cache_close(tc, jc)
    assert tc["index"] == 40


@pytest.mark.parametrize("case", ["mamba2", "hymba4"])
def test_decode_from_a_bridged_jax_cache(case):
    """``cache_from_numpy`` carries the JAX cache (with and without K/V;
    the reference's tail in the activations' type) across: the port's
    decode step on it gives the JAX step's logits."""
    cfg, jcfg, jp, tp = _both(case)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 15))
    _, jc = jlm.prefill(jp, jnp.asarray(toks, jnp.int32), jcfg,
                        max_len=MAX_LEN)
    tc = bridge.cache_from_numpy(jax.tree.map(np.asarray, jc), cfg,
                                 device="cpu")
    assert ("k" in tc) == cfg.has_attention and tc["ssm"].dtype == \
        tc["conv"].dtype == torch.float32
    nxt = np.array([[3], [7]])
    jl, _ = jlm.decode_step(jp, dict(jc), jnp.asarray(nxt, jnp.int32), jcfg)
    tl, _ = lm.decode_step(tp, tc, torch.as_tensor(nxt), cfg)
    _close(tl[:, :cfg.vocab_size], np.asarray(jl)[:, :cfg.vocab_size])
    bad = dict(jax.tree.map(np.asarray, jc))
    del bad["conv"]
    with pytest.raises(ValueError, match="conv"):
        bridge.cache_from_numpy(bad, cfg, device="cpu")


@pytest.mark.parametrize("case", ["mamba2", "hymba"])
def test_failed_step_leaves_the_committed_state(case, monkeypatch):
    """A decode step and a chunk that fail at layer 1 (after layer 0's
    block ran) leave the caller's ``ssm``/``conv`` as they were; the retry
    gives the clean step's logits and state."""
    cfg, _, _, tp = _both(case)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 10))
    _, cache = lm.prefill(tp, torch.as_tensor(toks), cfg, max_len=MAX_LEN)
    nxt = torch.tensor([[1], [2]])
    chunk = torch.as_tensor(toks[:1, :4])
    row = {k: (v[:, :1] if torch.is_tensor(v) else v)
           for k, v in cache.items()}
    clean = lm.decode_step(tp, cache, nxt, cfg)
    clean_chunk = lm.prefill_chunk(tp, row, chunk, cfg, 10)
    before = {k: cache[k].clone() for k in lm.SSM_KEYS}
    row_before = {k: row[k].clone() for k in lm.SSM_KEYS}
    real = ssm.mamba_apply
    calls = []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected failure at layer 1")
        return real(*args, **kwargs)

    monkeypatch.setattr(ssm, "mamba_apply", flaky)
    for step, args, committed, want in (
            (lm.decode_step, (tp, cache, nxt, cfg), (cache, before), clean),
            (lm.prefill_chunk, (tp, row, chunk, cfg, 10), (row, row_before),
             clean_chunk)):
        calls.clear()
        with pytest.raises(RuntimeError, match="injected"):
            step(*args)
        for k in lm.SSM_KEYS:
            assert torch.equal(committed[0][k], committed[1][k]), k
        logits, new = step(*args)          # the retry
        assert torch.equal(logits, want[0])
        for k in lm.SSM_KEYS:
            assert torch.equal(new[k], want[1][k]), k


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------
def _prompts(cfg, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in lens]


def _port_tokens(cfg, tp, prompts, new_tokens=6, **sc):
    eng = Engine(cfg, tp, max_len=MAX_LEN, device="cpu",
                 scheduler_config=SchedulerConfig(**sc) if sc else None)
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    eng.drain()
    assert [r.state for r in reqs] == [RequestState.DONE] * len(reqs)
    assert eng.stats()["demotions"] == 0
    return [list(r.out_tokens) for r in reqs], eng


@pytest.mark.parametrize("chunk", [0, 8], ids=["whole", "chunked"])
@pytest.mark.parametrize("case", ["mamba2", "hymba", "hymba4",
                                  "hymba4_int8"])
def test_port_engine_matches_jax_engine(case, chunk):
    """Distinct prompts of 7/12/2/23 (and 40, where hymba4's window
    binds) tokens through both engines' continuous schedulers, whole or
    in chunks of 8."""
    cfg, jcfg, jp, tp = _both(case)
    prompts = _prompts(cfg, (7, 12, 2, 23, 40))
    jeng = JaxEngine(jcfg, jp, max_len=MAX_LEN, scheduler_config=(
        JaxSchedulerConfig(prefill_chunk=chunk) if chunk else None))
    jreqs = [jeng.submit(p, 6) for p in prompts]
    jeng.drain()
    tokens, eng = _port_tokens(cfg, tp, prompts,
                               **({"prefill_chunk": chunk} if chunk else {}))
    assert tokens == [list(r.out_tokens) for r in jreqs]
    report = eng.scheduler_report()
    assert report["paged_decode"] is False
    # a page mirror only where there is attention over a float cache
    assert ("pages" in report) == (cfg.has_attention and not lm.int8_kv(cfg))


@pytest.mark.parametrize("case", ["mamba2", "hymba4"])
def test_chunked_prefill_gives_the_whole_prompts_tokens(case):
    """In float32 the chunked SSD passing its state at the chunks' 8-token
    boundaries emits the whole prompts' tokens (prompts of 2 to 40)."""
    cfg, _, _, tp = _both(case)
    prompts = _prompts(cfg, (7, 12, 2, 23, 40), seed=4)
    whole, _ = _port_tokens(cfg, tp, prompts)
    chunked, _ = _port_tokens(cfg, tp, prompts, prefill_chunk=8)
    assert chunked == whole


def test_identical_prompts_live_together_get_identical_tokens(monkeypatch):
    """Two identical 40-token prompts admitted while both are live: the
    page mirror holds the first's 32 full-page tokens when the second is
    admitted, but the pages carry no SSM state, so the port never looks a
    prefix up, prefills the second whole, and both emit the tokens of the
    prompt served alone."""
    from repro_torch.serve.paged_cache import PagedKVCache

    cfg, _, _, tp = _both("hymba4")
    p = _prompts(cfg, (40,), seed=9)[0]
    alone, _ = _port_tokens(cfg, tp, [p], new_tokens=8)
    calls = {"lookup_prefix": 0, "store": 0}
    for name in calls:
        real = getattr(PagedKVCache, name)

        def counted(self, *args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(self, *args, **kwargs)

        monkeypatch.setattr(PagedKVCache, name, counted)
    both, eng = _port_tokens(cfg, tp, [p, p.copy()], new_tokens=8)
    assert both == alone * 2
    assert not eng._scheduler.prefix_reuse
    assert calls == {"lookup_prefix": 0, "store": 2}


def test_engine_admits_an_attention_free_config():
    """mamba2 has no attention heads: the kernel checks (which divide by
    the kv heads) are skipped, no attention problem is warmed, no page
    pool is built."""
    cfg, _, _, tp = _both("mamba2")
    eng = Engine(cfg, tp, max_len=MAX_LEN, device="cpu")
    assert eng._kernels_refuse() is None
    assert eng._hot_problems(1, 9, 4, per_row=True) == []
    assert lm.hot_gemm_problems(configs.get("mamba2-780m"), 4, 1) == []
    _, eng = _port_tokens(cfg, tp, _prompts(cfg, (5, 9)))
    assert eng._scheduler.paged is None


def test_hot_problems_list_full_and_windowed_attention():
    cfg = configs.get("hymba-1.5b")
    probs = lm.hot_attention_problems(cfg, 1, 511, 2048, rows=1)
    assert [(p.sq, p.skv, p.window, p.group) for p in probs] == [
        (511, 511, None, 5), (1, 2048, None, 5), (511, 511, 1024, 5),
        (1, 2048, 1024, 5)]
    # the engine reads no weight to list its problems
    eng = Engine(cfg, {"embed": {"table": torch.zeros(1)}}, max_len=2048,
                 device="cpu")
    hot = eng._hot_problems(1, 511, 4, per_row=True)
    att = [p for p in hot if type(p).__name__ == "AttentionProblem"]
    assert [(p.sq, p.skv, p.window, p.rows) for p in att] == [
        (511, 511, None, 1), (511, 511, 1024, 1), (1, 2048, None, 4),
        (1, 2048, 1024, 4)]
    chunk = [p for p in lm.hot_chunk_problems(cfg, 128, 2048)
             if type(p).__name__ == "AttentionProblem"]
    assert [(p.sq, p.skv, p.window) for p in chunk] == [
        (128, 2048, None), (128, 2048, 1024)]


@pytest.fixture()
def _clean_faults(monkeypatch):
    for key in ("REPRO_FAULT_PLAN", "REPRO_JOURNAL_DIR",
                "REPRO_SNAPSHOT_EVERY"):
        monkeypatch.delenv(key, raising=False)
    health.reset_faults()
    yield monkeypatch
    health.reset_faults()


def test_engine_retries_a_failed_decode_step_from_the_committed_state(
        _clean_faults):
    """hymba-smoke, two requests: the MLP of layer 1 of a decode step
    raises (``layers.mlp`` hit 10: two prefills and a decode of 3 layers
    each came before), after layer 0's block advanced its state; the
    engine retries the step and emits the clean run's tokens."""
    cfg, _, _, tp = _both("hymba")
    prompts = _prompts(cfg, (9, 14), seed=6)
    clean, _ = _port_tokens(cfg, tp, prompts)
    _clean_faults.setenv("REPRO_FAULT_PLAN", "layers.mlp:10:raise")
    health.reset_faults()
    eng = Engine(cfg, tp, max_len=MAX_LEN, device="cpu")
    reqs = [eng.submit(p, 6) for p in prompts]
    eng.drain()
    assert [h.site for h in health.fault_log()] == ["layers.mlp"]
    assert eng.stats()["retries"] == 1
    assert [list(r.out_tokens) for r in reqs] == clean


def test_snapshot_restore_gives_the_same_tokens(_clean_faults, tmp_path):
    """hymba-smoke's batch loop (three 12-token prompts) with snapshots
    every 2 decode steps; after a crash that lost its last token records,
    a fresh engine restores the newest snapshot (the slot cache's SSM
    state with it) and finishes with the uninterrupted run's tokens, the
    JAX engine's."""
    cfg, jcfg, jp, tp = _both("hymba")
    prompts = _prompts(cfg, (12, 12, 12), seed=8)
    jeng = JaxEngine(jcfg, jp, max_len=MAX_LEN)
    jreqs = [jeng.submit(p, 6) for p in prompts]
    jeng.serve(jreqs)
    want = [list(r.out_tokens) for r in jreqs]
    eng = Engine(cfg, tp, max_len=MAX_LEN, device="cpu",
                 journal_dir=str(tmp_path), snapshot_every=2)
    reqs = [eng.submit(p, 6) for p in prompts]
    eng.serve(reqs)
    assert [list(r.out_tokens) for r in reqs] == want
    assert eng.stats()["snapshots_saved"] >= 1
    path = os.path.join(str(tmp_path), "journal.jsonl")
    lines = [line for line in open(path)
             if json.loads(line)["rec"]["kind"] != "done"]
    tok = [i for i, line in enumerate(lines)
           if json.loads(line)["rec"]["kind"] == "token"]
    drop = set(tok[-2:])
    open(path, "w").writelines(line for i, line in enumerate(lines)
                               if i not in drop)
    fresh = Engine(cfg, tp, max_len=MAX_LEN, device="cpu",
                   journal_dir=str(tmp_path))
    rec = fresh.restore()
    assert fresh._pending_resume["cache"]["ssm"].shape[1] == 3
    fresh.serve(rec)
    assert [list(r.out_tokens) for r in rec] == want
    st = fresh.stats()
    assert st["recovered"] == 3 and st["replay_divergence"] == 0
