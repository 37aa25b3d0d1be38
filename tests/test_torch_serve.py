"""The port's serving path on the CPU: ``Engine.submit`` -> ``drain`` ->
continuous scheduler -> whole-prompt prefill -> paged decode.

Held against the JAX package's engine on the same bridged weights
(equal greedy tokens), and against itself for the serving invariants:
a mixed-length batch emits the tokens each request emits alone, a
prefix-reuse hit the tokens of a miss, and a decode step poisoned with
NaNs is retried with bit-identical tokens — the commit rule at work.
Smoke config (2 layers, d_model 128, float32); prompts from a seeded
numpy generator.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve.engine import Engine as JaxEngine
from repro_torch import configs
from repro_torch.models import bridge, lm
from repro_torch.runtime import health
from repro_torch.serve.engine import AdmissionError, Engine, RequestState
from repro_torch.serve.paged_cache import PagedKVCache
from repro_torch.serve.scheduler import SamplingParams, SchedulerConfig

CFG = configs.get_smoke("qwen3-1.7b")
JCFG = jconfigs.get_smoke("qwen3-1.7b")
MAX_LEN = 48


@pytest.fixture(scope="module")
def params():
    jp = jlm.init_model(JCFG, jax.random.PRNGKey(0))
    return jp, bridge.params_from_numpy(jax.tree.map(np.asarray, jp), CFG,
                                        device="cpu")


@pytest.fixture(autouse=True)
def _no_faults(monkeypatch):
    monkeypatch.delenv("REPRO_FAULT_PLAN", raising=False)
    health.reset_faults()
    yield
    health.reset_faults()


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32)
            for n in lens]


def _serve(tp, prompts, new_tokens, cfg=CFG, **engine_kw):
    eng = Engine(cfg, tp, max_len=MAX_LEN, device="cpu", **engine_kw)
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    eng.drain()
    for r in reqs:
        assert r.state == RequestState.DONE, (r.rid, r.state, r.error)
    return [list(r.out_tokens) for r in reqs], eng


def _alone(tp, prompts, new_tokens):
    return [_serve(tp, [p], new_tokens)[0][0] for p in prompts]


def test_port_engine_matches_jax_engine(params):
    jp, tp = params
    prompts = _prompts([7, 12, 2, 23])
    jeng = JaxEngine(JCFG, jp, max_len=MAX_LEN)
    jreqs = [jeng.submit(p, 6) for p in prompts]
    jeng.drain()
    got, eng = _serve(tp, prompts, 6)
    assert got == [list(r.out_tokens) for r in jreqs]
    assert eng.stats()["demotions"] == 0


def test_mixed_length_batch_matches_sequential(params):
    _, tp = params
    prompts = _prompts([3, 9, 4, 6, 11], seed=1)
    got, eng = _serve(tp, prompts, 4,
                      scheduler_config=SchedulerConfig(max_batch=2))
    assert got == _alone(tp, prompts, 4)
    rep = eng.scheduler_report()
    assert rep["steps"] > 0 and rep["active"] == 0
    assert rep["pages"]["pages_free"] == rep["pages"]["pages_total"]


def test_prefix_hit_matches_miss(params):
    _, tp = params
    rng = np.random.default_rng(3)
    shared = rng.integers(0, CFG.vocab_size, (19,)).astype(np.int32)
    p2 = np.concatenate(
        [shared[:16], rng.integers(0, CFG.vocab_size, (5,)).astype(np.int32)])
    got, eng = _serve(tp, [shared, p2], 4,
                      scheduler_config=SchedulerConfig(max_batch=2,
                                                       page_size=8))
    pages = eng.scheduler_report()["pages"]
    assert pages["reuse_hits"] == 1 and pages["reuse_pages"] == 2
    assert got == _alone(tp, [shared, p2], 4)


def test_nan_decode_step_is_retried_bit_identically(params, monkeypatch):
    _, tp = params
    prompt = _prompts([9], seed=4)
    clean = _alone(tp, prompt, 6)
    # layers.attention hits 0-1 are the prefill's two layers; hit 3 is the
    # second layer of the first decode step
    monkeypatch.setenv("REPRO_FAULT_PLAN", "layers.attention:3:nan")
    health.reset_faults()
    got, eng = _serve(tp, prompt, 6)
    assert got == clean
    stats = eng.stats()
    assert stats["demotions"] == 1 and stats["retries"] == 1
    assert stats["degraded_steps"] >= 1
    assert [(f.site, f.hit, f.kind) for f in health.fault_log()] == [
        ("layers.attention", 3, "nan")]


# Sites no dense model's serving path reaches: the binary GEMM is drilled
# on the binary-MLP twin of the smoke model; the conv, which no served
# model runs, must fire nothing and leave the run clean (as the JAX
# package's drill treats a site that never fires).
BINARY_SITES = {"kernel.binary_matmul"}
UNSERVED_SITES = {"kernel.conv2d"}


@pytest.mark.parametrize("site", health.INJECTION_SITES)
def test_fault_drill_at_every_site_keeps_tokens(params, monkeypatch, site):
    """A raise at each site's second hit is absorbed — retried on the
    plain path, or (pool.alloc) deferred as backpressure while the first
    request holds pages — and every request still ends DONE with the
    tokens of a clean run."""
    _, tp = params
    cfg = CFG
    if site in BINARY_SITES:
        cfg = dataclasses.replace(CFG, binary_mlp=True)
        tp = lm.init_model(cfg, seed=0, device="cpu")
    prompts = _prompts([5, 9], seed=6)
    clean, _ = _serve(tp, prompts, 3, cfg=cfg)
    monkeypatch.setenv("REPRO_FAULT_PLAN", f"{site}:1:raise")
    health.reset_faults()
    got, eng = _serve(tp, prompts, 3, cfg=cfg)
    assert got == clean
    stats = eng.stats()
    if site in UNSERVED_SITES:
        assert health.fault_log() == [] and stats["demotions"] == 0
        return
    assert [(f.site, f.hit) for f in health.fault_log()] == [(site, 1)]
    if site == "pool.alloc":
        assert stats["backpressure"] == 1 and stats["demotions"] == 0
    else:
        assert stats["demotions"] == 1 and stats["retries"] == 1


def test_kernel_error_propagates_without_demotion(params, monkeypatch):
    """A kernel that does not build or launch is not a failed step: the
    engine re-raises it at once instead of serving on the plain path."""
    from repro_torch.kernels import _build
    from repro_torch.models import lm

    _, tp = params

    def broken(*args, **kwargs):
        raise _build.KernelError("paged_attention kernel launch failed")

    monkeypatch.setattr(lm, "paged_decode_step", broken)
    eng = Engine(CFG, tp, max_len=MAX_LEN, device="cpu")
    eng.submit(_prompts([5])[0], 3)
    with pytest.raises(_build.KernelError, match="launch failed"):
        eng.drain()
    stats = eng.stats()
    assert stats["demotions"] == 0 and stats["retries"] == 0
    assert stats["degraded_steps"] == 0


def test_card_engine_retries_on_the_kernel_path(params):
    """On the card a failed step is retried on the kernels themselves:
    the plain path never stands in for them there."""
    _, tp = params
    eng = Engine(CFG, tp, max_len=MAX_LEN, device="cpu")
    eng.device = torch.device("cuda")   # _execute reads only its type
    results = [torch.full((1, 4), float("nan")), torch.zeros(1, 4)]
    paths = []

    def step():
        from repro_torch.models import layers
        paths.append(layers._BACKEND_OVERRIDE)
        return results[len(paths) - 1], None

    logits, _, path = eng._execute("serve.decode_step", 0, step)
    assert path == "primary" and paths == [None, None]
    assert bool(torch.isfinite(logits).all())
    stats = eng.stats()
    assert stats["retries"] == 1 and stats["demotions"] == 0
    assert not stats["demoted_now"]


def test_sampled_stream_replays_and_handle_streams(params):
    _, tp = params
    prompt = _prompts([6], seed=5)[0]
    runs = []
    for _ in range(2):
        eng = Engine(CFG, tp, max_len=MAX_LEN, device="cpu")
        h = eng.submit(prompt, sampling=SamplingParams(
            max_new_tokens=4, greedy=False, seed=7))
        runs.append(list(h.tokens()))
        assert h.state == RequestState.DONE
    assert runs[0] == runs[1] and len(runs[0]) == 4


def test_admission_rejects(params):
    _, tp = params
    eng = Engine(CFG, tp, max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(np.zeros(0, np.int32), 2)
    with pytest.raises(ValueError, match="no decode room"):
        eng.submit(np.zeros(MAX_LEN, np.int32), 2)
    big_page = Engine(CFG, tp, max_len=128, device="cpu",
                      scheduler_config=SchedulerConfig(page_size=64))
    with pytest.raises(AdmissionError, match="page_size 64"):
        big_page.submit(np.zeros(4, np.int32), 2)
    tiny = Engine(CFG, tp, max_len=MAX_LEN, device="cpu",
                  scheduler_config=SchedulerConfig(n_pages=2, page_size=8))
    with pytest.raises(AdmissionError, match="kv reach 20"):
        tiny.submit(np.zeros(12, np.int32), 8)
    assert tiny.stats()["rejected"] == 1


def _chunked(tp):
    _serve(tp, _prompts([9]), 2,
           scheduler_config=SchedulerConfig(prefill_chunk=4))


def _pool_full(tp):
    # two 15-token prompts fill a 4-page pool; the first decode step that
    # crosses a page boundary needs the spill rung
    _serve(tp, _prompts([15, 15]), 4,
           scheduler_config=SchedulerConfig(max_batch=2, n_pages=4,
                                            page_size=8))


UNPORTED = {
    "journal": (lambda tp: Engine(CFG, tp, max_len=MAX_LEN, device="cpu",
                                  journal_dir="journal"), "A5a"),
    "serve": (lambda tp: Engine(CFG, tp, max_len=MAX_LEN,
                                device="cpu").serve([]), "A5d"),
    "chunked_prefill": (_chunked, "A5c"),
    "slot_cache": (lambda tp: _serve(tp, _prompts([5]), 2,
                                     scheduler_config=SchedulerConfig(
                                         page_size=0)), "A5d"),
    "pool_full": (_pool_full, "A5b"),
    "spill": (lambda tp: PagedKVCache(CFG, 4, 8).spill([0]), "A5b"),
}


@pytest.mark.parametrize("what", sorted(UNPORTED))
def test_unported_paths_raise_naming_their_roadmap_entry(params, what):
    _, tp = params
    fn, entry = UNPORTED[what]
    with pytest.raises(NotImplementedError, match=entry):
        fn(tp)


def test_cpu_run_launches_no_kernel(params):
    from repro_torch.kernels import _build

    _, tp = params
    before = dict(_build.LAUNCHES)
    _serve(tp, _prompts([5]), 2)
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA device"):
        _build.require_cuda(torch.zeros(1))
