"""The port's scheduler under pressure and in its other modes, on the CPU.

Port vs JAX: the port's ``Engine``/``ContinuousScheduler`` and the JAX
package's, on the same bridged weights and prompts, emit the same
greedy tokens — chunked prefill, the slot-cache decode path, the
pressure ladder (whose spill, unspill and preemption counters agree
too: its victims are chosen from step counts and rids alone), the
watermark deferral, the batch-synchronous ``serve()`` and
``generate()``; and ``lm.decode_step`` (a scalar or per-row index) gives
the JAX step's logits and cache.  Port only: the spill tier's round trip is bit-exact,
the pool conserves pages under any op sequence, the chunked-prefill
deadline fires at a chunk boundary, and a wedged drain fails its
requests loudly.  Smoke config (2 layers, d_model 128, float32).
"""
import time
import types
import warnings

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import ContinuousScheduler as JaxScheduler
from repro.serve.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro_torch import configs
from repro_torch.models import bridge
from repro_torch.runtime import health
from repro_torch.serve.engine import Engine, RequestState
from repro_torch.serve.paged_cache import PagedKVCache, pages_for
from repro_torch.serve.scheduler import ContinuousScheduler, SchedulerConfig

CFG = configs.get_smoke("qwen3-1.7b")
JCFG = jconfigs.get_smoke("qwen3-1.7b")
MAX_LEN = 48
# the reference's pressure drill: 4 + 4 + 3 + 6 = 17 pages of reach in a
# pool of 6 (the largest single reach), so the ladder must fire
NEW_TOKENS = 20
LENS = [7, 12, 2, 23]
PAGE = 8
TINY_POOL = 6
BIG_POOL = 24
COUNTERS = ("spills", "spilled_pages", "unspills", "preemptions",
            "backpressure", "failed", "replay_divergence")


@pytest.fixture(scope="module")
def params():
    jp = jlm.init_model(JCFG, jax.random.PRNGKey(0))
    return jp, bridge.params_from_numpy(jax.tree.map(np.asarray, jp), CFG,
                                        device="cpu")


@pytest.fixture(autouse=True)
def _no_faults(monkeypatch):
    for key in ("REPRO_FAULT_PLAN", "REPRO_JOURNAL_DIR",
                "REPRO_SNAPSHOT_EVERY", "REPRO_STRICT_POOL"):
        monkeypatch.delenv(key, raising=False)
    health.reset_faults()
    yield
    health.reset_faults()


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32)
            for n in lens]


def _tokens(reqs, done=True):
    if done:
        for r in reqs:
            assert r.state.value == "done", (r.rid, r.state, r.error)
    return [list(r.out_tokens) for r in reqs]


def _both_serve(params, prompts, new_tokens, max_len=MAX_LEN, **sckw):
    """The same requests through ``serve()`` of both engines."""
    jp, tp = params
    out = []
    for make, p, cfg, kw in (
            (JaxEngine, jp, JCFG, {}),
            (Engine, tp, CFG, {"device": "cpu"})):
        sc = (JaxSchedulerConfig if make is JaxEngine
              else SchedulerConfig)(**sckw) if sckw else None
        eng = make(cfg, p, max_len=max_len, scheduler_config=sc, **kw)
        reqs = [eng.submit(q, new_tokens) for q in prompts]
        eng.serve(reqs)
        out.append((_tokens(reqs), eng))
    return out


# ---------------------------------------------------------------------------
# Chunked prefill, the slot cache, serve() and generate(), port vs JAX.
# ---------------------------------------------------------------------------
def test_chunked_prefill_matches_whole_and_jax(params):
    prompts = _prompts([19, 7], seed=2)
    (jtoks, _), (ttoks, teng) = _both_serve(params, prompts, 4, max_batch=2,
                                            prefill_chunk=8)
    whole = _both_serve(params, prompts, 4, max_batch=2)
    assert ttoks == jtoks == whole[1][0] == whole[0][0]
    assert teng.stats()["demotions"] == 0


@pytest.mark.parametrize("page_size,max_len", [(0, MAX_LEN), (16, 40)],
                         ids=["page_size_0", "max_len_unaligned"])
def test_slot_cache_matches_paged_and_jax(params, page_size, max_len):
    """Configurations the paged step cannot take decode off the slot
    cache (``lm.decode_step`` with a per-row index) with the paged
    path's tokens; mixed lengths go through the continuous scheduler."""
    prompts = _prompts([7, 12, 2, 23])
    (jtoks, _), (ttoks, teng) = _both_serve(
        params, prompts, 5, max_len=max_len, page_size=page_size)
    paged = _both_serve(params, prompts, 5, max_len=MAX_LEN)[1][0]
    assert ttoks == jtoks == paged
    assert teng.scheduler_report()["paged_decode"] is False


def test_slot_cache_turns_slots_over(params):
    """More requests than slots on the slot cache: freed rows park at
    index 0 and the next request overwrites them whole."""
    prompts = _prompts([3, 9, 4, 6, 11], seed=1)
    (jtoks, _), (ttoks, _) = _both_serve(params, prompts, 3, max_batch=2,
                                         page_size=0)
    assert ttoks == jtoks


def test_equal_length_serve_runs_the_batch_loop(params):
    prompts = _prompts([8, 8, 8], seed=7)
    (jtoks, _), (ttoks, teng) = _both_serve(params, prompts, 6)
    assert ttoks == jtoks
    assert teng.scheduler_report() is None          # no scheduler ran
    assert teng.stats()["completed"] == 3
    alone = [_both_serve(params, [p], 6)[1][0][0] for p in prompts]
    assert ttoks == alone


def test_generate_is_a_deprecated_shim(params):
    jp, tp = params
    prompts = np.stack(_prompts([6, 6], seed=8))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = JaxEngine(JCFG, jp, max_len=MAX_LEN).generate(prompts, 4)
    eng = Engine(CFG, tp, max_len=MAX_LEN, device="cpu")
    with pytest.warns(DeprecationWarning, match="deprecated"):
        got = eng.generate(prompts, 4)
    assert got.shape == (2, 4) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# The pressure ladder, port vs JAX.
# ---------------------------------------------------------------------------
def _drain_both(params, n_pages, prompts, new_tokens, **sckw):
    jp, tp = params
    out = []
    for make, sched_cls, sc_cls, p, cfg, kw in (
            (JaxEngine, JaxScheduler, JaxSchedulerConfig, jp, JCFG, {}),
            (Engine, ContinuousScheduler, SchedulerConfig, tp, CFG,
             {"device": "cpu"})):
        eng = make(cfg, p, max_len=MAX_LEN, **kw)
        reqs = [eng.submit(q, new_tokens) for q in prompts]
        sched = sched_cls(eng, sc_cls(max_batch=4, page_size=PAGE,
                                      n_pages=n_pages, **sckw))
        for r in reqs:
            sched.enqueue(r)
        sched.drain()
        eng._check_replay(reqs)
        out.append((reqs, sched, eng))
    return out


def test_pressure_drill_matches_unconstrained_and_jax(params):
    prompts = _prompts(LENS)
    (jbig, _, _), (tbig, _, _) = _drain_both(params, BIG_POOL, prompts,
                                             NEW_TOKENS)
    (jreqs, _, jeng), (treqs, tsched, teng) = _drain_both(
        params, TINY_POOL, prompts, NEW_TOKENS)
    assert _tokens(treqs) == _tokens(tbig) == _tokens(jbig) == _tokens(jreqs)
    jc = {k: jeng._counters[k] for k in COUNTERS}
    tc = {k: teng._counters[k] for k in COUNTERS}
    assert tc == jc
    assert tc["spills"] + tc["preemptions"] > 0 and tc["failed"] == 0
    assert tc["replay_divergence"] == 0
    rep = tsched.report()
    assert rep["paged_decode"] is True and rep["paused"] == 0
    for key in ("occupancy", "above_high", "below_low", "spills"):
        assert key in rep["pages"], rep
    assert rep["pages"]["pages_free"] == TINY_POOL


def test_pressure_drill_on_simulated_oom_matches_jax(params, monkeypatch):
    """``pool.alloc`` raises on every third hit: the ladder runs on a roomy
    pool, and both engines walk it the same way."""
    prompts = _prompts(LENS)
    monkeypatch.setenv("REPRO_FAULT_PLAN", "")
    (jbig, _, _), _ = _drain_both(params, BIG_POOL, prompts, 8)
    hits = ",".join(f"pool.alloc:{i}:raise" for i in range(2, 40, 3))
    monkeypatch.setenv("REPRO_FAULT_PLAN", hits)
    from repro.runtime import health as jhealth
    jhealth.reset_faults()
    health.reset_faults()
    (jreqs, _, jeng), (treqs, _, teng) = _drain_both(
        params, BIG_POOL, prompts, 8)
    assert _tokens(treqs) == _tokens(jreqs) == _tokens(jbig)
    assert {k: teng._counters[k] for k in COUNTERS} == {
        k: jeng._counters[k] for k in COUNTERS}
    jhealth.reset_faults()


def test_watermark_defers_admission_with_reason(params):
    jp, tp = params
    rng = np.random.default_rng(1)
    big = rng.integers(0, CFG.vocab_size, (30,)).astype(np.int32)
    small = rng.integers(0, CFG.vocab_size, (4,)).astype(np.int32)
    seen = []
    for make, sched_cls, sc_cls, p, cfg, kw in (
            (JaxEngine, JaxScheduler, JaxSchedulerConfig, jp, JCFG, {}),
            (Engine, ContinuousScheduler, SchedulerConfig, tp, CFG,
             {"device": "cpu"})):
        eng = make(cfg, p, max_len=MAX_LEN, **kw)
        r1 = eng.submit(big, 10)              # reach 40: all 5 pages
        r2 = eng.submit(small, 2)
        sched = sched_cls(eng, sc_cls(max_batch=4, page_size=PAGE,
                                      n_pages=5))
        sched.enqueue(r1)
        for _ in range(6):                    # decode until growth fills
            sched.step()
            if sched.paged.above_high():
                break
        assert sched.paged.above_high()
        sched.enqueue(r2)
        sched.step()
        assert r2.state.value == "queued" and "watermark" in r2.queue_reason
        assert eng._counters["backpressure"] == 1
        sched.drain()
        assert r2.queue_reason is None        # cleared at admission
        seen.append((r2.queue_reason, _tokens([r1, r2])))
    assert seen[0] == seen[1]


# ---------------------------------------------------------------------------
# The spill tier and the pool, port only.
# ---------------------------------------------------------------------------
def _mk_pool(n_pages=8, ps=4):
    cfg = types.SimpleNamespace(n_layers=2, n_kv_heads=2, d_head=4)
    return PagedKVCache(cfg, n_pages, ps, dtype="float32", device="cpu")


def test_spill_unspill_round_trip_bit_exact():
    pool = _mk_pool()
    pages = pool.alloc(3)
    gen = torch.Generator().manual_seed(3)
    payload_k = torch.randn((2, 2, 3, 4, 4), generator=gen)
    payload_v = torch.randn((2, 2, 3, 4, 4), generator=gen)
    idx = torch.as_tensor(pages)
    pool.k_pages[:, :, idx] = payload_k
    pool.v_pages[:, :, idx] = payload_v
    pool.refs[pages[1]] += 1              # pages[1] shared with another
    free_before = pool.free_pages
    entries = pool.spill(pages)
    assert [e[0] for e in entries] == ["host", "resident", "host"]
    assert entries[1][1] == pages[1] and pool.refs[pages[1]] == 2
    assert pool.free_pages == free_before + 2
    assert pool.stats["spilled_pages"] == 2
    # the freed pages are reused and overwritten before the round trip
    other = pool.alloc(2)
    pool.k_pages[:, :, torch.as_tensor(other)] = 7.0
    pool.release(other)
    back = pool.unspill(entries)
    assert back is not None and len(back) == 3 and back[1] == pages[1]
    got_k = pool.k_pages[:, :, torch.as_tensor(back)]
    got_v = pool.v_pages[:, :, torch.as_tensor(back)]
    assert torch.equal(got_k[:, :, [0, 2]], payload_k[:, :, [0, 2]])
    assert torch.equal(got_v[:, :, [0, 2]], payload_v[:, :, [0, 2]])
    assert pool.stats["unspills"] == 1


def test_unspill_returns_none_when_pool_full_entries_untouched():
    pool = _mk_pool(n_pages=4)
    entries = pool.spill(pool.alloc(2))
    pool.alloc(4)                         # exhaust the pool
    assert pool.unspill(entries) is None
    assert len(entries) == 2 and pool.free_pages == 0


def test_release_underflow_counted_or_fatal_under_strict_pool(monkeypatch):
    pool = _mk_pool()
    pages = pool.alloc(1)
    pool.release(pages)
    pool.release(pages)                   # double free: counted
    assert pool.stats["ref_underflows"] == 1
    assert pool.free_pages == pool.n_pages
    monkeypatch.setenv("REPRO_STRICT_POOL", "1")
    pages = pool.alloc(1)
    pool.release(pages)
    with pytest.raises(RuntimeError, match="double free"):
        pool.release(pages)


def test_watermarks_and_report():
    pool = _mk_pool(n_pages=10)
    pool.alloc(6)
    assert pool.below_low() and not pool.above_high()
    pool.alloc(3)
    assert pool.above_high() and not pool.below_low()
    rep = pool.report()
    assert rep["occupancy"] == 0.9 and rep["above_high"] is True
    assert rep["below_low"] is False and rep["spills"] == 0


@settings(max_examples=15, deadline=None)
@given(st.lists(st.integers(0, 4), min_size=1, max_size=50))
def test_pool_conserves_pages_under_any_op_sequence(ops):
    pool = _mk_pool(n_pages=8, ps=4)
    ps = pool.page_size
    prompt = list(range(2 * ps + 1))      # 2 full pages + a partial tail
    k_row = torch.zeros((2, 2, len(prompt), 4))
    holders, spilled = [], []
    for op in ops:
        if op == 0:
            got = pool.alloc(1)
            if got is not None:
                holders.append(got)
        elif op == 1:
            if holders:
                pool.release(holders.pop(0))
        elif op == 2:
            reuse, covered = pool.lookup_prefix(prompt)
            new = pool.alloc(pages_for(len(prompt), ps) - len(reuse))
            if new is None:
                pool.release(reuse)
            else:
                pages = reuse + new
                pool.store(prompt, pages, covered, k_row, k_row)
                holders.append(pages)
        elif op == 3:
            reuse, _ = pool.lookup_prefix(prompt)
            if reuse:
                holders.append(reuse)
        elif op == 4:
            if spilled:
                back = pool.unspill(spilled[0])
                if back is not None:
                    spilled.pop(0)
                    holders.append(back)
            elif holders:
                spilled.append(pool.spill(holders.pop()))
        live = int(np.sum(pool.refs > 0))
        assert pool.free_pages + live == pool.n_pages
        for pid, key in pool._page_key.items():
            assert pool.refs[pid] > 0 and pool._prefix.get(key) == pid
        assert len(pool._prefix) == len(pool._page_key)
    assert pool.stats["ref_underflows"] == 0


# ---------------------------------------------------------------------------
# Chunked-prefill deadline and the drain stall, port only.
# ---------------------------------------------------------------------------
def test_chunked_prefill_checks_deadline_at_chunk_boundary(params):
    _, tp = params
    eng = Engine(CFG, tp, max_len=MAX_LEN, device="cpu")
    req = eng.submit(_prompts([23], seed=4)[0], 2, deadline_s=0.0)
    sched = ContinuousScheduler(eng, SchedulerConfig(
        max_batch=2, page_size=PAGE, n_pages=8, prefill_chunk=4))
    sched.enqueue(req)
    time.sleep(0.01)
    sched.drain()
    assert req.state == RequestState.EVICTED
    assert "chunked prefill" in req.error
    assert eng._counters["evicted"] == 1
    assert sched.paged.free_pages == sched.paged.n_pages   # nothing leaked


def test_drain_stall_fails_stranded_requests_loudly(params):
    _, tp = params
    eng = Engine(CFG, tp, max_len=MAX_LEN, device="cpu")
    req = eng.submit(_prompts([6], seed=5)[0], 2)
    sched = ContinuousScheduler(eng, SchedulerConfig(
        max_batch=2, page_size=PAGE, n_pages=8))
    sched.enqueue(req)
    sched._admit = lambda: False          # wedge the scheduler
    sched._decode = lambda: False
    sched.drain()
    assert req.state == RequestState.FAILED and "stalled" in req.error
    assert len(eng.monitor.events_of("scheduler.stall")) == 1
    assert not sched.has_work


# ---------------------------------------------------------------------------
# lm.decode_step (the slot-cache step, B2 at Sq = 1), port vs JAX.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("index", [None, [3, 8]], ids=["scalar", "per_row"])
def test_decode_step_matches_jax(params, index):
    import jax.numpy as jnp

    from repro_torch.models import lm

    jp, tp = params
    prompts = np.stack(_prompts([8, 8], seed=11))
    jlogits, jcache = jlm.prefill(jp, jnp.asarray(prompts), JCFG,
                                  max_len=MAX_LEN)
    tlogits, tcache = lm.prefill(tp, torch.as_tensor(prompts), CFG,
                                 max_len=MAX_LEN)
    if index is not None:
        jcache["index"] = jnp.asarray(index, jnp.int32)
        tcache["index"] = torch.tensor(index, dtype=torch.int32)
    toks = np.asarray([[5], [77]], np.int32)
    for _ in range(3):
        jlogits, jcache = jlm.decode_step(jp, jcache, jnp.asarray(toks),
                                          JCFG)
        tlogits, new = lm.decode_step(tp, tcache, torch.as_tensor(toks),
                                      CFG)
        assert new is not tcache and new["index"] is not tcache["index"]
        tcache = new
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   atol=2e-4, rtol=2e-4)
        toks = np.asarray(jlogits).argmax(-1)[:, None].astype(np.int32)
    np.testing.assert_array_equal(np.asarray(tcache["index"]),
                                  np.asarray(jcache["index"]))
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=2e-5, rtol=2e-5)
