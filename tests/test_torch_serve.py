"""The port's serving path on the CPU: ``Engine.submit`` -> ``drain`` ->
continuous scheduler -> whole-prompt prefill -> paged decode.

Held against the JAX package's engine on the same bridged weights
(equal greedy tokens), and against itself for the serving invariants:
a mixed-length batch emits the tokens each request emits alone, a
prefix-reuse hit the tokens of a miss, and a decode step poisoned with
NaNs is retried with bit-identical tokens — the commit rule at work.
A raise at every registered fault site leaves the tokens of a clean
run.  Smoke config (2 layers, d_model 128, float32); prompts from a
seeded numpy generator.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro_torch import configs
from repro_torch.core import autotune
from repro_torch.models import bridge, lm
from repro_torch.runtime import health
from repro_torch.serve.engine import AdmissionError, Engine, RequestState
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
# model runs, and the training loop's crash site must fire nothing and
# leave the run clean (as the JAX package's drill treats a site that never
# fires).  The spill site needs a
# pool too small for the batch; the durability sites a journal, snapshots
# and (engine.restore) a restart.  The autotuner's store sites fire at
# lookups on the CPU too: its first lookup after a clear reads the store
# (``autotune.load``), each miss writes it (``autotune.save``); a failed
# read or write is absorbed by the store, never by the step.
BINARY_SITES = {"kernel.binary_matmul"}
AUTOTUNE_SITES = {"autotune.load", "autotune.save"}
UNSERVED_SITES = {"kernel.conv2d", "train.step"}
PRESSURE_SITES = {"pool.spill"}
DURABLE_SITES = {"journal.append", "snapshot.save", "ckpt.write",
                 "engine.restore"}


def _drop_terminals(jdir):
    path = os.path.join(jdir, "journal.jsonl")
    lines = [line for line in open(path) if json.loads(line)["rec"]["kind"]
             not in ("done", "failed", "evicted")]
    open(path, "w").writelines(lines)


def _drill(tp, site, cfg, jdir):
    """One run of the drill's scenario for ``site``: (tokens, engine)."""
    if site in PRESSURE_SITES:
        # three spills and three preemptions on a clean run
        return _serve(tp, _prompts([14, 14], seed=9), 10, cfg=cfg,
                      scheduler_config=SchedulerConfig(
                          max_batch=2, n_pages=5, page_size=8))
    if site in AUTOTUNE_SITES:
        # twice from an emptied in-memory cache: the store is read at
        # each run's first lookup and written at the first run's misses
        autotune.reset_stats()
        for _ in range(2):
            autotune.clear()
            got = _serve(tp, _prompts([5, 9], seed=6), 3, cfg=cfg)
        return got
    if site not in DURABLE_SITES:
        return _serve(tp, _prompts([5, 9], seed=6), 3, cfg=cfg)
    eng = Engine(cfg, tp, max_len=MAX_LEN, device="cpu", journal_dir=jdir,
                 snapshot_every=1)
    reqs = [eng.submit(p, 5) for p in _prompts([6, 6], seed=6)]
    eng.serve(reqs)
    if site == "engine.restore":
        # a crash after the last token: the newest snapshot is torn, so
        # the restore's hit 0 falls back, hit 1 meets the drill
        _drop_terminals(jdir)
        newest = eng.snapshots.steps()[-1]
        with open(os.path.join(jdir, "snapshots", f"step_{newest:08d}",
                               "arrays.npz"), "wb") as f:
            f.write(b"torn")
        eng = Engine(cfg, tp, max_len=MAX_LEN, device="cpu",
                     journal_dir=jdir)
        reqs = eng.restore()
        eng.serve(reqs)
    for r in reqs:
        assert r.state == RequestState.DONE, (r.rid, r.state, r.error)
    return [list(r.out_tokens) for r in reqs], eng


@pytest.mark.parametrize("site", health.INJECTION_SITES)
def test_fault_drill_at_every_site_keeps_tokens(params, monkeypatch, site,
                                                tmp_path):
    """A raise at each site's second hit is absorbed — retried on the
    plain path; (pool.alloc) deferred as backpressure while the first
    request holds pages; (pool.spill) escalated to a preemption;
    (journal, snapshots) counted as degraded durability; (engine.restore)
    a fallback to an older snapshot — and every request still ends DONE
    with the tokens of a clean run."""
    _, tp = params
    cfg = CFG
    if site in BINARY_SITES:
        cfg = dataclasses.replace(CFG, binary_mlp=True)
        tp = lm.init_model(cfg, seed=0, device="cpu")
    if site in AUTOTUNE_SITES:
        monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    clean, _ = _drill(tp, site, cfg, str(tmp_path / "clean"))
    if site in AUTOTUNE_SITES:
        autotune.clear(disk=True)
    monkeypatch.setenv("REPRO_FAULT_PLAN", f"{site}:1:raise")
    health.reset_faults()
    got, eng = _drill(tp, site, cfg, str(tmp_path / "drill"))
    assert got == clean
    stats = eng.stats()
    if site in UNSERVED_SITES:
        assert health.fault_log() == [] and stats["demotions"] == 0
        return
    assert [(f.site, f.hit) for f in health.fault_log()] == [(site, 1)]
    if site in AUTOTUNE_SITES:
        errors = "load_errors" if site == "autotune.load" else "save_errors"
        assert autotune.stats()[errors] == 1 and stats["demotions"] == 0
        autotune.clear()
    elif site == "pool.alloc":
        assert stats["backpressure"] == 1 and stats["demotions"] == 0
    elif site == "pool.spill":
        assert eng.monitor.events_of("spill-failed")
        assert stats["preemptions"] >= 1 and stats["demotions"] == 0
    elif site == "journal.append":
        assert stats["journal"]["append_errors"] == 1
    elif site in ("snapshot.save", "ckpt.write"):
        assert stats["snapshot_errors"] == 1 and stats["demotions"] == 0
    elif site == "engine.restore":
        assert stats["restore_fallbacks"] == 2
        assert "warm resume" in eng.monitor.events_of("restore")[-1].detail
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
    # pages over 32 keys are admitted: B3 takes any page size
    big_page = Engine(CFG, tp, max_len=128, device="cpu",
                      scheduler_config=SchedulerConfig(page_size=64))
    assert big_page.submit(np.zeros(4, np.int32), 2).rid == 0
    tiny = Engine(CFG, tp, max_len=MAX_LEN, device="cpu",
                  scheduler_config=SchedulerConfig(n_pages=2, page_size=8))
    with pytest.raises(AdmissionError, match="kv reach 20"):
        tiny.submit(np.zeros(12, np.int32), 8)
    assert tiny.stats()["rejected"] == 1


def _both_engines(tp, jp, prompts, new_tokens, run, engine_kw=None,
                  cfgkw=None, max_len=MAX_LEN, **sckw):
    """The scenario on the port's engine and on the JAX engine: ``run`` is
    ``"drain"`` or ``"serve"``, ``cfgkw`` replaces config fields in both;
    returns (port tokens, JAX tokens, port engine)."""
    out = []
    for make, p, cfg, sc_cls, kw in (
            (Engine, tp, CFG, SchedulerConfig,
             dict(engine_kw or {}, device="cpu")),
            (JaxEngine, jp, JCFG, JaxSchedulerConfig,
             {k: v.replace("port", "jax") if k == "journal_dir" else v
              for k, v in (engine_kw or {}).items()})):
        cfg = dataclasses.replace(cfg, **(cfgkw or {}))
        eng = make(cfg, p, max_len=max_len,
                   scheduler_config=sc_cls(**sckw) if sckw else None, **kw)
        reqs = [eng.submit(q, new_tokens) for q in prompts]
        if run == "drain":
            eng.drain()
        else:
            eng.serve(reqs)
        for r in reqs:
            assert r.state.value == "done", (r.rid, r.state, r.error)
        out.append(([list(r.out_tokens) for r in reqs], eng))
    return out[0][0], out[1][0], out[0][1]


# What the port once refused (each raised NotImplementedError naming its
# ROADMAP entry) now serves, with the JAX engine's tokens.
FORMERLY_UNPORTED = {
    "journal": dict(run="drain", lens=[7, 12, 2], new=4),
    "serve": dict(run="serve", lens=[9, 9, 9], new=4),
    "chunked_prefill": dict(run="drain", lens=[9, 3], new=2,
                            sckw=dict(prefill_chunk=4)),
    "slot_cache": dict(run="drain", lens=[5, 11], new=3,
                       sckw=dict(page_size=0)),
    # two 14-token prompts fill 4 of 5 pages: decode growth runs the whole
    # ladder (spills, then preemptions)
    "pool_full": dict(run="drain", lens=[14, 14], new=10,
                      sckw=dict(max_batch=2, n_pages=5, page_size=8)),
    # three requests in 6 pages: one spills at a page boundary and comes
    # back once another finishes
    "spill": dict(run="drain", lens=[12, 12, 3], new=8,
                  sckw=dict(max_batch=3, n_pages=6, page_size=8)),
    # an int8 KV cache: codes and per-position scales, off the slot cache
    "int8_kv": dict(run="drain", lens=[7, 12, 2], new=4,
                    cfgkw=dict(kv_cache_dtype="int8")),
    # pages of 64 keys (B3 once took at most 32): the 60-token prompt's
    # decode crosses into its second page
    "page64": dict(run="drain", lens=[7, 60, 70, 2], new=6, max_len=128,
                   sckw=dict(page_size=64)),
}


@pytest.mark.parametrize("what", sorted(FORMERLY_UNPORTED))
def test_formerly_unported_paths_serve_like_jax(params, what, tmp_path):
    jp, tp = params
    case = FORMERLY_UNPORTED[what]
    engine_kw = ({"journal_dir": str(tmp_path / "port")}
                 if what == "journal" else None)
    got, want, eng = _both_engines(
        tp, jp, _prompts(case["lens"], seed=9), case["new"], case["run"],
        engine_kw, case.get("cfgkw"), case.get("max_len", MAX_LEN),
        **case.get("sckw", {}))
    assert got == want
    stats = eng.stats()
    assert stats["demotions"] == 0 and stats["failed"] == 0
    if what == "journal":
        assert stats["journal"]["fsyncs"] > 0
    elif what == "int8_kv":
        rep = eng.scheduler_report()
        assert rep["paged_decode"] is False and "pages" not in rep
    elif what == "page64":
        rep = eng.scheduler_report()
        assert rep["paged_decode"] is True
        assert eng._scheduler.paged.page_size == 64
    elif what in ("pool_full", "spill"):
        assert stats["spills"] + stats["preemptions"] > 0
        assert stats["replay_divergence"] == 0
        if what == "spill":
            assert stats["spills"] > 0 and stats["unspills"] > 0


# The test keeps the name and the id it had while ``restore(devices=)``
# was refused; it now checks the path as ported.
@pytest.mark.parametrize("what", ["restore_devices"])
def test_unported_paths_raise_naming_their_roadmap_entry(params, what,
                                                         monkeypatch,
                                                         tmp_path):
    """``restore(devices=)``: a fresh journal's restore onto a one-rank
    gloo group's 1x1 mesh puts the params on the mesh; the remeshed
    engine serves a batch over it as the one-device engine does, and
    its continuous scheduler (``step()`` until idle, then ``drain()``)
    serves a mixed-length batch with the one-device engine's tokens."""
    import torch.distributed as dist

    _, tp = params
    monkeypatch.chdir(tmp_path)
    prompts = np.random.default_rng(5).integers(
        0, CFG.vocab_size, (2, 8)).astype(np.int32)
    mixed = _prompts([7, 12, 2, 23], seed=5)
    one = Engine(CFG, tp, max_len=MAX_LEN, device="cpu")
    want = [one.submit(p, 4) for p in prompts]
    one.serve(want)
    want_mixed = [one.submit(p, 4) for p in mixed]
    one.drain()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        eng = Engine(CFG, tp, max_len=MAX_LEN, device="cpu",
                     journal_dir="journal")
        assert eng.restore(devices=["cpu"]) == []
        assert tuple(eng.dist.mesh.shape) == (1, 1)
        got = [eng.submit(p, 4) for p in prompts]
        eng.serve(got)
        assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
        stepped = [eng.submit(p, 4) for p in mixed[:2]]
        while eng.step():
            pass
        drained = [eng.submit(p, 4) for p in mixed[2:]]
        eng.drain()
        assert [r.out_tokens for r in stepped + drained] == \
            [r.out_tokens for r in want_mixed]
        assert all(r.state == RequestState.DONE for r in stepped + drained)
        assert eng.scheduler_report()["paged_decode"] is True
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("entry", ["prefill_chunk", "paged_decode_step"])
def test_one_rank_mesh_equals_one_device_bitwise(params, entry, tmp_path):
    """At one rank (a gloo group in process, a 1x1 mesh) the new ``dist=``
    entry points compute what ``dist=None`` does, bit for bit: a chunk
    of 5 tokens at position 7 over a cache a prefill filled (the mesh's
    cache holding the same values), and a paged decode step of 3 rows
    (one idle, on the scratch page) over pools that must end equal too."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import parallel

    _, tp = params
    rng = np.random.default_rng(8)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        d = lm.Dist(mesh, ("data",), "model")
        sp = parallel.shard_params(tp, mesh)
        if entry == "prefill_chunk":
            head = torch.from_numpy(rng.integers(0, CFG.vocab_size, (1, 7)))
            chunk = torch.from_numpy(rng.integers(0, CFG.vocab_size, (1, 5)))
            _, cache = lm.prefill(tp, head, CFG, max_len=MAX_LEN)
            want, wcache = lm.prefill_chunk(tp, cache, chunk, CFG, 7)
            _, mcache = lm.prefill(sp, head, CFG, max_len=MAX_LEN, dist=d)
            got, gcache = lm.prefill_chunk(sp, mcache, chunk, CFG, 7, dist=d)
            got = got.full_tensor()
            for name in ("k", "v"):
                assert torch.equal(gcache[name].full_tensor(), wcache[name])
            assert gcache["index"] == wcache["index"] == 12
        else:
            n_pages, page = 6, 8
            shape = (CFG.n_layers, CFG.n_kv_heads, n_pages, page, CFG.d_head)
            pools = [torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)) for _ in range(2)]
            toks = torch.from_numpy(rng.integers(0, CFG.vocab_size, (3, 1)))
            tables = torch.tensor([[1, 2, 0], [3, 0, 0], [0, 0, 0]],
                                  dtype=torch.int32)
            kv = torch.tensor([9, 3, 0], dtype=torch.int32)
            wp, wo = torch.tensor([2, 3, 5]), torch.tensor([1, 3, 0])
            mine = [p.clone() for p in pools]
            want, _ = lm.paged_decode_step(tp, *pools, toks, tables, kv, wp,
                                           wo, CFG)
            got, _ = lm.paged_decode_step(sp, *mine, toks, tables, kv, wp,
                                          wo, CFG, dist=d)
            got = got.full_tensor()
            assert all(torch.equal(a, b) for a, b in zip(mine, pools))
        assert got.shape == want.shape and torch.equal(got, want)
    finally:
        dist.destroy_process_group()


def test_cpu_run_launches_no_kernel(params):
    from repro_torch.kernels import _build

    _, tp = params
    before = dict(_build.LAUNCHES)
    _serve(tp, _prompts([5]), 2)
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA device"):
        _build.require_cuda(torch.zeros(1))
