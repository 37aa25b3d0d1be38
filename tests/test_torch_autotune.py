"""The port's persistent autotuner (``repro_torch.core.autotune``) and the
ops' ``spec=None`` resolution on the CPU.

* The key schema: the reference's segments, then the card's name, its
  shared memory a block and the ops' backend.
* ``warm`` writes the store once for all its misses; a lookup after it
  is a hit that builds no string key.
* ``SpecOverride.merge`` equals the reference's on every override and
  base (the port's specs carry no VMEM budget).
* The twins of ``tests/test_fault_tolerance.py``'s four store drills:
  a garbage file quarantined, a partly corrupt file keeping its good
  entries, a checksum mismatch skipped, a kill in the middle of a write
  (the ``autotune.save`` site) leaving the store whole; and a failed load
  (``autotune.load``) degrading to the in-memory cache.
* The two packages' stores never meet: the port's is a sibling of
  ``$REPRO_AUTOTUNE_CACHE``, and the reference's loader, reading its own
  file after both have saved, skips nothing.
* ``ops.*(spec=None)`` resolves through the autotuner; no feasible
  candidate raises ``ValueError``; ``REPRO_AUTOTUNE_REFINE=1`` picks the
  measured winner.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

from repro.core import autotune as jat
from repro.core.dataflow import DataflowSpec as JSpec
from repro.core.dataflow import GemmProblem as JGemm
from repro.core.dataflow import IS as JIS, OS as JOS, WS as JWS
from repro.core.dataflow import Residency as JRes
from repro.core.dataflow import SpecOverride as JOverride
from repro.core.dataflow import registration_for as jregistration
from repro_torch.core import autotune, cost_model, explorer
from repro_torch.core.dataflow import (AttentionProblem, BinaryProblem,
                                       ConvProblem, DataflowSpec, GemmProblem,
                                       Residency, SpecOverride,
                                       registration_for, IS, OS, WS)
from repro_torch.kernels import matmul_df, ops
from repro_torch.runtime import health

_ST = {OS: JOS, WS: JWS, IS: JIS}
_RES = {Residency.STREAMED: JRes.STREAMED, Residency.STRIPE: JRes.STRIPE,
        Residency.WHOLE: JRes.WHOLE}


@pytest.fixture()
def cache_file(tmp_path, monkeypatch):
    """The JAX package's store path; the port's is its sibling."""
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", path)
    monkeypatch.delenv("REPRO_FAULT_PLAN", raising=False)
    monkeypatch.delenv("REPRO_AUTOTUNE_REFINE", raising=False)
    health.reset_faults()
    for mod in (autotune, jat):
        mod.clear()
        mod.reset_stats()
    yield autotune.cache_path()
    for mod in (autotune, jat):
        mod.clear()
        mod.reset_stats()
    health.reset_faults()


def test_the_store_is_a_sibling_of_the_references(cache_file, tmp_path):
    assert cache_file == str(tmp_path / "autotune.torch.json")
    assert cache_file != jat.cache_path()


def test_key_schema(cache_file, monkeypatch):
    p = GemmProblem(512, 2048, 6144)
    digest = cost_model.model_digest()
    assert autotune._key(p, cost_model.H100, "cuda") == (
        "v2|gemm|512|2048|6144|bfloat16|float32|float32|wb-|"
        f"hw=NVIDIA H100 80GB HBM3|smem=232448|backend=cuda|model={digest}")
    card = cost_model.HardwareSpec(name="NVIDIA H100 PCIe", sms=114,
                                   smem_block=232448, l2_bytes=2 ** 25)
    assert autotune._key(p, card, "torch").endswith(
        f"|hw=NVIDIA H100 PCIe|smem=232448|backend=torch|model={digest}")
    # a refit keys afresh: no pick stored under the old constants is served
    monkeypatch.setitem(cost_model.EFFICIENCY, "matmul_os_prefill", 0.5)
    assert cost_model.model_digest() != digest
    assert autotune._key(p, cost_model.H100, "cuda").endswith(
        f"|model={cost_model.model_digest()}")
    # every kind's problem segments are the reference's
    from repro.core.dataflow import AttentionProblem as JAtt
    from repro.core.dataflow import BinaryProblem as JBin
    from repro.core.dataflow import ConvProblem as JConv
    pairs = [
        (GemmProblem(4, 2048, 6144, "int8", "float32", "int32", 4),
         JGemm(4, 2048, 6144, "int8", "float32", "int32", 4)),
        (ConvProblem(56, 56, 3, 3, 1, 64, 64, out_dtype="float32"),
         JConv(56, 56, 3, 3, 1, 64, 64, out_dtype="float32")),
        (BinaryProblem(511, 64, 6144, 2048, "int8"),
         JBin(511, 64, 6144, 2048, "int8")),
        (AttentionProblem(64, 1, 1024, 128, 2, dtype="bfloat16",
                          kv_dtype="int8", rows=4),
         JAtt(64, 1, 1024, 128, 2, dtype="bfloat16", kv_dtype="int8",
              rows=4)),
    ]
    for p, jp in pairs:
        reg, jreg = registration_for(p), jregistration(jp)
        assert reg.kind == jreg.kind
        assert reg.key_fields(p) == jreg.key_fields(jp)


def test_warm_writes_once_and_lookups_hit(cache_file, monkeypatch):
    saves = []
    real = autotune._save_disk
    monkeypatch.setattr(autotune, "_save_disk",
                        lambda: (saves.append(1), real()))
    probs = [GemmProblem(4, 2048, 6144), GemmProblem(4, 6144, 2048),
             BinaryProblem(4, 64, 6144, 2048, "int8"),
             AttentionProblem(64, 1, 1024, 128, 2, dtype="bfloat16")]
    specs = autotune.warm(probs)
    assert len(specs) == 4 and len(saves) == 1
    assert autotune.stats()["misses"] == 4
    autotune.warm(probs)
    assert len(saves) == 1 and autotune.stats()["hits"] == 4
    with open(cache_file) as f:
        assert len(json.load(f)["entries"]) == 4
    # a hit builds no string key
    monkeypatch.setattr(autotune, "_key", None)
    assert autotune.best_spec(probs[0]) == specs[0]


def test_warm_skips_problems_without_a_dataflow(cache_file):
    bad = AttentionProblem(4, 9, 9, 48, 2)       # d_head 48: no kernel
    assert autotune.warm([bad, GemmProblem(8, 64, 64)]) == [
        autotune.best_spec(GemmProblem(8, 64, 64))]
    with pytest.raises(ValueError, match="no feasible dataflow"):
        autotune.best_spec(bad)


OVERRIDES = [SpecOverride(), SpecOverride(anchor="ws"),
             SpecOverride(anchor=IS), SpecOverride(block=(None, 16)),
             SpecOverride(anchor="os", block=(64, 32, 64)),
             SpecOverride(anchor="Weight", block=(8, None, 8))]
BASES = [DataflowSpec.optimized(block=(64, 32, 64)),
         DataflowSpec(WS, {OS: Residency.STRIPE}, (OS,), (64, 32, 64)),
         DataflowSpec.basic(IS, block=(32, 32, 32))]


def _as_ref(o: SpecOverride) -> JOverride:
    return JOverride(anchor=None if o.anchor is None else _ST[o.anchor],
                     block=o.block)


def test_spec_override_merge_equals_the_references():
    for o, base in ((o, b) for o in OVERRIDES for b in BASES):
        jbase = JSpec(_ST[base.anchor],
                      {_ST[k]: _RES[r] for k, r in base.aux},
                      tuple(_ST[k] for k in base.aux_priority), base.block)
        jo = _as_ref(o)
        got, want = o.merge(base), jo.merge(jbase)
        assert (got.anchor.value, [(k.value, r.value) for k, r in got.aux],
                [k.value for k in got.aux_priority], got.block) == (
            want.anchor.value, [(k.value, r.value) for k, r in want.aux],
            [k.value for k in want.aux_priority], want.block)
        assert (o.is_complete, o.anchor_name, o.block_dim(1)) == (
            jo.is_complete, jo.anchor_name, jo.block_dim(1))
    with pytest.raises(ValueError, match="unknown anchor"):
        SpecOverride(anchor="xs")


# ---------------------------------------------------------------------------
# The store drills.
# ---------------------------------------------------------------------------
def _seed_cache(n=2):
    probs = [GemmProblem(m=64 * (i + 1), k=64, n=64) for i in range(n)]
    specs = [autotune.best_spec(p) for p in probs]
    autotune._save_disk()
    return probs, specs


def test_garbage_cache_file_quarantined_not_fatal(cache_file):
    with open(cache_file, "w") as f:
        f.write("{ truncated garbage !!!")
    autotune._load_disk()
    assert autotune.stats()["files_quarantined"] == 1
    assert glob.glob(cache_file + ".corrupt-*")
    assert not os.path.exists(cache_file)
    assert autotune.best_spec(GemmProblem(m=64, k=64, n=64)) is not None


def test_partially_corrupt_cache_keeps_good_entries(cache_file):
    probs, specs = _seed_cache(2)
    with open(cache_file) as f:
        d = json.load(f)
    keys = sorted(d["entries"])
    d["entries"][keys[0]] = {"spec": "not-a-dict", "sum": 0}
    with open(cache_file, "w") as f:
        json.dump(d, f)
    autotune.clear()
    autotune.reset_stats()
    autotune._load_disk()
    st = autotune.stats()
    assert st["entries_loaded"] == 1 and st["entries_skipped"] == 1
    loaded = [autotune.best_spec(p) for p in probs]
    assert specs[0] in loaded or specs[1] in loaded


def test_checksum_mismatch_skipped(cache_file):
    _seed_cache(1)
    with open(cache_file) as f:
        d = json.load(f)
    (k0,) = d["entries"]
    d["entries"][k0]["sum"] = 123456789
    with open(cache_file, "w") as f:
        json.dump(d, f)
    autotune.clear()
    autotune.reset_stats()
    autotune._load_disk()
    st = autotune.stats()
    assert st["entries_loaded"] == 0 and st["entries_skipped"] == 1


def test_midwrite_kill_leaves_original_intact(cache_file, monkeypatch):
    _seed_cache(1)
    before = open(cache_file).read()
    monkeypatch.setenv("REPRO_FAULT_PLAN", "autotune.save:0:raise")
    health.reset_faults()
    autotune._save_disk()           # the injected kill; must not raise
    assert open(cache_file).read() == before
    assert autotune.stats()["save_errors"] == 1
    assert not glob.glob(os.path.join(os.path.dirname(cache_file), "*.tmp"))
    monkeypatch.delenv("REPRO_FAULT_PLAN")
    health.reset_faults()
    autotune.best_spec(GemmProblem(m=192, k=64, n=64))
    autotune._save_disk()
    with open(cache_file) as f:
        assert len(json.load(f)["entries"]) == 2


def test_load_fault_degrades_to_empty_cache(cache_file, monkeypatch):
    _seed_cache(1)
    monkeypatch.setenv("REPRO_FAULT_PLAN", "autotune.load:0:raise")
    health.reset_faults()
    autotune.clear()
    autotune.reset_stats()
    autotune._load_disk()
    st = autotune.stats()
    assert st["load_errors"] == 1 and st["entries_loaded"] == 0
    monkeypatch.delenv("REPRO_FAULT_PLAN")
    health.reset_faults()
    autotune.clear()
    autotune.reset_stats()
    autotune._load_disk()
    assert autotune.stats()["entries_loaded"] == 1


def test_the_references_store_never_holds_a_port_entry(cache_file):
    jat.best_spec(JGemm(m=128, k=128, n=128))
    jat._save_disk()
    _seed_cache(2)
    ref_path = jat.cache_path()
    with open(ref_path) as f:
        ref_keys = list(json.load(f)["entries"])
    with open(cache_file) as f:
        port_keys = list(json.load(f)["entries"])
    assert ref_keys and port_keys
    assert not [k for k in ref_keys if "backend=cuda" in k]
    assert all("backend=cuda" in k for k in port_keys)
    jat.clear()
    jat.reset_stats()
    jat._load_disk()
    assert jat.stats()["entries_skipped"] == 0
    assert jat.stats()["entries_loaded"] == len(ref_keys)


# ---------------------------------------------------------------------------
# The ops.
# ---------------------------------------------------------------------------
def test_ops_spec_none_resolves_through_the_autotuner(cache_file):
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(17, 64, generator=gen).to(torch.bfloat16)
    b = torch.randn(64, 96, generator=gen).to(torch.bfloat16)
    before = autotune.stats()["lookups"]
    out = ops.matmul_fused(a, b, activation="silu")
    assert autotune.stats()["lookups"] == before + 1
    key = autotune._key(GemmProblem(17, 64, 96), cost_model.H100, "cuda")
    assert key in autotune._memory
    for spec in (SpecOverride(anchor="ws"),
                 SpecOverride(anchor="is", block=matmul_df.BLOCK),
                 autotune._memory[key]):
        assert torch.equal(ops.matmul_fused(a, b, activation="silu",
                                            spec=spec), out)
    # the torch backend resolves nothing
    n = autotune.stats()["lookups"]
    ops.matmul(a, b, backend="torch")
    assert autotune.stats()["lookups"] == n
    q = torch.randn(1, 4, 9, 32, generator=gen)
    k = torch.randn(1, 2, 9, 32, generator=gen)
    att = ops.attention(q, k, k)
    assert torch.equal(ops.attention(q, k, k, spec=SpecOverride("ws")), att)
    akey = autotune._key(AttentionProblem(4, 9, 9, 32, 2), cost_model.H100,
                         "cuda")
    assert akey in autotune._memory
    with pytest.raises(ValueError, match="compiled for"):
        ops.attention(q, k, k, spec=SpecOverride(block=(128, 128)))


def test_refine_picks_the_measured_winner(cache_file, monkeypatch):
    p = GemmProblem(4, 2048, 6144)
    ranked = explorer.explore(p, top=3)
    slowest_first = list(reversed([c.spec for c in ranked]))
    monkeypatch.setattr(explorer, "empirical_rank",
                        lambda problem, specs, device="cpu", iters=5:
                        [(s, float(i)) for i, s in enumerate(slowest_first)])
    monkeypatch.setenv("REPRO_AUTOTUNE_REFINE", "1")
    assert autotune.refine_enabled()
    assert autotune.best_spec(p) == slowest_first[0] != ranked[0].spec


def test_default_matmul_spec_is_alg8_under_the_cards_budget():
    """Paper Alg. 8 at the compiled block: the whole weight and an input
    stripe where they fit a block's shared memory, a weight stripe where
    only it does, basic OS where neither does (qwen3-1.7b's MLP)."""
    small = ops.default_matmul_spec(64, 64, 64)
    assert small.anchor == OS and dict(small.aux) == {
        WS: Residency.WHOLE, IS: Residency.STRIPE}
    narrow = ops.default_matmul_spec(4096, 1152, 64)
    assert dict(narrow.aux) == {WS: Residency.WHOLE}
    wide = ops.default_matmul_spec(512, 2048, 6144)
    assert wide.anchor == OS and dict(wide.aux) == {}
    for spec, shape in ((small, (64, 64, 64)), (narrow, (4096, 1152, 64)),
                        (wide, (512, 2048, 6144))):
        assert spec.block == matmul_df.BLOCK
        assert matmul_df.plan(spec, *shape).smem_bytes <= \
            cost_model.H100.smem_block


@pytest.mark.parametrize("mode", ["batch", "slot_chunked", "paged_prefix"])
def test_the_engines_warm_covers_every_serving_lookup(cache_file, mode,
                                                      monkeypatch):
    """Every problem an ``ops.*(spec=None)`` call of a serve looks up is
    among those the engine's warm hands the autotuner (the batch loop's
    decode over one cache index; the scheduler's per-row slot decode and
    its prefill chunks; a prefix hit's tail), so after the warm the serve
    looks up without a miss."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, RequestState
    from repro_torch.serve.scheduler import SchedulerConfig

    cfg = configs.get_smoke("qwen3-1.7b")
    params = lm.init_model(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    lens = {"batch": [9, 9], "slot_chunked": [5, 21, 12],
            "paged_prefix": [19, 19]}[mode]
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]
    if mode == "paged_prefix":
        prompts[1][:16] = prompts[0][:16]
    sc = {"batch": None,
          "slot_chunked": SchedulerConfig(max_batch=2, prefill_chunk=8,
                                          page_size=0),
          "paged_prefix": SchedulerConfig(max_batch=2, page_size=8)}[mode]
    warmed = []
    real = Engine._warm_autotune

    def recording(self, *args, **kw):
        warmed.extend(self._hot_problems(*args, **kw))
        return real(self, *args, **kw)

    monkeypatch.setattr(Engine, "_warm_autotune", recording)

    def serve():
        eng = Engine(cfg, params, max_len=48, device="cpu",
                     scheduler_config=sc)
        reqs = [eng.submit(p, 3) for p in prompts]
        if mode == "batch":
            eng.serve(reqs)
        else:
            eng.drain()
        assert all(r.state == RequestState.DONE for r in reqs)
        return eng

    ops.RESOLVED.clear()
    eng = serve()
    if mode == "paged_prefix":
        assert eng.scheduler_report()["pages"]["reuse_hits"] == 1
    assert ops.RESOLVED and set(ops.RESOLVED) <= set(warmed)
    autotune.clear()
    autotune.warm(warmed)
    autotune.reset_stats()
    serve()
    assert autotune.stats()["misses"] == 0 and autotune.stats()["hits"] > 0
