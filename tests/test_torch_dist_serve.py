"""The remeshed engine's continuous scheduler at gloo world size 2.

An engine moved onto a mesh (``Engine.restore(devices=)``, or its
``_remesh`` at 2x1) serves through the continuous scheduler: the page
pool with paged decode (``lm.paged_decode_step(..., dist=)``), chunked
prefill (``lm.prefill_chunk(..., dist=)``, its attention split over the
cache's keys at 1x2) and the slot cache.  One pair of worker processes
(``WORKER``, importing only ``repro_torch``; a ``FileStore`` in the
test's temporary directory, never a fixed port) runs every scenario over
one process group and saves both ranks' results; the tests here hold
them:

  * (a) the qwen3 smoke config at 1x2 (a fresh journal's
    ``restore(devices=)``) and at 2x1: ``drain()`` of prompts of 7, 12, 2
    and 23 tokens for 6 tokens, and ``serve()`` of the same mixed batch,
    each with the JAX engine's greedy tokens on one device (bridged
    weights);
  * (b) the serving invariants port vs port at 1x2: a mixed batch
    (``max_batch=2``) emits what each prompt emits alone; a prefix hit
    what a miss emits; chunked prefill (chunks of 8, and of 10, whose
    chunk 20-29 straddles the ranks' halves of the 48 positions) what a
    whole prefill emits; pool pressure (``FORMERLY_UNPORTED["pool_full"]``
    and ``["spill"]`` of ``tests/test_torch_serve.py``) spills and
    preempts and ends with the JAX engine's tokens; a journaled
    continuous drain cut by a kill, restored onto the mesh, replays to
    the uninterrupted tokens (``replay_divergence == 0``);
  * (c) the slot path at 1x2 (an int8 KV cache, the hymba smoke config)
    with the JAX engine's tokens;
  * (d) after every drain the two ranks' page pools are bit-equal (and
    were written);
  * (e) deadlines read one clock: rank 0's reading ticks by one per
    call and rank 1's jumps by 10^6 s after its third reading; both
    ranks evict the same request at the same step (the one whose
    deadline rank 0's clock passes), keep the one whose deadline only
    rank 1's own clock passes, and both drains end.

About 60 s alone on the CPU.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro_torch import configs
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.models import bridge
from repro_torch.serve.engine import Engine

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MAX_LEN = 48
# config key -> (registry name, config changes)
CFGS = {"qwen3": ("qwen3-1.7b", {}),
        "int8": ("qwen3-1.7b", {"kv_cache_dtype": "int8"}),
        "hymba": ("hymba-1.5b", {})}
# scenario -> (prompt lengths, new tokens, scheduler config)
POOL = {
    # two 14-token prompts fill 4 of 5 pages: decode growth runs the whole
    # ladder (spills, then preemptions)
    "pool_full": ([14, 14], 10, dict(max_batch=2, n_pages=5, page_size=8)),
    # three requests in 6 pages: one spills at a page boundary and comes
    # back once another finishes
    "spill": ([12, 12, 3], 8, dict(max_batch=3, n_pages=6, page_size=8)),
}
CHUNKS = (8, 10)
# The drains whose engines keep a page pool (held rank against rank).
POOL_DRAINS = (["drain_1x2", "drain_2x1", "mixed", "prefix", "chunk0",
                "crash_free", "hymba", "skew"]
               + [f"chunk{c}" for c in CHUNKS]
               + list(POOL))
# (e): rank 0's clock ticks 1 s a reading; the first request's deadline
# passes on it mid-run, the second's on rank 1's own clock alone.
SKEW_DEADLINES = (6.0, 1.0e5, None)

WORKER = r'''
import dataclasses, json, os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, job = int(sys.argv[1]), json.load(open(sys.argv[2]))
dist.init_process_group("gloo", init_method="file://" + job["store"],
                        rank=rank, world_size=2)
from repro_torch import configs
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.models import lm
from repro_torch.runtime import elastic
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import SchedulerConfig

os.environ["REPRO_JOURNAL_DIR"] = ""
CFGS = {k: dataclasses.replace(configs.get_smoke(name), **over)
        for k, (name, over) in job["cfgs"].items()}
PARAMS = {k: Checkpointer(p).restore(device="cpu")[1]["params"]
          for k, p in job["params"].items()}
PROMPTS = {k: [np.asarray(p, np.int32) for p in v]
           for k, v in job["prompts"].items()}
MESHES = {}
res, pools = {}, {}


def remeshed(key, tag, journal=None, **sc):
    """An engine on the ``tag`` mesh, moved there as ``restore(devices=)``
    moves it (``Engine._remesh``), the 2x1 grid by one ``model`` rank at
    most."""
    eng = Engine(CFGS[key], PARAMS[key], max_len=job["max_len"],
                 device="cpu", journal_dir=journal,
                 scheduler_config=SchedulerConfig(**sc) if sc else None)
    if (key, tag) not in MESHES:
        plan = elastic.plan_remesh(["cpu", "cpu"],
                                   engine_mod._shapes(PARAMS[key]),
                                   max_model=int(tag.split("x")[1]))
        MESHES[key, tag] = (lm.Dist(plan.new_mesh, ("data",), "model"),
                            elastic.reshard(PARAMS[key],
                                            plan.param_shardings))
    eng.dist, eng.params = MESHES[key, tag]
    return eng


def record(label, eng, reqs):
    st = eng.stats()
    res[label] = {
        "tokens": [list(r.out_tokens) for r in reqs],
        "states": [r.state.value for r in reqs],
        "mesh": list(eng.dist.mesh.shape),
        "stats": {k: st[k] for k in ("spills", "unspills", "preemptions",
                                     "replay_divergence", "demotions",
                                     "failed", "evicted")},
        "report": eng.scheduler_report(),
        "evicted": [[e.step, e.detail] for e in eng.monitor.events
                    if e.kind == "evicted"],
    }
    sched = eng._scheduler
    if sched is not None and sched.paged is not None:
        pools[label] = torch.stack([sched.paged.k_pages,
                                    sched.paged.v_pages]).numpy()


def drain(label, eng, prompts, new, deadlines=None):
    reqs = [eng.submit(p, new, deadline_s=None if deadlines is None
                       else deadlines[i]) for i, p in enumerate(prompts)]
    eng.drain()
    record(label, eng, reqs)


def serve(label, eng, prompts, new):
    reqs = [eng.submit(p, new) for p in prompts]
    eng.serve(reqs)
    record(label, eng, reqs)


jdir = lambda name: os.path.join(job["tmp"], f"journal_{name}_{rank}")

# (a) the paged path at 1x2 (a fresh journal's restore) and 2x1
eng = Engine(CFGS["qwen3"], PARAMS["qwen3"], max_len=job["max_len"],
             device="cpu", journal_dir=jdir("fresh"))
assert eng.restore(devices=["cpu", "cpu"]) == []
drain("drain_1x2", eng, PROMPTS["mixed"], 6)
drain("drain_2x1", remeshed("qwen3", "2x1"), PROMPTS["mixed"], 6)
for tag in ("1x2", "2x1"):
    serve(f"serve_{tag}", remeshed("qwen3", tag), PROMPTS["mixed"], 6)

# (b) the invariants at 1x2
drain("mixed", remeshed("qwen3", "1x2", max_batch=2), PROMPTS["alone"], 4)
for i, p in enumerate(PROMPTS["alone"] + PROMPTS["prefix"]):
    drain(f"alone_{i}", remeshed("qwen3", "1x2"), [p], 4)
drain("prefix", remeshed("qwen3", "1x2", max_batch=2, page_size=8),
      PROMPTS["prefix"], 4)
drain("chunk0", remeshed("qwen3", "1x2"), PROMPTS["chunk"], 6)
for c in job["chunks"]:
    drain(f"chunk{c}", remeshed("qwen3", "1x2", prefill_chunk=c),
          PROMPTS["chunk"], 6)
for name, (_, new, sc) in job["pool"].items():
    drain(name, remeshed("qwen3", "1x2", **sc), PROMPTS[name], new)
eng = Engine(CFGS["qwen3"], PARAMS["qwen3"], max_len=job["max_len"],
             device="cpu", journal_dir=job["crash"] + f"_{rank}")
rec = eng.restore(devices=["cpu", "cpu"])
pending = eng._pending_resume
res["crash_armed"] = [pending["mode"], pending["cache"] is None]
eng.serve(rec)
record("crash", eng, rec)
drain("crash_free", remeshed("qwen3", "1x2"), PROMPTS["crash"], 6)

# (c) the slot path at 1x2
for key in ("int8", "hymba"):
    drain(key, remeshed(key, "1x2"), PROMPTS["mixed"], 6)

# (e) one clock for every rank
real, ticks = engine_mod.local_clock, [0]


def skewed():
    ticks[0] += 1
    if rank == 0:
        return float(ticks[0])
    return real() + (1.0e6 if ticks[0] > 3 else 0.0)


engine_mod.local_clock = skewed
drain("skew", remeshed("qwen3", "1x2", max_batch=2, prefill_chunk=8),
      PROMPTS["skew"], 8, job["skew_deadlines"])
engine_mod.local_clock = real

json.dump(res, open(job["out"] + f"_{rank}.json", "w"))
np.savez(job["out"] + f"_pools_{rank}.npz", **pools)
dist.destroy_process_group()
'''


def _cfg_pair(key):
    name, over = CFGS[key]
    return (dataclasses.replace(configs.get_smoke(name), **over),
            dataclasses.replace(jconfigs.get_smoke(name), **over))


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in lens]


def _jax_tokens(jcfg, jp, prompts, new, **sc):
    eng = JaxEngine(jcfg, jp, max_len=MAX_LEN, scheduler_config=(
        JaxSchedulerConfig(**sc) if sc else None))
    reqs = [eng.submit(p, new) for p in prompts]
    eng.drain()
    assert all(r.state.value == "done" for r in reqs)
    return [list(r.out_tokens) for r in reqs]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both ranks' results and pools, the prompts, and the JAX engine's
    tokens (computed while the workers run)."""
    tmp = tmp_path_factory.mktemp("dist_serve")
    cfg, _ = _cfg_pair("qwen3")
    jps, tps = {}, {}
    for key in ("qwen3", "hymba"):
        c, jc = _cfg_pair(key)
        jps[key] = jlm.init_model(jc, jax.random.PRNGKey(0))
        tps[key] = bridge.params_from_numpy(jax.tree.map(np.asarray,
                                                         jps[key]), c,
                                            device="cpu")
        Checkpointer(str(tmp / f"params_{key}")).save(
            0, {"params": tps[key]}, blocking=True)
    jps["int8"] = jps["qwen3"]
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab_size, (19,)).astype(np.int32)
    prompts = {
        "mixed": _prompts(cfg, [7, 12, 2, 23], 0),
        "alone": _prompts(cfg, [3, 9, 4, 6, 11], 1),
        "prefix": [shared, np.concatenate(
            [shared[:16],
             rng.integers(0, cfg.vocab_size, (5,)).astype(np.int32)])],
        "chunk": _prompts(cfg, [30, 12, 7], 2),
        "crash": _prompts(cfg, [9, 4, 14], 4),
        "skew": _prompts(cfg, [20, 7, 12], 5),
        **{name: _prompts(cfg, lens, 9) for name, (lens, _, _) in
           POOL.items()},
    }

    # a journaled continuous drain on one device, then the journal a kill
    # leaves: no terminal records, the last 2 tokens lost
    crash = tmp / "crash"
    eng = Engine(cfg, tps["qwen3"], max_len=MAX_LEN, device="cpu",
                 journal_dir=str(crash))
    reqs = [eng.submit(p, 6) for p in prompts["crash"]]
    eng.drain()
    base = [list(r.out_tokens) for r in reqs]
    path = crash / "journal.jsonl"
    keep = [line for line in open(path)
            if json.loads(line)["rec"]["kind"] not in ("done", "failed",
                                                        "evicted")]
    tok = [i for i, line in enumerate(keep)
           if json.loads(line)["rec"]["kind"] == "token"]
    open(path, "w").writelines(line for i, line in enumerate(keep)
                               if i not in set(tok[-2:]))
    for r in range(2):
        shutil.copytree(crash, f"{crash}_{r}")

    job = {"store": str(tmp / "store"), "tmp": str(tmp), "max_len": MAX_LEN,
           "cfgs": CFGS, "params": {k: str(tmp / f"params_{k}")
                                    for k in ("qwen3", "hymba")},
           "prompts": {k: [p.tolist() for p in v]
                       for k, v in prompts.items()},
           "chunks": CHUNKS, "pool": POOL, "crash": str(crash),
           "skew_deadlines": SKEW_DEADLINES, "out": str(tmp / "out")}
    job["params"]["int8"] = job["params"]["qwen3"]
    (tmp / "job.json").write_text(json.dumps(job))
    (tmp / "worker.py").write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC)}
    env.pop("REPRO_FAULT_PLAN", None)
    procs = [subprocess.Popen([sys.executable, str(tmp / "worker.py"),
                               str(r), str(tmp / "job.json")], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        jax_tokens = {"mixed": _jax_tokens(_cfg_pair("qwen3")[1],
                                           jps["qwen3"], prompts["mixed"], 6)}
        for key in ("int8", "hymba"):
            jax_tokens[key] = _jax_tokens(_cfg_pair(key)[1], jps[key],
                                          prompts["mixed"], 6)
        for name, (_, new, sc) in POOL.items():
            jax_tokens[name] = _jax_tokens(_cfg_pair("qwen3")[1],
                                           jps["qwen3"], prompts[name], new,
                                           **sc)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    res = [json.load(open(tmp / f"out_{r}.json")) for r in range(2)]
    pools = [dict(np.load(tmp / f"out_pools_{r}.npz")) for r in range(2)]
    return {"res": res, "pools": pools, "jax": jax_tokens, "base": base,
            "prompts": prompts}


def _each(run, label):
    """``label``'s result on each rank, the two ranks' tokens and states
    equal."""
    a, b = (res[label] for res in run["res"])
    assert a["tokens"] == b["tokens"] and a["states"] == b["states"]
    return a


def _done(got) -> None:
    assert all(s == "done" for s in got["states"]), got["states"]
    assert got["stats"]["demotions"] == 0 and got["stats"]["failed"] == 0


@pytest.mark.parametrize("label,mesh", [
    ("drain_1x2", [1, 2]), ("drain_2x1", [2, 1]),
    ("serve_1x2", [1, 2]), ("serve_2x1", [2, 1])])
def test_remeshed_engine_matches_jax_engine(run, label, mesh):
    """(a) ``drain()`` and ``serve()`` of a mixed-length batch on the mesh
    (the 1x2 drain's engine remeshed by a fresh journal's
    ``restore(devices=)``) emit the JAX engine's greedy tokens; the paged
    path served them."""
    got = _each(run, label)
    _done(got)
    assert got["mesh"] == mesh
    assert got["tokens"] == run["jax"]["mixed"]
    assert got["report"]["paged_decode"] is True


def test_mixed_batch_equals_alone(run):
    got = _each(run, "mixed")
    _done(got)
    alone = [_each(run, f"alone_{i}")["tokens"][0]
             for i in range(len(run["prompts"]["alone"]))]
    assert got["tokens"] == alone
    assert got["report"]["pages"]["pages_free"] == \
        got["report"]["pages"]["pages_total"]


def test_prefix_hit_equals_miss(run):
    got = _each(run, "prefix")
    _done(got)
    pages = got["report"]["pages"]
    assert pages["reuse_hits"] == 1 and pages["reuse_pages"] == 2
    n = len(run["prompts"]["alone"])
    assert got["tokens"] == [_each(run, f"alone_{n + i}")["tokens"][0]
                             for i in range(2)]


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_prefill_equals_whole(run, chunk):
    """Chunks of 8 (the 30-token prompt's chunk 24-29 wholly in rank 1's
    half of the keys, chunk 16-23 wholly in rank 0's) and of 10 (chunk
    20-29 across the halves) through ``prefill_chunk(dist=)``."""
    got = _each(run, f"chunk{chunk}")
    _done(got)
    assert got["tokens"] == _each(run, "chunk0")["tokens"]


@pytest.mark.parametrize("name", sorted(POOL))
def test_pool_pressure_matches_jax(run, name):
    got = _each(run, name)
    _done(got)
    assert got["tokens"] == run["jax"][name]
    st = got["stats"]
    assert st["spills"] + st["preemptions"] > 0
    assert st["replay_divergence"] == 0
    if name == "spill":
        assert st["spills"] > 0 and st["unspills"] > 0


def test_crash_replay_onto_mesh_gives_uninterrupted_tokens(run):
    """A continuous drain's journal, cut by a kill, restored onto the 1x2
    mesh: a cold replay through a fresh continuous scheduler there."""
    for res in run["res"]:
        assert res["crash_armed"] == ["continuous", True]
    got = _each(run, "crash")
    _done(got)
    assert got["mesh"] == [1, 2]
    assert got["tokens"] == run["base"]
    assert got["stats"]["replay_divergence"] == 0
    assert _each(run, "crash_free")["tokens"] == run["base"]


@pytest.mark.parametrize("key", ["int8", "hymba"])
def test_slot_path_matches_jax_engine(run, key):
    """The slot cache over the mesh (its rows' K/V split over the keys
    at decode): an int8 KV cache and the hybrid decoder."""
    got = _each(run, key)
    _done(got)
    assert got["report"]["paged_decode"] is False
    assert got["tokens"] == run["jax"][key]


@pytest.mark.parametrize("label", POOL_DRAINS)
def test_ranks_page_pools_bit_equal(run, label):
    """(d) Every rank writes the same K/V into its replica of the pool."""
    a, b = (pools[label] for pools in run["pools"])
    assert a.shape == b.shape and np.any(a != 0)
    assert a.tobytes() == b.tobytes()


def test_skewed_clock_evicts_the_same_request_on_both_ranks(run):
    """(e) Both ranks evict the first request at the same step, on rank
    0's clock, and keep the second, whose deadline only rank 1's own
    clock passed; both drains ended (the workers returned)."""
    a, b = (res["skew"] for res in run["res"])
    assert a["states"] == b["states"] == ["evicted", "done", "done"]
    assert a["evicted"] == b["evicted"] and len(a["evicted"]) == 1
    assert a["tokens"] == b["tokens"]
    assert a["stats"]["evicted"] == b["stats"]["evicted"] == 1
