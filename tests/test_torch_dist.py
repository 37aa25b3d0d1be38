"""The port's multi-device stack at gloo world size 2, against the JAX
package on one device.

One pair of worker processes (``WORKER``, importing only ``repro_torch``;
a ``FileStore`` in the test's temporary directory, never a fixed port)
runs every case over one process group and saves its results; the tests
here hold them against the JAX package:

  * ``CASES``, each at TP=2 (a 1x2 mesh), the qwen3 smoke config also at
    DP=2 (2x1): the qwen3 smoke config (attention split by heads), the
    same with one KV head (the "query" split: each rank takes its query
    heads' KV head) and with three query heads (attention replicated over
    ``model``), the mamba2 and hymba smoke configs (the Mamba2 block and
    its state) and the whisper smoke config (the encoder and cross
    attention).  Each against the JAX single-device results:
      - the forward's logits (float32, atol/rtol 1e-4, ``FWD_TOL``);
      - the training loss (``remat="dots"``, as the port's default step)
        within ``LOSS_RTOL`` and every parameter's gradient within
        ``GRAD_TOL`` of its leaf's largest magnitude, the bounds of
        ``tests/test_torch_train.py`` (float32 summed in other orders),
        against ``jax.value_and_grad`` of the reference's ``loss_fn``:
        this holds the vocab-parallel cross entropy's backward, the
        ``Partial`` gradients of the regions and the reduce-scatter that
        undoes each FSDP gather against the reference;
      - a cold prefill over the mesh, then ``DECODE_STEPS`` decode steps
        on its cache of DTensors (the last with one cache index per row),
        the logits of each against the JAX ``prefill``/``decode_step``
        (``FWD_TOL``);
  * ``moe_apply_sharded`` on the qwen3-moe smoke config's first layer in
    all-to-all mode (S=16) and psum-local mode (S=1) against the JAX
    ``moe_apply`` at a capacity with no drops (atol/rtol 1e-5), and with
    the int8 payload on, differentiated (the payload is int8 only in
    training, as the reference's ``custom_vjp`` sends it), against the
    JAX ``moe_apply_sharded`` on one device under ``jax.vjp``, whose
    all-to-alls quantize the same per-slot payload; the aux
    loss against the mean of the JAX aux over each rank's tokens;
  * ``compressed_psum``: its closed form at one step, and error feedback
    over 50 steps (the reference's bound, 4 code steps);
  * decode at 1x2 with the cache attention split over the keys (each
    rank attending over its half of the ``SERVE_LEN`` positions, the
    ranks' outputs merged through B2's row statistics), beyond the cases
    above (``SPLIT_CASES``): a last step whose rows' keys all lie in rank
    0's range (rank 1 seeing none of them), an int8 cache (decoding from
    the JAX prefill's codes and scales, copied into the mesh cache's
    shards: a prefill value quantized to the next code by one package
    and not the other moves the logits by ~1e-3 on one device as well),
    and hymba's 4-layer variant, whose layer 1 attends over 8 keys with
    the window straddling the ranks' boundary at 12; each step's logits
    against the JAX ``decode_step`` (``FWD_TOL``); the last decode step's
    all-gathers (``hlo_analysis.CollectiveCounter``) are the merge's
    alone, none carrying a cache shard's bytes, and each rank's cache
    buffers hold its own positions alone, equal to the JAX cache's;
  * ``make_global_batch``: each rank holds its slice alone;
  * a batch snapshot restored onto a 1x2 mesh (``Engine.restore(
    devices=)``) resumes to the uninterrupted run's tokens, bit for bit.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.models import bridge
from repro_torch.optim.adamw import leaves

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CFG = configs.get_smoke("qwen3-1.7b")
MOE = "qwen3-moe-235b-a22b"
MAX_LEN = 48
NEW_TOKENS = 6
FWD_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 1e-5
GRAD_TOL = 5e-5            # of the leaf's largest |gradient|
BATCH, SEQ, ENC_LEN = 4, 16, 16
SERVE_LEN, DECODE_STEPS = 24, 3

# case -> (arch, config overrides, meshes (data x model))
CASES = {
    "dense": ("qwen3-1.7b", {}, ("1x2", "2x1")),
    "query": ("qwen3-1.7b", {"n_kv_heads": 1}, ("1x2",)),
    "replicated": ("qwen3-1.7b", {"n_heads": 3, "n_kv_heads": 1}, ("1x2",)),
    "mamba2": ("mamba2-780m", {}, ("1x2",)),
    "hymba": ("hymba-1.5b", {}, ("1x2",)),
    "whisper": ("whisper-tiny", {}, ("1x2",)),
}
CASE_MESHES = [(c, m) for c, (_, _, ms) in CASES.items() for m in ms]
# Decode with the cache attention split over the keys at 1x2, prefill and
# decode alone: case -> (arch, config overrides, the last step's index per
# row, or None for the cases' own).  At SERVE_LEN 24 rank 0 holds
# positions 0-11 and rank 1 12-23.
SPLIT_CASES = {
    # rows at 4 and 11: every key in rank 0's range, rank 1 sees none
    "edge": ("qwen3-1.7b", {}, [4, 11, 12, 17]),
    "int8": ("qwen3-1.7b", {"kv_cache_dtype": "int8"}, None),
    # layer 1 windowed over 8 keys: at 16-18 the window spans 9-18
    "hymba4": ("hymba-1.5b", {"n_layers": 4}, None),
}
# The cases whose last decode step's collectives and cache shards are
# held (each at 1x2).
SPLIT_KEYS = ["dense"] + list(SPLIT_CASES)
# The cases whose Mamba2 block, encoder or cross attention split over
# ``model`` at 1x2: their forward's and last decode step's all-gathers,
# and their cache shards after it, are held too.
BLOCK_KEYS = ["mamba2", "hymba", "whisper"]

WORKER = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, job = int(sys.argv[1]), json.load(open(sys.argv[2]))
dist.init_process_group("gloo", init_method="file://" + job["store"],
                        rank=rank, world_size=2)
import dataclasses
from repro_torch import configs
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.launch import hlo_analysis, mesh as mesh_lib, sharding
from repro_torch.models import lm, moe, parallel
from repro_torch.optim import compress
from repro_torch.optim.adamw import leaves
from repro_torch.serve.engine import Engine
from repro_torch.train.step import make_loss_fn, value_and_grad

out = {}


class Gathers(hlo_analysis.CollectiveCounter):
    """The dtype and shape of each all-gather's result, in order."""

    def __init__(self):
        super().__init__()
        self.gathers = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        count = self.stats.count_by_kind.get("all-gather", 0)
        res = super().__torch_dispatch__(func, types, args, kwargs)
        if self.stats.count_by_kind.get("all-gather", 0) > count:
            self.gathers.append(f"{res.dtype} "
                                + "x".join(map(str, res.shape)))
        return res


def serve(sp, ccfg, d, data, toks, frames, key, held):
    """A cold prefill over the mesh, then the decode steps (the last at
    one index per row); with ``held``, the last step's all-gathers and
    the local cache buffers after it."""
    logits, cache = lm.prefill(sp, toks, ccfg, max_len=job["serve_len"],
                               enc_frames=frames, dist=d)
    for name in ("k", "v", "k_scale", "v_scale"):
        if "cache_" + name in data:    # decode from the reference's codes
            full = torch.from_numpy(data["cache_" + name])
            cache[name].to_local().copy_(full[sharding.shard_slices(
                tuple(full.shape), cache[name].placements, d.mesh)])
    steps = [logits.full_tensor().numpy()]
    counter = Gathers()
    for j, nxt in enumerate(data["decode"]):
        last = j == len(data["decode"]) - 1
        if last:   # one index per row
            cache["index"] = torch.from_numpy(data["ragged"])
            with counter:
                logits, cache = lm.decode_step(sp, cache,
                                               torch.from_numpy(nxt), ccfg,
                                               dist=d)
        else:
            logits, cache = lm.decode_step(sp, cache, torch.from_numpy(nxt),
                                           ccfg, dist=d)
        steps.append(logits.full_tensor().numpy())
    out[f"serve_{key}"] = np.stack(steps)
    if held:
        out[f"gathers_{key}"] = np.array(counter.gathers)
        for name in ("k", "v", "ssm", "conv", "cross_k", "cross_v"):
            if name in cache:
                out[f"cache_{key}_{name}"] = cache[name].to_local().numpy()


for case, (arch, over, meshes) in job["cases"].items():
    ccfg = dataclasses.replace(configs.get_smoke(arch), **over)
    _, st, _ = Checkpointer(job["params"][case]).restore(device="cpu")
    data = dict(np.load(job["data"][case]))
    toks = torch.from_numpy(data["tokens"])
    frames = (torch.from_numpy(data["frames"]) if ccfg.is_encoder_decoder
              else None)
    batch = {"tokens": toks, "targets": torch.from_numpy(data["targets"])}
    if frames is not None:
        batch["enc_frames"] = frames
    for tag in meshes:
        mesh = mesh_lib.make_test_mesh(*map(int, tag.split("x")),
                                       device_type="cpu")
        d = lm.Dist(mesh, ("data",), "model")
        sp = parallel.shard_params(st["params"], mesh)
        key = f"{case}_{tag}"
        counter = Gathers()
        with counter:
            logits, _ = lm.forward(sp, toks, ccfg, enc_frames=frames, dist=d)
        out[f"fwd_gathers_{key}"] = np.array(counter.gathers)
        out[f"fwd_{key}"] = logits.full_tensor().numpy()
        loss, _, grads = value_and_grad(make_loss_fn(ccfg, dist=d), sp,
                                        batch)
        out[f"loss_{key}"] = np.array(float(loss))
        for path, g in leaves(grads):
            out[f"grad_{key}|" + "/".join(path)] = g.full_tensor().numpy()
        serve(sp, ccfg, d, data, toks, frames, key,
              key in job["split_keys"])

for case, (arch, over, _) in job["split_cases"].items():
    ccfg = dataclasses.replace(configs.get_smoke(arch), **over)
    _, st, _ = Checkpointer(job["params"][case]).restore(device="cpu")
    data = dict(np.load(job["data"][case]))
    mesh = mesh_lib.make_test_mesh(1, 2, device_type="cpu")
    d = lm.Dist(mesh, ("data",), "model")
    serve(parallel.shard_params(st["params"], mesh), ccfg, d, data,
          torch.from_numpy(data["tokens"]), None, f"{case}_1x2", True)

cfg = configs.get_smoke("qwen3-1.7b")
_, st, _ = Checkpointer(job["params"]["dense"]).restore(device="cpu")
params = st["params"]

mcfg = dataclasses.replace(configs.get_smoke(job["moe_arch"]),
                           capacity_factor=16.0)
_, st, _ = Checkpointer(job["moe"]).restore(device="cpu")
p = {k: v[0] for k, v in st["params"]["layers"]["moe"].items()
     if torch.is_tensor(v)}
if "shared" in st["params"]["layers"]["moe"]:
    p["shared"] = {k: v[0] for k, v in
                   st["params"]["layers"]["moe"]["shared"].items()}
mesh = mesh_lib.make_test_mesh(1, 2, device_type="cpu")
sh = sharding.param_shardings({"layers": {"moe": {
    k: v[None] if torch.is_tensor(v) else {kk: vv[None] for kk, vv in
                                          v.items()}
    for k, v in p.items()}}}, mesh)["layers"]["moe"]

def placed(v, s):
    from torch.distributed.tensor import Shard
    pls = tuple(Shard(pl.dim - 1) if hasattr(pl, "dim") else pl
                for pl in s.placements)
    return parallel.from_global(v, mesh, pls)

pd = {k: placed(v, sh[k]) if torch.is_tensor(v) else
      {kk: placed(vv, sh[k][kk]) for kk, vv in v.items()}
      for k, v in p.items()}
for name in ("a2a", "psum"):
    x = torch.from_numpy(np.load(job[f"moe_x_{name}"]))
    xd = parallel.tokens_on(lm.Dist(mesh, ("data",), "model"), x)
    for int8 in (False, True):
        moe.A2A_INT8 = int8
        # differentiated, as the int8 payload is sent only in training
        y, aux = moe.moe_apply_sharded(pd, xd.detach().requires_grad_(),
                                       mcfg, mesh, ("data",), "model")
        out[f"moe_{name}_{int(int8)}"] = y.full_tensor().detach().numpy()
        out[f"moe_aux_{name}_{int(int8)}"] = \
            aux.full_tensor().detach().numpy()
moe.A2A_INT8 = True

g_all = np.load(job["grads"])
group = (mesh, 1)
red, res = compress.compressed_psum({"g": torch.from_numpy(g_all[0, rank])},
                                    group)
out["psum_one"] = red["g"].numpy()
res = None
reds = []
for s in range(g_all.shape[0]):
    red, res = compress.compressed_psum(
        {"g": torch.from_numpy(g_all[s, rank])}, group, res)
    reds.append(red["g"].numpy())
out["psum_steps"] = np.stack(reds)

ds = SyntheticLMDataset(vocab_size=100, seq_len=16, global_batch=4, seed=7)
mesh2 = mesh_lib.make_test_mesh(2, 1, device_type="cpu")
bsh = sharding.batch_shardings(ds.batch_np(3), mesh2)
gb = ds.batch(3, device="cpu", sharding=bsh)
out["batch_local"] = gb["tokens"].to_local().numpy()
out["batch_full"] = gb["tokens"].full_tensor().numpy()

os.environ["REPRO_JOURNAL_DIR"] = ""
eng = Engine(cfg, params, max_len=job["max_len"], device="cpu",
             journal_dir=job["journal"] + f"_{rank}")
rec = eng.restore(devices=["cpu", "cpu"])
armed = eng._pending_resume is not None and \
    eng._pending_resume["cache"] is not None
eng.serve(rec)
out["restored_tokens"] = np.array([r.out_tokens for r in rec])
out["restore_mesh"] = np.array(tuple(eng.dist.mesh.shape) + (int(armed),))
np.savez(job["out"] + f"_{rank}.npz", **out)
dist.destroy_process_group()
'''


def _cfgs(case):
    arch, over, _ = CASES[case] if case in CASES else SPLIT_CASES[case]
    return (dataclasses.replace(configs.get_smoke(arch), **over),
            dataclasses.replace(jconfigs.get_smoke(arch), **over))


def _save_port(jp, cfg, path):
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                  device="cpu")
    Checkpointer(str(path)).save(0, {"params": tp}, blocking=True)
    return tp


def _case_data(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    out = {"tokens": toks, "targets": np.roll(toks, -1, 1),
           "decode": rng.integers(0, cfg.vocab_size,
                                  (DECODE_STEPS, BATCH, 1)).astype(np.int32),
           # the last step's index per row: rows 1 and 3 a position back
           "ragged": (SEQ + DECODE_STEPS - 1
                      - np.arange(BATCH) % 2).astype(np.int32)}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.normal(size=(BATCH, ENC_LEN, cfg.d_model)
                                   ).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' results and the inputs they were given."""
    tmp = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    jps, datas = {}, {}
    for i, case in enumerate(CASES):
        cfg, jcfg = _cfgs(case)
        jps[case] = jlm.init_model(jcfg, jax.random.PRNGKey(i))
        got = _save_port(jps[case], cfg, tmp / f"params_{case}")
        datas[case] = _case_data(cfg, 10 + i)
        if case == "dense":
            tp = got
            toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(
                np.int32)
            datas[case].update(tokens=toks, targets=np.roll(toks, -1, 1))
        np.savez(tmp / f"data_{case}.npz", **datas[case])
    for i, (case, (_, _, ragged)) in enumerate(SPLIT_CASES.items()):
        cfg, jcfg = _cfgs(case)
        jps[case] = jlm.init_model(jcfg, jax.random.PRNGKey(20 + i))
        _save_port(jps[case], cfg, tmp / f"params_{case}")
        datas[case] = _case_data(cfg, 30 + i)
        if ragged is not None:
            datas[case]["ragged"] = np.array(ragged, dtype=np.int32)
        if cfg.kv_cache_dtype == "int8":
            _, jc = jlm.prefill(jps[case], jnp.asarray(datas[case]["tokens"]),
                                jcfg, max_len=SERVE_LEN)
            for name in ("k", "v", "k_scale", "v_scale"):
                datas[case]["cache_" + name] = np.asarray(jc[name])
        np.savez(tmp / f"data_{case}.npz", **datas[case])
    mcfg = jconfigs.get_smoke(MOE)
    mp = jlm.init_model(mcfg, jax.random.PRNGKey(1))
    _save_port(mp, configs.get_smoke(MOE), tmp / "moe")
    xs = {"a2a": rng.normal(size=(2, 16, mcfg.d_model)).astype(np.float32),
          "psum": rng.normal(size=(4, 1, mcfg.d_model)).astype(np.float32)}
    for k, v in xs.items():
        np.save(tmp / f"moe_x_{k}.npy", v)
    grads = rng.normal(size=(50, 2, 32)).astype(np.float32)
    np.save(tmp / "grads.npy", grads)

    # an interrupted batch: served on one device with snapshots every 2
    # steps, then the journal a kill leaves (no terminals, 2 tokens lost)
    from repro_torch.serve.engine import Engine
    prompts = rng.integers(0, CFG.vocab_size, (2, 8)).astype(np.int32)
    jdir = tmp / "journal"
    eng = Engine(CFG, tp, max_len=MAX_LEN, device="cpu",
                 journal_dir=str(jdir), snapshot_every=2)
    reqs = [eng.submit(p, NEW_TOKENS) for p in prompts]
    eng.serve(reqs)
    base = [list(r.out_tokens) for r in reqs]
    path = jdir / "journal.jsonl"
    keep = [line for line in open(path)
            if json.loads(line)["rec"]["kind"] not in ("done", "failed",
                                                        "evicted")]
    tok = [i for i, line in enumerate(keep)
           if json.loads(line)["rec"]["kind"] == "token"]
    keep = [line for i, line in enumerate(keep) if i not in set(tok[-2:])]
    open(path, "w").writelines(keep)
    for r in range(2):
        shutil.copytree(jdir, f"{jdir}_{r}")

    job = {"store": str(tmp / "store"), "cases": CASES,
           "split_cases": SPLIT_CASES,
           "split_keys": [f"{c}_1x2" for c in SPLIT_KEYS + BLOCK_KEYS],
           "params": {c: str(tmp / f"params_{c}")
                      for c in (*CASES, *SPLIT_CASES)},
           "data": {c: str(tmp / f"data_{c}.npz")
                    for c in (*CASES, *SPLIT_CASES)},
           "serve_len": SERVE_LEN,
           "moe": str(tmp / "moe"), "moe_arch": MOE,
           "grads": str(tmp / "grads.npy"),
           "journal": str(jdir), "max_len": MAX_LEN, "out": str(tmp / "out"),
           **{f"moe_x_{k}": str(tmp / f"moe_x_{k}.npy") for k in xs}}
    (tmp / "job.json").write_text(json.dumps(job))
    (tmp / "worker.py").write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC)}
    env.pop("REPRO_FAULT_PLAN", None)
    procs = [subprocess.Popen([sys.executable, str(tmp / "worker.py"),
                               str(r), str(tmp / "job.json")], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    res = [dict(np.load(tmp / f"out_{r}.npz")) for r in range(2)]
    return {"res": res, "jps": jps, "data": datas, "mp": mp, "mcfg": mcfg,
            "xs": xs, "grads": grads, "base": base}


_JAX = {}


def _jax_ref(run, case):
    """The JAX package's single-device forward, loss and gradients
    (``remat="dots"``, as the port's step runs) and prefill/decode logits
    of ``case``, the gradients in the port's layout."""
    if case in _JAX:
        return _JAX[case]
    cfg, jcfg = _cfgs(case)
    jp, data = run["jps"][case], run["data"][case]
    frames = (jnp.asarray(data["frames"]) if cfg.is_encoder_decoder
              else None)
    toks = jnp.asarray(data["tokens"])
    fwd, _ = jlm.forward(jp, toks, jcfg, enc_frames=frames)
    batch = {"tokens": toks, "targets": jnp.asarray(data["targets"])}
    if frames is not None:
        batch["enc_frames"] = frames
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jcfg, remat="dots"), has_aux=True))(
        jp, batch)
    serve = _jax_serve(jp, jcfg, data, toks, frames)
    port_grads = bridge.params_from_numpy(jax.tree.map(np.asarray, grads),
                                          cfg, device="cpu")
    _JAX[case] = {"fwd": np.asarray(fwd), "loss": float(loss),
                  "grads": {"/".join(p): g.numpy()
                            for p, g in leaves(port_grads)},
                  **serve}
    return _JAX[case]


def _jax_serve(jp, jcfg, data, toks, frames=None):
    """The JAX ``prefill`` and ``decode_step`` logits of a case (the last
    step at one index per row) and the cache's K/V after the last."""
    logits, cache = jlm.prefill(jp, toks, jcfg, max_len=SERVE_LEN,
                                enc_frames=frames)
    steps = [np.asarray(logits)]
    for j, nxt in enumerate(data["decode"]):
        cache = dict(cache)
        if j == len(data["decode"]) - 1:
            cache["index"] = jnp.asarray(data["ragged"])
        logits, cache = jlm.decode_step(jp, cache, jnp.asarray(nxt), jcfg)
        steps.append(np.asarray(logits))
    return {"serve": np.stack(steps),
            **{f"cache_{n}": np.asarray(cache[n])
               for n in ("k", "v", "ssm", "conv", "cross_k", "cross_v")
               if n in cache}}


def _jax_split(run, case):
    """``_jax_serve`` of a ``SPLIT_CASES`` case (or the dense case)."""
    if case in CASES:
        return _jax_ref(run, case)
    if case not in _JAX:
        _, jcfg = _cfgs(case)
        data = run["data"][case]
        _JAX[case] = _jax_serve(run["jps"][case], jcfg, data,
                                jnp.asarray(data["tokens"]))
    return _JAX[case]


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_forward_matches_jax_single_device(run, mesh):
    want = _jax_ref(run, "dense")["fwd"]
    for res in run["res"]:
        np.testing.assert_allclose(res[f"fwd_dense_{mesh}"], want, **FWD_TOL)


@pytest.mark.parametrize("case", [c for c in CASES if c != "dense"])
def test_mesh_paths_forward_matches_jax_single_device(run, case):
    """The query split, replicated attention, the Mamba2 block, the
    encoder and cross attention, at TP=2."""
    want = _jax_ref(run, case)["fwd"]
    for res in run["res"]:
        np.testing.assert_allclose(res[f"fwd_{case}_1x2"], want, **FWD_TOL)


@pytest.mark.parametrize("case,mesh", CASE_MESHES)
def test_train_loss_and_grads_match_jax(run, case, mesh):
    ref = _jax_ref(run, case)
    for res in run["res"]:
        got = float(res[f"loss_{case}_{mesh}"])
        assert got == pytest.approx(ref["loss"], rel=LOSS_RTOL)
        names = {k.split("|", 1)[1] for k in res
                 if k.startswith(f"grad_{case}_{mesh}|")}
        assert names == set(ref["grads"])
        for name, want in ref["grads"].items():
            g = res[f"grad_{case}_{mesh}|{name}"]
            assert g.shape == want.shape, name
            bound = GRAD_TOL * float(np.abs(want).max()) + 1e-12
            err = float(np.abs(g - want).max())
            assert err <= bound, (name, err, bound)


@pytest.mark.parametrize("case,mesh", CASE_MESHES)
def test_cold_prefill_then_decode_match_jax(run, case, mesh):
    """A prefill over the mesh into a fresh cache of DTensors (each rank
    writing its positions' range), then decode steps on it, the last at
    one index per row: the logits of every step over the real
    vocabulary."""
    cfg, _ = _cfgs(case)
    want = _jax_ref(run, case)["serve"][..., :cfg.vocab_size]
    for res in run["res"]:
        got = res[f"serve_{case}_{mesh}"][..., :cfg.vocab_size]
        np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_key_split_decode_matches_jax(run, case):
    """The cache attention split over the keys at 1x2: a row whose keys
    all lie in rank 0's range, an int8 cache, a window across the ranks'
    boundary."""
    cfg, _ = _cfgs(case)
    want = _jax_split(run, case)["serve"][..., :cfg.vocab_size]
    for res in run["res"]:
        got = res[f"serve_{case}_1x2"][..., :cfg.vocab_size]
        np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("case", SPLIT_KEYS)
def test_decode_gathers_no_cache_shard(run, case):
    """The last decode step gathers no cache: its all-gathers are, per
    attention layer, the merge's (every rank's partial output (B, Hq, 1,
    D) and row statistics (B, Hq, 1), float32), and the layer's weights
    (the projections run replicated over ``model``), each gathered whole:
    every other result holds as many elements as a parameter of a layer,
    and none as many as a layer's cache or a rank's shard of it."""
    cfg, _ = _cfgs(case)
    tp, hq = 2, cfg.n_heads
    merge = [f"torch.float32 {tp}x{BATCH}x{hq}x1x{cfg.d_head}",
             f"torch.float32 {tp}x{BATCH}x{hq}x1"]
    leaves = {int(np.prod(np.shape(v)[1:]))
              for v in jax.tree.leaves(run["jps"][case]["layers"])}
    cache = BATCH * cfg.n_kv_heads * SERVE_LEN * cfg.d_head
    state = [_assembly(cfg, tp)] if cfg.has_ssm else []
    for res in run["res"]:
        got = res[f"gathers_{case}_1x2"].tolist()
        assert [g for g in got if g in merge] == merge * cfg.n_layers
        assert [g for g in got if g in state] == state * cfg.n_layers
        for g in got:
            if g in merge + state:
                continue
            n = int(np.prod([int(e) for e in g.split()[1].split("x")]))
            assert n in leaves and n not in (cache, cache // tp), g


@pytest.mark.parametrize("case", SPLIT_KEYS)
def test_each_rank_keeps_its_own_positions(run, case):
    """After the decode steps each rank's cache buffers hold its own half
    of the positions, equal to the JAX cache's (int8 codes within one
    code: a fresh value may round to the neighbouring code in one
    package)."""
    cfg, _ = _cfgs(case)
    ref = _jax_split(run, case)
    half = SERVE_LEN // 2
    for r, res in enumerate(run["res"]):
        for name in ("k", "v"):
            got = res[f"cache_{case}_1x2_{name}"]
            want = ref[f"cache_{name}"][:, :, :, r * half:(r + 1) * half]
            assert got.shape == want.shape == (
                cfg.n_layers, BATCH, cfg.n_kv_heads, half, cfg.d_head)
            if got.dtype == np.int8:
                assert np.abs(got.astype(int) - want).max() <= 1
            else:
                np.testing.assert_allclose(got, want, **FWD_TOL)


def _assembly(cfg, tp):
    """The Mamba2 state's assembly, one all-gather a layer: every rank's
    P rows of the state and d_inner columns of the conv tail, float32."""
    n = (cfg.ssm_heads * cfg.ssm_state * cfg.ssm_headdim
         + (cfg.ssm_conv - 1) * cfg.d_inner) // tp
    return f"torch.float32 {tp}x{BATCH}x{n}"


# The Mamba2 leaves whose d_inner the rules shard over ``model``.
MAMBA_SHARDED = ("x_proj", "z_proj", "out_proj", "conv_x_w")


@pytest.mark.parametrize("step", ["fwd", "decode"])
@pytest.mark.parametrize("case", BLOCK_KEYS)
def test_block_splits_gather_no_sharded_leaf_or_cache(run, case, step):
    """The forward's and the last decode step's all-gathers at 1x2 with
    the Mamba2 block, the encoder and cross attention split over
    ``model``: the forward gathers the decoder's residual stream alone
    (whisper's, sequence-parallel between blocks); decode gathers, per layer,
    the merges' pieces (the self-attention's and the cross attention's,
    each split over its keys), the state's assembly and weights gathered
    whole (2-D: the self-attention's projections, cross attention's
    ``wq``/``wo``), and never a whole ``x_proj``/``z_proj``/``out_proj``/
    ``conv_x_w`` or a cache (a cache's gather would be 4-D or more)."""
    cfg, _ = _cfgs(case)
    tp, hq, layers_ = 2, cfg.n_heads, cfg.n_layers
    merge = [f"torch.float32 {tp}x{BATCH}x{hq}x1x{cfg.d_head}",
             f"torch.float32 {tp}x{BATCH}x{hq}x1"]
    n_merge = layers_ * (int(cfg.has_attention)
                         + int(cfg.is_encoder_decoder))
    state = [_assembly(cfg, tp)] if cfg.has_ssm else []
    # the decoder's residual stream, sequence over ``model`` (Megatron-SP)
    # where the config has no SSM, gathered into each block
    residual = set() if cfg.has_ssm else {
        f"torch.float32 {tp * BATCH}x{SEQ // tp}x{cfg.d_model}"}
    mamba = run["jps"][case]["layers"].get("mamba", {})
    whole = {int(np.prod(np.shape(mamba[n])[1:])) for n in MAMBA_SHARDED
             if n in mamba}
    for res in run["res"]:
        if step == "fwd":
            assert set(res[f"fwd_gathers_{case}_1x2"].tolist()) <= residual
            continue
        got = res[f"gathers_{case}_1x2"].tolist()
        assert [g for g in got if g in merge] == merge * n_merge
        assert [g for g in got if g in state] == state * layers_
        for g in got:
            if g in merge + state:
                continue
            shape = [int(e) for e in g.split()[1].split("x")]
            assert len(shape) == 2 and int(np.prod(shape)) not in whole, g


@pytest.mark.parametrize("case", ["mamba2", "hymba"])
def test_assembled_state_matches_jax(run, case):
    """After the decode steps each rank's state and conv tail (replicated
    over ``model``, assembled from the ranks' P rows) equal JAX's."""
    ref = _jax_ref(run, case)
    for res in run["res"]:
        for name in ("ssm", "conv"):
            got = res[f"cache_{case}_1x2_{name}"]
            assert got.shape == ref[f"cache_{name}"].shape
            np.testing.assert_allclose(got, ref[f"cache_{name}"], **FWD_TOL)


def test_cross_cache_shards_hold_own_positions(run):
    """Each rank's cross cache holds every head over its half of the
    encoder positions (filled at prefill by the all-to-all from heads to
    positions), equal to the JAX cross cache."""
    cfg, _ = _cfgs("whisper")
    ref = _jax_ref(run, "whisper")
    half = ENC_LEN // 2
    for r, res in enumerate(run["res"]):
        for name in ("cross_k", "cross_v"):
            got = res[f"cache_whisper_1x2_{name}"]
            want = ref[f"cache_{name}"][:, :, :, r * half:(r + 1) * half]
            assert got.shape == want.shape == (
                cfg.n_layers, BATCH, cfg.n_kv_heads, half, cfg.d_head)
            np.testing.assert_allclose(got, want, **FWD_TOL)


def _jax_moe(run, x, int8_a2a=False):
    """The JAX ``moe_apply``; with ``int8_a2a`` its ``moe_apply_sharded``
    on a 1x1 mesh, whose all-to-alls quantize each slot's payload as the
    port's do at any EP size (the scales are per slot, so per token)."""
    cfg = dataclasses.replace(run["mcfg"], capacity_factor=16.0)
    p = jax.tree.map(lambda a: a[0], run["mp"]["layers"]["moe"])
    if not int8_a2a:
        return jmoe.moe_apply(p, jnp.asarray(x), cfg)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    # under differentiation, where its custom_vjp's int8 rule runs
    return jax.vjp(lambda x: jmoe.moe_apply_sharded(
        p, x, cfg, mesh, ("data",), "model"), jnp.asarray(x))[0]


@pytest.mark.parametrize("mode", ["a2a", "psum"])
@pytest.mark.parametrize("int8", [0, 1])
def test_moe_sharded_matches_jax_moe_apply(run, mode, int8):
    """psum-local sends no payload, so ``A2A_INT8`` leaves it as is."""
    x = run["xs"][mode]
    want, _ = _jax_moe(run, x, int8_a2a=bool(int8) and mode == "a2a")
    tol = dict(atol=1e-5, rtol=1e-5)
    for res in run["res"]:
        np.testing.assert_allclose(res[f"moe_{mode}_{int8}"],
                                   np.asarray(want), **tol)
    # the load-balancing loss: the mean over the ranks' own tokens
    if mode == "a2a":
        halves = [x[:, :8], x[:, 8:]]
    else:
        halves = [x, x]
    aux = np.mean([float(_jax_moe(run, h)[1]) for h in halves])
    for res in run["res"]:
        assert abs(float(res[f"moe_aux_{mode}_{int8}"]) - aux) <= 1e-5


def test_compressed_psum_closed_form(run):
    g = run["grads"][0]
    scale = max(np.abs(g[r]).max() for r in range(2)) / 127.0
    q = np.clip(np.round(g / np.float32(scale)), -127, 127)
    want = q.sum(0) * np.float32(scale) / 2
    for res in run["res"]:
        np.testing.assert_allclose(res["psum_one"], want, atol=1e-6)


def test_compressed_psum_error_feedback_unbiased(run):
    g = run["grads"]
    true_sum = g.mean(axis=1).sum(0)
    scale = float(np.abs(g).max()) / 127.0
    for res in run["res"]:
        comp_sum = res["psum_steps"].sum(0)
        assert np.abs(true_sum - comp_sum).max() < 4 * scale


def test_make_global_batch_holds_its_slice_alone(run):
    from repro_torch.data.pipeline import SyntheticLMDataset
    full = SyntheticLMDataset(vocab_size=100, seq_len=16, global_batch=4,
                              seed=7).batch_np(3)["tokens"]
    for r, res in enumerate(run["res"]):
        np.testing.assert_array_equal(res["batch_local"],
                                      full[2 * r:2 * r + 2])
        np.testing.assert_array_equal(res["batch_full"], full)


def test_snapshot_restored_onto_mesh_resumes_bit_exact(run):
    for res in run["res"]:
        assert tuple(res["restore_mesh"]) == (1, 2, 1)   # warm, 1x2
        assert res["restored_tokens"].tolist() == run["base"]


def test_cases_take_their_attention_split():
    """``CASES`` cover each way attention splits over TP=2."""
    from repro_torch.models import parallel
    want = {"dense": "heads", "query": "query", "replicated": None,
            "hymba": "heads", "whisper": "heads"}
    for case, split in want.items():
        assert parallel._heads_split(_cfgs(case)[0], 2) == split, case
    assert not _cfgs("mamba2")[0].has_attention
