"""The port's crash safety on the CPU: journal, checkpoints, snapshots
and restore.

Port vs JAX: each recovery scenario of the reference's crash suite —
terminal requests restored intact, warm resume from a snapshot, cold
replay from the journal alone, corrupt snapshots falling back, a forged
journal token detected as replay divergence, a failed snapshot or
checkpoint write degrading serving instead of failing it — runs through
both engines on the same bridged weights, and both recover the
uninterrupted run's greedy tokens with the same counters.  A journal the
port writes is read by the reference's ``replay_table``.  Port only: the
journal's CRC, torn-tail and append-fault cases, and the
``Checkpointer``'s layout, durability and exact restore of every leaf
kind (bf16 as raw words, packed weights, binary words).
"""
import dataclasses
import json
import os
import zlib

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.runtime import health as jhealth
from repro.serve import journal as jjournal
from repro.serve.engine import Engine as JaxEngine
from repro_torch import configs
from repro_torch.ckpt.checkpoint import Checkpointer, CheckpointError
from repro_torch.kernels import pack
from repro_torch.models import bridge, lm
from repro_torch.runtime import health
from repro_torch.serve.engine import Engine
from repro_torch.serve.journal import RequestJournal, replay_table

CFG = configs.get_smoke("qwen3-1.7b")
JCFG = jconfigs.get_smoke("qwen3-1.7b")
MAX_LEN = 48
NEW_TOKENS = 6
ENV = ("REPRO_FAULT_PLAN", "REPRO_FAULT_HANG_S", "REPRO_JOURNAL_DIR",
       "REPRO_SNAPSHOT_EVERY", "REPRO_STRICT_POOL")
RECOVERY = ("recovered", "replay_divergence", "snapshots_saved",
            "snapshot_errors", "completed", "failed")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    health.reset_faults()
    jhealth.reset_faults()
    yield
    health.reset_faults()
    jhealth.reset_faults()


@pytest.fixture(scope="module")
def served():
    jp = jlm.init_model(JCFG, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), CFG,
                                  device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, CFG.vocab_size, (2, 8)).astype(np.int32)
    eng = JaxEngine(JCFG, jp, max_len=MAX_LEN)
    reqs = [eng.submit(p, NEW_TOKENS) for p in prompts]
    eng.serve(reqs)
    assert all(r.state.value == "done" for r in reqs)
    return {"jax": jp, "port": tp}, prompts, [list(r.out_tokens)
                                              for r in reqs]


def _engine(pkg, params, jdir, **kw):
    if pkg == "jax":
        return JaxEngine(JCFG, params["jax"], max_len=MAX_LEN,
                         journal_dir=str(jdir), **kw)
    return Engine(CFG, params["port"], max_len=MAX_LEN, device="cpu",
                  journal_dir=str(jdir), **kw)


def _run(pkg, params, prompts, jdir, **kw):
    eng = _engine(pkg, params, jdir, **kw)
    reqs = [eng.submit(p, NEW_TOKENS) for p in prompts]
    eng.serve(reqs)
    return eng, reqs


def _crash_journal(jdir, drop_terminals=True, drop_tokens=0):
    """The journal a kill leaves: no terminal records, and the last
    ``drop_tokens`` token records never flushed."""
    path = os.path.join(str(jdir), "journal.jsonl")
    keep = [line for line in open(path).readlines()
            if not (drop_terminals and json.loads(line)["rec"]["kind"]
                    in ("done", "failed", "evicted"))]
    if drop_tokens:
        tok = [i for i, line in enumerate(keep)
               if json.loads(line)["rec"]["kind"] == "token"]
        drop = set(tok[-drop_tokens:])
        keep = [line for i, line in enumerate(keep) if i not in drop]
    open(path, "w").writelines(keep)


def _recover(pkg, params, jdir, **restore_kw):
    eng = _engine(pkg, params, jdir)
    rec = eng.restore(**restore_kw)
    armed = eng._pending_resume
    eng.serve(rec)
    return eng, rec, armed


def _both(served, tmp_path, prepare, **run_kw):
    """``prepare(pkg, jdir)`` on each package's own journal, then a fresh
    engine's restore + serve; returns {pkg: (engine, requests, armed)}."""
    params, prompts, base = served
    out = {}
    for pkg in ("jax", "port"):
        jdir = tmp_path / pkg
        _run(pkg, params, prompts, jdir, **run_kw)
        prepare(pkg, jdir)
        out[pkg] = _recover(pkg, params, jdir)
        assert [list(r.out_tokens) for r in out[pkg][1]] == base, pkg
        assert [r.state.value for r in out[pkg][1]] == ["done"] * 2, pkg
    jst, tst = out["jax"][0].stats(), out["port"][0].stats()
    assert {k: tst[k] for k in RECOVERY} == {k: jst[k] for k in RECOVERY}
    return out


# ---------------------------------------------------------------------------
# Journal (port only): CRC envelopes, torn tail, append faults.
# ---------------------------------------------------------------------------
def test_journal_roundtrip_and_stats(tmp_path):
    j = RequestJournal(str(tmp_path))
    j.append("submit", fsync=True, rid=0, prompt=[1, 2], max_new_tokens=3,
             deadline_s=None)
    j.append("token", rid=0, step=1, token=7)
    j.append("done", fsync=True, rid=0, step=1, error=None)
    j.close()
    j2 = RequestJournal(str(tmp_path))
    recs = j2.scan()
    assert [r["kind"] for r in recs] == ["submit", "token", "done"]
    assert j.stats()["appends"] == 3 and j.stats()["fsyncs"] == 2
    assert j2.stats()["records_loaded"] == 3
    table = replay_table(recs)
    assert table[0]["state"] == "done" and table[0]["tokens"] == [7]


def test_journal_corrupt_record_skipped_not_fatal(tmp_path):
    j = RequestJournal(str(tmp_path))
    j.append("submit", rid=0, prompt=[1], max_new_tokens=2)
    j.append("token", rid=0, step=1, token=5)
    j.append("token", rid=0, step=2, token=6)
    j.close()
    lines = open(j.path).readlines()
    env = json.loads(lines[1])
    env["rec"]["token"] = 999            # bit flip: the CRC now mismatches
    lines[1] = json.dumps(env) + "\n"
    lines.insert(1, "not json at all\n")
    open(j.path, "w").writelines(lines)
    j2 = RequestJournal(str(tmp_path))
    recs = j2.scan()
    assert j2.stats()["records_skipped"] == 2
    assert j2.stats()["records_loaded"] == 2
    # step 1 is gone, so step 2 would leave a hole: not resurrected
    assert replay_table(recs)[0]["tokens"] == []


def test_journal_torn_tail_dropped(tmp_path):
    j = RequestJournal(str(tmp_path))
    j.append("submit", rid=0, prompt=[1], max_new_tokens=2)
    j.append("token", rid=0, step=1, token=5)
    j.close()
    with open(j.path, "a") as f:
        f.write('{"rec": {"kind": "token", "rid": 0, "st')   # kill mid-line
    j2 = RequestJournal(str(tmp_path))
    assert [r["kind"] for r in j2.scan()] == ["submit", "token"]
    assert j2.stats()["torn_tail"] == 1


def test_journal_append_fault_degrades_not_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_FAULT_PLAN", "journal.append:0:raise")
    health.reset_faults()
    j = RequestJournal(str(tmp_path))
    j.append("submit", rid=0, prompt=[1], max_new_tokens=1)  # no raise
    j.append("token", rid=0, step=1, token=4)
    assert j.stats()["append_errors"] == 1 and j.stats()["appends"] == 1
    assert [r["kind"] for r in j.scan()] == ["token"]


def test_replay_table_position_addressed_tokens():
    recs = [
        {"kind": "submit", "rid": 3, "prompt": [1], "max_new_tokens": 4},
        {"kind": "token", "rid": 3, "step": 1, "token": 10},
        {"kind": "token", "rid": 3, "step": 2, "token": 11},
        {"kind": "token", "rid": 3, "step": 2, "token": 11},   # replayed
        {"kind": "preempt", "rid": 3, "step": 2, "tokens_done": 2},
        {"kind": "token", "rid": 3, "step": 3, "token": 12},
        {"kind": "token", "rid": 9, "step": 1, "token": 99},   # no submit
        {"kind": "done", "rid": 3, "step": 3, "error": None},
    ]
    table = replay_table(recs)
    assert table[3]["tokens"] == [10, 11, 12] and table[3]["state"] == "done"
    assert 9 not in table
    assert table == jjournal.replay_table(recs)


def test_reference_reads_the_ports_journal(served, tmp_path):
    """A journal the port writes — submits, the serve record, tokens,
    snapshots, terminals — folds to the same table under the reference's
    ``replay_table`` as under the port's, and its checksums hold there."""
    params, prompts, base = served
    _run("port", params, prompts, tmp_path, snapshot_every=2)
    recs = RequestJournal(str(tmp_path)).scan()
    jrecs = jjournal.RequestJournal(str(tmp_path)).scan()
    assert jrecs == recs
    assert {r["kind"] for r in recs} == {"submit", "serve", "token",
                                         "snapshot", "done"}
    table = replay_table(recs)
    assert jjournal.replay_table(jrecs) == table
    assert [table[rid]["tokens"] for rid in sorted(table)] == base


# ---------------------------------------------------------------------------
# Recovery, port vs JAX.
# ---------------------------------------------------------------------------
def test_restore_terminal_requests_intact(served, tmp_path):
    params, prompts, base = served
    for pkg in ("jax", "port"):
        _run(pkg, params, prompts, tmp_path / pkg)
        eng = _engine(pkg, params, tmp_path / pkg)
        rec = eng.restore()
        assert [r.state.value for r in rec] == ["done"] * 2
        assert [list(r.out_tokens) for r in rec] == base
        assert eng.stats()["recovered"] == 0
        assert eng.submit(prompts[0], 2).rid == rec[-1].rid + 1


def test_warm_resume_from_snapshot_bit_exact(served, tmp_path):
    out = _both(served, tmp_path,
                lambda pkg, jdir: _crash_journal(jdir, drop_tokens=2),
                snapshot_every=2)
    for eng, rec, armed in out.values():
        assert armed["cache"] is not None
        st = eng.stats()
        assert st["recovered"] == 2 and st["replay_divergence"] == 0
    # the port restored its snapshot onto its own device, bit for bit
    eng = out["port"][0]
    assert eng.params["embed"]["table"].device.type == "cpu"
    assert "warm resume" in eng.monitor.events_of("restore")[-1].detail


def test_cold_replay_without_snapshot_bit_exact(served, tmp_path):
    out = _both(served, tmp_path,
                lambda pkg, jdir: _crash_journal(jdir, drop_tokens=3))
    for eng, _, armed in out.values():
        assert armed["cache"] is None
        assert eng.stats()["replayed_steps"] > 0
    assert out["port"][0].stats()["replayed_steps"] == \
        out["jax"][0].stats()["replayed_steps"]


def _tear_snapshots(pkg, jdir):
    snapdir = os.path.join(str(jdir), "snapshots")
    for d in os.listdir(snapdir):
        npz = os.path.join(snapdir, d, "arrays.npz")
        if os.path.exists(npz):
            with open(npz, "wb") as f:
                f.write(b"!torn npz!")
    _crash_journal(jdir, drop_tokens=1)


def test_corrupt_snapshots_fall_back_to_cold_replay(served, tmp_path):
    out = _both(served, tmp_path, _tear_snapshots, snapshot_every=2)
    for eng, _, armed in out.values():
        assert eng.stats()["restore_fallbacks"] >= 1
        assert armed["cache"] is None
    assert out["port"][0].stats()["restore_fallbacks"] == \
        out["jax"][0].stats()["restore_fallbacks"]


def test_injected_restore_fault_falls_back(served, tmp_path, monkeypatch):
    params, prompts, base = served
    for pkg in ("jax", "port"):
        jdir = tmp_path / pkg
        _run(pkg, params, prompts, jdir, snapshot_every=2)
        _crash_journal(jdir, drop_tokens=1)
        monkeypatch.setenv("REPRO_FAULT_PLAN", "engine.restore:*:raise")
        eng = _engine(pkg, params, jdir)
        rec = eng.restore()
        monkeypatch.delenv("REPRO_FAULT_PLAN")
        assert eng.stats()["restore_fallbacks"] >= 1
        assert eng._pending_resume["cache"] is None
        eng.serve(rec)
        assert [list(r.out_tokens) for r in rec] == base


def _forge_first_token(pkg, jdir):
    _crash_journal(jdir)
    path = os.path.join(str(jdir), "journal.jsonl")
    lines = open(path).readlines()
    for i, line in enumerate(lines):
        env = json.loads(line)
        if env["rec"]["kind"] == "token" and env["rec"]["step"] == 1:
            env["rec"]["token"] = (env["rec"]["token"] + 1) % CFG.vocab_size
            env["sum"] = zlib.crc32(json.dumps(
                env["rec"], sort_keys=True,
                separators=(",", ":")).encode()) & 0xFFFFFFFF
            lines[i] = json.dumps(env) + "\n"
            break
    open(path, "w").writelines(lines)


def test_replay_divergence_detected(served, tmp_path):
    params, prompts, base = served
    for pkg in ("jax", "port"):
        jdir = tmp_path / pkg
        _run(pkg, params, prompts, jdir)
        _forge_first_token(pkg, jdir)
        eng, rec, _ = _recover(pkg, params, jdir)
        assert [list(r.out_tokens) for r in rec] == base   # recomputed win
        assert eng.stats()["replay_divergence"] == 1
        assert eng.monitor.events_of("replay-divergence")


@pytest.mark.parametrize("plan,saved,errors", [
    ("snapshot.save:*:raise", 0, 2), ("ckpt.write:1:raise", 1, 1)],
    ids=["snapshot.save", "ckpt.write"])
def test_snapshot_fault_degrades_serving(served, tmp_path, monkeypatch,
                                         plan, saved, errors):
    """A failed snapshot (or a checkpoint write dying after its payload
    is durable) costs a recovery point, never the serving: tokens stand,
    the previous snapshot stays the latest, and recovery still works."""
    params, prompts, base = served
    for pkg in ("jax", "port"):
        jdir = tmp_path / pkg
        monkeypatch.setenv("REPRO_FAULT_PLAN", plan)
        health.reset_faults()
        jhealth.reset_faults()
        eng, reqs = _run(pkg, params, prompts, jdir, snapshot_every=2)
        monkeypatch.delenv("REPRO_FAULT_PLAN")
        assert [list(r.out_tokens) for r in reqs] == base
        st = eng.stats()
        assert (st["snapshots_saved"], st["snapshot_errors"]) == (
            saved, errors), pkg
        assert eng.monitor.events_of("snapshot-error")
        if saved:
            assert eng.snapshots.latest_step() == 2
        _crash_journal(jdir, drop_tokens=1)
        _, rec, _ = _recover(pkg, params, jdir)
        assert [list(r.out_tokens) for r in rec] == base


def test_restore_without_journal_or_onto_devices_raises(served, tmp_path):
    """Without a journal restore raises; onto devices (a one-rank gloo
    group's 1x1 mesh, made and destroyed here) it resumes the snapshot
    over the mesh, bit for bit."""
    import torch.distributed as dist

    params, prompts, base = served
    with pytest.raises(ValueError, match="journal"):
        Engine(CFG, params["port"], max_len=MAX_LEN, device="cpu").restore()
    jdir = tmp_path / "port"
    _run("port", params, prompts, jdir, snapshot_every=2)
    _crash_journal(jdir, drop_tokens=2)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        eng, rec, armed = _recover("port", params, jdir, devices=["cpu"])
    finally:
        dist.destroy_process_group()
    assert armed["cache"] is not None
    assert tuple(eng.dist.mesh.shape) == (1, 1)
    assert eng.params["embed"]["table"].placements is not None
    assert [list(r.out_tokens) for r in rec] == base
    assert eng.stats()["replay_divergence"] == 0


def test_restore_before_any_serve_requeues(served, tmp_path):
    params, prompts, base = served
    for pkg in ("jax", "port"):
        _engine(pkg, params, tmp_path / pkg).submit(prompts[0], NEW_TOKENS)
        eng = _engine(pkg, params, tmp_path / pkg)
        rec = eng.restore()
        assert [r.state.value for r in rec] == ["queued"]
        assert eng._pending_resume is None
        eng.serve(rec)
        assert rec[0].state.value == "done"
        assert list(rec[0].out_tokens) == base[0]


def test_env_flags_turn_journal_and_snapshots_on(served, tmp_path,
                                                 monkeypatch):
    params, prompts, base = served
    monkeypatch.setenv("REPRO_JOURNAL_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_SNAPSHOT_EVERY", "2")
    eng = Engine(CFG, params["port"], max_len=MAX_LEN, device="cpu")
    reqs = [eng.submit(p, NEW_TOKENS) for p in prompts]
    eng.serve(reqs)
    assert [list(r.out_tokens) for r in reqs] == base
    st = eng.stats()
    assert st["snapshots_saved"] == 2 and st["journal"]["fsyncs"] > 0
    assert eng.snapshots.steps() == [2, 4]


# ---------------------------------------------------------------------------
# The Checkpointer (port only).
# ---------------------------------------------------------------------------
def _leaf_state():
    gen = torch.Generator().manual_seed(0)
    codes = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 4, 6), generator=gen,
                          dtype=torch.int32)
    packed = pack.PackedWeights(
        codes, None, torch.rand((2, 1, 6), generator=gen),
        torch.tensor([[1, 32], [3, 32]], dtype=torch.int32),
        torch.randint(-9, 9, (2, 2, 6), generator=gen, dtype=torch.int32),
        4, 30, 6)
    return {"params": {
        "bf16": torch.randn((3, 5), generator=gen).to(torch.bfloat16),
        "f32": torch.randn((4,), generator=gen),
        "words": torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 3),
                               generator=gen, dtype=torch.int32),
        "mlp": {"w1": packed},
    }, "cache": {"index": 17, "k": torch.zeros((1, 2), dtype=torch.int8)}}


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, pack.PackedWeights):
        assert (a.bits, a.k, a.n) == (b.bits, b.k, b.n)
        for f in a.LEAVES:
            _same(getattr(a, f), getattr(b, f))
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_checkpointer_restores_every_leaf_bit_for_bit(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = _leaf_state()
    ck.save(5, state, extras={"note": "x"})
    ck.wait()
    step, got, extras = ck.restore(device="cpu")
    assert step == 5 and extras == {"note": "x"}
    _same(state, got)
    man = ck.manifest(5)
    assert man["trees"]["params"]["bf16"]["dtype"] == "bfloat16"
    with np.load(tmp_path / "step_00000005" / "arrays.npz") as data:
        assert data["params::bf16"].dtype == np.int16      # raw words
    assert man["packed"]["params"]["mlp/w1"] == {"bits": 4, "k": 30, "n": 6}


def test_checkpointer_durability_layout_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    state = _leaf_state()
    for step in (1, 2, 3):
        ck.save(step, state, blocking=True)
    assert ck.steps() == [2, 3] and ck.latest_step() == 3
    assert open(tmp_path / "LATEST").read() == "step_00000003"
    assert ck.stats()["saves"] == 3 and ck.stats()["gc_removed"] == 1
    ck.save(3, state, blocking=True)                    # a side-rename
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000002",
                                            "step_00000003"]
    os.remove(tmp_path / "LATEST")                      # a kill mid-swap
    assert ck.latest_step() == 3
    os.makedirs(tmp_path / "step_00000009.tmp")         # residue of a kill
    ck.save(4, state, blocking=True)
    assert not os.path.exists(tmp_path / "step_00000009.tmp")


def test_ckpt_write_fault_keeps_previous_step(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))
    state = _leaf_state()
    ck.save(1, state, blocking=True)
    monkeypatch.setenv("REPRO_FAULT_PLAN", "ckpt.write:0:raise")
    health.reset_faults()
    with pytest.raises(CheckpointError, match="step 2"):
        ck.save(2, state, blocking=True)
    assert ck.latest_step() == 1 and ck.stats()["save_errors"] == 1
    health.reset_faults()
    ck.save(2, state)                                   # in the background
    with pytest.raises(CheckpointError, match="async"):
        ck.wait()
    assert ck.latest_step() == 1 and ck.stats()["save_errors"] == 2
    _same(state, ck.restore(device="cpu")[1])


def test_bridge_loads_params_from_a_snapshot(served, tmp_path):
    """The port's parameters from one of its own snapshots, checked
    against the config and equal bit for bit."""
    params, prompts, _ = served
    _run("port", params, prompts, tmp_path, snapshot_every=2)
    snaps = os.path.join(str(tmp_path), "snapshots")
    got = bridge.params_from_checkpoint(snaps, CFG, device="cpu")
    _same(params["port"], got)
    wrong = dataclasses.replace(CFG, d_ff=512)
    with pytest.raises(ValueError, match="w1"):
        bridge.params_from_checkpoint(snaps, wrong, device="cpu")


def test_snapshot_holds_packed_and_binary_params(tmp_path):
    """Packed-MLP and binary-MLP engines snapshot and warm-resume with
    every parameter leaf bit for bit."""
    for mlp in ({"packed_weights": True}, {"binary_mlp": True}):
        cfg = dataclasses.replace(CFG, **mlp)
        tp = lm.init_model(cfg, seed=0, device="cpu")
        jdir = tmp_path / next(iter(mlp))
        eng = Engine(cfg, tp, max_len=MAX_LEN, device="cpu",
                     journal_dir=str(jdir), snapshot_every=2)
        prompts = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 5)).astype(np.int32)
        reqs = [eng.submit(p, 5) for p in prompts]
        eng.serve(reqs)
        base = [list(r.out_tokens) for r in reqs]
        _crash_journal(jdir, drop_tokens=2)
        eng2 = Engine(cfg, tp, max_len=MAX_LEN, device="cpu",
                      journal_dir=str(jdir))
        rec = eng2.restore()
        assert eng2._pending_resume["cache"] is not None
        _same(tp, eng2.params)
        eng2.serve(rec)
        assert [list(r.out_tokens) for r in rec] == base
        assert eng2.stats()["replay_divergence"] == 0
