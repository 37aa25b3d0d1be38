"""SIGKILL drills of the port on the CPU: a real kill, a real restart.

The ``kill`` fault kind delivers a real ``SIGKILL`` at a chosen hit of a
site (no ``finally``, no flush); a second process then runs
``Engine.restore()`` + ``serve()`` and must recover every journaled
request with the uninterrupted run's greedy tokens — none lost, none
FAILED or duplicated, no replay divergence.  Twins of the reference's
ragged drill (a mixed-length continuous drain), its kill mid-spill (the
pressure ladder on a pool a third of the working set) and its
batch-synchronous crash drill (snapshots every 2 steps; a kill in the
decode loop and one inside a snapshot's write).  The processes import
only ``repro_torch`` and run on the CPU; every one has a timeout.  The
hit is drawn from ``REPRO_CRASH_DRILL_SEED`` (default 0), as in the
reference's drills.
"""
import json
import os
import random
import subprocess
import sys
import textwrap

import pytest

from repro_torch.serve.journal import RequestJournal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120

SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import SchedulerConfig

    mode, jdir, out, case = sys.argv[1:5]
    case = json.loads(case)
    cfg = configs.get_smoke("qwen3-1.7b")
    params = lm.init_model(cfg, seed=0, device="cpu")
    sc = (SchedulerConfig(**case["scheduler"]) if case.get("scheduler")
          else None)
    eng = Engine(cfg, params, max_len=48, device="cpu", journal_dir=jdir,
                 snapshot_every=case.get("snapshot_every"),
                 scheduler_config=sc)
    if mode == "resume":
        reqs = eng.restore()
        eng.serve(reqs)
    else:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
                   for n in case["lens"]]
        reqs = [eng.submit(p, case["new_tokens"]) for p in prompts]
        eng.serve(reqs)
    stats = {k: v for k, v in eng.stats().items() if isinstance(v, int)}
    restores = [e.detail for e in eng.monitor.events_of("restore")]
    json.dump({"tokens": {str(r.rid): list(r.out_tokens) for r in reqs},
               "states": {str(r.rid): r.state.value for r in reqs},
               "stats": stats, "restores": restores}, open(out, "w"))
""")

# the reference drills' scenarios, at its smoke sizes
RAGGED = {"lens": [7, 12, 2, 23], "new_tokens": 5}
PRESSURE = {"lens": [7, 12, 2, 23], "new_tokens": 20,
            "scheduler": {"max_batch": 4, "page_size": 8, "n_pages": 6}}
BATCH = {"lens": [8, 8], "new_tokens": 6, "snapshot_every": 2}
CASES = {"ragged": RAGGED, "pressure": PRESSURE, "batch": BATCH}


def _run(tmp, mode, jdir, out, case, plan=None):
    script = tmp / "serve_process.py"
    if not script.exists():
        script.write_text(SCRIPT)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    for key in ("REPRO_FAULT_PLAN", "REPRO_JOURNAL_DIR",
                "REPRO_SNAPSHOT_EVERY"):
        env.pop(key, None)
    if plan is not None:
        env["REPRO_FAULT_PLAN"] = plan
    return subprocess.run(
        [sys.executable, str(script), mode, str(jdir), str(out),
         json.dumps(case)], env=env, timeout=TIMEOUT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


@pytest.fixture(scope="module")
def baselines(tmp_path_factory):
    """Each scenario uninterrupted, in its own process."""
    out = {}
    for name, case in CASES.items():
        tmp = tmp_path_factory.mktemp(f"base-{name}")
        res = tmp / "out.json"
        proc = _run(tmp, "run", tmp / "journal", res, case)
        assert proc.returncode == 0, proc.stderr.decode()[-2000:]
        result = json.load(open(res))
        assert all(s == "done" for s in result["states"].values()), result
        out[name] = result
    return out


def _hit(site, hit_range, tag):
    seed = int(os.environ.get("REPRO_CRASH_DRILL_SEED", "0"))
    return random.Random(f"{seed}|{tag}|{site}").randint(*hit_range)


def _kill_and_recover(tmp_path, case, plan, base):
    jdir = tmp_path / "journal"
    out1, out2 = tmp_path / "out1.json", tmp_path / "out2.json"
    proc = _run(tmp_path, "run", jdir, out1, case, plan=plan)
    assert proc.returncode == -9, (plan, proc.stderr.decode()[-2000:])
    assert not out1.exists()               # SIGKILL: no output, no cleanup
    recs = RequestJournal(str(jdir)).scan()
    owed = sorted(r["rid"] for r in recs if r["kind"] == "submit")
    proc = _run(tmp_path, "resume", jdir, out2, case)
    assert proc.returncode == 0, (plan, proc.stderr.decode()[-2000:])
    result = json.load(open(out2))
    got = {int(rid): toks for rid, toks in result["tokens"].items()}
    assert sorted(got) == owed, (plan, result)     # none lost or invented
    for rid in owed:
        assert result["states"][str(rid)] == "done", (plan, result)
        assert got[rid] == base["tokens"][str(rid)], (plan, result)
    assert result["stats"]["failed"] == 0
    assert result["stats"]["replay_divergence"] == 0
    return recs, result


RAGGED_KILL_SITES = [("serve.decode_step", (2, 6)),
                     ("journal.append", (10, 18))]


@pytest.mark.parametrize("site,hit_range", RAGGED_KILL_SITES,
                         ids=[s for s, _ in RAGGED_KILL_SITES])
def test_ragged_sigkill_then_restart_bit_exact(tmp_path, baselines, site,
                                               hit_range):
    plan = f"{site}:{_hit(site, hit_range, 'ragged')}:kill"
    recs, result = _kill_and_recover(tmp_path, RAGGED, plan,
                                     baselines["ragged"])
    serves = [r for r in recs if r["kind"] == "serve"]
    assert serves and serves[-1].get("mode") == "continuous", serves
    assert "cold resume" in result["restores"][-1]


def test_sigkill_mid_spill_recovers_via_journal(tmp_path, baselines):
    base = baselines["pressure"]
    assert base["stats"]["spills"] + base["stats"]["preemptions"] > 0
    _kill_and_recover(tmp_path, PRESSURE, "pool.spill:0:kill", base)


BATCH_KILL_SITES = [("serve.decode_step", (1, 4)), ("ckpt.write", (0, 1))]


@pytest.mark.parametrize("site,hit_range", BATCH_KILL_SITES,
                         ids=[s for s, _ in BATCH_KILL_SITES])
def test_sigkill_then_restart_bit_exact(tmp_path, baselines, site,
                                        hit_range):
    hit = _hit(site, hit_range, "batch")
    _, result = _kill_and_recover(tmp_path, BATCH, f"{site}:{hit}:kill",
                                  baselines["batch"])
    # a kill after the first snapshot resumes warm from it
    warm = site == "ckpt.write" and hit == 1 or \
        site == "serve.decode_step" and hit >= 2
    assert ("warm resume" if warm else "cold resume") in \
        result["restores"][-1], result["restores"]
