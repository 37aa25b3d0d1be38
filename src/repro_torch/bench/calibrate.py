"""Fit the Hopper cost model's constants to the card's own timings.

    PYTHONPATH=src python -m repro_torch.bench.calibrate            # the stored timings
    PYTHONPATH=src python -m repro_torch.bench.calibrate run1.log run2.log \
        --extract src/repro_torch/bench/calibration_h100.jsonl

Reads the ``autotune`` phase's records of ``chip_smoke.py`` logs (each
problem with every feasible candidate's measured median ms; by default
``calibration_h100.jsonl`` beside this file, the records the constants in
``cost_model`` were fitted to, with ``--extract`` written there), rebuilds
each candidate's ``cost_model.Walk`` on the CPU, and fits
``cost_model.LAUNCH_SECONDS``, ``CONTENTION`` and, per kernel family,
``EFFICIENCY``, ``PROLOGUE_SECONDS`` and ``STEP_SECONDS`` to them: a grid
over the first two, and for each point each family's terms by least
squares of the relative error of the time after the launch.  The fit minimizes the sum
of squared log errors, every candidate weighted alike.  It prints the
constants, then, with them, each problem's pick, its measured time over
the fastest candidate's and the worst such ratio of each group (in
sample), then the held-out agreement: each group's picks under the
constants fitted to the other groups' records alone.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import numpy as np

from repro_torch.core import cost_model, explorer
from repro_torch.core.dataflow import (AttentionProblem, BinaryProblem,
                                       ConvProblem, GemmProblem)

STORED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "calibration_h100.jsonl")
KINDS = {"GemmProblem": (GemmProblem, cost_model.gemm_walk),
         "ConvProblem": (ConvProblem, cost_model.conv_walk),
         "BinaryProblem": (BinaryProblem, cost_model.binary_walk),
         "AttentionProblem": (AttentionProblem, cost_model.attention_walk)}
# chip_smoke.py's PICK_RATIO: a pick within it of the fastest agrees
RATIO = 1.15
BETAS = [i * 0.05 for i in range(0, 31)]
LAUNCHES = [i * 0.5e-6 for i in range(0, 31)]
SPREAD = 2.0

Fit = Tuple[float, float, Dict[str, float], Dict[str, float],
            Dict[str, float], float]


def records(paths: List[str]) -> List[dict]:
    """The autotune records of the logs, trimmed to what the fit reads; a
    problem measured in several logs keeps its last record."""
    out = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                if not line.startswith("{"):
                    continue
                rec = json.loads(line)
                if rec.get("phase") != "autotune" or "candidates" not in rec:
                    continue
                key = (rec["group"], rec["label"],
                       json.dumps(rec["problem"], sort_keys=True))
                out[key] = {
                    "phase": "autotune", "group": rec["group"],
                    "label": rec["label"], "kind": rec["kind"],
                    "problem": rec["problem"],
                    "candidates": [{"spec": c["spec"], "ms": c["ms"]}
                                   for c in rec["candidates"]]}
    return list(out.values())


def load(paths: List[str]) -> List[dict]:
    """One row a problem: its group, label, problem and (name, walk,
    measured seconds) of each candidate."""
    rows = []
    for rec in records(paths):
        cls, walk_of = KINDS[rec["kind"]]
        problem = cls(**rec["problem"])
        specs = {c.name: c.spec for c in explorer.explore(problem, top=99)}
        cands = [(c["spec"], walk_of(problem, specs[c["spec"]]),
                  c["ms"] * 1e-3)
                 for c in rec["candidates"] if c["spec"] in specs]
        rows.append(dict(group=rec["group"], label=rec["label"],
                         problem=problem, cands=cands))
    return rows


def fit(rows: List[dict], hw=cost_model.H100) -> Fit:
    """(launch seconds, contention, then by family the efficiency, the
    prologue seconds and the step seconds, log error) of the least log
    error over the grid."""
    walks = [(w, t) for r in rows for _, w, t in r["cands"]]
    fams = sorted({w.family for w, _ in walks})
    fam = np.array([fams.index(w.family) for w, _ in walks])
    occ = np.array([cost_model.walk_occupancy(w, hw) for w, _ in walks])
    per_sm, waves = occ[:, 0], occ[:, 1]
    # the steps' operations at full efficiency and no contention
    base = np.array([cost_model.walk_path_seconds(w, hw, 0.0)
                     for w, _ in walks])
    steps = np.array([w.steps for w, _ in walks])
    ops = np.array([w.step_ops for w, _ in walks])
    floor = np.array([w.moved / hw.hbm_bw for w, _ in walks])
    t = np.array([t for _, t in walks])
    best = None
    for beta in BETAS:
        slow = 1 + beta * (per_sm - 1)
        x = np.stack([waves * slow, waves * steps * slow, base * slow], 1)
        for t0 in LAUNCHES:
            rest = t - t0
            ok = (rest > 0) & (steps > 0)
            coef = np.zeros((len(fams), 3))
            coef[:, 2] = 10.0
            for f in range(len(fams)):
                m = ok & (fam == f)
                if m.any():
                    coef[f] = _family_fit(x[m], rest[m], ops[m])
            pred = np.maximum(t0 + (x * coef[fam]).sum(1), floor)
            err = float(np.sum((np.log(pred) - np.log(t)) ** 2))
            if best is None or err < best[5]:
                best = (t0, beta,
                        {f: 1.0 / coef[i, 2] for i, f in enumerate(fams)},
                        {f: float(coef[i, 0]) for i, f in enumerate(fams)},
                        {f: float(coef[i, 1]) for i, f in enumerate(fams)},
                        err)
    return best


def _family_fit(x: np.ndarray, rest: np.ndarray,
                ops: np.ndarray) -> np.ndarray:
    """(prologue seconds, step seconds, 1 / efficiency) of one family:
    least squares of the relative error of ``rest`` ~ waves * prologue +
    waves * steps * step latency + operations / eff, all non-negative.
    The step latency is fitted only where a step's operations differ at
    least ``SPREAD``-fold between the family's records, the prologue
    only where a wave's steps do (else the terms cannot be told apart);
    else the efficiency alone (geometric mean)."""
    per_wave = x[:, 2] / x[:, 0]
    for cols in ([0, 1, 2], [0, 2]):
        if (cols == [0, 1, 2] and ops.max() < SPREAD * ops.min()) or \
                per_wave.max() < SPREAD * per_wave.min():
            continue
        sol, *_ = np.linalg.lstsq(x[:, cols] / rest[:, None],
                                  np.ones(len(rest)), rcond=None)
        if (sol >= 0).all() and sol[-1] > 0:
            out = np.zeros(3)
            out[cols] = sol
            return out
    return np.array([0.0, 0.0, math.exp(np.mean(np.log(rest)
                                                - np.log(x[:, 2])))])


def rounded(f: Fit) -> Fit:
    """The fit as ``cost_model`` stores it."""
    t0, beta, *fams, err = f
    return (round(t0, 9), round(beta, 2),
            *({k: float(f"{v:.4g}") for k, v in d.items()} for d in fams),
            err)


@contextlib.contextmanager
def applied(f: Fit) -> Iterator[None]:
    """``cost_model``'s constants set to the fit ``f`` inside the block: a
    family it did not fit takes the defaults, not the stored constants."""
    tables = (cost_model.EFFICIENCY, cost_model.PROLOGUE_SECONDS,
              cost_model.STEP_SECONDS)
    saved = (cost_model.LAUNCH_SECONDS, cost_model.CONTENTION,
             *(dict(d) for d in tables))

    def put(launch, contention, *fams):
        cost_model.LAUNCH_SECONDS, cost_model.CONTENTION = launch, contention
        for live, new in zip(tables, fams):
            live.clear()
            live.update(new)

    put(*rounded(f)[:-1])
    try:
        yield
    finally:
        put(*saved)


def picks(rows: List[dict], hw=cost_model.H100) -> List[dict]:
    """Each problem's estimated pick and its measured time over the
    fastest candidate's, under the constants in ``cost_model`` now."""
    out = []
    for r in rows:
        est = {n: cost_model.walk_seconds(w, hw) for n, w, _ in r["cands"]}
        ms = {n: t for n, _, t in r["cands"]}
        pick = min(est, key=lambda n: est[n])
        fastest = min(ms, key=ms.get)
        out.append(dict(group=r["group"], label=r["label"], pick=pick,
                        fastest=fastest, ratio=ms[pick] / ms[fastest]))
    return out


def agreement(ps: List[dict]) -> Dict[str, dict]:
    """Per group: problems, picks that are the fastest, picks within
    ``RATIO`` of it, and the worst ratio."""
    by = defaultdict(list)
    for p in ps:
        by[p["group"]].append(p["ratio"])
    return {g: {"problems": len(r), "pick_is_fastest": sum(x <= 1.0
                                                           for x in r),
                "within_ratio": sum(x <= RATIO for x in r),
                "worst_ratio": max(r)} for g, r in sorted(by.items())}


def held_out(rows: List[dict]) -> Dict[str, dict]:
    """Each group's agreement under the constants fitted to the other
    groups' records alone."""
    out = {}
    for g in sorted({r["group"] for r in rows}):
        with applied(fit([r for r in rows if r["group"] != g])):
            out.update(agreement(picks([r for r in rows
                                        if r["group"] == g])))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("logs", nargs="*", default=[STORED])
    ap.add_argument("--extract", metavar="OUT",
                    help="write the logs' autotune records to OUT first")
    args = ap.parse_args()
    if args.extract:
        with open(args.extract, "w") as f:
            for rec in records(args.logs):
                f.write(json.dumps(rec) + "\n")
    rows = load(args.logs)
    f = fit(rows)
    t0, beta, eff, pro, step, err = rounded(f)
    print(json.dumps({"LAUNCH_SECONDS": t0, "CONTENTION": beta,
                      "EFFICIENCY": dict(sorted(eff.items())),
                      "PROLOGUE_SECONDS": dict(sorted(pro.items())),
                      "STEP_SECONDS": {k: v for k, v in sorted(step.items())
                                       if v},
                      "log_error": err, "candidates": sum(
                          len(r["cands"]) for r in rows)}))
    with applied(f):
        ps = picks(rows)
    for p in ps:
        print(json.dumps(p))
    print(json.dumps({"in_sample": agreement(ps)}))
    print(json.dumps({"held_out": held_out(rows)}))


if __name__ == "__main__":
    main()
