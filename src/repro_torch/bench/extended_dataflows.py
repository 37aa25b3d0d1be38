"""Fig. 7 on the card: auxiliary stationarity.

The twin of ``benchmarks/bench_extended_dataflows.py``, measured instead
of modelled.  For each GEMM view of the paper's layer grid and each
qwen3-1.7b MLP GEMM, every one of the nine canonical specs runs (or is
reported infeasible at that shape); per anchor the row gives its basic
time, its best feasible variant and the gain basic / best (7a), and the
best WS and IS against the best OS (7b).  The summary gives the medians
over the paper layers beside the paper's (7a: OS x1.78, IS x1.96, WS
x1.08; 7b: optimized WS ~7.41x slower than optimized OS, optimized OS
ahead of IS on ~90% of layers).

    PYTHONPATH=src python -m repro_torch.bench.extended_dataflows
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

from repro_torch.bench import common

PAPER_7A = {"os": 1.78, "is": 1.96, "ws": 1.08}
PAPER_7B = {"ws_vs_os": 7.41, "os_beats_is_share": 0.9}


def run(device: str = "cuda",
        layers: Sequence[Tuple[int, int, int, int]] = common.PAPER_LAYERS,
        mlp: Sequence[Tuple[int, int, int]] = common.QWEN_MLP,
        iters: int = 5, seed: int = 100) -> List[dict]:
    timer = common.Timer(device)
    shapes = [("paper", lay, common.paper_gemm(lay)) for lay in layers]
    shapes += [("qwen3-1.7b mlp", None, common.GemmProblem(m, k, n))
               for m, k, n in mlp]
    rows = []
    for i, (source, layer, g) in enumerate(shapes):
        a, b = common.gemm_operands(g.m, g.k, g.n, device, seed + i)
        res = {name: common.time_spec(timer, name, a, b, iters)
               for name in common.NINE_SPECS}
        row = {"bench": "fig7", "source": source, "layer": layer,
               "m": g.m, "k": g.k, "n": g.n,
               "ms": {name: r["ms"] for name, r in res.items()},
               "infeasible": sorted(n for n, r in res.items()
                                    if not r["feasible"])}
        best = {}
        for anchor, names in common.ANCHOR_SPECS.items():
            ran = [(res[n]["ms"], n) for n in names if res[n]["feasible"]]
            timed = [x for x in ran if x[0] is not None]
            best[anchor] = min(timed) if timed else (None, ran[0][1]
                                                     if ran else None)
            row[f"{anchor}_best"] = best[anchor][1]
            row[f"{anchor}_gain"] = common.ratio(
                res[f"{anchor}_basic"]["ms"], best[anchor][0])
        row["opt_ws_vs_os"] = common.ratio(best["ws"][0], best["os"][0])
        row["opt_is_vs_os"] = common.ratio(best["is"][0], best["os"][0])
        rows.append(row)
    paper = [r for r in rows if r["layer"]]
    ranked = [r for r in paper if r["opt_is_vs_os"] is not None]
    rows.append({
        "bench": "fig7_summary",
        "gain_median": {a: common.median([r[f"{a}_gain"] for r in paper])
                        for a in ("os", "ws", "is")},
        "opt_ws_vs_os_median": common.median(
            [r["opt_ws_vs_os"] for r in paper]),
        "opt_is_vs_os_median": common.median(
            [r["opt_is_vs_os"] for r in paper]),
        "os_beats_is_share": (sum(r["opt_is_vs_os"] > 1 for r in ranked)
                              / len(ranked)) if ranked else None,
        "layers": len(paper), "paper_7a": PAPER_7A, "paper_7b": PAPER_7B})
    return rows


def main(device: Optional[str] = None) -> None:
    for row in run(device or "cuda"):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
