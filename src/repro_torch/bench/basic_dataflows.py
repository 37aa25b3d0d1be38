"""Fig. 2 on the card: the basic OS, WS and IS dataflows.

The twin of ``benchmarks/bench_basic_dataflows.py``, measured instead of
modelled: each GEMM view of the paper's layer grid (cin 128, implicit
GEMM M = oh*ow, K = fh*fw*128, N = n_filters) and each qwen3-1.7b MLP
GEMM runs under basic OS (B1), WS and IS (B4), bf16 in, f32 out.  A row
gives each time, its ratio to OS, or why the anchor cannot run at that
shape (its resident stripe needs more shared memory than a block has).
The summary gives the medians of IS/OS and WS/OS over the paper layers
at stride 1 and 2, beside the paper's ratios as the reference bench
quotes them.

    PYTHONPATH=src python -m repro_torch.bench.basic_dataflows
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

from repro_torch.bench import common

ANCHORS = ("os_basic", "ws_basic", "is_basic")
PAPER = {"s=1": "1.93x / 3.41x", "s=2": "5.39x / 2.81x"}


def run(device: str = "cuda",
        layers: Sequence[Tuple[int, int, int, int]] = common.PAPER_LAYERS,
        mlp: Sequence[Tuple[int, int, int]] = common.QWEN_MLP,
        iters: int = 5, seed: int = 0) -> List[dict]:
    timer = common.Timer(device)
    shapes = [("paper", lay, common.paper_gemm(lay)) for lay in layers]
    shapes += [("qwen3-1.7b mlp", None, common.GemmProblem(m, k, n))
               for m, k, n in mlp]
    rows = []
    for i, (source, layer, g) in enumerate(shapes):
        a, b = common.gemm_operands(g.m, g.k, g.n, device, seed + i)
        res = {name: common.time_spec(timer, name, a, b, iters)
               for name in ANCHORS}
        os_ms = res["os_basic"]["ms"]
        rows.append({
            "bench": "fig2", "source": source, "layer": layer,
            "m": g.m, "k": g.k, "n": g.n,
            **{f"{name}_ms": r["ms"] for name, r in res.items()},
            "ws_vs_os": common.ratio(res["ws_basic"]["ms"], os_ms),
            "is_vs_os": common.ratio(res["is_basic"]["ms"], os_ms),
            "infeasible": {name: r["why"] for name, r in res.items()
                           if not r["feasible"]},
            "ctas": {name: r.get("ctas") for name, r in res.items()},
        })
    summary = {"bench": "fig2_summary"}
    for s in (1, 2):
        sel = [r for r in rows if r["layer"] and r["layer"][2] == s]
        summary[f"s={s}"] = {
            "is_vs_os_median": common.median([r["is_vs_os"] for r in sel]),
            "ws_vs_os_median": common.median([r["ws_vs_os"] for r in sel]),
            "layers_is_ran": sum(r["is_vs_os"] is not None for r in sel),
            "layers_ws_ran": sum(r["ws_vs_os"] is not None for r in sel),
            "layers": len(sel), "paper": PAPER[f"s={s}"]}
    rows.append(summary)
    return rows


def main(device: Optional[str] = None) -> None:
    for row in run(device or "cuda"):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
