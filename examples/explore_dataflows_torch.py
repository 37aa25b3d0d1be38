"""Dataflow exploration over the paper's layer grid, then measured on the card.

    PYTHONPATH=src python examples/explore_dataflows_torch.py            # card
    PYTHONPATH=src python examples/explore_dataflows_torch.py --device cpu

The port's twin of ``examples/explore_dataflows.py``, the paper's two
steps (heuristics first, measurement second): every layer of the paper's
grid (Sec. V; cin 128, bf16, its implicit-GEMM view) is ranked by the
Hopper cost model over the port's kernels (``core.explorer``), then the
analytical top candidates of each layer are run through ``ops.matmul``
on the card and timed (CUDA events after an L2 flush).  ``--device cpu``
prints the ranking only: a CPU timing says nothing of the card.
"""
import argparse

from repro_torch.bench.common import PAPER_CIN, PAPER_LAYERS
from repro_torch.core import cost_model, explorer
from repro_torch.core.dataflow import ConvProblem


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--top", type=int, default=3,
                    help="analytical candidates measured a layer")
    args = ap.parse_args()
    hw = cost_model.hardware_for(args.device)
    wins, agree = {}, 0
    for hw_, f, s, nf in PAPER_LAYERS:
        g = ConvProblem(ih=hw_, iw=hw_, fh=f, fw=f, s=s, cin=PAPER_CIN,
                        cout=nf, in_dtype="bfloat16",
                        out_dtype="float32").as_gemm()
        ranked = explorer.explore(g, hw, top=args.top)
        best = ranked[0]
        wins[best.name] = wins.get(best.name, 0) + 1
        line = (f"({f}x{f}, {hw_}x{hw_}, {nf}) s={s}: analytical best "
                f"{best.name} ({best.est_seconds * 1e3:.4f} ms est.)")
        if args.device == "cuda":
            measured = explorer.empirical_rank(g, [c.spec for c in ranked],
                                               device="cuda", iters=15)
            agree += measured[0][0] == best.spec
            line += "; measured " + ", ".join(
                f"{spec.name} {sec * 1e3:.4f} ms" for spec, sec in measured)
        print(line)
    print(f"\nanalytical winners on {hw.name}: {wins}")
    if args.device == "cuda":
        print(f"measured fastest == analytical best on {agree} of "
              f"{len(PAPER_LAYERS)} layers")


if __name__ == "__main__":
    main()
