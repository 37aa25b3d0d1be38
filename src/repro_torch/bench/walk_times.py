"""The timed rows of B4's walks, B5a and B1's weight-stripe residency,
for one checkout's kernels.

``chip_smoke.py`` times these rows for the tree it runs from; this module
also runs on its own against another checkout's ``src`` (a parent
commit's ``git archive``), so both are timed in one call on one card:

    python3 src/repro_torch/bench/walk_times.py --src .chip_parent/src \
        [--figures]

Each row: the spec's plan at the shape (kernel, tile, cluster, CTAs), its
CUDA-event median, ``torch.matmul``'s on the same operands, the plain
version's and the bound (``common.gemm_bound``).  ``--figures`` adds the
Fig. 2 and Fig. 7 summaries of that checkout's bench twins.  Needs a
card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

# (kernel, spec, shape): a paper layer (hw, f, s, n_filters) or (M, K, N).
TIMED = (("matmul_rmw", "ws_basic", (56, 3, 1, 128)),
         ("matmul_rmw", "is_basic", (56, 3, 1, 128)),
         ("matmul_os", "os_w_stripe", (56, 3, 1, 128)),
         ("matmul_ws_stripe", "ws_o_stripe", (512, 6144, 2048)),
         ("matmul_is_stripe", "is_o_stripe", (56, 3, 1, 128)))


def time_row(timer, spec_name: str, shape, dev: str = "cuda") -> dict:
    import torch

    from repro_torch.bench import common
    from repro_torch.kernels import matmul_df, ref

    if len(shape) == 4:
        g = common.paper_gemm(shape)
        m, k, n = g.m, g.k, g.n
        label = f"paper layer {shape} M={m} K={k} N={n} {spec_name}"
    else:
        m, k, n = shape
        label = f"M={m} K={k} N={n} {spec_name}"
    a, w = common.gemm_operands(m, k, n, dev, seed=m + n)
    spec = common.NINE_SPECS[spec_name]
    p = matmul_df.plan(spec, m, k, n, a.dtype)
    bnd = common.gemm_bound(m, k, n)
    return dict(
        shape=label, spec=spec_name, kernel=p.kernel,
        tile_kernel=getattr(p, "tile_kernel", None),
        cluster=getattr(p, "cluster", None), ctas=p.ctas,
        smem_bytes=p.smem_bytes,
        ms=timer.ms(lambda: matmul_df.matmul_df(a, w, spec)),
        plain_ms=timer.ms(lambda: ref.matmul_fused_ref(a, w)),
        library_ms=timer.ms(lambda: torch.matmul(a, w)),
        library_call="torch.matmul (bf16 out)",
        bound_ms=bnd[0], bound_by=bnd[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."),
        help="the src directory whose repro_torch is timed")
    ap.add_argument("--figures", action="store_true")
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import torch

    if not torch.cuda.is_available():
        print("walk_times: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.bench import common

    timer = common.Timer("cuda")
    card = common.card_line()
    for kernel, spec_name, shape in TIMED:
        print(json.dumps({"bench": "walk_times", "src": src, "card": card,
                          **time_row(timer, spec_name, shape)}), flush=True)
    if args.figures:
        from repro_torch.bench import basic_dataflows, extended_dataflows

        for bench in (basic_dataflows, extended_dataflows):
            rows = bench.run("cuda")
            print(json.dumps({"src": src, "card": card, **rows[-1]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
