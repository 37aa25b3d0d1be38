"""The timed rows of B4's walks, B5a, B5b, B1's weight-stripe residency
and B7 beside B2, for one checkout's kernels.

``chip_smoke.py`` times these rows for the tree it runs from; this module
also runs on its own against another checkout's ``src`` (a parent
commit's ``git archive``), so both are timed in one call on one card:

    python3 src/repro_torch/bench/walk_times.py --src .chip_parent/src \
        [--figures]

Each GEMM row: the spec's plan at the shape (kernel, tile, cluster,
CTAs), its CUDA-event median, ``torch.matmul``'s on the same operands,
the plain version's and the bound (``common.gemm_bound``).  Each
attention row (qwen3-1.7b prefill, causal, bf16, at ``TIMED_ATTENTION``
lengths): B7's and B2's medians, SDPA's, and a sha256 of each kernel's
output bytes on seeded inputs under four masks, so two checkouts' bits
can be compared.  ``--figures`` adds the Fig. 2 and Fig. 7 summaries of
that checkout's bench twins.  Needs a card.
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
# Sq = Skv of the attention rows (Hq 16, Hkv 8, D 128: qwen3-1.7b).
TIMED_ATTENTION = (512, 2048)


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


def attention_row(timer, sq: int, dev: str = "cuda") -> dict:
    import hashlib

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import attention_df

    hq, hkv, d = 16, 8, 128
    gen = torch.Generator(device=dev).manual_seed(sq)
    q, k, v = (torch.randn((1, h, sq, d), generator=gen,
                           device=dev).to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    digests = {}
    for name, fn in (("kv_stationary", attention_df.kv_stationary_attention),
                     ("flash_attention", attention_df.flash_attention)):
        h = hashlib.sha256()
        for mask in (dict(), dict(window=100), dict(kv_len=sq - 37),
                     dict(causal=False, window=300)):
            h.update(fn(q, k, v, **mask).view(torch.int16).cpu().numpy()
                     .tobytes())
        digests[name] = h.hexdigest()[:16]
    return dict(
        shape=f"prefill Sq=Skv={sq} Hq={hq} Hkv={hkv} D={d} causal",
        kv_stationary_ms=timer.ms(
            lambda: attention_df.kv_stationary_attention(q, k, v)),
        flash_ms=timer.ms(lambda: attention_df.flash_attention(q, k, v)),
        sdpa_ms=timer.ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
        sha256=digests)


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
    for sq in TIMED_ATTENTION:
        print(json.dumps({"bench": "walk_times", "src": src, "card": card,
                          **attention_row(timer, sq)}), flush=True)
    if args.figures:
        from repro_torch.bench import basic_dataflows, extended_dataflows

        for bench in (basic_dataflows, extended_dataflows):
            rows = bench.run("cuda")
            print(json.dumps({"src": src, "card": card, **rows[-1]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
