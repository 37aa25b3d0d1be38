"""How B1's bf16 sums round: the tensor-core k step against an f32 FMA
chain and cuBLAS.

B1's bf16 path sums each 16-deep k chunk on the tensor cores and adds it
to an f32 accumulator; its float32 path (the same bf16 values widened)
takes one fmaf per k, as B1's bf16 path did before the tensor cores;
``torch.matmul`` on the widened values (cuBLAS, no TF32) is what
``ref.matmul_fused_ref`` computes.  For seeded bf16 operands this
reports each one's largest error against the float64 product, how many
of their bf16-rounded outputs differ from cuBLAS's, and, with the fused
epilogue (per-row scale, bias, gelu, residual) and a bf16 output, how
many elements fall outside ``chip_smoke.py``'s B1 tolerance (atol 1e-3,
rtol 1e-3, under one bf16 ulp above 0.25).

    PYTHONPATH=src python -m repro_torch.bench.rounding

On the CPU nothing runs (the k steps exist only on the card): ``run``
returns no rows.
"""
from __future__ import annotations

import json
from typing import List, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.kernels import matmul_df, ref

SHAPES = ((137, 256, 192), (512, 2048, 512), (512, 6144, 256))


def run(device: Optional[str] = None, seed: int = 1) -> List[dict]:
    device = device_lib.resolve(device)
    if device.type != "cuda":
        return []
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for m, k, n in SHAPES:
        a = torch.randn((m, k), generator=gen, device=device).bfloat16()
        w = (torch.randn((k, n), generator=gen, device=device)
             * k ** -0.5).bfloat16()
        exact = a.double() @ w.double()
        paths = {"tensor_cores": matmul_df.matmul_os(a, w),
                 "fma_chain": matmul_df.matmul_os(a.float(), w.float()),
                 "cublas": a.float() @ w.float()}
        row = {"bench": "b1_rounding", "m": m, "k": k, "n": n,
               "elements": m * n}
        for name, out in paths.items():
            row[f"{name}_max_err"] = float((out.double() - exact).abs().max())
            row[f"{name}_bf16_differs_from_cublas"] = int(
                (out.bfloat16() != paths["cublas"].bfloat16()).sum())
        epi = dict(scale=torch.rand((m, 1), generator=gen, device=device) + 0.5,
                   bias=torch.randn((1, n), generator=gen, device=device),
                   residual=torch.randn((m, n), generator=gen, device=device),
                   activation="gelu", out_dtype=torch.bfloat16)
        want = ref.matmul_fused_ref(a, w, **epi).float()
        for name, (x, y) in {"tensor_cores": (a, w),
                             "fma_chain": (a.float(), w.float())}.items():
            got = matmul_df.matmul_os(x, y, **epi).float()
            row[f"{name}_bf16_out_outside_b1_tol"] = int(
                ((got - want).abs() > 1e-3 + 1e-3 * want.abs()).sum())
        rows.append(row)
    return rows


if __name__ == "__main__":
    for r in run():
        print(json.dumps(r))
