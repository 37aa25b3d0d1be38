"""Attention's two anchors on the card: OS (flash, B2) against WS
(kv-stationary, B7) at qwen3-1.7b prefill widths (Hq 16, Hkv 8, D 128,
causal, bf16), Sq = Skv = 512 and 2048, with SDPA's time at each shape
as the library's yardstick (timed here, never on the port's path).

    PYTHONPATH=src python -m repro_torch.bench.attention_anchors
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.bench import common
from repro_torch.kernels import ops


def run(device: str = "cuda", lengths: Sequence[int] = (512, 2048),
        heads=(16, 8), d: int = 128, iters: int = 5,
        seed: int = 200) -> List[dict]:
    timer = common.Timer(device)
    hq, hkv = heads
    rows = []
    for i, s in enumerate(lengths):
        gen = torch.Generator(device=device).manual_seed(seed + i)
        q, k, v = (torch.randn((1, h, s, d), generator=gen,
                               device=device).to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        for anchor in ("os", "ws"):
            out = ops.attention(q, k, v, anchor=anchor)
            if tuple(out.shape) != tuple(q.shape):
                raise AssertionError(f"anchor {anchor}: output "
                                     f"{tuple(out.shape)}")
        pairs = s * (s + 1) // 2
        bnd = common.bound((hq + 2 * hkv) * s * d * 2 + hq * s * d * 2,
                           4.0 * d * pairs * hq)
        os_ms = timer.ms(lambda: ops.attention(q, k, v, anchor="os"), iters)
        ws_ms = timer.ms(lambda: ops.attention(q, k, v, anchor="ws"), iters)
        sdpa_ms = None
        if q.device.type == "cuda":
            sdpa_ms = timer.ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), iters)
        rows.append({"bench": "attention_anchors", "sq": s, "skv": s,
                     "hq": hq, "hkv": hkv, "d": d, "causal": True,
                     "os_ms": os_ms, "ws_ms": ws_ms,
                     "ws_vs_os": common.ratio(ws_ms, os_ms),
                     "sdpa_ms": sdpa_ms, "bound_ms": bnd[0],
                     "bound_by": bnd[1]})
    return rows


def main(device: Optional[str] = None) -> None:
    for row in run(device or "cuda"):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
