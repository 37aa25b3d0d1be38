"""Packed int4/int5 weights on the card: B1 with B6 decoding the planes,
against int8 and bf16 weights.

The twin of ``benchmarks/bench_fused.py``'s packed rows.  The reference
models the weight stream of a packed GEMM in its cost model and gates the
wb4/int8 weight-traffic ratio at <= 0.65; here B1 runs at qwen3-1.7b's
MLP shapes (K x N = 2048 x 6144 and 6144 x 2048) at decode (M = 4) and
prefill (M = 512), four ways, each with the scale-only dequant epilogue
(one launch, f32 out):

* ``wb4``, ``wb5``: ``ops.matmul_packed`` on packed planes drawn as the
  packed MLP draws them (``layers.draw_packed``), int8 activations;
* ``int8``: ``ops.int8_matmul_fused`` on the same weight's exact int8
  image, which must equal the packed result bit for bit;
* ``bf16``: ``ops.matmul_fused`` on the dequantized weight in bf16.

A row gives the time, the modeled bytes (weight as stored, activations
and f32 output once; ``weight_bytes`` alone) and the bound (bytes over
3.35 TB/s or 2*M*K*N over the int8 or bf16 peak); the summary gives the
measured wb4/int8 and wb5/int8 time ratios at M = 4 beside the modeled
weight-byte ratios.  On the CPU nothing is timed.

    PYTHONPATH=src python -m repro_torch.bench.packed
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.bench import common
from repro_torch.kernels import ops, pack
from repro_torch.models import layers

# qwen3-1.7b's MLP GEMMs (M, K, N) at decode batch 4 and a 512-token
# prefill.
SHAPES: List[Tuple[int, int, int]] = [
    (m, k, n) for m in (4, 512) for k, n in ((2048, 6144), (6144, 2048))]
KINDS = ("wb4", "wb5", "int8", "bf16")
REFERENCE_GATE = ("modeled wb4/int8 weight traffic <= 0.65 "
                  "(benchmarks/bench_fused.py, check_regression.py)")


def weight_bytes(kind: str, k: int, n: int) -> int:
    if kind in ("wb4", "wb5"):
        return pack.packed_bytes(k, n, int(kind[-1]))
    return k * n * (1 if kind == "int8" else 2)


def run(device: Optional[str] = None, iters: int = 15, seed: int = 500,
        shapes: Sequence[Tuple[int, int, int]] = SHAPES) -> List[dict]:
    dev = device_lib.resolve(device)
    timer = common.Timer(dev)
    rows = []
    for i, (m, k, n) in enumerate(shapes):
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        pws = {bits: layers.draw_packed(gen, k, n, bits, dev)
               for bits in (4, 5)}
        aq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                           dtype=torch.int8)
        a_scale = torch.tensor(0.02, device=dev)
        q4, w_scale = pack.unpack_weights(pws[4])
        a16 = (aq.float() * a_scale).to(torch.bfloat16)
        w16 = pack.dequantize(pws[4], torch.bfloat16)
        calls = {
            "wb4": lambda: ops.matmul_packed(aq, pws[4], a_scale=a_scale),
            "wb5": lambda: ops.matmul_packed(aq, pws[5], a_scale=a_scale),
            "int8": lambda: ops.int8_matmul_fused(aq, q4, a_scale, w_scale),
            "bf16": lambda: ops.matmul_fused(a16, w16),
        }
        outs = {kind: fn() for kind, fn in calls.items()}
        if not torch.equal(outs["wb4"], outs["int8"]):
            raise AssertionError(f"packed 4-bit and int8 B1 differ at "
                                 f"M={m} K={k} N={n}")
        for kind, fn in calls.items():
            if tuple(outs[kind].shape) != (m, n) \
                    or outs[kind].dtype != torch.float32:
                raise AssertionError(f"{kind} output {tuple(outs[kind].shape)}"
                                     f" {outs[kind].dtype}")
            act = 2 if kind == "bf16" else 1
            moved = weight_bytes(kind, k, n) + m * k * act + m * n * 4
            bnd = common.bound(moved, 2.0 * m * k * n,
                               common.BF16_FLOPS_PER_S if kind == "bf16"
                               else common.INT8_OPS_PER_S)
            rows.append({"bench": "packed_b1", "m": m, "k": k, "n": n,
                         "kind": kind, "ms": timer.ms(fn, iters),
                         "weight_bytes": weight_bytes(kind, k, n),
                         "bytes": moved, "bound_ms": bnd[0],
                         "bound_by": bnd[1]})
    summary = {"bench": "packed_summary", "reference_gate": REFERENCE_GATE}
    for bits in (4, 5):
        ratios = [common.ratio(r["ms"], s["ms"]) for r in rows for s in rows
                  if r["kind"] == f"wb{bits}" and s["kind"] == "int8"
                  and r["m"] == s["m"] == 4 and (r["k"], r["n"]) ==
                  (s["k"], s["n"])]
        summary[f"wb{bits}_over_int8_ms_m4"] = common.median(ratios)
        summary[f"wb{bits}_over_int8_weight_bytes"] = common.median(
            [weight_bytes(f"wb{bits}", k, n) / weight_bytes("int8", k, n)
             for _, k, n in shapes])
    rows.append(summary)
    return rows


def main(device: Optional[str] = None) -> None:
    for row in run(device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
