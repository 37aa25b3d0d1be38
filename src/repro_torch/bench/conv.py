"""The conv twin on the card: fused against unfused epilogue per anchor,
and the ResNet-18 conv body at int8.

The twin of ``benchmarks/bench_conv.py`` and of the functional part of
``benchmarks/bench_e2e_int8.py``, measured instead of counted:

* ``conv_fused``: at ``CASE`` (f32, 14x14x128, 3x3, 128 filters, the
  reference bench's case) each anchor runs ``ops.conv2d_fused`` (scale,
  bias, silu and residual at the flush: one launch) against
  ``ops.conv2d`` followed by the same epilogue in PyTorch (the raw
  accumulator round-trips device memory), or reports why the anchor
  cannot hold its operand at that shape; ``conv_fused_bf16`` the same
  in bf16 (the tensor-core OS tile and WS/IS walks).
* ``resnet18_int8``: each layer of the ResNet-18 conv body (``RESNET18``,
  the reference's stack, batch 1) runs ``ops.int8_conv2d_fused`` with
  the dequant (per-channel x_scale * w_scale), bias and relu fused, under
  each anchor whose resident operand fits, beside its bound at the int8
  tensor-core rate; the summary sums the stack (times each layer's
  repeat) per anchor.

Times are CUDA-event medians after an L2 flush (``common.Timer``).  On the
CPU nothing is timed: the rows only check shapes and plans.

    PYTHONPATH=src python -m repro_torch.bench.conv
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch.bench import common
from repro_torch.core.dataflow import ConvProblem, DataflowSpec, IS, OS, WS
from repro_torch.kernels import conv2d_df, ops

CASE = dict(n=1, ih=14, iw=14, f=3, s=1, cin=128, cout=128)
# ResNet-18 conv body (ih, iw, fh, s, cin, cout, repeat), as
# benchmarks/bench_e2e_int8.py lists it.
RESNET18: List[Tuple[int, int, int, int, int, int, int]] = [
    (56, 56, 3, 1, 64, 64, 4),
    (56, 56, 3, 2, 64, 128, 1),
    (28, 28, 3, 1, 128, 128, 3),
    (28, 28, 3, 2, 128, 256, 1),
    (14, 14, 3, 1, 256, 256, 3),
    (14, 14, 3, 2, 256, 512, 1),
    (7, 7, 3, 1, 512, 512, 3),
]
ANCHORS = {name: DataflowSpec.basic(a, block=conv2d_df.BLOCK)
           for name, a in (("os", OS), ("ws", WS), ("is", IS))}


def _feasible(spec: DataflowSpec, conv: ConvProblem,
              dtype: torch.dtype) -> Tuple[Optional[conv2d_df.Plan],
                                           Optional[str]]:
    try:
        return conv2d_df.plan(spec, conv, dtype), None
    except ValueError as err:
        return None, str(err)


def fused_rows(device, timer: common.Timer, iters: int, seed: int,
               dtype: torch.dtype = torch.float32) -> List[dict]:
    c = CASE
    gen = torch.Generator(device=device).manual_seed(seed)
    conv = ConvProblem(ih=c["ih"], iw=c["iw"], fh=c["f"], fw=c["f"],
                       s=c["s"], cin=c["cin"], cout=c["cout"], n=c["n"])
    x = torch.randn((c["n"], c["ih"], c["iw"], c["cin"]), generator=gen,
                    device=device).to(dtype)
    w = (torch.randn((c["f"], c["f"], c["cin"], c["cout"]), generator=gen,
                     device=device)
         * (c["f"] * c["f"] * c["cin"]) ** -0.5).to(dtype)
    bias = torch.randn((c["cout"],), generator=gen, device=device)
    # Epilogue operands live on the device before timing: a Python scalar
    # would add a host-to-device copy to every fused call.
    scale = torch.tensor(0.37, device=device)
    residual = torch.randn((c["n"], conv.oh, conv.ow, c["cout"]),
                           generator=gen, device=device)
    rows = []
    for name, spec in ANCHORS.items():
        p, why = _feasible(spec, conv, x.dtype)
        row = {"bench": "conv_fused" + ("" if dtype == torch.float32
                                        else "_bf16"),
               "case": dict(CASE), "anchor": name,
               "dtype": str(dtype).removeprefix("torch."),
               "epilogue": "scale+bias+silu+residual"}
        if p is None:
            rows.append({**row, "feasible": False, "why": why,
                         "fused_ms": None, "unfused_ms": None})
            continue

        def fused():
            return ops.conv2d_fused(x, w, stride=c["s"], bias=bias,
                                    scale=scale, residual=residual,
                                    activation="silu", spec=spec)

        def unfused():
            acc = ops.conv2d(x, w, stride=c["s"], spec=spec)
            return F.silu(scale * acc + bias) + residual

        diff = float((fused() - unfused()).abs().max())
        if diff > 1e-4:
            raise AssertionError(f"conv anchor {name}: fused and unfused "
                                 f"differ by {diff}")
        f_ms = timer.ms(fused, iters)
        u_ms = timer.ms(unfused, iters)
        rows.append({**row, "feasible": True, "walk": p.walk, "ctas": p.ctas,
                     "smem_bytes": p.smem_bytes, "fused_ms": f_ms,
                     "unfused_ms": u_ms,
                     "unfused_vs_fused": common.ratio(u_ms, f_ms),
                     "max_abs_diff": diff})
    return rows


def resnet_rows(device, timer: common.Timer, iters: int, seed: int,
                layers: Sequence[Tuple[int, ...]] = RESNET18) -> List[dict]:
    rows = []
    stack = {name: 0.0 for name in ANCHORS}
    for i, (ih, iw, f, s, cin, cout, rep) in enumerate(layers):
        gen = torch.Generator(device=device).manual_seed(seed + i)
        conv = ConvProblem(ih=ih, iw=iw, fh=f, fw=f, s=s, cin=cin, cout=cout)
        xq = torch.randint(-127, 128, (1, ih, iw, cin), generator=gen,
                           device=device, dtype=torch.int8)
        wq = torch.randint(-127, 128, (f, f, cin, cout), generator=gen,
                           device=device, dtype=torch.int8)
        x_scale = torch.tensor(0.02, device=device)
        w_scale = torch.rand((cout,), generator=gen, device=device) * 1e-3
        bias = torch.randn((cout,), generator=gen, device=device)
        bnd = common.conv_bound(conv, 1, 4, common.INT8_OPS_PER_S)
        row = {"bench": "resnet18_int8", "layer": [ih, iw, f, s, cin, cout],
               "repeat": rep, "m": conv.as_gemm().m, "k": conv.as_gemm().k,
               "n": cout, "bound_ms": bnd[0], "bound_by": bnd[1],
               "infeasible": {}}
        outs = {}
        for name, spec in ANCHORS.items():
            p, why = _feasible(spec, conv, torch.int8)
            if p is None:
                row["infeasible"][name] = why
                row[f"{name}_ms"] = None
                stack[name] = None
                continue

            def run_one(spec=spec):
                return ops.int8_conv2d_fused(xq, wq, x_scale, w_scale,
                                             stride=s,
                                             bias=bias, activation="relu",
                                             spec=spec)

            outs[name] = run_one()
            row[f"{name}_ms"] = timer.ms(run_one, iters)
            row[f"{name}_ctas"] = p.ctas
            if stack[name] is not None and row[f"{name}_ms"] is not None:
                stack[name] += rep * row[f"{name}_ms"]
        base = outs["os"]
        if tuple(base.shape) != (1, conv.oh, conv.ow, cout):
            raise AssertionError(f"resnet layer {row['layer']}: output "
                                 f"{tuple(base.shape)}")
        row["anchors_equal_os_bitwise"] = all(
            torch.equal(o, base) for o in outs.values())
        if not row["anchors_equal_os_bitwise"]:
            raise AssertionError(f"resnet layer {row['layer']}: an anchor "
                                 f"differs from OS")
        rows.append(row)
    measured = timer.flush is not None
    rows.append({"bench": "resnet18_int8_summary",
                 "stack_ms": {k: (v if measured else None)
                              for k, v in stack.items()},
                 "layers": len(layers)})
    return rows


def run(device: Optional[str] = None, iters: int = 15, seed: int = 300,
        layers: Sequence[Tuple[int, ...]] = RESNET18) -> List[dict]:
    dev = device_lib.resolve(device)
    timer = common.Timer(dev)
    return (fused_rows(dev, timer, iters, seed)
            + fused_rows(dev, timer, iters, seed + 1, torch.bfloat16)
            + resnet_rows(dev, timer, iters, seed + 10, layers))


def main(device: Optional[str] = None) -> None:
    for row in run(device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
