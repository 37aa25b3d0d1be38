"""The timed rows of B8 (the direct conv) for one checkout's kernels.

``chip_smoke.py`` times these rows for the tree it runs from; this module
also runs on its own against another checkout's ``src`` (a parent
commit's ``git archive``), so both are timed in one call on one card:

    python3 src/repro_torch/bench/conv_times.py --src .chip_parent/src

At ResNet-18's (56,3,1,64->64), batch 1: int8 with the fused dequant
(scale, bias) under OS, WS and IS; packed 4-bit OS (two outlier rows);
bf16 OS and WS beside cuDNN (IS at (28,3,1,128->128), where the bf16
image fits); f32 OS beside cuDNN without TF32.  Each row: the plan
(tile, CTAs, split where the tree has them), its CUDA-event median, the
library call's, the bound (``common.conv_bound``) and a sha256 of the
output's bytes on seeded inputs, so two checkouts' bits can be compared
(the int8 ones must agree).  Then the ResNet-18 int8 stack per anchor
(``bench.conv``) and Fig. 9's summary (``bench.binary``) of that tree.
Needs a card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

SHAPE = (56, 3, 1, 64, 64)        # (ih, f, s, cin, cout)
BF16_IS_SHAPE = (28, 3, 1, 128, 128)


def rows(timer, dev: str = "cuda"):
    import torch
    import torch.nn.functional as F

    from repro_torch.bench import common
    from repro_torch.bench.conv import ANCHORS
    from repro_torch.core.dataflow import ConvProblem
    from repro_torch.kernels import conv2d_df, ops, pack

    torch.backends.cudnn.allow_tf32 = False

    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu()
                              .numpy().tobytes()).hexdigest()[:16]

    def operands(shape, dtype, seed):
        ih, f, s, cin, cout = shape
        gen = torch.Generator(device=dev).manual_seed(seed)
        if dtype == torch.int8:
            return (torch.randint(-127, 128, (1, ih, ih, cin), generator=gen,
                                  device=dev, dtype=torch.int8),
                    torch.randint(-127, 128, (f, f, cin, cout),
                                  generator=gen, device=dev,
                                  dtype=torch.int8))
        x = torch.randn((1, ih, ih, cin), generator=gen, device=dev)
        w = torch.randn((f, f, cin, cout), generator=gen, device=dev)
        return x.to(dtype), (w * (f * f * cin) ** -0.5).to(dtype)

    def row(what, shape, dtype, anchor, call, library=None, bits=None):
        ih, f, s, cin, cout = shape
        conv = ConvProblem(ih=ih, iw=ih, fh=f, fw=f, s=s, cin=cin,
                           cout=cout)
        p = conv2d_df.plan(ANCHORS[anchor], conv, dtype, bits)
        rate = {torch.int8: common.INT8_OPS_PER_S,
                torch.bfloat16: common.BF16_FLOPS_PER_S,
                torch.float32: common.F32_FLOPS_PER_S}[dtype]
        in_bytes = 0.5 if bits == 4 else dtype.itemsize
        bnd = common.conv_bound(conv, in_bytes, 4, rate)
        return dict(
            row=what, shape=f"({ih},{f},{s},{cin}->{cout})",
            anchor=anchor, tile=getattr(p, "tile_kernel", None),
            ctas=p.ctas, split=getattr(p, "split", None),
            ms=timer.ms(call),
            library_ms=None if library is None else timer.ms(library),
            bound_ms=bnd[0], bound_by=bnd[1], sha256=digest(call()))

    out = []
    xq, wq = operands(SHAPE, torch.int8, 1)
    gen = torch.Generator(device=dev).manual_seed(2)
    scale = torch.rand((1, SHAPE[4]), generator=gen, device=dev) * 1e-4
    bias = torch.randn((1, SHAPE[4]), generator=gen, device=dev)
    for anchor in ANCHORS:
        out.append(row("int8, fused dequant (scale, bias), f32 out", SHAPE,
                       torch.int8, anchor,
                       lambda a=anchor: ops.conv2d_fused(
                           xq, wq, SHAPE[2], scale=scale, bias=bias,
                           spec=ANCHORS[a])))
    q = torch.randint(-8, 8, (3, 3, 64, 64), generator=gen, device=dev)
    q[0, 1, 3], q[2, 0, 5] = 127, -127
    pcw = pack.pack_conv_weights(q.float() * 0.01, 4)
    x_scale = torch.tensor(0.02, device=dev)
    out.append(row("packed 4-bit, R=2 outlier rows, dequant, f32 out", SHAPE,
                   torch.int8, "os",
                   lambda: ops.conv2d_packed(xq, pcw, SHAPE[2],
                                             x_scale=x_scale), bits=4))
    for dtype, anchor, shape in ((torch.bfloat16, "os", SHAPE),
                                 (torch.bfloat16, "ws", SHAPE),
                                 (torch.bfloat16, "is", BF16_IS_SHAPE),
                                 (torch.float32, "os", SHAPE)):
        x, w = operands(shape, dtype, 3)
        x_nchw = x.permute(0, 3, 1, 2)
        w_lib = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        out.append(row(f"{dtype} -> f32", shape, dtype, anchor,
                       lambda x=x, w=w, a=anchor, s=shape[2]: ops.conv2d(
                           x, w, s, spec=ANCHORS[a]),
                       library=lambda x=x_nchw, w=w_lib, s=shape[2]:
                       F.conv2d(x, w, stride=s)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."),
        help="the src directory whose repro_torch is timed")
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import torch

    if not torch.cuda.is_available():
        print("conv_times: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.bench import binary, common, conv

    timer = common.Timer("cuda")
    card = common.card_line()
    for r in rows(timer):
        print(json.dumps({"bench": "conv_times", "src": src, "card": card,
                          **r}), flush=True)
    for bench in (conv.resnet_rows(torch.device("cuda"), timer, 15, 310),
                  binary.run("cuda")):
        print(json.dumps({"src": src, "card": card, **bench[-1]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
