"""Fig. 9 on the card: binary against int8 and bf16 convolution.

The twin of ``benchmarks/bench_binary.py``.  The paper reports its binary
(1-bit) conv code up to 4.8x faster than float implementations and over
12x faster than bit-serial code on VGG conv layers; the reference bench
computes only the bytes each datatype moves, in its cost model.  Here
each of the four ``VGG_LAYERS`` runs at full size, batch 1, three ways:

* binary through B9: ``ops.binary_conv2d`` on channel-packed int32 words
  (the im2col in PyTorch, then one binary GEMM launch), raw int32 dots;
  the kernel alone on the im2col'd operands is timed beside it;
* int8 through B8: ``ops.conv2d`` of the same +-1 values as int8, int32
  out, which must equal the binary dots bit for bit;
* bf16 through B8: ``ops.conv2d`` in bf16, f32 out, with cuDNN's
  ``F.conv2d`` at bf16 timed beside it as the library's yardstick (never
  on the port's path).

A row gives each time, the int8/binary and bf16/binary time ratios (the
binary path's speedups), against the binary op and against B9 alone (at
these sizes the op's host work can outlast its kernel, so the op's ratio
moves from run to run), and the bytes each datatype moves (input,
weights and output once).  On the CPU nothing is timed.

    PYTHONPATH=src python -m repro_torch.bench.binary
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch.bench import common
from repro_torch.core.dataflow import ConvProblem
from repro_torch.kernels import binary_mm, ops, ref

# (ih, iw, f, s, cin, cout), as benchmarks/bench_binary.py lists them.
VGG_LAYERS: List[Tuple[int, int, int, int, int, int]] = [
    (56, 56, 3, 1, 256, 256),
    (56, 56, 3, 1, 256, 512),
    (28, 28, 3, 1, 512, 512),
    (14, 14, 3, 1, 512, 512),
]
PAPER = {"binary_vs_float": "up to 4.8x", "binary_vs_bitserial": ">12x"}


def layer_bytes(conv: ConvProblem) -> dict:
    """Bytes each datatype moves: input, weights and output once (binary:
    1 bit per channel in, int32 dots out; int8: int32 out; bf16: f32)."""
    ins = conv.n * conv.ih * conv.iw * conv.cin \
        + conv.fh * conv.fw * conv.cin * conv.cout
    outs = conv.n * conv.oh * conv.ow * conv.cout
    return {"binary": ins // 8 + 4 * outs, "int8": ins + 4 * outs,
            "bf16": 2 * ins + 4 * outs}


def run(device: Optional[str] = None, iters: int = 15, seed: int = 400,
        layers: Sequence[Tuple[int, ...]] = VGG_LAYERS) -> List[dict]:
    dev = device_lib.resolve(device)
    timer = common.Timer(dev)
    rows = []
    for i, (ih, iw, f, s, cin, cout) in enumerate(layers):
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        conv = ConvProblem(ih=ih, iw=iw, fh=f, fw=f, s=s, cin=cin, cout=cout)
        x = torch.where(torch.rand((1, ih, iw, cin), generator=gen,
                                   device=dev) < 0.5, -1, 1).to(torch.int8)
        w = torch.where(torch.rand((f, f, cin, cout), generator=gen,
                                   device=dev) < 0.5, -1, 1).to(torch.int8)
        xp, wp = ref.pack_binary(x, axis=-1), ref.pack_binary(w, axis=2)
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        n_bits = f * f * cin

        dots = ops.binary_conv2d(xp, wp, stride=s, n_bits=n_bits)
        as_int8 = ops.conv2d(x, w, stride=s)
        if not torch.equal(dots, as_int8):
            raise AssertionError(f"VGG layer {(ih, iw, f, s, cin, cout)}: "
                                 f"binary dots differ from the int8 conv")
        if not torch.equal(ops.conv2d(xb, wb, stride=s),
                           as_int8.float()):
            raise AssertionError(f"VGG layer {(ih, iw, f, s, cin, cout)}: "
                                 f"the bf16 conv of +-1 differs")
        a = ref.binary_im2col(xp, f, f, s).reshape(conv.oh * conv.ow, -1)
        b = wp.reshape(-1, cout)
        bin_ms = timer.ms(lambda: ops.binary_conv2d(xp, wp, stride=s,
                                                    n_bits=n_bits), iters)
        kernel_ms = timer.ms(lambda: binary_mm.binary_mm_df(
            a, b, n_bits, binary_mm.BASIC_OS), iters)
        int8_ms = timer.ms(lambda: ops.conv2d(x, w, stride=s), iters)
        bf16_ms = timer.ms(lambda: ops.conv2d(xb, wb, stride=s), iters)
        cudnn_ms = None
        if dev.type == "cuda":
            x_nchw = xb.permute(0, 3, 1, 2)
            w_lib = wb.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            cudnn_ms = timer.ms(lambda: F.conv2d(x_nchw, w_lib, stride=s),
                                iters)
        nbytes = layer_bytes(conv)
        rows.append({
            "bench": "fig9", "layer": [ih, iw, f, s, cin, cout],
            "m": conv.oh * conv.ow, "k": n_bits, "n": cout,
            "binary_ms": bin_ms, "binary_kernel_ms": kernel_ms,
            "int8_ms": int8_ms, "bf16_ms": bf16_ms, "cudnn_bf16_ms": cudnn_ms,
            "int8_over_binary": common.ratio(int8_ms, bin_ms),
            "bf16_over_binary": common.ratio(bf16_ms, bin_ms),
            "int8_over_binary_kernel": common.ratio(int8_ms, kernel_ms),
            "bf16_over_binary_kernel": common.ratio(bf16_ms, kernel_ms),
            "bytes": nbytes,
            "bytes_int8_over_binary": nbytes["int8"] / nbytes["binary"],
            "bytes_bf16_over_binary": nbytes["bf16"] / nbytes["binary"],
            "binary_equals_int8": True})
    ratios = ("int8_over_binary", "bf16_over_binary",
              "int8_over_binary_kernel", "bf16_over_binary_kernel")
    rows.append({"bench": "fig9_summary", "paper": PAPER,
                 **{f"{k}_median": common.median([r[k] for r in rows])
                    for k in ratios}})
    return rows


def main(device: Optional[str] = None) -> None:
    for row in run(device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
