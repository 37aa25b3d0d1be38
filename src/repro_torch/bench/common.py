"""What the bench twins share: the paper's layer grid, qwen3-1.7b's MLP
GEMMs, the nine canonical dataflow specs, CUDA-event timing and the
H100's bound (bf16, int8 and the CUDA cores' popcount rate).

Times are CUDA-event medians on the card, each launch preceded by a
256 MiB write so operands come from device memory, not the 50 MB L2,
and by a ~1 ms spin on the card, so the host's Python in a wrapper runs
while the card is busy and no host time falls between the events.
On the CPU nothing is timed: a bench's rows there only check shapes and
plans, and every time is ``None`` ("not measured").
"""
from __future__ import annotations

import subprocess
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.dataflow import (ConvProblem, DataflowSpec, GemmProblem,
                                       Residency, IS, OS, WS)
from repro_torch.kernels import matmul_df, pack

# Published H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12            # float32 on the CUDA cores, no TF32
INT8_OPS_PER_S = 1979e12
# xor+popcount word pairs per second on the CUDA cores: 16 popc per SM per
# clock (the CUDA C++ documentation's arithmetic instruction throughput,
# compute capability 9.0) on 132 SMs at 1.98 GHz, the clock the data
# sheet's 67 TFLOP/s float32 (128 FMA lanes per SM) implies.
POPC_WORDS_PER_S = 132 * 16 * 1.98e9
# The binary tensor cores (mma.sync m16n8k256 .b1 .and.popc, B9's tiles),
# 2 M N K operations a product with K in bits: the data sheet gives no
# rate, so this is bench/binary_sweep.cu's reading on an NVIDIA H100 80GB
# HBM3 at 700 W (8x its m16n8k32 .s8 reading, 1 284.9 TOP/s). A measured
# rate is at most the peak, so a bound taken from it may be loose.
B1_OPS_PER_S = 10285.5e12

# The paper's conv layer grid (Sec. V), as the reference's benches take it
# (benchmarks/common.py): (input hw, filter hw, stride, n_filters), cin 128.
PAPER_LAYERS: List[Tuple[int, int, int, int]] = [
    (56, 3, 1, 128), (56, 3, 1, 256), (56, 3, 1, 512),
    (56, 4, 1, 128), (56, 5, 1, 256),
    (112, 3, 1, 128), (112, 3, 1, 256), (112, 4, 1, 512),
    (56, 3, 2, 128), (56, 4, 2, 256),
    (112, 3, 2, 128), (112, 5, 2, 256),
]
PAPER_CIN = 128

# qwen3-1.7b's MLP GEMMs (d_model 2048, d_ff 6144) at decode batch 4, a
# ragged 137-token prefill and a 512-token prefill.
QWEN_MLP: List[Tuple[int, int, int]] = [
    (m, k, n) for m in (4, 137, 512) for k, n in ((2048, 6144), (6144, 2048))]

_B = matmul_df.BLOCK
# The reference's canonical nine (tests/test_fused_epilogue.py), each at
# the port's compiled block.
NINE_SPECS: Dict[str, DataflowSpec] = {
    "os_basic": DataflowSpec.basic(OS, block=_B),
    "os_w_stripe": DataflowSpec(OS, {WS: Residency.STRIPE}, (WS,), _B),
    "os_w_whole_i_stripe": DataflowSpec(
        OS, {WS: Residency.WHOLE, IS: Residency.STRIPE}, (WS, IS), _B),
    "ws_basic": DataflowSpec.basic(WS, block=_B),
    "ws_o_stripe": DataflowSpec(WS, {OS: Residency.STRIPE}, (OS,), _B),
    "ws_i_stripe": DataflowSpec(WS, {IS: Residency.STRIPE}, (IS,), _B),
    "is_basic": DataflowSpec.basic(IS, block=_B),
    "is_o_stripe": DataflowSpec(IS, {OS: Residency.STRIPE}, (OS,), _B),
    "is_b_whole": DataflowSpec(IS, {WS: Residency.WHOLE}, (WS,), _B),
}
ANCHOR_SPECS = {a: [n for n in NINE_SPECS if n.startswith(a)]
                for a in ("os", "ws", "is")}


def paper_gemm(layer: Tuple[int, int, int, int]) -> GemmProblem:
    hw, f, s, nf = layer
    return ConvProblem(ih=hw, iw=hw, fh=f, fw=f, s=s, cin=PAPER_CIN,
                       cout=nf).as_gemm()


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def bound(bytes_moved: float, flops: float,
          ops_per_s: float = BF16_FLOPS_PER_S) -> Tuple[float, str]:
    """Least time (ms) the card could take: bytes over HBM bandwidth or
    operations over their peak rate (the bf16 tensor cores by default),
    whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def packed_read_bytes(w) -> int:
    """Bytes a kernel must read of packed weights ``w`` (``PackedWeights``
    or ``PackedConvWeights``): the planes, the sidecar's slot indices, and
    the delta rows of the filled slots only (the kernels skip an empty
    slot without reading its row)."""
    n = w.codes.shape[-1]
    rows = w.codes.numel() // n * pack.WORD_NIBBLES   # the padded K
    idx = w.outlier_idx
    filled = int(((idx >= 0) & (idx < rows)).sum())
    planes = w.codes.numel() + (0 if w.highbits is None
                                else w.highbits.numel())
    return 4 * (planes + idx.numel() + filled * n)


def gemm_bound(m: int, k: int, n: int, in_bytes: int = 2,
               out_bytes: int = 4) -> Tuple[float, str]:
    """A, B and the output moved once; 2*M*K*N operations."""
    return bound((m * k + k * n) * in_bytes + m * n * out_bytes,
                 2.0 * m * k * n)


class Timer:
    """Median per-launch ms by CUDA events after an L2 flush; on a CPU
    device, runs the function once and measures nothing."""

    # ~1 ms at the H100's 1.98 GHz: longer than any wrapper's host work.
    SPIN_CYCLES = 2_000_000

    def __init__(self, device: str):
        self.device = torch.device(device)
        self.flush = (torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                                  device=self.device)
                      if self.device.type == "cuda" else None)

    def ms(self, fn: Callable[[], object], iters: int = 15) -> Optional[float]:
        if self.flush is None:
            fn()
            return None
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in pairs)
        return times[len(times) // 2]


def gemm_operands(m: int, k: int, n: int, device: str, seed: int):
    """bf16 operands from a seed, B scaled to keep outputs near unit size."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    b = (torch.randn((k, n), generator=gen, device=device)
         * k ** -0.5).to(torch.bfloat16)
    return a, b


def time_spec(timer: Timer, spec_name: str, a: torch.Tensor, b: torch.Tensor,
              iters: int) -> dict:
    """One spec at one shape: its plan and time, or why it cannot run."""
    from repro_torch.kernels import ops

    m, k = a.shape
    n = b.shape[1]
    spec = NINE_SPECS[spec_name]
    try:
        p = matmul_df.plan(spec, m, k, n, a.dtype)
    except ValueError as err:
        return {"spec": spec_name, "feasible": False, "why": str(err),
                "ms": None}
    out = ops.matmul(a, b, spec=spec)
    if tuple(out.shape) != (m, n) or out.dtype != torch.float32:
        raise AssertionError(f"{spec_name}: output {tuple(out.shape)} "
                             f"{out.dtype}, want ({m}, {n}) float32")
    ms = timer.ms(lambda: ops.matmul(a, b, spec=spec), iters=iters)
    return {"spec": spec_name, "feasible": True, "kernel": p.kernel,
            "walk": p.walk, "ctas": p.ctas, "smem_bytes": p.smem_bytes,
            "demoted": p.demoted, "ms": ms}


def median(xs: List[float]) -> Optional[float]:
    xs = sorted(x for x in xs if x is not None)
    if not xs:
        return None
    mid = len(xs) // 2
    return xs[mid] if len(xs) % 2 else 0.5 * (xs[mid - 1] + xs[mid])


def ratio(x: Optional[float], y: Optional[float]) -> Optional[float]:
    return None if x is None or y is None else x / y


def conv_bound(layer: ConvProblem, in_bytes: float, out_bytes: int,
               ops_per_s: float) -> Tuple[float, str]:
    """A conv's input, weights and output moved once (``in_bytes`` per
    element of each operand, fractional for packed bits); 2*M*K*N
    operations of its implicit GEMM at ``ops_per_s``."""
    g = layer.as_gemm()
    moved = ((layer.n * layer.ih * layer.iw * layer.cin
              + layer.fh * layer.fw * layer.cin * layer.cout) * in_bytes
             + g.m * g.n * out_bytes)
    return bound(moved, 2.0 * g.m * g.k * g.n, ops_per_s)
