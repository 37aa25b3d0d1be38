"""Heuristic-guided dataflow exploration (paper §IV), on Hopper's kernels.

The twin of ``repro/core/explorer.py``: enumerate the (anchor, auxiliary
residency) candidates of a workload, prune them with the observations
Table I gives (Obs 1, 4, 5), rank them with ``core.cost_model``'s Hopper
estimate, and measure the best on the card when asked.

Each of the port's kernels is compiled for one block
(``matmul_df.BLOCK``, ``conv2d_df.BLOCK``, ``binary_mm.BLOCK``,
``attention_df.FLASH_BLOCKS``/``KV_BLOCKS``), so there is no block sweep
as on the TPU: a candidate is an anchor and residencies at the compiled
block, feasible where its kernel's planner does not raise.  ``explore``
is generic: it dispatches through the problem registry
(``core.dataflow.register_problem``), and this module registers the four
problem types (GEMM, conv, binary, attention) when it is imported.

``measure`` times the public ops (``kernels.ops``, bound late to avoid an
import cycle) with CUDA events after an L2 flush on the card; on the CPU
it times the plain path, a proxy as the reference's interpret mode is.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import cost_model
from repro_torch.core.dataflow import (AttentionProblem, BinaryProblem,
                                       ConvProblem, DataflowSpec, GemmProblem,
                                       ProblemRegistration, Residency,
                                       Stationarity, register_problem,
                                       registration_for, IS, OS, WS)
from repro_torch.kernels import attention_df, binary_mm, conv2d_df, matmul_df


@dataclasses.dataclass(frozen=True)
class Candidate:
    spec: DataflowSpec
    est_seconds: float
    traffic_bytes: int
    feasible: bool

    @property
    def name(self) -> str:
        return self.spec.name


# The reference's auxiliary variants per anchor; with the observations'
# pruning WS keeps {} and the output stripe (Obs 1 and 5), IS {} and the
# output stripe (Obs 4).
GEMM_AUX = {
    OS: ({}, {WS: Residency.STRIPE}, {WS: Residency.WHOLE},
         {IS: Residency.STRIPE}, {WS: Residency.WHOLE, IS: Residency.STRIPE}),
    WS: ({}, {OS: Residency.STRIPE}, {IS: Residency.STRIPE}),
    IS: ({}, {OS: Residency.STRIPE}, {WS: Residency.WHOLE}),
}
PRUNED_AUX = {WS: ({}, {OS: Residency.STRIPE}),
              IS: ({}, {OS: Residency.STRIPE})}


def gemm_specs(anchors: Sequence[Stationarity] = (OS, WS, IS),
               prune_with_observations: bool = True) -> List[DataflowSpec]:
    """The GEMM candidate specs at the compiled block."""
    out = []
    for anchor in anchors:
        variants = GEMM_AUX[anchor]
        if prune_with_observations and anchor in PRUNED_AUX:
            variants = PRUNED_AUX[anchor]
        for aux in variants:
            out.append(DataflowSpec(anchor=anchor, aux=aux,
                                    aux_priority=tuple(aux),
                                    block=matmul_df.BLOCK))
    return out


def _candidates(problem, specs: Sequence[DataflowSpec],
                hw: cost_model.HardwareSpec, walk_of) -> List[Candidate]:
    """The specs whose plans do not raise, each with its estimate and the
    bytes its CTAs load."""
    out = []
    for spec in specs:
        try:
            w = walk_of(problem, spec)
        except ValueError:
            continue
        out.append(Candidate(spec, cost_model.walk_seconds(w, hw), w.fetched,
                             True))
    return out


def enumerate_candidates(
    problem: GemmProblem,
    hw: cost_model.HardwareSpec = cost_model.H100,
    anchors: Sequence[Stationarity] = (OS, WS, IS),
    prune_with_observations: bool = True,
) -> List[Candidate]:
    """Every feasible GEMM dataflow of ``problem`` (``matmul_df.plan``
    does not raise), with its estimate."""
    return _candidates(problem, gemm_specs(anchors, prune_with_observations),
                       hw, cost_model.gemm_walk)


def explore(problem, hw: cost_model.HardwareSpec = cost_model.H100,
            top: int = 5, **kw) -> List[Candidate]:
    """Ranked candidates (best first) for any registered problem type;
    extra keywords go to its enumerator."""
    cands = registration_for(problem).enumerate(problem, hw, **kw)
    return sorted(cands, key=lambda c: (c.est_seconds, c.traffic_bytes))[:top]


def best_spec(problem,
              hw: cost_model.HardwareSpec = cost_model.H100) -> DataflowSpec:
    ranked = explore(problem, hw, top=1)
    if not ranked:
        raise ValueError(f"no feasible dataflow for {problem}")
    return ranked[0].spec


# ---------------------------------------------------------------------------
# Conv: B8's anchors (its kernel reads only the anchor; OS holds nothing,
# WS a channel tile's filter, IS an image).
# ---------------------------------------------------------------------------
CONV_AUX = {OS: {IS: Residency.WHOLE}, WS: {}, IS: {}}


def conv_specs(anchors: Sequence[Stationarity] = (OS, WS, IS)
               ) -> List[DataflowSpec]:
    return [DataflowSpec(anchor=a, aux=CONV_AUX[a],
                         aux_priority=tuple(CONV_AUX[a]),
                         block=conv2d_df.BLOCK) for a in anchors]


def enumerate_conv_candidates(
    problem: ConvProblem,
    hw: cost_model.HardwareSpec = cost_model.H100,
    anchors: Sequence[Stationarity] = (OS, WS, IS),
) -> List[Candidate]:
    """Every conv anchor ``conv2d_df.plan`` does not refuse."""
    return _candidates(problem, conv_specs(anchors), hw,
                       cost_model.conv_walk)


# ---------------------------------------------------------------------------
# Binary: B9's anchors (the basic OS tiles, the WS/IS walks).
# ---------------------------------------------------------------------------
def binary_specs(anchors: Sequence[Stationarity] = (OS, WS, IS)
                 ) -> List[DataflowSpec]:
    return [DataflowSpec.basic(a, block=binary_mm.BLOCK) for a in anchors]


def enumerate_binary_candidates(
    problem: BinaryProblem,
    hw: cost_model.HardwareSpec = cost_model.H100,
    anchors: Sequence[Stationarity] = (OS, WS, IS),
) -> List[Candidate]:
    """Every binary anchor ``binary_mm.plan`` does not refuse."""
    return _candidates(problem, binary_specs(anchors), hw,
                       cost_model.binary_walk)


# ---------------------------------------------------------------------------
# Attention: B2 (OS) and B7 (WS) at their compiled blocks for the q dtype.
# ---------------------------------------------------------------------------
def attention_specs(problem: AttentionProblem,
                    anchors: Sequence[Stationarity] = (OS, WS)
                    ) -> List[DataflowSpec]:
    if problem.dtype not in ("bfloat16", "float32"):
        return []
    dtype = cost_model.TORCH_DTYPES[problem.dtype]
    blocks = {OS: attention_df.FLASH_BLOCKS, WS: attention_df.KV_BLOCKS}
    return [DataflowSpec.basic(a, block=blocks[a][dtype] + (problem.d,))
            for a in anchors]


def enumerate_attention_candidates(
    problem: AttentionProblem,
    hw: cost_model.HardwareSpec = cost_model.H100,
    anchors: Sequence[Stationarity] = (OS, WS),
) -> List[Candidate]:
    """B2 and B7 where their kernels are built for ``problem``: its
    d_head in ``attention_df.HEAD_DIMS`` and its q dtype a compiled one
    (B7's bf16 cluster plan holds for every shape)."""
    return _candidates(problem, attention_specs(problem, anchors), hw,
                       cost_model.attention_walk)


# ---------------------------------------------------------------------------
# Measurement: the public ops, timed.
# ---------------------------------------------------------------------------
def measure(fn: Callable[[], object], device="cpu", iters: int = 15,
            warmup: int = 2) -> float:
    """Seconds per call of ``fn``: on a CUDA device the median of
    ``iters`` CUDA-event timings, each after a 256 MiB write that flushes
    the L2 (``bench.common.Timer``); on the CPU the mean over ``iters``
    calls by the host clock."""
    device = torch.device(device)
    if device.type == "cuda":
        return _timer(device).ms(fn, iters=iters) * 1e-3
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


@functools.lru_cache(maxsize=None)
def _timer(device: torch.device):
    """One timer (and its flush buffer) a card."""
    from repro_torch.bench.common import Timer

    return Timer(device)


def _rank(calls, device, iters: int) -> List[Tuple[DataflowSpec, float]]:
    timed = [(spec, measure(fn, device, iters)) for spec, fn in calls]
    return sorted(timed, key=lambda sr: sr[1])


def _gen(device, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def gemm_calls(problem: GemmProblem, specs: Sequence[DataflowSpec],
               device="cpu", seed: int = 0):
    """(spec, call) pairs running each spec through ``ops.matmul`` (for
    packed weights ``ops.matmul_packed``) on operands of the problem's
    dtype drawn from ``seed``."""
    from repro_torch.kernels import ops, pack

    gen = _gen(device, seed)
    dtype = cost_model.TORCH_DTYPES[problem.in_dtype]
    m, k, n = problem.m, problem.k, problem.n
    if dtype == torch.int8:
        a = torch.randint(-127, 128, (m, k), generator=gen, device=device,
                          dtype=torch.int8)
        b = torch.randint(-8, 8, (k, n), generator=gen, device=device,
                          dtype=torch.int8)
        if problem.weight_bits is not None:
            pw = pack.pack_int8(b, torch.ones(1, n, device=device),
                                bits=problem.weight_bits)
            return [(s, lambda s=s: ops.matmul_packed(a, pw, spec=s))
                    for s in specs]
    else:
        a = torch.randn(m, k, generator=gen, device=device).to(dtype)
        b = (torch.randn(k, n, generator=gen, device=device)
             * k ** -0.5).to(dtype)
    return [(s, lambda s=s: ops.matmul(a, b, spec=s)) for s in specs]


def conv_calls(problem: ConvProblem, specs: Sequence[DataflowSpec],
               device="cpu", seed: int = 0):
    """(spec, call) pairs running each spec through ``ops.conv2d``."""
    from repro_torch.kernels import ops

    gen = _gen(device, seed)
    dtype = cost_model.TORCH_DTYPES[problem.in_dtype]
    xs = (problem.n, problem.ih, problem.iw, problem.cin)
    ws = (problem.fh, problem.fw, problem.cin, problem.cout)
    if dtype == torch.int8:
        x = torch.randint(-8, 9, xs, generator=gen, device=device,
                          dtype=torch.int8)
        w = torch.randint(-8, 9, ws, generator=gen, device=device,
                          dtype=torch.int8)
    else:
        x = torch.randn(xs, generator=gen, device=device).to(dtype)
        w = torch.randn(ws, generator=gen, device=device).to(dtype)
    return [(s, lambda s=s: ops.conv2d(x, w, stride=problem.s, spec=s))
            for s in specs]


def binary_calls(problem: BinaryProblem, specs: Sequence[DataflowSpec],
                 device="cpu", seed: int = 0):
    """(spec, call) pairs running each spec through ``ops.binary_matmul``
    on random words."""
    from repro_torch.kernels import ops

    gen = _gen(device, seed)
    words = dict(generator=gen, device=device, dtype=torch.int32)
    a = torch.randint(-2 ** 31, 2 ** 31 - 1, (problem.m, problem.kp), **words)
    b = torch.randint(-2 ** 31, 2 ** 31 - 1, (problem.kp, problem.n), **words)
    return [(s, lambda s=s: ops.binary_matmul(a, b, problem.n_bits, spec=s))
            for s in specs]


def attention_calls(problem: AttentionProblem,
                    specs: Sequence[DataflowSpec], device="cpu",
                    seed: int = 0):
    """(spec, call) pairs running each spec through ``ops.attention`` on
    ``rows`` batch rows (one for a uniform batch), int8 K/V with
    per-position scales for an int8 cache."""
    from repro_torch.kernels import ops

    gen = _gen(device, seed)
    b = problem.rows
    dtype = cost_model.TORCH_DTYPES[problem.dtype]
    q = torch.randn(b, problem.bh // b, problem.sq, problem.d,
                    generator=gen, device=device).to(dtype)
    kv_shape = (b, problem.bh_kv // b, problem.skv, problem.d)
    kw = {}
    if problem.kv_quantized:
        k, v = (torch.randint(-127, 128, kv_shape, generator=gen,
                              device=device, dtype=torch.int8)
                for _ in range(2))
        kw["k_scale"], kw["v_scale"] = (torch.full(
            kv_shape[:-1] + (1,), 1 / 127, device=device) for _ in range(2))
    else:
        k, v = (torch.randn(kv_shape, generator=gen, device=device).to(dtype)
                for _ in range(2))
    if problem.kv_len is not None:
        kw["kv_len"] = problem.kv_len
    return [(s, lambda s=s: ops.attention(
        q, k, v, causal=problem.causal, window=problem.window, spec=s,
        group=problem.group, **kw)) for s in specs]


def empirical_rank(problem: GemmProblem, specs: Sequence[DataflowSpec],
                   device="cpu", iters: int = 5
                   ) -> List[Tuple[DataflowSpec, float]]:
    """Each spec run and timed (``measure``), fastest first."""
    return _rank(gemm_calls(problem, specs, device), device, iters)


def _measure_conv(problem: ConvProblem, specs: Sequence[DataflowSpec],
                  device="cpu", iters: int = 5):
    return _rank(conv_calls(problem, specs, device), device, iters)


def _measure_binary(problem: BinaryProblem, specs: Sequence[DataflowSpec],
                    device="cpu", iters: int = 5):
    return _rank(binary_calls(problem, specs, device), device, iters)


def _measure_attention(problem: AttentionProblem,
                       specs: Sequence[DataflowSpec], device="cpu",
                       iters: int = 5):
    return _rank(attention_calls(problem, specs, device), device, iters)


def candidate_calls(problem, specs: Sequence[DataflowSpec], device="cpu",
                    seed: int = 0):
    """(spec, call) pairs for any registered problem type."""
    return {GemmProblem: gemm_calls, ConvProblem: conv_calls,
            BinaryProblem: binary_calls,
            AttentionProblem: attention_calls}[type(problem)](
        problem, specs, device, seed)


def _late_bound(name: str) -> Callable:
    """A measure hook resolved through this module's globals when called,
    so a test can patch ``empirical_rank``/``_measure_*``."""
    def hook(problem, specs, device="cpu", iters: int = 5):
        return globals()[name](problem, specs, device=device, iters=iters)
    return hook


def _packing(bits: Optional[int]) -> str:
    return "wb-" if bits is None else f"wb{bits}"


register_problem(ProblemRegistration(
    kind="gemm", problem_cls=GemmProblem,
    key_fields=lambda p: (str(p.m), str(p.k), str(p.n), p.in_dtype,
                          p.out_dtype, p.acc_dtype, _packing(p.weight_bits)),
    enumerate=enumerate_candidates,
    time_estimate=cost_model.gemm_time_estimate,
    footprint=cost_model.gemm_footprint_on_card,
    measure=_late_bound("empirical_rank"),
))

register_problem(ProblemRegistration(
    kind="conv", problem_cls=ConvProblem,
    key_fields=lambda p: (str(p.n), str(p.ih), str(p.iw), str(p.fh),
                          str(p.fw), str(p.s), str(p.cin), str(p.cout),
                          p.in_dtype, p.out_dtype, _packing(p.weight_bits)),
    enumerate=enumerate_conv_candidates,
    time_estimate=cost_model.conv_time_estimate,
    footprint=cost_model.conv_footprint_on_card,
    measure=_late_bound("_measure_conv"),
))

register_problem(ProblemRegistration(
    kind="bin", problem_cls=BinaryProblem,
    key_fields=lambda p: (str(p.m), str(p.kp), str(p.n), str(p.n_bits),
                          p.out_dtype),
    enumerate=enumerate_binary_candidates,
    time_estimate=cost_model.binary_time_estimate,
    footprint=cost_model.binary_footprint_on_card,
    measure=_late_bound("_measure_binary"),
))

register_problem(ProblemRegistration(
    kind="attn", problem_cls=AttentionProblem,
    key_fields=lambda p: (str(p.bh), str(p.sq), str(p.skv), str(p.d),
                          str(p.group), f"c{int(p.causal)}",
                          "w-" if p.window is None else f"w{p.window}",
                          p.dtype,
                          "kl-" if p.kv_len is None else f"kl{p.kv_len}",
                          "kd-" if p.kv_dtype is None else f"kd{p.kv_dtype}",
                          f"r{p.rows}"),
    enumerate=enumerate_attention_candidates,
    time_estimate=cost_model.attention_time_estimate,
    footprint=cost_model.attention_footprint_on_card,
    measure=_late_bound("_measure_attention"),
))
