"""Code generator: DataflowSpec + layer config -> a callable over the
port's kernels, and standalone Python source that pins the dataflow.

The twin of ``repro/core/codegen.py``.  ``build_matmul`` /
``build_conv2d`` return callables over ``matmul_df.matmul_df`` (B1) and
``ops.conv2d`` (B8).  ``generate_source`` emits a module that imports
only ``repro_torch``: it pins ``SPEC`` field for field (so executing it
gives ``ns["SPEC"] == spec``) and defines ``kernel(a, b)``, which checks
the shapes and launches ``matmul_df(a, b, SPEC)`` on the inputs' device.
The emitted text is Python, as the reference's is: the reference's
generator writes a Python module that pins a spec and calls its Pallas
kernel, and the CUDA source that the spec selects is the compiled
library under ``kernels/csrc``, which the plan in the header names.
The header keeps the reference's fields (problem, anchor and grid
order, aux, blocks, and the cost model's reads and writes); in place of
the TPU's VMEM claim it states what ``matmul_df.plan`` launches on the
card: the tile kernel or cluster walk, the cluster size and the shared
memory a block takes.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import cost_model
from repro_torch.core.dataflow import (ConvProblem, DataflowSpec,
                                       GemmProblem, IS, OS, WS)

# The grid order each anchor keeps (the reference's ``ANCHOR_GRID_ORDER``):
# the anchored operand's tile indices outermost, the reduction inside.
ANCHOR_GRID_ORDER = {
    OS: ("m", "n", "k"),
    WS: ("k", "n", "m"),
    IS: ("m", "k", "n"),
}


def _fn_name(prefix: str, spec: DataflowSpec) -> str:
    return f"{prefix}_{spec.name.replace('+', '_').replace(':', '_')}"


def build_matmul(problem: GemmProblem, spec: DataflowSpec
                 ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """A callable realizing ``spec`` on ``problem`` through B1."""
    from repro_torch.kernels import matmul_df

    def fn(a, b):
        return matmul_df.matmul_df(a, b, spec)

    fn.__name__ = _fn_name("matmul", spec)
    return fn


def build_conv2d(problem: ConvProblem, spec: DataflowSpec
                 ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """A callable realizing ``spec`` on ``problem`` through B8."""
    from repro_torch.kernels import ops

    def fn(x, w):
        return ops.conv2d(x, w, stride=problem.s, spec=spec)

    fn.__name__ = _fn_name("conv2d", spec)
    return fn


def card_plan(problem: GemmProblem, spec: DataflowSpec) -> str:
    """One line: what ``matmul_df.plan`` launches for ``spec`` at
    ``problem`` (kernel, tile kernel or walk, cluster, shared memory),
    or why it refuses."""
    from repro_torch.kernels import matmul_df

    try:
        pl = matmul_df.plan(spec, problem.m, problem.k, problem.n,
                            cost_model.TORCH_DTYPES[problem.in_dtype],
                            problem.weight_bits)
    except ValueError as e:
        return f"refused ({e})"
    return (f"{pl.kernel} tile={pl.tile_kernel or pl.kernel} "
            f"cluster={pl.cluster or 1} ctas={pl.ctas} "
            f"smem={pl.smem_bytes} B")


_SOURCE_TEMPLATE = '''\
"""Generated by repro_torch.core.codegen — dataflow: {name}.

problem : ({m} x {k}) @ ({k} x {n}), in={in_dtype}, out={out_dtype}
anchor  : {anchor} (grid order {order})
aux     : {aux}
blocks  : bm={bm} bk={bk} bn={bn}
plan    : {plan}
traffic : reads={reads} B, writes={writes} B  (cost-model estimate)
"""
import torch
from repro_torch.core.dataflow import DataflowSpec, Residency, Stationarity
from repro_torch.kernels.matmul_df import matmul_df

SPEC = DataflowSpec(
    anchor=Stationarity("{anchor}"),
    aux={aux_literal},
    aux_priority={aux_priority_literal},
    block=({bm}, {bk}, {bn}),
)


def kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """({m}, {k}) @ ({k}, {n}) under the {name} dataflow, on the
    inputs' device."""
    assert tuple(a.shape) == ({m}, {k}) and tuple(b.shape) == ({k}, {n}), \\
        (a.shape, b.shape)
    return matmul_df(a, b, SPEC)
'''


def generate_source(problem: GemmProblem, spec: DataflowSpec) -> str:
    """Standalone Python source implementing the dataflow."""
    t = cost_model.gemm_traffic(problem, spec)
    aux_literal = "{" + ", ".join(
        f'Stationarity("{st.value}"): Residency("{res.value}")'
        for st, res in spec.aux) + "}"
    aux_pri = "(" + ", ".join(
        f'Stationarity("{st.value}")' for st in spec.aux_priority
    ) + ("," if len(spec.aux_priority) == 1 else "") + ")"
    return _SOURCE_TEMPLATE.format(
        name=spec.name,
        m=problem.m, k=problem.k, n=problem.n,
        in_dtype=problem.in_dtype, out_dtype=problem.out_dtype,
        anchor=spec.anchor.value,
        order="".join(ANCHOR_GRID_ORDER[spec.anchor]),
        aux=dict(spec.aux) or "none (basic dataflow)",
        bm=spec.block[0], bk=spec.block[1], bn=spec.block[2],
        plan=card_plan(problem, spec),
        reads=sum(t.reads.values()), writes=sum(t.writes.values()),
        aux_literal=aux_literal,
        aux_priority_literal=aux_pri,
    )


def describe_plan(problem: GemmProblem, spec: DataflowSpec) -> str:
    """Human-readable dataflow plan (the generated schedule)."""
    t = cost_model.gemm_traffic(problem, spec)
    lines = [
        f"dataflow {spec.name}: anchor={spec.anchor.value}, "
        f"grid order {'>'.join(ANCHOR_GRID_ORDER[spec.anchor])}",
        f"  blocks bm={spec.block[0]} bk={spec.block[1]} bn={spec.block[2]}",
    ]
    for st in (IS, WS, OS):
        res = spec.residency(st)
        r = t.reads.get(st, 0)
        w = t.writes.get(st, 0)
        lines.append(
            f"  {st.value:7s}: {res.value:9s} reads={r:>14,d}B "
            f"writes={w:>14,d}B")
    try:
        foot = f"{cost_model.gemm_footprint_on_card(problem, spec):,d} B"
    except ValueError:
        foot = "refused by the planner"
    lines.append(f"  total HBM traffic {t.total:,d} B; shared memory a "
                 f"block {foot}")
    lines.append(f"  card plan: {card_plan(problem, spec)}")
    return "\n".join(lines)
