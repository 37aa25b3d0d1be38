"""End-to-end network planning (paper §IV-B/C), on the port's conv kernel.

The twin of ``repro/core/network.py``: for a whole conv network (a list
of layers, with the depthwise and grouped variants the paper covers) it
explores each layer's dataflows (``core.explorer`` on the layer's
per-group ``ConvProblem``, ranked by the Hopper cost model over B8's
plans), runs the chain DP of ``core.layout`` over the layers' options
with their transition costs, and returns a plan: a spec a layer, each
realizable through ``ops.conv2d``.  The reference explores each layer's
implicit-GEMM view over its TPU blocks; the port's convs run on B8,
whose planner decides which anchors fit, so the port explores the conv.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from repro_torch.core import cost_model, explorer, layout
from repro_torch.core.dataflow import ConvProblem, DataflowSpec


@dataclasses.dataclass(frozen=True)
class ConvLayerSpec:
    """One conv layer of a network: plain, depthwise (``groups == cin ==
    cout``) or grouped."""

    ih: int
    iw: int
    fh: int
    fw: int
    s: int
    cin: int
    cout: int
    groups: int = 1
    in_dtype: str = "int8"

    def problems(self) -> ConvProblem:
        """The per-group conv (the groups share one dataflow)."""
        if self.cin % self.groups or self.cout % self.groups:
            raise ValueError(f"groups {self.groups} must divide channels")
        return ConvProblem(ih=self.ih, iw=self.iw, fh=self.fh, fw=self.fw,
                           s=self.s, cin=self.cin // self.groups,
                           cout=self.cout // self.groups,
                           in_dtype=self.in_dtype)

    @property
    def is_depthwise(self) -> bool:
        return self.groups == self.cin == self.cout


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    layer: ConvLayerSpec
    spec: DataflowSpec
    layout: str
    est_seconds: float
    traffic_bytes: int


@dataclasses.dataclass(frozen=True)
class NetworkPlan:
    layers: List[LayerPlan]
    total_seconds: float

    def describe(self) -> str:
        lines = []
        for i, lp in enumerate(self.layers):
            tag = "dw" if lp.layer.is_depthwise else (
                f"g{lp.layer.groups}" if lp.layer.groups > 1 else "conv")
            lines.append(
                f"  L{i:02d} {tag:5s} {lp.layer.ih}x{lp.layer.iw} "
                f"f{lp.layer.fh} s{lp.layer.s} "
                f"{lp.layer.cin}->{lp.layer.cout}: {lp.spec.name:22s} "
                f"{lp.est_seconds * 1e6:9.1f}us {lp.layout}")
        lines.append(f"  total: {self.total_seconds * 1e6:.1f}us (est.)")
        return "\n".join(lines)


def plan_layer(layer: ConvLayerSpec,
               hw: cost_model.HardwareSpec = cost_model.H100,
               top: int = 3) -> List[Tuple[DataflowSpec, float, int]]:
    """The best dataflows of one layer: (spec, est. seconds, bytes), the
    groups run one after another with the same dataflow (grouping shrinks
    K and N, which moves what fits on chip)."""
    out = []
    for c in explorer.explore(layer.problems(), hw, top=top):
        out.append((c.spec, c.est_seconds * layer.groups,
                    c.traffic_bytes * layer.groups))
    return out


def optimize_network(net: Sequence[ConvLayerSpec],
                     hw: cost_model.HardwareSpec = cost_model.H100,
                     flexible_writes: bool = True,
                     layouts: Sequence[str] = ("NHWC",)) -> NetworkPlan:
    """Each layer's dataflows explored, then the chain DP over (layout,
    dataflow); with ``flexible_writes`` (the paper's finding) transitions
    are free and the DP is a per-layer argmin."""
    per_layer_options: List[List[layout.LayerOption]] = []
    per_layer_specs: List[List[DataflowSpec]] = []
    for lyr in net:
        conv = lyr.problems()
        out_bytes = conv.E * lyr.cout * cost_model.dtype_bytes(
            conv.out_dtype)
        opts, specs = [], []
        for spec, est_s, _ in plan_layer(lyr, hw):
            for lo in layouts:
                opts.append(layout.LayerOption(layout=lo, dataflow=spec.name,
                                               cost=est_s,
                                               out_bytes=out_bytes))
                specs.append(spec)
        per_layer_options.append(opts)
        per_layer_specs.append(specs)
    total, choice = layout.optimize_chain(per_layer_options, flexible_writes)
    plans = [LayerPlan(layer=lyr, spec=specs[j], layout=opts[j].layout,
                       est_seconds=opts[j].cost, traffic_bytes=0)
             for lyr, opts, specs, j in zip(net, per_layer_options,
                                            per_layer_specs, choice)]
    return NetworkPlan(layers=plans, total_seconds=total)


# The paper's Fig. 8 network bodies, with the depthwise and grouped
# variants of its §IV scope.
def resnet18_int8() -> List[ConvLayerSpec]:
    body = [(56, 3, 1, 64, 64, 1, 4), (56, 3, 2, 64, 128, 1, 1),
            (28, 3, 1, 128, 128, 1, 3), (28, 3, 2, 128, 256, 1, 1),
            (14, 3, 1, 256, 256, 1, 3), (14, 3, 2, 256, 512, 1, 1),
            (7, 3, 1, 512, 512, 1, 3)]
    spec = []
    for hw_, f, s, cin, cout, g, rep in body:
        spec.extend([ConvLayerSpec(hw_, hw_, f, f, s, cin, cout, g)] * rep)
    return spec


def mobilenet_block_int8(hw_: int, cin: int, cout: int,
                         s: int = 1) -> List[ConvLayerSpec]:
    """Depthwise-separable block: a depthwise 3x3, then a pointwise 1x1."""
    out = (hw_ - 3) // s + 1
    return [ConvLayerSpec(hw_, hw_, 3, 3, s, cin, cin, groups=cin),
            ConvLayerSpec(out, out, 1, 1, 1, cin, cout, groups=1)]


def shufflenet_stage_int8(hw_: int, c: int, groups: int = 4,
                          rep: int = 3) -> List[ConvLayerSpec]:
    """Shuffled grouped convolutions (the paper's §IV scope)."""
    out = []
    for _ in range(rep):
        out.append(ConvLayerSpec(hw_, hw_, 1, 1, 1, c, c, groups=groups))
        out.append(ConvLayerSpec(hw_, hw_, 3, 3, 1, c, c, groups=c))
        out.append(ConvLayerSpec(hw_ - 2, hw_ - 2, 1, 1, 1, c, c,
                                 groups=groups))
        hw_ -= 2
    return out
