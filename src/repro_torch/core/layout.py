"""End-to-end layout/dataflow chain optimization (paper §IV-C).

The twin of ``repro/core/layout.py``: given a chain of layers, each with
several (layout, dataflow) options of known cost, pick one option a
layer so that the total cost, layout transformations between successive
layers included, is least (dynamic programming).  The paper observes
that reducing along fw/fh/ic lets a layer write its outputs in any
layout, so most transitions are free: ``transition_cost``'s
``flexible_writes``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Sequence, Tuple

from repro_torch.core.cost_model import H100


@dataclasses.dataclass(frozen=True)
class LayerOption:
    """One (memory layout, dataflow) implementation of a layer."""

    layout: str          # e.g. "NHWC"
    dataflow: str        # DataflowSpec.name
    cost: float          # the layer's cost (seconds or bytes)
    out_bytes: int = 0   # its activation's bytes (drive a relayout's cost)


def transition_cost(prev: LayerOption, nxt: LayerOption,
                    flexible_writes: bool = True,
                    hbm_bw: float = H100.hbm_bw) -> float:
    """Seconds to turn ``prev``'s output layout into ``nxt``'s input
    layout: free when they match or writes are flexible (the paper's
    finding), else one read and one write of the activation."""
    if prev.layout == nxt.layout or flexible_writes:
        return 0.0
    return 2.0 * prev.out_bytes / hbm_bw


def optimize_chain(layers: Sequence[Sequence[LayerOption]],
                   flexible_writes: bool = True) -> Tuple[float, List[int]]:
    """The DP over the chain: (total cost, option index a layer)."""
    if not layers:
        return 0.0, []
    dp = [opt.cost for opt in layers[0]]
    back: List[List[int]] = []
    for li in range(1, len(layers)):
        ndp, nback = [], []
        for opt in layers[li]:
            best_j, best_c = 0, float("inf")
            for j, prev_opt in enumerate(layers[li - 1]):
                c = dp[j] + transition_cost(prev_opt, opt, flexible_writes)
                if c < best_c:
                    best_c, best_j = c, j
            ndp.append(best_c + opt.cost)
            nback.append(best_j)
        dp = ndp
        back.append(nback)
    idx = int(min(range(len(dp)), key=dp.__getitem__))
    total = dp[idx]
    choice = [idx]
    for nback in reversed(back):
        idx = nback[idx]
        choice.append(idx)
    choice.reverse()
    return total, choice


def brute_force_chain(layers: Sequence[Sequence[LayerOption]],
                      flexible_writes: bool = True
                      ) -> Tuple[float, List[int]]:
    """Every combination tried: the reference ``optimize_chain`` is held
    against."""
    best = (float("inf"), [])
    for combo in itertools.product(*[range(len(l)) for l in layers]):
        cost = sum(layers[i][j].cost for i, j in enumerate(combo))
        for i in range(1, len(combo)):
            cost += transition_cost(layers[i - 1][combo[i - 1]],
                                    layers[i][combo[i]], flexible_writes)
        if cost < best[0]:
            best = (cost, list(combo))
    return best
