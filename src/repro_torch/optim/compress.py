"""Gradient compression: int8 quantized all-reduce with error feedback.

The port's copy of ``repro/optim/compress.py``: ``quantize_grad`` and
``dequantize_grad`` (the codes and the scale equal the reference's bit
for bit: ``core.quant``), and ``compressed_psum``, which all-reduces
int8 codes over a data-parallel group (``torch.distributed`` functional
collectives: a ``ProcessGroup``, or ``(DeviceMesh, dim)``) and carries
each rank's quantization error into its next step (error feedback keeps
the scheme unbiased over time).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import quant


def quantize_grad(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization -> (q, scale)."""
    return quant.symmetric_int8(g)


def dequantize_grad(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grads: Dict[str, Any], group,
                    residuals: Optional[Dict[str, Any]] = None
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """int8-compressed gradient all-reduce with error feedback, on every
    tensor leaf of the nested dict ``grads``.

    Per leaf: quantize (grad + residual) to find its scale, all-reduce
    MAX the scale so every rank shares one, requantize with it, all-reduce
    SUM the int8 payload as int32 (no overflow), divide by the group's
    size, and keep the local quantization error as the next residual.
    Returns (reduced grads in their dtypes, new float32 residuals)."""
    import torch.distributed._functional_collectives as funcol

    def one(g, r):
        target = g.float() + (0.0 if r is None else r)
        _, scale = quantize_grad(target)
        # one conservative scale, so dequantizing the summed codes is exact
        scale = funcol.wait_tensor(funcol.all_reduce(scale, "max", group))
        q = torch.clamp(torch.round(target / scale), -127, 127).to(
            torch.int8)
        new_r = target - q.float() * scale           # local error feedback
        summed = funcol.wait_tensor(funcol.all_reduce(q.to(torch.int32),
                                                      "sum", group))
        n = funcol.wait_tensor(funcol.all_reduce(
            torch.ones((), dtype=torch.int32, device=g.device), "sum",
            group))
        return (summed.float() * scale / n.float()).to(g.dtype), new_r

    out, res = {}, {}
    for k, g in grads.items():
        r = None if residuals is None else residuals[k]
        if isinstance(g, dict):
            out[k], res[k] = compressed_psum(g, group, r)
        else:
            out[k], res[k] = one(g, r)
    return out, res
