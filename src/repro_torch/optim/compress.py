"""Gradient compression: symmetric per-tensor int8 quantization.

The port's copy of ``repro/optim/compress.py``'s ``quantize_grad`` and
``dequantize_grad`` (the codes and the scale equal the reference's bit
for bit: ``core.quant``).  ``compressed_psum``, the int8 all-reduce with
error feedback, is a collective over a data-parallel group: it waits for
ROADMAP A14 (the multi-device stack on ``torch.distributed``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import quant


def quantize_grad(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization -> (q, scale)."""
    return quant.symmetric_int8(g)


def dequantize_grad(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(*args, **kwargs):
    raise NotImplementedError(
        "compressed_psum is an all-reduce over a data-parallel group: it "
        "waits for ROADMAP A14 (multi-device on torch.distributed)")
