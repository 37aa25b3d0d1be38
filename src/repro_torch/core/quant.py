"""Symmetric int8 quantization, the port's copy of ``repro/core/quant.py``.

Every int8 tier uses the same zero-point-free scheme:

    amax  = max(|x|)  over the reduction axes
    scale = amax / 127        (1.0 where amax == 0, so dequant is exact)
    q     = clip(round(x / scale), -127, 127)  as int8

amax and the division are in float32, and ``torch.round`` rounds half
to even as ``jnp.round`` does, so q and scale equal the JAX package's
bit for bit.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

Axis = Union[None, int, Tuple[int, ...]]


def symmetric_int8(x: torch.Tensor, axis: Axis = None,
                   keepdims: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of ``x`` -> ``(q, scale)``.

    ``axis=None`` quantizes per tensor (a 0-d float32 scale); an int or
    tuple reduces amax over those dims, kept as size-1 dims when
    ``keepdims`` so the scale broadcasts back against ``q``.
    """
    x32 = x.float()
    if axis is None:
        amax = x32.abs().amax()
    else:
        amax = x32.abs().amax(dim=axis, keepdim=keepdims)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`symmetric_int8` up to the round-trip bound."""
    return (q.float() * scale).to(dtype)
