"""Device resolution for the port's entry points.

Entry points (``serve.engine.Engine``, ``models.lm.init_model``,
``launch.serve``) run on the card by default.  Without CUDA they raise
unless the caller asks for the CPU with ``device="cpu"`` (as the tests
do); there is no silent fallback to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` -> the CUDA card; ``"cpu"``/``"cuda[:n]"`` as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass device='cpu' to run its plain PyTorch path")
    return dev
