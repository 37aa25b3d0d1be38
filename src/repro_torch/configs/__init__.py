"""Architecture registry of the port.

``get(name)`` / ``get_smoke(name)`` resolve a config.  Only qwen3-1.7b
is ported; the JAX package's other nine configs are queued in
ROADMAP.md (A3).
"""
from __future__ import annotations

from typing import List

from repro_torch.configs import qwen3_1_7b
from repro_torch.configs.base import ArchConfig

_MODULES = {"qwen3-1.7b": qwen3_1_7b}

ARCH_NAMES: List[str] = list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(
            f"unknown or not yet ported arch {name!r}; the port has "
            f"{ARCH_NAMES} (the other configs are queued in ROADMAP.md A3)")
    return _MODULES[name]


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE
