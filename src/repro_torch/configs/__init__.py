"""Architecture registry of the port.

``get(name)`` / ``get_smoke(name)`` resolve a config: the port's own
copies of the JAX package's dense decoders (qwen3-1.7b, minicpm-2b,
mistral-nemo-12b, minitron-8b), chameleon-34b, which the JAX package
serves as a dense backbone (family ``vlm``: image tokens are vocab ids),
the MoE decoders (qwen3-moe-235b-a22b, moonshot-v1-16b-a3b), the
attention-free SSM mamba2-780m, the hybrid hymba-1.5b (attention and
SSM heads in parallel, sliding windows but on three layers) and the
encoder-decoder whisper-tiny (family ``audio``: its conv frontend
stubbed, the encoder fed frame embeddings).  Every config of the JAX
package has its twin; ``QUEUED`` names any that waits for a ROADMAP
entry (none now).  ``cell_skipped`` and ``all_cells`` enumerate the
(arch x shape) cells of the dry-run, as the reference's registry does.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.configs import (chameleon_34b, hymba_1_5b, mamba2_780m,
                                 minicpm_2b, minitron_8b, mistral_nemo_12b,
                                 moonshot_v1_16b_a3b, qwen3_1_7b,
                                 qwen3_moe_235b_a22b, whisper_tiny)
from repro_torch.configs.base import (ArchConfig, ShapeConfig, SHAPES,
                                      input_specs)

_MODULES = {
    "minicpm-2b": minicpm_2b,
    "mistral-nemo-12b": mistral_nemo_12b,
    "qwen3-1.7b": qwen3_1_7b,
    "minitron-8b": minitron_8b,
    "chameleon-34b": chameleon_34b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "mamba2-780m": mamba2_780m,
    "hymba-1.5b": hymba_1_5b,
    "whisper-tiny": whisper_tiny,
}
# The JAX package's other configs, by the ROADMAP entry that ports them.
QUEUED: dict = {}

ARCH_NAMES: List[str] = list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        queued = ", ".join(f"{n} ({a})" for n, a in QUEUED.items())
        raise KeyError(
            f"unknown or not yet ported arch {name!r}; the port has "
            f"{ARCH_NAMES}; queued in ROADMAP.md: {queued or 'none'}")
    return _MODULES[name]


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE


def cell_skipped(arch: str, shape: str) -> Tuple[bool, str]:
    """(skipped?, reason) for an (arch x shape) dry-run cell."""
    cfg = get(arch)
    if shape == "long_500k" and not cfg.subquadratic:
        return True, ("full quadratic attention at 512k context "
                      "(per assignment: run only SSM/hybrid/linear-attn)")
    return False, ""


def all_cells(include_skipped: bool = False):
    """Every (arch, shape, skipped, reason) of the assignment (40 cells)."""
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            skipped, reason = cell_skipped(arch, shape)
            if skipped and not include_skipped:
                continue
            yield arch, shape, skipped, reason
