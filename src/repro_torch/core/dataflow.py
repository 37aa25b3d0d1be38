"""Dataflow specifications, as far as the port's kernels use them.

A copy of the part of ``repro/core/dataflow.py`` that the port's
``kernels.ops`` reads: the stationarity names and anchor constants, the
``Epilogue`` a GEMM fuses into its output write, and ``DataflowSpec``.
The port keeps its own kernel registry here (``register_kernel``): one
row per hand-written CUDA kernel, saying which TPU kernel it replaces,
where its source lives and which dataflow and block it is compiled for.
It is separate from the JAX package's problem registry, which a process
importing both packages must not see overwritten.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Tuple


class Stationarity(str, enum.Enum):
    """Operand classes whose reuse a dataflow can exploit (paper §II/§III)."""

    INPUT = "input"
    WEIGHT = "weight"
    OUTPUT = "output"

    def __repr__(self) -> str:
        return self.value


class Residency(str, enum.Enum):
    """How an auxiliary operand is held on chip: re-fetched per step,
    one stripe resident, or the whole operand resident."""

    STREAMED = "streamed"
    STRIPE = "stripe"
    WHOLE = "whole"

    def __repr__(self) -> str:
        return self.value


IS = Stationarity.INPUT
WS = Stationarity.WEIGHT
OS = Stationarity.OUTPUT

EPILOGUE_ACTIVATIONS = ("relu", "gelu", "silu")


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Element-wise tail fused into a kernel's output write:
    ``y = act(scale * acc + bias) + residual``, each stage optional, in
    float32 whatever the accumulator type."""

    bias: bool = False
    activation: Optional[str] = None
    scale: bool = False
    residual: bool = False

    def __post_init__(self) -> None:
        if (self.activation is not None
                and self.activation not in EPILOGUE_ACTIVATIONS):
            raise ValueError(
                f"activation {self.activation!r} not in "
                f"{EPILOGUE_ACTIVATIONS}")

    @property
    def is_noop(self) -> bool:
        return not (self.bias or self.activation or self.scale
                    or self.residual)


@dataclasses.dataclass(frozen=True)
class DataflowSpec:
    """A dataflow for a GEMM-like tiled kernel: the anchoring
    stationarity (which operand's tile stays on chip across the inner
    loop), the residency of the others, and the tile (the GEMM's
    ``(bm, bk, bn)``; attention's ``(bq, bkv, 1)``)."""

    anchor: Stationarity
    aux: Tuple[Tuple[Stationarity, Residency], ...] = ()
    block: Tuple[int, int, int] = (128, 128, 128)

    def __post_init__(self) -> None:
        aux = dict(self.aux)
        if self.anchor in aux:
            raise ValueError(f"anchor {self.anchor!r} cannot also be "
                             f"auxiliary")
        for st, res in aux.items():
            if not isinstance(st, Stationarity) \
                    or not isinstance(res, Residency):
                raise TypeError(f"bad aux entry {st!r}: {res!r}")
        object.__setattr__(self, "aux", tuple(
            sorted(aux.items(), key=lambda kv: kv[0].value)))
        if min(self.block) <= 0:
            raise ValueError(f"non-positive block {self.block}")


# ---------------------------------------------------------------------------
# The port's kernel registry.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class KernelRegistration:
    """One hand-written CUDA kernel of the port."""

    name: str                      # key of kernels._build.LAUNCHES
    source: str                    # path in the repo
    replaces: str                  # file:line of the TPU pallas_call
    spec: DataflowSpec             # the dataflow and block it is built for


_REGISTRY: Dict[str, KernelRegistration] = {}


def register_kernel(reg: KernelRegistration) -> KernelRegistration:
    _REGISTRY[reg.name] = reg
    return reg


def registered_kernels() -> Dict[str, KernelRegistration]:
    return dict(_REGISTRY)
