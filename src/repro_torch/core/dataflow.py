"""Dataflow specifications, as far as the port's kernels use them.

A copy of the part of ``repro/core/dataflow.py`` that the port's
``kernels`` and ``bench`` read: the stationarity names and anchor
constants, the ``Epilogue`` a GEMM fuses into its output write,
``DataflowSpec`` (with its residency queries and canonical dataflows),
the ``BinaryEpilogue`` a binary GEMM fuses into its flush, and the
``GemmProblem``/``ConvProblem``/``BinaryProblem`` shape records.
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
    aux_priority: Tuple[Stationarity, ...] = ()
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

    def residency(self, operand: Stationarity) -> Residency:
        """The anchored operand is held across the inner loop (STRIPE);
        the others are as ``aux`` says, STREAMED when absent."""
        if operand == self.anchor:
            return Residency.STRIPE
        return dict(self.aux).get(operand, Residency.STREAMED)

    @property
    def name(self) -> str:
        parts = [f"{self.anchor.value[0].upper()}S"]
        for st, res in self.aux:
            if res != Residency.STREAMED:
                parts.append(f"{st.value[0]}:{res.value}")
        return "+".join(parts)

    @classmethod
    def basic(cls, anchor: Stationarity, **kw) -> "DataflowSpec":
        """A basic dataflow: the anchoring stationarity only (paper §II)."""
        return cls(anchor=anchor, aux=(), aux_priority=(), **kw)

    @classmethod
    def optimized(cls, **kw) -> "DataflowSpec":
        """Paper Alg. 8: OS anchor, aux priority weight-then-input."""
        return cls(anchor=OS,
                   aux={WS: Residency.STRIPE, IS: Residency.STREAMED},
                   aux_priority=(WS, IS), **kw)


@dataclasses.dataclass(frozen=True)
class GemmProblem:
    """A GEMM-like workload: (M, K) x (K, N) -> (M, N)."""

    m: int
    k: int
    n: int


@dataclasses.dataclass(frozen=True)
class ConvProblem:
    """A direct convolution in the paper's notation (Fig. 3): ih/iw the
    input, fh/fw the filter, s the stride, cin/cout the channels, n the
    batch."""

    ih: int
    iw: int
    fh: int
    fw: int
    s: int
    cin: int
    cout: int
    n: int = 1

    @property
    def oh(self) -> int:
        return (self.ih - self.fh) // self.s + 1

    @property
    def ow(self) -> int:
        return (self.iw - self.fw) // self.s + 1

    def as_gemm(self) -> GemmProblem:
        """Implicit-GEMM view: M = n*oh*ow, K = fh*fw*cin, N = cout."""
        return GemmProblem(m=self.n * self.oh * self.ow,
                           k=self.fh * self.fw * self.cin, n=self.cout)


@dataclasses.dataclass(frozen=True)
class BinaryProblem:
    """A binary (+-1, xnor-popcount) GEMM on bit-packed operands:
    ``(M, Kp) x (Kp, N)`` over 32-bit words (32 binary channels each),
    with ``n_bits`` the true pre-packing reduction depth K
    (``n_bits <= 32 * kp``; slack bits are zero padding that cancels out
    of the ``K - 2*popcount(xor)`` identity)."""

    m: int
    kp: int
    n: int
    n_bits: int
    out_dtype: str = "int32"

    def __post_init__(self) -> None:
        if self.n_bits > 32 * self.kp:
            raise ValueError(
                f"n_bits={self.n_bits} exceeds packed depth 32*{self.kp}")

    @property
    def bit_ops(self) -> int:
        """xnor + popcount-accumulate pairs, in scalar-bit-op units."""
        return 2 * self.m * self.n_bits * self.n

    def as_gemm(self) -> GemmProblem:
        """The packed-word GEMM view."""
        return GemmProblem(m=self.m, k=self.kp, n=self.n)


@dataclasses.dataclass(frozen=True)
class BinaryEpilogue:
    """Element-wise tail fused into a binary kernel's accumulator flush:
    ``y = scale * dot + bias + residual`` in float32, each stage rounded
    on its own, then ``sign(y)`` (``y >= 0`` -> +1) when ``binarize``.
    ``scale``/``bias`` carry a folded batchnorm; ``binarize`` lets
    chained binary layers pass +-1 int8 activations instead of the int32
    accumulator."""

    scale: bool = False
    bias: bool = False
    residual: bool = False
    binarize: bool = False

    @property
    def is_noop(self) -> bool:
        return not (self.scale or self.bias or self.residual
                    or self.binarize)


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
