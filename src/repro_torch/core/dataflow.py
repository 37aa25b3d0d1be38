"""Dataflow specifications, as far as the port's kernels use them.

The port's copy of ``repro/core/dataflow.py``: the stationarity names
and anchor constants, the ``Epilogue`` a GEMM fuses into its output
write, ``DataflowSpec`` (with its residency queries and canonical
dataflows), the per-call ``SpecOverride``, the ``BinaryEpilogue`` a
binary GEMM fuses into its flush, the ``GemmProblem``/``ConvProblem``/
``BinaryProblem``/``AttentionProblem`` workload records, and the problem
registry through which ``core.explorer`` and ``core.autotune`` serve
every problem type.  ``DataflowSpec`` has no VMEM budget: each kernel is
compiled for one block, and what fits is what its planner
(``matmul_df.plan`` and the others) does not refuse.
The port also keeps a kernel registry here (``register_kernel``): one
row per hand-written CUDA kernel, saying which TPU kernel it replaces,
where its source lives and which dataflow and block it is compiled for.
Both registries are separate from the JAX package's, which a process
importing both packages must not see overwritten.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, Optional, Tuple


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

    def with_block(self, block: Tuple[int, int, int]) -> "DataflowSpec":
        return dataclasses.replace(self, block=tuple(block))


_ANCHOR_ALIASES = {
    "os": Stationarity.OUTPUT, "output": Stationarity.OUTPUT,
    "ws": Stationarity.WEIGHT, "weight": Stationarity.WEIGHT,
    "is": Stationarity.INPUT, "input": Stationarity.INPUT,
}


@dataclasses.dataclass(frozen=True)
class SpecOverride:
    """A partial per-call dataflow override for ``ops.*(spec=...)``:
    fields left ``None`` inherit from the autotuned spec of the call's
    problem, so ``SpecOverride(anchor=WS)`` forces the anchor and keeps
    the rest.  ``anchor`` takes a ``Stationarity`` or its short name
    (``"os"``/``"ws"``/``"is"``); for attention ``block`` is ``(bq,
    bkv)``.  A block other than the kernel's compiled one raises where
    the op runs, as an explicit spec's does."""

    anchor: Optional[Stationarity] = None
    block: Optional[Tuple[Optional[int], ...]] = None

    def __post_init__(self) -> None:
        a = self.anchor
        if isinstance(a, str) and not isinstance(a, Stationarity):
            try:
                a = _ANCHOR_ALIASES[a.lower()]
            except KeyError:
                raise ValueError(
                    f"unknown anchor {self.anchor!r}; use one of "
                    f"{sorted(_ANCHOR_ALIASES)} or a Stationarity") from None
            object.__setattr__(self, "anchor", a)
        if self.block is not None:
            object.__setattr__(self, "block", tuple(self.block))

    @property
    def anchor_name(self) -> Optional[str]:
        if self.anchor is None:
            return None
        return {OS: "os", WS: "ws", IS: "is"}[self.anchor]

    def block_dim(self, idx: int) -> Optional[int]:
        if self.block is None or idx >= len(self.block):
            return None
        return self.block[idx]

    @property
    def is_complete(self) -> bool:
        """Every field pinned: the merge needs no autotuned base."""
        return (self.anchor is not None and self.block is not None
                and len(self.block) > 0
                and all(b is not None for b in self.block))

    def merge(self, base: DataflowSpec) -> DataflowSpec:
        """The full spec this override realizes over ``base``: an anchor
        change drops ``base``'s residencies (chosen for the old anchor),
        a pure block override keeps them."""
        anchor = self.anchor if self.anchor is not None else base.anchor
        block = list(base.block)
        if self.block is not None:
            for i, bv in enumerate(self.block):
                if bv is not None and i < len(block):
                    block[i] = bv
        if anchor == base.anchor:
            return dataclasses.replace(base, block=tuple(block))
        return DataflowSpec.basic(anchor, block=tuple(block))


@dataclasses.dataclass(frozen=True)
class GemmProblem:
    """A GEMM-like workload: (M, K) x (K, N) -> (M, N).  ``weight_bits``
    (None, 4 or 5) marks B as the packed planes of ``kernels/pack.py``:
    the cost model charges their bytes and the autotune key gains a
    packing segment."""

    m: int
    k: int
    n: int
    in_dtype: str = "bfloat16"
    out_dtype: str = "float32"
    acc_dtype: str = "float32"
    weight_bits: Optional[int] = None

    def __post_init__(self) -> None:
        if self.weight_bits not in (None, 4, 5):
            raise ValueError(
                f"weight_bits must be None, 4 or 5, got {self.weight_bits}")

    @property
    def flops(self) -> int:
        return 2 * self.m * self.k * self.n


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
    in_dtype: str = "int8"
    out_dtype: str = "int32"
    weight_bits: Optional[int] = None

    def __post_init__(self) -> None:
        if self.weight_bits not in (None, 4, 5):
            raise ValueError(
                f"weight_bits must be None, 4 or 5, got {self.weight_bits}")

    @property
    def oh(self) -> int:
        return (self.ih - self.fh) // self.s + 1

    @property
    def ow(self) -> int:
        return (self.iw - self.fw) // self.s + 1

    # The paper's notation: H = ih*iw, R = fh*fw, E = oh*ow.
    @property
    def H(self) -> int:
        return self.ih * self.iw

    @property
    def R(self) -> int:
        return self.fh * self.fw

    @property
    def E(self) -> int:
        return self.oh * self.ow

    @property
    def flops(self) -> int:
        return 2 * self.n * self.E * self.R * self.cin * self.cout

    def as_gemm(self) -> GemmProblem:
        """Implicit-GEMM view: M = n*oh*ow, K = fh*fw*cin, N = cout."""
        return GemmProblem(m=self.n * self.oh * self.ow,
                           k=self.fh * self.fw * self.cin, n=self.cout,
                           in_dtype=self.in_dtype, out_dtype=self.out_dtype,
                           weight_bits=self.weight_bits)


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
        """The packed-word GEMM view the traffic is counted on."""
        return GemmProblem(m=self.m, k=self.kp, n=self.n,
                           in_dtype="binary_packed", out_dtype=self.out_dtype,
                           acc_dtype="int32")


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


@dataclasses.dataclass(frozen=True)
class AttentionProblem:
    """A (GQA) attention workload: ``bh`` folded batch * q heads,
    ``group`` q heads a KV head, true lengths ``sq``/``skv`` (q rows
    right-aligned against the KV length, so decode is ``sq=1``).
    ``kv_len`` is the valid prefix of a padded KV buffer (None: all of
    ``skv``, the worst case a run-time length keys as), ``window`` a
    causal sliding window, ``kv_dtype`` the K/V element type where it is
    not ``dtype`` (``"int8"``: the int8 KV cache, with per-position f32
    scales), ``rows`` the batch rows that each carry their own valid
    length.  The anchors: OS is B2 (flash, the q tile anchored), WS is B7
    (KV-stationary, each KV block fetched once per cluster); a spec's
    ``block`` is ``(bq, bkv, d)``."""

    bh: int
    sq: int
    skv: int
    d: int
    group: int = 1
    causal: bool = True
    window: Optional[int] = None
    dtype: str = "float32"
    kv_len: Optional[int] = None
    kv_dtype: Optional[str] = None
    rows: int = 1

    def __post_init__(self) -> None:
        if self.bh % max(self.group, 1):
            raise ValueError(
                f"bh={self.bh} not divisible by group={self.group}")
        if self.kv_len is not None and not 0 < self.kv_len <= self.skv:
            raise ValueError(
                f"kv_len={self.kv_len} outside (0, skv={self.skv}]")
        if self.rows < 1 or self.bh % self.rows:
            raise ValueError(
                f"bh={self.bh} not divisible by rows={self.rows}")

    @property
    def bh_kv(self) -> int:
        return self.bh // max(self.group, 1)

    @property
    def kv_valid(self) -> int:
        return self.kv_len if self.kv_len is not None else self.skv

    @property
    def kv_elem_dtype(self) -> str:
        return self.kv_dtype if self.kv_dtype is not None else self.dtype

    @property
    def kv_quantized(self) -> bool:
        """The K/V carry per-position dequant scales (int8 codes)."""
        return self.kv_elem_dtype in ("int8", "uint8")

    @property
    def dot_flops(self) -> int:
        """QK^T + PV flops over the full (unbanded) score grid."""
        return 4 * self.bh * self.sq * self.skv * self.d

    @property
    def softmax_ops(self) -> int:
        return 6 * self.bh * self.sq * self.skv

    @property
    def flops(self) -> int:
        return self.dot_flops


# ---------------------------------------------------------------------------
# The problem registry: one explore/autotune pipeline for every problem type.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ProblemRegistration:
    """How a problem type plugs into ``core.explorer``/``core.autotune``:
    ``kind`` (the cache-key tag), ``key_fields`` (problem -> strings of
    every field that changes the ranking), ``enumerate`` ((problem, hw)
    -> the feasible ``explorer.Candidate`` list, each with its estimate),
    ``time_estimate`` ((problem, spec, hw) -> seconds), ``footprint``
    ((problem, spec) -> shared memory bytes a block of the planned kernel
    takes) and ``measure`` ((problem, specs) -> [(spec, seconds)] fastest
    first, the refinement hook)."""

    kind: str
    problem_cls: type
    key_fields: Callable[[Any], Tuple[str, ...]]
    enumerate: Callable[..., Any]
    time_estimate: Callable[..., float]
    footprint: Callable[[Any, DataflowSpec], int]
    measure: Optional[Callable[..., Any]] = None


_PROBLEMS: Dict[type, ProblemRegistration] = {}


def register_problem(reg: ProblemRegistration) -> ProblemRegistration:
    """Register (or re-register) a problem type; ``kind`` tags must be
    unique, or two types would share autotune keys."""
    for cls, existing in _PROBLEMS.items():
        if existing.kind == reg.kind and cls is not reg.problem_cls:
            raise ValueError(f"kind {reg.kind!r} is already registered for "
                             f"{cls.__name__}; cache keys would collide")
    _PROBLEMS[reg.problem_cls] = reg
    return reg


def registration_for(problem_or_cls) -> ProblemRegistration:
    """The registration of a problem instance or class; ``TypeError``
    naming an unregistered type."""
    cls = (problem_or_cls if isinstance(problem_or_cls, type)
           else type(problem_or_cls))
    reg = _PROBLEMS.get(cls)
    if reg is None:
        raise TypeError(
            f"{cls.__name__} is not a registered dataflow problem type; "
            f"known: {sorted(r.kind for r in _PROBLEMS.values())} "
            f"(see core.dataflow.register_problem)")
    return reg


def registered_kinds() -> Dict[str, type]:
    """kind tag -> problem class for every registered problem type."""
    return {reg.kind: cls for cls, reg in _PROBLEMS.items()}


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
