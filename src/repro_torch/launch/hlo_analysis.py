"""Cost analysis of a step on the mesh: collective bytes, FLOPs, memory.

The port has no compiled HLO.  What it keeps of the reference's
``launch/hlo_analysis.py``:

  * ``collective_stats(hlo_text)`` / ``CollectiveStats``: the stdlib HLO
    text parser, copied as it is (it reads text a JAX or XLA tool wrote);
  * ``CollectiveCounter``, a ``TorchDispatchMode`` that records every
    ``_c10d_functional`` collective the step issues (DTensor
    redistributions, ``local_map`` regions, the MoE all-to-all), by kind,
    with its result bytes: the per-rank payload, as the reference counts
    result shapes;
  * ``cost_summary``: FLOPs from ``torch.utils.flop_counter``;
  * ``memory_summary``: the local bytes of the argument shards, and the
    peak bytes the counter saw live (every tensor an operator made that
    is not a view, freed when its Python object is: the step's
    activations, saved tensors and temporaries under ``FakeTensorMode``).

A dispatch mode sees an operator on DTensors once, at the DTensor level,
and not the operators DTensor then runs on local shards; the counter
declines those (``NotImplemented``) so DTensor runs them under it, and
it sees the local collectives.  ``FlopCounterMode`` counts an operator
where it sees it: matrix products inside ``local_map`` regions on local
shards (per-rank FLOPs), any at the DTensor level on global shapes (the
dry-run's step has none outside the regions).
"""
from __future__ import annotations

import dataclasses
import re
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# tuple-result collectives: (bf16[...], bf16[...]) all-reduce(
_TUPLE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    if dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]
    # f32 payloads re-counted at 2 B/elem (the reference's projection of
    # a CPU toolchain's f32 GEMMs onto bf16 traffic)
    bf16_projected_by_kind: Dict[str, int] = dataclasses.field(
        default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def bf16_projected_bytes(self) -> int:
        return sum(self.bf16_projected_by_kind.values()) or self.total_bytes

    def summary(self) -> str:
        parts = [
            f"{k}: n={self.count_by_kind[k]} bytes={v:,}"
            for k, v in sorted(self.bytes_by_kind.items())
        ]
        return "; ".join(parts) or "none"


def collective_stats(hlo_text: str) -> CollectiveStats:
    """Sum result-shape bytes of every collective op in the HLO text."""
    by_kind: Dict[str, int] = {}
    count: Dict[str, int] = {}
    proj: Dict[str, int] = {}
    for line in hlo_text.splitlines():
        hit = None
        for c in _COLLECTIVES:
            if f" {c}(" in line or f" {c}-start(" in line:
                hit = c
                break
        if hit is None:
            continue
        lhs = line.split("=", 1)[0] + "=" + line.split("=", 1)[1].split(hit)[0]
        nbytes = 0
        pbytes = 0
        for dt, dims in _TUPLE_RE.findall(lhs):
            b = _shape_bytes(dt, dims)
            nbytes += b
            pbytes += b // 2 if dt == "f32" else b
        by_kind[hit] = by_kind.get(hit, 0) + nbytes
        count[hit] = count.get(hit, 0) + 1
        proj[hit] = proj.get(hit, 0) + pbytes
    return CollectiveStats(by_kind, count, proj)


# ``_c10d_functional`` operator -> the reference's collective kind.
_FUNCTIONAL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def _kind(func) -> str:
    name = func.name()            # e.g. "_c10d_functional::all_reduce"
    if not name.startswith("_c10d_functional"):
        return ""
    op = name.split("::", 1)[1].split(".")[0]
    for key, kind in _FUNCTIONAL_KINDS.items():
        if op.startswith(key):
            return kind
    return ""


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CollectiveCounter(TorchDispatchMode):
    """Counts collectives (kind, result bytes) and the live bytes of
    non-view operator outputs while active."""

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats({}, {}, {})
        self.live = 0
        self.peak = 0

    def _track(self, outs) -> None:
        for t in outs:
            if not isinstance(t, torch.Tensor) or t._base is not None:
                continue
            n = _nbytes(t)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor runs its local ops here
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        kind = _kind(func)
        if kind:
            st = self.stats
            for t in outs:
                if not isinstance(t, torch.Tensor):
                    continue
                n = _nbytes(t)
                st.bytes_by_kind[kind] = st.bytes_by_kind.get(kind, 0) + n
                st.bf16_projected_by_kind[kind] = \
                    st.bf16_projected_by_kind.get(kind, 0) + (
                        n // 2 if t.dtype == torch.float32 else n)
            st.count_by_kind[kind] = st.count_by_kind.get(kind, 0) + 1
        self._track(outs)
        return out


def cost_summary(flop_counter) -> Dict[str, float]:
    """{"flops": ...} from a ``FlopCounterMode`` that ran the step, and
    the FLOPs by operator."""
    by_op: Dict[str, float] = {}
    for mod, ops in flop_counter.get_flop_counts().items():
        if mod != "Global":
            continue
        for op, n in ops.items():
            by_op[str(op)] = by_op.get(str(op), 0.0) + float(n)
    return {"flops": float(flop_counter.get_total_flops()),
            "flops_by_op": by_op}


def memory_summary(arg_trees, counter: CollectiveCounter) -> Dict[str, float]:
    """Per-rank bytes: the argument shards (params, optimizer state,
    batch, cache: local shards of DTensors, whole plain tensors) and the
    peak live bytes of the step's own outputs."""
    def local_bytes(tree) -> int:
        if isinstance(tree, dict):
            return sum(local_bytes(v) for v in tree.values())
        if isinstance(tree, (tuple, list)):
            return sum(local_bytes(v) for v in tree)
        if hasattr(tree, "to_local"):
            return _nbytes(tree.to_local())
        if isinstance(tree, torch.Tensor):
            return _nbytes(tree)
        return 0

    args = float(local_bytes(arg_trees))
    return {"argument_size_in_bytes": args,
            "temp_size_in_bytes": float(counter.peak),
            "peak_memory_in_bytes": args + float(counter.peak)}
