"""Cost models: the paper's Table I heuristics, byte counts of a dataflow,
rooflines, and the time estimate the explorer ranks Hopper's kernels by.

Two parts, kept apart:

1. Free of any hardware, ported from ``repro/core/cost_model.py`` as it
   is: ``table1_reduction`` and ``paper_observations_hold`` (the paper's
   CPU/SIMD memory-instruction reductions and Observations 1-5), the
   packed-weight byte counts, ``gemm_traffic``/``conv_traffic``/
   ``binary_traffic``/``attention_traffic`` (the bytes the reference's
   tiled kernels move under a dataflow at a given block, with their
   on-chip footprints checked against a given ``budget``),
   ``roofline`` and ``model_flops``.  On the same problem, spec, block
   and budget they give the reference's numbers.

2. Hopper: ``HardwareSpec`` (the card's SMs, shared memory a block may
   take, L2 bytes, HBM rate and the peak rate of each unit a kernel can
   run on) and the time estimate of a spec, made from the plan its
   kernel runs (``matmul_df.plan``, ``conv2d_df.plan``,
   ``binary_mm.plan``, ``attention_df.kv_stationary_plan``): the steps
   the busiest SM's CTAs run one after another, each step's operations
   at a per-kernel share of the rate of the unit it runs on (a
   tensor-core tile, a cluster walk or a CUDA-core walk), plus each
   kernel's prologue a CTA and latency a step, after the launch; or the
   bytes the work needs over the HBM rate, if longer.  The per-kernel
   constants are fitted to the card's timings (section 5).  A spec whose
   plan raises is infeasible.  ``H100`` is the constant for the card; a
   CPU engine and the tests rank with it, so a CPU ranking equals the
   card's.
"""
from __future__ import annotations

import dataclasses
import functools
import zlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.dataflow import (AttentionProblem, BinaryProblem,
                                       ConvProblem, DataflowSpec, GemmProblem,
                                       Residency, Stationarity, IS, OS, WS)
from repro_torch.kernels import (attention_df, binary_mm, conv2d_df,
                                 matmul_df, pack)

_DTYPE_BYTES = {
    "float64": 8, "float32": 4, "bfloat16": 2, "float16": 2, "int32": 4,
    "uint32": 4, "int8": 1, "uint8": 1, "bool": 1,
    "binary_packed": 4,   # 32 binary channels per 32-bit word
}


def dtype_bytes(dtype: str) -> int:
    key = str(dtype)
    if key not in _DTYPE_BYTES:
        raise KeyError(f"unknown dtype {dtype!r}")
    return _DTYPE_BYTES[key]


TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.int32: "int32",
                torch.float16: "float16"}


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the problems' dtype strings."""
    name = _DTYPE_NAMES.get(dtype)
    return name if name is not None else str(dtype).replace("torch.", "")


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# 1. The paper's Table I, in its literal CPU/SIMD form.
# ---------------------------------------------------------------------------
def table1_reduction(anchor: Stationarity, aux: Stationarity,
                     conv: ConvProblem,
                     n_aux_vars: int = 1) -> Tuple[float, float]:
    """(reads saved, writes saved) per additional auxiliary vector
    variable: the paper's Table I (simplified forms), in memory
    instructions of one vector variable each."""
    H, R, E, s, fw, fh, ih = (conv.H, conv.R, conv.E, conv.s, conv.fw,
                              conv.fh, conv.ih)
    if anchor == OS:
        # every stashed input or weight variable saves E reads
        if aux in (IS, WS):
            return (float(E), 0.0)
    elif anchor == WS:
        if aux == IS:
            return (float(R), 0.0)
        if aux == OS:
            return (float(R), float(R))
    elif anchor == IS:
        if s == 1:
            if aux == WS:
                return (float(H), 0.0)
            if aux == OS:
                return (float(H), float(H))
        else:
            if aux == WS:
                if n_aux_vars <= fw:
                    return (H / s, 0.0)
                return (H / ((fw - s) * s), 0.0)
            if aux == OS:
                if n_aux_vars == 1:
                    g = H + H / fw
                    return (g, g)
                if n_aux_vars == 2:
                    g = (ih / max(fw - s, 1)) * (H + H / fw) + (ih / s) * max(
                        fw - s - 1, 0)
                    return (g, g)
                g = (fh - s) * (fw - s) * H / R
                return (g, g)
    raise ValueError(f"no Table-I row for anchor={anchor} aux={aux} s={s}")


def paper_observations_hold(conv: ConvProblem) -> Dict[str, bool]:
    """Observations 1, 3, 4 and 5, re-derived from Table I for a layer."""
    ws_gain = max(sum(table1_reduction(WS, a, conv)) for a in (IS, OS))
    os_gain = sum(table1_reduction(OS, WS, conv))
    is_gain = sum(table1_reduction(IS, OS, conv, n_aux_vars=1))
    return {
        # Obs 1: WS gains least per auxiliary variable
        "obs1_ws_gains_least": ws_gain <= min(os_gain, is_gain),
        # Obs 3: under OS, input aux == weight aux
        "obs3_os_aux_symmetric":
            table1_reduction(OS, IS, conv) == table1_reduction(OS, WS, conv),
        # Obs 4: under IS, output aux >= weight aux
        "obs4_is_output_first":
            sum(table1_reduction(IS, OS, conv, 1))
            >= sum(table1_reduction(IS, WS, conv, 1)),
        # Obs 5: under WS, output aux >= input aux
        "obs5_ws_output_first":
            sum(table1_reduction(WS, OS, conv))
            >= sum(table1_reduction(WS, IS, conv)),
    }


# ---------------------------------------------------------------------------
# 2. Bytes a tiled kernel moves under a dataflow (the reference's model).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Traffic:
    """Bytes moved between device memory and the chip, per operand class;
    ``footprint`` the on-chip bytes the dataflow claims, ``feasible``
    whether they fit the budget it was counted against."""

    reads: Dict[Stationarity, int]
    writes: Dict[Stationarity, int]
    footprint: int
    feasible: bool

    @property
    def total(self) -> int:
        return sum(self.reads.values()) + sum(self.writes.values())


def _fits(foot: int, budget: Optional[int]) -> bool:
    return budget is None or foot <= budget


# Packed weights (kernels/pack.py): a nibble plane of ceil(k/8) words a
# column, at 5 bits a bit plane of ceil(k/32) words a column, and an
# outlier sidecar of ``pack.outlier_capacity(k)`` rows (an index word and
# n delta words each).
def packed_slab_bytes(rows: int, cols: int, weight_bits: int) -> int:
    """Bytes of the packed planes covering a ``rows x cols`` slab."""
    bytes_ = _ceil(rows, 8) * cols * 4
    if weight_bits == 5:
        bytes_ += _ceil(rows, 32) * cols * 4
    return bytes_


def packed_weight_bytes(k: int, n: int, weight_bits: int) -> int:
    """Bytes of a packed (k, n) weight: the planes and the sidecar."""
    cap = pack.outlier_capacity(k)
    return packed_slab_bytes(k, n, weight_bits) + cap * (4 + n * 4)


def weight_stream_bytes(p: GemmProblem) -> int:
    """Bytes of one full read of the weight operand (packed-aware)."""
    if p.weight_bits is None:
        return p.k * p.n * dtype_bytes(p.in_dtype)
    return packed_weight_bytes(p.k, p.n, p.weight_bits)


def gemm_footprint(p: GemmProblem, spec: DataflowSpec) -> int:
    """On-chip bytes the reference's tiled GEMM claims under ``spec`` at
    its block (streamed blocks double-buffered)."""
    bm, bk, bn = spec.block
    ib, ob = dtype_bytes(p.in_dtype), dtype_bytes(p.out_dtype)
    ab = dtype_bytes(p.acc_dtype)
    res_a, res_b, res_o = (spec.residency(IS), spec.residency(WS),
                           spec.residency(OS))
    foot = {Residency.STREAMED: 2 * bm * bk, Residency.STRIPE: bm * p.k,
            Residency.WHOLE: p.m * p.k}[res_a] * ib
    if p.weight_bits is None:
        foot += {Residency.STREAMED: 2 * bk * bn, Residency.STRIPE: p.k * bn,
                 Residency.WHOLE: p.k * p.n}[res_b] * ib
    else:
        # the packed planes as the dataflow holds them, plus the int8
        # block decoded at the stripe load
        foot += {
            Residency.STREAMED: 2 * packed_slab_bytes(bk, bn, p.weight_bits),
            Residency.STRIPE: packed_slab_bytes(p.k, bn, p.weight_bits),
            Residency.WHOLE: packed_slab_bytes(p.k, p.n, p.weight_bits),
        }[res_b]
        foot += bk * bn
    foot += {Residency.STREAMED: 2 * bm * bn,
             Residency.STRIPE: bm * p.n if spec.anchor == IS else p.m * bn,
             Residency.WHOLE: p.m * p.n}[res_o] * ob
    # the scratch accumulator: OS always, and the streamed-output WS/IS
    if spec.anchor == OS or res_o == Residency.STREAMED:
        foot += bm * bn * ab
    elif p.in_dtype in ("int8", "uint8", "int32", "uint32", "bool"):
        # integer output-stripe writers accumulate in an int32 stripe
        foot += {Residency.STRIPE: bm * p.n if spec.anchor == IS
                 else p.m * bn, Residency.WHOLE: p.m * p.n}[res_o] * ab
    return foot


def gemm_traffic(p: GemmProblem, spec: DataflowSpec,
                 budget: Optional[int] = None) -> Traffic:
    """Bytes the reference's tiled GEMM moves under ``spec``: an operand
    whose block index stays constant across consecutive grid steps is
    fetched once per distinct index; a streamed one again on every sweep
    of the grid dimensions its index does not depend on."""
    bm, bk, bn = spec.block
    gm, gk, gn = _ceil(p.m, bm), _ceil(p.k, bk), _ceil(p.n, bn)
    ib, ob = dtype_bytes(p.in_dtype), dtype_bytes(p.out_dtype)
    A, B, O = p.m * p.k * ib, weight_stream_bytes(p), p.m * p.n * ob
    res_a, res_b, res_o = (spec.residency(IS), spec.residency(WS),
                           spec.residency(OS))
    reads: Dict[Stationarity, int] = {}
    writes: Dict[Stationarity, int] = {IS: 0, WS: 0, OS: 0}
    if spec.anchor == OS:
        writes[OS] = O
        reads[OS] = 0
        # one stripe operand owns the outer grid position (the aux
        # priority decides; paper Alg. 8: weight first); WHOLE removes
        # the conflict
        a_once = res_a == Residency.WHOLE
        b_once = res_b == Residency.WHOLE
        stripes = [st for st in spec.aux_priority
                   if spec.residency(st) == Residency.STRIPE
                   and st in (IS, WS)]
        if not stripes:
            stripes = [st for st in (WS, IS)
                       if spec.residency(st) == Residency.STRIPE]
        if stripes:
            first = stripes[0]
            a_once = a_once or first == IS
            b_once = b_once or first == WS
            # a second stripe sticks only beside a WHOLE first
            for st in stripes[1:]:
                if (st == IS and b_once and res_b == Residency.WHOLE) or (
                        st == WS and a_once and res_a == Residency.WHOLE):
                    a_once = a_once or st == IS
                    b_once = b_once or st == WS
        reads[IS] = A if a_once else gn * A
        reads[WS] = B if b_once else gm * B
    elif spec.anchor == WS:
        reads[WS] = B
        a_once = res_a in (Residency.STRIPE, Residency.WHOLE)
        reads[IS] = A if a_once else gn * A
        if res_o in (Residency.STRIPE, Residency.WHOLE):
            reads[OS] = 0
            writes[OS] = O
        else:                       # read-modify-write per reduction visit
            reads[OS] = gk * O
            writes[OS] = gk * O
    elif spec.anchor == IS:
        reads[IS] = A
        b_once = res_b == Residency.WHOLE   # stripes don't survive the m sweep
        reads[WS] = B if b_once else gm * B
        if res_o in (Residency.STRIPE, Residency.WHOLE):
            reads[OS] = 0
            writes[OS] = O
        else:
            reads[OS] = gk * O
            writes[OS] = gk * O
    else:
        raise ValueError(spec.anchor)
    foot = gemm_footprint(p, spec)
    return Traffic(reads=reads, writes=writes, footprint=foot,
                   feasible=_fits(foot, budget))


def conv_traffic(p: ConvProblem, spec: DataflowSpec,
                 budget: Optional[int] = None) -> Traffic:
    """The implicit-GEMM view's traffic, with a resident input read once
    (its halo rows not fetched again: the paper's input-reuse argument,
    Fig. 4, in bytes)."""
    g = p.as_gemm()
    t = gemm_traffic(g, spec, budget)
    unique_in = p.n * p.H * p.cin * dtype_bytes(p.in_dtype)
    reads = dict(t.reads)
    if spec.residency(IS) in (Residency.STRIPE, Residency.WHOLE):
        refetch = reads[IS] // max(g.m * g.k * dtype_bytes(g.in_dtype), 1)
        reads[IS] = (max(1, refetch) * unique_in if spec.anchor != IS
                     else unique_in)
        if spec.residency(IS) == Residency.WHOLE or spec.anchor == IS:
            reads[IS] = unique_in
    return Traffic(reads, dict(t.writes), t.footprint, t.feasible)


def conv_gemm_view(p: ConvProblem, spec: DataflowSpec) -> DataflowSpec:
    """A conv-blocked spec ``(b_oh, bc, bk)`` as its implicit-GEMM block:
    an output tile covers ``b_oh * ow`` rows."""
    b_oh, bc, bk = spec.block
    return spec.with_block((max(1, b_oh) * p.ow, bc, bk))


def conv_footprint(p: ConvProblem, spec: DataflowSpec) -> int:
    """On-chip bytes of the reference's conv kernel at a conv-blocked
    spec: the padded image whole, one weight and one output block
    double-buffered, one f32/int32 accumulator tile."""
    b_oh, bc, bk = spec.block
    ib, ob = dtype_bytes(p.in_dtype), dtype_bytes(p.out_dtype)
    ab = 4
    cpad = _ceil(p.cin, bc) * bc
    kpad = _ceil(p.cout, bk) * bk
    b_oh = min(b_oh, p.oh)
    oh_pad = _ceil(p.oh, b_oh) * b_oh
    ih_pad = (oh_pad - 1) * p.s + p.fh + (p.s - 1)
    iw_pad = (p.ow - 1) * p.s + p.fw + (p.s - 1)
    foot = ih_pad * iw_pad * cpad * ib
    foot += 2 * p.fh * p.fw * cpad * min(bk, kpad) * ib
    foot += 2 * b_oh * p.ow * min(bk, kpad) * ob
    foot += b_oh * p.ow * min(bk, kpad) * ab
    return foot


def binary_traffic(p: BinaryProblem, spec: DataflowSpec,
                   budget: Optional[int] = None) -> Traffic:
    """Bytes of the binary GEMM, counted on its packed-word view (A is
    ``m * kp * 4`` bytes, 8x less than the int8 image of the layer)."""
    return gemm_traffic(p.as_gemm(), spec, budget)


# The attention kernels' state: an f32 accumulator row of d and the online
# softmax's statistics (m and l), ``stat_words`` f32 words a q row (the
# port's kernels hold two).
_F32 = 4


def attention_block_clamp(sq: int, skv: int, bq: int, bkv: int,
                          align: int = 1) -> Tuple[int, int]:
    """The ``(bq, bkv)`` a kernel realizes at true lengths ``(sq, skv)``:
    blocks clamp to the sequence rounded up to ``align`` rows, and
    ``sq == 1`` takes the one-row decode block."""
    bq = 1 if sq <= 1 else max(1, min(bq, _ceil(sq, align) * align))
    bkv = max(1, min(bkv, _ceil(max(skv, 1), align) * align))
    return bq, bkv


def attention_band(p: AttentionProblem, i: int, bq: int,
                   bkv: int) -> Tuple[int, int]:
    """[lo, hi] of the KV blocks q tile ``i`` sees (the valid prefix, the
    causal diagonal, the window); ``hi < lo``: none."""
    kv_valid = p.kv_valid
    off = kv_valid - p.sq
    hi = max(0, _ceil(kv_valid, bkv) - 1)
    if p.causal:
        qmax = min((i + 1) * bq, p.sq) - 1 + off
        hi = min(hi, max(0, qmax) // bkv)
    lo = 0
    if p.window is not None:
        qmin = i * bq + off
        lo = max(0, (qmin - p.window + 1) // bkv)
    return min(lo, hi), hi


def attention_visited_blocks(p: AttentionProblem, bq: int, bkv: int,
                             align: int = 1) -> Tuple[int, int, int, int]:
    """(visited (q tile, KV block) pairs, distinct visited KV blocks, q
    tiles, KV blocks) under banded execution."""
    bq, bkv = attention_block_clamp(p.sq, p.skv, bq, bkv, align)
    gq, gkv = _ceil(p.sq, bq), _ceil(p.skv, bkv)
    pairs = 0
    seen = set()
    for i in range(gq):
        lo, hi = attention_band(p, i, bq, bkv)
        if hi < lo:
            continue
        pairs += hi - lo + 1
        seen.update(range(lo, hi + 1))
    return pairs, len(seen), gq, gkv


def attention_banded_ops(p: AttentionProblem, bq: int, bkv: int,
                         align: int = 1) -> Tuple[int, int]:
    """(dot flops, softmax ops) over the visited score blocks only."""
    pairs, _, _, _ = attention_visited_blocks(p, bq, bkv, align)
    bq, bkv = attention_block_clamp(p.sq, p.skv, bq, bkv, align)
    scores = pairs * bq * bkv
    return 4 * p.bh * scores * p.d, 6 * p.bh * scores


def attention_footprint(p: AttentionProblem, spec: DataflowSpec,
                        stat_words: int = 2, align: int = 1) -> int:
    """On-chip bytes of the reference's attention kernel: double-buffered
    q and K/V blocks (and int8 scales), the (acc, m, l) state in scratch
    (OS) or double-buffered as it is revisited (WS)."""
    bq, bkv = attention_block_clamp(p.sq, p.skv, spec.block[0],
                                    spec.block[1], align)
    ib, kvib = dtype_bytes(p.dtype), dtype_bytes(p.kv_elem_dtype)
    state = bq * (p.d + stat_words) * _F32
    foot = 2 * bq * p.d * ib + 2 * 2 * bkv * p.d * kvib
    if p.kv_quantized:
        foot += 2 * 2 * bkv * _F32
    if spec.anchor == OS:
        foot += 2 * bq * p.d * ib + state
    else:
        foot += 2 * state
    return foot


def attention_traffic(p: AttentionProblem, spec: DataflowSpec,
                      budget: Optional[int] = None, stat_words: int = 2,
                      align: int = 1) -> Traffic:
    """Bytes of the reference's attention kernels: Q = inputs, K/V (and
    int8 scales) = weights, output and running state = outputs.  OS
    (flash): Q and O once, a KV block per visited (q tile, KV block)
    pair.  WS (KV-stationary): each visited KV block once, but every q
    tile re-reads its q block and round-trips its state at every swept
    block."""
    bq, bkv = attention_block_clamp(p.sq, p.skv, spec.block[0],
                                    spec.block[1], align)
    sqp = _ceil(p.sq, bq) * bq
    pairs, kv_blocks, gq, _ = attention_visited_blocks(p, bq, bkv, align)
    qib, kvib = dtype_bytes(p.dtype), dtype_bytes(p.kv_elem_dtype)
    # a KV position: its K and V rows (+ two f32 scales for int8), charged
    # per q-head row
    kv_pos = 2 * p.d * kvib + (2 * _F32 if p.kv_quantized else 0)
    Q = O = p.bh * sqp * p.d * qib
    reads: Dict[Stationarity, int] = {}
    writes: Dict[Stationarity, int] = {IS: 0, WS: 0, OS: 0}
    if spec.anchor == OS:
        reads[IS] = Q
        reads[WS] = p.bh * pairs * bkv * kv_pos
        reads[OS] = 0
        writes[OS] = O
    elif spec.anchor == WS:
        reads[WS] = p.bh * kv_blocks * bkv * kv_pos
        steps = kv_blocks * gq
        reads[IS] = p.bh * steps * bq * p.d * qib
        state = p.bh * steps * bq * (p.d + stat_words) * _F32
        reads[OS] = state
        writes[OS] = state
    else:
        raise ValueError(f"attention admits OS/WS anchors, not {spec.anchor}")
    foot = attention_footprint(p, spec, stat_words, align)
    return Traffic(reads=reads, writes=writes, footprint=foot,
                   feasible=_fits(foot, budget))


def attention_rows_traffic(p: AttentionProblem, kv_lens,
                           spec: DataflowSpec, budget: Optional[int] = None,
                           stat_words: int = 2, align: int = 1) -> Traffic:
    """A ragged decode step's traffic: each of ``len(kv_lens)`` batch
    rows (sharing ``p.bh`` equally) charged at its own valid length, a
    row at 0 nothing."""
    kv_lens = [int(kv) for kv in kv_lens]
    rows = max(len(kv_lens), 1)
    if p.bh % rows:
        raise ValueError(f"bh={p.bh} not divisible by {rows} kv_lens rows")
    heads = p.bh // rows
    reads: Dict[Stationarity, int] = {IS: 0, WS: 0, OS: 0}
    writes: Dict[Stationarity, int] = {IS: 0, WS: 0, OS: 0}
    footprint, feasible = 0, True
    for kv in kv_lens:
        if kv <= 0:
            continue
        rp = dataclasses.replace(p, bh=heads, rows=1, kv_len=min(kv, p.skv))
        t = attention_traffic(rp, spec, budget, stat_words, align)
        for st in (IS, WS, OS):
            reads[st] += t.reads.get(st, 0)
            writes[st] += t.writes.get(st, 0)
        footprint = max(footprint, t.footprint)
        feasible &= t.feasible
    return Traffic(reads=reads, writes=writes, footprint=footprint,
                   feasible=feasible)


# ---------------------------------------------------------------------------
# 3. The card.
# ---------------------------------------------------------------------------
# Peak rates of one H100 SXM at a 700 W limit, by the unit a kernel runs
# on, in operations a second (2 per multiply-add): the bf16 and int8
# tensor cores, float32 on the CUDA cores (NVIDIA's data sheet, dense);
# the binary tensor cores (``mma.sync`` m16n8k256 ``.b1 .and.popc``,
# K counted in bits): no data sheet gives it, so it is
# ``bench/binary_sweep.cu``'s reading on an H100 80GB HBM3 at 700 W; the
# CUDA cores' 32-bit integer multiply-add (the int8 and packed walks):
# 64 an SM a clock (the CUDA C++ Programming Guide's arithmetic
# instruction throughput, compute capability 9.0) on 132 SMs at
# 1.98 GHz, the clock the data sheet's float32 rate implies; their
# popcount (B9's walks): 16 an SM a clock (same table), a word pair being
# 32 bits x 2 operations.
SM_CLOCK_HZ = 1.98e9
H100_RATES = (
    ("bf16_tc", 989e12),
    ("int8_tc", 1979e12),
    ("b1_tc", 10285.5e12),
    ("f32_cuda", 67e12),
    ("int_cuda", 2 * 64 * 132 * SM_CLOCK_HZ),
    ("popc_cuda", 64 * 16 * 132 * SM_CLOCK_HZ),
)


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """One CUDA card as the cost model sees it."""

    name: str
    sms: int
    smem_block: int                  # opt-in shared memory of one block
    l2_bytes: int
    smem_sm: int = 233_472           # shared memory of one SM (228 KB)
    hbm_bw: float = 3.35e12          # bytes/s (H100 SXM data sheet)
    link_bw: float = 900e9           # NVLink bytes/s (H100 SXM data sheet)
    rates: Tuple[Tuple[str, float], ...] = H100_RATES

    def rate(self, unit: str) -> float:
        return dict(self.rates)[unit]

    def peak_for(self, dtype: str) -> float:
        """The peak rate of the unit a dtype's dense GEMM runs on."""
        return self.rate({"bfloat16": "bf16_tc", "float16": "bf16_tc",
                          "int8": "int8_tc", "float32": "f32_cuda",
                          "binary_packed": "b1_tc"}.get(str(dtype),
                                                        "bf16_tc"))


H100 = HardwareSpec(name="NVIDIA H100 80GB HBM3", sms=matmul_df.CARD_SMS,
                    smem_block=matmul_df.MAX_SMEM, l2_bytes=50 * 2 ** 20)


@functools.lru_cache(maxsize=None)
def _card(index: int) -> HardwareSpec:
    props = torch.cuda.get_device_properties(index)
    return dataclasses.replace(
        H100, name=torch.cuda.get_device_name(index),
        sms=props.multi_processor_count,
        smem_block=getattr(props, "shared_memory_per_block_optin",
                           H100.smem_block),
        l2_bytes=getattr(props, "L2_cache_size", H100.l2_bytes),
        smem_sm=getattr(props, "shared_memory_per_multiprocessor",
                        H100.smem_sm))


def hardware_for(device) -> HardwareSpec:
    """The card a tensor or engine on ``device`` runs on (its properties
    read once); ``H100`` for the CPU."""
    if not isinstance(device, torch.device):
        device = torch.device(device)
    if device.type != "cuda":
        return H100
    return _card(device.index if device.index is not None
                 else torch.cuda.current_device())


# ---------------------------------------------------------------------------
# 4. Rooflines.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    t_compute: float
    t_memory: float
    t_collective: float
    chips: int
    flops: float
    hbm_bytes: float
    collective_bytes: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def compute_fraction(self) -> float:
        if self.bound_time == 0:
            return 0.0
        return self.t_compute / self.bound_time


def roofline(flops: float, hbm_bytes: float, collective_bytes: float,
             chips: int = 1, hw: HardwareSpec = H100,
             dtype: str = "bfloat16") -> RooflineTerms:
    """compute = flops / (chips * peak), memory = bytes / (chips * HBM
    rate), collective = bytes / (chips * link rate); the quantities are
    whole-step, divided over the chips."""
    return RooflineTerms(
        t_compute=flops / (chips * hw.peak_for(dtype)),
        t_memory=hbm_bytes / (chips * hw.hbm_bw),
        t_collective=collective_bytes / (chips * hw.link_bw),
        chips=chips, flops=flops, hbm_bytes=hbm_bytes,
        collective_bytes=collective_bytes)


def model_flops(n_params: int, tokens: int, training: bool = True) -> float:
    """6*N*D for training (forward and backward), 2*N*D for inference."""
    return (6.0 if training else 2.0) * n_params * tokens


# ---------------------------------------------------------------------------
# 5. Hopper: the time of a spec, from the plan its kernel runs.
# ---------------------------------------------------------------------------
# The port's kernels are latency-bound at the serving shapes: a CTA runs
# its k steps (attention: its KV blocks) one after another, so a launch
# takes about the steps its busiest SM runs times the time of a step, and
# that time is set by the unit the kernel's step runs on and by how close
# to that unit's peak one CTA gets.  ``Walk`` is what the estimate reads
# of a plan.  Per kernel family, ``EFFICIENCY`` is the share of an SM's
# peak rate for its unit that one CTA's steps reach, ``PROLOGUE_SECONDS``
# what a CTA spends outside its steps (filling its pipeline or its
# resident stripe, its epilogue) and ``STEP_SECONDS`` the latency of a
# step whatever its operations (a k chunk's arrival in B5a's and B5b's
# clusters, where a step's operations grow with the tiles a CTA owns; 0
# where a family's steps all carry the same operations, which cannot
# tell the two apart); ``LAUNCH_SECONDS`` is the time of a
# launch before its first CTA starts and ``CONTENTION`` what each further
# CTA an SM holds adds to a CTA's time.  They are fitted to the card's own
# timings by ``bench/calibrate.py`` from ``bench/calibration_h100.jsonl``,
# the records of ``chip_smoke.py``'s autotune phase on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md §6); a family with no timing there
# (``conv2d_ws_bf16``, ``conv2d_f32``) keeps an efficiency of 0.1, no
# prologue and no step latency.
MAX_RESIDENT = 8            # 256-thread CTAs an SM holds (2048 threads)
SMEM_RESERVED = 1024        # shared memory the runtime keeps for a block
# The f32 attention kernels fold one q row per warp at a time: B2's
# (csrc/flash_attention.cu) has 4 warps of 4 rows each, so its busiest warp
# runs min(4, live rows) rows a KV block; B7's (csrc/kv_stationary.cu) has
# 16 warps of one row each.
F32_FLASH_WARPS, F32_FLASH_ROWS_PER_WARP = 4, 4
F32_KV_WARPS = 16
# B5a's and B5b's clusters: a CTA owns several output tiles of its stripe
# and folds each k chunk into all of them (csrc/gemm_cluster.cuh)
STRIPE_CLUSTERS = ("matmul_ws_stripe_cluster", "matmul_is_stripe_cluster")
LAUNCH_SECONDS = 2.5e-06
CONTENTION = 0.3
EFFICIENCY: Dict[str, float] = {
    "bf16_walk": 0.04342, "binary_mm_decode": 0.01247,
    "binary_mm_prefill": 0.0854, "conv2d_is_bf16": 0.04634,
    "conv2d_is_i8": 0.05832, "conv2d_os_bf16": 0.1714,
    "conv2d_os_i8": 0.07623, "conv2d_ws_i8": 0.07402, "f32_walk": 0.2231,
    "flash_attention": 0.0608, "flash_attention_f32": 0.2843,
    "flash_attention_i8kv": 0.0453, "int_walk": 0.5054,
    "kv_stationary_cluster": 0.04633, "kv_stationary_cluster_i8kv": 0.03405,
    "kv_stationary_f32": 0.3308, "matmul_is_stripe_cluster": 0.2582,
    "matmul_os_cluster": 0.06182, "matmul_os_decode": 0.02036,
    "matmul_os_i8_decode": 0.0436, "matmul_os_i8_prefill": 0.1004,
    "matmul_os_prefill": 0.08951, "matmul_rmw_cluster": 0.06187,
    "matmul_ws_stripe_cluster": 5.647, "popc_walk": 0.9554,
}
PROLOGUE_SECONDS: Dict[str, float] = {
    "bf16_walk": 1.259e-05, "binary_mm_decode": 2.038e-06,
    "binary_mm_prefill": 3.678e-06, "conv2d_is_bf16": 0.0,
    "conv2d_is_i8": 3.563e-05, "conv2d_os_bf16": 1.158e-05,
    "conv2d_os_i8": 4.671e-06, "conv2d_ws_i8": 1.092e-05,
    "f32_walk": 3.787e-06, "flash_attention": 5.521e-06,
    "flash_attention_f32": 3.271e-06, "flash_attention_i8kv": 0.0,
    "int_walk": 4.949e-05, "kv_stationary_cluster": 8.077e-06,
    "kv_stationary_cluster_i8kv": 0.0, "kv_stationary_f32": 3.067e-06,
    "matmul_is_stripe_cluster": 9.448e-06, "matmul_os_cluster": 0.0,
    "matmul_os_decode": 2.928e-06, "matmul_os_i8_decode": 3.78e-06,
    "matmul_os_i8_prefill": 5.679e-06, "matmul_os_prefill": 1.127e-05,
    "matmul_rmw_cluster": 0.0, "matmul_ws_stripe_cluster": 1.331e-05,
    "popc_walk": 5.656e-06,
}
STEP_SECONDS: Dict[str, float] = {
    "conv2d_os_bf16": 2.477e-07, "conv2d_os_i8": 2.068e-07,
    "flash_attention_f32": 7.031e-07, "kv_stationary_f32": 1.498e-06,
    "matmul_is_stripe_cluster": 3.385e-07,
    "matmul_ws_stripe_cluster": 6.125e-07,
}


def model_digest() -> str:
    """CRC32 of the fitted constants and the f32 attention kernels'
    shapes the estimate reads: the autotuner's store keys on it."""
    blob = repr((LAUNCH_SECONDS, CONTENTION, sorted(EFFICIENCY.items()),
                 sorted(PROLOGUE_SECONDS.items()),
                 sorted(STEP_SECONDS.items()), MAX_RESIDENT, SMEM_RESERVED,
                 F32_FLASH_WARPS, F32_FLASH_ROWS_PER_WARP, F32_KV_WARPS,
                 STRIPE_CLUSTERS)).encode()
    return f"{zlib.crc32(blob) & 0xFFFFFFFF:08x}"


@dataclasses.dataclass(frozen=True)
class Walk:
    """What the estimate reads of a plan: the kernel ``family``, the
    ``unit`` its step runs on, the operations of one step of one CTA,
    the ``steps`` a CTA runs one after another, the CTAs, a CTA's shared
    memory, and the bytes the work needs (each input read once, each
    output written once)."""

    family: str
    unit: str
    step_ops: float
    steps: int
    ctas: int
    smem: int
    moved: int
    step_bytes: int = 0       # operand bytes one step of one CTA loads

    @property
    def fetched(self) -> int:
        """Bytes every CTA's steps load, from the L2 or device memory."""
        return self.ctas * self.steps * self.step_bytes


def walk_occupancy(w: Walk, hw: HardwareSpec = H100) -> Tuple[int, int]:
    """(CTAs the busiest SM holds at once, waves): as many co-resident
    CTAs as its shared memory holds, at most ``MAX_RESIDENT``."""
    res = max(1, min(MAX_RESIDENT, hw.smem_sm // (w.smem + SMEM_RESERVED)))
    return min(res, _ceil(w.ctas, hw.sms)), _ceil(w.ctas, hw.sms * res)


def walk_path_seconds(w: Walk, hw: HardwareSpec = H100,
                      contention: Optional[float] = None) -> float:
    """The steps of the busiest SM at the unit's full per-SM rate, wave
    after wave, each CTA slowed by ``contention`` (default
    ``CONTENTION``) for every other CTA beside it."""
    if contention is None:
        contention = CONTENTION
    per_sm, waves = walk_occupancy(w, hw)
    return (waves * w.steps * w.step_ops / (hw.rate(w.unit) / hw.sms)
            * (1 + contention * (per_sm - 1)))


def walk_seconds(w: Walk, hw: HardwareSpec = H100) -> float:
    """The launch's time: the launch, then the busiest SM's CTAs, their
    prologues, their steps' latency and their operations at the family's
    share of the unit's rate, slowed as ``walk_path_seconds`` says; or
    the bytes over the HBM rate if they take longer."""
    per_sm, waves = walk_occupancy(w, hw)
    fixed = (waves * (1 + CONTENTION * (per_sm - 1))
             * (PROLOGUE_SECONDS.get(w.family, 0.0)
                + w.steps * STEP_SECONDS.get(w.family, 0.0)))
    path = walk_path_seconds(w, hw) / EFFICIENCY.get(w.family, 0.1)
    return max(LAUNCH_SECONDS + fixed + path, w.moved / hw.hbm_bw)


def gemm_walk(p: GemmProblem, spec: DataflowSpec) -> Walk:
    """The GEMM plan of ``spec`` at ``p`` as the estimate reads it;
    ``ValueError`` where ``matmul_df.plan`` refuses the spec.  A tile
    runs its k steps; a walk each of the tiles it sweeps (a cluster's
    share of them) in full."""
    dtype = TORCH_DTYPES[p.in_dtype]
    plan = matmul_df.plan(spec, p.m, p.k, p.n, dtype, p.weight_bits)
    tm, kstep, tn = plan.tile
    walk = {torch.bfloat16: "bf16_walk", torch.int8: "int_walk",
            torch.float32: "f32_walk"}[dtype]
    family = plan.tile_kernel or walk
    if plan.tile_kernel and not plan.cluster:
        owned = 1
    else:
        gm, gn = _ceil(p.m, tm), _ceil(p.n, tn)
        if plan.kernel == "matmul_os":
            # column stripes sweep the row tiles, row stripes the columns
            owned = {1: gm, 2: gn}.get(plan.args[1], gn if plan.args[0]
                                       else 1)
        elif plan.kernel == "matmul_rmw":
            owned = gm if plan.args[0] else gn
        elif plan.kernel == "matmul_ws_stripe":
            owned = gm
        else:
            owned = gn
        owned = _ceil(owned, plan.cluster or 1)
    unit = {torch.int8: "int8_tc" if plan.tile_kernel else "int_cuda",
            torch.float32: "f32_cuda"}.get(dtype, "bf16_tc")
    moved = (p.m * p.k * dtype_bytes(p.in_dtype) + weight_stream_bytes(p)
             + p.m * p.n * dtype_bytes(p.out_dtype))
    b_elt = dtype_bytes(p.in_dtype) if p.weight_bits is None else 0.5
    a_tile = kstep * tm * dtype_bytes(p.in_dtype)
    if family in STRIPE_CLUSTERS:
        # a step is one k chunk, multicast once, for every tile it owns
        return Walk(family, unit, 2.0 * tm * tn * kstep * owned,
                    _ceil(p.k, kstep), plan.ctas, plan.smem_bytes, moved,
                    int(owned * a_tile + kstep * tn * b_elt))
    return Walk(family, unit, 2.0 * tm * tn * kstep,
                owned * _ceil(p.k, kstep), plan.ctas, plan.smem_bytes, moved,
                int(a_tile + kstep * tn * b_elt))


def gemm_time_estimate(p: GemmProblem, spec: DataflowSpec,
                       hw: HardwareSpec = H100) -> float:
    """Seconds of ``spec`` on ``p``: inf where its plan raises."""
    try:
        return walk_seconds(gemm_walk(p, spec), hw)
    except ValueError:
        return float("inf")


def gemm_footprint_on_card(p: GemmProblem, spec: DataflowSpec) -> int:
    """Shared memory a block of the planned GEMM kernel takes."""
    return matmul_df.plan(spec, p.m, p.k, p.n, TORCH_DTYPES[p.in_dtype],
                          p.weight_bits).smem_bytes


def conv_walk(p: ConvProblem, spec: DataflowSpec) -> Walk:
    """The conv plan of ``spec`` at ``p``: OS a CTA per output tile (its
    share of the k steps when k is split), WS a CTA per channel tile
    sweeping every pixel tile, IS a CTA per image sweeping the channel
    and pixel tiles; ``ValueError`` where ``conv2d_df.plan`` refuses."""
    dtype = TORCH_DTYPES[p.in_dtype]
    plan = conv2d_df.plan(spec, p, dtype, p.weight_bits)
    pix, kstep, ch = plan.tile
    g = p.as_gemm()
    ksteps = _ceil(g.k, kstep)
    tiles_pix, tiles_ch = p.n * _ceil(p.E, pix), _ceil(p.cout, ch)
    family = plan.tile_kernel or "conv2d_f32"
    unit = {torch.int8: "int8_tc", torch.float32: "f32_cuda"}.get(dtype,
                                                                 "bf16_tc")
    if spec.anchor == OS:
        steps = _ceil(ksteps, plan.split or 1)
    elif spec.anchor == WS:
        steps = tiles_pix * ksteps
    else:
        steps = tiles_ch * _ceil(p.E, pix) * ksteps
    moved = (p.n * p.H * p.cin * dtype_bytes(p.in_dtype)
             + weight_stream_bytes(g) + g.m * g.n * dtype_bytes(p.out_dtype))
    return Walk(family, unit, 2.0 * pix * ch * kstep, steps, plan.ctas,
                plan.smem_bytes, moved,
                int(kstep * (pix + ch) * dtype_bytes(p.in_dtype)))


def conv_time_estimate(p: ConvProblem, spec: DataflowSpec,
                       hw: HardwareSpec = H100) -> float:
    """Seconds of the conv anchor ``spec`` on ``p``: inf where its plan
    raises."""
    try:
        return walk_seconds(conv_walk(p, spec), hw)
    except ValueError:
        return float("inf")


def conv_footprint_on_card(p: ConvProblem, spec: DataflowSpec) -> int:
    return conv2d_df.plan(spec, p, TORCH_DTYPES[p.in_dtype],
                          p.weight_bits).smem_bytes


def binary_walk(p: BinaryProblem, spec: DataflowSpec) -> Walk:
    """The binary plan of ``spec`` at ``p``: the basic OS tiles on the
    binary tensor cores, the WS/IS walks (a CTA per column / row stripe
    sweeping the other dimension's tiles) on the CUDA cores' popcount; a
    step's operations counted in bits, 2 per bit pair."""
    plan = binary_mm.plan(spec, p.m, p.kp, p.n)
    tm, kw, tn = plan.tile
    if plan.tile_kernel:
        family, unit, owned = plan.tile_kernel, "b1_tc", 1
    else:
        family, unit = "popc_walk", "popc_cuda"
        owned = _ceil(p.m, tm) if spec.anchor == WS else _ceil(p.n, tn)
    moved = (p.m + p.n) * p.kp * 4 + p.m * p.n * dtype_bytes(p.out_dtype)
    return Walk(family, unit, 2.0 * tm * tn * kw * 32,
                owned * _ceil(p.kp, kw), plan.ctas, plan.smem_bytes, moved,
                (tm + tn) * kw * 4)


def binary_time_estimate(p: BinaryProblem, spec: DataflowSpec,
                         hw: HardwareSpec = H100) -> float:
    """Seconds of the binary anchor ``spec`` on ``p``: inf where its plan
    raises."""
    try:
        return walk_seconds(binary_walk(p, spec), hw)
    except ValueError:
        return float("inf")


def binary_footprint_on_card(p: BinaryProblem, spec: DataflowSpec) -> int:
    return binary_mm.plan(spec, p.m, p.kp, p.n).smem_bytes


def attention_walk(p: AttentionProblem, spec: DataflowSpec) -> Walk:
    """The attention anchor ``spec`` at ``p``.  OS is B2: a CTA per
    (batch*head, q tile), folding the KV blocks of its own band, so the
    busiest CTA folds the longest band.  WS is B7: at bf16 a cluster per
    (batch row, kv head) walks the union of its units' bands in lockstep,
    each CTA folding every block for each unit it holds; at f32 a CTA per
    batch*head folds every visible (KV block, q tile) pair.  A step is one
    compiled (bq, bkv) tile's QK^T and PV at the q dtype's unit; at f32,
    on the CUDA cores, one row of each warp against a KV block, so B2's
    busiest CTA runs its band once for each row its busiest warp holds."""
    if p.d not in attention_df.HEAD_DIMS or p.dtype not in TORCH_DTYPES:
        raise ValueError(f"no attention kernel is built for d_head {p.d} "
                         f"and {p.dtype} queries")
    dtype = TORCH_DTYPES[p.dtype]
    # the compiled tile, whatever the sequence (decode: one live q row of
    # its bq)
    bq, bkv = spec.block[0], spec.block[1]
    gq = _ceil(p.sq, bq)
    bands = [attention_band(p, i, bq, bkv) for i in range(gq)]
    lens = [hi - lo + 1 for lo, hi in bands if hi >= lo]
    pairs = sum(lens)
    swept = (max(hi for _, hi in bands) - min(lo for lo, _ in bands) + 1
             if lens else 0)
    f32 = dtype == torch.float32
    kvb = dtype_bytes(p.kv_elem_dtype)
    kind = "_f32" if f32 else ("_i8kv" if p.kv_quantized else "")
    step_ops = 4.0 * bq * bkv * p.d
    if spec.anchor == OS:
        family = "flash_attention" + kind
        ctas, steps = p.bh * gq, max(lens, default=0)
        smem = (bq + 4 * bkv) * p.d * dtype_bytes(p.dtype)
        if f32:
            # a step: each warp folds one of its rows into a KV block
            step_ops = 4.0 * F32_FLASH_WARPS * bkv * p.d
            steps = max((hi - lo + 1) * min(F32_FLASH_ROWS_PER_WARP,
                                            p.sq - i * bq)
                        for i, (lo, hi) in enumerate(bands) if hi >= lo) \
                if lens else 0
    elif spec.anchor == WS:
        kvp = _kv_plan(p)
        if kvp is None:
            # every warp's row of a visible (KV block, q tile) pair at once
            family, ctas, steps = "kv_stationary_f32", p.bh, pairs
            step_ops = 4.0 * F32_KV_WARPS * bkv * p.d
            smem = (bq + 4 * bkv) * p.d * 4
        else:
            family = "kv_stationary_cluster" + kind
            ctas, smem = kvp.ctas, kvp.smem_bytes
            steps = swept * _ceil(gq * p.group, kvp.cluster)
    else:
        raise ValueError(f"attention admits OS/WS anchors, not {spec.anchor}")
    moved = (2 * p.bh * p.sq * p.d * dtype_bytes(p.dtype)
             + 2 * p.bh_kv * p.kv_valid * (p.d * kvb + (
                 _F32 if p.kv_quantized else 0)))
    return Walk(family, "f32_cuda" if f32 else "bf16_tc",
                step_ops, steps, ctas, smem, moved,
                2 * bkv * (p.d * kvb + (_F32 if p.kv_quantized else 0)))


def attention_time_estimate(p: AttentionProblem, spec: DataflowSpec,
                            hw: HardwareSpec = H100) -> float:
    """Seconds of the attention anchor ``spec`` on ``p``: inf where no
    kernel is built for it."""
    try:
        return walk_seconds(attention_walk(p, spec), hw)
    except ValueError:
        return float("inf")


def _kv_plan(p: AttentionProblem) -> Optional[attention_df.KvPlan]:
    """B7's plan for ``p``: its clusters are the (batch row, kv head)
    pairs, ``bh_kv`` of them, each with ``group`` q heads."""
    return attention_df.kv_stationary_plan(
        p.bh_kv, p.group, 1, p.sq, p.skv, TORCH_DTYPES[p.dtype], p.d,
        p.kv_quantized)


def attention_footprint_on_card(p: AttentionProblem,
                                spec: DataflowSpec) -> int:
    """Shared memory of B7's cluster kernel for WS at bf16; 0 where the
    port's planners name none."""
    kvp = _kv_plan(p) if spec.anchor == WS else None
    return 0 if kvp is None else kvp.smem_bytes
