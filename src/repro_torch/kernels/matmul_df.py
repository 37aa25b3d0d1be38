"""B1, B4, B5a and B5b: the fused-epilogue GEMM under every dataflow, as
CUDA kernels.

Ports of ``repro/kernels/matmul_df.py``: ``act(scale * (a @ b) + bias) +
residual`` with one f32 accumulator per output element and one write of
the post-epilogue value, under the anchor and auxiliary residencies a
``DataflowSpec`` names.

* B1 ``matmul_os`` (``csrc/matmul_os.cu``) replaces ``_os_kernel``: the
  OS anchor, basic or with an IS STRIPE/WHOLE input stripe, a WS STRIPE
  weight stripe (n-first) or the WS WHOLE weight.
* B4 ``matmul_rmw`` (``csrc/matmul_rmw.cu``) replaces ``_rmw_kernel``:
  basic WS (weight stripe resident, row tiles swept) and basic IS (input
  stripe resident, column tiles swept).
* B5a ``matmul_ws_stripe`` (``csrc/matmul_ws_stripe.cu``) replaces
  ``_ws_stripe_kernel``: WS with the (M, bn) output stripe resident.
* B5b ``matmul_is_stripe`` (``csrc/matmul_is_stripe.cu``) replaces
  ``_is_stripe_kernel``: IS with the (bm, N) output stripe resident,
  optionally with the whole weight.

bf16 launches of B1's residencies, B4, B5a and B5b whose walk sweeps two
tiles or more take the cluster walks of ``csrc/gemm_cluster.cuh``: a
thread-block cluster of ``cluster`` CTAs holds the resident operand,
fetched once per cluster, and its CTAs split the sweep (B5a: the output
stripe's row tiles, B5b: its column tiles, each CTA's part in
registers; B5b takes 2 to 32 column tiles, more keep one CTA).  ``plan``
names the walk as ``tile_kernel`` (``matmul_os_cluster``,
``matmul_rmw_cluster``, ``matmul_ws_stripe_cluster``,
``matmul_is_stripe_cluster``, counted beside the library's key) with the
cluster size, CTAs and launched shared memory, and ``check_took`` holds
each launch's report against it.  Feasibility does not change: the
resident operands must fit one block, as before.

"Resident" means held in the CTA's shared memory across a walk over the
grid dimension the TPU kernel revisits the operand in.  ``plan`` names
the kernel, the walk and the resident operands with their bytes, and
raises ``ValueError`` where they do not fit in a block's 227 KB, as a
TPU compile over VMEM fails: no spec runs another dataflow instead.

Every kernel sums k in ascending order into one f32 accumulator per
output element, k padded with zeros to a multiple of 32: bf16 operands
on the tensor cores (one ``mma.sync`` m16n8k16 per 16-deep k chunk, each
chunk summed from zero and added with one rounded f32 add), f32 operands
on the CUDA cores (one fmaf per k).  So every dataflow gives B1's bits,
and a row's result does not depend on the batch it is in.  The walks
tile 64x64 outputs over 32-deep k steps; B1's bf16 basic OS launch, the
serving path's, takes a tensor-core tile of its own
(``csrc/gemm_tc.cuh``): 128x64 fed by a 4-stage ``cp.async`` ring for
M > 16 (prefill), 16 rows x 16 columns streaming the weights through an
8-stage ring of 256-deep k steps for M <= 16 (decode).  ``plan`` names
the tile.  The reference's float output-stripe kernels accumulate in the
output dtype (bf16 for a bf16 output); these always accumulate in f32
(ROADMAP C).

int8 operands sum exactly in int32, the int32 result written as it is
without an epilogue, else put through the f32 epilogue.  With
``weight_bits`` (4 or 5) B is the packed nibble plane of
``kernels/pack.py`` (and its bit plane at 5 bits), decoded in the
kernel (B6, ``csrc/pack_common.cuh``), and the outlier sidecar
``(outlier_idx, outlier_delta)`` is added to the int32 accumulator at
the flush; the reference adds the same rows as a precomputed (M, N)
compensation term.  The int8 basic OS launch (an int8 B or packed
planes, the packed-MLP serving path) takes the integer tensor-core
tiles of ``csrc/gemm_tc_i8.cuh`` (one ``mma.sync`` m16n8k32 ``.s8`` per
32-deep k chunk, packed words decoded straight into its B fragments):
for M > 16 a 128x64 tile on a 4-stage ring of 128-deep k steps, for
M <= 16 the 16 rows x 32 (packed) or 64 (int8) columns on a ring of
512-deep steps.  Every other
int8 dataflow keeps the integer k loop on the CUDA cores; integer sums
are exact in any order, so all give the tiles' bits.  ``plan`` charges
int8 operands one byte an element and packed planes their words.

Each wrapper launches its kernel for CUDA tensors and raises for what it
does not take; for CPU tensors it computes the kernels' plain version,
``ref.matmul_fused_ref`` (on the exact int8 image of packed planes).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.dataflow import (DataflowSpec, Epilogue,
                                       KernelRegistration, Residency, IS, OS,
                                       WS, register_kernel)
from repro_torch.kernels import _build, pack, ref

BLOCK = (64, 32, 64)               # (bm, bk, bn) of csrc/gemm_common.cuh
ACTIVATION_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3}
MAX_SMEM = 232_448                 # bytes of shared memory a block can use
# One streamed f32 (or int32) tile with its padded rows, in bytes.
TILE_BYTES = BLOCK[1] * (BLOCK[0] + 4) * 4
# B1's bf16 basic OS tiles (csrc/gemm_tc.cuh): (bm, bk, bn), ring stages
# and dynamic shared memory (each row padded by 8 bf16); the decode tile
# takes M <= DECODE_M.
PREFILL_TILE, PREFILL_STAGES = (128, 32, 64), 4
DECODE_TILE, DECODE_STAGES = (16, 256, 16), 8
DECODE_M = DECODE_TILE[0]
# B1's int8 basic OS tiles (csrc/gemm_tc_i8.cuh): (bm, bk, bn) and ring
# stages of the prefill tile (an int8 B or packed planes) and of the decode
# tile (M <= DECODE_M) for an int8 B and for packed planes.  The CUDA
# configurations are the source; every launch reports the tile it took,
# held against this copy (``check_took``).
I8_PREFILL_TILE, I8_PREFILL_STAGES = (128, 128, 64), 4
I8_DECODE_TILE, I8_DECODE_STAGES = (16, 512, 64), 3
PACKED_DECODE_TILE, PACKED_DECODE_STAGES = (16, 512, 32), 4
WEIGHT_BITS = (4, 5)
# The cluster walks (csrc/gemm_cluster.cuh, namespace cl; the CUDA
# configuration is the source, held against this copy at every launch):
# bytes of a 64 x 32 A or 32 x 64 B bf16 k step, the streamed operand's
# ring slots, the largest cluster, the SMs a cluster size fills; B5a's k
# steps a chunk, chunks held at once and most row tiles a CTA owns.
CLUSTER_SLOT, CLUSTER_RING, MAX_CLUSTER, CARD_SMS = 4096, 16, 16, 132
STRIPE_KC, STRIPE_SLOTS, STRIPE_TILES = 2, 4, 2
_B_RES_CODES = {Residency.STREAMED: 0, Residency.STRIPE: 1,
                Residency.WHOLE: 2}

_SRC = "src/repro_torch/kernels/csrc/"
REGISTRATION = register_kernel(KernelRegistration(
    name="matmul_os", source=_SRC + "matmul_os.cu",
    replaces="src/repro/kernels/matmul_df.py:347",
    spec=DataflowSpec(anchor=OS, aux={WS: Residency.STREAMED}, block=BLOCK),
))
RMW = register_kernel(KernelRegistration(
    name="matmul_rmw", source=_SRC + "matmul_rmw.cu",
    replaces="src/repro/kernels/matmul_df.py:476",
    spec=DataflowSpec(anchor=WS, block=BLOCK),
))
WS_STRIPE = register_kernel(KernelRegistration(
    name="matmul_ws_stripe", source=_SRC + "matmul_ws_stripe.cu",
    replaces="src/repro/kernels/matmul_df.py:556",
    spec=DataflowSpec(anchor=WS, aux={OS: Residency.STRIPE}, block=BLOCK),
))
IS_STRIPE = register_kernel(KernelRegistration(
    name="matmul_is_stripe", source=_SRC + "matmul_is_stripe.cu",
    replaces="src/repro/kernels/matmul_df.py:643",
    spec=DataflowSpec(anchor=IS, aux={OS: Residency.STRIPE}, block=BLOCK),
))
BASIC_OS = DataflowSpec.basic(OS, block=BLOCK)
# B1's bf16 basic OS tiles, counted under their own names beside matmul_os.
PREFILL = register_kernel(KernelRegistration(
    name="matmul_os_prefill", source=_SRC + "gemm_tc.cuh",
    replaces="src/repro/kernels/matmul_df.py:347",
    spec=DataflowSpec.basic(OS, block=PREFILL_TILE),
))
DECODE = register_kernel(KernelRegistration(
    name="matmul_os_decode", source=_SRC + "gemm_tc.cuh",
    replaces="src/repro/kernels/matmul_df.py:347",
    spec=DataflowSpec.basic(OS, block=DECODE_TILE),
))
# B1's int8 basic OS tiles, counted the same way.  The decode tile's
# width depends on the B kind (``plan(...).tile``), so it registers B1's
# basic spec.
I8_PREFILL = register_kernel(KernelRegistration(
    name="matmul_os_i8_prefill", source=_SRC + "gemm_tc_i8.cuh",
    replaces="src/repro/kernels/matmul_df.py:347",
    spec=DataflowSpec.basic(OS, block=I8_PREFILL_TILE),
))
I8_DECODE = register_kernel(KernelRegistration(
    name="matmul_os_i8_decode", source=_SRC + "gemm_tc_i8.cuh",
    replaces="src/repro/kernels/matmul_df.py:347", spec=BASIC_OS,
))
# The cluster walks of B1's residencies, B4, B5a and B5b, counted beside
# their libraries' keys.
OS_CLUSTER = register_kernel(KernelRegistration(
    name="matmul_os_cluster", source=_SRC + "gemm_cluster.cuh",
    replaces="src/repro/kernels/matmul_df.py:347",
    spec=DataflowSpec(anchor=OS, aux={WS: Residency.STRIPE}, block=BLOCK),
))
RMW_CLUSTER = register_kernel(KernelRegistration(
    name="matmul_rmw_cluster", source=_SRC + "gemm_cluster.cuh",
    replaces="src/repro/kernels/matmul_df.py:476",
    spec=DataflowSpec(anchor=WS, block=BLOCK),
))
WS_STRIPE_CLUSTER = register_kernel(KernelRegistration(
    name="matmul_ws_stripe_cluster", source=_SRC + "gemm_cluster.cuh",
    replaces="src/repro/kernels/matmul_df.py:556",
    spec=DataflowSpec(anchor=WS, aux={OS: Residency.STRIPE}, block=BLOCK),
))
IS_STRIPE_CLUSTER = register_kernel(KernelRegistration(
    name="matmul_is_stripe_cluster", source=_SRC + "gemm_cluster.cuh",
    replaces="src/repro/kernels/matmul_df.py:643",
    spec=DataflowSpec(anchor=IS, aux={OS: Residency.STRIPE}, block=BLOCK),
))
_CLUSTER_TILES = {"matmul_os": OS_CLUSTER.name,
                  "matmul_rmw": RMW_CLUSTER.name,
                  "matmul_ws_stripe": WS_STRIPE_CLUSTER.name,
                  "matmul_is_stripe": IS_STRIPE_CLUSTER.name}
# B6 has no kernel of its own: it is the packed-plane decode inside these
# GEMMs' and the conv's tile loads, counted under its own launch key.
UNPACK = register_kernel(KernelRegistration(
    name=_build.PACKED_DECODE, source=_SRC + "pack_common.cuh",
    replaces="src/repro/kernels/pack.py:87", spec=BASIC_OS,
))


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one spec runs at one shape on the card (the GEMM, conv and
    binary planners all return one)."""

    kernel: str                   # key of _build.LAUNCHES
    grid_order: str               # the TPU grid order the walk keeps
    walk: str                     # what a CTA owns and what it sweeps
    ctas: int
    resident: Dict[str, int]      # operand held in shared memory -> bytes
    smem_bytes: int
    args: Tuple[int, ...]         # the entry point's dataflow arguments
    demoted: Optional[str] = None  # an aux the reference also streams
    tile: Tuple[int, int, int] = BLOCK   # a CTA's (bm, bk, bn)
    tile_kernel: Optional[str] = None    # the tile, counted beside kernel
    cluster: Optional[int] = None        # CTAs of a cluster (cluster walks)
    split: Optional[int] = None          # parts of k (B8's tensor-core tiles)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _ring_bytes(tile: Tuple[int, int, int], stages: int) -> int:
    bm, bk, bn = tile
    return stages * (bm * (bk + 8) + bk * (bn + 8)) * 2


def _i8_ring_bytes(tile: Tuple[int, int, int], stages: int,
                   weight_bits: Optional[int]) -> int:
    """An int8 tile's ring: A rows of bk bytes (+32 when bk % 64 == 0,
    for conflict-free fragment loads), and B as int8 or as the packed
    planes' words, rows of bn + 8 words."""
    bm, bk, bn = tile
    a_ld = bk + 32 if bk % 64 == 0 else bk
    b = bk * bn if weight_bits is None else (
        (bk // pack.WORD_NIBBLES
         + (bk // pack.WORD_BITS if weight_bits == 5 else 0)) * (bn + 8) * 4)
    return stages * (bm * a_ld + b)


def _held(res: Residency) -> bool:
    return res in (Residency.STRIPE, Residency.WHOLE)


def _pow2_ceil(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def cluster_size(anchors: int, g: int, lo: int = 1) -> int:
    """CTAs of a cluster for a sweep of ``g`` tiles under ``anchors``
    clusters (``csrc/gemm_cluster.cuh`` ``cl::cluster_size``): doubled from
    2 while the card has SMs without a CTA, up to ``MAX_CLUSTER`` and to
    ``g``; at least ``lo``."""
    c = 2
    while c < MAX_CLUSTER and 2 * c <= g and anchors * c < CARD_SMS:
        c *= 2
    return max(c, lo)


def cluster_tiles(g: int, cluster: int, rank: int) -> range:
    """The tiles of a sweep of ``g`` that CTA ``rank`` of a cluster walks
    (and, of a resident operand's ``g`` slots, the ones it fetches)."""
    return range(rank, g, cluster)


def _bar_bytes(ring: int) -> int:
    """The cluster kernels' mbarriers (``cl::bar_bytes``): one, and two a
    ring slot, 8 bytes each, in 128-byte lines."""
    return _cdiv(8 * (1 + 2 * ring), 128) * 128


def cluster_walk_smem(walk: str, a_res: bool, b_res: Residency, m: int,
                      k: int, n: int) -> int:
    """Shared memory of a cluster walk of B1/B4 (``cl::walk_smem``):
    ``walk`` "M" (a column stripe's CTAs split the row tiles) or "N"; the
    resident A row stripe (``a_res`` under "N", ``ra`` rows a k step) and
    B panel in 4 KB k steps, then the streamed operand's ring (under "M"
    with ``a_res``, the row stripe: all its k steps, at least 2), then the
    mbarriers (none beside an A stripe of fewer than 64 rows)."""
    ks, gn = _cdiv(k, BLOCK[1]), _cdiv(n, BLOCK[2])
    ra = min(BLOCK[0], _cdiv(m, 4) * 4) if walk == "N" and a_res else BLOCK[0]
    tma = ra == BLOCK[0]
    blocks = {Residency.STRIPE: 1, Residency.WHOLE: gn}.get(b_res, 0)
    held = (ks * ra * 64 if walk == "N" and a_res else 0) + \
        blocks * ks * CLUSTER_SLOT
    if walk == "M" and a_res:
        ring = max(2, ks)
    elif walk == "M" or not a_res or b_res == Residency.STREAMED:
        most = held + (_bar_bytes(CLUSTER_RING) if tma else 0)
        ring = min(CLUSTER_RING, max(0, MAX_SMEM - most) // CLUSTER_SLOT)
    else:
        ring = 0
    return held + ring * CLUSTER_SLOT + (_bar_bytes(ring) if tma else 0)


def stripe_cluster_smem(tiles: int, cluster: int) -> int:
    """Shared memory of B5a's and B5b's cluster kernels over a sweep of
    ``tiles`` row (B5a) or column (B5b) tiles (``cl::stripe_smem``):
    ``STRIPE_SLOTS`` chunks of the multicast operand and of the busiest
    CTA's streamed tiles, and the mbarriers."""
    return (STRIPE_SLOTS * STRIPE_KC * CLUSTER_SLOT
            * (1 + _cdiv(tiles, cluster)) + _bar_bytes(STRIPE_SLOTS))


def _cluster_plan(p: "Plan", dtype: torch.dtype, m: int, k: int,
                  n: int) -> "Plan":
    """``p`` as launched: a bf16 resident walk of B1/B4, B5a or B5b over
    a sweep of two tiles or more (B5b: at most ``STRIPE_TILES *
    MAX_CLUSTER``) takes its cluster walk; anything else is ``p``
    itself."""
    if dtype != torch.bfloat16 or p.kernel not in _CLUSTER_TILES:
        return p
    gm, gn = _cdiv(m, BLOCK[0]), _cdiv(n, BLOCK[2])
    if p.kernel == "matmul_ws_stripe":
        if gm < 2:
            return p
        c = cluster_size(gn, gm, _pow2_ceil(_cdiv(gm, STRIPE_TILES)))
        return dataclasses.replace(
            p, tile_kernel=WS_STRIPE_CLUSTER.name, cluster=c, ctas=gn * c,
            smem_bytes=stripe_cluster_smem(gm, c),
            walk=(f"cluster of {c} CTAs per column stripe j, CTA r owning "
                  f"row tiles r, r+{c}, ... (stripe in registers), weight "
                  f"chunks multicast, sweeps k"))
    if p.kernel == "matmul_is_stripe":
        if not 2 <= gn <= STRIPE_TILES * MAX_CLUSTER:
            return p
        c = cluster_size(gm, gn, _pow2_ceil(_cdiv(gn, STRIPE_TILES)))
        return dataclasses.replace(
            p, tile_kernel=IS_STRIPE_CLUSTER.name, cluster=c, ctas=gm * c,
            smem_bytes=stripe_cluster_smem(gn, c),
            walk=(f"cluster of {c} CTAs per row stripe i, CTA r owning "
                  f"column tiles r, r+{c}, ... (stripe in registers), input "
                  f"chunks multicast, sweeps k"))
    res_of = {code: res for res, code in _B_RES_CODES.items()}
    if p.kernel == "matmul_os":          # args (a_stripe, b_res)
        a_res, b_res = bool(p.args[0]), res_of[p.args[1]]
        walk = "M" if b_res == Residency.STRIPE else "N"
    else:                                # args (m_minor, a_stripe, b_res)
        walk = "M" if p.args[0] else "N"
        a_res, b_res = bool(p.args[1]), res_of[p.args[2]]
    anchors, g = (gn, gm) if walk == "M" else (gm, gn)
    if g < 2:
        return p
    c = cluster_size(anchors, g)
    return dataclasses.replace(
        p, tile_kernel=_CLUSTER_TILES[p.kernel], cluster=c, ctas=anchors * c,
        smem_bytes=cluster_walk_smem(walk, a_res, b_res, m, k, n),
        walk=(f"cluster of {c} CTAs per {'column' if walk == 'M' else 'row'}"
              f" stripe, resident operands multicast, CTA r sweeps "
              f"{'i' if walk == 'M' else 'j'} = r, r+{c}, ..."))


def panel_bytes(rows: int, width: int, elt: int,
                weight_bits: Optional[int] = None) -> int:
    """Bytes of a resident (rows, width) B panel: ``elt`` bytes an
    element, or the packed planes' words (rows a multiple of 32)."""
    if weight_bits is None:
        return rows * width * elt
    words = rows // pack.WORD_NIBBLES + (
        rows // pack.WORD_BITS if weight_bits == 5 else 0)
    return words * width * 4


@functools.lru_cache(maxsize=4096)   # every GEMM launch plans; shapes repeat
def plan(spec: DataflowSpec, m: int, k: int, n: int,
         dtype: torch.dtype = torch.bfloat16,
         weight_bits: Optional[int] = None) -> Plan:
    """The kernel, walk and resident operands of ``spec`` at (m, k, n)
    with A of ``dtype`` and B of the same type, or (int8 A) B's packed
    planes at ``weight_bits``, following the reference's dispatch
    (``repro/kernels/matmul_df.py:_build_os/_build_rmw/_build_ws/
    _build_is``).  Raises ``ValueError`` for a block other than the
    compiled one, or when the resident operands need more shared memory
    than a block has."""
    if tuple(spec.block) != BLOCK:
        raise ValueError(f"the GEMM kernels are compiled for block {BLOCK}, "
                         f"got {tuple(spec.block)}")
    elt = dtype.itemsize
    bm, bk, bn = BLOCK
    gm, gn = _cdiv(m, bm), _cdiv(n, bn)
    kp, np_ = _cdiv(k, bk) * bk, gn * bn
    ra = min(bm, _cdiv(m, 4) * 4)          # rows of a resident A stripe
    res_a, res_b, res_o = (spec.residency(IS), spec.residency(WS),
                           spec.residency(OS))
    b_kind = "" if weight_bits is None else f" packed {weight_bits}-bit"
    acc = "f32" if dtype.is_floating_point else "int32"
    a_stripe_bytes = kp * ra * elt
    b_stripe_bytes = panel_bytes(kp, bn, elt, weight_bits)
    b_whole_bytes = panel_bytes(kp, np_, elt, weight_bits)
    demoted = None
    resident: Dict[str, int] = {}

    if spec.anchor == OS:
        a_res = _held(res_a)
        if a_res:
            resident[f"A row stripe ({ra}, {kp})"] = a_stripe_bytes
        if res_b == Residency.STRIPE:
            resident[f"B column stripe ({kp}, {bn}){b_kind}"] = \
                b_stripe_bytes
            order, ctas = "(gn, gm, gk)", gn
            walk = "CTA per column stripe j, sweeps i"
        elif res_b == Residency.WHOLE:
            resident[f"B whole ({kp}, {np_}){b_kind}"] = b_whole_bytes
            order, ctas = "(gm, gn, gk)", gm
            walk = "CTA per row stripe i, sweeps j"
        elif a_res:
            order, ctas = "(gm, gn, gk)", gm
            walk = "CTA per row stripe i, sweeps j"
        else:
            order, ctas = "(gm, gn, gk)", gm * gn
            walk = "CTA per output tile"
        kernel = "matmul_os"
        args = (int(a_res), _B_RES_CODES[res_b])
        smem = ((0 if a_res else TILE_BYTES)
                + (0 if res_b != Residency.STREAMED else TILE_BYTES)
                + sum(resident.values()))
        if dtype in (torch.bfloat16, torch.int8) and not resident:
            decode = m <= DECODE_M
            if dtype == torch.bfloat16:
                tile_kernel, tile, stages = (
                    (DECODE.name, DECODE_TILE, DECODE_STAGES) if decode
                    else (PREFILL.name, PREFILL_TILE, PREFILL_STAGES))
                smem, cores = _ring_bytes(tile, stages), "tensor cores"
            else:
                tile_kernel, tile, stages = (
                    (I8_PREFILL.name, I8_PREFILL_TILE, I8_PREFILL_STAGES)
                    if not decode else
                    (I8_DECODE.name, I8_DECODE_TILE, I8_DECODE_STAGES)
                    if weight_bits is None else
                    (I8_DECODE.name, PACKED_DECODE_TILE, PACKED_DECODE_STAGES))
                smem = _i8_ring_bytes(tile, stages, weight_bits)
                cores = "int8 tensor cores"
            ctas = _cdiv(m, tile[0]) * _cdiv(n, tile[2])
            walk = (f"CTA per {tile[0]}x{tile[2]} output tile on the "
                    f"{cores}, {stages}-stage cp.async ring")
            return Plan(kernel=kernel, grid_order=order, walk=walk,
                        ctas=ctas, resident=resident, smem_bytes=smem,
                        args=args, tile=tile, tile_kernel=tile_kernel)
    elif spec.anchor == WS and _held(res_o):
        if res_a != Residency.STREAMED:
            demoted = (f"IS {res_a.value} aux streamed: the output-stripe "
                       f"kernel takes (bm, bk) input blocks "
                       f"(repro/kernels/matmul_df.py:560)")
        resident[f"output column stripe ({_cdiv(m, 4) * 4}, {bn}) {acc}"] = \
            _cdiv(m, 4) * 4 * bn * 4
        kernel, order, ctas, args = "matmul_ws_stripe", "(gn, gk, gm)", gn, ()
        walk = "CTA per column stripe j, sweeps k then i"
        smem = 2 * TILE_BYTES + sum(resident.values())
    elif spec.anchor == WS:
        a_res = _held(res_a)
        resident[f"B column stripe ({kp}, {bn}){b_kind}"] = b_stripe_bytes
        if a_res:
            resident[f"A row stripe ({ra}, {kp}), per i"] = a_stripe_bytes
        kernel, order, ctas = "matmul_rmw", "(gn, gm, gk)", gn
        walk = "CTA per column stripe j, sweeps i"
        args = (1, int(a_res), _B_RES_CODES[Residency.STRIPE])
        smem = (0 if a_res else TILE_BYTES) + sum(resident.values())
    elif _held(res_o):                       # IS with the output stripe
        b_whole = res_b == Residency.WHOLE
        if res_b == Residency.STRIPE:
            demoted = ("WS stripe aux streamed: the output-stripe kernel "
                       "takes (bk, bn) weight blocks "
                       "(repro/kernels/matmul_df.py:627)")
        resident[f"output row stripe ({ra}, {np_}) {acc}"] = ra * np_ * 4
        if b_whole:
            resident[f"B whole ({kp}, {np_}){b_kind}"] = b_whole_bytes
        kernel, order, ctas = "matmul_is_stripe", "(gm, gk, gn)", gm
        walk = "CTA per row stripe i, sweeps k then j"
        args = (int(b_whole),)
        smem = TILE_BYTES * (1 if b_whole else 2) + sum(resident.values())
    else:                                    # basic IS
        b_res = res_b
        if b_res == Residency.STRIPE:
            demoted = ("WS stripe aux streamed: it cannot survive the m "
                       "sweep (repro/kernels/matmul_df.py:428-429)")
            b_res = Residency.STREAMED
        resident[f"A row stripe ({ra}, {kp})"] = a_stripe_bytes
        if b_res == Residency.WHOLE:
            resident[f"B whole ({kp}, {np_}){b_kind}"] = b_whole_bytes
        kernel, order, ctas = "matmul_rmw", "(gm, gn, gk)", gm
        walk = "CTA per row stripe i, sweeps j"
        args = (0, 1, _B_RES_CODES[b_res])
        smem = ((TILE_BYTES if b_res == Residency.STREAMED else 0)
                + sum(resident.values()))
    if smem > MAX_SMEM:
        held = ", ".join(f"{name} {size} B" for name, size in resident.items())
        raise ValueError(
            f"{spec.name} at M={m} K={k} N={n} ({dtype}{b_kind}) "
            f"needs {smem} bytes of shared memory per block ({held}); a "
            f"Hopper block has {MAX_SMEM}")
    return _cluster_plan(Plan(kernel=kernel, grid_order=order, walk=walk,
                              ctas=ctas, resident=resident, smem_bytes=smem,
                              args=args, demoted=demoted), dtype, m, k, n)


def check_took(p: Plan, took: Optional[tuple]) -> None:
    """Raise unless the tile a ``matmul_os``, ``matmul_rmw``,
    ``matmul_ws_stripe``, ``matmul_is_stripe`` (or ``binary_mm``,
    ``conv2d``) launch took (``_build.launch``'s
    report, from the CUDA tile configurations) is the one ``p`` planned,
    with its shared memory bytes and CTAs, for a cluster walk its
    cluster size and for B8's tiles the split of k: the planner's copy of
    the tile shapes must not drift from the kernels'."""
    want = None if p.tile_kernel is None else (
        (p.tile_kernel, p.smem_bytes, p.ctas)
        + ((p.cluster,) if p.cluster else ())
        + ((p.split,) if p.split else ()))
    if took != want:
        raise _build.KernelError(
            f"{p.kernel} took the tile {took} (name, shared memory bytes, "
            f"CTAs[, cluster or split]) where its plan says {want}")


def scale_mode(scale: Optional[torch.Tensor]) -> int:
    """0 none, 1 per-tensor (1, 1), 2 per-column (1, N), 3 per-row (M, 1)."""
    if scale is None:
        return 0
    if scale.shape == (1, 1):
        return 1
    if scale.shape[0] == 1:
        return 2
    return 3


def check_operands(a: torch.Tensor, b: torch.Tensor,
                   weight_bits: Optional[int] = None,
                   b_hi: Optional[torch.Tensor] = None) -> None:
    """Float A and B, int8 A and B, or (``weight_bits``) int8 A and B's
    packed int32 planes for round_up(K, 32) rows; raises otherwise."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if weight_bits is None:
        if b.shape[0] != a.shape[1]:
            raise ValueError(f"bad shapes {tuple(a.shape)} @ "
                             f"{tuple(b.shape)}")
        if not ((a.is_floating_point() and b.is_floating_point())
                or a.dtype == b.dtype == torch.int8):
            raise TypeError(f"GEMM operands must both be float or both "
                            f"int8, got {a.dtype} @ {b.dtype}")
        return
    if weight_bits not in WEIGHT_BITS:
        raise ValueError(f"weight_bits must be 4 or 5, got {weight_bits}")
    if a.dtype != torch.int8:
        raise ValueError(f"packed weights need int8 activations, got "
                         f"{a.dtype}")
    kp = _cdiv(a.shape[1], pack.WORD_BITS) * pack.WORD_BITS
    if b.dtype != torch.int32 or b.shape[0] * pack.WORD_NIBBLES != kp:
        raise ValueError(f"bad packed shapes: a {tuple(a.shape)} vs nibble "
                         f"plane {tuple(b.shape)} {b.dtype}")
    if weight_bits == 5:
        want = (kp // pack.WORD_BITS, b.shape[1])
        if b_hi is None or tuple(b_hi.shape) != want \
                or b_hi.dtype != torch.int32:
            raise ValueError(f"weight_bits=5 needs the int32 bit plane "
                             f"{want}, got "
                             f"{None if b_hi is None else tuple(b_hi.shape)}")


def _int_output_ok(a: torch.Tensor, stages: bool,
                   out_dtype: torch.dtype) -> None:
    allowed = ((torch.int32, torch.float32, torch.bfloat16)
               if not a.is_floating_point() and not stages
               else (torch.float32, torch.bfloat16))
    if out_dtype not in allowed:
        raise TypeError(f"the GEMM kernels write {allowed} here, got "
                        f"{out_dtype}")


def matmul_df(
    a: torch.Tensor,                          # (M, K)
    b: torch.Tensor,                          # (K, N), or (K_pad/8, N) words
    spec: DataflowSpec,
    scale: Optional[torch.Tensor] = None,     # (1, 1), (1, N) or (M, 1) f32
    bias: Optional[torch.Tensor] = None,      # (1, N) f32
    residual: Optional[torch.Tensor] = None,  # (M, N)
    activation: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
    weight_bits: Optional[int] = None,
    b_hi: Optional[torch.Tensor] = None,      # (K_pad/32, N) int32, 5 bits
    outlier_idx: Optional[torch.Tensor] = None,    # (R,) int32
    outlier_delta: Optional[torch.Tensor] = None,  # (R, N) int32
) -> torch.Tensor:
    """``act(scale * (a @ b) + bias) + residual`` in one launch of the
    kernel ``plan(spec, ...)`` names.  The output is float32 by default,
    int32 for int8 operands without an epilogue stage.  With
    ``weight_bits``, ``b`` (and ``b_hi``) are a packed weight's planes
    and ``(outlier_idx, outlier_delta)`` its sidecar (slots at or past K
    empty)."""
    check_operands(a, b, weight_bits, b_hi)
    if (outlier_idx is None) != (outlier_delta is None) or (
            outlier_idx is not None and weight_bits is None):
        raise ValueError("the outlier sidecar needs both its idx and delta, "
                         "and packed weights")
    m, k = a.shape
    n = b.shape[1]
    p = plan(spec, m, k, n, a.dtype, weight_bits)
    stages = any(t is not None for t in (scale, bias, residual, activation))
    out_dtype = out_dtype or (torch.int32 if not a.is_floating_point()
                              and not stages else torch.float32)
    _int_output_ok(a, stages, out_dtype)
    if outlier_idx is not None and (
            tuple(outlier_delta.shape) != (outlier_idx.shape[0], n)):
        raise ValueError(f"outlier delta shape {tuple(outlier_delta.shape)} "
                         f"!= ({outlier_idx.shape[0]}, {n})")
    if a.device.type == "cpu":
        if weight_bits is not None:
            b = pack.unpack_planes(b, b_hi, weight_bits, k, outlier_idx,
                                   outlier_delta)
        if not stages:
            return ref.matmul_ref(a, b, out_dtype)
        return ref.matmul_fused_ref(a, b, bias=bias, scale=scale,
                                    residual=residual, activation=activation,
                                    out_dtype=out_dtype)
    if weight_bits is None and a.dtype != b.dtype:
        raise TypeError(f"operand dtypes differ: {a.dtype} vs {b.dtype}")
    epi = Epilogue(bias=bias is not None, activation=activation,
                   scale=scale is not None, residual=residual is not None)
    if scale is not None:
        scale = scale.float().contiguous()
        if scale.shape not in ((1, 1), (1, n), (m, 1)):
            raise ValueError(f"scale shape {tuple(scale.shape)} != "
                             f"(1,1)/(1,{n})/({m},1)")
    if bias is not None:
        bias = bias.float().contiguous()
        if bias.shape != (1, n):
            raise ValueError(f"bias shape {tuple(bias.shape)} != (1, {n})")
    if residual is not None:
        residual = residual.float().contiguous()
        if residual.shape != (m, n):
            raise ValueError(f"residual shape {tuple(residual.shape)} != "
                             f"({m}, {n})")
    a, b = a.contiguous(), b.contiguous()
    r = 0
    if outlier_idx is not None and outlier_idx.shape[0]:
        r = outlier_idx.shape[0]
        outlier_idx = outlier_idx.to(torch.int32).contiguous()
        outlier_delta = outlier_delta.to(torch.int32).contiguous()
    else:
        outlier_idx = outlier_delta = None
    if b_hi is not None:
        b_hi = b_hi.contiguous()
    _build.refuse_grad(p.kernel + (" (packed weights: B6)" if weight_bits
                                   else ""), a, b, scale, bias, residual)
    _build.require_cuda(a, b, scale, bias, residual, b_hi, outlier_idx,
                        outlier_delta)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    took = _build.launch(
        p.kernel, _build.ptr(a), _build.ptr(b), _build.ptr(out), m, n, k,
        _build.dtype_code(a), _build.dtype_code(out), _build.ptr(scale),
        scale_mode(scale), _build.ptr(bias),
        ACTIVATION_CODES[epi.activation], _build.ptr(residual),
        weight_bits or 0, _build.ptr(b_hi), _build.ptr(outlier_idx),
        _build.ptr(outlier_delta), r, *p.args,
        packed=weight_bits is not None)
    if p.kernel in _build.TILE_LIBRARIES:
        check_took(p, took)
    return out


def matmul_os(
    a: torch.Tensor,                          # (M, K)
    b: torch.Tensor,                          # (K, N)
    scale: Optional[torch.Tensor] = None,     # (1, 1), (1, N) or (M, 1) f32
    bias: Optional[torch.Tensor] = None,      # (1, N) f32
    residual: Optional[torch.Tensor] = None,  # (M, N)
    activation: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """B1 under the basic OS dataflow, the serving path's GEMM:
    ``act(scale * (a @ b) + bias) + residual`` in one kernel launch."""
    return matmul_df(a, b, BASIC_OS, scale=scale, bias=bias,
                     residual=residual, activation=activation,
                     out_dtype=out_dtype)
