"""B9: the binary (+-1, xnor-popcount) GEMM with its fused epilogue, as a
CUDA kernel.

Port of ``repro/kernels/binary_mm.py``: ``binary_mm_df`` computes the
exact +-1 dot ``n_bits - 2 * popcount(a xor b)`` of two bit-packed
operands, A (M, Kp) and B (Kp, N) words (32 binary channels each), and
applies the ``BinaryEpilogue`` at the flush: ``y = scale * dot + bias +
residual`` in float32, each stage rounded on its own, then ``sign(y)``
(``y >= 0`` -> +1) when ``binarize``.  ``csrc/binary_mm.cu`` replaces
``_binary_kernel``.

Words are int32 tensors holding the JAX package's uint32 words bit for
bit (``numpy_array.view(np.int32)``).  Zero words past Kp drop out of the
popcount, so the kernel masks ragged M, N and Kp instead of padding.

``plan`` names the walk of each anchor and raises ``ValueError`` naming
the bytes where a stripe does not fit a block's 227 KB.  The basic OS
launch (serving's) runs on Hopper's binary tensor cores (``mma.sync``
m16n8k256 ``.b1 .and.popc``, the xor count recovered as popc(a) +
popc(b) - 2 popc(a & b)): for M > 16 the prefill tile (a CTA per 64x64
output tile, a 3-stage ``cp.async`` ring of 32-word k stages), for
M <= 16 the decode tile (a CTA per 16 columns, its 8 warps splitting
the k steps); ``plan`` names the tile (``tile_kernel``), and each launch
reports the tile it took, counted under its own name beside
``binary_mm`` and held against the plan (``matmul_df.check_took``).  WS
(a CTA per column stripe, holding B's (Kp, 64) stripe, walks the rows)
and IS (a CTA per row stripe, holding A's (64, Kp) stripe, walks the
columns) keep their xor + popc walk on the CUDA cores.  The reference's
kernel reads only the anchor of a spec, and so does this one.  Integer
counts are exact in any order, so every anchor and both tiles give the
same bits.

For CPU tensors the wrapper computes the kernel's plain version,
``ref.binary_matmul_fused_ref``; for CUDA tensors it launches the kernel
or raises.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch.core.dataflow import (BinaryEpilogue, BinaryProblem,
                                       DataflowSpec, KernelRegistration, IS,
                                       OS, WS, register_kernel)
from repro_torch.kernels import _build, matmul_df, ref
from repro_torch.kernels.matmul_df import MAX_SMEM, Plan

BLOCK = (64, 16, 64)               # (bm, bkp words, bn) of csrc/binary_mm.cu
_LD = BLOCK[0] + 4                 # words per padded tile row
TILE_BYTES = BLOCK[1] * _LD * 4    # one streamed word tile
WALKS = {OS: 0, WS: 1, IS: 2}
# The basic OS launch's tiles (csrc/binary_mm.cu; the CUDA configurations
# are the source, each launch's report is held against this copy): the
# prefill tile's (bm, words a ring stage, bn), stages and (row, column)
# warps, its A rows padded by 4 words and B rows by 8; the decode tile's
# (rows, words a k step, columns), for M <= DECODE_M, with its warps' int32
# partials in shared memory.
PREFILL_TILE, PREFILL_STAGES, PREFILL_WARPS = (64, 32, 64), 3, (4, 2)
DECODE_TILE, DECODE_WARPS = (16, 8, 16), 8
DECODE_M = DECODE_TILE[0]
PREFILL_SMEM = PREFILL_STAGES * (
    PREFILL_TILE[0] * (PREFILL_TILE[1] + 4)
    + PREFILL_TILE[1] * (PREFILL_TILE[2] + 8)) * 4
DECODE_SMEM = DECODE_WARPS * DECODE_TILE[0] * DECODE_TILE[2] * 4

_SRC = "src/repro_torch/kernels/csrc/binary_mm.cu"
_REPLACES = "src/repro/kernels/binary_mm.py:238"
REGISTRATION = register_kernel(KernelRegistration(
    name="binary_mm", source=_SRC, replaces=_REPLACES,
    spec=DataflowSpec.basic(OS, block=BLOCK),
))
BASIC_OS = DataflowSpec.basic(OS, block=BLOCK)
# The basic OS tiles, counted under their own names beside binary_mm.
PREFILL = register_kernel(KernelRegistration(
    name="binary_mm_prefill", source=_SRC, replaces=_REPLACES,
    spec=DataflowSpec.basic(OS, block=PREFILL_TILE),
))
DECODE = register_kernel(KernelRegistration(
    name="binary_mm_decode", source=_SRC, replaces=_REPLACES,
    spec=DataflowSpec.basic(OS, block=DECODE_TILE),
))

# Output types the kernel writes: the raw dot, +-1, or the float image.
RAW_DTYPES = (torch.int32, torch.float32, torch.bfloat16)
SIGN_DTYPES = (torch.int8, torch.int32, torch.float32, torch.bfloat16)
FLOAT_DTYPES = (torch.float32, torch.bfloat16)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def plan(spec: DataflowSpec, m: int, kp: int, n: int) -> Plan:
    """The tile (basic OS: prefill for m > DECODE_M, else decode) or the
    walk and resident stripe (WS, IS) of ``spec``'s anchor at (m, kp, n)
    (``repro/kernels/binary_mm.py:binary_mm_df``'s grid orders).  Raises
    ``ValueError`` for a block other than the compiled one, or when the
    resident stripe and a streamed tile need more shared memory than a
    block has."""
    if tuple(spec.block) != BLOCK:
        raise ValueError(f"the binary kernel is compiled for block {BLOCK}, "
                         f"got {tuple(spec.block)}")
    bm, bkp, bn = BLOCK
    gm, gn = _cdiv(m, bm), _cdiv(n, bn)
    stripe = _cdiv(kp, bkp) * bkp * _LD * 4
    resident: Dict[str, int] = {}
    if spec.anchor == OS:
        if m <= DECODE_M:
            tile_kernel, tile, smem = DECODE.name, DECODE_TILE, DECODE_SMEM
            ctas = _cdiv(n, tile[2])
            walk = (f"CTA per {tile[2]} columns on the binary tensor cores, "
                    f"{DECODE_WARPS} warps splitting the k steps")
        else:
            tile_kernel, tile, smem = PREFILL.name, PREFILL_TILE, PREFILL_SMEM
            ctas = _cdiv(m, tile[0]) * _cdiv(n, tile[2])
            walk = (f"CTA per {tile[0]}x{tile[2]} output tile on the binary "
                    f"tensor cores, {PREFILL_STAGES}-stage cp.async ring")
        return Plan(kernel="binary_mm", grid_order="(gm, gn, gk)", walk=walk,
                    ctas=ctas, resident=resident, smem_bytes=smem,
                    args=(WALKS[OS],), tile=tile, tile_kernel=tile_kernel)
    if spec.anchor == WS:
        resident[f"B column stripe ({kp}, {bn}) words"] = stripe
        order, walk, ctas = "(gn, gm, gk)", \
            "CTA per column stripe j, sweeps i", gn
        smem = TILE_BYTES + stripe
    elif spec.anchor == IS:
        resident[f"A row stripe ({bm}, {kp}) words"] = stripe
        order, walk, ctas = "(gm, gn, gk)", "CTA per row stripe i, sweeps j", gm
        smem = TILE_BYTES + stripe
    else:
        raise ValueError(f"binary anchor must be OS, WS or IS, got "
                         f"{spec.anchor!r}")
    if smem > MAX_SMEM:
        held = ", ".join(f"{k} {v} B" for k, v in resident.items())
        raise ValueError(
            f"binary {spec.name} at M={m} Kp={kp} N={n} needs {smem} bytes "
            f"of shared memory per block ({held}); a Hopper block has "
            f"{MAX_SMEM}")
    return Plan(kernel="binary_mm", grid_order=order, walk=walk, ctas=ctas,
                resident=resident, smem_bytes=smem,
                args=(WALKS[spec.anchor],))


def check_operands(a: torch.Tensor, b: torch.Tensor,
                   n_bits: int) -> BinaryProblem:
    """The ``BinaryProblem`` of packed operands, checked."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"packed operands are int32 words, got {a.dtype} @ "
                        f"{b.dtype}")
    return BinaryProblem(m=a.shape[0], kp=a.shape[1], n=b.shape[1],
                         n_bits=n_bits)


def binary_mm_df(
    a: torch.Tensor,                          # (M, Kp) int32 words
    b: torch.Tensor,                          # (Kp, N) int32 words
    n_bits: int,                              # true reduction depth K
    spec: DataflowSpec,
    out_dtype: Optional[torch.dtype] = None,
    epilogue: Optional[BinaryEpilogue] = None,
    scale: Optional[torch.Tensor] = None,     # (1, 1) or (1, N) float32
    bias: Optional[torch.Tensor] = None,      # (1, N) float32
    residual: Optional[torch.Tensor] = None,  # (M, N)
) -> torch.Tensor:
    """The packed +-1 GEMM under ``spec``'s anchor, with ``epilogue``
    applied before the one output write, in one kernel launch."""
    prob = check_operands(a, b, n_bits)
    m, kp, n = prob.m, prob.kp, prob.n
    p = plan(spec, m, kp, n)
    epi = epilogue if (epilogue is not None and not epilogue.is_noop) \
        else None
    if epi is None:
        scale = bias = residual = None
    else:
        for name, on, arr in (("scale", epi.scale, scale),
                              ("bias", epi.bias, bias),
                              ("residual", epi.residual, residual)):
            if on and arr is None:
                raise ValueError(f"epilogue.{name} set but no {name} array")
        scale = scale if epi.scale else None
        bias = bias if epi.bias else None
        residual = residual if epi.residual else None
        if scale is not None and tuple(scale.shape) not in ((1, 1), (1, n)):
            raise ValueError(f"scale shape {tuple(scale.shape)} != "
                             f"(1,1)/(1,{n})")
        if bias is not None and tuple(bias.shape) != (1, n):
            raise ValueError(f"bias shape {tuple(bias.shape)} != (1, {n})")
        if residual is not None and tuple(residual.shape) != (m, n):
            raise ValueError(f"residual shape {tuple(residual.shape)} != "
                             f"({m}, {n})")
    out_dtype = out_dtype or (torch.int32 if epi is None else torch.int8
                              if epi.binarize else torch.float32)
    allowed = (RAW_DTYPES if epi is None
               else SIGN_DTYPES if epi.binarize else FLOAT_DTYPES)
    if out_dtype not in allowed:
        raise TypeError(f"the binary kernel writes {allowed} for this "
                        f"epilogue, got {out_dtype}")
    if a.device.type == "cpu":
        return ref.binary_matmul_fused_ref(
            a, b, n_bits, scale=scale, bias=bias, residual=residual,
            binarize=epi is not None and epi.binarize, out_dtype=out_dtype)
    scale, bias, residual = (None if t is None else t.float().contiguous()
                             for t in (scale, bias, residual))
    a, b = a.contiguous(), b.contiguous()
    _build.refuse_grad("binary_mm", scale, bias, residual)
    _build.require_cuda(a, b, scale, bias, residual)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    took = _build.launch(
        p.kernel, _build.ptr(a), _build.ptr(b), _build.ptr(out), m, n, kp,
        n_bits, _build.dtype_code(out), _build.ptr(scale),
        matmul_df.scale_mode(scale), _build.ptr(bias), _build.ptr(residual),
        int(epi is not None and epi.binarize), *p.args)
    matmul_df.check_took(p, took)
    return out
