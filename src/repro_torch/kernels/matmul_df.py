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

"Resident" means held in the CTA's shared memory across a walk over the
grid dimension the TPU kernel revisits the operand in.  ``plan`` names
the kernel, the walk and the resident operands with their bytes, and
raises ``ValueError`` where they do not fit in a block's 227 KB, as a
TPU compile over VMEM fails: no spec runs another dataflow instead.

Every kernel tiles 64x64 outputs over 32-deep k steps and sums k in
ascending order with one fmaf per step, so for f32 accumulation every
dataflow gives B1's bits, and a row's result does not depend on the
batch it is in.  The reference's float output-stripe kernels accumulate
in the output dtype (bf16 for a bf16 output); these always accumulate in
f32 (ROADMAP C).

Each wrapper launches its kernel for CUDA tensors and raises for what it
does not take; for CPU tensors it computes the kernels' plain version,
``ref.matmul_fused_ref``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.dataflow import (DataflowSpec, Epilogue,
                                       KernelRegistration, Residency, IS, OS,
                                       WS, register_kernel)
from repro_torch.kernels import _build, ref

BLOCK = (64, 32, 64)               # (bm, bk, bn) of csrc/gemm_common.cuh
ACTIVATION_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3}
MAX_SMEM = 232_448                 # bytes of shared memory a block can use
# One streamed f32 tile with its padded rows, in bytes.
TILE_BYTES = BLOCK[1] * (BLOCK[0] + 4) * 4
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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _held(res: Residency) -> bool:
    return res in (Residency.STRIPE, Residency.WHOLE)


@functools.lru_cache(maxsize=4096)   # every GEMM launch plans; shapes repeat
def plan(spec: DataflowSpec, m: int, k: int, n: int,
         dtype: torch.dtype = torch.bfloat16) -> Plan:
    """The kernel, walk and resident operands of ``spec`` at (m, k, n)
    with operands of ``dtype``, following the reference's dispatch
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
    a_stripe_bytes = kp * ra * elt
    b_stripe_bytes = kp * bn * elt
    b_whole_bytes = kp * np_ * elt
    demoted = None
    resident: Dict[str, int] = {}

    if spec.anchor == OS:
        a_res = _held(res_a)
        if a_res:
            resident[f"A row stripe ({ra}, {kp})"] = a_stripe_bytes
        if res_b == Residency.STRIPE:
            resident[f"B column stripe ({kp}, {bn})"] = b_stripe_bytes
            order, ctas = "(gn, gm, gk)", gn
            walk = "CTA per column stripe j, sweeps i"
        elif res_b == Residency.WHOLE:
            resident[f"B whole ({kp}, {np_})"] = b_whole_bytes
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
    elif spec.anchor == WS and _held(res_o):
        if res_a != Residency.STREAMED:
            demoted = (f"IS {res_a.value} aux streamed: the output-stripe "
                       f"kernel takes (bm, bk) input blocks "
                       f"(repro/kernels/matmul_df.py:560)")
        resident[f"output column stripe ({_cdiv(m, 4) * 4}, {bn}) f32"] = \
            _cdiv(m, 4) * 4 * bn * 4
        kernel, order, ctas, args = "matmul_ws_stripe", "(gn, gk, gm)", gn, ()
        walk = "CTA per column stripe j, sweeps k then i"
        smem = 2 * TILE_BYTES + sum(resident.values())
    elif spec.anchor == WS:
        a_res = _held(res_a)
        resident[f"B column stripe ({kp}, {bn})"] = b_stripe_bytes
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
        resident[f"output row stripe ({ra}, {np_}) f32"] = ra * np_ * 4
        if b_whole:
            resident[f"B whole ({kp}, {np_})"] = b_whole_bytes
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
            resident[f"B whole ({kp}, {np_})"] = b_whole_bytes
        kernel, order, ctas = "matmul_rmw", "(gm, gn, gk)", gm
        walk = "CTA per row stripe i, sweeps j"
        args = (0, 1, _B_RES_CODES[b_res])
        smem = ((TILE_BYTES if b_res == Residency.STREAMED else 0)
                + sum(resident.values()))
    if smem > MAX_SMEM:
        held = ", ".join(f"{name} {size} B" for name, size in resident.items())
        raise ValueError(
            f"{spec.name} at M={m} K={k} N={n} ({dtype}) needs {smem} bytes "
            f"of shared memory per block ({held}); a Hopper block has "
            f"{MAX_SMEM}")
    return Plan(kernel=kernel, grid_order=order, walk=walk, ctas=ctas,
                resident=resident, smem_bytes=smem, args=args,
                demoted=demoted)


def scale_mode(scale: Optional[torch.Tensor]) -> int:
    """0 none, 1 per-tensor (1, 1), 2 per-column (1, N), 3 per-row (M, 1)."""
    if scale is None:
        return 0
    if scale.shape == (1, 1):
        return 1
    if scale.shape[0] == 1:
        return 2
    return 3


def check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 2 or b.ndim != 2 or b.shape[0] != a.shape[1]:
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if not (a.is_floating_point() and b.is_floating_point()):
        raise NotImplementedError(
            f"int8 GEMM operands are not ported yet (ROADMAP A8), got "
            f"{a.dtype} @ {b.dtype}")


def matmul_df(
    a: torch.Tensor,                          # (M, K)
    b: torch.Tensor,                          # (K, N)
    spec: DataflowSpec,
    scale: Optional[torch.Tensor] = None,     # (1, 1), (1, N) or (M, 1) f32
    bias: Optional[torch.Tensor] = None,      # (1, N) f32
    residual: Optional[torch.Tensor] = None,  # (M, N)
    activation: Optional[str] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``act(scale * (a @ b) + bias) + residual`` in one launch of the
    kernel ``plan(spec, ...)`` names."""
    check_operands(a, b)
    m, k = a.shape
    n = b.shape[1]
    p = plan(spec, m, k, n, a.dtype)
    if a.device.type == "cpu":
        return ref.matmul_fused_ref(a, b, bias=bias, scale=scale,
                                    residual=residual, activation=activation,
                                    out_dtype=out_dtype)
    if a.dtype != b.dtype:
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
    _build.require_cuda(a, b, scale, bias, residual)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    _build.launch(
        p.kernel, _build.ptr(a), _build.ptr(b), _build.ptr(out), m, n, k,
        _build.dtype_code(a), _build.dtype_code(out), _build.ptr(scale),
        scale_mode(scale), _build.ptr(bias),
        ACTIVATION_CODES[epi.activation], _build.ptr(residual), *p.args)
    return out


def matmul_os(
    a: torch.Tensor,                          # (M, K)
    b: torch.Tensor,                          # (K, N)
    scale: Optional[torch.Tensor] = None,     # (1, 1), (1, N) or (M, 1) f32
    bias: Optional[torch.Tensor] = None,      # (1, N) f32
    residual: Optional[torch.Tensor] = None,  # (M, N)
    activation: Optional[str] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """B1 under the basic OS dataflow, the serving path's GEMM:
    ``act(scale * (a @ b) + bias) + residual`` in one kernel launch."""
    return matmul_df(a, b, BASIC_OS, scale=scale, bias=bias,
                     residual=residual, activation=activation,
                     out_dtype=out_dtype)
