"""B8: the direct NHWC convolution with its fused epilogue, as a CUDA
kernel.

Port of ``repro/kernels/conv2d_df.py``: ``conv2d_df`` computes the VALID
convolution of x (N, H, W, Cin) with w (fh, fw, Cin, Cout) at stride s,
float inputs (f32, bf16) accumulated in f32 and int8 inputs exactly in
int32, and applies the ``Epilogue`` at the flush: ``act(scale * acc +
bias) + residual`` in f32, scale (1, 1) or (1, Cout).
``csrc/conv2d.cu`` replaces ``_conv_kernel``; every anchor sums the
reduction (ky, kx, cin) in one ascending order, so every anchor gives
the OS anchor's bits.

A CTA owns 64 consecutive output pixels of one image by 64 output
channels and masks Cin, Cout and the pixel count at the edges, so
nothing is padded (the reference pads channels to 128 lanes and halo
rows for its window loads, ``ops._conv_pad``; the outputs are the same).
``plan`` names each anchor's walk (OS: a CTA per output tile; WS: a CTA
per 64-channel tile holds its (fh, fw, Cin, 64) weight block and walks
every pixel tile; IS: a CTA per image holds the image (H, W, Cin) and
walks the channel and pixel tiles) and raises ``ValueError`` naming the
bytes where the resident operand does not fit a block's 227 KB beside
the two staging tiles.  The reference's conv kernel reads only the
anchor of a spec, and so does this one.

For CPU tensors the wrapper computes the kernel's plain version,
``ref.conv2d_fused_ref``; for CUDA tensors it launches the kernel or
raises.  Packed (int4/int5) weights are not ported yet (ROADMAP A8).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.dataflow import (ConvProblem, DataflowSpec, Epilogue,
                                       KernelRegistration, IS, OS, WS,
                                       register_kernel)
from repro_torch.kernels import _build, ref
from repro_torch.kernels.matmul_df import (ACTIVATION_CODES, MAX_SMEM, Plan,
                                         scale_mode)

BLOCK = (64, 32, 64)       # (output pixels, reduction step, output channels)
TILE_BYTES = 2 * BLOCK[1] * (BLOCK[0] + 4) * 4   # the two staging tiles
WALKS = {OS: 0, WS: 1, IS: 2}

REGISTRATION = register_kernel(KernelRegistration(
    name="conv2d", source="src/repro_torch/kernels/csrc/conv2d.cu",
    replaces="src/repro/kernels/conv2d_df.py:276",
    spec=DataflowSpec.basic(OS, block=BLOCK),
))
BASIC_OS = DataflowSpec.basic(OS, block=BLOCK)
IN_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def plan(spec: DataflowSpec, conv: ConvProblem,
         dtype: torch.dtype = torch.float32) -> Plan:
    """The walk and resident operand of ``spec``'s anchor for ``conv``
    with inputs of ``dtype`` (the grid orders of
    ``repro/kernels/conv2d_df.py:conv2d_df``).  Raises ``ValueError``
    when the resident operand does not fit a block's shared memory."""
    elt = dtype.itemsize
    pix, bk, bn = BLOCK
    tiles = _cdiv(conv.oh * conv.ow, pix)
    gn = _cdiv(conv.cout, bn)
    k = conv.fh * conv.fw * conv.cin
    resident: Dict[str, int] = {}
    if spec.anchor == OS:
        order, ctas = "(n, goh, gk, r)", conv.n * tiles * gn
        walk = "CTA per (image, pixel tile, channel tile)"
    elif spec.anchor == WS:
        resident[f"weight block ({conv.fh}, {conv.fw}, {conv.cin}, {bn}) "
                 f"{dtype}"] = _cdiv(k, bk) * bk * bn * elt
        order, ctas = "(gk, n, goh, r)", gn
        walk = "CTA per channel tile, sweeps (image, pixel tile)"
    elif spec.anchor == IS:
        resident[f"image ({conv.ih}, {conv.iw}, {conv.cin}) {dtype}"] = \
            _cdiv(conv.ih * conv.iw * conv.cin * elt, 16) * 16
        order, ctas = "(n, gk, goh, r)", conv.n
        walk = "CTA per image, sweeps (channel tile, pixel tile)"
    else:
        raise ValueError(f"conv anchor must be OS, WS or IS, got "
                         f"{spec.anchor!r}")
    smem = TILE_BYTES + sum(resident.values())
    if smem > MAX_SMEM:
        held = ", ".join(f"{name} {size} B" for name, size in
                         resident.items())
        raise ValueError(
            f"conv {spec.name} at {conv.n}x{conv.ih}x{conv.iw}x{conv.cin} "
            f"f{conv.fh}x{conv.fw} s{conv.s} -> {conv.cout} ({dtype}) needs "
            f"{smem} bytes of shared memory per block ({held}); a Hopper "
            f"block has {MAX_SMEM}")
    return Plan(kernel="conv2d", grid_order=order, walk=walk, ctas=ctas,
                resident=resident, smem_bytes=smem,
                args=(WALKS[spec.anchor],))


def problem(x: torch.Tensor, w: torch.Tensor, stride: int) -> ConvProblem:
    """The ``ConvProblem`` of a conv of ``x`` with ``w``, checked."""
    if x.ndim != 4 or w.ndim != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"bad conv shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} (NHWC x (fh, fw, Cin, Cout))")
    n, ih, iw, cin = x.shape
    fh, fw, _, cout = w.shape
    if stride < 1 or ih < fh or iw < fw:
        raise ValueError(f"a VALID conv of {ih}x{iw} with {fh}x{fw} at "
                         f"stride {stride} has no output")
    return ConvProblem(ih=ih, iw=iw, fh=fh, fw=fw, s=stride, cin=cin,
                       cout=cout, n=n)


def _not_packed(weight_bits: Optional[int]) -> None:
    if weight_bits is not None:
        raise NotImplementedError(
            "packed int4/int5 conv weights are not ported yet (ROADMAP A8)")


def conv2d_df(
    x: torch.Tensor,                          # (N, H, W, Cin)
    w: torch.Tensor,                          # (fh, fw, Cin, Cout)
    stride: int,
    spec: DataflowSpec,
    out_dtype: Optional[torch.dtype] = None,
    epilogue: Optional[Epilogue] = None,
    scale: Optional[torch.Tensor] = None,     # (1, 1) or (1, Cout) float32
    bias: Optional[torch.Tensor] = None,      # (1, Cout) float32
    residual: Optional[torch.Tensor] = None,  # (N, oh, ow, Cout)
    weight_bits: Optional[int] = None,
) -> torch.Tensor:
    """Direct conv under ``spec``'s anchor, the epilogue applied before
    the one output write, in one kernel launch.  Returns (N, oh, ow,
    Cout): int32 for int8 inputs without an epilogue, float32 otherwise
    (or ``out_dtype``)."""
    _not_packed(weight_bits)
    conv = problem(x, w, stride)
    if x.dtype not in IN_DTYPES or w.dtype != x.dtype:
        raise TypeError(f"conv operands must share one of {IN_DTYPES}, got "
                        f"{x.dtype} and {w.dtype}")
    p = plan(spec, conv, x.dtype)
    epi = epilogue if (epilogue is not None and not epilogue.is_noop) \
        else None
    cout = conv.cout
    out_shape: Tuple[int, ...] = (conv.n, conv.oh, conv.ow, cout)
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
        if scale is not None and tuple(scale.shape) not in ((1, 1),
                                                            (1, cout)):
            raise ValueError(f"scale shape {tuple(scale.shape)} != "
                             f"(1,1)/(1,{cout})")
        if bias is not None and tuple(bias.shape) != (1, cout):
            raise ValueError(f"bias shape {tuple(bias.shape)} != "
                             f"(1, {cout})")
        if residual is not None and tuple(residual.shape) != out_shape:
            raise ValueError(f"residual shape {tuple(residual.shape)} != "
                             f"{out_shape}")
    integer = not x.is_floating_point()
    out_dtype = out_dtype or (torch.int32 if integer and epi is None
                              else torch.float32)
    allowed = ((torch.int32, torch.float32, torch.bfloat16)
               if integer and epi is None
               else (torch.float32, torch.bfloat16))
    if out_dtype not in allowed:
        raise TypeError(f"the conv kernel writes {allowed} here, got "
                        f"{out_dtype}")
    if x.device.type == "cpu":
        if epi is None:
            return ref.conv2d_ref(x, w, stride, out_dtype=out_dtype)
        return ref.conv2d_fused_ref(
            x, w, stride, bias=bias, scale=scale, residual=residual,
            activation=epi.activation, out_dtype=out_dtype)
    scale, bias, residual = (None if t is None else t.float().contiguous()
                             for t in (scale, bias, residual))
    x, w = x.contiguous(), w.contiguous()
    _build.require_cuda(x, w, scale, bias, residual)
    out = torch.empty(out_shape, dtype=out_dtype, device=x.device)
    _build.launch(
        p.kernel, _build.ptr(x), _build.ptr(w), _build.ptr(out), conv.n,
        conv.ih, conv.iw, conv.cin, conv.fh, conv.fw, stride, cout,
        _build.dtype_code(x), _build.dtype_code(out), _build.ptr(scale),
        scale_mode(scale), _build.ptr(bias),
        ACTIVATION_CODES[epi.activation if epi else None],
        _build.ptr(residual), *p.args)
    return out
