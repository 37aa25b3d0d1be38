"""B8: the direct NHWC convolution with its fused epilogue, as a CUDA
kernel.

Port of ``repro/kernels/conv2d_df.py``: ``conv2d_df`` computes the VALID
convolution of x (N, H, W, Cin) with w (fh, fw, Cin, Cout) at stride s,
float inputs (f32, bf16) accumulated in f32 and int8 inputs exactly in
int32, and applies the ``Epilogue`` at the flush: ``act(scale * acc +
bias) + residual`` in f32, scale (1, 1) or (1, Cout).
``csrc/conv2d.cu`` replaces ``_conv_kernel``; every anchor sums the
reduction (ky, kx, cin) in one order, so every anchor gives the OS
anchor's bits.

int8 (with an int8 or a packed filter) and bf16 convs run on the tensor
cores as an implicit GEMM (``csrc/conv_tc.cuh``): int8 one ``mma.sync``
m16n8k32 ``.s8`` per 32-deep chunk (exact), bf16 one m16n8k16 per 16-deep
chunk of the flat (ky, kx, cin) order, each summed from zero and added
with one rounded f32 add (B1's order).  OS takes the tile of
``OS_TILES`` that first gives every SM two CTAs (bf16: one; else the
narrowest), an integer conv splitting its k steps over up to
``MAX_SPLIT`` CTAs where its tiles alone fall short, merged by the
tile's last CTA.  WS and IS keep
their grids and their resident operand and run the same k step on
``WALK_TILES``, whose rings fit in ``TILE_BYTES``.  ``plan`` names the
tile (``tile_kernel``, counted beside ``conv2d``) with its CTAs, shared
memory and split; the kernel reports what it took and ``check_took``
raises on a difference.  f32 stays on the CUDA cores (one fmaf per
index, no TF32): a CTA owns 64 consecutive output pixels of one image by
64 output channels.

Every kernel masks Cin, Cout and the pixel count at the edges, so
nothing is padded (the reference pads channels to 128 lanes and halo
rows for its window loads, ``ops._conv_pad``; the outputs are the same).
``plan`` names each anchor's walk (OS: a CTA per output tile; WS: a CTA
per 64-channel tile holds its (fh, fw, Cin, 64) weight block and walks
every pixel tile; IS: a CTA per image holds the image (H, W, Cin) and
walks the channel and pixel tiles) and raises ``ValueError`` naming the
bytes where the resident operand does not fit a block's 227 KB beside
the two staging tiles.  The reference's conv kernel reads only the
anchor of a spec, and so does this one.

Packed int4/int5 filters (``weight_bits``; int8 images) are the per-tap
planes of ``kernels/pack.py``, (fh, fw, Cin_pad/8, Cout) nibble words
and, at 5 bits, (fh, fw, Cin_pad/32, Cout) bit-plane words: read as
(K/8, Cout) they are B1's packed B, decoded into the ``mma`` fragments
(B6, ``csrc/pack_common.cuh``); the outlier sidecar is added to the
int32 accumulator at the flush, one (tap, channel) row per slot; the
wrapper turns each slot's flat row into its offset in a pixel's input
window.  The reference adds the same rows as a precomputed (N, oh, ow,
Cout) term.

For CPU tensors the wrapper computes the kernel's plain version,
``ref.conv2d_fused_ref`` (on the exact int8 image of packed planes);
for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.dataflow import (ConvProblem, DataflowSpec, Epilogue,
                                       KernelRegistration, IS, OS, WS,
                                       register_kernel)
from repro_torch.kernels import _build, pack, ref
from repro_torch.kernels.matmul_df import (ACTIVATION_CODES, CARD_SMS,
                                           MAX_SMEM, WEIGHT_BITS, Plan,
                                           _i8_ring_bytes, _ring_bytes,
                                           check_took, panel_bytes,
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

# The tensor-core tiles (csrc/conv_tc.cuh; the CUDA configurations are the
# source, each launch's report is held against this copy by check_took):
# (pixels, k step, channels) and ring stages by input kind.  OS takes the
# first tile whose CTAs reach TARGET_CTAS (two an SM for integers, one for
# bf16, which cannot split k), else the last; an integer conv splits its k
# steps as far as that needs, into up to MAX_SPLIT parts of at least
# MIN_PART steps.  The walks: 64 x 64 in
# 32-deep steps (bf16 IS 16-deep), rings within TILE_BYTES.
OS_TILES = {"int8": (((128, 64, 64), 4), ((64, 64, 64), 4),
                     ((32, 64, 32), 4)),
            "bf16": (((128, 64, 64), 3), ((64, 64, 64), 4),
                     ((32, 64, 32), 4))}
TARGET_CTAS = {"int8": 2 * CARD_SMS, "bf16": CARD_SMS}
MIN_PART, MAX_SPLIT = 5, 8
WALK_TILES = {("int8", WS): ((64, 32, 64), 4), ("int8", IS): ((64, 32, 64), 4),
              ("bf16", WS): ((64, 32, 64), 3), ("bf16", IS): ((64, 16, 64), 3)}
_SRC = "src/repro_torch/kernels/csrc/conv_tc.cuh"
# Counted beside conv2d under their own names (_build.CONV_TILES).
TILE_KERNELS = {(OS, "int8"): "conv2d_os_i8", (OS, "bf16"): "conv2d_os_bf16",
                (WS, "int8"): "conv2d_ws_i8", (IS, "int8"): "conv2d_is_i8",
                (WS, "bf16"): "conv2d_ws_bf16", (IS, "bf16"): "conv2d_is_bf16"}
for (_anchor, _kind), _name in TILE_KERNELS.items():
    register_kernel(KernelRegistration(
        name=_name, source=_SRC, replaces=REGISTRATION.replaces,
        spec=DataflowSpec.basic(_anchor, block=(
            OS_TILES[_kind][1][0] if _anchor == OS
            else WALK_TILES[(_kind, _anchor)][0]))))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tc_kind(dtype: torch.dtype) -> Optional[str]:
    return {torch.int8: "int8", torch.bfloat16: "bf16"}.get(dtype)


def os_tile(conv: ConvProblem, kind: str,
            k: int) -> Tuple[Tuple[int, int, int], int, int, int]:
    """(tile, stages, output tiles, split) the OS rule takes
    (``csrc/conv_tc.cuh`` ``os_tile``)."""
    p = conv.oh * conv.ow
    for tile, stages in OS_TILES[kind]:
        outputs = conv.n * _cdiv(p, tile[0]) * _cdiv(conv.cout, tile[2])
        split = 1 if kind != "int8" else max(1, min(
            _cdiv(TARGET_CTAS[kind], outputs),
            _cdiv(_cdiv(k, 32) * 32, tile[1]) // MIN_PART, MAX_SPLIT))
        if outputs * split >= TARGET_CTAS[kind]:
            break
    return tile, stages, outputs, split


@functools.lru_cache(maxsize=1024)
def plan(spec: DataflowSpec, conv: ConvProblem,
         dtype: torch.dtype = torch.float32,
         weight_bits: Optional[int] = None) -> Plan:
    """The walk and resident operand of ``spec``'s anchor for ``conv``
    with inputs of ``dtype`` and a filter of the same type, or (int8)
    packed at ``weight_bits`` (the grid orders of
    ``repro/kernels/conv2d_df.py:conv2d_df``), and for int8, packed and
    bf16 inputs the tensor-core tile.  Raises ``ValueError`` when the
    resident operand does not fit a block's shared memory."""
    elt = dtype.itemsize
    pix, bk, bn = BLOCK
    tiles = _cdiv(conv.oh * conv.ow, pix)
    gn = _cdiv(conv.cout, bn)
    cr = conv.cin if weight_bits is None else _cdiv(conv.cin, bk) * bk
    k = conv.fh * conv.fw * cr
    kind = f"{dtype}" if weight_bits is None else f"packed {weight_bits}-bit"
    resident: Dict[str, int] = {}
    if spec.anchor == OS:
        order, ctas = "(n, goh, gk, r)", conv.n * tiles * gn
        walk = "CTA per (image, pixel tile, channel tile)"
    elif spec.anchor == WS:
        resident[f"weight block ({conv.fh}, {conv.fw}, {cr}, {bn}) "
                 f"{kind}"] = panel_bytes(_cdiv(k, bk) * bk, bn, elt,
                                          weight_bits)
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
            f"f{conv.fh}x{conv.fw} s{conv.s} -> {conv.cout} ({kind}) needs "
            f"{smem} bytes of shared memory per block ({held}); a Hopper "
            f"block has {MAX_SMEM}")
    tc = _tc_kind(dtype)
    if tc is None:
        return Plan(kernel="conv2d", grid_order=order, walk=walk, ctas=ctas,
                    resident=resident, smem_bytes=smem,
                    args=(WALKS[spec.anchor],))
    split = 1
    if spec.anchor == OS:
        tile, stages, ctas, split = os_tile(conv, tc, k)
        smem = (_i8_ring_bytes(tile, stages, weight_bits) if tc == "int8"
                else _ring_bytes(tile, stages))
        ctas *= split
        walk = (f"CTA per (image, {tile[0]}-pixel tile, {tile[2]}-channel "
                f"tile)" + (f" x {split} parts of k" if split > 1 else ""))
    else:
        tile, stages = WALK_TILES[(tc, spec.anchor)]
    walk += f" on the {tc} tensor cores"
    return Plan(kernel="conv2d", grid_order=order, walk=walk, ctas=ctas,
                resident=resident, smem_bytes=smem,
                args=(WALKS[spec.anchor],), tile=tile,
                tile_kernel=TILE_KERNELS[(spec.anchor, tc)], split=split)


# Zeroed arrival counters of the split merge per (device, stream): every
# launch leaves them zeroed (csrc/conv_tc.cuh's atomicInc wraps), so
# launches on one stream share them.
_SPLIT_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _split_counters(device: torch.device, stream: int,
                    count: int) -> torch.Tensor:
    held = _SPLIT_COUNTERS.get((device, stream))
    if held is None or held.numel() < count:
        held = torch.zeros(max(count, 256), dtype=torch.int32, device=device)
        _SPLIT_COUNTERS[(device, stream)] = held
    return held


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


def check_packed(x: torch.Tensor, w: torch.Tensor, weight_bits: int,
                 w_hi: Optional[torch.Tensor]) -> Tuple[int, int, int]:
    """(fh, fw, cout) of packed filter planes for the int8 image ``x``."""
    if weight_bits not in WEIGHT_BITS:
        raise ValueError(f"weight_bits must be 4 or 5, got {weight_bits}")
    if x.dtype != torch.int8 or x.ndim != 4:
        raise ValueError(f"packed weights need an int8 NHWC image, got "
                         f"{tuple(x.shape)} {x.dtype}")
    cp = _cdiv(x.shape[3], pack.WORD_BITS) * pack.WORD_BITS
    if (w.ndim != 4 or w.dtype != torch.int32
            or w.shape[2] * pack.WORD_NIBBLES != cp):
        raise ValueError(f"nibble plane {tuple(w.shape)} {w.dtype} does not "
                         f"pack {x.shape[3]} input channels (per-tap pad "
                         f"to {cp})")
    fh, fw, _, cout = w.shape
    if weight_bits == 5:
        want = (fh, fw, cp // pack.WORD_BITS, cout)
        if w_hi is None or tuple(w_hi.shape) != want \
                or w_hi.dtype != torch.int32:
            raise ValueError(f"weight_bits=5 needs the int32 bit plane "
                             f"{want}")
    return fh, fw, cout


def _window_offsets(idx: torch.Tensor, conv: ConvProblem,
                    cp: int) -> torch.Tensor:
    """Each sidecar slot's flat row ``(ky * fw + kx) * cp + c`` as its
    offset in a pixel's input window, -1 for an empty slot."""
    f = idx.long()
    tap, c = f // cp, f % cp
    off = ((tap // conv.fw) * conv.iw + tap % conv.fw) * conv.cin + c
    real = (f >= 0) & (f < conv.fh * conv.fw * cp) & (c < conv.cin)
    return torch.where(real, off, -1).to(torch.int32)


def conv2d_df(
    x: torch.Tensor,                          # (N, H, W, Cin)
    w: torch.Tensor,                          # (fh, fw, Cin, Cout) or planes
    stride: int,
    spec: DataflowSpec,
    out_dtype: Optional[torch.dtype] = None,
    epilogue: Optional[Epilogue] = None,
    scale: Optional[torch.Tensor] = None,     # (1, 1) or (1, Cout) float32
    bias: Optional[torch.Tensor] = None,      # (1, Cout) float32
    residual: Optional[torch.Tensor] = None,  # (N, oh, ow, Cout)
    weight_bits: Optional[int] = None,
    w_hi: Optional[torch.Tensor] = None,      # (fh, fw, Cin_pad/32, Cout)
    outlier_idx: Optional[torch.Tensor] = None,    # (R,) flat tap rows
    outlier_delta: Optional[torch.Tensor] = None,  # (R, Cout) int32
) -> torch.Tensor:
    """Direct conv under ``spec``'s anchor, the epilogue applied before
    the one output write, in one kernel launch.  Returns (N, oh, ow,
    Cout): int32 for int8 inputs without an epilogue, float32 otherwise
    (or ``out_dtype``).  With ``weight_bits``, ``w`` (and ``w_hi``) are
    a packed filter's per-tap planes and ``(outlier_idx,
    outlier_delta)`` its sidecar."""
    if weight_bits is None:
        conv = problem(x, w, stride)
        if x.dtype not in IN_DTYPES or w.dtype != x.dtype:
            raise TypeError(f"conv operands must share one of {IN_DTYPES}, "
                            f"got {x.dtype} and {w.dtype}")
    else:
        fh, fw, cout = check_packed(x, w, weight_bits, w_hi)
        conv = problem(x, torch.empty((fh, fw, x.shape[3], cout),
                                      device="meta"), stride)
    if (outlier_idx is None) != (outlier_delta is None) or (
            outlier_idx is not None and weight_bits is None):
        raise ValueError("the outlier sidecar needs both its idx and delta, "
                         "and packed weights")
    p = plan(spec, conv, x.dtype, weight_bits)
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
    if outlier_idx is not None and (
            tuple(outlier_delta.shape) != (outlier_idx.shape[0], cout)):
        raise ValueError(f"outlier delta shape {tuple(outlier_delta.shape)} "
                         f"!= ({outlier_idx.shape[0]}, {cout})")
    cp = _cdiv(conv.cin, pack.WORD_BITS) * pack.WORD_BITS
    if x.device.type == "cpu":
        if weight_bits is not None:
            w = pack.unpack_conv_planes(w, w_hi, weight_bits, conv.cin,
                                        outlier_idx, outlier_delta)
        if epi is None:
            return ref.conv2d_ref(x, w, stride, out_dtype=out_dtype)
        return ref.conv2d_fused_ref(
            x, w, stride, bias=bias, scale=scale, residual=residual,
            activation=epi.activation, out_dtype=out_dtype)
    scale, bias, residual = (None if t is None else t.float().contiguous()
                             for t in (scale, bias, residual))
    x, w = x.contiguous(), w.contiguous()
    r, offsets = 0, None
    if outlier_idx is not None and outlier_idx.shape[0]:
        r = outlier_idx.shape[0]
        offsets = _window_offsets(outlier_idx, conv, cp).contiguous()
        outlier_delta = outlier_delta.to(torch.int32).contiguous()
    else:
        outlier_delta = None
    if w_hi is not None:
        w_hi = w_hi.contiguous()
    _build.refuse_grad("conv2d", x, w, scale, bias, residual)
    _build.require_cuda(x, w, scale, bias, residual, w_hi, offsets,
                        outlier_delta)
    out = torch.empty(out_shape, dtype=out_dtype, device=x.device)
    ws = counters = None
    if p.split and p.split > 1:   # each part's int32 sums, then the merge
        ws = torch.empty(p.ctas * p.tile[0] * p.tile[2], dtype=torch.int32,
                         device=x.device)
        counters = _split_counters(
            x.device, torch.cuda.current_stream(x.device).cuda_stream,
            p.ctas // p.split)
    took = _build.launch(
        p.kernel, _build.ptr(x), _build.ptr(w), _build.ptr(out), conv.n,
        conv.ih, conv.iw, conv.cin, conv.fh, conv.fw, stride, cout,
        _build.dtype_code(x), _build.dtype_code(out), _build.ptr(scale),
        scale_mode(scale), _build.ptr(bias),
        ACTIVATION_CODES[epi.activation if epi else None],
        _build.ptr(residual), weight_bits or 0, _build.ptr(w_hi),
        _build.ptr(offsets), _build.ptr(outlier_delta), r, *p.args,
        _build.ptr(ws), 0 if ws is None else ws.numel(), _build.ptr(counters),
        0 if counters is None else counters.numel(),
        packed=weight_bits is not None)
    check_took(p, took)
    return out
