"""Plain-PyTorch oracles for the port's kernels.

The twins of ``repro/kernels/ref.py``: the ground truth every CUDA
kernel is held against on the card, the path each kernel wrapper takes
for a tensor on the CPU, and the ``backend="torch"`` path a CPU serving
engine demotes to (on the card the engine never demotes).  They compute
in float32 (integer convolutions and binary dots exactly) and cast the
result.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core.dataflow import EPILOGUE_ACTIVATIONS

ACTIVATION_FNS = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu default
    "silu": F.silu,
}
assert set(ACTIVATION_FNS) == set(EPILOGUE_ACTIVATIONS)


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain GEMM oracle, accumulated in float32."""
    return (a.float() @ b.float()).to(out_dtype or torch.float32)


def matmul_fused_ref(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Fused-epilogue GEMM oracle: act(scale * (a @ b) + bias) + residual,
    in float32; ``bias``/``scale``/``residual`` broadcast."""
    x = a.float() @ b.float()
    if scale is not None:
        x = x * scale.float()
    if bias is not None:
        x = x + bias.float()
    if activation is not None:
        x = ACTIVATION_FNS[activation](x)
    if residual is not None:
        x = x + residual.float()
    return x.to(out_dtype or torch.float32)


KvLen = Union[None, int, torch.Tensor]


def attention_ref(
    q: torch.Tensor,              # (B, Hq, Sq, D)
    k: torch.Tensor,              # (B, Hkv, Skv, D)
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    kv_len: KvLen = None,         # scalar, or (B,) per-row valid lengths
) -> torch.Tensor:
    """GQA attention oracle with the kernels' mask.

    q rows right-align against the valid KV length (``kv_len``, default
    ``Skv``): row i sits at position ``i + kv_len - Sq``.  A key is
    visible when it lies below ``kv_len``, at or before the row
    (``causal``) and within ``window`` positions of it.  Rows that see no
    key emit 0.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    logits = torch.einsum("bhgqd,bhkd->bhgqk",
                          q.float().reshape(b, hkv, group, sq, d),
                          k.float()) * scale
    kv_valid = skv if kv_len is None else kv_len
    kpos = torch.arange(skv, device=dev)
    if torch.is_tensor(kv_valid) and kv_valid.ndim == 1:
        kv_col = kv_valid.to(dev).long()[:, None, None]            # (B,1,1)
        qpos = torch.arange(sq, device=dev)[None, :, None] + (kv_col - sq)
        mask = kpos[None, None, :] < kv_col                        # (B,Sq,Skv)
        kpos = kpos[None, None, :]
    else:
        kv_valid = int(kv_valid)
        qpos = torch.arange(sq, device=dev)[:, None] + (kv_valid - sq)
        kpos = kpos[None, :]
        mask = kpos < kv_valid
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    mask = mask[:, None, None] if mask.ndim == 3 else mask[None, None, None]
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)                 # fully-masked rows
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype)


def paged_attention_ref(
    q: torch.Tensor,              # (B, Hq, 1, D)
    k_pages: torch.Tensor,        # (Hkv, P, page, D)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,   # (B, max_pages) int32
    kv_lens: torch.Tensor,        # (B,) int32
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention over a page pool: gather each row's pages into a
    contiguous cache, then ``attention_ref`` with per-row ``kv_len``."""
    b, d = q.shape[0], q.shape[-1]
    hkv = k_pages.shape[0]
    tables = block_tables.long()
    kg = k_pages[:, tables].movedim(1, 0).reshape(b, hkv, -1, d)
    vg = v_pages[:, tables].movedim(1, 0).reshape(b, hkv, -1, d)
    return attention_ref(q, kg, vg, causal=True, window=window, scale=scale,
                         kv_len=kv_lens)


# ---------------------------------------------------------------------------
# Convolution (twins of repro/kernels/ref.py conv2d_ref, conv2d_fused_ref).
# ---------------------------------------------------------------------------
def _conv_out_hw(ih: int, iw: int, fh: int, fw: int, stride: int):
    return (ih - fh) // stride + 1, (iw - fw) // stride + 1


def conv2d_ref(
    x: torch.Tensor,          # (N, H, W, Cin)
    w: torch.Tensor,          # (fh, fw, Cin, Cout)
    stride: int = 1,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Direct NHWC convolution, VALID padding: one product per filter tap,
    summed over the taps.  Float inputs accumulate in float32; integer
    inputs exactly, in float64 (|sum| < 2^53 for any int8 conv a card
    holds: torch has no integer matmul on CUDA), returned as int32."""
    n, ih, iw, _ = x.shape
    fh, fw, _, cout = w.shape
    oh, ow = _conv_out_hw(ih, iw, fh, fw, stride)
    integer = not x.is_floating_point()
    acc = torch.float64 if integer else torch.float32
    out = torch.zeros((n, oh, ow, cout), dtype=acc, device=x.device)
    for ky in range(fh):
        for kx in range(fw):
            xs = x[:, ky:ky + (oh - 1) * stride + 1:stride,
                   kx:kx + (ow - 1) * stride + 1:stride, :]
            out = out + xs.to(acc) @ w[ky, kx].to(acc)
    if integer:
        out = out.to(torch.int32)
    return out.to(out_dtype or out.dtype)


def conv2d_fused_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    stride: int = 1,
    bias: Optional[torch.Tensor] = None,       # (1, Cout)
    scale: Optional[torch.Tensor] = None,      # (1, 1) or (1, Cout)
    residual: Optional[torch.Tensor] = None,   # (N, oh, ow, Cout)
    activation: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Fused-epilogue conv oracle: act(scale * conv + bias) + residual,
    the epilogue in float32, each stage rounded on its own."""
    out = conv2d_ref(x, w, stride).float()
    if scale is not None:
        out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    if activation is not None:
        out = ACTIVATION_FNS[activation](out)
    if residual is not None:
        out = out + residual.float()
    return out.to(out_dtype or torch.float32)


# ---------------------------------------------------------------------------
# Binary (+-1, xnor-popcount) datapath (twins of repro/kernels/ref.py).
#
# Packed words are int32 tensors holding the JAX package's uint32 words
# bit for bit (torch cannot shift uint32 tensors on every device): packing
# and unpacking work on their bytes, the popcount on the words widened to
# int64, where the 32 bits are non-negative and shifts are logical.
# ---------------------------------------------------------------------------
_WORD = 32
_LOW32 = 0xFFFFFFFF


def _unsigned(words: torch.Tensor) -> torch.Tensor:
    """The words' 32 bits as a non-negative int64."""
    return words.to(torch.int64) & _LOW32


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each non-negative int64 below 2^32 (SWAR count)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _LOW32) >> 24


def pack_binary(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack a +-1 (or {0, 1}) tensor into int32 words along ``axis``
    (length a multiple of 32): bit i of word j is ``x[32 j + i] > 0``, so
    0 and -0.0 pack as -1.  Built byte by byte (each byte the sum of its
    eight bits times 1, 2, ..., 128) and read four bytes to a word, little
    endian as the card and the CPU store it."""
    bits = (x > 0).movedim(axis, -1)
    *lead, k = bits.shape
    if k % _WORD:
        raise ValueError(f"packed axis length {k} is not a multiple of 32")
    weights = torch.ones(8, dtype=torch.uint8, device=x.device) \
        << torch.arange(8, dtype=torch.uint8, device=x.device)
    octets = (bits.reshape(*lead, k // 8, 8).view(torch.uint8)
              * weights).sum(-1, dtype=torch.uint8)
    return octets.view(torch.int32).movedim(-1, axis)


def unpack_binary(packed: torch.Tensor, axis: int = -1,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``pack_binary``: words -> a +-1 tensor whose ``axis`` is
    32x longer (bit 1 -> +1, bit 0 -> -1)."""
    octets = packed.movedim(axis, -1).contiguous().view(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (octets[..., None] >> shifts) & 1               # (..., 4 kp, 8)
    *lead, n, _ = bits.shape
    pm1 = 2 * bits.reshape(*lead, n * 8).to(torch.int8) - 1
    return pm1.to(dtype).movedim(-1, axis)


def binary_matmul_ref(a_packed: torch.Tensor, b_packed: torch.Tensor,
                      n_bits: int, k_chunk: int = 8) -> torch.Tensor:
    """+-1 GEMM on packed words: ``dot = n_bits - 2 * popcount(a xor b)``,
    int32.  ``a_packed`` (M, Kp), ``b_packed`` (Kp, N); the words are
    taken ``k_chunk`` at a time to bound the (M, chunk, N) temporaries."""
    m, kp = a_packed.shape
    n = b_packed.shape[1]
    a, b = _unsigned(a_packed), _unsigned(b_packed)
    pops = torch.zeros((m, n), dtype=torch.int64, device=a_packed.device)
    for k0 in range(0, kp, k_chunk):
        x = a[:, k0:k0 + k_chunk, None] ^ b[None, k0:k0 + k_chunk, :]
        pops += popcount32(x).sum(dim=1)
    return (n_bits - 2 * pops).to(torch.int32)


def binary_epilogue_ref(
    dot: torch.Tensor,                         # (M, N) int32
    scale: Optional[torch.Tensor] = None,      # (1, 1) or (1, N) float32
    bias: Optional[torch.Tensor] = None,       # (1, N) float32
    residual: Optional[torch.Tensor] = None,   # (M, N)
    binarize: bool = False,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``y = scale * dot + bias + residual`` in float32, each stage rounded
    on its own (eager PyTorch contracts nothing into an FMA), then
    ``sign(y)`` (``y >= 0`` -> +1, int8 by default) when ``binarize``."""
    x = dot.float()
    if scale is not None:
        x = x * scale.float()
    if bias is not None:
        x = x + bias.float()
    if residual is not None:
        x = x + residual.float()
    if binarize:
        one = torch.ones((), dtype=torch.int32, device=x.device)
        return torch.where(x >= 0, one, -one).to(out_dtype or torch.int8)
    return x.to(out_dtype or torch.float32)


def binary_matmul_fused_ref(
    a_packed: torch.Tensor, b_packed: torch.Tensor, n_bits: int,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    binarize: bool = False,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The xnor-popcount dot through ``binary_epilogue_ref``."""
    return binary_epilogue_ref(
        binary_matmul_ref(a_packed, b_packed, n_bits), scale=scale,
        bias=bias, residual=residual, binarize=binarize,
        out_dtype=out_dtype)


def binary_im2col(x_packed: torch.Tensor, fh: int, fw: int,
                  stride: int = 1) -> torch.Tensor:
    """Patch-extract a packed NHWC image for the implicit-GEMM view:
    (N, H, W, Cp) -> (N, oh, ow, fh*fw*Cp), taps in (ky, kx, cp) order, as
    a (fh, fw, Cp, Cout) filter reshaped to (fh*fw*Cp, Cout) has them."""
    _, ih, iw, _ = x_packed.shape
    oh, ow = _conv_out_hw(ih, iw, fh, fw, stride)
    taps = [x_packed[:, ky:ky + (oh - 1) * stride + 1:stride,
                     kx:kx + (ow - 1) * stride + 1:stride, :]
            for ky in range(fh) for kx in range(fw)]
    return torch.cat(taps, dim=-1)


def binary_conv2d_ref(
    x_packed: torch.Tensor,   # (N, H, W, Cp) int32 words
    w_packed: torch.Tensor,   # (fh, fw, Cp, Cout) int32 words
    stride: int = 1,
    n_bits: Optional[int] = None,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,   # (N, oh, ow, Cout)
    binarize: bool = False,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Binary conv oracle: explicit im2col and the packed GEMM oracle.
    ``n_bits`` defaults to every packed bit (fh*fw*32*Cp)."""
    n, ih, iw, cp = x_packed.shape
    fh, fw, _, cout = w_packed.shape
    oh, ow = _conv_out_hw(ih, iw, fh, fw, stride)
    if n_bits is None:
        n_bits = fh * fw * _WORD * cp
    a = binary_im2col(x_packed, fh, fw, stride).reshape(n * oh * ow, -1)
    b = w_packed.reshape(fh * fw * cp, cout)
    res2 = None if residual is None else residual.reshape(n * oh * ow, cout)
    if scale is None and bias is None and res2 is None and not binarize:
        out = binary_matmul_ref(a, b, n_bits)
        if out_dtype is not None:
            out = out.to(out_dtype)
    else:
        out = binary_matmul_fused_ref(a, b, n_bits, scale=scale, bias=bias,
                                      residual=res2, binarize=binarize,
                                      out_dtype=out_dtype)
    return out.reshape(n, oh, ow, cout)
