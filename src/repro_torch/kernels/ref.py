"""Plain-PyTorch oracles for the port's kernels.

The twins of ``repro/kernels/ref.py``: the ground truth every CUDA
kernel is held against on the card, the path each kernel wrapper takes
for a tensor on the CPU, and the ``backend="torch"`` path a CPU serving
engine demotes to (on the card the engine never demotes).  They compute in float32 and cast the result.
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
