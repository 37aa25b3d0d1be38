"""Public entry points of the port's kernels.

The twins of ``repro/kernels/ops.py``'s ``matmul``, ``matmul_fused``,
``attention`` and ``paged_attention``, with the same signatures.
``backend`` picks the path:

* ``"cuda"`` — the hand-written kernel (``matmul_df`` /
  ``attention_df``), the port's counterpart of ``"pallas"``; on a CPU
  tensor the wrapper computes the kernel's plain version;
* ``"torch"`` — the plain PyTorch oracle (``ref``), the port's
  counterpart of ``"xla"`` and the path a CPU serving engine demotes to;
* ``None`` — ``"cuda"``.

``spec=None`` takes B1's basic OS dataflow (attention: B2's flash
anchor); nothing is autotuned yet (ROADMAP A4). An explicit GEMM spec
runs, at the kernels' one compiled block, the kernel ``matmul_df.plan``
names for its anchor and residencies, or raises ``ValueError`` where
they do not fit in shared memory. Where the JAX ops pad operands to the
block, the CUDA kernels mask the ragged edges themselves, so nothing is
padded here. Each op carries the same fault-injection site as its JAX
twin (``kernel.matmul`` / ``kernel.attention``), fired on every call.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dataflow import DataflowSpec, OS, WS
from repro_torch.kernels import attention_df, matmul_df, ref
from repro_torch.runtime import health

BACKENDS = ("cuda", "torch")


def _backend(backend: Optional[str]) -> str:
    backend = backend or "cuda"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    return backend


def _poison(out: torch.Tensor, fault: Optional[str]) -> torch.Tensor:
    """Realize a ``nan``-kind injected fault on a float result."""
    if fault == "nan" and out.is_floating_point():
        return out * float("nan")
    return out


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    spec: Optional[DataflowSpec] = None,
    out_dtype: Optional[torch.dtype] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """(M, K) @ (K, N) under a dataflow spec; float32 output by default."""
    fault = health.maybe_inject("kernel.matmul")
    matmul_df.check_operands(a, b)
    out_dtype = out_dtype or torch.float32
    if _backend(backend) == "torch":
        out = ref.matmul_ref(a, b, out_dtype)
    else:
        out = matmul_df.matmul_df(a, b, spec or matmul_df.BASIC_OS,
                                  out_dtype=out_dtype)
    return _poison(out, fault)


def matmul_fused(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: Optional[torch.Tensor] = None,       # (N,) or (1, N) float
    scale: Optional[torch.Tensor] = None,      # scalar, (N,) or (M, 1)
    residual: Optional[torch.Tensor] = None,   # (M, N)
    activation: Optional[str] = None,          # relu | gelu | silu
    spec: Optional[DataflowSpec] = None,
    out_dtype: Optional[torch.dtype] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Fused-epilogue GEMM ``act(scale * (a @ b) + bias) + residual`` in
    one kernel launch; float32 epilogue, float32 output by default.

    ``scale`` is per-tensor (one element), per-column ((N,) / (1, N)) or
    per-row ((M, 1)); a 1-D vector is per-column when M == N.
    """
    fault = health.maybe_inject("kernel.matmul")
    matmul_df.check_operands(a, b)
    m, _ = a.shape
    n = b.shape[1]
    backend = _backend(backend)
    if bias is not None:
        bias = torch.as_tensor(bias, dtype=torch.float32,
                               device=a.device).reshape(1, n)
    if scale is not None:
        scale = torch.as_tensor(scale, dtype=torch.float32, device=a.device)
        if scale.numel() == 1:
            scale = scale.reshape(1, 1)
        elif scale.ndim == 2 and tuple(scale.shape) == (m, 1):
            pass
        elif scale.numel() == n and not (scale.ndim == 2
                                         and scale.shape[1] == 1):
            scale = scale.reshape(1, n)
        elif scale.numel() == m and (scale.ndim == 1
                                     or scale.shape[1] == 1):
            scale = scale.reshape(m, 1)
        else:
            raise ValueError(
                f"scale must be scalar, per-column (N={n}) or per-row "
                f"(M={m}, 1), got {tuple(scale.shape)}")
    out_dtype = out_dtype or torch.float32
    if backend == "torch":
        out = ref.matmul_fused_ref(a, b, bias=bias, scale=scale,
                                   residual=residual, activation=activation,
                                   out_dtype=out_dtype)
    else:
        out = matmul_df.matmul_df(a, b, spec or matmul_df.BASIC_OS,
                                  scale=scale, bias=bias, residual=residual,
                                  activation=activation, out_dtype=out_dtype)
    return _poison(out, fault)


def attention(
    q: torch.Tensor,            # (B, Hq, Sq, D)
    k: torch.Tensor,            # (B, Hkv, Skv, D)
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    spec: Optional[DataflowSpec] = None,
    bq: Optional[int] = None,
    bkv: Optional[int] = None,
    backend: Optional[str] = None,
    anchor: Optional[str] = None,          # "os" flash | "ws" kv-stationary
    group: Optional[int] = None,
    kv_len: ref.KvLen = None,              # valid KV prefix: int or (B,)
    window_dyn: Optional[int] = None,      # run-time sliding window
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """GQA attention under the OS (flash, B2) or WS (kv-stationary, B7)
    anchor.  Returns (B, Hq, Sq, D).

    ``kv_len`` is the filled prefix of a padded KV buffer; q rows
    right-align against it and the kernel visits only the KV tiles in
    each q tile's band.  A ``(B,)`` vector bands every batch row at its
    own length.  ``window``/``window_dyn`` is a causal sliding window
    (PyTorch runs eagerly, so the two mean the same here).
    """
    fault = health.maybe_inject("kernel.attention")
    b, hq, _, _ = q.shape
    hkv = k.shape[1]
    if group is not None and group != hq // hkv:
        raise ValueError(f"group {group} != Hq/Hkv = {hq // hkv}")
    if k_scale is not None or v_scale is not None or not k.is_floating_point():
        raise NotImplementedError(
            "int8 K/V is not ported yet (ROADMAP A6)")
    if spec is not None:
        if spec.anchor not in (OS, WS):
            raise ValueError(f"attention admits OS/WS anchors, not "
                             f"{spec.anchor!r}")
        anchor = anchor or ("os" if spec.anchor == OS else "ws")
        bq = bq if bq is not None else spec.block[0]
        bkv = bkv if bkv is not None else spec.block[1]
    anchor = anchor or "os"
    if anchor not in ("os", "ws"):
        raise ValueError(f"attention anchor must be 'os' or 'ws', got "
                         f"{anchor!r}")
    win = window if window is not None else window_dyn
    if torch.is_tensor(win):
        win = int(win)
    backend = _backend(backend)
    if torch.is_tensor(kv_len) and kv_len.ndim == 1 \
            and kv_len.shape[0] != b:
        raise ValueError(f"per-row kv_len needs one entry per batch row "
                         f"({b}), got shape {tuple(kv_len.shape)}")
    if backend == "torch":
        out = ref.attention_ref(q, k, v, causal=causal, window=win,
                                scale=scale, kv_len=kv_len)
    else:
        reg = attention_df.FLASH if anchor == "os" \
            else attention_df.KV_STATIONARY
        built = reg.spec.block[:2]
        if any(got is not None and got != want
               for got, want in zip((bq, bkv), built)):
            raise ValueError(f"the {reg.name} kernel is compiled for (bq, "
                             f"bkv) = {built}, got ({bq}, {bkv})")
        fn = attention_df.flash_attention if anchor == "os" \
            else attention_df.kv_stationary_attention
        out = fn(q, k, v, causal=causal, window=win, scale=scale,
                 kv_len=kv_len)
    return _poison(out, fault)


def paged_attention(
    q: torch.Tensor,             # (B, Hq, 1, D) decode queries
    k_pages: torch.Tensor,       # (Hkv, n_pages, page, D) page pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_pages) int32 page ids (pad with 0)
    kv_lens: torch.Tensor,       # (B,) int32 valid KV length per row
    scale: Optional[float] = None,
    window: Optional[int] = None,
    group: Optional[int] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Decode attention straight off a paged KV cache.  Returns
    (B, Hq, 1, D).  Decode-only: ``Sq == 1``."""
    fault = health.maybe_inject("kernel.attention")
    b, hq, sq, _ = q.shape
    if sq != 1:
        raise ValueError(f"paged_attention is decode-only (Sq == 1), "
                         f"got {sq}")
    if group is not None and group != hq // k_pages.shape[0]:
        raise ValueError(f"group {group} != Hq/Hkv")
    if _backend(backend) == "torch":
        out = ref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                      kv_lens, scale=scale, window=window)
    else:
        out = attention_df.paged_flash_attention(
            q, k_pages, v_pages, block_tables, kv_lens, scale=scale,
            window=window)
    return _poison(out, fault)
