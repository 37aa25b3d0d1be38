"""Public entry points of the port's kernels.

The twins of ``repro/kernels/ops.py``'s ``matmul``, ``matmul_fused``,
``int8_matmul``, ``int8_matmul_fused``, ``matmul_packed``,
``matmul_packed_fused``, ``conv2d``, ``conv2d_fused``,
``int8_conv2d_fused``, ``conv2d_packed``, ``conv2d_packed_fused``,
``attention``, ``paged_attention``, ``binary_matmul``,
``binary_matmul_fused`` and ``binary_conv2d``, with the same
signatures.  ``backend`` picks the path:

* ``"cuda"`` — the hand-written kernel (``matmul_df``, ``conv2d_df``,
  ``attention_df``, ``binary_mm``), the port's counterpart of
  ``"pallas"``; on a CPU tensor the wrapper computes the kernel's plain
  version;
* ``"torch"`` — the plain PyTorch oracle (``ref``), the port's
  counterpart of ``"xla"`` and the path a CPU serving engine demotes to;
* ``None`` — ``"cuda"``.

``spec=None`` takes the basic OS dataflow (attention: B2's flash
anchor); nothing is autotuned yet (ROADMAP A4). An explicit GEMM spec
runs, at the kernels' one compiled block, the kernel ``matmul_df.plan``
names for its anchor and residencies, or raises ``ValueError`` where
they do not fit in shared memory; a conv or binary spec runs its
anchor's walk (``conv2d_df.plan``, ``binary_mm.plan``) the same way.
Where the JAX ops pad operands to the block, the CUDA kernels mask the
ragged edges themselves, so nothing is padded here. Each op carries the
same fault-injection site as its JAX twin (``kernel.matmul``,
``kernel.conv2d``, ``kernel.binary_matmul``, ``kernel.attention``),
fired on every call.  Packed binary operands and packed int4/int5
weight planes are int32 words holding the JAX package's words bit for
bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dataflow import (BinaryEpilogue, DataflowSpec,
                                       Epilogue, OS, WS)
from repro_torch.kernels import (attention_df, binary_mm, conv2d_df,
                                 matmul_df, pack, ref)
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
    """(M, K) @ (K, N) under a dataflow spec; float32 output by default
    (int32, exact, for int8 operands)."""
    fault = health.maybe_inject("kernel.matmul")
    matmul_df.check_operands(a, b)
    out_dtype = out_dtype or (torch.float32 if a.is_floating_point()
                              else torch.int32)
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


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def int8_matmul(
    aq: torch.Tensor, bq: torch.Tensor, a_scale, b_scale,
    spec: Optional[DataflowSpec] = None, backend: Optional[str] = None,
) -> torch.Tensor:
    """Quantized GEMM: int8 x int8 -> exact int32 -> dequantized f32."""
    acc = matmul(aq, bq, spec=spec, out_dtype=torch.int32, backend=backend)
    return (acc.float() * _f32(a_scale, acc.device)
            * _f32(b_scale, acc.device))


def int8_matmul_fused(
    aq: torch.Tensor, bq: torch.Tensor, a_scale, b_scale,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
    spec: Optional[DataflowSpec] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Quantized GEMM with the dequant and the epilogue fused into the
    kernel: ``act((a_scale * b_scale) * (aq @ bq) + bias) + residual``
    -> f32.  The scales must combine to per-tensor, per-column (1, N) or
    per-row (M, 1); a full (M, N) grid needs ``int8_matmul``."""
    scale = _f32(a_scale, aq.device) * _f32(b_scale, aq.device)
    m, n = aq.shape[0], bq.shape[1]
    per_row = scale.ndim == 2 and tuple(scale.shape) == (m, 1)
    per_column = (tuple(scale.shape) == (n,)
                  or (scale.ndim == 2 and tuple(scale.shape) == (1, n)))
    if not (scale.numel() == 1 or per_column or per_row):
        raise ValueError(
            f"fused dequant needs scalar, per-column or per-row scales, got "
            f"combined shape {tuple(scale.shape)}; use int8_matmul instead")
    return matmul_fused(aq, bq, bias=bias,
                        scale=scale if per_row else scale.reshape(1, -1),
                        residual=residual, activation=activation, spec=spec,
                        backend=backend)


def _per_tensor(x_scale, device, name: str) -> Optional[torch.Tensor]:
    if x_scale is None:
        return None
    x_scale = _f32(x_scale, device)
    if x_scale.numel() != 1:
        raise ValueError(f"{name} must be per-tensor (scalar), got "
                         f"{tuple(x_scale.shape)}")
    return x_scale.reshape(1, 1)


def matmul_packed_fused(
    aq: torch.Tensor,                         # (M, K) int8 activations
    pw: pack.PackedWeights,
    a_scale: Optional[torch.Tensor] = None,   # per-tensor activation scale
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
    spec: Optional[DataflowSpec] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Packed-weight GEMM with the in-kernel decode (B6) and the fused
    epilogue: ``act((a_scale * w_scale) * (aq @ W) + bias) + residual``
    -> f32, ``W`` the exact int8 image of the packed weight.  One kernel
    launch; bit for bit ``ref.matmul_packed_ref`` when the epilogue is
    scale-only."""
    fault = health.maybe_inject("kernel.matmul")
    m, k = aq.shape
    if k != pw.k:
        raise ValueError(f"activation K={k} != packed weight k={pw.k}")
    n = pw.n
    a_scale = _per_tensor(a_scale, aq.device, "a_scale")
    if _backend(backend) == "torch":
        out = ref.matmul_packed_ref(aq, pw, a_scale=a_scale, bias=bias,
                                    residual=residual,
                                    activation=activation)
    else:
        scale = pw.scale if a_scale is None else a_scale * pw.scale
        if bias is not None:
            bias = _f32(bias, aq.device).reshape(1, n)
        out = matmul_df.matmul_df(
            aq, pw.codes, spec or matmul_df.BASIC_OS, scale=scale,
            bias=bias, residual=residual, activation=activation,
            out_dtype=torch.float32, weight_bits=pw.bits,
            b_hi=pw.highbits, outlier_idx=pw.outlier_idx,
            outlier_delta=pw.outlier_delta)
    return _poison(out, fault)


def matmul_packed(
    aq: torch.Tensor,
    pw: pack.PackedWeights,
    a_scale: Optional[torch.Tensor] = None,
    spec: Optional[DataflowSpec] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Packed-weight GEMM, dequant-only epilogue:
    ``(a_scale * w_scale) * (aq @ W)`` -> f32 (bit for bit the oracle)."""
    return matmul_packed_fused(aq, pw, a_scale=a_scale, spec=spec,
                               backend=backend)


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
    (PyTorch runs eagerly, so the two mean the same here).  int8 K/V
    (the int8 KV cache) take per-position f32 ``k_scale``/``v_scale`` of
    shape ``(B, Hkv, Skv, 1)``, dequantized inside the kernel (folded
    into the scores and probabilities); the cache is never copied to
    float.
    """
    fault = health.maybe_inject("kernel.attention")
    b, hq, _, _ = q.shape
    hkv = k.shape[1]
    if group is not None and group != hq // hkv:
        raise ValueError(f"group {group} != Hq/Hkv = {hq // hkv}")
    if k.dtype == torch.int8:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 K/V need per-position k_scale/v_scale")
        # catch wrong scale layouts (a squeezed (B, H, S) vector, a
        # per-tensor or per-head scale) before they broadcast silently
        want_k = tuple(k.shape[:-1]) + (1,)
        want_v = tuple(v.shape[:-1]) + (1,)
        if tuple(k_scale.shape) != want_k or tuple(v_scale.shape) != want_v:
            raise ValueError(
                f"int8 K/V scales must be per-position with a trailing "
                f"singleton lane: expected k_scale {want_k} and v_scale "
                f"{want_v}, got {tuple(k_scale.shape)} and "
                f"{tuple(v_scale.shape)}")
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
                                scale=scale, kv_len=kv_len, k_scale=k_scale,
                                v_scale=v_scale)
    else:
        reg = attention_df.FLASH if anchor == "os" \
            else attention_df.KV_STATIONARY
        blocks = attention_df.FLASH_BLOCKS if anchor == "os" \
            else attention_df.KV_BLOCKS
        built = blocks.get(q.dtype, reg.spec.block[:2])
        if any(got is not None and got != want
               for got, want in zip((bq, bkv), built)):
            raise ValueError(f"the {reg.name} kernel is compiled for (bq, "
                             f"bkv) = {built}, got ({bq}, {bkv})")
        fn = attention_df.flash_attention if anchor == "os" \
            else attention_df.kv_stationary_attention
        out = fn(q, k, v, causal=causal, window=win, scale=scale,
                 kv_len=kv_len, k_scale=k_scale, v_scale=v_scale)
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


# ---------------------------------------------------------------------------
# Convolution (B8).
# ---------------------------------------------------------------------------
def conv2d(
    x: torch.Tensor,           # (N, H, W, Cin)
    w: torch.Tensor,           # (fh, fw, Cin, Cout)
    stride: int = 1,
    spec: Optional[DataflowSpec] = None,
    b_oh: int = 8,
    bc: int = 128,
    bk: int = 128,
    out_dtype: Optional[torch.dtype] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Direct NHWC conv (VALID padding) under a dataflow spec; int32 for
    int8 inputs, float32 otherwise, by default.  ``b_oh``/``bc``/``bk``
    are the TPU kernel's blocking, kept for the signature: the CUDA
    kernel picks its own tile (``conv2d_df.plan``: the f32 walk's
    ``conv2d_df.BLOCK``, or for int8 and bf16 a tensor-core tile by the
    CTAs it gives) and masks every edge.  Packed filters go through
    ``conv2d_packed``."""
    fault = health.maybe_inject("kernel.conv2d")
    conv2d_df.problem(x, w, stride)
    if _backend(backend) == "torch":
        out = ref.conv2d_ref(x, w, stride, out_dtype)
    else:
        out = conv2d_df.conv2d_df(x, w, stride, spec or conv2d_df.BASIC_OS,
                                  out_dtype=out_dtype)
    return _poison(out, fault)


def conv2d_fused(
    x: torch.Tensor,           # (N, H, W, Cin)
    w: torch.Tensor,           # (fh, fw, Cin, Cout)
    stride: int = 1,
    bias: Optional[torch.Tensor] = None,       # (Cout,) or (1, Cout) float
    scale: Optional[torch.Tensor] = None,      # scalar or (Cout,)
    residual: Optional[torch.Tensor] = None,   # (N, oh, ow, Cout)
    activation: Optional[str] = None,          # relu | gelu | silu
    spec: Optional[DataflowSpec] = None,
    b_oh: int = 8,
    bc: int = 128,
    bk: int = 128,
    out_dtype: Optional[torch.dtype] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Fused-epilogue conv ``act(scale * conv(x, w) + bias) + residual``
    in one kernel launch; float32 epilogue and output by default."""
    fault = health.maybe_inject("kernel.conv2d")
    cout = conv2d_df.problem(x, w, stride).cout
    if bias is not None:
        bias = torch.as_tensor(bias, dtype=torch.float32,
                               device=x.device).reshape(1, cout)
    if scale is not None:
        scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
        if scale.numel() == 1:
            scale = scale.reshape(1, 1)
        elif scale.numel() == cout:
            scale = scale.reshape(1, cout)
        else:
            raise ValueError(
                f"scale must be scalar or per-output-channel (Cout={cout}), "
                f"got {tuple(scale.shape)}")
    if _backend(backend) == "torch":
        out = ref.conv2d_fused_ref(x, w, stride, bias=bias, scale=scale,
                                   residual=residual, activation=activation,
                                   out_dtype=out_dtype)
    else:
        epi = Epilogue(bias=bias is not None, activation=activation,
                       scale=scale is not None,
                       residual=residual is not None)
        out = conv2d_df.conv2d_df(
            x, w, stride, spec or conv2d_df.BASIC_OS,
            out_dtype=out_dtype or torch.float32, epilogue=epi, scale=scale,
            bias=bias, residual=residual)
    return _poison(out, fault)


def int8_conv2d_fused(
    xq: torch.Tensor,
    wq: torch.Tensor,
    x_scale: torch.Tensor,
    w_scale: torch.Tensor,
    stride: int = 1,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
    spec: Optional[DataflowSpec] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Quantized conv with the dequant and the epilogue fused into the
    kernel: ``act((x_scale * w_scale) * conv(xq, wq) + bias) + residual``
    -> float32.  The scales must combine to per-tensor or
    per-output-channel."""
    scale = (torch.as_tensor(x_scale, dtype=torch.float32, device=xq.device)
             * torch.as_tensor(w_scale, dtype=torch.float32,
                               device=xq.device))
    cout = wq.shape[3]
    if scale.numel() not in (1, cout):
        raise ValueError(
            f"fused conv dequant needs scalar or per-output-channel scales, "
            f"got combined shape {tuple(scale.shape)}")
    return conv2d_fused(xq, wq, stride=stride, bias=bias,
                        scale=scale.reshape(1, -1), residual=residual,
                        activation=activation, spec=spec, backend=backend)


def conv2d_packed_fused(
    xq: torch.Tensor,                         # (N, H, W, Cin) int8
    pcw: pack.PackedConvWeights,
    stride: int = 1,
    x_scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,   # (N, oh, ow, Cout)
    activation: Optional[str] = None,
    spec: Optional[DataflowSpec] = None,
    b_oh: int = 8,
    bc: int = 128,
    bk: int = 128,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Packed-weight conv with the in-kernel decode (B6) and the fused
    epilogue: ``act((x_scale * w_scale) * conv(xq, W) + bias) +
    residual`` -> f32, one kernel launch; the outlier rows join the
    int32 accumulator at the flush.  ``b_oh``/``bc``/``bk`` as
    ``conv2d``."""
    fault = health.maybe_inject("kernel.conv2d")
    if xq.ndim != 4 or xq.shape[3] != pcw.cin:
        raise ValueError(f"input channels {tuple(xq.shape)[3:]} != packed "
                         f"cin {pcw.cin}")
    x_scale = _per_tensor(x_scale, xq.device, "x_scale")
    if _backend(backend) == "torch":
        out = ref.conv2d_packed_ref(xq, pcw, stride, x_scale=x_scale,
                                    bias=bias, residual=residual,
                                    activation=activation)
    else:
        scale = pcw.scale if x_scale is None else x_scale * pcw.scale
        if bias is not None:
            bias = _f32(bias, xq.device).reshape(1, pcw.kout)
        epi = Epilogue(scale=True, bias=bias is not None,
                       activation=activation,
                       residual=residual is not None)
        out = conv2d_df.conv2d_df(
            xq, pcw.codes, stride, spec or conv2d_df.BASIC_OS,
            out_dtype=torch.float32, epilogue=epi, scale=scale, bias=bias,
            residual=residual, weight_bits=pcw.bits, w_hi=pcw.highbits,
            outlier_idx=pcw.outlier_idx, outlier_delta=pcw.outlier_delta)
    return _poison(out, fault)


def conv2d_packed(
    xq: torch.Tensor,
    pcw: pack.PackedConvWeights,
    stride: int = 1,
    x_scale: Optional[torch.Tensor] = None,
    spec: Optional[DataflowSpec] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Packed-weight conv, dequant-only epilogue (bit for bit the
    oracle)."""
    return conv2d_packed_fused(xq, pcw, stride=stride, x_scale=x_scale,
                               spec=spec, backend=backend)


# ---------------------------------------------------------------------------
# Binary (+-1, xnor-popcount) datapath (B9).
# ---------------------------------------------------------------------------
def binary_matmul(
    a_packed: torch.Tensor,    # (M, Kp) int32 words
    b_packed: torch.Tensor,    # (Kp, N) int32 words
    n_bits: int,               # true pre-packing reduction depth K
    spec: Optional[DataflowSpec] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Packed +-1 GEMM: (M, N) int32 dots ``n_bits - 2*popcount(a ^ b)``."""
    fault = health.maybe_inject("kernel.binary_matmul")
    binary_mm.check_operands(a_packed, b_packed, n_bits)
    if _backend(backend) == "torch":
        out = ref.binary_matmul_ref(a_packed, b_packed, n_bits)
    else:
        out = binary_mm.binary_mm_df(a_packed, b_packed, n_bits,
                                     spec or binary_mm.BASIC_OS,
                                     out_dtype=torch.int32)
    return _poison(out, fault)


def binary_matmul_fused(
    a_packed: torch.Tensor,
    b_packed: torch.Tensor,
    n_bits: int,
    scale: Optional[torch.Tensor] = None,      # scalar or (N,) folded-BN gamma
    bias: Optional[torch.Tensor] = None,       # (N,) folded-BN beta
    residual: Optional[torch.Tensor] = None,   # (M, N)
    binarize: bool = False,
    spec: Optional[DataflowSpec] = None,
    out_dtype: Optional[torch.dtype] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Fused-epilogue binary GEMM: ``y = scale * dot + bias + residual``,
    then ``sign(y)`` when ``binarize``, in one kernel launch.  Output
    int8 (+-1) when ``binarize``, else float32, by default."""
    fault = health.maybe_inject("kernel.binary_matmul")
    binary_mm.check_operands(a_packed, b_packed, n_bits)
    n = b_packed.shape[1]
    if scale is not None:
        scale = torch.as_tensor(scale, dtype=torch.float32,
                                device=a_packed.device)
        if scale.numel() == 1:
            scale = scale.reshape(1, 1)
        elif scale.numel() == n:
            scale = scale.reshape(1, n)
        else:
            raise ValueError(
                f"scale must be scalar or per-output-column (N={n}), "
                f"got {tuple(scale.shape)}")
    if bias is not None:
        bias = torch.as_tensor(bias, dtype=torch.float32,
                               device=a_packed.device).reshape(1, n)
    if _backend(backend) == "torch":
        out = ref.binary_matmul_fused_ref(
            a_packed, b_packed, n_bits, scale=scale, bias=bias,
            residual=residual, binarize=binarize, out_dtype=out_dtype)
    else:
        epi = BinaryEpilogue(scale=scale is not None, bias=bias is not None,
                             residual=residual is not None,
                             binarize=binarize)
        out = binary_mm.binary_mm_df(
            a_packed, b_packed, n_bits, spec or binary_mm.BASIC_OS,
            out_dtype=out_dtype or (torch.int8 if binarize
                                    else torch.float32),
            epilogue=epi, scale=scale, bias=bias, residual=residual)
    return _poison(out, fault)


def binary_conv2d(
    x_packed: torch.Tensor,    # (N, H, W, Cp) int32 channel-packed image
    w_packed: torch.Tensor,    # (fh, fw, Cp, Cout) int32 words
    stride: int = 1,
    n_bits: Optional[int] = None,   # true reduction depth fh*fw*cin
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,   # (N, oh, ow, Cout)
    binarize: bool = False,
    spec: Optional[DataflowSpec] = None,
    out_dtype: Optional[torch.dtype] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Binary NHWC conv (VALID padding) on the implicit-GEMM view: the
    packed image is patch-extracted in PyTorch (as the JAX op leaves it to
    XLA) to (N*oh*ow, fh*fw*Cp) words, and one binary GEMM launch runs
    it, with the fused folded-BN/sign epilogue when any is given (int32
    dots when none is).  ``n_bits`` defaults to every packed bit
    (fh*fw*32*Cp)."""
    nb, _, _, cp = x_packed.shape
    fh, fw, _, cout = w_packed.shape
    cols = ref.binary_im2col(x_packed, fh, fw, stride)
    _, oh, ow, _ = cols.shape
    raw = (scale is None and bias is None and residual is None
           and not binarize)
    out = binary_matmul_fused(
        cols.reshape(nb * oh * ow, fh * fw * cp),
        w_packed.reshape(fh * fw * cp, cout),
        fh * fw * 32 * cp if n_bits is None else n_bits, scale=scale,
        bias=bias,
        residual=None if residual is None else residual.reshape(-1, cout),
        binarize=binarize, spec=spec,
        out_dtype=out_dtype or (torch.int32 if raw else None),
        backend=backend)
    return out.reshape(nb, oh, ow, cout)
