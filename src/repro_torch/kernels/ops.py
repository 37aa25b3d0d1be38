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

``spec=None`` takes the dataflow ``core.autotune`` picks for the call's
problem (``GemmProblem``, ``ConvProblem``, ``BinaryProblem``,
``AttentionProblem``) on the card the operands live on (the H100's
constant for CPU tensors): the explorer's candidates are ranked once a
workload by the Hopper cost model, and memoized in the process and on
disk; ``ValueError`` where no candidate is feasible.  A
``SpecOverride`` merges onto that pick (a complete one onto Alg. 8's
``DataflowSpec.optimized()``), and a full ``DataflowSpec`` runs as
given.  Every spec runs at the kernels' one compiled block: a GEMM spec
the kernel ``matmul_df.plan`` names for its anchor and residencies, a
conv or binary spec its anchor's walk (``conv2d_df.plan``,
``binary_mm.plan``), an attention spec B2 (OS) or B7 (WS); each raises
``ValueError`` where the resident operands do not fit in shared memory
or the block is another.  ``backend="torch"`` resolves nothing.
Where the JAX ops pad operands to the block, the CUDA kernels mask the
ragged edges themselves, so nothing is padded here. Each op carries the
same fault-injection site as its JAX twin (``kernel.matmul``,
``kernel.conv2d``, ``kernel.binary_matmul``, ``kernel.attention``),
fired on every call.  Packed binary operands and packed int4/int5
weight planes are int32 words holding the JAX package's words bit for
bit.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch.core import autotune, cost_model
from repro_torch.core.dataflow import (AttentionProblem, BinaryEpilogue,
                                       BinaryProblem, ConvProblem,
                                       DataflowSpec, Epilogue, GemmProblem,
                                       Residency, SpecOverride, IS, OS, WS)
from repro_torch.kernels import (attention_df, autograd, binary_mm,
                                 conv2d_df, matmul_df, pack, ref)
from repro_torch.runtime import health

BACKENDS = ("cuda", "torch")
Spec = Optional[object]          # None, a SpecOverride or a DataflowSpec
# Calls whose ``spec=None`` the autotuner resolved, by problem (each took
# ``autotune.best_spec`` of it on its card): what a launch count on the
# card must follow (chip_smoke.py's gates).
RESOLVED: Dict[object, int] = {}


def _picked(problem, device: torch.device) -> DataflowSpec:
    spec = autotune.best_spec(problem, cost_model.hardware_for(device))
    RESOLVED[problem] = RESOLVED.get(problem, 0) + 1
    return spec


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


def _resolve_spec(spec: Spec, problem, device: torch.device,
                  block) -> DataflowSpec:
    """``None`` -> the autotuned spec of ``problem`` on ``device``'s card;
    a ``SpecOverride`` merged onto it (a complete one onto Alg. 8's
    dataflow at ``block``, with no lookup); a ``DataflowSpec`` as is."""
    if isinstance(spec, SpecOverride):
        if spec.is_complete:
            return spec.merge(DataflowSpec.optimized(block=block))
        base = autotune.best_spec(problem, cost_model.hardware_for(device))
        return spec.merge(base)
    if spec is None:
        return _picked(problem, device)
    return spec


def _out_name(dtype: Optional[torch.dtype], integer: bool) -> str:
    if dtype is None:
        return "int32" if integer else "float32"
    return cost_model.dtype_name(dtype)


# The problem builders are memoized: a serving step calls them with the
# same few shapes every time, and a lookup is far cheaper than a build.
@functools.lru_cache(maxsize=4096)
def _gemm_problem(m: int, k: int, n: int, in_dtype: torch.dtype,
                  out_dtype: Optional[torch.dtype],
                  weight_bits: Optional[int] = None) -> GemmProblem:
    integer = not in_dtype.is_floating_point
    return GemmProblem(m=m, k=k, n=n, in_dtype=cost_model.dtype_name(in_dtype),
                       out_dtype=_out_name(out_dtype, integer),
                       acc_dtype="int32" if integer else "float32",
                       weight_bits=weight_bits)


@functools.lru_cache(maxsize=4096)
def _conv_problem(x_shape: tuple, x_dtype: torch.dtype, cout: int, fh: int,
                  fw: int, stride: int, out_dtype: Optional[torch.dtype],
                  weight_bits: Optional[int] = None) -> ConvProblem:
    n, ih, iw, cin = x_shape
    return ConvProblem(ih=ih, iw=iw, fh=fh, fw=fw, s=stride, cin=cin,
                       cout=cout, n=n, in_dtype=cost_model.dtype_name(x_dtype),
                       out_dtype=_out_name(out_dtype,
                                           not x_dtype.is_floating_point),
                       weight_bits=weight_bits)


@functools.lru_cache(maxsize=4096)
def _binary_problem(m: int, kp: int, n: int, n_bits: int,
                    out_dtype: torch.dtype) -> BinaryProblem:
    return BinaryProblem(m=m, kp=kp, n=n, n_bits=n_bits,
                         out_dtype=cost_model.dtype_name(out_dtype))


def default_matmul_spec(m: int, k: int, n: int, in_dtype: str = "bfloat16",
                        hw: cost_model.HardwareSpec = cost_model.H100
                        ) -> DataflowSpec:
    """Paper Alg. 8 under ``hw``'s shared memory a block: the OS anchor,
    auxiliary residency to the weights first (WHOLE if it fits, else a
    STRIPE), then to the inputs, at the compiled block."""
    dtype = cost_model.TORCH_DTYPES[in_dtype]
    for aux in ({WS: Residency.WHOLE, IS: Residency.STRIPE},
                {WS: Residency.WHOLE}, {WS: Residency.STRIPE}, {}):
        spec = DataflowSpec(anchor=OS, aux=aux, aux_priority=(WS, IS),
                            block=matmul_df.BLOCK)
        try:
            if matmul_df.plan(spec, m, k, n, dtype).smem_bytes \
                    <= hw.smem_block:
                return spec
        except ValueError:
            continue
    raise ValueError(f"no OS dataflow fits M={m} K={k} N={n} {in_dtype}")


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    spec: Spec = None,
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
    elif autograd.b1_carries_grad(spec, a, b):
        out = autograd.matmul_fused(a, b, None, None, None, None, out_dtype)
    else:
        m, k = a.shape
        spec = _resolve_spec(spec, _gemm_problem(m, k, b.shape[1], a.dtype,
                                                 out_dtype),
                             a.device, matmul_df.BLOCK)
        out = matmul_df.matmul_df(a, b, spec, out_dtype=out_dtype)
    return _poison(out, fault)


def matmul_fused(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: Optional[torch.Tensor] = None,       # (N,) or (1, N) float
    scale: Optional[torch.Tensor] = None,      # scalar, (N,) or (M, 1)
    residual: Optional[torch.Tensor] = None,   # (M, N)
    activation: Optional[str] = None,          # relu | gelu | silu
    spec: Spec = None,
    out_dtype: Optional[torch.dtype] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Fused-epilogue GEMM ``act(scale * (a @ b) + bias) + residual`` in
    one kernel launch; float32 epilogue, float32 output by default.

    ``scale`` is per-tensor (one element), per-column ((N,) / (1, N)) or
    per-row ((M, 1)); a 1-D vector is per-column when M == N.  Where grad
    is enabled and a float operand requires it, the launch runs inside
    ``autograd.matmul_fused``, whose backward is B1 too (``spec=None``
    only: the forward is the serving path's pick).
    """
    fault = health.maybe_inject("kernel.matmul")
    matmul_df.check_operands(a, b)
    backend = _backend(backend)
    n = b.shape[1]
    if bias is not None:
        bias = torch.as_tensor(bias, dtype=torch.float32,
                               device=a.device).reshape(1, n)
    scale = _scale_operand(scale, a, n)
    out_dtype = out_dtype or torch.float32
    if backend == "cuda" and autograd.b1_carries_grad(
            spec, a, b, bias, residual, scale):
        out = autograd.matmul_fused(a, b, bias, scale, residual, activation,
                                    out_dtype)
    else:
        out = _matmul_fused(a, b, bias, scale, residual, activation, spec,
                            out_dtype, backend)
    return _poison(out, fault)


def _scale_operand(scale, a: torch.Tensor, n: int
                   ) -> Optional[torch.Tensor]:
    """``scale`` as the kernel takes it: f32 (1, 1), (1, N) or (M, 1)."""
    if scale is None:
        return None
    m = a.shape[0]
    scale = torch.as_tensor(scale, dtype=torch.float32, device=a.device)
    if scale.numel() == 1:
        return scale.reshape(1, 1)
    if scale.ndim == 2 and tuple(scale.shape) == (m, 1):
        return scale
    if scale.numel() == n and not (scale.ndim == 2 and scale.shape[1] == 1):
        return scale.reshape(1, n)
    if scale.numel() == m and (scale.ndim == 1 or scale.shape[1] == 1):
        return scale.reshape(m, 1)
    raise ValueError(
        f"scale must be scalar, per-column (N={n}) or per-row "
        f"(M={m}, 1), got {tuple(scale.shape)}")


def _matmul_fused(a, b, bias, scale, residual, activation, spec: Spec,
                  out_dtype: torch.dtype, backend: str = "cuda"
                  ) -> torch.Tensor:
    """``matmul_fused``'s launch (or its plain version for
    ``backend="torch"``), with ``bias`` and ``scale`` already as the
    kernel takes them (``_scale_operand``): no fault site, no gradient."""
    m, _ = a.shape
    n = b.shape[1]
    if backend == "torch":
        return ref.matmul_fused_ref(a, b, bias=bias, scale=scale,
                                    residual=residual, activation=activation,
                                    out_dtype=out_dtype)
    spec = _resolve_spec(spec, _gemm_problem(m, a.shape[1], n, a.dtype,
                                             out_dtype),
                         a.device, matmul_df.BLOCK)
    return matmul_df.matmul_df(a, b, spec, scale=scale, bias=bias,
                               residual=residual, activation=activation,
                               out_dtype=out_dtype)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def int8_matmul(
    aq: torch.Tensor, bq: torch.Tensor, a_scale, b_scale,
    spec: Spec = None, backend: Optional[str] = None,
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
    spec: Spec = None,
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
    spec: Spec = None,
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
        spec = _resolve_spec(spec, _gemm_problem(m, k, n, aq.dtype,
                                                 torch.float32, pw.bits),
                             aq.device, matmul_df.BLOCK)
        out = matmul_df.matmul_df(
            aq, pw.codes, spec, scale=scale,
            bias=bias, residual=residual, activation=activation,
            out_dtype=torch.float32, weight_bits=pw.bits,
            b_hi=pw.highbits, outlier_idx=pw.outlier_idx,
            outlier_delta=pw.outlier_delta)
    return _poison(out, fault)


def matmul_packed(
    aq: torch.Tensor,
    pw: pack.PackedWeights,
    a_scale: Optional[torch.Tensor] = None,
    spec: Spec = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Packed-weight GEMM, dequant-only epilogue:
    ``(a_scale * w_scale) * (aq @ W)`` -> f32 (bit for bit the oracle)."""
    return matmul_packed_fused(aq, pw, a_scale=a_scale, spec=spec,
                               backend=backend)


@functools.lru_cache(maxsize=4096)
def _attention_problem(q_shape: tuple, q_dtype: torch.dtype, k_shape: tuple,
                       k_dtype: torch.dtype, causal: bool,
                       window: Optional[int], rows: int) -> AttentionProblem:
    """The problem an attention call keys the autotuner on: a run-time
    valid length keys as the whole buffer (the reference's worst case)."""
    b, hq, sq, d = q_shape
    hkv, skv = k_shape[1], k_shape[2]
    kdt = cost_model.dtype_name(k_dtype)
    dt = cost_model.dtype_name(q_dtype)
    return AttentionProblem(bh=b * hq, sq=sq, skv=skv, d=d, group=hq // hkv,
                            causal=causal, window=window, dtype=dt,
                            kv_dtype=None if kdt == dt else kdt, rows=rows)


def attention(
    q: torch.Tensor,            # (B, Hq, Sq, D)
    k: torch.Tensor,            # (B, Hkv, Skv, D)
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    spec: Spec = None,
    bq: Optional[int] = None,
    bkv: Optional[int] = None,
    backend: Optional[str] = None,
    anchor: Optional[str] = None,          # "os" flash | "ws" kv-stationary
    group: Optional[int] = None,
    kv_len: ref.KvLen = None,              # valid KV prefix: int or (B,)
    window_dyn: Optional[int] = None,      # run-time sliding window
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    return_lse: bool = False,
):
    """GQA attention under the OS (flash, B2) or WS (kv-stationary, B7)
    anchor: ``anchor``, or the spec's, or (neither given) the autotuned
    pick of the call's ``AttentionProblem``.  Returns (B, Hq, Sq, D).

    ``return_lse``: returns (out, each row's statistic, f32 (B, Hq, Sq);
    ``ref.attention_ref``'s), for a rank attending over its range of a
    cache split over the keys (``kv_len`` then below 0 or above ``Skv``
    where the range lies wholly after or before the rows).  Only B2 keeps
    statistics, so such a call takes the OS anchor and no autotuned pick
    (naming "ws" raises); it carries no gradient.

    ``kv_len`` is the filled prefix of a padded KV buffer; q rows
    right-align against it and the kernel visits only the KV tiles in
    each q tile's band.  A ``(B,)`` vector bands every batch row at its
    own length.  ``window``/``window_dyn`` is a causal sliding window
    (PyTorch runs eagerly, so the two mean the same here).  int8 K/V
    (the int8 KV cache) take per-position f32 ``k_scale``/``v_scale`` of
    shape ``(B, Hkv, Skv, 1)``, dequantized inside the kernel (folded
    into the scores and probabilities); the cache is never copied to
    float.  Where grad is enabled and q, k or v requires it, the launch
    runs inside ``autograd.attention`` (float K/V, a scalar ``kv_len``),
    whose backward is plain PyTorch.
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
    if isinstance(spec, SpecOverride):
        # its fields fill whichever of anchor/bq/bkv were not passed
        if spec.anchor not in (None, OS, WS):
            raise ValueError(f"attention admits OS/WS anchors, not "
                             f"{spec.anchor!r}")
        anchor = anchor if anchor is not None else spec.anchor_name
        bq = bq if bq is not None else spec.block_dim(0)
        bkv = bkv if bkv is not None else spec.block_dim(1)
        spec = None
    win = window if window is not None else window_dyn
    if torch.is_tensor(win):
        win = int(win)
    backend = _backend(backend)
    if return_lse:
        if anchor not in (None, "os") or (spec is not None
                                          and spec.anchor != OS):
            raise ValueError("row statistics come from B2 (the OS anchor) "
                             "alone")
        anchor = "os"
    if spec is None and anchor is None and backend != "torch":
        ragged = torch.is_tensor(kv_len) and kv_len.ndim == 1
        spec = _picked(_attention_problem(
            tuple(q.shape), q.dtype, tuple(k.shape), k.dtype, causal, win,
            b if ragged else 1), q.device)
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
    if torch.is_tensor(kv_len) and kv_len.ndim == 1 \
            and kv_len.shape[0] != b:
        raise ValueError(f"per-row kv_len needs one entry per batch row "
                         f"({b}), got shape {tuple(kv_len.shape)}")
    if backend == "torch":
        out = ref.attention_ref(q, k, v, causal=causal, window=win,
                                scale=scale, kv_len=kv_len, k_scale=k_scale,
                                v_scale=v_scale, return_lse=return_lse)
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
        if return_lse:
            out = attention_df.flash_attention(
                q, k, v, causal=causal, window=win, scale=scale,
                kv_len=kv_len, k_scale=k_scale, v_scale=v_scale,
                return_lse=True)
        elif autograd.b2_carries_grad(q, k, v, kv_len=kv_len,
                                      k_scale=k_scale):
            out = autograd.attention(
                q, k, v, causal, win,
                float(scale if scale is not None else q.shape[-1] ** -0.5),
                None if kv_len is None else int(kv_len), anchor)
        else:
            out = _attention(q, k, v, anchor, causal=causal, window=win,
                             scale=scale, kv_len=kv_len, k_scale=k_scale,
                             v_scale=v_scale)
    if return_lse:
        out, lse = out
        return _poison(out, fault), lse
    return _poison(out, fault)


def _attention(q, k, v, anchor: str, **kw) -> torch.Tensor:
    """One launch of B2 (``anchor`` "os") or B7 ("ws"): no fault site, no
    gradient."""
    fn = attention_df.flash_attention if anchor == "os" \
        else attention_df.kv_stationary_attention
    return fn(q, k, v, **kw)


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
    spec: Spec = None,
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
        fh, fw, _, cout = w.shape
        spec = _resolve_spec(spec, _conv_problem(
            tuple(x.shape), x.dtype, cout, fh, fw, stride, out_dtype),
                             x.device, conv2d_df.BLOCK)
        out = conv2d_df.conv2d_df(x, w, stride, spec, out_dtype=out_dtype)
    return _poison(out, fault)


def conv2d_fused(
    x: torch.Tensor,           # (N, H, W, Cin)
    w: torch.Tensor,           # (fh, fw, Cin, Cout)
    stride: int = 1,
    bias: Optional[torch.Tensor] = None,       # (Cout,) or (1, Cout) float
    scale: Optional[torch.Tensor] = None,      # scalar or (Cout,)
    residual: Optional[torch.Tensor] = None,   # (N, oh, ow, Cout)
    activation: Optional[str] = None,          # relu | gelu | silu
    spec: Spec = None,
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
        fh, fw = w.shape[:2]
        spec = _resolve_spec(spec, _conv_problem(
            tuple(x.shape), x.dtype, cout, fh, fw, stride,
            out_dtype or torch.float32),
            x.device, conv2d_df.BLOCK)
        out = conv2d_df.conv2d_df(
            x, w, stride, spec,
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
    spec: Spec = None,
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
    spec: Spec = None,
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
        spec = _resolve_spec(spec, _conv_problem(
            tuple(xq.shape), xq.dtype, pcw.kout, pcw.fh, pcw.fw, stride,
            torch.float32, pcw.bits),
            xq.device, conv2d_df.BLOCK)
        out = conv2d_df.conv2d_df(
            xq, pcw.codes, stride, spec,
            out_dtype=torch.float32, epilogue=epi, scale=scale, bias=bias,
            residual=residual, weight_bits=pcw.bits, w_hi=pcw.highbits,
            outlier_idx=pcw.outlier_idx, outlier_delta=pcw.outlier_delta)
    return _poison(out, fault)


def conv2d_packed(
    xq: torch.Tensor,
    pcw: pack.PackedConvWeights,
    stride: int = 1,
    x_scale: Optional[torch.Tensor] = None,
    spec: Spec = None,
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
    spec: Spec = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Packed +-1 GEMM: (M, N) int32 dots ``n_bits - 2*popcount(a ^ b)``."""
    fault = health.maybe_inject("kernel.binary_matmul")
    binary_mm.check_operands(a_packed, b_packed, n_bits)
    if _backend(backend) == "torch":
        out = ref.binary_matmul_ref(a_packed, b_packed, n_bits)
    else:
        m, kp = a_packed.shape
        spec = _resolve_spec(spec, _binary_problem(
            m, kp, b_packed.shape[1], n_bits, torch.int32),
            a_packed.device, binary_mm.BLOCK)
        out = binary_mm.binary_mm_df(a_packed, b_packed, n_bits, spec,
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
    spec: Spec = None,
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
        out_dtype = out_dtype or (torch.int8 if binarize else torch.float32)
        spec = _resolve_spec(spec, _binary_problem(
            a_packed.shape[0], a_packed.shape[1], n, n_bits, out_dtype),
            a_packed.device, binary_mm.BLOCK)
        out = binary_mm.binary_mm_df(
            a_packed, b_packed, n_bits, spec, out_dtype=out_dtype,
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
    spec: Spec = None,
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
