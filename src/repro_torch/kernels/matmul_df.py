"""B1: the output-stationary fused-epilogue GEMM, as a CUDA kernel.

Port of ``repro/kernels/matmul_df.py``'s OS anchor (``_os_kernel`` /
``_build_os``): ``act(scale * (a @ b) + bias) + residual`` with the
output tile's f32 accumulator held on chip across the whole reduction
and one write of the post-epilogue values.  The kernel
(``csrc/matmul_os.cu``) tiles 64x64 outputs over 32-deep k steps in a
fixed order, so a row's result does not depend on the batch it is in.

``matmul_os`` launches the kernel for CUDA tensors and raises for what
it does not take; for CPU tensors it computes the kernel's plain
version, ``ref.matmul_fused_ref``.  The WS/IS anchors (``_build_rmw``,
``_build_ws``, ``_build_is``) are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dataflow import (DataflowSpec, Epilogue,
                                       KernelRegistration, Residency, OS, WS,
                                       register_kernel)
from repro_torch.kernels import _build, ref

BLOCK = (64, 32, 64)                       # (bm, bk, bn) of csrc/matmul_os.cu
ACTIVATION_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3}

REGISTRATION = register_kernel(KernelRegistration(
    name="matmul_os",
    source="src/repro_torch/kernels/csrc/matmul_os.cu",
    replaces="src/repro/kernels/matmul_df.py:347",
    spec=DataflowSpec(anchor=OS, aux={WS: Residency.STREAMED}, block=BLOCK),
))


def _scale_mode(scale: Optional[torch.Tensor], m: int) -> int:
    """0 none, 1 per-tensor (1, 1), 2 per-column (1, N), 3 per-row (M, 1)."""
    if scale is None:
        return 0
    if scale.shape == (1, 1):
        return 1
    if scale.shape[0] == 1:
        return 2
    return 3


def matmul_os(
    a: torch.Tensor,                          # (M, K)
    b: torch.Tensor,                          # (K, N)
    scale: Optional[torch.Tensor] = None,     # (1, 1), (1, N) or (M, 1) f32
    bias: Optional[torch.Tensor] = None,      # (1, N) f32
    residual: Optional[torch.Tensor] = None,  # (M, N)
    activation: Optional[str] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``act(scale * (a @ b) + bias) + residual`` in one kernel launch."""
    m, k = a.shape
    n = b.shape[1]
    if b.shape[0] != k:
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
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
        "matmul_os", _build.ptr(a), _build.ptr(b), _build.ptr(out), m, n, k,
        _build.dtype_code(a), _build.dtype_code(out), _build.ptr(scale),
        _scale_mode(scale, m), _build.ptr(bias),
        ACTIVATION_CODES[epi.activation], _build.ptr(residual))
    return out
