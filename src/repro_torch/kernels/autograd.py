"""Gradients through the port's kernels: B1 and B2 as autograd ops.

The JAX package trains with ``jax.value_and_grad`` of ``lm.loss_fn``.
None of its Pallas kernels has a ``custom_vjp`` (the only one in the
package wraps the MoE all-to-all), so no TPU kernel has a backward of
its own and this module adds no kernel: it makes the port's forward
kernels carry gradients.  A kernel launch writes into a fresh tensor
that autograd knows nothing of, so outside this module a gradient would
stop there; every wrapper therefore refuses an operand that requires
grad while grad is enabled (``_build.refuse_grad``), and a gradient is
never dropped in silence.

* ``matmul_fused`` (B1, ``act(scale * (a @ b) + bias) + residual``; the
  MLP's projections, the shared experts, whisper's encoder MLP).  Its
  forward is the serving path's launch (``ops.matmul_fused`` with
  ``spec=None``: the autotuner's pick, B1 or where picked B4/B5), so its
  bits are the serving path's.  Its backward, with ``dU`` the gradient
  of the epilogue's input: ``dA = dU @ b^T`` and ``dB = a^T @ dU``, each
  one launch of B1 on the basic OS dataflow with an explicit spec (no
  autotuner lookup, so the store holds no backward shapes), ``b^T`` and
  ``a^T`` contiguous copies (B1 reads both operands row-major);
  where the epilogue has an activation, the pre-activation recomputed by
  one more B1 launch and ``act'`` applied in PyTorch; the bias and
  residual gradients plain sums.  ``dU`` is cast to the operands' dtype
  before the GEMMs (the reference's bf16 cotangents are bf16), and every
  gradient comes back in its operand's dtype.
* ``attention`` (B2, or B7 where the autotuner picks WS).  Its forward
  is the kernel.  Its backward recomputes ``softmax(q k^T * scale)`` in
  float32 from the saved q, k and v, with the forward's mask (causal,
  window, valid length) and GQA grouping, and forms dQ, dK and dV in
  plain PyTorch: it holds B * Hq * Sq * Skv float32 probabilities and
  their gradient at once (67 MB each a layer at qwen3-1.7b's 16 heads
  and 4 x 512 tokens).  A flash backward kernel is parked in ROADMAP B.

Both are ``torch.library.custom_op``s with their autograd registered,
not ``autograd.Function``s: ``torch.utils.checkpoint``'s selective policy
sees only dispatcher ops, and ``lm``'s ``remat="dots"`` keeps B1's
outputs with the other GEMMs' (``KEPT_UNDER_DOTS``) and recomputes the
rest.  On the CPU both run the same wrappers, so the kernels' plain
versions, forward and backward: the CPU tests hold the backward's
formulas against autograd through the plain ops.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import matmul_df, ops, ref


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Is grad enabled, and does any of ``tensors`` require it?"""
    return torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad for t in tensors)


def b1_carries_grad(spec, a: torch.Tensor, b: torch.Tensor,
                    bias=None, residual=None, scale=None) -> bool:
    """Does this B1 call run through ``matmul_fused`` below?  Float
    operands under grad; it takes the serving path's pick only, and no
    trained scale (no caller trains one)."""
    if not a.is_floating_point() or not needs_grad(a, b, bias, residual,
                                                   scale):
        return False
    if spec is not None:
        raise NotImplementedError(
            "under grad B1 runs the serving path's pick: call with "
            "spec=None")
    if needs_grad(scale):
        raise NotImplementedError("B1's backward trains no scale")
    return True


def b2_carries_grad(q, k, v, kv_len, k_scale) -> bool:
    """Does this attention call run through ``attention`` below?  Under
    grad, float K/V and one valid length for the batch (the training
    path's: the sequence's own K/V)."""
    if not needs_grad(q, k, v):
        return False
    if k_scale is not None or (torch.is_tensor(kv_len) and kv_len.ndim):
        raise NotImplementedError(
            "attention's backward takes float K/V and one valid length; "
            "an int8 KV cache and per-row lengths are serving's, not "
            "trained")
    return True


# --------------------------------------------------------------------------
# B1.
# --------------------------------------------------------------------------
@torch.library.custom_op("repro_torch::matmul_fused", mutates_args=())
def matmul_fused(a: torch.Tensor, b: torch.Tensor,
                 bias: Optional[torch.Tensor], scale: Optional[torch.Tensor],
                 residual: Optional[torch.Tensor],
                 activation: Optional[str],
                 out_dtype: torch.dtype) -> torch.Tensor:
    """B1 as the serving path launches it; ``bias`` and ``scale`` as the
    kernel takes them (``scale`` never trained)."""
    return ops._matmul_fused(a, b, bias, scale, residual, activation, None,
                             out_dtype)


def _b1_setup(ctx, inputs, output) -> None:
    a, b, bias, scale, residual, activation, _ = inputs
    ctx.save_for_backward(a, b, bias, scale)
    ctx.activation = activation
    ctx.residual_dtype = None if residual is None else residual.dtype


def _b1(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype,
        **epilogue) -> torch.Tensor:
    """One backward launch of B1, on the basic OS dataflow."""
    return ops._matmul_fused(a, b, epilogue.get("bias"),
                             epilogue.get("scale"), None, None,
                             matmul_df.BASIC_OS, out_dtype)


def _b1_backward(ctx, grad: torch.Tensor):
    a, b, bias, scale = ctx.saved_tensors
    need_a, need_b, need_bias, _, need_res = ctx.needs_input_grad[:5]
    gu = grad.float()
    if ctx.activation is not None:
        u = _b1(a, b, torch.float32, bias=bias, scale=scale)
        with torch.enable_grad():
            u.requires_grad_()
            y = ref.ACTIVATION_FNS[ctx.activation](u)
        gu, = torch.autograd.grad(y, u, gu)
    g_bias = gu.sum(0, keepdim=True).to(bias.dtype) if need_bias else None
    g_res = grad.to(ctx.residual_dtype) if need_res else None
    gp = (gu if scale is None else gu * scale).to(a.dtype)
    g_a = _b1(gp, b.t().contiguous(), a.dtype) if need_a else None
    g_b = _b1(a.t().contiguous(), gp, b.dtype) if need_b else None
    return g_a, g_b, g_bias, None, g_res, None, None


matmul_fused.register_autograd(_b1_backward, setup_context=_b1_setup)


# --------------------------------------------------------------------------
# B2 (and B7).
# --------------------------------------------------------------------------
@torch.library.custom_op("repro_torch::attention", mutates_args=())
def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: Optional[int], scale: float,
              kv_len: Optional[int], anchor: str) -> torch.Tensor:
    """B2 (``anchor`` "os") or B7 ("ws") over float K/V."""
    return ops._attention(q, k, v, anchor, causal=causal, window=window,
                          scale=scale, kv_len=kv_len)


def _b2_setup(ctx, inputs, output) -> None:
    q, k, v, causal, window, scale, kv_len, _ = inputs
    ctx.save_for_backward(q, k, v)
    ctx.mask = (causal, window, kv_len)
    ctx.scale = scale


def _b2_backward(ctx, grad: torch.Tensor):
    q, k, v = ctx.saved_tensors
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    causal, window, kv_len = ctx.mask
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d)
    kf, vf = k.float(), v.float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * ctx.scale
    logits.masked_fill_(~ref.visible_keys(sq, skv, kv_len, causal, window,
                                          q.device), float("-inf"))
    p = torch.softmax(logits, dim=-1).nan_to_num_(nan=0.0)
    del logits
    go = grad.float().reshape(qf.shape)
    g_v = torch.einsum("bhgqk,bhgqd->bhkd", p, go)
    # the softmax's backward, then the scale: dS = P (dP - rowsum(dP P))
    gs = torch.einsum("bhgqd,bhkd->bhgqk", go, vf)
    gs.sub_((gs * p).sum(dim=-1, keepdim=True)).mul_(p).mul_(ctx.scale)
    del p
    g_q = torch.einsum("bhgqk,bhkd->bhgqd", gs, kf).reshape(b, hq, sq, d)
    g_k = torch.einsum("bhgqk,bhgqd->bhkd", gs, qf)
    return (g_q.to(q.dtype), g_k.to(k.dtype), g_v.to(v.dtype),
            None, None, None, None, None)


attention.register_autograd(_b2_backward, setup_context=_b2_setup)


# The ops whose outputs ``lm``'s ``remat="dots"`` keeps (the reference's
# ``checkpoint_dots``: every matrix product's output); everything else,
# B2 included, is recomputed in the backward.
KEPT_UNDER_DOTS = frozenset((torch.ops.repro_torch.matmul_fused.default,
                             torch.ops.aten.mm.default,
                             torch.ops.aten.bmm.default,
                             torch.ops.aten.addmm.default,
                             torch.ops.aten.baddbmm.default))
