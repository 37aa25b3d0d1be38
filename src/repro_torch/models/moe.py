"""Mixture-of-Experts layer of the port: sort-based capacity dispatch.

Twin of ``repro/models/moe.py``'s local path.  Tokens are routed to
their top-k experts (``_route``: float32 logits, softmax, top-k,
renormalized gates, the Switch load-balancing loss), the token->expert
assignments sorted by expert id into slots of an ``(E, C, D)`` capacity
buffer (``_dispatch_indices``; an expert's assignments past its
capacity ``C`` are dropped), the buffer run through every expert as one
batched SwiGLU (``_expert_ffn``), and each token's k outputs gathered
back and summed under their gates (``moe_apply``).  Shared experts
(moonshot-style) run as a dense MLP on every token through
``layers.mlp_apply``, so their projections reach the fused GEMM kernel
(B1) as the reference's reach ``fused_dense``.  The expert einsums stay
``torch.bmm``: the reference computes them with ``jnp.einsum`` outside
any Pallas kernel.

``moe_apply`` makes no host sync: the capacity is computed from host
ints, and every index stays on the device.

Parameters keep the reference's layout, with every leaf stacked on a
leading ``L`` axis as the rest of the port's are: ``router`` (L, d, E)
float32, ``w1``/``w3`` (L, E, d, f), ``w2`` (L, E, f, d) and, with
shared experts, ``shared.{w1, w3, w2}`` of width ``f * n_shared``.

The multi-device paths (``moe_apply_sharded``, ``moe_apply_psum_local``,
the all-to-all ``_a2a`` and its int8 payload ``A2A_INT8``) are queued
with the rest of the multi-device port (ROADMAP A14).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers

Params = Dict[str, torch.Tensor]


def init_moe(gen: torch.Generator, cfg, n_layers: int, device) -> Params:
    """``n_layers`` MoE blocks' weights drawn from ``gen`` on ``device``
    with the reference's scales: router N(0, 1/d) float32, experts and
    shared experts N(0, 2/(d_in+d_out)) in ``cfg.param_dtype``.  Each
    layer's leaf is drawn in float32 and cast into a preallocated stacked
    tensor, so the float32 draw never holds more than one layer (a
    moonshot-v1-16b-a3b ``w1`` is 35 GB in float32 over its 48 layers)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    dt = getattr(torch, cfg.param_dtype)

    def stacked(shape, std, dtype=dt):
        out = torch.empty((n_layers,) + shape, dtype=dtype, device=device)
        for i in range(n_layers):
            out[i] = torch.randn(shape, generator=gen,
                                 device=device).mul_(std)
        return out

    scale = (2.0 / (d + f)) ** 0.5
    p: Params = {"router": stacked((d, e), d ** -0.5, torch.float32),
                 "w1": stacked((e, d, f), scale),
                 "w3": stacked((e, d, f), scale),
                 "w2": stacked((e, f, d), scale)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        s = (2.0 / (d + fs)) ** 0.5
        p["shared"] = {"w1": stacked((d, fs), s), "w3": stacked((d, fs), s),
                       "w2": stacked((fs, d), s)}
    return p


def capacity(cfg, tokens: int) -> int:
    """Slots an expert holds for ``tokens`` routed tokens (host ints, as
    the reference computes it)."""
    return max(8, int(cfg.capacity_factor * tokens * cfg.top_k
                      / cfg.n_experts))


def router_logits(x_flat: torch.Tensor, router: torch.Tensor
                  ) -> torch.Tensor:
    """(T, E) float32 logits: float32 activations times the float32
    router (full float32 on the card: no TF32)."""
    return x_flat.float() @ router


def _route(x_flat: torch.Tensor, router: torch.Tensor, top_k: int):
    """Top-k routing with renormalized gates.  x_flat: (T, D).  Returns
    (gates (T, k) f32, experts (T, k), the load-balancing loss)."""
    probs = torch.softmax(router_logits(x_flat, router), dim=-1)
    top_g, top_e = torch.topk(probs, top_k, dim=-1)
    top_g = top_g / top_g.sum(dim=-1, keepdim=True)
    # load-balancing aux loss (Switch-style): E * sum_e f_e * p_e
    t, e = x_flat.shape[0], router.shape[1]
    counts = torch.zeros(e, dtype=torch.float32, device=x_flat.device)
    counts.index_add_(0, top_e.reshape(-1),
                      torch.ones(top_e.numel(), device=x_flat.device))
    aux = e * torch.sum(counts / t * probs.mean(dim=0)) / top_k
    return top_g, top_e, aux


def _dispatch_indices(top_e: torch.Tensor, top_k: int, n_experts: int,
                      cap: int):
    """Sort the token->expert assignments by expert (stable); each one's
    slot in its expert's buffer, and whether it fits the capacity.
    Returns (order, sorted expert, source token, clamped slot, keep)."""
    t = top_e.shape[0]
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = order // top_k
    starts = torch.searchsorted(
        se, torch.arange(n_experts, dtype=se.dtype, device=se.device),
        side="left")
    pos = torch.arange(t * top_k, device=se.device) - starts[se]
    keep = pos < cap
    return order, se, st, pos.clamp(max=cap - 1), keep


def _expert_ffn(p: Params, xs: torch.Tensor) -> torch.Tensor:
    """Batched SwiGLU over experts: xs (E, C, D) -> (E, C, D)."""
    gate = F.silu(torch.bmm(xs, p["w1"]))
    up = torch.bmm(xs, p["w3"])
    return torch.bmm(gate * up, p["w2"])


def moe_apply(p: Params, x: torch.Tensor,
              cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE block.  x: (B, S, D).  Returns (y (B, S, D), aux loss).

    Dropped assignments add exact zeros into their expert's last slot
    and gather nothing back, as the reference's do.  The capacity buffer
    is shared by every token of ``x``, so a batch's rows are coupled
    wherever an expert overflows."""
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    t = x_flat.shape[0]
    e, k = cfg.n_experts, cfg.top_k

    top_g, top_e, aux = _route(x_flat, p["router"], k)
    cap = capacity(cfg, t)
    order, se, st, pos_c, keep = _dispatch_indices(top_e, k, e, cap)

    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((se, pos_c), x_flat[st] * keep[:, None].to(x.dtype),
                   accumulate=True)
    out_buf = _expert_ffn(p, buf)

    gathered = out_buf[se, pos_c] * keep[:, None].to(out_buf.dtype)
    y_flat = torch.zeros((t * k, d), dtype=x.dtype, device=x.device)
    y_flat[order] = gathered.to(x.dtype)
    y = (y_flat.reshape(t, k, d) * top_g[..., None].to(x.dtype)).sum(dim=1)

    if "shared" in p:
        y = y + layers.mlp_apply(p["shared"], x_flat, cfg)
    return y.reshape(b, s, d), aux
