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

Expert parallelism (the reference's ``shard_map`` paths), over the
``model`` axis of a ``DeviceMesh`` (EP == TP, ``n_experts % tp == 0``):
``moe_apply(..., ep_axis=(mesh, dim))`` runs inside ``local_map`` on
this rank's experts and tokens, exchanging the capacity buffers with
``_a2a`` (an autograd ``Function`` over ``all_to_all_single``: under
``A2A_INT8`` the forward sends int8 codes with per-slot scales, the
backward a plain all-to-all with the axes swapped, a straight-through
estimator; without gradients the plain payload, as the reference's
``custom_vjp`` primal); ``moe_apply_psum_local`` routes every token on every rank
and runs the local experts only, its output summed over the axis by the
caller; ``moe_apply_sharded`` picks the all-to-all where the sequence
splits over the axis and psum-local otherwise (decode), and averages
the load-balancing loss over ``model`` and the data axes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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


# ---------------------------------------------------------------------------
# Expert parallelism.
# ---------------------------------------------------------------------------
# int8-compressed dispatch all-to-all: the forward sends int8 payload and
# per-slot scales (~2x fewer bytes than bf16); the backward routes the
# cotangent through a plain all-to-all (straight-through estimator).
A2A_INT8 = True


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``j`` of ``x``'s leading axis to rank ``j``; block ``j`` of
    the result from rank ``j`` (the reference's untiled ``all_to_all``
    with split and concat axis 0)."""
    import torch.distributed._functional_collectives as funcol

    out = funcol.all_to_all_single(x.contiguous(), None, None, group)
    return funcol.wait_tensor(out)


class _A2A(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        if not A2A_INT8:
            return _all_to_all(x, group)
        xf = x.float()
        amax = xf.abs().amax(dim=-1, keepdim=True)
        scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        q, scale = _all_to_all(q, group), _all_to_all(scale, group)
        return (q.float() * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        # split and concat are both the leading axis: its own inverse
        return _all_to_all(g, ctx.group), None


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    """The dispatch all-to-all.  As the reference's ``custom_vjp``: the
    int8 forward rule runs where the exchange is differentiated
    (training); a forward without gradients sends the plain payload."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _A2A.apply(x, group)
    return _all_to_all(x, group)


def _ep(ep_axis) -> Tuple[int, int]:
    """(size, this rank's coordinate) of ``ep_axis`` = (mesh, dim)."""
    mesh, dim = ep_axis
    return mesh.size(dim), mesh.get_local_rank(dim)


def _combine(out_buf, se, pos_c, keep, order, top_g, t, k, d, dtype):
    gathered = out_buf[se, pos_c] * keep[:, None].to(out_buf.dtype)
    y_flat = torch.zeros((t * k, d), dtype=dtype, device=out_buf.device)
    y_flat[order] = gathered.to(dtype)
    return (y_flat.reshape(t, k, d) * top_g[..., None].to(dtype)).sum(dim=1)


def moe_apply_ep(p: Params, x: torch.Tensor, cfg, ep_axis
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``moe_apply`` with ``ep_axis`` set, on local
    tensors inside ``local_map``: ``p``'s experts are this rank's
    ``E / ep``, ``x`` its tokens; the (E, C, D) capacity buffer goes out
    as (ep, E_loc, C, D), each rank's local experts run on one C slab
    from every peer, and the outputs come back the same way."""
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    t = x_flat.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    ep, _ = _ep(ep_axis)
    e_loc = e // ep
    group = ep_axis

    top_g, top_e, aux = _route(x_flat, p["router"], k)
    cap = capacity(cfg, t)
    order, se, st, pos_c, keep = _dispatch_indices(top_e, k, e, cap)
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((se, pos_c), x_flat[st] * keep[:, None].to(x.dtype),
                   accumulate=True)
    buf = _a2a(buf.reshape(ep, e_loc, cap, d), group)
    buf = buf.transpose(0, 1).reshape(e_loc, ep * cap, d)
    out = _expert_ffn(p, buf)
    out = out.reshape(e_loc, ep, cap, d).transpose(0, 1)
    out_buf = _a2a(out, group).reshape(e, cap, d)
    y = _combine(out_buf, se, pos_c, keep, order, top_g, t, k, d, x.dtype)
    if "shared" in p:
        y = y + layers.mlp_apply(p["shared"], x_flat, cfg)
    return y.reshape(b, s, d), aux


def moe_apply_psum_local(p: Params, x: torch.Tensor, cfg, ep_axis
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """EP without all-to-all: this rank routes all its tokens and runs
    its local experts only (slice ``[rank * E_loc, (rank + 1) * E_loc)``
    of the buffer).  Returns (this rank's share of the routed output,
    to be summed over ``ep_axis``; aux loss); the shared experts are the
    caller's (the reference adds them after its psum)."""
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    t = x_flat.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    ep, rank = _ep(ep_axis)
    e_loc = e // ep

    top_g, top_e, aux = _route(x_flat, p["router"], k)
    cap = capacity(cfg, t)
    order, se, st, pos_c, keep = _dispatch_indices(top_e, k, e, cap)
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((se, pos_c), x_flat[st] * keep[:, None].to(x.dtype),
                   accumulate=True)
    out_loc = _expert_ffn(p, buf[rank * e_loc:(rank + 1) * e_loc])
    out_buf = torch.zeros((e, cap, d), dtype=out_loc.dtype, device=x.device)
    out_buf[rank * e_loc:(rank + 1) * e_loc] = out_loc
    y = _combine(out_buf, se, pos_c, keep, order, top_g, t, k, d, x.dtype)
    return y.reshape(b, s, d), aux


def moe_apply_sharded(p: Params, x, cfg, mesh, dp_axes: Tuple[str, ...],
                      tp_axis: str, norm: Optional[torch.Tensor] = None,
                      ) -> Tuple[object, object]:
    """EP MoE over ``mesh``, on DTensors ``p`` (experts over ``tp_axis``)
    and ``x`` (B, S, D), normed by ``norm`` (the layer's ``ln2``) first
    when given.  Training/prefill (the sequence splits over ``tp_axis``:
    ``s % tp == 0 and s >= tp``): ``x`` sequence-sharded, capacity
    buffers exchanged by all-to-all.  Otherwise (decode): psum-local, the
    routed output ``Partial`` over ``tp_axis`` and reduced, then the
    shared experts added.  Returns (y DTensor in ``x``'s batch layout,
    the aux loss averaged over ``tp_axis`` and then ``dp_axes``, a 0-d
    replicated DTensor)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.models import parallel
    from repro_torch.models.lm import Dist

    dist = Dist(mesh, tuple(dp_axes), tp_axis)
    names = mesh.mesh_dim_names
    tdim = names.index(tp_axis)
    tp = mesh.size(tdim)
    if cfg.n_experts % tp:
        raise ValueError(f"{cfg.n_experts} experts do not split over "
                         f"{tp} ranks of {tp_axis!r}")
    b, s, _ = x.shape
    a2a_mode = s % tp == 0 and s >= tp
    bs = parallel.batch_split(dist, b)
    x_pl = parallel.act(dist, bs, Shard(1) if a2a_mode else None)
    experts = {n: p[n] for n in ("w1", "w3", "w2")}
    e_pl = {n: tuple(Shard(0) if i == tdim else Replicate()
                     for i in range(mesh.ndim)) for n in experts}
    shared = parallel._flat(p["shared"]) if "shared" in p else []
    norm_in = [] if norm is None else [(norm, parallel.act(dist, False))]
    n_ranks = mesh.size()
    all_partial = tuple(Partial() for _ in range(mesh.ndim))
    group = (mesh, tdim)

    def prelude(x, rest):
        if norm is not None:
            x = layers.rmsnorm(rest[0], x, cfg.norm_eps)
            rest = rest[1:]
        return x, rest

    def routed(x, router, w1, w3, w2, *rest):
        x, rest = prelude(x, rest)
        lp = {"router": router, "w1": w1, "w3": w3, "w2": w2}
        if a2a_mode:
            if shared:
                lp["shared"] = parallel._unflat(
                    zip([pth for pth, _ in shared], rest))
            y, aux = moe_apply_ep(lp, x, cfg, group)
        else:
            y, aux = moe_apply_psum_local(lp, x, cfg, group)
        return y, aux / n_ranks

    rep = parallel.act(dist, False)
    inputs = ([(x, x_pl), (p["router"], rep)]
              + [(experts[n], e_pl[n]) for n in ("w1", "w3", "w2")]
              + norm_in)
    if a2a_mode:
        inputs += [(v, rep) for _, v in shared]
    y_pl = x_pl if a2a_mode else parallel.act(dist, bs, Partial())
    y, aux = parallel.region(dist, routed, inputs, [y_pl, all_partial],
                             tp_region=True, batch_sharded=bs)
    aux = aux.redistribute(mesh, rep)
    if a2a_mode:
        return y, aux
    y = y.redistribute(mesh, x_pl)
    if shared:
        paths = [pth for pth, _ in shared]

        def shared_fn(x, *rest):
            x, rest = prelude(x, rest)
            return (layers.mlp_apply(parallel._unflat(
                zip(paths, rest)), x.reshape(-1, x.shape[-1]),
                cfg).reshape(x.shape),)

        (ys,) = parallel.region(
            dist, shared_fn, [(x, x_pl)] + norm_in + [(v, rep)
                                                      for _, v in shared],
            [x_pl], tp_region=False, batch_sharded=bs)
        y = y + ys
    return y, aux
