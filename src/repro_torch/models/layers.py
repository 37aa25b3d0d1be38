"""Model layers of the port: plain functions on tensors.

Twins of ``repro/models/layers.py`` for the dense decoder: RMSNorm,
RoPE, embedding, GQA attention (prefill and cached), paged decode
attention, the bidirectional attention of an encoder and of cross
attention, the SwiGLU MLP, the binary MLP and the packed-weight SwiGLU
MLP, with parameters as dictionaries of tensors in the JAX package's
layout.

Kernel dispatch: the SwiGLU MLP's three projections go through
``fused_dense`` -> ``ops.matmul_fused`` (B1), the packed MLP's three
through ``ops.matmul_packed[_fused]`` (B1 with B6 decoding the planes),
the binary MLP's two through ``binary_dense`` ->
``ops.binary_matmul_fused`` (B9), prefill and cached attention through
``ops.attention`` (B2), paged decode through ``ops.paged_attention``
(B3).  The q/k/v/o projections, the unembedding and
``bidir_attention`` stay plain PyTorch, as the JAX package leaves them to
XLA.  ``forced_backend("torch")`` pins every dispatch site onto its
plain PyTorch path — the serving engine's degraded step.  The sites
carry the ``layers.attention`` / ``layers.mlp`` fault-injection points.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.kernels import ops, pack, ref
from repro_torch.runtime import health

Params = Dict[str, torch.Tensor]
Index = Union[int, torch.Tensor]

# Process-wide kernel-backend override: "torch" pins every dispatch site
# onto its plain path; None lets each op pick the CUDA kernel.
_BACKEND_OVERRIDE: Optional[str] = None


@contextlib.contextmanager
def forced_backend(backend: Optional[str]):
    """Pin every kernel dispatch site in this module to ``backend`` for
    the duration (the serving engine's degraded steps)."""
    global _BACKEND_OVERRIDE
    prev = _BACKEND_OVERRIDE
    _BACKEND_OVERRIDE = backend
    try:
        yield
    finally:
        _BACKEND_OVERRIDE = prev


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    orig = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(orig)


def rope_frequencies(d_head: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, D) with positions broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ table.T


# ---------------------------------------------------------------------------
# Attention.
# ---------------------------------------------------------------------------
def _qkv(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor):
    """Projections, qk-norm and RoPE: q (B, Hq, S, D), k/v (B, Hkv, S, D)."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p["wq"]).reshape(b, s, h, dh)
    k = (x @ p["wk"]).reshape(b, s, hkv, dh)
    v = (x @ p["wv"]).reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q.transpose(1, 2), positions[:, None], cfg.rope_theta)
    k = apply_rope(k.transpose(1, 2), positions[:, None], cfg.rope_theta)
    return q, k, v.transpose(1, 2)


def _cache_update(buf: torch.Tensor, val: torch.Tensor, idx: Index) -> None:
    """Write ``val`` (B, H, S, D) into ``buf`` (B, H, S_max, D) at
    position ``idx`` (one offset, or one per batch row), in place."""
    s = val.shape[2]
    if torch.is_tensor(idx) and idx.ndim == 1:
        pos = idx.to(buf.device).long()[:, None] + torch.arange(
            s, device=buf.device)
        rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
        buf[rows, :, pos] = val.transpose(1, 2).to(buf.dtype)
    else:
        i = int(idx)
        buf[:, :, i:i + s] = val.to(buf.dtype)


def _range_update(buf: torch.Tensor, val: torch.Tensor, idx: Index,
                  k0: int) -> None:
    """Write into ``buf`` (B, H, n, D), which holds the positions ``[k0,
    k0 + n)`` of a cache, the part of ``val`` (B, H, S, D) whose
    positions ``idx + [0, S)`` (one offset, or one per batch row) fall
    there, in place."""
    s, n = val.shape[2], buf.shape[2]
    if torch.is_tensor(idx) and idx.ndim == 1:
        pos = (idx.to(buf.device).long()[:, None] - k0
               + torch.arange(s, device=buf.device))
        hit = (pos >= 0) & (pos < n)
        rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
        buf[rows.expand_as(pos)[hit], :, pos[hit]] = \
            val.transpose(1, 2)[hit].to(buf.dtype)
    else:
        i = int(idx) - k0
        lo, hi = max(i, 0), min(i + s, n)
        if hi > lo:
            buf[:, :, lo:hi] = val[:, :, lo - i:hi - i].to(buf.dtype)


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(batch, head, position) int8 quantization of K/V:
    int8 codes and (B, H, S, 1) f32 scales."""
    return quant.symmetric_int8(x, axis=-1)


def _finish(p: Params, out: torch.Tensor, fault: Optional[str]):
    if fault == "nan":
        out = out * float("nan")
    b, h, s, dh = out.shape
    return out.transpose(1, 2).reshape(b, s, h * dh) @ p["wo"]


def attention_apply(
    p: Params,
    x: torch.Tensor,                  # (B, S, D_model)
    cfg,
    positions: Optional[torch.Tensor] = None,
    window: Optional[int] = None,     # static sliding window
    kv_cache: Optional[Tuple[torch.Tensor, ...]] = None,
    cache_index: Optional[Index] = None,
    attend_local: bool = False,
    backend: Optional[str] = None,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, ...]]]:
    """GQA self-attention.  Returns (out, new_kv_cache).

    With ``kv_cache`` (each (B, Hkv, S_max, D)) the fresh K/V is written
    into the buffers in place at ``cache_index``, and attention runs
    over the filled prefix (``kv_len = cache_index + S``) — or, with
    ``attend_local`` (prefill from zero), over the fresh K/V alone, which
    is the same math over S positions instead of S_max.  In place is
    safe for a retried step: the write lands beyond the prefix the
    caller has committed, and a retry rewrites the same positions.

    An int8 cache is the 4-tuple ``(k, v, k_scale, v_scale)``, the
    scales (B, Hkv, S_max, 1) f32: the fresh K/V is quantized per
    position (``_quantize_kv``) and its codes and scales written in
    place, and attention runs over the int8 buffers with their scales
    (dequantized inside the kernel), or with ``attend_local`` over the
    fresh float K/V, as the JAX package does.
    """
    fault = health.maybe_inject("layers.attention")
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions)
    new_cache = None
    kv_len = None
    k_att, v_att = k, v
    k_sc = v_sc = None
    if kv_cache is not None:
        ck, cv = kv_cache[0], kv_cache[1]
        if ck.dtype == torch.int8:
            (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
            new_cache = kv_cache
            for buf, val in zip(kv_cache, (kq, vq, ks, vs)):
                _cache_update(buf, val, cache_index)
        else:
            _cache_update(ck, k, cache_index)
            _cache_update(cv, v, cache_index)
            new_cache = (ck, cv)
        if not attend_local:
            k_att, v_att = ck, cv
            if ck.dtype == torch.int8:
                k_sc, v_sc = kv_cache[2], kv_cache[3]
            kv_len = cache_index + s
    out = ops.attention(q, k_att, v_att, causal=True,
                        scale=cfg.d_head ** -0.5, window=window,
                        kv_len=kv_len, k_scale=k_sc, v_scale=v_sc,
                        backend=backend or _BACKEND_OVERRIDE)
    return _finish(p, out, fault), new_cache


def attention_key_range(
    p: Params,
    x: torch.Tensor,                  # (B, S, D_model), normed
    cfg,
    positions: torch.Tensor,
    window: Optional[int],
    kv_range: Tuple[torch.Tensor, ...],
    cache_index: Index,
    k0: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GQA self-attention of ``x`` over one range of a cache's keys: the
    buffers ``kv_range`` (each (B, Hkv, n, D); an int8 cache's 4-tuple
    as in ``attention_apply``) hold the positions ``[k0, k0 + n)`` of
    the whole cache, as a ``model`` rank's shard holds them.

    The fresh K/V (quantized for an int8 cache) is written in place
    where its positions ``cache_index + [0, S)`` meet the range, and B2
    attends over the range with the valid length ``cache_index + S -
    k0`` (below 0 or over ``n`` where the range lies wholly after or
    before the rows), returning its rows' statistics too.  Returns (out
    (B, Hq, S, D) before ``wo``, lse (B, Hq, S) f32): the ranges'
    pairs merge into the whole cache's attention
    (``parallel.merge_key_ranges``), which ``_finish`` projects.  No
    fault site: the caller fires ``layers.attention`` once for the
    merged call."""
    s = x.shape[1]
    q, k, v = _qkv(p, x, cfg, positions)
    if kv_range[0].dtype == torch.int8:
        (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
        fresh = (kq, vq, ks, vs)
    else:
        fresh = (k, v)
    for buf, val in zip(kv_range, fresh):
        _range_update(buf, val, cache_index, k0)
    scales = kv_range[2:] if len(kv_range) == 4 else (None, None)
    return ops.attention(q, kv_range[0], kv_range[1], causal=True,
                         scale=cfg.d_head ** -0.5, window=window,
                         kv_len=cache_index + s - k0, k_scale=scales[0],
                         v_scale=scales[1], return_lse=True,
                         backend=_BACKEND_OVERRIDE)


def paged_attention_apply(
    p: Params,
    x: torch.Tensor,                  # (B, 1, D_model) decode activations
    cfg,
    *,
    positions: torch.Tensor,          # (B, 1) position of this token
    window: Optional[int],
    k_pages: torch.Tensor,            # (Hkv, n_pages, page, Dh) one layer
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,       # (B, max_pages) int32 page ids
    kv_lens: torch.Tensor,            # (B,) int32 filled length (pre-write)
    write_pids: torch.Tensor,         # (B,) page receiving this step's KV
    write_offs: torch.Tensor,         # (B,) offset within that page
    backend: Optional[str] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """GQA decode attention straight off a paged KV pool.

    The fresh K/V is scattered into the pool in place at
    ``(write_pids, write_offs)`` — one position past each row's
    committed length, or the pool's scratch page for idle rows — and
    attention runs through ``ops.paged_attention`` with a
    ``kv_lens + 1`` band.  Returns ``(out, (k_pages, v_pages))``.
    """
    fault = health.maybe_inject("layers.attention")
    q, k, v = _qkv(p, x, cfg, positions)
    k_pages[:, write_pids, write_offs] = k[:, :, 0].transpose(0, 1).to(
        k_pages.dtype)
    v_pages[:, write_pids, write_offs] = v[:, :, 0].transpose(0, 1).to(
        v_pages.dtype)
    out = ops.paged_attention(q, k_pages, v_pages, block_tables, kv_lens + 1,
                              scale=cfg.d_head ** -0.5, window=window,
                              backend=backend or _BACKEND_OVERRIDE)
    return _finish(p, out, fault), (k_pages, v_pages)


# ---------------------------------------------------------------------------
# Bidirectional attention (the encoder's self-attention, cross attention).
# Plain PyTorch on any device: the reference computes it with jnp einsums
# outside any Pallas kernel (``layers.bidir_attention``), so there is no
# TPU kernel to port, and its twin here is the same einsum.
# ---------------------------------------------------------------------------
def _plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, return_lse: bool = False):
    """The reference's ``_plain_attention`` without a mask (all keys
    visible): q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D); logits and the
    softmax in float32; the output in q's dtype (and, with
    ``return_lse``, the rows' log-sum-exp of the scaled logits (B, Hq,
    Sq) float32)."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, sq, d).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    out = out.reshape(b, hq, sq, d).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(logits, dim=-1).reshape(b, hq, sq)


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float, q_chunk: int = 512,
                       kv_chunk: int = 1024, return_lse: bool = False):
    """The reference's double-chunked online softmax without a mask:
    q chunks outer, KV chunks inner, a running (m, l, acc) in float32 per
    q row, so live memory is O(q_chunk x kv_chunk) whatever the length.
    The reference pads the last chunks and masks the padding; here they
    are shorter, which adds nothing to a sum.  ``return_lse`` as in
    ``_plain_attention`` (``m + log l``)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    kf, vf = k.float(), v.float()
    outs, lses = [], []
    for q0 in range(0, sq, q_chunk):
        qi = q[:, :, q0:q0 + q_chunk].reshape(b, hkv, g, -1, d).float()
        m = torch.full(qi.shape[:-1] + (1,), float("-inf"),
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qi)
        for k0 in range(0, skv, kv_chunk):
            logits = torch.einsum("bhgqd,bhkd->bhgqk", qi,
                                  kf[:, :, k0:k0 + kv_chunk]) * scale
            m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
            p = torch.exp(logits - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vf[:, :, k0:k0 + kv_chunk])
            m = m_new
        outs.append((acc / l).reshape(b, hq, -1, d).to(q.dtype))
        lses.append((m + torch.log(l)).reshape(b, hq, -1))
    out = torch.cat(outs, dim=2)
    return (out, torch.cat(lses, dim=2)) if return_lse else out


def bidir_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, chunked_threshold: int = 2048,
                    return_lse: bool = False):
    """Non-causal GQA attention (the encoder's, and cross attention): the
    masked einsum up to ``chunked_threshold`` keys, the double-chunked
    online softmax above, as the reference dispatches.  Plain PyTorch on
    every device (see the section's head): no kernel of the port runs
    here.  With ``return_lse``, (out, the rows' log-sum-exp (B, Hq, Sq)
    float32): over a range of the keys, the pair that
    ``parallel.merge_key_ranges`` merges with the other ranges'."""
    if k.shape[2] > chunked_threshold:
        return _chunked_attention(q, k, v, scale, return_lse=return_lse)
    return _plain_attention(q, k, v, scale, return_lse)


# ---------------------------------------------------------------------------
# SwiGLU MLP.
# ---------------------------------------------------------------------------
def fused_dense(
    x: torch.Tensor,                      # (..., d_in)
    w: torch.Tensor,                      # (d_in, d_out)
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Projection through the fused-epilogue GEMM kernel (B1): leading
    dims collapse to M, bias/activation/residual apply before the one
    output write."""
    lead = x.shape[:-1]
    r2 = (residual.reshape(-1, residual.shape[-1])
          if residual is not None else None)
    out = ops.matmul_fused(x.reshape(-1, x.shape[-1]), w, bias=bias,
                           residual=r2, activation=activation)
    return out.reshape(*lead, w.shape[-1]).to(x.dtype)


# ---------------------------------------------------------------------------
# Binary (+-1, xnor-popcount) MLP.
# ---------------------------------------------------------------------------
def binary_dense(
    p: Params,                    # w_packed (d_in/32, d_out) int32, scale, bias
    x: torch.Tensor,              # (..., d_in) real-valued or +-1
    binarize: bool = True,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Binarize ``x`` (``x > 0`` -> +1), project through the fused binary
    GEMM (B9) and apply the folded batchnorm (and the sign, when
    ``binarize``) before its one output write: +-1 int8 or float32."""
    if backend is None:
        backend = _BACKEND_OVERRIDE
    d_in = x.shape[-1]
    lead = x.shape[:-1]
    xp = ref.pack_binary(x.reshape(-1, d_in), axis=1)
    out = ops.binary_matmul_fused(xp, p["w_packed"], d_in, scale=p["scale"],
                                  bias=p["bias"], binarize=binarize,
                                  backend=backend)
    return out.reshape(*lead, out.shape[-1])


def binary_mlp_apply(p: Params, x: torch.Tensor,
                     backend: Optional[str] = None) -> torch.Tensor:
    """Two chained binary projections: the hidden layer re-binarized at
    the flush (int8 +-1), the output left real-valued for the residual
    stream."""
    h = binary_dense(p["up"], x, binarize=True, backend=backend)
    return binary_dense(p["down"], h, binarize=False, backend=backend)


# ---------------------------------------------------------------------------
# Sub-byte packed-weight SwiGLU MLP (kernels/pack.py datapath).
# ---------------------------------------------------------------------------
def draw_packed(gen: torch.Generator, d_in: int, d_out: int, bits: int = 4,
                device=None) -> pack.PackedWeights:
    """One packed (d_in, d_out) weight, drawn from ``gen`` as the JAX
    package's ``init_packed_mlp`` draws each projection: in-range
    ``bits``-wide int8 codes, ``min(2, capacity)`` outlier rows with
    spikes in [-100, 100], scale ``1/(127 sqrt(d_in))``, packed at
    ``pack.outlier_capacity(d_in)``."""
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    q = torch.randint(lo, hi + 1, (d_in, d_out), generator=gen,
                      device=device, dtype=torch.int32)
    cap = pack.outlier_capacity(d_in)
    rows = torch.randperm(d_in, generator=gen, device=device)[:min(2, cap)]
    q[rows] = torch.randint(-100, 101, (rows.numel(), d_out), generator=gen,
                            device=device, dtype=torch.int32)
    scale = torch.full((1, d_out), 1.0 / (127.0 * d_in ** 0.5),
                       dtype=torch.float32, device=device)
    return pack.pack_int8(q.to(torch.int8), scale, bits=bits,
                          max_outliers=cap)


def init_packed_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                    bits: int = 4, device=None) -> Dict[str, pack.PackedWeights]:
    """SwiGLU MLP with sub-byte packed weights (``draw_packed`` each)."""
    return {"w1": draw_packed(gen, d_model, d_ff, bits, device),   # gate
            "w3": draw_packed(gen, d_model, d_ff, bits, device),   # up
            "w2": draw_packed(gen, d_ff, d_model, bits, device)}   # down


def packed_mlp_apply(p: Dict[str, pack.PackedWeights], x: torch.Tensor,
                     backend: Optional[str] = None) -> torch.Tensor:
    """SwiGLU through the packed-weight GEMMs.  Activations quantize per
    tensor to int8 at each projection boundary, over the flattened
    batch, as the JAX package's does (so a row's result depends on the
    other rows of its batch); each projection is one kernel launch with
    the combined (activation x per-column weight) scale, and the gate's
    silu, fused into its flush."""
    if backend is None:
        backend = _BACKEND_OVERRIDE
    lead = x.shape[:-1]
    xq, xs = quant.symmetric_int8(x.reshape(-1, x.shape[-1]))
    gate = ops.matmul_packed_fused(xq, p["w1"], a_scale=xs,
                                   activation="silu", backend=backend)
    up = ops.matmul_packed(xq, p["w3"], a_scale=xs, backend=backend)
    hq, hs = quant.symmetric_int8(gate * up)
    out = ops.matmul_packed(hq, p["w2"], a_scale=hs, backend=backend)
    return out.reshape(*lead, out.shape[-1])


def mlp_apply(p: Params, x: torch.Tensor, cfg=None) -> torch.Tensor:
    """The MLP: binary params (``cfg.binary_mlp``) through
    ``binary_mlp_apply``, packed params (``cfg.packed_weights``) through
    ``packed_mlp_apply``; SwiGLU through the fused GEMM kernel (the
    gate's silu fused into its output write), or plain matmuls under
    ``forced_backend("torch")``."""
    fault = health.maybe_inject("layers.mlp")
    if "up" in p:
        out = binary_mlp_apply(p, x).to(x.dtype)
    elif isinstance(p.get("w1"), pack.PackedWeights):
        out = packed_mlp_apply(p, x).to(x.dtype)
    elif _BACKEND_OVERRIDE is None:
        gate = fused_dense(x, p["w1"], activation="silu")
        up = fused_dense(x, p["w3"])
        out = fused_dense((gate * up).to(x.dtype), p["w2"])
    else:
        gate = F.silu(x @ p["w1"])
        out = (gate * (x @ p["w3"])) @ p["w2"]
    if fault == "nan":
        out = out * float("nan")
    return out
