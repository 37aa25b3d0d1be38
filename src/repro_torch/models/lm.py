"""The dense decoder LM of the port: init, prefill, paged decode.

Twin of ``repro/models/lm.py`` for the ``dense`` family, with the
SwiGLU MLP or (``cfg.binary_mlp``) the binary MLP.  Parameters
keep the JAX package's layout — per-layer leaves stacked on a leading
``L`` axis (``models/bridge.py`` moves a JAX tree over unchanged) — and
a Python loop over layers replaces ``lax.scan``.  The slot-cache
``decode_step`` and the MoE, SSM, hybrid and encoder-decoder families
are not ported yet (ROADMAP A5, A11, A12, A10).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch import device as device_lib
from repro_torch.kernels import ref
from repro_torch.models import layers

Params = Dict[str, Any]


def _check_supported(cfg) -> None:
    if (cfg.family != "dense" or cfg.n_experts or cfg.has_ssm
            or cfg.is_encoder_decoder or not cfg.has_attention):
        raise NotImplementedError(
            f"{cfg.name}: only dense decoders are ported (MoE, SSM and "
            f"encoder-decoder models are queued in ROADMAP.md A10-A12)")
    if cfg.packed_weights:
        raise NotImplementedError(
            f"{cfg.name}: packed-weight MLPs are queued in ROADMAP.md A8")
    if cfg.kv_cache_dtype not in ("auto", None):
        raise NotImplementedError("int8 KV caches are queued in ROADMAP A6")
    if cfg.attn_window is not None and cfg.full_attn_every:
        raise NotImplementedError(
            "per-layer sliding-window schedules are queued in ROADMAP A12")


def init_model(cfg, seed: int = 0, device=None) -> Params:
    """Random weights from ``torch.Generator(seed)``, drawn on ``device``
    (the card by default), with the JAX package's init scales: dense
    N(0, 2/(d_in+d_out)), embeddings N(0, 1/d), norms 1.  Norm scales
    are float32, the rest ``cfg.param_dtype``.  A binary MLP
    (``cfg.binary_mlp``) draws +-1 weights bit-packed along the
    reduction axis into int32 words, scale 1/sqrt(d_in), bias 0, as the
    JAX package's ``init_binary_dense`` does."""
    _check_supported(cfg)
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    n, d, dh = cfg.n_layers, cfg.d_model, cfg.d_head

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dt)

    def dense(d_in, d_out):
        return normal((n, d_in, d_out), (2.0 / (d_in + d_out)) ** 0.5)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def binary(d_in, d_out):
        if d_in % 32:
            raise ValueError(f"binary d_in {d_in} must be a multiple of 32")
        words = [ref.pack_binary(torch.randn((d_in, d_out), generator=gen,
                                             device=dev) >= 0, axis=0)
                 for _ in range(n)]
        return {"w_packed": torch.stack(words),
                "scale": torch.full((n, d_out), d_in ** -0.5,
                                    dtype=torch.float32, device=dev),
                "bias": torch.zeros((n, d_out), dtype=torch.float32,
                                    device=dev)}

    attn = {"wq": dense(d, cfg.q_dim), "wk": dense(d, cfg.kv_dim),
            "wv": dense(d, cfg.kv_dim), "wo": dense(cfg.q_dim, d)}
    if cfg.qk_norm:
        attn["q_norm"], attn["k_norm"] = ones(n, dh), ones(n, dh)
    params: Params = {
        "embed": {"table": normal((cfg.padded_vocab, d), d ** -0.5)},
        "layers": {
            "ln1": ones(n, d), "attn": attn, "ln2": ones(n, d),
            "mlp": ({"up": binary(d, cfg.d_ff), "down": binary(cfg.d_ff, d)}
                    if cfg.binary_mlp else
                    {"w1": dense(d, cfg.d_ff), "w3": dense(d, cfg.d_ff),
                     "w2": dense(cfg.d_ff, d)}),
        },
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": normal((cfg.padded_vocab, d),
                                             d ** -0.5)}
    return params


def _layer_params(params: Params) -> List[Params]:
    """Per-layer views of the stacked leaves."""
    stacked = params["layers"]
    n = stacked["ln1"].shape[0]

    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}

    return [pick(stacked, i) for i in range(n)]


def _window(cfg) -> Optional[int]:
    return None if cfg.attn_window is None else int(cfg.attn_window)


def _head(params: Params) -> torch.Tensor:
    return params.get("lm_head", params["embed"])["table"]


def _mlp_residual(lp: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    h2 = layers.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + layers.mlp_apply(lp["mlp"], h2, cfg)


def _mask_vocab(logits: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = float("-inf")
    return logits


def init_cache(cfg, batch: int, max_len: int, dtype="bfloat16",
               device=None) -> Params:
    """Contiguous KV buffers ``(L, B, Hkv, max_len, D)`` plus ``index``."""
    _check_supported(cfg)
    dev = device_lib.resolve(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.d_head)
    dt = getattr(torch, dtype)
    return {"index": 0,
            "k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def prefill(params: Params, tokens: torch.Tensor, cfg,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """Run the prompt (B, S) through the model, filling a fresh
    ``max_len`` cache.  Attention runs over the local K/V
    (``attend_local``).  Returns (last-token logits (B, V), cache)."""
    b, s = tokens.shape
    dev = tokens.device
    cache = init_cache(cfg, b, max_len or s, cfg.act_dtype, dev)
    x = layers.embed(params["embed"]["table"], tokens).to(
        getattr(torch, cfg.act_dtype))
    positions = torch.arange(s, device=dev)[None, :]
    for i, lp in enumerate(_layer_params(params)):
        h = layers.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        attn_out, _ = layers.attention_apply(
            lp["attn"], h, cfg, positions=positions, window=_window(cfg),
            kv_cache=(cache["k"][i], cache["v"][i]), cache_index=0,
            attend_local=True)
        x = _mlp_residual(lp, x + attn_out, cfg)
    cache["index"] = s
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.unembed(_head(params), x[:, -1]), cache


def prefill_chunk(params: Params, cache: Params, tokens: torch.Tensor, cfg,
                  start: Union[int, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Params]:
    """Prefill the chunk ``tokens`` (B, S) into ``cache`` at ``start``
    (one offset, or one per row), attending over the filled cache, so
    the chunk sees everything before it.  The cache is updated in place.
    Returns (last-token logits (B, V), cache)."""
    b, s = tokens.shape
    dev = tokens.device
    x = layers.embed(params["embed"]["table"], tokens).to(
        getattr(torch, cfg.act_dtype))
    steps = torch.arange(s, device=dev)
    if torch.is_tensor(start) and start.ndim == 1:
        positions = start.to(dev).long()[:, None] + steps[None, :]
    else:
        positions = (int(start) + steps)[None, :]
    for i, lp in enumerate(_layer_params(params)):
        h = layers.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        attn_out, _ = layers.attention_apply(
            lp["attn"], h, cfg, positions=positions, window=_window(cfg),
            kv_cache=(cache["k"][i], cache["v"][i]), cache_index=start)
        x = _mlp_residual(lp, x + attn_out, cfg)
    cache["index"] = start + s
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.unembed(_head(params), x[:, -1]), cache


def supports_paged_decode(cfg) -> bool:
    """Can ``paged_decode_step`` drive this config's decode?  (The
    pure-attention decoder with no or a uniform static window.)"""
    return bool(
        cfg.has_attention
        and not cfg.has_ssm
        and not cfg.is_encoder_decoder
        and cfg.kv_cache_dtype in ("auto", None)
        and (cfg.attn_window is None or cfg.full_attn_every == 0))


def paged_decode_step(
    params: Params,
    k_pages: torch.Tensor,        # (L, Hkv, n_pages, page, Dh) page pools
    v_pages: torch.Tensor,
    tokens: torch.Tensor,         # (B, 1)
    block_tables: torch.Tensor,   # (B, max_pages) int32
    kv_lens: torch.Tensor,        # (B,) int32 filled length per row
    write_pids: torch.Tensor,     # (B,) destination page per row
    write_offs: torch.Tensor,     # (B,) offset within that page
    cfg,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decode step straight off the paged KV pool.

    Each layer writes its fresh K/V into the pools in place at
    ``(write_pids, write_offs)`` — past every row's committed length, or
    the scratch page for idle rows — and attends through
    ``ops.paged_attention``.  The caller commits by advancing
    ``kv_lens`` only once the logits are good, so a failed step leaves
    nothing a later step reads.  Returns (logits (B, V), (k_pages,
    v_pages)), padded-vocab logits at -inf.
    """
    x = layers.embed(params["embed"]["table"], tokens).to(
        getattr(torch, cfg.act_dtype))
    positions = kv_lens.long()[:, None]
    for i, lp in enumerate(_layer_params(params)):
        h = layers.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        attn_out, _ = layers.paged_attention_apply(
            lp["attn"], h, cfg, positions=positions, window=_window(cfg),
            k_pages=k_pages[i], v_pages=v_pages[i],
            block_tables=block_tables, kv_lens=kv_lens,
            write_pids=write_pids, write_offs=write_offs)
        x = _mlp_residual(lp, x + attn_out, cfg)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = layers.unembed(_head(params), x[:, -1])
    return _mask_vocab(logits, cfg), (k_pages, v_pages)
