"""The decoder LM of the port: init, prefill, decode.

Twin of ``repro/models/lm.py`` for the ``dense`` family (and ``vlm``,
which the JAX package serves as a dense backbone), with the
SwiGLU MLP, the binary MLP (``cfg.binary_mlp``) or the SwiGLU MLP with
sub-byte packed weights (``cfg.packed_weights``); for the ``moe``
family, whose layers run the routed-expert block (``models/moe.py``,
its load-balancing loss dropped, as the reference's serving steps drop
it) where the dense ones run the MLP; for the ``ssm`` family, whose
layers are a Mamba2 block alone (``models/ssm.py``: no attention, no
MLP); and for the ``hybrid`` family (hymba), whose layers run attention
and the Mamba2 block side by side on the same normed input and add
their mean (``_mix_residual``), then the MLP.  Each layer attends
with its own sliding window (``cfg.layer_window``: hymba keeps its
first, middle and last layers full), a static int the kernels band
with.  Parameters
keep the JAX package's layout — per-layer leaves stacked on a leading
``L`` axis (``models/bridge.py`` moves a JAX tree over unchanged) — and
a Python loop over layers replaces ``lax.scan``.  Decode runs off the
paged KV pool (``paged_decode_step``) or off the contiguous slot cache
(``decode_step``, a scalar or per-row ``index``); an int8 KV cache
(``cfg.kv_cache_dtype == "int8"``: int8 codes with per-position f32
scales) decodes off the slot cache only, as in the JAX package, and so
does a config with SSM state (``ssm``/``conv`` in the slot cache).  The
encoder-decoder family is not ported yet (ROADMAP A10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch import device as device_lib
from repro_torch.core.dataflow import (AttentionProblem, BinaryProblem,
                                       GemmProblem)
from repro_torch.kernels import pack, ref
from repro_torch.models import layers, moe, ssm

Params = Dict[str, Any]


# Families served as the dense decoder: ``vlm`` (chameleon) is early
# fusion, its image tokens ordinary vocab ids, as the JAX package serves it.
DENSE_FAMILIES = ("dense", "vlm")
# Families served as the decoder with routed experts in place of the MLP.
MOE_FAMILIES = ("moe",)
# Family -> (attention, SSM) paths its layers run.
_PATHS = {**{f: (True, False) for f in DENSE_FAMILIES + MOE_FAMILIES},
          "ssm": (False, True), "hybrid": (True, True)}


def _check_supported(cfg) -> None:
    paths = _PATHS.get(cfg.family)
    if (paths != (cfg.has_attention, cfg.has_ssm)
            or bool(cfg.n_experts) != (cfg.family in MOE_FAMILIES)
            or cfg.is_encoder_decoder):
        raise NotImplementedError(
            f"{cfg.name} (family {cfg.family!r}): the port runs dense, "
            f"MoE, SSM and hybrid decoders; encoder-decoder models are "
            f"queued in ROADMAP.md A10")


def init_model(cfg, seed: int = 0, device=None) -> Params:
    """Random weights from ``torch.Generator(seed)``, drawn on ``device``
    (the card by default), with the JAX package's init scales: dense
    N(0, 2/(d_in+d_out)), embeddings N(0, 1/d), norms 1.  Norm scales
    are float32, the rest ``cfg.param_dtype``.  A binary MLP
    (``cfg.binary_mlp``) draws +-1 weights bit-packed along the
    reduction axis into int32 words, scale 1/sqrt(d_in), bias 0, as the
    JAX package's ``init_binary_dense`` does.  A packed MLP
    (``cfg.packed_weights``) draws each layer's MSR-coded int8 codes and
    packs them at ``cfg.packed_weight_bits`` (``layers.init_packed_mlp``);
    its leaves are stacked on the layer axis like the rest.  A MoE config
    (``cfg.n_experts``) draws ``layers["moe"]`` (``moe.init_moe``, a
    layer at a time) in place of the MLP.  An SSM config draws
    ``layers["mamba"]`` (``ssm.init_mamba``); its layers have ``ln1`` and
    the block alone.  A hybrid config draws attention, the block and the
    MLP."""
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

    def mlp():
        if cfg.binary_mlp:
            return {"up": binary(d, cfg.d_ff), "down": binary(cfg.d_ff, d)}
        if cfg.packed_weights:
            per_layer = [layers.init_packed_mlp(gen, d, cfg.d_ff,
                                                cfg.packed_weight_bits, dev)
                         for _ in range(n)]
            return {name: pack.stack([lp[name] for lp in per_layer])
                    for name in ("w1", "w3", "w2")}
        return {"w1": dense(d, cfg.d_ff), "w3": dense(d, cfg.d_ff),
                "w2": dense(cfg.d_ff, d)}

    def ffn():
        if cfg.n_experts:
            return {"ln2": ones(n, d), "moe": moe.init_moe(gen, cfg, n, dev)}
        if cfg.d_ff and cfg.family != "ssm":
            return {"ln2": ones(n, d), "mlp": mlp()}
        return {}

    mix = {}
    if cfg.has_attention:
        mix["attn"] = {"wq": dense(d, cfg.q_dim), "wk": dense(d, cfg.kv_dim),
                       "wv": dense(d, cfg.kv_dim), "wo": dense(cfg.q_dim, d)}
        if cfg.qk_norm:
            mix["attn"]["q_norm"] = ones(n, dh)
            mix["attn"]["k_norm"] = ones(n, dh)
    embed = {"table": normal((cfg.padded_vocab, d), d ** -0.5)}
    if cfg.has_ssm:
        mix["mamba"] = ssm.init_mamba(gen, cfg, n, dev)
    params: Params = {
        "embed": embed,
        "layers": {"ln1": ones(n, d), **mix, **ffn()},
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": normal((cfg.padded_vocab, d),
                                             d ** -0.5)}
    return params


def hot_gemm_problems(cfg, batch: int, seq: int) -> List[GemmProblem]:
    """The GEMMs that reach the autotuned fused kernel, as ``GemmProblem``
    rows for ``core.autotune.warm``: the MLP's projections
    (``layers.fused_dense`` -> ``ops.matmul_fused``), or for a packed MLP
    the int8-activation, ``weight_bits``-tagged problems of
    ``ops.matmul_packed``.  A binary MLP reaches B9 instead
    (``hot_binary_problems``).  A MoE config lists its shared experts'
    projections (width ``d_ff * n_shared_experts``), and nothing without
    them: its routed experts run as ``torch.bmm``, reaching no kernel.
    An SSM config lists nothing: its projections are ``torch.matmul``, as
    the reference's are ``jnp.einsum``."""
    if not cfg.d_ff or cfg.family == "ssm" or getattr(cfg, "binary_mlp",
                                                        False):
        return []
    t = batch * seq
    ff = cfg.d_ff * cfg.n_shared_experts if cfg.n_experts else cfg.d_ff
    if not ff:
        return []
    shapes = sorted({(t, cfg.d_model, ff), (t, ff, cfg.d_model)})
    if getattr(cfg, "packed_weights", False):
        return [GemmProblem(m, k, n, in_dtype="int8", out_dtype="float32",
                            acc_dtype="int32",
                            weight_bits=cfg.packed_weight_bits)
                for m, k, n in shapes]
    return [GemmProblem(m, k, n, in_dtype=cfg.param_dtype)
            for m, k, n in shapes]


def hot_binary_problems(cfg, batch: int, seq: int) -> List[BinaryProblem]:
    """A binary MLP's two projections (``layers.binary_mlp_apply``) as
    ``BinaryProblem`` rows: packed depth d/32 words, true depth d bits,
    the hidden one re-binarized (int8), the output float32."""
    if not getattr(cfg, "binary_mlp", False) or not cfg.d_ff:
        return []
    t = batch * seq
    return [BinaryProblem(m=t, kp=cfg.d_model // 32, n=cfg.d_ff,
                          n_bits=cfg.d_model, out_dtype="int8"),
            BinaryProblem(m=t, kp=cfg.d_ff // 32, n=cfg.d_model,
                          n_bits=cfg.d_ff, out_dtype="float32")]


def hot_attention_problems(cfg, batch: int, seq: int,
                           max_len: Optional[int] = None, rows: int = 1
                           ) -> List[AttentionProblem]:
    """The attention of the decoder layers that reaches ``ops.attention``:
    the prefill square (``sq = skv = seq``) and the slot-cache decode step
    (``sq = 1`` over the ``max_len`` buffer, its run-time valid length
    keyed as the whole buffer; ``rows = batch`` where each row has a cache
    index of its own, as the scheduler's slot cache has), full and, for a
    config with ``attn_window``, windowed (the reference's order: the
    pair without a window, then the pair with it); an int8 KV cache keys
    the decode with ``kv_dtype="int8"``.  Callers pick prefill and decode
    rows by ``sq``.  (Decode off the page pool runs B3, which is not
    autotuned.)"""
    if not cfg.has_attention:
        return []
    kv_dt = "int8" if int8_kv(cfg) else None
    group = max(1, cfg.n_heads // cfg.n_kv_heads)
    bh = batch * cfg.n_heads
    windows = [None] + ([int(cfg.attn_window)]
                        if cfg.attn_window is not None else [])
    out = []
    for win in windows:
        out += [AttentionProblem(bh=bh, sq=seq, skv=seq, d=cfg.d_head,
                                 group=group, causal=True, window=win,
                                 dtype=cfg.act_dtype),
                AttentionProblem(bh=bh, sq=1, skv=max_len or seq,
                                 d=cfg.d_head, group=group, causal=True,
                                 window=win, dtype=cfg.act_dtype,
                                 kv_dtype=kv_dt, rows=rows)]
    return out


def hot_chunk_problems(cfg, seq: int, max_len: int) -> list:
    """What a ``prefill_chunk`` of ``seq`` tokens of one row into a
    ``max_len`` cache hands the autotuner: the MLP GEMMs (or binary
    GEMMs) of ``seq`` rows and the attention of the chunk over the cache
    buffer (its valid prefix keyed as the whole buffer)."""
    out = hot_gemm_problems(cfg, 1, seq) + hot_binary_problems(cfg, 1, seq)
    out += [dataclasses.replace(p, sq=seq)
            for p in hot_attention_problems(cfg, 1, 1, max_len)
            if p.skv == max_len]
    return out


def _layer_params(params: Params) -> List[Params]:
    """Per-layer views of the stacked leaves (a stacked ``PackedWeights``
    gives its layer's view)."""
    stacked = params["layers"]
    n = stacked["ln1"].shape[0]

    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict)
                else v.layer(i) if isinstance(v, pack.PackedWeights)
                else v[i]
                for k, v in tree.items()}

    return [pick(stacked, i) for i in range(n)]


def _head(params: Params) -> torch.Tensor:
    return params.get("lm_head", params["embed"])["table"]


def _ffn_residual(lp: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """``x`` plus the layer's MLP, or its MoE block (the load-balancing
    loss dropped, as the reference's serving steps drop it), over the
    normed ``x``; ``x`` as it is for a layer with neither (an SSM's)."""
    if "ln2" not in lp:
        return x
    h2 = layers.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if cfg.n_experts:
        y, _ = moe.moe_apply(lp["moe"], h2, cfg)
        return x + y
    return x + layers.mlp_apply(lp["mlp"], h2, cfg)


def _mask_vocab(logits: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = float("-inf")
    return logits


# The cache's per-layer buffers, in the order ``attention_apply`` takes
# them (the scales only in an int8 cache).
KV_KEYS = ("k", "v", "k_scale", "v_scale")
# The SSM's per-layer state and conv tail (configs with SSM state).
SSM_KEYS = ("ssm", "conv")
CACHE_KEYS = KV_KEYS + SSM_KEYS


def init_cache(cfg, batch: int, max_len: int, dtype="bfloat16",
               device=None) -> Params:
    """``index`` plus, with attention, contiguous KV buffers ``(L, B,
    Hkv, max_len, D)`` of ``dtype`` unless ``cfg.kv_cache_dtype`` names
    another (an int8 cache adds ``k_scale``/``v_scale`` ``(L, B, Hkv,
    max_len, 1)`` f32, ones until written), and with an SSM, zero
    float32 ``ssm`` ``(L, B, H, N, P)`` and ``conv`` ``(L, B, K-1,
    d_inner + 2N)``."""
    _check_supported(cfg)
    dev = device_lib.resolve(device)
    cache: Params = {"index": 0}
    if cfg.has_attention:
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.d_head)
        kv = cfg.kv_cache_dtype
        dt = getattr(torch, dtype if kv in ("auto", None) else kv)
        cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dt, device=dev)
        if dt == torch.int8:
            for name in KV_KEYS[2:]:
                cache[name] = torch.ones(shape[:-1] + (1,),
                                         dtype=torch.float32, device=dev)
    if cfg.has_ssm:
        for name, buf in zip(SSM_KEYS, ssm.init_ssm_state(cfg, batch, dev)):
            cache[name] = buf.expand((cfg.n_layers,) + buf.shape).clone()
    return cache


def _layer_cache(cache: Params, i: int) -> Tuple[torch.Tensor, ...]:
    """Layer ``i``'s views of the cache's buffers: (k, v), or (k, v,
    k_scale, v_scale) for an int8 cache."""
    return tuple(cache[name][i] for name in KV_KEYS if name in cache)


def _mix_residual(lp: Params, x: torch.Tensor, cfg, i: int, cache: Params,
                  new: Params, positions: torch.Tensor, cache_index,
                  attend_local: bool = False) -> torch.Tensor:
    """Layer ``i`` over ``cache``: ``x`` plus the mean of its attention
    (window ``cfg.layer_window(i)``; K/V written into the cache in place)
    and its Mamba2 block (from the layer's state in ``cache``, the new
    state written into ``new``'s buffers), both over the normed ``x``, as
    the reference's ``layer_apply`` mixes them; then the FFN residual."""
    h = layers.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    paths = []
    if cfg.has_attention:
        out, _ = layers.attention_apply(
            lp["attn"], h, cfg, positions=positions,
            window=cfg.layer_window(i), kv_cache=_layer_cache(cache, i),
            cache_index=cache_index, attend_local=attend_local)
        paths.append(out)
    if cfg.has_ssm:
        out, (s, conv) = ssm.mamba_apply(
            lp["mamba"], h, cfg, (cache["ssm"][i], cache["conv"][i]))
        new["ssm"][i], new["conv"][i] = s, conv
        paths.append(out)
    mix = paths[0] if len(paths) == 1 else (paths[0] + paths[1]) / 2
    return _ffn_residual(lp, x + mix, cfg)


def _with_new_state(cache: Params) -> Params:
    """A new dict over ``cache``'s buffers, with fresh ``ssm``/``conv``
    buffers for the step to write (the caller's state stays as it was)."""
    new = dict(cache)
    for name in SSM_KEYS:
        if name in cache:
            new[name] = torch.empty_like(cache[name])
    return new


def prefill(params: Params, tokens: torch.Tensor, cfg,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """Run the prompt (B, S) through the model, filling a fresh
    ``max_len`` cache.  Attention runs over the local K/V
    (``attend_local``); the SSM runs its chunked form from the zero
    state.  Returns (last-token logits (B, V), cache)."""
    b, s = tokens.shape
    dev = tokens.device
    cache = init_cache(cfg, b, max_len or s, cfg.act_dtype, dev)
    x = layers.embed(params["embed"]["table"], tokens).to(
        getattr(torch, cfg.act_dtype))
    positions = torch.arange(s, device=dev)[None, :]
    for i, lp in enumerate(_layer_params(params)):
        x = _mix_residual(lp, x, cfg, i, cache, cache, positions, 0,
                          attend_local=True)
    cache["index"] = s
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.unembed(_head(params), x[:, -1]), cache


def prefill_chunk(params: Params, cache: Params, tokens: torch.Tensor, cfg,
                  start: Union[int, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Params]:
    """Prefill the chunk ``tokens`` (B, S) into ``cache`` at ``start``
    (one offset, or one per row), attending over the filled cache, so
    the chunk sees everything before it, and running the SSM on from the
    cache's state.  K/V are written into the cache's buffers in place;
    the returned cache is a new dict, with new ``ssm``/``conv`` tensors,
    so the caller's state is as it was if the step is retried.  Returns
    (last-token logits (B, V), cache)."""
    b, s = tokens.shape
    dev = tokens.device
    x = layers.embed(params["embed"]["table"], tokens).to(
        getattr(torch, cfg.act_dtype))
    steps = torch.arange(s, device=dev)
    if torch.is_tensor(start) and start.ndim == 1:
        positions = start.to(dev).long()[:, None] + steps[None, :]
    else:
        positions = (int(start) + steps)[None, :]
    new = _with_new_state(cache)
    for i, lp in enumerate(_layer_params(params)):
        x = _mix_residual(lp, x, cfg, i, cache, new, positions, start)
    new["index"] = start + s
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.unembed(_head(params), x[:, -1]), new


def decode_step(params: Params, cache: Params, tokens: torch.Tensor, cfg
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step (tokens (B, 1)) on the contiguous slot cache.

    ``cache["index"]`` is one position for the whole batch (an int) or
    one per row (a ``(B,)`` tensor): positions, the cache writes and the
    attention bands (``kv_len = index + 1``, B2 at Sq = 1) follow it.
    Each layer writes its fresh K/V into the buffers in place at
    ``index``; the returned cache is a new dict whose ``index`` has
    advanced and whose SSM state (``ssm``/``conv``) is in new tensors, so
    a caller that keeps the old dict after a failed step retries at the
    same positions from the same state.  Returns (logits (B, V), cache),
    padded-vocab logits at -inf.
    """
    b = tokens.shape[0]
    dev = tokens.device
    x = layers.embed(params["embed"]["table"], tokens).to(
        getattr(torch, cfg.act_dtype))
    idx = cache["index"]
    if torch.is_tensor(idx) and idx.ndim == 1:
        positions = idx.to(dev).long()[:, None]
    else:
        positions = torch.full((b, 1), int(idx), device=dev)
    new = _with_new_state(cache)
    for i, lp in enumerate(_layer_params(params)):
        x = _mix_residual(lp, x, cfg, i, cache, new, positions, idx)
    new["index"] = idx + 1
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = layers.unembed(_head(params), x[:, -1])
    return _mask_vocab(logits, cfg), new


def int8_kv(cfg) -> bool:
    """Does this config keep an int8 KV cache (codes and per-position
    scales)?"""
    return cfg.kv_cache_dtype == "int8"


def supports_paged_decode(cfg) -> bool:
    """Can ``paged_decode_step`` drive this config's decode?  (The
    pure-attention decoder with no or a uniform static window, over a
    float cache: the page pools hold no int8 scales.)"""
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
            lp["attn"], h, cfg, positions=positions,
            window=cfg.layer_window(i), k_pages=k_pages[i], v_pages=v_pages[i],
            block_tables=block_tables, kv_lens=kv_lens,
            write_pids=write_pids, write_offs=write_offs)
        x = _ffn_residual(lp, x + attn_out, cfg)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = layers.unembed(_head(params), x[:, -1])
    return _mask_vocab(logits, cfg), (k_pages, v_pages)
