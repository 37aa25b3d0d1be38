"""The LM of the port: init, the teacher-forced forward, prefill, decode.

Twin of ``repro/models/lm.py`` for the ``dense`` family (and ``vlm``,
which the JAX package serves as a dense backbone), with the
SwiGLU MLP, the binary MLP (``cfg.binary_mlp``) or the SwiGLU MLP with
sub-byte packed weights (``cfg.packed_weights``); for the ``moe``
family, whose layers run the routed-expert block (``models/moe.py``) where
the dense ones run the MLP; for the ``ssm`` family, whose
layers are a Mamba2 block alone (``models/ssm.py``: no attention, no
MLP); for the ``hybrid`` family (hymba), whose layers run attention
and the Mamba2 block side by side on the same normed input and add
their mean, then the MLP; and for the ``audio`` family (whisper), an
encoder-decoder: ``encode`` runs a bidirectional encoder over
precomputed frame embeddings (the conv frontend is stubbed, as in the
reference), and each decoder layer adds a cross-attention residual to the
encoder's output between its self-attention and its MLP, with the
encoder's per-layer K/V projections kept in the cache (``cross_k`` /
``cross_v``) for decode.  Each layer attends
with its own sliding window (``cfg.layer_window``: hymba keeps its
first, middle and last layers full), a static int the kernels band
with.  ``forward`` is the teacher-forced pass over a whole sequence
(logits at every position, the MoE load-balancing loss summed over the
layers); the serving steps drop that loss, as the reference's do.
``loss_fn`` is the training loss over it (``chunked_cross_entropy``
plus the weighted load-balancing loss), each layer rematerialized under
autograd as ``remat`` says.
Parameters
keep the JAX package's layout — per-layer leaves stacked on a leading
``L`` axis (``models/bridge.py`` moves a JAX tree over unchanged) — and
a Python loop over layers replaces ``lax.scan``.  Decode runs off the
paged KV pool (``paged_decode_step``) or off the contiguous slot cache
(``decode_step``, a scalar or per-row ``index``); an int8 KV cache
(``cfg.kv_cache_dtype == "int8"``: int8 codes with per-position f32
scales) decodes off the slot cache only, as in the JAX package, and so
does a config with SSM state (``ssm``/``conv`` in the slot cache) or a
cross cache.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import device as device_lib
from repro_torch.core.dataflow import (AttentionProblem, BinaryProblem,
                                       ConvProblem, GemmProblem)
from repro_torch.kernels import autograd, pack, ref
from repro_torch.models import layers, moe, ssm

Params = Dict[str, Any]


# Families served as the dense decoder: ``vlm`` (chameleon) is early
# fusion, its image tokens ordinary vocab ids, as the JAX package serves it.
DENSE_FAMILIES = ("dense", "vlm")
# Families served as the decoder with routed experts in place of the MLP.
MOE_FAMILIES = ("moe",)
# Family -> (attention, SSM) paths its layers run.
_PATHS = {**{f: (True, False) for f in DENSE_FAMILIES + MOE_FAMILIES},
          "ssm": (False, True), "hybrid": (True, True),
          "audio": (True, False)}


def _check_supported(cfg) -> None:
    paths = _PATHS.get(cfg.family)
    if (paths != (cfg.has_attention, cfg.has_ssm)
            or bool(cfg.n_experts) != (cfg.family in MOE_FAMILIES)
            or cfg.is_encoder_decoder != (cfg.family == "audio")):
        raise NotImplementedError(
            f"{cfg.name} (family {cfg.family!r}): the port runs dense, "
            f"MoE, SSM and hybrid decoders and the audio encoder-decoder, "
            f"each with its family's paths; this config's fields fit none")


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
    MLP.  An encoder-decoder config draws, after all that, each decoder
    layer's ``ln_cross`` and ``cross`` attention and the ``encoder``: its
    ``n_enc_layers`` layers (``ln1``, ``attn``, ``ln2`` and a SwiGLU
    ``mlp``) and its ``final_norm``."""
    _check_supported(cfg)
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    n, d, dh = cfg.n_layers, cfg.d_model, cfg.d_head

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dt)

    def dense(d_in, d_out, count=n):
        return normal((count, d_in, d_out), (2.0 / (d_in + d_out)) ** 0.5)

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

    def attention(count=n):
        p = {"wq": dense(d, cfg.q_dim, count),
             "wk": dense(d, cfg.kv_dim, count),
             "wv": dense(d, cfg.kv_dim, count),
             "wo": dense(cfg.q_dim, d, count)}
        if cfg.qk_norm:
            p["q_norm"] = ones(count, dh)
            p["k_norm"] = ones(count, dh)
        return p

    mix = {}
    if cfg.has_attention:
        mix["attn"] = attention()
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
    if cfg.is_encoder_decoder:
        params["layers"]["ln_cross"] = ones(n, d)
        params["layers"]["cross"] = attention()
        ne = cfg.n_enc_layers
        params["encoder"] = {
            "layers": {"ln1": ones(ne, d), "attn": attention(ne),
                       "ln2": ones(ne, d),
                       "mlp": {"w1": dense(d, cfg.d_ff, ne),
                               "w3": dense(d, cfg.d_ff, ne),
                               "w2": dense(cfg.d_ff, d, ne)}},
            "final_norm": ones(d)}
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


# whisper-style audio frontends: n_mels mel bins, two k=3 1-D convs
# (stride 1 then stride 2) over 2x the encoder frame count
AUDIO_N_MELS = 80
AUDIO_CONV_KERNEL = 3


def hot_conv_problems(cfg, batch: int, seq: int) -> List[ConvProblem]:
    """The convs of ``cfg``'s modality frontend, as ``ConvProblem`` rows,
    the reference's: an audio config fronts its encoder with two 1-D
    convs over the mel spectrogram, k=3 stride 1 (n_mels -> d_model) then
    k=3 stride 2 (d_model -> d_model, halving the frames to the encoder's
    length), as height-1 2-D problems.  The frontend itself is stubbed
    (the encoder takes frame embeddings), so these key the autotuner
    ahead of it and reach no kernel on the serving path.  Other families
    have no frontend: an empty list."""
    if cfg.family != "audio":
        return []
    enc_seq = max(1, int(seq * cfg.enc_seq_ratio))
    frames, k = 2 * enc_seq, AUDIO_CONV_KERNEL
    return [ConvProblem(ih=1, iw=frames + k - 1, fh=1, fw=k, s=1,
                        cin=AUDIO_N_MELS, cout=cfg.d_model, n=batch,
                        in_dtype=cfg.param_dtype, out_dtype="float32"),
            ConvProblem(ih=1, iw=2 * enc_seq + k - 1, fh=1, fw=k, s=2,
                        cin=cfg.d_model, cout=cfg.d_model, n=batch,
                        in_dtype=cfg.param_dtype, out_dtype="float32")]


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


def _stack_views(stacked: Params) -> List[Params]:
    """Per-layer views of leaves stacked on a leading layer axis (a
    stacked ``PackedWeights`` gives its layer's view).  Each leaf is
    unbound once, so under autograd a leaf's layers send their gradients
    to one node that stacks them (indexing each layer would add a
    leaf-sized gradient per layer)."""
    n = stacked["ln1"].shape[0]

    def unbound(tree):
        return {k: unbound(v) if isinstance(v, dict)
                else [v.layer(i) for i in range(n)]
                if isinstance(v, pack.PackedWeights) else v.unbind(0)
                for k, v in tree.items()}

    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}

    views = unbound(stacked)
    return [pick(views, i) for i in range(n)]


def _layer_params(params: Params) -> List[Params]:
    """Per-layer views of the decoder's stacked leaves."""
    return _stack_views(params["layers"])


def _head(params: Params) -> torch.Tensor:
    return params.get("lm_head", params["embed"])["table"]


def _ffn_residual(lp: Params, x: torch.Tensor, cfg
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``x`` plus the layer's MLP, or its MoE block, over the normed
    ``x``; the MoE block's load-balancing loss, else 0).  ``x`` as it is
    for a layer with neither (an SSM's)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ln2" not in lp:
        return x, aux
    h2 = layers.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if cfg.n_experts:
        y, aux = moe.moe_apply(lp["moe"], h2, cfg)
        return x + y, aux
    return x + layers.mlp_apply(lp["mlp"], h2, cfg), aux


def _mask_vocab(logits: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = float("-inf")
    return logits


# The cache's per-layer buffers, in the order ``attention_apply`` takes
# them (the scales only in an int8 cache).
KV_KEYS = ("k", "v", "k_scale", "v_scale")
# The SSM's per-layer state and conv tail (configs with SSM state).
SSM_KEYS = ("ssm", "conv")
# The encoder's per-layer K/V projections (encoder-decoder configs).
CROSS_KEYS = ("cross_k", "cross_v")
CACHE_KEYS = KV_KEYS + SSM_KEYS + CROSS_KEYS


def init_cache(cfg, batch: int, max_len: int, dtype="bfloat16",
               device=None, enc_len: Optional[int] = None) -> Params:
    """``index`` plus, with attention, contiguous KV buffers ``(L, B,
    Hkv, max_len, D)`` of ``dtype`` unless ``cfg.kv_cache_dtype`` names
    another (an int8 cache adds ``k_scale``/``v_scale`` ``(L, B, Hkv,
    max_len, 1)`` f32, ones until written), with an SSM, zero
    float32 ``ssm`` ``(L, B, H, N, P)`` and ``conv`` ``(L, B, K-1,
    d_inner + 2N)``, and for an encoder-decoder zero ``cross_k`` /
    ``cross_v`` ``(L, B, Hkv, enc_len or max_len, D)`` of ``dtype``, a
    float dtype even over an int8 KV cache, as the reference keeps them."""
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
    if cfg.is_encoder_decoder:
        shape = (cfg.n_layers, batch, cfg.n_kv_heads,
                 max_len if enc_len is None else enc_len, cfg.d_head)
        for name in CROSS_KEYS:
            cache[name] = torch.zeros(shape, dtype=getattr(torch, dtype),
                                      device=dev)
    return cache


def _layer_cache(cache: Params, i: int) -> Tuple[torch.Tensor, ...]:
    """Layer ``i``'s views of the cache's buffers: (k, v), or (k, v,
    k_scale, v_scale) for an int8 cache."""
    return tuple(cache[name][i] for name in KV_KEYS if name in cache)


def _cross_kv(p: Params, enc_out: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output's K/V projections for cross attention, each
    (B, Hkv, S_enc, D), before any qk-norm (what the cache keeps)."""
    b, se, _ = enc_out.shape
    shape = (b, se, cfg.n_kv_heads, cfg.d_head)
    return ((enc_out @ p["wk"]).reshape(shape).transpose(1, 2),
            (enc_out @ p["wv"]).reshape(shape).transpose(1, 2))


def _cross_attention(p: Params, x: torch.Tensor, enc_out: torch.Tensor,
                     cfg, kv: Optional[Tuple[torch.Tensor, ...]] = None
                     ) -> torch.Tensor:
    """Cross attention of the decoder's normed ``x`` (B, S, D) to the
    encoder's output (B, S_enc, D): q from ``x``, K/V from ``enc_out``
    (or ``kv``, ``_cross_kv`` of it), qk-norm where the config has it,
    every encoder position visible (``layers.bidir_attention``)."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.d_head
    q = (x @ p["wq"]).reshape(b, s, h, dh)
    k, v = kv if kv is not None else _cross_kv(p, enc_out, cfg)
    if cfg.qk_norm:
        q = layers.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = layers.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    out = layers.bidir_attention(q.transpose(1, 2), k, v, scale=dh ** -0.5)
    return out.transpose(1, 2).reshape(b, s, h * dh) @ p["wo"]


def _cross_residual(lp: Params, x: torch.Tensor, cfg, i: int,
                    cache: Optional[Params],
                    enc_out: Optional[torch.Tensor]) -> torch.Tensor:
    """``x`` plus layer ``i``'s cross attention over the normed ``x``, as
    the reference's ``layer_apply`` branches: to ``enc_out`` where it is
    given (a forward, or a prefill, which also writes the layer's
    projections into ``cache``'s cross buffers in place), else to the
    projections ``cache`` holds (decode, a prefill chunk); ``x`` as it
    is for a decoder-only config."""
    if not cfg.is_encoder_decoder:
        return x
    hc = layers.rmsnorm(lp["ln_cross"], x, cfg.norm_eps)
    p = lp["cross"]
    if enc_out is not None:
        ck, cv = _cross_kv(p, enc_out, cfg)
        if cache is not None:
            cache["cross_k"][i] = ck.to(cache["cross_k"].dtype)
            cache["cross_v"][i] = cv.to(cache["cross_v"].dtype)
        return x + _cross_attention(p, hc, enc_out, cfg, kv=(ck, cv))
    if cache is None or "cross_k" not in cache:
        return x
    b, s, _ = hc.shape
    q = (hc @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.d_head).transpose(1, 2)
    out = layers.bidir_attention(q, cache["cross_k"][i], cache["cross_v"][i],
                                 scale=cfg.d_head ** -0.5)
    return x + out.transpose(1, 2).reshape(b, s, -1) @ p["wo"]


def _layer(lp: Params, x: torch.Tensor, cfg, i: int,
           positions: torch.Tensor, cache: Optional[Params] = None,
           new: Optional[Params] = None, cache_index=None,
           attend_local: bool = False,
           enc_out: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoder layer ``i``: ``x`` plus the mean of its attention (window
    ``cfg.layer_window(i)``; with a ``cache``, K/V written into it in
    place) and its Mamba2 block (from the layer's state in ``cache``, the
    new state written into ``new``'s buffers; from the zero state without
    a cache), both over the normed ``x``, as the reference's
    ``layer_apply`` mixes them; then the cross-attention residual
    (``_cross_residual``), then the FFN residual.  Returns (x, the MoE
    block's load-balancing loss or 0)."""
    h = layers.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    paths = []
    if cfg.has_attention:
        out, _ = layers.attention_apply(
            lp["attn"], h, cfg, positions=positions,
            window=cfg.layer_window(i),
            kv_cache=None if cache is None else _layer_cache(cache, i),
            cache_index=cache_index, attend_local=attend_local)
        paths.append(out)
    if cfg.has_ssm:
        state = None if cache is None else (cache["ssm"][i], cache["conv"][i])
        out, new_state = ssm.mamba_apply(lp["mamba"], h, cfg, state)
        if new_state is not None:
            new["ssm"][i], new["conv"][i] = new_state
        paths.append(out)
    mix = paths[0] if len(paths) == 1 else (paths[0] + paths[1]) / 2
    x = _cross_residual(lp, x + mix, cfg, i, cache, enc_out)
    return _ffn_residual(lp, x, cfg)


def _with_new_state(cache: Params) -> Params:
    """A new dict over ``cache``'s buffers, with fresh ``ssm``/``conv``
    buffers for the step to write (the caller's state stays as it was)."""
    new = dict(cache)
    for name in SSM_KEYS:
        if name in cache:
            new[name] = torch.empty_like(cache[name])
    return new


def _embed(params: Params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    return layers.embed(params["embed"]["table"], tokens).to(
        getattr(torch, cfg.act_dtype))


def _encoded(params: Params, cfg, enc_frames: Optional[torch.Tensor]
             ) -> Optional[torch.Tensor]:
    """The encoder's output for an encoder-decoder config (``ValueError``
    without frames, as the reference raises), None for any other."""
    if not cfg.is_encoder_decoder:
        return None
    if enc_frames is None:
        raise ValueError("enc-dec arch requires enc_frames")
    return encode(params, enc_frames, cfg)


def encode(params: Params, frames: torch.Tensor, cfg) -> torch.Tensor:
    """The bidirectional encoder over precomputed frame embeddings
    ``frames`` (B, S_enc, d_model) (the conv frontend stubbed, as in the
    reference): per layer, RoPE on q and k at positions 0..S_enc-1,
    attention over every frame (``layers.bidir_attention``, plain
    PyTorch), the SwiGLU MLP through ``layers.mlp_apply`` (B1's fused
    GEMM); then the final norm.  Returns (B, S_enc, d_model) in the
    activations' dtype."""
    enc = params["encoder"]
    x = frames.to(getattr(torch, cfg.act_dtype))
    b, s, _ = x.shape
    hh, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    pos = torch.arange(s, device=x.device)[None, None, :]
    for lp in _stack_views(enc["layers"]):
        h = layers.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        p = lp["attn"]
        q = (h @ p["wq"]).reshape(b, s, hh, dh).transpose(1, 2)
        k = (h @ p["wk"]).reshape(b, s, hkv, dh).transpose(1, 2)
        v = (h @ p["wv"]).reshape(b, s, hkv, dh).transpose(1, 2)
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        k = layers.apply_rope(k, pos, cfg.rope_theta)
        out = layers.bidir_attention(q, k, v, scale=dh ** -0.5)
        x = x + out.transpose(1, 2).reshape(b, s, hh * dh) @ p["wo"]
        h2 = layers.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + layers.mlp_apply(lp["mlp"], h2, cfg)
    return layers.rmsnorm(enc["final_norm"], x, cfg.norm_eps)


# Activation rematerialization of each decoder layer under autograd,
# the reference's ``remat``: "none" keeps every activation the backward
# reads; "full" keeps a layer's input alone and recomputes the layer in
# the backward; "dots" keeps the outputs of its matrix products (B1's and
# the projections', ``autograd.KEPT_UNDER_DOTS``) and recomputes the rest,
# B2 included.  The recomputation repeats the forward's arithmetic, so no
# mode changes a bit of the loss or of the gradients.
REMAT = ("none", "dots", "full")


def _keep_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in autograd.KEPT_UNDER_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _rematerialized(fn, remat: str):
    """``fn`` run under ``torch.utils.checkpoint`` as ``remat`` says."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    if remat == "none":
        return fn
    kw = {} if remat == "full" else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _keep_dots)}
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def _tracked(params: Params) -> bool:
    """Is grad enabled with a parameter that requires it?"""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in _tensor_leaves(params))


def _tensor_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensor_leaves(v)
        elif torch.is_tensor(v):
            yield v


def forward_hidden(params: Params, tokens: torch.Tensor, cfg,
                   enc_frames: Optional[torch.Tensor] = None,
                   remat: str = "dots"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The teacher-forced pass over ``tokens`` (B, S) without the
    unembedding: every layer over the whole sequence, causal attention
    over the sequence's own K/V (no cache), the SSM's chunked SSD from the
    zero state, an encoder-decoder's cross attention to ``encode`` of
    ``enc_frames`` (required).  Under autograd each layer is
    rematerialized as ``remat`` says (``REMAT``; without a parameter
    that requires grad there is nothing to keep, and ``remat`` is moot).
    Returns (final hidden (B, S, D), the MoE load-balancing loss summed
    over the layers, 0 without experts)."""
    x = _embed(params, tokens, cfg)
    enc_out = _encoded(params, cfg, enc_frames)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    remat = remat if _tracked(params) else "none"
    for i, lp in enumerate(_layer_params(params)):
        layer = _rematerialized(functools.partial(
            _layer, lp, cfg=cfg, i=i, positions=positions, enc_out=enc_out),
            remat)
        x, a = layer(x)
        aux = aux + a
    return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def forward(params: Params, tokens: torch.Tensor, cfg,
            enc_frames: Optional[torch.Tensor] = None, remat: str = "dots"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The teacher-forced forward (``forward_hidden``, then the
    unembedding).  Returns (logits (B, S, padded_vocab), aux loss); the
    padded vocabulary's logits are left as computed, as the reference
    leaves them (the loss masks them: ``chunked_cross_entropy``)."""
    x, aux = forward_hidden(params, tokens, cfg, enc_frames, remat)
    return layers.unembed(_head(params), x), aux


def _chunk_nll(x: torch.Tensor, table: torch.Tensor, targets: torch.Tensor,
               vocab: int) -> torch.Tensor:
    """Summed next-token NLL of one sequence chunk: the unembedding in
    the activations' dtype cast to float32 (the reference's
    ``einsum(...).astype(float32)``), logits past ``vocab`` at -inf."""
    logits = (x @ table.T).float()
    if logits.shape[-1] != vocab:
        logits = logits.masked_fill(
            torch.arange(logits.shape[-1], device=x.device) >= vocab,
            float("-inf"))
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def chunked_cross_entropy(x: torch.Tensor, table: torch.Tensor,
                          targets: torch.Tensor, cfg,
                          chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross entropy of ``x`` (B, S, D) under the
    unembedding ``table`` (padded_vocab, D) against ``targets`` (B, S),
    the reference's ``chunked_cross_entropy``: the sequence in chunks of
    ``chunk``, each under ``torch.utils.checkpoint``, so the float32
    logits are held for one chunk at a time, never at (B, S, V), and
    recomputed in the backward (the reference pads the last chunk and
    masks the padding; here it is shorter).  A float32 0-d tensor."""
    b, s, _ = x.shape
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, s, chunk):
        total = total + checkpoint(_chunk_nll, x[:, c:c + chunk], table,
                                   targets[:, c:c + chunk], cfg.vocab_size,
                                   use_reentrant=False)
    return total / (b * s)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg,
            remat: str = "dots", aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss of ``batch`` (``tokens``, ``targets``, and
    ``enc_frames`` for an encoder-decoder): the mean next-token NLL plus
    ``aux_weight`` times the MoE load-balancing loss.  Returns (loss,
    {"nll", "aux"}), float32 0-d tensors."""
    x, aux = forward_hidden(params, batch["tokens"], cfg,
                            batch.get("enc_frames"), remat)
    nll = chunked_cross_entropy(x, _head(params), batch["targets"], cfg)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def prefill(params: Params, tokens: torch.Tensor, cfg,
            max_len: Optional[int] = None,
            enc_frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Run the prompt (B, S) through the model, filling a fresh
    ``max_len`` cache.  Attention runs over the local K/V
    (``attend_local``); the SSM runs its chunked form from the zero
    state; an encoder-decoder encodes ``enc_frames`` (required:
    ``ValueError`` without) and keeps each layer's cross K/V in the cache
    (``enc_len`` = the frames' length).  Returns (last-token logits (B,
    V), cache)."""
    b, s = tokens.shape
    dev = tokens.device
    enc_out = _encoded(params, cfg, enc_frames)
    cache = init_cache(cfg, b, max_len or s, cfg.act_dtype, dev,
                       enc_len=None if enc_out is None else enc_out.shape[1])
    x = _embed(params, tokens, cfg)
    positions = torch.arange(s, device=dev)[None, :]
    for i, lp in enumerate(_layer_params(params)):
        x, _ = _layer(lp, x, cfg, i, positions, cache, cache, 0,
                      attend_local=True, enc_out=enc_out)
    cache["index"] = s
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.unembed(_head(params), x[:, -1]), cache


def prefill_chunk(params: Params, cache: Params, tokens: torch.Tensor, cfg,
                  start: Union[int, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Params]:
    """Prefill the chunk ``tokens`` (B, S) into ``cache`` at ``start``
    (one offset, or one per row), attending over the filled cache, so
    the chunk sees everything before it, running the SSM on from the
    cache's state, and cross-attending to the cache's cross K/V.  K/V are
    written into the cache's buffers in place;
    the returned cache is a new dict, with new ``ssm``/``conv`` tensors,
    so the caller's state is as it was if the step is retried.  Returns
    (last-token logits (B, V), cache)."""
    b, s = tokens.shape
    dev = tokens.device
    x = _embed(params, tokens, cfg)
    steps = torch.arange(s, device=dev)
    if torch.is_tensor(start) and start.ndim == 1:
        positions = start.to(dev).long()[:, None] + steps[None, :]
    else:
        positions = (int(start) + steps)[None, :]
    new = _with_new_state(cache)
    for i, lp in enumerate(_layer_params(params)):
        x, _ = _layer(lp, x, cfg, i, positions, cache, new, start)
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
    ``index``; an encoder-decoder cross-attends to the cache's cross K/V,
    carried through unchanged.  The returned cache is a new dict whose
    ``index`` has advanced and whose SSM state (``ssm``/``conv``) is in
    new tensors, so a caller that keeps the old dict after a failed step
    retries at the same positions from the same state.  Returns (logits
    (B, V), cache), padded-vocab logits at -inf.
    """
    b = tokens.shape[0]
    dev = tokens.device
    x = _embed(params, tokens, cfg)
    idx = cache["index"]
    if torch.is_tensor(idx) and idx.ndim == 1:
        positions = idx.to(dev).long()[:, None]
    else:
        positions = torch.full((b, 1), int(idx), device=dev)
    new = _with_new_state(cache)
    for i, lp in enumerate(_layer_params(params)):
        x, _ = _layer(lp, x, cfg, i, positions, cache, new, idx)
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
    float cache: the page pools hold no int8 scales, SSM state or cross
    K/V.)"""
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
    x = _embed(params, tokens, cfg)
    positions = kv_lens.long()[:, None]
    for i, lp in enumerate(_layer_params(params)):
        h = layers.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        attn_out, _ = layers.paged_attention_apply(
            lp["attn"], h, cfg, positions=positions,
            window=cfg.layer_window(i), k_pages=k_pages[i], v_pages=v_pages[i],
            block_tables=block_tables, kv_lens=kv_lens,
            write_pids=write_pids, write_offs=write_offs)
        x, _ = _ffn_residual(lp, x + attn_out, cfg)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = layers.unembed(_head(params), x[:, -1])
    return _mask_vocab(logits, cfg), (k_pages, v_pages)
