"""Weight bridge: the JAX package's parameter tree into the port.

``repro.models.lm.init_model`` builds a tree of per-layer leaves stacked
on a leading ``L`` axis (``embed.table`` (padded_vocab, d);
``layers.{ln1, ln2}``, ``layers.attn.{wq, wk, wv, wo, q_norm, k_norm}``,
``layers.mlp.{w1, w3, w2}``, or with ``cfg.binary_mlp``
``layers.mlp.{up, down}.{w_packed, scale, bias}``, or with
``cfg.packed_weights`` ``layers.mlp.{w1, w3, w2}`` as stacked
``PackedWeights``, or with ``cfg.n_experts`` ``layers.moe.{router, w1,
w3, w2}`` and, with shared experts, ``layers.moe.shared.{w1, w3, w2}``;
with an SSM ``layers.mamba.{z_proj, x_proj, bc_proj, dt_proj, conv_x_w,
conv_x_b, conv_bc_w, conv_bc_b, a_log, d_skip, dt_bias, norm,
out_proj}``, and no ``attn`` for an attention-free config, no ``ln2`` or
``mlp`` for an ``ssm`` one; for an encoder-decoder ``layers.ln_cross``,
``layers.cross.{wq, wk, wv, wo}``, and ``encoder.layers.{ln1, ln2}``,
``encoder.layers.attn.{wq, wk, wv, wo}``, ``encoder.layers.mlp.{w1, w3,
w2}`` stacked on the encoder's ``n_enc_layers`` and
``encoder.final_norm``, each attention with ``q_norm``/``k_norm`` under
qk-norm; ``final_norm``; ``lm_head.table`` when the embeddings are
untied).
``params_from_numpy`` takes that tree with numpy leaves
(``jax.tree.map(numpy.asarray, params)``) and returns the port's
parameters, the same layout as ``lm.init_model`` builds.  It
checks every path and shape against ``cfg`` and raises on a mismatch.
Binary uint32 words cross over bit for bit as int32 (the port's word
type: torch cannot shift uint32 tensors on the CPU); a ``PackedWeights``
crosses over leaf by leaf (its planes are int32 already), with its
``bits``, ``k`` and ``n`` as they are, into the port's
``kernels.pack.PackedWeights``.

``cache_from_numpy`` carries a JAX cache across the same way (int8
codes, f32 scales, bf16 K/V by their bits, the SSM's ``ssm``/``conv``
state, an encoder-decoder's ``cross_k``/``cross_v``, and ``index``), so
the port's decode step can run on exactly the JAX package's cache.

``params_from_checkpoint`` loads the port's parameters from one of its
own checkpoints (the ``params`` tree of an engine snapshot,
``ckpt.checkpoint``), checked against ``cfg`` the same way.  It reads no
JAX checkpoint.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.kernels import pack


def _mamba_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Leaf -> shape of one Mamba2 block (``ssm.init_mamba``)."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h, k = cfg.ssm_heads, cfg.ssm_conv
    return {"z_proj": (d, di), "x_proj": (d, di), "bc_proj": (d, 2 * n),
            "dt_proj": (d, h), "conv_x_w": (k, di), "conv_x_b": (di,),
            "conv_bc_w": (k, 2 * n), "conv_bc_b": (2 * n,), "a_log": (h,),
            "d_skip": (h,), "dt_bias": (h,), "norm": (di,),
            "out_proj": (di, d)}


def _attention_shapes(cfg, prefix: Tuple[str, ...],
                      n: int) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """Leaf path -> shape of ``n`` stacked attentions under ``prefix``
    (with ``q_norm``/``k_norm`` under qk-norm)."""
    d, dh = cfg.d_model, cfg.d_head
    shapes = {prefix + ("wq",): (n, d, cfg.q_dim),
              prefix + ("wk",): (n, d, cfg.kv_dim),
              prefix + ("wv",): (n, d, cfg.kv_dim),
              prefix + ("wo",): (n, cfg.q_dim, d)}
    if cfg.qk_norm:
        shapes[prefix + ("q_norm",)] = (n, dh)
        shapes[prefix + ("k_norm",)] = (n, dh)
    return shapes


def expected_shapes(cfg) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """Leaf path -> shape of a dense, MoE, SSM or hybrid decoder's, or
    an encoder-decoder's, parameter tree."""
    n, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    shapes = {
        ("embed", "table"): (cfg.padded_vocab, d),
        ("layers", "ln1"): (n, d),
        ("final_norm",): (d,),
    }
    if cfg.has_attention:
        shapes.update(_attention_shapes(cfg, ("layers", "attn"), n))
    if cfg.has_ssm:
        for leaf, shape in _mamba_shapes(cfg).items():
            shapes[("layers", "mamba", leaf)] = (n,) + shape
    if cfg.n_experts or (ff and cfg.family != "ssm"):
        shapes[("layers", "ln2")] = (n, d)
    if cfg.n_experts:
        e, fs = cfg.n_experts, ff * cfg.n_shared_experts
        shapes[("layers", "moe", "router")] = (n, d, e)
        shapes[("layers", "moe", "w1")] = (n, e, d, ff)
        shapes[("layers", "moe", "w3")] = (n, e, d, ff)
        shapes[("layers", "moe", "w2")] = (n, e, ff, d)
        if fs:
            shapes[("layers", "moe", "shared", "w1")] = (n, d, fs)
            shapes[("layers", "moe", "shared", "w3")] = (n, d, fs)
            shapes[("layers", "moe", "shared", "w2")] = (n, fs, d)
    elif cfg.binary_mlp:
        for name, d_in, d_out in (("up", d, ff), ("down", ff, d)):
            shapes[("layers", "mlp", name, "w_packed")] = (n, d_in // 32,
                                                           d_out)
            shapes[("layers", "mlp", name, "scale")] = (n, d_out)
            shapes[("layers", "mlp", name, "bias")] = (n, d_out)
    elif cfg.packed_weights:
        for name, d_in, d_out in _packed_mlp(cfg):
            for leaf, shape in _packed_shapes(n, d_in, d_out,
                                              cfg.packed_weight_bits).items():
                shapes[("layers", "mlp", name, leaf)] = shape
    elif ff and cfg.family != "ssm":
        shapes[("layers", "mlp", "w1")] = (n, d, ff)
        shapes[("layers", "mlp", "w3")] = (n, d, ff)
        shapes[("layers", "mlp", "w2")] = (n, ff, d)
    if cfg.is_encoder_decoder:
        ne = cfg.n_enc_layers
        shapes[("layers", "ln_cross")] = (n, d)
        shapes.update(_attention_shapes(cfg, ("layers", "cross"), n))
        enc = ("encoder", "layers")
        shapes[enc + ("ln1",)] = (ne, d)
        shapes[enc + ("ln2",)] = (ne, d)
        shapes.update(_attention_shapes(cfg, enc + ("attn",), ne))
        shapes[enc + ("mlp", "w1")] = (ne, d, ff)
        shapes[enc + ("mlp", "w3")] = (ne, d, ff)
        shapes[enc + ("mlp", "w2")] = (ne, ff, d)
        shapes[("encoder", "final_norm")] = (d,)
    if not cfg.tie_embeddings:
        shapes[("lm_head", "table")] = (cfg.padded_vocab, d)
    return shapes


def _packed_mlp(cfg):
    """(name, d_in, d_out) of a packed MLP's projections."""
    d, ff = cfg.d_model, cfg.d_ff
    return (("w1", d, ff), ("w3", d, ff), ("w2", ff, d))


def _packed_shapes(n: int, d_in: int, d_out: int,
                   bits: int) -> Dict[str, Tuple[int, ...]]:
    """Leaf shapes of ``n`` stacked ``PackedWeights`` of a (d_in, d_out)
    weight packed at ``outlier_capacity(d_in)``."""
    kp = -(-d_in // pack.WORD_BITS) * pack.WORD_BITS
    r = pack.outlier_capacity(d_in)
    shapes = {"codes": (n, kp // pack.WORD_NIBBLES, d_out),
              "scale": (n, 1, d_out), "outlier_idx": (n, r),
              "outlier_delta": (n, r, d_out)}
    if bits == 5:
        shapes["highbits"] = (n, kp // pack.WORD_BITS, d_out)
    return shapes


def _is_packed(v) -> bool:
    return all(hasattr(v, f) for f in ("codes", "outlier_idx", "bits", "k",
                                       "n"))


def _leaves(tree: Dict[str, Any], prefix=()):
    """(path, array) of every leaf; a packed weight's leaves under its
    path, by field name."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        elif _is_packed(v):
            for f in pack.PackedWeights.LEAVES:
                if getattr(v, f) is not None:
                    yield prefix + (k, f), getattr(v, f)
        else:
            yield prefix + (k,), v


def _to_tensor(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":      # ml_dtypes: no numpy<->torch path
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                             .copy()).view(torch.bfloat16)
    elif arr.dtype == np.uint32:          # packed words, bit for bit
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int32).copy())
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(dev)


def check_tree(tree: Dict[str, Any], cfg) -> Dict[Tuple[str, ...], Any]:
    """The tree's leaves by path, or ``ValueError`` naming every path,
    shape and packed size that does not match ``cfg``."""
    want = expected_shapes(cfg)
    got = dict(_leaves(tree))
    problems = [f"missing {'.'.join(p)}" for p in want if p not in got]
    problems += [f"unexpected {'.'.join(p)}" for p in got if p not in want]
    problems += [
        f"{'.'.join(p)}: shape {tuple(np.shape(got[p]))} != {shape}"
        for p, shape in want.items()
        if p in got and tuple(np.shape(got[p])) != shape]
    if cfg.packed_weights:
        mlp = tree.get("layers", {}).get("mlp", {})
        problems += [
            f"layers.mlp.{name}: (bits, k, n) != "
            f"{(cfg.packed_weight_bits, d_in, d_out)}"
            for name, d_in, d_out in _packed_mlp(cfg)
            if not _is_packed(mlp.get(name)) or (
                mlp[name].bits, mlp[name].k, mlp[name].n)
            != (cfg.packed_weight_bits, d_in, d_out)]
    if problems:
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         + "; ".join(problems))
    return got


def params_from_numpy(tree: Dict[str, Any], cfg, device=None
                      ) -> Dict[str, Any]:
    """The port's parameters from a JAX parameter tree of numpy arrays."""
    dev = device_lib.resolve(device)
    got = check_tree(tree, cfg)
    out: Dict[str, Any] = {}
    for path, arr in got.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _to_tensor(arr, dev)
    if cfg.packed_weights:
        mlp = out["layers"]["mlp"]
        for name, d_in, d_out in _packed_mlp(cfg):
            leaves = mlp[name]
            mlp[name] = pack.PackedWeights(
                leaves["codes"], leaves.get("highbits"), leaves["scale"],
                leaves["outlier_idx"], leaves["outlier_delta"],
                cfg.packed_weight_bits, d_in, d_out)
    return out


def cache_from_numpy(tree: Dict[str, Any], cfg, device=None
                     ) -> Dict[str, Any]:
    """The port's cache (``lm.init_cache``'s layout) from a JAX cache of
    numpy arrays (``jax.tree.map(numpy.asarray, cache)``): with attention
    ``k``/``v`` (L, B, Hkv, S, D) as they are (bf16 by their bits, int8
    codes) and an int8 cache's ``k_scale``/``v_scale`` (L, B, Hkv, S, 1)
    f32; with an SSM ``ssm`` (L, B, H, N, P) and ``conv`` (L, B, K-1,
    d_inner + 2N), float32 (a tail the reference left in the activations'
    type is widened, exactly); with an encoder ``cross_k``/``cross_v``
    (L, B, Hkv, S_enc, D) as they are; and ``index`` as an int (a scalar)
    or an int32 tensor (one per row).  Raises ``ValueError`` on a missing
    or unexpected buffer or a shape ``cfg`` does not give."""
    from repro_torch.models import lm

    dev = device_lib.resolve(device)
    int8 = np.asarray(tree.get("k")).dtype == np.int8
    want = list(lm.KV_KEYS if int8 else lm.KV_KEYS[:2]) \
        if cfg.has_attention else []
    want += list(lm.SSM_KEYS) if cfg.has_ssm else []
    want += list(lm.CROSS_KEYS) if cfg.is_encoder_decoder else []
    names = [n for n in lm.CACHE_KEYS if n in tree]
    if names != want or "index" not in tree:
        raise ValueError(f"a {'int8' if int8 else 'float'} cache of "
                         f"{cfg.name} has index and {want}, got "
                         f"{sorted(tree)}")
    shapes = {}
    if cfg.has_attention:
        shape = np.shape(tree["k"])
        if len(shape) != 5 or shape[0] != cfg.n_layers \
                or shape[2] != cfg.n_kv_heads or shape[4] != cfg.d_head:
            raise ValueError(f"cache buffers {shape} do not match "
                             f"{cfg.name}'s (L, B, Hkv, S, D)")
        for n in names:
            if n in lm.KV_KEYS:
                shapes[n] = shape[:4] + ((1,) if n.endswith("scale")
                                         else (shape[4],))
    if cfg.has_ssm:
        b = np.shape(tree["ssm"])[1]
        shapes["ssm"] = (cfg.n_layers, b, cfg.ssm_heads, cfg.ssm_state,
                         cfg.ssm_headdim)
        shapes["conv"] = (cfg.n_layers, b, cfg.ssm_conv - 1,
                          cfg.d_inner + 2 * cfg.ssm_state)
    if cfg.is_encoder_decoder:
        b, se = np.shape(tree["k"])[1], np.shape(tree["cross_k"])[3]
        for n in lm.CROSS_KEYS:
            shapes[n] = (cfg.n_layers, b, cfg.n_kv_heads, se, cfg.d_head)
    for n, sh in shapes.items():
        if tuple(np.shape(tree[n])) != sh:
            raise ValueError(f"cache {n}: shape {np.shape(tree[n])} != {sh}")
    out: Dict[str, Any] = {n: _to_tensor(tree[n], dev) for n in names}
    for n in lm.SSM_KEYS:
        if n in out:
            out[n] = out[n].float()
    index = np.asarray(tree["index"])
    out["index"] = (int(index) if index.ndim == 0 else
                    torch.from_numpy(index.astype(np.int32)).to(dev))
    return out


def params_from_checkpoint(directory: str, cfg, step: Optional[int] = None,
                           device=None) -> Dict[str, Any]:
    """The port's parameters from one of its own checkpoints in
    ``directory`` (step ``step``, default the latest), loaded onto
    ``device`` (the card by default) and checked against ``cfg``."""
    from repro_torch.ckpt.checkpoint import Checkpointer

    dev = device_lib.resolve(device)
    _, state, _ = Checkpointer(directory).restore(step, device=dev,
                                                  names=["params"])
    check_tree(state["params"], cfg)
    return state["params"]
