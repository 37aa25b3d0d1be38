"""Weight bridge: the JAX package's parameter tree into the port.

``repro.models.lm.init_model`` builds a tree of per-layer leaves stacked
on a leading ``L`` axis (``embed.table`` (padded_vocab, d);
``layers.{ln1, ln2}``, ``layers.attn.{wq, wk, wv, wo, q_norm, k_norm}``,
``layers.mlp.{w1, w3, w2}``, or with ``cfg.binary_mlp``
``layers.mlp.{up, down}.{w_packed, scale, bias}``; ``final_norm``;
``lm_head.table`` when the embeddings are untied).  ``params_from_numpy``
takes that tree with numpy leaves (``jax.tree.map(numpy.asarray,
params)``) and returns the port's parameters, the same layout as
``lm.init_model`` builds.  It checks every path and shape against
``cfg`` and raises on a mismatch.  Packed uint32 words cross over bit for
bit as int32 (the port's word type: torch cannot shift uint32 tensors on
the CPU).
Loading a checkpoint from disk is queued in ROADMAP A5.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib


def expected_shapes(cfg) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """Leaf path -> shape of a dense decoder's parameter tree."""
    n, d, dh, ff = cfg.n_layers, cfg.d_model, cfg.d_head, cfg.d_ff
    shapes = {
        ("embed", "table"): (cfg.padded_vocab, d),
        ("layers", "ln1"): (n, d),
        ("layers", "ln2"): (n, d),
        ("layers", "attn", "wq"): (n, d, cfg.q_dim),
        ("layers", "attn", "wk"): (n, d, cfg.kv_dim),
        ("layers", "attn", "wv"): (n, d, cfg.kv_dim),
        ("layers", "attn", "wo"): (n, cfg.q_dim, d),
        ("final_norm",): (d,),
    }
    if cfg.binary_mlp:
        for name, d_in, d_out in (("up", d, ff), ("down", ff, d)):
            shapes[("layers", "mlp", name, "w_packed")] = (n, d_in // 32,
                                                           d_out)
            shapes[("layers", "mlp", name, "scale")] = (n, d_out)
            shapes[("layers", "mlp", name, "bias")] = (n, d_out)
    else:
        shapes[("layers", "mlp", "w1")] = (n, d, ff)
        shapes[("layers", "mlp", "w3")] = (n, d, ff)
        shapes[("layers", "mlp", "w2")] = (n, ff, d)
    if cfg.qk_norm:
        shapes[("layers", "attn", "q_norm")] = (n, dh)
        shapes[("layers", "attn", "k_norm")] = (n, dh)
    if not cfg.tie_embeddings:
        shapes[("lm_head", "table")] = (cfg.padded_vocab, d)
    return shapes


def _leaves(tree: Dict[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
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


def params_from_numpy(tree: Dict[str, Any], cfg, device=None
                      ) -> Dict[str, Any]:
    """The port's parameters from a JAX parameter tree of numpy arrays."""
    dev = device_lib.resolve(device)
    want = expected_shapes(cfg)
    got = dict(_leaves(tree))
    problems = [f"missing {'.'.join(p)}" for p in want if p not in got]
    problems += [f"unexpected {'.'.join(p)}" for p in got if p not in want]
    problems += [
        f"{'.'.join(p)}: shape {tuple(np.shape(got[p]))} != {shape}"
        for p, shape in want.items()
        if p in got and tuple(np.shape(got[p])) != shape]
    if problems:
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         + "; ".join(problems))
    out: Dict[str, Any] = {}
    for path, arr in got.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _to_tensor(arr, dev)
    return out
