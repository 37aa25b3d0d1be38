"""The LM over a device mesh: tensor, sequence, data and expert parallel.

The counterpart of the reference's ``dist=`` paths (``lm.Dist``), which
GSPMD partitions from sharding constraints.  ``lm``'s entry points and
``lm._layer`` are written once; with ``dist=`` they run their pieces
through ``Mesh`` (here) in place of ``lm.OneDevice``.  This module holds
the layouts, the regions and the vocab-parallel pieces.  Every block runs on
local shards inside ``torch.distributed.tensor.experimental.local_map``
(the counterpart of ``shard_map``), over parameters that are DTensors
placed by the rules of ``launch/sharding.py``.  A region redistributes
its DTensor inputs to the placements it computes on (FSDP: a weight's
data axes gathered; its ``model`` axis as the rule shards it), calls the
single-device code of ``models/layers.py``, ``models/moe.py`` and
``models/ssm.py`` on the local tensors (so every kernel wrapper sees a
plain tensor: no custom op or CUDA wrapper is dispatched as a DTensor
op), and wraps its outputs as DTensors.  At one rank a region's local
tensors are the whole tensors and it launches what the single-device
path launches, on the same values.

Layouts, per mesh dimension (``act``): activations put their batch on
the data axes (where the batch divides them) and, for attention-only
configs whose sequence divides the ``model`` axis, their sequence on it
between blocks (Megatron-SP: the reference's constraint at
``lm.py:283-296``), else replicate it there.

Blocks:
  * attention, teacher-forced: column-parallel ``wq`` (and ``wk``/``wv``
    where the KV heads divide the axis; where the axis is a multiple of
    the KV heads each rank gathers them and takes its query heads' KV
    head), row-parallel ``wo``, B2 over the local heads; the output is
    ``Partial`` over ``model`` (a reduce-scatter back to the sequence
    layout).  Other head counts run the block replicated over ``model``.
  * attention with a cache: the cache keeps the reference's layout
    (sequence over ``model``) and is never redistributed.  A prefill
    attends over its fresh K/V alone, replicated over ``model``, each
    rank writing its positions' range.  Decode (more than one ``model``
    rank) splits over the keys: each rank computes q, k and v (the
    projections replicated over ``model``), writes the fresh K/V where
    its positions meet the rank's range, attends over that range with
    B2 (valid length ``kv_len - k0``) and its rows' statistics, and the
    ranks' (output, statistic) pairs are all-gathered over ``model`` and
    merged (``merge_key_ranges``) in rank order, the same on every rank,
    before ``wo``.  At one ``model`` rank it runs the one-device code.
  * MLP: column-parallel ``w1``/``w3``, row-parallel ``w2`` (B1 on the
    local columns), ``Partial`` out; replicated where ``d_ff`` does not
    divide the axis, and for the binary MLP.
  * MoE: ``moe.moe_apply_sharded`` (all-to-all or psum-local).
  * Mamba2, cross attention, the encoder: replicated over ``model``.
  * embedding: vocab-parallel lookup, ``Partial`` out; unembedding:
    vocab-parallel logits, sharded over ``model`` on the vocabulary (the
    reference's ``P(dp, None, tp)``); the loss: a vocab-parallel cross
    entropy (``VocabParallelNLL``).

The gradient of a region's input follows from where it computes: an
input replicated over ``model`` inside a tensor-parallel block gets a
``Partial`` gradient there; a weight gathered over the data axes gets a
``Partial`` gradient over them where the batch is split (the backward
of the gather is then a reduce-scatter: ZeRO-3).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.launch import sharding as rules
from repro_torch.models import layers, lm, moe
from repro_torch.runtime import health

Params = Dict[str, Any]

# DTensor logs a warning for every redistribution over two mesh axes at
# once (two sequential all-reduces): the data axes of a multi-pod mesh.
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)


def _dt():
    from torch.distributed import tensor
    return tensor


# ---------------------------------------------------------------------------
# Layouts.
# ---------------------------------------------------------------------------
def _dims(dist) -> Tuple[List[int], int]:
    names = dist.mesh.mesh_dim_names
    return [names.index(a) for a in dist.dp_axes], names.index(dist.tp_axis)


def tp_size(dist) -> int:
    return dist.mesh.size(_dims(dist)[1])


def tp_rank(dist) -> int:
    return dist.mesh.get_local_rank(_dims(dist)[1])


def dp_size(dist) -> int:
    dp, _ = _dims(dist)
    out = 1
    for d in dp:
        out *= dist.mesh.size(d)
    return out


def batch_split(dist, batch: int) -> bool:
    """Does the batch split over the data axes (the batch rule)?"""
    return batch % dp_size(dist) == 0


def seq_split(dist, cfg, seq: int) -> bool:
    """Megatron-SP: the residual stream's sequence over ``model``."""
    tp = tp_size(dist)
    return (not cfg.has_ssm) and seq % tp == 0 and seq >= tp


def act(dist, batch_sharded: bool, tp_pl=None, batch_dim: int = 0) -> tuple:
    """Placements of an activation: its batch over the data axes (where
    it splits), ``tp_pl`` (default replicated) over ``model``."""
    t = _dt()
    dp, tp = _dims(dist)
    out = [t.Replicate()] * dist.mesh.ndim
    for d in dp:
        out[d] = t.Shard(batch_dim) if batch_sharded else t.Replicate()
    out[tp] = tp_pl if tp_pl is not None else t.Replicate()
    return tuple(out)


def residual(dist, cfg, batch: int, seq: int) -> tuple:
    """The residual stream's layout between blocks."""
    t = _dt()
    return act(dist, batch_split(dist, batch),
               t.Shard(1) if seq_split(dist, cfg, seq) else None)


def gathered(dist, x, keep_tp: bool = True) -> tuple:
    """A weight's compute placements: its data axes gathered (FSDP), its
    ``model`` placement kept (or gathered too)."""
    t = _dt()
    dp, tp = _dims(dist)
    out = list(x.placements)
    for d in dp:
        out[d] = t.Replicate()
    if not keep_tp:
        out[tp] = t.Replicate()
    return tuple(out)


def _grad_placements(dist, pl: tuple, tp_region: bool,
                     batch_sharded: bool) -> tuple:
    t = _dt()
    dp, tp = _dims(dist)
    out = list(pl)
    for d in dp:
        if isinstance(pl[d], t.Replicate) and batch_sharded:
            out[d] = t.Partial()
    if isinstance(pl[tp], t.Replicate) and tp_region:
        out[tp] = t.Partial()
    return tuple(out)


def region(dist, fn, inputs: Sequence[Tuple[Any, tuple]], out_pls,
           tp_region: bool, batch_sharded: bool):
    """``fn(*local inputs)`` under ``local_map``: each input a DTensor
    with the placements it is computed on; ``out_pls`` one placement
    tuple per output of ``fn`` (which returns a tuple)."""
    from torch.distributed.tensor.experimental import local_map

    args = [x for x, _ in inputs]
    in_pls = tuple(pl for _, pl in inputs)
    grads = tuple(_grad_placements(dist, pl, tp_region, batch_sharded)
                  for pl in in_pls)
    return local_map(fn, out_placements=tuple(out_pls),
                     in_placements=in_pls, in_grad_placements=grads,
                     device_mesh=dist.mesh, redistribute_inputs=True)(*args)


def _flat(tree, prefix=()) -> List[Tuple[Tuple[str, ...], Any]]:
    out = []
    for k in tree:
        v = tree[k]
        if isinstance(v, dict):
            out += _flat(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def _unflat(pairs) -> Params:
    tree: Params = {}
    for path, v in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


# ---------------------------------------------------------------------------
# Tensors onto the mesh.
# ---------------------------------------------------------------------------
def from_global(x: torch.Tensor, mesh, pls: tuple, device=None) -> Any:
    """A DTensor from a tensor every rank holds whole (on the host or a
    device): this rank's slice (``sharding.shard_slices``), moved to
    ``device`` when given, wrapped as it is."""
    from torch.distributed.tensor import DTensor

    local = x[rules.shard_slices(tuple(x.shape), pls, mesh)]
    if device is not None:
        local = local.to(device)
    return DTensor.from_local(local.contiguous(), mesh, pls,
                              run_check=False, shape=x.shape,
                              stride=_contiguous_stride(x.shape))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def _as_dist(x, mesh, pls: tuple):
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(mesh, pls) if x.placements != pls else x
    return from_global(x, mesh, pls)


def shard_params(params: Params, mesh) -> Params:
    """Whole parameters (every rank's the same) as DTensors by the rules."""
    sh = rules.param_shardings(params, mesh)
    return rules._map(lambda path, v: from_global(v, mesh, _get(sh, path)
                                                  .placements), params)


def _get(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def zeros_like_sharded(shape, dtype, mesh, pls: tuple, device) -> Any:
    """A zero DTensor of global ``shape``, allocating this rank's shard
    only."""
    from torch.distributed.tensor import DTensor

    local = torch.zeros(rules.local_shape_of(shape, pls, mesh), dtype=dtype,
                        device=device)
    return DTensor.from_local(local, mesh, pls, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


# ---------------------------------------------------------------------------
# Blocks.
# ---------------------------------------------------------------------------
def _heads_split(cfg, tp: int) -> Optional[str]:
    """How attention splits over ``tp`` ranks: "heads" (Q and KV heads
    both divide), "query" (Q heads divide, the axis is a multiple of the
    KV heads: each rank takes one KV head), or None (replicated)."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if tp == 1 or hq % tp:
        return "heads" if tp == 1 else None
    if hkv % tp == 0:
        return "heads"
    if tp % hkv == 0:
        return "query"
    return None


def _tp_on(dist, x) -> bool:
    """Is ``x`` sharded over ``model``?"""
    return isinstance(x.placements[_dims(dist)[1]], _dt().Shard)


def attention_block(dist, lp: Params, x, cfg, i: int, positions):
    """Layer ``i``'s normed self-attention over the whole sequence (no
    cache).  Returns its output, ``Partial`` or replicated over
    ``model``."""
    t = _dt()
    p = lp["attn"]
    tp = tp_size(dist)
    split = _heads_split(cfg, tp)
    if split is not None and not (_tp_on(dist, p["wq"])
                                  and _tp_on(dist, p["wo"])):
        split = None
    if split == "heads" and tp > 1 and not _tp_on(dist, p["wk"]):
        split = None
    if split is None:
        return replicated_block(
            dist, lp, x, cfg, ("ln1", "attn"),
            lambda w, x: lm.ONE_DEVICE.attention(
                w, layers.rmsnorm(w["ln1"], x, cfg.norm_eps), cfg, i,
                positions))
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    loc = dataclasses.replace(cfg, n_heads=hq // tp,
                              n_kv_heads=hkv // tp if split == "heads" else 1)
    kvh = (tp_rank(dist) * (hq // tp)) // (hq // hkv)
    b = x.shape[0]
    bs = batch_split(dist, b)
    names = sorted(p)
    pls = []
    for n in names:
        keep = not (split == "query" and n in ("wk", "wv"))
        pls.append(gathered(dist, p[n], keep_tp=keep))

    def fn(x, ln1, *leaves):
        w = dict(zip(names, leaves))
        if split == "query":
            w["wk"] = w["wk"][:, kvh * dh:(kvh + 1) * dh]
            w["wv"] = w["wv"][:, kvh * dh:(kvh + 1) * dh]
        h = layers.rmsnorm(ln1, x, cfg.norm_eps)
        return (lm.ONE_DEVICE.attention({"attn": w}, h, loc, i, positions),)

    inputs = ([(x, act(dist, bs)), (lp["ln1"], gathered(dist, lp["ln1"]))]
              + [(p[n], pl) for n, pl in zip(names, pls)])
    (out,) = region(dist, fn, inputs, [act(dist, bs, t.Partial())],
                    tp_region=True, batch_sharded=bs)
    return out


def replicated_block(dist, lp: Params, x, cfg, keys: Sequence[str], body,
                     extra: Sequence[Tuple[Any, tuple]] = (),
                     n_out: int = 1):
    """``body(local lp, local x, *local extra)`` with every weight under
    ``keys`` gathered whole and ``x`` replicated over ``model``: every
    rank of a ``model`` group computes the same output."""
    b = x.shape[0]
    bs = batch_split(dist, b)
    sub = {k: lp[k] for k in keys}
    leaves = _flat(sub)
    paths = [pth for pth, _ in leaves]

    def fn(x, *rest):
        w = _unflat(zip(paths, rest[:len(paths)]))
        out = body(w, x, *rest[len(paths):])
        return out if isinstance(out, tuple) else (out,)

    inputs = ([(x, act(dist, bs))]
              + [(v, gathered(dist, v, keep_tp=False)) for _, v in leaves]
              + list(extra))
    outs = region(dist, fn, inputs, [act(dist, bs)] * n_out,
                  tp_region=False, batch_sharded=bs)
    return outs if n_out > 1 else outs[0]


def mlp_block(dist, lp: Params, x, cfg):
    """Layer's normed MLP: column/row parallel SwiGLU, ``Partial`` out;
    replicated where ``d_ff`` does not divide ``model`` (or binary)."""
    t = _dt()
    p = lp["mlp"]
    tp_ok = (set(p) == {"w1", "w3", "w2"}
             and all(torch.is_tensor(v) for v in p.values())
             and _tp_on(dist, p["w1"]) and _tp_on(dist, p["w3"])
             and _tp_on(dist, p["w2"]))
    if not tp_ok:
        return replicated_block(
            dist, lp, x, cfg, ("ln2", "mlp"),
            lambda w, x: layers.mlp_apply(
                w["mlp"], layers.rmsnorm(w["ln2"], x, cfg.norm_eps), cfg))
    b = x.shape[0]
    bs = batch_split(dist, b)

    def fn(x, ln2, w1, w3, w2):
        h2 = layers.rmsnorm(ln2, x, cfg.norm_eps)
        return (layers.mlp_apply({"w1": w1, "w3": w3, "w2": w2}, h2, cfg),)

    inputs = [(x, act(dist, bs)), (lp["ln2"], gathered(dist, lp["ln2"]))] + [
        (p[n], gathered(dist, p[n])) for n in ("w1", "w3", "w2")]
    (out,) = region(dist, fn, inputs, [act(dist, bs, t.Partial())],
                    tp_region=True, batch_sharded=bs)
    return out


def ssm_block(dist, lp: Params, x, cfg, i: int, cache=None, new=None):
    """Layer ``i``'s normed Mamba2 block (``lm.OneDevice.ssm``), replicated
    over ``model``.  With a ``cache`` (DTensors), the new state is written
    into ``new``'s (the caller's fresh buffers') local shards in place."""
    if cache is None:
        return replicated_block(
            dist, lp, x, cfg, ("ln1", "mamba"),
            lambda w, x: lm.ONE_DEVICE.ssm(
                w, layers.rmsnorm(w["ln1"], x, cfg.norm_eps), cfg, i))
    bs = batch_split(dist, x.shape[0])
    bufs = [cache[n][i] for n in lm.SSM_KEYS] + [new[n][i]
                                                 for n in lm.SSM_KEYS]

    def body(w, x, ssm_s, conv_s, new_ssm, new_conv):
        h = layers.rmsnorm(w["ln1"], x, cfg.norm_eps)
        return lm.ONE_DEVICE.ssm(
            w, h, cfg, 0, {"ssm": ssm_s[None], "conv": conv_s[None]},
            {"ssm": new_ssm[None], "conv": new_conv[None]})

    return replicated_block(dist, lp, x, cfg, ("ln1", "mamba"), body,
                            [(s, act(dist, bs)) for s in bufs])


def to_layout(x, dist, pls: tuple):
    """``x`` redistributed to ``pls`` (a no-op when it is there)."""
    return x if x.placements == pls else x.redistribute(dist.mesh, pls)


# ---------------------------------------------------------------------------
# Embedding, final norm, unembedding, loss.
# ---------------------------------------------------------------------------
def _vocab_shard(dist, table) -> Tuple[bool, int, int]:
    """(vocab sharded over ``model``?, this rank's first row, its rows)."""
    if not _tp_on(dist, table):
        return False, 0, table.shape[0]
    rows = table.shape[0] // tp_size(dist)
    return True, tp_rank(dist) * rows, rows


def embed(dist, params: Params, tokens, cfg, layout: tuple):
    """Vocab-parallel embedding of ``tokens`` (a DTensor, batch over the
    data axes), in the activations' dtype, in ``layout``."""
    t = _dt()
    table = params["embed"]["table"]
    split, off, rows = _vocab_shard(dist, table)
    bs = batch_split(dist, tokens.shape[0])
    dt = getattr(torch, cfg.act_dtype)

    def fn(tok, tab):
        if not split:
            return (layers.embed(tab, tok).to(dt),)
        loc = tok.long() - off
        hit = (loc >= 0) & (loc < rows)
        e = layers.embed(tab, loc.clamp(0, rows - 1))
        return (torch.where(hit[..., None], e, torch.zeros_like(e)).to(dt),)

    (x,) = region(dist, fn, [(tokens, act(dist, bs)),
                             (table, gathered(dist, table))],
                  [act(dist, bs, t.Partial() if split else None)],
                  tp_region=split, batch_sharded=bs)
    return to_layout(x, dist, layout)


def final_norm(dist, params: Params, x, cfg):
    """The final norm of ``x`` in its own layout (a row-wise op: no
    communication)."""
    w = params["final_norm"]
    (out,) = region(dist, lambda x, w: (layers.rmsnorm(w, x, cfg.norm_eps),),
                    [(x, x.placements), (w, gathered(dist, w))],
                    [x.placements], tp_region=_tp_on(dist, x),
                    batch_sharded=batch_split(dist, x.shape[0]))
    return out


def unembed(dist, params: Params, x, cfg, last: bool, mask_vocab: bool):
    """Logits of the normed ``x`` (B, S, D) (``last``: of its last
    position only), padded-vocab logits at -inf when ``mask_vocab``:
    vocab-sharded over ``model`` where the table is, as the reference's
    logits sharding."""
    t = _dt()
    head = params.get("lm_head", params["embed"])["table"]
    split, off, rows = _vocab_shard(dist, head)
    bs = batch_split(dist, x.shape[0])
    vocab = cfg.vocab_size

    def fn(x, tab):
        logits = layers.unembed(tab, x[:, -1] if last else x)
        if mask_vocab and off + rows > vocab:
            logits[..., max(vocab - off, 0):] = float("-inf")
        return (logits,)

    nd = 2 if last else 3
    (out,) = region(dist, fn,
                    [(x, act(dist, bs)), (head, gathered(dist, head))],
                    [act(dist, bs, t.Shard(nd - 1) if split else None)],
                    tp_region=split, batch_sharded=bs)
    return out


class VocabParallelNLL(torch.autograd.Function):
    """Per-token NLL of vocab-sharded float32 logits (T, V_loc): the max
    and the sum of exponentials all-reduced over the ``model`` group, the
    gold logit from the rank that holds it.  Backward: softmax minus the
    one-hot, on the local columns."""

    @staticmethod
    def forward(ctx, logits, targets, off: int, group):
        import torch.distributed._functional_collectives as funcol

        m = funcol.all_reduce(logits.detach().amax(dim=-1), "max", group)
        e = torch.exp(logits - m[:, None])
        se = funcol.all_reduce(e.sum(dim=-1), "sum", group)
        loc = targets.long() - off
        hit = (loc >= 0) & (loc < logits.shape[-1])
        idx = loc.clamp(0, logits.shape[-1] - 1)
        gold = logits.gather(-1, idx[:, None])[:, 0] * hit
        gold = funcol.all_reduce(gold, "sum", group)
        ctx.save_for_backward(e / se[:, None], idx, hit)
        return torch.log(se) + m - gold

    @staticmethod
    def backward(ctx, g):
        p, idx, hit = ctx.saved_tensors
        grad = p * g[:, None]
        grad.scatter_add_(-1, idx[:, None], (-g * hit)[:, None])
        return grad, None, None, None


def nll_sum(dist, params: Params, x, targets, cfg, chunk: int = 1024):
    """Summed next-token NLL of the normed ``x`` (B x S x D) against
    ``targets``: ``lm._nll_sum`` on the local batch, the logits
    vocab-parallel where the head is sharded.  A 0-d replicated
    DTensor."""
    t = _dt()
    head = params.get("lm_head", params["embed"])["table"]
    split, off, _ = _vocab_shard(dist, head)
    bs = batch_split(dist, x.shape[0])
    group = (dist.mesh, _dims(dist)[1]) if split else None

    def fn(x, tab, tg):
        return (lm._nll_sum(x, tab, tg, cfg.vocab_size, chunk, off, group),)

    out_pl = list(act(dist, False))
    if bs:
        for d in _dims(dist)[0]:
            out_pl[d] = t.Partial()
    (out,) = region(dist, fn, [(x, act(dist, bs)),
                               (head, gathered(dist, head)),
                               (targets, act(dist, bs))],
                    [tuple(out_pl)], tp_region=split, batch_sharded=bs)
    return out.redistribute(dist.mesh, act(dist, False))


# ---------------------------------------------------------------------------
# Caches.
# ---------------------------------------------------------------------------
def _seq_range(dist, length: int, pls: tuple, seq_dim: int
               ) -> Tuple[int, int]:
    """(first position, positions) of this rank's shard of a cache whose
    sequence (dim ``seq_dim``) is laid out by ``pls``."""
    sl = rules.shard_slices((length,) * (seq_dim + 1), pls, dist.mesh)[
        seq_dim]
    start = sl.start or 0
    stop = length if sl.stop is None else sl.stop
    return start, stop - start


def merge_key_ranges(outs: Sequence[torch.Tensor],
                     lses: Sequence[torch.Tensor]) -> torch.Tensor:
    """One attention over a cache's keys from its parts over disjoint key
    ranges: each range's output (B, Hq, S, D) and rows' statistics
    (B, Hq, S) f32 (B2's ``return_lse``).  With ``M`` the rows' largest
    statistic, range r weighs ``w_r = exp(lse_r - M)`` (0 where it sees
    no key), and the output is ``sum_r w_r out_r / sum_r w_r``, in
    float32, summed in the ranges' order, in the outputs' dtype; a row no
    range sees gives 0, as on one device.  One range gives its output's
    bits."""
    m = torch.stack(list(lses)).amax(dim=0)
    shift = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    num = torch.zeros(outs[0].shape, dtype=torch.float32,
                      device=outs[0].device)
    den = torch.zeros_like(m)
    for out, lse in zip(outs, lses):
        w = torch.exp(lse - shift)
        num = num + w[..., None] * out.float()
        den = den + w
    merged = torch.where(den[..., None] > 0, num / den[..., None],
                         torch.zeros_like(num))
    return merged.to(outs[0].dtype)


def _key_split_block(dist, lp: Params, x, cfg, i: int, positions,
                     stored: Sequence[Any], cache_index):
    """Layer ``i``'s normed self-attention with the cache split over the
    keys of ``model``'s ranks (module docstring): on the stored shards'
    own placements, the output replicated over ``model``."""
    start, _ = _seq_range(dist, stored[0].shape[2], stored[0].placements, 2)
    tp_group = (dist.mesh, _dims(dist)[1])

    def body(w, x, *own):
        import torch.distributed._functional_collectives as funcol

        # all_gather_single where this PyTorch has it (it deprecates
        # all_gather_tensor for it)
        gather = getattr(funcol, "all_gather_single",
                         funcol.all_gather_tensor)
        fault = health.maybe_inject("layers.attention")
        h = layers.rmsnorm(w["ln1"], x, cfg.norm_eps)
        out, lse = layers.attention_key_range(
            w["attn"], h, cfg, positions, cfg.layer_window(i), own,
            cache_index, start)
        outs = gather(out[None].contiguous(), 0, tp_group)
        lses = gather(lse[None].contiguous(), 0, tp_group)
        return layers._finish(w["attn"], merge_key_ranges(
            outs.unbind(0), lses.unbind(0)), fault)

    return replicated_block(dist, lp, x, cfg, ("ln1", "attn"), body,
                            [(s, s.placements) for s in stored])


class KeyRanges(lm.OneDevice):
    """``lm.OneDevice`` with each decode step's cache attention split over
    ``ranges`` equal key ranges of the layer cache, each range attended
    by ``layers.attention_key_range`` on views of the cache and the parts
    merged by ``merge_key_ranges``: what the ``model`` ranks of a mesh
    compute (without the gathers), on one device.  A prefill (attention
    over its fresh K/V alone) runs as on one device."""

    def __init__(self, ranges: int):
        self.ranges = ranges

    def attention(self, lp, h, cfg, i, positions, cache=None,
                  cache_index=None, attend_local=False):
        if cache is None or attend_local:
            return super().attention(lp, h, cfg, i, positions, cache,
                                     cache_index, attend_local)
        fault = health.maybe_inject("layers.attention")
        bufs = lm._layer_cache(cache, i)
        n = -(-bufs[0].shape[2] // self.ranges)
        outs, lses = [], []
        for k0 in range(0, bufs[0].shape[2], n):
            out, lse = layers.attention_key_range(
                lp["attn"], h, cfg, positions, cfg.layer_window(i),
                tuple(b[:, :, k0:k0 + n] for b in bufs), cache_index, k0)
            outs.append(out)
            lses.append(lse)
        return layers._finish(lp["attn"], merge_key_ranges(outs, lses),
                              fault)


def attention_cache_block(dist, lp: Params, x, cfg, i: int, positions,
                          cache: Params, cache_index, attend_local: bool):
    """Layer ``i``'s normed self-attention with the cache, whose stored
    buffers keep the reference's layout (sequence over ``model``) and
    are written in place.  Decode over more than one ``model`` rank:
    split over the keys (``_key_split_block``).  Otherwise replicated
    over ``model``: a prefill over its fresh K/V alone, each rank
    copying its positions' range into its shard; decode where a rank's
    shard is the whole sequence (one ``model`` rank, or a length the
    axis does not divide)."""
    names = [n for n in ("k", "v", "k_scale", "v_scale") if n in cache]
    stored = [cache[n][i] for n in names]
    if not attend_local and tp_size(dist) > 1 and _tp_on(dist, stored[0]):
        return _key_split_block(dist, lp, x, cfg, i, positions, stored,
                                cache_index)
    b = x.shape[0]
    bs = batch_split(dist, b)
    max_len = stored[0].shape[2]
    start, n_pos = _seq_range(dist, max_len, stored[0].placements, 2)

    def body(w, x, *bufs):
        own, whole = bufs[:len(names)], bufs[len(names):]
        if attend_local:
            whole = [torch.zeros(o.shape[:2] + (x.shape[1],) + o.shape[3:],
                                 dtype=o.dtype, device=o.device)
                     for o in own]
        h = layers.rmsnorm(w["ln1"], x, cfg.norm_eps)
        out, _ = layers.attention_apply(
            w["attn"], h, cfg, positions=positions, window=cfg.layer_window(i),
            kv_cache=tuple(whole), cache_index=0 if attend_local
            else cache_index, attend_local=attend_local)
        for o, full in zip(own, whole):
            hi = min(start + n_pos, full.shape[2])
            if hi > start:
                o[:, :, :hi - start] = full[:, :, start:hi]
        return out

    extra = ([(s, s.placements) for s in stored]
             + ([] if attend_local else [(s, act(dist, bs)) for s in stored]))
    return replicated_block(dist, lp, x, cfg, ("ln1", "attn"), body, extra)


def cross_block(dist, lp: Params, x, cfg, i: int, cache: Optional[Params],
                enc_out):
    """The cross-attention residual of layer ``i``, replicated over
    ``model`` (``lm._cross_residual`` on local tensors; with ``enc_out``
    and a cache, the layer's cross K/V written into its shards)."""
    bs = batch_split(dist, x.shape[0])
    extra, has_cache = [], cache is not None and "cross_k" in cache
    if enc_out is not None:
        extra.append((enc_out, act(dist, bs)))
    if has_cache:
        ck, cv = cache["cross_k"][i], cache["cross_v"][i]
        extra += [(ck, ck.placements), (cv, cv.placements)]
        if enc_out is None:
            extra += [(ck, act(dist, bs)), (cv, act(dist, bs))]

    def body(w, x, *rest):
        rest = list(rest)
        enc = rest.pop(0) if enc_out is not None else None
        if not has_cache:
            return lm._cross_residual(w, x, cfg, 0, None, enc)
        own = rest[:2]
        if enc is None:
            return lm._cross_residual(w, x, cfg, 0,
                                      {"cross_k": rest[2][None],
                                       "cross_v": rest[3][None]}, None)
        full = {n: torch.zeros(o.shape[:2] + (enc.shape[1],) + o.shape[3:],
                               dtype=o.dtype, device=o.device)[None]
                for n, o in zip(("cross_k", "cross_v"), own)}
        y = lm._cross_residual(w, x, cfg, 0, full, enc)
        start, n_pos = _seq_range(dist, enc.shape[1],
                                  cache["cross_k"][i].placements, 2)
        for o, n in zip(own, ("cross_k", "cross_v")):
            o.copy_(full[n][0][:, :, start:start + n_pos])
        return y

    return replicated_block(dist, lp, x, cfg, ("ln_cross", "cross"), body,
                            extra)


def encode(dist, params: Params, frames, cfg):
    """The encoder, replicated over ``model``, batch over the data axes."""
    bs = batch_split(dist, frames.shape[0])
    enc = params["encoder"]
    leaves = _flat(enc)
    paths = [p for p, _ in leaves]

    def fn(fr, *rest):
        return (lm.encode({"encoder": _unflat(zip(paths, rest))}, fr, cfg),)

    (out,) = region(dist, fn, [(frames, act(dist, bs))] + [
        (v, gathered(dist, v, keep_tp=False)) for _, v in leaves],
        [act(dist, bs)], tp_region=False, batch_sharded=bs)
    return out


# ---------------------------------------------------------------------------
# The pieces of ``lm``'s layer loop over the mesh.
# ---------------------------------------------------------------------------
def ffn_residual(dist, lp: Params, x, cfg, layout: tuple):
    """(``x`` plus the layer's MLP or MoE block, the block's aux loss as a
    plain 0-d tensor, or 0)."""
    aux = torch.zeros((), dtype=torch.float32,
                      device=x.to_local().device)
    if "ln2" not in lp:
        return x, aux
    if cfg.n_experts:
        y, a = moe.moe_apply_sharded(lp["moe"], x, cfg, dist.mesh,
                                     dist.dp_axes, dist.tp_axis,
                                     norm=lp["ln2"])
        return x + to_layout(y, dist, layout), a.full_tensor()
    return x + to_layout(mlp_block(dist, lp, x, cfg), dist, layout), aux


def stack_views(stacked: Params) -> List[Params]:
    """Per-layer views of DTensor leaves stacked on the layer axis (a
    select on the unsharded leading dim: no communication)."""
    n = stacked["ln1"].shape[0]
    views = {path: v.unbind(0) for path, v in _flat(stacked)}
    return [_unflat((path, vs[i]) for path, vs in views.items())
            for i in range(n)]


def tokens_on(dist, tokens):
    """``tokens`` (B, ...) as a DTensor, batch over the data axes: a plain
    tensor is the global batch, every rank's the same."""
    return _as_dist(tokens, dist.mesh, act(dist, batch_split(
        dist, tokens.shape[0])))


def init_cache(dist, cfg, batch: int, max_len: int, dtype="bfloat16",
               device=None, enc_len: Optional[int] = None) -> Params:
    """``lm.init_cache``'s buffers as DTensors in the cache rules' layout,
    each rank allocating its shard alone."""
    shapes = lm.init_cache(cfg, batch, max_len, dtype, "meta", enc_len)
    sh = rules.cache_shardings(shapes, dist.mesh)
    out: Params = {"index": 0}
    for name, v in shapes.items():
        if name == "index":
            continue
        pls = sh[name].placements
        fill = 1.0 if name.endswith("scale") else 0.0
        buf = zeros_like_sharded(tuple(v.shape), v.dtype, dist.mesh, pls,
                                 device)
        if fill:
            buf.to_local().fill_(fill)
        out[name] = buf
    return out


class Mesh(lm.OneDevice):
    """``lm.OneDevice``'s pieces over ``dist``'s mesh: DTensors in,
    DTensors out, each block a region (above) whose output is put back
    in the residual stream's layout."""

    def __init__(self, dist):
        self.dist = dist

    def tokens(self, tokens):
        return tokens_on(self.dist, tokens)

    def rows(self, t):
        return t[rules.shard_slices(tuple(t.shape), act(
            self.dist, batch_split(self.dist, t.shape[0])),
            self.dist.mesh)]

    def embed(self, params, tokens, cfg):
        b, s = tokens.shape
        return embed(self.dist, params, tokens, cfg,
                     residual(self.dist, cfg, b, s))

    def encode(self, params, frames, cfg):
        return encode(self.dist, params, frames, cfg)

    def init_cache(self, cfg, batch, max_len, dtype, device, enc_len):
        return init_cache(self.dist, cfg, batch, max_len, dtype, device,
                          enc_len)

    def layer_params(self, params):
        return stack_views(params["layers"])

    def prenorm(self, lp, x, cfg):
        return x   # each block's region norms its local input

    def attention(self, lp, h, cfg, i, positions, cache, cache_index,
                  attend_local):
        if cache is None:
            out = attention_block(self.dist, lp, h, cfg, i, positions)
        else:
            out = attention_cache_block(self.dist, lp, h, cfg, i,
                                        positions, cache, cache_index,
                                        attend_local)
        return to_layout(out, self.dist, h.placements)

    def ssm(self, lp, h, cfg, i, cache, new):
        return to_layout(ssm_block(self.dist, lp, h, cfg, i, cache, new),
                         self.dist, h.placements)

    def cross(self, lp, x, cfg, i, cache, enc_out):
        if not cfg.is_encoder_decoder:
            return x
        return to_layout(cross_block(self.dist, lp, x, cfg, i, cache,
                                     enc_out), self.dist, x.placements)

    def ffn(self, lp, x, cfg):
        return ffn_residual(self.dist, lp, x, cfg, x.placements)

    def final_norm(self, params, x, cfg):
        return final_norm(self.dist, params, x, cfg)

    def logits(self, params, x, cfg, last, mask_vocab):
        return unembed(self.dist, params, x, cfg, last, mask_vocab)

    def nll_sum(self, params, x, targets, cfg, chunk):
        return nll_sum(self.dist, params, x, targets, cfg,
                       chunk).to_local()

