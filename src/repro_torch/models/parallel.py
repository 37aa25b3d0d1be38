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
    A prefill chunk (``lm.prefill_chunk``) takes the same split with its
    S queries (valid length ``cache_index + S - k0``).
  * attention off the page pools (``paged_attention_block``, a paged
    decode step): the pools are plain tensors, every rank holding the
    whole pool, as the reference's page pool is an unsharded array (no
    rule shards it).  The block runs replicated over the whole mesh:
    every row on every rank (its input gathered over the data axes), the
    projections gathered whole, so every rank writes the same fresh K/V
    into its pools and B3 reads the same pages; its output is replicated,
    each rank keeping its rows.  Every rank's pools are so bit-equal
    after every step.
  * MLP: column-parallel ``w1``/``w3``, row-parallel ``w2`` (B1 on the
    local columns), ``Partial`` out; replicated where ``d_ff`` does not
    divide the axis, and for the binary MLP.
  * MoE: ``moe.moe_apply_sharded`` (all-to-all or psum-local).
  * Mamba2 (the reference's headdim-sharded SSD): with d_inner's p-major
    layout a rank's ``model`` shard of ``x_proj``/``z_proj``/``conv_x_*``
    (and row shard of ``out_proj``) is its 1/tp of every head's P rows.
    Each rank computes B, C and dt for every head, runs the SSD (chunked
    or recurrent) on its P rows, and sums the gated norm's squares over
    ``model`` (``SumOver``: one (B, L, 1) float32 all-reduce, whose
    backward all-reduces the gradient); ``out_proj`` row-parallel,
    ``Partial`` out.  The state keeps the rules' layout (replicated over
    ``model``): each rank reads its rows of it, and the new state is
    assembled by one all-gather of the ranks' rows (state and conv tail,
    float32).  Replicated where P does not divide the axis (``ssm_split``).
  * cross attention: the cross cache keeps the rules' layout (encoder
    positions over ``model``).  With the encoder's output (a forward, a
    prefill): split by heads as attention is, a prefill's K/V moved from
    the rank's heads to its positions by one all-to-all.  Decode: split
    over the cached positions as self-attention's cache is (each rank's
    every head over its range, ``lm._cross_key_range``, q from ``wq``
    gathered whole; merged by ``merge_key_ranges``, then ``wo``).
    Replicated where the heads (with the encoder's output) or the encoder
    length (decode) do not divide the axis.
  * the encoder: its layer loop is ``lm.encode``'s, each piece run here:
    self-attention split by heads (``enc_attention_block``), the MLP as
    above, the residual stream's batch over the data axes and replicated
    over ``model``; replicated attention where the heads do not divide.
  At one ``model`` rank each of these runs the one-device code.
  ``Splits`` runs the same splits on one device (the cache attention's
  too), each part through the function a rank's region calls.
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
from repro_torch.models import layers, lm, moe, ssm
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

    def body(h, w):
        if split == "query":
            w["wk"] = w["wk"][:, kvh * dh:(kvh + 1) * dh]
            w["wv"] = w["wv"][:, kvh * dh:(kvh + 1) * dh]
        return lm.ONE_DEVICE.attention({"attn": w}, h, loc, i, positions)

    return _heads_block(dist, x, lp["ln1"], p, cfg, body,
                        whole=("wk", "wv") if split == "query" else ())


def replicated_block(dist, lp: Params, x, cfg, keys: Sequence[str], body,
                     extra: Sequence[Tuple[Any, tuple]] = (),
                     n_out: int = 1, whole_rows: bool = False):
    """``body(local lp, local x, *local extra)`` with every weight under
    ``keys`` gathered whole and ``x`` replicated over ``model``: every
    rank of a ``model`` group computes the same output.  ``whole_rows``:
    ``x`` replicated over the data axes too, so every rank of the mesh
    computes every row."""
    b = x.shape[0]
    bs = batch_split(dist, b) and not whole_rows
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


class SumOver(torch.autograd.Function):
    """A float sum over ``group``'s ranks (an all-reduce) whose backward
    all-reduces the gradient too: each rank uses the sum for its own
    part, so the sum's gradient is the ranks' gradients summed."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as funcol

        ctx.group = group
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(
            g.contiguous(), "sum", ctx.group)), None


def _gather(x, group):
    """``x`` from every rank of ``group``, stacked on a new leading dim in
    rank order (all_gather_single where this PyTorch has it: it
    deprecates all_gather_tensor for it)."""
    import torch.distributed._functional_collectives as funcol

    gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
    return gather(x[None].contiguous(), 0, group)


def _tp_group(dist):
    return (dist.mesh, _dims(dist)[1])


def ssm_split(dist, cfg, p: Params) -> bool:
    """Does layer ``p``'s Mamba2 block split over ``model`` (the head
    dimension divides it, and the rules shard the block's d_inner
    leaves over it)?"""
    return ssm.splits(cfg, tp_size(dist)) and all(
        _tp_on(dist, p[n]) for n in ssm.PART_LEAVES if n != "norm")


def ssm_block(dist, lp: Params, x, cfg, i: int, cache=None, new=None):
    """Layer ``i``'s normed Mamba2 block (module docstring): split over
    the head dimension of ``model``'s ranks (``ssm_split``), ``Partial``
    out; else replicated over ``model`` (``lm.OneDevice.ssm``).  With a
    ``cache`` (DTensors), the new state is written into ``new``'s (the
    caller's fresh buffers') local shards in place."""
    bs = batch_split(dist, x.shape[0])
    bufs = [] if cache is None else (
        [cache[n][i] for n in lm.SSM_KEYS] + [new[n][i] for n in lm.SSM_KEYS])
    p = lp["mamba"]
    if not ssm_split(dist, cfg, p):
        def body(w, x, *state):
            h = layers.rmsnorm(w["ln1"], x, cfg.norm_eps)
            if not state:
                return lm.ONE_DEVICE.ssm(w, h, cfg, i)
            ssm_s, conv_s, new_ssm, new_conv = state
            return lm.ONE_DEVICE.ssm(
                w, h, cfg, 0, {"ssm": ssm_s[None], "conv": conv_s[None]},
                {"ssm": new_ssm[None], "conv": new_conv[None]})

        return replicated_block(dist, lp, x, cfg, ("ln1", "mamba"), body,
                                [(s, act(dist, bs)) for s in bufs])
    t = _dt()
    tp, r, group = tp_size(dist), tp_rank(dist), _tp_group(dist)
    names = sorted(p)

    def fn(x, ln1, *rest):
        w = ssm.param_part(dict(zip(names, rest)), cfg, r, tp, ("norm",))
        state = rest[len(names):]
        h = layers.rmsnorm(ln1, x, cfg.norm_eps)
        gated, sumsq, new_state = ssm.mamba_part(
            w, h, cfg, ssm.state_part(state[:2], cfg, r, tp) if state
            else None)
        out = ssm.mamba_part_out(w, gated, SumOver.apply(sumsq, group), cfg)
        if state:
            _assemble_state(new_state, state[2:], cfg, group)
        return (out,)

    inputs = ([(x, act(dist, bs)), (lp["ln1"], gathered(dist, lp["ln1"]))]
              + [(p[n], gathered(dist, p[n])) for n in names]
              + [(s, act(dist, bs)) for s in bufs])
    (out,) = region(dist, fn, inputs, [act(dist, bs, t.Partial())],
                    tp_region=True, batch_sharded=bs)
    return out


def _assemble_state(part, new, cfg, group) -> None:
    """Write the whole new state into ``new`` (this rank's (state, conv
    tail) buffers, replicated over ``model``) from every rank's part
    (``ssm.state_part``'s layout): one all-gather of the parts' state
    rows and conv-tail x columns, float32."""
    s, tail = part
    rows, w = s.shape[0], tail.shape[-1] - 2 * cfg.ssm_state
    flat = torch.cat([s.reshape(rows, -1),
                      tail[..., :w].reshape(rows, -1)], dim=1)
    n = s[0].numel()
    parts = [(a[:, :n].reshape(s.shape),
              torch.cat([a[:, n:].reshape(tail.shape[:-1] + (w,)),
                         tail[..., w:]], dim=-1))
             for a in _gather(flat, group).unbind(0)]
    for buf, whole in zip(new, ssm.assemble_state(parts, cfg)):
        buf.copy_(whole)


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
    group = _tp_group(dist)

    def body(w, x, *own):
        fault = health.maybe_inject("layers.attention")
        h = layers.rmsnorm(w["ln1"], x, cfg.norm_eps)
        out, lse = layers.attention_key_range(
            w["attn"], h, cfg, positions, cfg.layer_window(i), own,
            cache_index, start)
        return layers._finish(w["attn"], merge_key_ranges(
            _gather(out, group).unbind(0), _gather(lse, group).unbind(0)),
            fault)

    return replicated_block(dist, lp, x, cfg, ("ln1", "attn"), body,
                            [(s, s.placements) for s in stored])


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


def paged_attention_block(dist, lp: Params, x, cfg, i: int, positions,
                          pages) -> Any:
    """Layer ``i``'s normed self-attention off the page pools (``pages``,
    an ``lm.Pages`` of plain tensors, every rank's the same), replicated
    over the whole mesh (module docstring): every rank computes every
    row and writes the same K/V into its pools.  Output replicated."""
    return replicated_block(
        dist, lp, x, cfg, ("ln1", "attn"),
        lambda w, x: lm.ONE_DEVICE.paged_attention(
            w, layers.rmsnorm(w["ln1"], x, cfg.norm_eps), cfg, i, positions,
            pages), whole_rows=True)


def _head_split(dist, cfg, p: Params) -> bool:
    """Does a bidirectional attention block (the encoder's, or cross
    attention to the encoder's output) split by heads over ``model``:
    more than one rank, Q and KV heads both dividing it, and its
    projections sharded over it by the rules?"""
    tp = tp_size(dist)
    return tp > 1 and _heads_split(cfg, tp) == "heads" and all(
        _tp_on(dist, p[n]) for n in ("wq", "wk", "wv", "wo"))


def _local_heads(cfg, parts: int):
    """``cfg`` with 1/``parts`` of its Q and KV heads: a part's."""
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // parts,
                               n_kv_heads=cfg.n_kv_heads // parts)


def _heads_block(dist, x, norm, p: Params, cfg, body,
                 extra: Sequence[Tuple[Any, tuple]] = (),
                 whole: Sequence[str] = ()):
    """``body(h, w, *extra)`` over the mesh: ``h`` the local ``x``
    normed by ``norm``, ``w`` each projection of ``p`` on this rank's
    ``model`` shard (column-parallel ``wq``/``wk``/``wv``, row-parallel
    ``wo``) but those named in ``whole``, gathered whole; ``extra`` local
    too.  Its output ``Partial`` over ``model``."""
    t = _dt()
    bs = batch_split(dist, x.shape[0])
    names = sorted(p)

    def fn(x, norm, *rest):
        w = dict(zip(names, rest))
        return (body(layers.rmsnorm(norm, x, cfg.norm_eps), w,
                     *rest[len(names):]),)

    inputs = ([(x, act(dist, bs)), (norm, gathered(dist, norm))]
              + [(p[n], gathered(dist, p[n], keep_tp=n not in whole))
                 for n in names] + list(extra))
    (out,) = region(dist, fn, inputs, [act(dist, bs, t.Partial())],
                    tp_region=True, batch_sharded=bs)
    return out


def enc_attention_block(dist, lp: Params, x, cfg, positions):
    """An encoder layer's normed self-attention (``lm._enc_attention``):
    split by heads over ``model`` (``_head_split``), ``Partial`` out; else
    replicated over ``model``."""
    if not _head_split(dist, cfg, lp["attn"]):
        return replicated_block(
            dist, lp, x, cfg, ("ln1", "attn"),
            lambda w, x: lm._enc_attention(
                w["attn"], layers.rmsnorm(w["ln1"], x, cfg.norm_eps), cfg,
                positions))
    loc = _local_heads(cfg, tp_size(dist))
    return _heads_block(dist, x, lp["ln1"], lp["attn"], cfg,
                        lambda h, w: lm._enc_attention(w, h, loc, positions))


def _heads_to_positions(kv, own, group) -> None:
    """Write a prefill's cross K/V, this rank's heads over every encoder
    position (each (B, Hkv/tp, S_enc, D)), into ``own``: this rank's
    shards of the layer's cross cache, every head over its range of the
    positions.  One all-to-all over ``group`` (rank j's slice of the
    positions to rank j), of the cache's dtype."""
    import torch.distributed._functional_collectives as funcol

    b, hl, se, d = kv[0].shape
    tp = se // own[0].shape[2]
    send = torch.stack(kv).to(own[0].dtype).reshape(
        2, b, hl, tp, se // tp, d).permute(3, 0, 1, 2, 4, 5).contiguous()
    got = funcol.wait_tensor(funcol.all_to_all_single(send, None, None,
                                                      group))
    whole = got.permute(1, 2, 0, 3, 4, 5).reshape(2, b, tp * hl,
                                                   se // tp, d)
    for o, w in zip(own, whole.unbind(0)):
        o.copy_(w)


def _cross_key_split(dist, lp: Params, x, cfg, stored):
    """Decode's cross attention with the layer's cross cache split over
    the encoder positions of ``model``'s ranks: each rank attends every
    head over its range (q from ``wq`` gathered whole), the ranks'
    (output, log-sum-exp) pairs are all-gathered and merged
    (``merge_key_ranges``) in rank order, then ``wo``: the output
    replicated over ``model``."""
    group = _tp_group(dist)
    sub = {"ln_cross": lp["ln_cross"],
           "cross": {n: lp["cross"][n] for n in ("wq", "wo")}}

    def body(w, x, ck, cv):
        hc = layers.rmsnorm(w["ln_cross"], x, cfg.norm_eps)
        out, lse = lm._cross_key_range(w["cross"], hc, cfg, ck, cv)
        return lm._cross_out(w["cross"], merge_key_ranges(
            _gather(out, group).unbind(0), _gather(lse, group).unbind(0)))

    return replicated_block(dist, sub, x, cfg, ("ln_cross", "cross"), body,
                            [(s, s.placements) for s in stored])


def cross_block(dist, lp: Params, x, cfg, i: int, cache: Optional[Params],
                enc_out):
    """``x`` plus layer ``i``'s cross-attention residual (module
    docstring), in ``x``'s layout.  The cross cache keeps the rules'
    layout (encoder positions over ``model``).  With ``enc_out``: split
    by heads where ``_head_split`` allows and the cache (if any) is
    sharded over ``model``, a prefill's K/V moved from heads to positions
    (``_heads_to_positions``).  Decode: split over the cached encoder
    positions where the cache is sharded over more than one ``model``
    rank (``_cross_key_split``).  Otherwise replicated over ``model``
    (``lm._cross_residual`` on local tensors; a prefill writing its
    positions' range into each rank's shards)."""
    bs = batch_split(dist, x.shape[0])
    has_cache = cache is not None and "cross_k" in cache
    stored = [cache[n][i] for n in lm.CROSS_KEYS] if has_cache else []
    sharded = tp_size(dist) > 1 and has_cache and _tp_on(dist, stored[0])
    if enc_out is None and sharded:
        y = _cross_key_split(dist, lp, x, cfg, stored)
        return x + to_layout(y, dist, x.placements)
    if (enc_out is not None and _head_split(dist, cfg, lp["cross"])
            and (sharded or not has_cache)):
        group, loc = _tp_group(dist), _local_heads(cfg, tp_size(dist))

        def body(hc, w, enc, *own):
            y, kv = lm._cross_prefill(w, hc, enc, loc)
            if own:
                _heads_to_positions(kv, own, group)
            return y

        y = _heads_block(dist, x, lp["ln_cross"], lp["cross"], cfg, body,
                         [(enc_out, act(dist, bs))]
                         + [(s, s.placements) for s in stored])
        return x + to_layout(y, dist, x.placements)
    extra = []
    if enc_out is not None:
        extra.append((enc_out, act(dist, bs)))
    if has_cache:
        extra += [(s, s.placements) for s in stored]
        if enc_out is None:
            extra += [(s, act(dist, bs)) for s in stored]

    def rep(w, x, *rest):
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
                for n, o in zip(lm.CROSS_KEYS, own)}
        y = lm._cross_residual(w, x, cfg, 0, full, enc)
        start, n_pos = _seq_range(dist, enc.shape[1], stored[0].placements,
                                  2)
        for o, n in zip(own, lm.CROSS_KEYS):
            o.copy_(full[n][0][:, :, start:start + n_pos])
        return y

    return to_layout(replicated_block(dist, lp, x, cfg,
                                      ("ln_cross", "cross"), rep, extra),
                     dist, x.placements)


# ---------------------------------------------------------------------------
# The splits on one device.
# ---------------------------------------------------------------------------
def head_part(p: Params, cfg, r: int, parts: int) -> Params:
    """Part ``r`` of ``parts``' heads of an attention block's projections
    (views): the column ranges of ``wq``/``wk``/``wv`` and the row range
    of ``wo`` that a ``model`` rank's shards hold under the rules."""
    q, kv = cfg.q_dim // parts, cfg.kv_dim // parts
    out = dict(p)
    out["wq"] = p["wq"][:, r * q:(r + 1) * q]
    out["wk"] = p["wk"][:, r * kv:(r + 1) * kv]
    out["wv"] = p["wv"][:, r * kv:(r + 1) * kv]
    out["wo"] = p["wo"][r * q:(r + 1) * q]
    return out


def _summed(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The parts of a ``Partial`` output summed in part order, in
    float32, in their dtype."""
    total = parts[0].float()
    for y in parts[1:]:
        total = total + y.float()
    return total.to(parts[0].dtype)


class Splits(lm.OneDevice):
    """``lm.OneDevice`` with the mesh's splits run on one device, each
    part through the per-part function a ``model`` rank's region calls,
    on slices of the whole tensors (without the gathers): decode's cache
    attention over ``keys`` equal key ranges of the layer cache
    (``layers.attention_key_range`` on views of the cache, merged by
    ``merge_key_ranges``); the Mamba2 block over ``ssm``
    ranges of the head dimension (``ssm.mamba_part``, the norm's sums of
    squares summed, the parts' outputs summed, the state assembled); the
    encoder's self-attention, and cross attention to the encoder's
    output, over ``heads`` ranges of the heads (``lm._enc_attention``,
    ``lm._cross_prefill``; outputs summed); decode's cross attention over
    ``cross`` ranges of the cached encoder positions
    (``lm._cross_key_range``, merged by ``merge_key_ranges``).  A
    prefill's self-attention (over its fresh K/V alone) runs as on one
    device, and so does a split over one part, or over a count that does
    not divide its dimension (``ssm.splits``, ``_heads_split``, the
    encoder length; the cache's last range may be shorter)."""

    def __init__(self, keys: int = 1, ssm: int = 1, heads: int = 1,
                 cross: int = 1):
        self.keys, self.ssm_parts = keys, ssm
        self.heads, self.cross_parts = heads, cross

    def attention(self, lp, h, cfg, i, positions, cache=None,
                  cache_index=None, attend_local=False):
        if cache is None or attend_local or self.keys < 2:
            return super().attention(lp, h, cfg, i, positions, cache,
                                     cache_index, attend_local)
        fault = health.maybe_inject("layers.attention")
        bufs = lm._layer_cache(cache, i)
        n = -(-bufs[0].shape[2] // self.keys)
        outs, lses = [], []
        for k0 in range(0, bufs[0].shape[2], n):
            out, lse = layers.attention_key_range(
                lp["attn"], h, cfg, positions, cfg.layer_window(i),
                tuple(b[:, :, k0:k0 + n] for b in bufs), cache_index, k0)
            outs.append(out)
            lses.append(lse)
        return layers._finish(lp["attn"], merge_key_ranges(outs, lses),
                              fault)

    def _heads_divide(self, cfg) -> bool:
        return self.heads > 1 and _heads_split(cfg, self.heads) == "heads"

    def ssm(self, lp, h, cfg, i, cache=None, new=None):
        n = self.ssm_parts
        if not ssm.splits(cfg, n):
            return super().ssm(lp, h, cfg, i, cache, new)
        state = None if cache is None else (cache["ssm"][i],
                                            cache["conv"][i])
        ws = [ssm.param_part(lp["mamba"], cfg, r, n) for r in range(n)]
        parts = [ssm.mamba_part(w, h, cfg, None if state is None
                                else ssm.state_part(state, cfg, r, n))
                 for r, w in enumerate(ws)]
        sumsq = parts[0][1]
        for _, sq, _ in parts[1:]:
            sumsq = sumsq + sq
        if state is not None:
            new["ssm"][i], new["conv"][i] = ssm.assemble_state(
                [st for _, _, st in parts], cfg)
        return _summed([ssm.mamba_part_out(w, g, sumsq, cfg)
                        for w, (g, _, _) in zip(ws, parts)])

    def enc_attention(self, lp, x, cfg, positions):
        if not self._heads_divide(cfg):
            return super().enc_attention(lp, x, cfg, positions)
        n, loc = self.heads, _local_heads(cfg, self.heads)
        h = layers.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        return _summed([lm._enc_attention(head_part(lp["attn"], cfg, r, n),
                                          h, loc, positions)
                        for r in range(n)])

    def cross(self, lp, x, cfg, i, cache, enc_out):
        has_cache = cache is not None and "cross_k" in cache
        if enc_out is not None and self._heads_divide(cfg):
            n, loc = self.heads, _local_heads(cfg, self.heads)
            hc = layers.rmsnorm(lp["ln_cross"], x, cfg.norm_eps)
            parts = [lm._cross_prefill(head_part(lp["cross"], cfg, r, n),
                                       hc, enc_out, loc) for r in range(n)]
            if has_cache:
                for j, name in enumerate(lm.CROSS_KEYS):
                    cache[name][i] = torch.cat(
                        [kv[j] for _, kv in parts], dim=1).to(
                            cache[name].dtype)
            return x + _summed([y for y, _ in parts])
        n = self.cross_parts
        if (enc_out is not None or not has_cache or n < 2
                or cache["cross_k"].shape[3] % n):
            return super().cross(lp, x, cfg, i, cache, enc_out)
        hc = layers.rmsnorm(lp["ln_cross"], x, cfg.norm_eps)
        ck, cv = cache["cross_k"][i], cache["cross_v"][i]
        w = ck.shape[2] // n
        pairs = [lm._cross_key_range(lp["cross"], hc, cfg,
                                     ck[:, :, r * w:(r + 1) * w],
                                     cv[:, :, r * w:(r + 1) * w])
                 for r in range(n)]
        return x + lm._cross_out(lp["cross"], merge_key_ranges(
            [o for o, _ in pairs], [s for _, s in pairs]))


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

    def paged_attention(self, lp, h, cfg, i, positions, pages):
        return to_layout(paged_attention_block(self.dist, lp, h, cfg, i,
                                               positions, pages),
                         self.dist, h.placements)

    def ssm(self, lp, h, cfg, i, cache, new):
        return to_layout(ssm_block(self.dist, lp, h, cfg, i, cache, new),
                         self.dist, h.placements)

    def enc_attention(self, lp, x, cfg, positions):
        return to_layout(enc_attention_block(self.dist, lp, x, cfg,
                                             positions),
                         self.dist, x.placements)

    def cross(self, lp, x, cfg, i, cache, enc_out):
        if not cfg.is_encoder_decoder:
            return x
        return cross_block(self.dist, lp, x, cfg, i, cache, enc_out)

    def ffn(self, lp, x, cfg):
        return ffn_residual(self.dist, lp, x, cfg, x.placements)

    def final_norm(self, params, x, cfg):
        return final_norm(self.dist, params, x, cfg)

    def logits(self, params, x, cfg, last, mask_vocab):
        return unembed(self.dist, params, x, cfg, last, mask_vocab)

    def nll_sum(self, params, x, targets, cfg, chunk):
        return nll_sum(self.dist, params, x, targets, cfg,
                       chunk).to_local()

