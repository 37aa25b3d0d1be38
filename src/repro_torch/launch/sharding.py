"""Sharding rules: parameter/optimizer/batch/cache specs by path.

Twin of ``repro/launch/sharding.py``, with the same rules: Megatron TP
over the ``model`` axis and FSDP (ZeRO-3) over the data axes, by
parameter-path matching:

  embed/lm_head (V, D)         -> (model, dp)     vocab-TP
  wq/wk/wv/w1/w3 (D, F)        -> (dp, model)     column-parallel
  wo/w2 (F, D)                 -> (model, dp)     row-parallel
  moe w1/w3 (E, D, F)          -> (model, dp, -)  expert-parallel + FSDP
  moe w2 (E, F, D)             -> (model, -, dp)
  router / norms / mamba small -> replicated
  stacked layer leading dim L  -> never sharded

A spec is a tuple with one entry per tensor dimension: a mesh-axis name,
a tuple of names, or ``None``, as the reference's ``PartitionSpec``
reads; any axis whose size does not divide its dimension falls back to
replication (``_maybe``).  ``placements`` turns a spec into DTensor
placements, one per mesh dimension.  The ``*_shardings`` functions map a
nested dict of tensors (or anything with ``.shape``/``.ndim``) to a
dict of the same keys holding ``Sharding``s; a path is the keys joined
with ``/``, as the reference's ``_path_str`` joins dict keys, and the
port's parameters keep the reference's keys (``models/bridge.py``).
Optimizer moments live under ``m``/``v`` with the parameter's sub-path
(``optim.AdamWState``), so their paths hold the same substrings as the
reference's; the step count is a host int there, and a 0-d leaf or a
path naming ``step`` is replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

Spec = Tuple[Any, ...]


def _axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of a stand-in whose
    ``.shape`` is already that dict."""
    if isinstance(getattr(mesh, "shape", None), dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _names(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def _maybe(spec: Sequence, shape, mesh) -> Spec:
    """Fall back to replication for any axis that doesn't divide."""
    sizes = _axis_sizes(mesh)
    out = []
    for dim, names in zip(shape, tuple(spec)
                          + (None,) * (len(shape) - len(spec))):
        if names is None:
            out.append(None)
            continue
        size = 1
        for n in _names(names):
            size *= sizes[n]
        out.append(names if dim % size == 0 else None)
    return tuple(out)


def param_pspec(path: str, shape, mesh, dp, tp) -> Spec:
    """The spec of one parameter, by path substring matching."""
    nd = len(shape)
    lead = 1 if "layers" in path and nd >= 2 else 0  # stacked layer dim

    def with_lead(*spec):
        return _maybe((None,) * lead + spec, shape, mesh)

    if "embed" in path or "lm_head" in path:
        return _maybe((tp, dp), shape, mesh)
    if "moe" in path:
        if "router" in path:
            return (None,) * nd
        if path.endswith("w2"):
            return with_lead(tp, None, dp)
        if "shared" in path:
            return with_lead(dp, tp) if path.endswith(("w1", "w3")) \
                else with_lead(tp, dp)
        return with_lead(tp, dp, None)          # moe w1/w3 (E, D, F)
    if "mamba" in path:
        if "x_proj" in path or "z_proj" in path:
            return with_lead(dp, tp)       # column-parallel on d_inner
        if "out_proj" in path:
            return with_lead(tp, dp)       # row-parallel (psum on exit)
        if "bc_proj" in path or "dt_proj" in path:
            return with_lead(dp, None)
        if "conv_x" in path:
            return with_lead(None, tp) if nd >= 2 + lead else \
                with_lead(tp)
        return (None,) * nd
    if path.endswith(("wq", "wk", "wv", "w1", "w3")):
        return with_lead(dp, tp)
    if path.endswith(("wo", "w2")):
        return with_lead(tp, dp)
    return (None,) * nd                         # norms, scalars, biases


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dimension,
    ``Shard(d)`` for the tensor dimension ``d`` whose entry names it,
    else ``Replicate()``.  A tensor dimension named by several axes is
    split over them in the order named (the reference's tuple order)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for n in _names(entry):
            out[mesh.mesh_dim_names.index(n)] = Shard(d)
    return tuple(out)


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a tensor of ``shape`` under
    ``spec`` (every named axis divides its dimension: ``_maybe``)."""
    sizes = _axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        for n in (() if entry is None else _names(entry)):
            dim //= sizes[n]
        out.append(dim)
    return tuple(out)


def shard_slices(shape, pls: tuple, mesh) -> Tuple[slice, ...]:
    """This rank's slice of a tensor of ``shape`` under DTensor
    placements ``pls``: each ``Shard(d)`` cuts dimension ``d`` evenly
    over its mesh dimension at this rank's coordinate there, mesh
    dimensions in order (as DTensor nests them)."""
    from torch.distributed.tensor import Shard

    lo = [0] * len(shape)
    size = list(shape)
    for mdim, pl in enumerate(pls):
        if isinstance(pl, Shard):
            d, n = pl.dim, mesh.size(mdim)
            if size[d] % n:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                                 f"split over {n} ranks")
            size[d] //= n
            lo[d] += mesh.get_local_rank(mdim) * size[d]
    return tuple(slice(a, a + n) for a, n in zip(lo, size))


def local_shape_of(shape, pls: tuple, mesh) -> Tuple[int, ...]:
    """The shape of this rank's shard under placements ``pls``."""
    return tuple(s.stop - s.start for s in shard_slices(shape, pls, mesh))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh: the counterpart of ``NamedSharding``."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _dp_tp(mesh):
    """(dp, tp) as the reference passes them: one dp axis by name, more
    as a tuple, none as None."""
    from repro_torch.launch.mesh import mesh_axes

    dp, tp = mesh_axes(mesh)
    return (dp if len(dp) > 1 else dp[0] if dp else None), tp


def _map(fn, tree, prefix=()):
    """``fn(path, leaf)`` over a nested dict, keeping its keys (a
    ``PackedWeights`` leaf is one leaf)."""
    return {k: _map(fn, v, prefix + (k,)) if isinstance(v, dict)
            else fn("/".join(prefix + (k,)), v) for k, v in tree.items()}


def _ndim(leaf) -> int:
    """Dimensions of a leaf; 0 for a host scalar (a cache's ``index``,
    an optimizer's step count)."""
    return len(getattr(leaf, "shape", ()))


def state_tree(state) -> dict:
    """An ``AdamWState`` as the dict the rules walk (``step``, ``m``,
    ``v``); a dict as it is."""
    return state if isinstance(state, dict) else dict(state._asdict())


def param_shardings(params_shape, mesh):
    """``Sharding`` tree matching a params (shape) tree."""
    dp, tp = _dp_tp(mesh)
    return _map(lambda path, leaf: Sharding(
        mesh, param_pspec(path, tuple(leaf.shape), mesh, dp, tp)),
        params_shape)


def opt_state_shardings(opt_state_shape, mesh):
    """Optimizer state: moments inherit the parameter's spec (their
    paths hold its sub-path); the step and 0-d leaves are replicated."""
    dp, tp = _dp_tp(mesh)

    def one(path, leaf):
        if _ndim(leaf) == 0 or "step" in path:
            return Sharding(mesh, ())
        return Sharding(mesh, param_pspec(path, tuple(leaf.shape), mesh,
                                          dp, tp))

    return _map(one, state_tree(opt_state_shape))


def batch_shardings(batch_shape, mesh):
    """tokens/targets (B, S) -> batch over the dp axes; frames likewise."""
    dp, _ = _dp_tp(mesh)
    return _map(lambda path, leaf: Sharding(
        mesh, _maybe((dp,), tuple(leaf.shape), mesh)), batch_shape)


def cache_shardings(cache_shape, mesh):
    """KV cache (L, B, H, S, D): batch over dp, sequence over model.
    SSM state (L, B, H, N, P): batch over dp only."""
    dp, tp = _dp_tp(mesh)

    def one(path, leaf):
        nd = _ndim(leaf)
        if nd == 0:
            return Sharding(mesh, ())
        shape = tuple(leaf.shape)
        if path.startswith(("k", "v", "cross")) and nd == 5:
            return Sharding(mesh, _maybe((None, dp, None, tp, None), shape,
                                         mesh))
        if path.startswith(("ssm", "conv")):
            return Sharding(mesh, _maybe((None, dp), shape, mesh))
        return Sharding(mesh, (None,) * nd)

    return _map(one, cache_shape)


def logits_sharding(mesh) -> Sharding:
    dp, tp = _dp_tp(mesh)
    return Sharding(mesh, (dp, None, tp))
