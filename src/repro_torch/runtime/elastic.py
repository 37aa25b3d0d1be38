"""Elastic scaling: recompute the mesh from survivors and reshard state.

Twin of ``repro/runtime/elastic.py``.  When ranks die (or join), the
coordinator:
  1. picks the largest (data x model) grid over the surviving ranks
     subject to the arch's TP-divisibility constraints,
  2. rebuilds the placements from the same path rules
     (``launch/sharding.py``) on a ``DeviceMesh`` over those ranks,
  3. reshards the live (or checkpoint-restored) state: a DTensor is
     redistributed, a plain tensor (a whole copy, every rank's the same)
     is cut into this rank's shard.

Batches are a pure function of (seed, step) (``data/pipeline.py``) and
the rules are axis-name based, so resuming on the new mesh is exact up
to the order of reductions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import torch

from repro_torch.launch import sharding as shard_rules


def largest_grid(n_devices: int, max_model: int,
                 model_divisors: Sequence[int]) -> tuple:
    """(data, model) maximizing used devices (ties -> larger model).

    ``model_divisors``: candidate TP sizes, e.g. (16, 8, 4, 2, 1)
    filtered by the arch's dims.
    """
    if n_devices < 1:
        raise ValueError(
            f"cannot plan a mesh over {n_devices} surviving devices")
    best = (n_devices, 1)
    best_used = n_devices
    for model in sorted(set(model_divisors), reverse=True):
        if model > max_model or model > n_devices:
            continue
        data = n_devices // model
        used = data * model
        if used > best_used or (used == best_used and model > best[1]):
            best, best_used = (data, model), used
    return best


@dataclasses.dataclass
class ReshardPlan:
    new_mesh: Any
    param_shardings: Any
    opt_shardings: Any = None
    cache_shardings: Any = None


def _ranks_and_type(surviving: Sequence):
    """Ranks of the default group and the mesh's device type: an int is a
    rank; a ``torch.device`` (or its name) stands for the rank of its
    position in the list, its type the mesh's."""
    ranks, types = [], set()
    for i, d in enumerate(surviving):
        if isinstance(d, int):
            ranks.append(d)
        else:
            ranks.append(i)
            types.add(torch.device(d).type)
    if len(types) > 1:
        raise ValueError(f"surviving devices of several types: {types}")
    return ranks, (types.pop() if types else "cuda")


def plan_remesh(
    surviving: List,
    params_shape,
    opt_shape=None,
    model_divisors: Sequence[int] = (16, 8, 4, 2, 1),
    max_model: int = 16,
    cache_shape=None,
    device_type: Optional[str] = None,
) -> ReshardPlan:
    """Plan the survivors' mesh and placements for every state family.

    ``surviving`` lists ranks of the default process group (or devices,
    see ``_ranks_and_type``); every rank of the group calls this (a
    mesh's subgroups are made collectively).  ``opt_shape`` is optional
    so inference restarts (``Engine.restore``) can plan without
    optimizer state; ``cache_shape`` (a cache tree, tensors or shapes)
    additionally yields the placements the ``Checkpointer`` restores a
    snapshot's cache onto.
    """
    from torch.distributed.device_mesh import DeviceMesh

    ranks, dev_type = _ranks_and_type(surviving)
    data, model = largest_grid(len(ranks), max_model, model_divisors)
    grid = torch.tensor(ranks[:data * model]).reshape(data, model)
    mesh = DeviceMesh(device_type or dev_type, grid,
                      mesh_dim_names=("data", "model"))
    return ReshardPlan(
        new_mesh=mesh,
        param_shardings=shard_rules.param_shardings(params_shape, mesh),
        opt_shardings=(shard_rules.opt_state_shardings(opt_shape, mesh)
                       if opt_shape is not None else None),
        cache_shardings=(shard_rules.cache_shardings(cache_shape, mesh)
                         if cache_shape is not None else None),
    )


def place(x, sh: shard_rules.Sharding):
    """One leaf onto its sharding: a DTensor redistributed, a tensor every
    rank holds whole cut to this rank's slice, which alone moves to the
    mesh's device type; a host scalar kept."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import parallel

    if isinstance(x, DTensor):
        return x.redistribute(sh.mesh, sh.placements)
    if not torch.is_tensor(x):
        return x
    dev = None if x.device.type == sh.mesh.device_type \
        else sh.mesh.device_type
    return parallel.from_global(x, sh.mesh, sh.placements, device=dev)


def reshard(state, shardings):
    """Every leaf of ``state`` (a nested dict) onto its sharding."""
    return {k: reshard(v, shardings[k]) if isinstance(v, dict)
            else place(v, shardings[k]) for k, v in state.items()}
