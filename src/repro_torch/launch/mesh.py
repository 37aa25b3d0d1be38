"""Production mesh construction on ``torch.distributed``.

Twin of ``repro/launch/mesh.py``: meshes are built by functions, never
at import, over the default process group the caller initialized (an
NCCL or gloo group of real ranks, or the dry-run's ``"fake"`` group of
256 or 512).  ``init_device_mesh`` makes the mesh's per-axis subgroups.
"""
from __future__ import annotations

from typing import Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type(device_type: str) -> str:
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    return device_type


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 ``("data", "model")`` over 256 ranks, or 2x16x16 ``("pod",
    "data", "model")`` over 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)


def make_test_mesh(data: int = 1, model: int = 1,
                   device_type: str = "cuda") -> DeviceMesh:
    """A ``(data, model)`` mesh over the process group's ranks."""
    n = dist.get_world_size()
    if data * model != n:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} "
                         f"ranks, the process group has {n}")
    return init_device_mesh(_device_type(device_type), (data, model),
                            mesh_dim_names=("data", "model"))


def mesh_axes(mesh: DeviceMesh) -> Tuple[Tuple[str, ...], str]:
    """(dp_axes, tp_axis) for any of our meshes."""
    tp = "model"
    return tuple(n for n in mesh.mesh_dim_names if n != tp), tp


def axis_size(mesh: DeviceMesh, names) -> int:
    """Ranks along the mesh axis ``names`` (a name or a tuple of names)."""
    names = names if isinstance(names, tuple) else (names,)
    size = 1
    for n in names:
        size *= mesh.size(mesh.mesh_dim_names.index(n))
    return size
