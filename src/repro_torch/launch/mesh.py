"""Meshes (``repro.launch.mesh``).

``make_production_mesh`` is abstract: axis names and sizes with no
process behind them, which is all rule resolution (``Model.param_pspecs``
and the like) reads. ``make_mesh`` and ``make_host_mesh`` are live: a
``DeviceMesh`` over the ``torch.distributed`` process group, one process
per device. Nothing here touches ``torch.distributed`` at import.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.parallel.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(dict(zip(axes, shape)))


def make_mesh(shape: Sequence[int], axes: Sequence[str], device) -> Mesh:
    """A live mesh over the initialized process group, whose world size is
    the product of ``shape``; process ``r`` sits at the row-major position
    ``r`` of the mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(torch.device(device).type, tuple(shape),
                          mesh_dim_names=tuple(axes))
    return Mesh(dict(zip(axes, shape)), dm)


def make_host_mesh(device=None) -> Mesh:
    """A live 1x1 ("data", "model") mesh on one device: the card unless
    ``device`` says otherwise. Without a process group it starts one of
    world size 1 over an in-process store (NCCL on the card, gloo on the
    CPU); the caller ends it with ``destroy_process_group``."""
    import torch.distributed as dist
    device = torch.device("cuda" if device is None else device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return make_mesh((1, 1), ("data", "model"), device)
