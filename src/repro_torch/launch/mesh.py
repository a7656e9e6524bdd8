"""Production and local meshes as torch `DeviceMesh`es.

Mirrors `repro/launch/mesh.py`.  A mesh spans the ranks of the process
group this process has initialized: the production meshes need 256 or
512 of them (one a device), and `make_production_mesh` raises on any
other world size rather than build a smaller mesh.  `make_local_mesh` is
the reference launcher's non-production mesh, (world size, 1) over
``("data", "model")``: (1, 1) on one card, where it first creates a
one-rank group from an in-process store if none exists (or, under
``torchrun``, the group its environment describes).
`destroy_process_group` tears down whatever group is initialized.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

__all__ = ["MESH_SHAPES", "make_production_mesh", "make_local_mesh", "destroy_process_group",
           "mesh_device"]

MESH_SHAPES = {
    False: ((16, 16), ("data", "model")),  # one pod: 256 devices
    True: ((2, 16, 16), ("pod", "data", "model")),  # two pods: 512 devices
}


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The (16, 16) or (2, 16, 16) mesh over the initialized process group,
    whose world size must equal the mesh's size."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = MESH_SHAPES[multi_pod]
    need, world = math.prod(shape), _world_size()
    if world != need:
        raise RuntimeError(
            f"the {'x'.join(map(str, shape))} production mesh needs {need} ranks, one a "
            f"device; the process group has {world} (initialize one of {need} ranks "
            "first)")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(device_type: str = "cuda"):
    """(world size, 1) over ``("data", "model")``.  Without an initialized
    process group: the one ``torchrun`` describes in the environment
    (``WORLD_SIZE`` > 1; NCCL when each rank has a card of its own, else
    gloo, which also takes CUDA tensors where ranks share a card), else a
    one-rank group (gloo, in-process store)."""
    import os

    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world > 1:
            own_card = device_type == "cuda" and torch.cuda.device_count() >= world
            dist.init_process_group("nccl" if own_card else "gloo", init_method="env://")
        else:
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(device_type, (_world_size(), 1), mesh_dim_names=("data", "model"))


def mesh_device(mesh) -> torch.device:
    """The device of this rank's slice of ``mesh``: on a ``"cuda"`` mesh
    this rank's card (`device.local_card`: ``LOCAL_RANK``'s on a host with
    several, ``cuda:0`` where ranks share one), else the mesh's device
    type."""
    if mesh.device_type == "cuda":
        from ..device import local_card

        return torch.device("cuda", local_card())
    return torch.device(mesh.device_type)


def destroy_process_group() -> None:
    """Destroy the initialized process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()
