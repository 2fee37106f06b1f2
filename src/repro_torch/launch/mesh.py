"""Production mesh definitions (the reference's `repro.launch.mesh`), as
torch DeviceMeshes with the reference's shapes and axis names.

Single pod slice: 256 ranks as (16, 16) = ("data", "model").
Multi-pod:        2 pods x 256   = (2, 16, 16) = ("pod", "data", "model").

Functions, not module constants: importing this module touches no process
group. The process group must be initialized first
(`launch.distributed.initialize`, or a fake one for the dry-run) with at
least as many ranks as the mesh; when it has more, the first prod(shape)
ranks form the mesh. Meshes are on the card ("cuda") unless the caller
asks for "cpu" (gloo).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _mesh(shape, axes, device_type):
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"mesh {shape} needs an initialized process "
                           "group (launch.distributed.initialize)")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, have {world}")
    if world == n:
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """Tiny mesh with the same axis names for fast iteration/tests."""
    shape = (2, 2, 2) if multi_pod else (2, 2)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)
