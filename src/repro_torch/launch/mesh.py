"""Production mesh builders, as ``repro.launch.mesh``.

Single pod: 16 x 16 = 256 devices, axes ("data", "model").  Multi-pod: 2 x
16 x 16 = 512, axes ("pod", "data", "model"): "pod" is pure data
parallelism between pods with gradient compression (``optim/compress.py``),
"data" FSDP and batch inside a pod, "model" tensor and expert parallel.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
default process group, which the caller sets up first: NCCL across cards,
or the fake process group on the host (``launch/dryrun.py``), where a
512-rank world costs nothing and collectives do nothing.  The card is the
default device type; the tests pass ``device_type="cpu"``.  Functions, not
module constants: importing this module touches no process group.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

POD_SHAPE, POD_AXES = (16, 16), ("data", "model")
MULTI_POD_SHAPE, MULTI_POD_AXES = (2, 16, 16), ("pod", "data", "model")


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str):
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, found {world} -- run under "
            f"launch/dryrun.py (a fake process group of 512 ranks) or on a "
            f"pod")
    if world > n:
        # init_device_mesh spans the whole world; a smaller mesh takes
        # the first n ranks, as the JAX package takes the first n devices
        return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                          mesh_dim_names=axes)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    if multi_pod:
        return _mesh(MULTI_POD_SHAPE, MULTI_POD_AXES, device_type)
    return _mesh(POD_SHAPE, POD_AXES, device_type)


def make_debug_mesh(shape: Sequence[int] = (2, 2),
                    axes: Sequence[str] = ("data", "model"),
                    device_type: str = "cuda"):
    """A small mesh over the first ranks of the world (the tests' fake or
    gloo group, one card's NCCL group)."""
    return _mesh(tuple(shape), tuple(axes), device_type)


def batch_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (pod included when present)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
