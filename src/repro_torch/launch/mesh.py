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

:func:`use_mesh` makes a mesh the ambient one, as ``repro.compat.set_mesh``
does in the JAX package, and :func:`spmd_mesh` gives an LM config the
ambient mesh its SPMD fields ask for.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

_AMBIENT: contextvars.ContextVar = contextvars.ContextVar("mesh",
                                                         default=None)

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


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh of the calls inside the block, as
    ``repro.compat.set_mesh`` does: the LM's activation constraints and
    expert-parallel MoE read it (:func:`spmd_mesh`)."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def current_mesh():
    """The mesh of the innermost :func:`use_mesh` block, or None."""
    return _AMBIENT.get()


def spmd_mesh(cfg) -> Optional[object]:
    """The ambient mesh an LM config's SPMD fields ask for, None for a
    config without them (the one-card path).

    ``act_shard_axes`` names the mesh's batch axes: the mesh must hold them
    and ``"model"``, the product of their sizes must be ``data_axis_size``
    and the size of ``"model"`` ``model_axis_size``.  ``ep_shard_map``
    runs the MoE's dispatch inside those axes, so it needs them named.
    Anything missing or of another size raises ValueError naming it."""
    if cfg.act_shard_axes is None:
        if cfg.ep_shard_map:
            raise ValueError(
                f"{cfg.name}: ep_shard_map dispatches the MoE inside the "
                f"mesh's batch axes, and act_shard_axes names none")
        return None
    mesh = current_mesh()
    ba = tuple(cfg.act_shard_axes)
    if mesh is None:
        raise ValueError(
            f"{cfg.name}: act_shard_axes={ba} shards activations over a "
            f"mesh, and none is ambient; call under launch.mesh.use_mesh")
    sizes = mesh_axis_sizes(mesh)
    missing = [a for a in ba + ("model",) if a not in sizes]
    if missing:
        raise ValueError(f"{cfg.name}: the ambient mesh {sizes} has no "
                         f"axis {missing}")
    data = math.prod(sizes[a] for a in ba)
    if data != cfg.data_axis_size or sizes["model"] != cfg.model_axis_size:
        raise ValueError(
            f"{cfg.name}: the config asks for data_axis_size="
            f"{cfg.data_axis_size} over {ba} and model_axis_size="
            f"{cfg.model_axis_size}; the ambient mesh {sizes} has "
            f"{data} and {sizes['model']}")
    return mesh
