"""Elastic scaling: re-shard a checkpointed training state onto a new mesh,
as ``repro.runtime.elastic``.

Scenario: the job starts on 2 pods (512 cards); a pod is lost -> resume on
256; capacity returns -> grow back.  Checkpoints store logical arrays, so
elasticity is a restore placed by the *new* mesh's shardings plus a
data-pipeline re-split.  :func:`plan_elastic_restart` computes the new mesh
shape and the batch re-split; :func:`reshard_state` places every leaf.

A mesh is a ``DeviceMesh`` over the default process group and a sharding a
:class:`repro_torch.distributed.sharding.NamedSharding`; a placed leaf is a
DTensor.  Every rank of the group calls these functions together (their
placements are collectives).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

from repro_torch import tree as T
from repro_torch.launch.mesh import make_debug_mesh


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    per_host_batch: int


def plan_elastic_restart(n_devices: int, global_batch: int,
                         model_parallel: int = 16) -> ElasticPlan:
    """Choose (data, model) given the surviving device count.

    Keeps model-parallel fixed (weight layouts stay valid) and shrinks the
    data axis; the global batch is kept by raising the per-shard batch.
    """
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"model_parallel={model_parallel}")
    data = n_devices // model_parallel
    # shrink the data axis until it divides the batch (keeps semantics exact)
    while data > 1 and global_batch % data:
        data -= 1
    return ElasticPlan((data, model_parallel), ("data", "model"),
                       global_batch // data)


def make_mesh_from_plan(plan: ElasticPlan, device_type: str = "cuda"):
    """The plan's mesh over the first ``prod(mesh_shape)`` ranks."""
    return make_debug_mesh(plan.mesh_shape, plan.axis_names, device_type)


def _place(a, s):
    from torch.distributed.tensor import DTensor, distribute_tensor
    if s is None:
        return a
    if isinstance(a, DTensor):
        if a.device_mesh == s.mesh:
            return a.redistribute(s.mesh, s.placements)
        a = a.full_tensor()            # another mesh: through the whole
    return distribute_tensor(a, s.mesh, s.placements)


def reshard_state(state: Any, shardings: Any) -> Any:
    """Every leaf of ``state`` placed by the sharding at its position (a
    plain tensor distributed from rank 0's copy, a DTensor redistributed on
    its own mesh or gathered and distributed onto another); logical values
    unchanged.  A ``None`` sharding leaves its leaf as it is."""
    return T.tree_map(_place, state, shardings)
