"""A registry cell's step cost, counted on the meta device: the port's
counterpart of ``repro.launch.hlo_cost``.

The JAX package compiles each cell and parses the HLO text for dot FLOPs
(times each ``while`` loop's trip count) and collective bytes.  The port
emits no HLO: it runs the cell's step once on ``device="meta"`` tensors
(shapes and dtypes, no bytes) and counts what runs.

* **FLOPs a step**: ``2 * M * N * K`` per matrix product (``mm``, ``bmm``,
  ``addmm``, ...), the convention of ``parse_hlo``'s dots, over forward,
  backward and optimizer.  The layers are a Python loop, so every layer
  counts and no trip count is needed.  The kernels' meta branches give
  their outputs' shapes (the gathers and sums by id do no products); flash
  attention's is the plain version's ops on meta, so its products count as
  the JAX package's einsums do (full S x S).  Plan builders keep every lane
  on meta: the padded capacity, the shape JAX compiles.  A step on plain
  tensors (every cell but an LM ``opt`` cell) is counted whole, for the
  global batch, by ``torch.utils.flop_counter.FlopCounterMode``.  An LM
  ``opt`` cell's step runs on DTensors placed by the cell's shardings under
  ``launch.mesh.use_mesh`` (its config's SPMD fields ask for the mesh): its
  FLOPs are rank 0's, the ops one device runs once DTensor has split each
  op into its local work -- the partitioned program's count, as the JAX
  package's HLO of an SPMD step gives it.
* **Collective bytes** (DTensor steps): the operand bytes of every
  collective rank 0 issues (``torch.distributed.tensor.debug.
  CommDebugMode`` sees them), by kind (``all_gather_into_tensor``,
  ``all_reduce``, ``reduce_scatter_tensor``, ``all_to_all_single``, ...),
  as ``hlo_cost`` sums operand bytes by collective type.  A step on plain
  tensors issues none it could count: ``None`` with :data:`NOT_COUNTED`
  as the reason, never 0.
* **Argument and output bytes a device**: each leaf's rank-0 local shape
  under its sharding (:mod:`repro_torch.distributed.sharding`), from
  ``distribute_tensor`` of a meta tensor on the mesh -- the fake process
  group's rank 0 in the dry run.
* **Temporary memory**: ``None`` (no compiler's buffer assignment to read).

A step that cannot run on meta leaves ``flops`` ``None`` and its
exception's text in ``flops_error``.
"""
from __future__ import annotations

import collections
import contextlib
import math
import time
from typing import Any, Dict, Optional

from repro_torch import tree as T
from repro_torch.distributed.sharding import (out_shardings_for_cell,
                                              shardings_for_cell)

NOT_COUNTED = ("collective bytes not counted: the step runs on plain "
               "tensors, not DTensors under the mesh (only the LM opt cells' "
               "steps do); temporary memory not counted: no compiler's "
               "buffer assignment to read")
NOT_COUNTED_TEMP = ("temporary memory not counted: no compiler's buffer "
                    "assignment to read")
_COLLECTIVES = ("all_gather", "allgather", "all_reduce", "allreduce",
                "reduce_scatter", "all_to_all", "alltoall", "broadcast")


def _device_counter():
    """A ``CommDebugMode`` that also sums, over the ops rank 0 runs (a
    DTensor op passes through to its local ops and collectives): FLOPs by
    op from ``torch.utils.flop_counter``'s formulas, and each collective's
    operand bytes by kind."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import flop_registry

    class DeviceCounter(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.flops = collections.Counter()
            self.coll_bytes = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            # DTensor's sharding propagation runs each new op once on fake
            # tensors of the global shapes: no device runs that
            if (out is NotImplemented or not hasattr(func, "_overloadpacket")
                    or any(issubclass(t, FakeTensor) for t in types)):
                return out
            packet, kwargs = func._overloadpacket, kwargs or {}
            if packet in flop_registry:
                self.flops[str(packet)] += int(
                    flop_registry[packet](*args, **kwargs, out_val=out))
            name = packet.__name__.strip("_")
            if "c10d" in func.namespace and any(k in name
                                                for k in _COLLECTIVES):
                self.coll_bytes[name] += sum(
                    x.numel() * x.element_size() for x in T.leaves(
                        list(args)) if hasattr(x, "element_size"))
            return out

    return DeviceCounter()


def step_flops(cb, mesh=None) -> Dict[str, Any]:
    """Run ``cb.step_fn`` on its meta arguments: {"flops", "flops_by_op",
    "flops_error", "collective_bytes", "outputs", "seconds"}.  Without
    ``mesh``, on the plain meta tensors under ``FlopCounterMode``.  With it
    (an LM ``opt`` cell), on the arguments placed as DTensors by the cell's
    shardings, under ``use_mesh(mesh)`` and :func:`_device_counter`:
    rank 0's FLOPs and its collectives' bytes by kind."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import use_mesh
    from repro_torch.runtime.elastic import reshard_state
    t0 = time.perf_counter()
    args, ambient = cb.arg_specs, contextlib.nullcontext()
    counter = FlopCounterMode(display=False)
    if mesh is not None:
        args = reshard_state(args, shardings_for_cell(mesh, cb))
        ambient, counter = use_mesh(mesh), _device_counter()
    try:
        with ambient, counter:
            outputs = cb.step_fn(*args)
    except Exception as e:  # noqa: BLE001 -- recorded, never a silent 0
        return {"flops": None, "flops_by_op": None,
                "flops_error": f"{type(e).__name__}: {e}",
                "collective_bytes": None, "outputs": None,
                "seconds": time.perf_counter() - t0}
    if mesh is None:
        by_op = {str(op): int(n) for op, n in
                 counter.get_flop_counts().get("Global", {}).items()}
        coll = None
    else:
        by_op, coll = dict(counter.flops), dict(counter.coll_bytes)
        outputs = T.tree_map(_global_meta, outputs)
    return {"flops": float(sum(by_op.values())), "flops_by_op": by_op,
            "flops_error": None, "collective_bytes": coll,
            "outputs": outputs, "seconds": time.perf_counter() - t0}


def _global_meta(x):
    """A DTensor output as a meta tensor of its global shape (the record
    places outputs by the cell's output shardings, as for a plain step)."""
    import torch
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return x


def bytes_per_device(tree: Any, shardings: Any) -> int:
    """Bytes of rank 0's shards of ``tree``'s leaves, each placed by the
    sharding at its position (``shardings`` has ``tree``'s structure up to
    its leaves; a ``None`` sharding holds no leaf)."""
    total = 0
    for sh, x in zip(T.leaves(shardings), T.flatten_up_to(shardings, tree)):
        total += math.prod(sh.local_shape(x)) * x.element_size()
    return total


def cell_cost(cb, mesh, flops: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
    """The cost record of cell ``cb`` on ``mesh``: bytes a device from the
    cell's shardings, FLOPs a step and collective bytes from
    :func:`step_flops` (pass its result to reuse it across meshes: a plain
    step's count does not depend on the mesh, and an ``opt`` cell is built
    for one).  An LM ``opt`` cell's step runs on ``mesh``."""
    if flops is None:
        flops = step_flops(cb, mesh if spmd_cell(cb) else None)
    in_sh = shardings_for_cell(mesh, cb)
    out_sh = out_shardings_for_cell(mesh, cb, in_sh)
    out = flops["outputs"]
    return {
        "argument_bytes_per_device": bytes_per_device(cb.arg_specs, in_sh),
        "output_bytes_per_device": (None if out is None
                                    else bytes_per_device(out, out_sh)),
        "flops_per_step": flops["flops"],
        "flops_by_op": flops["flops_by_op"],
        "flops_error": flops["flops_error"],
        "collective_bytes": flops["collective_bytes"],
        "temp_bytes": None,
        "not_counted": (NOT_COUNTED if flops["collective_bytes"] is None
                        else NOT_COUNTED_TEMP),
    }


def spmd_cell(cb) -> bool:
    """Whether the cell's step runs on DTensors under the mesh: an LM cell
    whose config sets the SPMD fields (the ``opt`` variants)."""
    return cb.family == "lm" and cb.cfg.act_shard_axes is not None

