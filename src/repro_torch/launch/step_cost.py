"""A registry cell's step cost, counted on the meta device: the port's
counterpart of ``repro.launch.hlo_cost``.

The JAX package compiles each cell and parses the HLO text for dot FLOPs
(times each ``while`` loop's trip count) and collective bytes.  The port
emits no HLO: it runs the cell's step once on ``device="meta"`` tensors
(shapes and dtypes, no bytes) under ``torch.utils.flop_counter``.

* **FLOPs a step**: ``FlopCounterMode`` over the step, forward, backward
  and optimizer, for the whole global batch: ``2 * M * N * K`` per matrix
  product (``mm``, ``bmm``, ``addmm``, ...), the convention of
  ``parse_hlo``'s dots.  The layers are a Python loop, so every layer
  counts and no trip count is needed.  The kernels' meta branches give
  their outputs' shapes (the gathers and sums by id do no products); flash
  attention's is the plain version's ops on meta, so its products count as
  the JAX package's einsums do (full S x S).  Plan builders keep every lane
  on meta: the padded capacity, the shape JAX compiles.
* **Argument and output bytes a device**: each leaf's rank-0 local shape
  under its sharding (:mod:`repro_torch.distributed.sharding`), from
  ``distribute_tensor`` of a meta tensor on the mesh -- the fake process
  group's rank 0 in the dry run.
* **Collective bytes and temporary memory**: ``None``, with
  :data:`NOT_COUNTED` as the reason, until a step runs under DTensor across
  cards (ROADMAP.md, queue 1 item 8.4).  Never 0.

A step that cannot run on meta leaves ``flops`` ``None`` and its
exception's text in ``flops_error``.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional

from repro_torch import tree as T
from repro_torch.distributed.sharding import (out_shardings_for_cell,
                                              shardings_for_cell)

NOT_COUNTED = ("not counted: needs the step run under DTensor across cards "
               "(ROADMAP.md, queue 1 item 8.4)")


def step_flops(cb) -> Dict[str, Any]:
    """Run ``cb.step_fn`` on its meta arguments under ``FlopCounterMode``:
    {"flops", "flops_by_op", "flops_error", "outputs", "seconds"}."""
    from torch.utils.flop_counter import FlopCounterMode
    t0 = time.perf_counter()
    counter = FlopCounterMode(display=False)
    try:
        with counter:
            outputs = cb.step_fn(*cb.arg_specs)
    except Exception as e:  # noqa: BLE001 -- recorded, never a silent 0
        return {"flops": None, "flops_by_op": None,
                "flops_error": f"{type(e).__name__}: {e}", "outputs": None,
                "seconds": time.perf_counter() - t0}
    by_op = {str(op): int(n) for op, n in
             counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": float(counter.get_total_flops()), "flops_by_op": by_op,
            "flops_error": None, "outputs": outputs,
            "seconds": time.perf_counter() - t0}


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
    cell's shardings, FLOPs a step from :func:`step_flops` (pass its result
    to reuse it across meshes: the count does not depend on the mesh)."""
    flops = flops if flops is not None else step_flops(cb)
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
        "collective_bytes": None,
        "temp_bytes": None,
        "not_counted": NOT_COUNTED,
    }

