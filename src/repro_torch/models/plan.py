"""Lanes laid out once for the graph kernels, shared by the models.

A lane is one read of a table row at a data-dependent id: an edge's
endpoint in a GNN batch, an item id in a SASRec batch.  An
:class:`EdgePlan` holds a batch's lanes stable-sorted by id with the CSR
``row_ptr`` of each id (and, for a graph, the same by source), built once
per batch as the engine's ``SweepPlan`` is built once per snapshot.  Over
it a gather runs on ``block_gather`` and its gradient, a sum by id, on
``block_gather`` (the lanes' gradients into id order) and ``segment_sum``
(:class:`_Gather`, :func:`lane_sum`).  ``models/gnn/common.py`` builds its
aggregation on the same plan.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.kernels.block_gather.ops import gather_rows
from repro_torch.kernels.segment_matmul.ops import (csr_items_per_cta,
                                                    merge_path_partition,
                                                    segment_sum_csr)

I32 = torch.int32


@dataclasses.dataclass(eq=False)
class EdgePlan:
    """One batch's lanes laid out for the kernels.

    ``seg``: each lane's destination (id), ``n`` on a lane outside the
    plan.  By destination: ``dst_order`` (the plan's lanes, stable-sorted by
    destination), ``dst_row_ptr`` (each destination's span of it) and
    ``src_by_dst`` (their sources, in that order).  By source, when the
    plan was built with sources: ``src_order``, ``src_row_ptr`` and
    ``dst_by_src``.  All int32.  Merge-path partitions of each order are
    made once per feature width.  The plan holds the tensors it was built
    from and refuses others (:meth:`check`).
    """
    n: int
    built_from: tuple                 # (dst, valid)
    src: Optional[torch.Tensor]       # i32[E], the lanes' sources
    dst: torch.Tensor                 # i32[E]
    seg: torch.Tensor                 # i32[E]
    dst_order: torch.Tensor           # i32[V]
    dst_row_ptr: torch.Tensor         # i32[n + 1]
    src_by_dst: Optional[torch.Tensor] = None      # i32[V]
    src_order: Optional[torch.Tensor] = None       # i32[V]
    src_row_ptr: Optional[torch.Tensor] = None     # i32[n + 1]
    dst_by_src: Optional[torch.Tensor] = None      # i32[V]
    _parts: Dict = dataclasses.field(default_factory=dict)

    @property
    def num_valid(self) -> int:
        return self.dst_order.numel()

    def check(self, dst: torch.Tensor, valid: torch.Tensor, n: int) -> None:
        if n != self.n or self.built_from[0] is not dst \
                or self.built_from[1] is not valid:
            raise ValueError("edge plan was built for another batch; build "
                             "one for these edges with edge_plan(...)")

    def row_ptr(self, side: str) -> torch.Tensor:
        row_ptr = self.dst_row_ptr if side == "dst" else self.src_row_ptr
        if row_ptr is None:
            raise ValueError("this edge plan has no source order (build it "
                             "with the edges' sources)")
        return row_ptr

    def order(self, side: str) -> torch.Tensor:
        """The plan's lanes in ``side`` order."""
        self.row_ptr(side)
        return self.dst_order if side == "dst" else self.src_order

    def partition(self, side: str, F: int) -> torch.Tensor:
        """The merge-path partition of the ``"dst"`` or ``"src"`` order at
        feature width ``F``."""
        key = (side, csr_items_per_cta(F))
        if key not in self._parts:
            self._parts[key] = merge_path_partition(
                self.row_ptr(side), key[1], num_items=self.num_valid)
        return self._parts[key]

    def in_degree(self) -> torch.Tensor:
        """float32 [n]: the plan's in-edges of each node (``row_ptr``'s
        differences, the counts a sum of ones gives)."""
        return (self.dst_row_ptr[1:] - self.dst_row_ptr[:-1]).to(
            torch.float32)


def _order(key: torch.Tensor, lanes: torch.Tensor, n: int):
    """(lanes stable-sorted by key, each key's span of them, the sort's
    permutation of ``lanes``)."""
    sorted_key, perm = torch.sort(key, stable=True)
    bounds = torch.arange(n + 1, dtype=I32, device=key.device)
    row_ptr = torch.searchsorted(sorted_key, bounds, out_int32=True)
    return lanes[perm].to(I32), row_ptr, perm


def edge_plan(dst: torch.Tensor, valid: torch.Tensor, n: int,
              src: Optional[torch.Tensor] = None) -> EdgePlan:
    """The plan of the lanes ``valid`` marks whose destination lies in
    [0, n) (a sum drops the others, as JAX's ``segment_sum`` does); with
    ``src``, also by source, whose kept lanes must lie in [0, n) too
    (checked, one host sync).

    On meta tensors (the dry run) every lane is kept: the padded capacity,
    the shape the JAX package compiles, since a meta mask holds no count.
    """
    if dst.dtype != I32 or (src is not None and src.dtype != I32):
        raise TypeError("edge_plan wants int32 edge endpoints")
    keep = valid & (dst >= 0) & (dst < n)
    if dst.device.type == "meta":
        lanes = torch.arange(dst.numel(), device=dst.device)
    else:
        lanes = torch.nonzero(keep).squeeze(1)
    d = dst[lanes]
    seg = torch.where(keep, dst, torch.full_like(dst, n))
    dst_order, dst_row_ptr, perm = _order(d, lanes, n)
    plan = EdgePlan(n=n, built_from=(dst, valid),
                    src=None if src is None else src.contiguous(),
                    dst=dst.contiguous(), seg=seg.contiguous(),
                    dst_order=dst_order, dst_row_ptr=dst_row_ptr)
    if src is not None:
        s = src[lanes]
        if s.numel() and s.device.type != "meta" \
                and bool(((s < 0) | (s >= n)).any()):
            raise ValueError(f"edge_plan: a valid edge's source lies "
                             f"outside [0, {n})")
        plan.src_by_dst = s[perm].contiguous()
        plan.src_order, plan.src_row_ptr, perm = _order(s, lanes, n)
        plan.dst_by_src = d[perm].contiguous()
    return plan


# ---------------------------------------------------------------------------
# the kernel route's gather and its gradient
# ---------------------------------------------------------------------------

def _sum_by(plan: EdgePlan, side: str, stream: torch.Tensor) -> torch.Tensor:
    """The ``side``-ordered stream summed by ``side`` -> f32[n, F]."""
    return segment_sum_csr(stream, plan.row_ptr(side),
                           plan.partition(side, max(stream.shape[1], 1)))


def _gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return gather_rows(table.contiguous(), ids, rows_per_step=1)


def lane_sum(plan: EdgePlan, side: str, grad: torch.Tensor) -> torch.Tensor:
    """f32[n, F]: the rows ``grad`` of every lane (lane order) summed by
    the lanes' ``side`` ids over the plan -- the gradient of a gather at
    those ids.  Lanes outside the plan add nothing."""
    return _sum_by(plan, side, _gather(grad, plan.order(side)))


class _Gather(torch.autograd.Function):
    """out[e] = table[ids[e]] for every lane, ``ids`` the lanes' sources
    (``side == "src"``) or destinations."""

    @staticmethod
    def forward(ctx, table, plan, side):
        ctx.plan, ctx.side = plan, side
        return _gather(table, plan.src if side == "src" else plan.dst)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        return lane_sum(ctx.plan, ctx.side, grad), None, None
