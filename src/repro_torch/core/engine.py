"""Dynamic graph processing engine: the Table-1 API over CBList, in torch.

ProcessEdge runs block-parallel over the GTChain: every block contributes
its lanes through one segment reduction.  One sweep in push mode is

    msg(e=(u,v)) = dense_f(x[u], w_uv)        for u active
    y[v]         = combine_e(msg over in-edges)

and pull mode gathers ``x[v_dst]`` per lane instead.  Every sweep takes
``impl=``:

  * ``"torch"`` — plain tensor ops (``index_add_`` / ``scatter_reduce``),
    the oracle, as ``impl="xla"`` is in the JAX package;
  * ``"cuda"``  — the data-dependent gathers go through ``gather_rows`` and
    the destination sum through the GTChain segment-sum kernel (their
    plain versions when the tensors lie on the CPU).

A :class:`SweepPlan` (:func:`sweep_plan`) lays a CBList snapshot's lanes out
in destination order once, so that a ``"cuda"`` sum sweep handed one sorts
nothing: push gathers ``x[src]`` in that order (the vertex vector is the
random side, small enough for L2) and the segment sum reads one contiguous
stream.  Without a plan each sum sweep sorts its segment ids itself.

``min``/``max`` combines always use ``scatter_reduce`` (the sum kernel is
additive), as the JAX package keeps them off its kernels.

Every sweep entry point also takes a
:class:`~repro_torch.core.tiered.TieredGraph`: the delta sweeps as above
(through ``plan``, the delta's plan), the sealed run through the CSR sweeps
of :mod:`repro_torch.core.csr`, and the two partials merge through the
semiring.  A :class:`~repro_torch.distributed.graph.ShardedCBList` runs the
same sweep on every shard this rank holds (``plan`` then holds one plan a
local shard), reduces the partials along the shard axis and, on a process
group, across the ranks with the semiring's collective.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import backend
from repro_torch.backend import resolve_impl
from repro_torch.core.blockstore import NULL, I32, arange32
from repro_torch.core.cblist import CBList
from repro_torch.core.traversal import lane_mask
from repro_torch.kernels import gather_rows, segment_matmul
from repro_torch.kernels.segment_matmul.ops import (INT32_MAX,
                                                    csr_items_per_cta,
                                                    merge_path_partition,
                                                    segment_sum_csr)


def _segment_reduce(reduce: str, fill: float):
    def fn(data: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
        valid = (seg >= 0) & (seg < n)
        out = torch.full((n,) + tuple(data.shape[1:]), fill, dtype=data.dtype,
                         device=data.device)
        if reduce == "sum":
            return out.index_add_(0, seg[valid].long(), data[valid])
        idx = seg[valid].long()
        if data.dim() > 1:
            idx = idx.view(-1, *([1] * (data.dim() - 1))).expand(
                -1, *data.shape[1:])
        return out.scatter_reduce_(0, idx, data[valid], reduce,
                                   include_self=True)
    return fn


@dataclasses.dataclass(frozen=True)
class Semiring:
    """One combine semiring: the masked-lane identity, the flat segment
    reduction over lanes (the oracle), the dense reduction along an axis
    (per-block pull) and the ``torch.distributed`` reduction that combines
    partial outputs across ranks (the JAX package's ``collective``)."""
    name: str
    fill: float
    segment_reduce: Callable      # (data, seg, n) -> [n, ...]
    lane_reduce: Callable         # (x, dim) -> reduced
    reduce_op: object             # dist.ReduceOp.SUM / MIN / MAX


SEMIRINGS = {
    "sum": Semiring("sum", 0.0, _segment_reduce("sum", 0.0),
                    lambda x, dim: x.sum(dim), dist.ReduceOp.SUM),
    "min": Semiring("min", float("inf"), _segment_reduce("amin", float("inf")),
                    lambda x, dim: x.amin(dim), dist.ReduceOp.MIN),
    "max": Semiring("max", float("-inf"),
                    _segment_reduce("amax", float("-inf")),
                    lambda x, dim: x.amax(dim), dist.ReduceOp.MAX),
}


def _default_edge_f(xs, w):
    return xs * w


def _gather_values(x: torch.Tensor, ids: torch.Tensor,
                   impl: str) -> torch.Tensor:
    """``x[ids]`` through the ``gather_rows`` kernel when impl == "cuda".

    ``ids`` must already lie in [0, len(x)); the result keeps the shape of
    ``ids`` (+ the feature axis when x is 2-D).
    """
    if impl == "torch":
        return x[ids.long()]
    flat = ids.reshape(-1).to(I32).contiguous()
    table = x.reshape(x.shape[0], -1).contiguous()
    out = gather_rows(table, flat, rows_per_step=1)
    return out.reshape(ids.shape + x.shape[1:])


def _segment_sum(msg: torch.Tensor, seg: torch.Tensor, num_segments: int,
                 impl: str) -> torch.Tensor:
    """Flat segment sum via the GTChain kernel or the oracle."""
    if impl == "torch":
        return SEMIRINGS["sum"].segment_reduce(msg, seg, num_segments)
    data = msg[:, None] if msg.dim() == 1 else msg
    out = segment_matmul(data.contiguous(), seg.to(I32).contiguous(),
                         num_segments)
    return out[:, 0] if msg.dim() == 1 else out


@dataclasses.dataclass(eq=False)
class SweepPlan:
    """One CBList snapshot's sum sweeps in destination order.

    ``lanes`` (push, push_feat): the live lanes whose destination is in
    range, stable-sorted by destination, as each lane's source vertex
    ``src`` (its block's owner) and weight ``w``, with ``row_ptr`` the span
    of each destination.  ``blocks`` (pull): the owned blocks stable-sorted
    by owner, with ``block_row_ptr``.  Either is None when not built.  The
    merge-path partitions of both streams are made once per feature width.
    The plan holds the store arrays it was built from and refuses another
    store (:meth:`check`).
    """
    nv: int
    built_from: tuple                    # (keys, vals, count, owner)
    src: Optional[torch.Tensor] = None   # i32[V]
    w: Optional[torch.Tensor] = None     # f32[V]
    row_ptr: Optional[torch.Tensor] = None         # i32[nv + 1]
    blocks: Optional[torch.Tensor] = None          # i32[NB owned]
    block_row_ptr: Optional[torch.Tensor] = None   # i32[nv + 1]
    _parts: dict = dataclasses.field(default_factory=dict)

    def check(self, cbl: CBList) -> None:
        st = cbl.store
        now = (st.keys, st.vals, st.count, st.owner)
        if cbl.capacity_vertices != self.nv or any(
                a is not b for a, b in zip(self.built_from, now)):
            raise ValueError("sweep plan was built for another CBList store; "
                             "build one for this graph with sweep_plan(cbl)")

    def stream(self, name: str):
        """``row_ptr`` of the ``"lanes"`` or ``"blocks"`` stream."""
        row_ptr = self.row_ptr if name == "lanes" else self.block_row_ptr
        if row_ptr is None:
            raise ValueError(f"this sweep plan has no {name} stream "
                             f"(build it with sweep_plan(cbl, ...))")
        return row_ptr

    def partition(self, name: str, F: int) -> torch.Tensor:
        """The merge-path partition of stream ``name`` at width ``F``."""
        key = (name, csr_items_per_cta(F))
        if key not in self._parts:
            self._parts[key] = merge_path_partition(self.stream(name), key[1])
        return self._parts[key]


def sweep_plan(cbl: CBList, *, push: bool = True,
               pull: bool = True) -> SweepPlan:
    """Lay ``cbl``'s lanes (``push``) and blocks (``pull``) out in
    destination order for the sum sweeps; counted in
    ``backend.PLAN_BUILDS``."""
    backend.PLAN_BUILDS += 1
    st = cbl.store
    nv = cbl.capacity_vertices
    plan = SweepPlan(nv=nv, built_from=(st.keys, st.vals, st.count,
                                        st.owner))
    bounds = arange32(nv + 1, cbl.device)
    if push:
        mask = lane_mask(st) & (st.keys >= 0) & (st.keys < nv)
        lanes = torch.nonzero(mask.reshape(-1)).squeeze(1)   # GTChain order
        if lanes.numel() > INT32_MAX:
            raise ValueError(f"sweep_plan: {lanes.numel()} lanes do not fit "
                             "an int32 stream")
        sorted_dst, order = torch.sort(st.keys.reshape(-1)[lanes],
                                       stable=True)
        lanes = lanes[order]
        plan.src = st.owner[lanes // st.block_width]
        plan.w = st.vals.reshape(-1)[lanes]
        plan.row_ptr = torch.searchsorted(sorted_dst, bounds, out_int32=True)
        plan.partition("lanes", 1)
    if pull:
        blocks = torch.nonzero((st.owner >= 0) & (st.owner < nv)).squeeze(1)
        sorted_owner, order = torch.sort(st.owner[blocks], stable=True)
        plan.blocks = blocks[order].to(I32)
        plan.block_row_ptr = torch.searchsorted(sorted_owner, bounds,
                                                out_int32=True)
        plan.partition("blocks", 1)
    return plan


def _planned_sum(plan: SweepPlan, name: str,
                 data: torch.Tensor) -> torch.Tensor:
    """Segment sum of a stream already in the plan's order (an empty stream
    too: a delta whose every vertex is sealed)."""
    flat = data.reshape(data.shape[0], math.prod(data.shape[1:])).contiguous()
    out = segment_sum_csr(flat, plan.stream(name),
                          plan.partition(name, flat.shape[1]))
    return out.reshape((out.shape[0],) + tuple(data.shape[1:]))


def _active_lanes(plan: SweepPlan, msg: torch.Tensor,
                  active: Optional[torch.Tensor]) -> torch.Tensor:
    """Lanes whose source is inactive add 0."""
    if active is None:
        return msg
    act = active.index_select(0, plan.src)
    return torch.where(act.view(-1, *([1] * (msg.dim() - 1))), msg, 0.0)


def process_vertex(cbl: CBList, f: Callable, x: torch.Tensor,
                   active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ProcessVertex(f, active): map f over vertex values (inactive keep x)."""
    y = f(x)
    live = arange32(cbl.capacity_vertices, cbl.device) < cbl.n_vertices
    if active is not None:
        live = live & active
    return torch.where(live, y, x)


def process_edge_push(cbl: CBList, x: torch.Tensor,
                      active: Optional[torch.Tensor] = None, *,
                      dense_f: Callable = _default_edge_f,
                      combine: str = "sum",
                      impl: str = "torch",
                      plan: Optional[SweepPlan] = None) -> torch.Tensor:
    """Push sweep: y[dst] = combine over in-edges of dense_f(x[src], w).

    Each block has exactly one owner, so the source value is one gather per
    block broadcast over its lanes (the locality the GTChain buys).  With a
    ``plan`` (``impl="cuda"``, sum) the source values are gathered per lane
    in destination order instead and summed as one sorted stream.
    """
    impl = resolve_impl(impl)
    if not isinstance(cbl, CBList):
        from repro_torch.core.tiered import (TieredGraph,
                                             tiered_process_edge_push)
        if isinstance(cbl, TieredGraph):
            return tiered_process_edge_push(cbl, x, active, dense_f=dense_f,
                                            combine=combine, impl=impl,
                                            plan=plan)
        from repro_torch.distributed.graph import sharded_process_edge_push
        return sharded_process_edge_push(cbl, x, active, dense_f=dense_f,
                                         combine=combine, impl=impl,
                                         plan=plan)
    if plan is not None and impl == "cuda" and combine == "sum":
        plan.check(cbl)
        plan.stream("lanes")
        xs = _gather_values(x, plan.src, impl)           # [V] in dst order
        msg = torch.broadcast_to(dense_f(xs, plan.w), xs.shape)
        return _planned_sum(plan, "lanes", _active_lanes(plan, msg, active))
    st = cbl.store
    nv = cbl.capacity_vertices
    owner_safe = st.owner.clamp(min=0)
    gather_impl = impl if combine == "sum" else "torch"
    xs = _gather_values(x, owner_safe, gather_impl)      # [NB] per-block src value
    mask = lane_mask(st)
    if active is not None:
        mask = mask & active[owner_safe.long()][:, None]
    msg = dense_f(xs[:, None], st.vals)                  # [NB, B]
    seg = torch.where(mask, st.keys, nv)                 # PAD/out-of-range drop
    sr = SEMIRINGS[combine]
    msg = torch.where(mask, msg, sr.fill)
    if combine == "sum":
        return _segment_sum(msg.reshape(-1), seg.reshape(-1), nv, impl)
    return sr.segment_reduce(msg.reshape(-1), seg.reshape(-1), nv)


def process_edge_pull(cbl: CBList, x: torch.Tensor,
                      active_dst: Optional[torch.Tensor] = None, *,
                      dense_f: Callable = _default_edge_f,
                      combine: str = "sum",
                      impl: str = "torch",
                      plan: Optional[SweepPlan] = None) -> torch.Tensor:
    """Pull sweep: y[src] = combine over out-edges of dense_f(x[dst], w).

    The x[dst] gather is the paper's random-access pattern (§2.1); with
    ``impl="cuda"`` it runs through the ``gather_rows`` kernel.  With a
    ``plan`` (``impl="cuda"``, sum) the per-block sums are put in owner
    order by the plan's block order and summed as one sorted stream.
    """
    impl = resolve_impl(impl)
    if not isinstance(cbl, CBList):
        from repro_torch.core.tiered import (TieredGraph,
                                             tiered_process_edge_pull)
        if isinstance(cbl, TieredGraph):
            return tiered_process_edge_pull(cbl, x, active_dst,
                                            dense_f=dense_f, combine=combine,
                                            impl=impl, plan=plan)
        from repro_torch.distributed.graph import sharded_process_edge_pull
        return sharded_process_edge_pull(cbl, x, active_dst, dense_f=dense_f,
                                         combine=combine, impl=impl,
                                         plan=plan)
    planned = plan is not None and impl == "cuda" and combine == "sum"
    if planned:
        plan.check(cbl)
        plan.stream("blocks")
    st = cbl.store
    nv = cbl.capacity_vertices
    mask = lane_mask(st)
    dst_safe = st.keys.clamp(0, nv - 1)
    gather_impl = impl if combine == "sum" else "torch"
    xd = _gather_values(x, dst_safe, gather_impl)        # [NB, B] random gather
    if active_dst is not None:
        mask = mask & active_dst[dst_safe.long()]
    msg = dense_f(xd, st.vals)
    owner_seg = torch.where(st.owner == NULL, nv, st.owner)
    sr = SEMIRINGS[combine]
    msg = torch.where(mask, msg, sr.fill)
    per_blk = sr.lane_reduce(msg, 1)
    if planned:
        flat = per_blk.reshape(per_blk.shape[0], -1).contiguous()
        ordered = gather_rows(flat, plan.blocks, rows_per_step=1)
        return _planned_sum(plan, "blocks", ordered.reshape(
            (-1,) + tuple(per_blk.shape[1:])))
    if combine == "sum":
        return _segment_sum(per_blk, owner_seg, nv, impl)
    return sr.segment_reduce(per_blk, owner_seg, nv)


def process_edge_push_feat(cbl: CBList, x: torch.Tensor,
                           active: Optional[torch.Tensor] = None, *,
                           weighted: bool = True,
                           impl: str = "torch",
                           plan: Optional[SweepPlan] = None) -> torch.Tensor:
    """Feature-matrix push: y[dst, :] += x[src, :] * w over all edges.

    One F-wide row gather per block, then a segment-sum keyed by the lane
    destinations (both kernels with ``impl="cuda"``).  With a ``plan``
    (``impl="cuda"``) the rows are gathered per lane in destination order
    and summed as one sorted stream.
    """
    impl = resolve_impl(impl)
    if not isinstance(cbl, CBList):
        from repro_torch.core.tiered import (TieredGraph,
                                             tiered_process_edge_push_feat)
        if isinstance(cbl, TieredGraph):
            return tiered_process_edge_push_feat(cbl, x, active,
                                                 weighted=weighted, impl=impl,
                                                 plan=plan)
        from repro_torch.distributed.graph import \
            sharded_process_edge_push_feat
        return sharded_process_edge_push_feat(cbl, x, active,
                                              weighted=weighted, impl=impl,
                                              plan=plan)
    if plan is not None and impl == "cuda":
        plan.check(cbl)
        plan.stream("lanes")
        xs = _gather_values(x, plan.src, impl)           # [V, F] in dst order
        msg = xs * plan.w[:, None] if weighted else xs
        return _planned_sum(plan, "lanes", _active_lanes(plan, msg, active))
    st = cbl.store
    nv = cbl.capacity_vertices
    owner_safe = st.owner.clamp(min=0)
    xs = _gather_values(x, owner_safe, impl)             # [NB, F]
    mask = lane_mask(st)
    if active is not None:
        mask = mask & active[owner_safe.long()][:, None]
    scale = st.vals if weighted else torch.ones_like(st.vals)
    msg = xs[:, None, :] * torch.where(mask, scale, 0.0)[:, :, None]
    seg = torch.where(mask, st.keys, nv)
    return _segment_sum(msg.reshape(-1, x.shape[1]), seg.reshape(-1), nv,
                        impl)


def out_degrees(cbl: CBList) -> torch.Tensor:
    return cbl.v_deg


def in_degrees(cbl: CBList) -> torch.Tensor:
    if not isinstance(cbl, CBList):
        from repro_torch.core.tiered import TieredGraph, tiered_in_degrees
        if isinstance(cbl, TieredGraph):
            return tiered_in_degrees(cbl)
        from repro_torch.distributed.graph import sharded_in_degrees
        return sharded_in_degrees(cbl)
    st = cbl.store
    nv = cbl.capacity_vertices
    seg = torch.where(lane_mask(st), st.keys, nv).reshape(-1)
    valid = (seg >= 0) & (seg < nv)
    return torch.bincount(seg[valid].long(), minlength=nv)[:nv].to(I32)
