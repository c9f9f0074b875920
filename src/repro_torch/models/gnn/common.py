"""GNN substrate: padded-COO graph batches + segment message passing, as
``repro.models.gnn.common``.

Message passing is gather -> transform -> segment reduction over an edge
index.  Every function takes ``impl=``:

  * ``"torch"`` — plain tensor ops (``index_select``, ``index_put``),
    differentiated by autograd: the oracle, as ``impl="xla"`` is in the JAX
    package;
  * ``"cuda"``  — the gathers and the sums by destination go through the
    ``block_gather`` and GTChain ``segment_sum`` kernels, forward and
    backward (their plain versions when the tensors lie on the CPU).

The kernel route reads an :class:`EdgePlan` (``models/plan.py``), built
once per batch as the engine's ``SweepPlan`` is built once per snapshot:
the valid edges in stable destination order with the CSR ``row_ptr`` of
each destination, and the same by source (the transposed plan).  The gradient of a sum by
destination is a gather at each edge's destination, and the gradient of a
gather by source is a sum by source, so both directions run on the two
kernels (:func:`scatter_sum`, :func:`gather`).  :func:`aggregate` is GIN's
``scatter_sum(h[src], dst)`` as one function over the plan, so the [E, F]
message stream exists once, in destination order, and is never saved for
the backward.  Lanes outside the plan (invalid edges) get no gradient from
:func:`gather`: every model masks them before any sum, so theirs is 0.

``scatter_max`` / ``scatter_min`` / ``segment_softmax`` stay plain
(``scatter_reduce``), as the JAX package keeps them off its kernels; ties
share the gradient equally in both packages.  ``segment_softmax`` takes
[E] scores or [E, H] (one softmax a head, JAX's ``vmap`` over heads).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.backend import resolve_impl
from repro_torch.models.plan import (EdgePlan, _Gather, _gather,  # noqa: F401
                                     _sum_by, edge_plan)


class GraphBatch(NamedTuple):
    """Fixed-shape (padded) graph batch on one device (``device``).

    For batched small graphs, nodes of all graphs are flattened and
    ``graph_id`` routes pooling; for single graphs graph_id == 0.  ``plan``
    is the batch's :class:`EdgePlan` (:meth:`with_plan`); a kernel-route
    model call without one builds it for that call.
    """
    x: torch.Tensor                        # f32[N, F] node features
    edge_src: torch.Tensor                 # i32[E]
    edge_dst: torch.Tensor                 # i32[E]
    edge_valid: torch.Tensor               # bool[E]
    node_valid: torch.Tensor               # bool[N]
    graph_id: torch.Tensor                 # i32[N]
    pos: Optional[torch.Tensor] = None     # f32[N, 3] (geometric models)
    edge_attr: Optional[torch.Tensor] = None   # f32[E, Fe]
    labels: Optional[torch.Tensor] = None      # i32[N] or f32[G]
    plan: Optional[EdgePlan] = None

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_graphs(self) -> int:
        return int(self.graph_id.max()) + 1 if self.graph_id.numel() else 1

    @property
    def device(self) -> torch.device:
        return self.x.device

    def with_plan(self) -> "GraphBatch":
        return self._replace(plan=edge_plan(self.edge_dst, self.edge_valid,
                                            self.num_nodes, self.edge_src))


def batch_plan(g: GraphBatch, impl: str) -> Optional[EdgePlan]:
    """The plan a model call over ``g`` uses: none on the plain route."""
    if resolve_impl(impl) == "torch":
        return None
    return g.plan if g.plan is not None else g.with_plan().plan


# ---------------------------------------------------------------------------
# the kernel route's autograd functions
# ---------------------------------------------------------------------------

class _ScatterSum(torch.autograd.Function):
    """y[v] = sum of msg[e] over the plan's lanes e with dst[e] == v."""

    @staticmethod
    def forward(ctx, msg, plan):
        ctx.plan = plan
        return _sum_by(plan, "dst", _gather(msg, plan.dst_order))

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None
        # a lane's gradient is its destination's; row n (off the plan) is 0
        padded = torch.cat([grad, grad.new_zeros((1, grad.shape[1]))])
        return _gather(padded, ctx.plan.seg), None


class _Aggregate(torch.autograd.Function):
    """y[v] = sum of h[src[e]] over the plan's lanes e with dst[e] == v."""

    @staticmethod
    def forward(ctx, h, plan):
        ctx.plan = plan
        return _sum_by(plan, "dst", _gather(h, plan.src_by_dst))

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None
        plan = ctx.plan
        return _sum_by(plan, "src", _gather(grad, plan.dst_by_src)), None


# ---------------------------------------------------------------------------
# message passing
# ---------------------------------------------------------------------------

def _lane_plan(dst, valid, n, impl, plan) -> Optional[EdgePlan]:
    if resolve_impl(impl) == "torch":
        return None
    if plan is None:
        return edge_plan(dst, valid, n)
    plan.check(dst, valid, n)
    return plan


def _graph_plan(g: GraphBatch, impl: str,
                plan: Optional[EdgePlan]) -> EdgePlan:
    plan = plan if plan is not None else batch_plan(g, impl)
    plan.check(g.edge_dst, g.edge_valid, g.num_nodes)
    return plan


def scatter_sum(msg: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                n: int, impl: str = "cuda",
                plan: Optional[EdgePlan] = None) -> torch.Tensor:
    """sum_{e: dst[e]==v} msg[e]  — the GNN aggregation primitive."""
    plan = _lane_plan(dst, valid, n, impl, plan)
    if plan is None:
        keep = valid & (dst >= 0) & (dst < n)
        seg = torch.where(keep, dst, torch.full_like(dst, n))
        out = msg.new_zeros((n + 1,) + tuple(msg.shape[1:]))
        # index_put, not index_add: autograd keeps only the indices, not the
        # [E, F] messages, for the backward
        return out.index_put((seg,), msg, accumulate=True)[:n]
    out = _ScatterSum.apply(msg.reshape(msg.shape[0], -1), plan)
    return out.reshape((n,) + tuple(msg.shape[1:]))


def scatter_mean(msg, dst, valid, n, impl="cuda", plan=None):
    plan = _lane_plan(dst, valid, n, impl, plan)
    if plan is None:
        s = scatter_sum(msg, dst, valid, n, "torch")
        c = scatter_sum(msg.new_ones((msg.shape[0], 1)), dst, valid, n,
                        "torch")
    else:
        s = scatter_sum(msg, dst, valid, n, impl, plan)
        c = plan.in_degree().reshape((n,) + (1,) * (msg.dim() - 1))
    return s / torch.clamp(c, min=1.0)


def gather(h: torch.Tensor, g: GraphBatch, side: str, impl: str = "cuda",
           plan: Optional[EdgePlan] = None) -> torch.Tensor:
    """``h[g.edge_src]`` (``side == "src"``) or ``h[g.edge_dst]``."""
    if resolve_impl(impl) == "torch":
        return h.index_select(0, g.edge_src if side == "src"
                              else g.edge_dst)
    return _Gather.apply(h, _graph_plan(g, impl, plan), side)


def aggregate(h: torch.Tensor, g: GraphBatch, impl: str = "cuda",
              plan: Optional[EdgePlan] = None) -> torch.Tensor:
    """``scatter_sum(h[g.edge_src], g.edge_dst, g.edge_valid, n)``."""
    if resolve_impl(impl) == "torch":
        return scatter_sum(gather(h, g, "src", "torch"), g.edge_dst,
                           g.edge_valid, g.num_nodes, "torch")
    return _Aggregate.apply(h, _graph_plan(g, impl, plan))


def _scatter_extremum(msg, dst, valid, n, reduce: str, fill: float):
    seg = torch.where(valid, dst, torch.full_like(dst, n)).long()
    shape = (-1,) + (1,) * (msg.dim() - 1)
    src = torch.where(valid.view(shape), msg, fill)
    out = msg.new_full((n + 1,) + tuple(msg.shape[1:]), fill)
    out = out.scatter_reduce(0, seg.view(shape).expand_as(msg), src, reduce,
                             include_self=True)[:n]
    return torch.where(torch.isfinite(out), out, 0.0)


def scatter_max(msg, dst, valid, n):
    return _scatter_extremum(msg, dst, valid, n, "amax", float("-inf"))


def scatter_min(msg, dst, valid, n):
    return _scatter_extremum(msg, dst, valid, n, "amin", float("inf"))


def segment_softmax(scores: torch.Tensor, dst: torch.Tensor,
                    valid: torch.Tensor, n: int) -> torch.Tensor:
    """Edge softmax over incoming edges per destination: scores [E], or
    [E, H] with one softmax a column (head)."""
    seg = torch.where(valid, dst, torch.full_like(dst, n)).long()
    shape = (-1,) + (1,) * (scores.dim() - 1)
    live = valid.view(shape)
    idx = seg.view(shape).expand_as(scores)
    mx = scores.new_full((n + 1,) + tuple(scores.shape[1:]),
                         float("-inf")).scatter_reduce(
        0, idx, torch.where(live, scores, float("-inf")), "amax",
        include_self=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.where(live, torch.exp(scores - mx[seg]), 0.0)
    den = scores.new_zeros((n + 1,) + tuple(scores.shape[1:])).index_add(
        0, seg, ex)
    return ex / torch.clamp(den[seg], min=1e-16)


def in_degree(g: GraphBatch, impl: str = "cuda",
              plan: Optional[EdgePlan] = None) -> torch.Tensor:
    if resolve_impl(impl) == "torch":
        ones = torch.ones((g.edge_src.shape[0], 1), dtype=torch.float32,
                          device=g.device)
        return scatter_sum(ones, g.edge_dst, g.edge_valid, g.num_nodes,
                           "torch")[:, 0]
    return _graph_plan(g, impl, plan).in_degree()


def graph_pool(h: torch.Tensor, graph_id: torch.Tensor,
               node_valid: torch.Tensor, num_graphs: int,
               mode: str = "mean") -> torch.Tensor:
    seg = torch.where(node_valid, graph_id,
                      torch.full_like(graph_id, num_graphs))
    s = h.new_zeros((num_graphs + 1, h.shape[1])).index_add(
        0, seg, h)[:num_graphs]
    if mode == "sum":
        return s
    c = h.new_zeros((num_graphs + 1,)).index_add(
        0, seg, node_valid.to(h.dtype))[:num_graphs]
    return s / torch.clamp(c[:, None], min=1.0)


# ---------------------------------------------------------------------------
# MLPs, the node / graph loss and the parameters as a module
# ---------------------------------------------------------------------------

def mlp_params(generator: torch.Generator, dims, device,
               dtype=torch.float32):
    """He-normal weights from ``generator`` (on ``device``), zero biases."""
    return [{"w": (torch.randn((a, b), generator=generator,
                               dtype=torch.float32, device=device)
                   * (2.0 / a) ** 0.5).to(dtype),
             "b": torch.zeros((b,), dtype=dtype, device=device)}
            for a, b in zip(dims[:-1], dims[1:])]


def mlp_apply(params, x, act=F.silu, final_act=False):
    for i, p in enumerate(params):
        x = x @ p["w"] + p["b"]
        if i < len(params) - 1 or final_act:
            x = act(x)
    return x


def node_loss(logits: torch.Tensor, g: GraphBatch,
              graph_level: bool) -> torch.Tensor:
    """Mean squared error of graph-level targets, else the mean
    cross-entropy over valid nodes with a label >= 0 (every model's
    ``loss_fn``)."""
    if graph_level:
        return torch.mean((logits[:, 0] - g.labels) ** 2)
    mask = g.node_valid & (g.labels >= 0)
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, g.labels.clamp(min=0).long()[:, None])[:, 0]
    return torch.where(mask, logz - ll, 0.0).sum() / torch.clamp(
        mask.sum(), min=1)


class ParamModule(nn.Module):
    """``nn.Module`` view of a parameter tree (dicts and lists of tensors):
    trainable ``nn.Parameter``s sharing the tree's storage; :meth:`tree`
    gives the tree back."""

    def __init__(self, tree):
        super().__init__()
        self._is_list = isinstance(tree, list)
        items = enumerate(tree) if self._is_list else tree.items()
        for key, value in items:
            if isinstance(value, (dict, list)):
                self.add_module(str(key), ParamModule(value))
            else:
                self.register_parameter(str(key), nn.Parameter(value))

    def tree(self):
        out = dict(self.named_parameters(recurse=False))
        out.update((k, m.tree()) for k, m in self.named_children())
        if self._is_list:
            return [out[str(i)] for i in range(len(out))]
        return out
