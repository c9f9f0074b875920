"""GIN (Graph Isomorphism Network) — arXiv:1810.00826, as
``repro.models.gnn.gin``.

h_v' = MLP((1 + eps) * h_v + sum_{u in N(v)} h_u), eps learnable.
Config gin-tu: 5 layers, d_hidden=64, sum aggregator.  On the kernel route
each layer's neighbour sum is one :func:`~.common.aggregate` over the
batch's edge plan: forward a ``block_gather`` and a ``segment_sum``, and the
same two backward for every layer whose input needs a gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn

from repro_torch.backend import resolve_device
from repro_torch.models.gnn.common import (GraphBatch, ParamModule,
                                           aggregate, batch_plan, graph_pool,
                                           mlp_apply, mlp_params, node_loss)


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str = "gin-tu"
    n_layers: int = 5
    d_hidden: int = 64
    d_in: int = 64
    n_classes: int = 16
    graph_level: bool = False         # node classification unless molecule


def init_params(cfg: GINConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random weights from ``generator``, which must live on ``device`` (the
    card by default)."""
    dev = resolve_device(device)
    layers = []
    for i in range(cfg.n_layers):
        d_in = cfg.d_in if i == 0 else cfg.d_hidden
        layers.append({
            "mlp": mlp_params(generator, (d_in, cfg.d_hidden, cfg.d_hidden),
                              dev),
            "eps": torch.zeros((), dtype=torch.float32, device=dev),
        })
    return {"layers": layers,
            "head": mlp_params(generator, (cfg.d_hidden, cfg.n_classes),
                               dev)}


def forward(params, cfg: GINConfig, g: GraphBatch, impl: str = "cuda"):
    plan = batch_plan(g, impl)
    h = g.x
    for lp in params["layers"]:
        agg = aggregate(h, g, impl, plan)
        h = mlp_apply(lp["mlp"], (1.0 + lp["eps"]) * h + agg,
                      act=torch.relu, final_act=True)
        h = torch.where(g.node_valid[:, None], h, 0.0)
    if cfg.graph_level:
        ng = g.labels.shape[0] if g.labels is not None else 1
        pooled = graph_pool(h, g.graph_id, g.node_valid, ng, mode="sum")
        return mlp_apply(params["head"], pooled)
    return mlp_apply(params["head"], h)


def loss_fn(params, cfg: GINConfig, g: GraphBatch, impl: str = "cuda"):
    return node_loss(forward(params, cfg, g, impl), g, cfg.graph_level)


class GIN(nn.Module):
    """``nn.Module`` view of a GIN parameter tree (trainable parameters
    sharing its storage); ``forward(g, impl)`` is :func:`forward`."""

    def __init__(self, cfg: GINConfig, params):
        super().__init__()
        self.cfg = cfg
        self.params = ParamModule(params)

    def forward(self, g: GraphBatch, impl: str = "cuda") -> torch.Tensor:
        return forward(self.params.tree(), self.cfg, g, impl)
