"""EGNN — E(n)-equivariant GNN (arXiv:2102.09844), as
``repro.models.gnn.egnn``.

m_ij  = phi_e(h_i, h_j, ||x_i - x_j||^2, a_ij)
x_i' = x_i + C * sum_j (x_i - x_j) phi_x(m_ij)
h_i' = phi_h(h_i, sum_j m_ij)

Config egnn: 4 layers, d_hidden=64, E(n) equivariance via scalar-distance
messages.  On the kernel route the node gathers (features and positions)
and the sums by destination run on the kernels over the batch's edge plan.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.backend import resolve_device
from repro_torch.models.gnn.common import (GraphBatch, batch_plan, gather,
                                           graph_pool, mlp_apply, mlp_params,
                                           node_loss, scatter_mean,
                                           scatter_sum)


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 64
    n_classes: int = 16
    graph_level: bool = False


def init_params(cfg: EGNNConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random weights from ``generator``, which must live on ``device`` (the
    card by default)."""
    dev = resolve_device(device)
    layers = []
    for i in range(cfg.n_layers):
        d_in = cfg.d_in if i == 0 else cfg.d_hidden
        d = cfg.d_hidden
        layers.append({
            "phi_e": mlp_params(generator, (2 * d_in + 1, d, d), dev),
            "phi_x": mlp_params(generator, (d, d, 1), dev),
            "phi_h": mlp_params(generator, (d_in + d, d, d), dev),
        })
    return {"layers": layers,
            "head": mlp_params(generator, (cfg.d_hidden, cfg.n_classes),
                               dev)}


def forward(params, cfg: EGNNConfig, g: GraphBatch, impl: str = "cuda"):
    plan = batch_plan(g, impl)
    h = g.x
    pos = g.pos
    n = g.num_nodes
    for lp in params["layers"]:
        diff = (gather(pos, g, "src", impl, plan)
                - gather(pos, g, "dst", impl, plan))              # x_i - x_j
        d2 = torch.sum(diff * diff, dim=-1, keepdim=True)
        m = mlp_apply(lp["phi_e"],
                      torch.cat([gather(h, g, "dst", impl, plan),
                                 gather(h, g, "src", impl, plan), d2], -1),
                      final_act=True)
        # coordinate update (mean-normalized sum for stability)
        xw = mlp_apply(lp["phi_x"], m)                            # [E, 1]
        dx = scatter_mean(diff * torch.tanh(xw), g.edge_dst, g.edge_valid, n,
                          impl, plan)
        pos = pos - dx                                            # move toward
        agg = scatter_sum(m, g.edge_dst, g.edge_valid, n, impl, plan)
        upd = mlp_apply(lp["phi_h"], torch.cat([h, agg], -1))
        h = (h + upd) if h.shape[-1] == upd.shape[-1] else upd
        h = torch.where(g.node_valid[:, None], h, 0.0)
        pos = torch.where(g.node_valid[:, None], pos, 0.0)
    if cfg.graph_level:
        ng = g.labels.shape[0] if g.labels is not None else 1
        pooled = graph_pool(h, g.graph_id, g.node_valid, ng)
        return mlp_apply(params["head"], pooled)
    return mlp_apply(params["head"], h)


def loss_fn(params, cfg: EGNNConfig, g: GraphBatch, impl: str = "cuda"):
    return node_loss(forward(params, cfg, g, impl), g, cfg.graph_level)
