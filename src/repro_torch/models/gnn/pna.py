"""PNA (Principal Neighbourhood Aggregation) — arXiv:2004.05718, as
``repro.models.gnn.pna``.

Four aggregators (mean, max, min, std) x three degree scalers
(identity, amplification, attenuation) -> 12-way concatenation -> linear.
Config pna: 4 layers, d_hidden=75.  On the kernel route the message's
gathers and the two means run on the kernels over the batch's edge plan;
max and min stay plain.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.backend import resolve_device
from repro_torch.models.gnn.common import (GraphBatch, batch_plan, gather,
                                           graph_pool, in_degree, mlp_apply,
                                           mlp_params, node_loss,
                                           scatter_max, scatter_mean,
                                           scatter_min)


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 75
    n_classes: int = 16
    delta: float = 2.5                # avg log-degree normalizer
    graph_level: bool = False


def init_params(cfg: PNAConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random weights from ``generator``, which must live on ``device`` (the
    card by default)."""
    dev = resolve_device(device)
    layers = []
    for i in range(cfg.n_layers):
        d_in = cfg.d_in if i == 0 else cfg.d_hidden
        layers.append({
            "pre": mlp_params(generator, (2 * d_in, cfg.d_hidden), dev),
            "post": mlp_params(generator,
                               (12 * cfg.d_hidden + d_in, cfg.d_hidden), dev),
        })
    return {"layers": layers,
            "head": mlp_params(generator, (cfg.d_hidden, cfg.n_classes),
                               dev)}


def forward(params, cfg: PNAConfig, g: GraphBatch, impl: str = "cuda"):
    plan = batch_plan(g, impl)
    h = g.x
    n = g.num_nodes
    deg = in_degree(g, impl, plan)
    logd = torch.log1p(deg)
    amp = (logd / cfg.delta)[:, None]
    att = (cfg.delta / torch.clamp(logd, min=1e-3))[:, None]
    zero = h.new_zeros(())
    for lp in params["layers"]:
        msg = mlp_apply(lp["pre"],
                        torch.cat([gather(h, g, "src", impl, plan),
                                   gather(h, g, "dst", impl, plan)], -1),
                        final_act=True)
        mean = scatter_mean(msg, g.edge_dst, g.edge_valid, n, impl, plan)
        mx = scatter_max(msg, g.edge_dst, g.edge_valid, n)
        mn = scatter_min(msg, g.edge_dst, g.edge_valid, n)
        sq = scatter_mean(msg * msg, g.edge_dst, g.edge_valid, n, impl, plan)
        # maximum, not clamp: a tie at 0 (a node of degree <= 1) shares the
        # gradient, as jnp.maximum's does
        std = torch.sqrt(torch.maximum(sq - mean * mean, zero) + 1e-5)
        aggs = torch.cat([mean, mx, mn, std], dim=-1)              # [N, 4d]
        scaled = torch.cat([aggs, aggs * amp, aggs * att], -1)     # 12d
        h = mlp_apply(lp["post"], torch.cat([scaled, h], -1),
                      final_act=True)
        h = torch.where(g.node_valid[:, None], h, 0.0)
    if cfg.graph_level:
        ng = g.labels.shape[0] if g.labels is not None else 1
        pooled = graph_pool(h, g.graph_id, g.node_valid, ng)
        return mlp_apply(params["head"], pooled)
    return mlp_apply(params["head"], h)


def loss_fn(params, cfg: PNAConfig, g: GraphBatch, impl: str = "cuda"):
    return node_loss(forward(params, cfg, g, impl), g, cfg.graph_level)
