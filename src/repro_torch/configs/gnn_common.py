"""Shared GNN shape table (shapes assigned to the GNN family), the port's
copy of ``repro.configs.gnn_common``; ``graph_specs`` gives a shape's
batch as ``device="meta"`` tensors (JAX's gives shape structs).

d_feat / n_classes per shape: full_graph_sm = Cora (1433 feat, 7 classes);
minibatch_lg = Reddit-scale sampled training (602 feat, 41 classes,
fanout 15-10 from 1024 seed nodes); ogb_products (100 feat, 47 classes);
molecule = batched 30-node graphs, graph-level regression.
"""
from __future__ import annotations

import torch

# capacities padded to multiples of 512; live counts (Cora 2708/10556,
# sampled-Reddit 170368/168960, ogb-products 2449029/61859140, molecule
# 3840/8192) ride inside via the valid masks.
GNN_SHAPES = {
    #                n_nodes     n_edges      d_feat n_cls graph_lvl n_graphs
    "full_graph_sm": (3_072,     10_752,      1433,  7,    False,    1),
    "minibatch_lg":  (170_496,   168_960,     602,   41,   False,    1),
    "ogb_products":  (2_449_408, 61_859_840,  100,   47,   False,    1),
    "molecule":      (4_096,     8_192,       64,    1,    True,     128),
}


def graph_specs(shape_name: str, with_pos: bool):
    """(the batch's fields as ``device="meta"`` tensors, (d_feat, n_classes,
    graph_level))."""
    n, e, f, ncls, glvl, ng = GNN_SHAPES[shape_name]

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    spec = {
        "x": meta((n, f), torch.float32),
        "edge_src": meta((e,), torch.int32),
        "edge_dst": meta((e,), torch.int32),
        "edge_valid": meta((e,), torch.bool),
        "node_valid": meta((n,), torch.bool),
        "graph_id": meta((n,), torch.int32),
        "pos": meta((n, 3), torch.float32) if with_pos else None,
        "edge_attr": None,
        "labels": (meta((ng,), torch.float32) if glvl
                   else meta((n,), torch.int32)),
    }
    return spec, (f, ncls, glvl)
