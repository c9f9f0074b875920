"""Shared GNN shape table (shapes assigned to the GNN family), the port's
copy of ``repro.configs.gnn_common.GNN_SHAPES`` (its ``graph_specs`` builds
JAX shape structs for the dry-run and is not ported).

d_feat / n_classes per shape: full_graph_sm = Cora (1433 feat, 7 classes);
minibatch_lg = Reddit-scale sampled training (602 feat, 41 classes,
fanout 15-10 from 1024 seed nodes); ogb_products (100 feat, 47 classes);
molecule = batched 30-node graphs, graph-level regression.
"""
from __future__ import annotations

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
