"""Graph neural networks of the port: GIN, PNA and EGNN over padded-COO
batches, and Equiformer-v2 with its SO(3) code (``repro.models.gnn``)."""
from repro_torch.models.gnn.common import EdgePlan, GraphBatch, edge_plan
from repro_torch.models.gnn import egnn, equiformer_v2, gin, pna, so3
