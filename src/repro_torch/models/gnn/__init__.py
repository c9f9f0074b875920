"""Graph neural networks of the port: GIN, PNA and EGNN over padded-COO
batches (``repro.models.gnn`` without Equiformer-v2 and its SO(3) code)."""
from repro_torch.models.gnn.common import EdgePlan, GraphBatch, edge_plan
from repro_torch.models.gnn import egnn, gin, pna
