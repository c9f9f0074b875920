"""egnn [arXiv:2102.09844]: 4 layers, d_hidden=64, E(n) equivariance."""
from repro_torch.models.gnn.egnn import EGNNConfig

FAMILY = "gnn"
SKIP_SHAPES = {}
MODULE = "egnn"
NEEDS_POS = True


def full_config(d_in=64, n_classes=16, graph_level=False) -> EGNNConfig:
    return EGNNConfig(name="egnn", n_layers=4, d_hidden=64, d_in=d_in,
                      n_classes=n_classes, graph_level=graph_level)


def smoke_config() -> EGNNConfig:
    return EGNNConfig(name="egnn-smoke", n_layers=2, d_hidden=16, d_in=8,
                      n_classes=3)
