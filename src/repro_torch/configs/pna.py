"""pna [arXiv:2004.05718]: 4 layers, d_hidden=75, aggregators
mean/max/min/std, scalers identity/amplification/attenuation."""
from repro_torch.models.gnn.pna import PNAConfig

FAMILY = "gnn"
SKIP_SHAPES = {}
MODULE = "pna"
NEEDS_POS = False


def full_config(d_in=75, n_classes=16, graph_level=False) -> PNAConfig:
    return PNAConfig(name="pna", n_layers=4, d_hidden=75, d_in=d_in,
                     n_classes=n_classes, graph_level=graph_level)


def smoke_config() -> PNAConfig:
    return PNAConfig(name="pna-smoke", n_layers=2, d_hidden=12, d_in=8,
                     n_classes=3)
