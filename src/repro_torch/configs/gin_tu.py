"""gin-tu [arXiv:1810.00826]: 5 layers, d_hidden=64, sum aggregator,
learnable eps."""
from repro_torch.models.gnn.gin import GINConfig

FAMILY = "gnn"
SKIP_SHAPES = {}
MODULE = "gin"
NEEDS_POS = False


def full_config(d_in=64, n_classes=16, graph_level=False) -> GINConfig:
    return GINConfig(name="gin-tu", n_layers=5, d_hidden=64, d_in=d_in,
                     n_classes=n_classes, graph_level=graph_level)


def smoke_config() -> GINConfig:
    return GINConfig(name="gin-smoke", n_layers=2, d_hidden=16, d_in=8,
                     n_classes=3)
