"""equiformer-v2 [arXiv:2306.12059]: 12 layers, d_hidden=128, l_max=6,
m_max=2, 8 heads, SO(2)-eSCN equivariant graph attention.  The port's own
copy of ``repro.configs.equiformer_v2``."""
from repro_torch.models.gnn.equiformer_v2 import EquiformerV2Config

FAMILY = "gnn"
SKIP_SHAPES = {}
MODULE = "equiformer_v2"
NEEDS_POS = True


def full_config(d_in=128, n_classes=1, graph_level=True) -> EquiformerV2Config:
    return EquiformerV2Config(name="equiformer-v2", n_layers=12, d_hidden=128,
                              l_max=6, m_max=2, n_heads=8, d_in=d_in,
                              n_classes=n_classes, graph_level=graph_level)


def smoke_config() -> EquiformerV2Config:
    return EquiformerV2Config(name="equiformer-v2-smoke", n_layers=2,
                              d_hidden=16, l_max=2, m_max=1, n_heads=4,
                              d_in=8, n_classes=1, n_rbf=8, graph_level=True)
