"""GAT on Cora [arXiv:1710.10903]: 2 layers, 8 hidden x 8 heads, attn
aggregator. Counterpart of ``repro/configs/gat_cora.py``."""
from repro_torch.configs.base import GNN_SHAPES, GNNConfig, scaled

CONFIG = GNNConfig(name="gat-cora", n_layers=2, d_hidden=8, n_heads=8,
                   aggregator="attn")
SHAPES = GNN_SHAPES


def reduced() -> GNNConfig:
    return scaled(CONFIG, name="gat-smoke", n_layers=2, d_hidden=4, n_heads=2)
