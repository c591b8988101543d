"""DCN-v2 [arXiv:2008.13535]: 13 dense + 26 sparse (Criteo), 3 cross
layers, deep MLP. Counterpart of ``repro/configs/dcn_v2.py``."""
from repro_torch.configs.base import RECSYS_SHAPES, RecSysConfig, scaled

CONFIG = RecSysConfig(
    name="dcn-v2", kind="dcn_v2", embed_dim=16,
    n_dense=13, n_sparse=26, n_cross_layers=3, mlp_dims=(1024, 1024, 512),
    tables={f"cat_{i}": 1_000_000 for i in range(26)},
    interaction="cross",
)
SHAPES = RECSYS_SHAPES


def reduced() -> RecSysConfig:
    return scaled(CONFIG, name="dcn-v2-smoke", embed_dim=8, n_dense=4, n_sparse=6,
                  n_cross_layers=2, mlp_dims=(32, 16),
                  tables={f"cat_{i}": 128 for i in range(6)})
