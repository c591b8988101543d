"""Wide&Deep [arXiv:1606.07792]: 40 sparse fields, wide cross + deep MLP
1024-512-256. Counterpart of ``repro/configs/wide_deep.py``."""
from repro_torch.configs.base import RECSYS_SHAPES, RecSysConfig, scaled

CONFIG = RecSysConfig(
    name="wide-deep", kind="wide_deep", embed_dim=32,
    n_sparse=40, mlp_dims=(1024, 512, 256),
    tables={f"sparse_{i}": 1_000_000 for i in range(40)},
    multi_hot={"sparse_38": 8, "sparse_39": 8},  # two multi-hot fields -> embedding bags
    interaction="concat",
)
SHAPES = RECSYS_SHAPES


def reduced() -> RecSysConfig:
    return scaled(CONFIG, name="wide-deep-smoke", embed_dim=8, n_sparse=6,
                  mlp_dims=(32, 16), tables={f"sparse_{i}": 128 for i in range(6)},
                  multi_hot={"sparse_4": 4, "sparse_5": 4})
