"""DIEN [arXiv:1809.03672]: GRU interest extraction + AUGRU interest
evolution. Counterpart of ``repro/configs/dien.py``."""
from repro_torch.configs.base import RECSYS_SHAPES, RecSysConfig, scaled

CONFIG = RecSysConfig(
    name="dien", kind="dien", embed_dim=18,
    seq_len=100, gru_dim=108, mlp_dims=(200, 80),
    tables=dict(item=10_000_000, category=100_000, user=50_000_000),
    interaction="augru",
)
SHAPES = RECSYS_SHAPES


def reduced() -> RecSysConfig:
    return scaled(CONFIG, name="dien-smoke", embed_dim=8, seq_len=8, gru_dim=16,
                  mlp_dims=(16, 8), tables=dict(item=256, category=32, user=128))
