"""BERT4Rec [arXiv:1904.06690]: bidirectional self-attention over item
sequences. Counterpart of ``repro/configs/bert4rec.py``."""
from repro_torch.configs.base import RECSYS_SHAPES, RecSysConfig, scaled

CONFIG = RecSysConfig(
    name="bert4rec", kind="bert4rec", embed_dim=64,
    n_blocks=2, n_heads=2, seq_len=200,
    tables=dict(item=1_000_000),   # item vocab (ML-20m's 26744 scaled to 1M rows)
    interaction="bidir-seq",
)
SHAPES = RECSYS_SHAPES


def reduced() -> RecSysConfig:
    return scaled(CONFIG, name="bert4rec-smoke", embed_dim=16, n_blocks=2,
                  n_heads=2, seq_len=16, tables=dict(item=512))
