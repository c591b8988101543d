"""Qwen2-1.5B [arXiv:2407.10671; hf]: dense, GQA kv=2, QKV bias, big vocab.
Counterpart of ``repro/configs/qwen2_1_5b.py``."""
from repro_torch.configs.base import LM_SHAPES, LMConfig, scaled

CONFIG = LMConfig(
    name="qwen2-1.5b",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True,
    norm_eps=1e-6, rope_theta=1000000.0,
)
SHAPES = LM_SHAPES


def reduced() -> LMConfig:
    return scaled(CONFIG, name="qwen2-smoke", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                  vocab_size=256, remat=False)
