"""Phi-3-mini 3.8B [arXiv:2404.14219]: dense, RoPE, SwiGLU, GQA kv=32
(== MHA). Counterpart of ``repro/configs/phi3_mini_3_8b.py``."""
from repro_torch.configs.base import LM_SHAPES, LMConfig, scaled

CONFIG = LMConfig(
    name="phi3-mini-3.8b",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    norm_eps=1e-5, rope_theta=10000.0,
)
SHAPES = LM_SHAPES


def reduced() -> LMConfig:
    return scaled(CONFIG, name="phi3-mini-smoke", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                  vocab_size=256, remat=False)
