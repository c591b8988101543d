"""DeepSeek-Coder-33B [arXiv:2401.14196; hf]: llama-arch dense, GQA kv=8.
Counterpart of ``repro/configs/deepseek_coder_33b.py``."""
from repro_torch.configs.base import LM_SHAPES, LMConfig, scaled

CONFIG = LMConfig(
    name="deepseek-coder-33b",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab_size=32256,
    norm_eps=1e-6, rope_theta=100000.0,
)
SHAPES = LM_SHAPES


def reduced() -> LMConfig:
    return scaled(CONFIG, name="deepseek-coder-smoke", n_layers=2,
                  d_model=64, n_heads=8, n_kv_heads=2, head_dim=8, d_ff=160,
                  vocab_size=256, remat=False)
