"""DeepSeekMoE-16B [arXiv:2401.06066; hf]: fine-grained MoE, 2 shared + 64
routed experts top-6, one leading dense layer. Counterpart of
``repro/configs/deepseek_moe_16b.py``."""
from repro_torch.configs.base import LM_SHAPES, LMConfig, MoEConfig, scaled

CONFIG = LMConfig(
    name="deepseek-moe-16b",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944,                      # first dense layer width (DeepSeekMoE)
    vocab_size=102400,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
    first_k_dense=1,
    norm_eps=1e-6, rope_theta=10000.0,
)
SHAPES = LM_SHAPES


def reduced() -> LMConfig:
    return scaled(CONFIG, name="deepseek-moe-16b-smoke", n_layers=2,
                  d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=96,
                  vocab_size=256,
                  moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                                n_shared=1),
                  remat=False)
