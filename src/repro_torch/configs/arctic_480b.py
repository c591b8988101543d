"""Snowflake Arctic [hf:Snowflake/snowflake-arctic-base]: 128 experts top-2
beside a dense residual MLP in every layer. Counterpart of
``repro/configs/arctic_480b.py``."""
from repro_torch.configs.base import LM_SHAPES, LMConfig, MoEConfig, scaled

CONFIG = LMConfig(
    name="arctic-480b",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual=True, d_ff_dense=4864),
    norm_eps=1e-5, rope_theta=10000.0,
)
SHAPES = LM_SHAPES


def reduced() -> LMConfig:
    return scaled(CONFIG, name="arctic-480b-smoke", n_layers=2, d_model=64,
                  n_heads=8, n_kv_heads=2, head_dim=8, d_ff=96,
                  vocab_size=256,
                  moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                                dense_residual=True, d_ff_dense=32),
                  remat=False)
