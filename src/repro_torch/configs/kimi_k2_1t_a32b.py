"""kimi-k2-1t-a32b [moe]: trillion-parameter MoE (paper-table config).

61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, 384 experts top-8
+ 1 shared expert [arXiv:2501.kimi2; unverified].  moe_d_ff=2048 per expert;
dense d_ff applies to the first dense layer.  Adafactor keeps optimizer
state within the 16GB/chip HBM budget at 512 chips (DESIGN.md §6).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=18432,             # dense first layer (deepseek-v3-style)
    vocab_size=163840,
    n_experts=384,
    n_shared_experts=1,
    experts_per_token=8,
    moe_d_ff=2048,
    first_dense_layers=1,
    optimizer="adafactor",
    rope_theta=50_000.0,
    source="arXiv:2501.kimi2 (paper table)",
)
