"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention block.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64
[arXiv:2411.15242; unverified].  The shared transformer block (one parameter
set, applied every 6 mamba blocks on concat(hidden, embedding)) is Zamba's
signature; per-application LoRA deltas are omitted (DESIGN.md §5).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_heads=112,          # d_inner 7168 / head_dim 64
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=2,
    shared_attn_every=6,
    rope_theta=10000.0,
    source="arXiv:2411.15242",
)
