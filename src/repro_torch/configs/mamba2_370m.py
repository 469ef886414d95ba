"""mamba2-370m [ssm]: attention-free SSD (state-space duality).

48L d_model=1024 d_ff=0 vocab=50280, ssm_state=128 [arXiv:2405.21060].
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_head=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_heads=32,           # d_inner 2048 / head_dim 64
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
