"""internvl2-2b [vlm]: InternViT frontend (STUB) + InternLM2-1.8b backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553 [arXiv:2404.16821; hf].
``input_specs()`` provides precomputed patch embeddings (256 visual tokens
after pixel-shuffle), prepended to the text sequence.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=92553,
    frontend_tokens=256,
    rope_theta=1_000_000.0,
    source="arXiv:2404.16821",
)
