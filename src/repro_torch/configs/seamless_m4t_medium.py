"""seamless-m4t-medium [audio]: encoder-decoder transformer backbone.

12L(+12L dec) d_model=1024 16H (kv=16) d_ff=4096 vocab=256206
[arXiv:2308.11596; hf].  The speech frontend is a STUB: ``input_specs()``
provides precomputed frame embeddings (DESIGN.md §5); the text decoder is a
standard causal transformer with cross-attention.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,            # decoder layers
    n_encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab_size=256206,
    frontend_tokens=1024,   # precomputed speech frames fed to the encoder
    rope_theta=10_000.0,
    source="arXiv:2308.11596",
)
