"""deepseek-moe-16b [moe]: 2 shared + 64 routed top-6, fine-grained experts.

28L d_model=2048 16H (kv=16) d_ff=1408(expert) vocab=102400
[arXiv:2401.06066; hf].  Layer 0 is dense with d_ff=10944.

This preset routes as the reference does (a softmax over the 6 chosen
logits, capacity factor 1.25, an fp32 decode cache), so the differential
tests compare like with like.  The published model (HF
``deepseek-ai/deepseek-moe-16b-base``'s ``config.json``: ``scoring_func``
softmax, ``norm_topk_prob`` false, ``topk_method`` greedy, no token
dropped at inference) is ``dataclasses.replace(CONFIG,
moe_norm_topk_prob=False, moe_capacity_factor=None)``, served with
``moe_cache_dtype="bfloat16"``, the weights' dtype (the benchmark's
``portbench/configs/deepseek-moe-16b.json``).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=10944,             # dense first layer
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    rope_theta=10_000.0,
    source="arXiv:2401.06066",
)
