"""Plain PyTorch version of the flash-attention prefill kernel.

It is the CPU path of ``ops.mha`` and the oracle the CUDA kernel is held
against on the card.  As in the JAX package, it reuses the model-side naive
attention (``models.attention.full_attention``, which works in the
``[B, S, H, D]`` layout) with the transposes around it.  ``full_attention``
rounds the softmax weights to ``v.dtype`` before ``p @ v`` while the kernel
keeps them in fp32; in bf16 the reference's tolerance (2e-2) covers that,
and in fp32 the rounding is the identity.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import full_attention

__all__ = ["flash_attention_ref"]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q [B,H,Sq,D], k/v [B,KV,Sk,D] → o [B,H,Sq,D] (naive softmax)."""
    o = full_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       causal=causal)
    return o.transpose(1, 2)
