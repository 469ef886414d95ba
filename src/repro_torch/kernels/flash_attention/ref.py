"""Plain PyTorch version of the flash-attention prefill kernel.

It is the CPU path of ``ops.mha`` and the oracle the CUDA kernel is held
against on the card.  As in the JAX package, it reuses the model-side naive
attention (``models.attention.full_attention``, which works in the
``[B, S, H, D]`` layout) with the transposes around it.  ``full_attention``
rounds the softmax weights to ``v.dtype`` before ``p @ v`` while the kernel
keeps them in fp32; in bf16 the reference's tolerance (2e-2) covers that,
and in fp32 the rounding is the identity.

``split_bf16`` mirrors how the kernel's bf16 path feeds an fp32 p to bf16
tensor cores: as three bf16 pieces whose sum is p.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import full_attention

__all__ = ["flash_attention_ref", "split_bf16"]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q [B,H,Sq,D], k/v [B,KV,Sk,D] → o [B,H,Sq,D] (naive softmax)."""
    o = full_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       causal=causal)
    return o.transpose(1, 2)


def split_bf16(p: torch.Tensor):
    """fp32 ``p`` → bf16 ``(hi, mid, lo)``: ``hi = bf16(p)``, ``mid =
    bf16(p - hi)``, ``lo = bf16(p - hi - mid)``, each rounded to nearest
    and each residual exact in fp32.  Their sum is ``p`` exactly for
    ``|p| >= 2**-110``; below that ``lo`` falls on bf16's subnormal grid
    and the sum is within ``2**-134`` of ``p``."""
    hi = p.to(torch.bfloat16)
    rest = p - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return hi, mid, lo
