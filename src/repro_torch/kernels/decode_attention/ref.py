"""Plain PyTorch version of the split-KV decode kernel.

It is the CPU path of ``ops.decode_mha`` and the oracle the CUDA kernel is
held against on the card.  The math is the TPU kernel's, in fp32, in one
pass instead of KV blocks: scores scaled by ``1/sqrt(D)``, positions at or
beyond ``cache_len`` set to ``-1e30`` (so ``cache_len = 0`` gives the mean
of V over the whole capacity), the probabilities kept in fp32 for the
``p @ v`` product, and ``l`` clamped at ``1e-30``.  ``cache_len`` is one
length for the whole batch or one per batch row.
"""

from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "decode_attention_ref"]

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len):
    """``q [B,H,D]``, ``k_cache``/``v_cache [B,KV,S,D]``, ``cache_len`` an
    int, an int tensor of one element, or an int tensor of B elements (row
    ``b`` masked at its own length) → ``(out [B,H,D] in q.dtype, lse [B,H]
    fp32)``."""
    B, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.float().reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float()) * (1.0 / math.sqrt(D))
    if isinstance(cache_len, torch.Tensor):
        cache_len = (cache_len.reshape(()) if cache_len.numel() == 1
                     else cache_len.reshape(B, 1, 1, 1))
    valid = torch.arange(S, device=q.device) < cache_len
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return out.reshape(B, H, D).to(q.dtype), lse.reshape(B, H)
