"""Plain PyTorch version of the split-KV decode kernel.

It is the CPU path of ``ops.decode_mha`` and the oracle the CUDA kernel is
held against on the card.  The math is the TPU kernel's, in fp32, in one
pass instead of KV blocks: scores scaled by ``1/sqrt(D)``, positions at or
beyond ``cache_len`` set to ``-1e30`` (so ``cache_len = 0`` gives the mean
of V over the whole capacity), the probabilities kept in fp32 for the
``p @ v`` product, and ``l`` clamped at ``1e-30``.  ``cache_len`` is one
length for the whole batch or one per batch row.

The paged form (:func:`decode_attention_paged_ref`) takes K and V as the
serving pool's pages and a block table: a plain gather by the table into
the contiguous layout, then the same math, so it equals the contiguous form
over the gathered copy bit for bit.
"""

from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "decode_attention_ref", "decode_attention_paged_ref",
           "gather_pages"]

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


def gather_pages(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """One layer's pages ``[num_blocks, KV, block_k, D]`` through the block
    table ``[B, table_width]`` (page ids, any integer dtype) -> the
    contiguous cache ``[B, KV, table_width * block_k, D]``: key t of row b
    is row ``t % block_k`` of page ``table[b, t // block_k]``."""
    B, W = table.shape
    _, KV, bk, D = pages.shape
    return (pages[table.long()].permute(0, 2, 1, 3, 4)
            .reshape(B, KV, W * bk, D))


def decode_attention_paged_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, table: torch.Tensor,
                               cache_len):
    """``q [B,H,D]``, ``k_pages``/``v_pages [num_blocks,KV,block_k,D]``, the
    block table ``[B, table_width]`` and ``cache_len`` as in
    :func:`decode_attention_ref`, over a capacity of ``table_width *
    block_k`` -> ``(out [B,H,D] in q.dtype, lse [B,H] fp32)``."""
    return decode_attention_ref(q, gather_pages(k_pages, table),
                                gather_pages(v_pages, table), cache_len)
