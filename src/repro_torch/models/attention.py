"""Attention score computation: chunked (flash-style) softmax streaming.

Entry points:

* :func:`chunked_causal_attention` — prefill.  Never materializes the full
  [Sq, Sk] score matrix: loops over KV chunks with running (max, sum, acc).
* :func:`decode_attention` — single-query attention against a KV cache,
  looping over KV chunks; with ``return_lse`` it returns the normalized
  partial and its logsumexp for a split-KV combine.
* :func:`decode_attention_dense` — the same over the whole cache at once,
  the parity oracle of the decode backends.
* :func:`full_attention` — naive reference for tests.
* :func:`combine_split_kv_stacked` — the lse-weighted merge of split-KV
  partials over a leading shard axis.

Decode caches use the layout ``[B, KV, S, D]`` (the decode kernel's), so
the CUDA kernel, the dense oracle and the chunked scan read the same
buffers.  All math accumulates in fp32: bf16 operands are widened to fp32
before each product, which gives the products of the reference's
``preferred_element_type=float32`` einsums exactly, and the probabilities
are rounded to the value dtype before ``p @ v`` as the reference rounds
them.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch

ACC = torch.float32
NEG_INF = -1e30

__all__ = ["full_attention", "chunked_causal_attention", "decode_attention",
           "decode_attention_dense", "combine_split_kv_stacked"]


def _valid(cache_len, S: int, ndim: int, device) -> torch.Tensor:
    """The mask ``position < cache_len`` over ``S`` key positions, shaped to
    broadcast against scores of ``ndim`` dims (batch first, key position
    last).  ``cache_len``: an int, a tensor of one element (one length for
    the batch: an ``[S]`` mask), or an int tensor of one length per batch
    row (a ``[B, 1, ..., S]`` mask)."""
    pos = torch.arange(S, device=device)
    if not isinstance(cache_len, torch.Tensor):
        return pos < int(cache_len)
    if cache_len.numel() == 1:
        return pos < cache_len.reshape(())
    return pos < cache_len.reshape((-1,) + (1,) * (ndim - 1))


def _sqrt_d(D: int) -> float:
    """sqrt(D) in fp32, as a Python float (a scalar operand needs no
    host-to-device copy)."""
    return float(np.float32(math.sqrt(D)))


def _scale(D: int) -> float:
    """1/sqrt(D) rounded as the reference rounds it: an fp32 divide."""
    return float(np.float32(1.0) / np.float32(_sqrt_d(D)))


def _pv(p: torch.Tensor, v: torch.Tensor, eq: str) -> torch.Tensor:
    """``einsum(eq, p, v)`` with ``p`` rounded to ``v``'s dtype first and
    the product accumulated in fp32."""
    return torch.einsum(eq, p.to(v.dtype).to(ACC), v.to(ACC))


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B,Sq,H,D], k [B,Sk,KV,D] → scores [B,KV,G,Sq,Sk] (H = KV·G)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    return torch.einsum("bqkgd,bskd->bkgqs", qg.to(ACC), k.to(ACC))


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Naive reference (materializes scores) — test oracle only."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scores = _gqa_scores(q, k) / _sqrt_d(D)
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(Sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = _pv(w, v, "bkgqs,bskd->bqkgd")
    return out.reshape(B, Sq, H, D).to(q.dtype)


def chunked_causal_attention(
    q: torch.Tensor,            # [B, Sq, H, D]
    k: torch.Tensor,            # [B, Sk, KV, D]
    v: torch.Tensor,            # [B, Sk, KV, D]
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    causal: bool = True,
    q_offset: int = 0,          # global position of q[0] (prefill continuation)
) -> torch.Tensor:
    """Flash-style attention: O(Sq·Sk) compute, O(chunk²) memory."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    n_q = -(-Sq // q_chunk)
    n_k = -(-Sk // kv_chunk)
    pad_q = n_q * q_chunk - Sq
    pad_k = n_k * kv_chunk - Sk
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    dev = q.device
    # [B, n, chunk, KV, (G,) D] → chunk-major views
    qs = q.reshape(B, n_q, q_chunk, KV, G, D).permute(1, 0, 3, 4, 2, 5)
    ks = k.reshape(B, n_k, kv_chunk, KV, D).permute(1, 0, 3, 2, 4)
    vs = v.reshape(B, n_k, kv_chunk, KV, D).permute(1, 0, 3, 2, 4)
    scale = _scale(D)
    kv_valid = (torch.arange(n_k * kv_chunk, device=dev) < Sk).reshape(n_k, kv_chunk)

    outs = []
    for qi in range(n_q):
        q_blk = qs[qi].to(ACC)                       # [B, KV, G, q_chunk, D]
        m = torch.full((B, KV, G, q_chunk), NEG_INF, dtype=ACC, device=dev)
        l = torch.zeros((B, KV, G, q_chunk), dtype=ACC, device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, D), dtype=ACC, device=dev)
        for kj in range(n_k):
            s = torch.einsum("bkgqd,bksd->bkgqs", q_blk, ks[kj].to(ACC)) * scale
            if causal:
                qpos = qi * q_chunk + torch.arange(q_chunk, device=dev) + q_offset
                kpos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
                mask = (qpos[:, None] >= kpos[None, :]) & kv_valid[kj][None, :]
            else:
                mask = kv_valid[kj][None, :].expand(q_chunk, kv_chunk)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _pv(p, vs[kj], "bkgqs,bksd->bkgqd")
            m = m_new
        outs.append(acc / l.clamp_min(1e-30)[..., None])
    out = torch.stack(outs)                          # [n_q, B, KV, G, q_chunk, D]
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(B, n_q * q_chunk, H, D)
    return out[:, :Sq].to(q.dtype)


def decode_attention(
    q: torch.Tensor,            # [B, 1, H, D] — one new token
    k_cache: torch.Tensor,      # [B, KV, S, D]
    v_cache: torch.Tensor,      # [B, KV, S, D]
    cache_len=None,             # valid prefix (≤ S): int, or tensor of 1 or B
    kv_chunk: int = 2048,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Streaming single-token attention over the cache, chunk by chunk.

    With ``return_lse=True`` returns the *normalized* partial output (fp32)
    plus its logsumexp, so partials over slices of the sequence combine as
    an lse-weighted average (:func:`combine_split_kv_stacked`).
    """
    B, _, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    kv_chunk = min(kv_chunk, S)
    n_k = -(-S // kv_chunk)
    pad = n_k * kv_chunk - S
    if pad:
        k_cache = torch.nn.functional.pad(k_cache, (0, 0, 0, pad))
        v_cache = torch.nn.functional.pad(v_cache, (0, 0, 0, pad))
    dev = q.device
    qg = q.reshape(B, KV, G, D).to(ACC)
    scale = _scale(D)
    valid_all = _valid(S if cache_len is None else cache_len, n_k * kv_chunk,
                       4, dev)
    m = torch.full((B, KV, G), NEG_INF, dtype=ACC, device=dev)
    l = torch.zeros((B, KV, G), dtype=ACC, device=dev)
    acc = torch.zeros((B, KV, G, D), dtype=ACC, device=dev)
    for kj in range(n_k):
        sl = slice(kj * kv_chunk, (kj + 1) * kv_chunk)
        k_blk, v_blk = k_cache[:, :, sl], v_cache[:, :, sl]
        s = torch.einsum("bkgd,bksd->bkgs", qg, k_blk.to(ACC)) * scale
        s = torch.where(valid_all[..., sl], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _pv(p, v_blk, "bkgs,bksd->bkgd")
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    if return_lse:
        lse = m + torch.log(l.clamp_min(1e-30))
        return out.reshape(B, 1, H, D), lse.reshape(B, 1, H)
    return out.reshape(B, 1, H, D).to(q.dtype)


def decode_attention_dense(
    q: torch.Tensor,            # [B, 1, H, D]
    k_cache: torch.Tensor,      # [B, KV, S, D]
    v_cache: torch.Tensor,      # [B, KV, S, D]
    cache_len,                  # valid prefix: int, or tensor of 1 or B
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Single-token attention over the full cache, no chunking.

    ``return_lse=True`` returns ``(out [B,1,H,D] fp32 normalized partial,
    lse [B,1,H])``.
    """
    B, _, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    dev = q.device
    qg = q.reshape(B, 1, KV, G, D).to(ACC)
    scale = _scale(D)
    s = torch.einsum("bqkgd,bksd->bkgqs", qg, k_cache.to(ACC)) * scale
    s = torch.where(_valid(S if cache_len is None else cache_len, S, 5, dev), s,
                    torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = _pv(p / l.clamp_min(1e-30), v_cache, "bkgqs,bksd->bqkgd")
    if return_lse:
        lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0, 0]  # [B, KV, G]
        return out.reshape(B, 1, H, D), lse.reshape(B, 1, H)
    return out.reshape(B, 1, H, D).to(q.dtype)


def combine_split_kv_stacked(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """Merge split-KV partials over a leading shard axis: ``outs [n, B, 1,
    H, D]``, ``lses [n, B, 1, H]`` → ``[B, 1, H, D]``.  A shard with no
    valid positions has ``lse ≈ -1e30`` and weight 0."""
    m = lses.amax(dim=0)
    w = torch.exp(lses - m)
    num = (outs * w[..., None]).sum(dim=0)
    den = w.sum(dim=0)
    return num / den[..., None].clamp_min(1e-30)
