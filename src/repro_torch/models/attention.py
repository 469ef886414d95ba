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
  partials over a leading shard axis; :func:`combine_split_kv` the same
  over a list of shards.
* :func:`sharded_decode_attend` — the sequence-sharded decode op: the
  cache's S axis split over a mesh (``launch/mesh.py``), one list entry a
  shard; the new token written on the shard that owns its position, the
  backend's split-KV form over each shard's slice, and the partials
  merged by lse (:func:`seq_shard_bounds`, :func:`insert_kv_local`).

Decode caches use the layout ``[B, KV, S, D]`` (the decode kernel's), so
the CUDA kernel, the dense oracle and the chunked scan read the same
buffers.  All math accumulates in fp32: bf16 operands are widened to fp32
before each product, which gives the products of the reference's
``preferred_element_type=float32`` einsums exactly, and the probabilities
are rounded to the value dtype before ``p @ v`` as the reference rounds
them.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils.checkpoint

ACC = torch.float32
NEG_INF = -1e30

__all__ = ["full_attention", "chunked_causal_attention", "decode_attention",
           "decode_attention_dense", "combine_split_kv_stacked",
           "combine_split_kv", "seq_shard_bounds", "shard_devices",
           "insert_kv_local", "ShardStep", "seq_shard_plan",
           "sharded_decode_attend"]


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

    def q_body(qi: int, q_blk: torch.Tensor) -> torch.Tensor:
        q_blk = q_blk.to(ACC)                        # [B, KV, G, q_chunk, D]
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
        return acc / l.clamp_min(1e-30)[..., None]

    # Checkpoint per q-chunk, as the reference does: autograd through the
    # kv loop would keep every chunk's probability block, O(Sq·Sk)
    # residuals; recomputing a q-chunk row in the backward pass bounds them
    # to one row.
    records = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for qi in range(n_q):
        if records:
            outs.append(torch.utils.checkpoint.checkpoint(
                q_body, qi, qs[qi], use_reentrant=False))
        else:
            outs.append(q_body(qi, qs[qi]))
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


def combine_split_kv(outs: Sequence[torch.Tensor],
                     lses: Sequence[torch.Tensor]) -> torch.Tensor:
    """The cross-shard merge of sequence-sharded decode over a list of
    shards: ``outs[d] [B, 1, H, D]`` (normalized partials) and ``lses[d]
    [B, 1, H]``, shard ``d`` on its mesh entry's device → fp32 ``[B, 1, H,
    D]`` on the first shard's device.  The reference's ``pmax`` and
    ``psum`` become a max and a sum over the list, in shard order: ``m =
    max(lse)``, ``w = exp(lse - m)``, ``sum(out · w) / max(sum(w),
    1e-30)``.  A shard with no valid position has ``lse ≈ -1e30``, so its
    weight is 0; over one shard the weight is exactly 1 and the result is
    the partial, widened."""
    dev = outs[0].device
    return combine_split_kv_stacked(
        torch.stack([o.to(dev) for o in outs]).to(ACC),
        torch.stack([lse.to(dev) for lse in lses]).to(ACC))


def seq_shard_bounds(shard: int, s_local: int) -> Tuple[int, int]:
    """``(offset, shard)`` of shard ``shard``'s slice of a cache whose S
    axis is split into slices of ``s_local`` positions in shard order."""
    return int(shard) * int(s_local), int(shard)


def shard_devices(mesh) -> List[torch.device]:
    """The shard list's devices: a :class:`repro_torch.launch.mesh.Mesh`'s
    entries row-major (the reference composes several axis names
    row-major), or a sequence of devices as it is (``"cuda"`` resolved to
    the current device's index)."""
    from repro_torch.launch.mesh import resolve_device

    flat = getattr(mesh, "flat", None)
    return [resolve_device(d) for d in (flat() if flat is not None else mesh)]


@functools.lru_cache(maxsize=None)
def _arange(n: int, device: torch.device) -> torch.Tensor:
    """``arange(n)`` on ``device``, made once: the row index of every
    layer's write, so a step launches no kernel to rebuild it."""
    return torch.arange(n, device=device)


def insert_kv_local(cache: torch.Tensor, update: torch.Tensor,
                    local_pos: torch.Tensor, owned: torch.Tensor) -> torch.Tensor:
    """Write a one-token update ``[B, KV, 1, D]`` into a shard's ``[B, KV,
    S_loc, D]`` cache at ``local_pos``, in place, only where ``owned``:
    elsewhere the value there is read back and written again, so a shard
    that does not own the position is left bit-unchanged.  ``local_pos``
    and ``owned`` hold one entry (the batch at one position) or one a
    batch row.  Returns ``cache``."""
    B, KV, _, D = update.shape
    update = update.to(cache.dtype)
    lp = local_pos.long()
    if lp.numel() == 1:
        lp = lp.reshape(1)
        cur = cache.index_select(2, lp)
        cache.index_copy_(2, lp, torch.where(owned.reshape(()), update, cur))
        return cache
    rows = _arange(B, cache.device)
    cur = cache[rows, :, lp]                           # [B, KV, D]
    cache[rows, :, lp] = torch.where(owned.reshape(B, 1, 1),
                                     update.reshape(B, KV, D), cur)
    return cache


class ShardStep(NamedTuple):
    """One shard's part of a decode step: where the new token goes in its
    slice (``local_pos``, int64), whether the shard owns it (``owned``)
    and its valid prefix (``local_len``, int32), each one entry or one a
    batch row, on the shard's device."""

    local_pos: torch.Tensor
    owned: torch.Tensor
    local_len: torch.Tensor


def seq_shard_plan(pos: torch.Tensor, s_local: int, mesh) -> List[ShardStep]:
    """Every shard's :class:`ShardStep` for the new token at global
    position ``pos``, shard ``d`` holding positions ``[d · s_local, (d +
    1) · s_local)``: ``local_pos = clamp(pos - offset, 0, s_local - 1)``,
    ``owned = offset <= pos < offset + s_local``, ``local_len = clamp(pos
    + 1 - offset, 0, s_local)``.  It depends on the step, not the layer:
    a model computes it once a step and hands it to every layer's
    :func:`sharded_decode_attend`."""
    plan = []
    for d, dev in enumerate(shard_devices(mesh)):
        offset, _ = seq_shard_bounds(d, s_local)
        rel = pos.to(dev) - offset
        plan.append(ShardStep(rel.clamp(0, s_local - 1).long(),
                              (rel >= 0) & (rel < s_local),
                              (rel + 1).clamp(0, s_local).to(torch.int32)))
    return plan


def sharded_decode_attend(attn, q: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, k_shards: List[torch.Tensor],
                          v_shards: List[torch.Tensor], pos: torch.Tensor,
                          mesh, plan: Optional[List[ShardStep]] = None):
    """The sequence-sharded decode op, start to finish.

    ``k_shards``/``v_shards``: one ``[B, KV, S_loc, D]`` slice of the
    cache a shard, shard ``d`` on ``mesh``'s entry ``d``
    (:func:`shard_devices`) and holding global positions ``[d · S_loc,
    (d + 1) · S_loc)``.  ``pos``: the new token's global position, an int
    tensor of one element or one a batch row (``plan``, where given, is
    :func:`seq_shard_plan` of it, and ``pos`` is not read).  Each shard
    writes the new ``k_new``/``v_new [B, KV, 1, D]`` if it owns ``pos``
    (:func:`insert_kv_local`, in place) and runs ``attn.decode_partial``
    over its slice with the shard-local valid prefix ``clamp(pos + 1 -
    offset, 0, S_loc)``, a row at a time where ``pos`` has one a row; the
    partials merge by lse (:func:`combine_split_kv`).  Shard 0 always
    holds position 0, so the merge always has a valid shard.  Returns
    ``(o [B, 1, H, D] fp32 on q's device, k_shards, v_shards)``.  The
    model families and the tests call this one recipe."""
    devices = shard_devices(mesh)
    if not (len(devices) == len(k_shards) == len(v_shards)):
        raise ValueError(f"a mesh of {len(devices)} entries takes as many "
                         f"shards, got {len(k_shards)} and {len(v_shards)}")
    s_local = int(k_shards[0].shape[2])
    if plan is None:
        plan = seq_shard_plan(pos, s_local, devices)
    outs, lses = [], []
    for d, (kc, vc, dev, step) in enumerate(zip(k_shards, v_shards, devices,
                                                plan)):
        if kc.shape[2] != s_local or vc.shape != kc.shape:
            raise ValueError(f"shard {d}'s cache {tuple(kc.shape)} and "
                             f"{tuple(vc.shape)} do not match shard 0's "
                             f"S_loc {s_local}")
        if kc.device != dev or vc.device != dev:
            raise ValueError(f"shard {d} is on {kc.device}, its mesh entry "
                             f"on {dev}")
        insert_kv_local(kc, k_new.to(dev), step.local_pos, step.owned)
        insert_kv_local(vc, v_new.to(dev), step.local_pos, step.owned)
        o, lse = attn.decode_partial(q.to(dev), kc, vc, step.local_len)
        outs.append(o)
        lses.append(lse)
    return combine_split_kv(outs, lses).to(q.device), k_shards, v_shards
