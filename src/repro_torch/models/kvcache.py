"""KV caches for serving.

Layout: ``{"k": [L, B, KV, S_cap, D], "v": same, "length": int32 scalar
tensor}`` — the decode kernel's layout, with the capacity ``S_cap`` padded
to the attention backend's ``block_k`` multiple at prefill
(:class:`repro_torch.core.backends.KVCacheLayout`), so the per-step decode
reads the buffers as they are.  ``length`` is the valid prefix, the same
for the whole batch, and lives on the cache's device so a decode loop
never reads it back to the host.

Unlike the reference's functional ``dynamic_update_slice``, the updates
here write into the cache in place: a full-size cache is hundreds of MB,
and copying it every step would cost more than the step.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.backends import KVCacheLayout

Cache = Dict[str, torch.Tensor]

__all__ = ["KVCacheLayout", "init_attn_cache", "pad_kv_to_layout",
           "update_layer_kv"]


def init_attn_cache(
    n_layers: int, batch: int, max_len: int, n_kv: int, d_head: int,
    dtype=torch.bfloat16, layout: KVCacheLayout = KVCacheLayout(),
    device="cpu",
) -> Cache:
    shape = (n_layers, batch, n_kv, layout.padded_len(max_len), d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


def pad_kv_to_layout(k: torch.Tensor, max_len: int,
                     layout: KVCacheLayout = KVCacheLayout()) -> torch.Tensor:
    """[B, S, KV, D] prefill projections → [B, KV, S_cap, D], zero beyond S."""
    k = k.transpose(1, 2)
    pad = layout.padded_len(max_len) - k.shape[2]
    return torch.nn.functional.pad(k, (0, 0, 0, pad)) if pad else k.contiguous()


def update_layer_kv(cache: Cache, layer: int, k_new: torch.Tensor,
                    v_new: torch.Tensor, position: int) -> Cache:
    """Write [B, S_new, KV, D] at sequence offset ``position`` of ``layer``,
    in place.  Returns ``cache``."""
    n = k_new.shape[1]
    for key, new in (("k", k_new), ("v", v_new)):
        buf = cache[key][layer]
        buf[:, :, position:position + n] = new.transpose(1, 2).to(buf.dtype)
    return cache
