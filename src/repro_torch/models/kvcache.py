"""KV caches for serving.

Layout: ``{"k": [L, B, KV, S_cap, D], "v": same, "length": int32 scalar
tensor}`` — the decode kernel's layout, with the capacity ``S_cap`` padded
to the attention backend's ``block_k`` multiple at prefill
(:class:`repro_torch.core.backends.KVCacheLayout`), so the per-step decode
reads the buffers as they are.  ``length`` is the valid prefix, the same
for the whole batch (an int32 scalar tensor) or one per batch row (an int32
``[B]`` tensor, as the continuous-batching scheduler keeps it), and lives
on the cache's device so a decode loop never reads it back to the host.
The mamba2 cache (``models/mamba2.py``) holds ``{"conv": {"x", "B", "C"},
"ssm", "length"}``, the hybrid cache (``models/hybrid.py``) the same plus
one ``k``/``v`` stack over its shared-attention sites, and the
encoder-decoder cache (``models/encdec.py``) ``k``/``v`` plus the
cross-attention ``kc``/``vc`` and ``src_length``; every leaf but the
lengths has the layer (or site) axis first and the batch axis second.

A sequence-sharded cache (``decode_step(..., seq_shard_axes=mesh)``, the
continuous-batching scheduler over a mesh) holds each growing ``k``/``v``
stack as a list of shards, ``[L, B, KV, S_loc, D]`` each, shard ``d`` the
positions ``[d · S_loc, (d + 1) · S_loc)`` on the mesh's entry ``d``;
:func:`kv_layer` and :func:`kv_capacity` read either form.

A paged cache (the continuous-batching scheduler's step on one device)
holds each growing ``k``/``v`` stack as a :class:`PagedKV`: the KV pool's
pages ``[num_blocks, L, KV, block_k, D]``, the slots' block table and each
slot's write row for the step, so that a layer writes its new K and V
straight to the page and attention reads the pages through the table
(``transformer._decode_attn``); no contiguous copy of the cache is made.

Unlike the reference's functional ``dynamic_update_slice``, the updates
here write into the cache in place: a full-size cache is hundreds of MB,
and copying it every step would cost more than the step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.backends import KVCacheLayout

Cache = Dict[str, torch.Tensor]

__all__ = ["KVCacheLayout", "PagedKV", "init_attn_cache", "pad_kv_to_layout",
           "update_layer_kv", "seq_axis_tree", "kv_layer", "kv_capacity",
           "check_kv_capacity"]

# Cache-dict keys whose subtrees hold *growing* self-attention KV (sequence
# axis at -2, one new position written per decode step) vs. state that is
# slot-resident in the continuous-batching scheduler (the SSM and conv
# states, the encoder-decoder's cross-attention KV, written once at
# prefill, and the lengths).
_GROWING_KV_KEYS = frozenset({"k", "v"})
_STATIC_KEYS = frozenset({"conv", "ssm", "length", "kc", "vc", "src_length"})


def seq_axis_tree(cache: Any, _path=()) -> Any:
    """A tree matching ``cache`` (nested dicts and lists of tensors) of
    ``Optional[int]``: the sequence axis of every *growing* KV leaf (always
    ``-2`` in the kernel's layout), or ``None`` for slot-resident state.

    This is the single source of truth for which cache leaves the paged
    :class:`repro_torch.serving.kv_pool.KVBlockPool` owns and which the
    scheduler keeps per slot.  The classification is by dict key along the
    path: ``k``/``v`` subtrees grow, unless a key on the path marks
    slot-resident state (``conv``, ``ssm``, ``kc``, ``vc``, the lengths).
    The port's mamba2 conv cache is a dict of ``x``, ``B`` and ``C``
    tails; the ``conv`` key on their path keeps them in the slot.  The moe
    cache's ``stacks`` is a list of ``{k, v}`` dicts, one a block kind; a
    list adds no key to the path.
    Families re-export this as ``cache_seq_axes``.
    """
    if isinstance(cache, dict):
        return {k: seq_axis_tree(v, _path + (k,)) for k, v in cache.items()}
    if isinstance(cache, list):
        return [seq_axis_tree(v, _path) for v in cache]
    if any(k in _STATIC_KEYS for k in _path):
        return None
    if any(k in _GROWING_KV_KEYS for k in _path) and cache.dim() >= 4:
        return -2
    return None


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


@dataclasses.dataclass
class PagedKV:
    """A growing K or V stack left in the KV pool's pages.

    ``pages``: ``[num_blocks, L, KV, block_k, D]`` for the stack, or one
    layer's ``[num_blocks, KV, block_k, D]`` (:func:`kv_layer`); a view of
    the pool's buffer, each page's head a contiguous ``block_k x D`` run.
    ``table``: int32 ``[B, table_width]``, row b's pages in order, so key t
    of row b is row ``t % block_k`` of page ``table[b, t // block_k]`` and
    the capacity is ``table_width * block_k``.  ``rows``: ``(page,
    offset)``, two int64 ``[B]`` tensors, where row b writes this step's
    token (the pool's ``write_rows``: an inactive slot's page is the
    sink).  ``scatter(pages, new, rows)`` writes ``new [B, KV, D]`` there in
    place: the pool's ``scatter_token``, so the pool stays the only writer
    of its pages."""

    pages: torch.Tensor
    table: torch.Tensor
    rows: Tuple[torch.Tensor, torch.Tensor]
    scatter: Callable[..., Any]

    @property
    def capacity(self) -> int:
        return int(self.table.shape[1]) * int(self.pages.shape[-2])

    def layer(self, i: int) -> "PagedKV":
        return dataclasses.replace(self, pages=self.pages[:, i])

    def write(self, new: torch.Tensor) -> None:
        """Row b's ``new[b] [KV, D]`` (in the pages' dtype) at its write
        row, in place."""
        self.scatter(self.pages, new.to(self.pages.dtype), self.rows)


def kv_layer(stack, i: int):
    """Layer ``i`` of a KV stack: ``[B, KV, S, D]`` of a tensor, the list
    of each shard's ``[B, KV, S_loc, D]`` of a sharded stack, the layer's
    pages of a :class:`PagedKV`."""
    if isinstance(stack, torch.Tensor):
        return stack[i]
    if isinstance(stack, PagedKV):
        return stack.layer(i)
    return [s[i] for s in stack]


def kv_capacity(stack) -> int:
    """The global sequence capacity of a KV stack, sharded, paged or
    neither."""
    if isinstance(stack, torch.Tensor):
        return int(stack.shape[3])
    if isinstance(stack, PagedKV):
        return stack.capacity
    return sum(int(s.shape[3]) for s in stack)


def check_kv_capacity(layout: KVCacheLayout, stack) -> None:
    """``layout.check_capacity`` of the capacity a decode backend sees:
    the whole stack's, or each shard's of a sharded stack."""
    if isinstance(stack, PagedKV):
        layout.check_capacity(stack.capacity)
        return
    for s in ([stack] if isinstance(stack, torch.Tensor) else stack):
        layout.check_capacity(int(s.shape[3]))
