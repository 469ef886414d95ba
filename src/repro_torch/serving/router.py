"""Decode-plan routing: which attention backend runs the per-step hot path,
and the :class:`KVCacheLayout` its caches need.

The platform is the device type the engine serves on (``"cuda"`` or
``"cpu"``), passed in by the caller; the router never guesses it.  The
reference's serverless and slice routing (``route_serverless``,
``route_tpu``) and the continuous-batching plan (``route_serving_plan``)
wait for ROADMAP.md Queue 1 items 9 and 6.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backends import (
    KVCacheLayout,
    attention_backend_for,
    cache_layout_for,
)

__all__ = ["DecodePlan", "route_attention_backend", "route_decode_plan"]


@dataclasses.dataclass
class DecodePlan:
    """A routed decode configuration: the attention backend and the
    :class:`KVCacheLayout` its caches are allocated with — ``None`` when
    the plan was routed without a ``max_len`` hint, in which case
    :meth:`layout_for` derives it once the capacity is known."""

    attn_backend: str
    cache_layout: Optional[KVCacheLayout] = None

    def layout_for(self, max_len: int) -> KVCacheLayout:
        if self.cache_layout is not None:
            return self.cache_layout
        return _layout(self.attn_backend, max_len)


def _layout(name: str, max_len: int) -> KVCacheLayout:
    # A backend's padding rule does not depend on its device: build it for
    # the CPU, so a plan for a card can be made on a host without one.
    return cache_layout_for(attention_backend_for(name, "cpu"), max_len)


def route_attention_backend(cfg: ModelConfig, max_len: Optional[int] = None,
                            platform: Optional[str] = None) -> str:
    """Pick the decode-attention backend for a serving configuration:

    * ``cuda`` → ``torch-splitk`` (the hand-written split-KV kernel), as
      the reference routes a TPU to ``pallas-splitk``;
    * long caches elsewhere → ``chunked-lse`` (the dense oracle
      materializes a [B, H, S] score row per step; the streaming scan
      bounds that);
    * otherwise → ``dense-ref``.

    Attention-free families get the oracle (unused), whatever the
    platform, as in the reference.
    """
    if cfg.is_attention_free:
        return "dense-ref"
    if platform is None:
        raise ValueError("pass platform, the device type the engine serves "
                         "on ('cuda' or 'cpu'); the router does not guess it")
    if platform == "cuda":
        return "torch-splitk"
    if max_len is not None and max_len > 4096:
        return "chunked-lse"
    return "dense-ref"


def route_decode_plan(cfg: ModelConfig, max_len: Optional[int] = None,
                      platform: Optional[str] = None) -> DecodePlan:
    """Backend choice + the cache layout it implies, in one decision.
    Without a ``max_len`` hint the layout stays unresolved (``None``)."""
    name = route_attention_backend(cfg, max_len=max_len, platform=platform)
    if max_len is None:
        return DecodePlan(attn_backend=name)
    return DecodePlan(attn_backend=name, cache_layout=_layout(name, max_len))
