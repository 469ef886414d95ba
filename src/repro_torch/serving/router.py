"""Decode-plan routing: which attention backend runs the per-step hot path,
and the :class:`KVCacheLayout` its caches need.

The platform is the device type the engine serves on (``"cuda"`` or
``"cpu"``), passed in by the caller; the router never guesses it.
:func:`route_serverless` picks the serverless channel and worker count
from the cost model (``core/cost_model.recommend_configuration``).  The
reference's slice routing (``route_tpu``) waits for ROADMAP.md Queue 1.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.cost_model import H100_SXM, recommend_configuration
from repro_torch.core.backends import (
    KVCacheLayout,
    attention_backend_for,
    cache_layout_for,
)

__all__ = ["DecodePlan", "ServingPlan", "ServerlessRoute", "AcceleratorRoute",
           "route_attention_backend", "route_decode_plan",
           "route_serving_plan", "route_serverless", "route_accelerator"]

Channel = Literal["serial", "queue", "object"]


@dataclasses.dataclass
class ServerlessRoute:
    channel: Channel
    workers: int


def route_serverless(model_bytes: int, per_layer_exchange_bytes: float,
                     n_layers: int, memory_mb: int = 4000) -> ServerlessRoute:
    """The serverless execution route of a request profile: the channel
    (serial, queue or object) and the worker count P that
    ``recommend_configuration`` picks for the model's bytes, the bytes a
    layer exchanges and the depth, with ``memory_mb`` per worker."""
    ch, p, _ = recommend_configuration(
        model_bytes, per_layer_exchange_bytes, n_layers,
        memory_mb_per_worker=memory_mb,
    )
    return ServerlessRoute(channel=ch, workers=p)


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


@dataclasses.dataclass
class ServingPlan:
    """A routed continuous-batching configuration for ``generate_stream``.

    ``slot_capacity`` is the static per-slot KV capacity: the longest
    request the stream may carry (prompt + new tokens), padded to the
    routed backend's ``block_k``; every admission prefills at this capacity
    so the decode step's shapes never change.  ``num_blocks`` sizes the
    :class:`repro_torch.serving.kv_pool.KVBlockPool` for full slot
    occupancy plus the reserved null and sink pages."""

    decode: DecodePlan
    num_slots: int
    slot_capacity: int
    num_blocks: int

    @property
    def layout(self) -> KVCacheLayout:
        return self.decode.layout_for(self.slot_capacity)


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


def route_serving_plan(cfg: ModelConfig, max_request_len: int,
                       num_slots: int = 4,
                       platform: Optional[str] = None) -> ServingPlan:
    """Slot and bucket policy for the continuous-batching scheduler: route
    the decode backend for the capacity on ``platform`` (required, as for
    :func:`route_attention_backend`), pad the capacity to its block size,
    and size the pool so ``num_slots`` maximal requests fit at once."""
    from repro_torch.serving.kv_pool import RESERVED_BLOCKS

    decode = route_decode_plan(cfg, max_len=max_request_len,
                               platform=platform)
    layout = decode.layout_for(max_request_len)
    cap = layout.padded_len(max_request_len)
    blocks = RESERVED_BLOCKS + num_slots * layout.blocks_for(cap)
    return ServingPlan(decode=decode, num_slots=num_slots,
                       slot_capacity=cap, num_blocks=blocks)


@dataclasses.dataclass
class AcceleratorRoute:
    chips: int
    reason: str


def route_accelerator(cfg: ModelConfig, shape: ShapeConfig,
                      bytes_per_param: float = 2.0,
                      target_step_latency_s: float = 0.1,
                      constants=H100_SXM) -> AcceleratorRoute:
    """The fewest cards, of 1, 2, 4, ... 512, whose memory holds the
    weights and the decode cache within 85% and whose bf16 peak runs a
    step's ``2·N_active`` FLOPs a token within ``target_step_latency_s``;
    ``constants`` is any object with ``hbm_bytes`` and ``peak_bf16_flops``."""
    params_b = cfg.param_count() * bytes_per_param
    cache_b = 0.0
    if shape.kind == "decode":
        cache_b = (2 * (cfg.n_layers + cfg.n_encoder_layers)
                   * shape.global_batch * shape.seq_len
                   * cfg.eff_kv_heads * cfg.d_head * 2.0)
        if cfg.family == "ssm":
            cache_b = (cfg.n_layers * shape.global_batch * cfg.ssm_heads
                       * cfg.ssm_head_dim * cfg.ssm_state * 4.0)
    flops = 2.0 * cfg.active_param_count() * max(1, shape.tokens
                                                 if shape.kind != "decode"
                                                 else shape.global_batch)
    chips = 1
    for candidate in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512):
        chips = candidate
        fits = (params_b + cache_b) / candidate <= 0.85 * constants.hbm_bytes
        fast = flops / (candidate * constants.peak_bf16_flops) <= target_step_latency_s
        if fits and fast:
            return AcceleratorRoute(
                chips=candidate,
                reason=f"fits at {candidate} chips "
                       f"({(params_b + cache_b) / candidate / 1e9:.1f}GB/chip)")
    return AcceleratorRoute(chips=chips, reason="requires the full 512-chip mesh")
