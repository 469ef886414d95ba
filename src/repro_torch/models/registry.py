"""Uniform model API over the families the port has.

``get_model(cfg)`` returns a :class:`ModelApi` with init / forward /
prefill / decode_step — the entry point the serving engine uses.  The
``dense``, ``moe`` and ``ssm`` families are ported; every other family
raises and names the ROADMAP.md item that ports it.  ``cache_seq_axes``
classifies a family's cache leaves for the continuous-batching scheduler
(``serving/scheduler.py``); ``loss_fn`` waits for training (Queue 1
item 8).  ``get_stage_model(cfg)`` gives the per-stage functions of the
pipeline over the serverless fabric (``faas/lm_pipeline.py``) for the
dense and moe families.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backends import cache_layout_for, get_backend
from repro_torch.models import mamba2, moe, transformer

__all__ = ["ModelApi", "StageModel", "get_model", "get_stage_model"]

_NOT_PORTED = {
    "vlm": "ROADMAP.md Queue 1 item 4 (its vlm half)",
    "hybrid": "ROADMAP.md Queue 1 item 5",
    "encdec": "ROADMAP.md Queue 1 item 5",
}


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig
    init: Callable[[torch.Generator], nn.Module]
    forward: Callable[..., torch.Tensor]
    prefill: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    decode_step: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    # cache -> tree of Optional[int]: the sequence axis of each growing KV
    # leaf, None for slot-resident state (``models.kvcache.seq_axis_tree``)
    cache_seq_axes: Callable[[Dict[str, Any]], Any]


def get_model(cfg: ModelConfig, attn_backend=None) -> ModelApi:
    """Build the family's :class:`ModelApi`.

    ``attn_backend`` — :class:`repro_torch.core.backends.AttentionBackend`
    name or instance used by every decode step of the attention-bearing
    families (``None`` → the attention kind's default, ``torch-splitk``).
    Resolved once here; its :class:`KVCacheLayout` is derived from
    ``max_len`` at prefill.  The ``ssm`` family has no decode attention and
    resolves none.
    """
    if cfg.family == "ssm":
        return ModelApi(
            cfg=cfg,
            init=lambda generator: mamba2.init(generator, cfg),
            forward=lambda p, b: mamba2.forward(p, b["tokens"], cfg),
            prefill=lambda p, b, max_len=0: mamba2.prefill(
                p, b["tokens"], cfg, max_len),
            decode_step=lambda p, t, c: mamba2.decode_step(p, t, c, cfg),
            cache_seq_axes=mamba2.cache_seq_axes,
        )
    _require_ported(cfg)
    attn = get_backend("attention", attn_backend)
    if cfg.family == "moe":
        # dp_groups: how a batch's tokens group for expert capacity
        return ModelApi(
            cfg=cfg,
            init=lambda generator: moe.init(generator, cfg),
            forward=lambda p, b, dp_groups=1: moe.forward(
                p, b["tokens"], cfg, dp_groups)[0],
            prefill=lambda p, b, max_len, dp_groups=1: moe.prefill(
                p, b["tokens"], cfg, max_len, dp_groups,
                layout=cache_layout_for(attn, max_len)),
            decode_step=lambda p, t, c, dp_groups=1: moe.decode_step(
                p, t, c, cfg, dp_groups, attn_backend=attn),
            cache_seq_axes=moe.cache_seq_axes,
        )
    return ModelApi(
        cfg=cfg,
        init=lambda generator: transformer.init(generator, cfg),
        forward=lambda p, b: transformer.forward(p, b["tokens"], cfg),
        prefill=lambda p, b, max_len: transformer.prefill(
            p, b["tokens"], cfg, max_len,
            layout=cache_layout_for(attn, max_len)),
        decode_step=lambda p, t, c: transformer.decode_step(
            p, t, c, cfg, attn_backend=attn),
        cache_seq_axes=transformer.cache_seq_axes,
    )


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not in repro_torch yet: "
            f"{_NOT_PORTED[cfg.family]} ports it")
    if cfg.family not in ("dense", "moe", "ssm"):
        raise ValueError(f"unknown family {cfg.family!r}")


# ---------------------------------------------------------------------------
# pipeline stages: the serverless LM executor's per-stage API
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StageModel:
    """Per-stage functions for the pipeline over the serverless fabric.

    ``slice_params(params, spec)`` gives the parameters a
    :class:`repro_torch.core.partitioner.StageSpec` keeps worker-resident
    (slices that share the model's tensors); ``prefill(stage_params, spec,
    x_in, max_len)`` and ``decode_step(stage_params, spec, x_in,
    stage_cache)`` run one stage: token ids in on the embedding stage, the
    previous stage's hidden states otherwise; logits out on the head
    stage.  The stage's KV cache never crosses a stage boundary."""

    cfg: ModelConfig
    slice_params: Callable[..., Dict[str, Any]]
    prefill: Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]
    decode_step: Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]


def get_stage_model(cfg: ModelConfig, attn_backend=None) -> StageModel:
    """Stage-executor functions for ``cfg``'s family: ``dense`` and ``moe``
    (the reference also stages ``vlm``, whose port is ROADMAP.md Queue 1
    item 4).  The recurrent families and the encoder-decoder raise
    ``ValueError``, as in the reference: their state does not cut into
    contiguous layer slices."""
    if cfg.family not in ("dense", "vlm", "moe"):
        raise ValueError(
            f"pipeline stages are not supported for family {cfg.family!r} "
            f"(supported: dense, vlm, moe)")
    _require_ported(cfg)
    attn = get_backend("attention", attn_backend)
    if cfg.family == "dense":
        return StageModel(
            cfg=cfg,
            slice_params=lambda p, spec: transformer.slice_stage_params(p, spec),
            prefill=lambda sp, spec, x, max_len: transformer.stage_prefill(
                sp, spec, x, cfg, max_len,
                layout=cache_layout_for(attn, max_len)),
            decode_step=lambda sp, spec, x, c: transformer.stage_decode_step(
                sp, spec, x, c, cfg, attn_backend=attn),
        )
    return StageModel(
        cfg=cfg,
        slice_params=lambda p, spec: moe.slice_stage_params(p, spec, cfg),
        prefill=lambda sp, spec, x, max_len: moe.stage_prefill(
            sp, spec, x, cfg, max_len, layout=cache_layout_for(attn, max_len)),
        decode_step=lambda sp, spec, x, c: moe.stage_decode_step(
            sp, spec, x, c, cfg, attn_backend=attn),
    )
