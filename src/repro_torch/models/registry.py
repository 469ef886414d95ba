"""Uniform model API over the families the port has.

``get_model(cfg)`` returns a :class:`ModelApi` with init / forward /
prefill / decode_step — the entry point the serving engine uses.  The
``dense`` and ``ssm`` families are ported; every other family raises and
names the ROADMAP.md item that ports it.  ``cache_seq_axes`` classifies a
family's cache leaves for the continuous-batching scheduler
(``serving/scheduler.py``); ``loss_fn`` waits for training (Queue 1
item 8).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backends import cache_layout_for, get_backend
from repro_torch.models import mamba2, transformer

__all__ = ["ModelApi", "get_model"]

_NOT_PORTED = {
    "vlm": "ROADMAP.md Queue 1 item 4 (its vlm half)",
    "moe": "ROADMAP.md Queue 1 item 5",
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
    if cfg.family != "dense":
        where = _NOT_PORTED.get(cfg.family, "no ROADMAP item")
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not in repro_torch yet: "
            f"{where} ports it")
    attn = get_backend("attention", attn_backend)
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
