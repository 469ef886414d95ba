"""Uniform model API over the model families.

``get_model(cfg)`` returns a :class:`ModelApi` with init / loss_fn /
forward / prefill / decode_step — the entry point the serving engine and
the trainer use — for every family of the reference: ``dense``, ``vlm``
(the dense transformer with prepended ``extra_embeds``), ``moe``, ``ssm``,
``hybrid`` and ``encdec``.  ``cache_seq_axes`` classifies a family's cache
leaves for the continuous-batching scheduler (``serving/scheduler.py``);
``ref_leaves`` names a model's parameters by the reference's param tree,
which training's optimizers and checkpoints work on.  ``get_stage_model(cfg)``
gives the per-stage functions of the pipeline over the serverless fabric
(``faas/lm_pipeline.py``) for the dense, vlm and moe families.
``input_specs`` and ``cache_specs`` build the inputs and caches of an
(arch x shape) cell: concrete tensors, or tensors on the ``meta`` device
(shapes and dtypes, no storage).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.backends import cache_layout_for, get_backend
from repro_torch.models import encdec, hybrid, mamba2, moe, transformer

__all__ = ["FRONTEND_INPUTS", "ModelApi", "StageModel", "get_model",
           "get_stage_model", "input_specs", "cache_specs", "abstract_params"]

# The batch key of each family's stub-frontend input, ``[B, F, d_model]``
# with F = ``cfg.frontend_tokens``: image embeddings prepended to the
# prompt (vlm), source frames for the encoder (encdec).
FRONTEND_INPUTS = {"vlm": "extra_embeds", "encdec": "frames"}


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig
    init: Callable[[torch.Generator], nn.Module]
    # (params, batch) -> the training loss, a 0-d fp32 tensor
    loss_fn: Callable[..., torch.Tensor]
    forward: Callable[..., torch.Tensor]
    prefill: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    decode_step: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    # cache -> tree of Optional[int]: the sequence axis of each growing KV
    # leaf, None for slot-resident state (``models.kvcache.seq_axis_tree``)
    cache_seq_axes: Callable[[Dict[str, Any]], Any]
    # params -> {reference leaf path: RefLeaf} (``models/param_tree.py``)
    ref_leaves: Callable[[nn.Module], Dict[Tuple[str, ...], Any]]
    # prefill takes ``n_valid`` (a prompt padded at its end, n positions
    # real) and pads exactly: each real position's result depends only on
    # the positions before it (causal attention, position-wise ops).  True
    # for ``transformer.prefill`` (dense, vlm) and for the moe family's
    # without a capacity (``moe_capacity_factor`` None, as deepseek-moe-16b
    # is published: no token drops, so a padded token's routing changes no
    # real token's result); at a capacity the moe family's routing counts
    # every token, padded ones too, the recurrent families (ssm, hybrid)
    # carry their state through every position, and the encdec family's
    # prefill has not been examined, so they keep the unpadded one
    prefill_pads: bool = False
    # the attention backend every decode step uses (None for ssm): the
    # scheduler asks it whether its step can read the KV pool's pages
    attn: Any = None


def get_model(cfg: ModelConfig, attn_backend=None) -> ModelApi:
    """Build the family's :class:`ModelApi`.

    ``attn_backend`` — :class:`repro_torch.core.backends.AttentionBackend`
    name or instance used by every decode step of the attention-bearing
    families (``None`` → the attention kind's default, ``torch-splitk``).
    Resolved once here; its :class:`KVCacheLayout` is derived from
    ``max_len`` at prefill.  The ``ssm`` family has no decode attention and
    resolves none.  The decode steps of the attention-bearing families
    pass the family's keywords through (``seq_shard_axes=mesh`` for the
    sequence-sharded step).  A batch is ``{"tokens"}``, plus ``"extra_embeds" [B, F,
    d]`` for ``vlm`` and ``"frames" [B, S_src, d]`` for ``encdec``.
    """
    fam = cfg.family
    if fam == "ssm":
        return ModelApi(
            cfg=cfg,
            init=lambda generator: mamba2.init(generator, cfg),
            loss_fn=lambda p, b: mamba2.loss_fn(p, b, cfg),
            forward=lambda p, b: mamba2.forward(p, b["tokens"], cfg),
            prefill=lambda p, b, max_len=0: mamba2.prefill(
                p, b["tokens"], cfg, max_len),
            decode_step=lambda p, t, c: mamba2.decode_step(p, t, c, cfg),
            cache_seq_axes=mamba2.cache_seq_axes,
            ref_leaves=mamba2.ref_leaves,
        )
    if fam not in ("dense", "vlm", "moe", "hybrid", "encdec"):
        raise ValueError(f"unknown family {fam!r}")
    attn = get_backend("attention", attn_backend)
    layout = lambda max_len: cache_layout_for(attn, max_len)  # noqa: E731
    if fam == "moe":
        # dp_groups: how a batch's tokens group for expert capacity
        return ModelApi(
            cfg=cfg,
            init=lambda generator: moe.init(generator, cfg),
            loss_fn=lambda p, b, dp_groups=1: moe.loss_fn(p, b, cfg,
                                                          dp_groups),
            forward=lambda p, b, dp_groups=1: moe.forward(
                p, b["tokens"], cfg, dp_groups)[0],
            prefill=lambda p, b, max_len, dp_groups=1, n_valid=None:
                moe.prefill(p, b["tokens"], cfg, max_len, dp_groups,
                            layout=layout(max_len), n_valid=n_valid),
            decode_step=lambda p, t, c, dp_groups=1, **kw: moe.decode_step(
                p, t, c, cfg, dp_groups, attn_backend=attn, **kw),
            cache_seq_axes=moe.cache_seq_axes,
            ref_leaves=moe.ref_leaves,
            prefill_pads=cfg.moe_capacity_factor is None,
            attn=attn,
        )
    if fam == "hybrid":
        return ModelApi(
            cfg=cfg,
            init=lambda generator: hybrid.init(generator, cfg),
            loss_fn=lambda p, b: hybrid.loss_fn(p, b, cfg),
            forward=lambda p, b: hybrid.forward(p, b["tokens"], cfg),
            prefill=lambda p, b, max_len: hybrid.prefill(
                p, b["tokens"], cfg, max_len, layout=layout(max_len)),
            decode_step=lambda p, t, c, **kw: hybrid.decode_step(
                p, t, c, cfg, attn_backend=attn, **kw),
            cache_seq_axes=hybrid.cache_seq_axes,
            ref_leaves=lambda p: hybrid.ref_leaves(cfg, p),
            attn=attn,
        )
    if fam == "encdec":
        return ModelApi(
            cfg=cfg,
            init=lambda generator: encdec.init(generator, cfg),
            loss_fn=lambda p, b: encdec.loss_fn(p, b, cfg),
            forward=lambda p, b: encdec.forward(p, b, cfg),
            prefill=lambda p, b, max_len: encdec.prefill(
                p, b, cfg, max_len, layout=layout(max_len)),
            decode_step=lambda p, t, c, **kw: encdec.decode_step(
                p, t, c, cfg, attn_backend=attn, **kw),
            cache_seq_axes=encdec.cache_seq_axes,
            ref_leaves=encdec.ref_leaves,
            attn=attn,
        )
    extra = (lambda b: b["extra_embeds"]) if fam == "vlm" else (lambda b: None)
    return ModelApi(
        cfg=cfg,
        init=lambda generator: transformer.init(generator, cfg),
        loss_fn=lambda p, b: transformer.loss_fn(p, b, cfg),
        forward=lambda p, b: transformer.forward(p, b["tokens"], cfg,
                                                 extra_embeds=extra(b)),
        prefill=lambda p, b, max_len, n_valid=None: transformer.prefill(
            p, b["tokens"], cfg, max_len, extra_embeds=extra(b),
            layout=layout(max_len), n_valid=n_valid),
        decode_step=lambda p, t, c, **kw: transformer.decode_step(
            p, t, c, cfg, attn_backend=attn, **kw),
        cache_seq_axes=transformer.cache_seq_axes,
        ref_leaves=transformer.ref_leaves,
        prefill_pads=True,
        attn=attn,
    )


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
    """Stage-executor functions for ``cfg``'s family: ``dense``/``vlm``
    (the transformer; ``extra`` embeddings go to the embedding stage) and
    ``moe``.  The recurrent families and the encoder-decoder raise
    ``ValueError``, as in the reference: their state does not cut into
    contiguous layer slices."""
    fam = cfg.family
    if fam not in ("dense", "vlm", "moe"):
        raise ValueError(
            f"pipeline stages are not supported for family {fam!r} "
            f"(supported: dense, vlm, moe)")
    attn = get_backend("attention", attn_backend)
    layout = lambda max_len: cache_layout_for(attn, max_len)  # noqa: E731
    if fam in ("dense", "vlm"):
        return StageModel(
            cfg=cfg,
            slice_params=lambda p, spec: transformer.slice_stage_params(p, spec),
            prefill=lambda sp, spec, x, max_len, extra=None:
                transformer.stage_prefill(
                    sp, spec, x, cfg, max_len, extra_embeds=extra,
                    layout=layout(max_len)),
            decode_step=lambda sp, spec, x, c: transformer.stage_decode_step(
                sp, spec, x, c, cfg, attn_backend=attn),
        )
    return StageModel(
        cfg=cfg,
        slice_params=lambda p, spec: moe.slice_stage_params(p, spec, cfg),
        prefill=lambda sp, spec, x, max_len, extra=None: moe.stage_prefill(
            sp, spec, x, cfg, max_len, layout=layout(max_len)),
        decode_step=lambda sp, spec, x, c: moe.stage_decode_step(
            sp, spec, x, c, cfg, attn_backend=attn),
    )


# ---------------------------------------------------------------------------
# input specs: concrete tensors or meta tensors per (arch x shape)
# ---------------------------------------------------------------------------

_MODULES = {"dense": transformer.Transformer, "vlm": transformer.Transformer,
            "moe": moe.Moe, "ssm": mamba2.Mamba2, "hybrid": hybrid.Hybrid,
            "encdec": encdec.EncDec}


def abstract_params(cfg: ModelConfig) -> nn.Module:
    """The family's parameter module at ``cfg``'s width on the ``meta``
    device (shapes and dtypes, no storage): the counterpart of the
    reference's ``jax.eval_shape(model.init, key)``."""
    return _MODULES[cfg.family](cfg, device="meta")



def _maker(abstract: bool, seed: int, cfg: ModelConfig, device):
    """``arr(shape, dtype)``: a tensor on the ``meta`` device (``abstract``)
    or a concrete one on ``device``, random from ``seed`` (int32 token ids
    in the vocabulary, normal floats), each drawn anew from the seed as the
    reference draws it."""
    def arr(shape, dtype):
        if abstract:
            return torch.empty(shape, dtype=dtype, device="meta")
        rng = np.random.default_rng(seed)
        if dtype == torch.int32:
            a = rng.integers(0, max(2, cfg.vocab_size or 2), size=shape)
            return torch.as_tensor(a, dtype=torch.int32, device=device)
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.as_tensor(a, device=device).to(dtype)
    return arr


def input_specs(cfg: ModelConfig, shape: ShapeConfig, abstract: bool = True,
                seed: int = 0, device="cpu") -> Dict[str, Any]:
    """Batch stand-ins for an (arch x shape) cell, as the reference's
    ``input_specs``: meta tensors (``abstract=True``) or concrete random
    tensors on ``device``.

    train:   ``{"tokens" [B,S], "labels" [B,S]}`` (+ the frontend's
             embeddings: ``extra_embeds`` for vlm, ``frames`` for encdec)
    prefill: ``{"tokens" [B,S], ...}``; vlm's prompt shrinks by
             ``frontend_tokens`` so that prefix + prompt = ``seq_len``
    decode:  ``{"token" [B,1]}``; the cache comes from :func:`cache_specs`.
    """
    B, S = shape.global_batch, shape.seq_len
    arr = _maker(abstract, seed, cfg, device)
    tok, bf16 = torch.int32, torch.bfloat16
    front = (B, cfg.frontend_tokens, cfg.d_model)
    if shape.kind == "train":
        if cfg.family == "encdec":
            return {"frames": arr(front, bf16), "tokens": arr((B, S), tok),
                    "labels": arr((B, S), tok)}
        batch = {"tokens": arr((B, S), tok), "labels": arr((B, S), tok)}
        if cfg.family == "vlm":
            batch["extra_embeds"] = arr(front, bf16)
        return batch
    if shape.kind == "prefill":
        if cfg.family == "encdec":
            return {"frames": arr(front, bf16), "tokens": arr((B, S), tok)}
        if cfg.family == "vlm":
            return {"tokens": arr((B, S - cfg.frontend_tokens), tok),
                    "extra_embeds": arr(front, bf16)}
        return {"tokens": arr((B, S), tok)}
    return {"token": arr((B, 1), tok)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, abstract: bool = True,
                device="cpu") -> Dict[str, Any]:
    """Caches of capacity ``shape.seq_len`` for decode cells, in the port's
    own layout of each family (``[L, B, KV, S, D]`` KV stacks, the batch
    axis second on every leaf): meta tensors (``abstract=True``) or zeros
    on ``device`` with ``length`` ``seq_len - 1`` (``src_length``
    ``frontend_tokens``).  The capacity is exactly ``seq_len``, the
    identity layout."""
    B, S = shape.global_batch, shape.seq_len
    kv_dt = torch.bfloat16
    dev = "meta" if abstract else device

    def arr(shp, dtype=kv_dt):
        return torch.zeros(shp, dtype=dtype, device=dev)

    def length(n):
        return torch.tensor(n, dtype=torch.int32, device=dev)

    def kv(n, s=S, dtype=kv_dt):
        return arr((n, B, cfg.eff_kv_heads, s, cfg.d_head), dtype)

    def ssm_state(n):
        gn = cfg.ssm_groups * cfg.ssm_state
        Km1 = cfg.conv_kernel - 1
        return {"conv": {"x": arr((n, B, Km1, cfg.d_inner)),
                         "B": arr((n, B, Km1, gn)),
                         "C": arr((n, B, Km1, gn))},
                "ssm": arr((n, B, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), torch.float32)}

    fam = cfg.family
    if fam in ("dense", "vlm"):
        return {"k": kv(cfg.n_layers), "v": kv(cfg.n_layers),
                "length": length(S - 1)}
    if fam == "moe":
        fd, dt = cfg.first_dense_layers, moe.cache_dtype(cfg)
        counts = [n for n in (fd, cfg.n_layers - fd) if n]
        return {"stacks": [{"k": kv(n, dtype=dt), "v": kv(n, dtype=dt)}
                           for n in counts],
                "length": length(S - 1)}
    if fam == "ssm":
        return {**ssm_state(cfg.n_layers), "length": length(S - 1)}
    if fam == "hybrid":
        n = hybrid.n_shared_sites(cfg)
        return {"k": kv(n), "v": kv(n), **ssm_state(cfg.n_layers),
                "length": length(S - 1)}
    if fam == "encdec":
        src = cfg.frontend_tokens
        return {"k": kv(cfg.n_layers), "v": kv(cfg.n_layers),
                "kc": kv(cfg.n_layers, src), "vc": kv(cfg.n_layers, src),
                "length": length(S - 1), "src_length": length(src)}
    raise ValueError(fam)
