"""Dense decoder-only transformer (internlm2 / llama3.2 / minicpm / codeqwen,
and the LM backbone of internvl2).

The vlm family reuses this module: ``extra_embeds`` (precomputed patch
embeddings from the stub frontend, ``[B, F, d]``) are prepended to the
token embeddings at ``forward``, ``prefill`` and the embedding stage of
``stage_prefill``; decoding is the dense family's.

The parameters live in a :class:`Transformer` module: ``embed``, a
``ModuleList`` of blocks, ``ln_f`` and, unless the embeddings are tied,
``unembed``.  Where the reference stacks the blocks on a leading layer axis
and runs them under ``jax.lax.scan``, the port loops over the
``ModuleList`` in Python; PyTorch runs eagerly, so there is no ``jit``.
:func:`params_from_arrays` loads the reference's param tree (as numpy
arrays) into the module, so both packages can hold the same weights, and
:func:`params_to_arrays` gives it back; :func:`ref_leaves` names the
module's parameters by the reference's leaves (training's optimizers and
checkpoints work on those).  :func:`loss_fn` is the reference's
next-token loss, each block rematerialized under ``cfg.remat``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backends import KVCacheLayout, get_backend
from repro_torch.core.spans import span
from repro_torch.kernels.decode_attention.ref import gather_pages
from repro_torch.models import layers as L
from repro_torch.models import param_tree as PT
from repro_torch.models.attention import (
    chunked_causal_attention,
    seq_shard_plan,
    shard_devices,
    sharded_decode_attend,
)
from repro_torch.models.kvcache import (
    PagedKV,
    check_kv_capacity,
    init_attn_cache,
    kv_capacity,
    kv_layer,
    seq_axis_tree,
    update_layer_kv,
)

Cache = Dict[str, torch.Tensor]

__all__ = ["Block", "Transformer", "init", "params_from_arrays",
           "params_to_arrays", "ref_leaves", "loss_fn", "forward",
           "prefill", "decode_step", "cache_seq_axes", "param_count",
           "prefill_layers", "decode_positions", "decode_layers", "final_logits",
           "embed_with_extra",
           "slice_stage_params", "stage_head", "stage_prefill",
           "stage_decode_step"]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=L.PARAM_DTYPE, device="cpu"):
        super().__init__()
        self.ln_attn = L.empty_param((cfg.d_model,), dtype, device)
        self.attn = L.Attention(cfg.d_model, cfg.eff_heads, cfg.eff_kv_heads,
                                cfg.d_head, qkv_bias=cfg.qkv_bias,
                                dtype=dtype, device=device)
        self.ln_mlp = L.empty_param((cfg.d_model,), dtype, device)
        self.mlp = L.Mlp(cfg.d_model, cfg.d_ff, dtype=dtype, device=device)


class Transformer(nn.Module):
    """Parameter container; the math is in the functions below.  Built with
    uninitialized storage: :func:`init` and :func:`params_from_arrays` fill
    it."""

    def __init__(self, cfg: ModelConfig, dtype=L.PARAM_DTYPE, device="cpu"):
        super().__init__()
        V, d = cfg.padded_vocab(), cfg.d_model
        self.embed = L.empty_param((V, d), dtype, device)
        self.blocks = nn.ModuleList(
            Block(cfg, dtype, device) for _ in range(cfg.n_layers))
        self.ln_f = L.empty_param((d,), dtype, device)
        self.unembed = None if cfg.tie_embeddings else L.empty_param((V, d), dtype,
                                                                device)

    @property
    def head(self) -> torch.Tensor:
        return self.embed if self.unembed is None else self.unembed


def init(generator: torch.Generator, cfg: ModelConfig,
         dtype=L.PARAM_DTYPE) -> Transformer:
    """Random weights from ``generator``, on its device: the reference's
    initializers (normal with 1/fan-in variance, 0.02 embeddings, unit
    norms, zero biases), drawn in fp32 and cast to ``dtype``."""
    model = Transformer(cfg, dtype=dtype, device=generator.device)
    for block in model.blocks:
        block.ln_attn.fill_(1.0)
        L.init_attention(block.attn, generator)
        block.ln_mlp.fill_(1.0)
        L.init_mlp(block.mlp, generator)
    model.embed.copy_(L.embed_init(generator, tuple(model.embed.shape), dtype))
    model.ln_f.fill_(1.0)
    if model.unembed is not None:
        model.unembed.copy_(L.embed_init(generator, tuple(model.unembed.shape),
                                         dtype))
    return model


def params_from_arrays(cfg: ModelConfig, tree: Mapping[str, Any],
                       device="cpu", dtype=L.PARAM_DTYPE) -> Transformer:
    """Load the reference's param tree into a :class:`Transformer`.

    ``tree`` is the reference's ``init`` output as numpy arrays
    (``jax.tree.map(np.asarray, params)``): ``embed``, ``ln_f``, optional
    ``unembed``, and ``blocks`` with every leaf stacked on a leading layer
    axis.  Leaves go through fp32 (numpy's bf16 from ``ml_dtypes`` is not a
    dtype ``torch.from_numpy`` takes; bf16 → fp32 → bf16 is exact), then to
    ``dtype`` on ``device``.
    """
    model = Transformer(cfg, dtype=dtype, device=device)

    def put(dst: torch.Tensor, src) -> None:
        a = np.array(src, dtype=np.float32)  # a writable copy
        if tuple(a.shape) != tuple(dst.shape):
            raise ValueError(f"param shape {a.shape} != {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(a))

    put(model.embed, tree["embed"])
    put(model.ln_f, tree["ln_f"])
    if model.unembed is not None:
        put(model.unembed, tree["unembed"])
    elif "unembed" in tree:
        raise ValueError(f"{cfg.name} ties its embeddings; the tree has an unembed")
    blocks = tree["blocks"]
    for i, block in enumerate(model.blocks):
        put(block.ln_attn, blocks["ln_attn"][i])
        put(block.ln_mlp, blocks["ln_mlp"][i])
        for name, p in block.attn.named_parameters():
            put(p, blocks["attn"][name][i])
        for name, p in block.mlp.named_parameters():
            put(p, blocks["mlp"][name][i])
    return model


def ref_leaves(model: Transformer) -> Dict[PT.Path, PT.RefLeaf]:
    """The reference's leaves (``blocks/attn/wq`` stacked over the layers,
    ...) over the module's parameters."""
    return PT.ref_leaves(model)


def params_to_arrays(cfg: ModelConfig, model: Transformer) -> Dict[str, Any]:
    """The inverse of :func:`params_from_arrays`: the reference's tree as
    numpy arrays (bf16 widened to fp32)."""
    return PT.leaves_to_arrays(ref_leaves(model))


def param_count(cfg: ModelConfig) -> int:
    return cfg.param_count()


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def _mlp_apply(block: Block, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = L.rms_norm(x, block.ln_mlp, cfg.norm_eps)
    return x + L.mlp(block.mlp, h)


def _attn_prefill(block: Block, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor):
    h = L.rms_norm(x, block.ln_attn, cfg.norm_eps)
    q, k, v = L.qkv_project(block.attn, h)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = chunked_causal_attention(q, k, v)
    return x + L.out_project(block.attn, o, x.dtype), k, v


def _block_train(block: Block, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor) -> torch.Tensor:
    x, _, _ = _attn_prefill(block, x, cfg, positions)
    return _mlp_apply(block, x, cfg)


def final_logits(x: torch.Tensor, ln_f: torch.Tensor, table: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The final norm and the unembedding → fp32 logits."""
    return L.unembed(L.rms_norm(x, ln_f, cfg.norm_eps), table)


# ---------------------------------------------------------------------------
# forward (teacher-forced)
# ---------------------------------------------------------------------------


def embed_with_extra(table: torch.Tensor, tokens: torch.Tensor,
                     extra_embeds: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The token embeddings ``[B, S, d]``, with ``extra_embeds [B, F, d]``
    (cast to the table's dtype) prepended where given: ``[B, F + S, d]``."""
    x = L.embed_tokens(table, tokens)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def forward(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, S] (+ optional prepended embeddings [B, F, d]) → logits
    [B, F + S, V] (fp32)."""
    x = embed_with_extra(params.embed, tokens, extra_embeds)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    for block in params.blocks:
        x = L.remat(cfg, _block_train, block, x, cfg, positions)
    return final_logits(x, params.ln_f, params.head, cfg)


def loss_fn(params: Transformer, batch: Mapping[str, torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` shifted by one (over ``batch["mask"]`` where
    given); vlm's ``extra_embeds`` positions are dropped from the logits
    first, as in the reference."""
    extra = batch.get("extra_embeds")
    logits = forward(params, batch["tokens"], cfg, extra_embeds=extra)
    if extra is not None:
        logits = logits[:, extra.shape[1]:]
    return L.cross_entropy_loss(logits[:, :-1], batch["labels"][:, 1:],
                                batch.get("mask"))


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def prefill_layers(blocks, x: torch.Tensor, cfg: ModelConfig, max_len: int,
                   layout: KVCacheLayout, ffn: Callable, cache_dtype=None,
                   n_valid: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt's hidden states ``x [B, S, d]`` through ``blocks``;
    ``ffn(block, x)`` is the block's feed-forward half.  Returns the hidden
    states and the blocks' ``[L, B, KV, S_cap, D]`` KV cache in
    ``cache_dtype`` (default ``x.dtype``), ``length`` S.  Each block's
    halves run under the spans ``model.prefill.attn`` (its K/V write
    included) and ``model.prefill.ffn`` (``core/spans.py``).

    ``n_valid``, an int32 scalar on ``x``'s device, is a padded prompt's
    real length n <= S, which the cache's ``length`` copies (no host
    read).  Padding after the last real position is exact for this math:
    attention is causal and every other op works position by position, so
    the first n positions' hidden states, K and V come from the same ops
    at the same dtypes as an unpadded prefill of n positions (they differ
    only by the sums' order at other shapes); the padded positions' K and
    V land at positions >= n, which a decode step masks out exactly."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    cache = init_attn_cache(len(blocks), B, max_len, cfg.eff_kv_heads,
                            cfg.d_head, dtype=cache_dtype or x.dtype,
                            layout=layout, device=x.device)
    for i, block in enumerate(blocks):
        with span("model.prefill.attn"):
            x, k, v = _attn_prefill(block, x, cfg, positions)
            update_layer_kv(cache, i, k, v, 0)
        with span("model.prefill.ffn"):
            x = ffn(block, x)
    if n_valid is None:
        cache["length"].fill_(S)
    else:
        cache["length"].copy_(n_valid)
    return x, cache


def _dense_ffn(cfg: ModelConfig) -> Callable:
    return lambda block, x: _mlp_apply(block, x, cfg)


def prefill(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int, extra_embeds: Optional[torch.Tensor] = None,
            layout: KVCacheLayout = KVCacheLayout(),
            n_valid: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt (after ``extra_embeds``, where given); build the [L,
    B, KV, S, D] KV cache with capacity ``layout.padded_len(max_len)`` (see
    ``models.kvcache``).  Returns the last position's logits [B, 1, V]
    (fp32) and the cache.

    ``n_valid`` (an int32 scalar on the device): the prompt is padded at
    its end and only its first n positions, ``extra_embeds`` counted, are
    real; the logits are then position n - 1's and the cache's ``length``
    is n (:func:`prefill_layers`), all without a host read, so that a CUDA
    graph of one padded shape serves every n up to it."""
    x = embed_with_extra(params.embed, tokens, extra_embeds)
    x, cache = prefill_layers(params.blocks, x, cfg, max_len, layout,
                              _dense_ffn(cfg), n_valid=n_valid)
    if n_valid is None:
        last = x[:, -1:]
    else:
        last = x.index_select(1, (n_valid.long() - 1).reshape(1))
    return final_logits(last, params.ln_f, params.head, cfg), cache


def _decode_attn(attn, q, k, v, k_cache, v_cache, at, cache_len,
                 seq_shard_axes=None):
    """Insert the new token's K and V (in place) and run the backend over
    the cache's first ``cache_len`` positions.  ``at`` is either one
    position index ``[1]`` for the whole batch, or ``(rows, positions)``,
    two ``[B]`` indices: row ``b`` writes at its own ``positions[b]``.

    With ``seq_shard_axes`` (a mesh), ``k_cache``/``v_cache`` are lists of
    shard slices (``models/kvcache.py``) and ``at`` is the step's
    ``attention.seq_shard_plan``: the token goes to the shard that owns
    position ``cache_len - 1``, each shard runs the backend's split-KV
    form over its slice and the partials merge by lse
    (:func:`repro_torch.models.attention.sharded_decode_attend`).

    With ``k_cache``/``v_cache`` a layer of a :class:`PagedKV` (the
    scheduler's step on one device), the token goes straight to each row's
    page (the leaf's write rows; ``at`` is not read), then the backend's
    paged form (``decode_paged``) reads the pages through the block table;
    a backend without one (the plain oracles) attends over this layer's
    pages gathered by the table.
    Returns o [B, 1, H, D]."""
    B, _, KV, D = k.shape
    if isinstance(k_cache, PagedKV):
        k_cache.write(k.reshape(B, KV, D))
        v_cache.write(v.reshape(B, KV, D))
        if hasattr(attn, "decode_paged"):
            return attn.decode_paged(q, k_cache, v_cache, cache_len)
        return attn.decode(q, gather_pages(k_cache.pages, k_cache.table),
                           gather_pages(v_cache.pages, v_cache.table),
                           cache_len)
    if seq_shard_axes is not None:
        o, _, _ = sharded_decode_attend(
            attn, q, k.reshape(B, KV, 1, D), v.reshape(B, KV, 1, D),
            k_cache, v_cache, None, seq_shard_axes, plan=at)
        return o
    for cache, new in ((k_cache, k), (v_cache, v)):
        new = new.to(cache.dtype)
        if isinstance(at, tuple):
            cache[at[0], :, at[1]] = new.reshape(B, KV, D)
        else:
            cache.index_copy_(2, at, new.reshape(B, KV, 1, D))
    return attn.decode(q, k_cache, v_cache, cache_len)


def decode_positions(pos: torch.Tensor, B: int, S: int, seq_shard_axes=None):
    """``(positions [B, 1], at, cache_len)`` of a decode step at cache
    length ``pos`` (a scalar or ``[B]``) over a cache of capacity S: each
    row's RoPE position, where :func:`_decode_attn` writes its K and V,
    and the keys it attends to.  With ``seq_shard_axes`` (the capacity
    split evenly over the mesh's entries), ``at`` is every shard's
    ``attention.seq_shard_plan``, made once for the step's layers."""
    if seq_shard_axes is not None:
        n = len(shard_devices(seq_shard_axes))
        rope = (pos.reshape(1, 1).expand(B, 1) if pos.dim() == 0
                else pos.reshape(B, 1))
        return (rope, seq_shard_plan(pos, S // n, seq_shard_axes),
                (pos + 1).reshape(-1))
    if pos.dim() == 0:
        return (pos.reshape(1, 1).expand(B, 1), pos.reshape(1).long(),
                (pos + 1).reshape(-1))
    at = (torch.arange(B, device=pos.device), pos.clamp(max=S - 1).long())
    return pos.reshape(B, 1), at, (pos + 1).reshape(-1)


def decode_layers(attn, blocks, x: torch.Tensor, k_cache, v_cache,
                  cfg: ModelConfig, step, ffn: Callable,
                  seq_shard_axes=None) -> torch.Tensor:
    """One token's hidden states ``x [B, 1, d]`` through ``blocks``, whose
    caches are ``k_cache``/``v_cache [L, B, KV, S, D]`` (written in place),
    or lists of shards with ``seq_shard_axes``; ``step`` is
    :func:`decode_positions`' triple."""
    positions, at, cache_len = step
    for i, block in enumerate(blocks):
        hn = L.rms_norm(x, block.ln_attn, cfg.norm_eps)
        q, k, v = L.qkv_project(block.attn, hn)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        o = _decode_attn(attn, q, k, v, kv_layer(k_cache, i),
                         kv_layer(v_cache, i), at, cache_len, seq_shard_axes)
        x = x + L.out_project(block.attn, o.to(x.dtype), x.dtype)
        x = ffn(block, x)
    return x


def decode_step(
    params: Transformer, token: torch.Tensor, cache: Cache, cfg: ModelConfig,
    *, seq_shard_axes=None, attn_backend=None,
    layout: Optional[KVCacheLayout] = None,
) -> Tuple[torch.Tensor, Cache]:
    """One decode step.  token [B, 1] → logits [B, 1, V] (fp32).

    The new token's K and V are written into ``cache``'s buffers in place
    (the reference returns a new cache; copying a full-size cache every
    step would cost more than the step), and the returned cache shares
    them, with ``length`` advanced by one.  A caller that wants to reuse a
    cache clones it first.  The position lives on the device, so the step
    never waits on the host.

    ``cache["length"]`` is a scalar (every row at one position) or a
    ``[B]`` tensor, one position per row, as the continuous-batching
    scheduler keeps it: each row then takes RoPE at its own position,
    writes its K and V there and attends to its own ``length + 1`` keys.
    A row's write position is clipped to the capacity, as the reference's
    ``dynamic_update_slice`` clips it.

    ``attn_backend``: :class:`repro_torch.core.backends.AttentionBackend`
    name or instance; ``None`` resolves to the attention kind's default,
    ``torch-splitk``.  ``layout``: the :class:`KVCacheLayout` the cache was
    allocated with; when given, the cache capacity is checked against it
    (each shard's, of a sharded cache).

    ``seq_shard_axes``: a :class:`repro_torch.launch.mesh.Mesh` (or a list
    of devices) whose entries hold the cache's sequence shards, in order:
    ``cache["k"]``/``["v"]`` are then lists of ``[L, B, KV, S_loc, D]``
    shards, the new token's K and V go to the shard that owns its
    position and the partials of every shard merge by lse
    (``attention.sharded_decode_attend``).  ``None``: the cache is one
    tensor.
    """
    attn = get_backend("attention", attn_backend)
    S = kv_capacity(cache["k"])
    if layout is not None:
        check_kv_capacity(layout, cache["k"])
    x = L.embed_tokens(params.embed, token)
    step = decode_positions(cache["length"], x.shape[0], S, seq_shard_axes)
    x = decode_layers(attn, params.blocks, x, cache["k"], cache["v"], cfg,
                      step, _dense_ffn(cfg), seq_shard_axes)
    logits = final_logits(x, params.ln_f, params.head, cfg)
    return logits, {**cache, "length": cache["length"] + 1}


# ---------------------------------------------------------------------------
# pipeline stages (the serverless LM executor, ``faas/lm_pipeline.py``)
# ---------------------------------------------------------------------------
#
# A stage is a contiguous slice ``[spec.start, spec.stop)`` of the blocks,
# with the embedding on the first stage and the final norm and unembedding
# on the last.  Chained stages run the monolithic model's per-layer ops at
# the same shapes in the same order (the same ``prefill_layers`` and
# ``decode_layers``), and the wire carries activations as fp32, which
# holds bf16 exactly, so the chain reproduces ``prefill``/``decode_step``
# bit for bit on one device.


def slice_stage_params(params: Transformer, spec) -> Dict[str, Any]:
    """The parameters stage ``spec`` keeps resident: ``blocks`` (a
    ``ModuleList`` slice sharing the model's modules, no copy) and, as the
    stage needs them, ``embed``, ``ln_f`` and ``unembed``."""
    out: Dict[str, Any] = {"blocks": params.blocks[spec.start:spec.stop]}
    if spec.has_embed:
        out["embed"] = params.embed
    if spec.has_head:
        out["ln_f"] = params.ln_f
        if params.unembed is not None:
            out["unembed"] = params.unembed
        elif not spec.has_embed:
            out["embed"] = params.embed  # a tied head needs the table
    return out


def stage_head(sp: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    """The head stage's :func:`final_logits`."""
    table = sp["embed"] if cfg.tie_embeddings else sp["unembed"]
    return final_logits(x, sp["ln_f"], table, cfg)


def stage_prefill(sp: Dict[str, Any], spec, x_in: torch.Tensor,
                  cfg: ModelConfig, max_len: int,
                  extra_embeds: Optional[torch.Tensor] = None,
                  layout: KVCacheLayout = KVCacheLayout(),
                  ) -> Tuple[torch.Tensor, Cache]:
    """One stage of ``prefill``.  ``x_in`` is the token ids [B, S] on the
    embedding stage (``extra_embeds`` prepended there, where given), the
    previous stage's hidden states [B, S, d] otherwise.  Returns the hidden
    states [B, S, d] (the last position's logits [B, 1, V] on the head
    stage) and the stage's resident cache."""
    x = (embed_with_extra(sp["embed"], x_in, extra_embeds) if spec.has_embed
         else x_in)
    x, cache = prefill_layers(sp["blocks"], x, cfg, max_len, layout,
                              _dense_ffn(cfg))
    if spec.has_head:
        return stage_head(sp, x[:, -1:], cfg), cache
    return x, cache


def stage_decode_step(sp: Dict[str, Any], spec, x_in: torch.Tensor,
                      cache: Cache, cfg: ModelConfig, *, attn_backend=None,
                      ) -> Tuple[torch.Tensor, Cache]:
    """One stage of ``decode_step``.  ``x_in`` is the new token [B, 1] on
    the embedding stage, the previous stage's hidden state [B, 1, d]
    otherwise.  Returns the hidden state (logits [B, 1, V] on the head
    stage) and the stage's cache, its K and V written in place."""
    attn = get_backend("attention", attn_backend)
    x = L.embed_tokens(sp["embed"], x_in) if spec.has_embed else x_in
    step = decode_positions(cache["length"], x.shape[0],
                            int(cache["k"].shape[3]))
    x = decode_layers(attn, sp["blocks"], x, cache["k"], cache["v"], cfg,
                      step, _dense_ffn(cfg))
    new_cache = {**cache, "length": cache["length"] + 1}
    if spec.has_head:
        return stage_head(sp, x, cfg), new_cache
    return x, new_cache


def cache_seq_axes(cache: Cache):
    """Growing-KV sequence axes for the continuous-batching scheduler:
    ``k``/``v`` page into the KV pool (seq axis -2), ``length`` stays
    slot-resident.  See :func:`repro_torch.models.kvcache.seq_axis_tree`."""
    return seq_axis_tree(cache)
