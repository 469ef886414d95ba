"""Dense decoder-only transformer (internlm2 / llama3.2 / minicpm / codeqwen).

The parameters live in a :class:`Transformer` module: ``embed``, a
``ModuleList`` of blocks, ``ln_f`` and, unless the embeddings are tied,
``unembed``.  Where the reference stacks the blocks on a leading layer axis
and runs them under ``jax.lax.scan``, the port loops over the
``ModuleList`` in Python; PyTorch runs eagerly, so there is no ``jit``.
:func:`params_from_arrays` loads the reference's param tree (as numpy
arrays) into the module, so both packages can hold the same weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backends import KVCacheLayout, get_backend
from repro_torch.models import layers as L
from repro_torch.models.attention import chunked_causal_attention
from repro_torch.models.kvcache import (
    init_attn_cache,
    seq_axis_tree,
    update_layer_kv,
)

Cache = Dict[str, torch.Tensor]

__all__ = ["Block", "Transformer", "init", "params_from_arrays", "forward",
           "prefill", "decode_step", "cache_seq_axes", "param_count"]


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


def _unembed_last(params: Transformer, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    x = L.rms_norm(x, params.ln_f, cfg.norm_eps)
    return L.unembed(x, params.head)


# ---------------------------------------------------------------------------
# forward (teacher-forced)
# ---------------------------------------------------------------------------


def forward(params: Transformer, tokens: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V] (fp32)."""
    x = L.embed_tokens(params.embed, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    for block in params.blocks:
        x, _, _ = _attn_prefill(block, x, cfg, positions)
        x = _mlp_apply(block, x, cfg)
    return _unembed_last(params, x, cfg)


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def prefill(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int, layout: KVCacheLayout = KVCacheLayout(),
            ) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt; build the [L, B, KV, S, D] KV cache with capacity
    ``layout.padded_len(max_len)`` (see ``models.kvcache``).  Returns the
    last position's logits [B, 1, V] (fp32) and the cache."""
    x = L.embed_tokens(params.embed, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    cache = init_attn_cache(cfg.n_layers, B, max_len, cfg.eff_kv_heads,
                            cfg.d_head, dtype=x.dtype, layout=layout,
                            device=x.device)
    for i, block in enumerate(params.blocks):
        x, k, v = _attn_prefill(block, x, cfg, positions)
        x = _mlp_apply(block, x, cfg)
        update_layer_kv(cache, i, k, v, 0)
    cache["length"].fill_(S)
    return _unembed_last(params, x[:, -1:], cfg), cache


def _decode_attn(attn, q, k, v, k_cache, v_cache, at, cache_len):
    """Insert the new token's K and V (in place) and run the backend over
    the cache's first ``cache_len`` positions.  ``at`` is either one
    position index ``[1]`` for the whole batch, or ``(rows, positions)``,
    two ``[B]`` indices: row ``b`` writes at its own ``positions[b]``.
    Returns o [B, 1, H, D]."""
    B, _, KV, D = k.shape
    for cache, new in ((k_cache, k), (v_cache, v)):
        new = new.to(cache.dtype)
        if isinstance(at, tuple):
            cache[at[0], :, at[1]] = new.reshape(B, KV, D)
        else:
            cache.index_copy_(2, at, new.reshape(B, KV, 1, D))
    return attn.decode(q, k_cache, v_cache, cache_len)


def decode_step(
    params: Transformer, token: torch.Tensor, cache: Cache, cfg: ModelConfig,
    *, attn_backend=None, layout: Optional[KVCacheLayout] = None,
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
    allocated with; when given, the cache capacity is checked against it.
    """
    attn = get_backend("attention", attn_backend)
    S = int(cache["k"].shape[3])
    if layout is not None:
        layout.check_capacity(S)
    x = L.embed_tokens(params.embed, token)
    B = x.shape[0]
    pos = cache["length"]
    if pos.dim() == 0:
        positions = pos.reshape(1, 1).expand(B, 1)
        at = pos.reshape(1).long()
    else:
        positions = pos.reshape(B, 1)
        at = (torch.arange(B, device=x.device), pos.clamp(max=S - 1).long())
    cache_len = (pos + 1).reshape(-1)
    for i, block in enumerate(params.blocks):
        hn = L.rms_norm(x, block.ln_attn, cfg.norm_eps)
        q, k, v = L.qkv_project(block.attn, hn)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        o = _decode_attn(attn, q, k, v, cache["k"][i], cache["v"][i], at,
                         cache_len)
        x = x + L.out_project(block.attn, o.to(x.dtype), x.dtype)
        x = _mlp_apply(block, x, cfg)
    logits = _unembed_last(params, x, cfg)
    return logits, {**cache, "length": cache["length"] + 1}


def cache_seq_axes(cache: Cache):
    """Growing-KV sequence axes for the continuous-batching scheduler:
    ``k``/``v`` page into the KV pool (seq axis -2), ``length`` stays
    slot-resident.  See :func:`repro_torch.models.kvcache.seq_axis_tree`."""
    return seq_axis_tree(cache)
