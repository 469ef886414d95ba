"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention block.

The shared transformer block (one parameter set) runs before every
``cfg.shared_attn_every``-th mamba block, reading ``concat(hidden,
embedding)``: Zamba's way of reusing one attention block across depth.
Per-application LoRA deltas are omitted, as in the reference.

The blocks form ``n_full`` groups of ``shared_attn_every`` mamba blocks,
each group preceded by the shared block, and a trailing partial group of
``n_layers % shared_attn_every`` blocks, also preceded by it: the shared
block runs at ``n_sites = ceil(n_layers / shared_attn_every)`` sites.
Where the reference scans over stacked groups, the port loops over one
``ModuleList`` of the mamba blocks (``models/mamba2.py``'s) in Python.

The decode cache is the mamba2 cache plus one KV stack over the sites, in
the port's own layout (batch axis second on every leaf, as the
continuous-batching scheduler and the paged pool take it)::

    {"k", "v": [n_sites, B, KV, S, D],
     "conv": {"x", "B", "C"}: [n_layers, B, K-1, C],
     "ssm": [n_layers, B, H, P, N] fp32,
     "length"}

The reference keeps ``kv [n_full, B, ...]``, ``states [n_full, g, B,
...]``, ``tail_kv [B, ...]`` and ``tail_state [tail, B, ...]``; site ``i``
and layer ``i * g + j`` here are its group ``i`` (or its tail) there.
The embeddings are tied: the reference unembeds with ``embed``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backends import KVCacheLayout, get_backend
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import param_tree as PT
from repro_torch.models import transformer as TF
from repro_torch.models.attention import chunked_causal_attention
from repro_torch.models.kvcache import (
    check_kv_capacity,
    init_attn_cache,
    kv_capacity,
    kv_layer,
    seq_axis_tree,
    update_layer_kv,
)

Cache = Dict[str, Any]

__all__ = ["SharedBlock", "Hybrid", "n_shared_sites", "site_sizes", "init",
           "params_from_arrays", "params_to_arrays", "ref_leaves", "loss_fn",
           "forward", "prefill", "decode_step",
           "cache_seq_axes"]


def n_shared_sites(cfg: ModelConfig) -> int:
    return -(-cfg.n_layers // cfg.shared_attn_every)


def _group_sizes(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_full_groups, group_len, tail_len)."""
    g = cfg.shared_attn_every
    return cfg.n_layers // g, g, cfg.n_layers % g


def site_sizes(cfg: ModelConfig) -> Tuple[int, ...]:
    """The mamba blocks after each site of the shared block, in order."""
    n_full, g, tail = _group_sizes(cfg)
    return (g,) * n_full + ((tail,) if tail else ())


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class SharedBlock(nn.Module):
    """The shared attention block: norms of width 2d, attention whose
    projections read 2d, and an MLP from 2d to d."""

    def __init__(self, cfg: ModelConfig, dtype=L.PARAM_DTYPE, device="cpu"):
        super().__init__()
        d2 = 2 * cfg.d_model
        self.ln_attn = L.empty_param((d2,), dtype, device)
        self.attn = L.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.d_head, dtype=dtype, device=device,
                                q_in_dim=d2)
        self.ln_mlp = L.empty_param((d2,), dtype, device)
        self.mlp = L.Mlp(d2, cfg.d_ff, dtype=dtype, device=device,
                         d_out=cfg.d_model)


class Hybrid(nn.Module):
    """Parameter container; the math is in the functions below.  Built with
    uninitialized storage: :func:`init` and :func:`params_from_arrays` fill
    it."""

    def __init__(self, cfg: ModelConfig, dtype=L.PARAM_DTYPE, device="cpu"):
        super().__init__()
        self.embed = L.empty_param((cfg.padded_vocab(), cfg.d_model), dtype,
                                   device)
        self.blocks = nn.ModuleList(
            M2.Mamba2Block(cfg, dtype, device) for _ in range(cfg.n_layers))
        self.shared = SharedBlock(cfg, dtype, device)
        self.ln_f = L.empty_param((cfg.d_model,), dtype, device)


def init(generator: torch.Generator, cfg: ModelConfig,
         dtype=L.PARAM_DTYPE) -> Hybrid:
    """Random weights from ``generator``, on its device: the mamba blocks'
    as ``mamba2.init`` draws them, the shared block's with the reference's
    initializers (normal with 1/fan-in variance, the fan-in 2d for its
    projections, unit norms), 0.02 embeddings."""
    model = Hybrid(cfg, dtype=dtype, device=generator.device)
    M2.init_blocks(model.blocks, generator, cfg, dtype)
    sh = model.shared
    sh.ln_attn.fill_(1.0)
    L.init_attention(sh.attn, generator)
    sh.ln_mlp.fill_(1.0)
    L.init_mlp(sh.mlp, generator)
    model.embed.copy_(L.embed_init(generator, tuple(model.embed.shape), dtype))
    model.ln_f.fill_(1.0)
    return model


def params_from_arrays(cfg: ModelConfig, tree: Mapping[str, Any],
                       device="cpu", dtype=L.PARAM_DTYPE) -> Hybrid:
    """Load the reference's param tree into a :class:`Hybrid`.

    ``tree`` is the reference's ``init`` output as numpy arrays: ``embed``,
    ``ln_f``, ``shared``, ``groups`` (every leaf ``[n_full, g, ...]``) and
    ``tail`` (every leaf ``[tail, ...]``, or ``None``).  Leaves go through
    fp32, then to ``dtype`` on ``device``; ``A_log``, ``dt_bias`` and ``D``
    stay fp32.
    """
    model = Hybrid(cfg, dtype=dtype, device=device)
    n_full, g, tail = _group_sizes(cfg)

    def put(dst: torch.Tensor, src) -> None:
        a = np.array(src, dtype=np.float32)  # a writable copy
        if tuple(a.shape) != tuple(dst.shape):
            raise ValueError(f"param shape {a.shape} != {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(a))

    put(model.embed, tree["embed"])
    put(model.ln_f, tree["ln_f"])
    sh = tree["shared"]
    put(model.shared.ln_attn, sh["ln_attn"])
    put(model.shared.ln_mlp, sh["ln_mlp"])
    for name, p in model.shared.attn.named_parameters():
        put(p, sh["attn"][name])
    for name, p in model.shared.mlp.named_parameters():
        put(p, sh["mlp"][name])
    if (tree.get("tail") is None) != (tail == 0):
        raise ValueError(f"{cfg.name}: a tail of {tail} layers, the tree's "
                         f"tail is {tree.get('tail') is not None}")
    names = {name for name, _ in model.blocks[0].named_parameters()}
    for stack in (tree["groups"],) + ((tree["tail"],) if tail else ()):
        if set(stack) != names:
            raise ValueError(f"block leaves {sorted(stack)} != {sorted(names)}")
    for i, blk in enumerate(model.blocks):
        for name, p in blk.named_parameters():
            src = (tree["groups"][name][i // g, i % g] if i < n_full * g
                   else tree["tail"][name][i - n_full * g])
            put(p, src)
    return model


def ref_leaves(cfg: ModelConfig, model: Hybrid) -> Dict[PT.Path, PT.RefLeaf]:
    """The reference's leaves over the module's parameters: the mamba
    blocks' as ``groups/<name>`` stacked ``[n_full, g]`` and ``tail/<name>``
    stacked ``[tail]``, the shared block's and the rest unstacked."""
    n_full, g, tail = _group_sizes(cfg)

    def regroup(path, i, n):
        if i < n_full * g:
            return ("groups",) + path[1:], (n_full, g)
        return ("tail",) + path[1:], (tail,)

    return PT.ref_leaves(model, regroup)


def params_to_arrays(cfg: ModelConfig, model: Hybrid) -> Dict[str, Any]:
    """The inverse of :func:`params_from_arrays` (``tail`` is ``None``
    without a tail, as in the reference)."""
    return PT.leaves_to_arrays(ref_leaves(cfg, model), empty=("tail",))


# ---------------------------------------------------------------------------
# the shared attention block
# ---------------------------------------------------------------------------


def _shared_mlp(sh: SharedBlock, h: torch.Tensor, emb: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    m = L.rms_norm(torch.cat([h, emb], dim=-1), sh.ln_mlp, cfg.norm_eps)
    return h + L.mlp(sh.mlp, m)


def _shared_qkv(sh: SharedBlock, h: torch.Tensor, emb: torch.Tensor,
                cfg: ModelConfig, positions: torch.Tensor):
    a = L.rms_norm(torch.cat([h, emb], dim=-1), sh.ln_attn, cfg.norm_eps)
    q, k, v = L.qkv_project(sh.attn, a)
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta), v)


def _shared_prefill(sh: SharedBlock, h: torch.Tensor, emb: torch.Tensor,
                    cfg: ModelConfig, positions: torch.Tensor):
    """The shared block over a whole sequence; returns (h, k, v)."""
    q, k, v = _shared_qkv(sh, h, emb, cfg, positions)
    o = chunked_causal_attention(q, k, v)
    h = h + L.out_project(sh.attn, o, h.dtype)
    return _shared_mlp(sh, h, emb, cfg), k, v


def _shared_decode(attn, sh: SharedBlock, h: torch.Tensor, emb: torch.Tensor,
                   cfg: ModelConfig, k_cache, v_cache, step,
                   seq_shard_axes=None) -> torch.Tensor:
    """The shared block on one token: its K and V written into the site's
    cache in place (a list of shards with ``seq_shard_axes``), attention
    through the backend (``step`` is
    :func:`repro_torch.models.transformer.decode_positions`' triple)."""
    positions, at, cache_len = step
    q, k, v = _shared_qkv(sh, h, emb, cfg, positions)
    o = TF._decode_attn(attn, q, k, v, k_cache, v_cache, at, cache_len,
                        seq_shard_axes)
    h = h + L.out_project(sh.attn, o.to(h.dtype), h.dtype)
    return _shared_mlp(sh, h, emb, cfg)


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


def _sites(params: Hybrid, cfg: ModelConfig):
    """``(site, [(layer, block), ...])`` for each site, in order."""
    layer = 0
    for site, n in enumerate(site_sizes(cfg)):
        yield site, [(i, params.blocks[i]) for i in range(layer, layer + n)]
        layer += n


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    return torch.arange(S, device=x.device)[None, :].expand(B, S)


def _site_train(sh: SharedBlock, blocks, x: torch.Tensor, emb: torch.Tensor,
                cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """One site over a whole sequence: the shared block, then its mamba
    blocks (the reference's group body)."""
    x, _, _ = _shared_prefill(sh, x, emb, cfg, positions)
    for blk in blocks:
        x, _, _ = M2.block_apply(blk, x, cfg)
    return x


def forward(params: Hybrid, tokens: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V] (fp32)."""
    emb = L.embed_tokens(params.embed, tokens)
    x, positions = emb, _positions(emb)
    for _, blocks in _sites(params, cfg):
        x = L.remat(cfg, _site_train, params.shared,
                    [blk for _, blk in blocks], x, emb, cfg, positions)
    return TF.final_logits(x, params.ln_f, params.embed, cfg)


def loss_fn(params: Hybrid, batch: Mapping[str, torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy, as the reference's."""
    logits = forward(params, batch["tokens"], cfg)
    return L.cross_entropy_loss(logits[:, :-1], batch["labels"][:, 1:],
                                batch.get("mask"))


def prefill(params: Hybrid, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int, layout: KVCacheLayout = KVCacheLayout(),
            ) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt; build the cache (module docstring), its KV stack of
    capacity ``layout.padded_len(max_len)``.  Returns the last position's
    logits [B, 1, V] (fp32) and the cache."""
    emb = L.embed_tokens(params.embed, tokens)
    B, S, _ = emb.shape
    x, positions = emb, _positions(emb)
    cache = init_attn_cache(n_shared_sites(cfg), B, max_len, cfg.n_kv_heads,
                            cfg.d_head, dtype=x.dtype, layout=layout,
                            device=x.device)
    convs, states = [], []
    for site, blocks in _sites(params, cfg):
        x, k, v = _shared_prefill(params.shared, x, emb, cfg, positions)
        update_layer_kv(cache, site, k, v, 0)
        for _, blk in blocks:
            x, conv_s, ssm_s = M2.block_apply(blk, x, cfg)
            convs.append(conv_s)
            states.append(ssm_s)
    cache["conv"] = {k: torch.stack([c[k] for c in convs])
                     for k in ("x", "B", "C")}
    cache["ssm"] = torch.stack(states)
    cache["length"].fill_(S)
    return TF.final_logits(x[:, -1:], params.ln_f, params.embed, cfg), cache


def decode_step(
    params: Hybrid, token: torch.Tensor, cache: Cache, cfg: ModelConfig,
    *, attn_backend=None, seq_shard_axes=None,
    layout: Optional[KVCacheLayout] = None,
) -> Tuple[torch.Tensor, Cache]:
    """One decode step.  token [B, 1] → logits [B, 1, V] (fp32).

    Every site's new K and V, and every layer's conv tails and state, are
    written into ``cache``'s buffers in place, and the returned cache
    shares them, with ``length`` advanced by one: a scalar, or one length
    per batch row (the continuous-batching scheduler's), as in
    :func:`repro_torch.models.transformer.decode_step`.  A caller that
    wants to reuse a cache clones it first.  ``seq_shard_axes``: the
    sites' KV stack sharded over a mesh's sequence shards, as in
    ``transformer.decode_step``; the conv tails and the state are not
    sharded."""
    attn = get_backend("attention", attn_backend)
    S = kv_capacity(cache["k"])
    if layout is not None:
        check_kv_capacity(layout, cache["k"])
    emb = L.embed_tokens(params.embed, token)
    step = TF.decode_positions(cache["length"], emb.shape[0], S, seq_shard_axes)
    conv, ssm = cache["conv"], cache["ssm"]
    x = emb
    for site, blocks in _sites(params, cfg):
        x = _shared_decode(attn, params.shared, x, emb, cfg,
                           kv_layer(cache["k"], site),
                           kv_layer(cache["v"], site), step, seq_shard_axes)
        for i, blk in blocks:
            x, conv_n, ssm_n = M2.decode_block(
                blk, x, cfg, {k: conv[k][i] for k in ("x", "B", "C")}, ssm[i])
            for k in ("x", "B", "C"):
                conv[k][i].copy_(conv_n[k])
            ssm[i].copy_(ssm_n)
    logits = TF.final_logits(x, params.ln_f, params.embed, cfg)
    return logits, {**cache, "length": cache["length"] + 1}


def cache_seq_axes(cache: Cache):
    """Growing-KV sequence axes: the sites' ``k``/``v`` stack pages into
    the KV pool (seq axis -2) like a layer stack; the conv tails, the SSM
    state and ``length`` stay slot-resident.  See
    :func:`repro_torch.models.kvcache.seq_axis_tree`."""
    return seq_axis_tree(cache)
