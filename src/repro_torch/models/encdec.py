"""Encoder-decoder backbone (seamless-m4t-medium).

Encoder: a bidirectional transformer over precomputed *frame embeddings*
(the speech frontend is a stub, as in the reference: the caller passes
``frames [B, S_src, d_model]``, cast to bf16 first as the reference casts
them).  Decoder: causal self-attention, cross-attention over the encoder's
output, an MLP.  Decoding runs the decoder against its growing
self-attention cache and the cross-attention K and V, which prefill writes
once.

The parameters live in an :class:`EncDec` module: ``embed`` (tied: the
reference unembeds with it), ``enc_blocks`` and ``dec_blocks``
(``ModuleList``\\ s), ``ln_enc`` and ``ln_f``.  The decode cache::

    {"k", "v":   [L, B, KV, S_cap, D]       the self-attention KV,
     "kc", "vc": [L, B, KV, S_src_cap, D]   the cross-attention KV,
     "length", "src_length"}

both in the decode kernel's layout, the cross capacity padded with the
same ``layout`` as the self capacity; ``src_length`` is the true source
length the cross attention decodes against.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backends import KVCacheLayout, get_backend
from repro_torch.models import layers as L
from repro_torch.models import param_tree as PT
from repro_torch.models import transformer as TF
from repro_torch.models.attention import chunked_causal_attention
from repro_torch.models.kvcache import (
    check_kv_capacity,
    kv_capacity,
    kv_layer,
    pad_kv_to_layout,
    seq_axis_tree,
)

Cache = Dict[str, Any]

__all__ = ["EncBlock", "DecBlock", "EncDec", "init", "params_from_arrays",
           "params_to_arrays", "ref_leaves", "loss_fn", "encode", "forward",
           "prefill", "decode_step", "cache_seq_axes"]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _attention(cfg: ModelConfig, dtype, device) -> L.Attention:
    return L.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                       dtype=dtype, device=device)


class EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=L.PARAM_DTYPE, device="cpu"):
        super().__init__()
        self.ln_attn = L.empty_param((cfg.d_model,), dtype, device)
        self.attn = _attention(cfg, dtype, device)
        self.ln_mlp = L.empty_param((cfg.d_model,), dtype, device)
        self.mlp = L.Mlp(cfg.d_model, cfg.d_ff, dtype=dtype, device=device)


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=L.PARAM_DTYPE, device="cpu"):
        super().__init__()
        self.ln_self = L.empty_param((cfg.d_model,), dtype, device)
        self.self_attn = _attention(cfg, dtype, device)
        self.ln_cross = L.empty_param((cfg.d_model,), dtype, device)
        self.cross_attn = _attention(cfg, dtype, device)
        self.ln_mlp = L.empty_param((cfg.d_model,), dtype, device)
        self.mlp = L.Mlp(cfg.d_model, cfg.d_ff, dtype=dtype, device=device)


class EncDec(nn.Module):
    """Parameter container; the math is in the functions below.  Built with
    uninitialized storage: :func:`init` and :func:`params_from_arrays` fill
    it."""

    def __init__(self, cfg: ModelConfig, dtype=L.PARAM_DTYPE, device="cpu"):
        super().__init__()
        d = cfg.d_model
        self.embed = L.empty_param((cfg.padded_vocab(), d), dtype, device)
        self.enc_blocks = nn.ModuleList(
            EncBlock(cfg, dtype, device) for _ in range(cfg.n_encoder_layers))
        self.dec_blocks = nn.ModuleList(
            DecBlock(cfg, dtype, device) for _ in range(cfg.n_layers))
        self.ln_enc = L.empty_param((d,), dtype, device)
        self.ln_f = L.empty_param((d,), dtype, device)


def init(generator: torch.Generator, cfg: ModelConfig,
         dtype=L.PARAM_DTYPE) -> EncDec:
    """Random weights from ``generator``, on its device, with the
    reference's initializers (normal with 1/fan-in variance, 0.02
    embeddings, unit norms), drawn in fp32 and cast to ``dtype``."""
    model = EncDec(cfg, dtype=dtype, device=generator.device)
    for blk in model.enc_blocks:
        blk.ln_attn.fill_(1.0)
        L.init_attention(blk.attn, generator)
        blk.ln_mlp.fill_(1.0)
        L.init_mlp(blk.mlp, generator)
    for blk in model.dec_blocks:
        for ln in (blk.ln_self, blk.ln_cross, blk.ln_mlp):
            ln.fill_(1.0)
        L.init_attention(blk.self_attn, generator)
        L.init_attention(blk.cross_attn, generator)
        L.init_mlp(blk.mlp, generator)
    model.embed.copy_(L.embed_init(generator, tuple(model.embed.shape), dtype))
    model.ln_enc.fill_(1.0)
    model.ln_f.fill_(1.0)
    return model


def params_from_arrays(cfg: ModelConfig, tree: Mapping[str, Any],
                       device="cpu", dtype=L.PARAM_DTYPE) -> EncDec:
    """Load the reference's param tree into an :class:`EncDec`.

    ``tree`` is the reference's ``init`` output as numpy arrays: ``embed``,
    ``ln_enc``, ``ln_f``, and ``enc_blocks`` / ``dec_blocks`` with every
    leaf stacked on a leading layer axis.  Leaves go through fp32, then to
    ``dtype`` on ``device``.
    """
    model = EncDec(cfg, dtype=dtype, device=device)

    def put(dst: torch.Tensor, src) -> None:
        a = np.array(src, dtype=np.float32)  # a writable copy
        if tuple(a.shape) != tuple(dst.shape):
            raise ValueError(f"param shape {a.shape} != {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(a))

    for name in ("embed", "ln_enc", "ln_f"):
        put(getattr(model, name), tree[name])
    for blocks, stacked in ((model.enc_blocks, tree["enc_blocks"]),
                            (model.dec_blocks, tree["dec_blocks"])):
        for i, blk in enumerate(blocks):
            for name, p in blk.named_parameters():
                sub = stacked
                for part in name.split("."):
                    sub = sub[part]
                put(p, sub[i])
    return model


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    return torch.arange(S, device=x.device)[None, :].expand(B, S)


def _project(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` accumulated in fp32, cast to
    ``dtype``."""
    d, h, k = w.shape
    return L.matmul_acc(x, w.reshape(d, h * k)).reshape(
        *x.shape[:-1], h, k).to(dtype)


def _self_attn(blk: DecBlock, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor):
    a = L.rms_norm(x, blk.ln_self, cfg.norm_eps)
    q, k, v = L.qkv_project(blk.self_attn, a)
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta), v)


def _cross_kv(blk: DecBlock, memory: torch.Tensor, dtype):
    return (_project(memory, blk.cross_attn.wk, dtype),
            _project(memory, blk.cross_attn.wv, dtype))


def _cross_q(blk: DecBlock, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    c = L.rms_norm(x, blk.ln_cross, cfg.norm_eps)
    return _project(c, blk.cross_attn.wq, x.dtype)


def _mlp_apply(blk, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return x + L.mlp(blk.mlp, L.rms_norm(x, blk.ln_mlp, cfg.norm_eps))


def encode(params: EncDec, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames [B, S_src, d_model] (the stub frontend's output) → memory
    [B, S_src, d_model] in bf16 (the frames are cast to bf16 first, as the
    reference casts them to its ``PARAM_DTYPE``)."""
    x = frames.to(L.PARAM_DTYPE)
    positions = _positions(x)
    for blk in params.enc_blocks:
        x = L.remat(cfg, _enc_block, blk, x, cfg, positions)
    return L.rms_norm(x, params.ln_enc, cfg.norm_eps)


def _enc_block(blk: EncBlock, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor) -> torch.Tensor:
    a = L.rms_norm(x, blk.ln_attn, cfg.norm_eps)
    q, k, v = L.qkv_project(blk.attn, a)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = chunked_causal_attention(q, k, v, causal=False)
    x = x + L.out_project(blk.attn, o, x.dtype)
    return _mlp_apply(blk, x, cfg)


def _dec_block(blk: DecBlock, x: torch.Tensor, memory: torch.Tensor,
               cfg: ModelConfig, positions: torch.Tensor):
    """One decoder block over a whole target sequence; returns (x, k, v,
    kc, vc), the self and cross K and V ``[B, S, KV, D]``."""
    # A view of the memory for this block alone: autograd then adds the
    # block's two bf16 cotangents of it (cross K and V) before adding them
    # to the other blocks', in the reference's association (its scan
    # accumulates each block's sum), which bf16 does not forgive.
    memory = memory.view_as(memory)
    q, k, v = _self_attn(blk, x, cfg, positions)
    o = chunked_causal_attention(q, k, v)
    x = x + L.out_project(blk.self_attn, o, x.dtype)
    qc = _cross_q(blk, x, cfg)
    kc, vc = _cross_kv(blk, memory, x.dtype)
    oc = chunked_causal_attention(qc, kc, vc, causal=False)
    x = x + L.out_project(blk.cross_attn, oc, x.dtype)
    return _mlp_apply(blk, x, cfg), k, v, kc, vc


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


def forward(params: EncDec, batch: Mapping[str, torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    """batch ``{"frames": [B, S_src, d], "tokens": [B, S]}`` → logits
    [B, S, V] (fp32)."""
    memory = encode(params, batch["frames"], cfg)
    x = L.embed_tokens(params.embed, batch["tokens"])
    positions = _positions(x)
    for blk in params.dec_blocks:
        x = L.remat(cfg, _dec_block_train, blk, x, memory, cfg, positions)
    return TF.final_logits(x, params.ln_f, params.embed, cfg)


def _dec_block_train(blk: DecBlock, x: torch.Tensor, memory: torch.Tensor,
                     cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    return _dec_block(blk, x, memory, cfg, positions)[0]


def loss_fn(params: EncDec, batch: Mapping[str, torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy of the decoder over ``batch["frames"]``'
    encoding, as the reference's."""
    logits = forward(params, batch, cfg)
    return L.cross_entropy_loss(logits[:, :-1], batch["labels"][:, 1:],
                                batch.get("mask"))


def ref_leaves(model: EncDec) -> Dict[PT.Path, PT.RefLeaf]:
    """The reference's leaves (``enc_blocks/...`` and ``dec_blocks/...``
    stacked over their layers) over the module's parameters."""
    return PT.ref_leaves(model)


def params_to_arrays(cfg: ModelConfig, model: EncDec) -> Dict[str, Any]:
    """The inverse of :func:`params_from_arrays`."""
    return PT.leaves_to_arrays(ref_leaves(model))


def prefill(params: EncDec, batch: Mapping[str, torch.Tensor],
            cfg: ModelConfig, max_len: int,
            layout: KVCacheLayout = KVCacheLayout(),
            ) -> Tuple[torch.Tensor, Cache]:
    """Encode the source and run the decoder over the prompt; cache the
    self-attention K and V at capacity ``layout.padded_len(max_len)`` and
    the cross-attention K and V at ``layout.padded_len(S_src)``.  Returns
    the last position's logits [B, 1, V] (fp32) and the cache."""
    memory = encode(params, batch["frames"], cfg)
    x = L.embed_tokens(params.embed, batch["tokens"])
    S, s_src = x.shape[1], memory.shape[1]
    positions = _positions(x)
    stacks = {key: [] for key in ("k", "v", "kc", "vc")}
    for blk in params.dec_blocks:
        x, k, v, kc, vc = _dec_block(blk, x, memory, cfg, positions)
        for key, t, n in (("k", k, max_len), ("v", v, max_len),
                          ("kc", kc, s_src), ("vc", vc, s_src)):
            stacks[key].append(pad_kv_to_layout(t, n, layout))
    cache = {key: torch.stack(ts) for key, ts in stacks.items()}
    cache["length"] = torch.tensor(S, dtype=torch.int32, device=x.device)
    cache["src_length"] = torch.tensor(s_src, dtype=torch.int32,
                                       device=x.device)
    return TF.final_logits(x[:, -1:], params.ln_f, params.embed, cfg), cache


def decode_step(
    params: EncDec, token: torch.Tensor, cache: Cache, cfg: ModelConfig,
    *, attn_backend=None, seq_shard_axes=None,
    layout: Optional[KVCacheLayout] = None,
) -> Tuple[torch.Tensor, Cache]:
    """One decoder step.  token [B, 1] → logits [B, 1, V] (fp32).

    The self-attention K and V are written into ``cache``'s buffers in
    place (as :func:`repro_torch.models.transformer.decode_step` writes
    them), and the returned cache shares them, with ``length`` advanced by
    one.  The cross attention decodes against the first ``src_length``
    positions of ``kc``/``vc``, which it never writes.  ``length`` and
    ``src_length`` are each a scalar or one per batch row (the
    continuous-batching scheduler's).  Only the growing self-attention
    cache takes part in sequence sharding (``seq_shard_axes``, as in
    ``transformer.decode_step``); the cross-attention cache stays whole
    and decodes where the model runs, as in the reference."""
    attn = get_backend("attention", attn_backend)
    S = kv_capacity(cache["k"])
    if layout is not None:
        check_kv_capacity(layout, cache["k"])
        layout.check_capacity(int(cache["kc"].shape[3]))
    x = L.embed_tokens(params.embed, token)
    step = TF.decode_positions(cache["length"], x.shape[0], S, seq_shard_axes)
    positions, at, cache_len = step
    src_len = cache["src_length"]
    for i, blk in enumerate(params.dec_blocks):
        q, k, v = _self_attn(blk, x, cfg, positions)
        o = TF._decode_attn(attn, q, k, v, kv_layer(cache["k"], i),
                            kv_layer(cache["v"], i), at, cache_len,
                            seq_shard_axes)
        x = x + L.out_project(blk.self_attn, o.to(x.dtype), x.dtype)
        oc = attn.decode(_cross_q(blk, x, cfg), cache["kc"][i],
                         cache["vc"][i], src_len)
        x = x + L.out_project(blk.cross_attn, oc.to(x.dtype), x.dtype)
        x = _mlp_apply(blk, x, cfg)
    logits = TF.final_logits(x, params.ln_f, params.embed, cfg)
    return logits, {**cache, "length": cache["length"] + 1}


def cache_seq_axes(cache: Cache):
    """Growing-KV sequence axes: the decoder's self-attention ``k``/``v``
    page into the KV pool (seq axis -2); the cross-attention ``kc``/``vc``
    are written once at prefill and stay slot-resident, as do ``length``
    and ``src_length``.  See :func:`repro_torch.models.kvcache.seq_axis_tree`."""
    return seq_axis_tree(cache)
