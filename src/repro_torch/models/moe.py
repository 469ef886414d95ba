"""Mixture-of-Experts decoder (kimi-k2-1t, deepseek-moe-16b).

Routing: the router's fp32 logits over all E experts, the top k chosen by
a stable descending sort (the lower expert id first among equal logits),
shared experts always active, and dense first layers
(``cfg.first_dense_layers``).  Two weightings of the k chosen experts:

* ``cfg.moe_norm_topk_prob`` True (the default, the reference's): a
  softmax over the k chosen logits, i.e. the top k of a softmax over all E
  renormalised to sum to one;
* False (HF ``norm_topk_prob: false``, deepseek-moe-16b as published,
  arXiv:2401.06066 and ``deepseek-ai/deepseek-moe-16b-base``'s
  ``config.json``: ``scoring_func`` softmax, ``topk_method`` greedy): a
  softmax over all E logits in fp32, the k chosen probabilities used as
  they are.

Dispatch is grouped, sort-based and of static capacity, as in the
reference: the tokens split into ``dp_groups`` groups, each expert takes at
most ``C = int(ceil(T_group·k/E) · capacity_factor)`` tokens of a group
(the rest drop), and the experts run as one batched product over the
``[E, G·C, d]`` dispatch buffer.  ``cfg.moe_capacity_factor`` None means no
capacity: C = T_group, which holds every assignment (a token's k experts
are distinct), so no token drops, as the published model serves.  Which
tokens share a group decides which compete for capacity: ``generate``
routes its whole batch as one group, and a decode step with one cache
length a row (the continuous-batching step) routes each row as its own,
as the reference's step mapped over slots does (C = 1 there, and k
distinct experts never overflow it: decode drops nothing at any factor).

Everything that depends on the data is computed on the device from shapes
alone (no ``.item()``, ``nonzero`` or boolean-mask indexing), so the
continuous-batching step that runs it can be captured in a CUDA graph.
The combine adds each token's expert outputs in a fixed order, expert id
ascending (the order of the reference's scatter-add over the ``[E, C]``
table), then the shared experts: no atomics, so a run gives the same bits
every time.  The layer's four parts run under the spans ``moe.route``,
``moe.dispatch``, ``moe.experts`` and ``moe.combine``, and each prefill
and decode step counts its routing on the device
(``core/spans.py::tally``: assignments dropped, experts hit, the
most-loaded expert over the mean).

Parameters live in a :class:`Moe` module: ``embed``, ``dense_blocks`` and
``moe_blocks`` (``ModuleList``\\ s; a moe block's experts are stacked
``[E, d, f]`` parameters and its router is fp32), ``ln_f`` and ``unembed``.
The decode cache holds one KV stack per block kind: ``{"stacks": [dense
{k, v}, moe {k, v}], "length"}``, the reference's layout, in
``cfg.moe_cache_dtype``: fp32 by default (:data:`DECODE_CACHE_DTYPE`), as
the reference keeps it; the published deployment caches in bf16, the
weights' dtype.  Without a capacity the prefill pads exactly (a padded
position's routing changes no real token's result), so the
continuous-batching scheduler serves it from its per-bucket prefill
graphs (``prefill(..., n_valid=)``, ``registry.ModelApi.prefill_pads``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import spans
from repro_torch.core.backends import KVCacheLayout, get_backend
from repro_torch.models import layers as L
from repro_torch.models import param_tree as PT
from repro_torch.models import transformer as TF
from repro_torch.models.kvcache import (
    check_kv_capacity,
    kv_capacity,
    seq_axis_tree,
)

__all__ = ["DECODE_CACHE_DTYPE", "cache_dtype", "capacity", "MoeFfn",
           "Block", "Moe", "init", "params_from_arrays", "params_to_arrays", "ref_leaves",
           "route_topk", "moe_ffn", "MOE_EP_SHARDMAP", "set_moe_ep_shardmap",
           "moe_ffn_shardmap", "moe_ffn_dispatch", "forward", "loss_fn",
           "prefill", "decode_step", "cache_seq_axes", "slice_stage_params",
           "stage_prefill", "stage_decode_step"]

ACC = L.ACC_DTYPE

# The moe family decodes from an fp32 KV cache by default, as the reference
# does: the router amplifies bf16 rounding of cached K and V into ~2.5e-2
# logit error on kimi-k2's worst rows (the reference's numerics note,
# moe.py:38-45).  ``cfg.moe_cache_dtype`` sets another.
DECODE_CACHE_DTYPE = torch.float32
_CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cache_dtype(cfg: ModelConfig) -> torch.dtype:
    """The decode cache's dtype, ``cfg.moe_cache_dtype``."""
    if cfg.moe_cache_dtype not in _CACHE_DTYPES:
        raise ValueError(f"moe_cache_dtype {cfg.moe_cache_dtype!r}; known: "
                         f"{sorted(_CACHE_DTYPES)}")
    return _CACHE_DTYPES[cfg.moe_cache_dtype]


def capacity(cfg: ModelConfig, group_tokens: int) -> int:
    """Each expert's slots in a group of ``group_tokens`` tokens:
    ``int(ceil(T·k/E) · capacity_factor)``, at least 1; with no capacity
    (``moe_capacity_factor`` None) T, every assignment kept."""
    if cfg.moe_capacity_factor is None:
        return max(1, group_tokens)
    E, k = cfg.n_experts, cfg.experts_per_token
    return max(1, int(-(-group_tokens * k // E) * cfg.moe_capacity_factor))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class MoeFfn(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=L.PARAM_DTYPE, device="cpu"):
        super().__init__()
        d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        self.router = L.empty_param((d, E), torch.float32, device)
        self.w_gate = L.empty_param((E, d, f), dtype, device)
        self.w_up = L.empty_param((E, d, f), dtype, device)
        self.w_down = L.empty_param((E, f, d), dtype, device)
        self.shared = (L.Mlp(d, f * cfg.n_shared_experts, dtype=dtype,
                             device=device)
                       if cfg.n_shared_experts else None)


class Block(nn.Module):
    """A decoder block: attention, then a dense ``mlp`` or a ``moe``."""

    def __init__(self, cfg: ModelConfig, dense: bool, dtype=L.PARAM_DTYPE,
                 device="cpu"):
        super().__init__()
        self.ln_attn = L.empty_param((cfg.d_model,), dtype, device)
        self.attn = L.Attention(cfg.d_model, cfg.eff_heads, cfg.eff_kv_heads,
                                cfg.d_head, qkv_bias=cfg.qkv_bias,
                                dtype=dtype, device=device)
        self.ln_mlp = L.empty_param((cfg.d_model,), dtype, device)
        self.mlp = L.Mlp(cfg.d_model, cfg.d_ff, dtype=dtype,
                         device=device) if dense else None
        self.moe = None if dense else MoeFfn(cfg, dtype, device)


class Moe(nn.Module):
    """Parameter container; the math is in the functions below.  Built with
    uninitialized storage: :func:`init` and :func:`params_from_arrays` fill
    it."""

    def __init__(self, cfg: ModelConfig, dtype=L.PARAM_DTYPE, device="cpu"):
        super().__init__()
        V, d = cfg.padded_vocab(), cfg.d_model
        fd = cfg.first_dense_layers
        self.embed = L.empty_param((V, d), dtype, device)
        self.dense_blocks = nn.ModuleList(
            Block(cfg, True, dtype, device) for _ in range(fd))
        self.moe_blocks = nn.ModuleList(
            Block(cfg, False, dtype, device) for _ in range(cfg.n_layers - fd))
        self.ln_f = L.empty_param((d,), dtype, device)
        self.unembed = None if cfg.tie_embeddings else L.empty_param((V, d), dtype,
                                                                device)

    @property
    def head(self) -> torch.Tensor:
        return self.embed if self.unembed is None else self.unembed


def _stacks(dense_blocks, moe_blocks) -> List[nn.ModuleList]:
    """The block stacks present, in layer order (the reference's
    ``_stacked_blocks``/``_present_stacks``): one KV stack each."""
    return [s for s in (dense_blocks, moe_blocks) if s is not None and len(s)]


def init(generator: torch.Generator, cfg: ModelConfig,
         dtype=L.PARAM_DTYPE) -> Moe:
    """Random weights from ``generator``, on its device, with the
    reference's initializers (normal with 1/fan-in variance, 0.02
    embeddings, unit norms, an fp32 router), each expert bank scaled by
    its own fan-in: d for ``w_gate`` and ``w_up``, f for ``w_down``.  (The
    reference's ``init_moe_ffn`` leaves ``w_gate``/``w_up`` to
    ``dense_init``'s default, the leading axis E, which makes every moe
    output ~10x the residual stream: a routing so sensitive that one
    bf16 rounding of an attention output changes the experts of most
    tokens within a few layers, PERF.md §6.  Only the scale of random
    weights differs; loaded weights (:func:`params_from_arrays`) are the
    reference's.)"""
    model = Moe(cfg, dtype=dtype, device=generator.device)
    for block in list(model.dense_blocks) + list(model.moe_blocks):
        block.ln_attn.fill_(1.0)
        L.init_attention(block.attn, generator)
        block.ln_mlp.fill_(1.0)
        if block.mlp is not None:
            L.init_mlp(block.mlp, generator)
            continue
        m = block.moe
        m.router.copy_(L.dense_init(generator, tuple(m.router.shape),
                                    dtype=torch.float32))
        for w in (m.w_gate, m.w_up):
            w.copy_(L.dense_init(generator, tuple(w.shape),
                                 in_axis_size=cfg.d_model, dtype=dtype))
        m.w_down.copy_(L.dense_init(generator, tuple(m.w_down.shape),
                                    in_axis_size=cfg.moe_d_ff, dtype=dtype))
        if m.shared is not None:
            L.init_mlp(m.shared, generator)
    model.embed.copy_(L.embed_init(generator, tuple(model.embed.shape), dtype))
    model.ln_f.fill_(1.0)
    if model.unembed is not None:
        model.unembed.copy_(L.embed_init(generator, tuple(model.unembed.shape),
                                         dtype))
    return model


def params_from_arrays(cfg: ModelConfig, tree: Mapping[str, Any],
                       device="cpu", dtype=L.PARAM_DTYPE) -> Moe:
    """Load the reference's param tree into a :class:`Moe`.

    ``tree`` is the reference's ``init`` output as numpy arrays:
    ``embed``, ``ln_f``, optional ``unembed``, and ``dense_blocks`` (or
    ``None``) and ``moe_blocks`` with every leaf stacked on a leading layer
    axis.  Leaves go through fp32 (bf16 → fp32 → bf16 is exact), then to
    ``dtype`` on ``device``; the router stays fp32, as the reference's.
    """
    model = Moe(cfg, dtype=dtype, device=device)

    def put(dst: torch.Tensor, src) -> None:
        a = np.array(src, dtype=np.float32)  # a writable copy
        if tuple(a.shape) != tuple(dst.shape):
            raise ValueError(f"param shape {a.shape} != {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(a))

    def load(module: nn.Module, stacked: Mapping[str, Any], i: int) -> None:
        for name, p in module.named_parameters():
            node = stacked
            for part in name.split("."):
                node = node[part]
            put(p, node[i])

    put(model.embed, tree["embed"])
    put(model.ln_f, tree["ln_f"])
    if model.unembed is not None:
        put(model.unembed, tree["unembed"])
    elif "unembed" in tree:
        raise ValueError(f"{cfg.name} ties its embeddings; the tree has an unembed")
    for key in ("dense_blocks", "moe_blocks"):
        blocks = getattr(model, key)
        if len(blocks) and tree.get(key) is None:
            raise ValueError(f"the tree has no {key} for {len(blocks)} layers")
        for i, block in enumerate(blocks):
            load(block, tree[key], i)
    return model


# ---------------------------------------------------------------------------
# routing + dispatch
# ---------------------------------------------------------------------------


def _total_order(x: torch.Tensor) -> torch.Tensor:
    """fp32 → int32 keys in the total order ``jax.lax.top_k`` sorts by:
    the order of the values, with -0.0 below +0.0."""
    bits = x.to(ACC).contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def route_topk(logits: torch.Tensor, k: int, normalize: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[T, E]`` → (gate weights ``[T, k]`` fp32; expert ids ``[T, k]``),
    the ids as ``jax.lax.top_k``: a stable descending sort keeps the lower
    expert id first among equal logits (``torch.topk`` promises no order on
    ties), and the sort keys put -0.0 below +0.0.  The weights are a
    softmax over the k selected logits (``normalize``, the reference's), or
    the k selected entries of a softmax over all E, not renormalised."""
    _, idx = torch.sort(_total_order(logits), dim=-1, descending=True,
                        stable=True)
    idx = idx[..., :k]
    if not normalize:
        return torch.gather(torch.softmax(logits.to(ACC), dim=-1), -1, idx), idx
    vals = torch.gather(logits, -1, idx)
    return torch.softmax(vals.to(ACC), dim=-1), idx


def _dispatch_tables(e_flat: torch.Tensor, E: int, C: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch within each token group.

    ``e_flat``: ``[..., A]`` expert id per assignment (A = T_group·k).
    Returns ``(table [..., E, C], valid [..., E, C])``: slot (e, c) holds
    the assignment that is expert e's c-th in (stable) sorted order, while
    c < C; an empty slot holds 0 and is not valid.  The reference drops the
    overflow with a scatter ``mode="drop"`` at column C; here the table has
    a column C that takes the overflow and is cut off."""
    lead, A = e_flat.shape[:-1], e_flat.shape[-1]
    e = e_flat.reshape(-1, A).long()
    n, dev = e.shape[0], e.device
    order = torch.argsort(e, dim=-1, stable=True)
    sorted_e = torch.gather(e, 1, order)
    experts = torch.arange(E, device=dev).expand(n, E).contiguous()
    seg_start = torch.searchsorted(sorted_e, experts, side="left")
    rank = torch.arange(A, device=dev) - torch.gather(seg_start, 1, sorted_e)
    col = torch.where(rank < C, rank, torch.full_like(rank, C))
    table = torch.full((n, E, C + 1), A, dtype=torch.long, device=dev)
    table[torch.arange(n, device=dev)[:, None], sorted_e, col] = order
    table = table[:, :, :C]
    valid = table < A
    table = torch.where(valid, table, torch.zeros_like(table))
    return table.reshape(*lead, E, C), valid.reshape(*lead, E, C)


def _routed_experts(router: torch.Tensor, w_gate: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor, x: torch.Tensor,
                    cfg: ModelConfig, groups: int = 1, e0: int = 0):
    """The routed experts of ``x [B, S, d]``: every token routed against
    all E experts (``router [d, E]``), the tokens split into ``groups``
    groups, each expert taking at most ``C`` (:func:`capacity`) of a
    group's tokens, and the experts ``[e0, e0 + E_local)`` run, whose
    stacked weights ``w_* [E_local, ...]`` are given (all E of them for
    :func:`moe_ffn`, one model shard's for :func:`_moe_ffn_local`).  An assignment to an expert outside the range
    goes to a sentinel expert that is cut off; the stable sort ranks the
    range's assignments as the unsharded dispatch ranks them, so the same
    tokens drop.  Returns (each token's terms of the range's experts [T,
    d] fp32, added in expert order from +0.0; the router logits [T, E];
    the expert ids [T, k]; the slots' ``valid`` [G, E_local, C])."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    E_local = w_gate.shape[0]
    xf = x.reshape(B * S, d)
    T = B * S
    G = max(1, min(groups, T))
    while T % G:
        G -= 1
    Tg = T // G
    C = capacity(cfg, Tg)
    dev = x.device

    with spans.span("moe.route"):
        logits = xf.to(ACC) @ router                  # [T, E] fp32
        w, idx = route_topk(logits, k, cfg.moe_norm_topk_prob)  # [T, k]
    with spans.span("moe.dispatch"):
        if E_local == E:                              # every expert here
            tables, valid = _dispatch_tables(idx.reshape(G, Tg * k), E, C)
        else:
            e_rel = idx - e0
            e_flat = torch.where((e_rel >= 0) & (e_rel < E_local), e_rel,
                                 torch.full_like(e_rel, E_local))
            tables, valid = _dispatch_tables(e_flat.reshape(G, Tg * k),
                                             E_local + 1, C)
            tables, valid = tables[:, :E_local], valid[:, :E_local]  # [G, El, C]

        # the token of each slot: slot (g, e, c) holds assignment
        # g·Tg·k + tables[g, e, c], whose token is that over k
        base = (torch.arange(G, device=dev) * (Tg * k))[:, None, None]
        slot_token = ((tables + base) // k).transpose(0, 1).reshape(
            E_local, G * C)
        xe = xf[slot_token]                           # [El, G·C, d]
    with spans.span("moe.experts"):
        gate = L.bmm_acc(xe, w_gate)
        up = L.bmm_acc(xe, w_up)
        h = (torch.nn.functional.silu(gate) * up).to(x.dtype)
        oe = L.bmm_acc(h, w_down).reshape(E_local * G * C, d)  # fp32
    with spans.span("moe.combine"):
        out = _combine(oe, w, idx, tables, valid)
    return out, logits, idx, valid


def _combine(oe: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
             tables: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Each token's weighted expert outputs ``[T, d]`` fp32 from the
    products' rows ``oe [E_local·G·C, d]`` (``tables``/``valid`` ``[G,
    E_local, C]``, gate weights ``w`` and ids ``idx`` ``[T, k]``), added
    in expert id order."""
    (G, E_local, C), (T, k), d = tables.shape, idx.shape, oe.shape[1]
    Tg, dev = T // G, oe.device

    # Each assignment's slot, read back from the tables: slot (g, e, c)
    # holds assignment tables[g, e, c] when valid.  An assignment that was
    # dropped, or went to another shard's expert, keeps -1; the scatter of
    # the empty slots aims at a column A that is cut off.  Valid slots
    # hold distinct assignments.
    A = Tg * k
    slot_ids = torch.arange(E_local * C, device=dev).expand(G, E_local * C)
    aim = torch.where(valid, tables, torch.full_like(tables, A)).reshape(
        G, E_local * C)
    slot_of = torch.full((G, A + 1), -1, dtype=torch.long, device=dev)
    slot_of.scatter_(1, aim, slot_ids)
    s = slot_of[:, :A].reshape(T, k)                  # per token and choice
    kept = s >= 0
    s = s.clamp(min=0)
    g_of = (torch.arange(T, device=dev) // Tg)[:, None]
    rows = (s // C) * (G * C) + g_of * C + s % C
    contrib = oe[rows] * w[..., None]                 # [T, k, d]
    contrib = torch.where(kept[..., None], contrib, torch.zeros_like(contrib))
    # expert id ascending, each token's sum started from +0.0 as the
    # reference's scatter-add starts from its zeros
    order = torch.argsort(idx, dim=-1, stable=True)
    contrib = torch.gather(contrib, 1, order[..., None].expand(T, k, d))
    out = torch.zeros((T, d), dtype=ACC, device=dev)
    for j in range(k):
        out = out + contrib[:, j]
    return out


def _lb_loss(logits: torch.Tensor, idx: torch.Tensor, E: int) -> torch.Tensor:
    """The Switch-style load-balancing loss of a routing, as the
    reference computes it."""
    T, k = idx.shape
    counts = torch.zeros((E,), dtype=ACC, device=idx.device).scatter_add_(
        0, idx.reshape(-1), torch.ones((T * k,), dtype=ACC, device=idx.device))
    return E * torch.sum((counts / (T * k)) * torch.softmax(logits, -1).mean(0))


def moe_ffn(p: MoeFfn, x: torch.Tensor, cfg: ModelConfig, dp_groups: int = 1,
            metrics: bool = True
            ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x ``[B, S, d]`` → (out ``[B, S, d]`` in ``x.dtype``, metrics).

    Every expert runs here (:func:`_routed_experts` over all E), the
    shared experts added in fp32 before the one rounding to ``x.dtype``.
    ``metrics`` (the Switch-style ``lb_loss`` and the share of empty
    expert slots ``drop_frac``, as the reference computes them) are
    ``None`` with ``metrics=False``, which serving passes.  The routing
    is counted into the open tally, where one is (``spans.tally``)."""
    B, S, d = x.shape
    out, logits, idx, valid = _routed_experts(p.router, p.w_gate, p.w_up,
                                              p.w_down, x, cfg, dp_groups)
    spans.count_routing(idx, valid, cfg.n_experts)
    if p.shared is not None:
        out = out + L.mlp(p.shared, x).reshape(B * S, d).to(ACC)
    out = out.reshape(B, S, d).to(x.dtype)
    if not metrics:
        return out, None
    return out, {"lb_loss": _lb_loss(logits, idx, cfg.n_experts),
                 "drop_frac": 1.0 - valid.to(ACC).mean()}


# ---------------------------------------------------------------------------
# expert parallelism over a mesh's model axis
# ---------------------------------------------------------------------------

# Off unless a launcher turns it on, as in the reference.  Every shard of
# the model axis routes the same tokens against all E experts, gathers only
# its own E / m experts' tokens and runs their products; a sum over the
# shards (the reference's one psum of the [T, d] output a moe layer)
# combines them.
MOE_EP_SHARDMAP = False


def set_moe_ep_shardmap(on: bool) -> None:
    global MOE_EP_SHARDMAP
    MOE_EP_SHARDMAP = on


def _expert_slice(p: MoeFfn, e0: int, E_local: int, dev) -> Dict[str, torch.Tensor]:
    """Shard ``[e0, e0 + E_local)``'s expert weights: views of the stacked
    ``[E, ...]`` parameters (never copies) on the parameters' device; a
    copy to ``dev`` only where the shard lives on another device."""
    return {name: getattr(p, name)[e0:e0 + E_local].to(dev)
            for name in ("w_gate", "w_up", "w_down")}


def _moe_ffn_local(p_local: Mapping[str, torch.Tensor], x: torch.Tensor,
                   cfg: ModelConfig, e0: int, E_local: int, groups: int = 1
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route against all E experts; evaluate only experts ``[e0, e0 +
    E_local)``.  ``p_local``: the full ``router`` and the shard's
    ``w_gate``, ``w_up``, ``w_down`` (``[E_local, ...]``).  Returns the
    shard's fp32 output ``[B, S, d]`` and the load-balancing loss."""
    if p_local["w_gate"].shape[0] != E_local:
        raise ValueError(f"the shard's experts are {p_local['w_gate'].shape[0]}, "
                         f"not {E_local}")
    out, logits, idx, _ = _routed_experts(
        p_local["router"], p_local["w_gate"], p_local["w_up"],
        p_local["w_down"], x, cfg, groups, e0)
    return out.reshape(x.shape), _lb_loss(logits, idx, cfg.n_experts)


def moe_ffn_shardmap(p: MoeFfn, x: torch.Tensor, cfg: ModelConfig,
                     dp_groups: int = 1
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Expert parallelism over the shard context's model axis
    (``layers.set_shard_ctx``), as the reference's ``shard_map``
    schedule: shard ``m`` of the axis (on the mesh's entry ``m`` along
    it) evaluates experts ``[m · E/M, (m + 1) · E/M)`` of the tokens
    (:func:`_moe_ffn_local`), and the shards' fp32 outputs are summed in
    shard order on the first shard's device (the psum), rounded to
    ``x.dtype``; the shared experts run once outside, added in
    ``x.dtype``, as in the reference.  The tokens group as the data axes
    split them in the reference (``dp`` size groups), or by ``dp_groups``
    where a caller asks for more (the continuous-batching step routes
    each slot as its own group).  Returns ``(out, {"lb_loss",
    "drop_frac": 0})``; ``lb_loss`` is shard 0's, equal on every shard."""
    from repro_torch.launch.mesh import mesh_axes_of

    ctx = L.shard_ctx()
    mesh, model_axis = ctx["mesh"], ctx["model"]
    devices = mesh.along(model_axis)
    E_local = cfg.n_experts // len(devices)
    dp_size = mesh_axes_of(mesh).axis_size(tuple(ctx["dp"])) if ctx["dp"] else 1
    groups = dp_groups if dp_groups > 1 else dp_size
    outs, lbs = [], []
    for m, dev in enumerate(devices):
        e0 = m * E_local
        p_local = {"router": p.router.to(dev),
                   **_expert_slice(p, e0, E_local, dev)}
        out, lb = _moe_ffn_local(p_local, x.to(dev), cfg, e0, E_local, groups)
        outs.append(out)
        lbs.append(lb)
    total = outs[0]
    for out in outs[1:]:
        total = total + out.to(total.device)
    out = total.to(x.device).to(x.dtype)
    if p.shared is not None:  # the shared experts stay outside the shards
        out = out + L.mlp(p.shared, x)
    return out, {"lb_loss": lbs[0].to(x.device),
                 "drop_frac": torch.zeros((), dtype=ACC, device=x.device)}


def moe_ffn_dispatch(p: MoeFfn, x: torch.Tensor, cfg: ModelConfig,
                     dp_groups: int = 1, metrics: bool = True):
    """The moe layer every block runs: :func:`moe_ffn_shardmap` when
    :data:`MOE_EP_SHARDMAP` is on, a shard context with a model axis is
    set and ``n_experts`` divides that axis's size (the reference's
    condition), :func:`moe_ffn` otherwise."""
    ctx = L.shard_ctx()
    if (MOE_EP_SHARDMAP and ctx["mesh"] is not None and ctx["model"]
            and cfg.n_experts % ctx["mesh"].shape[ctx["model"]] == 0):
        return moe_ffn_shardmap(p, x, cfg, dp_groups)
    return moe_ffn(p, x, cfg, dp_groups, metrics=metrics)


def _ffn(cfg: ModelConfig, dp_groups: int) -> Callable:
    """A block's feed-forward half, residual included: the dense ``mlp``
    or the routed ``moe`` (:func:`moe_ffn_dispatch`)."""
    def ffn(block: Block, x: torch.Tensor) -> torch.Tensor:
        h = L.rms_norm(x, block.ln_mlp, cfg.norm_eps)
        if block.mlp is not None:
            return x + L.mlp(block.mlp, h)
        out, _ = moe_ffn_dispatch(block.moe, h, cfg, dp_groups, metrics=False)
        return x + out
    return ffn


# ---------------------------------------------------------------------------
# forward (teacher-forced)
# ---------------------------------------------------------------------------


def _block_train(block: Block, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, dp_groups: int):
    """One block over a whole sequence: (x, the moe layer's ``lb_loss``,
    ``None`` for a dense block)."""
    x, _, _ = TF._attn_prefill(block, x, cfg, positions)
    h = L.rms_norm(x, block.ln_mlp, cfg.norm_eps)
    if block.mlp is not None:
        return x + L.mlp(block.mlp, h), None
    out, m = moe_ffn_dispatch(block.moe, h, cfg, dp_groups)
    return x + out, m["lb_loss"]


def forward(params: Moe, tokens: torch.Tensor, cfg: ModelConfig,
            dp_groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] → (logits [B, S, V] fp32, the moe layers' summed
    ``lb_loss``)."""
    x = L.embed_tokens(params.embed, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    lb = torch.zeros((), dtype=ACC, device=x.device)
    for block in list(params.dense_blocks) + list(params.moe_blocks):
        x, lb_block = L.remat(cfg, _block_train, block, x, cfg, positions,
                              dp_groups)
        if lb_block is not None:
            lb = lb + lb_block
    return TF.final_logits(x, params.ln_f, params.head, cfg), lb


def loss_fn(params: Moe, batch: Mapping[str, torch.Tensor], cfg: ModelConfig,
            dp_groups: int = 1, lb_coeff: float = 0.01) -> torch.Tensor:
    """Next-token cross-entropy plus ``lb_coeff`` times the moe layers'
    mean load-balancing loss, as the reference's."""
    logits, lb = forward(params, batch["tokens"], cfg, dp_groups)
    ce = L.cross_entropy_loss(logits[:, :-1], batch["labels"][:, 1:],
                              batch.get("mask"))
    n_moe = cfg.n_layers - cfg.first_dense_layers
    return ce + lb_coeff * lb / max(1, n_moe)


def ref_leaves(model: Moe) -> Dict[PT.Path, PT.RefLeaf]:
    """The reference's leaves (``dense_blocks/...`` and ``moe_blocks/...``
    stacked over their layers) over the module's parameters."""
    return PT.ref_leaves(model)


def params_to_arrays(cfg: ModelConfig, model: Moe) -> Dict[str, Any]:
    """The inverse of :func:`params_from_arrays` (``dense_blocks`` is
    ``None`` without dense layers, as in the reference)."""
    return PT.leaves_to_arrays(ref_leaves(model), empty=("dense_blocks",))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _prefill_stacks(stacks, x, cfg, max_len, dp_groups, layout,
                    n_valid=None):
    caches = []
    for blocks in stacks:
        x, c = TF.prefill_layers(blocks, x, cfg, max_len, layout,
                                 _ffn(cfg, dp_groups),
                                 cache_dtype=cache_dtype(cfg), n_valid=n_valid)
        caches.append({"k": c["k"], "v": c["v"]})
    return x, {"stacks": caches, "length": c["length"]}


def _decode_stacks(attn, stacks, x, cache, cfg, dp_groups,
                   seq_shard_axes=None):
    S = kv_capacity(cache["stacks"][-1]["k"])
    step = TF.decode_positions(cache["length"], x.shape[0], S, seq_shard_axes)
    for blocks, kv in zip(stacks, cache["stacks"]):
        x = TF.decode_layers(attn, blocks, x, kv["k"], kv["v"], cfg, step,
                             _ffn(cfg, dp_groups), seq_shard_axes)
    return x, {**cache, "length": cache["length"] + 1}


def prefill(params: Moe, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int, dp_groups: int = 1,
            layout: KVCacheLayout = KVCacheLayout(),
            n_valid: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt; the cache holds one ``[L, B, KV, S_cap, D]`` KV
    stack per block kind in :func:`cache_dtype`.  Returns the last
    position's logits [B, 1, V] (fp32) and the cache.

    ``n_valid`` (an int32 scalar on the device): the prompt is padded at
    its end and its first n positions are real; the logits are position
    n - 1's and the cache's ``length`` is n, without a host read, as
    ``transformer.prefill`` pads.  Exact only without a capacity
    (``moe_capacity_factor`` None): a capacity counts the padded tokens'
    assignments too, which can push a real token's out.  The routing is
    counted under ``moe.prefill`` (``spans.tally``)."""
    if n_valid is not None and cfg.moe_capacity_factor is not None:
        raise ValueError("a padded moe prefill needs no capacity "
                         "(moe_capacity_factor None): padded tokens would "
                         "compete for the experts' slots")
    with spans.tally("moe.prefill"):
        x = L.embed_tokens(params.embed, tokens)
        x, cache = _prefill_stacks(
            _stacks(params.dense_blocks, params.moe_blocks), x, cfg, max_len,
            dp_groups, layout, n_valid)
        if n_valid is None:
            last = x[:, -1:]
        else:
            last = x.index_select(1, (n_valid.long() - 1).reshape(1))
        return TF.final_logits(last, params.ln_f, params.head, cfg), cache


def decode_step(params: Moe, token: torch.Tensor, cache: Dict[str, Any],
                cfg: ModelConfig, dp_groups: int = 1, *, attn_backend=None,
                seq_shard_axes=None, layout: Optional[KVCacheLayout] = None,
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step, token [B, 1] → logits [B, 1, V] (fp32), as
    ``transformer.decode_step`` (K and V written in place; ``length`` a
    scalar or ``[B]``).  The backend gets a ``q`` in the params' dtype and
    the cache in :func:`cache_dtype`; with an fp32 cache it widens ``q``
    and rounds its output to ``q``'s dtype.
    ``dp_groups`` groups the B tokens for routing when the batch shares
    one length; with one length a row (the continuous-batching slots,
    each its own request) each row is its own group, as each B = 1 step
    of the reference's scheduler routes its one token, so that a row's
    experts never depend on its neighbours.  ``seq_shard_axes``: the
    sequence-sharded step over a mesh, as in
    ``transformer.decode_step``.  The routing is counted under
    ``moe.decode`` (``spans.tally``)."""
    attn = get_backend("attention", attn_backend)
    if cache["length"].dim() == 1:
        dp_groups = token.shape[0]
    if layout is not None:
        check_kv_capacity(layout, cache["stacks"][-1]["k"])
    with spans.tally("moe.decode"):
        x = L.embed_tokens(params.embed, token)
        x, new_cache = _decode_stacks(
            attn, _stacks(params.dense_blocks, params.moe_blocks), x, cache,
            cfg, dp_groups, seq_shard_axes)
        return TF.final_logits(x, params.ln_f, params.head, cfg), new_cache


def cache_seq_axes(cache):
    """Growing-KV sequence axes: every ``k``/``v`` leaf inside ``stacks``
    pages into the KV pool (seq axis -2); ``length`` stays slot-resident.
    See :func:`repro_torch.models.kvcache.seq_axis_tree`."""
    return seq_axis_tree(cache)


# ---------------------------------------------------------------------------
# pipeline stages (the serverless LM executor, ``faas/lm_pipeline.py``)
# ---------------------------------------------------------------------------
#
# Global layer ``l`` is ``dense_blocks[l]`` for ``l < first_dense_layers``
# and ``moe_blocks[l - first_dense_layers]`` otherwise.  A stage slices
# each stack it straddles; the stage functions run ``_prefill_stacks`` and
# ``_decode_stacks`` over the slices, so chained stages run the monolithic
# model's per-layer ops in the same order.


def _stage_stacks(cfg: ModelConfig, start: int, stop: int):
    """(dense_range, moe_range) a [start, stop) slice covers — either may be
    ``None``.  The moe range is stack-local (offset by first_dense_layers)."""
    fd = cfg.first_dense_layers
    dense = (start, min(stop, fd))
    m = (max(start, fd) - fd, stop - fd)
    return (dense if dense[1] > dense[0] else None,
            m if m[1] > m[0] else None)


def slice_stage_params(params: Moe, spec, cfg: ModelConfig) -> Dict[str, Any]:
    """The parameters stage ``spec`` keeps resident: a ``ModuleList`` slice
    of each stack it straddles (sharing the model's modules, no copy) and,
    as it needs them, ``embed``, ``ln_f`` and ``unembed``."""
    dense_r, moe_r = _stage_stacks(cfg, spec.start, spec.stop)
    out: Dict[str, Any] = {
        "dense_blocks": (params.dense_blocks[dense_r[0]:dense_r[1]]
                         if dense_r else None),
        "moe_blocks": (params.moe_blocks[moe_r[0]:moe_r[1]]
                       if moe_r else None),
    }
    if spec.has_embed:
        out["embed"] = params.embed
    if spec.has_head:
        out["ln_f"] = params.ln_f
        if params.unembed is not None:
            out["unembed"] = params.unembed
        elif not spec.has_embed:
            out["embed"] = params.embed  # a tied head needs the table
    return out


def stage_prefill(sp: Dict[str, Any], spec, x_in: torch.Tensor,
                  cfg: ModelConfig, max_len: int, dp_groups: int = 1,
                  layout: KVCacheLayout = KVCacheLayout(),
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One stage of ``prefill``: token ids [B, S] in on the embedding stage,
    hidden states [B, S, d] otherwise; logits [B, 1, V] out on the head
    stage.  The stage's KV stacks stay resident in its cache."""
    x = L.embed_tokens(sp["embed"], x_in) if spec.has_embed else x_in
    x, cache = _prefill_stacks(_stacks(sp["dense_blocks"], sp["moe_blocks"]),
                               x, cfg, max_len, dp_groups, layout)
    if spec.has_head:
        return TF.stage_head(sp, x[:, -1:], cfg), cache
    return x, cache


def stage_decode_step(sp: Dict[str, Any], spec, x_in: torch.Tensor,
                      cache: Dict[str, Any], cfg: ModelConfig,
                      dp_groups: int = 1, *, attn_backend=None,
                      ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One stage of ``decode_step``: token [B, 1] in on the embedding
    stage, hidden [B, 1, d] otherwise; logits [B, 1, V] out on the head
    stage."""
    attn = get_backend("attention", attn_backend)
    x = L.embed_tokens(sp["embed"], x_in) if spec.has_embed else x_in
    x, new_cache = _decode_stacks(
        attn, _stacks(sp["dense_blocks"], sp["moe_blocks"]), x, cache, cfg,
        dp_groups)
    if spec.has_head:
        return TF.stage_head(sp, x, cfg), new_cache
    return x, new_cache
