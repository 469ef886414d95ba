"""Mamba2 — SSD (state-space duality) blocks [arXiv:2405.21060].

Chunked SSD: the sequence splits into chunks of ``cfg.ssm_chunk``; within a
chunk the recurrence is a masked, decay-weighted product, and the chunk
states are carried by a short recurrence.  This is the decomposition of the
paper's Listing 1, and :func:`ssd_chunked` is the plain version of the
``ssd_scan`` kernel (``kernels/ssd_scan``).  Decode is the O(1) recurrent
update of the ``[B, H, P, N]`` state.

The parameters live in a :class:`Mamba2` module in the reference's layouts
(``in_z [d, di]``, ``conv_x_w [K, di]``, ``out_proj [di, d]``, ...);
``A_log``, ``dt_bias`` and ``D`` are fp32 whatever the other leaves'
dtype.  Where the reference scans over stacked blocks and maps over
chunks, the port loops over the ``ModuleList`` in Python and batches the
chunks into one einsum.  The fp32 points are the reference's: every
``ACC`` cast, ``clip(., -60, 0)`` before every ``exp``, softplus of
``dt + dt_bias`` in fp32, and ``A = -exp(A_log)``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import param_tree as PT
from repro_torch.models.kvcache import seq_axis_tree

ACC = torch.float32
Cache = Dict[str, Any]

__all__ = ["Mamba2Block", "Mamba2", "init", "init_blocks", "params_from_arrays",
           "params_to_arrays", "ref_leaves", "loss_fn",
           "chunk_cumsum", "causal_conv", "ssd_chunked", "ssd_decode", "ssm_inputs",
           "block_apply", "decode_block", "forward", "prefill", "decode_step",
           "cache_seq_axes"]

_FP32_LEAVES = ("A_log", "dt_bias", "D")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class Mamba2Block(nn.Module):
    """One block's parameters.  Projections are kept per component (z, x,
    B, C, dt), as in the reference."""

    def __init__(self, cfg: ModelConfig, dtype=L.PARAM_DTYPE, device="cpu"):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner
        H, gn, K = cfg.ssm_heads, cfg.ssm_groups * cfg.ssm_state, cfg.conv_kernel
        shapes = {"ln": (d,), "in_z": (d, di), "in_x": (d, di),
                  "in_B": (d, gn), "in_C": (d, gn), "in_dt": (d, H),
                  "conv_x_w": (K, di), "conv_x_b": (di,),
                  "conv_B_w": (K, gn), "conv_B_b": (gn,),
                  "conv_C_w": (K, gn), "conv_C_b": (gn,),
                  "A_log": (H,), "dt_bias": (H,), "D": (H,),
                  "norm": (di,), "out_proj": (di, d)}
        for name, shape in shapes.items():
            dt = torch.float32 if name in _FP32_LEAVES else dtype
            setattr(self, name, L.empty_param(shape, dt, device))


class Mamba2(nn.Module):
    """Parameter container; the math is in the functions below.  Built with
    uninitialized storage: :func:`init` and :func:`params_from_arrays` fill
    it.  The embeddings are tied (the reference unembeds with ``embed``)."""

    def __init__(self, cfg: ModelConfig, dtype=L.PARAM_DTYPE, device="cpu"):
        super().__init__()
        self.embed = L.empty_param((cfg.padded_vocab(), cfg.d_model), dtype,
                                   device)
        self.blocks = nn.ModuleList(
            Mamba2Block(cfg, dtype, device) for _ in range(cfg.n_layers))
        self.ln_f = L.empty_param((cfg.d_model,), dtype, device)


def init(generator: torch.Generator, cfg: ModelConfig,
         dtype=L.PARAM_DTYPE) -> Mamba2:
    """Random weights from ``generator``, on its device: the reference's
    initializers (normal with 1/fan-in variance, the convolutions' fan-in
    the kernel width, 0.02 embeddings, unit norms, zero biases, ``A_log``
    0, ``dt_bias`` -2, ``D`` 1), drawn in fp32 and cast to ``dtype``."""
    model = Mamba2(cfg, dtype=dtype, device=generator.device)
    init_blocks(model.blocks, generator, cfg, dtype)
    model.embed.copy_(L.embed_init(generator, tuple(model.embed.shape), dtype))
    model.ln_f.fill_(1.0)
    return model


def init_blocks(blocks, generator: torch.Generator, cfg: ModelConfig,
                dtype=L.PARAM_DTYPE) -> None:
    """Fill each :class:`Mamba2Block` of ``blocks`` with :func:`init`'s
    random weights."""
    K, di = cfg.conv_kernel, cfg.d_inner
    for blk in blocks:
        for name in ("in_z", "in_x", "in_B", "in_C", "in_dt"):
            p = getattr(blk, name)
            p.copy_(L.dense_init(generator, tuple(p.shape), dtype=dtype))
        for name in ("conv_x_w", "conv_B_w", "conv_C_w"):
            p = getattr(blk, name)
            p.copy_(L.dense_init(generator, tuple(p.shape), in_axis_size=K,
                                 dtype=dtype))
        blk.out_proj.copy_(L.dense_init(generator, tuple(blk.out_proj.shape),
                                        in_axis_size=di, dtype=dtype))
        for name in ("conv_x_b", "conv_B_b", "conv_C_b", "A_log"):
            getattr(blk, name).zero_()
        for name in ("ln", "norm", "D"):
            getattr(blk, name).fill_(1.0)
        blk.dt_bias.fill_(-2.0)


def params_from_arrays(cfg: ModelConfig, tree: Mapping[str, Any],
                       device="cpu", dtype=L.PARAM_DTYPE) -> Mamba2:
    """Load the reference's param tree into a :class:`Mamba2`.

    ``tree`` is the reference's ``init`` output as numpy arrays
    (``jax.tree.map(np.asarray, params)``): ``embed``, ``ln_f`` and
    ``blocks`` with every leaf stacked on a leading layer axis.  Leaves go
    through fp32 (bf16 → fp32 → bf16 is exact), then to ``dtype`` on
    ``device``; ``A_log``, ``dt_bias`` and ``D`` stay fp32.
    """
    model = Mamba2(cfg, dtype=dtype, device=device)

    def put(dst: torch.Tensor, src) -> None:
        a = np.array(src, dtype=np.float32)  # a writable copy
        if tuple(a.shape) != tuple(dst.shape):
            raise ValueError(f"param shape {a.shape} != {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(a))

    put(model.embed, tree["embed"])
    put(model.ln_f, tree["ln_f"])
    blocks = tree["blocks"]
    names = {name for name, _ in model.blocks[0].named_parameters()}
    if set(blocks) != names:
        raise ValueError(f"block leaves {sorted(blocks)} != {sorted(names)}")
    for i, blk in enumerate(model.blocks):
        for name, p in blk.named_parameters():
            put(p, blocks[name][i])
    return model


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

SCAN_BLOCK = 16


def chunk_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along the last dim in a fixed fp32 association:
    sequential within blocks of ``SCAN_BLOCK``, then each block's partial
    sums plus the inclusive cumsum of the block totals before it, taken the
    same way.  It is the association XLA's CPU backend gives ``jnp.cumsum``
    (its reduce-window rewrite), so the reference and the port agree on the
    within-chunk log-decay bit for bit; ``torch.cumsum`` would not (on the
    CPU it accumulates in fp64, on the card in a parallel scan), and a few
    ulps of ``l`` near -60 move ``exp`` by ~1e-5.  The SSD kernel takes the
    same association."""
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        outs = [x[..., 0]]
        for i in range(1, n):
            outs.append(outs[-1] + x[..., i])
        return torch.stack(outs, dim=-1)
    pad = (-n) % SCAN_BLOCK
    xb = torch.nn.functional.pad(x, (0, pad)).reshape(*x.shape[:-1], -1,
                                                      SCAN_BLOCK)
    loc = chunk_cumsum(xb)                         # [..., nb, 16]
    ctot = chunk_cumsum(loc[..., -1])              # [..., nb]
    out = torch.cat([loc[..., :1, :], ctot[..., :-1, None] + loc[..., 1:, :]],
                    dim=-2)
    return out.reshape(*x.shape[:-1], -1)[..., :n]


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over [B, L, C]; returns (y, new_state [B, K-1, C])."""
    K = w.shape[0]
    if state is None:
        xp = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    L_ = x.shape[1]
    y = sum(xp[:, i:i + L_, :] * w[i].to(ACC) for i in range(K)) + b.to(ACC)
    new_state = xp[:, L_:L_ + K - 1, :] if K > 1 else xp[:, :0, :]
    return torch.nn.functional.silu(y).to(x.dtype), new_state


def ssd_chunked(
    x: torch.Tensor,     # [B, L, H, P]
    dt: torch.Tensor,    # [B, L, H]  (post-softplus)
    A: torch.Tensor,     # [H] (negative)
    Bm: torch.Tensor,    # [B, L, G, N]
    Cm: torch.Tensor,    # [B, L, G, N]
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel SSD scan.  Returns (y [B,L,H,P] fp32, final state
    [B,H,P,N] fp32).  ``L`` is padded to a multiple of ``chunk`` with zeros,
    which leave the state unchanged."""
    B_, L_, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    pad = (-L_) % chunk
    if pad:
        F = torch.nn.functional
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (L_ + pad) // chunk
    xc = x.reshape(B_, nc, chunk, H, P).to(ACC)
    dtc = dt.reshape(B_, nc, chunk, H).to(ACC)
    Bc = Bm.reshape(B_, nc, chunk, G, N).to(ACC)
    Cc = Cm.reshape(B_, nc, chunk, G, N).to(ACC)

    dA = dtc * A.to(ACC)                          # [B,nc,Q,H] (<=0)
    l = chunk_cumsum(dA.transpose(2, 3)).transpose(2, 3)  # within-chunk log-decay
    l_last = l[:, :, -1]                          # [B,nc,H]

    # phase 1: per-chunk states
    w = torch.exp(torch.clamp(l_last[:, :, None] - l, -60.0, 0.0)) * dtc
    Bh = torch.repeat_interleave(Bc, rep, dim=3)  # [B,nc,Q,H,N]
    S_chunk = torch.einsum("bcsh,bcshm,bcshp->bchpm", w, Bh, xc)

    # phase 2: the inter-chunk recurrence (a small state carry)
    S = (torch.zeros((B_, H, P, N), dtype=ACC, device=x.device)
         if init_state is None else init_state.to(ACC))
    decay = torch.exp(torch.clamp(l_last, -60.0, 0.0))   # [B,nc,H]
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S)
        S = S * decay[:, c, :, None, None] + S_chunk[:, c]
    S_prev = torch.stack(S_prevs, dim=1)          # [B,nc,H,P,N]

    # phase 3: outputs
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    CB = torch.einsum("bctgm,bcsgm->bcgts", Cc, Bc)
    CBh = torch.repeat_interleave(CB, rep, dim=2)  # [B,nc,H,Q,Q]
    lt = l.transpose(2, 3)                         # [B,nc,H,Q]
    dec = torch.exp(torch.clamp(lt[..., :, None] - lt[..., None, :],
                                -60.0, 0.0))
    M = torch.where(causal, CBh * dec, torch.zeros((), dtype=ACC,
                                                   device=x.device))
    xdt = xc * dtc[..., None]
    y_in = torch.einsum("bchts,bcshp->bcthp", M, xdt)
    Ch = torch.repeat_interleave(Cc, rep, dim=3)   # [B,nc,Q,H,N]
    y_x = torch.einsum("bcthm,bchpm->bcthp", Ch, S_prev)
    y_x = y_x * torch.exp(torch.clamp(l, -60.0, 0.0))[..., None]
    y = (y_in + y_x).reshape(B_, nc * chunk, H, P)[:, :L_]
    return y, S


def ssd_decode(
    x: torch.Tensor,      # [B, 1, H, P]
    dt: torch.Tensor,     # [B, 1, H]
    A: torch.Tensor,      # [H]
    Bm: torch.Tensor,     # [B, 1, G, N]
    Cm: torch.Tensor,     # [B, 1, G, N]
    state: torch.Tensor,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) recurrent update: S ← exp(dt·A)·S + dt·B⊗x;  y = C·S."""
    rep = x.shape[2] // Bm.shape[2]
    xf = x[:, 0].to(ACC)                                         # [B,H,P]
    dtf = dt[:, 0].to(ACC)                                       # [B,H]
    # each group's B and C to its rep heads: repeat_interleave's values, as
    # a view (no index tensor built per step)
    Bh = Bm[:, 0, :, None].expand(-1, -1, rep, -1).flatten(1, 2).to(ACC)  # [B,H,N]
    Ch = Cm[:, 0, :, None].expand(-1, -1, rep, -1).flatten(1, 2).to(ACC)
    decay = torch.exp(torch.clamp(dtf * A.to(ACC), -60.0, 0.0))
    S_new = state.to(ACC) * decay[..., None, None] + torch.einsum(
        "bh,bhm,bhp->bhpm", dtf, Bh, xf)
    y = torch.einsum("bhm,bhpm->bhp", Ch, S_new)
    return y[:, None], S_new


def ssm_inputs(blk: Mamba2Block, x: torch.Tensor, cfg: ModelConfig,
               conv_state: Optional[Mapping[str, torch.Tensor]] = None):
    """The block's front half on [B, L, d]: the projections, the three causal
    convolutions and the SSD inputs.  Returns ``(xs [B,L,H,P], dt [B,L,H]
    fp32, A [H] fp32, Bm, Cm [B,L,G,N], z [B,L,di], new_conv)``."""
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    B_, L_, _ = x.shape
    h = L.rms_norm(x, blk.ln, cfg.norm_eps)

    def proj(w):
        return L.matmul_acc(h, w).to(h.dtype)

    z, xr, Br, Cr, dt = (proj(blk.in_z), proj(blk.in_x), proj(blk.in_B),
                         proj(blk.in_C), proj(blk.in_dt))
    cs = conv_state or {}
    xs, conv_x = causal_conv(xr, blk.conv_x_w, blk.conv_x_b, cs.get("x"))
    Bm, conv_B = causal_conv(Br, blk.conv_B_w, blk.conv_B_b, cs.get("B"))
    Cm, conv_C = causal_conv(Cr, blk.conv_C_w, blk.conv_C_b, cs.get("C"))
    new_conv = {"x": conv_x, "B": conv_B, "C": conv_C}
    dt_ = torch.nn.functional.softplus(dt.to(ACC) + blk.dt_bias)
    A = -torch.exp(blk.A_log)
    return (xs.reshape(B_, L_, H, P), dt_, A, Bm.reshape(B_, L_, G, N),
            Cm.reshape(B_, L_, G, N), z, new_conv)


def block_apply(
    blk: Mamba2Block, x: torch.Tensor, cfg: ModelConfig,
    conv_state: Optional[Mapping[str, torch.Tensor]] = None,
    ssm_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """Full mamba2 block on [B, L, d].  Returns (out, conv_states, ssm_state).

    ``conv_state``: None (prefill from scratch) or a dict with the "x"/"B"/"C"
    tails of the three causal convolutions.
    """
    B_, L_, _ = x.shape
    xs, dt_, A, Bm, Cm, z, new_conv = ssm_inputs(blk, x, cfg, conv_state)
    if L_ == 1 and ssm_state is not None:
        y, S = ssd_decode(xs, dt_, A, Bm, Cm, ssm_state)
    else:
        y, S = ssd_chunked(xs, dt_, A, Bm, Cm, cfg.ssm_chunk,
                           init_state=ssm_state)
    y = y + xs.to(ACC) * blk.D[None, None, :, None]
    y = y.reshape(B_, L_, cfg.d_inner).to(x.dtype)
    y = L.rms_norm(y * torch.nn.functional.silu(z.to(ACC)).to(y.dtype),
                   blk.norm, cfg.norm_eps)
    out = L.matmul_acc(y, blk.out_proj).to(x.dtype)
    return x + out, new_conv, S


def decode_block(blk: Mamba2Block, x: torch.Tensor, cfg: ModelConfig,
                 conv_state: Mapping[str, torch.Tensor],
                 ssm_state: torch.Tensor):
    """O(1) recurrent step on [B, 1, d]."""
    return block_apply(blk, x, cfg, conv_state=conv_state, ssm_state=ssm_state)


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------


def _block_train(blk: Mamba2Block, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return block_apply(blk, x, cfg)[0]


def forward(params: Mamba2, tokens: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V] (fp32)."""
    x = L.embed_tokens(params.embed, tokens)
    for blk in params.blocks:
        x = L.remat(cfg, _block_train, blk, x, cfg)
    x = L.rms_norm(x, params.ln_f, cfg.norm_eps)
    return L.unembed(x, params.embed)


def loss_fn(params: Mamba2, batch: Mapping[str, torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy, as the reference's."""
    logits = forward(params, batch["tokens"], cfg)
    return L.cross_entropy_loss(logits[:, :-1], batch["labels"][:, 1:],
                                batch.get("mask"))


def ref_leaves(model: Mamba2) -> Dict[PT.Path, PT.RefLeaf]:
    """The reference's leaves (``blocks/in_x`` stacked over the layers, ...)
    over the module's parameters."""
    return PT.ref_leaves(model)


def params_to_arrays(cfg: ModelConfig, model: Mamba2) -> Dict[str, Any]:
    """The inverse of :func:`params_from_arrays`."""
    return PT.leaves_to_arrays(ref_leaves(model))


def prefill(params: Mamba2, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int = 0) -> Tuple[torch.Tensor, Cache]:
    """The SSM cache is O(1): each layer's conv tails ``{"x","B","C"}``
    [L, B, K-1, C] and state ``ssm`` [L, B, H, P, N] (fp32), stacked on a
    leading layer axis as in the reference, and ``length``.  ``max_len`` is
    unused.  Returns the last position's logits [B, 1, V] (fp32)."""
    x = L.embed_tokens(params.embed, tokens)
    convs, states = [], []
    for blk in params.blocks:
        x, conv_s, ssm_s = block_apply(blk, x, cfg)
        convs.append(conv_s)
        states.append(ssm_s)
    x = L.rms_norm(x[:, -1:], params.ln_f, cfg.norm_eps)
    cache = {
        "conv": {k: torch.stack([c[k] for c in convs]) for k in ("x", "B", "C")},
        "ssm": torch.stack(states),
        "length": torch.tensor(tokens.shape[1], dtype=torch.int32,
                               device=x.device),
    }
    return L.unembed(x, params.embed), cache


def decode_step(params: Mamba2, token: torch.Tensor, cache: Cache,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
    """One decode step.  token [B, 1] → logits [B, 1, V] (fp32).

    Each layer's new conv tails and state are written into ``cache``'s
    stacked buffers in place (the reference returns a new cache), and the
    returned cache shares them, with ``length`` advanced by one: a scalar,
    or one length per batch row (the continuous-batching scheduler's
    ``[B]``), which the recurrence itself never reads.  A caller that wants
    to reuse a cache clones it first."""
    x = L.embed_tokens(params.embed, token)
    conv, ssm = cache["conv"], cache["ssm"]
    for i, blk in enumerate(params.blocks):
        x, conv_n, ssm_n = decode_block(
            blk, x, cfg, {k: conv[k][i] for k in ("x", "B", "C")}, ssm[i])
        for k in ("x", "B", "C"):
            conv[k][i].copy_(conv_n[k])
        ssm[i].copy_(ssm_n)
    x = L.rms_norm(x, params.ln_f, cfg.norm_eps)
    return L.unembed(x, params.embed), {**cache, "length": cache["length"] + 1}


def cache_seq_axes(cache: Cache):
    """Attention-free family: no growing KV, so every leaf (the conv tails,
    the state, ``length``) stays slot-resident in the continuous-batching
    scheduler: all ``None`` (``models.kvcache.seq_axis_tree``)."""
    return seq_axis_tree(cache)
