"""Shared model layers in PyTorch.

Conventions:
* parameters live in ``nn.Module``s in the reference's layouts
  (``wq [d, H, Dh]``, ``wo [H, Dh, d]``, ``embed [V, d]``, ``wi_gate
  [d, f]``), so the products here mirror its einsums one for one; every
  initializer takes an explicit ``torch.Generator``;
* activations flow as ``[batch, seq, d_model]`` in the parameters' dtype
  (bf16 by default) with fp32 accumulation inside every product
  (:func:`matmul_acc`, the counterpart of ``preferred_element_type``) and
  fp32 math in norms, RoPE and activations;
* training differentiates through the same functions with autograd: a
  product's cotangents are computed as the reference's ``dot_general``
  transposes them (in fp32, rounded to each operand's dtype), and
  :func:`remat` recomputes a block's activations in the backward pass where
  the config asks for it, as the reference's ``jax.checkpoint`` does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

PARAM_DTYPE = torch.bfloat16
ACC_DTYPE = torch.float32

__all__ = ["PARAM_DTYPE", "ACC_DTYPE", "set_shard_ctx", "shard_ctx",
           "set_tp_psum_dtype", "constrain", "matmul_acc", "bmm_acc", "dense_init",
           "cross_entropy_loss", "remat",
           "embed_init", "empty_param", "rms_norm", "rope_frequencies", "apply_rope",
           "Attention", "Mlp", "init_attention", "init_mlp", "mlp",
           "qkv_project", "out_project", "embed_tokens", "unembed"]


# ---------------------------------------------------------------------------
# sharding context (set by a launcher; nothing is set on a plain run)
# ---------------------------------------------------------------------------

_SHARD_CTX: Dict[str, Any] = {"mesh": None, "dp": (), "model": None}


def set_shard_ctx(mesh=None, dp=(), model=None) -> None:
    """Install a :class:`repro_torch.launch.mesh.Mesh` and the names of
    its data axes (``dp``) and its model axis (``model``).  The moe
    family's expert parallelism reads it (``moe.moe_ffn_dispatch``)."""
    _SHARD_CTX.update(mesh=mesh, dp=tuple(dp), model=model)


def shard_ctx() -> Dict[str, Any]:
    return dict(_SHARD_CTX)


# Dtype of tensor-parallel partial sums, as the reference keeps it; the
# port has no tensor-parallel path that reads it yet.
TP_PSUM_DTYPE = ACC_DTYPE


def set_tp_psum_dtype(dtype) -> None:
    global TP_PSUM_DTYPE
    TP_PSUM_DTYPE = dtype


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """The reference's sharding hint: symbolic axes (``"dp"``,
    ``"model"``, ``None``) or one ``distributed.sharding.Placement``.  A
    hint places a value and never changes it, and the port's model code
    runs on whole tensors, so ``x`` comes back unchanged (the dry run reads
    placements to cost a step; ``distributed.sharding.place`` moves a
    tensor onto one)."""
    return x


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


def matmul_acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` → fp32 ``[..., N]``, accumulated in fp32.

    On a CUDA card a bf16 product goes to cuBLAS with an fp32 output
    (``torch.mm(..., out_dtype=torch.float32)``), so the weights are read
    once in bf16 and the result is never rounded to bf16.  On the CPU the
    operands are widened to fp32 first: a product of two bf16 values is
    exact in fp32, so both give the reference's
    ``preferred_element_type=float32`` product up to summation order.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype == ACC_DTYPE and w.dtype == ACC_DTYPE:
        y = x2 @ w
    elif x2.dtype != w.dtype:
        # bf16 activations against fp32 weights (the encoder of an fp32
        # encdec model, whose frames the reference casts to bf16): widened,
        # which is exact, as the reference's mixed einsum promotes them
        y = x2.to(ACC_DTYPE) @ w.to(ACC_DTYPE)
    elif x2.is_cuda:
        y = _product_acc(x2, w)
    else:
        y = x2.to(ACC_DTYPE) @ w.to(ACC_DTYPE)
    return y.reshape(*lead, w.shape[-1])


def bmm_acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched ``x [E, M, K] @ w [E, K, N]`` → fp32 ``[E, M, N]``, as
    :func:`matmul_acc` does it: on a CUDA card a bf16 product goes to
    cuBLAS with an fp32 output (``torch.bmm(..., out_dtype=float32)``), on
    the CPU the operands are widened to fp32 first."""
    if x.dtype == ACC_DTYPE and w.dtype == ACC_DTYPE:
        return torch.bmm(x, w)
    if x.is_cuda:
        return _product_acc(x, w)
    return torch.bmm(x.to(ACC_DTYPE), w.to(ACC_DTYPE))


def _product_acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """cuBLAS's product with an fp32 output; through :class:`_ProductAcc`
    where autograd records it, directly where it does not (serving)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _ProductAcc.apply(x, w)
    if x.dim() == 2:
        return torch.mm(x, w, out_dtype=ACC_DTYPE)
    return torch.bmm(x, w, out_dtype=ACC_DTYPE)


class _ProductAcc(torch.autograd.Function):
    """A low-precision product with an fp32 output on the card (``mm`` or
    ``bmm`` with ``out_dtype=float32``), differentiated as the reference's
    ``dot_general`` with ``preferred_element_type=float32`` is: each
    cotangent product takes the fp32 cotangent and the other operand
    widened to fp32 (exact), accumulates in fp32 and is rounded to its
    operand's dtype, so a bf16 parameter's gradient is bf16.  (The
    derivative of ``mm.dtype`` is left out of the question this way.)"""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _product_acc(x, w)  # autograd is off inside forward

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (g @ w.to(ACC_DTYPE).transpose(-1, -2)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = (x.to(ACC_DTYPE).transpose(-1, -2) @ g).to(w.dtype)
        return gx, gw


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, in_axis_size: Optional[int] = None,
               dtype=PARAM_DTYPE) -> torch.Tensor:
    """Normal(0, 1/fan_in) in fp32, cast to ``dtype``, on the generator's
    device."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    scale = 1.0 / np.sqrt(max(1, fan_in))
    x = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype=PARAM_DTYPE) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (x * 0.02).to(dtype)


def empty_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(ACC_DTYPE)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.to(ACC_DTYPE)).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=ACC_DTYPE, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(
    x: torch.Tensor,            # [B, S, H, D]
    positions: torch.Tensor,    # [B, S] or [S]
    theta: float,
) -> torch.Tensor:
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)       # [D/2]
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(ACC_DTYPE) * freqs       # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(ACC_DTYPE).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# feed-forward (SwiGLU)
# ---------------------------------------------------------------------------


class Mlp(nn.Module):
    """``d_out`` defaults to ``d_model``; the hybrid family's shared block
    reads ``concat(hidden, embedding)`` (``d_model`` 2d) and writes d."""

    def __init__(self, d_model: int, d_ff: int, dtype=PARAM_DTYPE, device="cpu",
                 d_out: Optional[int] = None):
        super().__init__()
        self.wi_gate = empty_param((d_model, d_ff), dtype, device)
        self.wi_up = empty_param((d_model, d_ff), dtype, device)
        self.wo = empty_param((d_ff, d_out or d_model), dtype, device)


def init_mlp(module: Mlp, generator: torch.Generator) -> Mlp:
    d_model, d_ff = module.wi_gate.shape
    dt = module.wi_gate.dtype
    module.wi_gate.copy_(dense_init(generator, (d_model, d_ff), dtype=dt))
    module.wi_up.copy_(dense_init(generator, (d_model, d_ff), dtype=dt))
    module.wo.copy_(dense_init(generator, tuple(module.wo.shape),
                               in_axis_size=d_ff, dtype=dt))
    return module


def mlp(params: Mlp, x: torch.Tensor) -> torch.Tensor:
    gate = matmul_acc(x, params.wi_gate)
    up = matmul_acc(x, params.wi_up)
    h = (torch.nn.functional.silu(gate) * up).to(x.dtype)
    return matmul_acc(h, params.wo).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA) — projections here; score computation in attention.py
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """``q_in_dim`` (default ``d_model``) is the width the projections
    read: the hybrid family's shared block reads ``concat(hidden,
    embedding)``, 2 ``d_model``; ``wo`` writes ``d_model``."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 d_head: int, qkv_bias: bool = False, dtype=PARAM_DTYPE,
                 device="cpu", q_in_dim: Optional[int] = None):
        super().__init__()
        q_in = q_in_dim or d_model
        self.wq = empty_param((q_in, n_heads, d_head), dtype, device)
        self.wk = empty_param((q_in, n_kv_heads, d_head), dtype, device)
        self.wv = empty_param((q_in, n_kv_heads, d_head), dtype, device)
        self.wo = empty_param((n_heads, d_head, d_model), dtype, device)
        if qkv_bias:
            self.bq = empty_param((n_heads, d_head), dtype, device)
            self.bk = empty_param((n_kv_heads, d_head), dtype, device)
            self.bv = empty_param((n_kv_heads, d_head), dtype, device)
        else:
            self.bq = self.bk = self.bv = None


def init_attention(module: Attention, generator: torch.Generator) -> Attention:
    q_in, n_heads, d_head = module.wq.shape
    n_kv = module.wk.shape[1]
    dt = module.wq.dtype
    module.wq.copy_(dense_init(generator, (q_in, n_heads, d_head), q_in, dt))
    module.wk.copy_(dense_init(generator, (q_in, n_kv, d_head), q_in, dt))
    module.wv.copy_(dense_init(generator, (q_in, n_kv, d_head), q_in, dt))
    module.wo.copy_(dense_init(generator, (n_heads, d_head, module.wo.shape[-1]),
                               n_heads * d_head, dt))
    for b in (module.bq, module.bk, module.bv):
        if b is not None:
            b.zero_()
    return module


def qkv_project(params: Attention, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    out = []
    for w, b in ((params.wq, params.bq), (params.wk, params.bk),
                 (params.wv, params.bv)):
        d, h, k = w.shape
        y = matmul_acc(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)
        if b is not None:  # the bias joins in fp32, before the cast
            y = y + b.to(ACC_DTYPE)
        out.append(y.to(x.dtype))
    return out[0], out[1], out[2]


def out_project(params: Attention, attn_out: torch.Tensor, dtype) -> torch.Tensor:
    h, k, d = params.wo.shape
    o = attn_out.reshape(*attn_out.shape[:-2], h * k)
    return matmul_acc(o, params.wo.reshape(h * k, d)).to(dtype)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.embedding(tokens, table)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 from an fp32-accumulated product — [B, S, V]."""
    return matmul_acc(x, table.t())


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def cross_entropy_loss(logits: torch.Tensor,        # [B, S, V] fp32
                       labels: torch.Tensor,        # [B, S] int
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token negative log-likelihood (over ``mask``'s ones where
    given), as the reference's: ``logsumexp(logits) - logits[label]``."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def remat(cfg, fn: Callable, *args):
    """``fn(*args)``; with ``cfg.remat``, and autograd recording a tensor or
    a module's parameter among the arguments, its activations are
    recomputed in the backward pass instead of kept
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``
    wraps its block scan's body.  Serving, where nothing requires a
    gradient, calls ``fn`` as it is."""
    if cfg.remat and torch.is_grad_enabled() and any(map(_records, args)):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def _records(arg) -> bool:
    if isinstance(arg, torch.Tensor):
        return arg.requires_grad
    if isinstance(arg, nn.Module):
        return any(p.requires_grad for p in arg.parameters())
    return False
