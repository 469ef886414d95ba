"""The pieces the plain references share: fp32 products (optionally in a
simulated fp8, the control), RMS norm, rotary embeddings, causal GQA
attention, SwiGLU.  Frozen copies of the equations the configurations
state; nothing here imports the program."""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Optional

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """fp32 products as fp32 (no TF32) inside the block."""
    cuda, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(prec)


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to 448), back in fp32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    s = amax / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def linear(x: torch.Tensor, w: torch.Tensor, quant: Optional[str] = None
           ) -> torch.Tensor:
    """``x [N, K] @ w [K, M]`` in fp32; with ``quant="fp8"`` both operands
    are rounded to fp8 first (x per row, w per output column), as an fp8
    product with an fp32 accumulator computes."""
    if quant is None:
        return x @ w
    if quant != "fp8":
        raise ValueError(f"unknown quantization {quant!r}")
    return fp8(x, -1) @ fp8(w, 0)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x [N, heads, D]`` at positions ``pos [N]``,
    the two halves of each head rotated against each other."""
    D = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                          device=x.device) / D))
    ang = pos.to(torch.float32)[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """One sequence: ``q [T, H, D]``, ``k``/``v [T, KV, D]`` (query head
    ``h`` reads KV head ``h // (H / KV)``) -> ``[T, H * D]``."""
    T, H, D = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(D)
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hts,shd->thd", p, v).reshape(T, H * D)


def swiglu(h: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, quant: Optional[str] = None) -> torch.Tensor:
    g = linear(h, w_gate, quant)
    u = linear(h, w_up, quant)
    return linear(torch.nn.functional.silu(g) * u, w_down, quant)


def attention_block(x: torch.Tensor, w, prefix: str, layer: int, m: dict,
                    pos: torch.Tensor, bounds: List[int],
                    quant: Optional[str] = None) -> torch.Tensor:
    """The residual stream ``x [N, d]`` of the sequences laid end to end
    (``bounds``: their starts and the end) after one attention half."""
    d, H, KV, Dh = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_head"]
    h = rms_norm(x, w.get(f"{prefix}.ln_attn", layer), m["norm_eps"])
    q = linear(h, w.get(f"{prefix}.attn.wq", layer).reshape(d, H * Dh), quant)
    k = linear(h, w.get(f"{prefix}.attn.wk", layer).reshape(d, KV * Dh), quant)
    v = linear(h, w.get(f"{prefix}.attn.wv", layer).reshape(d, KV * Dh), quant)
    q = rope(q.reshape(-1, H, Dh), pos, m["rope_theta"])
    k = rope(k.reshape(-1, KV, Dh), pos, m["rope_theta"])
    v = v.reshape(-1, KV, Dh)
    o = torch.cat([causal_attention(q[a:b], k[a:b], v[a:b])
                   for a, b in zip(bounds[:-1], bounds[1:])])
    wo = w.get(f"{prefix}.attn.wo", layer).reshape(H * Dh, d)
    return x + linear(o, wo, quant)


def dense_mlp_block(x: torch.Tensor, w, prefix: str, layer: int, m: dict,
                    quant: Optional[str] = None) -> torch.Tensor:
    h = rms_norm(x, w.get(f"{prefix}.ln_mlp", layer), m["norm_eps"])
    return x + swiglu(h, w.get(f"{prefix}.mlp.wi_gate", layer),
                      w.get(f"{prefix}.mlp.wi_up", layer),
                      w.get(f"{prefix}.mlp.wo", layer), quant)


def embed(w, seqs: List[torch.Tensor]):
    """(x [N, d] fp32, positions [N], bounds) of the sequences laid end
    to end."""
    table = w.raw("embed")
    x = torch.cat([table[s].float() for s in seqs])
    pos = torch.cat([torch.arange(len(s), device=x.device) for s in seqs])
    bounds = [0]
    for s in seqs:
        bounds.append(bounds[-1] + len(s))
    return x, pos, bounds


def head(x: torch.Tensor, w, m: dict, rows: torch.Tensor,
         quant: Optional[str] = None) -> torch.Tensor:
    """fp32 logits ``[len(rows), padded_vocab]`` of the given rows."""
    h = rms_norm(x[rows], w.get("ln_f"), m["norm_eps"])
    table = w.get("embed" if m.get("tie_embeddings", False) else "unembed")
    return linear(h, table.t(), quant)
