"""The DeepSeekMoE decoder (deepseek-moe-16b) in plain fp32 PyTorch.

As published (arXiv:2401.06066; HF ``deepseek-ai/deepseek-moe-16b-base``'s
``config.json``): pre-norm blocks, each RMS norm, multi-head attention
with rotary embeddings over the whole causal prefix and a residual add,
then RMS norm, a feed-forward half and a residual add; the first
``first_dense_layers`` blocks' feed-forward half is a SwiGLU of ``d_ff``,
every later one a mixture of experts: the router's logits over all
``n_experts`` experts, a softmax over all of them (``scoring_func``
softmax), the ``experts_per_token`` largest probabilities chosen
(``topk_method`` greedy) and used as they are (``norm_topk_prob`` false),
each chosen expert's SwiGLU of ``moe_d_ff`` weighted by its probability,
every assignment kept (no capacity: inference drops no token), plus the
``n_shared_experts`` shared experts, which the weights hold as one SwiGLU
of ``n_shared_experts * moe_d_ff``; then the final norm and the
unembedding.  The whole sequence runs at once, layer by layer, as a
teacher-forced forward pass: no cache, no batching of requests into
slots, no dispatch buffer, no kernels.

Where this departs from the published model: the weights are random,
drawn from the run's seed (``pbcore/weights.py``), not the released
checkpoint; ``rope_scaling`` is left out (the contexts served here are far
inside ``max_position_embeddings``); the router's product is fp32, as
everything here is.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from reference import common as C


def moe_block(x: torch.Tensor, w, layer: int, m: dict,
              quant: Optional[str] = None) -> torch.Tensor:
    """The residual stream ``x [N, d]`` after moe layer ``layer``'s
    feed-forward half: each token's top-k experts by the softmax over all
    experts, unnormalised, every assignment kept, plus the shared
    experts."""
    p = "moe_blocks"
    h = C.rms_norm(x, w.get(f"{p}.ln_mlp", layer), m["norm_eps"])
    probs = torch.softmax(C.linear(h, w.get(f"{p}.moe.router", layer), quant),
                          dim=-1)
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = m["experts_per_token"]
    top, ids = top[:, :k], ids[:, :k]
    out = torch.zeros_like(x)
    w_gate, w_up = w.raw(f"{p}.moe.w_gate", layer), w.raw(f"{p}.moe.w_up", layer)
    w_down = w.raw(f"{p}.moe.w_down", layer)
    for e in range(m["n_experts"]):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if not len(tok):
            continue
        y = C.swiglu(h[tok], w_gate[e].float(), w_up[e].float(),
                     w_down[e].float(), quant)
        out.index_add_(0, tok, y * top[tok, slot, None])
    if m["n_shared_experts"]:
        out = out + C.swiglu(h, w.get(f"{p}.moe.shared.wi_gate", layer),
                             w.get(f"{p}.moe.shared.wi_up", layer),
                             w.get(f"{p}.moe.shared.wo", layer), quant)
    return x + out


def logits(w, m: dict, seqs: List[torch.Tensor], rows: torch.Tensor,
           prompt_lens: List[int], quant: Optional[str] = None) -> torch.Tensor:
    """fp32 logits at ``rows`` of the sequences laid end to end.
    ``prompt_lens`` is unused: with no capacity, a token's experts and
    their outputs depend on that token alone."""
    fd = m["first_dense_layers"]
    with torch.no_grad(), C.exact_fp32():
        x, pos, bounds = C.embed(w, seqs)
        for layer in range(m["n_layers"]):
            if layer < fd:
                x = C.attention_block(x, w, "dense_blocks", layer, m, pos,
                                      bounds, quant)
                x = C.dense_mlp_block(x, w, "dense_blocks", layer, m, quant)
            else:
                x = C.attention_block(x, w, "moe_blocks", layer - fd, m, pos,
                                      bounds, quant)
                x = moe_block(x, w, layer - fd, m, quant)
        return C.head(x, w, m, rows, quant)
