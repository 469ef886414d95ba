"""The dense decoder (internlm2-1.8b) in plain fp32 PyTorch.

Pre-norm blocks: RMS norm, GQA attention with rotary embeddings over the
whole causal prefix, a residual add; RMS norm, SwiGLU, a residual add;
then the final norm and the unembedding.  The whole sequence (prompt and
served tokens) runs at once, layer by layer, as a teacher-forced forward
pass: no cache, no batching of requests into slots, no kernels.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from reference import common as C


def logits(w, m: dict, seqs: List[torch.Tensor], rows: torch.Tensor,
           prompt_lens: List[int], quant: Optional[str] = None) -> torch.Tensor:
    """fp32 logits at ``rows`` of the sequences laid end to end.
    ``prompt_lens`` is unused: a dense block treats every position alike."""
    with torch.no_grad(), C.exact_fp32():
        x, pos, bounds = C.embed(w, seqs)
        for layer in range(m["n_layers"]):
            x = C.attention_block(x, w, "blocks", layer, m, pos, bounds, quant)
            x = C.dense_mlp_block(x, w, "blocks", layer, m, quant)
        return C.head(x, w, m, rows, quant)
