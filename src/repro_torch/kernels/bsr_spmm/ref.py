"""Plain PyTorch versions of the BSR SpMM kernels.

They are the CPU path of ``ops.bsr_spmm`` / ``ops.bsr_spmm_fleet`` and the
oracle the CUDA kernels are held against on the card.  The math is the
reference's vectorized host lowering (``_fleet_host_lowering`` in the JAX
package): one gather of every referenced x block row, then K batched
``[bm, bn] @ [bn, B]`` products accumulated in ascending k, then the clip.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["bsr_to_dense", "bsr_spmm_fused_ref", "bsr_spmm_fleet_ref"]


def bsr_to_dense(blocks: np.ndarray, cols: np.ndarray,
                 n_cols_blocks: int) -> np.ndarray:
    """Padded BSR (``blocks [NBR, K, bm, bn]``, ``cols [NBR, K]``) → the
    dense weight matrix ``[NBR·bm, n_cols_blocks·bn]`` (numpy, test-side);
    zero padding blocks add nothing wherever they point."""
    nbr, k, bm, bn = blocks.shape
    out = np.zeros((nbr * bm, n_cols_blocks * bn), dtype=blocks.dtype)
    for br in range(nbr):
        for i in range(k):
            c = int(cols[br, i])
            out[br * bm:(br + 1) * bm, c * bn:(c + 1) * bn] += blocks[br, i]
    return out


def bsr_spmm_fleet_ref(blocks: torch.Tensor, cols: torch.Tensor,
                       counts, x: torch.Tensor, bias: float,
                       clip: float = 32.0) -> torch.Tensor:
    """``blocks [P,NBR,K,bm,bn]``, ``cols [P,NBR,K]``, ``x [P,N,B]`` →
    ``y [P, NBR*bm, B] = clip(Σ_k blocks[:, :, k] @ x_k + bias, 0, clip)``.

    ``counts`` (the real blocks per row) is not read: the padding blocks
    beyond it are all zero, so running every K slot gives the same sums.
    On CUDA the products run in full fp32: TF32 is switched off for the call
    (``torch.backends.cuda.matmul.allow_tf32 = False``), because the layer op
    is held to 1e-5.
    """
    del counts
    p, nbr, k, bm, bn = blocks.shape
    b = x.shape[2]
    offs = torch.arange(bn, device=x.device)
    idx = cols.long()[..., None] * bn + offs                  # [P, NBR, K, bn]
    pidx = torch.arange(p, device=x.device)[:, None]
    xg = x[pidx, idx.reshape(p, -1)].reshape(p * nbr, k, bn, b)
    w = blocks.reshape(p * nbr, k, bm, bn)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        acc = torch.zeros((p * nbr, bm, b), dtype=torch.float32,
                          device=x.device)
        for i in range(k):  # ascending k: the kernels' accumulation order
            acc = acc + torch.bmm(w[:, i], xg[:, i])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return torch.clamp(acc.reshape(p, nbr * bm, b) + bias, 0.0, clip)


def bsr_spmm_fused_ref(blocks: torch.Tensor, cols: torch.Tensor,
                       x: torch.Tensor, bias: float,
                       clip: float = 32.0) -> torch.Tensor:
    """One worker-layer: ``blocks [NBR,K,bm,bn]``, ``cols [NBR,K]``,
    ``x [N,B]`` → ``y [NBR*bm, B]``."""
    return bsr_spmm_fleet_ref(blocks[None], cols[None], None, x[None],
                              bias, clip)[0]
