"""Plain PyTorch version of the chunked SSD scan kernel.

It is the CPU path of ``ops.ssd`` and the oracle the CUDA kernel is held
against on the card.  As in the JAX package, it reuses the model-side
chunked SSD (``models.mamba2.ssd_chunked``, which works in the
``[B, L, H, P]`` layout) with the transposes around it.
"""

from __future__ import annotations

import torch

from repro_torch.models.mamba2 import ssd_chunked

__all__ = ["ssd_scan_ref"]


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128):
    """x [B,H,L,P], dt [B,H,L], A [H], Bm/Cm [B,G,L,N] → (y [B,H,L,P] fp32,
    S [B,H,P,N] fp32)."""
    y, s = ssd_chunked(x.transpose(1, 2), dt.transpose(1, 2), A,
                       Bm.transpose(1, 2), Cm.transpose(1, 2), chunk=chunk)
    return y.transpose(1, 2), s
