"""Deterministic, step-keyed synthetic data pipeline (the reference's,
copied).

Every batch is a pure function of ``(seed, step)`` via a counter-based RNG
(Philox), so a restarted job regenerates the exact byte-identical batch
stream with zero coordination: the fault-tolerance contract the trainer's
restart test relies on.  The batches are numpy, byte for byte the
reference's; ``device_batch`` hands them over as tensors, on the card
unless the caller asks for the CPU, each key whole or placed on a mesh
(``distributed/sharding.py``).  A host can materialize only its slice
``batch[lo:hi]`` without generating the rest.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import place

__all__ = ["PipelineSpec"]


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0

    def _rng(self, step: int, stream: int = 0) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=(self.seed << 16) ^ (stream << 8) ^ 0x5eed,
                             counter=step)
        )

    def batch(self, step: int, lo: int = 0, hi: Optional[int] = None
              ) -> Dict[str, np.ndarray]:
        """Global batch slice [lo:hi) for ``step`` (hi=None → full batch)."""
        B, S = self.shape.global_batch, self.shape.seq_len
        hi = B if hi is None else hi
        vocab = max(2, self.cfg.vocab_size)
        rng = self._rng(step)
        # generate the full token block then slice — Philox makes this cheap
        # and guarantees identical content regardless of host topology
        tokens = rng.integers(0, vocab, size=(B, S), dtype=np.int64)[lo:hi]
        tokens = tokens.astype(np.int32)
        out: Dict[str, np.ndarray] = {"tokens": tokens, "labels": tokens.copy()}
        if self.cfg.family == "vlm":
            frng = self._rng(step, stream=1)
            out["extra_embeds"] = frng.standard_normal(
                (B, self.cfg.frontend_tokens, self.cfg.d_model)
            ).astype(np.float32)[lo:hi]
        if self.cfg.family == "encdec":
            frng = self._rng(step, stream=2)
            out["frames"] = frng.standard_normal(
                (B, self.cfg.frontend_tokens, self.cfg.d_model)
            ).astype(np.float32)[lo:hi]
        return out

    def device_batch(self, step: int, device="cuda",
                     shardings: Optional[Mapping[str, Any]] = None
                     ) -> Dict[str, Any]:
        """:meth:`batch` as tensors: a key of ``shardings`` (a
        ``distributed.sharding.Placement`` a key, as ``placements`` of
        ``batch_pspecs`` gives) comes back a ``Sharded`` on its placement,
        the reference's ``device_put(v, shardings[k])``; every other key
        whole on ``device``.  ``device`` is the card unless the caller
        passes ``"cpu"``; it raises where no card is present."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device_batch puts batches on a CUDA device by default and "
                "none is available; pass device='cpu' for the CPU")
        shardings = shardings or {}
        out: Dict[str, Any] = {}
        for k, v in self.batch(step).items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = place(t, shardings[k]) if k in shardings else t.to(device)
        return out
