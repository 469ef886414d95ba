"""Serving launcher: reduced configs on the CPU, full configs on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch internlm2-1.8b --batch 4 --prompt-len 16 --max-new 8
    PYTHONPATH=src python -m repro_torch.launch.serve --full-size
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --full-size
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch seamless-m4t-medium

vlm and encdec configs get random frontend embeddings from ``--seed``
(``extra_embeds`` and ``frames``), as the reference's launcher makes them.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models.registry import FRONTEND_INPUTS
from repro_torch.serving.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = cfg.reduced()
    engine = ServingEngine(cfg, seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(args.batch, args.prompt_len)).astype(np.int32)
    extra = {}
    if cfg.family in FRONTEND_INPUTS:
        extra[FRONTEND_INPUTS[cfg.family]] = rng.standard_normal(
            (args.batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    result = engine.generate(prompts, max_new_tokens=args.max_new, extra=extra)
    print(f"[{args.arch}] {engine.attn_backend.name} on {args.device}: "
          f"generated {result.tokens.shape} tokens:")
    print(result.tokens)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
