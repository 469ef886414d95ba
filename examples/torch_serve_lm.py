"""Serve a (reduced) assigned arch on the PyTorch port with batched
requests: prefill + decode loop through the engine, for a dense, an MoE
and an SSM model.  (The reference's example also asks its TPU router how
many chips a full-size model would take; that router belongs to the
port's distributed tooling, which has not landed.)

    PYTHONPATH=src python examples/torch_serve_lm.py              # the card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.serving.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    for arch in ("internlm2-1.8b", "deepseek-moe-16b", "mamba2-370m"):
        cfg = get_config(arch).reduced()
        engine = ServingEngine(cfg, seed=0, device=args.device)
        prompts = rng.integers(0, cfg.vocab_size, size=(4, 12)).astype(np.int32)
        out = engine.generate(prompts, max_new_tokens=6)
        print(f"[{arch}] on {args.device}: generated tokens:\n{out.tokens}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
