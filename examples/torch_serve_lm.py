"""Serve a (reduced) assigned arch on the PyTorch port with batched
requests: prefill + decode loop through the engine, for a dense, an MoE
and an SSM model, each after asking the router how many H100 SXM cards
the full-size model would take at ``decode_32k``.

    PYTHONPATH=src python examples/torch_serve_lm.py              # the card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.configs import get_config, get_shape
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.router import route_accelerator


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    for arch in ("internlm2-1.8b", "deepseek-moe-16b", "mamba2-370m"):
        cfg_full = get_config(arch)
        route = route_accelerator(cfg_full, get_shape("decode_32k"))
        cfg = cfg_full.reduced()
        engine = ServingEngine(cfg, seed=0, device=args.device)
        prompts = rng.integers(0, cfg.vocab_size, size=(4, 12)).astype(np.int32)
        out = engine.generate(prompts, max_new_tokens=6)
        print(f"[{arch}] router: {route.chips} H100 SXM cards ({route.reason})")
        print(f"  on {args.device}: generated tokens:\n{out.tokens}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
