"""Training launcher: reduced configs on the CPU, any config on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch llama3.2-1b --steps 50 --batch 8 --seq 64 --ckpt-dir CKPT
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --full-size --steps 4 --batch 8 --seq 512

The reference's flags, plus ``--device`` (``cuda`` by default, which
raises where no card is present).
"""

from __future__ import annotations

import argparse
import json

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.training.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full-size", action="store_true",
                    help="the full public config (on the card)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = cfg.reduced()
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, base_lr=args.lr,
        microbatches=args.microbatches, compress_grads=args.compress_grads,
    )
    trainer = Trainer(cfg, shape, tcfg, seed=args.seed, device=args.device)
    history = trainer.fit()
    first, last = history["loss"][0], history["loss"][-1]
    print(f"[{args.arch}] on {args.device}: steps={len(history['loss'])} "
          f"loss {first:.4f} → {last:.4f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(history, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
