"""Train a (reduced) assigned-architecture LM end to end on the PyTorch
port, with checkpointing, a simulated crash, and a resume — a few hundred
steps by default.

    PYTHONPATH=src python examples/torch_train_lm.py --arch llama3.2-1b \
        --steps 200                      # on the card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20
"""

import argparse
import shutil
import tempfile

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.training.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    shape = ShapeConfig("ex", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        crash_at = max(2, args.steps // 2)
        t1 = Trainer(cfg, shape, TrainerConfig(
            total_steps=args.steps, ckpt_every=max(1, crash_at // 2),
            ckpt_dir=ckpt_dir, stop_after=crash_at), device=args.device)
        h1 = t1.fit()
        print(f"ran {len(h1['loss'])} steps on {args.device}, then "
              f"'crashed'; loss {h1['loss'][0]:.4f} → {h1['loss'][-1]:.4f}")

        t2 = Trainer(cfg, shape, TrainerConfig(
            total_steps=args.steps, ckpt_every=50, ckpt_dir=ckpt_dir),
            device=args.device)
        h2 = t2.fit(resume=True)
        print(f"resumed at step {h2['step'][0]}, finished {args.steps}: "
              f"final loss {h2['loss'][-1]:.4f}")
        if not h2["loss"][-1] < h1["loss"][0]:
            raise SystemExit("training did not learn")
        print("loss decreased (the bit-for-bit restart is tested in "
              "tests/test_torch_training.py)")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
