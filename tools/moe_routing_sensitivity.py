"""How far one decode step of a routed model moves when only its attention
numerics change, on one CUDA card.

    python tools/moe_routing_sensitivity.py [--bank-fan-in d|E] [--steps N]

Draws deepseek-moe-16b at full width with the port's ``moe.init`` (bf16,
seed 0), or with the expert banks ``w_gate``/``w_up`` rescaled to the
JAX reference's initializer (``--bank-fan-in E``: fan-in E = 64, as
``dense_init`` takes the leading axis of ``[E, d, f]``), prefills 8
prompts of 512 and greedily decodes ``--steps`` tokens through the
split-KV kernel.  At every step it also runs the same step from a copy of
the kernel run's cache through the kernel's plain version and through
``dense-ref``, and prints how many of the 8 rows keep the kernel run's
greedy token and how many (token, layer) pairs keep its top-6 experts,
beside the mean norms of each moe layer's input and output at prefill.
Run it from a checkout; it takes the plain backend from ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import PlainSplitKOnCard  # noqa: E402  (puts src on the path)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bank-fan-in", choices=("d", "E"), default="d")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    cfg = get_config("deepseek-moe-16b")
    engine = ServingEngine(cfg, seed=0)
    if args.bank_fan_in == "E":
        scale = math.sqrt(cfg.d_model / cfg.n_experts)
        for block in engine.params.moe_blocks:
            for w in (block.moe.w_gate, block.moe.w_up):
                w.mul_(scale)
    others = {"plain": ServingEngine(cfg, params=engine.params,
                                     attn_backend=PlainSplitKOnCard()),
              "dense-ref": ServingEngine(cfg, params=engine.params,
                                         attn_backend="dense-ref")}
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (8, 512))
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}

    norms, routes = [], []
    moe_ffn, route_topk = moe.moe_ffn, moe.route_topk

    def ffn(p, x, cfg_, dp_groups=1, metrics=True):
        out, m = moe_ffn(p, x, cfg_, dp_groups, metrics)
        norms.append((x.float().norm(dim=-1).mean().item(),
                      out.float().norm(dim=-1).mean().item()))
        return out, m

    def recorded(logits, k, normalize=True):
        w, idx = route_topk(logits, k, normalize)
        routes.append(idx.sort(dim=-1).values)
        return w, idx

    moe.moe_ffn = ffn
    logits, cache = engine.model.prefill(engine.params, batch,
                                         512 + args.steps)
    moe.moe_ffn = moe_ffn
    x_in = np.mean([a for a, _ in norms])
    out = np.mean([b for _, b in norms])
    print(f"{cfg.name}, expert banks' fan-in {args.bank_fan_in}: moe layers "
          f"at prefill, mean |input| {x_in:.2f}, mean |output| {out:.2f}")
    moe.route_topk = recorded
    token = logits[:, -1:].argmax(-1)
    totals = {n: [0, 0] for n in others}
    for t in range(args.steps):
        copies = {n: {"stacks": [{k: v.clone() for k, v in s.items()}
                                 for s in cache["stacks"]],
                      "length": cache["length"].clone()} for n in others}
        routes.clear()
        logits, cache = engine.model.decode_step(engine.params, token, cache)
        mine = list(routes)
        line = [f"step {t}"]
        for n, e in others.items():
            routes.clear()
            lo, _ = e.model.decode_step(e.params, token, copies[n])
            same = sum(int((a == b).all(-1).sum()) for a, b in zip(mine, routes))
            agree = int((lo[:, -1].argmax(-1) == logits[:, -1].argmax(-1)).sum())
            totals[n][0] += agree
            totals[n][1] += same
            line.append(f"{n}: greedy {agree}/8, experts {same}/{8 * len(mine)}")
        print(", ".join(line))
        token = logits[:, -1:].argmax(-1)
    moe.route_topk = route_topk
    n_pairs = 8 * (cfg.n_layers - cfg.first_dense_layers) * args.steps
    print("over the steps: " + ", ".join(
        f"{n}: greedy {a}/{8 * args.steps}, experts {s}/{n_pairs}"
        for n, (a, s) in totals.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
