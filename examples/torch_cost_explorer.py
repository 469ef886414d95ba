"""The paper's cost model (§IV) from the PyTorch/CUDA port's copy of it:
sweep model size × parallelism and print which channel the recommender
picks — the design recommendations (Serial → Queue → Object) as workloads
grow.  The model is arithmetic on the host; ``--device`` is taken for
symmetry with the other examples and only printed.

    PYTHONPATH=src python examples/torch_cost_explorer.py
"""

import argparse

from repro_torch.core.cost_model import recommend_configuration


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    print(f"(the cost model runs on the host; --device {args.device})")
    print(f"{'model':>10} {'exchange/layer':>15} {'choice':>12} {'P':>4}")
    for model_gb, exch_mb in [
        (0.03, 0.1), (0.5, 0.5), (2, 1), (8, 2), (8, 60), (30, 200),
    ]:
        ch, p, _ = recommend_configuration(
            model_bytes=int(model_gb * 1e9),
            per_layer_exchange_bytes=exch_mb * 1e6,
            n_layers=120,
            memory_mb_per_worker=4000,
        )
        print(f"{model_gb:>8}GB {exch_mb:>13}MB {ch:>12} {p:>4}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
