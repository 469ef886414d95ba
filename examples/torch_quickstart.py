"""Quickstart on the PyTorch/CUDA port: the paper's system in 40 lines.

Builds a GraphChallenge-style sparse DNN, partitions it with HGP-DNN across
8 serverless workers, runs fully-serverless distributed inference over both
IPC channels through the hand-written BSR kernels (``torch-bsr``),
validates against the dense oracle, and prints the bill.

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.core.backends import TorchBsrBackend
from repro_torch.data.graphchallenge import dense_inference, make_inputs, make_sparse_dnn
from repro_torch.faas.simulator import run_fsi

NEURONS, LAYERS, BATCH, WORKERS = 512, 24, 64, 8


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    backend = TorchBsrBackend(device=args.device)
    net = make_sparse_dnn(NEURONS, n_layers=LAYERS, seed=0)
    x0 = make_inputs(NEURONS, BATCH, seed=1)
    oracle = dense_inference(net, x0)
    print(f"sparse DNN: N={NEURONS} L={LAYERS} nnz={net.total_nnz:,} "
          f"batch={BATCH}, {backend.name} on {args.device}\n")

    for channel in ("serial", "queue", "object"):
        P = 1 if channel == "serial" else WORKERS
        r = run_fsi(net, x0, P=P, channel=channel, memory_mb=4000,
                    compute_backend=backend)
        ok = np.allclose(r.output, oracle, rtol=1e-4, atol=1e-4)
        print(f"FSD-Inf-{channel.capitalize():<7} P={P}: "
              f"correct={ok}  latency={r.makespan:.2f}s  "
              f"per-sample={r.per_sample_ms(BATCH):.2f}ms  "
              f"cost=${r.cost.total:.6f} "
              f"(comms ${r.cost.communication:.6f})")
        if channel != "serial":
            print(f"    exchange: {r.raw_exchange_bytes/1e6:.2f}MB raw → "
                  f"{r.wire_exchange_bytes/1e6:.2f}MB on the wire (zlib), "
                  f"partition imbalance {r.metrics['imbalance']:.3f}")
        if not ok:
            raise SystemExit(f"{channel}: output differs from the oracle")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
