"""The paper's core scenario on the PyTorch/CUDA port: batch inference over
a deep sparse DNN on a serverless fleet, with channel + worker-count
selection by the cost model, partitioning ablation, straggler mitigation,
the fleet laid over a worker mesh (``torch-bsr-sharded``), and the
hand-written BSR kernel for the layer op.

    PYTHONPATH=src python examples/torch_serverless_sparse_dnn.py
    PYTHONPATH=src python examples/torch_serverless_sparse_dnn.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.core import partitioner as pt
from repro_torch.core.backends import TorchBsrBackend, TorchBsrShardedBackend
from repro_torch.core.cost_model import recommend_configuration
from repro_torch.core.sparse import bsr_from_csr
from repro_torch.data.graphchallenge import (
    dense_inference, make_inputs, make_sparse_dnn, relu_bias_threshold)
from repro_torch.faas.simulator import LatencyModel, run_fsi
from repro_torch.kernels.bsr_spmm.ops import bsr_spmm
from repro_torch.launch.mesh import make_worker_mesh

NEURONS, LAYERS, BATCH = 512, 24, 64


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    backend = TorchBsrBackend(device=args.device)
    net = make_sparse_dnn(NEURONS, n_layers=LAYERS, seed=0)
    x0 = make_inputs(NEURONS, BATCH, seed=1)
    oracle = dense_inference(net, x0)

    # 1 — the router picks the config from the cost model (paper §IV-C)
    hgp = pt.partition_network(net.layers, P=8, method="hgp", seed=0)
    vol = pt.measure_comm_volume(net.layers, hgp, bytes_per_row=4 * BATCH)
    channel, P, table = recommend_configuration(
        model_bytes=net.model_bytes,
        per_layer_exchange_bytes=vol.total_bytes_sent / LAYERS,
        n_layers=LAYERS,
    )
    print(f"router: channel={channel} P={P} "
          f"(candidates: {[(k, round(v.total, 5)) for k, v in list(table.items())[:6]]})")

    # 2 — run it (parallel even if serial was chosen, to demo IPC), then the
    # same fleet laid over a worker mesh: every device of the default mesh,
    # and three shards of one device (P 8 pads to 9 workers)
    run_channel = channel if channel != "serial" else "queue"
    run_P = P if P > 1 else 8
    r = run_fsi(net, x0, P=run_P, channel=run_channel, memory_mb=4000,
                compute_backend=backend)
    assert np.allclose(r.output, oracle, rtol=1e-4, atol=1e-4)
    print(f"parallel run: {run_channel} P={run_P} latency={r.makespan:.2f}s "
          f"cost=${r.cost.total:.6f} ({backend.name} on {args.device})")
    for mesh in (make_worker_mesh(device=args.device),
                 [torch.device(args.device)] * 3):
        for dispatch in ("fused", "vmap"):
            s = run_fsi(net, x0, P=run_P, channel=run_channel, memory_mb=4000,
                        compute_backend=TorchBsrShardedBackend(
                            dispatch=dispatch), mesh=mesh)
            same = np.array_equal(s.output, r.output)
            print(f"  torch-bsr-sharded D={len(mesh)} {dispatch}: output "
                  f"bit for bit torch-bsr's: {same}; cost "
                  f"${s.cost.total:.6f}")
            assert same

    # 3 — partitioning ablation (Table III)
    for method in ("hgp", "random"):
        res = pt.partition_network(net.layers, P=run_P, method=method, seed=0)
        rep = pt.measure_comm_volume(net.layers, res, bytes_per_row=4 * BATCH)
        print(f"  {method:6s}: exchange volume {rep.total_bytes_sent/1e6:.1f}MB")

    # 4 — straggler mitigation (paper §V-A3 lineage)
    lat = LatencyModel(straggler_prob=0.4, straggler_slowdown=5e4)
    slow = run_fsi(net, x0, P=run_P, channel=run_channel, memory_mb=4000,
                   latency=lat, compute_backend=backend)
    fixed = run_fsi(net, x0, P=run_P, channel=run_channel, memory_mb=4000,
                    latency=lat, reinvoke_stragglers=True,
                    compute_backend=backend)
    print(f"stragglers: makespan {slow.makespan:.2f}s → "
          f"{fixed.makespan:.2f}s with re-invocation")

    # 5 — the layer op on the hand-written kernel ≡ the CSR layer
    W = net.layers[0]
    blocks, cols, _ = bsr_from_csr(W, (32, 32), pad=True).padded()
    dev = torch.device(args.device)
    y_kernel = bsr_spmm(torch.from_numpy(blocks).to(dev),
                        torch.from_numpy(cols).to(dev),
                        torch.from_numpy(x0).to(dev), bias=net.bias)
    y_ref = relu_bias_threshold(W.matmul_dense_fast(x0), net.bias)
    ok = np.allclose(y_kernel.cpu().numpy()[:W.nrows], y_ref, rtol=1e-5,
                     atol=1e-5)
    print(f"BSR kernel ({args.device}) ≡ CSR layer: {ok}")
    if not ok:
        raise SystemExit("the BSR layer op differs from the CSR layer")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
