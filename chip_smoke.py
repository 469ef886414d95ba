"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printed as it ends:

1. card: the card's name and power limit, then the BSR kernels' build
   (``nvcc`` for ``sm_90a``, from the sources in the checkout);
2. kernels against their plain PyTorch versions on the card, at the main
   path's shapes and data (GraphChallenge N = 65536, batch 128, 32x32 blocks,
   K up to 32; the fleet of P = 64 workers that ``run_fsi`` stacks), plus a
   ragged batch and a zero-count worker; tolerance 1e-5 (summation order);
   the fleet kernel must equal the per-worker kernel bit for bit;
3. the main path: ``run_fsi`` with the ``torch-bsr`` backend on the queue and
   object channels at P = 64 and on the serial channel, on an 8-layer cut of
   the N = 65536 GraphChallenge net; each output is held to 1e-4 of
   ``dense_inference``, and FLOPs, messages and raw exchange bytes to exact
   equality with a ``numpy-fast`` run (cost within 5%);
4. one JSON line with each kernel's time, launches on the main path, bound,
   plain-version time and one library call's time.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, and the script exits non-zero without printing it; it also exits
non-zero where no CUDA card is present.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

N, BATCH, P, LAYERS, SEED = 65536, 128, 64, 8, 0
TOL = dict(rtol=1e-5, atol=1e-5)
E2E_TOL = dict(rtol=1e-4, atol=1e-4)
# (HBM bytes/s, fp32 FLOP/s outside the tensor cores), NVIDIA data sheets
PEAKS = {"H100 SXM": (3.35e12, 67e12), "H100 PCIe": (2.0e12, 51e12),
         "H100 NVL": (3.9e12, 60e12)}
KERNEL_SOURCE = "src/repro_torch/kernels/bsr_spmm/csrc/bsr_spmm.cu"
REPLACES = {"bsr_spmm_fused": "src/repro/kernels/bsr_spmm/bsr_spmm.py:180",
            "bsr_spmm_fleet": "src/repro/kernels/bsr_spmm/bsr_spmm.py:125"}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def peaks_for(name: str):
    if "H100" in name:
        kind = next((k for k in ("H100 NVL", "H100 PCIe") if k.split()[1] in name),
                    "H100 SXM")
        return kind, PEAKS[kind]
    raise ValueError(f"no data-sheet peaks for card {name!r}")


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` runs, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    err = (got - want).abs()
    rel = (err / want.abs().clamp_min(1e-30)).max().item()
    log(f"  {name}: shape {tuple(got.shape)} max_abs_err {err.max().item():.3e} "
        f"max_rel_err {rel:.3e} (tolerance rtol=atol=1e-5)")
    torch.testing.assert_close(got, want, **TOL)
    return err.max().item()


def bsr_library_call(blocks, cols, counts, x, n_cols_blocks, bias, clip):
    """One PyTorch call computing the fleet's layer op: a block-diagonal
    ``torch.sparse_bsr_tensor`` of every worker's real blocks times the
    stacked x, then the clamp.  A yardstick only; the port never calls it.
    Returns the call and its first result."""
    p, nbr, k, bm, bn = blocks.shape
    b = x.shape[-1]
    real = torch.arange(k, device=blocks.device) < counts[..., None].long()
    offs = (torch.arange(p, device=blocks.device) * n_cols_blocks)[:, None, None]
    values = blocks[real].contiguous()
    col = (cols.long() + offs)[real].to(torch.int32).contiguous()
    crow = torch.zeros(p * nbr + 1, dtype=torch.int32, device=blocks.device)
    crow[1:] = counts.reshape(-1).cumsum(0)
    a = torch.sparse_bsr_tensor(crow, col, values,
                                size=(p * nbr * bm, p * n_cols_blocks * bn),
                                check_invariants=False)
    xf = x.reshape(p * n_cols_blocks * bn, b)

    def call():
        return torch.clamp(a @ xf + bias, 0.0, clip)

    y = call().reshape(p, nbr * bm, b)
    return call, y


def bound(blocks, cols, counts, b: int, peaks):
    """Least time for the layer op on this data: the larger of every byte
    it needs once over HBM and every FMA it needs over the fp32 peak.  It
    needs the real blocks (those below ``counts``; the rest are zero
    padding), their column ids, the x block rows they reference, and y."""
    p, nbr, k, bm, bn = blocks.shape
    real = torch.arange(k, device=cols.device) < counts[..., None].long()
    n_real = int(real.sum())
    key = torch.arange(p, device=cols.device)[:, None, None] * (1 << 31) + cols.long()
    x_blocks = int(torch.unique(key[real]).numel())
    bytes_ = (n_real * (bm * bn + 1) + counts.numel() + x_blocks * bn * b
              + p * nbr * bm * b) * 4
    flops = 2.0 * n_real * bm * bn * b
    t_bytes, t_ops = bytes_ / peaks[0] * 1e3, flops / peaks[1] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            bytes_, flops)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    from repro_torch.core.backends import TorchBsrBackend
    from repro_torch.core.fsi import prepare_worker_artifacts
    from repro_torch.core.partitioner import partition_network
    from repro_torch.core.send_recv import build_comm_plans
    from repro_torch.core.sparse import bsr_from_csr
    from repro_torch.data.graphchallenge import (
        GraphChallengeNet, dense_inference, make_inputs, make_sparse_dnn)
    from repro_torch.faas.simulator import run_fsi
    from repro_torch.kernels.bsr_spmm import ops, ref

    dev = torch.device("cuda")
    t_start = time.time()

    # ---- 1. card + build -------------------------------------------------
    card = card_line()
    log(card)
    name = card.split(",")[0].strip()
    kind, peaks = peaks_for(name)
    log(f"[card] {name} x{torch.cuda.device_count()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; peaks of the {kind} data sheet: "
        f"{peaks[0] / 1e12} TB/s HBM, {peaks[1] / 1e12} TFLOP/s fp32")
    t = time.time()
    ops.load_library()
    log(f"[build] bsr_spmm.cu -> {ops.library_path().parent.name}: "
        f"{time.time() - t:.2f} s")
    for line in (ops.library_path().parent / "nvcc.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 2. kernels against their plain versions ------------------------
    log(f"[config] GraphChallenge N={N}, batch {BATCH}, blocks 32x32, P={P}, "
        f"{LAYERS} layers of 120 (depth cut for the time limit; width, block "
        f"shape and batch panel are the real ones; 8 layers cover every "
        f"window offset 0/3/6/9 twice), weights from seed {SEED}")
    t = time.time()
    net = make_sparse_dnn(N, n_layers=LAYERS, seed=SEED)
    x0 = make_inputs(N, BATCH, seed=1)
    layer = 2  # window offset 6: K = 32 blocks in every row block
    x_in = dense_inference(GraphChallengeNet(N, net.layers[:layer], net.bias), x0)
    log(f"[data] net + inputs + layer-{layer} activations: {time.time() - t:.1f} s")

    be = TorchBsrBackend(device="cuda")
    bsr = bsr_from_csr(net.layers[layer], (32, 32), pad=True)
    blocks_np, cols_np, counts_np = bsr.padded()
    blocks = torch.from_numpy(blocks_np).to(dev)
    cols = torch.from_numpy(cols_np).to(dev)
    counts = torch.from_numpy(counts_np.astype(np.int32)).to(dev)
    x = torch.from_numpy(np.ascontiguousarray(x_in, np.float32)).to(dev)
    nbr, k = blocks_np.shape[:2]
    log(f"[kernels] serial layer {layer}: blocks [{nbr},{k},32,32] "
        f"({blocks_np.nbytes / 1e6:.0f} MB), x [{N},{BATCH}], "
        f"{int(counts_np.sum())} real blocks of {nbr * k}, "
        f"{net.layers[layer].nnz} nonzeros")
    y_k = ops.bsr_spmm(blocks, cols, x, bias=net.bias)
    y_p = ref.bsr_spmm_fused_ref(blocks, cols, x, net.bias)
    err_fused = [compare("fused vs plain", y_k, y_p)]

    t = time.time()
    partition = partition_network(net.layers, P, method="hgp", seed=SEED)
    plans = build_comm_plans(net.layers, partition)
    arts = prepare_worker_artifacts(net.layers, partition, plans, backend=be)
    fleet = be.fleet_prepare_all(
        [[arts[m].layers[j].state_for(be) for m in range(P)]
         for j in range(LAYERS)])[layer]
    X = np.zeros((P, fleet.n_pad, BATCH), np.float32)
    for m in range(P):
        rows = arts[m].layers[layer].needed_rows
        X[m, : len(rows)] = x_in[rows]
    fx = torch.from_numpy(X).to(dev)
    log(f"[kernels] fleet layer {layer} (partition + artifacts "
        f"{time.time() - t:.1f} s): blocks {list(fleet.blocks.shape)} "
        f"({fleet.blocks.numel() * 4 / 1e6:.0f} MB), x {list(fx.shape)}, "
        f"{int(fleet.counts.sum())} real blocks of "
        f"{fleet.counts.numel() * fleet.blocks.shape[2]}")
    fy_k = ops.bsr_spmm_fleet(fleet.blocks, fleet.cols, fleet.counts, fx,
                              bias=net.bias)
    fy_p = ref.bsr_spmm_fleet_ref(fleet.blocks, fleet.cols, fleet.counts, fx,
                                  net.bias)
    err_fleet = [compare("fleet vs plain", fy_k, fy_p)]
    for m in range(P):
        per = ops.bsr_spmm(fleet.blocks[m], fleet.cols[m], fx[m], bias=net.bias)
        check(torch.equal(per, fy_k[m]), f"fleet != per-worker for worker {m}")
    log(f"  fleet == per-worker kernel, bitwise, for all {P} workers")

    # ragged: batch not a multiple of the 128-column tile, a zero-count worker
    g = np.random.default_rng(SEED)
    rb = 200
    rblocks = torch.cat([fleet.blocks[:3], torch.zeros_like(fleet.blocks[:1])])
    rcols = torch.cat([fleet.cols[:3], torch.zeros_like(fleet.cols[:1])])
    rcounts = torch.cat([fleet.counts[:3], torch.zeros_like(fleet.counts[:1])])
    rx = torch.from_numpy(g.uniform(0, 2, (4, fleet.n_pad, rb))
                          .astype(np.float32)).to(dev)
    ry_k = ops.bsr_spmm_fleet(rblocks, rcols, rcounts, rx, bias=net.bias)
    err_fleet.append(compare(
        "ragged fleet (batch 200, zero-count worker) vs plain", ry_k,
        ref.bsr_spmm_fleet_ref(rblocks, rcols, rcounts, rx, net.bias)))
    check(torch.equal(ry_k[3], torch.zeros_like(ry_k[3])),
          "zero-count worker produced nonzero output")
    for m in range(4):
        per = ops.bsr_spmm(rblocks[m], rcols[m], rx[m], bias=net.bias)
        check(torch.equal(per, ry_k[m]), f"ragged fleet != per-worker for worker {m}")
        err_fused.append(compare(
            f"ragged fused worker {m} vs plain", per,
            ref.bsr_spmm_fused_ref(rblocks[m], rcols[m], rx[m], net.bias)))
    log("  ragged fleet == per-worker kernel, bitwise")

    # timings at the main-path shapes
    timing = {}
    for kname, kern, plain, operands in (
        ("bsr_spmm_fused",
         lambda: ops.bsr_spmm(blocks, cols, x, bias=net.bias),
         lambda: ref.bsr_spmm_fused_ref(blocks, cols, x, net.bias),
         (blocks[None], cols[None], counts[None], x[None], N // 32)),
        ("bsr_spmm_fleet",
         lambda: ops.bsr_spmm_fleet(fleet.blocks, fleet.cols, fleet.counts, fx,
                                    bias=net.bias),
         lambda: ref.bsr_spmm_fleet_ref(fleet.blocks, fleet.cols, fleet.counts,
                                        fx, net.bias),
         (fleet.blocks, fleet.cols, fleet.counts, fx, fleet.n_pad // 32)),
    ):
        ms, plain_ms = time_ms(kern), time_ms(plain)
        lib_ms, lib_err = None, None
        try:
            call, y_lib = bsr_library_call(*operands, net.bias, be.clip)
            lib_ms = time_ms(call)
            y_ref = y_k if kname == "bsr_spmm_fused" else fy_k
            lib_err = (y_lib.reshape(y_ref.shape) - y_ref).abs().max().item()
            del call, y_lib
        except (RuntimeError, NotImplementedError, ValueError, TypeError) as e:
            log(f"  {kname}: library call refused: {type(e).__name__}: {e}")
        b_ms, b_by, nbytes, flops = bound(*operands[:3], BATCH, peaks)
        timing[kname] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by)
        log(f"[time] {kname}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms "
            f"(max |library - kernel| {lib_err}), bound {b_ms:.4f} ms by "
            f"{b_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; "
            f"{flops / ms / 1e9:.2f} TFLOP/s achieved) on {card}")
    del y_p, fy_p
    torch.cuda.empty_cache()

    # ---- 3. the main path ------------------------------------------------
    dense = dense_inference(net, x0)
    launches = {key: 0 for key in ops.LAUNCHES}
    runs = [("queue", dict(P=P, channel="queue", partition=partition)),
            ("object", dict(P=P, channel="object", partition=partition)),
            ("serial", dict(channel="serial"))]
    for ch, kw in runs:
        t = time.time()
        want = run_fsi(net, x0, compute_backend="numpy-fast", **kw)
        t_np = time.time() - t
        for key in ops.LAUNCHES:
            ops.LAUNCHES[key] = 0
        t = time.time()
        got = run_fsi(net, x0, compute_backend=TorchBsrBackend(device="cuda"),
                      **kw)
        t_gpu = time.time() - t
        counts_run = dict(ops.LAUNCHES)
        out = got.output
        check(out.shape == (N, BATCH) and bool(np.isfinite(out).all()),
              f"{ch}: output shape {out.shape} or non-finite values")
        err = float(np.abs(out - dense).max())
        np.testing.assert_allclose(out, dense, **E2E_TOL)
        if ch == "serial":
            check(got.metrics["flops"] == want.metrics["flops"], f"{ch}: flops")
            want_counts = {"bsr_spmm_fused": LAYERS, "bsr_spmm_fleet": 0}
        else:
            for key in ("flops_total", "messages"):
                check(got.metrics.get(key) == want.metrics.get(key), f"{ch}: {key}")
            check(got.raw_exchange_bytes == want.raw_exchange_bytes,
                  f"{ch}: raw exchange bytes")
            want_counts = {"bsr_spmm_fused": 0, "bsr_spmm_fleet": LAYERS}
        check(counts_run == want_counts, f"{ch}: launches {counts_run}")
        rel_cost = abs(got.cost.total - want.cost.total) / want.cost.total
        check(rel_cost <= 0.05, f"{ch}: cost differs by {rel_cost:.3%}")
        for key, v in counts_run.items():
            launches[key] += v
        log(f"[run_fsi] {ch}: torch-bsr {t_gpu:.2f} s host wall, numpy-fast "
            f"{t_np:.2f} s; max |out - dense_inference| {err:.3e}; "
            f"flops {got.metrics.get('flops_total', got.metrics.get('flops'))}, "
            f"messages {got.metrics.get('messages')}, raw bytes "
            f"{got.raw_exchange_bytes} (equal to numpy-fast); cost "
            f"{got.cost.total:.6e} vs {want.cost.total:.6e}; launches {counts_run}")
    for key, v in launches.items():
        check(v > 0, f"{key} was not launched on the main path")
    log(f"[memory] peak device allocation {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # ---- 4. kernels line -------------------------------------------------
    errs = {"bsr_spmm_fused": max(err_fused), "bsr_spmm_fleet": max(err_fleet)}
    kernels = [dict(name=k, route="cuda", source=KERNEL_SOURCE,
                    replaces=REPLACES[k], launches=launches[k],
                    max_abs_err=errs[k], **timing[k])
               for k in ("bsr_spmm_fused", "bsr_spmm_fleet")]
    log(f"[total] {time.time() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
