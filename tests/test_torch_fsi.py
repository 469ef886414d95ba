"""The port's FSI main path (``repro_torch.faas.simulator.run_fsi``) against
the JAX package's, on the same net and inputs.

* The port's ``numpy-csr`` run equals the reference's on every metric: the
  simulator, fabrics and billing are copies, so nothing may move.
* ``torch-bsr`` on the CPU (the kernels' plain PyTorch versions) follows the
  reference's backend-parity rules (``tests/test_backends.py``) against both
  ``numpy-csr`` and ``pallas-bsr``: output within 1e-4 over 8 fp32 layers,
  FLOPs, messages and raw exchange bytes exact, cost within 5%, worker times
  within 2% (wire bytes may differ: zlib sees other fp32 bit patterns).
* The port imports neither JAX nor the JAX package, and its default backend
  raises without a CUDA card instead of running on the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.data import graphchallenge as ref_gc  # noqa: E402
from repro.faas.simulator import run_fsi as ref_run_fsi  # noqa: E402
from repro_torch.core import backends as port_backends  # noqa: E402
from repro_torch.core.backends import TorchBsrBackend  # noqa: E402
from repro_torch.data import graphchallenge as port_gc  # noqa: E402
from repro_torch.faas.simulator import run_fsi as port_run_fsi  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
N, LAYERS, P, BATCH = 256, 8, 4, 24


def _carry(net):
    """The reference net's weights handed to the port as numpy arrays."""
    return port_gc.net_from_arrays(
        net.neurons, net.bias,
        [(W.shape, W.indptr, W.indices, W.data) for W in net.layers])


@pytest.fixture(scope="module")
def case():
    net = ref_gc.make_sparse_dnn(N, n_layers=LAYERS, seed=0)
    x0 = ref_gc.make_inputs(N, BATCH, seed=1)
    return net, _carry(net), x0, ref_gc.dense_inference(net, x0)


def _assert_same_run(a, b):
    """Every reported number of two runs is equal."""
    np.testing.assert_array_equal(a.output, b.output)
    np.testing.assert_array_equal(a.worker_times, b.worker_times)
    assert (a.channel, a.P) == (b.channel, b.P)
    assert vars(a.stats) == vars(b.stats)
    assert vars(a.cost) == vars(b.cost)
    assert a.metrics == b.metrics
    assert a.raw_exchange_bytes == b.raw_exchange_bytes
    assert a.wire_exchange_bytes == b.wire_exchange_bytes


def _assert_billing_parity(r, ref, oracle):
    np.testing.assert_allclose(r.output, oracle, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(r.output, ref.output, rtol=1e-4, atol=1e-4)
    assert r.metrics["flops_total"] == ref.metrics["flops_total"]
    assert r.metrics.get("messages") == ref.metrics.get("messages")
    assert r.raw_exchange_bytes == ref.raw_exchange_bytes
    assert r.cost.total == pytest.approx(ref.cost.total, rel=0.05)
    np.testing.assert_allclose(r.worker_times, ref.worker_times, rtol=2e-2)


@pytest.mark.parametrize("channel", ["queue", "object"])
def test_run_fsi_matches_reference(case, channel):
    net, port_net, x0, oracle = case
    kw = dict(P=P, channel=channel, memory_mb=4000)
    ref_csr = ref_run_fsi(net, x0, compute_backend="numpy-csr", **kw)
    ref_pallas = ref_run_fsi(net, x0, compute_backend="pallas-bsr", **kw)
    port_csr = port_run_fsi(port_net, x0, compute_backend="numpy-csr", **kw)
    port_bsr = port_run_fsi(port_net, x0,
                            compute_backend=TorchBsrBackend(device="cpu"), **kw)
    _assert_same_run(port_csr, ref_csr)
    _assert_billing_parity(port_bsr, ref_csr, oracle)
    _assert_billing_parity(port_bsr, ref_pallas, oracle)


def test_serial_matches_reference(case):
    net, port_net, x0, oracle = case
    ref_csr = ref_run_fsi(net, x0, channel="serial", compute_backend="numpy-csr")
    ref_pallas = ref_run_fsi(net, x0, channel="serial",
                             compute_backend="pallas-bsr")
    port_csr = port_run_fsi(port_net, x0, channel="serial",
                            compute_backend="numpy-csr")
    port_bsr = port_run_fsi(port_net, x0, channel="serial",
                            compute_backend=TorchBsrBackend(device="cpu"))
    _assert_same_run(port_csr, ref_csr)
    for ref in (ref_csr, ref_pallas):
        np.testing.assert_allclose(port_bsr.output, oracle, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(port_bsr.output, ref.output, rtol=1e-4,
                                   atol=1e-4)
        # serial has no channel: the bill is compute + invocation only
        assert port_bsr.metrics["flops"] == ref.metrics["flops"]
        assert port_bsr.cost.total == pytest.approx(ref.cost.total, rel=1e-12)


def test_fleet_and_per_worker_paths_agree_bitwise(case):
    """``fleet_apply`` (one launch per layer) and ``apply`` (one per worker,
    the path fault injection drives) give the same output bits."""
    _, port_net, x0, _ = case
    be = TorchBsrBackend(device="cpu")

    class PerWorker(TorchBsrBackend):
        def fleet_prepare_all(self, layer_states):
            return None

    fleet = port_run_fsi(port_net, x0, P=P, channel="queue", compute_backend=be)
    per = port_run_fsi(port_net, x0, P=P, channel="queue",
                       compute_backend=PerWorker(device="cpu"))
    np.testing.assert_array_equal(fleet.output, per.output)


@pytest.mark.parametrize("channel", ["queue", "object"])
def test_chaos_path_matches_reference(case, channel):
    """A killed worker recovers through the per-worker ``apply`` path: the
    port's copy bills the recovery exactly as the reference does, and the
    kernel backend's output stays bitwise equal to its fault-free run."""
    from repro.faas.chaos import FaultPlan as RefFaultPlan
    from repro_torch.faas.chaos import FaultPlan

    net, port_net, x0, oracle = case
    kill = ((1, 2, "compute"),)
    kw = dict(P=P, channel=channel, memory_mb=4000)
    ref_csr = ref_run_fsi(net, x0, compute_backend="numpy-csr",
                          faults=RefFaultPlan(kills=kill), **kw)
    port_csr = port_run_fsi(port_net, x0, compute_backend="numpy-csr",
                            faults=FaultPlan(kills=kill), **kw)
    _assert_same_run(port_csr, ref_csr)
    be = TorchBsrBackend(device="cpu")
    port_bsr = port_run_fsi(port_net, x0, compute_backend=be,
                            faults=FaultPlan(kills=kill), **kw)
    clean = port_run_fsi(port_net, x0, compute_backend=be, **kw)
    np.testing.assert_array_equal(port_bsr.output, clean.output)
    _assert_billing_parity(port_bsr, ref_csr, oracle)
    assert port_bsr.metrics["n_reinvokes"] == ref_csr.metrics["n_reinvokes"] == 1.0


def test_net_from_arrays_and_seeded_nets_match_reference():
    ref = ref_gc.make_sparse_dnn(N, n_layers=LAYERS, seed=0)
    for port in (port_gc.make_sparse_dnn(N, n_layers=LAYERS, seed=0), _carry(ref)):
        assert (port.neurons, port.bias, port.n_layers) == (
            ref.neurons, ref.bias, ref.n_layers)
        for a, b in zip(port.layers, ref.layers):
            assert a.shape == b.shape
            for name in ("indptr", "indices", "data"):
                x, y = getattr(a, name), getattr(b, name)
                assert x.dtype == y.dtype, name
                np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(port_gc.make_inputs(N, BATCH, seed=1),
                                  ref_gc.make_inputs(N, BATCH, seed=1))
    carried = _carry(ref)
    carried.layers[0].data[0] = 7.0  # a copy, not a view of the source
    assert ref.layers[0].data[0] != 7.0


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    examples = sorted((REPO / "examples").glob("torch_*.py"))
    return files + examples + [REPO / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_reference():
    files = _port_files()
    assert len(files) > 20 and all(f.exists() for f in files)
    bad = [(f.relative_to(REPO).as_posix(), m)
           for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]
    assert not bad, bad
    probe = ("import sys, repro_torch.faas.simulator, repro_torch.core.backends,"
             " repro_torch.kernels.bsr_spmm.ops, repro_torch.training.trainer,"
             " repro_torch.launch.mesh, repro_torch.models.attention,"
             " repro_torch.models.moe, repro_torch.serving.scheduler,"
             " repro_torch.serving.router,"
             " repro_torch.distributed.sharding, repro_torch.distributed.costing,"
             " repro_torch.launch.dryrun,"
             " repro_torch.configs.sparse_dnn_graphchallenge;"
             " print(sorted({m.split('.')[0] for m in sys.modules}"
             " & {'jax', 'jaxlib', 'repro', 'ml_dtypes'}))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_default_backend_raises_without_cuda(case, monkeypatch):
    _, port_net, x0, _ = case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: port_backends.get_backend(None),
                 lambda: port_backends.get_backend("torch-bsr"),
                 lambda: port_run_fsi(port_net, x0, P=P, channel="queue"),
                 lambda: port_run_fsi(port_net, x0, channel="serial")):
        with pytest.raises(RuntimeError, match="CUDA device"):
            make()


def test_registry_names_and_state_keys():
    assert port_backends.BACKEND_NAMES == ("numpy-csr", "numpy-fast", "torch-bsr",
                                           "torch-bsr-sharded")
    with pytest.raises(ValueError, match="unknown compute backend"):
        port_backends.get_backend("pallas-bsr")
    a = TorchBsrBackend(device="cpu")
    b = TorchBsrBackend(block_shape=(16, 16), device="cpu")
    assert a.state_key != b.state_key and "cpu" in a.state_key
    with pytest.raises(ValueError, match="mesh"):
        port_run_fsi(port_gc.make_sparse_dnn(64, n_layers=1), np.ones((64, 2)),
                     P=2, compute_backend=a, mesh=object())
