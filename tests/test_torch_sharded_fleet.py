"""The port's sharded fleet backend (``torch-bsr-sharded``,
``run_fsi(mesh=...)``) on the CPU, against the reference's ``numpy-csr``.

Ports of ``tests/test_sharded_fleet.py``, ``tests/test_fleet_channels.py``'s
sharded end-to-end test and the FSI half of ``tests/test_chaos.py``, run
over worker meshes of the CPU (``make_worker_mesh(D, device="cpu")``) at D 1
and D 3, where P 7 pads to 9 workers:

* both dispatches (``fused``: one fleet launch a device block; ``vmap``: one
  per-worker launch a worker) give ``torch-bsr``'s output bits, and
  ``fleet_apply`` equals the per-worker ``apply``;
* ``run_fsi`` over it follows the backend-parity rules against the
  reference's ``numpy-csr`` run, with and without a ``FaultPlan``: output
  within 1e-4 of ``dense_inference`` and of ``numpy-csr``, FLOPs, messages
  and raw exchange bytes exactly equal, cost within 5%, worker times within
  2%, and the recovery counts (re-invocations, checkpoint PUTs,
  redeliveries) exactly equal.  Wire bytes may differ (zlib sees other fp32
  bits), so nothing is held to the reference's pinned golden values;
* chaos runs recover to the backend's own fault-free output bit for bit;
* the probes P 1, 3, 6, 7, batch 1, 7, 33, 130 and
  ``exploit_sparsity=False``.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.data import graphchallenge as ref_gc  # noqa: E402
from repro.faas.chaos import FaultPlan as RefFaultPlan  # noqa: E402
from repro.faas.simulator import run_fsi as ref_run_fsi  # noqa: E402
from repro_torch.core.backends import (  # noqa: E402
    BACKEND_NAMES,
    TorchBsrBackend,
    TorchBsrShardedBackend,
    get_backend,
)
from repro_torch.core.sparse import random_sparse  # noqa: E402
from repro_torch.data import graphchallenge as port_gc  # noqa: E402
from repro_torch.faas.chaos import CRASH_PHASES, FaultPlan, FleetFailure  # noqa: E402
from repro_torch.faas.simulator import run_fsi  # noqa: E402
from repro_torch.launch.mesh import make_worker_mesh  # noqa: E402

MESHES = (1, 3)


def _carry(net):
    return port_gc.net_from_arrays(
        net.neurons, net.bias,
        [(W.shape, W.indptr, W.indices, W.data) for W in net.layers])


def _make_case(n, layers, batch, seed, x_seed):
    net = ref_gc.make_sparse_dnn(n, n_layers=layers, seed=seed)
    x0 = ref_gc.make_inputs(n, batch, seed=x_seed)
    return net, _carry(net), x0, ref_gc.dense_inference(net, x0)


@pytest.fixture(scope="module")
def case():
    return _make_case(256, 6, 16, 0, 1)


@pytest.fixture(scope="module")
def chaos_case():
    """``tests/test_chaos.py``'s net and inputs."""
    return _make_case(128, 6, 8, 7, 8)


def _sharded(D, dispatch="fused"):
    return TorchBsrShardedBackend(mesh=make_worker_mesh(D, device="cpu"),
                                  dispatch=dispatch)


def _assert_billing_parity(r, ref, oracle):
    np.testing.assert_allclose(r.output, oracle, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(r.output, ref.output, rtol=1e-4, atol=1e-4)
    assert r.metrics["flops_total"] == ref.metrics["flops_total"]
    assert r.metrics.get("messages") == ref.metrics.get("messages")
    assert r.raw_exchange_bytes == ref.raw_exchange_bytes
    assert r.cost.total == pytest.approx(ref.cost.total, rel=0.05)
    np.testing.assert_allclose(r.worker_times, ref.worker_times, rtol=2e-2)


RECOVERY = ("n_reinvokes", "checkpoint_puts", "redeliveries")


def _assert_recovery_parity(r, ref):
    for key in RECOVERY:
        assert r.metrics.get(key) == ref.metrics.get(key), key


class TestShardedFleetBackend:
    def test_registry_resolves_and_rejects_meshless(self, monkeypatch):
        assert BACKEND_NAMES == ("numpy-csr", "numpy-fast", "torch-bsr",
                                 "torch-bsr-sharded")
        be = get_backend("torch-bsr-sharded")
        assert isinstance(be, TorchBsrShardedBackend)
        assert be.dispatch == "fused"
        # the default mesh is every CUDA device: none here, so first use
        # raises instead of running on the CPU
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA device"):
            be.n_devices
        net = port_gc.make_sparse_dnn(128, n_layers=2, seed=0)
        x0 = port_gc.make_inputs(128, 4, seed=1)
        for name in ("numpy-fast", TorchBsrBackend(device="cpu")):
            with pytest.raises(ValueError, match="does not take a mesh"):
                run_fsi(net, x0, P=2, channel="queue", memory_mb=2000,
                        compute_backend=name,
                        mesh=make_worker_mesh(1, device="cpu"))

    def test_worker_mesh(self, monkeypatch):
        assert make_worker_mesh(3, device="cpu") == [torch.device("cpu")] * 3
        assert make_worker_mesh(device="cpu") == [torch.device("cpu")]
        with pytest.raises(ValueError, match="cuda or cpu"):
            make_worker_mesh(1, device="meta")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="none is available"):
            make_worker_mesh()

    def test_state_key_and_with_mesh_carry_mesh_and_dispatch(self):
        a, b = _sharded(1), _sharded(3, "vmap")
        plain = TorchBsrBackend(device="cpu")
        assert a.state_key != plain.state_key
        assert a.state_key == plain.state_key.replace(
            "torch-bsr", "torch-bsr-sharded") + ":d1:fused"
        assert a.state_key.endswith(":d1:fused")
        assert b.state_key.endswith(":d3:vmap")
        moved = b.with_mesh(make_worker_mesh(1, device="cpu"))
        assert (moved.dispatch, moved.n_devices) == ("vmap", 1)
        assert moved.state_key == _sharded(1, "vmap").state_key

    def test_dispatch_validated(self):
        with pytest.raises(ValueError, match="dispatch"):
            TorchBsrShardedBackend(dispatch="einsum")
        with pytest.raises(ValueError, match="at least one device"):
            TorchBsrShardedBackend(mesh=[])

    @pytest.mark.parametrize("D", MESHES)
    def test_fleet_apply_matches_per_worker_and_plain_fleet(self, D):
        """Ragged shards, P 3 and 7 (padded to a multiple of D): fused ≡
        vmap ≡ ``torch-bsr``'s fleet bit for bit, ≡ the per-worker apply."""
        rng = np.random.default_rng(11)
        plain = TorchBsrBackend(device="cpu")
        for P in (3, 7):
            shards = [random_sparse(64 + 32 * (i % 3), 96, 6, rng)
                      for i in range(P)]
            xs = [rng.standard_normal((W.ncols, 16)).astype(np.float32)
                  for W in shards]
            states = [plain.prepare(W) for W in shards]
            want = plain.fleet_apply(plain.fleet_prepare_all([states])[0],
                                     xs, -0.3)
            for dispatch in ("fused", "vmap"):
                be = _sharded(D, dispatch)
                fleet = be.fleet_prepare_all([states])[0]
                assert fleet.p_pad % D == 0 and fleet.p_pad >= P
                assert fleet.p_pad - P < D
                assert len(fleet.blocks) == D
                counts = torch.cat(fleet.counts)
                assert counts.shape[0] == fleet.p_pad
                assert int(counts[P:].sum()) == 0  # inert pad workers
                got = be.fleet_apply(fleet, xs, -0.3)
                for W, st, x, y, yf in zip(shards, states, xs, got, want):
                    assert y.shape == (W.nrows, 16)
                    np.testing.assert_array_equal(y, yf)
                    np.testing.assert_array_equal(y, be.apply(st, x, -0.3))

    @pytest.mark.parametrize("D", MESHES)
    @pytest.mark.parametrize("channel", ["queue", "object"])
    def test_run_fsi_matches_oracle_and_plain_backend(self, case, channel, D):
        """Both channels, P 7: output ≡ ``torch-bsr``'s bit for bit under
        both dispatches, and billing parity with the reference's
        ``numpy-csr``."""
        net, port_net, x0, oracle = case
        kw = dict(P=7, channel=channel, memory_mb=4000)
        ref = ref_run_fsi(net, x0, compute_backend="numpy-csr", **kw)
        plain = run_fsi(port_net, x0, compute_backend=TorchBsrBackend(
            device="cpu"), **kw)
        mesh = make_worker_mesh(D, device="cpu")
        for dispatch in ("fused", "vmap"):
            r = run_fsi(port_net, x0, compute_backend=TorchBsrShardedBackend(
                dispatch=dispatch), mesh=mesh, **kw)
            np.testing.assert_array_equal(r.output, plain.output)
            _assert_billing_parity(r, ref, oracle)

    def test_explicit_mesh_threads_through_run_fsi(self, case):
        _, port_net, x0, oracle = case
        r = run_fsi(port_net, x0, P=5, channel="queue", memory_mb=4000,
                    compute_backend="torch-bsr-sharded",
                    mesh=make_worker_mesh(3, device="cpu"))
        np.testing.assert_allclose(r.output, oracle, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("D", MESHES)
    def test_run_fsi_fused_batched_bit_identical_to_vmap_per_worker(
            self, case, D):
        """``tests/test_fleet_channels.py``'s sharded stack: the fused
        dispatch with batched channels against the vmap dispatch with
        per-worker channels, outputs and billing bit for bit."""
        _, port_net, x0, oracle = case
        mesh = make_worker_mesh(D, device="cpu")
        kw = dict(P=6, channel="queue", memory_mb=4000, mesh=mesh)
        a = run_fsi(port_net, x0, compute_backend=_sharded(D, "vmap"),
                    channel_batching=False, **kw)
        b = run_fsi(port_net, x0, compute_backend="torch-bsr-sharded",
                    channel_batching=True, **kw)
        np.testing.assert_array_equal(a.output, b.output)
        np.testing.assert_allclose(b.output, oracle, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(a.worker_times, b.worker_times)
        assert a.cost.total == b.cost.total
        assert a.raw_exchange_bytes == b.raw_exchange_bytes
        assert a.wire_exchange_bytes == b.wire_exchange_bytes
        assert vars(a.stats) == vars(b.stats)
        assert a.metrics == b.metrics


class TestProbes:
    """The shapes that ROADMAP's probe ran: P 1, 3, 6 and 7, batch 1, 7,
    33 and 130, ``exploit_sparsity=False``; N 1024, 4 layers."""

    @pytest.fixture(scope="class")
    def net(self):
        net = ref_gc.make_sparse_dnn(1024, n_layers=4, seed=3)
        return net, _carry(net)

    @pytest.mark.parametrize("channel", ["queue", "object"])
    @pytest.mark.parametrize("P", [1, 3, 6, 7])
    def test_worker_counts(self, net, P, channel):
        ref_net, port_net = net
        x0 = ref_gc.make_inputs(1024, 7, seed=4)
        oracle = ref_gc.dense_inference(ref_net, x0)
        kw = dict(P=P, channel=channel, memory_mb=4000)
        ref = ref_run_fsi(ref_net, x0, compute_backend="numpy-csr", **kw)
        for D in MESHES:
            r = run_fsi(port_net, x0, compute_backend="torch-bsr-sharded",
                        mesh=make_worker_mesh(D, device="cpu"), **kw)
            if P == 1:  # the serial short-circuit: no channel, no fleet
                np.testing.assert_allclose(r.output, oracle, rtol=1e-4,
                                           atol=1e-4)
                assert r.metrics["flops"] == ref.metrics["flops"]
                assert r.cost.total == pytest.approx(ref.cost.total,
                                                     rel=1e-12)
            else:
                _assert_billing_parity(r, ref, oracle)

    @pytest.mark.parametrize("batch", [1, 7, 33, 130])
    def test_batches(self, net, batch):
        ref_net, port_net = net
        x0 = ref_gc.make_inputs(1024, batch, seed=5)
        oracle = ref_gc.dense_inference(ref_net, x0)
        kw = dict(P=6, channel="queue", memory_mb=4000)
        ref = ref_run_fsi(ref_net, x0, compute_backend="numpy-csr", **kw)
        r = run_fsi(port_net, x0, compute_backend="torch-bsr-sharded",
                    mesh=make_worker_mesh(3, device="cpu"), **kw)
        _assert_billing_parity(r, ref, oracle)

    @pytest.mark.parametrize("channel", ["queue", "object"])
    def test_no_sparsity_exploit(self, net, channel):
        ref_net, port_net = net
        x0 = ref_gc.make_inputs(1024, 16, seed=6)
        oracle = ref_gc.dense_inference(ref_net, x0)
        kw = dict(P=7, channel=channel, memory_mb=4000,
                  exploit_sparsity=False)
        ref = ref_run_fsi(ref_net, x0, compute_backend="numpy-csr", **kw)
        r = run_fsi(port_net, x0, compute_backend="torch-bsr-sharded",
                    mesh=make_worker_mesh(3, device="cpu"), **kw)
        _assert_billing_parity(r, ref, oracle)


# ---------------------------------------------------------------------------
# the FSI half of tests/test_chaos.py over torch-bsr-sharded
# ---------------------------------------------------------------------------

COUNTERS = ("publish_units", "bytes_sns_to_sqs", "sqs_api_calls",
            "s3_puts", "s3_gets", "s3_lists")


def _counters(r):
    return {f: getattr(r.stats, f) for f in COUNTERS}


@pytest.fixture(scope="module")
def chaos_runs(chaos_case):
    """Runs keyed (backend, D, channel, faults), each made once: the
    reference's ``numpy-csr`` (D None) and ``torch-bsr-sharded`` at D."""
    net, port_net, x0, _ = chaos_case
    runs = {}

    def get(D, channel, kills=(), **plan):
        key = (D, channel, kills, tuple(sorted(plan.items())))
        if key not in runs:
            armed = bool(kills or plan)
            if D is None:
                runs[key] = ref_run_fsi(
                    net, x0, P=3, channel=channel, seed=0,
                    compute_backend="numpy-csr",
                    faults=RefFaultPlan(kills=kills, **plan) if armed else None)
            else:
                runs[key] = run_fsi(
                    port_net, x0, P=3, channel=channel, seed=0,
                    compute_backend="torch-bsr-sharded",
                    mesh=make_worker_mesh(D, device="cpu"),
                    faults=FaultPlan(kills=kills, **plan) if armed else None)
        return runs[key]

    return get


@pytest.mark.parametrize("D", MESHES)
class TestShardedChaos:
    @pytest.mark.parametrize("channel", ["queue", "object"])
    def test_zero_fault_armed_plan(self, chaos_runs, channel, D):
        """An armed but empty plan moves no main-fabric counter and no
        output bit; arming bills the checkpoint store's line only."""
        base = chaos_runs(D, channel)
        z = chaos_runs(D, channel, checkpoint_every=1)
        ref = chaos_runs(None, channel, checkpoint_every=1)
        assert _counters(z) == _counters(base)
        assert z.raw_exchange_bytes == base.raw_exchange_bytes
        assert z.wire_exchange_bytes == base.wire_exchange_bytes
        np.testing.assert_array_equal(z.output, base.output)
        assert z.cost.communication == base.cost.communication
        assert z.metrics["n_reinvokes"] == 0.0
        assert z.metrics["checkpoint_puts"] > 0
        assert z.cost.recovery > 0.0
        assert z.metrics["recovery_usd"] == z.cost.recovery
        _assert_recovery_parity(z, ref)

    @pytest.mark.parametrize("phase", CRASH_PHASES)
    @pytest.mark.parametrize("channel", ["queue", "object"])
    def test_single_kill_recovers_bitwise(self, chaos_case, chaos_runs,
                                          channel, phase, D):
        dense = chaos_case[3]
        kills = ((1, 2, phase),)
        base = chaos_runs(D, channel)
        r = chaos_runs(D, channel, kills)
        ref = chaos_runs(None, channel, kills)
        np.testing.assert_array_equal(r.output, base.output)
        _assert_billing_parity(r, ref, dense)
        _assert_recovery_parity(r, ref)
        assert r.metrics["n_reinvokes"] == 1.0
        assert r.cost.recovery > 0.0
        assert r.cost.total > base.cost.total
        assert r.makespan > base.makespan
        if channel == "queue" and phase == "drain":
            assert r.metrics["redeliveries"] >= 1.0

    def test_last_layer_drain_crash(self, chaos_case, chaos_runs, D):
        kills = ((2, 5, "drain"),)
        r = chaos_runs(D, "queue", kills)
        np.testing.assert_array_equal(r.output, chaos_runs(D, "queue").output)
        assert r.metrics["redeliveries"] >= 1.0
        _assert_recovery_parity(r, chaos_runs(None, "queue", kills))

    def test_runtime_limit_reinvokes(self, chaos_case, chaos_runs, D):
        plan = dict(runtime_limit_s=0.35, max_reinvokes=8)
        r = chaos_runs(D, "object", **plan)
        np.testing.assert_array_equal(r.output,
                                      chaos_runs(D, "object").output)
        assert r.metrics["n_reinvokes"] >= 1.0
        ref = chaos_runs(None, "object", **plan)
        _assert_billing_parity(r, ref, chaos_case[3])
        _assert_recovery_parity(r, ref)

    def test_object_replays_from_last_checkpoint(self, chaos_case,
                                                 chaos_runs, D):
        kills, plan = ((1, 3, "compute"),), dict(checkpoint_every=2)
        r = chaos_runs(D, "object", kills, **plan)
        np.testing.assert_array_equal(r.output,
                                      chaos_runs(D, "object").output)
        assert r.metrics["checkpoint_puts"] == 9.0
        ref = chaos_runs(None, "object", kills, **plan)
        _assert_billing_parity(r, ref, chaos_case[3])
        _assert_recovery_parity(r, ref)

    def test_queue_replay_is_honestly_unrecoverable(self, chaos_case, D):
        _, port_net, x0, _ = chaos_case
        with pytest.raises(FleetFailure) as ei:
            run_fsi(port_net, x0, P=3, channel="queue", seed=0,
                    compute_backend="torch-bsr-sharded",
                    mesh=make_worker_mesh(D, device="cpu"),
                    faults=FaultPlan(kills=((1, 3, "compute"),),
                                     checkpoint_every=2))
        reason = ei.value.diagnostics[1]["reason"]
        assert "queue" in reason and "checkpoint_every" in reason

    KILLS = tuple((0, k, "compute") for k in range(4))

    def test_budget_exceeded_raises_with_diagnostics(self, chaos_case, D):
        _, port_net, x0, _ = chaos_case
        with pytest.raises(FleetFailure) as ei:
            run_fsi(port_net, x0, P=3, channel="object", seed=0,
                    compute_backend="torch-bsr-sharded",
                    mesh=make_worker_mesh(D, device="cpu"),
                    faults=FaultPlan(kills=self.KILLS, max_reinvokes=3))
        diag = ei.value.diagnostics[0]
        assert diag["reinvokes"] == 4
        assert diag["phase"] == "compute"

    def test_budget_exactly_sufficient_recovers(self, chaos_case, chaos_runs,
                                                D):
        plan = dict(max_reinvokes=4)
        r = chaos_runs(D, "object", self.KILLS, **plan)
        np.testing.assert_array_equal(r.output,
                                      chaos_runs(D, "object").output)
        assert r.metrics["n_reinvokes"] == 4.0
        ref = chaos_runs(None, "object", self.KILLS, **plan)
        _assert_billing_parity(r, ref, chaos_case[3])
        _assert_recovery_parity(r, ref)
