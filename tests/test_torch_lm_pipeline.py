"""The port's LM pipeline over the serverless fabric
(``repro_torch.faas.lm_pipeline``) against the port's own device engine and
against the JAX package's pipeline, on the CPU, at the ``reduced()`` sizes
of internlm2-1.8b (dense) and deepseek-moe-16b (moe).

Both sides hold the same weights: the reference's ``init`` params, cast to
fp32 (this image's CPU jax cannot run the bf16 LM path) and carried over
with each family's ``params_from_arrays``.

* **Against the port's device engine, bit for bit**: the stage chain runs
  the monolithic model's ops at the same shapes in the same order, and the
  wire carries activations as fp32, so tokens and final logits are equal.
* **Against the reference's pipeline**: identical tokens, logits within
  1e-4 (the reference's fp32 model tolerance); publish units, SQS calls,
  S3 puts, gets and lists, raw exchange bytes, ``memory_mb``, FLOPs and
  every stage's ``weight_bytes`` exactly equal; cost within 5% and worker
  times within 2% (``run_fsi``'s gate, ``tests/test_backends.py``: zlib
  packs other fp32 bit patterns to other sizes).

Also ports of ``tests/test_lm_pipeline.py`` (planner, overlap against
phased clocks, KV residency, the engine's fabric and stream paths, the
unknown engine, stage cold start) and of the pipeline classes of
``tests/test_chaos.py``, ``tests/test_fault_tolerance.py`` (with its own
copies of the duplicating and reordering fabrics) and
``tests/test_overlap_ledger.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.backends import PallasSplitKAttention  # noqa: E402
from repro.faas import lm_pipeline as ref_pipeline  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.backends import TorchSplitKAttention  # noqa: E402
from repro_torch.core.cost_model import AWS_PRICING  # noqa: E402
from repro_torch.core.partitioner import plan_stages  # noqa: E402
from repro_torch.faas.chaos import FaultPlan, FleetFailure  # noqa: E402
from repro_torch.faas.lm_pipeline import (  # noqa: E402
    build_stage_executors,
    run_lm_pipeline,
    stage_layer_costs,
)
from repro_torch.faas.object_service import ObjectFabric  # noqa: E402
from repro_torch.faas.payload import _HEADER  # noqa: E402
from repro_torch.faas.queue_service import QueueFabric  # noqa: E402
from repro_torch.faas.simulator import LatencyModel, charge_weight_load  # noqa: E402
from repro_torch.faas.worker import (  # noqa: E402
    EventLedger,
    ModelStageWorker,
    WorkerState,
)
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.models.registry import get_stage_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import Request  # noqa: E402

ARCHS = {"internlm2-1.8b": (ref_transformer, transformer),
         "deepseek-moe-16b": (ref_moe, moe)}
MAX_NEW = 3
TOL = dict(rtol=1e-4, atol=1e-4)
COUNT_STATS = ("P", "memory_mb", "publish_units", "bytes_sns_to_sqs",
               "sqs_api_calls", "s3_puts", "s3_gets", "s3_lists")
# counts that do not depend on how zlib packs the values
BILLED_COUNTS = ("P", "memory_mb", "publish_units", "sqs_api_calls",
                 "s3_puts", "s3_gets", "s3_lists")
CHAOS_COUNTERS = ("publish_units", "bytes_sns_to_sqs", "sqs_api_calls",
                  "s3_puts", "s3_gets", "s3_lists")


def _nbytes(module) -> int:
    return sum(p.numel() * p.element_size() for p in module.parameters())


@functools.lru_cache(maxsize=None)
def _served(arch):
    """(port cfg, reference cfg, reference fp32 params, the port's fp32
    params, prompts, the port's device engine, its generate)."""
    ref_mod, mod = ARCHS[arch]
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          ref_mod.init(jax.random.key(0), ref_cfg))
    port = mod.params_from_arrays(
        cfg, jax.tree.map(lambda a: None if a is None else np.asarray(a),
                          params), device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab_size, (2, 10), dtype=np.int32)
    engine = ServingEngine(cfg, params=port, device="cpu")
    ref = engine.generate(prompts, max_new_tokens=MAX_NEW)
    return cfg, ref_cfg, params, port, prompts, engine, ref


@functools.lru_cache(maxsize=None)
def _executors(arch, P):
    cfg, _, _, port, _, engine, _ = _served(arch)
    return build_stage_executors(cfg, port, P, attn_backend=engine.attn_backend)


@functools.lru_cache(maxsize=None)
def _ref_executors(arch, P):
    """The reference's executors with its split-KV backend, whose cache
    padding the port's ``torch-splitk`` keeps, so that both sides' caches
    (and KV checkpoints) have one capacity."""
    _, ref_cfg, params, *_ = _served(arch)
    return ref_pipeline.build_stage_executors(
        ref_cfg, params, P, attn_backend=PallasSplitKAttention())


def _run(arch, P, channel, **kw):
    cfg, _, _, port, prompts, _, _ = _served(arch)
    kw.setdefault("max_new_tokens", MAX_NEW)
    return run_lm_pipeline(cfg, prompts, port, P=P, channel=channel,
                           executors=_executors(arch, P), **kw)


# ---------------------------------------------------------------------------
# the stage planner
# ---------------------------------------------------------------------------


class TestStagePlanner:
    def test_uniform_split_covers_contiguously(self):
        plan = plan_stages([1.0] * 8, 4)
        assert [s.n_layers for s in plan.stages] == [2, 2, 2, 2]
        assert plan.stages[0].start == 0 and plan.stages[-1].stop == 8
        for a, b in zip(plan.stages, plan.stages[1:]):
            assert a.stop == b.start

    def test_weighted_split_balances_cost(self):
        costs = [8.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
        plan = plan_stages(costs, 2)
        assert [sum(costs[s.start:s.stop]) for s in plan.stages] == [8.0, 7.0]

    def test_extreme_skew_keeps_every_stage_nonempty(self):
        plan = plan_stages([0.0, 0.0, 0.0, 100.0], 4)
        assert [s.n_layers for s in plan.stages] == [1, 1, 1, 1]

    def test_embed_and_head_flags(self):
        plan = plan_stages([1.0] * 6, 3)
        assert plan.stages[0].has_embed and not plan.stages[0].has_head
        assert plan.stages[-1].has_head and not plan.stages[-1].has_embed
        mid = plan.stages[1]
        assert not mid.has_embed and not mid.has_head
        solo = plan_stages([1.0], 1).stages[0]
        assert solo.has_embed and solo.has_head

    def test_invalid_inputs_raise(self):
        with pytest.raises(ValueError):
            plan_stages([1.0, 1.0], 0)
        with pytest.raises(ValueError):
            plan_stages([1.0, 1.0], 3)
        with pytest.raises(ValueError):
            plan_stages([1.0, -1.0], 1)

    @pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
    @pytest.mark.parametrize("arch", sorted(ARCHS))
    def test_layer_costs_and_plans_equal_the_reference(self, arch, reduced):
        """MoE layers weigh their active experts; the costs and the plans
        at P 2 and 4 are the reference's, at the reduced and full sizes."""
        cfg, ref_cfg = get_config(arch), ref_get_config(arch)
        if reduced:
            cfg, ref_cfg = cfg.reduced(), ref_cfg.reduced()
        costs = stage_layer_costs(cfg)
        assert costs == ref_pipeline.stage_layer_costs(ref_cfg)
        assert len(costs) == cfg.n_layers and all(c > 0 for c in costs)
        for P in (2, 4):
            assert dataclasses.astuple(plan_stages(costs, P)) == \
                dataclasses.astuple(ref_pipeline.plan_stages(costs, P))


# ---------------------------------------------------------------------------
# parity: the device engine, the clocks, the reference
# ---------------------------------------------------------------------------


CASES = [(a, P, ch) for a in sorted(ARCHS) for P in (2, 4)
         for ch in ("queue", "object")]


@pytest.mark.parametrize("arch,P,channel", CASES,
                         ids=[f"{a}-P{P}-{c}" for a, P, c in CASES])
class TestPipelineParity:
    def test_matches_device_engine_and_phased_oracle(self, arch, P, channel):
        """Tokens and logits bit for bit the device engine's; every billed
        count equal between the overlap and phased clocks, overlap never
        later, stage by stage."""
        ref = _served(arch)[6]
        ov = _run(arch, P, channel, overlap=True)
        ph = _run(arch, P, channel, overlap=False)
        np.testing.assert_array_equal(ov.tokens, ref.tokens)
        assert np.array_equal(ov.logits, ref.prefill_logits), \
            "pipeline logits are not bit for bit the device engine's"
        np.testing.assert_array_equal(ov.tokens, ph.tokens)
        np.testing.assert_array_equal(ov.logits, ph.logits)
        for f in COUNT_STATS:
            assert getattr(ov.stats, f) == getattr(ph.stats, f), f
        assert ov.raw_exchange_bytes == ph.raw_exchange_bytes
        assert ov.wire_exchange_bytes == ph.wire_exchange_bytes
        assert ov.cost.communication == ph.cost.communication
        assert ov.makespan <= ph.makespan + 1e-12
        np.testing.assert_array_compare(np.less_equal, ov.worker_times,
                                        ph.worker_times + 1e-12)
        assert ov.metrics["overlap_makespan_s"] == ov.makespan
        assert ph.metrics["phased_makespan_s"] == ph.makespan
        assert ov.metrics["phased_makespan_s"] == ph.metrics["phased_makespan_s"]
        assert ov.metrics["overlap_makespan_s"] == ph.metrics["overlap_makespan_s"]

    def test_matches_the_reference_pipeline(self, arch, P, channel):
        cfg, ref_cfg, params, _, prompts, _, _ = _served(arch)
        got = _run(arch, P, channel)
        want = ref_pipeline.run_lm_pipeline(
            ref_cfg, prompts, params, max_new_tokens=MAX_NEW, P=P,
            channel=channel, executors=_ref_executors(arch, P))
        np.testing.assert_array_equal(got.tokens, want.tokens)
        np.testing.assert_allclose(got.logits, want.logits, **TOL)
        assert dataclasses.astuple(got.plan) == dataclasses.astuple(want.plan)
        for f in BILLED_COUNTS:
            assert getattr(got.stats, f) == getattr(want.stats, f), f
        assert got.raw_exchange_bytes == want.raw_exchange_bytes
        for key in ("flops_total", "hops", "est_decode_hop_usd"):
            assert got.metrics[key] == want.metrics[key], key
        assert got.cost.total == pytest.approx(want.cost.total, rel=0.05)
        np.testing.assert_allclose(got.worker_times, want.worker_times,
                                   rtol=2e-2)
        assert [ex.weight_bytes for ex in _executors(arch, P)] == \
            [ex.weight_bytes for ex in _ref_executors(arch, P)]
        assert [ex.flops_per_token for ex in _executors(arch, P)] == \
            [ex.flops_per_token for ex in _ref_executors(arch, P)]


def test_kv_stays_worker_resident():
    """Decode ships only [B, 1, d] activations and the token loopback: a
    decode step's raw wire bytes do not scale with the prompt, and each
    stage's cache holds its own layers only."""
    cfg, _, _, _, prompts, _, _ = _served("internlm2-1.8b")
    one = _run("internlm2-1.8b", 2, "queue", max_new_tokens=1)
    two = _run("internlm2-1.8b", 2, "queue", max_new_tokens=2)
    B = prompts.shape[0]
    frame = _HEADER.size + B * 4
    expect = (frame + B * cfg.d_model * 4) + (frame + B * 4)
    assert two.raw_exchange_bytes - one.raw_exchange_bytes == expect
    for ex in _executors("internlm2-1.8b", 2):
        assert ex.cache["k"].shape[0] == ex.spec.n_layers


def test_moe_stage_straddles_the_dense_moe_boundary():
    """At P 4 over 1 dense and 3 moe layers, stage 0 holds the dense stack
    only and the later stages slices of the moe stack; the slices share
    the model's tensors (no copy), and the stages' caches hold one fp32
    KV stack per stack they hold."""
    _, _, _, port, _, _, _ = _served("deepseek-moe-16b")
    _run("deepseek-moe-16b", 4, "queue")
    executors = _executors("deepseek-moe-16b", 4)
    first = executors[0].params
    assert len(first["dense_blocks"]) == 1 and first["moe_blocks"] is None
    assert first["dense_blocks"][0] is port.dense_blocks[0]
    assert executors[0].cache["stacks"][0]["k"].dtype == torch.float32
    for ex in executors[1:]:
        assert ex.params["dense_blocks"] is None
        assert len(ex.cache["stacks"]) == 1
        assert ex.cache["stacks"][0]["k"].shape[0] == ex.spec.n_layers
    assert executors[-1].params["unembed"] is port.unembed
    plan = moe._stage_stacks(_served("deepseek-moe-16b")[0], 0, 3)
    assert plan == ((0, 1), (0, 2))


def test_engine_fabric_path():
    cfg, _, _, port, prompts, _, ref = _served("internlm2-1.8b")
    fab = ServingEngine(cfg, params=port, device="cpu", engine="fabric",
                        pipeline_P=2, pipeline_channel="queue")
    got = fab.generate(prompts, max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert np.array_equal(got.prefill_logits, ref.prefill_logits)
    assert got.fabric is not None and got.fabric.stats.sqs_api_calls > 0
    assert got.fabric.metrics["phased_makespan_s"] >= \
        got.fabric.metrics["overlap_makespan_s"]
    # the executors are built once and reused
    executors = fab._stage_executors
    fab.generate(prompts, max_new_tokens=1)
    assert fab._stage_executors is executors


def test_engine_fabric_stream_fallback():
    """The fabric engine has no mid-batch admission point, so
    ``generate_stream`` serves each request alone through the pipeline:
    each result equals its own fabric ``generate``."""
    cfg, _, _, port, prompts, _, _ = _served("deepseek-moe-16b")
    fab = ServingEngine(cfg, params=port, device="cpu", engine="fabric",
                        pipeline_P=2, pipeline_channel="object")
    reqs = [Request(rid=i, prompt=prompts[i, :3 + i], max_new_tokens=1 + i)
            for i in range(prompts.shape[0])]
    results = {r.rid: r for r in fab.generate_stream(reqs)}
    assert set(results) == {r.rid for r in reqs}
    for req in reqs:
        solo = fab.generate(np.asarray(req.prompt)[None],
                            max_new_tokens=req.max_new_tokens)
        np.testing.assert_array_equal(results[req.rid].tokens, solo.tokens[0])
        assert results[req.rid].prompt_len == req.prompt.shape[0]


def test_unknown_engine_and_unstaged_families_rejected():
    cfg, _, _, port, _, _, _ = _served("internlm2-1.8b")
    with pytest.raises(ValueError, match="unknown engine"):
        ServingEngine(cfg, params=port, device="cpu", engine="telepathy")
    for arch in ("mamba2-370m",):
        with pytest.raises(ValueError, match="not supported"):
            get_stage_model(get_config(arch).reduced(), "dense-ref")
    with pytest.raises(ValueError, match="not supported"):
        get_stage_model(dataclasses.replace(cfg, family="encdec"), "dense-ref")
    with pytest.raises(ValueError, match="not supported"):
        get_stage_model(dataclasses.replace(cfg, family="hybrid"), "dense-ref")
    vlm = get_stage_model(dataclasses.replace(cfg, family="vlm"), "dense-ref")
    assert vlm.cfg.family == "vlm"


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("internlm2-1.8b").reduced()
    with pytest.raises(RuntimeError, match="CUDA device"):
        run_lm_pipeline(cfg, np.zeros((1, 2), np.int32))
    with pytest.raises(RuntimeError, match="CUDA device"):
        ServingEngine(cfg, engine="fabric")


def test_seeded_params_on_the_cpu_serve():
    cfg = get_config("deepseek-moe-16b").reduced()
    r = run_lm_pipeline(cfg, np.ones((1, 4), np.int32), max_new_tokens=2,
                        P=2, device="cpu")
    assert r.tokens.shape == (1, 2) and np.isfinite(r.logits).all()


# ---------------------------------------------------------------------------
# stage cold start
# ---------------------------------------------------------------------------


class TestStageColdStart:
    @pytest.mark.parametrize("arch", sorted(ARCHS))
    def test_stage_slices_partition_the_weights(self, arch):
        port = _served(arch)[3]
        full = _nbytes(port)
        for P in (2, 4):
            executors = _executors(arch, P)
            for ex in executors:
                assert 0 < ex.weight_bytes < full
            # the slices cover the model (a tied head would count the
            # embedding twice, hence >=)
            assert sum(ex.weight_bytes for ex in executors) >= full

    def test_cold_start_bills_slice_not_full_model(self):
        port = _served("internlm2-1.8b")[3]
        full = _nbytes(port)
        ex = _executors("internlm2-1.8b", 4)[1]
        lat = LatencyModel()
        w = WorkerState(rank=0, memory_mb=1000)
        charge_weight_load(w, ex, lat)
        assert w.clock == pytest.approx(ex.weight_bytes / lat.weight_load_bandwidth)
        assert w.clock < full / lat.weight_load_bandwidth

    def test_cold_start_syncs_both_ledger_timelines(self):
        ex = ModelStageWorker(spec=None, params=None, prefill_fn=None,
                              decode_fn=None, weight_bytes=250_000_000)
        lat = LatencyModel()  # 250 MB/s -> exactly 1.0 s
        w = WorkerState(rank=0, memory_mb=1000,
                        ledger=EventLedger(t_compute=0.3, t_channel=2.0))
        charge_weight_load(w, ex, lat)
        assert w.ledger.t_compute == w.ledger.t_channel == pytest.approx(3.0)
        assert w.clock == pytest.approx(1.0)

    def test_tied_head_stage_counts_the_embedding(self):
        cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(),
                                  tie_embeddings=True)
        port = transformer.init(torch.Generator().manual_seed(0), cfg,
                                dtype=torch.float32)
        ex = build_stage_executors(cfg, port, 2, attn_backend="dense-ref")
        head = ex[-1]
        assert head.params["embed"] is port.embed
        blocks = sum(_nbytes(b) for b in port.blocks[head.spec.start:])
        assert head.weight_bytes == (blocks + port.embed.numel() * 4
                                     + port.ln_f.numel() * 4)


# ---------------------------------------------------------------------------
# chaos: crash recovery and KV checkpoints
# ---------------------------------------------------------------------------


class TestLmPipelineChaos:
    @pytest.mark.parametrize("channel", ["queue", "object"])
    def test_zero_fault_plan_is_invisible(self, channel):
        base = _run("internlm2-1.8b", 2, channel)
        z = _run("internlm2-1.8b", 2, channel, faults=FaultPlan())
        for f in CHAOS_COUNTERS:
            assert getattr(z.stats, f) == getattr(base.stats, f), f
        np.testing.assert_array_equal(z.tokens, base.tokens)
        np.testing.assert_array_equal(z.logits, base.logits)
        assert z.metrics["n_reinvokes"] == 0.0
        assert z.metrics["checkpoint_puts"] > 0

    @pytest.mark.parametrize("channel", ["queue", "object"])
    def test_hop_drain_crash_recovers(self, channel):
        """Stage 1 dies after draining the prefill hop, before its receipt
        deletes commit: the hop redelivers (queue) or is read again
        (object), and decode still emits the fault-free tokens."""
        base = _run("internlm2-1.8b", 2, channel)
        r = _run("internlm2-1.8b", 2, channel,
                 faults=FaultPlan(kills=((1, 0, "drain"),)))
        np.testing.assert_array_equal(r.tokens, base.tokens)
        np.testing.assert_array_equal(r.logits, base.logits)
        assert r.metrics["n_reinvokes"] == 1.0
        assert r.cost.recovery > 0.0
        assert r.cost.total > base.cost.total
        if channel == "queue":
            assert r.metrics["redeliveries"] >= 1.0

    def test_uncovered_queue_hop_is_unrecoverable(self):
        with pytest.raises(FleetFailure) as ei:
            _run("internlm2-1.8b", 2, "queue",
                 faults=FaultPlan(kills=((1, 6, "drain"),), checkpoint_every=2))
        assert "checkpoint_every" in ei.value.diagnostics[1]["reason"]

    def test_object_replays_uncovered_hop(self):
        base = _run("internlm2-1.8b", 2, "object")
        r = _run("internlm2-1.8b", 2, "object",
                 faults=FaultPlan(kills=((1, 6, "drain"),), checkpoint_every=2))
        np.testing.assert_array_equal(r.tokens, base.tokens)
        assert r.metrics["n_reinvokes"] == 1.0

    @pytest.mark.parametrize("arch", sorted(ARCHS))
    def test_checkpoint_bytes_and_recovery_bill_equal_the_reference(self, arch):
        """KV checkpoints carry the reference's bytes (deepseek's fp32 cache,
        capacities padded to the layout, ``length`` as 4 bytes), so the
        recovery line is the reference's."""
        cfg, ref_cfg, params, _, prompts, _, _ = _served(arch)
        plan = FaultPlan(kills=((1, 0, "drain"),))
        got = _run(arch, 2, "object", faults=plan)
        want = ref_pipeline.run_lm_pipeline(
            ref_cfg, prompts, params, max_new_tokens=MAX_NEW, P=2,
            channel="object", executors=_ref_executors(arch, 2), faults=plan)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        for key in ("checkpoint_puts", "checkpoint_bytes", "n_reinvokes",
                    "recovery_usd"):
            assert got.metrics[key] == want.metrics[key], key


# ---------------------------------------------------------------------------
# duplicate and reordered delivery
# ---------------------------------------------------------------------------

# tiny cap forces multi-chunk prefill hops, so chunk order matters
SMALL_PRICING = dataclasses.replace(AWS_PRICING, max_publish_payload=1600)


class DuplicatingQueueFabric(QueueFabric):
    """At-least-once SQS: every published message is delivered twice, the
    duplicate later."""

    def publish_batch(self, topic, entries, at_time, *, ledger_at=None):
        done = super().publish_batch(topic, entries, at_time,
                                     ledger_at=ledger_at)
        dup_led = None if ledger_at is None else ledger_at + 0.5
        return super().publish_batch(topic, entries, done + 0.5,
                                     ledger_at=dup_led)


class ReorderingQueueFabric(QueueFabric):
    """Deliveries within a poll window come back in reverse order."""

    def poll(self, worker, at_time, long_poll=True, max_messages=10):
        now, msgs = super().poll(worker, at_time, long_poll, max_messages)
        return now, list(reversed(msgs))


class DuplicatingReorderingQueueFabric(DuplicatingQueueFabric,
                                       ReorderingQueueFabric):
    pass


class DuplicatingObjectFabric(ObjectFabric):
    """Every object is PUT twice and LISTed twice."""

    def put_obj(self, layer, src, target, blob, at_time, *, ledger_at=None):
        done = super().put_obj(layer, src, target, blob, at_time,
                               ledger_at=ledger_at)
        dup_led = None if ledger_at is None else ledger_at + 0.5
        return super().put_obj(layer, src, target, blob, done,
                               ledger_at=dup_led)

    def list_files(self, layer, worker, at_time):
        now, handles = super().list_files(layer, worker, at_time)
        return now, handles + handles


class ReorderingObjectFabric(ObjectFabric):
    """LIST returns handles in reverse key order and multipart objects
    carry their chunks in reverse order."""

    def put_multipart(self, layer, src, target, blobs, at_time, *,
                      ledger_at=None):
        return super().put_multipart(layer, src, target,
                                     list(reversed(blobs)), at_time,
                                     ledger_at=ledger_at)

    def list_files(self, layer, worker, at_time):
        now, handles = super().list_files(layer, worker, at_time)
        return now, list(reversed(handles))


QUEUE_FAULTS = {
    "duplicate": DuplicatingQueueFabric,
    "out-of-order": ReorderingQueueFabric,
    "duplicate+out-of-order": DuplicatingReorderingQueueFabric,
}
OBJECT_FAULTS = {
    "duplicate": DuplicatingObjectFabric,
    "out-of-order": ReorderingObjectFabric,
}


class TestLmPipelineChannelFailures:
    """The activation hops and the token loopback reuse the FSI drain
    loops, so (src, seq) dedupe and the monotone hop tag keep tokens and
    logits exact under duplicate and reordered delivery."""

    P = 3

    def _run(self, arch, channel, fabric):
        return _run(arch, self.P, channel, max_new_tokens=2, fabric=fabric)

    def _clean(self, arch):
        return _run(arch, self.P, "queue", max_new_tokens=2)

    def _check(self, r, clean, ledger_bound=True):
        np.testing.assert_array_equal(r.tokens, clean.tokens)
        np.testing.assert_array_equal(r.logits, clean.logits)
        if ledger_bound:
            assert r.metrics["overlap_makespan_s"] <= \
                r.metrics["phased_makespan_s"] + 1e-9

    @pytest.mark.parametrize("arch", sorted(ARCHS))
    @pytest.mark.parametrize("fault", sorted(QUEUE_FAULTS))
    def test_queue_faults_keep_pipeline_exact(self, arch, fault):
        fabric = QUEUE_FAULTS[fault](self.P, pricing=SMALL_PRICING)
        self._check(self._run(arch, "queue", fabric), self._clean(arch))

    @pytest.mark.parametrize("fault", sorted(OBJECT_FAULTS))
    def test_object_faults_keep_pipeline_exact(self, fault):
        fabric = OBJECT_FAULTS[fault](self.P)
        # the duplicating object fabric stamps its redelivery on the ledger
        # timeline only, so the ledger <= phased bound is out of scope there
        self._check(self._run("internlm2-1.8b", "object", fabric),
                    self._clean("internlm2-1.8b"),
                    ledger_bound=(fault != "duplicate"))

    def test_duplicates_change_billing_not_results(self):
        clean = self._run("internlm2-1.8b", "queue",
                          QueueFabric(self.P, pricing=SMALL_PRICING))
        noisy = self._run("internlm2-1.8b", "queue",
                          DuplicatingQueueFabric(self.P, pricing=SMALL_PRICING))
        np.testing.assert_array_equal(clean.tokens, noisy.tokens)
        np.testing.assert_array_equal(clean.logits, noisy.logits)
        assert noisy.raw_exchange_bytes == 2 * clean.raw_exchange_bytes
        assert noisy.stats.publish_units == 2 * clean.stats.publish_units
        assert noisy.stats.sqs_api_calls >= clean.stats.sqs_api_calls


def test_auto_channel_plan_equals_the_reference():
    cfg, ref_cfg, params, _, prompts, _, _ = _served("internlm2-1.8b")
    got = run_lm_pipeline(cfg, prompts, _served("internlm2-1.8b")[3],
                          max_new_tokens=2, P=2, channel="auto",
                          attn_backend=TorchSplitKAttention(device="cpu"))
    want = ref_pipeline.run_lm_pipeline(ref_cfg, prompts, params,
                                        max_new_tokens=2, P=2, channel="auto")
    assert got.metrics["chosen_channel_plan"] == \
        want.metrics["chosen_channel_plan"]
    np.testing.assert_array_equal(got.tokens, want.tokens)
