"""End-to-end FSD-Inference run orchestration (the deterministic simulator).

``run_fsi`` is the entry point: partition the network, build comm plans and
offline worker artifacts, launch the worker tree, execute the FSI algorithm
layer-by-layer on every (simulated) Lambda, then Barrier + Reduce the output
panels to worker 0.  Every byte is really serialized/compressed/capped and
billed; worker clocks advance per the latency model, so the result carries
both the *output* (validated against the dense oracle in tests) and the
*latency + $-cost* profile (validated against the paper's §VI numbers in
benchmarks).

Fault tolerance: stragglers are modeled as slowed-down workers; when
``reinvoke_stragglers`` is set, workers whose per-layer compute exceeds
``straggler_timeout`` × the fleet median are re-invoked (cold start + weight
reload penalty, then full speed), per the pre-emptive retry literature the
paper cites.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Literal, Optional, Union

import numpy as np

from repro_torch.core.cost_model import (
    AWS_PRICING,
    CostBreakdown,
    PricingConstants,
    WorkloadStats,
    activation_hop_cost,
    lambda_cost,
    object_cost,
    queue_cost,
    serial_cost,
    warm_pool_cost,
)
from repro_torch.core.backends import ComputeBackend, get_backend
from repro_torch.core.fsi import (
    WorkerArtifacts,
    charge_finish,
    fsi_object_recv,
    fsi_object_recv_fleet,
    fsi_object_send_and_local,
    fsi_object_send_and_local_fleet,
    fsi_queue_recv,
    fsi_queue_recv_fleet,
    fsi_queue_send_and_local,
    fsi_queue_send_and_local_fleet,
    prepare_worker_artifacts,
    run_serial,
)
from repro_torch.core.partitioner import PartitionResult, partition_network
from repro_torch.core.send_recv import build_comm_plans
from repro_torch.data.graphchallenge import GraphChallengeNet
from repro_torch.faas.chaos import ChaosState, FaultPlan, FleetFailure
from repro_torch.faas.collectives import reduce_to_root
from repro_torch.faas.launch_tree import TreeSpec, launch_schedule, warm_pool_schedule
from repro_torch.faas.object_service import ObjectFabric
from repro_torch.faas.payload import Chunk
from repro_torch.faas.queue_service import QueueFabric
from repro_torch.faas.worker import ComputeModel, EventLedger, WorkerState

__all__ = ["LatencyModel", "SimulatorConfig", "FsiRunResult", "run_fsi",
           "charge_weight_load", "FaultPlan", "FleetFailure"]

Channel = Literal["queue", "object", "serial", "auto"]


@dataclasses.dataclass(frozen=True)
class SimulatorConfig:
    """Run policy + seeded RNG threading for the deterministic simulator.

    Every random draw a run makes — launch-tree cold-start jitter, straggler
    assignment, short-poll visibility — flows from this one seed through
    named, non-colliding streams, so two runs with an identical config
    produce identical makespans, metrics, and bills on both clock models.
    (Previously the straggler stream was derived as ``seed + 99``, which
    collides with the *launch* stream of a run seeded ``seed + 99`` —
    supposedly independent draws were correlated across runs.)

    ``eager_poll`` — consumers park their long-poll / LIST loop for the next
    layer before the publisher finishes, so the publish→poll RTT overlaps
    the sender's pack+publish on the ledger timeline (billing unchanged).
    ``warm_pool`` — workers are pre-invoked and weights pre-loaded before
    the request arrives; the pre-request GB-seconds are billed explicitly on
    the ``CostBreakdown.warm_pool`` line.
    """

    seed: int = 0
    eager_poll: bool = True
    warm_pool: bool = False

    def launch_rng(self) -> np.random.Generator:
        """Cold-start jitter stream — pinned to the historical root stream
        (``default_rng(seed)``) so committed bench baselines stay
        comparable across this refactor."""
        return np.random.default_rng(self.seed)

    def rng(self, stream: str) -> np.random.Generator:
        """A named stream statistically independent of every other stream
        and of any other seed's streams."""
        return np.random.default_rng([self.seed,
                                      zlib.crc32(stream.encode("utf-8"))])


@dataclasses.dataclass
class LatencyModel:
    """Service latency/throughput constants (defaults: public AWS figures)."""

    invoke_latency: float = 0.050
    cold_start: float = 0.250
    cold_start_jitter: float = 0.100
    sns_publish_latency: float = 0.012
    sns_fanout_latency: float = 0.020
    sqs_poll_rtt: float = 0.008
    sqs_long_poll_window: float = 2.0
    s3_put_latency: float = 0.030
    s3_get_first_byte: float = 0.018
    s3_list_latency: float = 0.025
    s3_bandwidth: float = 90e6
    weight_load_bandwidth: float = 250e6  # S3 model-shard read at startup
    straggler_prob: float = 0.0
    straggler_slowdown: float = 4.0


@dataclasses.dataclass
class FsiRunResult:
    output: np.ndarray                    # x^L assembled at worker 0 [N, batch]
    channel: Channel
    P: int
    worker_times: np.ndarray              # T_i (seconds, incl. launch offset)
    stats: WorkloadStats
    cost: CostBreakdown
    partition: Optional[PartitionResult]
    raw_exchange_bytes: int               # pre-compression volume (Table III)
    wire_exchange_bytes: int              # compressed bytes on the channel
    metrics: Dict[str, float]

    @property
    def mean_runtime(self) -> float:
        return float(self.worker_times.mean())

    @property
    def makespan(self) -> float:
        return float(self.worker_times.max())

    def per_sample_ms(self, batch: int) -> float:
        return self.makespan / batch * 1e3


def charge_weight_load(worker: WorkerState, artifact, latency: "LatencyModel") -> None:
    """Bill a worker's model-shard read from object storage at the startup
    read bandwidth.  One definition for every call site — FSI worker init,
    straggler re-invoke, and LM-pipeline stage cold start — so the cost
    expression can't drift.

    The shard size is the artifact's ``weight_bytes`` when it carries one (an
    LM pipeline stage loads only its own layer slice — it must never be
    billed the full-model read), else the FSI convention CSR nnz × 8B.

    On the overlapped ledger this is a fleet-wide stall: nothing can compute
    or communicate without the weights, so both timelines sync."""
    nbytes = getattr(artifact, "weight_bytes", None)
    if not nbytes:
        nbytes = artifact.weight_nnz * 8
    s = nbytes / latency.weight_load_bandwidth
    worker.charge_seconds(s)
    if worker.ledger is not None:
        worker.ledger.sync(s)


def run_fsi(
    net: GraphChallengeNet,
    x0: np.ndarray,
    P: int = 8,
    channel: Channel = "queue",
    partition_method: str = "hgp",
    memory_mb: Optional[int] = None,
    latency: Optional[LatencyModel] = None,
    compute: Optional[ComputeModel] = None,
    pricing: PricingConstants = AWS_PRICING,
    branching: int = 4,
    seed: int = 0,
    exploit_sparsity: bool = True,
    reinvoke_stragglers: bool = False,
    straggler_timeout: float = 3.0,
    partition: Optional[PartitionResult] = None,
    compute_backend: Union[str, ComputeBackend, None] = None,
    mesh: Optional[object] = None,
    channel_batching: bool = True,
    overlap: bool = True,
    eager_poll: bool = True,
    warm_pool: bool = False,
    sim: Optional[SimulatorConfig] = None,
    faults: Optional[FaultPlan] = None,
) -> FsiRunResult:
    """Run distributed FSI over a simulated serverless fleet.

    ``overlap`` selects which clock model the result reports.  Both models
    are always computed side by side: the strict-sum **phased** clock drives
    every fabric interaction (publishes, polls, LISTs — hence all billable
    counts), while the **event ledger** re-times the same events with
    per-worker compute/channel timelines merged only at dependency edges
    (layer k's drain overlaps layer k's publish lanes and local MVP).  With
    ``overlap=True`` (the default) worker times and billed durations come
    from the ledger; ``overlap=False`` reports the phased clock and serves
    as the differential oracle — charge counts are bit-identical between the
    two by construction.  Both makespans are always exposed in ``metrics``.

    ``eager_poll`` (default on) re-times ledger receives as if each consumer
    had its next-layer long-poll / LIST already parked when the publish
    landed — ledger-only, so no billable count moves.  ``warm_pool`` (default
    off: it adds a cost line) pre-invokes the fleet and pre-loads weights
    before the request epoch; the pre-request GB-seconds surface as
    ``CostBreakdown.warm_pool`` / ``metrics["warm_pool_usd"]``.
    ``channel="auto"`` picks queue vs object per layer boundary (and for the
    output gather) from ``activation_hop_cost`` over the comm plan's payload
    bytes; the plan string lands in ``metrics["chosen_channel_plan"]``.
    ``sim`` bundles seed + policy; when given it overrides ``seed`` /
    ``eager_poll`` / ``warm_pool``.

    ``mesh`` (a list of devices, ``launch.mesh.make_worker_mesh``) pins a
    sharded fleet backend's worker layout through its ``with_mesh``
    (``torch-bsr-sharded``); a backend without one raises.

    ``faults`` injects a seeded :class:`~repro_torch.faas.chaos.FaultPlan`:
    workers killed at chosen (layer, phase) sites are re-invoked (cold
    start + weight reload — or a warm-pool spare — on real cost lines),
    restore their input panel from a durable checkpoint written every
    ``checkpoint_every`` layers, and replay the layer handler; undeleted
    queue messages redeliver after the visibility timeout and durable
    objects are re-GET.  The output stays bitwise equal to the fault-free
    run while every recovery action bills (``CostBreakdown.recovery`` for
    re-invocations + the checkpoint store; redelivery/replay traffic on
    ``communication``; recovery runtime on ``compute``).  An unrecoverable
    plan raises :class:`~repro_torch.faas.chaos.FleetFailure` with per-worker
    diagnostics.  With ``faults=None`` nothing changes — every billable
    counter stays bit-identical to the fault-free baseline.  Fault
    injection drives the per-worker host path (no fleet batching).
    """
    latency = latency or LatencyModel()
    compute = compute or ComputeModel()
    if sim is None:
        sim = SimulatorConfig(seed=seed, eager_poll=eager_poll,
                              warm_pool=warm_pool)
    seed = sim.seed
    backend = get_backend(compute_backend)
    # Mesh threading for device-sharded fleet backends: the mesh rides on the
    # backend instance, so everything downstream — prepare_worker_artifacts,
    # fleet_prepare_all, fleet_apply — sees one consistent worker-axis layout
    # without new plumbing.
    if mesh is not None:
        if not hasattr(backend, "with_mesh"):
            raise ValueError(
                f"compute backend {backend.name!r} does not take a mesh"
            )
        backend = backend.with_mesh(mesh)
    batch = x0.shape[1]

    # ---------------- Serial short-circuit ---------------------------------
    if channel == "serial" or P == 1:
        memory_mb = memory_mb or pricing.max_lambda_memory_mb
        out, w = run_serial(net, x0, memory_mb=memory_mb, compute=compute,
                            backend=backend)
        w.charge_seconds(net.model_bytes / latency.weight_load_bandwidth)
        times = np.array([w.clock + latency.cold_start])
        stats = WorkloadStats(P=1, mean_runtime_s=float(times.mean()), memory_mb=memory_mb)
        return FsiRunResult(
            output=out, channel="serial", P=1, worker_times=times, stats=stats,
            cost=serial_cost(stats, pricing), partition=None,
            raw_exchange_bytes=0, wire_exchange_bytes=0,
            metrics={"flops": w.flops},
        )

    # ---------------- offline partitioning + plans --------------------------
    if partition is None:
        partition = partition_network(net.layers, P, method=partition_method, seed=seed)
    plans = build_comm_plans(net.layers, partition)
    artifacts = prepare_worker_artifacts(net.layers, partition, plans,
                                         backend=backend)
    # Fleet batching: torch-bsr stacks each layer's per-worker operands so
    # one kernel launch serves all P workers; numpy backends return None and
    # finish per worker.
    fleet_states = backend.fleet_prepare_all(
        [[artifacts[m].layers[k].state_for(backend) for m in range(P)]
         for k in range(net.n_layers)]
    )

    memory_mb = memory_mb or _default_memory_mb(net.neurons)
    for a in artifacts:
        need = a.memory_bytes(batch)
        if need > memory_mb * 1024 * 1024:
            raise MemoryError(
                f"worker {a.rank} shard needs ~{need/1e6:.0f}MB > {memory_mb}MB; "
                f"increase P or memory"
            )

    # ---------------- launch tree -------------------------------------------
    provision_s: Optional[np.ndarray] = None
    if sim.warm_pool:
        # the same cascade + weight loads run before the request epoch; the
        # per-worker pre-request runtime is billed on its own cost line
        weight_load_s = np.array([
            (getattr(artifacts[m], "weight_bytes", None)
             or artifacts[m].weight_nnz * 8) / latency.weight_load_bandwidth
            for m in range(P)
        ])
        ready, provision_s = warm_pool_schedule(
            P, branching=branching, invoke_latency=latency.invoke_latency,
            cold_start=latency.cold_start,
            cold_start_jitter=latency.cold_start_jitter,
            rng=sim.launch_rng(), weight_load_s=weight_load_s,
        )
    else:
        ready = launch_schedule(
            P, branching=branching, invoke_latency=latency.invoke_latency,
            cold_start=latency.cold_start,
            cold_start_jitter=latency.cold_start_jitter,
            rng=sim.launch_rng(),
        )
    rng = sim.rng("straggler")
    workers: List[WorkerState] = []
    for m in range(P):
        w = WorkerState(rank=m, memory_mb=memory_mb, start_time=float(ready[m]),
                        ledger=EventLedger(t_compute=float(ready[m]),
                                           t_channel=float(ready[m]),
                                           eager_poll=sim.eager_poll))
        if latency.straggler_prob > 0 and rng.random() < latency.straggler_prob:
            w.slowdown = latency.straggler_slowdown
        if not sim.warm_pool:
            # weight shard load from object storage (paper: workers reload
            # per request); warm pools pre-loaded during provisioning
            charge_weight_load(w, artifacts[m], latency)
        workers.append(w)

    # ---------------- fabric(s) ----------------------------------------------
    def _mk_fabric(ch: str):
        if ch == "queue":
            return QueueFabric(
                P, pricing=pricing,
                publish_latency=latency.sns_publish_latency,
                fanout_latency=latency.sns_fanout_latency,
                poll_rtt=latency.sqs_poll_rtt,
                long_poll_window=latency.sqs_long_poll_window,
                seed=seed,
            )
        return ObjectFabric(
            P,
            put_latency=latency.s3_put_latency,
            get_first_byte=latency.s3_get_first_byte,
            list_latency=latency.s3_list_latency,
            bandwidth=latency.s3_bandwidth,
        )

    if channel == "auto":
        plan_channels, gather_ch = _autotune_plan(
            artifacts, batch, net.n_layers, P, branching, pricing)
        plan_str = "".join(c[0] for c in plan_channels) + "+" + gather_ch[0]
    elif channel in ("queue", "object"):
        plan_channels = [channel] * net.n_layers
        gather_ch = channel
        plan_str = None
    else:
        raise ValueError(channel)
    fabrics = {ch: _mk_fabric(ch)
               for ch in dict.fromkeys(list(plan_channels) + [gather_ch])}

    # ---------------- chaos / recovery plumbing ------------------------------
    chaos: Optional[ChaosState] = None
    ckpt_fabric: Optional[ObjectFabric] = None
    # warm-pool spares drawn on re-invoke (stragglers or crash recovery);
    # their pre-provisioning seconds fold into the warm-pool cost line
    spare_provision_s: List[float] = []
    runtime_start = [w.clock for w in workers]
    if faults is not None:
        chaos = faults.activate()
        for fab in fabrics.values():
            fab.chaos = chaos
        # The panel-checkpoint store: durable, on its own prefix space, and
        # billed on the *recovery* cost line rather than communication.
        ckpt_fabric = ObjectFabric(
            P,
            put_latency=latency.s3_put_latency,
            get_first_byte=latency.s3_get_first_byte,
            list_latency=latency.s3_list_latency,
            bandwidth=latency.s3_bandwidth,
        )

    # ---------------- layer loop --------------------------------------------
    x_panels: List[np.ndarray] = [
        x0[artifacts[m].x0_rows].astype(np.float32) for m in range(P)
    ]
    for k in range(net.n_layers):
        t_before = [w.clock for w in workers]
        arts_k = [artifacts[m].layers[k] for m in range(P)]
        ch_k = plan_channels[k]
        fabric = fabrics[ch_k]
        if chaos is not None:
            # Crash-fault path: per-worker handlers with kill sites, panel
            # checkpoints, and re-invoke recovery (see _chaos_run_layer).
            x_panels = _chaos_run_layer(
                k, net, artifacts, x_panels, workers, fabrics, plan_channels,
                backend, compute, latency, chaos, ckpt_fabric, sim.warm_pool,
                spare_provision_s, runtime_start, exploit_sparsity,
            )
            _check_stragglers(
                reinvoke_stragglers, workers, t_before, straggler_timeout,
                artifacts, latency, sim.warm_pool, spare_provision_s)
            continue
        # Phases 1+2 — publish + overlapped local MVP, then drain the channel.
        # ``channel_batching`` (the default) runs the fleet-batched host path:
        # one pack pass and one vectorized drain scatter per layer instead of
        # O(P) Python-level passes.  Billed charges are bit-identical either
        # way (the fleet variants share the publish/drain helpers — asserted
        # in tests/test_fleet_channels.py).
        bufs: List[np.ndarray]
        if channel_batching:
            if ch_k == "queue":
                fleet_bufs = fsi_queue_send_and_local_fleet(
                    arts_k, x_panels, workers, fabric, compute,
                    exploit_sparsity=exploit_sparsity,
                )
                bufs = fsi_queue_recv_fleet(arts_k, fleet_bufs, workers,
                                            fabric, compute)
            else:
                fleet_bufs = fsi_object_send_and_local_fleet(
                    arts_k, x_panels, workers, fabric, compute,
                    exploit_sparsity=exploit_sparsity,
                )
                bufs = fsi_object_recv_fleet(arts_k, fleet_bufs, workers,
                                             fabric, compute)
        else:
            bufs = []
            for m in range(P):
                art = arts_k[m]
                if ch_k == "queue":
                    bufs.append(fsi_queue_send_and_local(
                        art, x_panels[m], workers[m], fabric, compute,
                        exploit_sparsity=exploit_sparsity,
                    ))
                else:
                    bufs.append(fsi_object_send_and_local(
                        art, x_panels[m], workers[m], fabric, compute,
                        exploit_sparsity=exploit_sparsity,
                    ))
            for m in range(P):
                art = arts_k[m]
                if ch_k == "queue":
                    bufs[m] = fsi_queue_recv(art, bufs[m], workers[m], fabric, compute)
                else:
                    bufs[m] = fsi_object_recv(art, bufs[m], workers[m], fabric, compute)
        if fleet_states is not None:
            outs = backend.fleet_apply(fleet_states[k], bufs, net.bias)
        else:
            outs = [
                backend.apply(
                    artifacts[m].layers[k].state_for(backend), bufs[m], net.bias
                )
                for m in range(P)
            ]
        for m in range(P):
            x_panels[m] = charge_finish(
                artifacts[m].layers[k], bufs[m], outs[m], workers[m], compute
            )
        # Straggler slowdown applies to *active* work (compute, pack/unpack)
        # via WorkerState.slowdown at the charge sites — never to channel
        # waits, which would compound across the fleet.
        _check_stragglers(
            reinvoke_stragglers, workers, t_before, straggler_timeout,
            artifacts, latency, sim.warm_pool, spare_provision_s)

    if chaos is not None:
        # Mailbox sweep: a worker recovered at the *last* layer re-published
        # duplicates its peers had already drained past — they must be
        # polled and deleted (billed) before the queues host the reduce.
        for fab in fabrics.values():
            if not isinstance(fab, QueueFabric):
                continue
            for m, w in enumerate(workers):
                receipts: List[int] = []
                while fab.pending(m):
                    now, ds = fab.poll(m, w.abs_time)
                    w.advance_to_abs(now)
                    receipts.extend(d.receipt for d in ds)
                if receipts:
                    w.advance_to_abs(
                        fab.delete_batch(m, receipts, w.abs_time))

    # ---------------- fused sync + reduce (Algorithm lines 19-20) ------------
    # FMI-style collective fusion: the output reduce's up-sweep payload
    # doubles as the barrier token (``sync=True``), so the separate barrier
    # up/down sweeps — two full tree traversals of token messages — vanish
    # from both clock models and from the bill.
    tree = TreeSpec(n_workers=P, branching=branching)
    panels = [x_panels[m] for m in range(P)]
    gathered = reduce_to_root(workers, fabrics[gather_ch], tree, panels,
                              op="concat_rows", sync=True)
    order = np.argsort(np.concatenate([artifacts[m].layers[-1].out_rows for m in range(P)]))
    output = gathered[order]

    # ---------------- billing -------------------------------------------------
    phased_times = np.array([w.abs_time for w in workers])
    ledger_times = np.array([w.overlap_time for w in workers])
    times = ledger_times if overlap else phased_times
    starts = np.array([w.start_time for w in workers])
    stats = WorkloadStats(
        P=P, mean_runtime_s=float((times - starts).mean()),
        memory_mb=memory_mb,
    )
    raw, wire = 0, 0
    extra: Dict[str, float] = {}
    if "queue" in fabrics:
        qm = fabrics["queue"].metrics
        stats.publish_units = qm.publish_billed_units
        stats.bytes_sns_to_sqs = qm.bytes_sns_to_sqs
        stats.sqs_api_calls = qm.sqs_api_calls
        raw += qm.raw_bytes
        wire += qm.bytes_sns_to_sqs
        extra.update({
            "publish_api_calls": qm.publish_api_calls,
            "messages": qm.messages_delivered,
            "empty_polls": qm.empty_polls,
            "redeliveries": qm.redeliveries,
        })
    if "object" in fabrics:
        om = fabrics["object"].metrics
        stats.s3_puts = om.puts
        stats.s3_gets = om.gets
        stats.s3_lists = om.lists
        raw += om.raw_bytes
        wire += om.bytes_written
        extra["nul_files"] = om.nul_files
    # communication sums both fabrics' tariffs (each is 0 for unused stats)
    cost = CostBreakdown(
        compute=lambda_cost(stats, pricing),
        communication=(queue_cost(stats, pricing).communication
                       + object_cost(stats, pricing).communication),
    )
    if provision_s is not None:
        cost.warm_pool = warm_pool_cost(
            list(provision_s) + spare_provision_s, memory_mb, pricing)
    if chaos is not None:
        # recovery line: re-invocation fees + the checkpoint store's request
        # tariffs.  Redelivery / replay traffic on the main fabrics already
        # landed on ``communication`` (where the provider bills it) and
        # recovery runtime on ``compute`` via mean_runtime.
        n_reinvokes = sum(chaos.reinvokes.values())
        cm = ckpt_fabric.metrics
        ckpt_stats = WorkloadStats(
            P=P, mean_runtime_s=0.0, memory_mb=memory_mb,
            s3_puts=cm.puts, s3_gets=cm.gets, s3_lists=cm.lists,
        )
        cost.recovery = (n_reinvokes * pricing.lambda_invoke
                         + object_cost(ckpt_stats, pricing).communication)

    metrics = {
        "flops_total": float(sum(w.flops for w in workers)),
        "imbalance": partition.imbalance(net.layers),
        # both clock models are always computed; the flag only selects which
        # one ``worker_times``/``stats`` report
        "phased_makespan_s": float(phased_times.max()),
        "overlap_makespan_s": float(ledger_times.max()),
        **{k: float(v) for k, v in extra.items()},
    }
    if plan_str is not None:
        metrics["chosen_channel_plan"] = plan_str
    if provision_s is not None:
        metrics["warm_pool_usd"] = cost.warm_pool
        metrics["warm_pool_provision_s"] = float(
            np.sum(provision_s) + sum(spare_provision_s))
        metrics["warm_pool_spares"] = float(len(spare_provision_s))
    if chaos is not None:
        metrics["recovery_usd"] = cost.recovery
        metrics["n_reinvokes"] = float(sum(chaos.reinvokes.values()))
        metrics["checkpoint_puts"] = float(ckpt_fabric.metrics.puts)
        metrics["checkpoint_bytes"] = float(ckpt_fabric.metrics.bytes_written)
        metrics["throttle_retries"] = float(
            sum(f.metrics.throttle_retries for f in fabrics.values()))
    return FsiRunResult(
        output=output, channel=channel, P=P, worker_times=times, stats=stats,
        cost=cost, partition=partition,
        raw_exchange_bytes=int(raw), wire_exchange_bytes=int(wire),
        metrics=metrics,
    )


def _check_stragglers(
    reinvoke_stragglers: bool,
    workers: List[WorkerState],
    t_before: List[float],
    straggler_timeout: float,
    artifacts: List[WorkerArtifacts],
    latency: "LatencyModel",
    warm_pool: bool,
    spare_provision_s: List[float],
) -> None:
    """Pre-emptive straggler re-invocation after one layer (paper's cited
    retry mitigation): workers whose layer cost exceeds ``straggler_timeout``
    × the fleet median are replaced with a fresh container.

    On demand that bills a cold start + weight reload on the worker clock;
    under ``warm_pool=True`` the replacement is drawn from the
    pre-provisioned pool instead — the spare already paid its cold start +
    weight load *before* the request, so the clock pays only the invoke
    routing and the spare's provisioning seconds fold into the
    ``CostBreakdown.warm_pool`` line (via ``spare_provision_s``)."""
    if not reinvoke_stragglers:
        return
    layer_cost = np.array([w.clock - t0 for w, t0 in zip(workers, t_before)])
    med = float(np.median(layer_cost))
    for m, w in enumerate(workers):
        if med > 0 and layer_cost[m] > straggler_timeout * med and w.slowdown > 1:
            w.slowdown = 1.0
            if warm_pool:
                w.charge_seconds(latency.invoke_latency)
                if w.ledger is not None:
                    w.ledger.sync(latency.invoke_latency)
                nbytes = (getattr(artifacts[m], "weight_bytes", None)
                          or artifacts[m].weight_nnz * 8)
                spare_provision_s.append(
                    latency.cold_start + nbytes / latency.weight_load_bandwidth)
            else:
                # re-invoke: fresh container (cold start + weight reload),
                # then it runs at full speed
                w.charge_seconds(latency.cold_start)
                if w.ledger is not None:
                    w.ledger.sync(latency.cold_start)
                charge_weight_load(w, artifacts[m], latency)


def _bill_reinvoke(
    w: WorkerState,
    artifact: WorkerArtifacts,
    latency: "LatencyModel",
    warm_pool: bool,
    spare_provision_s: List[float],
) -> None:
    """Bill one crash-recovery re-invocation on the worker's clock models.

    On demand: invoke routing + cold start + weight reload (a fleet-wide
    stall on the ledger — nothing overlaps a dead worker).  Under a warm
    pool the replacement container is already hot: the clock pays only the
    invoke routing, and the spare's pre-request provisioning seconds land on
    the warm-pool cost line."""
    w.charge_seconds(latency.invoke_latency)
    if w.ledger is not None:
        w.ledger.sync(latency.invoke_latency)
    if warm_pool:
        nbytes = (getattr(artifact, "weight_bytes", None)
                  or artifact.weight_nnz * 8)
        spare_provision_s.append(
            latency.cold_start + nbytes / latency.weight_load_bandwidth)
    else:
        w.charge_seconds(latency.cold_start)
        if w.ledger is not None:
            w.ledger.sync(latency.cold_start)
        charge_weight_load(w, artifact, latency)


def _checkpoint_panel(
    ckpt_fabric: ObjectFabric,
    k: int,
    m: int,
    panel: np.ndarray,
    w: WorkerState,
    compute: ComputeModel,
) -> None:
    """PUT worker ``m``'s layer-``k`` input panel to the durable checkpoint
    store.  The upload rides a background connection (async PUT issued
    alongside the layer's sends), so the worker clock pays only the panel
    serialization; the store's request tariffs land on the *recovery* cost
    line at billing time.  This is what keeps the zero-fault overhead of an
    armed FaultPlan at ~0 on both clock models."""
    blob = Chunk(panel.tobytes(), raw_bytes=panel.nbytes)
    s = panel.nbytes / compute.pack_bandwidth * w.slowdown
    w.charge_seconds(s)
    if w.ledger is not None:
        w.ledger.compute(s)
    ckpt_fabric.put_obj(k, m, m, blob, w.abs_time)


def _restore_panel(
    m: int,
    k: int,
    batch: int,
    chaos: ChaosState,
    ckpt_fabric: ObjectFabric,
    artifacts: List[WorkerArtifacts],
    workers: List[WorkerState],
    fabrics: Dict[str, object],
    plan_channels: List[str],
    backend: ComputeBackend,
    compute: ComputeModel,
    net: GraphChallengeNet,
) -> np.ndarray:
    """Reconstruct worker ``m``'s layer-``k`` input panel after a crash.

    The re-invoked container GETs the newest checkpoint at or below ``k``
    (real bytes round-trip — the restored panel is ``np.frombuffer`` of what
    was PUT) and replays the intermediate layers forward.  Replay re-reads
    each layer's remote inputs, which only works where they are still
    readable: durable objects survive their drain, but queue messages were
    deleted when the layer committed — a replayed *queue* layer is
    unrecoverable and raises :class:`FleetFailure` (the checkpoint-cadence
    trade-off: on the queue channel, C=1 is the only fully-recoverable
    cadence).  Replayed layers do not re-publish — the restart driver hands
    the worker its last acknowledged send layer, so only the crashed layer's
    sends go out again."""
    plan = chaos.plan
    k0 = (k // plan.checkpoint_every) * plan.checkpoint_every
    w = workers[m]
    now, blob = ckpt_fabric.get_obj(k0, m, f"{m}_{m}.dat", w.abs_time)
    w.advance_to_abs(now)
    if w.ledger is not None:
        w.ledger.sync_to(w.abs_time)
    panel = np.frombuffer(bytes(blob), dtype=np.float32).reshape(-1, batch).copy()
    for j in range(k0, k):
        if plan_channels[j] != "object":
            raise chaos.unrecoverable(
                m, k,
                f"replaying layer {j} needs its inputs re-read, but the queue "
                f"channel deleted them at commit — lower checkpoint_every "
                f"(C={plan.checkpoint_every}) so a checkpoint lands on layer {k}",
            )
        art = artifacts[m].layers[j]
        buf = np.zeros((len(art.needed_rows), batch), dtype=np.float32)
        buf[art.owned_positions] = panel[art.owned_source_positions]
        w.charge_compute(art.local_flops * batch, compute)
        buf = fsi_object_recv(art, buf, w, fabrics["object"], compute)
        out = backend.apply(art.state_for(backend), buf, net.bias)
        panel = charge_finish(art, buf, out, w, compute)
    return panel


def _chaos_run_layer(
    k: int,
    net: GraphChallengeNet,
    artifacts: List[WorkerArtifacts],
    x_panels: List[np.ndarray],
    workers: List[WorkerState],
    fabrics: Dict[str, object],
    plan_channels: List[str],
    backend: ComputeBackend,
    compute: ComputeModel,
    latency: "LatencyModel",
    chaos: ChaosState,
    ckpt_fabric: ObjectFabric,
    warm_pool: bool,
    spare_provision_s: List[float],
    runtime_start: List[float],
    exploit_sparsity: bool,
) -> List[np.ndarray]:
    """One layer of the crash-fault executor (per-worker host path).

    Kill sites per :data:`~repro_torch.faas.chaos.CRASH_PHASES`:

    * ``send``    — dies before publishing; recovery re-invokes, restores the
      panel, then publishes for the first time;
    * ``compute`` — dies after publishing; the replayed handler publishes
      duplicates, which peers retire via the (src, seq) dedupe;
    * ``drain``   — dies after the drain but before the receipt deletes
      commit; the in-flight messages redeliver after the visibility timeout
      and the re-drain pays the empty polls + redelivery bills for real.

    A ``runtime_limit_s`` overrun is detected at the layer boundary and
    handled as a ``send``-phase kill.  Every recovery recomputes from real
    restored bytes, so the layer's output panels are bitwise identical to
    the fault-free run while every extra publish, poll, GET, and GB-second
    is billed.
    """
    P = len(workers)
    batch = x_panels[0].shape[1]
    plan = chaos.plan
    ch_k = plan_channels[k]
    fabric = fabrics[ch_k]

    if k % plan.checkpoint_every == 0:
        for m in range(P):
            _checkpoint_panel(ckpt_fabric, k, m, x_panels[m], workers[m],
                              compute)

    def send_local(m: int) -> np.ndarray:
        art = artifacts[m].layers[k]
        if ch_k == "queue":
            return fsi_queue_send_and_local(
                art, x_panels[m], workers[m], fabric, compute,
                exploit_sparsity=exploit_sparsity)
        return fsi_object_send_and_local(
            art, x_panels[m], workers[m], fabric, compute,
            exploit_sparsity=exploit_sparsity)

    def recover(m: int, phase: str, reason: str) -> None:
        chaos.record_reinvoke(m, k, phase, reason)
        _bill_reinvoke(workers[m], artifacts[m], latency, warm_pool,
                       spare_provision_s)
        runtime_start[m] = workers[m].clock
        x_panels[m] = _restore_panel(
            m, k, batch, chaos, ckpt_fabric, artifacts, workers, fabrics,
            plan_channels, backend, compute, net)

    bufs: List[Optional[np.ndarray]] = [None] * P
    for m in range(P):
        if (plan.runtime_limit_s is not None
                and workers[m].clock - runtime_start[m] > plan.runtime_limit_s):
            recover(m, "send", "per-function runtime limit exceeded")
        elif chaos.should_crash(m, k, "send"):
            recover(m, "send", "killed before publish")
        bufs[m] = send_local(m)
        if chaos.should_crash(m, k, "compute"):
            recover(m, "compute", "killed after publish, before drain")
            bufs[m] = send_local(m)  # handler replay: duplicate publishes
    for m in range(P):
        art = artifacts[m].layers[k]

        def drain(m: int, doomed: Optional[List[int]] = None) -> np.ndarray:
            if ch_k == "queue":
                return fsi_queue_recv(art, bufs[m], workers[m], fabric,
                                      compute, receipts_out=doomed)
            return fsi_object_recv(art, bufs[m], workers[m], fabric, compute)

        if chaos.peek_crash(m, k, "drain"):
            # A doomed drain defers its deletes: the receipts below are
            # abandoned when the worker dies, stay in flight, and redeliver
            # after the visibility timeout — which the re-drain pays for
            # (empty polls while invisible, then re-billed deliveries).
            bufs[m] = drain(m, doomed=[])
            chaos.should_crash(m, k, "drain")  # consume the site
            recover(m, "drain", "killed before the receipt deletes committed")
            bufs[m] = send_local(m)  # handler replay: duplicate publishes
            bufs[m] = drain(m)
        else:
            bufs[m] = drain(m)
    outs = [
        backend.apply(artifacts[m].layers[k].state_for(backend), bufs[m],
                      net.bias)
        for m in range(P)
    ]
    return [
        charge_finish(artifacts[m].layers[k], bufs[m], outs[m], workers[m],
                      compute)
        for m in range(P)
    ]


def _autotune_plan(
    artifacts: List[WorkerArtifacts], batch: int, n_layers: int, P: int,
    branching: int, pricing: PricingConstants,
):
    """Per-layer-boundary channel choice from the live cost model.

    For every layer the planner sums ``activation_hop_cost`` over the comm
    plan's (src → target) payloads — ``len(rows)`` activation rows of
    ``batch`` float32 each plus the chunk header — and picks the cheaper
    channel; ties go to queue (lower latency per hop).  The output gather is
    chosen the same way over the reduce tree's subtree panel sizes (shipped
    raw, so no compression discount).  Deterministic: the plan depends only
    on the partition, so overlap/phased twins of a run see one plan.
    """
    plan: List[str] = []
    for k in range(n_layers):
        cost = {"queue": 0.0, "object": 0.0}
        for m in range(P):
            for rows in artifacts[m].layers[k].send_global.values():
                nbytes = 24 + len(rows) * (4 + 4 * batch)
                for ch in cost:
                    cost[ch] += activation_hop_cost(ch, nbytes, pricing)
        plan.append("queue" if cost["queue"] <= cost["object"] else "object")
    tree = TreeSpec(n_workers=P, branching=branching)
    sub = [len(a.layers[-1].out_rows) for a in artifacts]
    for m in reversed(range(1, P)):
        sub[tree.parent(m)] += sub[m]
    gcost = {"queue": 0.0, "object": 0.0}
    for m in range(1, P):
        nbytes = sub[m] * batch * 4
        for ch in gcost:
            gcost[ch] += activation_hop_cost(ch, nbytes, pricing,
                                             est_compression_ratio=1.0)
    gather = "queue" if gcost["queue"] <= gcost["object"] else "object"
    return plan, gather


def _default_memory_mb(neurons: int) -> int:
    """Paper §VI-A1 worker sizing: 1000/1500/2000/4000MB for N=1k..64k."""
    return {1024: 1000, 4096: 1500, 16384: 2000, 65536: 4000}.get(neurons, 2000)
