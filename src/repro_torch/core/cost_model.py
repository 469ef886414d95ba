"""FSD-Inference cost model (paper §IV, Equations 1–7) + design recommender.

    C_Queue  = C_λ + C_SNS + C_SQS          (Eq. 1)
    C_Object = C_λ + C_S3                   (Eq. 2)
    C_Serial = C_λ                          (Eq. 3)
    C_λ      = P·C_λ(Inv) + P·T̄·M·C_λ(Run)  (Eq. 4)
    C_SNS    = S·C_SNS(Pub) + Z·C_SNS(Byte) (Eq. 5)
    C_SQS    = Q·C_SQS(API)                 (Eq. 6)
    C_S3     = V·C_S3(Put) + R·C_S3(Get) + L·C_S3(List)   (Eq. 7)

Pricing constants are the published AWS us-east-1 rates the paper's
experiments ran under (late-2023).  §VI-F of the paper validates the model:
at N=16384, P=20, 10k samples it predicts Queue = (comp $0.10, comms $0.25)
and Object = (comp $0.09, comms $0.28), matching actual billing — our
``tests/test_cost_model.py`` reproduces those totals from the same formulas.

The recommender encodes §IV-C: Serial for models that fit one instance,
Queue while payloads stay within pub-sub limits (API calls ≈1–2 OOM cheaper),
Object once volumes saturate queue payloads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

__all__ = [
    "PricingConstants",
    "AWS_PRICING",
    "WorkloadStats",
    "CostBreakdown",
    "lambda_cost",
    "queue_cost",
    "object_cost",
    "serial_cost",
    "warm_pool_cost",
    "activation_hop_cost",
    "recommend_configuration",
    "AcceleratorCostConstants",
    "H100_SXM",
    "H100_PCIE",
    "H100_NVL",
    "ACCELERATORS",
    "accelerator_for",
]


@dataclasses.dataclass(frozen=True)
class PricingConstants:
    """Per-unit prices (USD)."""

    lambda_invoke: float = 0.20 / 1e6          # per invocation
    lambda_mb_second: float = 0.0000166667 / 1024.0  # per MB-second
    sns_publish_64kb: float = 0.50 / 1e6       # per billed 64KB publish unit
    sns_byte_to_sqs: float = 0.09 / (1 << 30)  # per byte SNS→SQS transfer
    sqs_api_request: float = 0.40 / 1e6        # per SQS API call
    s3_put: float = 0.005 / 1e3                # per PUT
    s3_get: float = 0.0004 / 1e3               # per GET
    s3_list: float = 0.005 / 1e3               # per LIST

    # Provider-imposed message constraints (AWS, time of paper)
    max_publish_payload: int = 256 * 1024      # bytes per publish batch
    publish_billing_unit: int = 64 * 1024      # billed in 64KB increments
    max_messages_per_publish: int = 10
    max_lambda_memory_mb: int = 10240
    max_lambda_runtime_s: float = 900.0


AWS_PRICING = PricingConstants()


@dataclasses.dataclass
class WorkloadStats:
    """Measured or estimated per-request quantities (paper's S, Z, Q, V, R, L).

    Captured programmatically by the FaaS simulator (51 per-layer / 26
    per-batch metrics in the paper; we keep the billable aggregates).
    """

    P: int                     # number of workers
    mean_runtime_s: float      # T̄
    memory_mb: int             # M
    publish_units: int = 0     # S  (64KB-billed publish units)
    bytes_sns_to_sqs: int = 0  # Z
    sqs_api_calls: int = 0     # Q  (polls + deletes + sends)
    s3_puts: int = 0           # V
    s3_gets: int = 0           # R
    s3_lists: int = 0          # L


@dataclasses.dataclass
class CostBreakdown:
    compute: float
    communication: float
    # Pre-request provisioning $ under the warm-pool policy (GB-seconds from
    # each worker's invocation through pool-hot).  Zero for on-demand runs,
    # so the field is invisible to every existing cost comparison.
    warm_pool: float = 0.0
    # Crash-recovery $ under an injected FaultPlan: re-invocation fees plus
    # the durable checkpoint store's PUT/GET/LIST tariffs.  Redelivery and
    # replay traffic on the main fabrics stays on ``communication`` (that is
    # where the provider bills it); recovery *runtime* stays on ``compute``
    # via mean_runtime.  Zero for fault-free runs.
    recovery: float = 0.0

    @property
    def total(self) -> float:
        return self.compute + self.communication + self.warm_pool + self.recovery

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        warm = f", warm=${self.warm_pool:.4f}" if self.warm_pool else ""
        rec = f", recovery=${self.recovery:.4f}" if self.recovery else ""
        return (
            f"CostBreakdown(comp=${self.compute:.4f}, "
            f"comms=${self.communication:.4f}{warm}{rec}, total=${self.total:.4f})"
        )


def lambda_cost(stats: WorkloadStats, pricing: PricingConstants = AWS_PRICING) -> float:
    """Eq. 4 — C_λ = P·C_inv + P·T̄·M·C_run."""
    return stats.P * pricing.lambda_invoke + (
        stats.P * stats.mean_runtime_s * stats.memory_mb * pricing.lambda_mb_second
    )


def queue_cost(
    stats: WorkloadStats, pricing: PricingConstants = AWS_PRICING
) -> CostBreakdown:
    """Eq. 1/5/6."""
    c_sns = (
        stats.publish_units * pricing.sns_publish_64kb
        + stats.bytes_sns_to_sqs * pricing.sns_byte_to_sqs
    )
    c_sqs = stats.sqs_api_calls * pricing.sqs_api_request
    return CostBreakdown(compute=lambda_cost(stats, pricing), communication=c_sns + c_sqs)


def object_cost(
    stats: WorkloadStats, pricing: PricingConstants = AWS_PRICING
) -> CostBreakdown:
    """Eq. 2/7."""
    c_s3 = (
        stats.s3_puts * pricing.s3_put
        + stats.s3_gets * pricing.s3_get
        + stats.s3_lists * pricing.s3_list
    )
    return CostBreakdown(compute=lambda_cost(stats, pricing), communication=c_s3)


def serial_cost(
    stats: WorkloadStats, pricing: PricingConstants = AWS_PRICING
) -> CostBreakdown:
    """Eq. 3."""
    return CostBreakdown(compute=lambda_cost(stats, pricing), communication=0.0)


def warm_pool_cost(
    provision_seconds, memory_mb: int,
    pricing: PricingConstants = AWS_PRICING,
) -> float:
    """Pre-request $ of a warm pool: each worker's billed runtime from its
    invocation through pool-hot (``warm_pool_schedule``'s ``provision_s``),
    priced as ordinary Lambda GB-seconds.  Invocations themselves are billed
    once in :func:`lambda_cost` — pre-invoking merely moves them earlier."""
    return float(sum(provision_seconds)) * memory_mb * pricing.lambda_mb_second


def billed_publish_units(payload_bytes: int, pricing: PricingConstants = AWS_PRICING) -> int:
    """Publishes are billed in 64KB increments (a 256KB publish = 4 units)."""
    return max(1, math.ceil(payload_bytes / pricing.publish_billing_unit))


Channel = Literal["serial", "queue", "object"]


def activation_hop_cost(
    channel: Channel,
    activation_bytes: int,
    pricing: PricingConstants = AWS_PRICING,
    est_compression_ratio: float = 0.45,
) -> float:
    """Analytic $ for ONE inter-stage activation hop of the LM pipeline.

    The pipeline executor ships a [B, S, d] (prefill) or [B, 1, d] (decode)
    activation between consecutive stages; this prices that single
    point-to-point transfer per channel so the stage planner / router can
    predict $-per-token before running anything (the billed counterpart is
    aggregated in ``WorkloadStats`` by ``run_lm_pipeline``).

    Queue (Eq. 5/6): the compressed payload splits into ≤256KB publishes
    billed in 64KB units, plus SNS→SQS bytes, plus one receive + one delete
    batch per ≤10 messages.  Object (Eq. 7): one PUT, one GET, one LIST —
    size-independent, which is exactly why Object wins at long prefills and
    loses on per-token decode hops.
    """
    wire = max(1, int(activation_bytes * est_compression_ratio))
    if channel == "queue":
        n_msgs = max(1, math.ceil(wire / pricing.max_publish_payload))
        units = max(n_msgs, billed_publish_units(wire, pricing))
        publishes = math.ceil(n_msgs / pricing.max_messages_per_publish)
        sqs = 2 * math.ceil(n_msgs / 10)  # receive + delete batches
        return (
            max(publishes, units) * pricing.sns_publish_64kb
            + wire * pricing.sns_byte_to_sqs
            + sqs * pricing.sqs_api_request
        )
    if channel == "object":
        return pricing.s3_put + pricing.s3_get + pricing.s3_list
    if channel == "serial":
        return 0.0
    raise ValueError(channel)


def recommend_configuration(
    model_bytes: int,
    per_layer_exchange_bytes: float,
    n_layers: int,
    P_candidates: tuple[int, ...] = (1, 8, 20, 42, 62),
    memory_mb_per_worker: int = 2000,
    est_runtime_s: float = 120.0,
    pricing: PricingConstants = AWS_PRICING,
) -> tuple[Channel, int, dict]:
    """§IV-C design recommendations, made executable.

    Estimates each (channel, P) candidate's cost from the analytic model and
    returns the cheapest feasible one.  Feasibility: the per-worker model
    shard (plus 25% headroom) must fit in the instance memory, and the
    estimated runtime must respect the FaaS runtime limit.
    """
    table: dict = {}
    best: tuple[float, Channel, int] | None = None
    # per-layer channel round latency a parallel fleet pays and serial avoids
    round_latency = {"queue": 0.06, "object": 0.10}
    for P in P_candidates:
        shard_mb = model_bytes / P / 1e6 * 1.25
        if P == 1:
            # serial runs the whole model in one right-sized instance
            mem_req = model_bytes * 2.0 / 1e6  # model + activations + overhead
            if mem_req > pricing.max_lambda_memory_mb:
                continue
            if est_runtime_s > pricing.max_lambda_runtime_s:
                continue
            mem = int(min(pricing.max_lambda_memory_mb, max(512, mem_req)))
            stats = WorkloadStats(P=1, mean_runtime_s=est_runtime_s, memory_mb=mem)
            cost = serial_cost(stats, pricing)
            table[("serial", 1)] = cost
            if best is None or cost.total < best[0]:
                best = (cost.total, "serial", 1)
            continue
        if shard_mb > min(memory_mb_per_worker, pricing.max_lambda_memory_mb):
            continue
        runtime = est_runtime_s / P + n_layers * round_latency["queue"]
        if runtime > pricing.max_lambda_runtime_s:
            continue
        # per-target payload per layer (paper: HGP keeps targets ≈ P-1 worst case)
        pair_bytes = per_layer_exchange_bytes / max(1, P - 1)
        publishes = n_layers * P * max(
            1, math.ceil((P - 1) / pricing.max_messages_per_publish)
        )
        units = n_layers * P * (P - 1) * billed_publish_units(
            int(min(pair_bytes, pricing.max_publish_payload)), pricing
        ) // max(1, (P - 1))
        z = int(per_layer_exchange_bytes * n_layers)
        q = n_layers * P * (2 + math.ceil((P - 1) / 10))
        qstats = WorkloadStats(
            P=P, mean_runtime_s=runtime, memory_mb=memory_mb_per_worker,
            publish_units=max(publishes, units), bytes_sns_to_sqs=z, sqs_api_calls=q,
        )
        qcost = queue_cost(qstats, pricing)
        table[("queue", P)] = qcost
        v = n_layers * P * (P - 1)
        ostats = WorkloadStats(
            P=P, mean_runtime_s=runtime, memory_mb=memory_mb_per_worker,
            s3_puts=v, s3_gets=v, s3_lists=n_layers * P * 3,
        )
        ocost = object_cost(ostats, pricing)
        table[("object", P)] = ocost
        for ch, cost in (("queue", qcost), ("object", ocost)):
            if best is None or cost.total < best[0]:
                best = (cost.total, ch, P)  # type: ignore[assignment]
    if best is None:
        raise ValueError("no feasible configuration (model too large for FaaS fleet)")
    return best[1], best[2], table



# ---------------------------------------------------------------------------
# accelerator roofline constants (the dry run's and the router's)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AcceleratorCostConstants:
    """One card's roofline constants, from NVIDIA's data sheets:
    ``peak_bf16_flops`` (dense bf16 tensor-core FLOP/s), ``hbm_bandwidth``
    (bytes/s), ``link_bandwidth`` (NVLink bytes/s a GPU, one direction),
    ``hbm_bytes`` (the memory the card reports) and ``peak_fp32_flops``
    (fp32 FLOP/s outside the tensor cores)."""

    peak_bf16_flops: float
    hbm_bandwidth: float
    link_bandwidth: float
    hbm_bytes: float
    peak_fp32_flops: float = 0.0


# NVLink 4: 900 GB/s a GPU both ways on the SXM part, 600 GB/s over the
# PCIe and NVL parts' bridges.  Memory: what an H100 80GB HBM3 (SXM)
# reports (``torch.cuda.get_device_properties(0).total_memory``); the PCIe
# and NVL parts' are their data sheets' 80 GB and 94 GB, not read off a card
H100_SXM = AcceleratorCostConstants(
    peak_bf16_flops=989e12, hbm_bandwidth=3.35e12, link_bandwidth=450e9,
    hbm_bytes=85017493504, peak_fp32_flops=67e12)
H100_PCIE = AcceleratorCostConstants(
    peak_bf16_flops=756e12, hbm_bandwidth=2.0e12, link_bandwidth=300e9,
    hbm_bytes=80e9, peak_fp32_flops=51e12)
H100_NVL = AcceleratorCostConstants(
    peak_bf16_flops=835e12, hbm_bandwidth=3.9e12, link_bandwidth=300e9,
    hbm_bytes=94e9, peak_fp32_flops=60e12)
ACCELERATORS = {"H100 SXM": H100_SXM, "H100 PCIe": H100_PCIE,
                "H100 NVL": H100_NVL}


def accelerator_for(name: str):
    """``(kind, constants)`` for a card's name as CUDA reports it
    (``NVIDIA H100 80GB HBM3`` is the SXM part)."""
    if "H100" in name:
        kind = next((k for k in ("H100 NVL", "H100 PCIe")
                     if k.split()[1] in name), "H100 SXM")
        return kind, ACCELERATORS[kind]
    raise ValueError(f"no data-sheet constants for card {name!r}")
